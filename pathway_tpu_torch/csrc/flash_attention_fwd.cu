// Flash-attention forward for the encoder's attention seam, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` (pathway_tpu/ops/flash_attention.py:47,
// launched by `_flash_bhtd` at :104) and the glue around it (`_prepare` :288 pads t to
// the 128 tile and folds [b,t,h,d] -> [b*h,t,d]; `_from_bhtd` :304 unfolds).
//
// What it computes, as `_flash_kernel` does: for every (batch, head, query row)
//   s_j = (q * 1/sqrt(d)) . k_j + bias_j        (bias: 0 or -1e30 per key, f32)
//   o   = sum_j softmax(s)_j v_j                 (online softmax, f32 accumulators)
//   lse = m + log(l)                             (per-row logsumexp, kept for a backward)
// Inputs q, k, v are [b, t, h, d] in bf16 or f32, read with their own strides (the
// encoder hands over views of its fused qkv projection), so the TPU glue's transpose
// and pad copies disappear. o is [b, t, h, d] contiguous in the input type and lse is
// [b, h, t] f32. The mask value is the finite -1e30, never -inf: a row whose keys are
// all masked comes out as the uniform average of v, as the TPU kernel gives it, and not
// as NaN. Keys past t are not padded in: the ragged last tile is masked here, so such a
// row averages exactly the t real keys.
//
// What bounds it on an H100: at the main path's shape (b=256, t=128, h=12, d=32, bf16,
// 10-34 real keys per sequence) one call must read q and write o (25.2 MB each), lse
// and the bias, but k and v only for the real keys: a masked key's weight is exactly 0
// in f32 for any row with a real key. That is ~61 MB, ~18 us at 3.35 TB/s, against
// ~1.1 GFLOP over the real keys: memory-bound, with a bound of ~18 us (~30.6 us if
// every key were real, ~102 MB).
//
// Design, simple and right first: one block per (query tile of 128 rows, head, batch),
// one thread per query row with its scaled q row and its f32 accumulator in registers.
// K and V tiles of 32 keys are staged through shared memory as f32 by all threads
// (16-byte loads, neighbouring threads on neighbouring addresses) and read back as
// broadcasts, in a loop over key tiles that takes the place of the TPU's sequential
// grid axis. Each input byte is read from device memory once per query tile (once in
// all for t <= 128). The dot products run on the FP32 pipes, not the tensor cores, so
// the kernel is bound by instruction throughput, not bytes; wgmma, TMA and skipping
// fully masked key tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 128;  // query rows per block, one per thread
constexpr int kBlockK = 32;   // keys per shared-memory tile

struct Strides {
  long long b, t, h;  // in elements; the head-dim stride is 1
};

// One 16-byte chunk: 4 floats or 8 bf16 values, widened to float.
__device__ __forceinline__ void load_chunk(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_chunk(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ void store_chunk(__nv_bfloat16* p, const float* in) {
  uint4 x;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ o, float* __restrict__ lse, int t, int h,
                     Strides qs, Strides ks, Strides vs, float scale) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int kChunks = D / kVec;     // chunks per row of d elements
  __shared__ __align__(16) float k_tile[kBlockK][D];
  __shared__ __align__(16) float v_tile[kBlockK][D];
  __shared__ float b_tile[kBlockK];

  const int bi = blockIdx.z;
  const int hi = blockIdx.y;
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool active = row < t;

  float qr[D];
  float acc[D];
  if (active) {
    const T* qp = q + bi * qs.b + row * qs.t + hi * qs.h;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) load_chunk(qp + c * kVec, qr + c * kVec);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? qr[d] * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  const T* kp = k + bi * ks.b + hi * ks.h;
  const T* vp = v + bi * vs.b + hi * vs.h;
  const float* bp = bias ? bias + static_cast<long long>(bi) * t : nullptr;

  for (int k0 = 0; k0 < t; k0 += kBlockK) {
    const int nk = min(kBlockK, t - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kBlockK * kChunks; i += kBlockQ) {
      const int j = i / kChunks;
      const int c = (i % kChunks) * kVec;
      if (j < nk) {
        load_chunk(kp + (k0 + j) * ks.t + c, &k_tile[j][c]);
        load_chunk(vp + (k0 + j) * vs.t + c, &v_tile[j][c]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          k_tile[j][c + e] = 0.f;
          v_tile[j][c + e] = 0.f;
        }
      }
    }
    if (threadIdx.x < kBlockK) {
      const int j = threadIdx.x;
      b_tile[j] = (bp != nullptr && j < nk) ? bp[k0 + j] : 0.f;
    }
    __syncthreads();

    float s[kBlockK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], k_tile[j][d], dot);
      s[j] = dot + b_tile[j];
      if (j < nk) m_new = fmaxf(m_new, s[j]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      if (j < nk) {
        const float p = expf(s[j] - m_new);
        l += p;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(p, v_tile[j][d], acc[d]);
      }
    }
    m = m_new;
  }

  if (active) {
    const float l_safe = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = acc[d] / l_safe;
    T* op = o + ((static_cast<long long>(bi) * t + row) * h + hi) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) store_chunk(op + c * kVec, acc + c * kVec);
    lse[(static_cast<long long>(bi) * h + hi) * t + row] = m + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* o,
                   void* lse, int b, int t, int h, Strides qs, Strides ks, Strides vs,
                   float scale, cudaStream_t stream) {
  const dim3 grid((t + kBlockQ - 1) / kBlockQ, h, b);
  flash_fwd_kernel<T, D><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(o), static_cast<float*>(lse), t, h,
      qs, ks, vs, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, const void* bias,
                       void* o, void* lse, int b, int t, int h, Strides qs, Strides ks,
                       Strides vs, float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, bias, o, lse, b, t, h, qs, ks, vs, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, bias, o, lse, b, t, h, qs, ks, vs, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, bias, o, lse, b, t, h, qs, ks, vs, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16. Strides are in
// elements for the b, t and h axes of q, k and v. bias is [b, t] f32 contiguous, or
// null for no mask. Launches on `stream` and returns cudaGetLastError().
extern "C" int pt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* bias, void* o, void* lse, int dtype,
                                      int b, int t, int h, int d, long long q_sb,
                                      long long q_st, long long q_sh, long long k_sb,
                                      long long k_st, long long k_sh, long long v_sb,
                                      long long v_st, long long v_sh, float scale,
                                      void* stream) {
  if (b <= 0 || t <= 0 || h <= 0 || b > 65535 || h > 65535) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, bias, o, lse, b, t, h, qs, ks, vs, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, bias, o, lse, b, t, h, qs, ks, vs, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
