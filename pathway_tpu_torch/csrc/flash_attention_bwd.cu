// Flash-attention backward for the encoder's attention seam, for Hopper (sm_90a): the
// dQ kernel and the dK/dV kernel, built together by one nvcc run.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel` (pathway_tpu/ops/
// flash_attention.py:125, launched by `_flash_bwd_bhtd` at :231) and
// `_flash_bwd_dkv_kernel` (:166, launched at :247), and the glue of `_flash_diff_bwd`
// (:327) that computes delta = rowsum(dO * O) (:332) and folds [b,t,h,d] to [b*h,t,d].
//
// What they compute, as the TPU kernels do, for every (batch, head): with the forward's
// per-row logsumexp `lse` (f32) and scale = 1/sqrt(d),
//   s_ij  = (q_i * scale) . k_j + bias_j      (bias: 0 or -1e30 per key, f32)
//   P_ij  = exp(s_ij - lse_i)                 (the softmax, recomputed from lse)
//   dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - delta_i),  delta_i = dO_i . O_i
//   dQ_i  = scale * sum_j dS_ij k_j                       (dQ kernel)
//   dV_j  = sum_i P_ij dO_i,  dK_j = sum_i dS_ij (q_i * scale),
//   dbias_j = sum_i dS_ij                                  (dK/dV kernel)
// The dQ kernel also computes delta from dO and O and writes it ([b, h, t] f32) for the
// dK/dV kernel, which runs after it on the same stream; the TPU glue's separate
// elementwise pass and its f32 copy of dO * O are gone. q, k, v, O and dO are
// [b, t, h, d] in bf16 or f32, read with their own strides (q, k, v are views of the
// encoder's fused qkv projection). dQ, dK and dV come out [b, t, h, d] contiguous in
// the input type; dbias comes out per (batch, head) as [b, h, t] f32, and the wrapper
// sums it over heads with a torch op, so no atomics and the same result every run.
// Masked keys get P = 0 exactly for every row with a real key, so their dK, dV and
// dbias are exact zeros, written like any other. A fully masked query row has
// lse = -1e30 + log t, which rounds to -1e30 in f32, so its P is 1 for every key (not
// 1/t): the TPU kernel's rule, kept; keys past t are never read.
//
// What bounds them on an H100: at the train shape (b=1024 sequences, t=128, h=12, d=32,
// bf16, a few to 34 real keys of 128) the dQ kernel must read q, dO, O (for delta) and
// lse, and write dQ and delta, for every row, but read k and v only for the real keys;
// the dK/dV kernel reads q, dO, lse and delta for every row and k and v for the real
// keys, and writes dK, dV and dbias for every key. That is ~0.44 GB each, ~0.13 ms at
// 3.35 TB/s, against ~5-6 GFLOP over the real keys: both are memory-bound
// (chip_smoke.py computes the exact bounds from its run's mask).
//
// Design, simple and right first, as the forward (flash_attention_fwd.cu): one block
// per (tile of 128 rows, head, batch), one thread per row (query rows for dQ, key rows
// for dK/dV) with its row's operands and f32 accumulators in registers; the other
// side's rows are staged through shared memory as f32 in tiles of 32 (16-byte loads,
// neighbouring threads on neighbouring addresses) and read back as broadcasts, in a
// loop that takes the place of the TPU's sequential grid axis. The dK/dV kernel holds
// four rows per thread (k, v, dK, dV): at d = 64 that would be 256 registers, so for
// d = 64 two neighbouring threads share a row, each holding 32 of its dims, and add
// their partial dot products with one warp shuffle; every thread then holds at most
// 4 x 32 floats. Shared-memory rows carry one pad float per 32 dims, so the two halves
// read different banks. The dot products run on the FP32 pipes, not the tensor cores,
// so the kernels are bound by instruction throughput, not bytes; wgmma, TMA and
// skipping fully masked tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockRows = 128;  // rows per block (query rows for dQ, key rows for dK/dV)
constexpr int kTile = 32;        // rows of the other side per shared-memory tile
constexpr unsigned kFullMask = 0xffffffffu;

struct Strides {
  long long b, t, h;  // in elements; the head-dim stride is 1
};

// Threads per row: one for d <= 32, d / 32 for larger d, each holding kDims dims.
template <int D>
struct Split {
  static constexpr int kThreads = D > 32 ? D / 32 : 1;
  static constexpr int kDims = D / kThreads;
  static constexpr int kRow = D + kThreads - 1;  // shared row: one pad float per part
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

// This thread's kDims dims of one row (p points at the row's first element).
template <typename T, int D>
__device__ __forceinline__ void load_part(const T* p, int part, float* out) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kDims = Split<D>::kDims;
#pragma unroll
  for (int c = 0; c < kDims; c += kVec) load_chunk(p + part * kDims + c, out + c);
}

template <typename T, int D>
__device__ __forceinline__ void store_part(T* p, int part, const float* in) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kDims = Split<D>::kDims;
#pragma unroll
  for (int c = 0; c < kDims; c += kVec) store_chunk(p + part * kDims + c, in + c);
}

// Sum over the kThreads neighbouring lanes that share a row.
template <int D>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < Split<D>::kThreads; off <<= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

// Rows r0 .. r0+n-1 of a [b, t, h, d] operand (base already at its batch and head)
// into a shared tile as f32 times `mul`, by all threads of the block; rows past n are
// zero.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* base, long long row_stride, int r0, int n,
                                           float mul, float (*tile)[Split<D>::kRow]) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  constexpr int kDims = Split<D>::kDims;
  for (int i = threadIdx.x; i < kTile * kChunks; i += blockDim.x) {
    const int j = i / kChunks;
    const int c = (i % kChunks) * kVec;
    float* dst = &tile[j][c + c / kDims];  // a chunk never crosses a part
    float x[kVec];
    if (j < n) {
      load_chunk(base + (r0 + j) * row_stride + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[e] = x[e] * mul;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBlockRows * Split<D>::kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const T* __restrict__ o, const T* __restrict__ dout,
                        const float* __restrict__ lse, float* __restrict__ delta,
                        T* __restrict__ dq, int t, int h, Strides qs, Strides ks, Strides vs,
                        Strides os, Strides dos, float scale) {
  constexpr int kSplit = Split<D>::kThreads;
  constexpr int kDims = Split<D>::kDims;
  constexpr int kRow = Split<D>::kRow;
  __shared__ __align__(16) float k_tile[kTile][kRow];
  __shared__ __align__(16) float v_tile[kTile][kRow];
  __shared__ float b_tile[kTile];

  const int bi = blockIdx.z;
  const int hi = blockIdx.y;
  const int part = threadIdx.x % kSplit;
  const int row = blockIdx.x * kBlockRows + threadIdx.x / kSplit;
  const bool active = row < t;
  const int col = part * (kDims + 1);  // this thread's dims in a shared row
  const long long stat = (static_cast<long long>(bi) * h + hi) * t + row;  // lse, delta

  float qr[kDims];
  float dor[kDims];
  float acc[kDims];
  float row_delta = 0.f;
  float row_lse = 0.f;
  if (active) {
    load_part<T, D>(q + bi * qs.b + row * qs.t + hi * qs.h, part, qr);
    load_part<T, D>(dout + bi * dos.b + row * dos.t + hi * dos.h, part, dor);
    load_part<T, D>(o + bi * os.b + row * os.t + hi * os.h, part, acc);  // O, for delta
#pragma unroll
    for (int d = 0; d < kDims; ++d) row_delta = fmaf(dor[d], acc[d], row_delta);
    row_lse = lse[stat];
  }
  row_delta = row_sum<D>(row_delta);  // every lane takes part, active or not
  if (active && part == 0) delta[stat] = row_delta;
#pragma unroll
  for (int d = 0; d < kDims; ++d) {
    qr[d] = active ? qr[d] * scale : 0.f;
    dor[d] = active ? dor[d] : 0.f;
    acc[d] = 0.f;
  }

  const T* kp = k + bi * ks.b + hi * ks.h;
  const T* vp = v + bi * vs.b + hi * vs.h;
  const float* bp = bias ? bias + static_cast<long long>(bi) * t : nullptr;

  for (int k0 = 0; k0 < t; k0 += kTile) {
    const int nk = min(kTile, t - k0);
    __syncthreads();  // every thread is done with the previous tile
    stage_rows<T, D>(kp, ks.t, k0, nk, 1.f, k_tile);
    stage_rows<T, D>(vp, vs.t, k0, nk, 1.f, v_tile);
    if (threadIdx.x < kTile) {
      const int j = threadIdx.x;
      b_tile[j] = (bp != nullptr && j < nk) ? bp[k0 + j] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      if (j < nk) {  // the same for every thread of the block
        float s = 0.f;
        float dp = 0.f;
#pragma unroll
        for (int d = 0; d < kDims; ++d) {
          s = fmaf(qr[d], k_tile[j][col + d], s);
          dp = fmaf(dor[d], v_tile[j][col + d], dp);
        }
        s = row_sum<D>(s) + b_tile[j];
        dp = row_sum<D>(dp);
        const float ds = expf(s - row_lse) * (dp - row_delta);
#pragma unroll
        for (int d = 0; d < kDims; ++d) acc[d] = fmaf(ds, k_tile[j][col + d], acc[d]);
      }
    }
  }

  if (active) {
#pragma unroll
    for (int d = 0; d < kDims; ++d) acc[d] *= scale;
    store_part<T, D>(dq + ((static_cast<long long>(bi) * t + row) * h + hi) * D, part, acc);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBlockRows * Split<D>::kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ bias,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, float* __restrict__ dbias, int t, int h,
                         Strides qs, Strides ks, Strides vs, Strides dos, float scale) {
  constexpr int kSplit = Split<D>::kThreads;
  constexpr int kDims = Split<D>::kDims;
  constexpr int kRow = Split<D>::kRow;
  __shared__ __align__(16) float q_tile[kTile][kRow];  // q * scale
  __shared__ __align__(16) float do_tile[kTile][kRow];
  __shared__ float lse_tile[kTile];
  __shared__ float delta_tile[kTile];

  const int bi = blockIdx.z;
  const int hi = blockIdx.y;
  const int part = threadIdx.x % kSplit;
  const int row = blockIdx.x * kBlockRows + threadIdx.x / kSplit;  // a key row
  const bool active = row < t;
  const int col = part * (kDims + 1);

  float kr[kDims];
  float vr[kDims];
  float dk_acc[kDims];
  float dv_acc[kDims];
  float db = 0.f;
  float key_bias = 0.f;
  if (active) {
    load_part<T, D>(k + bi * ks.b + row * ks.t + hi * ks.h, part, kr);
    load_part<T, D>(v + bi * vs.b + row * vs.t + hi * vs.h, part, vr);
    if (bias != nullptr) key_bias = bias[static_cast<long long>(bi) * t + row];
  }
#pragma unroll
  for (int d = 0; d < kDims; ++d) {
    kr[d] = active ? kr[d] : 0.f;
    vr[d] = active ? vr[d] : 0.f;
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }

  const T* qp = q + bi * qs.b + hi * qs.h;
  const T* dop = dout + bi * dos.b + hi * dos.h;
  const long long stat0 = (static_cast<long long>(bi) * h + hi) * t;

  for (int q0 = 0; q0 < t; q0 += kTile) {
    const int nq = min(kTile, t - q0);
    __syncthreads();  // every thread is done with the previous tile
    stage_rows<T, D>(qp, qs.t, q0, nq, scale, q_tile);
    stage_rows<T, D>(dop, dos.t, q0, nq, 1.f, do_tile);
    if (threadIdx.x < kTile) {
      const int i = threadIdx.x;
      lse_tile[i] = i < nq ? lse[stat0 + q0 + i] : 0.f;
      delta_tile[i] = i < nq ? delta[stat0 + q0 + i] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      if (i < nq) {  // the same for every thread of the block
        float s = 0.f;
        float dp = 0.f;
#pragma unroll
        for (int d = 0; d < kDims; ++d) {
          s = fmaf(q_tile[i][col + d], kr[d], s);
          dp = fmaf(do_tile[i][col + d], vr[d], dp);
        }
        s = row_sum<D>(s) + key_bias;
        dp = row_sum<D>(dp);
        const float p = expf(s - lse_tile[i]);
        const float ds = p * (dp - delta_tile[i]);
#pragma unroll
        for (int d = 0; d < kDims; ++d) {
          dv_acc[d] = fmaf(p, do_tile[i][col + d], dv_acc[d]);
          dk_acc[d] = fmaf(ds, q_tile[i][col + d], dk_acc[d]);
        }
        db += ds;
      }
    }
  }

  if (active) {
    const long long out = ((static_cast<long long>(bi) * t + row) * h + hi) * D;
    store_part<T, D>(dk + out, part, dk_acc);
    store_part<T, D>(dv + out, part, dv_acc);
    if (part == 0) dbias[stat0 + row] = db;
  }
}

// One launch of a kernel for the runtime dtype (0 = float32, 1 = bfloat16) and head
// dim: Launch<T, D>::run.
template <template <typename, int> class Launch, typename Args>
cudaError_t dispatch(int dtype, int d, const Args& a, int b, int t, int h, const Strides* st,
                     float scale, cudaStream_t stream) {
  if (b <= 0 || t <= 0 || h <= 0 || b > 65535 || h > 65535) return cudaErrorInvalidValue;
  const dim3 grid((t + kBlockRows - 1) / kBlockRows, h, b);
  if (dtype == 0) {
    if (d == 16) return Launch<float, 16>::run(a, grid, t, h, st, scale, stream);
    if (d == 32) return Launch<float, 32>::run(a, grid, t, h, st, scale, stream);
    if (d == 64) return Launch<float, 64>::run(a, grid, t, h, st, scale, stream);
  } else if (dtype == 1) {
    if (d == 16) return Launch<__nv_bfloat16, 16>::run(a, grid, t, h, st, scale, stream);
    if (d == 32) return Launch<__nv_bfloat16, 32>::run(a, grid, t, h, st, scale, stream);
    if (d == 64) return Launch<__nv_bfloat16, 64>::run(a, grid, t, h, st, scale, stream);
  }
  return cudaErrorInvalidValue;
}

struct DqArgs {
  const void *q, *k, *v, *bias, *o, *dout, *lse;
  void *delta, *dq;
};

template <typename T, int D>
struct Dq {
  static cudaError_t run(const DqArgs& a, dim3 grid, int t, int h, const Strides* st,
                         float scale, cudaStream_t stream) {
    flash_bwd_dq_kernel<T, D><<<grid, kBlockRows * Split<D>::kThreads, 0, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const float*>(a.bias), static_cast<const T*>(a.o),
        static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<float*>(a.delta), static_cast<T*>(a.dq), t, h, st[0], st[1], st[2],
        st[3], st[4], scale);
    return cudaGetLastError();
  }
};

struct DkvArgs {
  const void *q, *k, *v, *bias, *dout, *lse, *delta;
  void *dk, *dv, *dbias;
};

template <typename T, int D>
struct Dkv {
  static cudaError_t run(const DkvArgs& a, dim3 grid, int t, int h, const Strides* st,
                         float scale, cudaStream_t stream) {
    flash_bwd_dkv_kernel<T, D><<<grid, kBlockRows * Split<D>::kThreads, 0, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const float*>(a.bias), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), static_cast<float*>(a.dbias), t, h,
        st[0], st[1], st[2], st[3], scale);
    return cudaGetLastError();
  }
};

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16. `strides` is a
// host array of (b, t, h) strides in elements, one triple per strided operand in the
// order of the pointers (dQ: q, k, v, o, dout; dK/dV: q, k, v, dout). bias is [b, t] f32
// contiguous, or null for no mask; lse and delta are [b, h, t] f32 contiguous; dq, dk,
// dv are [b, t, h, d] contiguous; dbias is [b, h, t] f32. Each launches on `stream` and
// returns cudaGetLastError().
extern "C" int pt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                         const void* bias, const void* o, const void* dout,
                                         const void* lse, void* delta, void* dq, int dtype,
                                         int b, int t, int h, int d, const long long* strides,
                                         float scale, void* stream) {
  Strides st[5];
  for (int i = 0; i < 5; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const DqArgs a{q, k, v, bias, o, dout, lse, delta, dq};
  return dispatch<Dq>(dtype, d, a, b, t, h, st, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int pt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                          const void* bias, const void* dout, const void* lse,
                                          const void* delta, void* dk, void* dv, void* dbias,
                                          int dtype, int b, int t, int h, int d,
                                          const long long* strides, float scale,
                                          void* stream) {
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const DkvArgs a{q, k, v, bias, dout, lse, delta, dk, dv, dbias};
  return dispatch<Dkv>(dtype, d, a, b, t, h, st, scale, static_cast<cudaStream_t>(stream));
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
