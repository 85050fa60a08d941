// Flash-attention forward for the encoder's attention seam, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` (pathway_tpu/ops/flash_attention.py:47,
// launched by `_flash_bhtd` at :104) and the glue around it (`_prepare` :288 pads t to
// the 128 tile and folds [b,t,h,d] -> [b*h,t,d]; `_from_bhtd` :304 unfolds).
//
// What it computes, as `_flash_kernel` does: for every (batch, head, query row)
//   s_j = (q . k_j) / sqrt(d) + bias_j          (bias: 0 or -1e30 per key, f32)
//   o   = sum_j softmax(s)_j v_j                 (online softmax, f32 accumulators)
//   lse = m + log(l)                             (per-row logsumexp, kept for a backward)
// Inputs q, k, v are [b, t, h, d] in bf16 or f32, read with their own strides (the
// encoder hands over views of its fused qkv projection), so the TPU glue's transpose
// and pad copies disappear. o is [b, t, h, d] contiguous in the input type and lse is
// [b, h, t] f32. The mask value is the finite -1e30, never -inf: a row whose keys are
// all masked comes out as the uniform average of v, as the TPU kernel gives it, and not
// as NaN. Keys past t are not padded in: they get p = 0 outright, so such a row
// averages exactly the t real keys.
//
// What bounds it on an H100: bytes. At the serving shape (b=256, t=128, h=12, d=32,
// bf16, 10-34 real keys per sequence) one call must read q and write o (25.2 MB each),
// lse and the bias, but k and v only for the real keys: a masked key's weight is
// exactly 0 in f32 for any row with a real key. That is ~61 MB, ~18 us at 3.35 TB/s,
// against ~1.1 GFLOP over the real keys (~18 flop per byte, far below the card's ridge
// of ~295 for bf16): the products are nearly free on the tensor cores, and what is
// left is moving the bytes (chip_smoke.py computes the exact bound from its run's mask).
//
// Design. One block of 4 warps per (64 query rows, head, batch); each warp owns 16
// query rows. What it does about the three limits of the earlier one-thread-per-row,
// FP32-pipe design:
// - Tensor cores. The bf16 instances use warp-level mma.sync.m16n8k16 (bf16 in, f32
//   accumulators) with ldmatrix (.trans for V): S = Q.K^T per 16-key tile, the scale
//   applied to the f32 scores, the online softmax on the accumulator fragments (row
//   max and sum by quad shuffles), P rounded to bf16 and moved from the accumulator
//   layout straight into the A operand of P.V (no trip through shared memory), O
//   accumulated in f32 and written as 16-byte stores through the warp's own rows of
//   the Q tile. mma.sync and not wgmma: at ~18 flop per byte the products are not the
//   limit, and wgmma's 64-row tiles (one warpgroup) fit 16-key tiles of a 128-token
//   sequence and its 10-34 real keys badly.
// - Masked key tiles. Warp 0 reads the sequence's bias row once and orders its 16-key
//   tiles, those holding a key with bias > -5e29 first (flash_common.cuh); the block
//   visits only those. A sequence with no real key is dead: every tile is visited, so
//   its rows average exactly the t keys given. Query rows are never skipped.
// - Registers and latency. Q's fragments and the f32 accumulators of 16 rows are
//   spread over a warp (at d=32: 8 registers of Q, 16 of O, 8 of S per thread, 56 in
//   all; blocks of four warps measured faster than two or eight).
//   K and V tiles of 16 keys come in through a four-stage cp.async ring (16 bytes a thread,
//   neighbouring threads on neighbouring addresses, rows padded by 16 bytes so ldmatrix
//   reads hit distinct banks): a sequence's one to three live tiles are all in flight
//   at once, beside the Q tile, and later tiles' loads overlap earlier tiles' products.
//   Warp 0 reads the bias row with one coalesced load a lane per 32 keys, all issued
//   before the first is used.
// Rounding points of the bf16 instances: only P (to bf16, before P.V) and o (one cast
// at the end); the scores, the softmax statistics, l and the O accumulators stay f32.
// P in [0, 1] rounded to bf16 is off by at most 2^-9 relative, and the row sum l is
// taken from the unrounded values, so o moves by well under 1e-2 where the outputs'
// own bf16 ulp near 1 is 2^-7: inside the 2e-2 bar (tests/test_torch_flash_tiles.py
// emulates these rounding points against the plain version).
// The f32 instances (no main path runs them; they are held to the 1e-4 bar, which TF32
// products cannot meet) keep FP32-pipe arithmetic with the same tile order and the same
// staging: a warp of 16 rows, two lanes per row each holding half of q and of the
// accumulator, one shuffle to add the halves of each dot product.

#include "flash_common.cuh"

namespace {

using flash::Strides;
using bf16 = __nv_bfloat16;

constexpr int kStages = 4;  // K/V ring depth: a sequence's one to three live tiles all in flight

// The K rows, then the V rows, of one 16-key tile into a stage of the ring.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_kv_tile(T* stage, const T* kp, long long k_st, const T* vp,
                                             long long v_st, int tile, int t) {
  const int k0 = tile * flash::kKeyTile;
  flash::load_rows<T, D, flash::kKeyTile, LD>(stage, kp, k_st, k0, t, threadIdx.x, blockDim.x);
  flash::load_rows<T, D, flash::kKeyTile, LD>(stage + flash::kKeyTile * LD, vp, v_st, k0, t,
                                              threadIdx.x, blockDim.x);
}

// The bf16 kernel's block: 4 warps of 16 query rows; shared memory holds the Q tile
// and kStages stages of K and V tiles, rows padded by 8 elements, then the tile order.
template <int D>
struct FwdMma {
  static constexpr int kWarps = 4;
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kLd = D + 8;
  static constexpr int kQElems = kRows * kLd;
  static constexpr int kKvElems = flash::kKeyTile * kLd;  // one K or V tile
  static constexpr int kBytes = (kQElems + kStages * 2 * kKvElems) * 2;
};

template <int D>
__global__ void __launch_bounds__(FwdMma<D>::kWarps * 32)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ bias,
                         bf16* __restrict__ o, float* __restrict__ lse, int t, int h,
                         Strides qs, Strides ks, Strides vs, float scale) {
  using C = FwdMma<D>;
  constexpr int kLd = C::kLd;
  constexpr int kTile = flash::kKeyTile;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = q_s + C::kQElems;  // [kStages][k, v][16][kLd]
  int* order = reinterpret_cast<int*>(smem + C::kBytes);
  __shared__ int n_live_s;

  const int bi = blockIdx.z;
  const int hi = blockIdx.y;
  const int q0 = blockIdx.x * C::kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;        // fragment row (and row + 8)
  const int j2 = 2 * (lane % 4);  // fragment column pair
  const bf16* qp = q + bi * qs.b + hi * qs.h;
  const bf16* kp = k + bi * ks.b + hi * ks.h;
  const bf16* vp = v + bi * vs.b + hi * vs.h;
  const float* bp = bias ? bias + static_cast<long long>(bi) * t : nullptr;

  flash::load_rows<bf16, D, C::kRows, kLd>(q_s, qp, qs.t, q0, t, tid, blockDim.x);
  flash::cp_async_commit();
  if (warp == 0) {
    const int n = flash::order_key_tiles(bp, t, order);
    if (lane == 0) n_live_s = n;
  }
  __syncthreads();
  const int n_live = n_live_s;

  for (int i = 0; i < kStages - 1; ++i) {  // the first tiles, one commit group each
    if (i < n_live)
      load_kv_tile<bf16, D, kLd>(kv_s + i * 2 * C::kKvElems, kp, ks.t, vp, vs.t, order[i], t);
    flash::cp_async_commit();
  }
  flash::cp_async_wait<kStages - 1>();  // the Q tile is in
  __syncthreads();

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    flash::ldsm_x4(qf[kk], q_s + (warp * 16 + lane % 16) * kLd + kk * 16 + (lane / 16) * 8);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {flash::kNegInf, flash::kNegInf};
  float l[2] = {0.f, 0.f};

  for (int i = 0; i < n_live; ++i) {
    const int next = i + kStages - 1;
    if (next < n_live)
      load_kv_tile<bf16, D, kLd>(kv_s + (next % kStages) * 2 * C::kKvElems, kp, ks.t, vp, vs.t,
                                 order[next], t);
    flash::cp_async_commit();
    flash::cp_async_wait<kStages - 1>();  // tile i is in
    __syncthreads();
    const bf16* k_s = kv_s + (i % kStages) * 2 * C::kKvElems;
    const bf16* v_s = k_s + C::kKvElems;
    const int k0 = order[i] * kTile;

    // S = Q . K^T for 16 query rows by 16 keys, two 16x8 accumulators
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[4];
      flash::ldsm_x4(b, k_s + ((lane / 16) * 8 + lane % 8) * kLd + kk * 16 + ((lane / 8) % 2) * 8);
      flash::mma(s[0], qf[kk], b[0], b[1]);
      flash::mma(s[1], qf[kk], b[2], b[3]);
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + j2 + (e & 1);
        float x = -INFINITY;  // keys past t carry no weight at all
        if (key < t) x = s[n][e] * scale + (bp != nullptr ? __ldg(bp + key) : 0.f);
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = flash::quad_max(mx[r]);
      alpha[r] = expf(m[r] - mx[r]);
      l[r] *= alpha[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e / 2]);
        l[e / 2] += p;
        s[n][e] = p;
      }
    // O += P . V: P from the accumulators as the A operand, V through ldmatrix.trans
    uint32_t pa[4];
    flash::acc_to_a(pa, s[0], s[1]);
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t b[4];
      flash::ldsm_x4_t(b, v_s + (lane % 16) * kLd + n2 * 16 + (lane / 16) * 8);
      flash::mma(acc[2 * n2], pa, b[0], b[1]);
      flash::mma(acc[2 * n2 + 1], pa, b[2], b[3]);
    }
    __syncthreads();  // every warp is done with this stage
  }

  // o through the warp's own rows of the Q tile (only this warp read them), then
  // 16-byte stores; lse from the lane that holds column 0 of each row
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = fmaxf(flash::quad_sum(l[r]), 1e-30f);
    inv[r] = 1.f / l[r];
  }
  bf16* o_s = q_s + warp * 16 * kLd;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(o_s + (g + 8 * r) * kLd + n * 8 + j2) =
          flash::pack_bf16(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
  __syncwarp();
  constexpr int kChunks = D / 8;
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks;
    const int row = q0 + warp * 16 + r;
    if (row < t)
      *reinterpret_cast<uint4*>(o + ((static_cast<long long>(bi) * t + row) * h + hi) * D +
                                (c % kChunks) * 8) =
          *reinterpret_cast<const uint4*>(o_s + r * kLd + (c % kChunks) * 8);
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      if (row < t) lse[(static_cast<long long>(bi) * h + hi) * t + row] = m[r] + logf(l[r]);
    }
  }
}

// The f32 kernel's block: 4 warps of 16 query rows, two lanes per row; shared memory
// as the bf16 kernel's, in f32, rows padded by 4 elements.
template <int D>
struct FwdF32 {
  static constexpr int kWarps = 4;
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kLd = D + 4;
  static constexpr int kQElems = kRows * kLd;
  static constexpr int kKvElems = flash::kKeyTile * kLd;
  static constexpr int kBytes = (kQElems + kStages * 2 * kKvElems) * 4;
};

template <int D>
__global__ void __launch_bounds__(FwdF32<D>::kWarps * 32)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ bias,
                         float* __restrict__ o, float* __restrict__ lse, int t, int h,
                         Strides qs, Strides ks, Strides vs, float scale) {
  using C = FwdF32<D>;
  constexpr int kLd = C::kLd;
  constexpr int kTile = flash::kKeyTile;
  constexpr int kHalf = D / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* kv_s = q_s + C::kQElems;
  int* order = reinterpret_cast<int*>(smem + C::kBytes);
  __shared__ int n_live_s;

  const int bi = blockIdx.z;
  const int hi = blockIdx.y;
  const int q0 = blockIdx.x * C::kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int half = lane % 2;
  const int row = q0 + warp * 16 + lane / 2;
  const float* qp = q + bi * qs.b + hi * qs.h;
  const float* kp = k + bi * ks.b + hi * ks.h;
  const float* vp = v + bi * vs.b + hi * vs.h;
  const float* bp = bias ? bias + static_cast<long long>(bi) * t : nullptr;

  flash::load_rows<float, D, C::kRows, kLd>(q_s, qp, qs.t, q0, t, tid, blockDim.x);
  flash::cp_async_commit();
  if (warp == 0) {
    const int n = flash::order_key_tiles(bp, t, order);
    if (lane == 0) n_live_s = n;
  }
  __syncthreads();
  const int n_live = n_live_s;

  for (int i = 0; i < kStages - 1; ++i) {  // the first tiles, one commit group each
    if (i < n_live)
      load_kv_tile<float, D, kLd>(kv_s + i * 2 * C::kKvElems, kp, ks.t, vp, vs.t, order[i], t);
    flash::cp_async_commit();
  }
  flash::cp_async_wait<1>();
  __syncthreads();

  float qr[kHalf];
  float acc[kHalf];
#pragma unroll
  for (int e = 0; e < kHalf; ++e) {
    qr[e] = q_s[(warp * 16 + lane / 2) * kLd + half * kHalf + e];
    acc[e] = 0.f;
  }
  float m = flash::kNegInf;
  float l = 0.f;

  for (int i = 0; i < n_live; ++i) {
    const int next = i + kStages - 1;
    if (next < n_live)
      load_kv_tile<float, D, kLd>(kv_s + (next % kStages) * 2 * C::kKvElems, kp, ks.t, vp, vs.t,
                                  order[next], t);
    flash::cp_async_commit();
    flash::cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* k_s = kv_s + (i % kStages) * 2 * C::kKvElems + half * kHalf;
    const float* v_s = k_s + C::kKvElems;
    const int k0 = order[i] * kTile;

    float s[kTile];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kHalf; ++e) dot = fmaf(qr[e], k_s[j * kLd + e], dot);
      dot += __shfl_xor_sync(flash::kFullMask, dot, 1);
      const int key = k0 + j;
      s[j] = key < t ? dot * scale + (bp != nullptr ? __ldg(bp + key) : 0.f) : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = expf(m - mx);
    l *= alpha;
    m = mx;
#pragma unroll
    for (int e = 0; e < kHalf; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = expf(s[j] - m);
      l += p;
#pragma unroll
      for (int e = 0; e < kHalf; ++e) acc[e] = fmaf(p, v_s[j * kLd + e], acc[e]);
    }
    __syncthreads();
  }

  if (row < t) {
    const float l_safe = fmaxf(l, 1e-30f);
    float* op = o + ((static_cast<long long>(bi) * t + row) * h + hi) * D + half * kHalf;
#pragma unroll
    for (int e = 0; e < kHalf; e += 4)
      *reinterpret_cast<float4*>(op + e) =
          make_float4(acc[e] / l_safe, acc[e + 1] / l_safe, acc[e + 2] / l_safe, acc[e + 3] / l_safe);
    if (half == 0) lse[(static_cast<long long>(bi) * h + hi) * t + row] = m + logf(l_safe);
  }
}

template <typename C, typename T, typename Kernel>
cudaError_t launch(Kernel kernel, const void* q, const void* k, const void* v,
                   const void* bias, void* o, void* lse, int b, int t, int h, Strides qs,
                   Strides ks, Strides vs, float scale, cudaStream_t stream) {
  const int tiles = (t + flash::kKeyTile - 1) / flash::kKeyTile;
  const int smem = C::kBytes + tiles * static_cast<int>(sizeof(int));
  const cudaError_t err = flash::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + C::kRows - 1) / C::kRows, h, b);
  kernel<<<grid, C::kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(o), static_cast<float*>(lse), t, h, qs,
      ks, vs, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int dtype, const void* q, const void* k, const void* v, const void* bias,
                     void* o, void* lse, int b, int t, int h, Strides qs, Strides ks,
                     Strides vs, float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch<FwdF32<D>, float>(
        flash_fwd_f32_kernel<D>, q, k, v, bias, o, lse, b, t, h, qs, ks, vs, scale, stream);
  return launch<FwdMma<D>, bf16>(
      flash_fwd_mma_kernel<D>, q, k, v, bias, o, lse, b, t, h, qs, ks, vs, scale, stream);
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
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch_d<16>(dtype, q, k, v, bias, o, lse, b, t, h, qs, ks, vs, scale, s);
    case 32:
      return launch_d<32>(dtype, q, k, v, bias, o, lse, b, t, h, qs, ks, vs, scale, s);
    case 64:
      return launch_d<64>(dtype, q, k, v, bias, o, lse, b, t, h, qs, ks, vs, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
