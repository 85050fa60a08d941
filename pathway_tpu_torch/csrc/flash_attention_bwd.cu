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
//   s_ij  = (q_i . k_j) * scale + bias_j      (bias: 0 or -1e30 per key, f32)
//   P_ij  = exp(s_ij - lse_i)                 (the softmax, recomputed from lse)
//   dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - delta_i),  delta_i = dO_i . O_i
//   dQ_i  = scale * sum_j dS_ij k_j                       (dQ kernel)
//   dV_j  = sum_i P_ij dO_i,  dK_j = scale * sum_i dS_ij q_i,
//   dbias_j = sum_i dS_ij                                  (dK/dV kernel)
// The dQ kernel also computes delta from dO and O and writes it ([b, h, t] f32) for the
// dK/dV kernel, which runs after it on the same stream; the TPU glue's separate
// elementwise pass and its f32 copy of dO * O are gone. q, k, v, O and dO are
// [b, t, h, d] in bf16 or f32, read with their own strides (q, k, v are views of the
// encoder's fused qkv projection). dQ, dK and dV come out [b, t, h, d] contiguous in
// the input type; dbias comes out per (batch, head) as [b, h, t] f32, and the wrapper
// sums it over heads with a torch op, so no atomics and the same result every run.
// Masked keys get P = 0 exactly for every row with a real key, so their dK, dV and
// dbias are exact zeros. A fully masked query row has lse = -1e30 + log t, which rounds
// to -1e30 in f32, so its P is 1 for every key (not 1/t): the TPU kernel's rule, kept;
// keys past t are never read.
//
// What bounds them on an H100: bytes. At the train shape (b=1024 sequences, t=128,
// h=12, d=32, bf16, a few to 34 real keys of 128) the dQ kernel must read q, dO, O (for
// delta) and lse, and write dQ and delta, for every row, but read k and v only for the
// real keys; the dK/dV kernel reads q, dO, lse and delta for every row and k and v for
// the real keys, and writes dK, dV and dbias for every key. That is ~0.45 GB each,
// ~0.135 ms at 3.35 TB/s, against ~5-6 GFLOP over the real keys (~13 flop per byte,
// far below the bf16 ridge of ~295): on the tensor cores the products are nearly free
// (chip_smoke.py computes the exact bounds from its run's mask).
//
// The dQ kernel: one block per (128 query rows, head, batch), one thread per query row
// with its row's operands and f32 accumulator in registers (two neighbouring threads
// share a row at d = 64 and add their partial dot products with one shuffle); k and v
// staged through shared memory as f32 in tiles of 32 keys and read back as broadcasts.
// Its products run on the FP32 pipes and it walks every key tile; its redesign (tensor
// cores, tile skipping, writing dq, dk and dv into one buffer) is the next step.
//
// The dK/dV kernel, redesigned for this card; what it does about the earlier design's
// limits (one thread per key row on the FP32 pipes, every key block walking every query
// tile, 217 registers a thread):
// - Tensor cores. The bf16 instances use warp-level mma.sync.m16n8k16 (bf16 in, f32
//   accumulators) with ldmatrix (.trans for the operands read along the query axis).
//   Keys are the M dimension: each warp owns 16 keys and, per tile of 16 query rows,
//   computes S^T = K.Q^T and dP^T = V.dO^T, then P^T = exp(S^T scale +
//   bias - lse) and dS^T = P^T (dP^T - delta) on the f32 accumulator fragments,
//   dbias += the row sums of dS^T (f32, unrounded), dV += P^T.dO and dK += dS^T.Q
//   with P^T and dS^T moved from the accumulator layout straight into the A operand,
//   each as two bf16 terms (below); the scale is applied to the f32 dK accumulator at
//   the end. mma.sync and not wgmma: at ~13 flop per byte the products are not the
//   limit, and wgmma's 64-row tiles fit a sequence's one to three live 16-key tiles
//   badly.
// - Masked key tiles. Warp 0 orders the sequence's 16-key tiles, those holding a key
//   with bias > -5e29 first (flash_common.cuh), and block x takes tiles 2x and 2x+1 of
//   that order, one per warp. A warp whose 16 keys are all masked, in a sequence with
//   a real key, writes exact zeros for their dK, dV and dbias and does no products; a
//   block with no live tile writes its zeros and ends. A dead sequence keeps the P = 1
//   rule over all t keys (all its tiles are live). Query rows are never skipped: rows
//   past t get P = 0, padded rows inside t attend as any other.
// - Registers and latency. The warp's K and V fragments and its f32 dK and dV
//   accumulators are spread over 32 lanes (at d=32: 8 + 8 + 16 + 16 registers a
//   thread, 95 in all); q, dO, lse and delta tiles come in through a four-stage
//   cp.async ring (16 bytes a thread for q and dO, neighbouring threads on neighbouring
//   addresses, rows padded by 16 bytes so ldmatrix reads hit distinct banks), so three
//   query tiles are in flight while a fourth is used; dK and dV leave as 16-byte stores
//   through the warp's own K and V rows in shared memory. Blocks of two warps (32
//   keys) measured faster than four or one at the train shape. Nothing uses atomics:
//   the same bits every run.
// Rounding points of the bf16 instances: P^T and dS^T enter the dV and dK products as
// two bf16 terms each, hi = bf16(x) and lo = bf16(x - hi) (about 16 significant bits,
// two products instead of one), and dK, dV are rounded once at the end; scores, P, dP,
// dS, dbias and the accumulators stay f32. One bf16 term is not enough: on a dead
// sequence P is 1 for every key and dS is t times a live row's, and a single rounding
// of dS^T moves dK past the 2e-2 bar relative to max(1, |plain|)
// (tests/test_torch_flash_tiles.py pins both readings); with two terms the products
// lose no more than the f32 sums do, and what is left is the outputs' own rounding.
// The f32 instances (no main path runs them; they are held to the 1e-4 bar, which TF32
// products cannot meet) keep FP32-pipe arithmetic with the same tile order and staging:
// two lanes a key, each holding half of its k, v, dK and dV rows.

#include <type_traits>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockRows = 128;  // query rows per dQ block
constexpr int kTile = 32;        // keys per shared-memory tile of the dQ kernel

using flash::Strides;

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
  for (int off = 1; off < Split<D>::kThreads; off <<= 1) x += __shfl_xor_sync(flash::kFullMask, x, off);
  return x;
}

// Rows r0 .. r0+n-1 of a [b, t, h, d] operand (base already at its batch and head)
// into a shared tile as f32, by all threads of the block; rows past n are zero.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* base, long long row_stride, int r0, int n,
                                           float (*tile)[Split<D>::kRow]) {
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
    for (int e = 0; e < kVec; ++e) dst[e] = x[e];
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
    stage_rows<T, D>(kp, ks.t, k0, nk, k_tile);
    stage_rows<T, D>(vp, vs.t, k0, nk, v_tile);
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

// Zeros for the dK and dV rows and the dbias entries of one 16-key tile, by one warp:
// the tile's keys are all masked in a sequence with a real key, so P is exactly 0 for
// each of them from every query row.
template <typename T, int D>
__device__ __forceinline__ void zero_key_tile(T* dk, T* dv, float* dbias, long long row0,
                                              long long stat0, int key0, int t, int h,
                                              int lane) {
  constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;
  for (int c = lane; c < flash::kKeyTile * kChunks; c += 32) {
    const int key = key0 + c / kChunks;
    if (key < t) {
      const long long at = (row0 + static_cast<long long>(key) * h) * D;
      reinterpret_cast<uint4*>(dk + at)[c % kChunks] = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(dv + at)[c % kChunks] = make_uint4(0, 0, 0, 0);
    }
  }
  if (lane < flash::kKeyTile && key0 + lane < t) dbias[stat0 + key0 + lane] = 0.f;
}

// The dK/dV kernels' block: 2 warps of 16 keys each, the block's share of the ordered
// key tiles (flash_common.cuh: tiles holding a real key first). Shared memory holds
// the block's K and V rows, then kStages stages of (q tile, dO tile, lse, delta), rows
// padded by 16 bytes, then the tile order. T is the element type, kQt the query rows
// per stage.
template <typename T, int D, int Qt>
struct Dkv {
  static constexpr int kD = D;
  static constexpr int kWarps = 2;
  static constexpr int kKeys = flash::kKeyTile * kWarps;
  static constexpr int kLd = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int kQt = Qt;
  static constexpr int kKvElems = kKeys * kLd;  // the block's K (or V) rows
  static constexpr int kTileElems = kQt * kLd;  // one q (or dO) tile
  static constexpr int kStageBytes = 2 * kTileElems * static_cast<int>(sizeof(T)) + 2 * kQt * 4;
  static constexpr int kStages = 4;  // query-side ring depth: three tiles in flight
  static constexpr int kBytes = 2 * kKvElems * static_cast<int>(sizeof(T)) + kStages * kStageBytes;
};

template <int D>
using DkvMma = Dkv<bf16, D, 16>;
template <int D>
using DkvF32 = Dkv<float, D, 16>;

// What both dK/dV kernels share: the tile order, the zeros of masked tiles, the K and
// V rows of the warps' live tiles, and the ring of query-side stages. `compute(stage,
// q0)` runs once per stage on the live warps; `prologue()` once after the K and V rows
// are in. Returns false for a warp with no live tile (it has already written its zeros).
template <typename C, typename T, typename Prologue, typename Compute>
__device__ __forceinline__ bool dkv_walk(const T* qp, const T* kp, const T* vp,
                                         const T* dop, const float* bp, const float* lse,
                                         const float* delta, T* dk, T* dv, float* dbias,
                                         int t, int h, long long row0, long long stat0,
                                         const Strides& qs, const Strides& ks,
                                         const Strides& dos, long long v_st, int& tile,
                                         Prologue prologue, Compute compute) {
  constexpr int kLd = C::kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + C::kKvElems;
  unsigned char* stages = smem + 2 * C::kKvElems * sizeof(T);
  int* order = reinterpret_cast<int*>(smem + C::kBytes);
  __shared__ int n_live_s;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (warp == 0) {
    const int n = flash::order_key_tiles(bp, t, order);
    if (lane == 0) n_live_s = n;
  }
  __syncthreads();
  const int n_live = n_live_s;
  const int tiles = (t + flash::kKeyTile - 1) / flash::kKeyTile;
  const int slot = blockIdx.x * C::kWarps + warp;
  tile = slot < tiles ? order[slot] : -1;
  const bool live = slot < n_live;
  if (tile >= 0 && !live)
    zero_key_tile<T, C::kD>(dk, dv, dbias, row0, stat0, tile * flash::kKeyTile, t, h, lane);
  if (static_cast<int>(blockIdx.x) * C::kWarps >= n_live) return false;  // the whole block

  if (live) {
    const int key0 = tile * flash::kKeyTile;
    flash::load_rows<T, C::kD, flash::kKeyTile, kLd>(k_s + warp * flash::kKeyTile * kLd,
                                                               kp, ks.t, key0, t, lane, 32);
    flash::load_rows<T, C::kD, flash::kKeyTile, kLd>(v_s + warp * flash::kKeyTile * kLd,
                                                               vp, v_st, key0, t, lane, 32);
  }
  auto load_stage = [&](int it, int stage) {
    T* q_t = reinterpret_cast<T*>(stages + stage * C::kStageBytes);
    T* do_t = q_t + C::kTileElems;
    float* lse_t = reinterpret_cast<float*>(do_t + C::kTileElems);
    const int q0 = it * C::kQt;
    flash::load_rows<T, C::kD, C::kQt, kLd>(q_t, qp, qs.t, q0, t, tid, blockDim.x);
    flash::load_rows<T, C::kD, C::kQt, kLd>(do_t, dop, dos.t, q0, t, tid, blockDim.x);
    flash::load_stats<C::kQt>(lse_t, lse + stat0, q0, t, tid, blockDim.x);
    flash::load_stats<C::kQt>(lse_t + C::kQt, delta + stat0, q0, t, tid, blockDim.x);
  };
  const int nq = (t + C::kQt - 1) / C::kQt;
  for (int it = 0; it < C::kStages - 1; ++it) {  // the first query tiles, a group each
    if (it < nq) load_stage(it, it);
    flash::cp_async_commit();
  }
  flash::cp_async_wait<C::kStages - 2>();  // K, V and query tile 0 are in
  __syncthreads();
  if (live) prologue(k_s + warp * flash::kKeyTile * kLd, v_s + warp * flash::kKeyTile * kLd);

  for (int it = 0; it < nq; ++it) {
    const int next = it + C::kStages - 1;
    if (next < nq) load_stage(next, next % C::kStages);
    flash::cp_async_commit();
    flash::cp_async_wait<C::kStages - 1>();  // query tile it is in
    __syncthreads();
    if (live) compute(reinterpret_cast<const T*>(stages + (it % C::kStages) * C::kStageBytes), it * C::kQt);
    __syncthreads();  // every warp is done with this stage
  }
  return live;
}

// dK/dV on the tensor cores (bf16). Each live warp owns 16 keys (the M dimension) and
// walks every query tile: S^T = K.Q^T and dP^T = V.dO^T on mma.sync, P^T and dS^T on
// the f32 accumulator fragments, then dV += P^T.dO and dK += dS^T.Q with P^T and dS^T
// rounded to bf16 and moved straight into the A operand.
template <int D>
__global__ void __launch_bounds__(DkvMma<D>::kWarps * 32)
    flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const float* __restrict__ bias,
                             const bf16* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ delta, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, float* __restrict__ dbias, int t, int h,
                             Strides qs, Strides ks, Strides vs, Strides dos, float scale) {
  using C = DkvMma<D>;
  constexpr int kLd = C::kLd;
  constexpr int kQt = C::kQt;
  constexpr int kNt = kQt / 8;  // 16x8 accumulators per query tile
  const int bi = blockIdx.z;
  const int hi = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;         // fragment row: keys g and g + 8 of the warp's tile
  const int j2 = 2 * (lane % 4);  // fragment column pair: query rows
  const float* bp = bias ? bias + static_cast<long long>(bi) * t : nullptr;
  const long long row0 = static_cast<long long>(bi) * t * h + hi;  // [b, t, h, d] row of key 0
  const long long stat0 = (static_cast<long long>(bi) * h + hi) * t;

  uint32_t kf[D / 16][4];
  uint32_t vf[D / 16][4];
  float dk_acc[D / 8][4];
  float dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  float kb[2] = {0.f, 0.f};  // the bias of keys g and g + 8
  float db[2] = {0.f, 0.f};
  int tile = -1;

  auto prologue = [&](const bf16* k_rows, const bf16* v_rows) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int at = (lane % 16) * kLd + kk * 16 + (lane / 16) * 8;
      flash::ldsm_x4(kf[kk], k_rows + at);
      flash::ldsm_x4(vf[kk], v_rows + at);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = tile * flash::kKeyTile + g + 8 * r;
      kb[r] = (bp != nullptr && key < t) ? __ldg(bp + key) : 0.f;
    }
  };

  auto compute = [&](const bf16* q_t, int q0) {
    const bf16* do_t = q_t + C::kTileElems;
    const float* lse_t = reinterpret_cast<const float*>(do_t + C::kTileElems);
    const float* delta_t = lse_t + kQt;
    float s[kNt][4];
    float dp[kNt][4];
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    // S^T = K.Q^T and dP^T = V.dO^T: Q and dO rows are the B operands, not transposed
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int np = 0; np < kNt / 2; ++np) {
        const int at = (np * 16 + (lane / 16) * 8 + lane % 8) * kLd + kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t b[4];
        flash::ldsm_x4(b, q_t + at);
        flash::mma(s[2 * np], kf[kk], b[0], b[1]);
        flash::mma(s[2 * np + 1], kf[kk], b[2], b[3]);
        flash::ldsm_x4(b, do_t + at);
        flash::mma(dp[2 * np], vf[kk], b[0], b[1]);
        flash::mma(dp[2 * np + 1], vf[kk], b[2], b[3]);
      }
    // P^T and dS^T in f32; query rows past t get P = 0
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + j2 + (e & 1);
        const float p = q0 + col < t ? expf(s[n][e] * scale + kb[e / 2] - lse_t[col]) : 0.f;
        const float ds = p * (dp[n][e] - delta_t[col]);
        db[e / 2] += ds;
        s[n][e] = p;
        dp[n][e] = ds;
      }
    // dV += P^T.dO and dK += dS^T.Q, P^T and dS^T each as two bf16 terms (hi + lo);
    // dO and Q rows through ldmatrix.trans
#pragma unroll
    for (int j = 0; j < kQt / 16; ++j) {
      uint32_t pa[4], pa_lo[4], da[4], da_lo[4];
      flash::acc_to_a_split(pa, pa_lo, s[2 * j], s[2 * j + 1]);
      flash::acc_to_a_split(da, da_lo, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        const int at = (j * 16 + lane % 16) * kLd + n2 * 16 + (lane / 16) * 8;
        uint32_t b[4];
        flash::ldsm_x4_t(b, do_t + at);
        flash::mma(dv_acc[2 * n2], pa, b[0], b[1]);
        flash::mma(dv_acc[2 * n2], pa_lo, b[0], b[1]);
        flash::mma(dv_acc[2 * n2 + 1], pa, b[2], b[3]);
        flash::mma(dv_acc[2 * n2 + 1], pa_lo, b[2], b[3]);
        flash::ldsm_x4_t(b, q_t + at);
        flash::mma(dk_acc[2 * n2], da, b[0], b[1]);
        flash::mma(dk_acc[2 * n2], da_lo, b[0], b[1]);
        flash::mma(dk_acc[2 * n2 + 1], da, b[2], b[3]);
        flash::mma(dk_acc[2 * n2 + 1], da_lo, b[2], b[3]);
      }
    }
  };

  if (!dkv_walk<C>(q + bi * qs.b + hi * qs.h, k + bi * ks.b + hi * ks.h, v + bi * vs.b + hi * vs.h,
                   dout + bi * dos.b + hi * dos.h, bp, lse, delta, dk, dv, dbias, t, h, row0,
                   stat0, qs, ks, dos, vs.t, tile, prologue, compute))
    return;

  // dK (scaled here, in f32) and dV through the warp's own K and V rows in shared
  // memory (only this warp read them), then 16-byte stores; dbias from column 0's lane
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* dk_s = reinterpret_cast<bf16*>(smem) + warp * flash::kKeyTile * kLd;
  bf16* dv_s = dk_s + C::kKvElems;
#pragma unroll
  for (int r = 0; r < 2; ++r) db[r] = flash::quad_sum(db[r]);
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int at = (g + 8 * r) * kLd + n * 8 + j2;
      *reinterpret_cast<uint32_t*>(dk_s + at) =
          flash::pack_bf16(dk_acc[n][2 * r] * scale, dk_acc[n][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv_s + at) = flash::pack_bf16(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  __syncwarp();
  constexpr int kChunks = D / 8;
  for (int c = lane; c < flash::kKeyTile * kChunks; c += 32) {
    const int r = c / kChunks;
    const int key = tile * flash::kKeyTile + r;
    if (key < t) {
      const long long at = (row0 + static_cast<long long>(key) * h) * D;
      reinterpret_cast<uint4*>(dk + at)[c % kChunks] = reinterpret_cast<const uint4*>(dk_s + r * kLd)[c % kChunks];
      reinterpret_cast<uint4*>(dv + at)[c % kChunks] = reinterpret_cast<const uint4*>(dv_s + r * kLd)[c % kChunks];
    }
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = tile * flash::kKeyTile + g + 8 * r;
      if (key < t) dbias[stat0 + key] = db[r];
    }
  }
}

// dK/dV in f32 on the FP32 pipes, with the same tile order and staging: each live warp
// owns 16 keys, two lanes a key, each holding half of its k, v, dK and dV rows.
template <int D>
__global__ void __launch_bounds__(DkvF32<D>::kWarps * 32)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ bias,
                             const float* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ delta, float* __restrict__ dk,
                             float* __restrict__ dv, float* __restrict__ dbias, int t, int h,
                             Strides qs, Strides ks, Strides vs, Strides dos, float scale) {
  using C = DkvF32<D>;
  constexpr int kLd = C::kLd;
  constexpr int kQt = C::kQt;
  constexpr int kHalf = D / 2;
  const int bi = blockIdx.z;
  const int hi = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int half = lane % 2;
  const float* bp = bias ? bias + static_cast<long long>(bi) * t : nullptr;
  const long long row0 = static_cast<long long>(bi) * t * h + hi;
  const long long stat0 = (static_cast<long long>(bi) * h + hi) * t;

  float kr[kHalf];
  float vr[kHalf];
  float dkr[kHalf];
  float dvr[kHalf];
#pragma unroll
  for (int e = 0; e < kHalf; ++e) dkr[e] = dvr[e] = 0.f;
  float kb = 0.f;
  float db = 0.f;
  int tile = -1;

  auto prologue = [&](const float* k_rows, const float* v_rows) {
#pragma unroll
    for (int e = 0; e < kHalf; ++e) {
      kr[e] = k_rows[(lane / 2) * kLd + half * kHalf + e];
      vr[e] = v_rows[(lane / 2) * kLd + half * kHalf + e];
    }
    const int key = tile * flash::kKeyTile + lane / 2;
    kb = (bp != nullptr && key < t) ? __ldg(bp + key) : 0.f;
  };

  auto compute = [&](const float* stage, int q0) {
    const float* q_t = stage + half * kHalf;
    const float* do_t = stage + C::kTileElems + half * kHalf;
    const float* lse_t = stage + 2 * C::kTileElems;
    const float* delta_t = lse_t + kQt;
#pragma unroll
    for (int i = 0; i < kQt; ++i) {
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int e = 0; e < kHalf; ++e) {
        s = fmaf(q_t[i * kLd + e], kr[e], s);
        dp = fmaf(do_t[i * kLd + e], vr[e], dp);
      }
      s += __shfl_xor_sync(flash::kFullMask, s, 1);
      dp += __shfl_xor_sync(flash::kFullMask, dp, 1);
      const float p = q0 + i < t ? expf(s * scale + kb - lse_t[i]) : 0.f;
      const float ds = p * (dp - delta_t[i]);
#pragma unroll
      for (int e = 0; e < kHalf; ++e) {
        dvr[e] = fmaf(p, do_t[i * kLd + e], dvr[e]);
        dkr[e] = fmaf(ds, q_t[i * kLd + e], dkr[e]);
      }
      db += ds;
    }
  };

  if (!dkv_walk<C>(q + bi * qs.b + hi * qs.h, k + bi * ks.b + hi * ks.h, v + bi * vs.b + hi * vs.h,
                   dout + bi * dos.b + hi * dos.h, bp, lse, delta, dk, dv, dbias, t, h, row0,
                   stat0, qs, ks, dos, vs.t, tile, prologue, compute))
    return;

  const int key = tile * flash::kKeyTile + lane / 2;
  if (key < t) {
    const long long at = (row0 + static_cast<long long>(key) * h) * D + half * kHalf;
#pragma unroll
    for (int e = 0; e < kHalf; e += 4) {
      *reinterpret_cast<float4*>(dk + at + e) =
          make_float4(dkr[e] * scale, dkr[e + 1] * scale, dkr[e + 2] * scale, dkr[e + 3] * scale);
      *reinterpret_cast<float4*>(dv + at + e) = make_float4(dvr[e], dvr[e + 1], dvr[e + 2], dvr[e + 3]);
    }
    if (half == 0) dbias[stat0 + key] = db;
  }
}

// One launch of a kernel for the runtime dtype (0 = float32, 1 = bfloat16) and head
// dim: Launch<T, D>::run.
template <template <typename, int> class Launch, typename Args>
cudaError_t dispatch(int dtype, int d, const Args& a, int b, int t, int h, const Strides* st,
                     float scale, cudaStream_t stream) {
  if (b <= 0 || t <= 0 || h <= 0 || b > 65535 || h > 65535) return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (d == 16) return Launch<float, 16>::run(a, b, t, h, st, scale, stream);
    if (d == 32) return Launch<float, 32>::run(a, b, t, h, st, scale, stream);
    if (d == 64) return Launch<float, 64>::run(a, b, t, h, st, scale, stream);
  } else if (dtype == 1) {
    if (d == 16) return Launch<bf16, 16>::run(a, b, t, h, st, scale, stream);
    if (d == 32) return Launch<bf16, 32>::run(a, b, t, h, st, scale, stream);
    if (d == 64) return Launch<bf16, 64>::run(a, b, t, h, st, scale, stream);
  }
  return cudaErrorInvalidValue;
}

struct DqArgs {
  const void *q, *k, *v, *bias, *o, *dout, *lse;
  void *delta, *dq;
};

template <typename T, int D>
struct Dq {
  static cudaError_t run(const DqArgs& a, int b, int t, int h, const Strides* st, float scale,
                         cudaStream_t stream) {
    const dim3 grid((t + kBlockRows - 1) / kBlockRows, h, b);
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

template <typename C, typename T, typename Kernel>
cudaError_t launch_dkv(Kernel kernel, const DkvArgs& a, int b, int t, int h, const Strides* st,
                       float scale, cudaStream_t stream) {
  const int tiles = (t + flash::kKeyTile - 1) / flash::kKeyTile;
  const int smem = C::kBytes + tiles * static_cast<int>(sizeof(int));
  const cudaError_t err = flash::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tiles + C::kWarps - 1) / C::kWarps, h, b);
  kernel<<<grid, C::kWarps * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.bias), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), static_cast<float*>(a.dbias), t, h, st[0],
      st[1], st[2], st[3], scale);
  return cudaGetLastError();
}

template <typename T, int D>
struct DkvLaunch {
  static cudaError_t run(const DkvArgs& a, int b, int t, int h, const Strides* st, float scale,
                         cudaStream_t stream) {
    if constexpr (std::is_same_v<T, float>)
      return launch_dkv<DkvF32<D>, float>(flash_bwd_dkv_f32_kernel<D>, a, b, t, h, st, scale, stream);
    else
      return launch_dkv<DkvMma<D>, bf16>(flash_bwd_dkv_mma_kernel<D>, a, b, t, h, st, scale, stream);
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
  return dispatch<DkvLaunch>(dtype, d, a, b, t, h, st, scale, static_cast<cudaStream_t>(stream));
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
