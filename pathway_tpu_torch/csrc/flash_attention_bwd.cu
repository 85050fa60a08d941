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
// encoder's fused qkv projection). dQ, dK and dV come out [b, t, h, d] in the input type,
// written with their own strides: the encoder's fused route hands over the three thirds
// of one [b, t, 3 h d] dqkv buffer, so no concatenation follows. dbias comes out per
// (batch, head) as [b, h, t] f32, and the wrapper sums it over heads with a torch op, so
// no atomics and the same result every run.
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
// Both kernels use warp-level mma.sync.m16n8k16 (bf16 in, f32 accumulators) with
// ldmatrix (.trans for the operands read along the other axis) in their bf16 instances.
// mma.sync and not wgmma: at ~13 flop per byte the products are not the limit, and
// wgmma's 64-row tiles fit a sequence's one to three live 16-key tiles badly. Both visit
// only the 16-key tiles that hold a key with bias > -5e29: warp 0 of each block orders
// the sequence's tiles, those first (flash_common.cuh). A dead sequence (no real key)
// counts every tile as live, which keeps the P = 1 rule over exactly the t keys given.
// Query rows are never skipped: rows past t get P = 0 in dK/dV and are neither computed
// into dQ nor written; padded rows inside t are rows like any other. Nothing uses
// atomics: each output row is written by one warp, the same bits every run.
//
// The dQ kernel: one block of 4 warps per (64 query rows, head, batch); query rows are
// the M dimension, each warp owns 16 of them.
// - Rows and delta. The block's q, dO and O rows come in through cp.async (16 bytes a
//   thread, neighbouring threads on neighbouring addresses, rows padded by 16 bytes so
//   ldmatrix reads hit distinct banks). Each warp takes its Q and dO A fragments once
//   and keeps them in registers; it takes O's fragments in the same layout, so delta of
//   each row is the sum of products of matching fragment entries (f32, exact products
//   of bf16 pairs) over the row's quad, written once per row: no extra pass over O.
// - Per live 16-key tile: S = Q.K^T and dP = dO.V^T (K and V rows as B fragments), then
//   P = exp(S scale + bias - lse) and dS = P (dP - delta) on the f32 accumulator
//   fragments (the scale applied to the f32 S, not to a rounded Q), and dQ += dS.K with
//   dS moved from the accumulator layout straight into the A operand (K rows through
//   ldmatrix.trans). dQ stays in f32 accumulators, is scaled once at the end and leaves
//   as 16-byte stores through the warp's own O rows in shared memory.
// - Latency and registers. K and V tiles come in through a two-stage cp.async ring
//   shared by the block's warps: the first live tile is in flight beside the q, dO and
//   O rows, and each later one while the one before it is used. At d=32 a thread holds
//   8 + 8 registers of Q and dO fragments and 16 of dQ accumulators; __launch_bounds__
//   caps it at 128 registers (four blocks of 128 threads an SM), without spills. Blocks
//   of four warps and a two-stage ring were kept after timing two, four and eight warps
//   and two to four stages at the train shape (probe_dq_block.py; PERF.md): eight warps
//   were slowest, and deeper rings were no faster.
//
// The dK/dV kernel: keys are the M dimension. Each warp owns 16 keys and, per tile of 16
// query rows, computes S^T = K.Q^T and dP^T = V.dO^T, then P^T = exp(S^T scale + bias -
// lse) and dS^T = P^T (dP^T - delta) on the f32 accumulator fragments, dbias += the row
// sums of dS^T (f32, unrounded), dV += P^T.dO and dK += dS^T.Q with P^T and dS^T moved
// from the accumulator layout straight into the A operand; the scale is applied to the
// f32 dK accumulator at the end. Block x takes tiles 2x and 2x+1 of the sequence's tile
// order, one per warp. A warp whose 16 keys are all masked, in a sequence with a real
// key, writes exact zeros for their dK, dV and dbias and does no products; a block with
// no live tile writes its zeros and ends. The warp's K and V fragments and its f32 dK
// and dV accumulators are spread over 32 lanes (at d=32: 8 + 8 + 16 + 16 registers a
// thread); q, dO, lse and delta tiles come in through a four-stage cp.async ring, so
// three query tiles are in flight while a fourth is used; dK and dV leave as 16-byte
// stores through the warp's own K and V rows in shared memory. Blocks of two warps (32
// keys) measured faster than four or one at the train shape.
//
// Rounding points of the bf16 instances: the factors P^T and dS^T (dK/dV) and dS (dQ)
// enter their products as two bf16 terms each, hi = bf16(x) and lo = bf16(x - hi)
// (about 16 significant bits, two products instead of one), and dQ, dK, dV are rounded
// once at the end; scores, P, dP, dS, delta, dbias and the accumulators stay f32. One
// bf16 term is not enough: on a dead sequence P is 1 for every key and dS is t times a
// live row's, and a single rounding moves dK and dQ past the 2e-2 bar relative to
// max(1, |plain|) (tests/test_torch_flash_tiles.py pins both readings); with two terms
// the products lose no more than the f32 sums do, and what is left is the outputs' own
// rounding.
// The f32 instances (no main path runs them; they are held to the 1e-4 bar, which TF32
// products cannot meet) keep FP32-pipe arithmetic with the same tile order and the same
// staging: two lanes a query row (dQ) or a key (dK/dV), each holding half of its rows.

#include <type_traits>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

using flash::Strides;

// The dQ kernels' block: 4 warps of 16 query rows. Shared memory holds the block's q,
// dO and O rows, then kStages stages of a K tile and a V tile (16 keys each), rows
// padded by 16 bytes, then the tile order. The O rows, once delta is taken, hold each
// warp's dQ rows on their way out.
template <typename T, int D>
struct Dq {
  static constexpr int kD = D;
  static constexpr int kWarps = 4;
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kMinBlocks = 16 / kWarps;  // resident blocks an SM: <= 128 registers a thread
  static constexpr int kLd = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int kRowElems = kRows * kLd;         // the block's q (or dO, or O) rows
  static constexpr int kKvElems = flash::kKeyTile * kLd;  // one K (or V) tile
  static constexpr int kStages = 2;  // K/V ring depth: the next live tile in flight
  static constexpr int kBytes = (3 * kRowElems + kStages * 2 * kKvElems) * static_cast<int>(sizeof(T));
};

template <int D>
using DqMma = Dq<bf16, D>;
template <int D>
using DqF32 = Dq<float, D>;

// What both dQ kernels share: the block's q, dO and O rows, the tile order, and the ring
// of K/V tiles over the live tiles. `prologue(q_s, do_s, o_s)` runs once when the rows
// are in; `compute(k_s, v_s, k0)` once per live tile, k0 its first key.
template <typename C, typename T, typename Prologue, typename Compute>
__device__ __forceinline__ void dq_walk(const T* qp, const T* kp, const T* vp, const T* op,
                                        const T* dop, const float* bp, int t, int q0,
                                        long long q_st, long long k_st, long long v_st,
                                        long long o_st, long long do_st, Prologue prologue,
                                        Compute compute) {
  constexpr int kLd = C::kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + C::kRowElems;
  T* o_s = do_s + C::kRowElems;
  T* kv_s = o_s + C::kRowElems;  // [kStages][k, v][16][kLd]
  int* order = reinterpret_cast<int*>(smem + C::kBytes);
  __shared__ int n_live_s;

  const int tid = threadIdx.x;
  flash::load_rows<T, C::kD, C::kRows, kLd>(q_s, qp, q_st, q0, t, tid, blockDim.x);
  flash::load_rows<T, C::kD, C::kRows, kLd>(do_s, dop, do_st, q0, t, tid, blockDim.x);
  flash::load_rows<T, C::kD, C::kRows, kLd>(o_s, op, o_st, q0, t, tid, blockDim.x);
  flash::cp_async_commit();
  if (tid / 32 == 0) {
    const int n = flash::order_key_tiles(bp, t, order);
    if (tid == 0) n_live_s = n;
  }
  __syncthreads();
  const int n_live = n_live_s;

  for (int i = 0; i < C::kStages - 1; ++i) {  // the first tiles, one commit group each
    if (i < n_live)
      flash::load_kv_tile<T, C::kD, kLd>(kv_s + i * 2 * C::kKvElems, kp, k_st, vp, v_st, order[i], t);
    flash::cp_async_commit();
  }
  flash::cp_async_wait<C::kStages - 1>();  // the q, dO and O rows are in
  __syncthreads();
  prologue(q_s, do_s, o_s);

  for (int i = 0; i < n_live; ++i) {
    const int next = i + C::kStages - 1;
    if (next < n_live)
      flash::load_kv_tile<T, C::kD, kLd>(kv_s + (next % C::kStages) * 2 * C::kKvElems, kp, k_st,
                                         vp, v_st, order[next], t);
    flash::cp_async_commit();
    flash::cp_async_wait<C::kStages - 1>();  // tile i is in
    __syncthreads();
    const T* k_s = kv_s + (i % C::kStages) * 2 * C::kKvElems;
    compute(k_s, k_s + C::kKvElems, order[i] * flash::kKeyTile);
    __syncthreads();  // every warp is done with this stage
  }
}

// dQ on the tensor cores (bf16). Each warp owns 16 query rows: Q and dO A fragments in
// registers, S = Q.K^T and dP = dO.V^T per live 16-key tile, P and dS on the f32
// accumulator fragments, dQ += dS.K with dS as two bf16 terms.
template <int D>
__global__ void __launch_bounds__(DqMma<D>::kWarps * 32, DqMma<D>::kMinBlocks)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const float* __restrict__ bias,
                            const bf16* __restrict__ o, const bf16* __restrict__ dout,
                            const float* __restrict__ lse, float* __restrict__ delta,
                            bf16* __restrict__ dq, int t, int h, Strides qs, Strides ks,
                            Strides vs, Strides os, Strides dos, Strides dqs, float scale) {
  using C = DqMma<D>;
  constexpr int kLd = C::kLd;
  const int bi = blockIdx.z;
  const int hi = blockIdx.y;
  const int q0 = blockIdx.x * C::kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;         // fragment row: query rows g and g + 8 of the warp's 16
  const int j2 = 2 * (lane % 4);  // fragment column pair: keys
  const int row0 = q0 + warp * 16 + g;
  const float* bp = bias ? bias + static_cast<long long>(bi) * t : nullptr;
  const long long stat0 = (static_cast<long long>(bi) * h + hi) * t;

  uint32_t qf[D / 16][4];
  uint32_t dof[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float row_lse[2];
  float row_delta[2];

  auto prologue = [&](const bf16* q_s, const bf16* do_s, const bf16* o_s) {
    // fragment entry e holds row g (e even) or g + 8 (e odd), two columns each
    float dsum[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int at = (warp * 16 + lane % 16) * kLd + kk * 16 + (lane / 16) * 8;
      uint32_t of[4];
      flash::ldsm_x4(qf[kk], q_s + at);
      flash::ldsm_x4(dof[kk], do_s + at);
      flash::ldsm_x4(of, o_s + at);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = flash::unpack_bf16(dof[kk][e]);
        const float2 y = flash::unpack_bf16(of[e]);
        dsum[e & 1] = fmaf(x.y, y.y, fmaf(x.x, y.x, dsum[e & 1]));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      row_delta[r] = flash::quad_sum(dsum[r]);
      row_lse[r] = row < t ? __ldg(lse + stat0 + row) : 0.f;
      if (lane % 4 == 0 && row < t) delta[stat0 + row] = row_delta[r];
    }
  };

  auto compute = [&](const bf16* k_s, const bf16* v_s, int k0) {
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    // S = Q.K^T and dP = dO.V^T: K and V rows are the B operands, not transposed
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int at = ((lane / 16) * 8 + lane % 8) * kLd + kk * 16 + ((lane / 8) % 2) * 8;
      uint32_t b[4];
      flash::ldsm_x4(b, k_s + at);
      flash::mma(s[0], qf[kk], b[0], b[1]);
      flash::mma(s[1], qf[kk], b[2], b[3]);
      flash::ldsm_x4(b, v_s + at);
      flash::mma(dp[0], dof[kk], b[0], b[1]);
      flash::mma(dp[1], dof[kk], b[2], b[3]);
    }
    // P and dS in f32 (dS over S's fragments); keys past t get P = 0
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + n * 8 + j2 + c;
        const float kb = (bp != nullptr && key < t) ? __ldg(bp + key) : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          const float p = key < t ? expf(s[n][e] * scale + kb - row_lse[r]) : 0.f;
          s[n][e] = p * (dp[n][e] - row_delta[r]);
        }
      }
    // dQ += dS.K, dS as two bf16 terms (hi + lo); K rows through ldmatrix.trans
    uint32_t da[4], da_lo[4];
    flash::acc_to_a_split(da, da_lo, s[0], s[1]);
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t b[4];
      flash::ldsm_x4_t(b, k_s + (lane % 16) * kLd + n2 * 16 + (lane / 16) * 8);
      flash::mma(acc[2 * n2], da, b[0], b[1]);
      flash::mma(acc[2 * n2], da_lo, b[0], b[1]);
      flash::mma(acc[2 * n2 + 1], da, b[2], b[3]);
      flash::mma(acc[2 * n2 + 1], da_lo, b[2], b[3]);
    }
  };

  dq_walk<C>(q + bi * qs.b + hi * qs.h, k + bi * ks.b + hi * ks.h, v + bi * vs.b + hi * vs.h,
             o + bi * os.b + hi * os.h, dout + bi * dos.b + hi * dos.h, bp, t, q0, qs.t, ks.t,
             vs.t, os.t, dos.t, prologue, compute);

  // dQ (scaled here, in f32) through the warp's own O rows in shared memory (only this
  // warp read them), then 16-byte stores
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* dq_s = reinterpret_cast<bf16*>(smem) + 2 * C::kRowElems + warp * 16 * kLd;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(dq_s + (g + 8 * r) * kLd + n * 8 + j2) =
          flash::pack_bf16(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  __syncwarp();
  constexpr int kChunks = D / 8;
  bf16* dqp = dq + bi * dqs.b + hi * dqs.h;
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks;
    const int row = q0 + warp * 16 + r;
    if (row < t)
      reinterpret_cast<uint4*>(dqp + row * dqs.t)[c % kChunks] =
          reinterpret_cast<const uint4*>(dq_s + r * kLd)[c % kChunks];
  }
}

// dQ in f32 on the FP32 pipes, with the same tile order and staging: each warp owns 16
// query rows, two lanes a row, each holding half of its q, dO and dQ rows.
template <int D>
__global__ void __launch_bounds__(DqF32<D>::kWarps * 32)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ bias,
                            const float* __restrict__ o, const float* __restrict__ dout,
                            const float* __restrict__ lse, float* __restrict__ delta,
                            float* __restrict__ dq, int t, int h, Strides qs, Strides ks,
                            Strides vs, Strides os, Strides dos, Strides dqs, float scale) {
  using C = DqF32<D>;
  constexpr int kLd = C::kLd;
  constexpr int kHalf = D / 2;
  const int bi = blockIdx.z;
  const int hi = blockIdx.y;
  const int q0 = blockIdx.x * C::kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int half = lane % 2;
  const int row = q0 + warp * 16 + lane / 2;
  const float* bp = bias ? bias + static_cast<long long>(bi) * t : nullptr;
  const long long stat0 = (static_cast<long long>(bi) * h + hi) * t;

  float qr[kHalf];
  float dor[kHalf];
  float acc[kHalf];
  float row_lse = 0.f;
  float row_delta = 0.f;

  auto prologue = [&](const float* q_s, const float* do_s, const float* o_s) {
    const int at = (warp * 16 + lane / 2) * kLd + half * kHalf;
    float dsum = 0.f;
#pragma unroll
    for (int e = 0; e < kHalf; ++e) {
      qr[e] = q_s[at + e];
      dor[e] = do_s[at + e];
      dsum = fmaf(dor[e], o_s[at + e], dsum);
      acc[e] = 0.f;
    }
    row_delta = dsum + __shfl_xor_sync(flash::kFullMask, dsum, 1);
    row_lse = row < t ? __ldg(lse + stat0 + row) : 0.f;
    if (half == 0 && row < t) delta[stat0 + row] = row_delta;
  };

  auto compute = [&](const float* k_s, const float* v_s, int k0) {
#pragma unroll 4
    for (int j = 0; j < flash::kKeyTile; ++j) {
      const float* kr = k_s + j * kLd + half * kHalf;
      const float* vr = v_s + j * kLd + half * kHalf;
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int e = 0; e < kHalf; ++e) {
        s = fmaf(qr[e], kr[e], s);
        dp = fmaf(dor[e], vr[e], dp);
      }
      s += __shfl_xor_sync(flash::kFullMask, s, 1);
      dp += __shfl_xor_sync(flash::kFullMask, dp, 1);
      const int key = k0 + j;
      const float kb = (bp != nullptr && key < t) ? __ldg(bp + key) : 0.f;
      const float p = key < t ? expf(s * scale + kb - row_lse) : 0.f;
      const float ds = p * (dp - row_delta);
#pragma unroll
      for (int e = 0; e < kHalf; ++e) acc[e] = fmaf(ds, kr[e], acc[e]);
    }
  };

  dq_walk<C>(q + bi * qs.b + hi * qs.h, k + bi * ks.b + hi * ks.h, v + bi * vs.b + hi * vs.h,
             o + bi * os.b + hi * os.h, dout + bi * dos.b + hi * dos.h, bp, t, q0, qs.t, ks.t,
             vs.t, os.t, dos.t, prologue, compute);

  if (row < t) {
    float* out = dq + bi * dqs.b + row * dqs.t + hi * dqs.h + half * kHalf;
#pragma unroll
    for (int e = 0; e < kHalf; e += 4)
      *reinterpret_cast<float4*>(out + e) =
          make_float4(acc[e] * scale, acc[e + 1] * scale, acc[e + 2] * scale, acc[e + 3] * scale);
  }
}

// Zeros for the dK and dV rows and the dbias entries of one 16-key tile, by one warp:
// the tile's keys are all masked in a sequence with a real key, so P is exactly 0 for
// each of them from every query row. dkp and dvp point at the (batch, head)'s key 0.
template <typename T, int D>
__device__ __forceinline__ void zero_key_tile(T* dkp, long long dk_st, T* dvp, long long dv_st,
                                              float* dbias, long long stat0, int key0, int t,
                                              int lane) {
  constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;
  for (int c = lane; c < flash::kKeyTile * kChunks; c += 32) {
    const int key = key0 + c / kChunks;
    if (key < t) {
      reinterpret_cast<uint4*>(dkp + key * dk_st)[c % kChunks] = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(dvp + key * dv_st)[c % kChunks] = make_uint4(0, 0, 0, 0);
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
                                         const float* delta, T* dkp, long long dk_st, T* dvp,
                                         long long dv_st, float* dbias, int t, long long stat0,
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
    zero_key_tile<T, C::kD>(dkp, dk_st, dvp, dv_st, dbias, stat0, tile * flash::kKeyTile, t, lane);
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
                             Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
                             Strides dvs, float scale) {
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
  const long long stat0 = (static_cast<long long>(bi) * h + hi) * t;
  bf16* dkp = dk + bi * dks.b + hi * dks.h;  // key 0 of this (batch, head)
  bf16* dvp = dv + bi * dvs.b + hi * dvs.h;

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
                   dout + bi * dos.b + hi * dos.h, bp, lse, delta, dkp, dks.t, dvp, dvs.t, dbias,
                   t, stat0, qs, ks, dos, vs.t, tile, prologue, compute))
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
      reinterpret_cast<uint4*>(dkp + key * dks.t)[c % kChunks] = reinterpret_cast<const uint4*>(dk_s + r * kLd)[c % kChunks];
      reinterpret_cast<uint4*>(dvp + key * dvs.t)[c % kChunks] = reinterpret_cast<const uint4*>(dv_s + r * kLd)[c % kChunks];
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
                             Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
                             Strides dvs, float scale) {
  using C = DkvF32<D>;
  constexpr int kLd = C::kLd;
  constexpr int kQt = C::kQt;
  constexpr int kHalf = D / 2;
  const int bi = blockIdx.z;
  const int hi = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int half = lane % 2;
  const float* bp = bias ? bias + static_cast<long long>(bi) * t : nullptr;
  const long long stat0 = (static_cast<long long>(bi) * h + hi) * t;
  float* dkp = dk + bi * dks.b + hi * dks.h;
  float* dvp = dv + bi * dvs.b + hi * dvs.h;

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
                   dout + bi * dos.b + hi * dos.h, bp, lse, delta, dkp, dks.t, dvp, dvs.t, dbias,
                   t, stat0, qs, ks, dos, vs.t, tile, prologue, compute))
    return;

  const int key = tile * flash::kKeyTile + lane / 2;
  if (key < t) {
    float* dk_row = dkp + key * dks.t + half * kHalf;
    float* dv_row = dvp + key * dvs.t + half * kHalf;
#pragma unroll
    for (int e = 0; e < kHalf; e += 4) {
      *reinterpret_cast<float4*>(dk_row + e) =
          make_float4(dkr[e] * scale, dkr[e + 1] * scale, dkr[e + 2] * scale, dkr[e + 3] * scale);
      *reinterpret_cast<float4*>(dv_row + e) = make_float4(dvr[e], dvr[e + 1], dvr[e + 2], dvr[e + 3]);
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

template <typename C, typename T, typename Kernel>
cudaError_t launch_dq(Kernel kernel, const DqArgs& a, int b, int t, int h, const Strides* st,
                      float scale, cudaStream_t stream) {
  const int tiles = (t + flash::kKeyTile - 1) / flash::kKeyTile;
  const int smem = C::kBytes + tiles * static_cast<int>(sizeof(int));
  const cudaError_t err = flash::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + C::kRows - 1) / C::kRows, h, b);
  kernel<<<grid, C::kWarps * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.bias), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<float*>(a.delta), static_cast<T*>(a.dq), t, h, st[0], st[1], st[2], st[3],
      st[4], st[5], scale);
  return cudaGetLastError();
}

template <typename T, int D>
struct DqLaunch {
  static cudaError_t run(const DqArgs& a, int b, int t, int h, const Strides* st, float scale,
                         cudaStream_t stream) {
    if constexpr (std::is_same_v<T, float>)
      return launch_dq<DqF32<D>, float>(flash_bwd_dq_f32_kernel<D>, a, b, t, h, st, scale, stream);
    else
      return launch_dq<DqMma<D>, bf16>(flash_bwd_dq_mma_kernel<D>, a, b, t, h, st, scale, stream);
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
      st[1], st[2], st[3], st[4], st[5], scale);
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
// host array of (b, t, h) strides in elements, one triple per strided tensor in the
// order of the pointers, inputs then outputs (dQ: q, k, v, o, dout, dq; dK/dV: q, k, v,
// dout, dk, dv); every [b, t, h, d] tensor has unit stride along d, a 16-byte aligned
// base and strides in multiples of 16 bytes. bias is [b, t] f32 contiguous, or null for
// no mask; lse and delta are [b, h, t] f32 contiguous; dbias is [b, h, t] f32. Each
// launches on `stream` and returns cudaGetLastError().
extern "C" int pt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                         const void* bias, const void* o, const void* dout,
                                         const void* lse, void* delta, void* dq, int dtype,
                                         int b, int t, int h, int d, const long long* strides,
                                         float scale, void* stream) {
  Strides st[6];
  for (int i = 0; i < 6; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const DqArgs a{q, k, v, bias, o, dout, lse, delta, dq};
  return dispatch<DqLaunch>(dtype, d, a, b, t, h, st, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int pt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                          const void* bias, const void* dout, const void* lse,
                                          const void* delta, void* dk, void* dv, void* dbias,
                                          int dtype, int b, int t, int h, int d,
                                          const long long* strides, float scale,
                                          void* stream) {
  Strides st[6];
  for (int i = 0; i < 6; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const DkvArgs a{q, k, v, bias, dout, lse, delta, dk, dv, dbias};
  return dispatch<DkvLaunch>(dtype, d, a, b, t, h, st, scale, static_cast<cudaStream_t>(stream));
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
