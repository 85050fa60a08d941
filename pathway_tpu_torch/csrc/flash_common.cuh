// Building blocks shared by the flash-attention kernels (flash_attention_fwd.cu and the
// dK/dV kernel of flash_attention_bwd.cu), for Hopper (sm_90a):
//
// - cp.async copies of 16 bytes (tiles of q, k, v, dO) and 4 bytes (lse, delta) from
//   device memory into shared memory, zero-filling what lies past the sequence;
// - ldmatrix and the warp-level bf16 tensor-core product mma.sync.m16n8k16 (f32
//   accumulators), with the fragment layouts the kernels rely on;
// - the order in which a block visits a sequence's 16-key tiles: those holding a key
//   that carries weight first, so a kernel can stop after them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace flash {

constexpr float kNegInf = -1e30f;   // the mask value, finite: never -inf
constexpr float kLive = -5e29f;     // a key with bias above this carries weight
constexpr int kKeyTile = 16;        // keys per tile: one m16 of the tensor-core product
constexpr unsigned kFullMask = 0xffffffffu;

struct Strides {
  long long b, t, h;  // in elements; the head-dim stride is 1
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst, or 16 zero bytes when `ok` is false (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows r0 .. r0+R-1 of a [t, D] operand (base at its batch and head, rows `stride`
// elements apart) into a shared tile whose rows are LD elements apart, by threads
// tid, tid+n, ... of the caller; rows at or past t become zeros.
template <typename T, int D, int R, int LD>
__device__ __forceinline__ void load_rows(T* tile, const T* base, long long stride, int r0,
                                          int t, int tid, int n) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int i = tid; i < R * kChunks; i += n) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    const bool ok = r0 + r < t;
    cp_async16(tile + r * LD + c, ok ? base + (r0 + r) * stride + c : base, ok);
  }
}

// Entries i0 .. i0+R-1 of an f32 row (lse or delta) into shared memory; past t, zeros.
template <int R>
__device__ __forceinline__ void load_stats(float* dst, const float* row, int i0, int t, int tid,
                                           int n) {
  for (int i = tid; i < R; i += n) {
    const bool ok = i0 + i < t;
    cp_async4(dst + i, ok ? row + i0 + i : row, ok);
  }
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row l % 8 of
// matrix l / 8 and receives, of each matrix, row l / 4, columns 2 (l % 4) and +1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed: lane l receives rows 2 (l % 4) and +1, column l / 4.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b on the tensor cores: a 16x16 bf16 (row-major fragment), b 16x8 bf16
// (column-major fragment), c 16x8 f32. With g = lane / 4 and j = 2 (lane % 4):
//   a = {A[g][j..j+1], A[g+8][j..j+1], A[g][j+8..j+9], A[g+8][j+8..j+9]}
//   b = {B[j..j+1][g], B[j+8..j+9][g]}
//   c = {C[g][j], C[g][j+1], C[g+8][j], C[g+8][j+1]}
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 and packed, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// The A fragment of a 16x16 product from the accumulators of two 16x8 products that
// cover its columns 0-7 (c0) and 8-15 (c1), rounded to bf16: no trip through memory.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// x and y as two bf16 terms each, x = hi + lo with hi = bf16(x) and lo = bf16(x - hi):
// about 16 significant bits, packed as pack_bf16 packs them.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 back = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - back.x, y - back.y);
}

// acc_to_a with each value carried as two bf16 terms (split_bf16), for a factor whose
// products must not lose more than the f32 sums do: two products instead of one.
__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                               const float (&c0)[4], const float (&c1)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// Sum or max over the four lanes of a quad (the lanes that share a fragment row).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 1);
  return x + __shfl_xor_sync(kFullMask, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
}

// Called by one whole warp: writes into `order` (ceil(t / 16) entries, shared) the
// sequence's 16-key tiles, those holding a key with bias > kLive first in ascending
// order, then the others, and returns how many come first. With no bias, or no key
// that carries weight (a dead sequence, whose rows weigh every key alike), every tile
// counts: the tiles in order, and the count is the number of tiles.
__device__ inline int order_key_tiles(const float* bias, int t, int* order) {
  const int lane = threadIdx.x % 32;
  const int tiles = (t + kKeyTile - 1) / kKeyTile;
  const unsigned below = (1u << lane) - 1u;
  int live = 0;
  int dead = 0;
  if (bias != nullptr) {
    for (int base = 0; base < tiles; base += 32) {  // 32 tiles, 512 keys, a round
      // all loads first, one coalesced key a lane per 32 keys, then one ballot per
      // 32 keys; lane j keeps the 16 bits of tile base + j
      float x[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int key = base * kKeyTile + c * 32 + lane;
        x[c] = key < t ? __ldg(bias + key) : kNegInf;
      }
      unsigned bits = 0;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const unsigned chunk = __ballot_sync(kFullMask, x[c] > kLive);
        if (lane == 2 * c) bits = chunk & 0xffffu;
        if (lane == 2 * c + 1) bits = chunk >> 16;
      }
      const int j = base + lane;
      const bool has = bits != 0;
      const unsigned live_bits = __ballot_sync(kFullMask, has);
      const unsigned dead_bits = __ballot_sync(kFullMask, j < tiles && !has);
      if (has) order[live + __popc(live_bits & below)] = j;
      if (j < tiles && !has) order[tiles - 1 - dead - __popc(dead_bits & below)] = j;
      live += __popc(live_bits);
      dead += __popc(dead_bits);
    }
    __syncwarp();
  }
  if (live == 0) {
    for (int j = lane; j < tiles; j += 32) order[j] = j;
    live = tiles;
  }
  __syncwarp();
  return live;
}

// Opt a kernel in to more than 48 KB of dynamic shared memory when it needs it.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace flash
