// Segment reduction: the groupby's per-commit sums on the card.
//
// Replaces pathway_tpu/engine/device_ops.py::_scatter_add (:213), the
// `out.at[inverse].add(w)` that segment_reduce_dispatch (:270) launches once for the
// diff counts and once for each sum column. Its spec is the host kernels of
// pathway_tpu/engine/device.py: segment_count / segment_sum, that is np.add.at for
// int64 (wrapping) and np.bincount for float64, which adds each group's values in row
// order starting from +0.0, rounding to nearest after every add.
//
// int64 columns (pt_segment_sum_int). Wrapping adds give the same bits in any order, so
// this path takes no order at all: one launch reads the group index and every int64
// column once, coalesced, and adds with 64-bit atomics. The path is a choice by shape
// (int_sums_shared): where the [columns, groups] sums fit one block's shared memory and
// the rows are many, and many a group, each block keeps private sums in shared memory
// and flushes the non-zero ones with global atomics; otherwise each warp merges its
// lanes' rows of one group (__match_any_sync, shuffles) and one lane adds them to the
// output with a global atomic, so a hot group costs one atomic a warp. Bound: bytes, 8
// a row for the index and 8 a row a column, 8 a group a column out.
//
// float64 columns. The spec's adds per group are one dependent chain in row order: no
// split, tree or atomic keeps the bits. So the rows are first partitioned by group,
// stably, carrying the float columns themselves as the payload, and then each group's
// contiguous run is folded in order:
// - pt_radix_pass, once per digit: an LSD radix partition over only the
//   ceil(log2 groups) bits the index can have, at most 11 bits a pass (the plan is
//   computed in Python, ops/segment_reduce.py::radix_passes): one pass up to 2,048
//   groups, two up to 2^22. Each pass is a stable counting sort over 2,048-row tiles:
//   per-tile digit counts (radix_histogram, tile-major), their scan along the tiles of
//   each digit (scan_tiles, through a transposed chunk in shared memory, so every
//   global access is coalesced) and over the digits (scan_digits, one block), and a
//   scatter (radix_scatter) whose in-tile ranks come from __match_any_sync in row
//   order, each warp counting its own 256 rows in shared memory and the warps' counts
//   added in warp order. The key narrows to int32 after the first read. The pass
//   returns where each digit's rows end, so after a single pass those are the runs'
//   ends; after two, pt_run_ends reads them off the sorted keys.
// - pt_fold_runs: a run shorter than kLongRun rows gets one thread (fold_short), which
//   adds it in order; a longer run gets one warp per run and column (fold_long), one
//   warp a block. Its lanes load 32 contiguous values at a time, kPrefetch chunks
//   ahead, and every lane adds the current chunk in order while the next one is
//   gathered, so the warp, which runs its instructions in order, never waits on a
//   gather or a load between two adds.
//   The gather is a shared-memory broadcast (each lane stores its value, every lane
//   reads the 32 as 16 LDS.128), not __shfl_sync: two SHFLs a row per warp held a
//   warp at 11.9 ns a row against a 4.1 ns dependent add on the H100. The run's last
//   chunks are padded with +0.0, which leaves the sum's bits as they are, so no add is
//   predicated. fold_short picks each run's class from the run ends and lists the
//   long runs for fold_long.
// Bound: bytes (the index read once, every column read once, every sum written once),
// and a second figure, the chain floor: the longest run times the latency of one
// dependent __dadd_rn (pt_dadd_chain measures it). At few large groups the chain sets
// it. No fast-math flag reaches this file, and every float add is __dadd_rn, which nvcc
// never contracts or reorders.

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// -- int64 columns --------------------------------------------------------------------

constexpr int kIntThreads = 512;
constexpr int kIntUnroll = 4;         // rows in flight a thread
constexpr long long kRowsPerBin = 4;  // shared path: the rows a block takes per bin

__global__ void __launch_bounds__(kIntThreads)
    int_sum_shared_kernel(const long long* __restrict__ inv,
                          const unsigned long long* __restrict__ w,
                          unsigned long long* __restrict__ out, long long n, long long groups,
                          int cols) {
  extern __shared__ unsigned long long sums[];  // [cols][groups]
  const long long bins = groups * cols;
  for (long long i = threadIdx.x; i < bins; i += kIntThreads) sums[i] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kIntThreads;
  for (long long r0 = static_cast<long long>(blockIdx.x) * kIntThreads + threadIdx.x; r0 < n;
       r0 += stride * kIntUnroll) {
    long long g[kIntUnroll];
#pragma unroll
    for (int u = 0; u < kIntUnroll; ++u) {
      const long long r = r0 + u * stride;
      g[u] = r < n ? inv[r] : -1;
    }
    for (int c = 0; c < cols; ++c) {
      const unsigned long long* wc = w + c * n;
      unsigned long long v[kIntUnroll];
#pragma unroll
      for (int u = 0; u < kIntUnroll; ++u) {
        const long long r = r0 + u * stride;
        v[u] = r < n ? wc[r] : 0ull;
      }
#pragma unroll
      for (int u = 0; u < kIntUnroll; ++u)
        if (g[u] >= 0) atomicAdd(&sums[c * groups + g[u]], v[u]);
    }
  }
  __syncthreads();
  for (long long i = threadIdx.x; i < bins; i += kIntThreads) {
    const unsigned long long s = sums[i];
    if (s != 0) atomicAdd(&out[i], s);
  }
}

__global__ void __launch_bounds__(kIntThreads)
    int_sum_global_kernel(const long long* __restrict__ inv,
                          const unsigned long long* __restrict__ w,
                          unsigned long long* __restrict__ out, long long n, long long groups,
                          int cols) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kIntThreads + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * kIntThreads) >> 5;
  for (long long base = warp * 32; base < n; base += warps * 32) {
    const long long r = base + lane;
    const bool valid = r < n;
    const unsigned live = __ballot_sync(kFull, valid);
    if (!valid) continue;
    const long long g = inv[r];
    const unsigned peers = __match_any_sync(live, g);
    const int leader = __ffs(peers) - 1;
    for (int c = 0; c < cols; ++c) {
      const unsigned long long v = w[c * n + r];
      unsigned long long s = 0;
      for (unsigned rest = peers; rest; rest &= rest - 1) s += __shfl_sync(peers, v, __ffs(rest) - 1);
      if (lane == leader) atomicAdd(&out[c * groups + g], s);
    }
  }
}

// What the launches need to know of the current card, read once per device: the host
// time of the attribute and occupancy queries would otherwise fall on every call.
struct Card {
  int sms;
  int smem_optin;     // dynamic shared memory a block may opt in to
  int smem_sm;        // shared memory an SM holds
  int smem_reserved;  // shared memory the runtime keeps a block
  int shared_per_sm;  // int_sum_shared_kernel's blocks an SM by threads and registers
};

constexpr int kMaxDevices = 64;

cudaError_t card(Card* out) {
  static std::mutex lock;
  static Card cards[kMaxDevices];
  static bool known[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const std::lock_guard<std::mutex> guard(lock);
  if (!known[dev]) {
    Card c;
    err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&c.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&c.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&c.smem_reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.shared_per_sm, int_sum_shared_kernel,
                                                          kIntThreads, 0);
    if (err != cudaSuccess) return err;
    cards[dev] = c;
    known[dev] = true;
  }
  *out = cards[dev];
  return cudaSuccess;
}

long long shared_blocks(long long n, long long groups) {
  return (n + kRowsPerBin * groups - 1) / (kRowsPerBin * groups);
}

// The int path by shape, from the two paths' device times (probe_int_sum.py, which times
// both from copies of this source): shared-memory sums where the [cols, groups] sums fit
// a block, there are kSharedMinRows rows or more and kSharedRowsPerGroup rows a group or
// more; else global atomics. A block of the shared path walks kRowsPerBin rows a bin,
// one shared atomic at a time, so its time grows with the groups; the global path's
// grows with the rows that contend for each group.
constexpr long long kSharedMinRows = 1 << 16;
constexpr long long kSharedRowsPerGroup = 128;

bool int_sums_shared(const Card& c, long long n, long long groups, int cols) {
  return groups * cols * 8 <= c.smem_optin && n >= kSharedMinRows && n >= kSharedRowsPerGroup * groups;
}

// -- float64 columns: the stable radix partition ---------------------------------------

constexpr int kRadixWarps = 8;
constexpr int kRadixThreads = kRadixWarps * 32;
constexpr int kRadixItems = 8;                             // rows a lane
constexpr long long kTile = kRadixThreads * kRadixItems;  // 2,048 rows a tile
constexpr int kMaxDigitBits = 11;

// counts[t * digits + d]: the rows of tile t whose digit is d (tile-major, so a block
// writes its counts in one coalesced row)
template <typename K>
__global__ void __launch_bounds__(kRadixThreads)
    radix_histogram_kernel(const K* __restrict__ keys, long long n, int shift, int bits,
                           int* __restrict__ counts) {
  extern __shared__ int hist[];  // [digits]
  const int digits = 1 << bits;
  for (int d = threadIdx.x; d < digits; d += kRadixThreads) hist[d] = 0;
  __syncthreads();
  const long long start = static_cast<long long>(blockIdx.x) * kTile;
  const long long end = start + kTile < n ? start + kTile : n;
#pragma unroll 4
  for (long long r = start + threadIdx.x; r < end; r += kRadixThreads)
    atomicAdd(&hist[(static_cast<int>(keys[r]) >> shift) & (digits - 1)], 1);
  __syncthreads();
  for (int d = threadIdx.x; d < digits; d += kRadixThreads)
    counts[static_cast<long long>(blockIdx.x) * digits + d] = hist[d];
}

// counts[t * digits + d] becomes the rows of digit d in the tiles before t (an exclusive
// scan along the tiles), and totals[d] the digit's rows. A block takes 32 digits and
// kScanChunk tiles at a time into shared memory, read and written a tile row at a time
// (coalesced), and warp w scans digit w of the 32 along the tiles from there.
constexpr int kScanThreads = 1024;
constexpr int kScanChunk = 256;

__global__ void __launch_bounds__(kScanThreads)
    scan_tiles_kernel(int* __restrict__ counts, long long tiles, int digits,
                      int* __restrict__ totals) {
  __shared__ int chunk[kScanChunk][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = blockIdx.x * 32 + lane;         // the digit this thread reads and writes
  const int scanned = blockIdx.x * 32 + warp;  // the digit this warp scans
  int carry = 0;
  for (long long t0 = 0; t0 < tiles; t0 += kScanChunk) {
    for (int r = warp; r < kScanChunk; r += 32) {
      const long long t = t0 + r;
      chunk[r][lane] = t < tiles && d < digits ? counts[t * digits + d] : 0;
    }
    __syncthreads();
    for (int r0 = 0; r0 < kScanChunk; r0 += 32) {
      const int v = chunk[r0 + lane][warp];
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      chunk[r0 + lane][warp] = carry + incl - v;
      carry += __shfl_sync(kFull, incl, 31);
    }
    __syncthreads();
    for (int r = warp; r < kScanChunk; r += 32) {
      const long long t = t0 + r;
      if (t < tiles && d < digits) counts[t * digits + d] = chunk[r][lane];
    }
    __syncthreads();
  }
  if (lane == 0 && scanned < digits) totals[scanned] = carry;
}

// digit_end[d]: the rows of every digit up to d (the scan of the digits' totals); one
// block of 1,024 threads, two digits a thread
__global__ void __launch_bounds__(kScanThreads)
    scan_digits_kernel(const int* __restrict__ totals, int digits, int* __restrict__ digit_end) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const int d0 = 2 * i, d1 = 2 * i + 1;
  const int a = d0 < digits ? totals[d0] : 0;
  const int b = d1 < digits ? totals[d1] : 0;
  int v = a + b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = (warp > 0 ? warp_sums[warp - 1] : 0) + v - a - b;
  if (d0 < digits) digit_end[d0] = before + a;
  if (d1 < digits) digit_end[d1] = before + a + b;
}

// Row r goes to the rank of (its digit, r) among all rows: the rows of digit d start at
// digit_end[d] - totals[d], and tile t's after scan[t * digits + d] more. kKeys:
// write the int32 keys too. Every global read a block needs (its keys, the first
// column, the tile's starts) is requested before the ranking, whose latency hides them,
// and the stores go out from registers. Two blocks an SM are asked for: left to its own
// aim, ptxas capped the registers lower and spilled.
template <typename K, bool kKeys>
__global__ void __launch_bounds__(kRadixThreads, 2)
    radix_scatter_kernel(const K* __restrict__ keys, const double* __restrict__ payload,
                         int cols, long long n, int shift, int bits,
                         const int* __restrict__ scan, const int* __restrict__ totals,
                         const int* __restrict__ digit_end, int* __restrict__ keys_out,
                         double* __restrict__ payload_out) {
  extern __shared__ int smem[];
  const int digits = 1 << bits;
  const int mask = digits - 1;
  int* warp_counts = smem;                          // [kRadixWarps][digits]
  int* tile_start = smem + kRadixWarps * digits;  // [digits]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lanes_before = (1u << lane) - 1;
  // warp w takes rows [w * 256, (w + 1) * 256) of the tile, 32 at a time
  const long long first =
      static_cast<long long>(blockIdx.x) * kTile + warp * (kRadixItems * 32) + lane;
  int key[kRadixItems];
  double v0[kRadixItems];  // column 0
#pragma unroll
  for (int i = 0; i < kRadixItems; ++i) {
    const long long r = first + i * 32;
    key[i] = r < n ? static_cast<int>(keys[r]) : 0;
  }
#pragma unroll
  for (int i = 0; i < kRadixItems; ++i) {
    const long long r = first + i * 32;
    v0[i] = cols > 0 && r < n ? payload[r] : 0.0;
  }
  for (int i = threadIdx.x; i < kRadixWarps * digits; i += kRadixThreads) warp_counts[i] = 0;
  const int* before = scan + static_cast<long long>(blockIdx.x) * digits;
#pragma unroll 4
  for (int d = threadIdx.x; d < digits; d += kRadixThreads)
    tile_start[d] = digit_end[d] - totals[d] + before[d];
  __syncthreads();
  int* mine = warp_counts + warp * digits;
  // rank = rows of the same digit before this one in the warp's rows, in row order
  int rank[kRadixItems];
#pragma unroll
  for (int i = 0; i < kRadixItems; ++i) {
    const bool valid = first + i * 32 < n;
    const unsigned live = __ballot_sync(kFull, valid);
    const int d = (key[i] >> shift) & mask;
    unsigned peers = 0;
    int base = 0;
    rank[i] = 0;
    if (valid) {
      peers = __match_any_sync(live, d);
      base = mine[d];
      rank[i] = base + __popc(peers & lanes_before);
    }
    __syncwarp();
    if (valid && (peers & lanes_before) == 0) mine[d] = base + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // each warp's first slot per digit: the tile's start, then the earlier warps' counts
  for (int d = threadIdx.x; d < digits; d += kRadixThreads) {
    int run = tile_start[d];
    for (int w = 0; w < kRadixWarps; ++w) {
      const int c = warp_counts[w * digits + d];
      warp_counts[w * digits + d] = run;
      run += c;
    }
  }
  __syncthreads();
  long long dest[kRadixItems];
#pragma unroll
  for (int i = 0; i < kRadixItems; ++i) {
    dest[i] = mine[(key[i] >> shift) & mask] + rank[i];
    if (first + i * 32 < n) {
      if (kKeys) keys_out[dest[i]] = key[i];
      if (cols > 0) payload_out[dest[i]] = v0[i];
    }
  }
  for (int c = 1; c < cols; ++c) {
    double v[kRadixItems];
#pragma unroll
    for (int i = 0; i < kRadixItems; ++i) {
      const long long r = first + i * 32;
      v[i] = r < n ? payload[c * n + r] : 0.0;
    }
#pragma unroll
    for (int i = 0; i < kRadixItems; ++i)
      if (first + i * 32 < n) payload_out[c * n + dest[i]] = v[i];
  }
}

// ends[g] = the first row whose key exceeds g (keys sorted, each in [0, groups))
__global__ void run_ends_kernel(const int* __restrict__ keys, long long n, long long groups,
                                int* __restrict__ ends) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i > n) return;
  const long long lo = i == 0 ? 0 : keys[i - 1];
  const long long hi = i == n ? groups : keys[i];
  for (long long g = lo; g < hi; ++g) ends[g] = static_cast<int>(i);
}

// -- float64 columns: the ordered fold ----------------------------------------------

constexpr int kFoldThreads = 256;
constexpr int kLongRun = 32;     // a run of this many rows or more gets a warp
constexpr int kPrefetch = 8;     // 32-row chunks in flight a lane in a long run
constexpr int kShortBatch = 8;   // loads in flight ahead of a short run's adds

// group g's run is [ends[g - 1], ends[g]), or all n rows for the one group of a call
// with no partition (ends == nullptr)
__device__ __forceinline__ long long run_start(const int* ends, long long g) {
  return ends == nullptr || g == 0 ? 0 : ends[g - 1];
}

__device__ __forceinline__ long long run_end(const int* ends, long long g, long long n) {
  return ends == nullptr ? n : ends[g];
}

__global__ void __launch_bounds__(kFoldThreads)
    fold_short_kernel(const double* __restrict__ w, int cols, long long n,
                      const int* __restrict__ ends, long long groups, double* __restrict__ out,
                      int* __restrict__ long_runs) {
  const long long g = static_cast<long long>(blockIdx.x) * kFoldThreads + threadIdx.x;
  const bool live = g < groups;
  long long start = 0, end = 0;
  if (live) {
    start = run_start(ends, g);
    end = run_end(ends, g, n);
  }
  const bool is_long = live && end - start >= kLongRun;
  const unsigned longs = __ballot_sync(kFull, is_long);
  if (longs != 0) {  // list the warp's long runs: long_runs[0] counts, [1 ..] the groups
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(longs) - 1;
    int slot = 0;
    if (lane == leader) slot = atomicAdd(long_runs, __popc(longs));
    slot = __shfl_sync(kFull, slot, leader);
    if (is_long) long_runs[1 + slot + __popc(longs & ((1u << lane) - 1))] = static_cast<int>(g);
  }
  if (!live || is_long) return;
  for (int c = 0; c < cols; ++c) {
    const double* wc = w + c * n;
    double acc = 0.0;  // +0.0, as the host accumulator starts
    long long j = start;
    for (; j + kShortBatch <= end; j += kShortBatch) {
      double v[kShortBatch];
#pragma unroll
      for (int u = 0; u < kShortBatch; ++u) v[u] = wc[j + u];
#pragma unroll
      for (int u = 0; u < kShortBatch; ++u) acc = __dadd_rn(acc, v[u]);
    }
    for (; j < end; ++j) acc = __dadd_rn(acc, wc[j]);
    out[c * groups + g] = acc;
  }
}

// One warp a block, so that a few long runs spread over the SMs instead of sharing one;
// one block an SM is the least asked for, so ptxas keeps x, y and v in registers.
__global__ void __launch_bounds__(32, 1)
    fold_long_kernel(const double* __restrict__ w, int cols, long long n,
                     const int* __restrict__ ends, long long groups, double* __restrict__ out,
                     const int* __restrict__ long_runs) {
  __shared__ __align__(16) double stage[2][32];  // the next chunk, every lane's value
  const int lane = threadIdx.x;
  // one warp per (long run, column); 32-bit: runs <= n / 32 < 2^26
  const unsigned runs = static_cast<unsigned>(long_runs[0]);
  for (unsigned item = blockIdx.x; item < runs * static_cast<unsigned>(cols); item += gridDim.x) {
    const unsigned c = item / runs;
    const long long g = long_runs[1 + (item - c * runs)];
    const double* wc = w + c * n;
    const long long start = run_start(ends, g);
    const long long end = run_end(ends, g, n);
    // v[u]: this lane's value of chunk u of the kPrefetch ahead; x: the chunk being
    // added, every lane holding its 32 values, read from stage as a broadcast. Rows past
    // the end load as +0.0, and adding +0.0 leaves acc's bits as they are: acc starts
    // at +0.0 and a round-to-nearest sum is never -0.0 unless both terms are, so acc is
    // +0.0, or non-zero, inf or NaN. So every chunk is added whole, with no predicate.
    double v[kPrefetch];
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const long long j = start + u * 32 + lane;
      v[u] = j < end ? wc[j] : 0.0;
    }
    double x[32];
    __syncwarp();  // the last item's reads of stage are done
    stage[0][lane] = v[0];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const double2 p = reinterpret_cast<const double2*>(stage[0])[k];
      x[2 * k] = p.x;
      x[2 * k + 1] = p.y;
    }
    double acc = 0.0;
    for (long long base = start; base < end; base += kPrefetch * 32) {
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        // chunk base + 32u is in x; stage[(u + 1) & 1] takes the next one: its last
        // reads (two steps back, or before step 0) are behind a __syncwarp
        const long long ahead = base + (u + kPrefetch) * 32 + lane;
        v[u] = ahead < end ? wc[ahead] : 0.0;
        const int next = (u + 1) & 1;
        stage[next][lane] = v[(u + 1) % kPrefetch];
        __syncwarp();
        double y[32];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const double2 p = reinterpret_cast<const double2*>(stage[next])[k];
          y[2 * k] = p.x;
          y[2 * k + 1] = p.y;
          acc = __dadd_rn(acc, x[2 * k]);
          acc = __dadd_rn(acc, x[2 * k + 1]);
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < 32; ++k) x[k] = y[k];
      }
    }
    if (lane == 0) out[c * groups + g] = acc;
  }
}

// -- calibration ------------------------------------------------------------------------

__global__ void dadd_chain_kernel(const double* __restrict__ x, double* __restrict__ out,
                                  long long iters) {
  double acc = x[0];
  const double step = x[1];
#pragma unroll 16
  for (long long i = 0; i < iters; ++i) acc = __dadd_rn(acc, step);
  *out = acc;
}

bool bad_rows(long long n) { return n <= 0 || n > 0x7fffffffLL; }

// Let `kernel` take up to `bytes` of dynamic shared memory on the current device, once
// per kernel and device: the attribute holds for the process, and setting it costs host
// time on every call.
cudaError_t allow_smem(const void* kernel, size_t bytes) {
  struct Allowed {
    const void* kernel;
    int dev;
    size_t bytes;
  };
  static std::mutex lock;
  static Allowed table[64];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i)
    if (table[i].kernel == kernel && table[i].dev == dev && table[i].bytes >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && used < 64) table[used++] = {kernel, dev, bytes};
  return err;
}

template <typename K, bool kKeys>
cudaError_t radix_pass(const void* keys, const void* payload, int cols, long long n, int shift,
                       int bits, void* counts, long long tiles, void* digit_end, void* keys_out,
                       void* payload_out, cudaStream_t s) {
  const int digits = 1 << bits;
  int* counts_ = static_cast<int*>(counts);
  int* totals = counts_ + tiles * digits;
  radix_histogram_kernel<K><<<static_cast<unsigned>(tiles), kRadixThreads, digits * sizeof(int), s>>>(
      static_cast<const K*>(keys), n, shift, bits, counts_);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_tiles_kernel<<<(digits + 31) / 32, kScanThreads, 0, s>>>(counts_, tiles, digits, totals);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_digits_kernel<<<1, kScanThreads, 0, s>>>(totals, digits, static_cast<int*>(digit_end));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = (kRadixWarps + 1) * digits * static_cast<int>(sizeof(int));
  err = allow_smem(reinterpret_cast<const void*>(radix_scatter_kernel<K, kKeys>),
                   (kRadixWarps + 1) * (1 << kMaxDigitBits) * sizeof(int));
  if (err != cudaSuccess) return err;
  radix_scatter_kernel<K, kKeys><<<static_cast<unsigned>(tiles), kRadixThreads, smem, s>>>(
      static_cast<const K*>(keys), static_cast<const double*>(payload), cols, n, shift, bits,
      counts_, totals, static_cast<const int*>(digit_end), static_cast<int*>(keys_out),
      static_cast<double*>(payload_out));
  return cudaGetLastError();
}

template <typename K>
cudaError_t radix_pass(const void* keys, const void* payload, int cols, long long n, int shift,
                       int bits, void* counts, long long tiles, void* digit_end, void* keys_out,
                       void* payload_out, cudaStream_t s) {
  if (keys_out != nullptr)
    return radix_pass<K, true>(keys, payload, cols, n, shift, bits, counts, tiles, digit_end,
                               keys_out, payload_out, s);
  return radix_pass<K, false>(keys, payload, cols, n, shift, bits, counts, tiles, digit_end,
                              keys_out, payload_out, s);
}

}  // namespace

// C interface, loaded with ctypes. Every pointer is to contiguous device memory; every
// entry point launches on `stream`, never synchronises, and returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments it does not take). Group indices must lie in
// [0, groups).

// out[c][g] = the wrapping sum of w[c][r] over the rows r with inv[r] == g. inv int64
// [n], w int64 [cols][n], out int64 [cols][groups].
extern "C" int pt_segment_sum_int(const void* inv, const void* w, void* out, long long n,
                                  long long groups, int cols, void* stream) {
  if (n <= 0 || groups <= 0 || cols <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Card c;
  cudaError_t err = card(&c);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(out, 0, static_cast<size_t>(groups * cols * 8), s);
  if (err != cudaSuccess) return err;
  const auto* inv_ = static_cast<const long long*>(inv);
  const auto* w_ = static_cast<const unsigned long long*>(w);
  auto* out_ = static_cast<unsigned long long*>(out);
  if (int_sums_shared(c, n, groups, cols)) {
    const long long smem = groups * cols * 8;
    err = allow_smem(reinterpret_cast<const void*>(int_sum_shared_kernel),
                     static_cast<size_t>(c.smem_optin));
    if (err != cudaSuccess) return err;
    // resident blocks: the threads' and registers' limit, and the shared memory's
    long long per_sm = c.smem_sm / (smem + c.smem_reserved);
    if (per_sm > c.shared_per_sm) per_sm = c.shared_per_sm;
    if (per_sm < 1) per_sm = 1;
    long long blocks = shared_blocks(n, groups);
    if (blocks > per_sm * c.sms) blocks = per_sm * c.sms;
    int_sum_shared_kernel<<<static_cast<unsigned>(blocks), kIntThreads, static_cast<size_t>(smem),
                            s>>>(inv_, w_, out_, n, groups, cols);
  } else {
    const long long by_rows = (n + kIntThreads - 1) / kIntThreads;
    const long long resident = static_cast<long long>(c.sms) * (2048 / kIntThreads);
    const long long blocks = by_rows < resident ? by_rows : resident;
    int_sum_global_kernel<<<static_cast<unsigned>(blocks), kIntThreads, 0, s>>>(inv_, w_, out_, n,
                                                                               groups, cols);
  }
  return cudaGetLastError();
}

// One stable pass by the digit (key >> shift) & (2^bits - 1): keys int64 (key_bytes 8)
// or int32 (4) [n]; payload float64 [cols][n] -> payload_out [cols][n] in the new
// order, keys_out int32 [n] (null: not written), digit_end int32 [2^bits] (the rows of
// digits up to d). counts: int32 scratch [2^bits * (tiles + 1)], tiles = ceil(n / 2,048).
extern "C" int pt_radix_pass(const void* keys, int key_bytes, const void* payload, int cols,
                             long long n, int shift, int bits, void* counts, long long tiles,
                             void* digit_end, void* keys_out, void* payload_out, void* stream) {
  if (bad_rows(n) || bits < 1 || bits > kMaxDigitBits || shift < 0 || shift + bits > 31 ||
      cols < 0 || tiles != (n + kTile - 1) / kTile)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bytes == 8)
    return radix_pass<long long>(keys, payload, cols, n, shift, bits, counts, tiles, digit_end,
                                 keys_out, payload_out, s);
  if (key_bytes == 4)
    return radix_pass<int>(keys, payload, cols, n, shift, bits, counts, tiles, digit_end, keys_out,
                           payload_out, s);
  return cudaErrorInvalidValue;
}

// ends[g] = the first row of the sorted int32 keys [n] whose key exceeds g, g < groups.
extern "C" int pt_run_ends(const void* keys, long long n, long long groups, void* ends,
                           void* stream) {
  if (bad_rows(n) || groups <= 0) return cudaErrorInvalidValue;
  const long long blocks = (n + 1 + 255) / 256;
  run_ends_kernel<<<static_cast<unsigned>(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), n, groups, static_cast<int*>(ends));
  return cudaGetLastError();
}

// out[c][g] = +0.0 + w[c][start] + ... in row order over group g's run [ends[g - 1],
// ends[g]) (ends null: one group, all n rows). w float64 [cols][n], out float64
// [cols][groups], long_runs int32 scratch [1 + min(groups, n / 32)].
extern "C" int pt_fold_runs(const void* w, int cols, long long n, const void* ends,
                            long long groups, void* out, void* long_runs, void* stream) {
  if (bad_rows(n) || groups <= 0 || cols <= 0 || (ends == nullptr && groups != 1))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Card c;
  cudaError_t err = card(&c);
  if (err == cudaSuccess) err = cudaMemsetAsync(long_runs, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  const auto* w_ = static_cast<const double*>(w);
  const auto* ends_ = static_cast<const int*>(ends);
  auto* out_ = static_cast<double*>(out);
  fold_short_kernel<<<static_cast<unsigned>((groups + kFoldThreads - 1) / kFoldThreads),
                      kFoldThreads, 0, s>>>(w_, cols, n, ends_, groups, out_,
                                            static_cast<int*>(long_runs));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // a warp for every (long run, column) the shape allows, at most 16 an SM
  const long long most = (groups < n / kLongRun ? groups : n / kLongRun) * cols;
  const long long resident = static_cast<long long>(c.sms) * 16;
  long long blocks = most < resident ? most : resident;
  if (blocks < 1) blocks = 1;
  fold_long_kernel<<<static_cast<unsigned>(blocks), 32, 0, s>>>(
      w_, cols, n, ends_, groups, out_, static_cast<const int*>(long_runs));
  return cudaGetLastError();
}

// One thread: out[0] = x[0] + x[1] + x[1] + ... (iters dependent __dadd_rn). Timed, it
// gives the latency of a dependent float64 add, the unit of the fold's chain floor.
extern "C" int pt_dadd_chain(const void* x, void* out, long long iters, void* stream) {
  if (iters <= 0) return cudaErrorInvalidValue;
  dadd_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<double*>(out), iters);
  return cudaGetLastError();
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
