// Ordered segment sum: the groupby's per-commit reductions on the card.
//
// Replaces pathway_tpu/engine/device_ops.py::_scatter_add (:213), the
// `out.at[inverse].add(w)` that segment_reduce_dispatch (:270) launches once for the
// diff counts and once for each sum column. Its spec is the host kernels of
// pathway_tpu/engine/device.py: segment_count / segment_sum, that is np.add.at for
// int64 (wrapping) and np.bincount for float64, which adds each group's values in row
// order starting from +0.0. An atomic scatter-add (index_add_) adds in an order that
// changes from run to run, so its float sums differ from the spec in the last bits.
//
// Design: the wrapper sorts the group index stably on the card (torch.sort) and builds
// the group offsets (torch.bincount + cumsum, exact in int64), so `order[offsets[g] ..
// offsets[g + 1])` lists group g's rows in row order. One thread per group walks them
// and adds sequentially: the additions are the spec's, in the spec's order. Loads are
// issued kBatch at a time ahead of the dependent adds, so their latency overlaps; the
// adds themselves stay in order. No fast-math flag reaches this file, and the float adds
// are __dadd_rn, which nvcc never contracts or reorders.
//
// Bound: bytes. Each call reads order and offsets (8 bytes a row and a group), the
// weights (8 bytes a row) and writes 8 bytes a group; the gather of w[order[j]] is
// scattered when the groups interleave. A thread per group is slow when there are few
// large groups (8 groups over 1M rows: 125k dependent adds in one thread); that case is
// measured and kept, since any tree or split reduction changes the float bits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;  // loads in flight per thread ahead of the ordered adds

// int64: two's-complement wrapping add (signed overflow is undefined in C++)
__device__ __forceinline__ long long ordered_add(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}

// float64: round-to-nearest add, never fused or reassociated
__device__ __forceinline__ double ordered_add(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ordered_segment_sum_kernel(const T* __restrict__ w, const long long* __restrict__ order,
                               const long long* __restrict__ offsets, T* __restrict__ out,
                               long long groups) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= groups) return;
  long long j = offsets[g];
  const long long end = offsets[g + 1];
  T acc = T(0);  // +0.0 for float64, as the host accumulator starts
  for (; j + kBatch <= end; j += kBatch) {
    T v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) v[u] = w[order[j + u]];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) acc = ordered_add(acc, v[u]);
  }
  for (; j < end; ++j) acc = ordered_add(acc, w[order[j]]);
  out[g] = acc;
}

template <typename T>
cudaError_t launch(const void* w, const void* order, const void* offsets, void* out,
                   long long groups, cudaStream_t stream) {
  const long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ordered_segment_sum_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(w), static_cast<const long long*>(order),
      static_cast<const long long*>(offsets), static_cast<T*>(out), groups);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. out[g] = sum of w[order[j]] for j in
// [offsets[g], offsets[g + 1]), added in j order. is_float: 0 = int64 (wrapping),
// 1 = float64. order and offsets are int64, offsets has groups + 1 entries; all
// contiguous. Launches on `stream` and returns cudaGetLastError().
extern "C" int pt_ordered_segment_sum(const void* w, const void* order, const void* offsets,
                                      void* out, int is_float, long long groups,
                                      void* stream) {
  if (groups <= 0 || (is_float != 0 && is_float != 1)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float) return launch<double>(w, order, offsets, out, groups, s);
  return launch<long long>(w, order, offsets, out, groups, s);
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
