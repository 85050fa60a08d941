// Bucket and swap: the collective exchange's device step on the card.
//
// Replaces pathway_tpu/engine/collective_exchange.py::_kernel's bucket_and_swap (:375):
// `payload[gidx]` per source chunk into an (n, depth, W) send buffer, then one
// lax.all_to_all over the data axis, under shard_map. That design pads: the chunk and the
// bucket depth round up to powers of two so that XLA compiles few shapes, and the swapped
// buffer holds n * n * depth rows of W bytes whatever the batch's real counts.
//
// Here every count is known on the host before the launch, and the shards share one
// card, so the swap is one gather into a compacted, destination-major (n_rows, W) matrix:
// out[i] = payload[perm[i]], with perm the stable argsort of the rows' destinations.
// Destination d's rows are then one contiguous slice of out, in ascending source index:
// the reference's trimmed concatenation of its buckets, since its source chunks are
// contiguous ascending row ranges. No padding is written or read.
//
// The kernel only moves bytes. Each thread copies one word of one output row; the word
// is the widest of 16, 8 or 4 bytes that divides W and the two base addresses (the
// wrapper picks it), else 1. Consecutive threads write consecutive words of out, so the
// stores coalesce; the loads read whole rows, contiguous within a row. Bound: bytes, the
// payload read once, perm read once (4 bytes a row), out written once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;  // a grid-stride loop covers the rest

template <typename Word>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const Word* __restrict__ in, const int* __restrict__ perm,
                       Word* __restrict__ out, long long n, int words) {
  const long long total = n * words;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; t < total;
       t += stride) {
    const long long row = t / words;
    const int w = static_cast<int>(t - row * words);
    out[t] = in[static_cast<long long>(__ldg(perm + row)) * words + w];
  }
}

template <typename Word>
cudaError_t launch(const void* payload, const void* perm, void* out, long long n,
                   long long width, cudaStream_t stream) {
  const int words = static_cast<int>(width / static_cast<long long>(sizeof(Word)));
  const long long total = n * words;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_rows_kernel<Word><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const Word*>(payload), static_cast<const int*>(perm),
      static_cast<Word*>(out), n, words);
  return cudaGetLastError();
}

bool aligned(const void* p, int word) {
  return reinterpret_cast<std::uintptr_t>(p) % static_cast<std::uintptr_t>(word) == 0;
}

}  // namespace

// out[i, :] = payload[perm[i], :] for i < n: payload and out are (rows, width) uint8
// row-major, perm int32 [n] with values in [0, rows). `word` is the copy's width in bytes
// (16, 8, 4 or 1): it must divide `width` and both base addresses.
extern "C" int pt_bucket_swap(const void* payload, const void* perm, void* out, long long n,
                              long long width, int word, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || width <= 0 || width > 0x7fffffffLL) return cudaErrorInvalidValue;
  if ((word != 16 && word != 8 && word != 4 && word != 1) || width % word != 0 ||
      !aligned(payload, word) || !aligned(out, word))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word) {
    case 16:
      return launch<uint4>(payload, perm, out, n, width, s);
    case 8:
      return launch<unsigned long long>(payload, perm, out, n, width, s);
    case 4:
      return launch<unsigned int>(payload, perm, out, n, width, s);
    default:
      return launch<unsigned char>(payload, perm, out, n, width, s);
  }
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
