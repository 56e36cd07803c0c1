// Exact radix rank-select: the byte-histogram and mask passes.
//
// Replaces two Pallas kernels of repro/kernels/threshold_select.py:
//
// - byte_histogram_kernel: the 256-bin count of byte `shift` of the uint32
//   sort keys whose higher bytes equal `prefix`.  Four MSB-first passes
//   (shift 24, 16, 8, 0) find the k-th smallest key; the bucket search
//   between them is a handful of PyTorch ops on the 256 counts.
// - select_mask_kernel: mask = key < T, or key == T with the running count
//   of ties (1-based, in index order) in (tie_lo, tie_hi]: the tie break of
//   a stable ascending argsort.
//
// The keys are the bits of the float-order map (float_order_keys), handed
// over as a contiguous 4-byte buffer and compared unsigned.  `prefix`, the
// threshold and the tie window are read from device scalars (int64), so the
// four passes and the mask never wait on the host.
//
// What bounds them on an H100: bytes.  A pass streams the 4-byte keys once
// (the mask pass also writes one byte per key) and does a few integer
// operations on each; at the plan's sizes (N = 5e4 to 1.3e6) a pass moves
// 0.2 to 6.4 MB, so the launch and the grid's tail weigh as much as the
// stream.
//
// Design:
// - byte histogram: a grid-stride loop whose trip count is the same for
//   every thread of a block (so whole warps vote together), counting into
//   256 bins in shared memory.  Lanes of a warp that hit the same bin are
//   merged with __match_any_sync and add once: rank-select inputs are often
//   one value repeated (FORGET's event counts), which would otherwise
//   serialise every lane on one shared counter.  Each block then adds its
//   non-zero bins to the output with one global atomic each.  Integer
//   counts: the result does not depend on the order.
// - mask: the Pallas kernel carries the tie count across a sequential grid;
//   CUDA blocks run in no order.  So the mask takes three launches over the
//   same contiguous tiles of kTile keys: (1) each block counts its ties,
//   (2) one block turns the counts into exclusive offsets, (3) each block
//   walks its tile in rounds of kThreads keys, ranks the ties of a round by
//   __ballot_sync/__popc within each warp plus the totals of the warps
//   before it, and adds its offset.  Every tie gets its exact global rank,
//   so the mask equals the sequential one bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kTile = kThreads * kRounds;   // keys per block of the mask
constexpr int kMaxGrid = 1024;

__global__ void __launch_bounds__(kThreads)
byte_histogram_bins(const uint32_t* __restrict__ keys,
                    const long long* __restrict__ prefix_ptr,
                    int* __restrict__ out, int n, int shift) {
  __shared__ int counts[256];
  counts[threadIdx.x] = 0;            // kThreads == 256: one bin each
  __syncthreads();
  const uint32_t pmask = shift < 24 ? (0xFFFFFFFFu << (shift + 8)) : 0u;
  const uint32_t prefix = static_cast<uint32_t>(*prefix_ptr);
  const int lane = threadIdx.x % 32;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads;
       base < n; base += static_cast<long long>(gridDim.x) * kThreads) {
    const long long i = base + threadIdx.x;
    uint32_t k = 0;
    bool match = false;
    if (i < n) {
      k = keys[i];
      match = (k & pmask) == prefix;
    }
    const unsigned voters = __ballot_sync(0xFFFFFFFFu, match);
    if (match) {
      const unsigned bucket = (k >> shift) & 0xFFu;
      const unsigned peers = __match_any_sync(voters, bucket);
      if (lane == __ffs(peers) - 1) atomicAdd(&counts[bucket], __popc(peers));
    }
  }
  __syncthreads();
  const int c = counts[threadIdx.x];
  if (c) atomicAdd(&out[threadIdx.x], c);
}

__device__ __forceinline__ int block_sum(int v, int* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kWarps; ++w) total += scratch[w];
  __syncthreads();                    // scratch is reused by the caller
  return total;
}

__global__ void __launch_bounds__(kThreads)
tie_counts(const uint32_t* __restrict__ keys,
           const long long* __restrict__ thresh_ptr, int* __restrict__ counts,
           int n) {
  __shared__ int scratch[kWarps];
  const uint32_t t = static_cast<uint32_t>(*thresh_ptr);
  const long long start = static_cast<long long>(blockIdx.x) * kTile;
  int c = 0;
  for (int r = 0; r < kRounds; ++r) {
    const long long i = start + r * kThreads + threadIdx.x;
    if (i < n && keys[i] == t) ++c;
  }
  c = block_sum(c, scratch);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

// Exclusive scan of `num` counts by one block, kThreads at a time.
__global__ void __launch_bounds__(kThreads)
exclusive_offsets(const int* __restrict__ counts, int* __restrict__ offsets,
                  int num) {
  __shared__ int warp_tot[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int carry = 0;
  for (int base = 0; base < num; base += kThreads) {
    const int i = base + threadIdx.x;
    const int v = i < num ? counts[i] : 0;
    int inc = v;                      // inclusive scan within the warp
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xFFFFFFFFu, inc, off);
      if (lane >= off) inc += up;
    }
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    int before = carry, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += warp_tot[w];
      total += warp_tot[w];
    }
    if (i < num) offsets[i] = before + inc - v;
    carry += total;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
select_mask_write(const uint32_t* __restrict__ keys,
                  const long long* __restrict__ thresh_ptr,
                  const long long* __restrict__ window,
                  const int* __restrict__ offsets,
                  unsigned char* __restrict__ mask, int n) {
  __shared__ int warp_tot[kWarps];
  const uint32_t t = static_cast<uint32_t>(*thresh_ptr);
  const long long lo = window[0], hi = window[1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned lanes_below = (1u << lane) - 1u;
  const long long start = static_cast<long long>(blockIdx.x) * kTile;
  long long carry = offsets[blockIdx.x];
  for (int r = 0; r < kRounds; ++r) {
    const long long i = start + r * kThreads + threadIdx.x;
    uint32_t k = 0;
    bool tie = false;
    if (i < n) {
      k = keys[i];
      tie = k == t;
    }
    const unsigned ties = __ballot_sync(0xFFFFFFFFu, tie);
    if (lane == 0) warp_tot[warp] = __popc(ties);
    __syncthreads();
    long long before = carry, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += warp_tot[w];
      total += warp_tot[w];
    }
    // 1-based running tie count at this key, as cumsum(tie) gives it.
    const long long cum = before + __popc(ties & lanes_below) + 1;
    if (i < n) mask[i] = (k < t) || (tie && cum > lo && cum <= hi);
    carry += total;
    __syncthreads();
  }
}

int grid_for(long long n, int per_block, int cap) {
  long long g = (n + per_block - 1) / per_block;
  return static_cast<int>(g < 1 ? 1 : (g > cap ? cap : g));
}

}  // namespace

// keys (n,) uint32 bits, prefix (1,) int64 device scalar holding the uint32
// prefix, out (256,) i32.  shift in {0, 8, 16, 24}.
extern "C" int rs_byte_histogram(const void* keys, const void* prefix,
                                 void* out, int n, int shift, int device,
                                 void* stream) {
  if (n < 0 || (shift != 0 && shift != 8 && shift != 16 && shift != 24))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, 256 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  byte_histogram_bins<<<grid_for(n, kThreads, kMaxGrid), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(keys),
      static_cast<const long long*>(prefix), static_cast<int*>(out), n, shift);
  return static_cast<int>(cudaGetLastError());
}

// Number of tiles (blocks) of the mask pass: the size of each of the two
// i32 scratch arrays the caller allocates.
extern "C" int rs_select_mask_tiles(int n) { return grid_for(n, kTile, 1 << 30); }

// keys (n,) uint32 bits, thresh (1,) int64 (the uint32 threshold key),
// window (2,) int64 [tie_lo, tie_hi], counts and offsets (tiles,) i32
// scratch, mask (n,) bool.
extern "C" int rs_select_mask(const void* keys, const void* thresh,
                              const void* window, void* counts, void* offsets,
                              void* mask, int n, int device, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = rs_select_mask_tiles(n);
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  const long long* t = static_cast<const long long*>(thresh);
  tie_counts<<<tiles, kThreads, 0, s>>>(k, t, static_cast<int*>(counts), n);
  exclusive_offsets<<<1, kThreads, 0, s>>>(static_cast<const int*>(counts),
                                           static_cast<int*>(offsets), tiles);
  select_mask_write<<<tiles, kThreads, 0, s>>>(
      k, t, static_cast<const long long*>(window),
      static_cast<const int*>(offsets), static_cast<unsigned char*>(mask), n);
  return static_cast<int>(cudaGetLastError());
}
