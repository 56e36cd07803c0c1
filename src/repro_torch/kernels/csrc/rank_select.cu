// Exact radix rank-select in one persistent kernel.
//
// Replaces two Pallas kernels of repro/kernels/threshold_select.py and the
// search that ran between them (radix_threshold):
//
// - byte_histogram_kernel: the 256-bin count of byte `shift` of the uint32
//   order keys whose higher bytes equal `prefix`.  Four MSB-first passes
//   (shift 24, 16, 8, 0) find the k-th smallest key: after each pass the
//   bucket holding the remaining-th key fixes one more byte of the prefix.
// - select_mask_kernel: mask = key < T, or key == T with the running count
//   of ties (1-based, in index order) in (tie_lo, tie_hi]: the tie break of
//   a stable ascending argsort.
//
// The kernel reads the float scores and builds the order keys itself: the
// sign-flip map, -0.0 collapsed onto +0.0, the complement for `high`
// (threshold_select.py::order_key_bits is its plain version).  k is read
// from a device scalar (int32 or int64) or passed by value, so nothing in a
// call waits on the host.
//
// What bounds it on an H100: not the bytes.  At the plan's sizes (N = 5e4
// to 1.3e6) the scores are 0.2 to 5.1 MB, 0.06 to 1.5 us at 3.35 TB/s.  The
// five passes depend on each other through grid-wide results (four
// histograms, then the tie counts), so the time is the latency of five
// grid barriers and of the bucket searches between them.  Earlier, each of
// those steps was a launch or a handful of PyTorch ops paced by the host.
//
// Design:
// - One cooperative launch (cudaLaunchCooperativeKernel), at most one block
//   of kThreads per SM, so that every block is resident and may wait on the
//   others.  Each block owns one contiguous slice of [0, N) in index order,
//   since the tie ranks need index order.
// - Where the slice fits (kMaxSliceKeys keys: N up to 7,434,240 on 132 SMs)
//   the block keeps its keys in dynamic shared memory, so the scores are
//   read from HBM once.  Above that each pass reads the slice again from
//   global memory, which L2 mostly serves.
// - A pass counts the block's slice into 256 shared bins.  Lanes of a warp
//   that hit the same bin are merged with __match_any_sync and add once:
//   rank-select inputs are often one value repeated (FORGET's event counts).
//   Each block adds its non-zero bins to the pass's global histogram with
//   atomics (integer counts: exact in any order), then a grid barrier.
// - After it, every block does the bucket search itself on the same 256
//   counts (scan, first bin whose running count reaches `remaining`, the
//   searchsorted of radix_threshold), so all agree with no second barrier.
// - The block's ties at the threshold are pass 3's local count of the
//   final bucket.  Each block posts it, a grid barrier, then sums the counts
//   of the blocks before it for its exclusive offset, and ranks its ties in
//   rounds of kThreads keys by __ballot_sync/__popc within each warp plus
//   the totals of the warps before it.  Every tie gets its exact global
//   rank, so the mask equals the sequential one bit for bit.
// - The grid barrier is cooperative_groups' this_grid().sync(), which
//   nvcc 12.x builds without -rdc for a cooperative launch.  A call is the
//   memset of the histograms and the kernel, two launches; the kernel
//   allocates nothing.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kPasses = 4;
constexpr int kUnroll = 4;   // keys a thread has in flight in a pass
// Keys a block keeps in shared memory (220 KiB of the 227 KiB a block may
// use on sm_90, beside the ~3.5 KiB of static shared memory).
constexpr int kMaxSliceKeys = 55 * 1024;
// Scratch layout, in 32-bit words (threshold_select.py mirrors it).
constexpr int kTripleWord = kPasses * kBins;   // after the (4, 256) i32 hists
constexpr int kTieWord = kTripleWord + 6;      // after 3 x i64 (T, needed, total):
                                               // (grid,) i32 ties per block
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t order_key(float x, uint32_t flip) {
  const uint32_t b = x == 0.0f ? 0u : __float_as_uint(x);
  return ((b & 0x80000000u) ? ~b : (b | 0x80000000u)) ^ flip;
}

__device__ __forceinline__ long long block_sum(long long v, long long* warp_sum) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  if (threadIdx.x % 32 == 0) warp_sum[threadIdx.x / 32] = v;
  __syncthreads();
  long long total = 0;
  for (int w = 0; w < kWarps; ++w) total += warp_sum[w];
  __syncthreads();                      // warp_sum is reused by the caller
  return total;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
rank_select_kernel(const float* __restrict__ scores, const void* k_ptr,
                   int k_bytes, long long k_value, uint32_t flip,
                   int* __restrict__ scratch, unsigned char* __restrict__ mask,
                   int n, int slice) {
  extern __shared__ uint32_t slice_keys[];
  __shared__ int bins[kBins];
  __shared__ long long cdf[kBins];
  __shared__ long long warp_sum[kWarps];
  __shared__ int warp_ties[kWarps];
  __shared__ int bucket;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long start = static_cast<long long>(blockIdx.x) * slice;
  const int len = static_cast<int>(
      start >= n ? 0 : (n - start < slice ? n - start : slice));
  const float* x = scores + start;
  const cooperative_groups::grid_group grid = cooperative_groups::this_grid();

  if (kShared) {                        // stage the slice's keys once
    for (int base = 0; base < len; base += kThreads * kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads + tid;
        v[u] = i < len ? x[i] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads + tid;
        if (i < len) slice_keys[i] = order_key(v[u], flip);
      }
    }
  }

  long long remaining =
      k_bytes == 8 ? *static_cast<const long long*>(k_ptr)
      : k_bytes == 4 ? static_cast<long long>(*static_cast<const int*>(k_ptr))
                     : k_value;
  uint32_t prefix = 0;
  int b = 0;
  long long total = 0;
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 24 - 8 * pass;
    const uint32_t pmask = pass == 0 ? 0u : 0xFFFFFFFFu << (shift + 8);
    if (tid < kBins) bins[tid] = 0;
    __syncthreads();                    // also orders the staging above
    // The trip count is the same for every thread: whole warps vote.
    for (int base = 0; base < len; base += kThreads * kUnroll) {
      uint32_t key[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads + tid;
        key[u] = i >= len ? 0u : kShared ? slice_keys[i] : order_key(x[i], flip);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads + tid;
        const bool match = i < len && (key[u] & pmask) == prefix;
        const unsigned voters = __ballot_sync(0xFFFFFFFFu, match);
        if (match) {
          const unsigned bk = (key[u] >> shift) & 0xFFu;
          const unsigned peers = __match_any_sync(voters, bk);
          if (lane == __ffs(peers) - 1) atomicAdd(&bins[bk], __popc(peers));
        }
      }
    }
    __syncthreads();
    int* hist = scratch + pass * kBins;
    if (tid < kBins && bins[tid]) atomicAdd(&hist[tid], bins[tid]);
    grid.sync();

    // Bucket search, in every block: inclusive scan of the 256 counts by
    // warps 0-7, then the first bin whose running count reaches
    // `remaining` (searchsorted, side="left"; 256 when none, clamped to 255).
    long long c = 0;
    if (warp < kBins / 32) {
      c = __ldcg(&hist[tid]);
      for (int off = 1; off < 32; off <<= 1) {
        const long long up = __shfl_up_sync(0xFFFFFFFFu, c, off);
        if (lane >= off) c += up;
      }
      if (lane == 31) warp_sum[warp] = c;
    }
    __syncthreads();
    if (tid < kBins) {
      for (int w = 0; w < warp; ++w) c += warp_sum[w];
      cdf[tid] = c;
    }
    __syncthreads();
    if (tid < kBins) {
      // cdf never falls, so exactly one thread writes.
      const bool reached = c >= remaining;
      if (reached ? tid == 0 || cdf[tid - 1] < remaining : tid == kBins - 1)
        bucket = tid;
    }
    __syncthreads();
    b = bucket;
    const long long below = b > 0 ? cdf[b - 1] : 0;
    total = cdf[b] - below;             // the bucket's count: at the last
    remaining -= below;                 // pass, the ties at the threshold
    prefix |= static_cast<uint32_t>(b) << shift;
    __syncthreads();                    // bins, cdf and bucket are reused
  }

  const uint32_t thresh = prefix;
  const long long needed = remaining;
  const long long lo = flip ? total - needed : 0;
  const long long hi = flip ? total : needed;
  if (tid == 0) {
    scratch[kTieWord + blockIdx.x] = bins[b];   // pass 3's count at thresh
    if (blockIdx.x == 0) {
      long long* triple = reinterpret_cast<long long*>(scratch + kTripleWord);
      triple[0] = thresh;
      triple[1] = needed;
      triple[2] = total;
    }
  }
  grid.sync();

  long long carry = 0;                  // ties in the blocks before this one
  for (int j = tid; j < static_cast<int>(blockIdx.x); j += kThreads)
    carry += __ldcg(&scratch[kTieWord + j]);
  carry = block_sum(carry, warp_sum);

  const unsigned lanes_below = (1u << lane) - 1u;
  for (int base = 0; base < len; base += kThreads) {
    const int i = base + tid;
    uint32_t key = 0;
    bool tie = false;
    if (i < len) {
      key = kShared ? slice_keys[i] : order_key(x[i], flip);
      tie = key == thresh;
    }
    const unsigned ties = __ballot_sync(0xFFFFFFFFu, tie);
    if (lane == 0) warp_ties[warp] = __popc(ties);
    __syncthreads();
    long long cum = carry;
    int round = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) cum += warp_ties[w];
      round += warp_ties[w];
    }
    // 1-based running tie count at this key, as cumsum(tie) gives it.
    cum += __popc(ties & lanes_below) + 1;
    if (i < len) mask[start + i] = key < thresh || (tie && cum > lo && cum <= hi);
    carry += round;
    __syncthreads();
  }
}

struct DeviceInfo {
  bool ready = false;
  int sms = 0;
  bool shared_fits = false;   // a block with kMaxSliceKeys keys is resident
  int global_blocks = 0;      // co-resident blocks of the global-memory path
};

cudaError_t device_info(int device, DeviceInfo** out) {
  static DeviceInfo infos[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& d = infos[device];
  if (!d.ready) {
    cudaError_t err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                             device);
    if (err != cudaSuccess) return err;
    const int bytes = kMaxSliceKeys * static_cast<int>(sizeof(uint32_t));
    int blocks = 0;
    if (cudaFuncSetAttribute(rank_select_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, rank_select_kernel<true>, kThreads, bytes) == cudaSuccess)
      d.shared_fits = blocks >= 1;
    cudaGetLastError();                 // a card without the room: global path
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &d.global_blocks, rank_select_kernel<false>, kThreads, 0);
    if (err != cudaSuccess) return err;
    d.ready = true;
  }
  *out = &d;
  return cudaSuccess;
}

}  // namespace

// scores (n,) f32; k from k_ptr (k_bytes 4: int32, 8: int64) or, with
// k_bytes 0, the value k_value; high != 0 selects the k largest.  scratch
// (scratch_words,) i32: on return its first 1024 words hold the four (256,)
// pass histograms, the next 6 the int64 (thresh, needed, total), and from
// word kTieWord one tie count per block.  mask (n,) bool.
extern "C" int rs_rank_select(const void* scores, const void* k_ptr, int k_bytes,
                              long long k_value, int high, void* scratch,
                              int scratch_words, void* mask, int n, int device,
                              void* stream) {
  if (n < 0 || (k_bytes != 0 && k_bytes != 4 && k_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  DeviceInfo* d = nullptr;
  err = device_info(device, &d);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Never more blocks than N has rows of kThreads keys; one a SM on the
  // shared-memory path, as many as are resident on the global one.
  const long long rows = (static_cast<long long>(n) + kThreads - 1) / kThreads;
  long long grid = rows < d->sms ? rows : d->sms;
  if (grid < 1) grid = 1;
  long long slice = (n + grid - 1) / grid;
  const bool shared = d->shared_fits && slice <= kMaxSliceKeys;
  if (!shared) {
    const long long cap = static_cast<long long>(d->global_blocks) * d->sms;
    grid = rows < cap ? rows : cap;
    if (grid < 1) grid = 1;
    slice = (n + grid - 1) / grid;
  }
  if (kTieWord + grid > scratch_words) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(scratch, 0, kTieWord * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* sc = static_cast<const float*>(scores);
  uint32_t flip = high ? 0xFFFFFFFFu : 0u;
  int* scr = static_cast<int*>(scratch);
  unsigned char* m = static_cast<unsigned char*>(mask);
  int slice_i = static_cast<int>(slice);
  void* args[] = {&sc, &k_ptr, &k_bytes, &k_value, &flip, &scr, &m, &n, &slice_i};
  const size_t smem = shared ? slice * sizeof(uint32_t) : 0;
  // A grid the card cannot hold at once is refused here, never run.
  err = cudaLaunchCooperativeKernel(
      shared ? reinterpret_cast<const void*>(rank_select_kernel<true>)
             : reinterpret_cast<const void*>(rank_select_kernel<false>),
      dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
