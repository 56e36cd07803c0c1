// The histogram-CDF hidden-sample selection in one persistent kernel.
//
// Replaces two Pallas kernels of repro/kernels/threshold_select.py and the
// ops that ran around them in repro/core/planops.py::histogram_masks:
//
// - minmax_kernel: the raw [lo, hi] of the valid losses, [BIG, -BIG] with
//   BIG = 3.4e38 when nothing is valid;
// - histogram_kernel: the count of valid losses in each of `bins` bins,
//   bin = clip(int((x - lo) / max(hi - lo, 1e-12) * bins), 0, bins - 1),
//   with lo = min(lo, hi) folded first;
// - the CDF walk: num_hide = floor(f32(low_fraction) * f32(N)), the first
//   bin b whose running count reaches it (searchsorted, side="left",
//   clamped to bins - 1), and whether to include it:
//   (num_hide - count below b) * 2 >= hist[b]; for high_fraction > 0 the
//   same walk mirrored from the top bin (DropTop);
// - the masks: low = valid && (include_b ? bin <= b : bin < b), high the
//   mirror.
// Non-finite losses count as invalid.  threshold_select.py::
// histogram_select_plain is the plain version, stage by stage.
//
// What bounds it on an H100: not the bytes.  At the plan's sizes (N = 5e4
// to 1.3e6) the losses and flags are 0.25 to 6.4 MB, 0.1 to 1.9 us at 3.35
// TB/s.  The stages depend on each other through grid-wide results (the
// range, then the histogram), so the time is the latency of two grid
// barriers and of the walk.  Earlier each stage was a launch, and the walk
// and masks some 50 PyTorch ops, all paced by the host.
//
// Design:
// - One cooperative launch (cudaLaunchCooperativeKernel), at most one block
//   of kThreads per SM on the shared-memory path, so that every block is
//   resident and may wait on the others.  Each block owns one contiguous
//   slice of [0, N).
// - The block loads its slice once, as x = valid && finite ? loss : NaN, so
//   NaN stands for "not valid" in every later pass.  Where the slice fits
//   beside the bins (kSmemBytes: 54,784 losses at 512 bins, so N up to
//   7,231,488 on 132 SMs) x stays in dynamic shared memory and HBM is read
//   once; above it each pass reads the slice again from global memory,
//   which L2 mostly serves.
// - Range: each block posts the min and max of its slice (invalid elements
//   count as BIG and -BIG, as the plain version's masked reduction has
//   them), a grid barrier, and every block reduces all the posts itself.
//   min and max are exact in any order, so [lo, hi] is the sequential one.
// - Histogram: each block counts its slice into shared bins (lanes of a
//   warp that hit one bin merge by __match_any_sync and add once: equal
//   losses are common), adds its non-zero bins to the global histogram
//   with atomics (integer counts: exact in any order), a grid barrier.
// - Walks: every block scans the same global counts (int64) and does both
//   walks itself, so all agree with no third barrier.  Then each writes
//   its slice's masks from the same bin arithmetic.
// - The bin index is __fsub_rn, __fdiv_rn, __fmul_rn (no contraction, no
//   approximate division), truncated toward zero and clamped: bit-identical
//   to the PyTorch and XLA formula.
// - The grid barrier is cooperative_groups' this_grid().sync(), which nvcc
//   12.x builds without -rdc for a cooperative launch.  A call is the
//   memset of the histogram and the kernel, two launches; the kernel
//   allocates nothing and reads low_fraction from a device scalar or by
//   value, so nothing in a call waits on the host.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;       // elements a thread has in flight in a pass
constexpr int kMaxBins = 8192;
// Dynamic shared memory a block uses at most: the bins' int64 CDF and int32
// counts (12 bytes a bin), then the slice's losses on the shared path
// (220 KiB of the 227 KiB a block may use on sm_90, beside the static).
constexpr int kSmemBytes = 220 * 1024;
// Scratch layout in 32-bit words (threshold_select.py mirrors it): the (6,)
// int64 walk (num_hide, b, include_b, num_top, b_top, include_bt), the (2,)
// f32 raw [lo, hi], the (bins,) i32 histogram, then (lo, hi) per block.
constexpr int kLoHiWord = 12;
constexpr int kHistWord = 14;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float load_x(const float* loss,
                                        const unsigned char* valid, int i) {
  const float v = loss[i];
  const bool finite = (__float_as_uint(v) & 0x7F800000u) != 0x7F800000u;
  return valid[i] && finite ? v : nan_f();
}

__device__ __forceinline__ int bin_of(float x, float lo, float span,
                                      float fbins, int bins) {
  const int b = __float2int_rz(__fmul_rn(__fdiv_rn(__fsub_rn(x, lo), span), fbins));
  return min(max(b, 0), bins - 1);
}

// floor(f32(fraction) * f32(n)) as the int32 the reference casts it to.
__device__ __forceinline__ long long count_of(float fraction, int n) {
  return static_cast<int>(floorf(__fmul_rn(fraction, static_cast<float>(n))));
}

// Block-wide min and max; every thread gets both.
__device__ __forceinline__ void block_minmax(float& lo, float& hi, float* wlo,
                                             float* whi) {
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xFFFFFFFFu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xFFFFFFFFu, hi, off));
  }
  if (threadIdx.x % 32 == 0) {
    wlo[threadIdx.x / 32] = lo;
    whi[threadIdx.x / 32] = hi;
  }
  __syncthreads();
  lo = wlo[0];
  hi = whi[0];
  for (int w = 1; w < kWarps; ++w) {
    lo = fminf(lo, wlo[w]);
    hi = fmaxf(hi, whi[w]);
  }
  __syncthreads();                      // wlo, whi are reused
}

// The slice's raw min and max (invalid as BIG and -BIG; an empty slice
// +inf and -inf), per thread (block_minmax folds them).  With kShared the
// loaded values, NaN for "not valid", are kept in xs.
template <bool kShared>
__device__ __forceinline__ void slice_minmax(const float* lp,
                                             const unsigned char* vp, int len,
                                             float* xs, float& lo, float& hi) {
  const int tid = threadIdx.x;
  lo = inf_f();
  hi = -inf_f();
  for (int base = 0; base < len; base += kThreads * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + tid;
      v[u] = i < len ? load_x(lp, vp, i) : nan_f();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + tid;
      if (i < len) {
        if (kShared) xs[i] = v[u];
        const bool ok = v[u] == v[u];
        lo = fminf(lo, ok ? v[u] : kBig);
        hi = fmaxf(hi, ok ? v[u] : -kBig);
      }
    }
  }
}

// The slice's valid losses counted into the block's shared `counts`.  The
// trip count is the same for every thread, so whole warps vote; lanes that
// hit one bin merge by __match_any_sync and add once.
template <bool kShared>
__device__ __forceinline__ void count_slice(const float* lp,
                                            const unsigned char* vp, int len,
                                            const float* xs, float lo_b,
                                            float span, float fbins, int bins,
                                            int* counts) {
  const int tid = threadIdx.x, lane = tid % 32;
  for (int base = 0; base < len; base += kThreads * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + tid;
      v[u] = i >= len ? nan_f() : kShared ? xs[i] : load_x(lp, vp, i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = v[u] == v[u];
      const unsigned voters = __ballot_sync(0xFFFFFFFFu, ok);
      if (ok) {
        const int b = bin_of(v[u], lo_b, span, fbins, bins);
        const unsigned peers = __match_any_sync(voters, b);
        if (lane == __ffs(peers) - 1) atomicAdd(&counts[b], __popc(peers));
      }
    }
  }
}

// The CDF walks over a histogram in global memory (`hist`, `bins` counts),
// run by a whole block: inclusive int64 scan of the counts in rounds of
// kThreads bins into `cdf` (the counts themselves into `counts`), then the
// first bin whose running count reaches the target (none: bins - 1), and
// whether to include it.  rcdf[j], the count in the top j + 1 bins, is
// total - cdf[bins - 2 - j].  Every thread returns the same walk.
struct Walk {
  long long num_hide, num_top;
  int b, b_top;
  bool include_b, include_bt;
};

__device__ __forceinline__ Walk walk_counts(const int* hist, int bins,
                                            long long num_hide,
                                            long long num_top, bool want_high,
                                            long long* cdf, int* counts,
                                            long long* wsum, int* picked) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  long long total = 0;
  for (int base = 0; base < bins; base += kThreads) {
    const int j = base + tid;
    const int h = j < bins ? __ldcg(&hist[j]) : 0;
    if (j < bins) counts[j] = h;
    long long c = h;
    for (int off = 1; off < 32; off <<= 1) {
      const long long up = __shfl_up_sync(0xFFFFFFFFu, c, off);
      if (lane >= off) c += up;
    }
    if (lane == 31) wsum[warp] = c;
    __syncthreads();
    long long before = total;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += wsum[w];
      total += wsum[w];
    }
    if (j < bins) cdf[j] = c + before;
    __syncthreads();                    // wsum is reused
  }
  if (tid == 0) picked[0] = picked[1] = bins - 1;
  __syncthreads();
  // Running counts never fall, so at most one thread writes each.
  for (int j = tid; j < bins; j += kThreads) {
    if (cdf[j] >= num_hide && (j == 0 || cdf[j - 1] < num_hide)) picked[0] = j;
    if (want_high) {
      const long long r = total - (j < bins - 1 ? cdf[bins - 2 - j] : 0);
      if (r >= num_top && (j == 0 || total - cdf[bins - 1 - j] < num_top))
        picked[1] = j;
    }
  }
  __syncthreads();
  Walk w;
  w.num_hide = num_hide;
  w.num_top = num_top;
  w.b = picked[0];
  w.include_b = (num_hide - (w.b > 0 ? cdf[w.b - 1] : 0)) * 2 >= counts[w.b];
  w.b_top = 0;
  w.include_bt = false;
  if (want_high) {
    const int bt = picked[1];
    w.b_top = bins - 1 - bt;
    w.include_bt = (num_top - (bt > 0 ? total - cdf[bins - 1 - bt] : 0)) * 2 >=
                   counts[w.b_top];
  }
  return w;
}

__device__ __forceinline__ void write_walk(long long* out, const Walk& w) {
  out[0] = w.num_hide;
  out[1] = w.b;
  out[2] = w.include_b;
  out[3] = w.num_top;
  out[4] = w.b_top;
  out[5] = w.include_bt;
}

// The masks of one loss x (NaN: not valid) from the walk's bins.
__device__ __forceinline__ void masks_of(float x, float lo_b, float span,
                                         float fbins, int bins, const Walk& w,
                                         bool& l, bool& h) {
  l = h = false;
  if (x == x) {
    const int idx = bin_of(x, lo_b, span, fbins, bins);
    l = w.include_b ? idx <= w.b : idx < w.b;
    h = w.include_bt ? idx >= w.b_top : idx > w.b_top;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
histogram_select_kernel(const float* __restrict__ loss,
                        const unsigned char* __restrict__ valid,
                        const float* frac_ptr, float frac_value,
                        float high_fraction, int bins, int* __restrict__ scratch,
                        unsigned char* __restrict__ low,
                        unsigned char* __restrict__ high, int n, int slice) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* cdf = reinterpret_cast<long long*>(smem);        // (bins,)
  int* counts = reinterpret_cast<int*>(cdf + bins);            // (bins,)
  float* xs = reinterpret_cast<float*>(counts + bins);         // (slice,)
  __shared__ float wlo[kWarps], whi[kWarps];
  __shared__ long long wsum[kWarps];
  __shared__ int picked[2];

  const int tid = threadIdx.x;
  const long long start = static_cast<long long>(blockIdx.x) * slice;
  const int len = static_cast<int>(
      start >= n ? 0 : (n - start < slice ? n - start : slice));
  const float* lp = loss + start;
  const unsigned char* vp = valid + start;
  int* hist = scratch + kHistWord;
  float* posts = reinterpret_cast<float*>(hist + bins);
  const cooperative_groups::grid_group grid = cooperative_groups::this_grid();

  // 1. Load the slice; the block's min and max, invalid as BIG and -BIG.
  float lo, hi;
  slice_minmax<kShared>(lp, vp, len, xs, lo, hi);
  for (int j = tid; j < bins; j += kThreads) counts[j] = 0;
  block_minmax(lo, hi, wlo, whi);
  if (tid == 0) {
    posts[2 * blockIdx.x] = lo;
    posts[2 * blockIdx.x + 1] = hi;
  }
  grid.sync();

  // 2. The range: every block reduces all the posts.
  lo = inf_f();
  hi = -inf_f();
  for (int j = tid; j < static_cast<int>(gridDim.x); j += kThreads) {
    lo = fminf(lo, __ldcg(&posts[2 * j]));
    hi = fmaxf(hi, __ldcg(&posts[2 * j + 1]));
  }
  block_minmax(lo, hi, wlo, whi);
  const float lo_b = fminf(lo, hi);     // nothing valid: [BIG, -BIG]
  const float span = fmaxf(__fsub_rn(hi, lo_b), 1e-12f);
  const float fbins = static_cast<float>(bins);

  // 3. The histogram.
  count_slice<kShared>(lp, vp, len, xs, lo_b, span, fbins, bins, counts);
  __syncthreads();
  for (int j = tid; j < bins; j += kThreads)
    if (counts[j]) atomicAdd(&hist[j], counts[j]);
  grid.sync();

  // 4. The walks, in every block.
  const bool want_high = high != nullptr;
  const Walk w = walk_counts(
      hist, bins, count_of(frac_ptr ? *frac_ptr : frac_value, n),
      want_high ? count_of(high_fraction, n) : 0, want_high, cdf, counts, wsum,
      picked);
  if (blockIdx.x == 0 && tid == 0) {
    write_walk(reinterpret_cast<long long*>(scratch), w);
    float* lo_hi = reinterpret_cast<float*>(scratch + kLoHiWord);
    lo_hi[0] = lo;
    lo_hi[1] = hi;
  }

  // 5. The masks, from the same bin arithmetic.
  for (int base = 0; base < len; base += kThreads) {
    const int i = base + tid;
    if (i < len) {
      const float x = kShared ? xs[i] : load_x(lp, vp, i);
      bool l, h;
      masks_of(x, lo_b, span, fbins, bins, w, l, h);
      low[start + i] = l;
      if (want_high) high[start + i] = h;
    }
  }
}


// ---------------------------------------------------------------------------
// The staged path: the same stages as separate launches, for a plan whose
// rows are split over ranks (core/planops.py::histogram_masks under a
// group).  Between them the caller reduces [lo, hi] (min, max) and the
// histogram (sum) over the ranks, which one launch cannot hold.  Each
// stage reads its inputs from device memory and shares the fused kernel's
// device functions (load_x, bin_of, count_of, walk_counts, masks_of), so a
// world of one gives the fused launch's bits.  range and count are
// cooperative (one 1,024-thread block a SM, all resident); the walk is an
// ordinary launch whose blocks each repeat the walk over the bins.

// B2: the raw local [lo, hi] into lo_hi[0..1]; posts (2 x grid) scratch.
__global__ void __launch_bounds__(kThreads, 1)
range_kernel(const float* __restrict__ loss,
             const unsigned char* __restrict__ valid, float* __restrict__ posts,
             float* __restrict__ lo_hi, int n, int slice) {
  __shared__ float wlo[kWarps], whi[kWarps];
  const long long start = static_cast<long long>(blockIdx.x) * slice;
  const int len = static_cast<int>(
      start >= n ? 0 : (n - start < slice ? n - start : slice));
  float lo, hi;
  slice_minmax<false>(loss + start, valid + start, len, nullptr, lo, hi);
  block_minmax(lo, hi, wlo, whi);
  if (threadIdx.x == 0) {
    posts[2 * blockIdx.x] = lo;
    posts[2 * blockIdx.x + 1] = hi;
  }
  cooperative_groups::this_grid().sync();
  if (blockIdx.x != 0) return;
  lo = inf_f();
  hi = -inf_f();
  for (int j = threadIdx.x; j < static_cast<int>(gridDim.x); j += kThreads) {
    lo = fminf(lo, __ldcg(&posts[2 * j]));
    hi = fmaxf(hi, __ldcg(&posts[2 * j + 1]));
  }
  block_minmax(lo, hi, wlo, whi);
  if (threadIdx.x == 0) {
    lo_hi[0] = lo;
    lo_hi[1] = hi;
  }
}

// The bin arithmetic's range from a raw [lo, hi] in device memory.
__device__ __forceinline__ void span_of(const float* lo_hi, float& lo_b,
                                        float& span) {
  const float lo = __ldcg(&lo_hi[0]), hi = __ldcg(&lo_hi[1]);
  lo_b = fminf(lo, hi);                 // nothing valid: [BIG, -BIG]
  span = fmaxf(__fsub_rn(hi, lo_b), 1e-12f);
}

// B3: the local counts over the [lo, hi] in lo_hi into hist (bins,), which
// the kernel zeroes itself before its grid barrier.
__global__ void __launch_bounds__(kThreads, 1)
count_kernel(const float* __restrict__ loss,
             const unsigned char* __restrict__ valid,
             const float* __restrict__ lo_hi, int* __restrict__ hist, int bins,
             int n, int slice) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* counts = reinterpret_cast<int*>(smem);                  // (bins,)
  const int tid = threadIdx.x;
  const long long start = static_cast<long long>(blockIdx.x) * slice;
  const int len = static_cast<int>(
      start >= n ? 0 : (n - start < slice ? n - start : slice));
  for (int j = tid; j < bins; j += kThreads) counts[j] = 0;
  for (int j = blockIdx.x * kThreads + tid; j < bins; j += gridDim.x * kThreads)
    hist[j] = 0;
  float lo_b, span;
  span_of(lo_hi, lo_b, span);
  __syncthreads();
  count_slice<false>(loss + start, valid + start, len, nullptr, lo_b, span,
                     static_cast<float>(bins), bins, counts);
  __syncthreads();
  cooperative_groups::this_grid().sync();   // every zero before any add
  for (int j = tid; j < bins; j += kThreads)
    if (counts[j]) atomicAdd(&hist[j], counts[j]);
}

// The walks over the (reduced) histogram in device memory, the counts from
// n_count rows (the ranks' total), then this rank's masks; block 0 writes
// the walk.
__global__ void __launch_bounds__(kThreads)
walk_kernel(const float* __restrict__ loss,
            const unsigned char* __restrict__ valid,
            const int* __restrict__ hist, const float* __restrict__ lo_hi,
            const float* frac_ptr, float frac_value, float high_fraction,
            int bins, int n_count, long long* __restrict__ walk,
            unsigned char* __restrict__ low, unsigned char* __restrict__ high,
            int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* cdf = reinterpret_cast<long long*>(smem);        // (bins,)
  int* counts = reinterpret_cast<int*>(cdf + bins);            // (bins,)
  __shared__ long long wsum[kWarps];
  __shared__ int picked[2];
  const bool want_high = high != nullptr;
  const Walk w = walk_counts(
      hist, bins, count_of(frac_ptr ? *frac_ptr : frac_value, n_count),
      want_high ? count_of(high_fraction, n_count) : 0, want_high, cdf, counts,
      wsum, picked);
  if (blockIdx.x == 0 && threadIdx.x == 0) write_walk(walk, w);
  float lo_b, span;
  span_of(lo_hi, lo_b, span);
  const float fbins = static_cast<float>(bins);
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    bool l, h;
    masks_of(load_x(loss, valid, static_cast<int>(i)), lo_b, span, fbins, bins,
             w, l, h);
    low[i] = l;
    if (want_high) high[i] = h;
  }
}

struct DeviceInfo {
  bool ready = false;
  int sms = 0;
  bool shared_fits = false;   // a block with kSmemBytes is resident
};

cudaError_t device_info(int device, DeviceInfo** out) {
  static DeviceInfo infos[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& d = infos[device];
  if (!d.ready) {
    cudaError_t err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                             device);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    if (cudaFuncSetAttribute(histogram_select_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, histogram_select_kernel<true>, kThreads, kSmemBytes) ==
            cudaSuccess)
      d.shared_fits = blocks >= 1;
    cudaGetLastError();                 // a card without the room: global path
    err = cudaFuncSetAttribute(histogram_select_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxBins * 12);
    if (err != cudaSuccess) return err;
    d.ready = true;
  }
  *out = &d;
  return cudaSuccess;
}

}  // namespace

// loss (n,) f32, valid (n,) bool; low_fraction from frac_ptr (a device f32)
// or, when it is null, the value frac_value; high_fraction by value, used
// when high is not null.  scratch (scratch_words,) i32: on return it holds
// the (6,) int64 walk, the (2,) f32 raw [lo, hi] and the (bins,) i32
// histogram (layout above).  low and high (n,) bool.
extern "C" int hs_histogram_select(const void* loss, const void* valid,
                                   const void* frac_ptr, float frac_value,
                                   float high_fraction, int bins, void* scratch,
                                   int scratch_words, void* low, void* high,
                                   int n, int device, void* stream) {
  if (n < 1 || bins < 1 || bins > kMaxBins)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  DeviceInfo* d = nullptr;
  err = device_info(device, &d);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Never more blocks than N has rows of kThreads elements; one a SM on the
  // shared-memory path, as many as are resident on the global one.
  const long long rows = (static_cast<long long>(n) + kThreads - 1) / kThreads;
  long long grid = rows < d->sms ? rows : d->sms;
  long long slice = (n + grid - 1) / grid;
  const long long bin_bytes = 12LL * bins;
  const bool shared = d->shared_fits && bin_bytes + 4 * slice <= kSmemBytes;
  if (!shared) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, histogram_select_kernel<false>, kThreads, bin_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long cap = static_cast<long long>(per_sm) * d->sms;
    grid = rows < cap ? rows : cap;
    if (grid < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    slice = (n + grid - 1) / grid;
  }
  if (kHistWord + bins + 2 * grid > scratch_words)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* scr = static_cast<int*>(scratch);
  err = cudaMemsetAsync(scr + kHistWord, 0, bins * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* lp = static_cast<const float*>(loss);
  const unsigned char* vp = static_cast<const unsigned char*>(valid);
  const float* fp = static_cast<const float*>(frac_ptr);
  unsigned char* lm = static_cast<unsigned char*>(low);
  unsigned char* hm = static_cast<unsigned char*>(high);
  int slice_i = static_cast<int>(slice);
  void* args[] = {&lp, &vp, &fp, &frac_value, &high_fraction, &bins, &scr,
                  &lm, &hm, &n, &slice_i};
  const size_t smem = bin_bytes + (shared ? 4 * slice : 0);
  // A grid the card cannot hold at once is refused here, never run.
  err = cudaLaunchCooperativeKernel(
      shared ? reinterpret_cast<const void*>(histogram_select_kernel<true>)
             : reinterpret_cast<const void*>(histogram_select_kernel<false>),
      dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}


// The staged grids: one block of kThreads a SM at most, never more blocks
// than N has rows of kThreads elements.
static int staged_grid(int n, int device, int* grid, int* slice) {
  DeviceInfo* d = nullptr;
  cudaError_t err = device_info(device, &d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = (static_cast<long long>(n) + kThreads - 1) / kThreads;
  *grid = static_cast<int>(rows < d->sms ? rows : d->sms);
  *slice = static_cast<int>((n + *grid - 1) / *grid);
  return 0;
}

// loss (n,) f32, valid (n,) bool -> lo_hi (2,) f32, the raw local [lo, hi];
// posts (2 x posts_blocks,) f32 scratch.
extern "C" int hs_range(const void* loss, const void* valid, void* posts,
                        int posts_blocks, void* lo_hi, int n, int device,
                        void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = 0, slice = 0;
  int code = staged_grid(n, device, &grid, &slice);
  if (code != 0) return code;
  if (grid > posts_blocks) return static_cast<int>(cudaErrorInvalidValue);
  const float* lp = static_cast<const float*>(loss);
  const unsigned char* vp = static_cast<const unsigned char*>(valid);
  float* pp = static_cast<float*>(posts);
  float* out = static_cast<float*>(lo_hi);
  void* args[] = {&lp, &vp, &pp, &out, &n, &slice};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(range_kernel),
                                    dim3(grid), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// loss (n,) f32, valid (n,) bool, lo_hi (2,) f32 -> hist (bins,) i32.
extern "C" int hs_count(const void* loss, const void* valid, const void* lo_hi,
                        void* hist, int bins, int n, int device, void* stream) {
  if (n < 1 || bins < 1 || bins > kMaxBins)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = 0, slice = 0;
  int code = staged_grid(n, device, &grid, &slice);
  if (code != 0) return code;
  const float* lp = static_cast<const float*>(loss);
  const unsigned char* vp = static_cast<const unsigned char*>(valid);
  const float* lh = static_cast<const float*>(lo_hi);
  int* hp = static_cast<int*>(hist);
  void* args[] = {&lp, &vp, &lh, &hp, &bins, &n, &slice};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(count_kernel),
                                    dim3(grid), dim3(kThreads), args,
                                    sizeof(int) * bins,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// loss (n,) f32, valid (n,) bool, hist (bins,) i32 and lo_hi (2,) f32 (the
// ranks' reduced ones); low_fraction from frac_ptr (a device f32) or, when
// it is null, frac_value; the counts from n_count rows -> walk (6,) int64,
// low (n,) bool and, when not null, high (n,) bool.
extern "C" int hs_walk(const void* loss, const void* valid, const void* hist,
                       const void* lo_hi, const void* frac_ptr, float frac_value,
                       float high_fraction, int bins, int n_count, void* walk,
                       void* low, void* high, int n, int device, void* stream) {
  if (n < 1 || bins < 1 || bins > kMaxBins)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = 0, slice = 0;
  int code = staged_grid(n, device, &grid, &slice);
  if (code != 0) return code;
  const size_t smem = 12 * static_cast<size_t>(bins);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(walk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  walk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(loss), static_cast<const unsigned char*>(valid),
      static_cast<const int*>(hist), static_cast<const float*>(lo_hi),
      static_cast<const float*>(frac_ptr), frac_value, high_fraction, bins,
      n_count, static_cast<long long*>(walk), static_cast<unsigned char*>(low),
      static_cast<unsigned char*>(high), n);
  return static_cast<int>(cudaGetLastError());
}
