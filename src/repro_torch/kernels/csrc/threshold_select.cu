// Range and histogram passes of the histogram-CDF hidden-sample selection.
//
// Replaces two Pallas kernels of repro/kernels/threshold_select.py:
//
// - minmax_kernel: masked min/max of the valid losses.  Returns the raw
//   [lo, hi], i.e. [BIG, -BIG] with BIG = 3.4e38 when nothing is valid;
//   the caller folds the degenerate case.
// - histogram_kernel: the count of valid losses in each of `bins` bins over
//   [lo, hi], bin = clip(int((x - lo) / max(hi - lo, 1e-12) * bins), 0,
//   bins - 1), with lo = min(lo, hi) folded as histogram_with_range does.
//
// What bounds them on an H100: bytes.  Both stream N losses (4 bytes) and N
// valid flags (1 byte) once and do a few operations on each; at the
// selection's sizes (N = 5e4 to 1.3e6) a pass moves 0.25 to 6.4 MB, so the
// launch and the tail of the grid weigh as much as the stream itself.
//
// Design: the TPU kernels carry one accumulator across a sequential grid.
// Here blocks run in parallel, so each pass is a grid-stride loop with the
// reduction inside the block and a second step across blocks:
// - min/max: every block writes its partial (min, max) to a scratch array,
//   and a second one-block kernel reduces the partials.  min and max are
//   exact in any order, so the result equals the sequential one.
// - histogram: each block counts into its own bins in shared memory with
//   atomicAdd, then adds every non-zero bin to the output with one global
//   atomicAdd.  Integer counts make the result independent of the order.
//   The output is zeroed by a small kernel launched first on the same
//   stream.  lo and hi are read from a 2-float device array (the min/max
//   output), so no host round trip sits between the two passes.
// The bin index is computed with __fsub_rn, __fdiv_rn and __fmul_rn (no
// fast-math contraction or approximate division), then truncated toward
// zero and clamped: bit-identical to the PyTorch and XLA formula.
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kThreads = 256;
constexpr int kMaxBins = 8192;   // 32 KB of shared-memory counters

__device__ __forceinline__ void block_minmax(float& lo, float& hi) {
  __shared__ float slo[kThreads / 32], shi[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) { slo[warp] = lo; shi[warp] = hi; }
  __syncthreads();
  if (warp == 0) {
    lo = lane < kThreads / 32 ? slo[lane] : kBig;
    hi = lane < kThreads / 32 ? shi[lane] : -kBig;
    for (int off = 16; off > 0; off >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
minmax_partial(const float* __restrict__ loss,
               const unsigned char* __restrict__ valid,
               float* __restrict__ partial, int n) {
  float lo = kBig, hi = -kBig;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    if (valid[i]) {
      float x = loss[i];
      lo = fminf(lo, x);
      hi = fmaxf(hi, x);
    }
  }
  block_minmax(lo, hi);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = lo;
    partial[2 * blockIdx.x + 1] = hi;
  }
}

__global__ void __launch_bounds__(kThreads)
minmax_final(const float* __restrict__ partial, float* __restrict__ out,
             int num_partials) {
  float lo = kBig, hi = -kBig;
  for (int i = threadIdx.x; i < num_partials; i += kThreads) {
    lo = fminf(lo, partial[2 * i]);
    hi = fmaxf(hi, partial[2 * i + 1]);
  }
  block_minmax(lo, hi);
  if (threadIdx.x == 0) {
    out[0] = lo;
    out[1] = hi;
  }
}

__global__ void zero_bins(int* __restrict__ out, int bins) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < bins;
       i += gridDim.x * blockDim.x)
    out[i] = 0;
}

__global__ void __launch_bounds__(kThreads)
histogram_bins(const float* __restrict__ loss,
               const unsigned char* __restrict__ valid,
               const float* __restrict__ range, int* __restrict__ out, int n,
               int bins) {
  extern __shared__ int counts[];
  for (int b = threadIdx.x; b < bins; b += kThreads) counts[b] = 0;
  __syncthreads();
  const float hi = range[1];
  const float lo = fminf(range[0], hi);
  const float span = fmaxf(__fsub_rn(hi, lo), 1e-12f);
  const float fbins = static_cast<float>(bins);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    if (valid[i]) {
      float t = __fmul_rn(__fdiv_rn(__fsub_rn(loss[i], lo), span), fbins);
      int b = __float2int_rz(t);
      b = min(max(b, 0), bins - 1);
      atomicAdd(&counts[b], 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += kThreads)
    if (counts[b]) atomicAdd(&out[b], counts[b]);
}

}  // namespace

// loss (n,) f32, valid (n,) bool, partial (2 * num_blocks,) f32 scratch,
// out (2,) f32.  num_blocks in [1, 1024].
extern "C" int ts_minmax(const void* loss, const void* valid, void* partial,
                         void* out, int n, int num_blocks, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  minmax_partial<<<num_blocks, kThreads, 0, s>>>(
      static_cast<const float*>(loss), static_cast<const unsigned char*>(valid),
      static_cast<float*>(partial), n);
  minmax_final<<<1, kThreads, 0, s>>>(static_cast<const float*>(partial),
                                      static_cast<float*>(out), num_blocks);
  return static_cast<int>(cudaGetLastError());
}

// loss (n,) f32, valid (n,) bool, range (2,) f32 raw [lo, hi], out (bins,)
// i32.  bins in [1, kMaxBins].
extern "C" int ts_histogram(const void* loss, const void* valid,
                            const void* range, void* out, int n, int bins,
                            int device, void* stream) {
  if (bins < 1 || bins > kMaxBins)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  zero_bins<<<(bins + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<int*>(out), bins);
  int grid = (n + kThreads - 1) / kThreads;
  grid = grid < 1 ? 1 : (grid > 1024 ? 1024 : grid);
  histogram_bins<<<grid, kThreads, bins * sizeof(int), s>>>(
      static_cast<const float*>(loss), static_cast<const unsigned char*>(valid),
      static_cast<const float*>(range), static_cast<int*>(out), n, bins);
  return static_cast<int>(cudaGetLastError());
}
