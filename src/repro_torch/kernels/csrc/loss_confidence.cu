// Fused per-row cross-entropy, prediction accuracy and prediction confidence.
//
// Replaces the Pallas kernel repro/kernels/loss_confidence.py
// (loss_confidence_kernel): one online-softmax pass over each row of a
// (T, V) logits matrix yields ce = lse - gold, correct = (gold >= max) and
// pmax = 1 / sum(exp(x - max)), with the reference's 1e-30 floors and its
// -1e30 initial max and gold.
//
// What bounds it on an H100: bytes.  Each logit is read once and costs a
// handful of float operations and one exp, far below the card's ~20
// operations per byte at 3.35 TB/s for fp32 outside the tensor cores.  At
// the CNN's (128, 10) the launch itself dominates.
//
// Design: the TPU kernel walks vocab tiles in sequence with the running
// (max, sum) in scratch memory; here each thread keeps its own running
// (m, l) over a strided walk of the row, and the partial pairs are merged
// with warp shuffles (and, for the block-per-row variant, through shared
// memory).  Rows of up to 1024 logits take one warp each, eight rows per
// block, so a (128, 10) batch is 16 blocks; longer rows take a 256-thread
// block each so that one row's bytes are in flight from many warps.  T and
// V are arbitrary: the strided walk stops at V and rows past T exit, so
// nothing is padded.  The gold logit is read once from labels[row].  Loads
// are f32 or bf16; all arithmetic is f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarp = 32;
constexpr int kRowsPerWarpBlock = 8;       // warp-per-row variant: 256 threads
constexpr int kBlockThreads = 256;         // block-per-row variant
constexpr int kWarpRowMaxV = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Online-softmax update of the running (m, l) with one logit.
__device__ __forceinline__ void online_update(float x, float& m, float& l) {
  if (x > m) {
    l = l * expf(m - x) + 1.0f;
    m = x;
  } else {
    l += expf(x - m);
  }
}

// Merge (m2, l2) into (m, l).
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ void warp_merge(float& m, float& l) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    merge(m, l, m2, l2);
  }
}

template <typename T>
__device__ __forceinline__ void finish(const T* row, int label, int v, float m,
                                       float l, int r, float* ce, int* correct,
                                       float* pmax) {
  float g = kNegInf;
  if (label >= 0 && label < v) g = fmaxf(to_f32(row[label]), kNegInf);
  float lf = fmaxf(l, 1e-30f);
  ce[r] = (m + logf(lf)) - g;
  correct[r] = g >= m ? 1 : 0;
  pmax[r] = 1.0f / lf;
}

template <typename T>
__global__ void __launch_bounds__(kWarp * kRowsPerWarpBlock)
lc_warp_rows(const T* __restrict__ logits, const int* __restrict__ labels,
             float* __restrict__ ce, int* __restrict__ correct,
             float* __restrict__ pmax, int t, int v) {
  const int lane = threadIdx.x % kWarp;
  const int r = blockIdx.x * kRowsPerWarpBlock + threadIdx.x / kWarp;
  if (r >= t) return;                      // whole warp exits together
  const T* row = logits + static_cast<size_t>(r) * v;
  float m = kNegInf, l = 0.0f;
  for (int j = lane; j < v; j += kWarp) online_update(to_f32(row[j]), m, l);
  warp_merge(m, l);
  if (lane == 0) finish(row, labels[r], v, m, l, r, ce, correct, pmax);
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
lc_block_rows(const T* __restrict__ logits, const int* __restrict__ labels,
              float* __restrict__ ce, int* __restrict__ correct,
              float* __restrict__ pmax, int t, int v) {
  __shared__ float sm[kBlockThreads / kWarp], sl[kBlockThreads / kWarp];
  const int r = blockIdx.x;
  const T* row = logits + static_cast<size_t>(r) * v;
  float m = kNegInf, l = 0.0f;
  for (int j = threadIdx.x; j < v; j += kBlockThreads)
    online_update(to_f32(row[j]), m, l);
  warp_merge(m, l);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (lane == 0) { sm[warp] = m; sl[warp] = l; }
  __syncthreads();
  if (warp == 0) {
    m = lane < kBlockThreads / kWarp ? sm[lane] : kNegInf;
    l = lane < kBlockThreads / kWarp ? sl[lane] : 0.0f;
    warp_merge(m, l);
    if (lane == 0) finish(row, labels[r], v, m, l, r, ce, correct, pmax);
  }
}

template <typename T>
int launch(const void* logits, const void* labels, void* ce, void* correct,
           void* pmax, int t, int v, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(logits);
  const int* lab = static_cast<const int*>(labels);
  float* o_ce = static_cast<float*>(ce);
  int* o_cor = static_cast<int*>(correct);
  float* o_pm = static_cast<float*>(pmax);
  if (t > 0) {
    if (v <= kWarpRowMaxV) {
      int grid = (t + kRowsPerWarpBlock - 1) / kRowsPerWarpBlock;
      lc_warp_rows<T><<<grid, kWarp * kRowsPerWarpBlock, 0, s>>>(
          x, lab, o_ce, o_cor, o_pm, t, v);
    } else {
      lc_block_rows<T><<<t, kBlockThreads, 0, s>>>(x, lab, o_ce, o_cor, o_pm,
                                                   t, v);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lc_forward_f32(const void* logits, const void* labels, void* ce,
                              void* correct, void* pmax, int t, int v,
                              int device, void* stream) {
  return launch<float>(logits, labels, ce, correct, pmax, t, v, device,
                       stream);
}

extern "C" int lc_forward_bf16(const void* logits, const void* labels,
                               void* ce, void* correct, void* pmax, int t,
                               int v, int device, void* stream) {
  return launch<__nv_bfloat16>(logits, labels, ce, correct, pmax, t, v,
                               device, stream);
}
