// Fused per-row cross-entropy, prediction accuracy and prediction
// confidence, and the analytic gradient of the cross-entropy.
//
// Forward: replaces the Pallas kernel repro/kernels/loss_confidence.py
// (loss_confidence_kernel): one online-softmax pass over each row of a
// (T, V) logits matrix yields ce = lse - gold, correct = (gold >= max) and
// pmax = 1 / sum(exp(x - max)), with the reference's 1e-30 floors and its
// -1e30 initial max and gold.
//
// Backward: replaces the jnp bwd of the custom_vjp around it
// (repro/kernels/ops.py::_fused_metrics_vjp, bwd), which XLA fuses into one
// elementwise pass:
//   dlogits[r, j] = (exp(x[r, j] - lse_r) - [j == label_r]) * g_r,
//   lse_r = ce_r + x[r, label_r]
// (the lse rebuilt from the saved forward result, not reduced again), in
// the logits' dtype, with the arithmetic in f32.
//
// What bounds both on an H100: bytes.  Each logit costs a handful of float
// operations and one exp, far below the card's ~20 operations per byte at
// 3.35 TB/s for fp32 outside the tensor cores.  The forward reads the
// logits once; the backward reads them once and writes the gradient once.
// At the CNN's (128, 10) neither moves enough bytes to matter: there the
// cost is the call, so each is one launch that allocates nothing and reads
// nothing back on the host, and a fused-scoring step makes two launches
// (the backward as PyTorch ops would be ten, and an int32 `correct` would
// need one more to become a bool).
//
// Forward design: the TPU kernel walks vocab tiles in sequence with the
// running (max, sum) in scratch memory; here each thread keeps its own
// running (m, l) over a strided walk of the row, and the partial pairs are
// merged with warp shuffles (and, for the block-per-row variant, through
// shared memory).  Rows of up to 1024 logits take one warp each, eight
// rows per block, so a (128, 10) batch is 16 blocks; longer rows take a
// 256-thread block each, reading 16 bytes a load where every row starts
// 16-byte aligned (V a multiple of 4 in f32, of 8 in bf16, and the base
// aligned), else 4 or 2.  `correct` is written as one byte, straight into
// a torch.bool tensor.
//
// Backward design: a flat grid of (row group, column tile) blocks, so that
// (128, 10) is one small launch of 16 blocks and (4096, 151936) some
// 150,000 blocks over all 132 SMs.  Each thread issues all its loads of a
// tile (kUnroll vectors of 16 bytes where aligned, else scalars with the
// ragged tail masked) before it computes, to keep bytes in flight; the
// row's label, ce, g and gold logit are read once per thread from L1/L2.
// The cotangent g is read through its stride (0 for the mean's expanded
// gradient), so no copy is launched for it.  T and V are arbitrary in
// both kernels; nothing is padded.  No --use_fast_math: exp is expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarp = 32;
constexpr int kRowsPerWarpBlock = 8;       // warp-per-row variant: 256 threads
constexpr int kBlockThreads = 256;         // block-per-row variant, backward
constexpr int kWarpRowMaxV = 1024;
constexpr int kUnroll = 4;                 // backward: loads in flight a thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// Sixteen bytes of logits as floats: 4 f32 or 8 bf16 (bf16 -> f32 is exact:
// the bf16 bits are the f32's upper half; element 0 is the low half-word).
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ void unpack(uint4 q, float (&f)[4]) {
  f[0] = __uint_as_float(q.x); f[1] = __uint_as_float(q.y);
  f[2] = __uint_as_float(q.z); f[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack(uint4 q, float (&f)[8]) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
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
                                       float l, int r, float* ce,
                                       unsigned char* correct, float* pmax) {
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
             float* __restrict__ ce, unsigned char* __restrict__ correct,
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

// kVector: the row is walked in 16-byte loads (v % kVec<T> == 0 and the
// base 16-byte aligned, so every row is); else element by element.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kBlockThreads)
lc_block_rows(const T* __restrict__ logits, const int* __restrict__ labels,
              float* __restrict__ ce, unsigned char* __restrict__ correct,
              float* __restrict__ pmax, int t, int v) {
  __shared__ float sm[kBlockThreads / kWarp], sl[kBlockThreads / kWarp];
  const int r = blockIdx.x;
  const T* row = logits + static_cast<size_t>(r) * v;
  float m = kNegInf, l = 0.0f;
  if constexpr (kVector) {
    constexpr int E = kVec<T>;
    const uint4* rv = reinterpret_cast<const uint4*>(row);
    for (int i = threadIdx.x; i < v / E; i += kBlockThreads) {
      float f[E];
      unpack(__ldg(rv + i), f);
#pragma unroll
      for (int e = 0; e < E; ++e) online_update(f[e], m, l);
    }
  } else {
    for (int j = threadIdx.x; j < v; j += kBlockThreads)
      online_update(to_f32(row[j]), m, l);
  }
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

// One (row group, column tile) a block: blockDim = (tx, ty), ty rows of
// tiles * tx * E * kUnroll columns; E = kVec<T> on the 16-byte path, else 1.
template <typename T, int E>
__global__ void __launch_bounds__(kBlockThreads)
lc_backward(const T* __restrict__ logits, const int* __restrict__ labels,
            const float* __restrict__ ce, const float* __restrict__ g,
            long long g_stride, T* __restrict__ dlogits, int t, int v,
            int tiles) {
  const int group = blockIdx.x / tiles;
  const int tile = blockIdx.x - group * tiles;
  const int r = group * blockDim.y + threadIdx.y;
  if (r >= t) return;
  const size_t base = static_cast<size_t>(r) * v;
  const int c0 = (tile * kUnroll * blockDim.x + threadIdx.x) * E;
  const int step = blockDim.x * E;
  // Every load of the tile first, then the arithmetic.
  float f[kUnroll][E];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int c = c0 + u * step;
    if constexpr (E == 1) {
      f[u][0] = c < v ? to_f32(logits[base + c]) : 0.0f;
    } else if (c < v) {
      unpack(__ldcs(reinterpret_cast<const uint4*>(logits + base + c)), f[u]);
    }
  }
  const int label = labels[r];
  // The reference's gold is a gather (take_along_axis): an out-of-range
  // label has no gold logit; its row comes out NaN instead of faulting.
  const float gold = label >= 0 && label < v ? to_f32(logits[base + label])
                                             : __int_as_float(0x7fc00000);
  const float lse = ce[r] + gold;
  const float gr = g[r * g_stride];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int c = c0 + u * step;
    if (c >= v) break;
    float d[E];
#pragma unroll
    for (int e = 0; e < E; ++e)
      d[e] = (expf(f[u][e] - lse) - (c + e == label ? 1.0f : 0.0f)) * gr;
    if constexpr (E == 1) {
      from_f32(d[0], dlogits + base + c);
    } else {
      *reinterpret_cast<uint4*>(dlogits + base + c) = pack(d);
    }
  }
}

int set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch_forward(const void* logits, const void* labels, void* ce,
                   void* correct, void* pmax, int t, int v, int device,
                   void* stream) {
  if (int err = set_device(device)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(logits);
  const int* lab = static_cast<const int*>(labels);
  float* o_ce = static_cast<float*>(ce);
  unsigned char* o_cor = static_cast<unsigned char*>(correct);
  float* o_pm = static_cast<float*>(pmax);
  if (t > 0) {
    if (v <= kWarpRowMaxV) {
      int grid = (t + kRowsPerWarpBlock - 1) / kRowsPerWarpBlock;
      lc_warp_rows<T><<<grid, kWarp * kRowsPerWarpBlock, 0, s>>>(
          x, lab, o_ce, o_cor, o_pm, t, v);
    } else if (v % kVec<T> == 0 && aligned16(logits)) {
      lc_block_rows<T, true><<<t, kBlockThreads, 0, s>>>(x, lab, o_ce, o_cor,
                                                         o_pm, t, v);
    } else {
      lc_block_rows<T, false><<<t, kBlockThreads, 0, s>>>(x, lab, o_ce, o_cor,
                                                          o_pm, t, v);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E>
int launch_backward_tiles(const T* x, const int* lab, const float* ce,
                          const float* g, long long g_stride, T* out, int t,
                          int v, cudaStream_t s) {
  // tx: enough threads for the row (a warp at least), at most the block.
  const long long per_thread = static_cast<long long>(E) * kUnroll;
  const long long need = (v + per_thread - 1) / per_thread;
  const int tx = static_cast<int>(
      need >= kBlockThreads ? kBlockThreads : (need + kWarp - 1) / kWarp * kWarp);
  const int ty = kBlockThreads / tx;
  const long long cols = per_thread * tx;
  const int tiles = static_cast<int>((v + cols - 1) / cols);
  const long long blocks = (t + ty - 1) / ty * static_cast<long long>(tiles);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  lc_backward<T, E><<<static_cast<unsigned>(blocks), dim3(tx, ty), 0, s>>>(
      x, lab, ce, g, g_stride, out, t, v, tiles);
  return 0;
}

template <typename T>
int launch_backward(const void* logits, const void* labels, const void* ce,
                    const void* g, long long g_stride, void* dlogits, int t,
                    int v, int device, void* stream) {
  if (int err = set_device(device)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(logits);
  const int* lab = static_cast<const int*>(labels);
  const float* c = static_cast<const float*>(ce);
  const float* gg = static_cast<const float*>(g);
  T* out = static_cast<T*>(dlogits);
  if (t > 0 && v > 0) {
    int err = v % kVec<T> == 0 && aligned16(logits) && aligned16(dlogits)
                  ? launch_backward_tiles<T, kVec<T>>(x, lab, c, gg, g_stride,
                                                      out, t, v, s)
                  : launch_backward_tiles<T, 1>(x, lab, c, gg, g_stride, out,
                                                t, v, s);
    if (err) return err;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lc_forward_f32(const void* logits, const void* labels, void* ce,
                              void* correct, void* pmax, int t, int v,
                              int device, void* stream) {
  return launch_forward<float>(logits, labels, ce, correct, pmax, t, v,
                               device, stream);
}

extern "C" int lc_forward_bf16(const void* logits, const void* labels,
                               void* ce, void* correct, void* pmax, int t,
                               int v, int device, void* stream) {
  return launch_forward<__nv_bfloat16>(logits, labels, ce, correct, pmax, t,
                                       v, device, stream);
}

extern "C" int lc_backward_f32(const void* logits, const void* labels,
                               const void* ce, const void* g,
                               long long g_stride, void* dlogits, int t, int v,
                               int device, void* stream) {
  return launch_backward<float>(logits, labels, ce, g, g_stride, dlogits, t,
                                v, device, stream);
}

extern "C" int lc_backward_bf16(const void* logits, const void* labels,
                                const void* ce, const void* g,
                                long long g_stride, void* dlogits, int t,
                                int v, int device, void* stream) {
  return launch_backward<__nv_bfloat16>(logits, labels, ce, g, g_stride,
                                        dlogits, t, v, device, stream);
}
