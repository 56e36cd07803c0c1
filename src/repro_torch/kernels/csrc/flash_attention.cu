// Forward attention with an online softmax (kernel B7), float32 or bfloat16
// inputs, float32 arithmetic, both products on the tensor cores in 3xTF32.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py
// (flash_attention, reached through repro/kernels/ops.py::flash_attention).
// Per (batch, query head h) with KV head h / (Hq / Hkv) (GQA: K and V are
// never repeated) and scale = d^-0.5:
//   s[t, u] = (q_t . k_u) * scale,  -1e30 where causal and u > t
//   o_t     = sum_u exp(s[t, u] - m_t) v_u / max(l_t, 1e-30)
// with m_t the row's running max and l_t its running sum of exp(s - m_t),
// both carried in float32 over tiles of 64 keys, as the TPU kernel carries
// them in VMEM scratch across its sequential key axis.
//
// What bounds it on an H100: operations.  At the serve shape of smollm-135m
// (B = 4, S = 2048, Hq = 9, Hkv = 3, D = 64, causal, float32) the two
// products over the causal half, s(s+1)/2 (query, key) pairs, are
// 4 B Hq D S(S+1)/2 = 19.3 GFLOP: 0.117 ms at 495 / 3 = 165 TFLOP/s (TF32
// dense, three passes), 0.289 ms at the 67 TFLOP/s of fp32 on the CUDA
// cores, against 50.3 MB of q, k, v and o (0.015 ms at 3.35 TB/s).
//
// Design.  mma.sync and not wgmma: wgmma takes TF32 only with both
// operands K-major in shared memory, which V is not, and it would move the
// split of K and V into TF32 halves into shared memory too.
// - One block of 4 warps per (query tile of 64 rows, batch.head); each
//   warp owns 16 query rows, the M of one mma.sync.m16n8k8 (mma_tf32.cuh).
// - The block loops over the key tiles with K and V in shared memory, two
//   stages deep: tile kt + 1 is copied by cp.async while tile kt is
//   multiplied.  Rows of D + 4 floats put the fragment reads (K: row g,
//   column q; V: row 2q, column g) in distinct banks.
// - A warp keeps in registers its Q fragments (split into TF32 halves
//   once, for D <= 64; at D = 128 they come from a shared tile), its
//   16 x 64 score tile, its 16 x D output accumulator O, m and l.
// - S = Q K^T and P V are 3xTF32 MMAs.  Each tile's P V starts from zero
//   and is folded into O by an FFMA (O alpha + P V), which rounds where the
//   tensor core's float32 sums do not.
// - P never leaves registers: S's accumulator holds row g at keys (2q,
//   2q + 1) of each 8-key tile, and P V reads A-column q as key 2q and
//   A-column q + 4 as key 2q + 1 (a permutation of the summed keys, matched
//   in the rows of V it reads), so S's fragment is P V's A fragment as it
//   lies.  Row max and sum go across the quad of lanes sharing a row.
// - Only tiles that reach past S or the warp's diagonal evaluate the
//   mask.  A causal block stops at its diagonal tile and skips the 8-key
//   column tiles above its warp's rows (the TPU kernel also runs the tiles
//   above the diagonal, which add exp(-1e30 - m) = 0: key 0 lies in the
//   first tile, so m is finite from the first step).  Query tiles start
//   longest first (blockIdx.y reversed).
// Shared memory: 4 tiles of 64 x (D + 4) floats (K, V, two stages), 68 KB
// at D = 64; at D = 128 a fifth for Q, 165 KB.
//
// Layout: q, k, v are (B, S, H, D), read in place through their strides
// (only the last dimension must be dense; the JAX wrapper's transposes to
// (B.H, S, D) and back are copies the port does not make); o is a
// contiguous (B, S, Hq, D) in q's type.  cp.async takes 16-byte rows, so
// float32 K and V whose base or strides are not multiples of 16 bytes, and
// bfloat16 inputs (converted to float32 on their way into shared memory,
// back with round to nearest even on the store), are copied by plain loads
// and stores into the same two stages.  A ragged S is masked, not padded:
// rows and keys past S load as zeros, keys past S score -1e30 and query
// rows past S are never written.  D is 16, 32, 64 or 128 (a template
// parameter; the wrapper checks it).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

using tf32x3::FragA;
using tf32x3::FragB;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileQ = 16 * kWarps;       // query rows of a block
constexpr int kTileK = 64;                // keys of a tile
constexpr int kNT = kTileK / 8;           // 8-key column tiles of S
static_assert(kTileQ == kTileK, "a causal block's last tile is its own");
constexpr float kNegInf = -1e30f;         // the reference's mask value

// Element strides over (batch, position, head); the last dimension is dense.
struct Strides {
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h;
};

using tf32x3::to_float;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Rows r0 .. r0 + 63 (r0 < S) of one head into a shared tile of row stride
// D + 4 floats, as float32; rows past S as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int r0, int S,
                                          bool async) {
  tf32x3::load_rows<kThreads>(dst, D + 4, src + r0 * row_stride, row_stride,
                              kTileK, S - r0, D, async);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int Hq, int group, int causal, float scale, int async,
                       Strides st) {
  constexpr int LD = D + 4;               // padded row of every tile
  constexpr int KS = D / 8;               // 8-wide steps over d
  constexpr bool kQRegs = D <= 64;        // Q fragments held in registers
  constexpr int kStage = 2 * kTileK * LD;  // one stage: K, then V
  extern __shared__ float4 smem4[];       // float4: 16-byte aligned
  float* const stages = reinterpret_cast<float*>(smem4);
  float* const sQ = stages + 2 * kStage;  // kTileQ x LD, only if !kQRegs

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, qd = lane % 4;
  const int qt = gridDim.y - 1 - blockIdx.y;     // longest rows first
  const int q0 = qt * kTileQ;
  const int bh = blockIdx.x, batch = bh / Hq, h = bh % Hq, hk = h / group;
  const T* qh = q + batch * st.q_b + h * st.q_h;
  const T* kh = k + batch * st.k_b + hk * st.k_h;
  const T* vh = v + batch * st.v_b + hk * st.v_h;
  const int w0 = 16 * warp;               // this warp's first row in the tile
  const int t_lo = q0 + w0 + g, t_hi = t_lo + 8;  // the rows of this lane
  const bool cp = async != 0;

  const int n_k = (S + kTileK - 1) / kTileK;
  const int n_kt = causal ? qt + 1 : n_k;
  if (!kQRegs) load_tile<T, D>(sQ, qh, st.q_s, q0, S, cp);
  load_tile<T, D>(stages, kh, st.k_s, 0, S, cp);
  load_tile<T, D>(stages + kTileK * LD, vh, st.v_s, 0, S, cp);
  tf32x3::cp_async_commit();

  FragA qf[kQRegs ? KS : 1];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int d = 8 * kk + qd;
      auto at = [&](int t, int dd) {
        return t < S ? to_float(qh[t * st.q_s + dd]) : 0.0f;
      };
      tf32x3::set_a(qf[kk], at(t_lo, d), at(t_hi, d), at(t_lo, d + 4),
                    at(t_hi, d + 4));
    }
  }

  float acc[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTileK;
    const float* K = stages + (kt & 1) * kStage;
    const float* V = K + kTileK * LD;
    if (kt + 1 < n_kt) {                  // the next tile, into the other stage
      float* next = stages + ((kt + 1) & 1) * kStage;
      load_tile<T, D>(next, kh, st.k_s, k0 + kTileK, S, cp);
      load_tile<T, D>(next + kTileK * LD, vh, st.v_s, k0 + kTileK, S, cp);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();                      // tile kt is in shared memory
    // Column tiles above every row of this warp add nothing: skip them.
    const int j_end = (causal && k0 + kTileK > q0 + w0)
                          ? min(kNT, (q0 + w0 + 16 - k0 + 7) / 8)
                          : kNT;

    // S = Q K^T: row t_lo / t_hi against key k0 + 8 j + 2 qd (+1).
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      FragA a;
      if constexpr (kQRegs) {
        a = qf[kk];
      } else {
        const float* r0 = sQ + (w0 + g) * LD + 8 * kk + qd;
        tf32x3::set_a(a, r0[0], r0[8 * LD], r0[4], r0[8 * LD + 4]);
      }
      FragB b[kNT];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j < j_end) {
          const float* kr = K + (8 * j + g) * LD + 8 * kk + qd;
          tf32x3::set_b(b[j], kr[0], kr[4]);
        }
      }
      tf32x3::mma3(s, a, b, j_end);
    }

    // Online softmax of the rows t_lo (r = 0) and t_hi (r = 1), each
    // spread over the 4 lanes of a quad.  Only a tile that reaches past S
    // or, causal, past this warp's first row has keys to mask.
    const bool edge = k0 + kTileK > S || (causal && k0 + kTileK - 1 > q0 + w0);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r ? t_hi : t_lo;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int u = k0 + 8 * j + 2 * qd + e;
          const float x = (edge && (u >= S || (causal && u > t)))
                              ? kNegInf
                              : s[j][2 * r + e] * scale;
          s[j][2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[j][2 * r + e] - m_new);
          s[j][2 * r + e] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }

    // O = O alpha + P V.  A-column qd is key 2 qd of the 8-key tile j,
    // A-column qd + 4 is key 2 qd + 1: S's accumulator as it lies.  P V
    // goes into a fresh accumulator, added to O by an FFMA: the tensor
    // core's float32 sums do not round to nearest, and chained over every
    // key tile they doubled O's error.
    float pv[KS][4];
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.0f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j < j_end) {
        FragA a;
        tf32x3::set_a(a, s[j][0], s[j][2], s[j][1], s[j][3]);
        const float* vr = V + (8 * j + 2 * qd) * LD + g;
        FragB b[KS];
#pragma unroll
        for (int n = 0; n < KS; ++n)
          tf32x3::set_b(b[n], vr[8 * n], vr[LD + 8 * n]);
        tf32x3::mma3(pv, a, b);
      }
    }
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = fmaf(acc[n][e], alpha[e / 2], pv[n][e]);
    __syncthreads();                      // every warp is done with K, V
  }

  const size_t row_o = static_cast<size_t>(Hq) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r ? t_hi : t_lo;
    if (t >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* out = o + (static_cast<size_t>(batch) * S + t) * row_o +
             static_cast<size_t>(h) * D + 2 * qd;
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      store(&out[8 * n], acc[n][2 * r] / den);
      store(&out[8 * n + 1], acc[n][2 * r + 1] / den);
    }
  }
}

constexpr size_t smem_bytes(int D) {
  return sizeof(float) * static_cast<size_t>(D <= 64 ? 4 : 5) * kTileK *
         (D + 4);
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int batch,
             int seqlen, int hq, int hkv, int causal, float scale,
             const Strides& st, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // cp.async needs 16-byte aligned rows of q (at D = 128), k and v.
  const int async = std::is_same<T, float>::value &&
                    tf32x3::aligned16(k, {st.k_b, st.k_s, st.k_h}) &&
                    tf32x3::aligned16(v, {st.v_b, st.v_s, st.v_h}) &&
                    (D <= 64 || tf32x3::aligned16(q, {st.q_b, st.q_s, st.q_h}));
  const dim3 grid(batch * hq, (seqlen + kTileQ - 1) / kTileQ);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seqlen, hq, hq / hkv,
      causal, scale, async, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int seqlen, int hq, int hkv, int head_dim, int causal, float scale,
           const long long* s, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || seqlen < 1 || hkv < 1 || hq % hkv ||
      (seqlen + kTileQ - 1) / kTileQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8]};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch_d<T, 16>(q, k, v, o, batch, seqlen, hq, hkv, causal, scale, st, cs);
    case 32:
      return launch_d<T, 32>(q, k, v, o, batch, seqlen, hq, hkv, causal, scale, st, cs);
    case 64:
      return launch_d<T, 64>(q, k, v, o, batch, seqlen, hq, hkv, causal, scale, st, cs);
    case 128:
      return launch_d<T, 128>(q, k, v, o, batch, seqlen, hq, hkv, causal, scale, st, cs);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, int batch, int seqlen, int hq,
                                   int hkv, int head_dim, int causal,
                                   float scale, const long long* strides,
                                   int device, void* stream) {
  return launch<float>(q, k, v, o, batch, seqlen, hq, hkv, head_dim, causal,
                       scale, strides, device, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, int batch, int seqlen, int hq,
                                    int hkv, int head_dim, int causal,
                                    float scale, const long long* strides,
                                    int device, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, batch, seqlen, hq, hkv, head_dim,
                               causal, scale, strides, device, stream);
}
