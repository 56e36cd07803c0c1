// Forward attention with an online softmax (kernel B7), float32 or bfloat16
// inputs, float32 arithmetic.
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
// 4 B Hq D S(S+1)/2 = 19.3 GFLOP: 0.289 ms at the 67 TFLOP/s of fp32
// outside the tensor cores, against 50.3 MB of q, k, v and o (0.015 ms at
// 3.35 TB/s).
//
// Design, simple first.  One block of 8 warps per (query tile of 64 rows,
// batch.head); the block loops over the key tiles with K and V in shared
// memory and keeps the output accumulator, m and l in registers: each warp
// owns 8 query rows; for the scores each lane owns 2 key columns, for the
// output each lane owns the columns d = lane + 32 j.  The scores' row max
// and row sum go through warp shuffles; the probabilities go through a
// shared 64 x 64 tile (each warp reads back only its own rows) into the
// product with V.  All products are fp32 FMAs on the CUDA cores (no TF32, no
// tensor cores): shared-memory traffic and instruction issue set the pace,
// so the operands a whole warp shares (a row of q, of the probabilities)
// are read as one broadcast float4, and K's rows are padded to D + 4
// floats so that the float4 reads of 32 different key rows fall in
// distinct banks.  A causal block stops at its diagonal tile (the TPU
// kernel also runs the tiles above it, which add exp(-1e30 - m) = 0: key 0
// lies in the first tile, so m is finite from the first step).  Query
// tiles are started longest first (blockIdx.y reversed) so that the causal
// tail is short.  Shared memory: (64 D + 64 (D + 4) + 64 D + 64 . 64)
// floats, 65 KB at D = 64 and 113 KB at D = 128 (above the 48 KB default,
// so cudaFuncSetAttribute).
//
// Layout: q, k, v are (B, S, H, D), read in place through their strides
// (only the last dimension must be dense; the JAX wrapper's transposes to
// (B.H, S, D) and back are copies the port does not make); o is a
// contiguous (B, S, Hq, D) in q's type.  bfloat16 converts to float32 on
// load and back (round to nearest even) on the store.  A ragged S is
// masked, not padded: rows and keys past S load as zeros, keys past S score
// -1e30 and query rows past S are never written.  D is 16, 32, 64 or 128
// (a template parameter; the wrapper checks it).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;             // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileQ = 64;                // query rows of a block
constexpr int kTileK = 64;                // keys of a tile
constexpr int kRows = kTileQ / kWarps;    // query rows of a warp
constexpr int kCols = kTileK / 32;        // key columns of a lane
constexpr float kNegInf = -1e30f;         // the reference's mask value

// Element strides over (batch, position, head); the last dimension is dense.
struct Strides {
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows r0 .. r0 + 63 of one head into a shared tile of row stride ld
// floats, as float32; rows past S as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int r0,
                                          int S) {
  for (int i = threadIdx.x; i < kTileK * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * ld + d] = r0 + r < S ? to_float(src[(r0 + r) * row_stride + d])
                                 : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int Hq, int group, int causal, float scale,
                       Strides st) {
  constexpr int KD = D + 4;               // padded row of K
  constexpr int DJ = (D + 31) / 32;       // output columns of a lane
  extern __shared__ float4 smem4[];       // float4: 16-byte aligned
  float* sQ = reinterpret_cast<float*>(smem4);   // kTileQ x D
  float* sK = sQ + kTileQ * D;                   // kTileK x (D + 4)
  float* sV = sK + kTileK * KD;                  // kTileK x D
  float* sP = sV + kTileK * D;                   // kTileQ x kTileK

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int qt = gridDim.y - 1 - blockIdx.y;     // longest rows first
  const int q0 = qt * kTileQ;
  const int bh = blockIdx.x, batch = bh / Hq, h = bh % Hq, hk = h / group;
  const T* qh = q + batch * st.q_b + h * st.q_h;
  const T* kh = k + batch * st.k_b + hk * st.k_h;
  const T* vh = v + batch * st.v_b + hk * st.v_h;
  const int row0 = warp * kRows;          // this warp's first row in the tile

  load_tile<T, D>(sQ, D, qh, st.q_s, q0, S);

  float m[kRows], l[kRows], acc[kRows][DJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  const int n_kt = causal ? qt + 1 : (S + kTileK - 1) / kTileK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTileK;
    __syncthreads();                      // every warp is done with K, V
    load_tile<T, D>(sK, KD, kh, st.k_s, k0, S);
    load_tile<T, D>(sV, D, vh, st.v_s, k0, S);
    __syncthreads();

    // Scores: row row0 + i against key k0 + lane + 32 j.
    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ld4(&sK[(lane + 32 * j) * KD + d]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv = ld4(&sQ[(row0 + i) * D + d]);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float a = sc[i][j];
          a = fmaf(qv.x, kv[j].x, a);
          a = fmaf(qv.y, kv[j].y, a);
          a = fmaf(qv.z, kv[j].z, a);
          sc[i][j] = fmaf(qv.w, kv[j].w, a);
        }
      }
    }

    // Online softmax, one row at a time across the warp.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int t = q0 + row0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int u = k0 + lane + 32 * j;
        const float s = (u >= S || (causal && u > t)) ? kNegInf
                                                      : sc[i][j] * scale;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
      const float m_new = fmaxf(m[i], warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sP[(row0 + i) * kTileK + lane + 32 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();                         // this warp's rows of sP are written

    // acc += P V over the tile's keys (zero rows of V past S, p = 0 there).
#pragma unroll 2
    for (int u = 0; u < kTileK; u += 4) {
      float vv[4][DJ];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int d = lane + 32 * j;
          vv[c][j] = d < D ? sV[(u + c) * D + d] : 0.0f;
        }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 p = ld4(&sP[(row0 + i) * kTileK + u]);
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          float a = acc[i][j];
          a = fmaf(p.x, vv[0][j], a);
          a = fmaf(p.y, vv[1][j], a);
          a = fmaf(p.z, vv[2][j], a);
          acc[i][j] = fmaf(p.w, vv[3][j], a);
        }
      }
    }
  }

  const size_t row_o = static_cast<size_t>(Hq) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = q0 + row0 + i;
    if (t >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* out = o + (static_cast<size_t>(batch) * S + t) * row_o +
             static_cast<size_t>(h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = lane + 32 * j;
      if (d < D) store(&out[d], acc[i][j] / den);
    }
  }
}

constexpr size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(kTileQ) * D + kTileK * (D + 4) +
                          kTileK * D + kTileQ * kTileK);
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
  const dim3 grid(batch * hq, (seqlen + kTileQ - 1) / kTileQ);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seqlen, hq, hq / hkv,
      causal, scale, st);
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
