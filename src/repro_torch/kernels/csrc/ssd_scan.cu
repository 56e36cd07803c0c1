// Mamba2 SSD chunked scan (kernel B6): y and the final state, in float32.
//
// Replaces the Pallas kernel repro/kernels/ssd_scan.py (ssd_scan_kernel,
// reached through repro/kernels/ops.py::ssd_scan).  Per (batch, head), over
// chunks of length l with dt = softplus(dt_raw), a = -exp(a_log) and
// cum = cumsum(dt * a) inside the chunk:
//   y_t   = sum_{s<=t} (c_t . b_s) e^{cum_t - cum_s} dt_s x_s
//           + e^{cum_t} (c_t . state) + d_skip x_t
//   state = state e^{seg} + sum_s e^{seg - cum_s} dt_s b_s x_s^T
// where seg = cum at the chunk's end; the state starts at zero and the last
// one is returned.  The exponent is masked (t < s gives 0 without calling
// exp), not the product: for t < s it is positive and would overflow.
//
// What bounds it on an H100: operations.  At the serve shape of
// mamba2-130m (B = 4, S = 2048, 24 heads of P = 64, N = 128, chunk 128) the
// chunked form's four products, counting only the causal s <= t half of
// C.B^T and scores.X, are 2 (l(l+1)/2)(N + P) + 4 l N P = 7.36 MFLOP per
// (batch.head, chunk), 11.3 GFLOP a call; the per-token recurrence needs
// fewer, 5 N P per token (decay, outer-product update, C.state): 8.05
// GFLOP.  The bound takes the fewer: 0.120 ms at the 67 TFLOP/s of fp32
// outside the tensor cores, against 114 MB moved (0.034 ms at 3.35 TB/s).
//
// Design.  The TPU kernel carries the state in VMEM scratch across a
// sequential grid axis; CUDA blocks run in no order, so here one block per
// (batch, head) loops over the chunks itself and keeps the N x P f32 state
// (32 KB at N = 128, P = 64) in shared memory from chunk to chunk: the
// state never goes to device memory until the end, and there is one
// launch.  The price is parallelism: B.NH blocks (96 at the serve shape,
// on 132 SMs), so each block has 16 warps to hide shared-memory latency.
// A chunk's x (l x P) and b (l x N) stay in shared memory; c and the l x l
// score tile do not fit beside them at l = N = 128, so they go through in
// tiles of 64 rows (t), each tile computing only the causal part s <= t.
// All four products are register-tiled loops over shared memory on the
// CUDA cores in fp32 (no library GEMM, no tensor cores).  Shared-memory
// traffic, not the FMA rate, sets the pace, so the operands that a whole
// warp shares (a row of c, of the scores, of b) are read four at a time as
// one broadcast float4, and b's rows are padded to N + 4 floats so that the
// float4 reads of 32 different rows in C.B^T fall in distinct banks.
// Shared memory: (N.P + l.P + l.(N+4) + 64.N + 64.l + 3l) floats, 196 KB at
// the serve shape, so one block per SM after cudaFuncSetAttribute.
//
// The chunk's cumsum of dt * a is a sequential float sum, as torch.cumsum
// takes it on the card: at the model's decay rates cum reaches -1e3 within
// a chunk, where one ulp is 6e-5, and exp(cum_t - cum_s) inherits the
// rounding of both sums, so another order of summation alone moves y by
// more than 1e-4.
//
// Layout: x and y are (B, S, NH, P), dt is (B, S, NH), b and c (B, S, N),
// read in place through their strides (x, b and c arrive as column slices
// of the model's conv output, so no copy makes them contiguous; only their
// last dimension must be dense); y is contiguous.  b and c are indexed by
// batch and never broadcast per head.
// The ragged tail is masked, not padded: positions past S load as zero with
// dt = 0, which is the reference's padding with dt = -1e30 (softplus 0, an
// identity step), and are never written.  Limits: N <= 128 and P <= 64,
// chunk <= 128, N and chunk multiples of 4 (the wrapper checks them).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;   // 16 warps: ty = warp (rows), tx = lane (cols)
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;       // rows t of c and of the score tile at a time
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;
constexpr int kMaxL = 128;
constexpr int kStateRows = kMaxN / kWarps;   // state rows n a thread owns

// Element strides of the inputs, which may be views (the model passes x, b
// and c as column slices of one activation): x (batch, t, head), dt (batch,
// t, head), b and c (batch, t).  The last dimension of x, b and c is dense.
struct Strides {
  long long x_b, x_s, x_h, dt_b, dt_s, dt_h, b_b, b_s, c_b, c_s;
};

__device__ __forceinline__ float softplus(float v) {
  // torch.nn.functional.softplus (beta 1, threshold 20).
  return v > 20.0f ? v : log1pf(expf(v));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc += a . (b0, b1, b2, b3): four terms of a dot product, in order.
__device__ __forceinline__ float dot4(float4 a, float b0, float b1, float b2,
                                      float b3, float acc) {
  acc = fmaf(a.x, b0, acc);
  acc = fmaf(a.y, b1, acc);
  acc = fmaf(a.z, b2, acc);
  return fmaf(a.w, b3, acc);
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const float* __restrict__ bm,
                const float* __restrict__ cm,
                const float* __restrict__ d_skip, float* __restrict__ y,
                float* __restrict__ state_out, int S, int NH, int P, int N,
                int L, Strides st) {
  extern __shared__ float4 smem4[];         // float4: 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const int NB = N + 4;                     // padded row of b
  float* s_state = smem;                    // N x P
  float* s_x = s_state + N * P;             // L x P
  float* s_b = s_x + L * P;                 // L x (N + 4)
  float* s_c = s_b + L * NB;                // kTile x N
  float* s_sc = s_c + kTile * N;            // kTile x L scores
  float* s_cum = s_sc + kTile * L;          // L
  float* s_dt = s_cum + L;                  // L
  float* s_f = s_dt + L;                    // L: e^{seg - cum_s} dt_s

  const int tid = threadIdx.x;
  const int tx = tid % 32, ty = tid / 32;
  const int bh = blockIdx.x;
  const int batch = bh / NH, h = bh % NH;
  const float a = -expf(a_log[h]);
  const float dsk = d_skip[h];
  const size_t row_y = static_cast<size_t>(NH) * P;   // y stride over t
  const float* xh = x + batch * st.x_b + h * st.x_h;   // this (batch, head)
  const float* dth = dt + batch * st.dt_b + h * st.dt_h;
  const float* bb = bm + batch * st.b_b;
  const float* cb = cm + batch * st.c_b;
  const int n_own = ty * kStateRows;        // first state row of this warp

  for (int i = tid; i < N * P; i += kThreads) s_state[i] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += L) {
    const int lv = min(L, S - c0);          // valid rows of this chunk
    __syncthreads();                        // the last chunk is done with smem
    const size_t t_base = static_cast<size_t>(batch) * S + c0;
    for (int i = tid; i < L * P; i += kThreads) {
      const int s = i / P, p = i % P;
      s_x[i] = s < lv ? xh[(c0 + s) * st.x_s + p] : 0.0f;
    }
    for (int i = tid; i < L * NB; i += kThreads) {
      const int s = i / NB, n = i % NB;
      s_b[i] = (s < lv && n < N) ? bb[(c0 + s) * st.b_s + n] : 0.0f;
    }
    for (int s = tid; s < L; s += kThreads) {
      const float d = s < lv ? softplus(dth[(c0 + s) * st.dt_s]) : 0.0f;
      s_dt[s] = d;
      s_cum[s] = d * a;
    }
    __syncthreads();
    if (tid == 0) {                         // sequential cumsum of dt * a
      float run = 0.0f;
      for (int s = 0; s < L; ++s) {
        run += s_cum[s];
        s_cum[s] = run;
      }
    }
    __syncthreads();
    const float seg = s_cum[L - 1];
    for (int s = tid; s < L; s += kThreads)
      s_f[s] = expf(seg - s_cum[s]) * s_dt[s];

    for (int t0 = 0; t0 < lv; t0 += kTile) {
      const int rows = min(kTile, lv - t0);
      const int s_end = t0 + rows;          // causal: s <= t < s_end
      const int jn = (s_end + 31) / 32;     // 32-column groups of scores
      const int s4 = min((s_end + 3) & ~3, L);
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int r = i / N, n = i % N;
        s_c[i] = r < rows ? cb[(c0 + t0 + r) * st.c_s + n] : 0.0f;
      }
      __syncthreads();

      // (1) scores[t, s] = (c_t . b_s) e^{cum_t - cum_s} dt_s for s <= t,
      // zero above the diagonal up to the 32-column group's end.
      {
        float acc[4][4] = {};
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = ld4(&s_c[(ty + kWarps * i) * N + n]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = tx + 32 * j;
            bv[j] = (j < jn && s < L) ? ld4(&s_b[s * NB + n])
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = dot4(cv[i], bv[j].x, bv[j].y, bv[j].z, bv[j].w,
                               acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + kWarps * i, t = t0 + r;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = tx + 32 * j;
            if (r < rows && j < jn && s < L)
              s_sc[r * L + s] =
                  s <= t ? acc[i][j] * expf(s_cum[t] - s_cum[s]) * s_dt[s]
                         : 0.0f;
          }
        }
      }
      __syncthreads();

      // (2) scores . X, (3) e^{cum_t} (c_t . state), then the D skip.
      {
        float intra[4][2] = {}, inter[4][2] = {};
        for (int s = 0; s < s4; s += 4) {
          float4 sc[4];
          float xv[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[i] = ld4(&s_sc[(ty + kWarps * i) * L + s]);
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int p = tx + 32 * j;
              xv[k][j] = p < P ? s_x[(s + k) * P + p] : 0.0f;
            }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              intra[i][j] = dot4(sc[i], xv[0][j], xv[1][j], xv[2][j], xv[3][j],
                                 intra[i][j]);
        }
        for (int n = 0; n < N; n += 4) {
          float4 cv[4];
          float sv[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = ld4(&s_c[(ty + kWarps * i) * N + n]);
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int p = tx + 32 * j;
              sv[k][j] = p < P ? s_state[(n + k) * P + p] : 0.0f;
            }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              inter[i][j] = dot4(cv[i], sv[0][j], sv[1][j], sv[2][j], sv[3][j],
                                 inter[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + kWarps * i, t = t0 + r;
          if (r >= rows) continue;
          const float ecum = expf(s_cum[t]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int p = tx + 32 * j;
            if (p < P)
              y[(t_base + t) * row_y + static_cast<size_t>(h) * P + p] =
                  intra[i][j] + ecum * inter[i][j] + dsk * s_x[t * P + p];
          }
        }
      }
      __syncthreads();                      // before the next tile's c
    }

    // (4) state = state e^{seg} + sum_s b_s (f_s x_s)^T, for the rows
    // n_own .. n_own + 7 this warp owns.
    if (n_own < N) {
      const float eseg = expf(seg);
      float acc[kStateRows][2];
#pragma unroll
      for (int i = 0; i < kStateRows; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n_own + i, p = tx + 32 * j;
          acc[i][j] = (n < N && p < P) ? s_state[n * P + p] * eseg : 0.0f;
        }
      for (int s = 0; s < lv; ++s) {
        const float f = s_f[s];
        float xv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int p = tx + 32 * j;
          xv[j] = p < P ? f * s_x[s * P + p] : 0.0f;
        }
        const float4 b0 = ld4(&s_b[s * NB + n_own]);
        const float4 b1 = ld4(&s_b[s * NB + n_own + 4]);
        const float bv[kStateRows] = {b0.x, b0.y, b0.z, b0.w,
                                      b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kStateRows; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(bv[i], xv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kStateRows; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n_own + i, p = tx + 32 * j;
          if (n < N && p < P) s_state[n * P + p] = acc[i][j];
        }
    }
  }
  __syncthreads();
  float* out = state_out + static_cast<size_t>(bh) * N * P;
  for (int i = tid; i < N * P; i += kThreads) out[i] = s_state[i];
}

size_t smem_bytes(int N, int P, int L) {
  return sizeof(float) * (static_cast<size_t>(N) * P + L * P + L * (N + 4) +
                          kTile * N + kTile * L + 3 * L);
}

}  // namespace

extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* a_log,
                            const void* b, const void* c, const void* d_skip,
                            void* y, void* state, int batch, int seqlen,
                            int heads, int head_dim, int state_dim, int chunk,
                            const long long* strides, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (state_dim < 4 || state_dim > kMaxN || state_dim % 4 || head_dim < 1 ||
      head_dim > kMaxP || chunk < 4 || chunk > kMaxL || chunk % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(state_dim, head_dim, chunk);
  err = cudaFuncSetAttribute(ssd_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch > 0 && heads > 0) {
    ssd_scan_kernel<<<batch * heads, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(a_log), static_cast<const float*>(b),
        static_cast<const float*>(c), static_cast<const float*>(d_skip),
        static_cast<float*>(y), static_cast<float*>(state), seqlen, heads,
        head_dim, state_dim, chunk,
        Strides{strides[0], strides[1], strides[2], strides[3], strides[4],
                strides[5], strides[6], strides[7], strides[8], strides[9]});
  }
  return static_cast<int>(cudaGetLastError());
}
