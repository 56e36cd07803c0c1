// Mamba2 SSD chunked scan (kernel B6): y and the final state, in float32,
// in four launches, its products on the tensor cores in 3xTF32.
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
// mamba2-130m (B = 4, S = 2048, 24 heads of P = 64, N = 128, chunk 128)
// the chunked form, with C.B^T once per (batch, chunk) (b and c are one
// group shared by every head) and only the causal s <= t half of C.B^T and
// scores.X, is B nc l(l+1) N + B NH nc (l(l+1) P + 4 l N P) = 8.2 GFLOP:
// 0.050 ms at 495 / 3 = 165 TFLOP/s (TF32 dense, three passes), against
// 114 MB of inputs and outputs (0.034 ms at 3.35 TB/s).  The chunk states'
// round trip through the scratch (below) adds 200 MB, 0.06 ms.  On the CUDA cores in fp32 the
// per-token recurrence's 5 N P a token (8.05 GFLOP) would bound it at
// 0.120 ms.
//
// Design: the SSD decomposition of the Mamba2 paper (arXiv:2405.21060
// section 6), which ssd_scan_plain follows step for step, one launch a
// step, all on the caller's stream; the blocks of a step run in parallel
// over (batch, chunk, head), and only step 3 is sequential over chunks.
//   1. ssd_prep, per (batch, chunk), two kinds of block: dt and cum for
//      every head (one warp a head, the chunk's cumsum a sequential float
//      sum in index order, as torch.cumsum takes it on the card: at the
//      model's decay rates cum reaches -1e3 within a chunk, where one ulp
//      is 6e-5, so another order of summation alone moves y by more than
//      1e-4; every lane adds the terms in order, fetched by shuffle), and
//      C.B^T once for all heads, the 16-row groups up to their diagonal,
//      with the chunk's b in shared memory.
//   2. ssd_state, per (batch, chunk, head): the chunk's own state
//      sum_s b_s (e^{seg - cum_s} dt_s x_s)^T, N x P.
//   3. ssd_pass, per (batch, head), parallel over the N.P elements and
//      sequential over chunks: h_c = h_{c-1} e^{seg_c} + state_c; it
//      overwrites each chunk's state with the state that chunk sees
//      (h_{c-1}) and writes the final one.
//   4. ssd_out, per (batch, chunk, head): y = (C.B^T o decay o dt) X +
//      e^{cum_t} (C h_{c-1}) + D x.
// Every product is a 3xTF32 mma.sync.m16n8k8 (mma_tf32.cuh; wgmma would
// need both TF32 operands K-major in shared memory, and x, b^T and the
// state are not): one warp a 16-row group of the output.  The tensor
// core's sums truncate, so no product chains all three passes of every
// k-step on one accumulator: C.B^T adds each k-step's product on the CUDA
// cores, the others keep the two small passes apart (mma3_split).  Against
// a float64 reference y's error is then within 2x of the float32 plain
// version's (PERF.md).  Steps 2 and 4 are held to 128 registers, two
// blocks a SM: at one block a SM they take up to half again as long.  The operands
// every warp of a block shares (b in step 1, x in steps 2 and 4, the
// carried state in step 4) are copied into shared memory by cp.async, the
// carried state first, so that C.h runs while x arrives; the operands a
// warp alone reads (its rows of c, b and C.B^T) go from device memory (L2)
// straight into its fragments.
//
// Scratch (float32, the wrapper allocates it; ssd_scan_scratch_floats
// gives its size): dt (B, nc, NH, l), cum (B, nc, NH, l), C.B^T (B, nc,
// l, l), and the chunk states (B, nc, NH, N, P), 50 MB at the serve shape.
//
// Layout: x and y are (B, S, NH, P), dt is (B, S, NH), b and c (B, S, N),
// read in place through their strides (x, b and c arrive as column slices
// of the model's conv output, so no copy makes them contiguous; only their
// last dimension must be dense); y is contiguous.  x is copied by cp.async
// where its base and strides are multiples of 16 bytes, else by plain
// loads.  The ragged tail is masked, not padded: positions past S load as
// zero with dt = 0, which is the reference's padding with dt = -1e30
// (softplus 0, an identity step), and are never written.  Limits: N <= 128
// and P <= 64, chunk <= 128, N and chunk multiples of 4 (the wrapper
// checks them); the MMA tiles' edges past N, P or the chunk are masked.
#include <cuda_runtime.h>

#include <climits>

#include "mma_tf32.cuh"

namespace {

using tf32x3::FragA;
using tf32x3::FragB;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;
constexpr int kMaxL = 128;

// Element strides of the inputs, which may be views (the model passes x, b
// and c as column slices of one activation): x (batch, t, head), dt (batch,
// t, head), b and c (batch, t).  The last dimension of x, b and c is dense.
struct Strides {
  long long x_b, x_s, x_h, dt_b, dt_s, dt_h, b_b, b_s, c_b, c_s;
};

// Sizes of one call, and where the scratch's parts start.
struct Dims {
  int S, NH, P, N, L, nc;
  int P8, L8, N8;                 // P, l, N rounded up to the MMA's 8
  float* dt;                      // (B, nc, NH, L)
  float* cum;                     // (B, nc, NH, L)
  float* cb;                      // (B, nc, L, L)
  float* hs;                      // (B, nc, NH, N, P)
};

__host__ __device__ inline int up8(int v) { return (v + 7) / 8 * 8; }

__device__ __forceinline__ float softplus(float v) {
  // torch.nn.functional.softplus (beta 1, threshold 20).
  return v > 20.0f ? v : log1pf(expf(v));
}

__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long rs, int rows, int valid,
                                          int cols, bool async) {
  tf32x3::load_rows<kThreads>(dst, ld, src, rs, rows, valid, cols, async);
}

// Steps 2 and 4 take a path without bounds checks, whose loops have
// compile-time trip counts (so that they unroll and the next k-step's
// loads are issued ahead), for a full chunk at the kernel's maxima (N, P,
// l) = (kMaxN, kMaxP, kMaxL): all l rows before S, no MMA tile with an
// edge to mask.  Every other chunk (the ragged last one, smaller shapes)
// masks its edges.
enum Mode { kPartial = 0, kFull = 1 };

__device__ __forceinline__ int chunk_mode(const Dims& dm, int lv) {
  return lv == dm.L && dm.N == kMaxN && dm.P == kMaxP && dm.L == kMaxL
             ? kFull
             : kPartial;
}

// The padded sizes at mode M, compile-time at kFull.
template <int M>
__device__ __forceinline__ int n8(const Dims& dm) { return M == kFull ? kMaxN : dm.N8; }
template <int M>
__device__ __forceinline__ int p8(const Dims& dm) { return M == kFull ? kMaxP : dm.P8; }
template <int M>
__device__ __forceinline__ int l8(const Dims& dm) { return M == kFull ? kMaxL : dm.L8; }

// ---------------------------------------------------------------------------
// 1. Per (batch, chunk): dt and cum for every head (blockIdx.z = 0); C.B^T
//    once (blockIdx.z = 1).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void prep_cumsum(const float* dt_raw,
                                            const float* a_log, const Dims& dm,
                                            const Strides& st, int batch,
                                            int c) {
  constexpr int kPer = kMaxL / 32;        // positions a lane holds
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int L = dm.L, c0 = c * L, lv = min(L, dm.S - c0);
  const size_t bc = static_cast<size_t>(batch) * dm.nc + c;
  for (int h = warp; h < dm.NH; h += kWarps) {
    const float a = -expf(a_log[h]);
    const float* dth = dt_raw + batch * st.dt_b + h * st.dt_h;
    float* dt_out = dm.dt + (bc * dm.NH + h) * L;
    float* cum_out = dm.cum + (bc * dm.NH + h) * L;
    float da[kPer], cum[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int s = lane + 32 * i;
      const float d = s < lv ? softplus(dth[(c0 + s) * st.dt_s]) : 0.0f;
      if (s < L) dt_out[s] = d;
      da[i] = d * a;
    }
    // The sequential cumsum of dt * a, in index order: every lane adds the
    // same terms in the same order (lane l's term by shuffle), and lane l
    // keeps the running sum after its own.
    float run = 0.0f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      cum[i] = 0.0f;
      if (32 * i < L) {
#pragma unroll 8
        for (int l = 0; l < 32; ++l) {
          run += __shfl_sync(0xffffffffu, da[i], l);
          if (lane == l) cum[i] = run;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int s = lane + 32 * i;
      if (s < L) cum_out[s] = cum[i];
    }
  }
}

// C.B^T of one chunk: warp w takes rows t0 = 16 w .. t0 + 15 against the
// 8-column tiles up to its last row (the causal half and its diagonal
// tiles), in two halves of up to 8 tiles (the registers of one sum);
// b's chunk is in shared memory (s_b, L8 x (N8 + 4)).  Each k-step's
// product starts from zero and is added to the sum by the CUDA cores
// (tf32x3::fold): C.B^T is every head's, and a chain of 16 k-steps on the
// tensor core's truncating sums made it y's largest error.
__device__ __forceinline__ void prep_cb(const float* cc, long long c_s,
                                        const float* s_b, float* out,
                                        const Dims& dm, int lv) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q = lane % 4;
  const int L = dm.L, t0 = 16 * warp, ldb = dm.N8 + 4;
  if (t0 >= L) return;
  const int j_end = min((t0 + 15) / 8 + 1, dm.L8 / 8);
  const int ta = t0 + g, tb = ta + 8;
  const bool oka = ta < lv, okb = tb < lv;
  const float* ca = cc + (oka ? ta : 0) * c_s;
  const float* cb = cc + (okb ? tb : 0) * c_s;
  for (int half = 0; 8 * half < j_end; ++half) {
    const int jn = min(j_end - 8 * half, 8);
    float acc[8][4], part[8][4];
    tf32x3::zero(acc);
    for (int k = 0; k < dm.N8; k += 8) {
      // Columns N .. N8 - 1 are zero on both sides: s_b holds no data there.
      const int n0 = k + q, n1 = n0 + 4;
      const bool m0 = n0 < dm.N, m1 = n1 < dm.N;
      FragA fa;
      tf32x3::set_a(fa, oka && m0 ? ca[n0] : 0.0f, okb && m0 ? cb[n0] : 0.0f,
                    oka && m1 ? ca[n1] : 0.0f, okb && m1 ? cb[n1] : 0.0f);
      FragB fb[8];
      const float* br = s_b + (64 * half + g) * ldb + n0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < jn)
          tf32x3::set_b(fb[j], m0 ? br[8 * j * ldb] : 0.0f,
                        m1 ? br[8 * j * ldb + 4] : 0.0f);
      tf32x3::zero(part);
      tf32x3::mma3(part, fa, fb, jn);
      tf32x3::fold(acc, part);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= jn) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + g + 8 * (e / 2);
        const int s = 64 * half + 8 * j + 2 * q + e % 2;
        if (t < L && s < L) out[t * L + s] = acc[j][e];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_prep(const float* __restrict__ dt_raw, const float* __restrict__ a_log,
         const float* __restrict__ bm, const float* __restrict__ cm, Dims dm,
         Strides st, int b_async) {
  const int c = blockIdx.x, batch = blockIdx.y;
  if (blockIdx.z == 0) {
    prep_cumsum(dt_raw, a_log, dm, st, batch, c);
    return;
  }
  extern __shared__ float4 smem4[];
  float* s_b = reinterpret_cast<float*>(smem4);   // L8 x (N8 + 4)
  const int c0 = c * dm.L, lv = min(dm.L, dm.S - c0);
  load_rows(s_b, dm.N8 + 4, bm + batch * st.b_b + c0 * st.b_s, st.b_s,
            dm.L8, lv, dm.N, b_async != 0);
  tf32x3::cp_async_commit();
  tf32x3::cp_async_wait<0>();
  __syncthreads();
  prep_cb(cm + batch * st.c_b + c0 * st.c_s, st.c_s, s_b,
          dm.cb + (static_cast<size_t>(batch) * dm.nc + c) * dm.L * dm.L, dm,
          lv);
}

// ---------------------------------------------------------------------------
// 2. Per (batch, chunk, head): the chunk's state sum_s b_s (w_s x_s)^T,
//    w_s = e^{seg - cum_s} dt_s.  Warp w takes state rows n0 = 16 w ..
//    n0 + 15; A(n, s) = b[s][n] from device memory, B(s, p) = w_s x[s][p]
//    from shared memory.
// ---------------------------------------------------------------------------
template <int M>
__device__ __forceinline__ void state_rows(const float* bb, long long b_s,
                                           const float* s_x, const float* s_w,
                                           int ldx, float* out, const Dims& dm,
                                           int lv) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q = lane % 4;
  constexpr bool kEdgeless = M == kFull;         // no edges to mask
  constexpr int kUnroll = kEdgeless ? 4 : 1;         // k-steps unrolled
  const int n0 = 16 * warp;
  if (n0 >= dm.N) return;
  const int na = n0 + g, nb = na + 8;
  const bool oka = kEdgeless || na < dm.N, okb = kEdgeless || nb < dm.N;
  const int p_tiles = p8<M>(dm) / 8;
  float acc[kMaxP / 8][4], small[kMaxP / 8][4];
  tf32x3::zero(acc);
  tf32x3::zero(small);
#pragma unroll kUnroll
  for (int k = 0; k < l8<M>(dm); k += 8) {
    const int s0 = k + q, s1 = s0 + 4;
    const bool r0 = kEdgeless || s0 < lv, r1 = kEdgeless || s1 < lv;
    const float* b0 = bb + (r0 ? s0 : 0) * b_s;
    const float* b1 = bb + (r1 ? s1 : 0) * b_s;
    FragA fa;
    tf32x3::set_a(fa, r0 && oka ? b0[na] : 0.0f, r0 && okb ? b0[nb] : 0.0f,
                  r1 && oka ? b1[na] : 0.0f, r1 && okb ? b1[nb] : 0.0f);
    const float w0 = s_w[s0], w1 = s_w[s1];
    const float* x0 = s_x + s0 * ldx + g;
    FragB fb[kMaxP / 8];
#pragma unroll
    for (int j = 0; j < kMaxP / 8; ++j) {
      const bool okp = kEdgeless || 8 * j + g < dm.P;
      if (j < p_tiles)
        tf32x3::set_b(fb[j], okp ? w0 * x0[8 * j] : 0.0f,
                      okp ? w1 * x0[4 * ldx + 8 * j] : 0.0f);
    }
    tf32x3::mma3_split(acc, small, fa, fb, p_tiles);
  }
  tf32x3::fold(acc, small);
#pragma unroll
  for (int j = 0; j < kMaxP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + g + 8 * (e / 2), p = 8 * j + 2 * q + e % 2;
      if (kEdgeless || (n < dm.N && p < dm.P)) out[n * dm.P + p] = acc[j][e];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_state(const float* __restrict__ x, const float* __restrict__ bm, Dims dm,
          Strides st, int x_async) {
  extern __shared__ float4 smem4[];
  float* s_x = reinterpret_cast<float*>(smem4);   // L8 x (P8 + 8)
  const int ldx = dm.P8 + 8;
  float* s_w = s_x + dm.L8 * ldx;                 // L8
  const int h = blockIdx.x, c = blockIdx.y, batch = blockIdx.z;
  const int L = dm.L, c0 = c * L, lv = min(L, dm.S - c0);
  const size_t bch = (static_cast<size_t>(batch) * dm.nc + c) * dm.NH + h;

  load_rows(s_x, ldx, x + batch * st.x_b + c0 * st.x_s + h * st.x_h,
            st.x_s, dm.L8, lv, dm.P, x_async != 0);
  tf32x3::cp_async_commit();
  {
    const float* cum = dm.cum + bch * L;
    const float* dt = dm.dt + bch * L;
    const float seg = cum[L - 1];
    for (int s = threadIdx.x; s < dm.L8; s += kThreads)
      s_w[s] = s < L ? expf(seg - cum[s]) * dt[s] : 0.0f;
  }
  tf32x3::cp_async_wait<0>();
  __syncthreads();

  const float* bb = bm + batch * st.b_b + c0 * st.b_s;
  float* out = dm.hs + bch * dm.N * dm.P;
  if (chunk_mode(dm, lv) == kFull)
    state_rows<kFull>(bb, st.b_s, s_x, s_w, ldx, out, dm, lv);
  else
    state_rows<kPartial>(bb, st.b_s, s_x, s_w, ldx, out, dm, lv);
}

// ---------------------------------------------------------------------------
// 3. Per (batch, head), over chunks in order: h_c = h_{c-1} e^{seg_c} +
//    state_c; each chunk's state is overwritten by h_{c-1}.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ssd_pass(float* __restrict__ state_out, Dims dm) {
  const int np = dm.N * dm.P;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, batch = blockIdx.z;
  if (e >= np) return;
  const size_t stride = static_cast<size_t>(dm.NH) * np;   // one chunk on
  float* p = dm.hs + (static_cast<size_t>(batch) * dm.nc * dm.NH + h) * np + e;
  const float* seg = dm.cum + (static_cast<size_t>(batch) * dm.nc * dm.NH + h) * dm.L +
                     dm.L - 1;
  // kBatch chunks' loads are issued before their stores, which the
  // compiler cannot reorder by itself (p and seg may alias for all it knows).
  constexpr int kBatch = 8;
  float run = 0.0f;
  for (int c0 = 0; c0 < dm.nc; c0 += kBatch) {
    float st[kBatch], sg[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const bool ok = c0 + i < dm.nc;
      st[i] = ok ? p[(c0 + i) * stride] : 0.0f;
      sg[i] = ok ? seg[(c0 + i) * static_cast<size_t>(dm.NH) * dm.L] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (c0 + i < dm.nc) {
        p[(c0 + i) * stride] = run;
        run = run * expf(sg[i]) + st[i];
      }
    }
  }
  state_out[(static_cast<size_t>(batch) * dm.NH + h) * np + e] = run;
}

// ---------------------------------------------------------------------------
// 4. Per (batch, chunk, head): y = (C.B^T o decay o dt) X
//    + e^{cum_t} (C h_{c-1}) + D x.  Warp w takes rows t0 = 16 w ..
//    t0 + 15; A from device memory (c, C.B^T), B from shared memory (h, x).
// ---------------------------------------------------------------------------
struct OutTiles {
  const float* s_h;     // N8 x ld: h_{c-1}
  const float* s_x;     // L8 x ld
  const float* s_cum;   // L8
  const float* s_dt;    // L8
  int ld;
};

// C h_{c-1} for this warp's rows, each row then scaled by e^{cum_t}.
template <int M>
__device__ __forceinline__ void out_inter(float (&acc)[kMaxP / 8][4],
                                          const float* cc, long long c_s,
                                          const OutTiles& tl, const Dims& dm,
                                          int lv) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q = lane % 4;
  constexpr bool kEdgeless = M == kFull;         // no edges to mask
  constexpr int kUnroll = kEdgeless ? 4 : 1;         // k-steps unrolled
  const int ta = 16 * warp + g, tb = ta + 8;
  const bool oka = kEdgeless || ta < lv, okb = kEdgeless || tb < lv;
  const float* ca = cc + (oka ? ta : 0) * c_s;
  const float* cb = cc + (okb ? tb : 0) * c_s;
  const int p_tiles = p8<M>(dm) / 8;
  float small[kMaxP / 8][4];
  tf32x3::zero(small);
#pragma unroll kUnroll
  for (int k = 0; k < n8<M>(dm); k += 8) {
    const int n0 = k + q, n1 = n0 + 4;
    const bool m0 = kEdgeless || n0 < dm.N, m1 = kEdgeless || n1 < dm.N;
    FragA fa;
    tf32x3::set_a(fa, oka && m0 ? ca[n0] : 0.0f, okb && m0 ? cb[n0] : 0.0f,
                  oka && m1 ? ca[n1] : 0.0f, okb && m1 ? cb[n1] : 0.0f);
    const float* h0 = tl.s_h + n0 * tl.ld + g;
    FragB fb[kMaxP / 8];
#pragma unroll
    for (int j = 0; j < kMaxP / 8; ++j) {
      const bool okp = kEdgeless || 8 * j + g < dm.P;
      if (j < p_tiles)
        tf32x3::set_b(fb[j], okp ? h0[8 * j] : 0.0f,
                      okp ? h0[4 * tl.ld + 8 * j] : 0.0f);
    }
    tf32x3::mma3_split(acc, small, fa, fb, p_tiles);
  }
  tf32x3::fold(acc, small);
  const float ea = expf(tl.s_cum[min(ta, dm.L8 - 1)]);
  const float eb = expf(tl.s_cum[min(tb, dm.L8 - 1)]);
#pragma unroll
  for (int j = 0; j < kMaxP / 8; ++j) {
    acc[j][0] *= ea;
    acc[j][1] *= ea;
    acc[j][2] *= eb;
    acc[j][3] *= eb;
  }
}

// (C.B^T o decay o dt) X over s <= t: the 8-column tiles up to the last row
// of this warp, as step 1 wrote them; then the D skip and the store.
template <int M>
__device__ __forceinline__ void out_intra(float (&acc)[kMaxP / 8][4],
                                          const float* cbm, float* yc,
                                          size_t row_y, float dsk,
                                          const OutTiles& tl, const Dims& dm,
                                          int lv) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q = lane % 4;
  constexpr bool kEdgeless = M == kFull;         // no edges to mask
  constexpr int kUnroll = kEdgeless ? 4 : 1;         // k-steps unrolled
  const int L = dm.L, t0 = 16 * warp, ta = t0 + g, tb = ta + 8;
  const bool oka = kEdgeless || ta < L, okb = kEdgeless || tb < L;
  const float* cba = cbm + (oka ? ta : 0) * L;
  const float* cbb = cbm + (okb ? tb : 0) * L;
  const float cum_a = tl.s_cum[min(ta, dm.L8 - 1)];
  const float cum_b = tl.s_cum[min(tb, dm.L8 - 1)];
  // score(t, s) = C.B^T[t, s] e^{cum_t - cum_s} dt_s for s <= t, else 0:
  // the exponent is never taken above the diagonal.
  auto score = [&](bool ok, const float* row, float cum_t, int t, int s) {
    return ok && s <= t ? row[s] * expf(cum_t - tl.s_cum[s]) * tl.s_dt[s]
                        : 0.0f;
  };
  const int p_tiles = p8<M>(dm) / 8;
  const int k_end = min(t0 + 16, l8<M>(dm));
  float small[kMaxP / 8][4];
  tf32x3::zero(small);
#pragma unroll kUnroll
  for (int k = 0; k < k_end; k += 8) {
    const int s0 = k + q, s1 = s0 + 4;
    FragA fa;
    tf32x3::set_a(fa, score(oka, cba, cum_a, ta, s0),
                  score(okb, cbb, cum_b, tb, s0),
                  score(oka, cba, cum_a, ta, s1),
                  score(okb, cbb, cum_b, tb, s1));
    const float* x0 = tl.s_x + s0 * tl.ld + g;
    FragB fb[kMaxP / 8];
#pragma unroll
    for (int j = 0; j < kMaxP / 8; ++j) {
      const bool okp = kEdgeless || 8 * j + g < dm.P;
      if (j < p_tiles)
        tf32x3::set_b(fb[j], okp ? x0[8 * j] : 0.0f,
                      okp ? x0[4 * tl.ld + 8 * j] : 0.0f);
    }
    tf32x3::mma3_split(acc, small, fa, fb, p_tiles);
  }
  tf32x3::fold(acc, small);
#pragma unroll
  for (int j = 0; j < kMaxP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + g + 8 * (e / 2), p = 8 * j + 2 * q + e % 2;
      if (kEdgeless || (t < lv && p < dm.P))
        yc[t * row_y + p] = acc[j][e] + dsk * tl.s_x[t * tl.ld + p];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_out(const float* __restrict__ x, const float* __restrict__ cm,
        const float* __restrict__ d_skip, float* __restrict__ y, Dims dm,
        Strides st, int x_async, int h_async) {
  extern __shared__ float4 smem4[];
  const int ld = dm.P8 + 8;
  float* s_h = reinterpret_cast<float*>(smem4);   // N8 x ld: h_{c-1}
  float* s_x = s_h + dm.N8 * ld;                  // L8 x ld
  float* s_cum = s_x + dm.L8 * ld;                // L8
  float* s_dt = s_cum + dm.L8;                    // L8
  const int h = blockIdx.x, c = blockIdx.y, batch = blockIdx.z;
  const int L = dm.L, c0 = c * L, lv = min(L, dm.S - c0);
  const size_t bc = static_cast<size_t>(batch) * dm.nc + c;
  const size_t bch = bc * dm.NH + h;

  load_rows(s_h, ld, dm.hs + bch * dm.N * dm.P, dm.P, dm.N8, dm.N, dm.P,
            h_async != 0);
  tf32x3::cp_async_commit();
  load_rows(s_x, ld, x + batch * st.x_b + c0 * st.x_s + h * st.x_h, st.x_s,
            dm.L8, lv, dm.P, x_async != 0);
  tf32x3::cp_async_commit();
  for (int s = threadIdx.x; s < dm.L8; s += kThreads) {
    s_cum[s] = s < L ? dm.cum[bch * L + s] : 0.0f;
    s_dt[s] = s < L ? dm.dt[bch * L + s] : 0.0f;
  }
  tf32x3::cp_async_wait<1>();                     // h_{c-1} has arrived
  __syncthreads();

  const OutTiles tl{s_h, s_x, s_cum, s_dt, ld};
  const bool active = 16 * (threadIdx.x / 32) < L;
  const int mode = chunk_mode(dm, lv);
  const float* cc = cm + batch * st.c_b + c0 * st.c_s;
  float acc[kMaxP / 8][4];
  tf32x3::zero(acc);
  if (active) {
    if (mode == kFull)
      out_inter<kFull>(acc, cc, st.c_s, tl, dm, lv);
    else
      out_inter<kPartial>(acc, cc, st.c_s, tl, dm, lv);
  }
  tf32x3::cp_async_wait<0>();                     // x has arrived
  __syncthreads();
  if (!active) return;
  const size_t row_y = static_cast<size_t>(dm.NH) * dm.P;
  float* yc = y + (static_cast<size_t>(batch) * dm.S + c0) * row_y +
              static_cast<size_t>(h) * dm.P;
  const float* cbm = dm.cb + bc * L * L;
  if (mode == kFull)
    out_intra<kFull>(acc, cbm, yc, row_y, d_skip[h], tl, dm, lv);
  else
    out_intra<kPartial>(acc, cbm, yc, row_y, d_skip[h], tl, dm, lv);
}

// The scratch's size in floats and its parts; false if it overflows int.
bool layout(int batch, int seqlen, int heads, int head_dim, int state_dim,
            int chunk, float* base, Dims* dm, long long* floats) {
  const int nc = (seqlen + chunk - 1) / chunk;
  const long long per_bc = static_cast<long long>(batch) * nc;
  const long long n_dt = per_bc * heads * chunk;
  const long long n_cb = per_bc * chunk * chunk;
  const long long n_hs = per_bc * heads * state_dim * head_dim;
  *floats = 2 * n_dt + n_cb + n_hs;
  if (*floats > INT_MAX) return false;
  auto at = [base](long long off) { return base ? base + off : nullptr; };
  *dm = Dims{seqlen, heads, head_dim, state_dim, chunk, nc,
             up8(head_dim), up8(chunk), up8(state_dim),
             at(0), at(n_dt), at(2 * n_dt), at(2 * n_dt + n_cb)};
  return true;
}

}  // namespace

// The scratch ssd_scan_f32 takes, in floats (-1: too large).
extern "C" int ssd_scan_scratch_floats(int batch, int seqlen, int heads,
                                       int head_dim, int state_dim,
                                       int chunk) {
  Dims dm;
  long long floats;
  if (chunk < 1 || !layout(batch, seqlen, heads, head_dim, state_dim, chunk,
                           nullptr, &dm, &floats))
    return -1;
  return static_cast<int>(floats);
}

extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* a_log,
                            const void* b, const void* c, const void* d_skip,
                            void* y, void* state, void* scratch, int batch,
                            int seqlen, int heads, int head_dim, int state_dim,
                            int chunk, const long long* strides, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (state_dim < 4 || state_dim > kMaxN || state_dim % 4 || head_dim < 1 ||
      head_dim > kMaxP || chunk < 4 || chunk > kMaxL || chunk % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  Dims dm;
  long long floats;
  if (!layout(batch, seqlen, heads, head_dim, state_dim, chunk,
              static_cast<float*>(scratch), &dm, &floats))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch < 1 || heads < 1 || seqlen < 1)
    return static_cast<int>(cudaGetLastError());
  if (batch > 65535 || dm.nc > 65535)             // grid's y and z limits
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9]};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int x_async =
      head_dim % 4 == 0 && tf32x3::aligned16(x, {st.x_b, st.x_s, st.x_h});
  const int h_async = head_dim % 4 == 0 && tf32x3::aligned16(dm.hs, {});
  const int b_async = state_dim % 4 == 0 && tf32x3::aligned16(b, {st.b_b, st.b_s});
  const int ld = dm.P8 + 8;
  const size_t smem_prep = sizeof(float) * dm.L8 * (dm.N8 + 4);
  const size_t smem_state = sizeof(float) * (dm.L8 * ld + dm.L8);
  const size_t smem_out =
      sizeof(float) * ((dm.N8 + dm.L8) * ld + 2 * dm.L8);
  err = cudaFuncSetAttribute(ssd_out,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_out));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_prep,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_prep));
  if (err != cudaSuccess) return static_cast<int>(err);

  ssd_prep<<<dim3(dm.nc, batch, 2), kThreads, smem_prep, cs>>>(
      static_cast<const float*>(dt), static_cast<const float*>(a_log),
      static_cast<const float*>(b), static_cast<const float*>(c), dm, st,
      b_async);
  ssd_state<<<dim3(heads, dm.nc, batch), kThreads, smem_state, cs>>>(
      static_cast<const float*>(x), static_cast<const float*>(b), dm, st,
      x_async);
  ssd_pass<<<dim3((state_dim * head_dim + kThreads - 1) / kThreads, heads,
                  batch), kThreads, 0, cs>>>(static_cast<float*>(state), dm);
  ssd_out<<<dim3(heads, dm.nc, batch), kThreads, smem_out, cs>>>(
      static_cast<const float*>(x), static_cast<const float*>(c),
      static_cast<const float*>(d_skip), static_cast<float*>(y), dm, st,
      x_async, h_async);
  return static_cast<int>(cudaGetLastError());
}
