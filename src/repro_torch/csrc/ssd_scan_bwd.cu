// Gradient of the Mamba-2 SSD scan for Hopper (sm_90a): kernel 6b.
//
// No TPU kernel computes it.  The JAX package trains mamba2 with XLA's
// autodiff of the model's prefill twin _ssd_chunked_jnp
// (src/repro/models/blocks.py:250); this replaces that autodiff, and
// ssd_scan.cu (kernel 6) computes the forward.  Per (batch b, head h), over
// chunks of Q steps with cdt = cumsum(dt) within a chunk, the forward is
//
//     y_t = sum_{i<=t} G[t,i] M[t,i] dt_i x_i + e_t C_t . S_c,
//     S_c+1 = decay_c S_c + sum_i w_i B_i (x) x_i,
//
// G = C B^T, M[t,i] = exp(A (cdt_t - cdt_i)), e_t = exp(A cdt_t),
// w_i = exp(A (cdt_last - cdt_i)) dt_i, decay_c = exp(A cdt_last), S_0 = 0.
// With dy the output's gradient and Gbar_c+1 that of S_c+1 (Gbar_nc = dS_fin,
// the final state's, zero if none):
//
//     Gbar_c = decay_c Gbar_c+1 + sum_t e_t C_t (x) dy_t          (reverse pass)
//     dx = W^T dy + w o (B Gbar_c+1),   W = G o M o dt (causal)
//     dC = dG B + e o (dy S_c^T),       dB = dG^T C + w o (x Gbar_c+1^T)
//     dG = (dy x^T) o M o dt (causal),
//
// summed over the heads for dB and dC (B and C have no head axis).  Every
// exponent a (...) passes its gradient to cdt (a reverse cumsum within the
// chunk gives ddt) and to A (summed over batch and chunks): the segment sums
// through (dy x^T) o G o M, the carry through de_t = C_t . (dy S_c^T)_t, the
// chunk state through dw_i = x_i . (B Gbar)_i, the decay through
// <Gbar_c+1, S_c>.  As in the forward, the mask comes before the exp, whose
// argument is positive past the diagonal (inf * 0 would give NaN).
//
// Design: three launches, Q = 64, the forward's chunk (its state buffer
// holds each chunk's S_c, [B, H, nc, N, P], and is read back here).
//   1. ssd_bwd_states, grid (N / 64, head, batch): the reverse state passing,
//      kernel 6's ssd_states mirrored.  One block per 64 state rows of a
//      (batch, head) walks the chunks from the last with Gbar in its MMA
//      accumulators, writes each chunk's Gbar_c+1 and adds
//      (C o e)^T dy [N x Q] . [Q x P]; the next chunk's C, dy and dt are
//      copied in (cp.async, double-buffered) while this one is computed.
//   2. ssd_bwd_chunk, grid (chunk, batch): every head of one chunk in turn,
//      so that G = C B^T is computed once and dB and dC are summed over the
//      heads in registers, in head order, with no atomics and no per-head
//      scratch.  For each head seven products: dy x^T, dy S_c^T, B Gbar,
//      x Gbar^T, W^T dy, dG B and dG^T C ([64 x 64], [64 x N] or [64 x P],
//      K = P, N or 64; the triangular ones over the causal half of K), then
//      the per-step scalars (row and column sums of the segment terms, a
//      reverse cumsum) by the first two warps; dx and ddt are written per
//      head, dA's part per (batch, head, chunk).
//   3. ssd_bwd_dA, grid (head): dA, the parts summed in a fixed order.
// Every sum runs in a fixed order: two runs give the same bits.  Products
// run on mma.sync m16n8k8 TF32 as 3xTF32 (ssd_common.cuh), which the
// forward's note shows the card needs for its 1e-4 tolerance at K = 128.
// Steps past the sequence's end load as zeros with dt = 0 and their
// gradients are not written; their dy is zero, so they add nothing to dA.
// x, dt, B, C and dy are read through element strides (last dim contiguous);
// dx through its own strides, ddt [B, H, S], dB and dC [B, S, N] contiguous.
//
// Bound.  The function reads x, dt, B, C and dy and writes dx, ddt, dA, dB
// and dC; counting the forward's saved chunk states as read once too, at
// mamba2-130m's training microbatch (B 16, H 24, S 2048, P 64, N 128) that
// is 1.08 GB, 0.32 ms at 3.35 TB/s.  The least operations of the chunked
// form are 8 N P a step and head (the state gradient's update, dx, dB and
// dC, each 2 N P; dC's carry term reads the saved S_c, so no state is
// rebuilt a step) and 2 N P a chunk and head (the decay's dot
// <Gbar_c+1, S_c>): 51.7 GFLOP, 0.31 ms at 3xTF32's third of dense TF32's
// 494.7 TFLOP/s, so bytes bound it, operations close behind.  This design
// does the chunked form's products inside each chunk too (77 GFLOP of
// products and 13 of state passing) and writes and reads the state
// gradients once more (0.8 GB).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

constexpr int kReduceThreads = 256;

template <int Q, int N, int P>
struct BwdDims {
  static constexpr int kRB = N < 64 ? N : 64;  // state rows a states block owns
  static constexpr int kBS = kRB + 8;  // C's columns of the block [Q][kRB], as A = C^T
  static constexpr int kCS = N + 4;    // B, C [Q][N]
  static constexpr int kXS = P + 8;    // x, dy [Q][P]; S, Gbar [N][P]
  static constexpr int kWS = Q + 4;    // G, DM [Q][Q]
  static constexpr int kStateThreads = 32 * (kRB / 16);
  static constexpr int kStage = Q * kBS + Q * kXS + Q;  // C columns, dy, dt of a chunk
  static constexpr int kStateSmem = 2 * kStage + 2 * Q + 32;
  static constexpr int kChunkThreads = 32 * (Q / 16) * 2;
  static constexpr int kScal = 10 * Q + 32;  // per-step scalars and reductions
  static constexpr int kChunkSmem =
      2 * Q * kWS + 2 * Q * kCS + 2 * Q * kXS + 2 * N * kXS + kScal;
};

// Load a warp's 16 x 8 NT accumulator tile from src (row stride rs, first
// column c0): the mirror of store_acc.
template <int NT>
__device__ __forceinline__ void load_acc(float (&acc)[NT][4], const float* src, int64_t rs,
                                         int r0, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* row = src + (r0 + g + 8 * h) * rs + c0 + 2 * q;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(row + 8 * j);
      acc[j][2 * h] = v.x;
      acc[j][2 * h + 1] = v.y;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The sum of a row's 8 NT accumulator entries (rows g and g + 8: h = 0, 1)
// times v_at(row, column) over the 4 lanes that hold the row; every lane of
// the quad gets it.
template <int NT, typename LV>
__device__ __forceinline__ float row_dot(const float (&acc)[NT][4], int h, int r, int c0,
                                         LV v_at) {
  const int q = threadIdx.x & 3;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) s += acc[j][2 * h + e] * v_at(r, c0 + 8 * j + 2 * q + e);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

// Warp 0: v[0 .. Q) replaced by its reverse inclusive cumsum, sum_{u >= t} v[u].
template <int Q>
__device__ __forceinline__ void reverse_cumsum(float* v) {
  constexpr int E = Q / 32;
  const int lane = threadIdx.x & 31;
  float s[E], run = 0.f;
#pragma unroll
  for (int e = E - 1; e >= 0; --e) {
    run += v[lane * E + e];
    s[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += u;
  }
  const float excl = incl - run;
  __syncwarp();
#pragma unroll
  for (int e = 0; e < E; ++e) v[lane * E + e] = excl + s[e];
}

// 1. Reverse state passing, grid (N / kRB, head, batch): the block owns kRB
// rows of one (batch, head)'s state gradient and walks the chunks from the
// last: it writes Gbar_c+1 (dstates[c]) and then, for c > 0, forms
// Gbar_c = exp(A cdt_last) Gbar_c+1 + (C o e)^T dy.  Warp w: rows 16 w.
template <int Q, int N, int P>
__global__ void __launch_bounds__(BwdDims<Q, N, P>::kStateThreads)
ssd_bwd_states(const float* __restrict__ dy, int64_t ysb, int64_t ysh, int64_t yss,
               const float* __restrict__ dt, int64_t dsb, int64_t dsh, int64_t dss,
               const float* __restrict__ A, const float* __restrict__ Cm, int64_t csb,
               int64_t css, const float* __restrict__ ds_fin, float* __restrict__ dstates,
               int64_t seq, bool vec) {
  using D = BwdDims<Q, N, P>;
  constexpr int NT = P / 8;
  extern __shared__ __align__(16) float smem[];
  float* cdt = smem + 2 * D::kStage;  // [Q]
  float* ev = cdt + Q;                // [Q] exp(A cdt_t)
  float* dec = ev + Q;                // [1]
  const int64_t rb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int64_t heads = gridDim.y, bh = b * heads + h;
  const int64_t nc = (seq + Q - 1) / Q;
  const float a = A[h];
  const float* yb = dy + b * ysb + h * ysh;
  const float* db = dt + b * dsb + h * dsh;
  const float* cb = Cm + b * csb + rb * D::kRB;
  auto stage = [&](int64_t c) { return smem + (c & 1) * D::kStage; };
  auto load = [&](int64_t c) {
    float* st = stage(c);
    const int64_t t0 = c * Q;
    const int valid = static_cast<int>(seq - t0 < Q ? seq - t0 : Q);
    load_rows<D::kRB, D::kBS>(st, cb + t0 * css, css, Q, valid, vec);
    load_rows<P, D::kXS>(st + Q * D::kBS, yb + t0 * yss, yss, Q, valid, vec);
    load_dt<Q>(st + Q * D::kBS + Q * D::kXS, db + t0 * dss, dss, valid);
  };
  const int r0 = 16 * (threadIdx.x >> 5);
  float* gb = dstates + (bh * nc * N + rb * D::kRB) * P;
  float acc[NT][4];
  if (ds_fin != nullptr)
    load_acc(acc, ds_fin + (bh * N + rb * D::kRB) * P, P, r0, 0);
  else
    zero(acc);
  load(nc - 1);
  cp_async_commit();
  for (int64_t c = nc - 1; c >= 0; --c) {
    if (c > 0) load(c - 1);
    cp_async_commit();
    cp_async_wait<1>();  // chunk c has landed
    __syncthreads();
    const float* cs = stage(c);
    const float* ys = cs + Q * D::kBS;
    const float* dts = ys + Q * D::kXS;
    store_acc(acc, gb + c * N * P, P, r0, 0, D::kRB);  // Gbar_c+1
    if (c > 0) {
      if (threadIdx.x < 32) {
        const float last = chunk_cumsum<Q>(dts, cdt);
        __syncwarp();
        for (int i = threadIdx.x; i < Q; i += 32) ev[i] = expf(a * cdt[i]);
        if (threadIdx.x == 0) dec[0] = expf(a * last);
      }
      __syncthreads();
      const float f = dec[0];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= f;
      warp_mma(acc, Q / 8, [&](int m, int k) { return cs[k * D::kBS + r0 + m]; },
               [&](int k, int n) { return ys[k * D::kXS + n] * ev[k]; });
    }
    __syncthreads();  // stage c is free for chunk c - 2
  }
}

// 2. Every head's gradients of one chunk, grid (chunk, batch).  Warp w: rows
// 16 (w / 2) of each [Q x *] product, the column half w % 2.
template <int Q, int N, int P>
__global__ void __launch_bounds__(BwdDims<Q, N, P>::kChunkThreads)
ssd_bwd_chunk(const float* __restrict__ x, int64_t xsb, int64_t xsh, int64_t xss,
              const float* __restrict__ dt, int64_t dsb, int64_t dsh, int64_t dss,
              const float* __restrict__ A, const float* __restrict__ Bm, int64_t bsb,
              int64_t bss, const float* __restrict__ Cm, int64_t csb, int64_t css,
              const float* __restrict__ dy, int64_t ysb, int64_t ysh, int64_t yss,
              const float* __restrict__ states, const float* __restrict__ dstates,
              float* __restrict__ dx, int64_t xdsb, int64_t xdsh, int64_t xdss,
              float* __restrict__ ddt, float* __restrict__ dB, float* __restrict__ dC,
              float* __restrict__ dA_part, int64_t heads, int64_t seq, bool vec_bc,
              bool vec_x, bool vec_y) {
  using D = BwdDims<Q, N, P>;
  constexpr int NQ = Q / 16, NP = P / 16, NN = N / 16;  // 8-column tiles of a half
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;              // [Q][kWS] G = C B^T
  float* dm = gs + Q * D::kWS;   // [Q][kWS] (dy x^T) o M, causal
  float* bs = dm + Q * D::kWS;   // [Q][kCS] B
  float* cs = bs + Q * D::kCS;   // [Q][kCS] C
  float* xs = cs + Q * D::kCS;   // [Q][kXS] x
  float* ys = xs + Q * D::kXS;   // [Q][kXS] dy
  float* ss = ys + Q * D::kXS;   // [N][kXS] S_c, the state before the chunk
  float* gg = ss + N * D::kXS;   // [N][kXS] Gbar_c+1, the gradient of the one after
  float* dts = gg + N * D::kXS;  // [Q] dt
  float* cdt = dts + Q;          // [Q] cumsum of dt
  float* ev = cdt + Q;           // [Q] e_t = exp(A cdt_t)
  float* ew = ev + Q;            // [Q] exp(A (cdt_last - cdt_i))
  float* wv = ew + Q;            // [Q] w_i
  float* pde = wv + Q;           // [2][Q] dL/de_t by column half
  float* pdw = pde + 2 * Q;      // [2][Q] dL/dw_i by column half
  float* dcdt = pdw + 2 * Q;     // [Q] dL/dcdt_t, then its reverse cumsum
  float* red = dcdt + Q;         // [32] reductions
  const int64_t c = blockIdx.x, b = blockIdx.y, t0 = c * Q, nc = gridDim.x;
  const int valid = static_cast<int>(seq - t0 < Q ? seq - t0 : Q);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int r0 = 16 * (w >> 1), half = w & 1;
  const int cq = half * (Q / 2), cp = half * (P / 2), cn = half * (N / 2);

  load_rows<N, D::kCS>(cs, Cm + b * csb + t0 * css, css, Q, valid, vec_bc);
  load_rows<N, D::kCS>(bs, Bm + b * bsb + t0 * bss, bss, Q, valid, vec_bc);
  cp_async_wait_all();
  __syncthreads();
  {
    float acc[NQ][4];
    zero(acc);
    warp_mma(acc, N / 8, [&](int m, int k) { return cs[(r0 + m) * D::kCS + k]; },
             [&](int k, int n) { return bs[(cq + n) * D::kCS + k]; });
    store_acc(acc, gs, D::kWS, r0, cq, Q);
  }
  float accB[NN][4], accC[NN][4];
  zero(accB);
  zero(accC);

  for (int64_t h = 0; h < heads; ++h) {
    const int64_t bh = b * heads + h;
    const float a = A[h];
    __syncthreads();  // the previous head is done with every buffer below
    load_rows<P, D::kXS>(xs, x + b * xsb + h * xsh + t0 * xss, xss, Q, valid, vec_x);
    load_rows<P, D::kXS>(ys, dy + b * ysb + h * ysh + t0 * yss, yss, Q, valid, vec_y);
    load_dt<Q>(dts, dt + b * dsb + h * dsh + t0 * dss, dss, valid);
    if (c > 0) load_rows<P, D::kXS>(ss, states + (bh * nc + c) * N * P, P, N, N, true);
    load_rows<P, D::kXS>(gg, dstates + (bh * nc + c) * N * P, P, N, N, true);
    cp_async_wait_all();
    __syncthreads();
    if (w == 0) {
      const float l = chunk_cumsum<Q>(dts, cdt);
      if (lane == 0) red[12] = l;
    }
    __syncthreads();
    const float last = red[12];
    for (int t = threadIdx.x; t < Q; t += blockDim.x) {
      ev[t] = expf(a * cdt[t]);
      ew[t] = expf(a * (last - cdt[t]));
      wv[t] = ew[t] * dts[t];
    }
    __syncthreads();

    // (dy x^T) o M, masked before the exp, into dm.
    {
      float acc[NQ][4];
      zero(acc);
      warp_mma(acc, P / 8, [&](int m, int k) { return ys[(r0 + m) * D::kXS + k]; },
               [&](int k, int n) { return xs[(cq + n) * D::kXS + k]; });
      const int q = lane & 3;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = r0 + g + 8 * hh;
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = cq + 8 * j + 2 * q + e;
            dm[t * D::kWS + i] =
                i <= t ? acc[j][2 * hh + e] * expf(a * (cdt[t] - cdt[i])) : 0.f;
          }
      }
    }
    // T = dy S_c^T: de_t = C_t . T_t, and dC += e o T.
    if (c > 0) {
      float T[NN][4];
      zero(T);
      warp_mma(T, P / 8, [&](int m, int k) { return ys[(r0 + m) * D::kXS + k]; },
               [&](int k, int n) { return ss[(cn + n) * D::kXS + k]; });
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = r0 + g + 8 * hh;
        const float s = row_dot(T, hh, t, cn, [&](int r, int col) { return cs[r * D::kCS + col]; });
        if ((lane & 3) == 0) pde[half * Q + t] = s;
        const float f = ev[t];
#pragma unroll
        for (int j = 0; j < NN; ++j) {
          accC[j][2 * hh] += f * T[j][2 * hh];
          accC[j][2 * hh + 1] += f * T[j][2 * hh + 1];
        }
      }
    } else if ((lane & 3) == 0) {
      pde[half * Q + r0 + g] = 0.f;
      pde[half * Q + r0 + g + 8] = 0.f;
    }
    // U = B Gbar: dw_i = x_i . U_i; U stays for dx.
    float U[NP][4];
    zero(U);
    warp_mma(U, N / 8, [&](int m, int k) { return bs[(r0 + m) * D::kCS + k]; },
             [&](int k, int n) { return gg[k * D::kXS + cp + n]; });
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = r0 + g + 8 * hh;
      const float s = row_dot(U, hh, t, cp, [&](int r, int col) { return xs[r * D::kXS + col]; });
      if ((lane & 3) == 0) pdw[half * Q + t] = s;
    }
    // V = x Gbar^T: dB += w o V.
    {
      float V[NN][4];
      zero(V);
      warp_mma(V, P / 8, [&](int m, int k) { return xs[(r0 + m) * D::kXS + k]; },
               [&](int k, int n) { return gg[(cn + n) * D::kXS + k]; });
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float f = wv[r0 + g + 8 * hh];
#pragma unroll
        for (int j = 0; j < NN; ++j) {
          accB[j][2 * hh] += f * V[j][2 * hh];
          accB[j][2 * hh + 1] += f * V[j][2 * hh + 1];
        }
      }
    }
    // <Gbar_c+1, S_c>, the decay's gradient, by warp.
    {
      float s = 0.f;
      if (c > 0)
        for (int e = threadIdx.x; e < N * P; e += blockDim.x) {
          const int n = e / P, p = e % P;
          s += gg[n * D::kXS + p] * ss[n * D::kXS + p];
        }
      s = warp_sum(s);
      if (lane == 0) red[w] = s;
    }
    __syncthreads();  // dm, pde, pdw and red are complete

    // dx = W^T dy + w o U, W[t, i] = G[t, i] M[t, i] dt_i for t >= i.
    {
      float acc[NP][4];
      zero(acc);
      warp_mma_range(acc, r0 / 8, Q / 8,
                     [&](int m, int k) {
                       const int i = r0 + m;
                       return k >= i ? gs[k * D::kWS + i] * expf(a * (cdt[k] - cdt[i])) * dts[i]
                                     : 0.f;
                     },
                     [&](int k, int n) { return ys[k * D::kXS + cp + n]; });
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float f = wv[r0 + g + 8 * hh];
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          acc[j][2 * hh] += f * U[j][2 * hh];
          acc[j][2 * hh + 1] += f * U[j][2 * hh + 1];
        }
      }
      store_acc(acc, dx + b * xdsb + h * xdsh + t0 * xdss, xdss, r0, cp, valid);
    }
    // dC += dG B and dB += dG^T C, dG[t, i] = dm[t, i] dt_i.
    warp_mma(accC, r0 / 8 + 2, [&](int m, int k) { return dm[(r0 + m) * D::kWS + k] * dts[k]; },
             [&](int k, int n) { return bs[k * D::kCS + cn + n]; });
    warp_mma_range(accB, r0 / 8, Q / 8,
                   [&](int m, int k) { return dm[k * D::kWS + r0 + m] * dts[r0 + m]; },
                   [&](int k, int n) { return cs[k * D::kCS + cn + n]; });

    // Per step j (the first two warps): the segment sums' row and column
    // terms, the carry's, the chunk state's; dL/dcdt_j, ddt's direct part,
    // and dA's terms.
    float direct = 0.f;
    if (threadIdx.x < Q) {
      const int j = threadIdx.x;
      float rs = 0.f, cr = 0.f;
      for (int i = 0; i <= j; ++i) rs += dm[j * D::kWS + i] * gs[j * D::kWS + i] * dts[i];
      for (int t = j; t < Q; ++t) cr += dm[t * D::kWS + j] * gs[t * D::kWS + j];
      const float cl = cr * dts[j];
      const float de = pde[j] + pde[Q + j], dw = pdw[j] + pdw[Q + j];
      const float zc = de * ev[j], zw = dw * wv[j];
      dcdt[j] = a * (rs - cl + zc - zw);
      direct = cr + dw * ew[j];
      const float zws = warp_sum(zw);
      const float das = warp_sum((rs - cl + zc) * cdt[j] + zw * (last - cdt[j]));
      if (lane == 0) {
        red[8 + 2 * w] = zws;
        red[9 + 2 * w] = das;
      }
    }
    __syncthreads();
    if (w == 0) {
      float dd = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) dd += red[u];
      const float zd = dd * expf(a * last);
      if (lane == 0) {
        dcdt[Q - 1] += a * (red[8] + red[10] + zd);
        dA_part[bh * nc + c] = red[9] + red[11] + zd * last;
      }
      __syncwarp();
      reverse_cumsum<Q>(dcdt);
    }
    __syncthreads();
    if (threadIdx.x < valid) ddt[bh * seq + t0 + threadIdx.x] = direct + dcdt[threadIdx.x];
  }
  store_acc(accB, dB + (b * seq + t0) * N, N, r0, cn, valid);
  store_acc(accC, dC + (b * seq + t0) * N, N, r0, cn, valid);
}

// 3. dA[h], its (batch, chunk) parts summed in a fixed order.
__global__ void __launch_bounds__(kReduceThreads)
ssd_bwd_dA(const float* __restrict__ part, float* __restrict__ dA, int64_t batch,
           int64_t heads, int64_t nc) {
  __shared__ float sm[kReduceThreads];
  const int64_t h = blockIdx.x;
  float s = 0.f;
  for (int64_t e = threadIdx.x; e < batch * nc; e += kReduceThreads)
    s += part[((e / nc) * heads + h) * nc + e % nc];
  sm[threadIdx.x] = s;
  __syncthreads();
  for (int off = kReduceThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) sm[threadIdx.x] += sm[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) dA[h] = sm[0];
}

template <int Q, int N, int P>
cudaError_t run_bwd(const float* x, int64_t xsb, int64_t xsh, int64_t xss, const float* dt,
                    int64_t dsb, int64_t dsh, int64_t dss, const float* A, const float* Bm,
                    int64_t bsb, int64_t bss, const float* Cm, int64_t csb, int64_t css,
                    const float* dy, int64_t ysb, int64_t ysh, int64_t yss, const float* ds_fin,
                    const float* states, float* dstates, float* dx, int64_t xdsb,
                    int64_t xdsh, int64_t xdss, float* ddt, float* dB, float* dC,
                    float* dA_part, float* dA, int64_t batch, int64_t heads, int64_t seq,
                    cudaStream_t st) {
  using D = BwdDims<Q, N, P>;
  const int64_t nc = (seq + Q - 1) / Q;
  const bool vec_c = aligned16(Cm, csb, css);
  const bool vec_bc = vec_c && aligned16(Bm, bsb, bss);
  const bool vec_x = aligned16(x, xsb, xsh, xss);
  const bool vec_y = aligned16(dy, ysb, ysh, yss);
  const int state_smem = 4 * D::kStateSmem, chunk_smem = 4 * D::kChunkSmem;
  cudaError_t err;
  if ((err = allow_smem(ssd_bwd_states<Q, N, P>, state_smem)) != cudaSuccess) return err;
  if ((err = allow_smem(ssd_bwd_chunk<Q, N, P>, chunk_smem)) != cudaSuccess) return err;
  const auto ub = static_cast<unsigned>(batch), uh = static_cast<unsigned>(heads);
  ssd_bwd_states<Q, N, P><<<dim3(N / D::kRB, uh, ub), D::kStateThreads, state_smem, st>>>(
      dy, ysb, ysh, yss, dt, dsb, dsh, dss, A, Cm, csb, css, ds_fin, dstates, seq,
      vec_c && vec_y);
  ssd_bwd_chunk<Q, N, P><<<dim3(static_cast<unsigned>(nc), ub), D::kChunkThreads, chunk_smem,
                           st>>>(x, xsb, xsh, xss, dt, dsb, dsh, dss, A, Bm, bsb, bss, Cm, csb,
                                 css, dy, ysb, ysh, yss, states, dstates, dx, xdsb, xdsh, xdss,
                                 ddt, dB, dC, dA_part, heads, seq, vec_bc, vec_x, vec_y);
  ssd_bwd_dA<<<uh, kReduceThreads, 0, st>>>(dA_part, dA, batch, heads, nc);
  return cudaGetLastError();
}

}  // namespace

// The SSD scan's gradients from x [batch, heads, seq, p], dt [batch, heads,
// seq], A [heads], B, C [batch, seq, n], the output gradient dy [batch,
// heads, seq, p] (each fp32 by pointer and element strides, last dim
// contiguous), the final state's gradient ds_fin [batch, heads, n, p]
// (contiguous; null: zero) and kernel 6's states [batch, heads, nc, n, p]
// (the state before each chunk of q steps; chunk 0's is not read): dx
// (strided likewise, p even), ddt [batch, heads, seq], dB, dC [batch, seq,
// n] and dA [heads], all fp32.  Scratch (contiguous fp32): dstates like
// states and dA_part [batch, heads, nc].  (n, p) is one of (16, 16),
// (32, 32), (64, 64), (128, 64); q is 64.
extern "C" int repro_ssd_scan_bwd(int64_t device, const void* x, int64_t xsb, int64_t xsh,
                                  int64_t xss, const void* dt, int64_t dsb, int64_t dsh,
                                  int64_t dss, const void* A, const void* Bm, int64_t bsb,
                                  int64_t bss, const void* Cm, int64_t csb, int64_t css,
                                  const void* dy, int64_t ysb, int64_t ysh, int64_t yss,
                                  const void* ds_fin, const void* states, void* dstates,
                                  void* dx, int64_t xdsb, int64_t xdsh, int64_t xdss, void* ddt,
                                  void* dB, void* dC, void* dA_part, void* dA, int64_t batch,
                                  int64_t heads, int64_t seq, int64_t n, int64_t p, int64_t q,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || heads <= 0 || seq <= 0) return 0;
  if (batch > 65535 || heads > 65535 || (seq + q - 1) / q > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define REPRO_SSD_BWD(QV, NV, PV)                                                             \
  if (q == QV && n == NV && p == PV)                                                          \
    return static_cast<int>(run_bwd<QV, NV, PV>(                                              \
        static_cast<const float*>(x), xsb, xsh, xss, static_cast<const float*>(dt), dsb, dsh, \
        dss, static_cast<const float*>(A), static_cast<const float*>(Bm), bsb, bss,           \
        static_cast<const float*>(Cm), csb, css, static_cast<const float*>(dy), ysb, ysh,     \
        yss, static_cast<const float*>(ds_fin), static_cast<const float*>(states),            \
        static_cast<float*>(dstates), static_cast<float*>(dx), xdsb, xdsh, xdss,              \
        static_cast<float*>(ddt), static_cast<float*>(dB), static_cast<float*>(dC),           \
        static_cast<float*>(dA_part), static_cast<float*>(dA), batch, heads, seq, s));
  REPRO_SSD_BWD(64, 16, 16)
  REPRO_SSD_BWD(64, 32, 32)
  REPRO_SSD_BWD(64, 64, 64)
  REPRO_SSD_BWD(64, 128, 64)
#undef REPRO_SSD_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
