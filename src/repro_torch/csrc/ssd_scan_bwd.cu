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
//   1. ssd_bwd_states, grid (N / 64, head, batch): the reverse state
//      passing, kernel 6's ssd_states mirrored.  One block of 4 warps per 64
//      state rows of a (batch, head) walks the chunks from the last with
//      Gbar in its MMA accumulators: it writes each chunk's Gbar_c+1 and
//      adds (C o e)^T dy [N x Q] . [Q x P].  One stage of C's columns, dy
//      and dt (33 KB, swizzled rows as in pass 2, fragments read at offsets
//      kept a lane), so that six blocks share an SM and hide each other's
//      copies (two stages or one block for all N rows read slower).
//   2. ssd_bwd_chunk, grid (chunk, batch): every head of one chunk in turn,
//      so that G = C B^T is computed once (kept in registers) and dB and dC
//      are summed over the heads in registers, in head order, with no
//      atomics and no per-head scratch.  The terms that are linear in dG are
//      summed over the heads first, sum_h dG_h (registers, head order), and
//      multiplied by B and C once a block: dC = (sum_h dG_h) B + sum_h e_h o
//      (dy_h S_c^T), dB = (sum_h dG_h)^T C + sum_h (w_h o x_h) Gbar_c+1^T.
//      For each head five products: dy x^T over its causal tiles (the
//      epilogue forms W = G o M o dt and dG = (dy x^T) o M o dt once, W into
//      shared memory, and the segment sums' row and column terms), dy
//      S_c^T, B Gbar, (w o x) Gbar^T straight into dB's accumulators, and
//      W^T dy.  The operands stream through a cp.async ring so that copies
//      overlap products: x, dy and dt double-buffered by head, S_c and
//      Gbar_c+1 in pieces of 64 state rows through two slots (a piece is
//      read by its products, then its slot takes the piece two ahead).
//      8 warps (4 row blocks x 2 column slices; 4 warps at P 32 and 16);
//      B Gbar and W^T dy pair row blocks p and 3 - p in a warp, so that
//      W^T dy's causal K (8 - 2 p k steps) evens out over the warps.  The
//      row and column sums are partial sums of every warp added in a fixed
//      order.  A head's per-step scalars (dL/dcdt, its reverse cumsum,
//      ddt, dA's part) run during the next head's products on two warps
//      whose tile of dy x^T lies past the diagonal, synchronised with each
//      other only (named barrier 1; the scalars and their inputs double-
//      buffered by head parity): five block barriers a head.  Rows are stored
//      unpadded with their columns XOR-swizzled (swz), so that fragment reads
//      of 8 rows x 4 columns and of 4 rows x 8 columns both meet 32 banks;
//      row-major operands are read by ldmatrix, four fragment registers an
//      instruction, the others at offsets kept a lane.  dx and ddt are
//      written per head, dA's part per (batch, head, chunk).
//   3. ssd_bwd_dA, grid (head): dA, the parts summed in a fixed order.
// Every sum runs in a fixed order: two runs give the same bits.  Products
// run on mma.sync m16n8k8 TF32 as 3xTF32, which the forward's note shows the
// card needs for its 1e-4 tolerance at K = 128: each operand splits into a
// TF32 hi (its top 19 bits) and lo (the rest, exact), a step's lo products
// issued for every tile before its hi ones.  Each warp splits its fragments
// as it reads them (hi + lo of every operand would not fit in shared memory
// beside the ring).
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
// does the chunked form's products inside each chunk too (47 GFLOP of
// products and 13 of state passing, each product three MMAs) and writes and
// reads the state gradients once more (0.8 GB).  Fed 8 independent products
// a warp and 32 warps an SM, mma.sync m16n8k8 TF32 runs at about 320 TFLOP/s
// on this card (scripts/train_scan_tiles.py measures it, and the chunk pass
// without its products); the chunk pass's products, issued among their
// fragment reads, splits and epilogues by 8 warps an SM, reach about 60 % of
// that rate and take about 60 % of its time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

constexpr int kReduceThreads = 256;

template <int Q, int N, int P>
struct BwdDims {
  // 1. The state pass.
  static constexpr int kRB = N < 64 ? N : 64;  // state rows a states block owns
  static constexpr int kStateThreads = 32 * (kRB / 16);
  static constexpr int kStage = Q * kRB + Q * P + Q;  // C columns, dy, dt of a chunk
  static constexpr int kStateSmem = kStage + 2 * Q + 32;
  // 2. The chunk pass.
  static constexpr int kNH = N < 64 ? N : 64;          // state rows a piece of S_c, Gbar_c+1
  static constexpr int kPieces = N / kNH;
  static constexpr int kWC = P / 32 < 1 ? 1 : P / 32;  // column slices (warps a row block)
  static constexpr int kWarps = 4 * kWC;
  static constexpr int kChunkThreads = 32 * kWarps;
  static constexpr int kXY = 2 * Q * P + Q;  // x, dy, dt of a head
  static constexpr int kSG = 2 * kNH * P;    // a piece of S_c and the same of Gbar_c+1
  static constexpr int kRed = 64;            // reductions (a slot a warp, then the scalars')
  // cdt, e, exp(A (cdt_last - cdt)), w and the row and column sums of R by
  // head parity; dL/de, dL/dw; reductions; the chunk's cdt_last by parity.
  static constexpr int kScal = 8 * Q + 2 * (kWC + 4) * Q + 3 * kWC * Q + kRed + 4;
  static constexpr int kChunkSmem = 2 * Q * N + 2 * kXY + 2 * kSG + Q * Q + kScal;
};

// Element (r, c) of a shared [rows][L] array: columns XOR-swizzled by row,
// so that both fragment reads, rows g x columns q and rows q x columns g (g <
// 8, q < 4), meet 32 banks; 4-float groups stay whole (cp.async, float2).
template <int L>
__device__ __forceinline__ int swz(int r, int c) {
  return r * L + (c ^ ((((r & 3) << 3) | (r & 4)) & (L - 4)));
}

// ROWS x L floats from src (row stride rs) into the swizzled dst by T
// threads; rows at or past `valid` are zero-filled.  vec: every source row is
// 16-byte aligned.  Each thread copies the same 16 bytes of every (T / (L /
// 4))-th row, a multiple of 8 rows apart, so its swizzled offset is computed
// once.  Else 4-byte copies.
template <int L, int ROWS, int T>
__device__ __forceinline__ void load_rows_sw(float* dst, const float* src, int64_t rs,
                                             int valid, bool vec) {
  constexpr int CPR = L / 4, RS = T / CPR;  // 16-byte columns a row, rows a sweep
  static_assert(L % 4 == 0 && T % CPR == 0 && RS % 8 == 0, "whole sweeps of 8 rows");
  if (vec) {
    const int r0 = threadIdx.x / CPR, c = 4 * (threadIdx.x % CPR);
    float* d = dst + swz<L>(r0, c);
    const float* sp = src + r0 * rs + c;
#pragma unroll
    for (int k = 0; k < (ROWS + RS - 1) / RS; ++k) {
      const int r = r0 + k * RS;
      if (ROWS % RS != 0 && r >= ROWS) break;
      if (r < valid)
        cp_async16(d + k * RS * L, sp + k * RS * rs);
      else
        *reinterpret_cast<float4*>(d + k * RS * L) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * L; e += T) {
      const int r = e / L, c = e % L;
      float* d = dst + swz<L>(r, c);
      if (r < valid)
        cp_async4(d, src + r * rs + c);
      else
        *d = 0.f;
    }
  }
}

// ---- Fragment reads from the swizzled arrays, 3xTF32 products ------------ //

// x = hi + lo exactly, hi x's top 19 bits; the MMA reads lo's top 19 bits
// (a relative error of 2^-20 of x against 3xTF32's rounded split, far inside
// SSD_BWD_TOL), in two operations instead of four.
__device__ __forceinline__ void split_t(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Four 8 x 4 fp32 tiles (8 x 8 b16 to ldmatrix): lane i gives the address of
// row i % 8 of tile i / 8 and gets element (lane / 4, lane % 4) of each.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// ldmatrix addresses in a swizzled [rows][L] array whose 8-row groups start
// on multiples of 8, columns cb + 8 s + (0..7) (cb a multiple of 32): lane i
// reads row row0 + i % 8 (+ 8 where sel_row picks it from i / 8) and column
// group 4 (bit sel_col of i / 8).
template <int L>
struct Ldsm {
  const float* base;
  int xo[4];
  __device__ __forceinline__ Ldsm(const float* p, int row0, int cb, int sel_row, int sel_col) {
    const int i = threadIdx.x & 31, t = i >> 3;
    const int f = (((i & 3) << 3) | (i & 4)) & (L - 4);
    base = p + (row0 + 8 * ((t >> sel_row) & 1) + (i & 7)) * L + cb;
#pragma unroll
    for (int v = 0; v < 4; ++v) xo[v] = (8 * v + 4 * ((t >> sel_col) & 1)) ^ f;
  }
  __device__ __forceinline__ void load(int s, int row_off, uint32_t (&r)[4]) const {
    ldsm4(r, base + row_off * L + 32 * (s >> 2) + xo[s & 3]);
  }
};

// A fragment, rows r0 + (g, g + 8), columns 8 s + (q, q + 4), of a row-major
// operand (A[m][k] stored as rows m); scaled by w0 (rows g) and w1 (g + 8).
template <int L>
struct RowA {
  Ldsm<L> m;
  float w0 = 1.f, w1 = 1.f;
  __device__ __forceinline__ RowA(const float* p, int r0, int cb) : m(p, r0, cb, 0, 1) {}
  __device__ __forceinline__ void load(int s, float (&a)[4]) const {
    uint32_t r[4];
    m.load(s, 0, r);
    a[0] = __uint_as_float(r[0]) * w0;
    a[1] = __uint_as_float(r[1]) * w1;
    a[2] = __uint_as_float(r[2]) * w0;
    a[3] = __uint_as_float(r[3]) * w1;
  }
};

// B fragments of NT 8-column tiles (n0 + 8 j + g, rows 8 s + (q, q + 4)) of an
// operand stored as rows n (B[k][n] at [n][k]); two tiles an ldmatrix.
template <int L, int NT>
struct RowB {
  Ldsm<L> m;
  __device__ __forceinline__ RowB(const float* p, int n0, int cb) : m(p, n0, cb, 1, 0) {}
  __device__ __forceinline__ void load(int s, float (&b)[NT][2]) const {
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t r[4];
      m.load(s, 16 * jj, r);
      b[2 * jj][0] = __uint_as_float(r[0]);
      b[2 * jj][1] = __uint_as_float(r[1]);
      b[2 * jj + 1][0] = __uint_as_float(r[2]);
      b[2 * jj + 1][1] = __uint_as_float(r[3]);
    }
  }
};

// B fragments of NT tiles of an operand stored as rows k (B[k][n] at
// [k][n]): element (8 s + q + 4 e, c0 + 8 j + g), offsets kept a lane.
template <int L, int NT>
struct ColB {
  const float* p;
  int off[NT][2];
  __device__ __forceinline__ ColB(const float* p_, int c0) : p(p_) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) off[j][e] = swz<L>(q + 4 * e, c0 + 8 * j + g);
  }
  __device__ __forceinline__ void load(int s, float (&b)[NT][2]) const {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) b[j][e] = p[off[j][e] + 8 * s * L];
  }
};

// A fragment of an operand stored as rows k (A[m][k] at [k][m]): element
// (m = r0 + g + 8 h, k = 8 s + q + 4 e).
template <int L>
struct ColA {
  const float* p;
  int off[2][2];
  __device__ __forceinline__ ColA(const float* p_, int r0) : p(p_) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) off[h][e] = swz<L>(q + 4 * e, r0 + g + 8 * h);
  }
  __device__ __forceinline__ void load(int s, float (&a)[4]) const {
    a[0] = p[off[0][0] + 8 * s * L];
    a[1] = p[off[1][0] + 8 * s * L];
    a[2] = p[off[0][1] + 8 * s * L];
    a[3] = p[off[1][1] + 8 * s * L];
  }
};

// mma.sync m16n8k8 TF32 as a pure function of its operands (not volatile):
// the compiler may issue the next k step's loads ahead of it.  Every
// accumulator still takes its products in program order.
__device__ __forceinline__ void mma_tf32_nv(float (&d)[4], const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k step of acc[j] += A . B in 3xTF32: the lo products of every tile,
// then the hi ones, so that no product waits on the one just issued.
template <int NT>
__device__ __forceinline__ void mma3_step(float (&acc)[NT][4], const float (&a)[4],
                                          const float (&b)[NT][2], int live = NT) {
  uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_t(a[i], ah[i], al[i]);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split_t(b[j][0], bh[j][0], bl[j][0]);
    split_t(b[j][1], bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < live) mma_tf32_nv(acc[j], al, bh[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < live) mma_tf32_nv(acc[j], ah, bl[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < live) mma_tf32_nv(acc[j], ah, bh[j]);
}

// acc[j] += A . B over the k steps s_lo <= s < s_hi of 8 (s < S, unrolled),
// for the tiles j < live (the others are left as they are).
template <int S, int NT, typename FA, typename FB>
__device__ __forceinline__ void mma3(float (&acc)[NT][4], int s_lo, int s_hi, const FA& fa,
                                     const FB& fb, int live = NT) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (s < s_lo || s >= s_hi) continue;
    float a[4], b[NT][2];
    fa.load(s, a);
    fb.load(s, b);
    mma3_step(acc, a, b, live);
  }
}

// Store a warp's 16 x 8 NT accumulator at rows r0.., columns c0.. of the
// swizzled [rows][L] dst.
template <int L, int NT>
__device__ __forceinline__ void store_acc_sw(const float (&acc)[NT][4], float* dst, int r0,
                                             int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<float2*>(dst + swz<L>(r0 + g + 8 * h, c0 + 8 * j + 2 * q)) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
}

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
// Gbar_c = exp(A cdt_last) Gbar_c+1 + (C o e)^T dy.  Warp w: rows 16 w.  The
// stage takes chunk c - 1 once chunk c's product has read it.
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
  float* cdt = smem + D::kStage;      // [Q]
  float* ev = cdt + Q;                // [Q] exp(A cdt_t)
  float* dec = ev + Q;                // [1]
  const int64_t rb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int64_t heads = gridDim.y, bh = b * heads + h;
  const int64_t nc = (seq + Q - 1) / Q;
  const float a = A[h];
  const float* yb = dy + b * ysb + h * ysh;
  const float* db = dt + b * dsb + h * dsh;
  const float* cb = Cm + b * csb + rb * D::kRB;
  auto load = [&](int64_t c) {
    float* st = smem;
    const int64_t t0 = c * Q;
    const int valid = static_cast<int>(seq - t0 < Q ? seq - t0 : Q);
    load_rows_sw<D::kRB, Q, D::kStateThreads>(st, cb + t0 * css, css, valid, vec);
    load_rows_sw<P, Q, D::kStateThreads>(st + Q * D::kRB, yb + t0 * yss, yss, valid, vec);
    load_dt<Q>(st + Q * D::kRB + Q * P, db + t0 * dss, dss, valid);
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
    cp_async_wait<0>();  // chunk c has landed
    __syncthreads();
    const float* cs = smem;
    const float* ys = cs + Q * D::kRB;
    const float* dts = ys + Q * P;
    store_acc(acc, gb + c * N * P, P, r0, 0, D::kRB);  // Gbar_c+1
    if (c > 0) {
      if (threadIdx.x < 32) {
        const float last = chunk_cumsum<Q>(dts, cdt);
        __syncwarp();
        for (int i = threadIdx.x; i < Q; i += 32) ev[i] = __expf(a * cdt[i]);
        if (threadIdx.x == 0) dec[0] = expf(a * last);
      }
      __syncthreads();
      const float f = dec[0];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= f;
      // A = (C's columns)^T and B = e o dy, both stored as rows t (k).
      const ColA<D::kRB> fa(cs, r0);
      const ColB<P, NT> fb(ys, 0);
      const int q = threadIdx.x & 3;
#pragma unroll
      for (int s = 0; s < Q / 8; ++s) {
        float ca[4], bv[NT][2];
        fa.load(s, ca);
        fb.load(s, bv);
        const float e0 = ev[8 * s + q], e1 = ev[8 * s + q + 4];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          bv[j][0] *= e0;
          bv[j][1] *= e1;
        }
        mma3_step(acc, ca, bv);
      }
      __syncthreads();  // the stage is read: it takes chunk c - 1
      load(c - 1);
      cp_async_commit();
    }
  }
}

// 2. Every head's gradients of one chunk, grid (chunk, batch).  Warp w: row
// block rw = w / kWC (16 rows of each [Q x *] product) and column slice cw =
// w % kWC (Q / kWC columns of dy x^T, kNH / kWC of a piece's products, P /
// kWC of B Gbar and W^T dy).
template <int Q, int N, int P>
__global__ void __launch_bounds__(BwdDims<Q, N, P>::kChunkThreads, 1)
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
  constexpr int WC = D::kWC, NH = D::kNH, PC = D::kPieces, kT = D::kChunkThreads;
  // The warps that finish a head's scalars: two whose tile of dy x^T lies
  // past the diagonal where there are such (kWC 2: rows 0-15 and 16-31,
  // columns 32-63), else the last two.
  constexpr int kSW0 = WC >= 2 ? 1 : 2, kSW1 = 3;
  constexpr int TQ = Q / WC / 8, TH = NH / WC / 8, TP = P / WC / 16;  // 8-column tiles
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;              // [Q][N] B
  float* cs = bs + Q * N;        // [Q][N] C
  float* xy = cs + Q * N;        // [2][kXY] x [Q][P], dy [Q][P], dt [Q] of a head
  float* sg = xy + 2 * D::kXY;   // [2][kSG] S_c, Gbar_c+1 [kNH][P] of a piece
  float* wb = sg + 2 * D::kSG;   // [Q][Q] W of a head; at the end sum_h dG
  // By head parity: [2][Q] each, and [2][kWC][Q], [2][4][Q].
  float* cdt2 = wb + Q * Q;       // cumsum of dt
  float* ev2 = cdt2 + 2 * Q;      // e_t = exp(A cdt_t)
  float* ew2 = ev2 + 2 * Q;       // exp(A (cdt_last - cdt_i))
  float* wv2 = ew2 + 2 * Q;       // w_i
  float* rsp2 = wv2 + 2 * Q;      // row sums of R o dt by column slice
  float* crp2 = rsp2 + 2 * WC * Q;  // column sums of R by row block
  float* dep = crp2 + 8 * Q;      // [kWC][Q] dL/de_t by column slice
  float* dwp = dep + WC * Q;      // [2 kWC][Q] dL/dw_t by B Gbar's column group
  float* red = dwp + 2 * WC * Q;  // [kRed] <Gbar_c+1, S_c> by warp; exchange
  float* last2 = red + D::kRed;   // [2] cdt_last
  const int64_t c = blockIdx.x, b = blockIdx.y, t0 = c * Q, nc = gridDim.x;
  const int64_t pieces = heads * PC;
  const int valid = static_cast<int>(seq - t0 < Q ? seq - t0 : Q);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int rw = w / WC, cw = w % WC, r0 = 16 * rw;
  const int cq = cw * (Q / WC), ch = cw * (NH / WC);
  // B Gbar and W^T dy: row blocks pu and 3 - pu (the causal K of W^T dy,
  // 8 - 2 pu and 2 + 2 pu k steps, evens out), columns cp.. of P / (2 kWC).
  const int pu = w & 1, cp = (w >> 1) * (P / WC / 2);
  const int ru[2] = {16 * pu, 16 * (3 - pu)};
  const bool diag = cq <= r0 + 15;  // the warp's [Q x Q] tile reaches i <= t

  auto load_xy = [&](int64_t h) {
    float* st = xy + (h & 1) * D::kXY;
    load_rows_sw<P, Q, kT>(st, x + b * xsb + h * xsh + t0 * xss, xss, valid, vec_x);
    load_rows_sw<P, Q, kT>(st + Q * P, dy + b * ysb + h * ysh + t0 * yss, yss, valid, vec_y);
    load_dt<Q>(st + 2 * Q * P, dt + b * dsb + h * dsh + t0 * dss, dss, valid);
  };
  // Piece m: state rows (m % PC) kNH of head m / PC (S_c only for c > 0).
  auto load_piece = [&](int64_t m) {
    float* st = sg + (m & 1) * D::kSG;
    const int64_t o = ((b * heads + m / PC) * nc + c) * N * P + (m % PC) * NH * P;
    if (c > 0) load_rows_sw<P, NH, kT>(st, states + o, P, NH, true);
    load_rows_sw<P, NH, kT>(st + NH * P, dstates + o, P, NH, true);
  };
  // Commit groups: B, C and head 0's x, dy, dt; piece 0; piece 1; then, as
  // each piece m is read, piece m + 2, after head h's first piece preceded
  // by head h + 1's x, dy, dt (empty past the end).  A head's first piece
  // and its x, dy, dt have landed with one group pending, a second piece
  // with two.
  load_rows_sw<N, Q, kT>(cs, Cm + b * csb + t0 * css, css, valid, vec_bc);
  load_rows_sw<N, Q, kT>(bs, Bm + b * bsb + t0 * bss, bss, valid, vec_bc);
  load_xy(0);
  cp_async_commit();
  load_piece(0);
  cp_async_commit();
  if (pieces > 1) load_piece(1);
  cp_async_commit();
  cp_async_wait<2>();
  __syncthreads();

  // G = C B^T on the warp's [Q x Q] tile, and sum_h dG there.
  float gr[TQ][4], sdg[TQ][4];
  zero(gr);
  zero(sdg);
  if (diag) mma3<N / 8>(gr, 0, N / 8, RowA<N>(cs, r0, 0), RowB<N, TQ>(bs, cq, 0));
  float accB[PC][TH][4], accC[PC][TH][4];
#pragma unroll
  for (int k = 0; k < PC; ++k) {
    zero(accB[k]);
    zero(accC[k]);
  }

  // Head hp's per-step scalars on warps kSW0 (steps 0-31) and kSW1 (32-63),
  // synchronised with each other only (named barrier 1): the segment sums'
  // row and column terms, the carry's, the chunk state's; dL/dcdt_j and its
  // reverse cumsum, ddt, and dA's part.
  auto finish = [&](int64_t hp) {
    const int par = static_cast<int>(hp & 1), hi = w == kSW1;
    const int j = 32 * hi + lane;
    const float a = A[hp], last = last2[par];
    const float* cdt = cdt2 + par * Q;
    const float* dts = xy + (hp & 1) * D::kXY + 2 * Q * P;
    float rs = 0.f, cr = 0.f, dev = 0.f, dw = 0.f;
#pragma unroll
    for (int u = 0; u < WC; ++u) {
      rs += rsp2[(par * WC + u) * Q + j];
      dev += dep[u * Q + j];
    }
#pragma unroll
    for (int u = 0; u < 2 * WC; ++u) dw += dwp[u * Q + j];
#pragma unroll
    for (int u = 0; u < 4; ++u) cr += crp2[(par * 4 + u) * Q + j];
    const float cl = cr * dts[j];
    const float zc = dev * ev2[par * Q + j], zw = dw * wv2[par * Q + j];
    float dc = a * (rs - cl + zc - zw);
    const float direct = cr + dw * ew2[par * Q + j];
    const float zws = warp_sum(zw);
    const float das = warp_sum((rs - cl + zc) * cdt[j] + zw * (last - cdt[j]));
    float* xch = red + D::kWarps;  // [5]
    if (lane == 0) {
      xch[2 * hi] = zws;
      xch[2 * hi + 1] = das;
    }
    asm volatile("bar.sync 1, 64;" ::: "memory");
    float dsum = 0.f;
#pragma unroll
    for (int u = 0; u < D::kWarps; ++u) dsum += red[u];
    const float zd = dsum * expf(a * last);
    const int64_t bhp = b * heads + hp;
    if (j == Q - 1) dc += a * (xch[0] + xch[2] + zd);
    if (j == 0) dA_part[bhp * nc + c] = xch[1] + xch[3] + zd * last;
    // Reverse inclusive cumsum of dc over the 64 steps.
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_down_sync(0xffffffffu, dc, off);
      if (lane + off < 32) dc += u;
    }
    if (hi && lane == 0) xch[4] = dc;
    asm volatile("bar.sync 1, 64;" ::: "memory");
    if (!hi) dc += xch[4];
    if (j < valid) ddt[bhp * seq + t0 + j] = direct + dc;
  };

  for (int64_t h = 0; h < heads; ++h) {
    const float a = A[h];
    const float* xs = xy + (h & 1) * D::kXY;
    const float* ys = xs + Q * P;
    const float* dts = ys + Q * P;
    const int par = static_cast<int>(h & 1);
    float* cdt = cdt2 + par * Q;
    float* ev = ev2 + par * Q;
    float* ew = ew2 + par * Q;
    float* wv = wv2 + par * Q;
    float* rsp = rsp2 + par * WC * Q;
    float* crp = crp2 + par * 4 * Q;
    cp_async_wait<1>();  // piece h PC, and so this head's x, dy, dt
    __syncthreads();
    if (w == 0) {
      const float l = chunk_cumsum<Q>(dts, cdt);
      __syncwarp();
      for (int i = lane; i < Q; i += 32) {
        ev[i] = __expf(a * cdt[i]);
        ew[i] = __expf(a * (l - cdt[i]));
        wv[i] = ew[i] * dts[i];
      }
      if (lane == 0) last2[par] = l;
    }
    __syncthreads();
    // The previous head's per-step scalars, on two warps that dy x^T leaves
    // idle, beside this head's products.
    if (h > 0 && (w == kSW0 || w == kSW1)) finish(h - 1);

    // DM = (dy x^T) o M, masked before the exp; its epilogue writes W = G o
    // M o dt (causal) into wb, adds dG = DM o dt into sum_h dG, and leaves
    // the row sums of R o dt and the column sums of R, R = DM o G.
    {
      float rs[2] = {0.f, 0.f}, cr[TQ][2];
#pragma unroll
      for (int j = 0; j < TQ; ++j) cr[j][0] = cr[j][1] = 0.f;
      if (diag) {
        float acc[TQ][4];
        zero(acc);
        // Tiles past the diagonal (cq + 8 j > r0 + 15) stay zero.
        mma3<P / 8>(acc, 0, P / 8, RowA<P>(ys, r0, 0), RowB<P, TQ>(xs, cq, 0),
                    (r0 + 15 - cq) / 8 + 1);
        float2 ci[TQ], di[TQ];  // cdt_i and dt_i of the lane's columns
#pragma unroll
        for (int j = 0; j < TQ; ++j) {
          ci[j] = *reinterpret_cast<const float2*>(cdt + cq + 8 * j + 2 * q);
          di[j] = *reinterpret_cast<const float2*>(dts + cq + 8 * j + 2 * q);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = r0 + g + 8 * hh;
          const float ct = cdt[t];
#pragma unroll
          for (int j = 0; j < TQ; ++j) {
            if (cq + 8 * j > r0 + 15) continue;  // past the diagonal: never read
            float wo[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = cq + 8 * j + 2 * q + e;
              const float dti = e ? di[j].y : di[j].x;
              const float mv = i <= t ? __expf(a * (ct - (e ? ci[j].y : ci[j].x))) : 0.f;
              const float dm = acc[j][2 * hh + e] * mv, gv = gr[j][2 * hh + e];
              const float r = dm * gv;
              wo[e] = gv * mv * dti;
              sdg[j][2 * hh + e] += dm * dti;
              rs[hh] += r * dti;
              cr[j][e] += r;
            }
            *reinterpret_cast<float2*>(wb + swz<Q>(t, cq + 8 * j + 2 * q)) =
                make_float2(wo[0], wo[1]);
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
        rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
      }
      if (q == 0) {
        rsp[cw * Q + r0 + g] = rs[0];
        rsp[cw * Q + r0 + g + 8] = rs[1];
      }
#pragma unroll
      for (int j = 0; j < TQ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = cr[j][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) crp[rw * Q + cq + 8 * j + 2 * q + e] = v;
        }
    }

    // The pieces of S_c and Gbar_c+1: T = dy S^T (de_t = C_t . T_t, dC +=
    // e o T), U += B Gbar (K over the piece's rows), dB += (w o x) Gbar^T,
    // and <Gbar_c+1, S_c>, the decay's gradient.
    float de[2] = {0.f, 0.f}, dd = 0.f, U[2][TP][4];
    zero(U[0]);
    zero(U[1]);
    const float w0 = wv[r0 + g], w1 = wv[r0 + g + 8];
#pragma unroll
    for (int k = 0; k < PC; ++k) {
      const int64_t m = h * PC + k;
      if (k > 0) {
        cp_async_wait<2>();
        __syncthreads();
      }
      const float* sp = sg + (m & 1) * D::kSG;
      const float* gp = sp + NH * P;
      if (c > 0) {
        float T[TH][4];
        zero(T);
        mma3<P / 8>(T, 0, P / 8, RowA<P>(ys, r0, 0), RowB<P, TH>(sp, ch, 0));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = r0 + g + 8 * hh;
          const float f = ev[t];
#pragma unroll
          for (int j = 0; j < TH; ++j) {
            const float2 cv =
                *reinterpret_cast<const float2*>(cs + swz<N>(t, k * NH + ch + 8 * j + 2 * q));
            de[hh] += cv.x * T[j][2 * hh] + cv.y * T[j][2 * hh + 1];
            accC[k][j][2 * hh] += f * T[j][2 * hh];
            accC[k][j][2 * hh + 1] += f * T[j][2 * hh + 1];
          }
        }
        for (int e = threadIdx.x; e < NH * P; e += blockDim.x) dd += gp[e] * sp[e];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mma3<NH / 8>(U[mt], 0, NH / 8, RowA<N>(bs, ru[mt], k * NH), ColB<P, TP>(gp, cp));
      RowA<P> xw(xs, r0, 0);
      xw.w0 = w0;
      xw.w1 = w1;
      mma3<P / 8>(accB[k], 0, P / 8, xw, RowB<P, TH>(gp, ch, 0));
      __syncthreads();  // piece m is read: its slot takes piece m + 2
      if (k == 0) {  // the previous head's x, dy and dt are read (finish() too)
        if (h + 1 < heads) load_xy(h + 1);
        cp_async_commit();
      }
      if (m + 2 < pieces) load_piece(m + 2);
      cp_async_commit();
    }

    // de_t by column slice; dw_t = x_t . U_t by column group.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float dv = de[hh];
      dv += __shfl_xor_sync(0xffffffffu, dv, 1);
      dv += __shfl_xor_sync(0xffffffffu, dv, 2);
      if (q == 0) dep[cw * Q + r0 + g + 8 * hh] = dv;
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = ru[mt] + g + 8 * hh;
        float dw = 0.f;
#pragma unroll
        for (int j = 0; j < TP; ++j) {
          const float2 xv = *reinterpret_cast<const float2*>(xs + swz<P>(t, cp + 8 * j + 2 * q));
          dw += xv.x * U[mt][j][2 * hh] + xv.y * U[mt][j][2 * hh + 1];
        }
        dw += __shfl_xor_sync(0xffffffffu, dw, 1);
        dw += __shfl_xor_sync(0xffffffffu, dw, 2);
        if (q == 0) dwp[(w >> 1) * Q + t] = dw;
      }
    }
    // dx = W^T dy + w o U over the causal half of K.
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float acc[TP][4];
      zero(acc);
      mma3<Q / 8>(acc, ru[mt] / 8, Q / 8, ColA<Q>(wb, ru[mt]), ColB<P, TP>(ys, cp));
      const float f0 = wv[ru[mt] + g], f1 = wv[ru[mt] + g + 8];
#pragma unroll
      for (int j = 0; j < TP; ++j) {
        acc[j][0] += f0 * U[mt][j][0];
        acc[j][1] += f0 * U[mt][j][1];
        acc[j][2] += f1 * U[mt][j][2];
        acc[j][3] += f1 * U[mt][j][3];
      }
      store_acc(acc, dx + b * xdsb + h * xdsh + t0 * xdss, xdss, ru[mt], cp, valid);
    }
    dd = warp_sum(dd);
    if (lane == 0) red[w] = dd;
  }
  __syncthreads();  // the last head's partial sums are complete
  if (w == kSW0 || w == kSW1) finish(heads - 1);

  // dC += (sum_h dG) B and dB += (sum_h dG)^T C over the causal half of K.
  if (diag) store_acc_sw<Q>(sdg, wb, r0, cq);  // wb's last reader, W^T dy, is done
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PC; ++k) {
    mma3<Q / 8>(accC[k], 0, r0 / 8 + 2, RowA<Q>(wb, r0, 0), ColB<N, TH>(bs, k * NH + ch));
    mma3<Q / 8>(accB[k], r0 / 8, Q / 8, ColA<Q>(wb, r0), ColB<N, TH>(cs, k * NH + ch));
    store_acc(accB[k], dB + (b * seq + t0) * N, N, r0, k * NH + ch, valid);
    store_acc(accC[k], dC + (b * seq + t0) * N, N, r0, k * NH + ch, valid);
  }
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
