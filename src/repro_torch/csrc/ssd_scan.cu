// Mamba-2 SSD scan for Hopper (sm_90a), chunk-parallel on the tensor cores.
//
// Replaces the TPU kernel ssd_scan_chunked
// (src/repro/kernels/ssd_scan/ssd_scan.py:78, body _ssd_kernel :27).  Per
// (batch b, head h), with state S [N, P]:
//
//     S_t = exp(A dt_t) S_{t-1} + dt_t B_t (x) x_t,     y_t = C_t . S_t
//
// Besides y it writes the final state S_fin [B, H, N, P], which the model's
// prefill keeps in its cache (the TPU kernel drops its scratch state).
//
// Design: the SSD decomposition (arXiv:2405.21060 sections 6-7) over chunks
// of Q steps (Q 64; 128 is built too, see scripts/radix_ssd_tiles.py),
// nc = ceil(S / Q), cdt = cumsum(dt) within a chunk, in three launches:
//   1. ssd_gram, grid (chunk, batch): G = C B^T [Q, Q] once per (batch,
//      chunk), shared by every head (B and C have no head axis).
//   2-3. ssd_states, grid (N / 64, head, batch): the chunk states and the
//      state passing in one block per 64 state rows of a (batch, head).  It
//      walks the chunks in order with the state in its MMA accumulators:
//      S_0 = 0, S_c+1 = exp(A cdt_last) S_c + dS_c, where the chunk's own
//      state dS_c[n, p] = sum_i B[i, n] (exp(A (cdt_last - cdt_i)) dt_i
//      x[i, p]) is an [N x Q] . [Q x P] product added onto the decayed
//      state.  It writes each S_c for phase 4, and S_fin; the next chunk's
//      B, x and dt are copied in (cp.async, double-buffered) while this one
//      is computed.  A separate pass kernel over the chunk states, as first
//      built, read and wrote them once more and cost a quarter of the scan
//      (PERF.md).
//   4. ssd_output, grid (chunk, head, batch):
//      y[t, p] = sum_{i<=t} W[t, i] x[i, p] + exp(A cdt_t) sum_n C[t, n]
//      S_c[n, p] with W[t, i] = G[t, i] exp(A (cdt_t - cdt_i)) dt_i (i > t
//      masked before the exp, whose argument is positive there): a
//      [Q x N] . [N x P] product whose accumulator rows are then scaled by
//      exp(A cdt_t), and a [Q x Q] . [Q x P] product added into the same
//      accumulator, W built from G as its fragments are read.
// Every product runs on mma.sync m16n8k8 TF32 as 3xTF32: each operand a is
// split into hi = tf32(a) and lo = tf32(a - hi), both rounded to nearest as
// cvt.rna rounds (by integer operations), and lo.hi + hi.lo + hi.hi go into
// the fp32 accumulator (lo.lo, about 2^-22 of the product, is dropped).  One
// TF32 pass errs by 2^-11 of each operand, which the card's 1e-4 (1 + |plain|)
// check does not hold at K = 128; three hold it (tests/test_torch_ssd_scan.py
// models both).  Each warp owns 16 rows of an output tile; operand tiles
// reach shared memory by cp.async (16-byte copies when every row is 16-byte
// aligned, else 4-byte ones) into rows padded so that the fragment loads are
// free of bank conflicts.  Steps past the sequence's end load as zeros with
// dt = 0 (the identity transition, as the JAX wrapper's padding is), and
// their y is not written.  x, dt, B, C and y are addressed with element
// strides (last dim contiguous), so the model's x [B, S, H, P] and B, C
// (column slices of one projection) go in as views.  Scratch, from the
// wrapper: G [B, nc, Q, Q] and the states before each chunk [B, H, nc, N, P].
//
// Types.  x, dt, A, B and C are each float32, bfloat16 or float16, read as
// they lie and converted to float32 where they land in shared memory
// (float_kinds.cuh; a narrow operand by plain loads, float32 by cp.async);
// every product and sum is the float32 one above.  y is written in x's type
// (rounded to nearest even once, as the TPU kernel's y_ref store rounds);
// S_fin, G and the chunk states stay float32, as the TPU kernel's state
// scratch is.  A bf16 or fp16 operand is exact in TF32, so its products
// could take one TF32 term instead of three: later work.
//
// Bound.  The function reads x, dt, B, C (B and C once per batch) and writes
// y and S_fin; it needs the recurrence's 4 N P operations a step and head.
// At mamba2-130m's prefill (B 8, H 24, S 1024, P 64, N 128) that is 115 MB,
// 34 us at 3.35 TB/s, and 6.4 GFLOP, which 3xTF32 does at a third of dense
// TF32's 494.7 TFLOP/s: 39 us, so operations bound it.  This design does the
// chunked form's ~1.3x as many operations (three MMAs each) and writes the
// chunk states (B H nc N P fp32: 100 MB at Q 64) and reads them back once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "float_kinds.cuh"
#include "ssd_common.cuh"

namespace {

// rows x L narrow elements from src (row stride rs) into the float rows of
// dst (row stride DS), zero past `valid`: kBatch loads a thread in flight
// (Raw bits), then converted and stored.  Not inlined: one copy a type, for
// every tile shape (the build's time).
template <typename T>
__device__ __noinline__ void load_rows_t(float* dst, const T* src, int64_t rs, int rows,
                                         int valid, int L, int DS) {
  constexpr int kBatch = 16;
  const int total = rows * L;
  for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * blockDim.x) {
    typename Raw<T>::type v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * blockDim.x, r = e / L;
      v[j] = e < total && r < valid ? load_raw(src + r * rs + e % L) : 0;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * blockDim.x;
      if (e < total) dst[(e / L) * DS + e % L] = to_float<T>(v[j]);
    }
  }
}

// rows x L elements of kind `kind` from src (row stride rs) into the float
// rows of dst (row stride DS), zero past `valid`: float32 by load_rows's
// cp.async copies, a narrow kind by loads converted to float32.
template <int L, int DS>
__device__ __forceinline__ void load_rows_k(float* dst, const void* src, int kind, int64_t rs,
                                            int rows, int valid, bool vec) {
  if (kind == kFp32)
    load_rows<L, DS>(dst, static_cast<const float*>(src), rs, rows, valid, vec);
  else if (kind == kBf16)
    load_rows_t(dst, static_cast<const __nv_bfloat16*>(src), rs, rows, valid, L, DS);
  else
    load_rows_t(dst, static_cast<const __half*>(src), rs, rows, valid, L, DS);
}

// The chunk's dt (0 past `valid`), as load_dt takes it, of kind `kind`.
template <int Q>
__device__ __forceinline__ void load_dt_k(float* dts, const void* dt, int kind, int64_t ds,
                                          int valid) {
  if (kind == kFp32) {
    load_dt<Q>(dts, static_cast<const float*>(dt), ds, valid);
    return;
  }
  for (int t = threadIdx.x; t < Q; t += blockDim.x)
    dts[t] = t < valid ? load_kind(dt, t * ds, kind) : 0.f;
}

// store_acc into y of kind `kind` at element offset off, rounding a narrow
// kind to nearest even.
template <int NT>
__device__ __forceinline__ void store_acc_k(const float (&acc)[NT][4], void* y, int kind,
                                            int64_t off, int64_t rs, int r0, int c0, int rows) {
  if (kind == kFp32) {
    store_acc(acc, static_cast<float*>(y) + off, rs, r0, c0, rows);
    return;
  }
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= rows) continue;
    const int64_t o = off + r * rs + c0 + 2 * q;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (kind == kBf16)
          store_f(static_cast<__nv_bfloat16*>(y) + o + 8 * j + e, acc[j][2 * h + e]);
        else
          store_f(static_cast<__half*>(y) + o + 8 * j + e, acc[j][2 * h + e]);
      }
  }
}

// The float kinds of the operands: x (and y), dt, A, B, C.
struct Kinds {
  int x, dt, a, b, c;
};

// Padded shared row strides: A-side tiles read (row g, col q) want a stride
// of 4 mod 32 words, B-side tiles read (row q, col g) 8 mod 32.
template <int Q, int N, int P>
struct Dims {
  static constexpr int kRB = N < 64 ? N : 64;  // state rows a states block owns
  static constexpr int kCS = N + 4;   // C (and B in the gram) [Q][N]
  static constexpr int kBS = kRB + 8; // B's columns of the block, as A = B^T
  static constexpr int kXS = P + 8;   // x [Q][P], S [N][P]
  static constexpr int kWS = Q + 4;   // G [Q][Q]
  static constexpr int kGramThreads = 32 * (Q / 16) * 2;
  static constexpr int kStateThreads = 32 * (kRB / 16);
  static constexpr int kOutThreads = 32 * (Q / 16) * 2;
  static constexpr int kGramSmem = 2 * Q * kCS;
  static constexpr int kStage = Q * kBS + Q * kXS + Q;  // B, x, dt of a chunk
  static constexpr int kStateSmem = 2 * kStage + 2 * Q + 32;
  static constexpr int kOutSmem = Q * kWS + Q * kCS + Q * kXS + N * kXS + 3 * Q;
};

// 1. G[b, c] = C_c B_c^T.  Warp w: rows 16 (w / 2), columns (w % 2) Q / 2.
template <int Q, int N>
__global__ void __launch_bounds__(Dims<Q, N, 16>::kGramThreads)
ssd_gram(const void* __restrict__ Bm, int64_t bsb, int64_t bss, const void* __restrict__ Cm,
         int64_t csb, int64_t css, float* __restrict__ G, int64_t seq, bool vec, Kinds kd) {
  using D = Dims<Q, N, 16>;
  constexpr int NT = Q / 16;
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;               // [Q][kCS]
  float* bs = cs + Q * D::kCS;    // [Q][kCS]
  const int64_t c = blockIdx.x, b = blockIdx.y, t0 = c * Q;
  const int valid = static_cast<int>(seq - t0 < Q ? seq - t0 : Q);
  load_rows_k<N, D::kCS>(cs, offset_kind(Cm, b * csb + t0 * css, kd.c), kd.c, css, Q, valid,
                         vec);
  load_rows_k<N, D::kCS>(bs, offset_kind(Bm, b * bsb + t0 * bss, kd.b), kd.b, bss, Q, valid,
                         vec);
  cp_async_wait_all();
  __syncthreads();
  const int w = threadIdx.x >> 5, r0 = 16 * (w >> 1), c0 = (w & 1) * (Q / 2);
  float acc[NT][4];
  zero(acc);
  warp_mma(acc, N / 8, [&](int m, int k) { return cs[(r0 + m) * D::kCS + k]; },
           [&](int k, int n) { return bs[(c0 + n) * D::kCS + k]; });
  store_acc(acc, G + (b * gridDim.x + c) * Q * Q, Q, r0, c0, Q);
}

// 2-3. Chunk states and state passing, grid (N / kRB, head, batch): the block
// owns kRB rows of one (batch, head)'s state, walks the chunks in order and
// keeps the state in its MMA accumulators: for each chunk it writes the state
// before the chunk, S_c, then S_c+1 = exp(A cdt_last) S_c + B^T (w x) with
// w_i = exp(A (cdt_last - cdt_i)) dt_i; last it writes S_fin.  The next
// chunk's B, x and dt are copied in while this one is computed.  Warp w:
// state rows 16 w of the block's, all P columns.
template <int Q, int N, int P>
__global__ void __launch_bounds__(Dims<Q, N, P>::kStateThreads)
ssd_states(const void* __restrict__ x, int64_t xsb, int64_t xsh, int64_t xss,
           const void* __restrict__ dt, int64_t dsb, int64_t dsh, int64_t dss,
           const void* __restrict__ A, const void* __restrict__ Bm, int64_t bsb,
           int64_t bss, float* __restrict__ states, float* __restrict__ s_fin, int64_t seq,
           bool vec, Kinds kd) {
  using D = Dims<Q, N, P>;
  constexpr int NT = P / 8;
  extern __shared__ __align__(16) float smem[];
  float* cdt = smem + 2 * D::kStage;  // [Q]
  float* wts = cdt + Q;               // [Q]
  float* dec = wts + Q;               // [1]
  const int64_t rb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int64_t heads = gridDim.y;
  const int64_t nc = (seq + Q - 1) / Q;
  const float a = load_kind(A, h, kd.a);
  const int64_t xb = b * xsb + h * xsh;
  const int64_t db = b * dsb + h * dsh;
  const int64_t bb = b * bsb + rb * D::kRB;
  auto stage = [&](int64_t c) { return smem + (c & 1) * D::kStage; };
  auto load = [&](int64_t c) {
    float* st = stage(c);
    const int64_t t0 = c * Q;
    const int valid = static_cast<int>(seq - t0 < Q ? seq - t0 : Q);
    load_rows_k<D::kRB, D::kBS>(st, offset_kind(Bm, bb + t0 * bss, kd.b), kd.b, bss, Q, valid,
                                vec);
    load_rows_k<P, D::kXS>(st + Q * D::kBS, offset_kind(x, xb + t0 * xss, kd.x), kd.x, xss, Q,
                           valid, vec);
    load_dt_k<Q>(st + Q * D::kBS + Q * D::kXS, offset_kind(dt, db + t0 * dss, kd.dt), kd.dt, dss,
                 valid);
  };
  const int r0 = 16 * (threadIdx.x >> 5);
  float* sb = states + ((b * heads + h) * nc * N + rb * D::kRB) * P;
  float acc[NT][4];
  zero(acc);
  if (nc > 0) load(0);
  cp_async_commit();
  for (int64_t c = 0; c < nc; ++c) {
    if (c + 1 < nc) load(c + 1);
    cp_async_commit();
    cp_async_wait<1>();  // chunk c has landed
    __syncthreads();
    const float* bs = stage(c);
    const float* xs = bs + Q * D::kBS;
    const float* dts = xs + Q * D::kXS;
    if (threadIdx.x < 32) {
      const float last = chunk_cumsum<Q>(dts, cdt);
      for (int i = threadIdx.x; i < Q; i += 32) wts[i] = expf(a * (last - cdt[i])) * dts[i];
      if (threadIdx.x == 0) dec[0] = expf(a * last);
    }
    if (c > 0) store_acc(acc, sb + c * N * P, P, r0, 0, D::kRB);  // S_c
    __syncthreads();
    const float f = dec[0];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= f;
    warp_mma(acc, Q / 8, [&](int m, int k) { return bs[k * D::kBS + r0 + m]; },
             [&](int k, int n) { return xs[k * D::kXS + n] * wts[k]; });
    __syncthreads();  // stage c is free for chunk c + 2
  }
  store_acc(acc, s_fin + ((b * heads + h) * N + rb * D::kRB) * P, P, r0, 0, D::kRB);
}

// 4. y of the chunk.  Warp w: rows 16 (w / 2), columns (w % 2) P / 2.  The
// carry C S_c goes into the accumulator first and its rows are scaled by
// exp(A cdt_t); then W x is added, W built from G as the fragments are read.
template <int Q, int N, int P>
__global__ void __launch_bounds__(Dims<Q, N, P>::kOutThreads)
ssd_output(const void* __restrict__ x, int64_t xsb, int64_t xsh, int64_t xss,
           const void* __restrict__ dt, int64_t dsb, int64_t dsh, int64_t dss,
           const void* __restrict__ A, const void* __restrict__ Cm, int64_t csb,
           int64_t css, const float* __restrict__ G, const float* __restrict__ states,
           void* __restrict__ y, int64_t ysb, int64_t ysh, int64_t yss, int64_t seq,
           bool vec, Kinds kd) {
  using D = Dims<Q, N, P>;
  constexpr int NT = P / 16;
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;              // [Q][kWS]
  float* cs = gs + Q * D::kWS;   // [Q][kCS]
  float* xs = cs + Q * D::kCS;   // [Q][kXS]
  float* ss = xs + Q * D::kXS;   // [N][kXS]: the state before the chunk
  float* dts = ss + N * D::kXS;  // [Q]
  float* cdt = dts + Q;          // [Q]
  float* dec = cdt + Q;          // [Q] exp(A cdt_t)
  const int64_t c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t0 = c * Q;
  const int64_t nc = gridDim.x, heads = gridDim.y;
  const int valid = static_cast<int>(seq - t0 < Q ? seq - t0 : Q);
  load_rows<Q, D::kWS>(gs, G + (b * nc + c) * Q * Q, Q, Q, Q, true);
  load_rows_k<P, D::kXS>(xs, offset_kind(x, b * xsb + h * xsh + t0 * xss, kd.x), kd.x, xss, Q,
                         valid, vec);
  load_dt_k<Q>(dts, offset_kind(dt, b * dsb + h * dsh + t0 * dss, kd.dt), kd.dt, dss, valid);
  if (c > 0) {
    load_rows_k<N, D::kCS>(cs, offset_kind(Cm, b * csb + t0 * css, kd.c), kd.c, css, Q, valid,
                           vec);
    load_rows<P, D::kXS>(ss, states + ((b * heads + h) * nc + c) * N * P, P, N, N, true);
  }
  const float a = load_kind(A, h, kd.a);
  cp_async_wait_all();
  __syncthreads();
  if (threadIdx.x < 32) chunk_cumsum<Q>(dts, cdt);
  __syncthreads();
  for (int t = threadIdx.x; t < Q; t += blockDim.x) dec[t] = expf(a * cdt[t]);
  __syncthreads();
  const int w = threadIdx.x >> 5, r0 = 16 * (w >> 1), c0 = (w & 1) * (P / 2);
  const int g = (threadIdx.x & 31) >> 2;
  float acc[NT][4];
  zero(acc);
  if (c > 0) {
    warp_mma(acc, N / 8, [&](int m, int k) { return cs[(r0 + m) * D::kCS + k]; },
             [&](int k, int n) { return ss[k * D::kXS + c0 + n]; });
    const float e0 = dec[r0 + g], e1 = dec[r0 + g + 8];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= e0;
      acc[j][1] *= e0;
      acc[j][2] *= e1;
      acc[j][3] *= e1;
    }
  }
  // W[t, i] = G[t, i] exp(A (cdt_t - cdt_i)) dt_i for i <= t, else 0 (the
  // mask before the exp); keys past the warp's last row give W = 0, so the
  // product stops at i < r0 + 16.
  warp_mma(acc, r0 / 8 + 2,
           [&](int m, int k) {
             const int t = r0 + m;
             return k <= t ? gs[t * D::kWS + k] * expf(a * (cdt[t] - cdt[k])) * dts[k] : 0.f;
           },
           [&](int k, int n) { return xs[k * D::kXS + c0 + n]; });
  store_acc_k(acc, y, kd.x, b * ysb + h * ysh + t0 * yss, yss, r0, c0, valid);
}

template <int Q, int N, int P>
cudaError_t run(const void* x, int64_t xsb, int64_t xsh, int64_t xss, const void* dt,
                int64_t dsb, int64_t dsh, int64_t dss, const void* A, const void* Bm,
                int64_t bsb, int64_t bss, const void* Cm, int64_t csb, int64_t css, void* y,
                int64_t ysb, int64_t ysh, int64_t yss, float* s_fin, float* G, float* states,
                int64_t batch, int64_t heads, int64_t seq, Kinds kd, cudaStream_t st) {
  using D = Dims<Q, N, P>;
  const int64_t nc = (seq + Q - 1) / Q;
  const bool vec_bc = aligned16(Bm, bsb, bss) && aligned16(Cm, csb, css);
  const bool vec_x = vec_bc && aligned16(x, xsb, xsh, xss);
  const int gram_smem = 4 * D::kGramSmem, state_smem = 4 * D::kStateSmem;
  const int out_smem = 4 * D::kOutSmem;
  cudaError_t err;
  if ((err = allow_smem(ssd_gram<Q, N>, gram_smem)) != cudaSuccess) return err;
  if ((err = allow_smem(ssd_states<Q, N, P>, state_smem)) != cudaSuccess) return err;
  if ((err = allow_smem(ssd_output<Q, N, P>, out_smem)) != cudaSuccess) return err;
  const auto ub = static_cast<unsigned>(batch), uh = static_cast<unsigned>(heads);
  const auto uc = static_cast<unsigned>(nc);
  ssd_states<Q, N, P><<<dim3(N / D::kRB, uh, ub), D::kStateThreads, state_smem, st>>>(
      x, xsb, xsh, xss, dt, dsb, dsh, dss, A, Bm, bsb, bss, states, s_fin, seq, vec_x, kd);
  if (seq > 0) {
    ssd_gram<Q, N><<<dim3(uc, ub), D::kGramThreads, gram_smem, st>>>(Bm, bsb, bss, Cm, csb,
                                                                   css, G, seq, vec_bc, kd);
    ssd_output<Q, N, P><<<dim3(uc, uh, ub), D::kOutThreads, out_smem, st>>>(
        x, xsb, xsh, xss, dt, dsb, dsh, dss, A, Cm, csb, css, G, states, y, ysb, ysh, yss,
        seq, vec_x, kd);
  }
  return cudaGetLastError();
}

}  // namespace

// SSD scan of x [batch, heads, seq, p] with dt [batch, heads, seq], A [heads]
// and B, C [batch, seq, n], each of the FloatKind given (float32, bfloat16
// or float16) and given by pointer and element strides (last dim
// contiguous); writes y [batch, heads, seq, p] in x's kind (strided
// likewise, p even) and the final state s_fin [batch, heads, n, p] (fp32,
// contiguous).
// Scratch (contiguous fp32): g [batch, nc, q, q] and states [batch, heads,
// nc, n, p], nc = ceil(seq / q).  (n, p) is one of (16, 16), (32, 32),
// (64, 64), (128, 64); q is 64 or 128.
extern "C" int repro_ssd_scan(int64_t device, const void* x, int64_t xsb, int64_t xsh,
                              int64_t xss, const void* dt, int64_t dsb, int64_t dsh,
                              int64_t dss, const void* A, const void* Bm, int64_t bsb,
                              int64_t bss, const void* Cm, int64_t csb, int64_t css,
                              void* y, int64_t ysb, int64_t ysh, int64_t yss, void* s_fin,
                              void* g, void* states, int64_t batch,
                              int64_t heads, int64_t seq, int64_t n, int64_t p, int64_t q,
                              int64_t x_kind, int64_t dt_kind, int64_t a_kind, int64_t b_kind,
                              int64_t c_kind, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || heads <= 0) return 0;
  if (batch > 65535 || heads > 65535 || (seq + q - 1) / q > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t kinds[] = {x_kind, dt_kind, a_kind, b_kind, c_kind};
  for (const int64_t kind : kinds)
    if (kind != kFp32 && kind != kBf16 && kind != kFp16)
      return static_cast<int>(cudaErrorInvalidValue);
  const Kinds kd{static_cast<int>(x_kind), static_cast<int>(dt_kind), static_cast<int>(a_kind),
                static_cast<int>(b_kind), static_cast<int>(c_kind)};
  const auto s = static_cast<cudaStream_t>(stream);
#define REPRO_SSD(QV, NV, PV)                                                              \
  if (q == QV && n == NV && p == PV)                                                       \
    return static_cast<int>(run<QV, NV, PV>(                                               \
        x, xsb, xsh, xss, dt, dsb, dsh, dss, A, Bm, bsb, bss, Cm, csb, css, y, ysb, ysh, yss, \
        static_cast<float*>(s_fin), static_cast<float*>(g), static_cast<float*>(states),   \
        batch, heads, seq, kd, s));
  REPRO_SSD(64, 16, 16)
  REPRO_SSD(64, 32, 32)
  REPRO_SSD(64, 64, 64)
  REPRO_SSD(64, 128, 64)
  REPRO_SSD(128, 16, 16)
  REPRO_SSD(128, 32, 32)
  REPRO_SSD(128, 64, 64)
  REPRO_SSD(128, 128, 64)
#undef REPRO_SSD
  return static_cast<int>(cudaErrorInvalidValue);
}
