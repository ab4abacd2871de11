// The backward of flash attention (kernel 5b) for Hopper (sm_90a): from q, k,
// v, the forward's output o, the output's gradient do and the forward's
// per-row log-sum-exp lse, the gradients dq, dk and dv under exactly the
// forward's mask (causal, the prefix-LM mask, the sliding window, sk_valid,
// q_offset) and GQA.
//
// It replaces no TPU kernel: the JAX model calls no Pallas kernel in
// training.  Its attention is layers.attention, "the XLA twin of the Pallas
// flash kernel" (src/repro/models/layers.py:99-174, _attention_chunked), and
// its gradient is XLA's autodiff of that twin, each KV chunk's scores
// rematerialised under jax.checkpoint.  This is what the port's backward is
// held against; the forward, flash_attention.cu, replaces flash_attention_bh.
//
// Bound.  The function does five products of the score matrix's size (the
// forward's two, Q K^T and P V, are 4.29e10 FLOP for a hubert-xlarge layer at
// batch 8, 1024 frames, 16 heads of 80): 2.5 times the forward, 1.07e11 FLOP,
// 0.1086 ms at 989 TFLOP/s of bf16 tensor cores; its bytes (q, k, v, o, do,
// lse in, dq, dk, dv out: 0.17 GB) take 0.05 ms at 3.35 TB/s.
//
// FlashAttention-2's split, with no atomics, so the gradients are the same
// bits run to run:
//   1. row_dot_kernel: D_i = sum_d dO_id O_id for every query row (fp32).
//   2. the dK/dV pass: one block a (batch, KV head, tile of keys), dK and dV
//      of its keys in registers; a loop over the query rows that may see the
//      tile (every query head of the KV head's group, position-major as in
//      the forward) rebuilds S = Q K^T * scale and P = e^(S - lse) (no
//      softmax: lse holds its normaliser) and dP = dO V^T, then dS = P (dP -
//      D), dV += P^T dO and dK += dS^T Q.  A KV head's dK and dV thus sum
//      over its group's query heads inside one block.
//   3. the dQ pass: one block a (batch, KV head, tile of query rows), dQ in
//      registers; a loop over the key tiles its rows may see (the forward's
//      key range) rebuilds S, P, dP and dS and adds dS K.
// dQ and dK are scaled at the end.  Every sum is fp32; the gradients are
// written in the inputs' type.  S and dP are built in both passes: seven
// products against the function's five.
//
// bf16 and fp16 (one template, built for each): every product on the tensor
// cores (the first port's fp32 FMA ran at 16.5 TFLOP/s at head dim 80 and 2.6
// at 256, 1.2 % and 0.3 % of the bound), mma.sync m16n8k16 (16-bit in, fp32
// sums) with operands read by ldmatrix from 16-bit shared rows padded by 16
// bytes (the 8 row addresses
// of an ldmatrix fall on distinct banks), so nothing is widened or
// transposed on its way in.  The dK/dV pass computes the transposed scores,
// S^T = K Q^T and dP^T = V dO^T, with K and V as the A operand and Q and
// dO as the column-major B operand (their rows, read as the forward reads
// K), so that P^T and dS^T = P^T (dP^T - D) land in the m16n8 accumulator
// layout, which is the m16n8k16 A layout: they go straight into A
// fragments for dV += P^T dO and dK += dS^T Q, with dO and Q read by
// ldmatrix.trans as the forward reads V.  The dQ pass computes S = Q K^T
// and dP = dO V^T and adds dS K, K read by ldmatrix.trans.  The streamed
// side (Q and dO with their lse and D; K and V) arrives through a 2-stage
// ring of cp.async copies, tile j + 1 in flight while tile j is computed;
// rows and keys past the range are zero-filled (src-size 0), so nothing
// masked holds NaN.  P and dS enter their products as 16-bit hi + lo (two
// products into one fp32 sum, exact to about 2^-16 in bf16): rounded once,
// either alone takes the gradients out of the card's bf16 tolerance
// (tests/test_torch_flash_attention.py models both), so the three gradient
// products cost two units each: ten product-units in all, against the
// bound's five.  In fp16 dS is scaled by a power of two before its split
// (flash_common.cuh's scale_rows): by 2^e a row of the split operand (a query
// row in the dQ pass, a key in the dK/dV pass), e from the largest |dS| the
// row has met, so that dS, which follows the size of dO and can sit wholly
// below fp16's normal range (2^-14), keeps 22 bits; the row's sums are
// rescaled when e falls and the scale comes out before the gradient is
// rounded.  P, at most 1, is split as it is (as the forward splits it).  P = 2^(S scale log2 e - lse log2 e) in fp32, scaled after
// the product.  Only tiles that straddle the causal diagonal, the prefix,
// the window's edge, sk_valid or the rows' end compare positions; tiles no
// row sees are skipped.  wgmma, TMA and warp specialisation are later work.
//
// Head dims 16-128: dkdv_mma_kernel and dq_mma_kernel.  Each of 4 warps
// owns 16 keys of a 64-key tile (dK/dV) or 16 rows of a 64-row tile (dQ)
// over 64-row (64-key) ring tiles.  The dK/dV pass launches its key tiles
// in order (under the causal mask the first see the most rows), the dQ
// pass its row tiles last first (they see the most keys).  Head dim 128
// takes the dK/dV pass's rows 32 at a time (64 + 64 fp32 of dK and dV a
// thread beside 32 of S^T and dP^T) and reads the dQ pass's Q and dO
// fragments from shared memory at each k-step (64 fp32 of dQ beside 64 of
// S and dP); up to head dim 80 a sub-step is the whole 64-row tile and the
// dQ pass holds Q's and dO's fragments in registers.  About 104 KB of
// shared memory at head dim 128: two blocks an SM.
//
// Head dim 256 (recurrentgemma's and paligemma's): dkdv_256_kernel,
// sum_slices_kernel and dq_256_kernel.  A warp's dK and dV of 16 keys over
// 256 columns would be 256 fp32 a thread, past the register file, so a
// dK/dV block has 8 warps on 64 keys, a pair on each 16: each warp of a
// pair keeps 128 columns of dK and dV (128 fp32 a thread, as at 128),
// computes S^T and dP^T over its 128 columns of the depth, and the pair adds
// the two halves through shared memory (a + b in both warps, the same bits;
// two buffers, one named barrier for the pair a sub-step), so no product is
// repeated.  Q and dO stream in 32-row ring tiles (about 197 KB of shared
// memory, one block an SM).  The key tiles alone are too few for the card
// (recurrentgemma's call: 96 for 132 SMs, the first seeing up to 21,110
// rows and the last a few hundred), so each tile's rows are cut into row
// slices, one block each (the wrapper plans them from the SM count,
// flash_attention._bwd_slices); every batch's and head's first tiles start
// first; a slice writes fp32 partial dK and dV to scratch, and
// sum_slices_kernel adds them in slice order.  The dQ pass gives each of 8
// warps 16 rows by 256 columns of dQ (128 fp32 a thread), reads Q's and
// dO's fragments from shared memory at each k-step, and streams K and V in
// 32-key tiles, as the forward's head-dim-256 prefill does (about 198 KB,
// one block an SM).  Both were measured on the card (PERF.md) against pairs
// that repeat S^T and dP^T, and against dQ blocks of 4 and 2 warps.
//
// fp32: dkdv_kernel and dq_kernel, the first port's shared-memory FMA
// kernels (67 TFLOP/s at best, fp32 sums).  They serve the fp32 checks and
// smoke configs.  Operands sit in shared memory as fp32 in the layout each
// product reads along: Q^T, dO^T, K^T and V^T for the score products
// (float4 loads along rows and keys), Q, dO and K rows for the gradient
// products.  Rows are padded by 4 floats.

#include <math.h>

#include "flash_common.cuh"

namespace {

// Accumulator columns of a thread: D = 8 VEC NCG, column cg 8 VEC + x VEC + e
// of thread column x in [0, 8).
template <int D>
struct Cols {
  static constexpr int VEC = D % 32 == 0 ? 4 : (D % 16 == 0 ? 2 : 1);
  static constexpr int NCG = D / (8 * VEC);
};

// The score tile [rows, BK] of the 128 threads: 4 keys a thread, BK / 4
// threads along the keys, RT rows a thread.
template <int BK, int ROWS>
struct Scores {
  static constexpr int TXN = BK / 4;
  static constexpr int TYN = kThreads / TXN;
  static constexpr int RT = ROWS / TYN;
  static_assert(RT >= 1 && RT * TYN == ROWS && BK % 4 == 0, "score tile");
};

// s = A B^T and dp = dO V^T over d for a thread's RT rows and 4 keys, from
// at [D][AP] (A^T), bt [D][BP] (B^T), dot [D][AP], vt [D][BP].
template <int D, int RT, int AP, int BP>
__device__ __forceinline__ void score_products(const float* at, const float* bt,
                                               const float* dot, const float* vt, int row,
                                               int key, float (&s)[RT][4], float (&dp)[RT][4]) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float a[RT], o[RT], b[4], w[4];
    ld<RT>(at + c * AP + row, a);
    ld<RT>(dot + c * AP + row, o);
    ld<4>(bt + c * BP + key, b);
    ld<4>(vt + c * BP + key, w);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(o[i], w[j], dp[i][j]);
      }
  }
}

// Whether query row r (position q_offset + r / group) sees key kp.
__device__ __forceinline__ bool sees(int64_t pos, int64_t kp, int64_t kv_lim, int causal,
                                     int64_t window, int64_t prefix) {
  return kp < kv_lim && (!causal || kp <= causal_limit(pos, prefix)) &&
         (window <= 0 || kp > pos - window);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* dsum;
  void* dq;
  void* dk;
  void* dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int64_t batch, sq, sk, hq, hkv, group, sk_valid, q_offset, window, prefix;
  int causal, d;
  float scale;
  // bf16 and fp16 at head dim 256: the dK/dV pass's row slices, and (slices
  // > 1) its fp32 partial sums [2 (dK, dV)][slices][batch][sk][hkv][256].
  int slices;
  float* part;
};

// D_i = sum_d dO_id O_id, one warp a row (b, h, i), into dsum [batch, hq, sq].
template <typename T>
__global__ void __launch_bounds__(kThreads) row_dot_kernel(const Args a) {
  const int lane = threadIdx.x % 32;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (w >= a.batch * a.hq * a.sq) return;
  const int64_t i = w % a.sq, h = (w / a.sq) % a.hq, b = w / (a.sq * a.hq);
  const T* o = static_cast<const T*>(a.o) + b * a.os.b + i * a.os.s + h * a.os.h;
  const T* g = static_cast<const T*>(a.dout) + b * a.dos.b + i * a.dos.s + h * a.dos.h;
  float acc = 0.f;
  for (int c = lane; c < a.d; c += 32) acc = fmaf(to_f(o[c]), to_f(g[c]), acc);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) a.dsum[w] = acc;
}

// dK and dV of a tile of BK keys, over the query rows in tiles of BQ.
template <int D, int BK, int BQ>
struct KvTile {
  static constexpr int KP = BK + 4, QP = BQ + 4, DP = D + 4;
  static constexpr int KR = BK / 16;  // keys a thread of the dK/dV tile
  static constexpr size_t kSmemFloats =
      2 * D * KP + 2 * D * QP + 2 * BQ * DP + 2 * BQ * KP + 2 * BQ;
  static_assert(BK % 16 == 0, "key tile");
};

template <int D, int BK, int BQ>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Args a) {
  using L = KvTile<D, BK, BQ>;
  using C = Cols<D>;
  using S = Scores<BK, BQ>;
  constexpr int KP = L::KP, QP = L::QP, DP = L::DP, KR = L::KR;
  constexpr int VEC = C::VEC, NCG = C::NCG, RT = S::RT;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;              // [D][KP]  K^T
  float* vt = kt + D * KP;       // [D][KP]  V^T
  float* qt = vt + D * KP;       // [D][QP]  Q^T of the row tile
  float* dot = qt + D * QP;      // [D][QP]  dO^T
  float* qr = dot + D * QP;      // [BQ][DP] Q rows
  float* dor = qr + BQ * DP;     // [BQ][DP] dO rows
  float* ps = dor + BQ * DP;     // [BQ][KP] P
  float* dss = ps + BQ * KP;     // [BQ][KP] dS
  float* sl = dss + BQ * KP;     // [BQ] lse of the rows
  float* sd = sl + BQ;           // [BQ] D of the rows

  const int tid = threadIdx.x;
  const int sx = tid % S::TXN, sy = tid / S::TXN;  // score tile: keys 4 sx, rows RT sy
  const int ky = tid / 8, dx = tid % 8;            // dK/dV: keys KR ky, columns of dx
  const int64_t b = blockIdx.z, hk = blockIdx.y, k0 = static_cast<int64_t>(blockIdx.x) * BK;
  const int64_t group = a.group, rows = a.sq * group;
  const int64_t kv_lim = a.sk_valid < a.sk ? a.sk_valid : a.sk;
  const float* q = static_cast<const float*>(a.q);
  const float* g = static_cast<const float*>(a.dout);
  const float* kb = static_cast<const float*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vs.b + hk * a.vs.h;

  for (int e = tid; e < BK * D; e += kThreads) {
    const int j = e / D, c = e % D;
    const int64_t kp = k0 + j;
    kt[c * KP + j] = kp < a.sk ? kb[kp * a.ks.s + c] : 0.f;
    vt[c * KP + j] = kp < a.sk ? vb[kp * a.vs.s + c] : 0.f;
  }

  float dk[KR][NCG * VEC], dv[KR][NCG * VEC];
#pragma unroll
  for (int kk = 0; kk < KR; ++kk)
#pragma unroll
    for (int c = 0; c < NCG * VEC; ++c) dk[kk][c] = dv[kk][c] = 0.f;

  // The rows that may see a key of the tile: under the causal mask those at
  // or after its first key (every row, if that key is in the prefix); under
  // a window those before its last key plus the window.
  int64_t r_lo = 0, r_hi = k0 < kv_lim ? rows : 0;
  if (a.causal && k0 >= a.prefix) {
    const int64_t first = k0 - a.q_offset;
    r_lo = first > 0 ? first * group : 0;
  }
  if (a.window > 0) {
    const int64_t last = (k0 + BK < kv_lim ? k0 + BK : kv_lim) - 1;
    const int64_t end = last + a.window - a.q_offset;  // positions before it
    const int64_t lim = end > 0 ? end * group : 0;
    r_hi = lim < r_hi ? lim : r_hi;
  }

  for (int64_t r0 = r_lo; r0 < r_hi; r0 += BQ) {
    __syncthreads();  // the last tile's operands are no longer read
    for (int e = tid; e < BQ * D; e += kThreads) {
      const int rr = e / D, c = e % D;
      const int64_t r = r0 + rr;
      float x = 0.f, y = 0.f;
      if (r < r_hi) {
        const int64_t i = r / group, h = hk * group + r % group;
        x = q[b * a.qs.b + i * a.qs.s + h * a.qs.h + c];
        y = g[b * a.dos.b + i * a.dos.s + h * a.dos.h + c];
      }
      qt[c * QP + rr] = x;
      qr[rr * DP + c] = x;
      dot[c * QP + rr] = y;
      dor[rr * DP + c] = y;
    }
    for (int rr = tid; rr < BQ; rr += kThreads) {
      const int64_t r = r0 + rr;
      float l = INFINITY, dd = 0.f;
      if (r < r_hi) {
        const int64_t idx = (b * a.hq + hk * group + r % group) * a.sq + r / group;
        l = a.lse[idx];
        dd = a.dsum[idx];
      }
      sl[rr] = l;
      sd[rr] = dd;
    }
    __syncthreads();

    float s[RT][4], dp[RT][4];
    score_products<D, RT, QP, KP>(qt, kt, dot, vt, sy * RT, sx * 4, s, dp);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int rr = sy * RT + i;
      const int64_t r = r0 + rr;
      const int64_t pos = a.q_offset + r / group;
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = r < r_hi && sees(pos, k0 + sx * 4 + j, kv_lim, a.causal, a.window,
                                         a.prefix);
        p[j] = ok ? expf(s[i][j] * a.scale - sl[rr]) : 0.f;
        ds[j] = p[j] * (dp[i][j] - sd[rr]);
      }
      *reinterpret_cast<float4*>(ps + rr * KP + sx * 4) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(dss + rr * KP + sx * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BQ; ++j) {
      float pv[KR], dsv[KR];
      ld<KR>(ps + j * KP + ky * KR, pv);
      ld<KR>(dss + j * KP + ky * KR, dsv);
#pragma unroll
      for (int cg = 0; cg < NCG; ++cg) {
        float ov[VEC], qv[VEC];
        ld<VEC>(dor + j * DP + cg * 8 * VEC + dx * VEC, ov);
        ld<VEC>(qr + j * DP + cg * 8 * VEC + dx * VEC, qv);
#pragma unroll
        for (int kk = 0; kk < KR; ++kk)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            dv[kk][cg * VEC + e] = fmaf(pv[kk], ov[e], dv[kk][cg * VEC + e]);
            dk[kk][cg * VEC + e] = fmaf(dsv[kk], qv[e], dk[kk][cg * VEC + e]);
          }
      }
    }
  }

  float* dkb = static_cast<float*>(a.dk) + b * a.dks.b + hk * a.dks.h;
  float* dvb = static_cast<float*>(a.dv) + b * a.dvs.b + hk * a.dvs.h;
#pragma unroll
  for (int kk = 0; kk < KR; ++kk) {
    const int64_t kp = k0 + ky * KR + kk;
    if (kp >= a.sk) continue;
#pragma unroll
    for (int cg = 0; cg < NCG; ++cg)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int c = cg * 8 * VEC + dx * VEC + e;
        dkb[kp * a.dks.s + c] = dk[kk][cg * VEC + e] * a.scale;
        dvb[kp * a.dvs.s + c] = dv[kk][cg * VEC + e];
      }
  }
}

// dQ of a tile of BQ query rows, over the key tiles of BK its rows may see.
template <int D, int BQ, int BK>
struct QTile {
  static constexpr int KP = BK + 4, QP = BQ + 4, DP = D + 4;
  static constexpr int RQ = BQ / 16;  // rows a thread of the dQ tile
  static constexpr size_t kSmemFloats = 2 * D * QP + 2 * D * KP + BK * DP + BK * QP + 2 * BQ;
  static_assert(BQ % 16 == 0, "row tile");
};

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  using L = QTile<D, BQ, BK>;
  using C = Cols<D>;
  using S = Scores<BK, BQ>;
  constexpr int KP = L::KP, QP = L::QP, DP = L::DP, RQ = L::RQ;
  constexpr int VEC = C::VEC, NCG = C::NCG, RT = S::RT;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // [D][QP]  Q^T of the row tile
  float* dot = qt + D * QP;      // [D][QP]  dO^T
  float* kt = dot + D * QP;      // [D][KP]  K^T of the key tile
  float* vt = kt + D * KP;       // [D][KP]  V^T
  float* kr = vt + D * KP;       // [BK][DP] K rows
  float* dst = kr + BK * DP;     // [BK][QP] dS^T
  float* sl = dst + BK * QP;     // [BQ] lse of the rows
  float* sd = sl + BQ;           // [BQ] D of the rows

  const int tid = threadIdx.x;
  const int sx = tid % S::TXN, sy = tid / S::TXN;  // score tile: keys 4 sx, rows RT sy
  const int qy = tid / 8, dx = tid % 8;            // dQ: rows RQ qy, columns of dx
  const int64_t b = blockIdx.z, hk = blockIdx.y;
  const int64_t group = a.group, rows = a.sq * group;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * BQ;
  const int64_t r_end = r0 + BQ < rows ? r0 + BQ : rows;
  const int64_t kv_lim = a.sk_valid < a.sk ? a.sk_valid : a.sk;
  const float* q = static_cast<const float*>(a.q);
  const float* g = static_cast<const float*>(a.dout);
  const float* kb = static_cast<const float*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vs.b + hk * a.vs.h;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int rr = e / D, c = e % D;
    const int64_t r = r0 + rr;
    float x = 0.f, y = 0.f;
    if (r < rows) {
      const int64_t i = r / group, h = hk * group + r % group;
      x = q[b * a.qs.b + i * a.qs.s + h * a.qs.h + c];
      y = g[b * a.dos.b + i * a.dos.s + h * a.dos.h + c];
    }
    qt[c * QP + rr] = x;
    dot[c * QP + rr] = y;
  }
  for (int rr = tid; rr < BQ; rr += kThreads) {
    const int64_t r = r0 + rr;
    float l = INFINITY, dd = 0.f;
    if (r < rows) {
      const int64_t idx = (b * a.hq + hk * group + r % group) * a.sq + r / group;
      l = a.lse[idx];
      dd = a.dsum[idx];
    }
    sl[rr] = l;
    sd[rr] = dd;
  }

  float dq[RQ][NCG * VEC];
#pragma unroll
  for (int ii = 0; ii < RQ; ++ii)
#pragma unroll
    for (int c = 0; c < NCG * VEC; ++c) dq[ii][c] = 0.f;

  int64_t k_lo, k_hi;
  key_range<BK>(r0, r_end, 0, a.sk, a.sk, group, a.sk_valid, a.q_offset, a.causal, a.window,
                a.prefix, k_lo, k_hi);
  for (int64_t k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the last key tile and dS^T are no longer read
    for (int e = tid; e < BK * D; e += kThreads) {
      const int j = e / D, c = e % D;
      const int64_t kp = k0 + j;
      float x = 0.f, y = 0.f;
      if (kp < k_hi) {  // zeros past the range: masked keys never hold NaN
        x = kb[kp * a.ks.s + c];
        y = vb[kp * a.vs.s + c];
      }
      kt[c * KP + j] = x;
      kr[j * DP + c] = x;
      vt[c * KP + j] = y;
    }
    __syncthreads();

    float s[RT][4], dp[RT][4];
    score_products<D, RT, QP, KP>(qt, kt, dot, vt, sy * RT, sx * 4, s, dp);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int rr = sy * RT + i;
      const int64_t r = r0 + rr;
      const int64_t pos = a.q_offset + r / group;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kp = k0 + sx * 4 + j;
        const bool ok = r < rows && sees(pos, kp, kv_lim, a.causal, a.window, a.prefix);
        const float p = ok ? expf(s[i][j] * a.scale - sl[rr]) : 0.f;
        dst[(sx * 4 + j) * QP + rr] = p * (dp[i][j] - sd[rr]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dsv[RQ];
      ld<RQ>(dst + j * QP + qy * RQ, dsv);
#pragma unroll
      for (int cg = 0; cg < NCG; ++cg) {
        float kv[VEC];
        ld<VEC>(kr + j * DP + cg * 8 * VEC + dx * VEC, kv);
#pragma unroll
        for (int ii = 0; ii < RQ; ++ii)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            dq[ii][cg * VEC + e] = fmaf(dsv[ii], kv[e], dq[ii][cg * VEC + e]);
      }
    }
  }

  float* dqb = static_cast<float*>(a.dq);
#pragma unroll
  for (int ii = 0; ii < RQ; ++ii) {
    const int64_t r = r0 + qy * RQ + ii;
    if (r >= rows) continue;
    const int64_t i = r / group, h = hk * group + r % group;
    float* row = dqb + b * a.dqs.b + i * a.dqs.s + h * a.dqs.h;
#pragma unroll
    for (int cg = 0; cg < NCG; ++cg)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        row[cg * 8 * VEC + dx * VEC + e] = dq[ii][cg * VEC + e] * a.scale;
  }
}

// ---------------------------------------------------------------------------
// bf16 and fp16: tensor cores (mma.sync m16n8k16) fed by cp.async and
// ldmatrix.
// ---------------------------------------------------------------------------

// Row r of a KV head's group (position-major) is position r / group of query
// head hk group + r % group; 32-bit arithmetic (the entry takes fewer than
// 2^31 rows).
__device__ __forceinline__ int64_t row_pos(int64_t r, int64_t group) {
  return static_cast<uint32_t>(r) / static_cast<uint32_t>(group);
}
__device__ __forceinline__ int64_t row_head(int64_t r, int64_t group) {
  return static_cast<uint32_t>(r) % static_cast<uint32_t>(group);
}

// The tensor-core passes' tiles: a block's 64 keys (dK/dV) or 64 query rows
// (dQ), 16 a warp; the other side's 64-row (64-key) tiles in an NS-stage
// ring; the dK/dV pass takes a ring tile SUB rows at a time, and the dQ pass
// holds Q's and dO's fragments in registers when QREG.  Rows of 16-bit
// elements padded to RS.
template <int D>
struct BwdTile {
  static constexpr int BT = 64;
  static constexpr int NS = 2;
  static constexpr int RS = D + 8;            // 16 bytes of padding a row
  static constexpr int SUB = D <= 80 ? 64 : 32;
  static constexpr bool QREG = D <= 80;
  // K, V and the ring of Q and dO tiles with their lse and D (dK/dV pass);
  // Q, dO and the ring of K and V tiles (dQ pass).
  static constexpr size_t kSmemBytes =
      sizeof(uint16_t) * (2 + 2 * NS) * BT * RS + sizeof(float) * 2 * NS * BT;
  static_assert(D % 16 == 0 && BT * (D / 8) % kThreads == 0 && BT % SUB == 0, "tile");
};

// Whether rows [r0, r1] (positions p_lo..p_hi) see any of keys [k0, k1], and
// whether they see all of them (live: the rows exist; kv_lim: sk_valid).
__device__ __forceinline__ bool sees_none(int64_t p_lo, int64_t p_hi, int64_t k0, int64_t k1,
                                          int64_t kv_lim, int causal, int64_t window,
                                          int64_t prefix) {
  return k0 >= kv_lim || (causal && k0 > causal_limit(p_hi, prefix)) ||
         (window > 0 && k1 <= p_lo - window);
}
__device__ __forceinline__ bool sees_all(int64_t p_lo, int64_t p_hi, int64_t k0, int64_t k1,
                                         int64_t kv_lim, int causal, int64_t window,
                                         int64_t prefix) {
  return k1 < kv_lim && (!causal || k1 <= causal_limit(p_lo, prefix)) &&
         (window <= 0 || k0 > p_hi - window);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dkdv_mma_kernel(const Args a) {
  using L = BwdTile<D>;
  constexpr int BT = L::BT, NS = L::NS, RS = L::RS, SUB = L::SUB;
  constexpr int CH = D / 8;     // 16-byte chunks of a row
  constexpr int KS = D / 16;    // 16-deep steps of S^T and dP^T
  constexpr int DT = D / 8;     // 8-column tiles of dK and dV
  constexpr int NT = SUB / 8;   // 8-row tiles of a sub-step's S^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);                     // [BT][RS]
  T* sV = sK + BT * RS;                                       // [BT][RS]
  T* sQ = sV + BT * RS;                                       // [NS][BT][RS]
  T* sO = sQ + NS * BT * RS;                                  // [NS][BT][RS] dO
  float* sL = reinterpret_cast<float*>(sO + NS * BT * RS);    // [NS][BT] lse
  float* sD = sL + NS * BT;                                   // [NS][BT] D

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int64_t group = a.group, rows = a.sq * group, q_offset = a.q_offset;
  const int64_t window = a.window, prefix = a.prefix;
  const int causal = a.causal;
  // Key tiles in order: under the causal mask the first see the most rows.
  const int64_t b = blockIdx.z, hk = blockIdx.y, k0 = static_cast<int64_t>(blockIdx.x) * BT;
  const int64_t kv_lim = a.sk_valid < a.sk ? a.sk_valid : a.sk;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + hk * a.vs.h;

  // K and V (zeros from kv_lim on) go with the first row tile.
  for (int e = tid; e < BT * CH; e += kThreads) {
    const int j = e / CH, c = e % CH;
    const int64_t kp = k0 + j;
    const bool ok = kp < kv_lim;
    cp_async16(smem_addr(sK + j * RS + c * 8), ok ? kb + kp * a.ks.s + c * 8 : kb, ok);
    cp_async16(smem_addr(sV + j * RS + c * 8), ok ? vb + kp * a.vs.s + c * 8 : vb, ok);
  }

  // The rows that may see a key of the tile: under the causal mask those at
  // or after its first key (every row, if that key is in the prefix); under
  // a window those before its last key plus the window.
  int64_t r_lo = 0, r_hi = k0 < kv_lim ? rows : 0;
  if (causal && k0 >= prefix) {
    const int64_t first = k0 - q_offset;
    r_lo = first > 0 ? first * group : 0;
  }
  if (window > 0) {
    const int64_t last = (k0 + BT < kv_lim ? k0 + BT : kv_lim) - 1;
    const int64_t end = last + window - q_offset;  // positions before it
    const int64_t lim = end > 0 ? end * group : 0;
    r_hi = lim < r_hi ? lim : r_hi;
  }
  const int ntiles = r_hi > r_lo ? static_cast<int>((r_hi - r_lo + BT - 1) / BT) : 0;

  // Q and dO rows of row tile t (zeros from r_hi on), and their lse and D.
  auto load_rows = [&](int t) {
    const int64_t r0 = r_lo + static_cast<int64_t>(t) * BT;
    T* dq_s = sQ + (t % NS) * BT * RS;
    T* do_s = sO + (t % NS) * BT * RS;
#pragma unroll 4
    for (int e = tid; e < BT * CH; e += kThreads) {
      const int rr = e / CH, c = e % CH;
      const int64_t r = r0 + rr;
      const bool ok = r < r_hi;
      int64_t qo = 0, oo = 0;
      if (ok) {
        const int64_t i = row_pos(r, group), h = hk * group + row_head(r, group);
        qo = b * a.qs.b + i * a.qs.s + h * a.qs.h + c * 8;
        oo = b * a.dos.b + i * a.dos.s + h * a.dos.h + c * 8;
      }
      cp_async16(smem_addr(dq_s + rr * RS + c * 8), q + qo, ok);
      cp_async16(smem_addr(do_s + rr * RS + c * 8), dout + oo, ok);
    }
    if (tid < BT) {
      const int64_t r = r0 + tid;
      const bool ok = r < r_hi;
      const int64_t idx =
          ok ? (b * a.hq + hk * group + row_head(r, group)) * a.sq + row_pos(r, group) : 0;
      cp_async4(smem_addr(sL + (t % NS) * BT + tid), a.lse + idx, ok);
      cp_async4(smem_addr(sD + (t % NS) * BT + tid), a.dsum + idx, ok);
    }
  };
  if (ntiles > 0) load_rows(0);
  cp_async_commit();

  // The warp's keys [kw0, kw0 + 16); a thread holds keys g and g + 8 of them,
  // and (fp16) their dS^T rows' exponents.
  const int64_t kw0 = k0 + 16 * warp;
  const float sl = a.scale * kLog2e;
  [[maybe_unused]] int dse[2] = {kDsExpMax, kDsExpMax};
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[n][j] = dv[n][j] = 0.f;
  // ldmatrix row addresses: K and V as A (keys 16 warp + lane % 16, columns
  // 8 (lane / 16)); Q and dO as B (rows lane % 8 + 8 (lane / 16), columns
  // 8 ((lane / 8) % 2)); Q and dO as B, transposed (rows lane % 16, columns
  // 8 (lane / 16)).
  const uint32_t k_addr = smem_addr(sK + (16 * warp + lane % 16) * RS + (lane / 16) * 8);
  const uint32_t v_addr = smem_addr(sV + (16 * warp + lane % 16) * RS + (lane / 16) * 8);
  const int b_row = (lane % 8 + (lane / 16) * 8) * RS + ((lane / 8) % 2) * 8;
  const int t_row = (lane % 16) * RS + (lane / 16) * 8;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile t has landed for every thread; tile t - 1 is no longer read
    if (t + NS - 1 < ntiles) load_rows(t + NS - 1);
    cp_async_commit();
    const int64_t rt0 = r_lo + static_cast<int64_t>(t) * BT;
    const T* tq = sQ + (t % NS) * BT * RS;
    const T* to = sO + (t % NS) * BT * RS;
    const float* tl = sL + (t % NS) * BT;
    const float* td = sD + (t % NS) * BT;
#pragma unroll 1
    for (int s0 = 0; s0 < BT; s0 += SUB) {
      const int64_t rs0 = rt0 + s0;
      if (rs0 >= r_hi) break;
      const int64_t rs1 = (rs0 + SUB < r_hi ? rs0 + SUB : r_hi) - 1;
      const int64_t p_lo = q_offset + row_pos(rs0, group);
      const int64_t p_hi = q_offset + row_pos(rs1, group);
      // A sub-step no row of which sees a key of the warp is skipped; one
      // whose rows all see every key of the warp is not masked.
      if (sees_none(p_lo, p_hi, kw0, kw0 + 15, kv_lim, causal, window, prefix)) continue;
      const bool full = rs0 + SUB <= r_hi &&
                        sees_all(p_lo, p_hi, kw0, kw0 + 15, kv_lim, causal, window, prefix);

      // S^T = K Q^T and dP^T = V dO^T over the sub-step's rows.
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[n][j] = dpt[n][j] = 0.f;
      const uint32_t q_b = smem_addr(tq + s0 * RS + b_row);
      const uint32_t o_b = smem_addr(to + s0 * RS + b_row);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, k_addr + kk * 32);
        ldsm_x4(va, v_addr + kk * 32);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t qf[4], of[4];
          ldsm_x4(qf, q_b + (np * 16 * RS + kk * 16) * 2);
          ldsm_x4(of, o_b + (np * 16 * RS + kk * 16) * 2);
          mma16<T>(st[2 * np], ka, qf[0], qf[1]);
          mma16<T>(st[2 * np + 1], ka, qf[2], qf[3]);
          mma16<T>(dpt[2 * np], va, of[0], of[1]);
          mma16<T>(dpt[2 * np + 1], va, of[2], of[3]);
        }
      }

      // P^T = 2^(S^T scale log2 e - lse log2 e) and dS^T = P^T (dP^T - D), in
      // place.  Accumulator element j of tile n: key g + 8 (j / 2), row
      // n 8 + 2 tig + j % 2 of the sub-step.
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = s0 + n * 8 + 2 * tig;
        const float2 lv = *reinterpret_cast<const float2*>(tl + c);
        const float2 dd = *reinterpret_cast<const float2*>(td + c);
        const float l2[2] = {lv.x * kLog2e, lv.y * kLog2e};
        const float dv2[2] = {dd.x, dd.y};
        bool ok[4] = {true, true, true, true};
        if (!full) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int64_t r = rt0 + c + e;
            const int64_t pos = q_offset + row_pos(r, group);
#pragma unroll
            for (int i = 0; i < 2; ++i)
              ok[2 * i + e] = r < r_hi && sees(pos, kw0 + g + 8 * i, kv_lim, causal, window,
                                               prefix);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = ok[j] ? exp2f(fmaf(st[n][j], sl, -l2[j & 1])) : 0.f;
          dpt[n][j] = ok[j] ? p * (dpt[n][j] - dv2[j & 1]) : 0.f;
          st[n][j] = p;
        }
      }

      // dV += P^T dO and dK += dS^T Q, P^T and dS^T as hi + lo straight
      // from the accumulators (in fp16 dS^T scaled first): the A fragment of
      // rows [16 kt, 16 kt + 16) is the C fragments of 8-row tiles 2 kt and
      // 2 kt + 1.
      if constexpr (Scaled<T>::value) scale_rows(dpt, dk, dse);
      const uint32_t q_t = smem_addr(tq + s0 * RS + t_row);
      const uint32_t o_t = smem_addr(to + s0 * RS + t_row);
#pragma unroll
      for (int kt = 0; kt < SUB / 16; ++kt) {
        uint32_t ph[4], pl[4], sh[4], so[4];
        split_frag<T>(st[2 * kt], st[2 * kt + 1], ph, pl);
        split_frag<T>(dpt[2 * kt], dpt[2 * kt + 1], sh, so);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t of[4], qf[4];
          ldsm_x4_t(of, o_t + (kt * 16 * RS + dp * 16) * 2);
          ldsm_x4_t(qf, q_t + (kt * 16 * RS + dp * 16) * 2);
          mma16<T>(dv[2 * dp], ph, of[0], of[1]);
          mma16<T>(dv[2 * dp], pl, of[0], of[1]);
          mma16<T>(dv[2 * dp + 1], ph, of[2], of[3]);
          mma16<T>(dv[2 * dp + 1], pl, of[2], of[3]);
          mma16<T>(dk[2 * dp], sh, qf[0], qf[1]);
          mma16<T>(dk[2 * dp], so, qf[0], qf[1]);
          mma16<T>(dk[2 * dp + 1], sh, qf[2], qf[3]);
          mma16<T>(dk[2 * dp + 1], so, qf[2], qf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (Scaled<T>::value) unscale_rows(dk, dse);

  T* dkb = static_cast<T*>(a.dk) + b * a.dks.b + hk * a.dks.h;
  T* dvb = static_cast<T*>(a.dv) + b * a.dvs.b + hk * a.dvs.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t kp = kw0 + g + 8 * i;
    if (kp >= a.sk) continue;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<uint32_t*>(dkb + kp * a.dks.s + n * 8 + tig * 2) =
          pack2<T>(dk[n][2 * i] * a.scale, dk[n][2 * i + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + kp * a.dvs.s + n * 8 + tig * 2) =
          pack2<T>(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dq_mma_kernel(const Args a) {
  using L = BwdTile<D>;
  constexpr int BT = L::BT, NS = L::NS, RS = L::RS;
  constexpr int CH = D / 8;     // 16-byte chunks of a row
  constexpr int KS = D / 16;    // 16-deep steps of S and dP
  constexpr int DT = D / 8;     // 8-column tiles of dQ
  constexpr int NT = BT / 8;    // 8-key tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);   // [BT][RS]
  T* sO = sQ + BT * RS;                     // [BT][RS] dO
  T* sK = sO + BT * RS;                     // [NS][BT][RS]
  T* sV = sK + NS * BT * RS;                // [NS][BT][RS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int64_t group = a.group, rows = a.sq * group, q_offset = a.q_offset;
  const int64_t window = a.window;
  const int causal = a.causal;
  // Row tiles last first: under the causal mask the last see the most keys.
  const int64_t b = blockIdx.z, hk = blockIdx.y;
  const int64_t r0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * BT;
  const int64_t r_end = r0 + BT < rows ? r0 + BT : rows;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + hk * a.vs.h;
  int64_t k_lo, k_hi;
  key_range<BT>(r0, r_end, 0, a.sk, a.sk, group, a.sk_valid, q_offset, causal, window,
                a.prefix, k_lo, k_hi);
  const int ntiles = k_hi > k_lo ? static_cast<int>((k_hi - k_lo + BT - 1) / BT) : 0;

  // Q and dO (zeros past the last row) go with the first K/V stage.
  for (int e = tid; e < BT * CH; e += kThreads) {
    const int rr = e / CH, c = e % CH;
    const int64_t r = r0 + rr;
    const bool ok = r < rows;
    int64_t qo = 0, oo = 0;
    if (ok) {
      const int64_t i = row_pos(r, group), h = hk * group + row_head(r, group);
      qo = b * a.qs.b + i * a.qs.s + h * a.qs.h + c * 8;
      oo = b * a.dos.b + i * a.dos.s + h * a.dos.h + c * 8;
    }
    cp_async16(smem_addr(sQ + rr * RS + c * 8), q + qo, ok);
    cp_async16(smem_addr(sO + rr * RS + c * 8), dout + oo, ok);
  }
  auto load_kv = [&](int t) {
    const int64_t k0 = k_lo + static_cast<int64_t>(t) * BT;
    T* dk_s = sK + (t % NS) * BT * RS;
    T* dv_s = sV + (t % NS) * BT * RS;
#pragma unroll 4
    for (int e = tid; e < BT * CH; e += kThreads) {
      const int j = e / CH, c = e % CH;
      const int64_t kp = k0 + j;
      const bool ok = kp < k_hi;  // zeros past the range: masked keys never hold NaN
      cp_async16(smem_addr(dk_s + j * RS + c * 8), ok ? kb + kp * a.ks.s + c * 8 : kb, ok);
      cp_async16(smem_addr(dv_s + j * RS + c * 8), ok ? vb + kp * a.vs.s + c * 8 : vb, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < ntiles) load_kv(t);
    cp_async_commit();
  }

  // The warp's rows [wr0, wr0 + 16); a thread holds rows g and g + 8 of them,
  // with their lse (log2 units; +inf past the last row: P is 0 there) and D.
  const int64_t wr0 = r0 + 16 * warp;
  const bool live = wr0 < rows;
  const int64_t wr_last = (wr0 + 16 < rows ? wr0 + 16 : rows) - 1;
  const int64_t p_lo = q_offset + row_pos(wr0, group), p_hi = q_offset + row_pos(wr_last, group);
  int64_t pos[2], cl_row[2];
  float l2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t r = wr0 + g + 8 * i;
    pos[i] = q_offset + row_pos(r, group);
    cl_row[i] = causal_limit(pos[i], a.prefix);
    l2[i] = INFINITY;
    dd[i] = 0.f;
    if (r < rows) {
      const int64_t idx = (b * a.hq + hk * group + row_head(r, group)) * a.sq + row_pos(r, group);
      l2[i] = a.lse[idx] * kLog2e;
      dd[i] = a.dsum[idx];
    }
  }
  const float sl = a.scale * kLog2e;
  [[maybe_unused]] int dse[2] = {kDsExpMax, kDsExpMax};   // fp16: the rows' dS exponents

  float dq[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  uint32_t qf[L::QREG ? KS : 1][4], of[L::QREG ? KS : 1][4];
  // ldmatrix row addresses: Q and dO as A (rows 16 warp + lane % 16,
  // columns 8 (lane / 16)); K and V as B (keys lane % 8 + 8 (lane / 16),
  // columns 8 ((lane / 8) % 2)); K as B, transposed (keys lane % 16, columns
  // 8 (lane / 16)).
  const uint32_t q_addr = smem_addr(sQ + (16 * warp + lane % 16) * RS + (lane / 16) * 8);
  const uint32_t o_addr = smem_addr(sO + (16 * warp + lane % 16) * RS + (lane / 16) * 8);
  const int b_row = (lane % 8 + (lane / 16) * 8) * RS + ((lane / 8) % 2) * 8;
  const int t_row = (lane % 16) * RS + (lane / 16) * 8;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile t has landed for every thread; tile t - 1 is no longer read
    if (t + NS - 1 < ntiles) load_kv(t + NS - 1);
    cp_async_commit();
    if constexpr (L::QREG) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          ldsm_x4(qf[kk], q_addr + kk * 32);
          ldsm_x4(of[kk], o_addr + kk * 32);
        }
      }
    }
    const int64_t k0 = k_lo + static_cast<int64_t>(t) * BT;
    // A tile no row of the warp sees is skipped; one every row sees whole is
    // not masked.
    if (!live || sees_none(p_lo, p_hi, k0, k0 + BT - 1, k_hi, causal, window, a.prefix))
      continue;
    const bool full = sees_all(p_lo, p_hi, k0, k0 + BT - 1, k_hi, causal, window, a.prefix);
    const T* kt = sK + (t % NS) * BT * RS;
    const T* vt = sV + (t % NS) * BT * RS;

    // S = Q K^T and dP = dO V^T over the tile's keys.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = dp[n][j] = 0.f;
    const uint32_t k_b = smem_addr(kt + b_row), v_b = smem_addr(vt + b_row);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], oa[4];
      if constexpr (L::QREG) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          qa[x] = qf[kk][x];
          oa[x] = of[kk][x];
        }
      } else {
        ldsm_x4(qa, q_addr + kk * 32);
        ldsm_x4(oa, o_addr + kk * 32);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, k_b + (np * 16 * RS + kk * 16) * 2);
        ldsm_x4(vf, v_b + (np * 16 * RS + kk * 16) * 2);
        mma16<T>(s[2 * np], qa, kf[0], kf[1]);
        mma16<T>(s[2 * np + 1], qa, kf[2], kf[3]);
        mma16<T>(dp[2 * np], oa, vf[0], vf[1]);
        mma16<T>(dp[2 * np + 1], oa, vf[2], vf[3]);
      }
    }

    // The masks as key offsets within the tile: below hi; at or below the
    // row's causal limit cl; above its window limit wl.  Then P and dS = P
    // (dP - D), dS in place of S.  Element j of tile n: row g + 8 (j / 2),
    // key n 8 + 2 tig + j % 2.
    int hi = BT, cl[2] = {BT, BT}, wl[2] = {-1, -1};
    if (!full) {
      hi = k_hi - k0 < BT ? static_cast<int>(k_hi - k0) : BT;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int64_t c = cl_row[i] - k0, w = pos[i] - window - k0;
        if (causal) cl[i] = c < -1 ? -1 : (c > BT ? BT : static_cast<int>(c));
        if (window > 0) wl[i] = w < -1 ? -1 : (w > BT ? BT : static_cast<int>(w));
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = j >> 1;
        const int kp = n * 8 + tig * 2 + (j & 1);
        const bool ok = full || (kp < hi && kp <= cl[i] && kp > wl[i]);
        const float p = ok ? exp2f(fmaf(s[n][j], sl, -l2[i])) : 0.f;
        s[n][j] = ok ? p * (dp[n][j] - dd[i]) : 0.f;
      }

    // dQ += dS K, dS as hi + lo straight from the accumulators (in fp16
    // scaled first).
    if constexpr (Scaled<T>::value) scale_rows(s, dq, dse);
    const uint32_t k_t = smem_addr(kt + t_row);
#pragma unroll
    for (int kt2 = 0; kt2 < BT / 16; ++kt2) {
      uint32_t sh[4], so[4];
      split_frag<T>(s[2 * kt2], s[2 * kt2 + 1], sh, so);
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t kf[4];
        ldsm_x4_t(kf, k_t + (kt2 * 16 * RS + dp2 * 16) * 2);
        mma16<T>(dq[2 * dp2], sh, kf[0], kf[1]);
        mma16<T>(dq[2 * dp2], so, kf[0], kf[1]);
        mma16<T>(dq[2 * dp2 + 1], sh, kf[2], kf[3]);
        mma16<T>(dq[2 * dp2 + 1], so, kf[2], kf[3]);
      }
    }
  }
  cp_async_wait<0>();
  if (!live) return;
  if constexpr (Scaled<T>::value) unscale_rows(dq, dse);

  T* dqb = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t r = wr0 + g + 8 * i;
    if (r >= rows) continue;
    T* row = dqb + b * a.dqs.b + row_pos(r, group) * a.dqs.s +
             (hk * group + row_head(r, group)) * a.dqs.h;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + tig * 2) =
          pack2<T>(dq[n][2 * i] * a.scale, dq[n][2 * i + 1] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// bf16 and fp16 at head dim 256: the same products, in passes shaped for 256
// columns.
// ---------------------------------------------------------------------------

struct Tile256 {
  static constexpr int D = 256;
  static constexpr int RS = D + 8;     // 16 bytes of padding a row
  static constexpr int CH = D / 8;     // 16-byte chunks of a row
  static constexpr int NS = 2;         // stages of either pass's ring
  // dK/dV pass: 64 keys a block, 8 warps, a pair on each 16 keys, each warp
  // of a pair 128 columns of dK and dV and of the score products' depth;
  // 32-row Q and dO ring tiles.  flash_attention.py restates BK, SUB and
  // QBK for its slice plan and the tests' model of the kernel;
  // repro_flash_attention_bwd256_tile reports them so a card test holds the
  // two equal.
  static constexpr int BK = 64;
  static constexpr int KV_WARPS = 8;
  static constexpr int HALF = D / 2;
  static constexpr int SUB = 32;
  static constexpr size_t kKvSmemBytes = sizeof(uint16_t) * (2 * BK + 2 * NS * SUB) * RS +
                                         sizeof(float) * 2 * NS * SUB +
                                         sizeof(float) * 2 * KV_WARPS * 32 * 32;
  // dQ pass: 8 warps of 16 query rows, 32-key K and V ring tiles.
  static constexpr int Q_WARPS = 8;
  static constexpr int BQ = 16 * Q_WARPS;
  static constexpr int QBK = 32;
  static constexpr size_t kQSmemBytes = sizeof(uint16_t) * (2 * BQ + 2 * NS * QBK) * RS;
};

// Wait at named barrier id (1-15) until `threads` threads have reached it.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The dK/dV pass at head dim 256.  Block (key tile, batch x KV head, slice),
// the slice fastest and the key tile slowest, so the first key tiles, which
// under the causal mask see the most rows, start first in every batch and
// head.  Warp w holds keys 16 (w % 4) and columns 128 (w / 4) of dK and dV
// (64 + 64 fp32 a thread); each warp of a pair computes S^T and dP^T over
// its 128 columns of the depth and the pair adds the halves through shared
// memory (a + b in both warps: the same bits).  A slice takes a contiguous run of the tile's
// 32-row ring tiles and writes fp32 partial sums, which sum_slices_kernel
// adds in slice order; one slice writes dK and dV itself.
template <typename T>
__global__ void __launch_bounds__(32 * Tile256::KV_WARPS, 1) dkdv_256_kernel(const Args a) {
  using L = Tile256;
  constexpr int D = L::D, RS = L::RS, CH = L::CH, NS = L::NS, BK = L::BK, SUB = L::SUB;
  constexpr int NTH = 32 * L::KV_WARPS;
  constexpr int KS = L::HALF / 16;  // 16-deep steps of S^T and dP^T
  constexpr int DT = L::HALF / 8;   // 8-column tiles of dK and dV
  constexpr int NT = SUB / 8;       // 8-row tiles of S^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);                     // [BK][RS]
  T* sV = sK + BK * RS;                                       // [BK][RS]
  T* sQ = sV + BK * RS;                                       // [NS][SUB][RS]
  T* sO = sQ + NS * SUB * RS;                                 // [NS][SUB][RS] dO
  float* sL = reinterpret_cast<float*>(sO + NS * SUB * RS);   // [NS][SUB] lse
  float* sD = sL + NS * SUB;                                  // [NS][SUB] D
  float4* sX = reinterpret_cast<float4*>(sD + NS * SUB);      // [2][warps][8][32] halves

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int kq = warp % 4, c0 = (warp / 4) * L::HALF;  // keys, and columns and depth
  const int64_t group = a.group, rows = a.sq * group, q_offset = a.q_offset;
  const int64_t window = a.window, prefix = a.prefix;
  const int causal = a.causal, slices = a.slices;
  const int slice = static_cast<int>(blockIdx.x % slices);
  const int64_t rest = blockIdx.x / slices, bhs = a.batch * a.hkv;
  const int64_t b = (rest % bhs) / a.hkv, hk = rest % a.hkv, k0 = (rest / bhs) * BK;
  const int64_t kv_lim = a.sk_valid < a.sk ? a.sk_valid : a.sk;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + hk * a.vs.h;

  for (int e = tid; e < BK * CH; e += NTH) {
    const int j = e / CH, c = e % CH;
    const int64_t kp = k0 + j;
    const bool ok = kp < kv_lim;
    cp_async16(smem_addr(sK + j * RS + c * 8), ok ? kb + kp * a.ks.s + c * 8 : kb, ok);
    cp_async16(smem_addr(sV + j * RS + c * 8), ok ? vb + kp * a.vs.s + c * 8 : vb, ok);
  }

  // The rows that may see a key of the tile, as dkdv_mma_kernel finds them,
  // then the slice's share of their 32-row ring tiles.
  int64_t r_lo = 0, r_hi = k0 < kv_lim ? rows : 0;
  if (causal && k0 >= prefix) {
    const int64_t first = k0 - q_offset;
    r_lo = first > 0 ? first * group : 0;
  }
  if (window > 0) {
    const int64_t last = (k0 + BK < kv_lim ? k0 + BK : kv_lim) - 1;
    const int64_t end = last + window - q_offset;
    const int64_t lim = end > 0 ? end * group : 0;
    r_hi = lim < r_hi ? lim : r_hi;
  }
  const int64_t nsub = r_hi > r_lo ? (r_hi - r_lo + SUB - 1) / SUB : 0;
  const int64_t per = (nsub + slices - 1) / slices;
  const int64_t t_lo = slice * per < nsub ? slice * per : nsub;
  const int ntiles = static_cast<int>((t_lo + per < nsub ? t_lo + per : nsub) - t_lo);
  const int64_t r_base = r_lo + t_lo * SUB;

  auto load_rows = [&](int t) {
    const int64_t r0 = r_base + static_cast<int64_t>(t) * SUB;
    T* q_s = sQ + (t % NS) * SUB * RS;
    T* o_s = sO + (t % NS) * SUB * RS;
#pragma unroll 4
    for (int e = tid; e < SUB * CH; e += NTH) {
      const int rr = e / CH, c = e % CH;
      const int64_t r = r0 + rr;
      const bool ok = r < r_hi;
      int64_t qo = 0, oo = 0;
      if (ok) {
        const int64_t i = row_pos(r, group), h = hk * group + row_head(r, group);
        qo = b * a.qs.b + i * a.qs.s + h * a.qs.h + c * 8;
        oo = b * a.dos.b + i * a.dos.s + h * a.dos.h + c * 8;
      }
      cp_async16(smem_addr(q_s + rr * RS + c * 8), q + qo, ok);
      cp_async16(smem_addr(o_s + rr * RS + c * 8), dout + oo, ok);
    }
    if (tid < SUB) {
      const int64_t r = r0 + tid;
      const bool ok = r < r_hi;
      const int64_t idx =
          ok ? (b * a.hq + hk * group + row_head(r, group)) * a.sq + row_pos(r, group) : 0;
      cp_async4(smem_addr(sL + (t % NS) * SUB + tid), a.lse + idx, ok);
      cp_async4(smem_addr(sD + (t % NS) * SUB + tid), a.dsum + idx, ok);
    }
  };
  if (ntiles > 0) load_rows(0);
  cp_async_commit();

  const int64_t kw0 = k0 + 16 * kq;
  const float sl = a.scale * kLog2e;
  // The thread's keys kw0 + g + 8 i: below kv_lim, in the prefix; and the
  // window as a 32-bit distance (no distance between a row and a key
  // reaches 2^30).
  bool key_live[2], key_pre[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key_live[i] = kw0 + g + 8 * i < kv_lim;
    key_pre[i] = kw0 + g + 8 * i < prefix;
  }
  const int win = window < (1 << 30) ? static_cast<int>(window) : (1 << 30);
  [[maybe_unused]] int dse[2] = {kDsExpMax, kDsExpMax};   // fp16: the keys' dS^T exponents
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[n][j] = dv[n][j] = 0.f;
  // ldmatrix row addresses as in dkdv_mma_kernel, at the warp's columns.
  const uint32_t k_addr = smem_addr(sK + (16 * kq + lane % 16) * RS + (lane / 16) * 8 + c0);
  const uint32_t v_addr = smem_addr(sV + (16 * kq + lane % 16) * RS + (lane / 16) * 8 + c0);
  const int b_row = (lane % 8 + (lane / 16) * 8) * RS + ((lane / 8) % 2) * 8 + c0;
  const int t_row = (lane % 16) * RS + (lane / 16) * 8 + c0;
  int xbuf = 0;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile t has landed for every thread; tile t - 1 is no longer read
    if (t + NS - 1 < ntiles) load_rows(t + NS - 1);
    cp_async_commit();
    const int64_t rs0 = r_base + static_cast<int64_t>(t) * SUB;
    const int64_t rs1 = (rs0 + SUB < r_hi ? rs0 + SUB : r_hi) - 1;
    const int64_t p_lo = q_offset + row_pos(rs0, group);
    const int64_t p_hi = q_offset + row_pos(rs1, group);
    // Both warps of a pair hold the same keys, so they skip alike.
    if (sees_none(p_lo, p_hi, kw0, kw0 + 15, kv_lim, causal, window, prefix)) continue;
    const bool full =
        rs0 + SUB <= r_hi && sees_all(p_lo, p_hi, kw0, kw0 + 15, kv_lim, causal, window, prefix);
    const T* tq = sQ + (t % NS) * SUB * RS;
    const T* to = sO + (t % NS) * SUB * RS;
    const float* tl = sL + (t % NS) * SUB;
    const float* td = sD + (t % NS) * SUB;

    // S^T = K Q^T and dP^T = V dO^T over the warp's depth.
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[n][j] = dpt[n][j] = 0.f;
    const uint32_t q_b = smem_addr(tq + b_row);
    const uint32_t o_b = smem_addr(to + b_row);
#pragma unroll 4
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, k_addr + kk * 32);
      ldsm_x4(va, v_addr + kk * 32);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t qf[4], of[4];
        ldsm_x4(qf, q_b + (np * 16 * RS + kk * 16) * 2);
        ldsm_x4(of, o_b + (np * 16 * RS + kk * 16) * 2);
        mma16<T>(st[2 * np], ka, qf[0], qf[1]);
        mma16<T>(st[2 * np + 1], ka, qf[2], qf[3]);
        mma16<T>(dpt[2 * np], va, of[0], of[1]);
        mma16<T>(dpt[2 * np + 1], va, of[2], of[3]);
      }
    }
    // The pair's halves: each warp writes its own into this sub-step's buffer
    // and adds its partner's.  Two buffers: a warp writes one again only
    // after the next pair barrier, which its partner reaches after reading it.
    float4* mine = sX + ((xbuf * L::KV_WARPS + warp) * 8) * 32 + lane;
    const float4* theirs = sX + ((xbuf * L::KV_WARPS + (warp ^ 4)) * 8) * 32 + lane;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mine[n * 32] = make_float4(st[n][0], st[n][1], st[n][2], st[n][3]);
      mine[(NT + n) * 32] = make_float4(dpt[n][0], dpt[n][1], dpt[n][2], dpt[n][3]);
    }
    bar_sync(1 + kq, 64);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float4 s4 = theirs[n * 32], d4 = theirs[(NT + n) * 32];
      st[n][0] += s4.x; st[n][1] += s4.y; st[n][2] += s4.z; st[n][3] += s4.w;
      dpt[n][0] += d4.x; dpt[n][1] += d4.y; dpt[n][2] += d4.z; dpt[n][3] += d4.w;
    }
    xbuf ^= 1;

    // P^T and dS^T in place, as dkdv_mma_kernel forms them.
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * tig;
      const float2 lv = *reinterpret_cast<const float2*>(tl + c);
      const float2 dd = *reinterpret_cast<const float2*>(td + c);
      const float l2[2] = {lv.x * kLog2e, lv.y * kLog2e};
      const float dv2[2] = {dd.x, dd.y};
      bool ok[4] = {true, true, true, true};
      if (!full) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t r = rs0 + c + e;
          // The row's position past key kw0 + g, clamped (a key it sees is
          // within the window, so at most 2^30 away).
          int64_t dist = q_offset + row_pos(r, group) - (kw0 + g);
          dist = dist < -(1 << 30) ? -(1 << 30) : (dist > (1 << 30) ? (1 << 30) : dist);
          const int dd0 = static_cast<int>(dist);
          const bool live = r < r_hi;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int di = dd0 - 8 * i;
            ok[2 * i + e] = live && key_live[i] && (!causal || di >= 0 || key_pre[i]) &&
                            (window <= 0 || di < win);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? exp2f(fmaf(st[n][j], sl, -l2[j & 1])) : 0.f;
        dpt[n][j] = ok[j] ? p * (dpt[n][j] - dv2[j & 1]) : 0.f;
        st[n][j] = p;
      }
    }

    // dV += P^T dO and dK += dS^T Q over the warp's 128 columns, P^T and
    // dS^T as hi + lo (in fp16 dS^T scaled first: both warps of a pair hold
    // the same dS^T, so they scale alike).
    if constexpr (Scaled<T>::value) scale_rows(dpt, dk, dse);
    const uint32_t q_t = smem_addr(tq + t_row);
    const uint32_t o_t = smem_addr(to + t_row);
#pragma unroll
    for (int kt = 0; kt < SUB / 16; ++kt) {
      uint32_t ph[4], pl[4], sh[4], so[4];
      split_frag<T>(st[2 * kt], st[2 * kt + 1], ph, pl);
      split_frag<T>(dpt[2 * kt], dpt[2 * kt + 1], sh, so);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t of[4], qf[4];
        ldsm_x4_t(of, o_t + (kt * 16 * RS + dp * 16) * 2);
        ldsm_x4_t(qf, q_t + (kt * 16 * RS + dp * 16) * 2);
        mma16<T>(dv[2 * dp], ph, of[0], of[1]);
        mma16<T>(dv[2 * dp], pl, of[0], of[1]);
        mma16<T>(dv[2 * dp + 1], ph, of[2], of[3]);
        mma16<T>(dv[2 * dp + 1], pl, of[2], of[3]);
        mma16<T>(dk[2 * dp], sh, qf[0], qf[1]);
        mma16<T>(dk[2 * dp], so, qf[0], qf[1]);
        mma16<T>(dk[2 * dp + 1], sh, qf[2], qf[3]);
        mma16<T>(dk[2 * dp + 1], so, qf[2], qf[3]);
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (Scaled<T>::value) unscale_rows(dk, dse);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t kp = kw0 + g + 8 * i;
    if (kp >= a.sk) continue;
    if (slices == 1) {
      T* dkr = static_cast<T*>(a.dk) + b * a.dks.b + hk * a.dks.h + kp * a.dks.s + c0;
      T* dvr = static_cast<T*>(a.dv) + b * a.dvs.b + hk * a.dvs.h + kp * a.dvs.s + c0;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        *reinterpret_cast<uint32_t*>(dkr + n * 8 + tig * 2) =
            pack2<T>(dk[n][2 * i] * a.scale, dk[n][2 * i + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvr + n * 8 + tig * 2) =
            pack2<T>(dv[n][2 * i], dv[n][2 * i + 1]);
      }
    } else {
      const int64_t plane = a.batch * a.sk * a.hkv * D;
      float* pk = a.part + slice * plane + ((b * a.sk + kp) * a.hkv + hk) * D + c0;
      float* pv = pk + slices * plane;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        *reinterpret_cast<float2*>(pk + n * 8 + tig * 2) = make_float2(dk[n][2 * i], dk[n][2 * i + 1]);
        *reinterpret_cast<float2*>(pv + n * 8 + tig * 2) = make_float2(dv[n][2 * i], dv[n][2 * i + 1]);
      }
    }
  }
}

// dK and dV from the slices' partial sums, added in slice order (fp32), dK
// scaled, each rounded to T once; a thread 4 columns of a key.
template <typename T>
__global__ void __launch_bounds__(kThreads) sum_slices_kernel(const Args a) {
  constexpr int D = Tile256::D;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t plane = a.batch * a.sk * a.hkv * D;
  if (i * 4 >= plane) return;
  float4 k = make_float4(0.f, 0.f, 0.f, 0.f), v = k;
  for (int s = 0; s < a.slices; ++s) {
    const float4 pk = *reinterpret_cast<const float4*>(a.part + s * plane + i * 4);
    const float4 pv = *reinterpret_cast<const float4*>(a.part + (a.slices + s) * plane + i * 4);
    k.x += pk.x; k.y += pk.y; k.z += pk.z; k.w += pk.w;
    v.x += pv.x; v.y += pv.y; v.z += pv.z; v.w += pv.w;
  }
  const int64_t c = (i * 4) % D, row = (i * 4) / D;  // row: (b sk + kp) hkv + hk
  const int64_t hk = row % a.hkv, kp = (row / a.hkv) % a.sk, b = row / (a.hkv * a.sk);
  T* dkr = static_cast<T*>(a.dk) + b * a.dks.b + kp * a.dks.s + hk * a.dks.h + c;
  T* dvr = static_cast<T*>(a.dv) + b * a.dvs.b + kp * a.dvs.s + hk * a.dvs.h + c;
  reinterpret_cast<uint32_t*>(dkr)[0] = pack2<T>(k.x * a.scale, k.y * a.scale);
  reinterpret_cast<uint32_t*>(dkr)[1] = pack2<T>(k.z * a.scale, k.w * a.scale);
  reinterpret_cast<uint32_t*>(dvr)[0] = pack2<T>(v.x, v.y);
  reinterpret_cast<uint32_t*>(dvr)[1] = pack2<T>(v.z, v.w);
}

// The dQ pass at head dim 256: one block a (batch, KV head, tile of BQ query
// rows), row tiles last first; a warp's 16 rows of dQ over 256 columns in
// registers (128 fp32 a thread); Q's and dO's fragments read from shared
// memory at each k-step; K and V through the ring in 32-key tiles.
template <typename T>
__global__ void __launch_bounds__(32 * Tile256::Q_WARPS) dq_256_kernel(const Args a) {
  using L = Tile256;
  constexpr int D = L::D, RS = L::RS, CH = L::CH, NS = L::NS, BK = L::QBK;
  constexpr int BQ = L::BQ, NTH = 32 * L::Q_WARPS;
  constexpr int KS = D / 16;    // 16-deep steps of S and dP
  constexpr int DT = D / 8;     // 8-column tiles of dQ
  constexpr int NT = BK / 8;    // 8-key tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);   // [BQ][RS]
  T* sO = sQ + BQ * RS;                     // [BQ][RS] dO
  T* sK = sO + BQ * RS;                     // [NS][BK][RS]
  T* sV = sK + NS * BK * RS;                // [NS][BK][RS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int64_t group = a.group, rows = a.sq * group, q_offset = a.q_offset;
  const int64_t window = a.window;
  const int causal = a.causal;
  const int64_t b = blockIdx.z, hk = blockIdx.y;
  const int64_t r0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * BQ;
  const int64_t r_end = r0 + BQ < rows ? r0 + BQ : rows;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + hk * a.vs.h;
  int64_t k_lo, k_hi;
  key_range<BK>(r0, r_end, 0, a.sk, a.sk, group, a.sk_valid, q_offset, causal, window,
                a.prefix, k_lo, k_hi);
  const int ntiles = k_hi > k_lo ? static_cast<int>((k_hi - k_lo + BK - 1) / BK) : 0;

  for (int e = tid; e < BQ * CH; e += NTH) {
    const int rr = e / CH, c = e % CH;
    const int64_t r = r0 + rr;
    const bool ok = r < rows;
    int64_t qo = 0, oo = 0;
    if (ok) {
      const int64_t i = row_pos(r, group), h = hk * group + row_head(r, group);
      qo = b * a.qs.b + i * a.qs.s + h * a.qs.h + c * 8;
      oo = b * a.dos.b + i * a.dos.s + h * a.dos.h + c * 8;
    }
    cp_async16(smem_addr(sQ + rr * RS + c * 8), q + qo, ok);
    cp_async16(smem_addr(sO + rr * RS + c * 8), dout + oo, ok);
  }
  auto load_kv = [&](int t) {
    const int64_t k0 = k_lo + static_cast<int64_t>(t) * BK;
    T* k_s = sK + (t % NS) * BK * RS;
    T* v_s = sV + (t % NS) * BK * RS;
#pragma unroll 4
    for (int e = tid; e < BK * CH; e += NTH) {
      const int j = e / CH, c = e % CH;
      const int64_t kp = k0 + j;
      const bool ok = kp < k_hi;  // zeros past the range: masked keys never hold NaN
      cp_async16(smem_addr(k_s + j * RS + c * 8), ok ? kb + kp * a.ks.s + c * 8 : kb, ok);
      cp_async16(smem_addr(v_s + j * RS + c * 8), ok ? vb + kp * a.vs.s + c * 8 : vb, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < ntiles) load_kv(t);
    cp_async_commit();
  }

  const int64_t wr0 = r0 + 16 * warp;
  const bool live = wr0 < rows;
  const int64_t wr_last = (wr0 + 16 < rows ? wr0 + 16 : rows) - 1;
  const int64_t p_lo = q_offset + row_pos(wr0, group), p_hi = q_offset + row_pos(wr_last, group);
  // Each row's causal limit and window limit as key offsets past k_lo,
  // 32-bit (clamped: only -1 and below, or past the last tile, matter).
  int cl_rel[2], wl_rel[2];
  float l2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t r = wr0 + g + 8 * i;
    const int64_t pos = q_offset + row_pos(r, group);
    const int64_t c = causal_limit(pos, a.prefix) - k_lo, w = pos - window - k_lo;
    cl_rel[i] = c < -1 ? -1 : (c > (1 << 30) ? (1 << 30) : static_cast<int>(c));
    wl_rel[i] = w < -1 ? -1 : (w > (1 << 30) ? (1 << 30) : static_cast<int>(w));
    l2[i] = INFINITY;
    dd[i] = 0.f;
    if (r < rows) {
      const int64_t idx = (b * a.hq + hk * group + row_head(r, group)) * a.sq + row_pos(r, group);
      l2[i] = a.lse[idx] * kLog2e;
      dd[i] = a.dsum[idx];
    }
  }
  const float sl = a.scale * kLog2e;
  [[maybe_unused]] int dse[2] = {kDsExpMax, kDsExpMax};   // fp16: the rows' dS exponents

  float dq[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  // ldmatrix row addresses as in dq_mma_kernel.
  const uint32_t q_addr = smem_addr(sQ + (16 * warp + lane % 16) * RS + (lane / 16) * 8);
  const uint32_t o_addr = smem_addr(sO + (16 * warp + lane % 16) * RS + (lane / 16) * 8);
  const int b_row = (lane % 8 + (lane / 16) * 8) * RS + ((lane / 8) % 2) * 8;
  const int t_row = (lane % 16) * RS + (lane / 16) * 8;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile t has landed for every thread; tile t - 1 is no longer read
    if (t + NS - 1 < ntiles) load_kv(t + NS - 1);
    cp_async_commit();
    const int64_t k0 = k_lo + static_cast<int64_t>(t) * BK;
    if (!live || sees_none(p_lo, p_hi, k0, k0 + BK - 1, k_hi, causal, window, a.prefix))
      continue;
    const bool full = sees_all(p_lo, p_hi, k0, k0 + BK - 1, k_hi, causal, window, a.prefix);
    const T* kt = sK + (t % NS) * BK * RS;
    const T* vt = sV + (t % NS) * BK * RS;

    // S = Q K^T and dP = dO V^T over the tile's keys.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = dp[n][j] = 0.f;
    const uint32_t k_b = smem_addr(kt + b_row), v_b = smem_addr(vt + b_row);
#pragma unroll 4
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, q_addr + kk * 32);
      ldsm_x4(oa, o_addr + kk * 32);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, k_b + (np * 16 * RS + kk * 16) * 2);
        ldsm_x4(vf, v_b + (np * 16 * RS + kk * 16) * 2);
        mma16<T>(s[2 * np], qa, kf[0], kf[1]);
        mma16<T>(s[2 * np + 1], qa, kf[2], kf[3]);
        mma16<T>(dp[2 * np], oa, vf[0], vf[1]);
        mma16<T>(dp[2 * np + 1], oa, vf[2], vf[3]);
      }
    }

    // The masks and dS = P (dP - D) in place of S, as dq_mma_kernel forms them.
    int hi = BK, cl[2] = {BK, BK}, wl[2] = {-1, -1};
    if (!full) {
      hi = k_hi - k0 < BK ? static_cast<int>(k_hi - k0) : BK;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = cl_rel[i] - t * BK, w = wl_rel[i] - t * BK;
        if (causal) cl[i] = c < -1 ? -1 : (c > BK ? BK : c);
        if (window > 0) wl[i] = w < -1 ? -1 : (w > BK ? BK : w);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = j >> 1;
        const int kp = n * 8 + tig * 2 + (j & 1);
        const bool ok = full || (kp < hi && kp <= cl[i] && kp > wl[i]);
        const float p = ok ? exp2f(fmaf(s[n][j], sl, -l2[i])) : 0.f;
        s[n][j] = ok ? p * (dp[n][j] - dd[i]) : 0.f;
      }

    // dQ += dS K, dS as hi + lo (in fp16 scaled first).
    if constexpr (Scaled<T>::value) scale_rows(s, dq, dse);
    const uint32_t k_t = smem_addr(kt + t_row);
#pragma unroll
    for (int kt2 = 0; kt2 < BK / 16; ++kt2) {
      uint32_t sh[4], so[4];
      split_frag<T>(s[2 * kt2], s[2 * kt2 + 1], sh, so);
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t kf[4];
        ldsm_x4_t(kf, k_t + (kt2 * 16 * RS + dp2 * 16) * 2);
        mma16<T>(dq[2 * dp2], sh, kf[0], kf[1]);
        mma16<T>(dq[2 * dp2], so, kf[0], kf[1]);
        mma16<T>(dq[2 * dp2 + 1], sh, kf[2], kf[3]);
        mma16<T>(dq[2 * dp2 + 1], so, kf[2], kf[3]);
      }
    }
  }
  cp_async_wait<0>();
  if (!live) return;
  if constexpr (Scaled<T>::value) unscale_rows(dq, dse);

  T* dqb = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t r = wr0 + g + 8 * i;
    if (r >= rows) continue;
    T* row = dqb + b * a.dqs.b + row_pos(r, group) * a.dqs.s +
             (hk * group + row_head(r, group)) * a.dqs.h;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + tig * 2) =
          pack2<T>(dq[n][2 * i] * a.scale, dq[n][2 * i + 1] * a.scale);
  }
}

// D_i = sum dO_i O_i into a.dsum, one warp a row.
template <typename T>
cudaError_t row_dot(const Args& a, cudaStream_t stream) {
  const int64_t rows_total = a.batch * a.hq * a.sq;
  const unsigned warps = kThreads / 32;
  row_dot_kernel<T><<<static_cast<unsigned>((rows_total + warps - 1) / warps), kThreads, 0,
                      stream>>>(a);
  return cudaGetLastError();
}

// The FMA kernels' three launches at one head dim's tiles: dK/dV over (BK
// keys, BQ rows), dQ over (BQQ rows, 32 keys).
template <int D, int BK, int BQ, int BQQ>
cudaError_t run(const Args& a, int device, cudaStream_t stream) {
  using KV = KvTile<D, BK, BQ>;
  using QT = QTile<D, BQQ, 32>;
  const size_t kv_smem = sizeof(float) * KV::kSmemFloats;
  const size_t q_smem = sizeof(float) * QT::kSmemFloats;
  auto* kv_kern = dkdv_kernel<D, BK, BQ>;
  auto* q_kern = dq_kernel<D, BQQ, 32>;
  static bool kv_done[64] = {}, q_done[64] = {};
  cudaError_t err = allow_smem(kv_kern, kv_smem, device, kv_done);
  if (err == cudaSuccess) err = allow_smem(q_kern, q_smem, device, q_done);
  if (err == cudaSuccess) err = row_dot<float>(a, stream);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid(static_cast<unsigned>((a.sk + BK - 1) / BK), static_cast<unsigned>(a.hkv),
                     static_cast<unsigned>(a.batch));
  kv_kern<<<kv_grid, kThreads, kv_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 q_grid(static_cast<unsigned>((a.sq * a.group + BQQ - 1) / BQQ),
                    static_cast<unsigned>(a.hkv), static_cast<unsigned>(a.batch));
  q_kern<<<q_grid, kThreads, q_smem, stream>>>(a);
  return cudaGetLastError();
}

// The tensor-core kernels' three launches at head dim D in T: dK/dV over
// 64-key tiles, dQ over 64-row tiles.
template <typename T, int D>
cudaError_t run_mma(const Args& a, int device, cudaStream_t stream) {
  using L = BwdTile<D>;
  auto* kv_kern = dkdv_mma_kernel<T, D>;
  auto* q_kern = dq_mma_kernel<T, D>;
  static bool kv_done[64] = {}, q_done[64] = {};
  cudaError_t err = allow_smem(kv_kern, L::kSmemBytes, device, kv_done);
  if (err == cudaSuccess) err = allow_smem(q_kern, L::kSmemBytes, device, q_done);
  if (err == cudaSuccess) err = row_dot<T>(a, stream);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid(static_cast<unsigned>((a.sk + L::BT - 1) / L::BT),
                     static_cast<unsigned>(a.hkv), static_cast<unsigned>(a.batch));
  kv_kern<<<kv_grid, kThreads, L::kSmemBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 q_grid(static_cast<unsigned>((a.sq * a.group + L::BT - 1) / L::BT),
                    static_cast<unsigned>(a.hkv), static_cast<unsigned>(a.batch));
  q_kern<<<q_grid, kThreads, L::kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

// The tensor-core kernels' launches at head dim 256 in T: the dK/dV pass over
// (64-key tile, batch x KV head, slice) blocks, the slices' sum when there
// are several, and the dQ pass over BQ-row tiles.
template <typename T>
cudaError_t run_256(const Args& a, int device, cudaStream_t stream) {
  using L = Tile256;
  auto* kv_kern = dkdv_256_kernel<T>;
  auto* q_kern = dq_256_kernel<T>;
  static bool kv_done[64] = {}, q_done[64] = {};
  cudaError_t err = allow_smem(kv_kern, L::kKvSmemBytes, device, kv_done);
  if (err == cudaSuccess) err = allow_smem(q_kern, L::kQSmemBytes, device, q_done);
  if (err == cudaSuccess) err = row_dot<T>(a, stream);
  if (err != cudaSuccess) return err;
  const int64_t kv_blocks = (a.sk + L::BK - 1) / L::BK * a.batch * a.hkv * a.slices;
  kv_kern<<<static_cast<unsigned>(kv_blocks), 32 * L::KV_WARPS, L::kKvSmemBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.slices > 1) {
    const int64_t quads = a.batch * a.sk * a.hkv * L::D / 4;
    sum_slices_kernel<T><<<static_cast<unsigned>((quads + kThreads - 1) / kThreads), kThreads,
                           0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 q_grid(static_cast<unsigned>((a.sq * a.group + L::BQ - 1) / L::BQ),
                    static_cast<unsigned>(a.hkv), static_cast<unsigned>(a.batch));
  q_kern<<<q_grid, 32 * L::Q_WARPS, L::kQSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

// The kernels built, by dtype and head dim.  fp32: the FMA kernels' tiles
// (BK, BQ) of the dK/dV pass and BQ of the dQ pass, within two blocks an SM
// up to head dim 128 (about 105 KB of shared memory at 80, 79 KB at 128; one
// block at 256).  bf16 and fp16: the tensor-core kernels, dkdv_mma_kernel and
// dq_mma_kernel up to head dim 128, dkdv_256_kernel and dq_256_kernel at 256.
template <typename T>
cudaError_t dispatch_mma(const Args& a, int device, cudaStream_t stream) {
  switch (a.d) {
    case 16: return run_mma<T, 16>(a, device, stream);
    case 32: return run_mma<T, 32>(a, device, stream);
    case 64: return run_mma<T, 64>(a, device, stream);
    case 80: return run_mma<T, 80>(a, device, stream);
    case 128: return run_mma<T, 128>(a, device, stream);
    case 256: return run_256<T>(a, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The fp16 instantiations are an object of their own, as in
// flash_attention.cu (REPRO_FLASH_F16); the entry hands them an fp16 call.
#ifdef REPRO_FLASH_F16
extern "C" int repro_flash_attention_bwd_f16(const void* args, int64_t device, void* stream) {
  return static_cast<int>(dispatch_mma<f16>(*static_cast<const Args*>(args),
                                            static_cast<int>(device),
                                            static_cast<cudaStream_t>(stream)));
}
#else
extern "C" int repro_flash_attention_bwd_f16(const void* args, int64_t device, void* stream);

static cudaError_t dispatch(int64_t dtype, const Args& a, int device, cudaStream_t stream) {
  if (dtype == 0) {
    switch (a.d) {
      case 16: return run<16, 64, 32, 64>(a, device, stream);
      case 32: return run<32, 64, 32, 64>(a, device, stream);
      case 64: return run<64, 64, 32, 64>(a, device, stream);
      case 80: return run<80, 64, 32, 64>(a, device, stream);
      case 128: return run<128, 32, 16, 32>(a, device, stream);
      case 256: return run<256, 16, 32, 16>(a, device, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) return dispatch_mma<bf16>(a, device, stream);
  if (dtype == 2)
    return static_cast<cudaError_t>(repro_flash_attention_bwd_f16(&a, device, stream));
  return cudaErrorInvalidValue;
}

// The head-dim-256 passes' tiles: which 0 is the dK/dV pass's keys a block,
// 1 its Q and dO ring rows, 2 the dQ pass's keys a ring tile, 3 its query
// rows a block; -1 for any other.
extern "C" int64_t repro_flash_attention_bwd256_tile(int64_t which) {
  switch (which) {
    case 0: return Tile256::BK;
    case 1: return Tile256::SUB;
    case 2: return Tile256::QBK;
    case 3: return Tile256::BQ;
    default: return -1;
  }
}

// Gradients of attention of q [batch, sq, hq, d] over k, v [batch, sk, hkv,
// d] (the forward's arguments, as repro_flash_attention takes them) given its
// output o and the output's gradient dout (both [batch, sq, hq, d]) and lse
// (fp32 [batch, hq, sq], the forward's), into dq, dk and dv (the shapes of q,
// k and v); each tensor given by its pointer and its batch, position and head
// strides in elements, d contiguous (for bf16 and fp16 q, k, v and dout
// 16-byte aligned with strides in multiples of 8, as the forward takes them;
// dq, dk and dv 4-byte aligned with even strides).  dsum is fp32 scratch of
// [batch, hq, sq].  dtype 0 is fp32, 1 is bf16, 2 is fp16; sq * hq / hkv is
// below 2^31; every key of dk and dv is written, zeros where no query sees
// it.  slices: the row slices of the dK/dV pass, 1 but for bf16 and fp16 at
// head dim 256, where more than 1 needs part, fp32 scratch of [2, slices,
// batch, sk, hkv, 256].
extern "C" int repro_flash_attention_bwd(
    int64_t device, const void* q, int64_t qsb, int64_t qss, int64_t qsh, const void* k,
    int64_t ksb, int64_t kss, int64_t ksh, const void* v, int64_t vsb, int64_t vss,
    int64_t vsh, const void* o, int64_t osb, int64_t oss, int64_t osh, const void* dout,
    int64_t dosb, int64_t doss, int64_t dosh, const void* lse, void* dsum, void* dq,
    int64_t dqsb, int64_t dqss, int64_t dqsh, void* dk, int64_t dksb, int64_t dkss,
    int64_t dksh, void* dv, int64_t dvsb, int64_t dvss, int64_t dvsh, void* part,
    int64_t slices, int64_t batch, int64_t sq, int64_t sk, int64_t hq, int64_t hkv,
    int64_t d, int64_t sk_valid, int64_t q_offset, int64_t causal, int64_t window,
    int64_t prefix, int64_t dtype, double scale, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || sq <= 0 || sk <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || window < 0 || prefix < 0 ||
      sq * (hq / hkv) >= (int64_t{1} << 31) || slices < 1 ||
      (slices > 1 && (part == nullptr || dtype == 0 || d != 256)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.dsum = static_cast<float*>(dsum);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.qs = {qsb, qss, qsh}; a.ks = {ksb, kss, ksh}; a.vs = {vsb, vss, vsh};
  a.os = {osb, oss, osh}; a.dos = {dosb, doss, dosh};
  a.dqs = {dqsb, dqss, dqsh}; a.dks = {dksb, dkss, dksh}; a.dvs = {dvsb, dvss, dvsh};
  a.batch = batch; a.sq = sq; a.sk = sk; a.hq = hq; a.hkv = hkv; a.group = hq / hkv;
  a.sk_valid = sk_valid; a.q_offset = q_offset; a.window = window; a.prefix = prefix;
  a.causal = causal ? 1 : 0;
  a.d = static_cast<int>(d);
  a.scale = static_cast<float>(scale);
  a.slices = static_cast<int>(slices);
  a.part = static_cast<float*>(part);
  return static_cast<int>(
      dispatch(dtype, a, static_cast<int>(device), static_cast<cudaStream_t>(stream)));
}
#endif  // REPRO_FLASH_F16
