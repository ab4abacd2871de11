// The backward of flash attention (kernel 5b) for Hopper (sm_90a): from q, k,
// v, the forward's output o, the output's gradient do and the forward's
// per-row log-sum-exp lse, the gradients dq, dk and dv under exactly the
// forward's mask (causal, the prefix-LM mask, the sliding window, sk_valid,
// q_offset) and GQA.
//
// It has no TPU counterpart: the JAX model calls no Pallas kernel in
// training.  Its attention is layers.attention, "the XLA twin of the Pallas
// flash kernel" (src/repro/models/layers.py:99-174, _attention_chunked), and
// its gradient is XLA's autodiff of that twin, each KV chunk's scores
// rematerialised under jax.checkpoint.  This is what the port's backward is
// held against; the forward, flash_attention.cu, replaces flash_attention_bh.
//
// FlashAttention-2's split, with no atomics, so the gradients are the same
// bits run to run:
//   1. row_dot_kernel: D_i = sum_d dO_id O_id for every query row (fp32).
//   2. dkdv_kernel: one block a (batch, KV head, tile of BK keys), dK and dV
//      of its keys in registers; a loop over the query rows that may see the
//      tile (every query head of the KV head's group, position-major as in
//      the forward) rebuilds S = Q K^T * scale and P = e^(S - lse) (no
//      softmax: lse holds its normaliser) and dP = dO V^T, then dS = P (dP -
//      D), dV += P^T dO and dK += dS^T Q.  A KV head's dK and dV thus sum
//      over its group's query heads inside one block.
//   3. dq_kernel: one block a (batch, KV head, tile of BQ query rows), dQ in
//      registers; a loop over the key tiles its rows may see (the forward's
//      key range) rebuilds S, P, dP and dS and adds dS K.
// dQ and dK are scaled at the end.  Every sum is fp32; the inputs are fp32 or
// bf16 (read as fp32), the gradients are written in the inputs' type.
//
// Bound.  The function does five products of the score matrix's size (the
// forward's two, Q K^T and P V, are 4.29e10 FLOP for a hubert-xlarge layer at
// batch 8, 1024 frames, 16 heads of 80): 2.5 times the forward, 1.07e11 FLOP,
// 0.108 ms at 989 TFLOP/s of bf16 tensor cores.  This first port is a plain
// shared-memory FMA kernel (67 TFLOP/s at best, fp32) that recomputes S and
// dP in both passes (seven products): it is far from that bound, and the
// tensor-core redesign (the forward's mma.sync and ldmatrix helpers, then
// wgmma) is later work.  Operands sit in shared memory as fp32 in the layout
// each product reads along: Q^T, dO^T, K^T and V^T for the score products
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
template <typename T, int D, int BK, int BQ>
struct KvTile {
  static constexpr int KP = BK + 4, QP = BQ + 4, DP = D + 4;
  static constexpr int KR = BK / 16;  // keys a thread of the dK/dV tile
  static constexpr size_t kSmemFloats =
      2 * D * KP + 2 * D * QP + 2 * BQ * DP + 2 * BQ * KP + 2 * BQ;
  static_assert(BK % 16 == 0, "key tile");
};

template <typename T, int D, int BK, int BQ>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Args a) {
  using L = KvTile<T, D, BK, BQ>;
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
  const T* q = static_cast<const T*>(a.q);
  const T* g = static_cast<const T*>(a.dout);
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + hk * a.vs.h;

  for (int e = tid; e < BK * D; e += kThreads) {
    const int j = e / D, c = e % D;
    const int64_t kp = k0 + j;
    kt[c * KP + j] = kp < a.sk ? to_f(kb[kp * a.ks.s + c]) : 0.f;
    vt[c * KP + j] = kp < a.sk ? to_f(vb[kp * a.vs.s + c]) : 0.f;
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
        x = to_f(q[b * a.qs.b + i * a.qs.s + h * a.qs.h + c]);
        y = to_f(g[b * a.dos.b + i * a.dos.s + h * a.dos.h + c]);
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

  T* dkb = static_cast<T*>(a.dk) + b * a.dks.b + hk * a.dks.h;
  T* dvb = static_cast<T*>(a.dv) + b * a.dvs.b + hk * a.dvs.h;
#pragma unroll
  for (int kk = 0; kk < KR; ++kk) {
    const int64_t kp = k0 + ky * KR + kk;
    if (kp >= a.sk) continue;
#pragma unroll
    for (int cg = 0; cg < NCG; ++cg)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int c = cg * 8 * VEC + dx * VEC + e;
        dkb[kp * a.dks.s + c] = from_f<T>(dk[kk][cg * VEC + e] * a.scale);
        dvb[kp * a.dvs.s + c] = from_f<T>(dv[kk][cg * VEC + e]);
      }
  }
}

// dQ of a tile of BQ query rows, over the key tiles of BK its rows may see.
template <typename T, int D, int BQ, int BK>
struct QTile {
  static constexpr int KP = BK + 4, QP = BQ + 4, DP = D + 4;
  static constexpr int RQ = BQ / 16;  // rows a thread of the dQ tile
  static constexpr size_t kSmemFloats = 2 * D * QP + 2 * D * KP + BK * DP + BK * QP + 2 * BQ;
  static_assert(BQ % 16 == 0, "row tile");
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  using L = QTile<T, D, BQ, BK>;
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
  const T* q = static_cast<const T*>(a.q);
  const T* g = static_cast<const T*>(a.dout);
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + hk * a.vs.h;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int rr = e / D, c = e % D;
    const int64_t r = r0 + rr;
    float x = 0.f, y = 0.f;
    if (r < rows) {
      const int64_t i = r / group, h = hk * group + r % group;
      x = to_f(q[b * a.qs.b + i * a.qs.s + h * a.qs.h + c]);
      y = to_f(g[b * a.dos.b + i * a.dos.s + h * a.dos.h + c]);
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
        x = to_f(kb[kp * a.ks.s + c]);
        y = to_f(vb[kp * a.vs.s + c]);
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

  T* dqb = static_cast<T*>(a.dq);
#pragma unroll
  for (int ii = 0; ii < RQ; ++ii) {
    const int64_t r = r0 + qy * RQ + ii;
    if (r >= rows) continue;
    const int64_t i = r / group, h = hk * group + r % group;
    T* row = dqb + b * a.dqs.b + i * a.dqs.s + h * a.dqs.h;
#pragma unroll
    for (int cg = 0; cg < NCG; ++cg)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        row[cg * 8 * VEC + dx * VEC + e] = from_f<T>(dq[ii][cg * VEC + e] * a.scale);
  }
}

// The three launches at one head dim's tiles: dK/dV over (BK keys, BQ rows),
// dQ over (BQQ rows, 32 keys).
template <typename T, int D, int BK, int BQ, int BQQ>
cudaError_t run(const Args& a, int device, cudaStream_t stream) {
  using KV = KvTile<T, D, BK, BQ>;
  using QT = QTile<T, D, BQQ, 32>;
  const size_t kv_smem = sizeof(float) * KV::kSmemFloats;
  const size_t q_smem = sizeof(float) * QT::kSmemFloats;
  auto* kv_kern = dkdv_kernel<T, D, BK, BQ>;
  auto* q_kern = dq_kernel<T, D, BQQ, 32>;
  static bool kv_done[64] = {}, q_done[64] = {};
  cudaError_t err = allow_smem(kv_kern, kv_smem, device, kv_done);
  if (err == cudaSuccess) err = allow_smem(q_kern, q_smem, device, q_done);
  if (err != cudaSuccess) return err;
  const int64_t rows_total = a.batch * a.hq * a.sq;
  const unsigned warps = kThreads / 32;
  row_dot_kernel<T><<<static_cast<unsigned>((rows_total + warps - 1) / warps), kThreads, 0,
                      stream>>>(a);
  err = cudaGetLastError();
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

// The tiles built, by head dim: (BK, BQ) of the dK/dV pass and BQ of the dQ
// pass, within two blocks an SM up to head dim 128 (about 105 KB of shared
// memory at 80, 79 KB at 128; one block at 256).
template <typename T>
cudaError_t dispatch(const Args& a, int device, cudaStream_t stream) {
  switch (a.d) {
    case 16: return run<T, 16, 64, 32, 64>(a, device, stream);
    case 32: return run<T, 32, 64, 32, 64>(a, device, stream);
    case 64: return run<T, 64, 64, 32, 64>(a, device, stream);
    case 80: return run<T, 80, 64, 32, 64>(a, device, stream);
    case 128: return run<T, 128, 32, 16, 32>(a, device, stream);
    case 256: return run<T, 256, 16, 32, 16>(a, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Gradients of attention of q [batch, sq, hq, d] over k, v [batch, sk, hkv,
// d] (the forward's arguments, as repro_flash_attention takes them) given its
// output o and the output's gradient dout (both [batch, sq, hq, d]) and lse
// (fp32 [batch, hq, sq], the forward's), into dq, dk and dv (the shapes of q,
// k and v); each tensor given by its pointer and its batch, position and head
// strides in elements, d contiguous.  dsum is fp32 scratch of [batch, hq, sq].
// dtype 0 is fp32, 1 is bf16; every key of dk and dv is written, zeros where
// no query sees it.
extern "C" int repro_flash_attention_bwd(
    int64_t device, const void* q, int64_t qsb, int64_t qss, int64_t qsh, const void* k,
    int64_t ksb, int64_t kss, int64_t ksh, const void* v, int64_t vsb, int64_t vss,
    int64_t vsh, const void* o, int64_t osb, int64_t oss, int64_t osh, const void* dout,
    int64_t dosb, int64_t doss, int64_t dosh, const void* lse, void* dsum, void* dq,
    int64_t dqsb, int64_t dqss, int64_t dqsh, void* dk, int64_t dksb, int64_t dkss,
    int64_t dksh, void* dv, int64_t dvsb, int64_t dvss, int64_t dvsh, int64_t batch,
    int64_t sq, int64_t sk, int64_t hq, int64_t hkv, int64_t d, int64_t sk_valid,
    int64_t q_offset, int64_t causal, int64_t window, int64_t prefix, int64_t dtype,
    double scale, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || sq <= 0 || sk <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || window < 0 || prefix < 0)
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
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch<float>(a, static_cast<int>(device), st));
  if (dtype == 1) return static_cast<int>(dispatch<bf16>(a, static_cast<int>(device), st));
  return static_cast<int>(cudaErrorInvalidValue);
}
