// Flash attention (online softmax, GQA, causal, sliding window, length mask) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_bh
// (src/repro/kernels/flash_attention/flash_attention.py:78, body _attn_kernel
// :26): out = softmax(q k^T * scale, masked) v with a running (m, l, acc) per
// query row, query head h reading KV head h / group, keys at or past sk_valid
// masked, causal blocks that are wholly masked skipped, and l == 0 guarded.
// It also takes the model's layouts directly: every tensor is addressed as
// (batch, position, head, d) with element strides, d contiguous, so the
// [B, S, H, d] KV cache and the JAX kernel's [B*H, S, d] both go in without
// a transposed copy.  q_offset is the absolute position of query row 0 (the
// TPU kernel's causal mask assumes 0): with it, a decode step (Sq = 1,
// q_offset = pos, sk_valid = pos + 1) is the same call as prefill.  window > 0
// adds the JAX model's local mask (src/repro/models/layers.py:54): a query at
// position p sees the keys k > p - window, itself and the window - 1 before it.
// prefix > 0 adds the prefix-LM mask under causal (layers.py:49-51, the patches
// frontend): every query also sees the keys k < prefix, so a row's causal
// limit is max(p, prefix - 1); the window still applies after it.
//
// Layout, both kernels.  One block owns one (batch, KV head, tile of query
// rows).  The rows of a tile are (position i, query head g of the KV head's
// group) pairs, position-major, so the group's query heads share every K/V
// tile a block loads (qwen2's group of 6, recurrentgemma's 10).  A loop inside
// the block runs over key tiles and takes the place of the TPU's sequential
// KV grid axis; it stops at the tile holding the last key any row of the
// block may see, min(sk_valid, max(q_offset + last position, prefix - 1) + 1),
// and with a window starts at the tile holding the first key its first row may
// see, so tiles wholly masked are never loaded.  When the row tiles alone give too
// few blocks to fill the card (decode: batch * KV heads = 16 for qwen2, 8 for
// recurrentgemma), the wrapper cuts the live keys into ranges, one block
// each; every block writes its unnormalised (acc, m, l) to fp32 scratch (l = 0
// for a block whose rows see no key of its range) and a second launch
// merges them, as flash-decoding does.
//
// Bound.  The function reads q, the sk_valid keys and values of each (batch,
// KV head) and writes out: bytes bound a decode step (B 8, 1062 live
// positions, 2 KV heads of 128 in bf16: 8.9 MB, 2.7 us a layer at
// 3.35 TB/s; recurrentgemma's window of 2048 keys of 256: 16.8 MB, 5.0 us).
// A causal prefill (B 8, 1024 positions, 12 query heads of 128) does
// 4 * 8 * 12 * 524,800 * 128 = 25.8 GFLOP, 26 us at 989 TFLOP/s of bf16
// tensor cores; recurrentgemma's windowed prefill (B 8, 3072 positions, 10
// query heads of 256, window 2048) 344 GFLOP, 0.348 ms.
//
// bf16: flash_mma_kernel, on the tensor cores.  Each of 4 warps owns 16 query
// rows of a 64-row tile (prefill).  S = Q K^T is mma.sync m16n8k16 (bf16 in,
// fp32 sums) with Q and K fragments read by ldmatrix (K row-major is the
// column-major B operand); S is scaled in fp32 after the product, never by a
// pre-scaled bf16 Q.  Row max and row sum use the quad shuffles of the m16n8
// accumulator layout and exp2f on log2(e)-scaled scores.  P goes from the S
// accumulators straight into A fragments (the C and A layouts of m16n8k16
// agree), and O += P V takes V by ldmatrix.trans.  P is split into hi =
// bf16(p) and lo = bf16(p - hi), two products into one fp32 accumulator: the
// residual is about 2^-16 p, so the output still differs from the fp32 plain
// version by the final rounding to bf16 alone (a P rounded once would add up
// to 2^-8 max|v|); l sums the fp32 p.  K/V tiles stream through a 2-stage
// ring of cp.async.cg 16-byte copies, tile j + 1 in flight while tile j is
// computed; keys past the range are zero-filled (src-size 0), so a masked key
// never holds NaN.  Shared rows are padded by 16 bytes, so the 8 row addresses
// of an ldmatrix fall on distinct banks.  Only key tiles that straddle the
// causal diagonal, sk_valid or the window's lower edge compare positions.
// Row tiles run heaviest first.  Head dim 128: 64 keys a tile, Q's fragments
// in registers (64 fp32 of O, 32 of S a thread), 87 KB of shared memory, two
// blocks an SM.  Head dim 256: Q's fragments are read from shared memory at
// each k-step, beside 128 fp32 of O.  Decode (<= 16 rows: the group's 6 or 10
// query heads of one position) uses one m16 tile whose 4 warps take the four
// 16-key quarters of each 64-key tile and merge their (m, l, acc) in shared
// memory at the end.  wgmma, TMA and warp specialisation are later work.
//
// fp32: flash_kernel, fp32 FMA with shared-memory operands (67 TFLOP/s at
// best): 32-key tiles, each of 128 threads holding RT query rows (4 keys of
// the score tile, D/8 columns of the accumulator), 64 rows (RT 4) up to head
// dim 128, 32 (RT 2) at 256, 16 (RT 1) for 16 rows or fewer.  It serves the
// float32 checks; the model serves in bf16.
//
// Head dim 80 (hubert-xlarge) is built in both: five 16-deep k-steps and ten
// 8-column output tiles on the tensor cores, 2-column accumulator groups in
// the FMA kernel.  For training, either kernel (or, when the keys are split,
// the merge) also writes each row's natural log-sum-exp lse = m + log l of the
// scaled, masked scores (the bf16 kernel's m and l are in log2 units and are
// converted); the backward, flash_attention_bwd.cu, rebuilds P = e^(s - lse)
// from it without a second softmax.

#include <math.h>

#include "flash_common.cuh"

namespace {

constexpr int kBK = 32;          // keys per KV tile of the fp32 kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// fp32: FMA with shared-memory operands.
// ---------------------------------------------------------------------------

template <int D, int RT>
struct Tile {
  static constexpr int BQ = 16 * RT;                 // query rows per block
  static constexpr int QP = BQ + 4;                  // padded rows of Q^T, P^T
  static constexpr int KP = kBK + 4;                 // padded rows of K^T
  static constexpr int VP = D + 4;                   // padded rows of V
  // accumulator columns per load: D = 8 VEC NCG (head dim 80: 2 of 5 groups)
  static constexpr int VEC = D % 32 == 0 ? 4 : (D % 16 == 0 ? 2 : 1);
  static constexpr int NCG = D / (8 * VEC);          // column groups per thread
  static constexpr int kSmemFloats = D * QP + D * KP + kBK * VP + kBK * QP;
};

template <typename T, int D, int RT>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, Strides qs, const T* __restrict__ k, Strides ks,
             const T* __restrict__ v, Strides vs, T* __restrict__ o, Strides os,
             float* __restrict__ part, float* __restrict__ lse, int64_t tiles,
             int64_t split_len, int64_t sq,
             int64_t sk, int64_t group, int64_t sk_valid, int64_t q_offset, int causal,
             int64_t window, int64_t prefix, float scale) {
  using L = Tile<D, RT>;
  constexpr int BQ = L::BQ, QP = L::QP, KP = L::KP, VP = L::VP;
  constexpr int VEC = L::VEC, NCG = L::NCG;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                 // [D][QP]  Q^T, pre-scaled
  float* kt = qt + D * QP;          // [D][KP]  K^T of the current tile
  float* vt = kt + D * KP;          // [kBK][VP] V of the current tile
  float* pt = vt + kBK * VP;        // [kBK][QP] P^T of the current tile

  const int tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;
  const int64_t b = blockIdx.z, hk = blockIdx.y;
  const int64_t tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int64_t rows = sq * group;
  const int64_t r0 = tile * BQ;
  const int64_t r_end = r0 + BQ < rows ? r0 + BQ : rows;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int rr = e / D, d = e % D;
    const int64_t r = r0 + rr;
    float x = 0.f;
    if (r < rows) {
      const int64_t i = r / group, h = hk * group + r % group;
      x = to_f(q[b * qs.b + i * qs.s + h * qs.h + d]) * scale;
    }
    qt[d * QP + rr] = x;
  }

  const int64_t kv_lim = sk_valid < sk ? sk_valid : sk;
  int64_t k_lo, k_hi;
  key_range<kBK>(r0, r_end, split, split_len, sk, group, sk_valid, q_offset, causal, window,
                 prefix, k_lo, k_hi);

  int64_t pos[RT], cl[RT];  // each row's position and causal limit
  bool alive[RT];
  float m[RT], l[RT], acc[RT][NCG * VEC];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int64_t r = r0 + ty * RT + i;
    alive[i] = r < rows;
    pos[i] = q_offset + r / group;
    cl[i] = causal_limit(pos[i], prefix);
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCG * VEC; ++c) acc[i][c] = 0.f;
  }

  for (int64_t k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the last tile's K, V and P are no longer read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const int64_t kp = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp < k_hi) {  // zeros past the end: masked keys never hold NaN
        kx = to_f(kb[kp * ks.s + d]);
        vx = to_f(vb[kp * vs.s + d]);
      }
      kt[d * KP + j] = kx;
      vt[j * VP + d] = vx;
    }
    __syncthreads();

    float s[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RT], kv[4];
      ld<RT>(qt + d * QP + ty * RT, qv);
      ld<4>(kt + d * KP + tx * 4, kv);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RT; ++i) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kp = k0 + tx * 4 + j;
        ok[j] = alive[i] && kp < kv_lim && (!causal || kp <= cl[i]) &&
                (window <= 0 || kp > pos[i] - window);
        s[i][j] = ok[j] ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        pt[(tx * 4 + j) * QP + ty * RT + i] = p;
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NCG * VEC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[RT];
      ld<RT>(pt + j * QP + ty * RT, pv);
#pragma unroll
      for (int cg = 0; cg < NCG; ++cg) {
        float vv[VEC];
        ld<VEC>(vt + j * VP + cg * 8 * VEC + tx * VEC, vv);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[i][cg * VEC + e] = fmaf(pv[i], vv[e], acc[i][cg * VEC + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    if (!alive[i]) continue;
    const int64_t r = r0 + ty * RT + i;
    if (part != nullptr) {  // this split's unnormalised (acc, m, l)
      float* prow = part + (((split * gridDim.z + b) * gridDim.y + hk) * rows + r) * (D + 2);
#pragma unroll
      for (int cg = 0; cg < NCG; ++cg)
#pragma unroll
        for (int e = 0; e < VEC; ++e) prow[cg * 8 * VEC + tx * VEC + e] = acc[i][cg * VEC + e];
      if (tx == 0) {
        prow[D] = m[i];
        prow[D + 1] = l[i];
      }
      continue;
    }
    const int64_t pi = r / group, h = hk * group + r % group;
    if (lse != nullptr && tx == 0)  // natural log-sum-exp of the scaled scores
      lse[(b * gridDim.y * group + h) * sq + pi] = l[i] == 0.f ? INFINITY : m[i] + logf(l[i]);
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    T* orow = o + b * os.b + pi * os.s + h * os.h;
#pragma unroll
    for (int cg = 0; cg < NCG; ++cg)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        orow[cg * 8 * VEC + tx * VEC + e] = from_f<T>(acc[i][cg * VEC + e] * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16) fed by cp.async and ldmatrix.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros when !ok
// (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i holds matrix i's (row lane / 4, columns 2 (lane % 4) + {0, 1}).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The same, transposed: register i holds matrix i's (rows 2 (lane % 4) + {0, 1},
// column lane / 4).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a b: a 16x16 bf16 (row-major fragments), b 16x8 bf16 (column-major), c fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as two bf16 pairs, hi = bf16(x, y) and lo = bf16((x, y) - hi): hi + lo
// is (x, y) to about 2^-16 of each.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// The tensor-core kernel's tiles: BQ query rows (4 warps of 16 in prefill; one
// m16 tile that all 4 warps share in decode), BK keys a K/V stage, KW of them
// each warp's (decode: a quarter each), NS stages, rows padded to RS elements.
template <int D, int BK, bool DECODE>
struct MmaTile {
  static constexpr int BQ = DECODE ? 16 : 64;
  static constexpr int KW = DECODE ? BK / 4 : BK;
  static constexpr int NS = 2;
  static constexpr int RS = D + 8;          // 16 bytes of padding a row
  static constexpr bool QREG = D <= 128;    // Q's fragments held in registers
  static constexpr size_t kSmemBytes = sizeof(bf16) * (BQ + 2 * NS * BK) * RS;
  // Decode's merge, in the K/V stages: [4 warps][16 rows][D + 8] fp32 of acc
  // and [4][16] (m, l).
  static constexpr int MS = D + 8;
  static constexpr size_t kMergeBytes = sizeof(float) * 4 * 16 * (MS + 2);
  static_assert(D % 16 == 0 && KW % 16 == 0 && BK * (D / 8) % kThreads == 0, "tile");
  static_assert(!DECODE || kMergeBytes <= sizeof(bf16) * 2 * NS * BK * RS, "merge");
};

struct MmaArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* part;
  float* lse;
  Strides qs, ks, vs, os;
  int64_t tiles, split_len, sq, sk, group, sk_valid, q_offset, window, prefix;
  int causal;
  float scale;
};

template <int D, int BK, bool DECODE>
__global__ void __launch_bounds__(kThreads) flash_mma_kernel(const MmaArgs a) {
  using L = MmaTile<D, BK, DECODE>;
  constexpr int BQ = L::BQ, KW = L::KW, NS = L::NS, RS = L::RS;
  constexpr int NT = KW / 8;   // 8-key tiles of a warp's scores
  constexpr int DT = D / 8;    // 8-column tiles of its output
  constexpr int KS = D / 16;   // 16-deep steps of Q K^T
  constexpr int CH = D / 8;    // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [BQ][RS]
  bf16* sK = sQ + BQ * RS;                        // [NS][BK][RS]
  bf16* sV = sK + NS * BK * RS;                   // [NS][BK][RS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int64_t group = a.group, q_offset = a.q_offset, window = a.window;
  const int causal = a.causal;
  const int64_t b = blockIdx.z, hk = blockIdx.y;
  // Heaviest row tiles first: under the causal mask the last ones see most keys.
  const int64_t tile = a.tiles - 1 - blockIdx.x % a.tiles, split = blockIdx.x / a.tiles;
  const int64_t rows = a.sq * group;
  const int64_t r0 = tile * BQ;
  const int64_t r_end = r0 + BQ < rows ? r0 + BQ : rows;
  const bf16* kb = a.k + b * a.ks.b + hk * a.ks.h;
  const bf16* vb = a.v + b * a.vs.b + hk * a.vs.h;
  int64_t k_lo, k_hi;
  key_range<BK>(r0, r_end, split, a.split_len, a.sk, group, a.sk_valid, q_offset, causal,
                window, a.prefix, k_lo, k_hi);
  const int ntiles = k_hi > k_lo ? static_cast<int>((k_hi - k_lo + BK - 1) / BK) : 0;

  // Q (zeros past the last row) goes with the first K/V stage.
  for (int e = tid; e < BQ * CH; e += kThreads) {
    const int rr = e / CH, c = e % CH;
    const int64_t r = r0 + rr;
    const bool ok = r < rows;
    const bf16* src =
        ok ? a.q + b * a.qs.b + (r / group) * a.qs.s + (hk * group + r % group) * a.qs.h + c * 8
           : a.q;
    cp_async16(smem_addr(sQ + rr * RS + c * 8), src, ok);
  }
  auto load_kv = [&](int t) {
    const int64_t k0 = k_lo + static_cast<int64_t>(t) * BK;
    bf16* dk = sK + (t % NS) * BK * RS;
    bf16* dv = sV + (t % NS) * BK * RS;
#pragma unroll 4
    for (int e = tid; e < BK * CH; e += kThreads) {
      const int j = e / CH, c = e % CH;
      const int64_t kp = k0 + j;
      const bool ok = kp < k_hi;  // zeros past the range: masked keys never hold NaN
      cp_async16(smem_addr(dk + j * RS + c * 8), ok ? kb + kp * a.ks.s + c * 8 : kb, ok);
      cp_async16(smem_addr(dv + j * RS + c * 8), ok ? vb + kp * a.vs.s + c * 8 : vb, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < ntiles) load_kv(t);
    cp_async_commit();
  }

  // The warp's rows and keys: in prefill rows [16 warp, 16 warp + 16) of the
  // tile and every key of a K/V tile; in decode the tile's 16 rows and keys
  // [KW warp, KW warp + KW) of each K/V tile.  A thread holds rows g and g + 8
  // of the warp's 16.
  const int wq = DECODE ? 0 : 16 * warp;
  const int kw = DECODE ? KW * warp : 0;
  const int64_t wr0 = r0 + wq;
  const bool live = wr0 < rows;
  const int64_t wr_last = (wr0 + 16 < rows ? wr0 + 16 : rows) - 1;
  const int64_t pos_lo = q_offset + wr0 / group, pos_hi = q_offset + wr_last / group;
  const int64_t pos[2] = {q_offset + (wr0 + g) / group, q_offset + (wr0 + g + 8) / group};
  // The causal limits (with a prefix, max(position, prefix - 1)); the window
  // reads the positions themselves.
  const int64_t cl_lo = causal_limit(pos_lo, a.prefix), cl_hi = causal_limit(pos_hi, a.prefix);
  const int64_t cl_row[2] = {causal_limit(pos[0], a.prefix), causal_limit(pos[1], a.prefix)};
  const float sl = a.scale * kLog2e;

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t qf[L::QREG ? KS : 1][4];
  // ldmatrix row addresses: A (Q rows wq + lane % 16, columns 8 (lane / 16));
  // K as B (keys lane % 8 + 8 (lane / 16), columns 8 ((lane / 8) % 2)); V as
  // B, transposed (keys lane % 16, columns 8 (lane / 16)).
  const uint32_t q_addr = smem_addr(sQ + (wq + lane % 16) * RS + (lane / 16) * 8);
  const int k_row = (lane % 8 + (lane / 16) * 8) * RS + ((lane / 8) % 2) * 8;
  const int v_row = (lane % 16) * RS + (lane / 16) * 8;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile t has landed for every thread; tile t - 1 is no longer read
    if (t + NS - 1 < ntiles) load_kv(t + NS - 1);
    cp_async_commit();
    if constexpr (L::QREG) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) ldsm_x4(qf[kk], q_addr + kk * 32);
      }
    }
    const int64_t k0 = k_lo + static_cast<int64_t>(t) * BK + kw;  // the warp's first key
    // A sub-tile no row of the warp sees is skipped; one every row sees
    // whole is not masked.
    if (!live || k0 >= k_hi || (causal && k0 > cl_hi) ||
        (window > 0 && k0 + KW - 1 <= pos_lo - window))
      continue;
    const bool full = k0 + KW <= k_hi && (!causal || k0 + KW - 1 <= cl_lo) &&
                      (window <= 0 || k0 > pos_hi - window);
    const bf16* kt = sK + (t % NS) * BK * RS + kw * RS;
    const bf16* vt = sV + (t % NS) * BK * RS + kw * RS;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const uint32_t k_addr = smem_addr(kt + k_row);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      if constexpr (L::QREG) {
        qa[0] = qf[kk][0]; qa[1] = qf[kk][1]; qa[2] = qf[kk][2]; qa[3] = qf[kk][3];
      } else {
        ldsm_x4(qa, q_addr + kk * 32);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, k_addr + (np * 16 * RS + kk * 16) * 2);
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }

    // Scale in fp32 (log2 units), mask a straddling tile, new row max.  The
    // masks as key offsets within the sub-tile: below hi; at or below the
    // row's causal limit cl; above its window limit wl.
    int hi = KW, cl[2] = {KW, KW}, wl[2] = {-1, -1};
    if (!full) {
      hi = k_hi - k0 < KW ? static_cast<int>(k_hi - k0) : KW;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int64_t c = cl_row[i] - k0, w = pos[i] - window - k0;
        if (causal) cl[i] = c < -1 ? -1 : (c > KW ? KW : static_cast<int>(c));
        if (window > 0) wl[i] = w < -1 ? -1 : (w > KW ? KW : static_cast<int>(w));
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[n][j] * sl;
        if (!full) {
          const int kp = n * 8 + tig * 2 + (j & 1);
          const int i = j >> 1;
          x = (kp < hi && kp <= cl[i] && kp > wl[i]) ? x : kNegInf;
        }
        s[n][j] = x;
        mx[j >> 1] = fmaxf(mx[j >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = s[n][j];
        const float p = (full || x != kNegInf) ? exp2f(x - m[j >> 1]) : 0.f;
        s[n][j] = p;
        l[j >> 1] += p;  // this thread's columns; the quad's sum comes at the end
      }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
    }

    // O += P V, P as bf16 hi + lo straight from the S accumulators: the A
    // fragment of keys [16 kt, 16 kt + 16) is the C fragments of 8-key tiles
    // 2 kt and 2 kt + 1.
    const uint32_t v_addr = smem_addr(vt + v_row);
#pragma unroll
    for (int kt2 = 0; kt2 < KW / 16; ++kt2) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kt2][0], s[2 * kt2][1], ph[0], pl[0]);
      split_bf16(s[2 * kt2][2], s[2 * kt2][3], ph[1], pl[1]);
      split_bf16(s[2 * kt2 + 1][0], s[2 * kt2 + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kt2 + 1][2], s[2 * kt2 + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldsm_x4_t(vf, v_addr + (kt2 * 16 * RS + dp * 16) * 2);
        mma_bf16(acc[2 * dp], ph, vf[0], vf[1]);
        mma_bf16(acc[2 * dp], pl, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], ph, vf[2], vf[3]);
        mma_bf16(acc[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  if constexpr (!DECODE) {
    if (!live) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t r = wr0 + g + 8 * i;
      if (r >= rows) continue;
      if (a.part != nullptr) {  // this split's unnormalised (acc, m, l), m in nats
        float* prow =
            a.part + (((split * gridDim.z + b) * gridDim.y + hk) * rows + r) * (D + 2);
#pragma unroll
        for (int n = 0; n < DT; ++n)
          *reinterpret_cast<float2*>(prow + n * 8 + tig * 2) =
              make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
        if (tig == 0) {
          prow[D] = m[i] * kLn2;
          prow[D + 1] = l[i];
        }
        continue;
      }
      if (a.lse != nullptr && tig == 0)  // m and l are in log2 units: back to nats
        a.lse[(b * gridDim.y * group + hk * group + r % group) * a.sq + r / group] =
            l[i] == 0.f ? INFINITY : (m[i] + log2f(l[i])) * kLn2;
      const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
      bf16* orow = a.o + b * a.os.b + (r / group) * a.os.s + (hk * group + r % group) * a.os.h;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + tig * 2) =
            __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
  } else {
    // The 4 warps' (m, l, acc) of the same 16 rows, merged in shared memory.
    constexpr int MS = L::MS;
    __syncthreads();  // every warp is done with the K/V stages, which take the merge
    float* s_acc = reinterpret_cast<float*>(sK);   // [4][16][MS]
    float* s_ml = s_acc + 4 * 16 * MS;             // [4][16][2]
    if (tig == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        s_ml[(warp * 16 + g + 8 * i) * 2] = m[i];
        s_ml[(warp * 16 + g + 8 * i) * 2 + 1] = l[i];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = g + 8 * i;
      float top = kNegInf;
#pragma unroll
      for (int w = 0; w < 4; ++w) top = fmaxf(top, s_ml[(w * 16 + rr) * 2]);
      const float alpha = exp2f(m[i] - top);
      float* arow = s_acc + (warp * 16 + rr) * MS;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<float2*>(arow + n * 8 + tig * 2) =
            make_float2(acc[n][2 * i] * alpha, acc[n][2 * i + 1] * alpha);
    }
    __syncthreads();
    for (int e = tid; e < 16 * D; e += kThreads) {
      const int rr = e / D, c = e % D;
      const int64_t r = r0 + rr;
      if (r >= rows) continue;
      float top = kNegInf;
#pragma unroll
      for (int w = 0; w < 4; ++w) top = fmaxf(top, s_ml[(w * 16 + rr) * 2]);
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        den += exp2f(s_ml[(w * 16 + rr) * 2] - top) * s_ml[(w * 16 + rr) * 2 + 1];
        num += s_acc[(w * 16 + rr) * MS + c];
      }
      if (a.part != nullptr) {
        float* prow =
            a.part + (((split * gridDim.z + b) * gridDim.y + hk) * rows + r) * (D + 2);
        prow[c] = num;
        if (c == 0) {
          prow[D] = top * kLn2;
          prow[D + 1] = den;
        }
      } else {
        a.o[b * a.os.b + (r / group) * a.os.s + (hk * group + r % group) * a.os.h + c] =
            __float2bfloat16(num / (den == 0.f ? 1.f : den));
        if (a.lse != nullptr && c == 0)
          a.lse[(b * gridDim.y * group + hk * group + r % group) * a.sq + r / group] =
              den == 0.f ? INFINITY : (top + log2f(den)) * kLn2;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

// Merge the splits' (acc, m, l) of one (batch, KV head, row): out =
// sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, M = max_s m_s, with the
// l == 0 guard, and with lse its log-sum-exp M + log(sum_s e^(m_s - M) l_s).  One block per (row, KV head, batch), one thread per column;
// the loops over the splits are unrolled so that their loads are in flight
// together.
template <typename T>
__global__ void combine_kernel(const float* __restrict__ part, T* __restrict__ o, Strides os,
                               float* __restrict__ lse, int64_t splits, int64_t sq,
                               int64_t group, int d) {
  const int64_t rows = sq * group;
  const int64_t r = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int64_t stride = static_cast<int64_t>(gridDim.z) * gridDim.y * rows * (d + 2);
  const float* p0 = part + ((b * gridDim.y + hk) * rows + r) * (d + 2);
  float mx = -1e30f;
#pragma unroll 8
  for (int64_t s = 0; s < splits; ++s) mx = fmaxf(mx, p0[s * stride + d]);
  const int64_t pi = r / group, h = hk * group + r % group;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float num = 0.f, den = 0.f;
#pragma unroll 8
    for (int64_t s = 0; s < splits; ++s) {
      const float* ps = p0 + s * stride;
      const float w = expf(ps[d] - mx);
      num += w * ps[c];
      den += w * ps[d + 1];
    }
    o[b * os.b + pi * os.s + h * os.h + c] = from_f<T>(num / (den == 0.f ? 1.f : den));
    if (lse != nullptr && c == 0)
      lse[(b * gridDim.y * group + h) * sq + pi] = den == 0.f ? INFINITY : mx + logf(den);
  }
}

// One call of the entry, as the wrapper planned it.
struct Call {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part;
  float* lse;
  Strides qs, ks, vs, os;
  int64_t splits, split_len, batch, sq, sk, hq, hkv, d, sk_valid, q_offset, window, prefix;
  int causal, device;
  float scale;
  cudaStream_t stream;
};

template <typename T>
cudaError_t combine(const Call& c) {
  if (c.splits <= 1) return cudaSuccess;
  const int64_t group = c.hq / c.hkv;
  dim3 grid(static_cast<unsigned>(c.sq * group), static_cast<unsigned>(c.hkv),
            static_cast<unsigned>(c.batch));
  const unsigned threads = static_cast<unsigned>(c.d < kThreads ? c.d : kThreads);
  combine_kernel<T><<<grid, threads, 0, c.stream>>>(
      c.part, static_cast<T*>(c.o), c.os, c.lse, c.splits, c.sq, group, static_cast<int>(c.d));
  return cudaGetLastError();
}

template <int D, int RT>
cudaError_t run_fma(const Call& c) {
  using L = Tile<D, RT>;
  const size_t smem = sizeof(float) * L::kSmemFloats;
  auto* kern = flash_kernel<float, D, RT>;
  static bool done[64] = {};
  cudaError_t err = allow_smem(kern, smem, c.device, done);
  if (err != cudaSuccess) return err;
  const int64_t group = c.hq / c.hkv;
  const int64_t tiles = (c.sq * group + L::BQ - 1) / L::BQ;
  dim3 grid(static_cast<unsigned>(tiles * c.splits), static_cast<unsigned>(c.hkv),
            static_cast<unsigned>(c.batch));
  kern<<<grid, kThreads, smem, c.stream>>>(
      static_cast<const float*>(c.q), c.qs, static_cast<const float*>(c.k), c.ks,
      static_cast<const float*>(c.v), c.vs, static_cast<float*>(c.o), c.os,
      c.splits > 1 ? c.part : nullptr, c.splits > 1 ? nullptr : c.lse, tiles, c.split_len,
      c.sq, c.sk, group, c.sk_valid,
      c.q_offset, c.causal, c.window, c.prefix, c.scale);
  err = cudaGetLastError();
  return err != cudaSuccess ? err : combine<float>(c);
}

template <int D, int BK, bool DECODE>
cudaError_t run_mma(const Call& c) {
  using L = MmaTile<D, BK, DECODE>;
  auto* kern = flash_mma_kernel<D, BK, DECODE>;
  static bool done[64] = {};
  cudaError_t err = allow_smem(kern, L::kSmemBytes, c.device, done);
  if (err != cudaSuccess) return err;
  MmaArgs a;
  a.q = static_cast<const bf16*>(c.q);
  a.k = static_cast<const bf16*>(c.k);
  a.v = static_cast<const bf16*>(c.v);
  a.o = static_cast<bf16*>(c.o);
  a.part = c.splits > 1 ? c.part : nullptr;
  a.lse = c.splits > 1 ? nullptr : c.lse;  // with splits the merge writes it
  a.qs = c.qs; a.ks = c.ks; a.vs = c.vs; a.os = c.os;
  a.group = c.hq / c.hkv;
  a.tiles = (c.sq * a.group + L::BQ - 1) / L::BQ;
  a.split_len = c.split_len; a.sq = c.sq; a.sk = c.sk; a.sk_valid = c.sk_valid;
  a.q_offset = c.q_offset; a.window = c.window; a.prefix = c.prefix; a.causal = c.causal;
  a.scale = c.scale;
  dim3 grid(static_cast<unsigned>(a.tiles * c.splits), static_cast<unsigned>(c.hkv),
            static_cast<unsigned>(c.batch));
  kern<<<grid, kThreads, L::kSmemBytes, c.stream>>>(a);
  err = cudaGetLastError();
  return err != cudaSuccess ? err : combine<bf16>(c);
}

// The tiles built.  fp32: key tile 32; 16 query rows (RT 1) for every head
// dim, and for prefill 64 (RT 4) up to 128 and 32 (RT 2) at 256.  bf16: 16
// rows (decode) over 64-key tiles for every head dim; 64 rows over 64-key
// tiles for prefill, and at head dim 256 over 32- or 64-key tiles.  Head dims
// 16, 32, 64, 80, 128 and 256.
cudaError_t dispatch(int64_t dtype, int64_t bq, int64_t bk, const Call& c) {
  const int64_t d = c.d;
  if (dtype == 0 && bk == kBK) {
#define REPRO_FLASH_FMA(DV, RTV) \
  if (d == DV && bq == 16 * RTV) return run_fma<DV, RTV>(c);
    REPRO_FLASH_FMA(16, 1) REPRO_FLASH_FMA(16, 4)
    REPRO_FLASH_FMA(32, 1) REPRO_FLASH_FMA(32, 4)
    REPRO_FLASH_FMA(64, 1) REPRO_FLASH_FMA(64, 4)
    REPRO_FLASH_FMA(80, 1) REPRO_FLASH_FMA(80, 4)
    REPRO_FLASH_FMA(128, 1) REPRO_FLASH_FMA(128, 4)
    REPRO_FLASH_FMA(256, 1) REPRO_FLASH_FMA(256, 2)
#undef REPRO_FLASH_FMA
  } else if (dtype == 1) {
#define REPRO_FLASH_MMA(DV, BKV, DEC) \
  if (d == DV && bk == BKV && bq == (DEC ? 16 : 64)) return run_mma<DV, BKV, DEC>(c);
    REPRO_FLASH_MMA(16, 64, true) REPRO_FLASH_MMA(16, 64, false)
    REPRO_FLASH_MMA(32, 64, true) REPRO_FLASH_MMA(32, 64, false)
    REPRO_FLASH_MMA(64, 64, true) REPRO_FLASH_MMA(64, 64, false)
    REPRO_FLASH_MMA(80, 64, true) REPRO_FLASH_MMA(80, 64, false)
    REPRO_FLASH_MMA(128, 64, true) REPRO_FLASH_MMA(128, 64, false)
    REPRO_FLASH_MMA(256, 64, true) REPRO_FLASH_MMA(256, 32, false)
    REPRO_FLASH_MMA(256, 64, false)
#undef REPRO_FLASH_MMA
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Attention of q [batch, sq, hq, d] over k, v [batch, sk, hkv, d] into
// o [batch, sq, hq, d]; each tensor given by its pointer and its batch,
// position and head strides in elements (d contiguous; for bf16 the pointers
// 16-byte aligned and the strides multiples of 8).  dtype 0 is fp32, 1 is
// bf16; hq is a multiple of hkv; window 0 is none; prefix 0 is none (with causal,
// the queries also see the keys before prefix).  (bq, bk) is the tile of
// query rows and keys, one of those `dispatch` lists.  The keys from the bk
// tile holding max(0, q_offset - window + 1) (0 without a window) are cut
// into `splits` ranges of split_len (a multiple of bk) keys, one block each;
// with splits > 1, part is fp32 scratch of [splits, batch, hkv, sq * hq / hkv,
// d + 2] for their partial results, merged by a second launch.  lse, when not
// null, takes each query row's natural log-sum-exp of its scaled, masked scores,
// fp32 [batch, hq, sq] (+inf for a row that sees no key): what the backward
// (flash_attention_bwd.cu) rebuilds the probabilities from.
extern "C" int repro_flash_attention(
    int64_t device, const void* q, int64_t qsb, int64_t qss, int64_t qsh, const void* k,
    int64_t ksb, int64_t kss, int64_t ksh, const void* v, int64_t vsb, int64_t vss,
    int64_t vsh, void* o, int64_t osb, int64_t oss, int64_t osh, void* part, void* lse,
    int64_t batch, int64_t sq, int64_t sk, int64_t hq, int64_t hkv, int64_t d,
    int64_t sk_valid, int64_t q_offset, int64_t causal, int64_t window, int64_t prefix,
    int64_t dtype,
    int64_t bq, int64_t bk, int64_t splits, int64_t split_len, double scale, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || sq <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || window < 0 || prefix < 0 || splits < 1 || bk <= 0 ||
      (splits > 1 && (part == nullptr || split_len <= 0 || split_len % bk != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Call c;
  c.q = q; c.k = k; c.v = v; c.o = o; c.part = static_cast<float*>(part);
  c.lse = static_cast<float*>(lse);
  c.qs = {qsb, qss, qsh}; c.ks = {ksb, kss, ksh}; c.vs = {vsb, vss, vsh};
  c.os = {osb, oss, osh};
  c.splits = splits;
  c.split_len = splits == 1 ? sk : split_len;  // one range: every key
  c.batch = batch; c.sq = sq; c.sk = sk; c.hq = hq; c.hkv = hkv; c.d = d;
  c.sk_valid = sk_valid; c.q_offset = q_offset; c.window = window; c.prefix = prefix;
  c.causal = causal ? 1 : 0;
  c.device = static_cast<int>(device);
  c.scale = static_cast<float>(scale);
  c.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, bq, bk, c));
}
