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
//
// Design.  One block owns one (batch, KV head, tile of BQ query rows).  The
// rows of a tile are (position i, query head g of the KV head's group) pairs,
// position-major, so the group's query heads share every K/V tile a block
// loads: K and V are read once per KV head and row tile, not once per query
// head (in decode the group's 6 query heads of qwen2 fill one tile).  A loop
// inside the block runs over 32-key tiles and takes the place of the TPU's
// sequential KV grid axis; it stops at the tile holding the last key any row
// of the block may see, min(sk_valid, q_offset + last position + 1), so
// causal and padded tiles are never loaded; with a window it also starts at
// the tile holding the first key its first row may see, so tiles wholly
// before the window are never loaded either.  Q (pre-scaled), K^T, V and P^T
// tiles sit in shared memory as fp32; each of the 128 threads holds RT query
// rows: 4 keys of the score tile and D/8 columns of the fp32 accumulator, in
// registers.  Row max and row sum reduce over the 8 lanes sharing a row with
// warp shuffles.  Inputs are fp32 or bf16; math is fp32 FMA; the output is
// written in the input type.  BQ is 64 (RT = 4) for prefill at head dims up
// to 128 and 32 (RT = 2) at head dim 256, where four rows' accumulators (128
// fp32 registers a thread) would not fit beside the rest; 16 (RT = 1) when a
// (batch, KV head) has 16 rows or fewer, as in decode.  Shared memory is
// 109 KiB at D 256, BQ 32 (two blocks an SM), under the 227 KB opt-in.  When
// the row tiles alone give too few blocks to fill the card (decode: batch *
// KV heads = 16 for qwen2 at B 8, 8 for recurrentgemma), the wrapper cuts the
// live keys -- from the window's first tile, if there is a window, to the
// last valid key -- into ranges, one block each; every block writes its
// unnormalised (acc, m, l) to fp32 scratch (l = 0 for a block whose rows see
// no key of its range) and a second launch merges them, as flash-decoding
// does.
//
// Bound.  The function reads q, the sk_valid keys and values of each (batch,
// KV head) and writes out: bytes bound a decode step (B 8, 1088 cached
// positions, 2 KV heads of 128 in bf16: 8.9 MB, 2.7 us a layer at 3.35 TB/s).
// A causal prefill (B 8, 1024 positions, 12 query heads of 128) does
// 4 * 8 * 12 * 524,800 * 128 = 25.8 GFLOP: 26 us at the bf16 tensor-core
// rate.  This kernel runs on the fp32 FMA units (67 TFLOP/s at best) with
// shared-memory operands, so prefill is far from that bound by design; a
// tensor-core (mma.sync / wgmma) version is later work.  Decode computes 16
// query rows for qwen2's 6 live ones and loads each K/V tile without
// overlapping it with compute, so it is far from its bound too.
// recurrentgemma-2b's windowed prefill (B 8, 3072 positions, 10 query heads
// of 256 over one KV head, window 2048) does 4 * 8 * 10 * 256 * 4,195,328 =
// 344 GFLOP, 0.348 ms at the tensor-core rate; its decode step reads the
// window's 2048 keys and values (16.8 MB, 5.0 us).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 32;          // keys per KV tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// n consecutive floats from 16-, 8- or 4-byte aligned shared memory.
template <int NV>
__device__ __forceinline__ void ld(const float* p, float* out) {
  if constexpr (NV == 4) {
    float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (NV == 2) {
    float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < NV; ++i) out[i] = p[i];
  }
}

struct Strides {
  int64_t b, s, h;  // elements per batch, position, head; d is contiguous
};

// The first key of the tile holding the first key a query at position pos
// sees under a window: max(0, pos - window + 1), rounded down to the tile.
__device__ __forceinline__ int64_t first_key_tile(int64_t pos, int64_t window) {
  const int64_t first = pos - window + 1;
  return first > 0 ? first / kBK * kBK : 0;
}

template <int D, int RT>
struct Tile {
  static constexpr int BQ = 16 * RT;                 // query rows per block
  static constexpr int QP = BQ + 4;                  // padded rows of Q^T, P^T
  static constexpr int KP = kBK + 4;                 // padded rows of K^T
  static constexpr int VP = D + 4;                   // padded rows of V
  static constexpr int VEC = D >= 32 ? 4 : D / 8;    // accumulator columns per load
  static constexpr int NCG = D / (8 * VEC);          // column groups per thread
  static constexpr int kSmemFloats = D * QP + D * KP + kBK * VP + kBK * QP;
};

template <typename T, int D, int RT>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, Strides qs, const T* __restrict__ k, Strides ks,
             const T* __restrict__ v, Strides vs, T* __restrict__ o, Strides os,
             float* __restrict__ part, int64_t tiles, int64_t split_len, int64_t sq,
             int64_t sk, int64_t group, int64_t sk_valid, int64_t q_offset, int causal,
             int64_t window, float scale) {
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

  // Keys past kv_lim are masked for every row; past kv_end for this block,
  // which runs over its split's keys [k_lo, k_hi).  The splits cut the keys
  // from k_base, the tile holding the first key row 0 may see (0 without a
  // window); the block starts at the tile holding its first row's first key.
  const int64_t kv_lim = sk_valid < sk ? sk_valid : sk;
  int64_t kv_end = kv_lim;
  if (causal) {
    const int64_t last = q_offset + (r_end - 1) / group + 1;
    kv_end = last < kv_end ? last : kv_end;
  }
  const int64_t k_base = window > 0 ? first_key_tile(q_offset, window) : 0;
  int64_t k_lo = k_base + split * split_len;
  const int64_t k_hi = k_lo + split_len < kv_end ? k_lo + split_len : kv_end;
  if (window > 0) {
    const int64_t own = first_key_tile(q_offset + r0 / group, window);
    k_lo = own > k_lo ? own : k_lo;
  }

  int64_t pos[RT];
  bool alive[RT];
  float m[RT], l[RT], acc[RT][NCG * VEC];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int64_t r = r0 + ty * RT + i;
    alive[i] = r < rows;
    pos[i] = q_offset + r / group;
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
        ok[j] = alive[i] && kp < kv_lim && (!causal || kp <= pos[i]) &&
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
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    T* orow = o + b * os.b + pi * os.s + h * os.h;
#pragma unroll
    for (int cg = 0; cg < NCG; ++cg)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        orow[cg * 8 * VEC + tx * VEC + e] = from_f<T>(acc[i][cg * VEC + e] * inv);
  }
}

// Merge the splits' (acc, m, l) of one (batch, KV head, row): out =
// sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, M = max_s m_s, with the
// l == 0 guard.  One block per (row, KV head, batch), one thread per column.
template <typename T>
__global__ void combine_kernel(const float* __restrict__ part, T* __restrict__ o, Strides os,
                               int64_t splits, int64_t rows, int64_t group, int d) {
  const int64_t r = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int64_t stride = static_cast<int64_t>(gridDim.z) * gridDim.y * rows * (d + 2);
  const float* p0 = part + ((b * gridDim.y + hk) * rows + r) * (d + 2);
  float mx = -1e30f;
  for (int64_t s = 0; s < splits; ++s) mx = fmaxf(mx, p0[s * stride + d]);
  const int64_t pi = r / group, h = hk * group + r % group;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float num = 0.f, den = 0.f;
    for (int64_t s = 0; s < splits; ++s) {
      const float* ps = p0 + s * stride;
      const float w = expf(ps[d] - mx);
      num += w * ps[c];
      den += w * ps[d + 1];
    }
    o[b * os.b + pi * os.s + h * os.h + c] = from_f<T>(num / (den == 0.f ? 1.f : den));
  }
}

// The row tiles built for each head dim: 16 rows (RT 1) for every one; for
// prefill 64 rows (RT 4) up to 128, and 32 (RT 2) at 256.
template <int D, int RT>
constexpr bool kBuilt = RT == 1 || RT == (D == 256 ? 2 : 4);

template <typename T, int D, int RT>
cudaError_t run(const void* q, Strides qs, const void* k, Strides ks, const void* v,
                Strides vs, void* o, Strides os, float* part, int64_t splits,
                int64_t split_len, int64_t batch, int64_t sq, int64_t sk, int64_t hq,
                int64_t hkv, int64_t sk_valid, int64_t q_offset, int causal,
                int64_t window, float scale, cudaStream_t stream) {
  using L = Tile<D, RT>;
  const size_t smem = sizeof(float) * L::kSmemFloats;
  auto* kern = flash_kernel<T, D, RT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t group = hq / hkv;
  const int64_t tiles = (sq * group + L::BQ - 1) / L::BQ;
  dim3 grid(static_cast<unsigned>(tiles * splits), static_cast<unsigned>(hkv),
            static_cast<unsigned>(batch));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), qs, static_cast<const T*>(k), ks, static_cast<const T*>(v),
      vs, static_cast<T*>(o), os, splits > 1 ? part : nullptr, tiles, split_len, sq, sk,
      group, sk_valid, q_offset, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return err;
  dim3 cgrid(static_cast<unsigned>(sq * group), static_cast<unsigned>(hkv),
             static_cast<unsigned>(batch));
  combine_kernel<T><<<cgrid, D < kThreads ? D : kThreads, 0, stream>>>(
      part, static_cast<T*>(o), os, splits, sq * group, group, D);
  return cudaGetLastError();
}

template <typename T, int RT>
cudaError_t by_dim(int64_t d, const void* q, Strides qs, const void* k, Strides ks,
                   const void* v, Strides vs, void* o, Strides os, float* part,
                   int64_t splits, int64_t split_len, int64_t batch, int64_t sq, int64_t sk,
                   int64_t hq, int64_t hkv, int64_t sk_valid, int64_t q_offset, int causal,
                   int64_t window, float scale, cudaStream_t stream) {
#define REPRO_FLASH_D(DV)                                                              \
  if constexpr (kBuilt<DV, RT>) {                                                      \
    if (d == DV)                                                                       \
      return run<T, DV, RT>(q, qs, k, ks, v, vs, o, os, part, splits, split_len, batch, \
                            sq, sk, hq, hkv, sk_valid, q_offset, causal, window, scale, \
                            stream);                                                   \
  }
  REPRO_FLASH_D(16)
  REPRO_FLASH_D(32)
  REPRO_FLASH_D(64)
  REPRO_FLASH_D(128)
  REPRO_FLASH_D(256)
#undef REPRO_FLASH_D
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_rows(int64_t bq, int64_t d, const void* q, Strides qs, const void* k,
                    Strides ks, const void* v, Strides vs, void* o, Strides os, float* part,
                    int64_t splits, int64_t split_len, int64_t batch, int64_t sq, int64_t sk,
                    int64_t hq, int64_t hkv, int64_t sk_valid, int64_t q_offset, int causal,
                    int64_t window, float scale, cudaStream_t stream) {
#define REPRO_FLASH_RT(RTV)                                                              \
  if (bq == 16 * RTV)                                                                    \
    return by_dim<T, RTV>(d, q, qs, k, ks, v, vs, o, os, part, splits, split_len, batch, \
                          sq, sk, hq, hkv, sk_valid, q_offset, causal, window, scale, stream);
  REPRO_FLASH_RT(1)
  REPRO_FLASH_RT(2)
  REPRO_FLASH_RT(4)
#undef REPRO_FLASH_RT
  return cudaErrorInvalidValue;
}

}  // namespace

// Attention of q [batch, sq, hq, d] over k, v [batch, sk, hkv, d] into
// o [batch, sq, hq, d]; each tensor given by its pointer and its batch,
// position and head strides in elements (d contiguous).  dtype 0 is fp32,
// 1 is bf16; hq is a multiple of hkv; window 0 is none.  bq is the query-row
// tile: 16 for any d of 16, 32, 64, 128 or 256, else 64 for d up to 128 and 32
// for d 256.  The keys from the tile holding max(0, q_offset - window + 1)
// (0 without a window) are cut into `splits` ranges of split_len (a multiple
// of 32) keys, one block each; with splits > 1, part is fp32 scratch of
// [splits, batch, hkv, sq * hq / hkv, d + 2] for their partial results,
// merged by a second launch.
extern "C" int repro_flash_attention(
    int64_t device, const void* q, int64_t qsb, int64_t qss, int64_t qsh, const void* k,
    int64_t ksb, int64_t kss, int64_t ksh, const void* v, int64_t vsb, int64_t vss,
    int64_t vsh, void* o, int64_t osb, int64_t oss, int64_t osh, void* part,
    int64_t batch, int64_t sq, int64_t sk, int64_t hq, int64_t hkv, int64_t d,
    int64_t sk_valid, int64_t q_offset, int64_t causal, int64_t window, int64_t dtype,
    int64_t bq, int64_t splits, int64_t split_len, double scale, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || sq <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || window < 0 || splits < 1 ||
      (splits > 1 && (part == nullptr || split_len <= 0 || split_len % kBK != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  const auto s = static_cast<cudaStream_t>(stream);
  const float sc = static_cast<float>(scale);
  const int c = causal ? 1 : 0;
  auto* pt = static_cast<float*>(part);
  if (splits == 1) split_len = sk;  // one range: every key
  if (dtype == 0) {
    err = by_rows<float>(bq, d, q, qs, k, ks, v, vs, o, os, pt, splits, split_len, batch,
                         sq, sk, hq, hkv, sk_valid, q_offset, c, window, sc, s);
  } else if (dtype == 1) {
    err = by_rows<__nv_bfloat16>(bq, d, q, qs, k, ks, v, vs, o, os, pt, splits, split_len,
                                 batch, sq, sk, hq, hkv, sk_valid, q_offset, c, window, sc,
                                 s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
