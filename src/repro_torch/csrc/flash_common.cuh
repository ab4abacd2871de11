// Helpers shared by flash attention's forward (flash_attention.cu) and its
// backward (flash_attention_bwd.cu): element conversions, shared-memory
// loads, the tensors' strides, the masks' limits, the key range a block
// of query rows attends, and the tensor-core kernels' tools (cp.async,
// ldmatrix, mma.sync and the hi + lo split of a 16-bit float, bf16 or
// fp16).  Included into each source's anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(f16 x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ f16 from_f<f16>(float x) { return __float2half_rn(x); }

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

// The first key of the BK-key tile holding the first key a query at position
// pos sees under a window: max(0, pos - window + 1), rounded down to the tile.
template <int BK>
__device__ __forceinline__ int64_t first_key_tile(int64_t pos, int64_t window) {
  const int64_t first = pos - window + 1;
  return first > 0 ? first / BK * BK : 0;
}

// The last key a query at position pos sees under the causal mask: pos itself,
// or with a prefix every key before it (the prefix-LM mask).
__device__ __forceinline__ int64_t causal_limit(int64_t pos, int64_t prefix) {
  return pos > prefix - 1 ? pos : prefix - 1;
}

// The keys a block attends: [k_lo, k_hi).  Keys past kv_lim are masked for
// every row; past the causal end for this block, whose rows are [r0, r_end):
// its last row's causal limit, max(position, prefix - 1).
// The splits cut the keys from k_base, the tile holding the first key row 0
// may see (0 without a window); the block starts at the tile holding its
// first row's first key.
template <int BK>
__device__ __forceinline__ void key_range(int64_t r0, int64_t r_end, int64_t split,
                                          int64_t split_len, int64_t sk, int64_t group,
                                          int64_t sk_valid, int64_t q_offset, int causal,
                                          int64_t window, int64_t prefix, int64_t& k_lo,
                                          int64_t& k_hi) {
  const int64_t kv_lim = sk_valid < sk ? sk_valid : sk;
  int64_t kv_end = kv_lim;
  if (causal) {
    const int64_t last = causal_limit(q_offset + (r_end - 1) / group, prefix) + 1;
    kv_end = last < kv_end ? last : kv_end;
  }
  const int64_t k_base = window > 0 ? first_key_tile<BK>(q_offset, window) : 0;
  k_lo = k_base + split * split_len;
  k_hi = k_lo + split_len < kv_end ? k_lo + split_len : kv_end;
  if (window > 0) {
    const int64_t own = first_key_tile<BK>(q_offset + r0 / group, window);
    k_lo = own > k_lo ? own : k_lo;
  }
}

// Let kern take smem bytes of dynamic shared memory on the current device, once
// a device (done: the caller's flags for kern), since a decode step's host
// time is a cost of its own.
template <typename K>
cudaError_t allow_smem(K* kern, size_t smem, int device, bool (&done)[64]) {
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

// ---------------------------------------------------------------------------
// Tensor cores (mma.sync m16n8k16, bf16 or fp16 in, fp32 sums) fed by
// cp.async and ldmatrix.
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

// The same for 4 bytes (one fp32), through L1.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
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

// c += a b: a 16x16 of T (row-major fragments), b 16x8 of T (column-major), c
// fp32; T is bf16 or fp16, the same instruction with its operand type.
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1);
template <>
__device__ __forceinline__ void mma16<bf16>(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16<f16>(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) rounded to nearest even into a pair of T, and such a pair back.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y);
template <>
__device__ __forceinline__ uint32_t pack2<bf16>(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<f16>(float x, float y) {
  const __half2 h = __floats2half2_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t w);
template <>
__device__ __forceinline__ float2 unpack2<bf16>(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
template <>
__device__ __forceinline__ float2 unpack2<f16>(uint32_t w) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}

// (x, y) as two pairs of T, hi = T(x, y) and lo = T((x, y) - hi): hi + lo is
// (x, y) to about 2^-16 of each in bf16 and 2^-22 in fp16, where neither part
// leaves T's normal range.
template <typename T>
__device__ __forceinline__ void split16(float x, float y, uint32_t& hi, uint32_t& lo) {
  hi = pack2<T>(x, y);
  const float2 hf = unpack2<T>(hi);
  lo = pack2<T>(x - hf.x, y - hf.y);
}

// The A fragments (16 rows, k 16) of the two 8-column accumulator tiles c0 and
// c1 (the m16n8 C layout is the m16n8k16 A layout), each split into hi + lo.
template <typename T>
__device__ __forceinline__ void split_frag(const float (&c0)[4], const float (&c1)[4],
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split16<T>(c0[0], c0[1], hi[0], lo[0]);
  split16<T>(c0[2], c0[3], hi[1], lo[1]);
  split16<T>(c1[0], c1[1], hi[2], lo[2]);
  split16<T>(c1[2], c1[3], hi[3], lo[3]);
}

// fp16's exponent is narrow: its normal numbers end at 2^-14 and its
// subnormals at 2^-24, where bf16 keeps float32's range.  So in fp16 the
// backward's dS, whose size follows the data, is scaled by a power of two
// before its split, and the scale is taken out of the float32 sums, which is
// exact: by 2^e a row, e from the largest |dS| the row has met so far
// (ds_exp), the row's sums multiplied by 2^(e' - e) when a larger one lowers
// it to e'.  bf16 takes none.
template <typename T>
struct Scaled {
  static constexpr bool value = false;
};
template <>
struct Scaled<f16> {
  static constexpr bool value = true;
};
constexpr int kDsExpMax = 100;  // the exponent of a row whose |dS| are all 0 so far

// 2^e as a float for e <= 127 (0 below -126).
__device__ __forceinline__ float pow2(int e) {
  return e < -126 ? 0.f : __int_as_float((e + 127) << 23);
}

// The largest e <= kDsExpMax with m 2^e < 2^15 (m >= 0 finite): m lies below
// 2^(biased exponent - 126).
__device__ __forceinline__ int ds_exp(float m) {
  const int e = 141 - static_cast<int>((__float_as_uint(m) >> 23) & 0xff);
  return e < kDsExpMax ? e : kDsExpMax;
}

// Scale the rows g and g + 8 of a thread's NT accumulator tiles x (dS in the
// m16n8 C layout: element j of a tile in row j / 2) for their split: each
// row's largest |x| over the quad, its exponent e[i] lowered to that row's
// ds_exp, the row's NA sums acc (the same layout) multiplied by the change,
// and x by 2^e[i].
template <int NT, int NA>
__device__ __forceinline__ void scale_rows(float (&x)[NT][4], float (&acc)[NA][4], int (&e)[2]) {
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) mx[j >> 1] = fmaxf(mx[j >> 1], fabsf(x[n][j]));
  float sc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const int ei = ds_exp(mx[i]);
    if (ei < e[i]) {
      const float f = pow2(ei - e[i]);
#pragma unroll
      for (int n = 0; n < NA; ++n) {
        acc[n][2 * i] *= f;
        acc[n][2 * i + 1] *= f;
      }
      e[i] = ei;
    }
    sc[i] = pow2(e[i]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[n][j] *= sc[j >> 1];
}

// Take a row's scale 2^e[i] back out of its sums (the same layout).
template <int NA>
__device__ __forceinline__ void unscale_rows(float (&acc)[NA][4], const int (&e)[2]) {
  const float f[2] = {pow2(-e[0]), pow2(-e[1])};
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] *= f[j >> 1];
}

}  // namespace
