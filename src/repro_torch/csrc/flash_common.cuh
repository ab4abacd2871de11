// Helpers shared by flash attention's forward (flash_attention.cu) and its
// backward (flash_attention_bwd.cu): element conversions, shared-memory
// loads, the tensors' strides, the masks' limits, the key range a block
// of query rows attends, and the tensor-core kernels' tools (cp.async,
// ldmatrix, mma.sync and the bf16 hi + lo split).  Included into each
// source's anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
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
// Tensor cores (mma.sync m16n8k16, bf16 in, fp32 sums) fed by cp.async and
// ldmatrix.
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

// The A fragments (16 rows, k 16) of the two 8-column accumulator tiles c0 and
// c1 (the m16n8 C layout is the m16n8k16 A layout), each split into bf16 hi +
// lo.
__device__ __forceinline__ void split_frag(const float (&c0)[4], const float (&c1)[4],
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

}  // namespace
