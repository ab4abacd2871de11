// Helpers shared by flash attention's forward (flash_attention.cu) and its
// backward (flash_attention_bwd.cu): element conversions, shared-memory
// loads, the tensors' strides, the masks' limits and the key range a block
// of query rows attends.  Included into each source's anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

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

}  // namespace
