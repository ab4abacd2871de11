// Helpers shared by the SSD scan (ssd_scan.cu, kernel 6) and its gradient
// (ssd_scan_bwd.cu, kernel 6b): 3xTF32 products on mma.sync m16n8k8 for one
// warp (kernel 6's; kernel 6b reads its fragments its own way), the
// accumulator's stores, cp.async copies into padded shared rows, a chunk's
// dt and its cumsum.  Each source gets its own copy (anonymous namespace).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- 3xTF32 tensor-core products ----------------------------------------- //

// x rounded to TF32's 10-bit mantissa, to nearest with ties away from zero
// (cvt.rna.tf32.f32 for finite x) by two integer operations; the MMA reads
// only the top 19 bits of an operand, so the mask matters only where the
// value is used again, as hi is.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[j] += A[16 x 8 ks] . B[8 ks x 8 NT] for one warp, in 3xTF32, with
// A(m, k) = a_at(m, k) (m counted from the warp's first row) and B(k, n) =
// b_at(k, n) (n from the warp's first column), read from shared memory; the
// k steps s0 <= s < ks of 8 (warp_mma: from 0).
// Fragments (PTX m16n8k8 .tf32): g = lane / 4, q = lane % 4; A holds
// (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4); B holds (q, g), (q + 4, g);
// the accumulator (g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1).
template <int NT, typename LA, typename LB>
__device__ __forceinline__ void warp_mma_range(float (&acc)[NT][4], int s0, int ks, LA a_at,
                                               LB b_at) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll 2
  for (int s = s0; s < ks; ++s) {
    const int k = 8 * s + q;
    uint32_t ah[4], al[4];
    split(a_at(g, k), ah[0], al[0]);
    split(a_at(g + 8, k), ah[1], al[1]);
    split(a_at(g, k + 4), ah[2], al[2]);
    split(a_at(g + 8, k + 4), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh[2], bl[2];
      split(b_at(k, 8 * j + g), bh[0], bl[0]);
      split(b_at(k + 4, 8 * j + g), bh[1], bl[1]);
      mma_tf32(acc[j], al, bh);
      mma_tf32(acc[j], ah, bl);
      mma_tf32(acc[j], ah, bh);
    }
  }
}

template <int NT, typename LA, typename LB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], int ks, LA a_at, LB b_at) {
  warp_mma_range(acc, 0, ks, a_at, b_at);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// Store a warp's 16 x 8 NT accumulator at dst (row stride rs, first column
// c0), rows r0 + g and r0 + g + 8 only where below `rows`.
template <int NT>
__device__ __forceinline__ void store_acc(const float (&acc)[NT][4], float* dst, int64_t rs,
                                          int r0, int c0, int rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= rows) continue;
    float* row = dst + r * rs + c0 + 2 * q;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// ---- asynchronous copies into padded shared rows ------------------------- //

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most `pending` of this thread's committed groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(pending) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
}

// rows x L floats from src (row stride rs) into dst (row stride DS); rows at
// or past `valid` are zero-filled.  vec: every source row is 16-byte aligned.
template <int L, int DS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t rs, int rows,
                                          int valid, bool vec) {
  static_assert(L % 4 == 0 && DS % 4 == 0, "rows of whole float4s");
  if (vec) {
    for (int e = threadIdx.x; e < rows * (L / 4); e += blockDim.x) {
      const int r = e / (L / 4), c = 4 * (e % (L / 4));
      float* d = dst + r * DS + c;
      if (r < valid)
        cp_async16(d, src + r * rs + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = threadIdx.x; e < rows * L; e += blockDim.x) {
      const int r = e / L, c = e % L;
      float* d = dst + r * DS + c;
      if (r < valid)
        cp_async4(d, src + r * rs + c);
      else
        *d = 0.f;
    }
  }
}

// The chunk's dt (0 past `valid`) into dts, by 4-byte copies in the current
// group.
template <int Q>
__device__ __forceinline__ void load_dt(float* dts, const float* dt, int64_t ds, int valid) {
  for (int t = threadIdx.x; t < Q; t += blockDim.x) {
    if (t < valid)
      cp_async4(dts + t, dt + t * ds);
    else
      dts[t] = 0.f;
  }
}

// Warp 0: the inclusive cumsum of dts[0 .. Q) into cdt; Q a multiple of 32.
// Returns the chunk's sum of dt (every lane).
template <int Q>
__device__ __forceinline__ float chunk_cumsum(const float* dts, float* cdt) {
  constexpr int E = Q / 32;
  const int lane = threadIdx.x & 31;
  float v[E], run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    run += dts[lane * E + e];
    v[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  const float excl = incl - run;
#pragma unroll
  for (int e = 0; e < E; ++e) cdt[lane * E + e] = excl + v[e];
  return __shfl_sync(0xffffffffu, incl, 31);
}

template <typename K>
cudaError_t allow_smem(K* kern, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

bool aligned16(const void* p, int64_t s0, int64_t s1, int64_t s2 = 0) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 4 == 0 && s1 % 4 == 0 &&
         s2 % 4 == 0;
}

}  // namespace
