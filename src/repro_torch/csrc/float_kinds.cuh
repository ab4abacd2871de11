// Float operands of 4 or 2 bytes (ssd_scan.cu, lru_scan.cu): each kernel
// reads float32, bfloat16 or float16 as it lies and converts it to float32
// in registers, as the TPU kernels do (x_ref[...].astype(jnp.float32)); all
// arithmetic is float32, and an output in a narrow type is rounded to
// nearest even once, where it is stored.
//
// The kinds' codes are kernels/_build.py's FLOAT_KINDS.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

enum FloatKind : int { kFp32 = 0, kBf16 = 1, kFp16 = 2 };

// A load that is converted at once makes the warp wait for it before the
// next load issues, so a kernel that keeps loads in flight holds an
// element's bits (Raw: float32 itself, or the 16 bits of a narrow one)
// until it is used, and converts it there (to_float).
template <typename T>
struct Raw {
  using type = uint16_t;
};
template <>
struct Raw<float> {
  using type = float;
};

__device__ __forceinline__ float load_raw(const float* p) { return __ldg(p); }
__device__ __forceinline__ uint16_t load_raw(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint16_t*>(p));
}
__device__ __forceinline__ uint16_t load_raw(const __half* p) {
  return __ldg(reinterpret_cast<const uint16_t*>(p));
}

template <typename T>
__device__ __forceinline__ float to_float(typename Raw<T>::type v);
template <>
__device__ __forceinline__ float to_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
template <>
__device__ __forceinline__ float to_float<__half>(uint16_t v) {
  return __half2float(__ushort_as_half(v));
}

// The bits of 1.0 in T.
template <typename T>
__device__ __forceinline__ typename Raw<T>::type raw_one();
template <>
__device__ __forceinline__ float raw_one<float>() {
  return 1.f;
}
template <>
__device__ __forceinline__ uint16_t raw_one<__nv_bfloat16>() {
  return 0x3f80;
}
template <>
__device__ __forceinline__ uint16_t raw_one<__half>() {
  return 0x3c00;
}

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_f(__half* p, float v) { *p = __float2half_rn(v); }

// Element i of an operand of kind `kind` at p, as float32 (the kind is the
// same for the whole launch, so the branch does not diverge).
__device__ __forceinline__ float load_kind(const void* p, int64_t i, int kind) {
  if (kind == kBf16)
    return to_float<__nv_bfloat16>(load_raw(static_cast<const __nv_bfloat16*>(p) + i));
  if (kind == kFp16) return to_float<__half>(load_raw(static_cast<const __half*>(p) + i));
  return load_raw(static_cast<const float*>(p) + i);
}

// The address of element i of an operand of kind `kind` at p.
__host__ __device__ __forceinline__ const void* offset_kind(const void* p, int64_t i, int kind) {
  return static_cast<const char*>(p) + i * (kind == kFp32 ? 4 : 2);
}

template <typename T>
struct TypeTag {
  using type = T;
};

// f(TypeTag<T>()) for the storage type T of the runtime kind `kind` (f a
// generic lambda); an unknown kind returns cudaErrorInvalidValue.
template <typename F>
int dispatch_float(int64_t kind, F&& f) {
  switch (kind) {
    case kFp32:
      return f(TypeTag<float>());
    case kBf16:
      return f(TypeTag<__nv_bfloat16>());
    case kFp16:
      return f(TypeTag<__half>());
    default:
      return 1;  // cudaErrorInvalidValue
  }
}

}  // namespace
