// Sort keys of 1, 2 or 4 bytes (radix_sort.cu, bitonic_sort.cu, kway_merge.cu):
// each key kind's storage type and its order-preserving image, an unsigned
// integer of the key's width whose order is the order of the keys.
//
//   * signed integers: the sign bit flipped (INT_MIN maps to 0);
//   * unsigned integers and bool (a byte, 0 or 1): the bits as they are;
//   * floats (float32, float16, bfloat16): jnp.sort's and torch.sort's
//     order, canonical before the usual map.  -0 is taken as +0, so the two
//     zeros tie; every NaN, of either sign and any payload, is taken as the
//     one positive quiet NaN, so all NaNs tie after +inf.  Then a negative
//     key has every bit flipped and a positive one its sign bit.
//
// The image steers the digits and the comparisons only: the keys moved are
// the input's own bits, never the image turned back.  Equal images of
// integer keys are equal bits, so any sort gives the same rows; float keys
// that tie in the image (the zeros, the NaNs) keep their input order only
// in a stable sort (the radix sort, and the bitonic network on an
// (image, index) pair).
//
// The kinds' codes are kernels/_build.py's KEY_KINDS.

#pragma once

#include <stdint.h>

namespace {

enum KeyKind : int {
  kI32 = 0, kU32 = 1, kF32 = 2, kI16 = 3, kU16 = 4, kF16 = 5, kBF16 = 6, kI8 = 7, kU8 = 8
};

// The canonical image of the float whose bits are b: kSign its sign bit,
// kInf the bits of +inf, kNaN those of its positive quiet NaN.
template <uint32_t kSign, uint32_t kInf, uint32_t kNaN>
__host__ __device__ __forceinline__ uint32_t float_image(uint32_t b) {
  const uint32_t mag = b & (kSign - 1u);
  b = mag > kInf ? kNaN : (mag == 0u ? 0u : b);
  return (b & kSign) ? (b ^ (kSign | (kSign - 1u))) : (b ^ kSign);
}

template <int K>
struct Key;

// int32 keeps `int` storage: its path is the one the PSRS local sort has
// always run.
template <>
struct Key<kI32> {
  using T = int;
  static constexpr bool kFloat = false;
  __device__ __forceinline__ static uint32_t image(int x) {
    return static_cast<uint32_t>(x) ^ 0x80000000u;
  }
};
template <>
struct Key<kU32> {
  using T = uint32_t;
  static constexpr bool kFloat = false;
  __device__ __forceinline__ static uint32_t image(uint32_t x) { return x; }
};
template <>
struct Key<kF32> {
  using T = uint32_t;
  static constexpr bool kFloat = true;
  __device__ __forceinline__ static uint32_t image(uint32_t x) {
    return float_image<0x80000000u, 0x7f800000u, 0x7fc00000u>(x);
  }
};
template <>
struct Key<kI16> {
  using T = uint16_t;
  static constexpr bool kFloat = false;
  __device__ __forceinline__ static uint32_t image(uint16_t x) { return x ^ 0x8000u; }
};
template <>
struct Key<kU16> {
  using T = uint16_t;
  static constexpr bool kFloat = false;
  __device__ __forceinline__ static uint32_t image(uint16_t x) { return x; }
};
template <>
struct Key<kF16> {
  using T = uint16_t;
  static constexpr bool kFloat = true;
  __device__ __forceinline__ static uint32_t image(uint16_t x) {
    return float_image<0x8000u, 0x7c00u, 0x7e00u>(x);
  }
};
template <>
struct Key<kBF16> {
  using T = uint16_t;
  static constexpr bool kFloat = true;
  __device__ __forceinline__ static uint32_t image(uint16_t x) {
    return float_image<0x8000u, 0x7f80u, 0x7fc0u>(x);
  }
};
template <>
struct Key<kI8> {
  using T = uint8_t;
  static constexpr bool kFloat = false;
  __device__ __forceinline__ static uint32_t image(uint8_t x) { return x ^ 0x80u; }
};
template <>
struct Key<kU8> {
  using T = uint8_t;
  static constexpr bool kFloat = false;
  __device__ __forceinline__ static uint32_t image(uint8_t x) { return x; }
};

template <int K>
struct KindTag {
  static constexpr int value = K;
};

// f(KindTag<K>()) for the runtime kind `kind` (f a generic lambda that reads
// decltype(tag)::value); an unknown kind returns cudaErrorInvalidValue.
#define REPRO_KEY_CASE(K) \
  case K:                 \
    return f(KindTag<K>());
template <typename F>
int dispatch_key(int64_t kind, F&& f) {
  switch (kind) {
    REPRO_KEY_CASE(kI32)
    REPRO_KEY_CASE(kU32)
    REPRO_KEY_CASE(kF32)
    REPRO_KEY_CASE(kI16)
    REPRO_KEY_CASE(kU16)
    REPRO_KEY_CASE(kF16)
    REPRO_KEY_CASE(kBF16)
    REPRO_KEY_CASE(kI8)
    REPRO_KEY_CASE(kU8)
    default:
      return 1;  // cudaErrorInvalidValue
  }
}
#undef REPRO_KEY_CASE

}  // namespace
