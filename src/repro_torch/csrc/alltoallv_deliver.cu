// PEMS2 direct message delivery (thesis §6.2) for Hopper (sm_90a).
//
// Replaces the TPU kernel deliver_tiles
// (src/repro/kernels/alltoallv_deliver/alltoallv_deliver.py:79, body
// _deliver_kernel :54): out[d, s, :] = msgs[s, d, :], lanes at or past
// counts[s, d] replaced by a fill word, plus the fused counts transpose
// ct[d, s] = counts_payload[s, d].
//
// Design.  The kernel works on raw 32-bit words addressed as
// (pointer, row stride, word offset), so the collective layer hands it the
// context store itself: message (s -> d) is read from row s, words
// [src_off + d*ww, +ww) and written straight into row d, words
// [dst_off + s*ww, +ww).  That is the thesis' direct delivery — each message
// lands in its destination context with no [v, v, ww] temporary.  The same
// entry serves the [v, v, ww] array form (row stride v*ww, offset 0).  Source
// and destination ranges must not overlap; the caller delivers through a
// temporary when they do (send field == recv field).
//
// Grid (ww-chunks, src, dst); each thread moves words along ww with
// coalesced 4-byte accesses.  Masked lanes are written as the fill word
// without being read.  Block (0, s, d) thread 0 also moves the one counts
// word (s, d) -> (d, s), so the transpose rides in the same launch.
//
// Bound.  The function must write all v*v*ww destination words and read the
// sum(counts) valid source words (plus the v*v counts words twice):
// at full-scale PSRS (v = 16, ww = 2^23, n = 2^27 valid keys) that is
// 8 GiB + 512 MiB, 2.7 ms at 3.35 TB/s; bytes, not operations, bound it.
// Unmasked (no fill) it reads every word: 2*v*v*ww*4 bytes.
//
// Offsets are 64-bit: v * row stride exceeds 2^31 words at full scale.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 4;

__global__ void deliver_kernel(const int* src, int64_t src_stride, int64_t src_off,
                               int* dst, int64_t dst_stride, int64_t dst_off,
                               int64_t ww, const int* cnt, int64_t cnt_stride,
                               int64_t cnt_off, int fill, const int* cp,
                               int64_t cp_stride, int64_t cp_off, int* ct,
                               int64_t ct_stride, int64_t ct_off) {
  const int64_t s = blockIdx.y;
  const int64_t d = blockIdx.z;
  const int* in = src + s * src_stride + src_off + d * ww;
  int* out = dst + d * dst_stride + dst_off + s * ww;
  int64_t valid = ww;
  if (cnt != nullptr) {
    const int64_t c = cnt[s * cnt_stride + cnt_off + d];
    valid = c < 0 ? 0 : (c < ww ? c : ww);
  }
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < ww; j += step) {
    out[j] = j < valid ? in[j] : fill;
  }
  if (ct != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    ct[d * ct_stride + ct_off + s] = cp[s * cp_stride + cp_off + d];
  }
}

}  // namespace

// Deliver the v*v messages of ww words each.  cnt (mask lengths, nullable),
// cp (counts words to transpose, nullable) and ct (its destination) are
// addressed like src/dst: pointer, row stride, word offset.
extern "C" int repro_deliver_words(int64_t device, const void* src, int64_t src_stride,
                                   int64_t src_off, void* dst, int64_t dst_stride,
                                   int64_t dst_off, int64_t v, int64_t ww,
                                   const void* cnt, int64_t cnt_stride, int64_t cnt_off,
                                   int64_t fill, const void* cp, int64_t cp_stride,
                                   int64_t cp_off, void* ct, int64_t ct_stride,
                                   int64_t ct_off, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (v <= 0 || ww <= 0) return 0;
  int64_t chunks = (ww + kThreads * kWordsPerThread - 1) / (kThreads * kWordsPerThread);
  if (chunks > 65535) chunks = 65535;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(v),
                  static_cast<unsigned>(v));
  deliver_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), src_stride, src_off, static_cast<int*>(dst),
      dst_stride, dst_off, ww, static_cast<const int*>(cnt), cnt_stride, cnt_off,
      static_cast<int>(fill), static_cast<const int*>(cp), cp_stride, cp_off,
      static_cast<int*>(ct), ct_stride, ct_off);
  return static_cast<int>(cudaGetLastError());
}
