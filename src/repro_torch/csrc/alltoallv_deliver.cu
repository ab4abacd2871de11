// PEMS2 direct message delivery (thesis §6.2) for Hopper (sm_90a): the
// P == 1 delivery (kernel 2) and the P > 1 mesh staging (kernel 4, below).
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

namespace {

// Mesh staging for P > 1 (kernel 4).
//
// Replaces the TPU kernel assemble_proc_tiles
// (src/repro/kernels/alltoallv_deliver/alltoallv_deliver.py:163, body
// _assemble_proc_kernel :137): out[p, d, j, :] = msgs[j, p, d, :], lanes at
// or past counts[j, p, d] replaced by the fill word, plus the fused counts
// transpose ct[p, d, j] = counts_payload[j, p, d].
//
// Design.  Word-level like deliver_kernel: it reads straight from the
// context store, one alpha-chunk of the exchange (Alg 7.1.3) for nq sending
// processes in one launch (a one-card mesh holds every process's rows).
// Sender q's local source j is row q*m + s0 + j; its message for
// destination process p's context c0 + dl sits at words
// src_off + (p*m + c0 + dl)*ww of that row, and its mask and counts words at
// cnt_off / cp_off + p*m + c0 + dl.  The message lands in the contiguous
// communication buffer at out[q][p][dl][j] (ww words), the counts word at
// ct[q][p][dl][j]: destination order, so the exchange ships out[q][p] to
// process p and lands it in p's rows without a transpose.
//
// Grid (ww-chunks, messages): blockIdx.y walks the nq*P*d*s messages, each
// thread moves words along ww with coalesced 4-byte accesses, masked lanes
// are written as the fill word without being read, and block x == 0's
// thread 0 moves the message's counts word.
//
// Bound.  A masked copy: it must write every buffer word and read the valid
// source words (plus the counts words: mask, payload, transposed); bytes,
// not operations, bound it.  Offsets are 64-bit (row * stride passes 2^31).
__global__ void assemble_kernel(const int* src, int64_t src_stride, int64_t src_off,
                                int64_t m, int64_t pn, int64_t s0, int64_t s,
                                int64_t c0, int64_t d, int64_t ww, int64_t n_msgs,
                                int* out, const int* cnt, int64_t cnt_stride,
                                int64_t cnt_off, int fill, const int* cp,
                                int64_t cp_stride, int64_t cp_off, int* ct) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t msg = blockIdx.y; msg < n_msgs; msg += gridDim.y) {
    // msg = ((q * pn + p) * d + dl) * s + j: the buffer's own order.
    const int64_t j = msg % s;
    int64_t r = msg / s;
    const int64_t dl = r % d;
    r /= d;
    const int64_t p = r % pn;
    const int64_t q = r / pn;
    const int64_t row = q * m + s0 + j;
    const int64_t col = p * m + c0 + dl;
    const int* in = src + row * src_stride + src_off + col * ww;
    int* o = out + msg * ww;
    int64_t valid = ww;
    if (cnt != nullptr) {
      const int64_t c = cnt[row * cnt_stride + cnt_off + col];
      valid = c < 0 ? 0 : (c < ww ? c : ww);
    }
    for (int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         w < ww; w += step) {
      o[w] = w < valid ? in[w] : fill;
    }
    if (ct != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
      ct[msg] = cp[row * cp_stride + cp_off + col];
    }
  }
}

}  // namespace

// Stage one chunk for nq senders: out is [nq, pn, d, s, ww] words, ct
// [nq, pn, d, s] (nullable with cp).  cnt (mask lengths, nullable) and cp
// are addressed like src: pointer, row stride, word offset.
extern "C" int repro_assemble_proc_words(int64_t device, const void* src,
                                         int64_t src_stride, int64_t src_off, int64_t m,
                                         int64_t pn, int64_t nq, int64_t s0, int64_t s,
                                         int64_t c0, int64_t d, int64_t ww, void* out,
                                         const void* cnt, int64_t cnt_stride,
                                         int64_t cnt_off, int64_t fill, const void* cp,
                                         int64_t cp_stride, int64_t cp_off, void* ct,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_msgs = nq * pn * d * s;
  if (n_msgs <= 0 || ww <= 0) return 0;
  int64_t chunks = (ww + kThreads * kWordsPerThread - 1) / (kThreads * kWordsPerThread);
  if (chunks > 65535) chunks = 65535;
  const int64_t rows = n_msgs < 65535 ? n_msgs : 65535;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(rows));
  assemble_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), src_stride, src_off, m, pn, s0, s, c0, d, ww,
      n_msgs, static_cast<int*>(out), static_cast<const int*>(cnt), cnt_stride,
      cnt_off, static_cast<int>(fill), static_cast<const int*>(cp), cp_stride,
      cp_off, static_cast<int*>(ct));
  return static_cast<int>(cudaGetLastError());
}
