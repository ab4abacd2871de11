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
// cnt_off / cp_off + p*m + c0 + dl.  The message (q, p, dl, j) lands at
// out + q*oq + p*op + dl*od + j*oj (ww contiguous words), its counts word at
// ct + q*tq + p*tp + dl*td + j*tj.  Two layouts take the same kernel: the
// contiguous [nq, pn, d, s, ww] communication buffer, which a mesh over
// several cards ships, and, on a one-card mesh, the receivers' recv rows
// themselves, rows[p, c0 + dl, q, s0 + j], so each message moves once.
//
// Bound.  A masked copy: it must write every destination word and read the
// valid source words plus the counts words (mask, payload, transposed);
// bytes, not operations, bound it.  At the full-scale alpha = 1 chunk (32
// messages of 2^23 words, 6 % of them valid) that is 1.14 GB, 0.34 ms at
// 3.35 TB/s, nearly all of it writes of fill words.
//
// What the design does about it.  Each block decodes its message once from
// blockIdx.y in 32-bit arithmetic (only row * stride is 64-bit: 16 rows of
// the store pass 2^31 words) and moves a span of span_vecs 16-byte vectors
// of it (the wrapper's 2048 words: two vectors a thread; one a thread pays
// the decode and the dependent counts load for every 16 bytes and ran at
// half the rate, scripts/assemble_sweep.py).  The vectors are aligned to the
// destination: every body store is one 16-byte store, fill lanes are
// stored without being read, and valid lanes are loaded 16 bytes at a time
// where the source has the destination's phase, 8 bytes where it is 8 bytes
// off (the store's row stride is 2 mod 4 words), else a word at a time.
// Block x == 0 also writes the message's up to three head words before the
// first 16-byte boundary, its up to three tail words, and its counts word.
__global__ void assemble_kernel(const int* __restrict__ src, int64_t src_stride,
                                int64_t src_off, int m, int pn, int s0, int s,
                                int c0, int d, int ww, int n_msgs,
                                int* __restrict__ out, int64_t oq, int64_t op,
                                int64_t od, int64_t oj, const int* cnt,
                                int64_t cnt_stride, int64_t cnt_off, int fill,
                                const int* cp, int64_t cp_stride, int64_t cp_off,
                                int* ct, int64_t tq, int64_t tp, int64_t td,
                                int64_t tj, int span_vecs) {
  for (int msg = blockIdx.y; msg < n_msgs; msg += gridDim.y) {
    // msg = ((q * pn + p) * d + dl) * s + j: the buffer's own order.
    const int j = msg % s;
    int r = msg / s;
    const int dl = r % d;
    r /= d;
    const int p = r % pn;
    const int q = r / pn;
    const int64_t row = static_cast<int64_t>(q) * m + s0 + j;
    const int col = p * m + c0 + dl;
    const int* in = src + row * src_stride + src_off + static_cast<int64_t>(col) * ww;
    int* o = out + q * oq + p * op + dl * od + j * oj;
    int valid = ww;
    if (cnt != nullptr) {
      const int c = cnt[row * cnt_stride + cnt_off + col];
      valid = c < 0 ? 0 : (c < ww ? c : ww);
    }
    // Words before o's first 16-byte boundary, the aligned body, the tail.
    int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(o) & 15)) & 15) >> 2;
    head = head < ww ? head : ww;
    const int nvec = (ww - head) >> 2;
    if (blockIdx.x == 0 && threadIdx.x < 8) {
      const int t = threadIdx.x;
      const int w = t < 4 ? t : head + 4 * nvec + t - 4;
      if (w < (t < 4 ? head : ww)) o[w] = w < valid ? in[w] : fill;
      if (t == 0 && ct != nullptr) {
        ct[q * tq + p * tp + dl * td + j * tj] = cp[row * cp_stride + cp_off + col];
      }
    }
    const int* iv = in + head;
    int4* ov = reinterpret_cast<int4*>(o + head);
    const int lanes = valid - head;   // valid words of the body (may be < 0)
    const uintptr_t phase = reinterpret_cast<uintptr_t>(iv) & 15;
    const int step = gridDim.x * span_vecs;
    for (int t0 = blockIdx.x * span_vecs; t0 < nvec; t0 += step) {
      const int t1 = t0 + span_vecs < nvec ? t0 + span_vecs : nvec;
      for (int t = t0 + threadIdx.x; t < t1; t += blockDim.x) {
        const int w = 4 * t;
        int4 x;
        if (w >= lanes) {
          x = make_int4(fill, fill, fill, fill);
        } else if (w + 4 <= lanes && phase == 0) {
          x = __ldg(reinterpret_cast<const int4*>(iv + w));
        } else if (w + 4 <= lanes && phase == 8) {
          const int2 a = __ldg(reinterpret_cast<const int2*>(iv + w));
          const int2 b = __ldg(reinterpret_cast<const int2*>(iv + w + 2));
          x = make_int4(a.x, a.y, b.x, b.y);
        } else {
          x.x = __ldg(iv + w);
          x.y = w + 1 < lanes ? __ldg(iv + w + 1) : fill;
          x.z = w + 2 < lanes ? __ldg(iv + w + 2) : fill;
          x.w = w + 3 < lanes ? __ldg(iv + w + 3) : fill;
        }
        ov[t] = x;
      }
    }
  }
}

}  // namespace

// Stage one chunk for nq senders.  Message (q, p, dl, j) lands at
// out + q*oq + p*op + dl*od + j*oj (ww contiguous words; strides in words),
// its counts word at ct + q*tq + p*tp + dl*td + j*tj (nullable with cp).
// cnt (mask lengths, nullable) and cp are addressed like src: pointer, row
// stride, word offset.  span: words a block moves of a message (a multiple
// of 4).  The sizes must fit in 32 bits (the wrapper checks).
extern "C" int repro_assemble_proc_words(
    int64_t device, const void* src, int64_t src_stride, int64_t src_off, int64_t m,
    int64_t pn, int64_t nq, int64_t s0, int64_t s, int64_t c0, int64_t d, int64_t ww,
    void* out, int64_t oq, int64_t op, int64_t od, int64_t oj, const void* cnt,
    int64_t cnt_stride, int64_t cnt_off, int64_t fill, const void* cp, int64_t cp_stride,
    int64_t cp_off, void* ct, int64_t tq, int64_t tp, int64_t td, int64_t tj,
    int64_t span, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_msgs = nq * pn * d * s;
  if (n_msgs <= 0 || ww <= 0) return 0;
  const int64_t span_vecs = span / 4;
  int64_t spans = (ww / 4 + span_vecs - 1) / span_vecs;
  spans = spans < 1 ? 1 : (spans > 65535 ? 65535 : spans);
  const int64_t msgs = n_msgs < 65535 ? n_msgs : 65535;
  const dim3 grid(static_cast<unsigned>(spans), static_cast<unsigned>(msgs));
  assemble_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), src_stride, src_off, static_cast<int>(m),
      static_cast<int>(pn), static_cast<int>(s0), static_cast<int>(s),
      static_cast<int>(c0), static_cast<int>(d), static_cast<int>(ww),
      static_cast<int>(n_msgs), static_cast<int*>(out), oq, op, od, oj,
      static_cast<const int*>(cnt), cnt_stride, cnt_off, static_cast<int>(fill),
      static_cast<const int*>(cp), cp_stride, cp_off, static_cast<int*>(ct), tq, tp,
      td, tj, static_cast<int>(span_vecs));
  return static_cast<int>(cudaGetLastError());
}
