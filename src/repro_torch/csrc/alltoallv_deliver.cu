// PEMS2 direct message delivery (thesis §6.2) for Hopper (sm_90a): the
// P == 1 delivery (kernel 2) and the P > 1 mesh staging (kernel 4, below).
//
// Replaces the TPU kernel deliver_tiles
// (src/repro/kernels/alltoallv_deliver/alltoallv_deliver.py:79, body
// _deliver_kernel :54): out[d, s, :] = msgs[s, d, :], lanes at or past
// counts[s, d] replaced by the fill element, plus the fused counts transpose
// ct[d, s] = counts_payload[s, d].
//
// Design.  The kernel works on raw elements of 1, 2 or 4 bytes addressed as
// (pointer, row stride, element offset), so the collective layer hands it the
// context store itself, in 4-byte words: message (s -> d) is read from row s,
// words [src_off + d*ww, +ww) and written straight into row d, words
// [dst_off + s*ww, +ww).  That is the thesis' direct delivery — each message
// lands in its destination context with no [v, v, ww] temporary.  The same
// entry serves the [v, v, ω] array form of any 1-, 2- or 4-byte payload (row
// stride v*ω, offset 0), as the TPU kernel moves any element size.  Source
// and destination ranges must not overlap; the caller delivers through a
// temporary when they do (send field == recv field).
//
// Grid (ww-chunks, src, dst); each thread moves words along ww with
// coalesced 4-byte accesses.  Masked lanes are written as the fill word
// without being read.  Block (0, s, d) thread 0 also moves the one counts
// element (s, d) -> (d, s) (1, 2 or 4 bytes), so the transpose rides in the
// same launch.  Elements of 1 or 2 bytes move as whole words too where every
// row, offset and message is whole words (deliver_packed_kernel): the counts
// are in elements, and only the word holding a message's count is masked, its
// valid bytes kept and the rest taken from the fill element; otherwise
// (ω = 3 of int8, say) an element at a time (deliver_kernel<uint8_t>).
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

// The storage of an element of ES bytes.
template <int ES>
struct Elem;
template <>
struct Elem<1> {
  using type = uint8_t;
};
template <>
struct Elem<2> {
  using type = uint16_t;
};
template <>
struct Elem<4> {
  using type = int;
};

// Element i of the ces-byte elements at p, stored as element j of q.
__device__ __forceinline__ void copy_elem(void* q, int64_t j, const void* p, int64_t i,
                                          int ces) {
  if (ces == 4)
    static_cast<int*>(q)[j] = static_cast<const int*>(p)[i];
  else if (ces == 2)
    static_cast<uint16_t*>(q)[j] = static_cast<const uint16_t*>(p)[i];
  else
    static_cast<uint8_t*>(q)[j] = static_cast<const uint8_t*>(p)[i];
}

// A fill element of es bytes repeated over a 4-byte word.
int fill_word(int64_t fill, int64_t es) {
  if (es == 1) return static_cast<int>((fill & 0xff) * 0x01010101u);
  if (es == 2) return static_cast<int>((fill & 0xffff) * 0x00010001u);
  return static_cast<int>(fill);
}

// One element of T at a time (T int: the 4-byte words of the store).
template <typename T>
__global__ void deliver_kernel(const T* src, int64_t src_stride, int64_t src_off,
                               T* dst, int64_t dst_stride, int64_t dst_off,
                               int64_t ww, const int* cnt, int64_t cnt_stride,
                               int64_t cnt_off, T fill, const void* cp,
                               int64_t cp_stride, int64_t cp_off, void* ct,
                               int64_t ct_stride, int64_t ct_off, int ces) {
  const int64_t s = blockIdx.y;
  const int64_t d = blockIdx.z;
  const T* in = src + s * src_stride + src_off + d * ww;
  T* out = dst + d * dst_stride + dst_off + s * ww;
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
    copy_elem(ct, d * ct_stride + ct_off + s, cp, s * cp_stride + cp_off + d, ces);
  }
}

// Elements of ES (1 or 2) bytes whose rows, offsets and messages are whole
// words, moved a word at a time (strides, offsets and ww in words; omega,
// the counts and fillw, the fill element repeated, in elements).
template <int ES>
__global__ void deliver_packed_kernel(const int* src, int64_t src_stride, int64_t src_off,
                                      int* dst, int64_t dst_stride, int64_t dst_off,
                                      int64_t ww, int64_t omega, const int* cnt,
                                      int64_t cnt_stride, int64_t cnt_off, int fillw,
                                      const void* cp, int64_t cp_stride, int64_t cp_off,
                                      void* ct, int64_t ct_stride, int64_t ct_off, int ces) {
  const int64_t s = blockIdx.y;
  const int64_t d = blockIdx.z;
  const int* in = src + s * src_stride + src_off + d * ww;
  int* out = dst + d * dst_stride + dst_off + s * ww;
  int64_t vb = 4 * ww;  // valid bytes
  if (cnt != nullptr) {
    const int64_t c = cnt[s * cnt_stride + cnt_off + d];
    vb = (c < 0 ? 0 : (c < omega ? c : omega)) * ES;
  }
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < ww; j += step) {
    const int64_t b = 4 * j;
    int x;
    if (b + 4 <= vb) {
      x = in[j];
    } else if (b >= vb) {
      x = fillw;
    } else {  // the word holding the count: its first vb - b bytes are valid
      const unsigned keep = (1u << (8 * (vb - b))) - 1u;
      x = static_cast<int>((static_cast<unsigned>(in[j]) & keep) |
                           (static_cast<unsigned>(fillw) & ~keep));
    }
    out[j] = x;
  }
  if (ct != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    copy_elem(ct, d * ct_stride + ct_off + s, cp, s * cp_stride + cp_off + d, ces);
  }
}

template <typename T>
cudaError_t launch_deliver(const void* src, int64_t src_stride, int64_t src_off, void* dst,
                           int64_t dst_stride, int64_t dst_off, int64_t v, int64_t ww,
                           const void* cnt, int64_t cnt_stride, int64_t cnt_off, int64_t fill,
                           const void* cp, int64_t cp_stride, int64_t cp_off, void* ct,
                           int64_t ct_stride, int64_t ct_off, int64_t ces, cudaStream_t stream) {
  int64_t chunks = (ww + kThreads * kWordsPerThread - 1) / (kThreads * kWordsPerThread);
  if (chunks > 65535) chunks = 65535;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(v),
                  static_cast<unsigned>(v));
  deliver_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), src_stride, src_off, static_cast<T*>(dst), dst_stride,
      dst_off, ww, static_cast<const int*>(cnt), cnt_stride, cnt_off, static_cast<T>(fill), cp,
      cp_stride, cp_off, ct, ct_stride, ct_off, static_cast<int>(ces));
  return cudaGetLastError();
}

template <int ES>
cudaError_t launch_packed(const void* src, int64_t src_stride, int64_t src_off, void* dst,
                          int64_t dst_stride, int64_t dst_off, int64_t v, int64_t ww,
                          const void* cnt, int64_t cnt_stride, int64_t cnt_off, int64_t fill,
                          const void* cp, int64_t cp_stride, int64_t cp_off, void* ct,
                          int64_t ct_stride, int64_t ct_off, int64_t ces, cudaStream_t stream) {
  constexpr int64_t per = 4 / ES;  // elements a word
  const int64_t words = ww / per;
  int64_t chunks = (words + kThreads * kWordsPerThread - 1) / (kThreads * kWordsPerThread);
  if (chunks > 65535) chunks = 65535;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(v),
                  static_cast<unsigned>(v));
  deliver_packed_kernel<ES><<<grid, kThreads, 0, stream>>>(
      static_cast<const int*>(src), src_stride / per, src_off / per, static_cast<int*>(dst),
      dst_stride / per, dst_off / per, words, ww, static_cast<const int*>(cnt), cnt_stride,
      cnt_off, fill_word(fill, ES), cp, cp_stride, cp_off, ct, ct_stride, ct_off,
      static_cast<int>(ces));
  return cudaGetLastError();
}

// Whether elements of es bytes at p (row stride and offset in elements) lie
// in whole words, row by row.
bool whole_words(const void* p, int64_t stride, int64_t off, int64_t es) {
  return reinterpret_cast<uintptr_t>(p) % 4 == 0 && stride * es % 4 == 0 && off * es % 4 == 0;
}

}  // namespace

// Deliver the v*v messages of ww elements of es (1, 2 or 4) bytes each; src
// and dst strides and offsets are in those elements.  cnt (mask lengths in
// elements, int32, nullable), cp (the ces-byte counts elements to transpose,
// nullable) and ct (its destination) are addressed like src/dst: pointer, row
// stride, element offset.  fill: the fill element's bits (its low es bytes).
extern "C" int repro_deliver_words(int64_t device, const void* src, int64_t src_stride,
                                   int64_t src_off, void* dst, int64_t dst_stride,
                                   int64_t dst_off, int64_t v, int64_t ww,
                                   const void* cnt, int64_t cnt_stride, int64_t cnt_off,
                                   int64_t fill, const void* cp, int64_t cp_stride,
                                   int64_t cp_off, void* ct, int64_t ct_stride,
                                   int64_t ct_off, int64_t es, int64_t ces, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (v <= 0 || ww <= 0) return 0;
  if ((es != 1 && es != 2 && es != 4) ||
      (ct != nullptr && (cp == nullptr || (ces != 1 && ces != 2 && ces != 4))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool packed = es < 4 && ww * es % 4 == 0 && whole_words(src, src_stride, src_off, es) &&
                      whole_words(dst, dst_stride, dst_off, es);
#define REPRO_DELIVER_ARGS                                                              \
  src, src_stride, src_off, dst, dst_stride, dst_off, v, ww, cnt, cnt_stride, cnt_off, \
      fill, cp, cp_stride, cp_off, ct, ct_stride, ct_off, ces, st
  if (es == 4) err = launch_deliver<int>(REPRO_DELIVER_ARGS);
  else if (packed && es == 2) err = launch_packed<2>(REPRO_DELIVER_ARGS);
  else if (packed) err = launch_packed<1>(REPRO_DELIVER_ARGS);
  else if (es == 2) err = launch_deliver<uint16_t>(REPRO_DELIVER_ARGS);
  else err = launch_deliver<uint8_t>(REPRO_DELIVER_ARGS);
#undef REPRO_DELIVER_ARGS
  return static_cast<int>(err);
}

namespace {

// Mesh staging for P > 1 (kernel 4).
//
// Replaces the TPU kernel assemble_proc_tiles
// (src/repro/kernels/alltoallv_deliver/alltoallv_deliver.py:163, body
// _assemble_proc_kernel :137): out[p, d, j, :] = msgs[j, p, d, :], lanes at
// or past counts[j, p, d] replaced by the fill element, plus the fused counts
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
// Elements of 1 or 2 bytes (ES) take the same design in bytes: the head and
// tail are the up to 15 bytes outside the 16-byte body, the counts are in
// elements, and a body vector is loaded 16, 8 or 4 bytes at a time where the
// source's phase allows it and it holds no count, else (the vector holding
// the count, or a source at an odd phase, as ω = 3 of int8 gives) an element
// at a time; the fill element fills the rest.  At 4 bytes the kernel is the
// word kernel above.
template <int ES>
__device__ __forceinline__ int4 gather(const typename Elem<ES>::type* p, int n,
                                       typename Elem<ES>::type fe) {
  constexpr int H = 16 / ES;
  union {
    int4 v;
    typename Elem<ES>::type e[H];
  } u;
#pragma unroll
  for (int i = 0; i < H; ++i) u.e[i] = i < n ? __ldg(p + i) : fe;
  return u.v;
}

template <int ES>
__global__ void assemble_kernel(const typename Elem<ES>::type* __restrict__ src,
                                int64_t src_stride, int64_t src_off, int m, int pn, int s0,
                                int s, int c0, int d, int ww, int n_msgs,
                                typename Elem<ES>::type* __restrict__ out, int64_t oq,
                                int64_t op, int64_t od, int64_t oj, const int* cnt,
                                int64_t cnt_stride, int64_t cnt_off, int fill,
                                const void* cp, int64_t cp_stride, int64_t cp_off, void* ct,
                                int64_t tq, int64_t tp, int64_t td, int64_t tj, int ces,
                                int span_vecs) {
  using T = typename Elem<ES>::type;
  constexpr int H = 16 / ES;              // elements of a 16-byte vector
  constexpr int SHIFT = ES == 4 ? 2 : ES - 1;   // log2 ES
  const T fe = static_cast<T>(fill);      // fill: the fill element in every lane of a word
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
    const T* in = src + row * src_stride + src_off + static_cast<int64_t>(col) * ww;
    T* o = out + q * oq + p * op + dl * od + j * oj;
    int valid = ww;
    if (cnt != nullptr) {
      const int c = cnt[row * cnt_stride + cnt_off + col];
      valid = c < 0 ? 0 : (c < ww ? c : ww);
    }
    // Elements before o's first 16-byte boundary, the aligned body, the tail.
    int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(o) & 15)) & 15) >> SHIFT;
    head = head < ww ? head : ww;
    const int nvec = (ww - head) >> (4 - SHIFT);
    if (blockIdx.x == 0 && threadIdx.x < 2 * H) {
      const int t = threadIdx.x;
      const int w = t < H ? t : head + H * nvec + t - H;
      if (w < (t < H ? head : ww)) o[w] = w < valid ? in[w] : fe;
      if (t == 0 && ct != nullptr) {
        copy_elem(ct, q * tq + p * tp + dl * td + j * tj, cp, row * cp_stride + cp_off + col,
                  ces);
      }
    }
    const T* iv = in + head;
    int4* ov = reinterpret_cast<int4*>(o + head);
    const int lanes = valid - head;   // valid elements of the body (may be < 0)
    const uintptr_t phase = reinterpret_cast<uintptr_t>(iv) & 15;
    const int step = gridDim.x * span_vecs;
    for (int t0 = blockIdx.x * span_vecs; t0 < nvec; t0 += step) {
      const int t1 = t0 + span_vecs < nvec ? t0 + span_vecs : nvec;
      for (int t = t0 + threadIdx.x; t < t1; t += blockDim.x) {
        const int w = H * t;
        int4 x;
        if (w >= lanes) {
          x = make_int4(fill, fill, fill, fill);
        } else if (w + H <= lanes && phase == 0) {
          x = __ldg(reinterpret_cast<const int4*>(iv + w));
        } else if (w + H <= lanes && phase == 8) {
          const int2 a = __ldg(reinterpret_cast<const int2*>(iv + w));
          const int2 b = __ldg(reinterpret_cast<const int2*>(iv + w) + 1);
          x = make_int4(a.x, a.y, b.x, b.y);
        } else if constexpr (ES == 4) {
          x.x = __ldg(iv + w);
          x.y = w + 1 < lanes ? __ldg(iv + w + 1) : fill;
          x.z = w + 2 < lanes ? __ldg(iv + w + 2) : fill;
          x.w = w + 3 < lanes ? __ldg(iv + w + 3) : fill;
        } else if (w + H <= lanes && (phase & 3) == 0) {
          const int* iw = reinterpret_cast<const int*>(iv + w);
          x = make_int4(__ldg(iw), __ldg(iw + 1), __ldg(iw + 2), __ldg(iw + 3));
        } else {
          x = gather<ES>(iv + w, lanes - w, fe);
        }
        ov[t] = x;
      }
    }
  }
}

template <int ES>
cudaError_t launch_assemble(const void* src, int64_t src_stride, int64_t src_off, int64_t m,
                            int64_t pn, int64_t s0, int64_t s, int64_t c0, int64_t d,
                            int64_t ww, int64_t n_msgs, void* out, int64_t oq, int64_t op,
                            int64_t od, int64_t oj, const void* cnt, int64_t cnt_stride,
                            int64_t cnt_off, int64_t fill, const void* cp, int64_t cp_stride,
                            int64_t cp_off, void* ct, int64_t tq, int64_t tp, int64_t td,
                            int64_t tj, int64_t ces, int64_t span_vecs, cudaStream_t stream) {
  using T = typename Elem<ES>::type;
  int64_t spans = (ww * ES / 16 + span_vecs - 1) / span_vecs;
  spans = spans < 1 ? 1 : (spans > 65535 ? 65535 : spans);
  const int64_t msgs = n_msgs < 65535 ? n_msgs : 65535;
  const dim3 grid(static_cast<unsigned>(spans), static_cast<unsigned>(msgs));
  assemble_kernel<ES><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), src_stride, src_off, static_cast<int>(m),
      static_cast<int>(pn), static_cast<int>(s0), static_cast<int>(s), static_cast<int>(c0),
      static_cast<int>(d), static_cast<int>(ww), static_cast<int>(n_msgs),
      static_cast<T*>(out), oq, op, od, oj, static_cast<const int*>(cnt), cnt_stride, cnt_off,
      fill_word(fill, ES), cp, cp_stride, cp_off, ct, tq, tp, td, tj, static_cast<int>(ces),
      static_cast<int>(span_vecs));
  return cudaGetLastError();
}

}  // namespace

// Stage one chunk for nq senders, of elements of es (1, 2 or 4) bytes; every
// stride and offset below is in those elements.  Message (q, p, dl, j) lands
// at out + q*oq + p*op + dl*od + j*oj (ww contiguous elements), its counts
// element (ces bytes) at ct + q*tq + p*tp + dl*td + j*tj (nullable with cp).
// cnt (mask lengths in elements, int32, nullable) and cp are addressed like
// src: pointer, row stride, element offset.  fill: the fill element's bits.
// span: 4-byte words a block moves of a message (a multiple of 4).  The sizes
// must fit in 32 bits (the wrapper checks).
extern "C" int repro_assemble_proc_words(
    int64_t device, const void* src, int64_t src_stride, int64_t src_off, int64_t m,
    int64_t pn, int64_t nq, int64_t s0, int64_t s, int64_t c0, int64_t d, int64_t ww,
    void* out, int64_t oq, int64_t op, int64_t od, int64_t oj, const void* cnt,
    int64_t cnt_stride, int64_t cnt_off, int64_t fill, const void* cp, int64_t cp_stride,
    int64_t cp_off, void* ct, int64_t tq, int64_t tp, int64_t td, int64_t tj,
    int64_t span, int64_t es, int64_t ces, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_msgs = nq * pn * d * s;
  if (n_msgs <= 0 || ww <= 0) return 0;
  if ((es != 1 && es != 2 && es != 4) ||
      (ct != nullptr && (cp == nullptr || (ces != 1 && ces != 2 && ces != 4))))
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_ASSEMBLE_ARGS                                                               \
  src, src_stride, src_off, m, pn, s0, s, c0, d, ww, n_msgs, out, oq, op, od, oj, cnt,   \
      cnt_stride, cnt_off, fill, cp, cp_stride, cp_off, ct, tq, tp, td, tj, ces, span / 4, \
      static_cast<cudaStream_t>(stream)
  if (es == 4) err = launch_assemble<4>(REPRO_ASSEMBLE_ARGS);
  else if (es == 2) err = launch_assemble<2>(REPRO_ASSEMBLE_ARGS);
  else err = launch_assemble<1>(REPRO_ASSEMBLE_ARGS);
#undef REPRO_ASSEMBLE_ARGS
  return static_cast<int>(err);
}
