// Bitonic sorting network for Hopper (sm_90a): the PSRS local sort of rows
// that fit one shared-memory segment, and the k-way merge's tile sort of
// tiles larger than kway_merge.cu's warp-register sort takes.
//
// The TPU kernels bitonic_sort_rows (src/repro/kernels/bitonic_sort/
// bitonic_sort.py:44) and merge_tile_grid (src/repro/kernels/kway_merge/
// kway_merge.py:65, network sort_tile_rows :35) run a bitonic network: for
// stage = 0 .. log2(n)-1 and sub = stage .. 0, elements i and i + 2^sub (bit
// sub of i clear) are compare-exchanged, ascending iff bit (stage+1) of i is
// 0 (src/repro/kernels/bitonic_sort/bitonic_sort.py:31-35).  The PSRS local
// sort is the radix sort of radix_sort.cu; a row of 2^13 keys or fewer takes
// this file's one shared-memory pass instead.  The k-way merge sorts its
// tiles in warp registers (kway_merge.cu); a tile of more than 1024 keys
// comes here.  Entry point: repro_bitonic_sort_rows.
//
// Design.  The TPU kernel keeps a whole row in VMEM; a Hopper block may use
// 227 KB of shared memory, so the network is split:
//   * a shared-memory pass (smem_stages) loads one 2^13-element segment
//     (32 KiB) per block, runs every compare-exchange whose stride is below
//     the segment, and writes the segment back;
//   * one global-memory pass (global_step) per larger stride.
// A row of n = 2^L elements, L > 13, costs 1 + sum_{s=13}^{L-1} (s - 12) + (L - 13)
// passes, each reading and writing the whole batch once with coalesced 4-byte
// accesses; a row of 2^13 or fewer costs the one shared-memory pass.  Bytes
// bound it: a row that fits one segment is read once and written once.
//
// Keys.  Every kind of sort_keys.cuh.  The network sorts a word made from
// each key (Net below): an int32 key as it is, another integer key as its
// order-preserving image, and a float key as its image above its index in
// the row, so that keys that tie in the image (the two zeros, the NaNs) keep
// their input order, as jnp.sort's and torch.sort(stable=True)'s do; the
// float key's own bits come back by that index from the input row.  A float
// row takes the one shared-memory pass only (n <= 2^13; the wrapper hands
// longer ones to the radix sort), and float32's 8-byte words make that pass
// 64 KiB of shared memory.
//
// Offsets are 64-bit throughout: a batch may exceed 2^31 elements.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sort_keys.cuh"

namespace {

constexpr int kSegLog = 13;      // 8192 keys of shared memory per block
constexpr int kMaxThreads = 1024;
constexpr int kStepThreads = 256;

template <typename W>
__device__ __forceinline__ void compare_exchange(W& a, W& b, bool asc) {
  const W lo = b < a ? b : a;
  const W hi = b < a ? a : b;
  a = asc ? lo : hi;
  b = asc ? hi : lo;
}

// The word the network sorts for a key of kind K: encode(key, index in the
// row segment), and decode(word, the segment's input) gives the key back.
template <int K, bool kFloat = Key<K>::kFloat>
struct Net;

// int32: the key itself, compared signed (the local sort's path since its
// port).
template <>
struct Net<kI32, false> {
  using W = int;
  __device__ __forceinline__ static int encode(int x, int) { return x; }
  __device__ __forceinline__ static int decode(int w, const int*) { return w; }
};

// Other integer kinds: the image (an XOR with the image of 0), compared
// unsigned, turned back by the same XOR.
template <int K>
struct Net<K, false> {
  using T = typename Key<K>::T;
  using W = uint32_t;
  __device__ __forceinline__ static W encode(T x, int) { return Key<K>::image(x); }
  __device__ __forceinline__ static T decode(W w, const T*) {
    return static_cast<T>(w ^ Key<K>::image(T(0)));
  }
};

// Float kinds: the image above the index, read back from the input.
template <int K>
struct Net<K, true> {
  using T = typename Key<K>::T;
  static constexpr int kBits = 8 * sizeof(T);
  using W = typename std::conditional<sizeof(T) == 4, uint64_t, uint32_t>::type;
  __device__ __forceinline__ static W encode(T x, int i) {
    return (static_cast<W>(Key<K>::image(x)) << kBits) | static_cast<W>(i);
  }
  __device__ __forceinline__ static T decode(W w, const T* seg) {
    return seg[static_cast<int>(w & ((W(1) << kBits) - 1))];
  }
};

// Stages [stage_lo, stage_hi] of the network, restricted to strides below the
// 2^seg_log segment, on every segment of the batch (one block per segment).
// Input rows are in_stride elements apart (a strided view of the context
// store); output rows are contiguous.  `in` and `out` may alias (in_stride
// == n, integer kinds only): each block reads its segment fully before
// writing it.
template <int K>
__global__ void smem_stages(const typename Key<K>::T* in, int64_t in_stride,
                            typename Key<K>::T* out, int log_n, int seg_log, int stage_lo,
                            int stage_hi) {
  using T = typename Key<K>::T;
  using W = typename Net<K>::W;
  extern __shared__ __align__(16) unsigned char seg_raw[];
  W* seg_buf = reinterpret_cast<W*>(seg_raw);
  const int seg = 1 << seg_log;
  const int64_t first = static_cast<int64_t>(blockIdx.x) << seg_log;  // flat
  const int64_t row_pos = first & ((int64_t(1) << log_n) - 1);        // in row
  const T* src = in + (first >> log_n) * in_stride + row_pos;
  for (int e = threadIdx.x; e < seg; e += blockDim.x) seg_buf[e] = Net<K>::encode(src[e], e);
  __syncthreads();
  for (int stage = stage_lo; stage <= stage_hi; ++stage) {
    const int sub_hi = stage < seg_log - 1 ? stage : seg_log - 1;
    for (int sub = sub_hi; sub >= 0; --sub) {
      const int stride = 1 << sub;
      for (int p = threadIdx.x; p < seg / 2; p += blockDim.x) {
        const int i = ((p >> sub) << (sub + 1)) | (p & (stride - 1));
        const bool asc = (((row_pos + i) >> (stage + 1)) & 1) == 0;
        W a = seg_buf[i];
        W b = seg_buf[i + stride];
        compare_exchange(a, b, asc);
        seg_buf[i] = a;
        seg_buf[i + stride] = b;
      }
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < seg; e += blockDim.x)
    out[first + e] = Net<K>::decode(seg_buf[e], src);
}

// One compare-exchange step (stage, sub) over the whole [rows, 2^log_n] batch
// (integer kinds).
template <int K>
__global__ void global_step(typename Key<K>::T* x, int64_t rows, int log_n, int stage,
                            int sub) {
  using T = typename Key<K>::T;
  using W = typename Net<K>::W;
  const int64_t half_log = log_n - 1;
  const int64_t pairs = rows << half_log;
  const int64_t stride = int64_t(1) << sub;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < pairs; t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = t >> half_log;
    const int64_t p = t & ((int64_t(1) << half_log) - 1);
    const int64_t i = ((p >> sub) << (sub + 1)) | (p & (stride - 1));
    const bool asc = ((i >> (stage + 1)) & 1) == 0;
    T* row = x + (r << log_n);
    W a = Net<K>::encode(row[i], 0);
    W b = Net<K>::encode(row[i + stride], 0);
    compare_exchange(a, b, asc);
    row[i] = Net<K>::decode(a, nullptr);
    row[i + stride] = Net<K>::decode(b, nullptr);
  }
}

template <int K>
int sort_rows(const void* in_, int64_t in_stride, void* out_, int64_t rows, int64_t n,
              cudaStream_t st) {
  using T = typename Key<K>::T;
  const T* in = static_cast<const T*>(in_);
  T* o = static_cast<T*>(out_);
  int log_n = 0;
  while ((int64_t(1) << log_n) < n) ++log_n;
  if (Key<K>::kFloat && log_n > kSegLog) return static_cast<int>(cudaErrorInvalidValue);
  const int seg_log = log_n < kSegLog ? log_n : kSegLog;
  const int seg = 1 << seg_log;
  const int threads = seg / 2 < 1 ? 1 : (seg / 2 < kMaxThreads ? seg / 2 : kMaxThreads);
  const int64_t segments = rows << (log_n - seg_log);
  const size_t smem = static_cast<size_t>(seg) * sizeof(typename Net<K>::W);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        smem_stages<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  smem_stages<K><<<static_cast<unsigned>(segments), threads, smem, st>>>(
      in, in_stride, o, log_n, seg_log, 0, seg_log - 1);
  if constexpr (!Key<K>::kFloat) {
    const int64_t pairs = rows << (log_n > 0 ? log_n - 1 : 0);
    int64_t step_blocks = (pairs + kStepThreads - 1) / kStepThreads;
    if (step_blocks > (int64_t(1) << 20)) step_blocks = int64_t(1) << 20;
    for (int stage = seg_log; stage < log_n; ++stage) {
      for (int sub = stage; sub >= seg_log; --sub) {
        global_step<K><<<static_cast<unsigned>(step_blocks), kStepThreads, 0, st>>>(
            o, rows, log_n, stage, sub);
      }
      smem_stages<K><<<static_cast<unsigned>(segments), threads, smem, st>>>(
          o, int64_t(1) << log_n, o, log_n, seg_log, stage, stage);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Ascending sort of each row of in[rows, n] (n a power of two, rows
// in_stride elements apart, keys of KeyKind `kind`) into the contiguous
// out[rows, n]; the local sort takes it for n <= 2^13, one shared-memory
// pass, and the k-way merge's tile sort for tiles past 1024 keys.  A float
// kind takes n <= 2^13 only.
extern "C" int repro_bitonic_sort_rows(int64_t device, const void* in, int64_t in_stride,
                                       void* out, int64_t rows, int64_t n, int64_t kind,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || n <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  return dispatch_key(kind, [&](auto tag) {
    return sort_rows<decltype(tag)::value>(in, in_stride, out, rows, n, st);
  });
}

extern "C" const char* repro_error_string(int64_t err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
