// Stable LSD radix sort of rows for Hopper (sm_90a): the PSRS local sort.
//
// Replaces the TPU kernel bitonic_sort_rows
// (src/repro/kernels/bitonic_sort/bitonic_sort.py:44, body _bitonic_kernel
// :22), which sorts each row of [rows, n] with a bitonic network in VMEM.
// Any sort gives the same integer rows, so this one need not be a network;
// float rows need a stable sort (sort_keys.cuh), which this one is.
//
// Keys.  Keys of 1, 2 or 4 bytes, of every kind of sort_keys.cuh (int8,
// uint8, bool, int16, uint16, float16, bfloat16, int32, uint32, float32).
// Digits are taken from the key's order-preserving image there: for int32
// u = uint32(x) ^ 0x80000000, whose unsigned order is the signed order of x
// (INT_MIN maps to 0, INT_MAX to 2^32 - 1).  The keys themselves are moved
// unchanged: nothing is undone at the end.
//
// Passes.  One pass of 8-bit digits a byte of the key, least significant
// first, ping-pong between out and a tmp [rows, n] buffer, the last pass
// into out: for four passes in -> tmp -> out -> tmp -> out.
// Pass 1 reads the input's rows in_stride elements apart (a strided view of
// the context store); the others read contiguous rows.  Each pass is stable,
// which is what makes LSD correct: keys of equal digit keep the order the
// previous passes gave them.
//
//   * row_histograms, once: each row's counts of all its digits,
//     hist [rows, passes, 256];
//   * per pass, three launches:
//       upsweep    grid (tile, row): the tile's digit counts into
//                  counts [rows, 256, tiles] (per-warp shared histograms, so
//                  that the atomics of one warp do not contend with another's);
//       scan_tiles grid (bin, row): an exclusive scan over the tiles of each
//                  (row, bin), plus the bin's exclusive prefix in the row from
//                  hist, in place: the tile's first output slot of each bin;
//       downsweep  grid (tile, row): reloads the tile and ranks each key
//                  stably within it.  Thread l of warp w holds keys
//                  w*32*KPT + j*32 + l, j = 0 .. KPT-1, taken in order of j:
//                  eight ballots, one a digit bit, find a key's peers (the
//                  lanes holding its digit, as __match_any_sync would), its
//                  rank among them is popc(peers & lanemask_lt), and the
//                  lowest peer bumps the warp's count of the bin.  An exclusive scan
//                  of the warp counts per bin, then over the bins, gives the
//                  tile's order: warps in order, keys of a warp in order.  The
//                  keys are placed at their tile-local sorted slot in shared
//                  memory, and then threads write consecutive slots, so keys
//                  of one bin go to consecutive addresses and the writes
//                  coalesce.
//   A tile is 256 threads x 32 keys (8192 keys); for int32 keys tiles of
//   256 x 16 and 512 x 8 are built too, and scripts/radix_ssd_tiles.py times
//   the three.
//   The rank loop is a chain of shared-memory round trips per warp, so the
//   tile shape sets how much of its latency other warps hide.  Rows of 2^13
//   keys or fewer take the bitonic kernel's one shared-memory pass instead
//   (the wrapper's choice).
//
// Bound.  The function must read its input once and write its output once
// (2 x 4 bytes per key): at [4, 2^23] int32 that is 256 MiB, 0.080 ms at
// 3.35 TB/s; its log2(n!) comparisons a row take 0.043 ms at the card's int32
// rate, so bytes bound it.  This design reads the keys 1 + 4 x 2 times (the
// histograms, then each pass's upsweep and downsweep) and writes them 4
// times: 13 x 128 MiB = 1.66 GiB, 0.53 ms at 3.35 TB/s, plus 4 x 3 x 4 MiB
// of tile counts (written, scanned, read) at 8192-key tiles.  Onesweep (decoupled look-back, one
// launch a pass) would drop the upsweep's read, and a pass of 11 bits would
// drop a pass: later work.  Keys of 2 bytes take two passes and keys of
// one byte one, each pass reading and writing the key's own width; the
// float kinds add the canonical map's few integer operations a digit.
//
// Offsets are 64-bit throughout; counts within a row are 32-bit (n < 2^31).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sort_keys.cuh"

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;             // every kernel here
constexpr int kWarps = kThreads / 32;
constexpr int kHistKeysPerBlock = 16384;  // keys a histogram block takes per row pass

template <int K>
__device__ __forceinline__ uint32_t digit_of(typename Key<K>::T key, int shift) {
  return (Key<K>::image(key) >> shift) & (kBins - 1);
}

// The lanes of the warp whose live key has digit d (the AND of eight
// ballots, one a digit bit; __match_any_sync gives the same).
__device__ __forceinline__ uint32_t peers_of(uint32_t d, bool live) {
  uint32_t peers = __ballot_sync(0xffffffffu, live);
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    const bool set = (d >> bit) & 1u;
    const uint32_t vote = __ballot_sync(0xffffffffu, set);
    peers &= set ? vote : ~vote;
  }
  return peers;
}

// Inclusive scan of v over the block (blockDim.x a multiple of 32); *total
// gets the block's sum.  Ends with __syncthreads, so `sums` may be reused.
__device__ __forceinline__ uint32_t block_inclusive_scan(uint32_t v, uint32_t* sums,
                                                        uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = lane < nw ? sums[lane] : 0u;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t u = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += u;
    }
    if (lane < nw) sums[lane] = s;
  }
  __syncthreads();
  const uint32_t prefix = warp > 0 ? sums[warp - 1] : 0u;
  *total = sums[nw - 1];
  __syncthreads();
  return v + prefix;
}

// hist[row][d][bin] += count of digit d == bin over the row (zeroed before),
// d < kPasses, one digit a byte of the key.  Grid (blocks per row, rows).
template <int K>
__global__ void __launch_bounds__(kThreads)
row_histograms(const typename Key<K>::T* __restrict__ in, int64_t in_stride, int64_t n,
               uint32_t* __restrict__ hist) {
  constexpr int kPasses = sizeof(typename Key<K>::T);
  __shared__ uint32_t wh[kWarps][kPasses][kBins];  // 32 KiB at 4 passes
  uint32_t* flat = &wh[0][0][0];
  for (int e = threadIdx.x; e < kWarps * kPasses * kBins; e += kThreads) flat[e] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const typename Key<K>::T* row = in + static_cast<int64_t>(blockIdx.y) * in_stride;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
#pragma unroll 4
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += step) {
    const uint32_t u = Key<K>::image(row[i]);
#pragma unroll
    for (int d = 0; d < kPasses; ++d) atomicAdd(&wh[warp][d][(u >> (8 * d)) & 0xffu], 1u);
  }
  __syncthreads();
  uint32_t* h = hist + static_cast<int64_t>(blockIdx.y) * kPasses * kBins;
  for (int e = threadIdx.x; e < kPasses * kBins; e += kThreads) {
    uint32_t s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += flat[w * kPasses * kBins + e];
    if (s) atomicAdd(h + e, s);
  }
}

// counts[row][bin][tile] = keys of the tile whose digit is bin.
template <int KPT, int K>
__global__ void __launch_bounds__(kThreads)
upsweep(const typename Key<K>::T* __restrict__ src, int64_t src_stride, int64_t n,
        uint32_t* __restrict__ counts, int64_t tiles, int shift) {
  using T = typename Key<K>::T;
  constexpr int kTile = kThreads * KPT;
  __shared__ uint32_t wh[kWarps][kBins];
  for (int e = threadIdx.x; e < kWarps * kBins; e += kThreads) (&wh[0][0])[e] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.y, tile = blockIdx.x;
  const int64_t base = tile * kTile;
  const int64_t valid = n - base < kTile ? n - base : kTile;
  const T* s = src + row * src_stride + base;
  T key[KPT];  // every load in flight before the first atomic
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int idx = j * kThreads + threadIdx.x;
    key[j] = idx < valid ? s[idx] : 0;
  }
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    if (j * kThreads + threadIdx.x < valid) atomicAdd(&wh[warp][digit_of<K>(key[j], shift)], 1u);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += kThreads) {
    uint32_t c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += wh[w][b];
    counts[(row * kBins + b) * tiles + tile] = c;
  }
}

// In place: counts[row][bin][tile] becomes the row position of the tile's
// first key of that bin.  Grid (bins, rows).
__global__ void __launch_bounds__(kThreads)
scan_tiles(uint32_t* __restrict__ counts, const uint32_t* __restrict__ hist,
           int64_t tiles, int passes, int pass) {
  __shared__ uint32_t sums[32];
  __shared__ uint32_t bin_base;
  const int bin = blockIdx.x;
  const int64_t row = blockIdx.y;
  if (threadIdx.x < 32) {
    const uint32_t* h = hist + (row * passes + pass) * kBins;
    uint32_t s = 0;
    for (int b = threadIdx.x; b < bin; b += 32) s += h[b];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (threadIdx.x == 0) bin_base = s;
  }
  __syncthreads();
  uint32_t carry = bin_base;
  uint32_t* c = counts + (row * kBins + bin) * tiles;
  for (int64_t t0 = 0; t0 < tiles; t0 += kThreads) {
    const int64_t t = t0 + threadIdx.x;
    const uint32_t v = t < tiles ? c[t] : 0u;
    uint32_t total;
    const uint32_t incl = block_inclusive_scan(v, sums, &total);
    if (t < tiles) c[t] = carry + incl - v;
    carry += total;
  }
}

// Stable scatter of one tile of THREADS x KPT keys by digit (see the note
// at the top).
template <int KPT, int THREADS, int K>
__global__ void __launch_bounds__(THREADS)
downsweep(const typename Key<K>::T* __restrict__ src, int64_t src_stride,
          typename Key<K>::T* __restrict__ dst, int64_t n, const uint32_t* __restrict__ offsets,
          int64_t tiles, int shift) {
  using T = typename Key<K>::T;
  constexpr int kTile = THREADS * KPT, kW = THREADS / 32;
  static_assert(kTile <= 65535, "16-bit tile counts");
  __shared__ uint16_t wcnt[kW][kBins];  // per-warp counts, then tile offsets
  __shared__ T keys_s[kTile];
  __shared__ uint32_t gbase[kBins];
  __shared__ uint32_t sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.y, tile = blockIdx.x;
  const int64_t base = tile * kTile;
  const int valid = static_cast<int>(n - base < kTile ? n - base : kTile);
  const T* s = src + row * src_stride + base;
  for (int e = threadIdx.x; e < kW * kBins; e += THREADS) (&wcnt[0][0])[e] = 0;
  T key[KPT];
  const int first = warp * 32 * KPT + lane;
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int idx = first + j * 32;
    key[j] = idx < valid ? s[idx] : 0;
  }
  // The tile's first row position of bin threadIdx.x, loaded while ranking.
  const uint32_t off =
      threadIdx.x < kBins ? offsets[(row * kBins + threadIdx.x) * tiles + tile] : 0u;
  __syncthreads();

  // Rank within the warp, keys in order of j, lanes in order within j: a
  // key's rank among its peers is popc(peers & lanemask_lt), and the lowest
  // peer bumps the warp's count of the bin.
  const uint32_t lt = (1u << lane) - 1u;
  uint32_t rank[KPT];
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const bool live = first + j * 32 < valid;
    const uint32_t d = live ? digit_of<K>(key[j], shift) : 0u;
    const uint32_t peers = peers_of(d, live);
    const uint32_t before = wcnt[warp][d];
    __syncwarp();
    if (live && lane == __ffs(peers) - 1)
      wcnt[warp][d] = static_cast<uint16_t>(before + __popc(peers));
    __syncwarp();
    rank[j] = before + __popc(peers & lt);
  }
  __syncthreads();

  // Thread b: the warps' exclusive prefix for bin b, then the bins' prefix.
  uint32_t tot = 0;
  if (threadIdx.x < kBins) {
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const uint32_t c = wcnt[w][threadIdx.x];
      wcnt[w][threadIdx.x] = static_cast<uint16_t>(tot);
      tot += c;
    }
  }
  uint32_t total;
  const uint32_t bin_start = block_inclusive_scan(tot, sums, &total) - tot;
  if (threadIdx.x < kBins) {
#pragma unroll
    for (int w = 0; w < kW; ++w) wcnt[w][threadIdx.x] += static_cast<uint16_t>(bin_start);
    gbase[threadIdx.x] = off - bin_start;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    if (first + j * 32 < valid) keys_s[wcnt[warp][digit_of<K>(key[j], shift)] + rank[j]] = key[j];
  }
  __syncthreads();

  // Slot i of the tile goes to row position gbase[bin] + i.
  T* out = dst + row * n;
  for (int i = threadIdx.x; i < valid; i += THREADS) {
    const T k = keys_s[i];
    out[gbase[digit_of<K>(k, shift)] + i] = k;
  }
}

// KPT keys a thread in tiles of THREADS x KPT; the upsweep takes the same
// tiles with 256 threads.  One pass a byte of the key, the last into out.
template <int KPT, int THREADS, int K>
cudaError_t sort_rows(const void* in_, int64_t in_stride, void* out_, void* tmp_,
                      uint32_t* scratch, int64_t rows, int64_t n, cudaStream_t st) {
  using T = typename Key<K>::T;
  constexpr int kPasses = sizeof(T);
  constexpr int64_t kTile = THREADS * KPT;
  constexpr int kUpKeys = kTile / kThreads;
  const T* in = static_cast<const T*>(in_);
  T* out = static_cast<T*>(out_);
  T* tmp = static_cast<T*>(tmp_);
  const int64_t tiles = (n + kTile - 1) / kTile;
  uint32_t* hist = scratch;                       // [rows, passes, 256]
  uint32_t* counts = scratch + rows * kPasses * kBins;  // [rows, 256, tiles]
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(uint32_t) * rows * kPasses * kBins, st);
  if (err != cudaSuccess) return err;
  int64_t hblocks = (n + kHistKeysPerBlock - 1) / kHistKeysPerBlock;
  const int64_t hcap = rows >= 1024 ? 1 : 1024 / rows;  // about 8 blocks an SM in all
  if (hblocks > hcap) hblocks = hcap;
  row_histograms<K><<<dim3(static_cast<unsigned>(hblocks), static_cast<unsigned>(rows)),
                      kThreads, 0, st>>>(in, in_stride, n, hist);
  const dim3 tile_grid(static_cast<unsigned>(tiles), static_cast<unsigned>(rows));
  const dim3 bin_grid(kBins, static_cast<unsigned>(rows));
  // Four passes: in -> tmp -> out -> tmp -> out; two: in -> tmp -> out;
  // one: in -> out.
  const T* src = in;
  int64_t src_stride = in_stride;
  for (int pass = 0; pass < kPasses; ++pass) {
    T* dst = ((kPasses - 1 - pass) & 1) ? tmp : out;
    upsweep<kUpKeys, K><<<tile_grid, kThreads, 0, st>>>(src, src_stride, n, counts, tiles,
                                                        8 * pass);
    scan_tiles<<<bin_grid, kThreads, 0, st>>>(counts, hist, tiles, kPasses, pass);
    downsweep<KPT, THREADS, K><<<tile_grid, THREADS, 0, st>>>(src, src_stride, dst, n, counts,
                                                              tiles, 8 * pass);
    src = dst;
    src_stride = n;
  }
  return cudaGetLastError();
}

}  // namespace

// Stable ascending sort of each row of in[rows, n] (rows in_stride elements
// apart) into the contiguous out[rows, n], through tmp[rows, n] and a uint32
// scratch of rows * passes * 256 + rows * 256 * tiles words (hist, then
// counts), passes the key's bytes, tiles = ceil(n / (threads * kpt)).
// `kind` is the keys' KeyKind (sort_keys.cuh).  (kpt, threads) is (32, 256),
// the wrapper's; int32 keys are also built at (16, 256) and (8, 512), which
// scripts/radix_ssd_tiles.py times beside it.
extern "C" int repro_radix_sort_rows(int64_t device, const void* in, int64_t in_stride,
                                     void* out, void* tmp, void* scratch, int64_t rows,
                                     int64_t n, int64_t kpt, int64_t threads, int64_t kind,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || n <= 0) return 0;
  if (rows > 65535 || n >= (int64_t(1) << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* s = static_cast<uint32_t*>(scratch);
  if (kind == kI32) {
#define REPRO_RADIX(K, T)          \
  if (kpt == K && threads == T) \
    return static_cast<int>(sort_rows<K, T, kI32>(in, in_stride, out, tmp, s, rows, n, st));
    REPRO_RADIX(32, 256)
    REPRO_RADIX(16, 256)
    REPRO_RADIX(8, 512)
#undef REPRO_RADIX
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kpt != 32 || threads != 256) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_key(kind, [&](auto tag) {
    return static_cast<int>(
        sort_rows<32, 256, decltype(tag)::value>(in, in_stride, out, tmp, s, rows, n, st));
  });
}
