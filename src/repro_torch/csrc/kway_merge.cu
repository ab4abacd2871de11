// The k-way merge of the PSRS merge stage for Hopper (sm_90a): exact
// splitting, window load and merge fused into two kernels that read the
// received buckets where they lie, and a warp-register tile sort.
//
// Replaces the TPU kernel merge_tile_grid
// (src/repro/kernels/kway_merge/kway_merge.py:65, body _kway_merge_kernel
// :61, network sort_tile_rows :35) together with the splitter search and
// compact gather around it (src/repro/kernels/kway_merge/ops.py:98-221).
// The function: per context, the lowest rcap elements of the count-masked
// buckets brecv[k, v, cap] (lane i of bucket j is INT_MAX when i >= cnt[j]),
// ascending.  It is unique, so any correct design equals the JAX package's
// kway_merge bit for bit.
//
// Design (ops.py's gather route materialised a 2 GiB masked copy and five
// [k, G, tile] int64 index tensors at full-scale PSRS before the tile sort):
//
//   repro_kway_splitters (one warp per context and coarse rank r, lanes over
//     the buckets, 32 at a time): the exact start of every bucket at
//     r = c*S*tile, the boundary of every S-th output tile.  The MSB-first
//     search of the biased value domain finds t = max u: #{x < u} < r, then
//     the duplicates of t are taken greedily in bucket order (the JAX
//     package's _exact_starts, ops.py:98-135).  Each step is one
//     lower-bound search a lane over its bucket, as it lies in global memory,
//     plus a warp sum.  A lane at or past the bucket's count counts as
//     INT_MAX without being read.  Each bucket keeps a bracket [lb(u),
//     lb(u + 2^(b+1))) in shared memory, so a step searches only what the
//     bits still leave open, and the last bracket gives #{x < t} and
//     #{x <= t} without further searches.
//
//   repro_kway_merge_segments (one block per context and segment of S tiles):
//     1. copies the v windows [start_c[j], start_{c+1}[j]) of the segment
//        into shared memory with cp.async, packed in bucket order to exactly
//        the segment's keys, masked lanes as INT_MAX;
//     2. merges the v sorted windows there, pairwise in ceil(log2 v) levels
//        between two buffers: every thread makes a fixed share of a level's
//        output, finding where it starts in its pair of runs by a merge-path
//        search and merging serially from there;
//     3. copies the merged segment into merged[k, rcap], coalesced.
//     A segment wholly at or past the context's valid total holds only
//     INT_MAX (every element of rank >= total is the maximum), so its block
//     writes INT_MAX without reading anything.  Segments hold 2^13 keys
//     (S = 32 at tile 256): two 32 KiB buffers, three blocks an SM.
//     Why a merge and not searches for the inner tile boundaries followed
//     by a sort of each tile: that design was built first and, timed in
//     turns with this one at full-scale PSRS, took more than twice as long
//     a launch; clock64 probes put most of its blocks' time in the
//     searches, each boundary a latency-bound chain of ~20 dependent steps.
//     The merge reads each key from shared memory once a level.  (A
//     throwaway harness; the numbers were not kept.  Segment sizes:
//     scripts/merge_stage_split.py --seg-tiles.)
//
//   repro_kway_tile_sort (merge_tile_grid, the counterpart of the TPU
//     kernel, on the gather route): one warp sorts 256 keys in registers, 8 a
//     lane, with the bitonic network (strides below the keys a lane in
//     registers, larger ones by __shfl_xor_sync), for tiles of 1024 or
//     fewer; larger tiles take bitonic_sort.cu's shared-memory and global
//     passes (repro_bitonic_sort_rows).
//
// Bound of (a) and (b) at full-scale PSRS (2^27 keys, v 16, k 4): a round
// reads the valid keys of rank below rcap, 4 x 2^23 int32 (128 MiB), and
// writes k*rcap = 4 x 2^24 keys (256 MiB): 0.120 ms at 3.35 TB/s.  The
// comparisons, n*log2(v) = 1.3e8, take 0.008 ms at the card's int32 rate
// (16.7 T/s): bytes bound the merge.  The splitter search is latency-bound
// (4 x 1025 warps of dependent loads a round); the fill-only segments,
// about half of rcap = 2n/v in PSRS, cost only their writes.
//
// Offsets into the buckets and the output are 64-bit; positions inside one
// bucket are 32-bit (cap < 2^31).

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int repro_bitonic_sort_rows(int64_t device, const void* in, int64_t in_stride,
                                       void* out, int64_t rows, int64_t n, void* stream);

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kIntMax = 0x7fffffff;
constexpr int kSplitWarps = 4;      // warps a block of the splitter kernel
constexpr int kSegThreads = 256;    // threads a block of the segment kernel
constexpr int kTileWarps = 4;       // warps a block of the tile-sort kernel
constexpr int kWarpTileMax = 1024;  // largest tile the warp-register sort takes
constexpr int kSmemMax = 227 * 1024;

// Keys a lane holds for tiles of T: a lane holds a whole tile up to 8, a
// warp holds 32*8 keys up to tile 256, then one tile a warp.
__host__ __device__ constexpr int keys_per_lane(int T) {
  return T <= 8 ? T : (T <= 256 ? 8 : T / 32);
}
__host__ __device__ constexpr int log2c(int n) { return n <= 1 ? 0 : 1 + log2c(n / 2); }

// Shared-memory padding: element i at i + i/32.  It spreads a warp's
// blocked writes (lane*K + r) and strided reads (32*r + lane) over the 32
// banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int key_of(uint32_t u) { return static_cast<int>(u ^ 0x80000000u); }

__device__ __forceinline__ long long warp_sum(long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ long long warp_inclusive_scan(long long x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// Bucket j of one context where it lies: cap lanes, those at or past the
// count INT_MAX (worked out, not loaded).
struct Buckets {
  const int* rows;
  int64_t sb;
  const int* cnt;
  int cap;
  __device__ int valid(int j) const { return min(max(__ldg(cnt + j), 0), cap); }
  __device__ int at(int j, int i) const { return __ldg(rows + j * sb + i); }
};

// #{x < q} in bucket j, known to lie in [lo, hi].  Lanes at or past
// valid(j) hold INT_MAX, never below q, so the count is at most valid(j).
__device__ __forceinline__ int lower_bound(const Buckets& s, int j, int lo, int hi, int q) {
  hi = min(hi, s.valid(j));
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (s.at(j, mid) < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ------------------------------------------------------------------ (a)
// One warp a (context, rank r): start[j], the number of bucket j's lanes
// among the r smallest in (value, bucket, lane) order.  Lane j % 32 keeps
// bucket j's bracket in the warp's shared-memory rows lo[v], hi[v], mid[v].
__global__ void __launch_bounds__(kSplitWarps * 32)
    splitters_kernel(const int* __restrict__ brecv, int64_t sk, int64_t sb,
                     const int* __restrict__ cnt, int64_t sck, const int64_t* __restrict__ ranks,
                     int64_t R, int64_t k, int v, int cap, int* __restrict__ starts) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kSplitWarps + warp;
  if (item >= k * R) return;
  const int64_t ctx = item / R;
  const long long r = ranks[item % R];
  const Buckets seq{brecv + ctx * sk, sb, cnt + ctx * sck, cap};
  int* lo = smem + warp * 3 * v;
  int* hi = lo + v;
  int* mid = hi + v;
  int* start = starts + item * v;

  // t = max u: #{x < u} < r, bit by bit; bucket j's bracket [lo, hi] is
  // [#{x < u}, #{x < u + 2^(bit+1)}].
  for (int j = lane; j < v; j += 32) {
    lo[j] = 0;
    hi[j] = cap;
  }
  uint32_t u = 0;
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t cand = u | (1u << bit);
    const int q = key_of(cand);
    long long below = 0;
    for (int j = lane; j < v; j += 32) {
      mid[j] = lower_bound(seq, j, lo[j], hi[j], q);
      below += mid[j];
    }
    const bool take = warp_sum(below) < r;
    if (take) u = cand;
    for (int j = lane; j < v; j += 32) {
      if (take) lo[j] = mid[j]; else hi[j] = mid[j];
    }
  }
  // lo = #{x < t}, hi = #{x <= t}: hand the duplicates of t out in bucket
  // order.
  long long lo_sum = 0;
  for (int j = lane; j < v; j += 32) lo_sum += lo[j];
  const long long need = r - warp_sum(lo_sum);
  long long carry = 0;
  for (int j0 = 0; j0 < v; j0 += 32) {
    const int j = j0 + lane;
    const long long dup = j < v ? hi[j] - lo[j] : 0;
    const long long incl = warp_inclusive_scan(dup, lane);
    const long long take = min(max(need - (carry + incl - dup), 0LL), dup);
    if (j < v) start[j] = lo[j] + static_cast<int>(take);
    carry += __shfl_sync(kFull, incl, 31);
  }
}

// ------------------------------------------------------------------ (b)
struct SegArgs {
  const int* brecv;
  int64_t sk, sb;
  const int* cnt;
  int64_t sck;
  const int* starts;  // [k, C+1, v]
  int* out;           // [k, rcap]
  int v, cap, C;
  int seg_keys;       // S*tile
  int64_t rcap;
};

// The number of A's keys among the first d of merge(A, B), A's first on
// ties (merge path): A = buf[a0, a0 + na), B = buf[b0, b0 + nb).
__device__ __forceinline__ int merge_path(const int* buf, int a0, int na, int b0, int nb, int d) {
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (buf[a0 + mid] <= buf[b0 + d - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kSegThreads) segments_kernel(SegArgs a) {
  extern __shared__ int smem[];
  const int v = a.v;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t ctx = blockIdx.y, c = blockIdx.x;
  const int64_t pos0 = c * a.seg_keys;                   // first output key
  const int64_t pos_end = min64(pos0 + a.seg_keys, a.rcap);
  int* out = a.out + ctx * a.rcap;

  int* buf0 = smem;                       // [seg_keys] the windows, packed
  int* buf1 = buf0 + a.seg_keys;          // [seg_keys] the other merge buffer
  int* base = buf1 + a.seg_keys;          // [v+1] window j at [base[j], base[j+1])
  int* s0 = base + v + 1;                 // [v] coarse starts
  int* nv = s0 + v;                       // [v] valid lanes
  __shared__ long long total;

  if (warp == 0) {
    long long sum = 0;
    for (int j = lane; j < v; j += 32) {
      const int n = min(max(a.cnt[ctx * a.sck + j], 0), a.cap);
      nv[j] = n;
      sum += n;
    }
    sum = warp_sum(sum);
    if (lane == 0) total = sum;
  }
  __syncthreads();
  if (pos0 >= total) {                    // every key here is INT_MAX
    for (int64_t p = pos0 + threadIdx.x; p < pos_end; p += blockDim.x) out[p] = kIntMax;
    return;
  }

  if (warp == 0) {
    const int* st0 = a.starts + (ctx * (a.C + 1) + c) * v;
    long long carry = 0;
    for (int j0 = 0; j0 < v; j0 += 32) {
      const int j = j0 + lane;
      int w = 0;
      if (j < v) {
        s0[j] = st0[j];
        w = st0[v + j] - st0[j];
      }
      const long long incl = warp_inclusive_scan(w, lane);
      if (j < v) base[j] = static_cast<int>(carry + incl - w);
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) base[v] = static_cast<int>(carry);
  }
  __syncthreads();

  const int* rows = a.brecv + ctx * a.sk;
  for (int j = 0; j < v; ++j) {
    const int w = base[j + 1] - base[j], b0 = base[j], s = s0[j], n = nv[j];
    const int* src = rows + j * a.sb;
    for (int i = threadIdx.x; i < w; i += blockDim.x) {
      if (s + i < n) cp_async4(buf0 + b0 + i, src + s + i);
      else buf0[b0 + i] = kIntMax;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // Merge runs of `width` windows pairwise into runs of 2*width, from src
  // into dst; run m of a level covers windows [m*2w, (m+1)*2w).  A
  // thread's share of the outputs is odd, so that the threads' stores fall
  // in 32 different banks.
  const int n = base[v];
  const int share = ((n + blockDim.x - 1) / blockDim.x) | 1;
  int* src = buf0;
  int* dst = buf1;
  for (int width = 1; width < v; width *= 2) {
    const int runs = (v + 2 * width - 1) / (2 * width);
    int o = min(n, static_cast<int>(threadIdx.x) * share);
    const int o_end = min(n, o + share);
    while (o < o_end) {
      int lo = 0, hi = runs - 1;            // the run holding output o
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (base[mid * 2 * width] <= o) lo = mid; else hi = mid - 1;
      }
      const int ja = lo * 2 * width;
      const int a0 = base[ja], b0 = base[min(ja + width, v)], e = base[min(ja + 2 * width, v)];
      const int na = b0 - a0, nb = e - b0;
      int i = merge_path(src, a0, na, b0, nb, o - a0);
      int j = o - a0 - i;
      // A run past its end reads as INT_MAX.  Where the other run's head is
      // INT_MAX too, every key left is INT_MAX, so the values come out
      // right whichever run the tie takes.
      int ka = i < na ? src[a0 + i] : kIntMax;
      int kb = j < nb ? src[b0 + j] : kIntMax;
      for (const int stop = min(o_end, e); o < stop; ++o) {
        if (ka <= kb) {
          dst[o] = ka;
          ka = ++i < na ? src[a0 + i] : kIntMax;
        } else {
          dst[o] = kb;
          kb = ++j < nb ? src[b0 + j] : kIntMax;
        }
      }
    }
    __syncthreads();
    int* t = src;
    src = dst;
    dst = t;
  }

  // Ranks past v*cap (rcap > v*cap) are fill too.
  for (int64_t p = threadIdx.x; p < pos_end - pos0; p += blockDim.x) {
    out[pos0 + p] = p < n ? src[p] : kIntMax;
  }
}

// ------------------------------------------------------------------ (c)
__device__ __forceinline__ void compare_exchange(int& a, int& b, bool asc) {
  const int lo = min(a, b);
  const int hi = max(a, b);
  a = asc ? lo : hi;
  b = asc ? hi : lo;
}

// Ascending bitonic sort of the independent T-key groups that one warp
// holds, K keys a lane: key r of lane l is element i = l*K + r, and each
// aligned run of T elements is one group.  The TPU network's rule: stage s,
// sub-stage t pairs i with i + 2^t, ascending iff bit s+1 of i's place in
// its group is 0.  Strides below K pair registers of one lane, larger ones
// pair lanes (__shfl_xor_sync), which share bits above the stride.
template <int K, int T>
__device__ __forceinline__ void warp_sort(int (&a)[K], int lane) {
  constexpr int L = log2c(T);
#pragma unroll
  for (int stage = 0; stage < L; ++stage) {
#pragma unroll
    for (int sub = stage; sub >= 0; --sub) {
      const int stride = 1 << sub;
      if (stride < K) {
#pragma unroll
        for (int r = 0; r < K; ++r) {
          if (r & stride) continue;
          const int i = lane * K + r;
          const bool asc = (((i & (T - 1)) >> (stage + 1)) & 1) == 0;
          compare_exchange(a[r], a[r + stride], asc);
        }
      } else {
        const int lmask = stride / K;
        const bool upper = (lane & lmask) != 0;
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const int i = lane * K + r;
          const bool asc = (((i & (T - 1)) >> (stage + 1)) & 1) == 0;
          const int other = __shfl_xor_sync(kFull, a[r], lmask);
          a[r] = (asc != upper) ? min(a[r], other) : max(a[r], other);
        }
      }
    }
  }
}

// One warp sorts 32*K keys of in[n] (n a multiple of T), W/T tiles at a
// time: a tile's keys go to its lanes in any order (coalesced loads), and
// the sorted keys leave through a padded staging row, 32 consecutive keys a
// store.
template <int T>
__global__ void __launch_bounds__(kTileWarps * 32)
    tile_sort_kernel(const int* __restrict__ in, int* __restrict__ out, int64_t n) {
  constexpr int K = keys_per_lane(T);
  constexpr int LP = T / K;   // lanes a tile
  constexpr int W = 32 * K;
  __shared__ int stage[kTileWarps][33 * K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = (static_cast<int64_t>(blockIdx.x) * kTileWarps + warp) * W;
  if (base >= n) return;
  const int t = lane / LP, l = lane % LP;
  int key[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int64_t i = base + t * T + r * LP + l;
    key[r] = i < n ? in[i] : kIntMax;
  }
  warp_sort<K, T>(key, lane);
  int* stg = stage[warp];
#pragma unroll
  for (int r = 0; r < K; ++r) stg[pad(lane * K + r)] = key[r];
  __syncwarp();
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int i = r * 32 + lane;
    if (base + i < n) out[base + i] = stg[pad(i)];
  }
}

template <int T>
cudaError_t launch_tile_sort(const int* in, int* out, int64_t n, cudaStream_t st) {
  const int64_t per_block = static_cast<int64_t>(kTileWarps) * 32 * keys_per_lane(T);
  const int64_t blocks = (n + per_block - 1) / per_block;
  tile_sort_kernel<T><<<static_cast<unsigned>(blocks), kTileWarps * 32, 0, st>>>(in, out, n);
  return cudaGetLastError();
}

}  // namespace

// Exact starts start[k, R, v] of the count-masked buckets brecv[k, v, cap]
// (context stride sk, bucket stride sb; counts cnt[k, v], context stride
// sck) at the ranks ranks[R] (int64, each <= v*cap).
extern "C" int repro_kway_splitters(int64_t device, const void* brecv, int64_t sk, int64_t sb,
                                    const void* cnt, int64_t sck, const void* ranks, int64_t R,
                                    int64_t k, int64_t v, int64_t cap, void* starts,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k <= 0 || R <= 0 || v <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (k * R + kSplitWarps - 1) / kSplitWarps;
  const auto* b = static_cast<const int*>(brecv);
  const auto* c = static_cast<const int*>(cnt);
  const auto* rk = static_cast<const int64_t*>(ranks);
  auto* s = static_cast<int*>(starts);
  const size_t smem = static_cast<size_t>(kSplitWarps) * 3 * v * sizeof(int);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(splitters_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  splitters_kernel<<<static_cast<unsigned>(blocks), kSplitWarps * 32, smem, st>>>(
      b, sk, sb, c, sck, rk, R, k, static_cast<int>(v), static_cast<int>(cap), s);
  return static_cast<int>(cudaGetLastError());
}

// merged[k, rcap] from the buckets, their counts, and the starts of
// repro_kway_splitters at the coarse ranks min(min(c*S, G)*tile, v*cap),
// c = 0..C (G = ceil(rcap/tile), C = ceil(G/S)).
extern "C" int repro_kway_merge_segments(int64_t device, const void* brecv, int64_t sk,
                                         int64_t sb, const void* cnt, int64_t sck,
                                         const void* starts, void* out, int64_t k, int64_t v,
                                         int64_t cap, int64_t rcap, int64_t tile,
                                         int64_t seg_tiles, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k <= 0 || rcap <= 0) return 0;
  const int64_t G = (rcap + tile - 1) / tile;
  const int64_t C = (G + seg_tiles - 1) / seg_tiles;
  const int64_t seg_keys = seg_tiles * tile;
  const size_t smem = (2 * static_cast<size_t>(seg_keys) + 3 * static_cast<size_t>(v) + 1) *
                      sizeof(int);
  if (smem + sizeof(long long) > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(segments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const SegArgs a{static_cast<const int*>(brecv), sk, sb, static_cast<const int*>(cnt), sck,
                  static_cast<const int*>(starts), static_cast<int*>(out), static_cast<int>(v),
                  static_cast<int>(cap), static_cast<int>(C), static_cast<int>(seg_keys), rcap};
  segments_kernel<<<dim3(static_cast<unsigned>(C), static_cast<unsigned>(k)), kSegThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Ascending sort of each compactly gathered k-way merge tile of in[G, tile]
// into out: the warp-register sort up to tile 1024, bitonic_sort.cu's
// passes above.
extern "C" int repro_kway_tile_sort(int64_t device, const void* in, void* out, int64_t tiles,
                                    int64_t tile, void* stream) {
  if (tile > kWarpTileMax) return repro_bitonic_sort_rows(device, in, tile, out, tiles, tile, stream);
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles <= 0) return 0;
  const auto* i = static_cast<const int*>(in);
  auto* o = static_cast<int*>(out);
  const int64_t n = tiles * tile;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 1: err = launch_tile_sort<1>(i, o, n, st); break;
    case 2: err = launch_tile_sort<2>(i, o, n, st); break;
    case 4: err = launch_tile_sort<4>(i, o, n, st); break;
    case 8: err = launch_tile_sort<8>(i, o, n, st); break;
    case 16: err = launch_tile_sort<16>(i, o, n, st); break;
    case 32: err = launch_tile_sort<32>(i, o, n, st); break;
    case 64: err = launch_tile_sort<64>(i, o, n, st); break;
    case 128: err = launch_tile_sort<128>(i, o, n, st); break;
    case 256: err = launch_tile_sort<256>(i, o, n, st); break;
    case 512: err = launch_tile_sort<512>(i, o, n, st); break;
    case 1024: err = launch_tile_sort<1024>(i, o, n, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
