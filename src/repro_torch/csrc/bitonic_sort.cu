// Bitonic sorting networks for Hopper (sm_90a): the k-way merge's tile sort,
// and the PSRS local sort of rows that fit one shared-memory segment.
//
// Replaces the TPU kernel merge_tile_grid
// (src/repro/kernels/kway_merge/kway_merge.py:65, body _kway_merge_kernel
// :61, network sort_tile_rows :35) — entry point repro_kway_tile_sort.  The
// TPU kernel runs a bitonic network: for stage = 0 .. log2(n)-1 and
// sub = stage .. 0, elements i and i + 2^sub (bit sub of i clear) are
// compare-exchanged, ascending iff bit (stage+1) of i is 0
// (src/repro/kernels/bitonic_sort/bitonic_sort.py:31-35).  The PSRS local
// sort (TPU kernel bitonic_sort_rows, bitonic_sort.py:44) is the radix sort
// of radix_sort.cu; a row of 2^13 keys or fewer takes this file's one
// shared-memory pass instead (entry repro_bitonic_sort_rows).
//
// Design.  The TPU kernel keeps a whole row in VMEM; a Hopper block may use
// 227 KB of shared memory, so the network is split:
//   * a shared-memory pass (smem_stages) loads one 2^13-element segment
//     (32 KiB) per block, runs every compare-exchange whose stride is below
//     the segment, and writes the segment back;
//   * one global-memory pass (global_step) per larger stride.
// A row of n = 2^L elements, L > 13, costs 1 + sum_{s=13}^{L-1} (s - 12) + (L - 13)
// passes, each reading and writing the whole batch once with coalesced 4-byte
// accesses; a row of 2^13 or fewer costs the one shared-memory pass.
//
// The k-way merge tiles are 256 elements by default: one block per tile sorts
// it entirely in shared memory (1 KiB), one launch for all k*G tiles of a
// round; larger power-of-two tiles fall through to the global passes.
// Bound of the tile sort: at full-scale PSRS a round holds 4 * 65,536 tiles
// of 256 int32, 512 MiB read and written once (0.16 ms at 3.35 TB/s) against
// log2(256!) comparisons a tile (4.4e8 in all, 0.026 ms at the card's int32
// rate, 16.7 T/s: 132 SMs x 64 int32 lanes x 1.98 GHz): bytes bound it, and
// a tile that fits one segment is read once and written once, in a single
// pass.  The network's own n/2 * L(L+1)/2 compare-exchanges per tile
// describe the algorithm, not the function.
//
// Offsets are 64-bit throughout: a batch may exceed 2^31 elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSegLog = 13;      // 8192 int32 = 32 KiB shared memory per block
constexpr int kMaxThreads = 1024;
constexpr int kStepThreads = 256;

__device__ __forceinline__ void compare_exchange(int& a, int& b, bool asc) {
  const int lo = min(a, b);
  const int hi = max(a, b);
  a = asc ? lo : hi;
  b = asc ? hi : lo;
}

// Stages [stage_lo, stage_hi] of the network, restricted to strides below the
// 2^seg_log segment, on every segment of the batch (one block per segment).
// Input rows are in_stride elements apart (a strided view of the context
// store); output rows are contiguous.  `in` and `out` may alias (in_stride
// == n): each block reads its segment fully before writing it.
__global__ void smem_stages(const int* in, int64_t in_stride, int* out, int log_n,
                            int seg_log, int stage_lo, int stage_hi) {
  extern __shared__ int seg_buf[];
  const int seg = 1 << seg_log;
  const int64_t first = static_cast<int64_t>(blockIdx.x) << seg_log;  // flat
  const int64_t row_pos = first & ((int64_t(1) << log_n) - 1);        // in row
  const int* src = in + (first >> log_n) * in_stride + row_pos;
  for (int e = threadIdx.x; e < seg; e += blockDim.x) seg_buf[e] = src[e];
  __syncthreads();
  for (int stage = stage_lo; stage <= stage_hi; ++stage) {
    const int sub_hi = stage < seg_log - 1 ? stage : seg_log - 1;
    for (int sub = sub_hi; sub >= 0; --sub) {
      const int stride = 1 << sub;
      for (int p = threadIdx.x; p < seg / 2; p += blockDim.x) {
        const int i = ((p >> sub) << (sub + 1)) | (p & (stride - 1));
        const bool asc = (((row_pos + i) >> (stage + 1)) & 1) == 0;
        int a = seg_buf[i];
        int b = seg_buf[i + stride];
        compare_exchange(a, b, asc);
        seg_buf[i] = a;
        seg_buf[i + stride] = b;
      }
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < seg; e += blockDim.x) out[first + e] = seg_buf[e];
}

// One compare-exchange step (stage, sub) over the whole [rows, 2^log_n] batch.
__global__ void global_step(int* x, int64_t rows, int log_n, int stage, int sub) {
  const int64_t half_log = log_n - 1;
  const int64_t pairs = rows << half_log;
  const int64_t stride = int64_t(1) << sub;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < pairs; t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = t >> half_log;
    const int64_t p = t & ((int64_t(1) << half_log) - 1);
    const int64_t i = ((p >> sub) << (sub + 1)) | (p & (stride - 1));
    const bool asc = ((i >> (stage + 1)) & 1) == 0;
    int* row = x + (r << log_n);
    int a = row[i];
    int b = row[i + stride];
    compare_exchange(a, b, asc);
    row[i] = a;
    row[i + stride] = b;
  }
}

int sort_rows(int64_t device, const void* in, int64_t in_stride, void* out,
              int64_t rows, int64_t n, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int log_n = 0;
  while ((int64_t(1) << log_n) < n) ++log_n;
  const int seg_log = log_n < kSegLog ? log_n : kSegLog;
  const int seg = 1 << seg_log;
  const int threads = seg / 2 < 1 ? 1 : (seg / 2 < kMaxThreads ? seg / 2 : kMaxThreads);
  const int64_t segments = rows << (log_n - seg_log);
  const size_t smem = static_cast<size_t>(seg) * sizeof(int);
  int* o = static_cast<int*>(out);
  smem_stages<<<static_cast<unsigned>(segments), threads, smem, st>>>(
      static_cast<const int*>(in), in_stride, o, log_n, seg_log, 0, seg_log - 1);
  const int64_t pairs = rows << (log_n > 0 ? log_n - 1 : 0);
  int64_t step_blocks = (pairs + kStepThreads - 1) / kStepThreads;
  if (step_blocks > (int64_t(1) << 20)) step_blocks = int64_t(1) << 20;
  for (int stage = seg_log; stage < log_n; ++stage) {
    for (int sub = stage; sub >= seg_log; --sub) {
      global_step<<<static_cast<unsigned>(step_blocks), kStepThreads, 0, st>>>(
          o, rows, log_n, stage, sub);
    }
    smem_stages<<<static_cast<unsigned>(segments), threads, smem, st>>>(
        o, int64_t(1) << log_n, o, log_n, seg_log, stage, stage);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Ascending sort of each row of in[rows, n] (n a power of two, rows
// in_stride elements apart) into the contiguous out[rows, n]; the local sort
// takes it for n <= 2^13, one shared-memory pass.
extern "C" int repro_bitonic_sort_rows(int64_t device, const void* in, int64_t in_stride,
                                       void* out, int64_t rows, int64_t n, void* stream) {
  return sort_rows(device, in, in_stride, out, rows, n, stream);
}

// Ascending sort of each compactly gathered k-way merge tile of in[G, tile]
// into out: one block per tile while the tile fits one shared-memory segment.
extern "C" int repro_kway_tile_sort(int64_t device, const void* in, void* out,
                                    int64_t tiles, int64_t tile, void* stream) {
  return sort_rows(device, in, tile, out, tiles, tile, stream);
}

extern "C" const char* repro_error_string(int64_t err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
