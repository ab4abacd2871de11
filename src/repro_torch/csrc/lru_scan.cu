// RG-LRU linear recurrence for Hopper (sm_90a): kernel 7.
//
// Replaces the TPU kernel lru_scan_chunked
// (src/repro/kernels/lru_scan/lru_scan.py:57, body _lru_kernel :41), which is
// also the function of the JAX model's prefill twin _lru_chunked_jnp
// (src/repro/models/blocks.py:397).  Elementwise in the width:
//
//     h_t = a_t * h_{t-1} + b_t      over [batch, seq, width], h_{-1} = 0.
//
// Besides h it writes the final state h_fin [batch, width], which the model's
// prefill keeps in its cache (the TPU kernel leaves it in its scratch).
//
// Design.  The TPU kernel runs a (batch, chunk) grid whose chunk axis is
// sequential, carries h in VMEM scratch and does a log2(C) doubling scan
// inside each chunk.  A Hopper block cannot carry scratch to the next grid
// step, so the scan is chunked in time across blocks, kernel 7b's design
// (lru_scan_bwd.cu) run forward, in three launches:
//   1. lru_local, grid (channel tiles, chunks, batch): each thread runs one
//      channel over one chunk of kChunk steps (lru_scan.CHUNK) from a zero
//      carry, with every step's a and b loaded up front (2 kChunk loads in
//      flight a thread).  The chunk's outgoing state is affine in its
//      incoming one, h_out = L + Pr * h_in, with L the end state from zero
//      and Pr the product of the chunk's a.  It writes L and Pr.
//   2. lru_carry, one thread per (batch, channel): walks the chunks from the
//      first, whose incoming state is 0, and writes each chunk's incoming
//      state over its L.
//   3. lru_fix, the grid of pass 1: reruns each chunk's recurrence from its
//      incoming state, writes h, and (the last chunk) h_fin = h at the last
//      step, the same bits.
// That reads a and b twice: 20 bytes an element against the function's 12.
// Where batch x width fills the card, one thread per (batch, channel) over
// the whole sequence already keeps enough loads in flight, so lru_kernel
// (the one-pass design of the first port) reads 12 bytes an element and
// stays: the wrapper takes it from ONE_PASS_CHANNELS = 16384 (batch x
// width) channels up (lru_scan.py) and passes no scratch.  On the H100 the
// chunked scan read 2.5 and 1.5 times faster at 5,120 and 10,240 channels,
// the one-pass kernel 1.1 times faster at 20,480 (PERF.md, from
// scripts/train_scan_tiles.py).  lru_kernel loops in groups of kU steps and loads the
// next group's a and b before it runs the current group's dependent FMAs;
// its block is one warp of 32 channels (recurrentgemma-2b's 8 x 2560
// channels make 640 warps, within one warp of even over 132 SMs).
// Neighbouring threads hold neighbouring channels, so every load and store
// is a coalesced row.  Steps past the end load as the identity (a = 1, b =
// 0), as the JAX wrapper's padding does, and their h is not written.  Every
// sum runs in a fixed order: two runs give the same bits.  a and b are read
// through their batch and step strides (width contiguous); h is written
// contiguous.
//
// Types.  a and b are float32, bfloat16 or float16, both of one type, read
// as they lie and converted to float32 on load (float_kinds.cuh); every
// operation is float32.  h is written in a's type (rounded to nearest even
// once, as the TPU kernel's o_ref store rounds), h_fin in float32: the
// carried state, as the TPU kernel's scratch is.  The scratch carry and
// prod are float32.  In bf16 the function moves 2 + 2 + 2 bytes an element.
//
// Bound.  The function reads a and b and writes h: 12 bytes an element (the
// 2 FLOP an element count for nothing against that).  At recurrentgemma-2b's
// training microbatch (batch 2, seq 3072, width 2560) that is 189 MB, 0.056
// ms at 3.35 TB/s, and the chunked scan's 20 bytes 0.094 ms; at its prefill
// (batch 8) 755 MB, 0.225 ms, where the one-pass kernel runs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "float_kinds.cuh"

namespace {

constexpr int kThreads = 32;        // one-pass: channels per block, one warp
constexpr int kU = 16;              // one-pass: steps a group, loaded ahead
constexpr int kChunkThreads = 128;  // chunked: channels a block
constexpr int kChunk = 32;          // chunked: steps a chunk (lru_scan.CHUNK)
constexpr int kCarryU = 8;          // chunks whose L and Pr lru_carry loads ahead

// The group's a and b as they lie (Raw bits, converted where used).
template <typename TA, typename TB>
__device__ __forceinline__ void load_steps(const TA* __restrict__ ap, int64_t ass,
                                           const TB* __restrict__ bp, int64_t bss,
                                           int64_t t0, int64_t seq,
                                           typename Raw<TA>::type* xa,
                                           typename Raw<TB>::type* xb) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int64_t t = t0 + u;
    const bool in = t < seq;
    xa[u] = in ? load_raw(ap + t * ass) : raw_one<TA>();
    xb[u] = in ? load_raw(bp + t * bss) : typename Raw<TB>::type(0);
  }
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
lru_kernel(const TA* __restrict__ a, int64_t asb, int64_t ass, const TB* __restrict__ b,
           int64_t bsb, int64_t bss, TA* __restrict__ h, float* __restrict__ h_fin,
           int64_t seq, int64_t width) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t n = blockIdx.y;
  if (c >= width) return;
  const TA* ap = a + n * asb + c;
  const TB* bp = b + n * bsb + c;
  TA* hp = h + n * seq * width + c;

  typename Raw<TA>::type ca[kU], na[kU];
  typename Raw<TB>::type cb[kU], nb[kU];
  load_steps(ap, ass, bp, bss, 0, seq, ca, cb);
  float hv = 0.f;
  for (int64_t t0 = 0; t0 < seq; t0 += kU) {
    load_steps(ap, ass, bp, bss, t0 + kU, seq, na, nb);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      hv = fmaf(to_float<TA>(ca[u]), hv, to_float<TB>(cb[u]));
      if (t0 + u < seq) store_f(hp + (t0 + u) * width, hv);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
  h_fin[n * width + c] = hv;
}

// The chunk's a and b (a = 1, b = 0 past the end) into registers, as they
// lie (Raw bits, converted where used).
template <typename TA, typename TB>
__device__ __forceinline__ void load_chunk(const TA* __restrict__ ap, int64_t ass,
                                           const TB* __restrict__ bp, int64_t bss,
                                           int64_t t0, int64_t seq,
                                           typename Raw<TA>::type* va,
                                           typename Raw<TB>::type* vb) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const bool in = t0 + u < seq;
    va[u] = in ? load_raw(ap + u * ass) : raw_one<TA>();
    vb[u] = in ? load_raw(bp + u * bss) : typename Raw<TB>::type(0);
  }
}

// 1. The chunk's end state from a zero incoming one, and its product of a.
template <typename TA, typename TB>
__global__ void __launch_bounds__(kChunkThreads)
lru_local(const TA* __restrict__ a, int64_t asb, int64_t ass, const TB* __restrict__ b,
          int64_t bsb, int64_t bss, float* __restrict__ carry, float* __restrict__ prod,
          int64_t seq, int64_t width) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kChunkThreads + threadIdx.x;
  const int64_t k = blockIdx.y, n = blockIdx.z, nc = gridDim.y;
  if (c >= width) return;
  const int64_t t0 = k * kChunk;
  typename Raw<TA>::type va[kChunk];
  typename Raw<TB>::type vb[kChunk];
  load_chunk(a + n * asb + t0 * ass + c, ass, b + n * bsb + t0 * bss + c, bss, t0, seq, va, vb);
  float hv = 0.f, pr = 1.f;
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const float au = to_float<TA>(va[u]);
    hv = fmaf(au, hv, to_float<TB>(vb[u]));
    pr *= au;
  }
  const int64_t o = (n * nc + k) * width + c;
  carry[o] = hv;
  prod[o] = pr;
}

// 2. Each chunk's incoming state, written over its L: chunk 0's is 0, and
// chunk k + 1's is L_k + Pr_k * (chunk k's).
__global__ void __launch_bounds__(kChunkThreads)
lru_carry(float* __restrict__ carry, const float* __restrict__ prod, int64_t nc,
          int64_t width) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kChunkThreads + threadIdx.x;
  const int64_t n = blockIdx.y;
  if (c >= width) return;
  float cin = 0.f;
  float* cp = carry + n * nc * width + c;
  const float* pp = prod + n * nc * width + c;
  int64_t k = 0;
  for (; k + kCarryU <= nc; k += kCarryU) {
    float l[kCarryU], p[kCarryU];
#pragma unroll
    for (int u = 0; u < kCarryU; ++u) {
      l[u] = cp[(k + u) * width];
      p[u] = pp[(k + u) * width];
    }
#pragma unroll
    for (int u = 0; u < kCarryU; ++u) {
      cp[(k + u) * width] = cin;
      cin = fmaf(p[u], cin, l[u]);
    }
  }
  for (; k < nc; ++k) {
    const float l = cp[k * width], p = pp[k * width];
    cp[k * width] = cin;
    cin = fmaf(p, cin, l);
  }
}

// 3. The chunk's recurrence from its incoming state: h, and h_fin from the
// last chunk (steps past the end keep h: fmaf(1, h, 0) == h).
template <typename TA, typename TB>
__global__ void __launch_bounds__(kChunkThreads)
lru_fix(const TA* __restrict__ a, int64_t asb, int64_t ass, const TB* __restrict__ b,
        int64_t bsb, int64_t bss, const float* __restrict__ carry, TA* __restrict__ h,
        float* __restrict__ h_fin, int64_t seq, int64_t width) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kChunkThreads + threadIdx.x;
  const int64_t k = blockIdx.y, n = blockIdx.z, nc = gridDim.y;
  if (c >= width) return;
  const int64_t t0 = k * kChunk;
  typename Raw<TA>::type va[kChunk];
  typename Raw<TB>::type vb[kChunk];
  load_chunk(a + n * asb + t0 * ass + c, ass, b + n * bsb + t0 * bss + c, bss, t0, seq, va, vb);
  float hv = carry[(n * nc + k) * width + c];
  TA* hp = h + (n * seq + t0) * width + c;
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    hv = fmaf(to_float<TA>(va[u]), hv, to_float<TB>(vb[u]));
    if (t0 + u < seq) store_f(hp + u * width, hv);
  }
  if (k == nc - 1) h_fin[n * width + c] = hv;
}

template <typename TA, typename TB>
cudaError_t run(const void* a, int64_t asb, int64_t ass, const void* b, int64_t bsb,
                int64_t bss, void* h, float* h_fin, float* carry, float* prod, int64_t batch,
                int64_t seq, int64_t width, cudaStream_t st) {
  const auto* at = static_cast<const TA*>(a);
  const auto* bt = static_cast<const TB*>(b);
  auto* ht = static_cast<TA*>(h);
  const auto ub = static_cast<unsigned>(batch);
  if (carry == nullptr || prod == nullptr || seq == 0) {
    const dim3 grid(static_cast<unsigned>((width + kThreads - 1) / kThreads), ub);
    lru_kernel<TA, TB><<<grid, kThreads, 0, st>>>(at, asb, ass, bt, bsb, bss, ht, h_fin, seq,
                                                  width);
    return cudaGetLastError();
  }
  const int64_t nc = (seq + kChunk - 1) / kChunk;
  if (nc > 65535) return cudaErrorInvalidValue;
  const auto tiles = static_cast<unsigned>((width + kChunkThreads - 1) / kChunkThreads);
  const dim3 grid(tiles, static_cast<unsigned>(nc), ub);
  lru_local<TA, TB><<<grid, kChunkThreads, 0, st>>>(at, asb, ass, bt, bsb, bss, carry, prod,
                                                    seq, width);
  lru_carry<<<dim3(tiles, ub), kChunkThreads, 0, st>>>(carry, prod, nc, width);
  lru_fix<TA, TB><<<grid, kChunkThreads, 0, st>>>(at, asb, ass, bt, bsb, bss, carry, ht, h_fin,
                                                  seq, width);
  return cudaGetLastError();
}

}  // namespace

// The recurrence over a, b [batch, seq, width], each given by pointer, its
// FloatKind (a_kind == b_kind: float32, bfloat16 or float16) and its
// batch and step strides in elements (width contiguous), into h [batch, seq,
// width] in a's kind and h_fin [batch, width] fp32, both contiguous.  carry
// and prod (contiguous fp32 [batch, nc, width], nc = ceil(seq / kChunk)) are
// the chunked scan's scratch; null: the one-pass kernel.
extern "C" int repro_lru_scan(int64_t device, const void* a, int64_t asb, int64_t ass,
                              const void* b, int64_t bsb, int64_t bss, void* h, void* h_fin,
                              void* carry, void* prod, int64_t batch, int64_t seq,
                              int64_t width, int64_t a_kind, int64_t b_kind, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || width <= 0) return 0;
  if (seq < 0 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* ff = static_cast<float*>(h_fin);
  auto* cf = static_cast<float*>(carry);
  auto* pf = static_cast<float*>(prod);
  if (a_kind != b_kind) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_float(a_kind, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return static_cast<int>(
        run<T, T>(a, asb, ass, b, bsb, bss, h, ff, cf, pf, batch, seq, width, st));
  });
}
