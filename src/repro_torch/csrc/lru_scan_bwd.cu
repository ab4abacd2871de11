// Gradient of the RG-LRU linear recurrence for Hopper (sm_90a): kernel 7b.
//
// No TPU kernel computes it.  The JAX package trains recurrentgemma with
// XLA's autodiff of the model's prefill twin _lru_chunked_jnp
// (src/repro/models/blocks.py:397); this replaces that autodiff, and
// lru_scan.cu (kernel 7) computes the forward.  With the forward
//
//     h_t = a_t * h_{t-1} + b_t      over [batch, seq, width], h_{-1} = 0,
//
// and g_t the gradient of h_t (its own dh_t and all that h_t feeds):
//
//     g_t = dh_t + a_{t+1} * g_{t+1},   g_{seq-1} = dh_{seq-1} + dh_fin,
//     db_t = g_t,   da_t = g_t * h_{t-1},
//
// a reverse recurrence with a shifted by one step; dh_fin is the gradient of
// the final state (none: zero).  h_{t-1} is read from the forward's h.
//
// Design.  Kernel 7 runs one thread per (batch, channel) over the whole
// sequence; at a training microbatch (batch 2, width 2560) that is 5,120
// threads, too few loads in flight for the HBM rate (its note).  The
// backward is chunked in time instead, in three launches:
//   1. lru_bwd_local, grid (channel tiles, chunks, batch): each thread runs
//      the reverse recurrence over one chunk of kChunk steps of one channel
//      from a zero carry, with every step's a and dh loaded up front (2 kChunk
//      loads in flight a thread).  Writing c_t = a_t g_t for the carry a step
//      hands to the step before, the chunk's outgoing carry is affine in its
//      incoming one: c_out = L + Pr * c_in, with L the outgoing carry from
//      zero and Pr the product of the chunk's a.  It writes L and Pr.
//   2. lru_bwd_carry, one thread per (batch, channel): walks the chunks from
//      the last, whose incoming carry is dh_fin, and writes each chunk's
//      incoming carry over its L.
//   3. lru_bwd_fix, the grid of 1: reruns each chunk's reverse recurrence
//      from its incoming carry and writes db = g and da = g * h_{t-1}.
// Steps past the end load as a = 1, dh = 0 (they pass the carry through)
// and write nothing.  Every sum runs in a fixed order: two runs give the
// same bits.  a, h and dh are read through their batch and step strides
// (width contiguous); da and db are written contiguous.
//
// Bound.  The function reads a, h and dh and writes da and db: 20 bytes an
// element (its 3 FLOP an element count for nothing against that).  At
// recurrentgemma-2b's training microbatch (batch 2, seq 3072, width 2560)
// that is 315 MB, 0.094 ms at 3.35 TB/s.  This design reads a and dh twice
// (28 bytes an element, 1.4x the bound) to keep the chunks independent; the
// carries, 8 bytes a chunk and channel, stay in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channels a block
constexpr int kChunk = 32;     // steps a chunk (lru_scan.BWD_CHUNK)
constexpr int kCarryU = 8;     // chunks whose L and Pr phase 2 loads ahead

// The chunk's a and dh (a = 1, dh = 0 past the end) into registers.
__device__ __forceinline__ void load_chunk(const float* __restrict__ ap, int64_t ass,
                                           const float* __restrict__ dp, int64_t dss,
                                           int64_t t0, int64_t seq, float* va, float* vd) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const bool in = t0 + u < seq;
    va[u] = in ? __ldg(ap + u * ass) : 1.f;
    vd[u] = in ? __ldg(dp + u * dss) : 0.f;
  }
}

// 1. The chunk's outgoing carry from a zero incoming one, and its product of a.
__global__ void __launch_bounds__(kThreads)
lru_bwd_local(const float* __restrict__ a, int64_t asb, int64_t ass,
              const float* __restrict__ dh, int64_t dsb, int64_t dss, float* __restrict__ carry,
              float* __restrict__ prod, int64_t seq, int64_t width) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t k = blockIdx.y, n = blockIdx.z, nc = gridDim.y;
  if (c >= width) return;
  const int64_t t0 = k * kChunk;
  float va[kChunk], vd[kChunk];
  load_chunk(a + n * asb + t0 * ass + c, ass, dh + n * dsb + t0 * dss + c, dss, t0, seq, va, vd);
  float cr = 0.f, pr = 1.f;
#pragma unroll
  for (int u = kChunk - 1; u >= 0; --u) {
    cr = va[u] * (vd[u] + cr);
    pr *= va[u];
  }
  const int64_t o = (n * nc + k) * width + c;
  carry[o] = cr;
  prod[o] = pr;
}

// 2. Each chunk's incoming carry, written over its L: the last chunk's is
// dh_fin (0 without it), and chunk k - 1's is L_k + Pr_k * (chunk k's).
__global__ void __launch_bounds__(kThreads)
lru_bwd_carry(float* __restrict__ carry, const float* __restrict__ prod,
              const float* __restrict__ dh_fin, int64_t nc, int64_t width) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t n = blockIdx.y;
  if (c >= width) return;
  float cin = dh_fin != nullptr ? dh_fin[n * width + c] : 0.f;
  float* cp = carry + n * nc * width + c;
  const float* pp = prod + n * nc * width + c;
  int64_t k = nc - 1;
  for (; k >= kCarryU - 1; k -= kCarryU) {
    float l[kCarryU], p[kCarryU];
#pragma unroll
    for (int u = 0; u < kCarryU; ++u) {
      l[u] = cp[(k - u) * width];
      p[u] = pp[(k - u) * width];
    }
#pragma unroll
    for (int u = 0; u < kCarryU; ++u) {
      cp[(k - u) * width] = cin;
      cin = fmaf(p[u], cin, l[u]);
    }
  }
  for (; k >= 0; --k) {
    const float l = cp[k * width], p = pp[k * width];
    cp[k * width] = cin;
    cin = fmaf(p, cin, l);
  }
}

// 3. The chunk's reverse recurrence from its incoming carry: db and da.
__global__ void __launch_bounds__(kThreads)
lru_bwd_fix(const float* __restrict__ a, int64_t asb, int64_t ass, const float* __restrict__ h,
            int64_t hsb, int64_t hss, const float* __restrict__ dh, int64_t dsb, int64_t dss,
            const float* __restrict__ carry, float* __restrict__ da, float* __restrict__ db,
            int64_t seq, int64_t width) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t k = blockIdx.y, n = blockIdx.z, nc = gridDim.y;
  if (c >= width) return;
  const int64_t t0 = k * kChunk;
  float va[kChunk], vd[kChunk], hp[kChunk];
  load_chunk(a + n * asb + t0 * ass + c, ass, dh + n * dsb + t0 * dss + c, dss, t0, seq, va, vd);
  const float* hb = h + n * hsb + c;
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const int64_t t = t0 + u - 1;  // h_{t0 + u - 1}; h_{-1} = 0
    hp[u] = (t >= 0 && t < seq) ? __ldg(hb + t * hss) : 0.f;
  }
  float cr = carry[(n * nc + k) * width + c];
  float* dap = da + (n * seq + t0) * width + c;
  float* dbp = db + (n * seq + t0) * width + c;
#pragma unroll
  for (int u = kChunk - 1; u >= 0; --u) {
    const float g = vd[u] + cr;
    cr = va[u] * g;
    if (t0 + u < seq) {
      dbp[u * width] = g;
      dap[u * width] = g * hp[u];
    }
  }
}

}  // namespace

// The recurrence's gradients da, db [batch, seq, width] (contiguous fp32)
// from the forward's a and h and the output gradient dh, each [batch, seq,
// width] fp32 given by pointer and its batch and step strides in elements
// (width contiguous), and dh_fin [batch, width] contiguous (null: zero).
// Scratch (contiguous fp32): carry and prod [batch, nc, width], nc =
// ceil(seq / 32).
extern "C" int repro_lru_scan_bwd(int64_t device, const void* a, int64_t asb, int64_t ass,
                                  const void* h, int64_t hsb, int64_t hss, const void* dh,
                                  int64_t dsb, int64_t dss, const void* dh_fin, void* da,
                                  void* db, void* carry, void* prod, int64_t batch,
                                  int64_t seq, int64_t width, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || width <= 0 || seq <= 0) return 0;
  const int64_t nc = (seq + kChunk - 1) / kChunk;
  if (batch > 65535 || nc > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto tiles = static_cast<unsigned>((width + kThreads - 1) / kThreads);
  const dim3 grid(tiles, static_cast<unsigned>(nc), static_cast<unsigned>(batch));
  const auto* af = static_cast<const float*>(a);
  const auto* df = static_cast<const float*>(dh);
  auto* cf = static_cast<float*>(carry);
  auto* pf = static_cast<float*>(prod);
  lru_bwd_local<<<grid, kThreads, 0, st>>>(af, asb, ass, df, dsb, dss, cf, pf, seq, width);
  lru_bwd_carry<<<dim3(tiles, static_cast<unsigned>(batch)), kThreads, 0, st>>>(
      cf, pf, static_cast<const float*>(dh_fin), nc, width);
  lru_bwd_fix<<<grid, kThreads, 0, st>>>(af, asb, ass, static_cast<const float*>(h), hsb, hss,
                                         df, dsb, dss, cf, static_cast<float*>(da),
                                         static_cast<float*>(db), seq, width);
  return static_cast<int>(cudaGetLastError());
}
