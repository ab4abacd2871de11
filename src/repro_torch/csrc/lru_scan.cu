// RG-LRU linear recurrence for Hopper (sm_90a).
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
// step, so a loop inside the thread takes the place of the chunk axis: one
// thread per (batch, channel) runs the whole sequence in fp32 with one FMA a
// step.  Neighbouring threads hold neighbouring channels, so each step's loads
// and stores are coalesced 128-byte rows.  The loop goes in groups of kU
// steps and loads the next group's a and b before it runs the current
// group's dependent FMAs, so 2 kU loads a thread stay in flight.  A block is
// one warp of 32 channels: recurrentgemma-2b's 8 x 2560 channels make 640
// warps, which spread over the 132 SMs within one warp of even (128-thread
// blocks would put two of the 160 blocks on 28 SMs and leave most SMs one).
// Steps past the end load as the identity (a = 1, b = 0), as the JAX
// wrapper's padding does, and their h is not written.  a and b are read
// through their batch and step strides (width contiguous); h is written
// contiguous.
//
// Bound.  The function reads a and b and writes h: 12 bytes an element (the
// 2 FLOP an element count for nothing against that).  At recurrentgemma-2b's
// prefill (batch 8, seq 3072, width 2560) that is 755 MB, 0.225 ms at
// 3.35 TB/s.  One thread per channel gives only 20,480 threads, 155 a SM, so
// far fewer bytes are in flight than the HBM rate needs: expect it well above
// its bound.  A two-pass chunked scan across blocks (local scans, carry
// propagation, fix-up) is the fast design.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;  // channels per block: one warp
constexpr int kU = 16;        // steps a group; the next group is loaded ahead

__device__ __forceinline__ void load_steps(const float* __restrict__ ap, int64_t ass,
                                           const float* __restrict__ bp, int64_t bss,
                                           int64_t t0, int64_t seq, float* xa, float* xb) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int64_t t = t0 + u;
    const bool in = t < seq;
    xa[u] = in ? __ldg(ap + t * ass) : 1.f;
    xb[u] = in ? __ldg(bp + t * bss) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
lru_kernel(const float* __restrict__ a, int64_t asb, int64_t ass, const float* __restrict__ b,
           int64_t bsb, int64_t bss, float* __restrict__ h, float* __restrict__ h_fin,
           int64_t seq, int64_t width) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t n = blockIdx.y;
  if (c >= width) return;
  const float* ap = a + n * asb + c;
  const float* bp = b + n * bsb + c;
  float* hp = h + n * seq * width + c;

  float ca[kU], cb[kU], na[kU], nb[kU];
  load_steps(ap, ass, bp, bss, 0, seq, ca, cb);
  float hv = 0.f;
  for (int64_t t0 = 0; t0 < seq; t0 += kU) {
    load_steps(ap, ass, bp, bss, t0 + kU, seq, na, nb);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      hv = fmaf(ca[u], hv, cb[u]);
      if (t0 + u < seq) hp[(t0 + u) * width] = hv;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
  h_fin[n * width + c] = hv;
}

}  // namespace

// The recurrence over a, b [batch, seq, width] fp32, each given by pointer and
// its batch and step strides in elements (width contiguous), into h [batch,
// seq, width] and h_fin [batch, width], both contiguous fp32.
extern "C" int repro_lru_scan(int64_t device, const void* a, int64_t asb, int64_t ass,
                              const void* b, int64_t bsb, int64_t bss, void* h, void* h_fin,
                              int64_t batch, int64_t seq, int64_t width, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || width <= 0) return 0;
  if (seq < 0 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>((width + kThreads - 1) / kThreads),
            static_cast<unsigned>(batch));
  lru_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), asb, ass, static_cast<const float*>(b), bsb, bss,
      static_cast<float*>(h), static_cast<float*>(h_fin), seq, width);
  return static_cast<int>(cudaGetLastError());
}
