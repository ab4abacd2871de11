// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel ssd_scan_chunked
// (src/repro/kernels/ssd_scan/ssd_scan.py:78, body _ssd_kernel :27).  Per
// (batch b, head h), with state S [N, P]:
//
//     S_t = exp(A dt_t) S_{t-1} + dt_t B_t (x) x_t,     y_t = C_t . S_t
//
// computed chunk by chunk as the SSD decomposition does: inside a chunk the
// quadratic form y_intra = (C B^T (.) exp(A (cdt_t - cdt_i)) (.) dt_i, i <= t) x,
// across chunks y_carry = exp(A cdt_t) C S and the state update
// S' = exp(A cdt_last) S + sum_i exp(A (cdt_last - cdt_i)) dt_i B_i (x) x_i.
// Besides y it writes the final state S_fin [B, H, N, P], which the model's
// prefill keeps in its cache (the TPU kernel drops its scratch state).
//
// Design.  One block of 256 threads owns one (b, h) and loops over chunks of
// 32 steps: the loop takes the place of the TPU's sequential chunk axis.  The
// state stays on chip for the whole sequence: each thread holds an
// (N/16) x (P/16) tile of it in registers and updates it, and a copy in
// shared memory (32 KiB at N 128, P 64) feeds every thread's y_carry.  A
// chunk's x, B, B^T, C^T and the masked decay matrix W^T (32 x 32 fp32, not
// the 64 KiB a 128-step chunk's C x C tile would need) sit in shared memory,
// 97 KiB in all at N 128, P 64, so two blocks share an SM.  cumsum(dt) is
// a warp scan; every product is an fp32 FMA loop over register tiles.  Steps
// past the sequence's end load as zeros (dt = 0 is the identity transition,
// as the JAX wrapper's padding is), and their y is not written.  Every tensor
// is addressed with element strides (last dim contiguous), so the model's
// x [B, S, H, P] and B, C (column slices of one projection) go in as views.
//
// Bound.  The function reads x, dt, B, C (B and C once per batch: they are
// shared by the heads) and writes y and S_fin; it needs the recurrence's
// 4 N P operations a step and head, at the fp32 rate (67 TFLOP/s, no tensor
// core runs exact fp32).  At mamba2-130m's prefill (B 8, H 24, S 1024,
// P 64, N 128) that is 115 MB, 34 us at 3.35 TB/s, and 6.4 GFLOP, 96 us:
// operations bound it.  This kernel does the chunked form's ~1.4x as many
// and reads its operands from shared memory, so expect it well above that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kQ = 32;         // chunk length (one warp's scan)
constexpr int kQP = kQ + 4;    // padded rows of B^T, C^T, W^T

template <int NV>
__device__ __forceinline__ void ld(const float* p, float* out) {
  if constexpr (NV % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NV; i += 4) {
      float4 t = *reinterpret_cast<const float4*>(p + i);
      out[i] = t.x; out[i + 1] = t.y; out[i + 2] = t.z; out[i + 3] = t.w;
    }
  } else if constexpr (NV == 2) {
    float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < NV; ++i) out[i] = p[i];
  }
}

template <int N, int P>
struct Layout {
  static constexpr int TN = N / 16, TP = P / 16;  // state tile per thread
  static constexpr int kSmemFloats =
      kQ * P + kQ * N + 2 * N * kQP + kQ * kQP + N * P + 4 * kQ;
};

template <int N, int P>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, int64_t xsb, int64_t xsh, int64_t xss,
           const float* __restrict__ dt, int64_t dsb, int64_t dsh, int64_t dss,
           const float* __restrict__ A, const float* __restrict__ Bm, int64_t bsb,
           int64_t bss, const float* __restrict__ Cm, int64_t csb, int64_t css,
           float* __restrict__ y, int64_t ysb, int64_t ysh, int64_t yss,
           float* __restrict__ s_fin, int64_t seq) {
  using L = Layout<N, P>;
  constexpr int TN = L::TN, TP = L::TP;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                // [kQ][P]   x of the chunk
  float* bs = xs + kQ * P;         // [kQ][N]   B
  float* bt = bs + kQ * N;         // [N][kQP]  B^T
  float* ct = bt + N * kQP;        // [N][kQP]  C^T
  float* wt = ct + N * kQP;        // [kQ][kQP] W^T: wt[i][t] = W[t][i]
  float* st = wt + kQ * kQP;       // [N][P]    state before the chunk
  float* cdt = st + N * P;         // [kQ]      cumsum(dt)
  float* dts = cdt + kQ;           // [kQ]      dt
  float* dec = dts + kQ;           // [kQ]      exp(A cdt_t)
  float* wgt = dec + kQ;           // [kQ]      exp(A (cdt_last - cdt_i)) dt_i

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int64_t h = blockIdx.x, b = blockIdx.y;
  const float a = A[h];
  const float* xb = x + b * xsb + h * xsh;
  const float* db = dt + b * dsb + h * dsh;
  const float* bb = Bm + b * bsb;
  const float* cb = Cm + b * csb;
  float* yb = y + b * ysb + h * ysh;

  float s_reg[TN][TP];  // S[ty*TN + i][tx*TP + j]
#pragma unroll
  for (int i = 0; i < TN; ++i)
#pragma unroll
    for (int j = 0; j < TP; ++j) s_reg[i][j] = 0.f;
  for (int e = tid; e < N * P; e += kThreads) st[e] = 0.f;

  for (int64_t c0 = 0; c0 < seq; c0 += kQ) {
    const int64_t valid = seq - c0 < kQ ? seq - c0 : kQ;
    __syncthreads();  // the last chunk's operands are no longer read
    for (int e = tid; e < kQ * P; e += kThreads) {
      const int t = e / P, p = e % P;
      xs[e] = t < valid ? xb[(c0 + t) * xss + p] : 0.f;
    }
    for (int e = tid; e < kQ * N; e += kThreads) {
      const int t = e / N, n = e % N;
      const float bv = t < valid ? bb[(c0 + t) * bss + n] : 0.f;
      const float cv = t < valid ? cb[(c0 + t) * css + n] : 0.f;
      bs[e] = bv;
      bt[n * kQP + t] = bv;
      ct[n * kQP + t] = cv;
    }
    float last_cdt = 0.f;
    if (tid < kQ) {  // warp 0: inclusive scan of dt over the chunk
      const float d = tid < valid ? db[(c0 + tid) * dss] : 0.f;
      float cs = d;
#pragma unroll
      for (int w = 1; w < kQ; w <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, cs, w);
        if (tid >= w) cs += u;
      }
      last_cdt = __shfl_sync(0xffffffffu, cs, kQ - 1);
      cdt[tid] = cs;
      dts[tid] = d;
      dec[tid] = expf(a * cs);
      wgt[tid] = expf(a * (last_cdt - cs)) * d;
    }
    __syncthreads();

    // W[t][i] = (C_t . B_i) exp(A (cdt_t - cdt_i)) dt_i for i <= t, else 0;
    // thread (ty, tx) computes t = 2ty + {0,1}, i = 2tx + {0,1}.
    {
      float g[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float cv[2], bv[2];
        ld<2>(ct + n * kQP + 2 * ty, cv);
        ld<2>(bt + n * kQP + 2 * tx, bv);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int q = 0; q < 2; ++q) g[r][q] = fmaf(cv[r], bv[q], g[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int t = 2 * ty + r, i = 2 * tx + q;
          wt[i * kQP + t] = i <= t ? g[r][q] * expf(a * (cdt[t] - cdt[i])) * dts[i] : 0.f;
        }
    }
    __syncthreads();

    // y[t][p] = sum_i W[t][i] x[i][p] + exp(A cdt_t) sum_n C[t][n] S[n][p];
    // thread (ty, tx) computes t = 2ty + {0,1}, p = tx*TP + {0..TP-1}.
    {
      float yi[2][TP], yc[2][TP];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < TP; ++j) yi[r][j] = yc[r][j] = 0.f;
      const int t_hi = 2 * ty + 1;
      for (int i = 0; i <= t_hi; ++i) {
        float wv[2], xv[TP];
        ld<2>(wt + i * kQP + 2 * ty, wv);
        ld<TP>(xs + i * P + tx * TP, xv);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < TP; ++j) yi[r][j] = fmaf(wv[r], xv[j], yi[r][j]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[2], sv[TP];
        ld<2>(ct + n * kQP + 2 * ty, cv);
        ld<TP>(st + n * P + tx * TP, sv);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < TP; ++j) yc[r][j] = fmaf(cv[r], sv[j], yc[r][j]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = 2 * ty + r;
        if (t < valid) {
          float* yrow = yb + (c0 + t) * yss + tx * TP;
#pragma unroll
          for (int j = 0; j < TP; ++j) yrow[j] = yi[r][j] + dec[t] * yc[r][j];
        }
      }
    }

    // S' = exp(A cdt_last) S + sum_i B[i][n] (wgt_i x[i][p]), in registers.
    {
      const float e_last = dec[kQ - 1];
#pragma unroll
      for (int i = 0; i < TN; ++i)
#pragma unroll
        for (int j = 0; j < TP; ++j) s_reg[i][j] *= e_last;
#pragma unroll 4
      for (int i = 0; i < kQ; ++i) {
        float bv[TN], xv[TP];
        ld<TN>(bs + i * N + ty * TN, bv);
        ld<TP>(xs + i * P + tx * TP, xv);
        const float w = wgt[i];
#pragma unroll
        for (int j = 0; j < TP; ++j) xv[j] *= w;
#pragma unroll
        for (int r = 0; r < TN; ++r)
#pragma unroll
          for (int j = 0; j < TP; ++j) s_reg[r][j] = fmaf(bv[r], xv[j], s_reg[r][j]);
      }
    }
    __syncthreads();  // every y_carry has read the old state
#pragma unroll
    for (int r = 0; r < TN; ++r)
#pragma unroll
      for (int j = 0; j < TP; ++j) st[(ty * TN + r) * P + tx * TP + j] = s_reg[r][j];
  }

  float* sb = s_fin + (b * gridDim.x + h) * static_cast<int64_t>(N * P);
#pragma unroll
  for (int r = 0; r < TN; ++r)
#pragma unroll
    for (int j = 0; j < TP; ++j) sb[(ty * TN + r) * P + tx * TP + j] = s_reg[r][j];
}

template <int N, int P>
cudaError_t run(const float* x, int64_t xsb, int64_t xsh, int64_t xss, const float* dt,
                int64_t dsb, int64_t dsh, int64_t dss, const float* A, const float* Bm,
                int64_t bsb, int64_t bss, const float* Cm, int64_t csb, int64_t css,
                float* y, int64_t ysb, int64_t ysh, int64_t yss, float* s_fin,
                int64_t batch, int64_t heads, int64_t seq, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Layout<N, P>::kSmemFloats;
  auto* kern = ssd_kernel<N, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  kern<<<grid, kThreads, smem, stream>>>(x, xsb, xsh, xss, dt, dsb, dsh, dss, A, Bm, bsb,
                                         bss, Cm, csb, css, y, ysb, ysh, yss, s_fin, seq);
  return cudaGetLastError();
}

}  // namespace

// SSD scan of x [batch, heads, seq, p] with dt [batch, heads, seq], A [heads]
// and B, C [batch, seq, n], all fp32 and given by pointer and element strides
// (last dim contiguous); writes y [batch, heads, seq, p] (strided likewise)
// and the final state s_fin [batch, heads, n, p] (contiguous).  (n, p) is one
// of (16, 16), (32, 32), (64, 64), (128, 64).
extern "C" int repro_ssd_scan(int64_t device, const void* x, int64_t xsb, int64_t xsh,
                              int64_t xss, const void* dt, int64_t dsb, int64_t dsh,
                              int64_t dss, const void* A, const void* Bm, int64_t bsb,
                              int64_t bss, const void* Cm, int64_t csb, int64_t css,
                              void* y, int64_t ysb, int64_t ysh, int64_t yss, void* s_fin,
                              int64_t batch, int64_t heads, int64_t seq, int64_t n,
                              int64_t p, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || heads <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
#define REPRO_SSD_NP(NV, PV)                                                             \
  if (n == NV && p == PV)                                                                \
    return static_cast<int>(run<NV, PV>(                                                 \
        static_cast<const float*>(x), xsb, xsh, xss, static_cast<const float*>(dt), dsb, \
        dsh, dss, static_cast<const float*>(A), static_cast<const float*>(Bm), bsb, bss, \
        static_cast<const float*>(Cm), csb, css, static_cast<float*>(y), ysb, ysh, yss,  \
        static_cast<float*>(s_fin), batch, heads, seq, s));
  REPRO_SSD_NP(16, 16)
  REPRO_SSD_NP(32, 32)
  REPRO_SSD_NP(64, 64)
  REPRO_SSD_NP(128, 64)
#undef REPRO_SSD_NP
  return static_cast<int>(cudaErrorInvalidValue);
}
