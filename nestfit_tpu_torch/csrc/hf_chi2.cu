// Fused hyperfine spectrum synthesis + chi-square for one transition.
//
// Replaces the TPU kernel nestfit_tpu/ops/fused.py::hf_chi2_fused
// (pallas_call at fused.py:159).  For each flat row b (proposal t, pixel
// r = b % R) it computes, per component c,
//   tau_c(s) = sum_j tau0_c w_j exp(-(dnu_s - cen_cj)^2 / (2 hw_cj^2))
// over the transition's hyperfine lines, then the prediction
//   pred(s) = sum_c T0_s (1/expm1(T0_s/Tex_c) - Tbg_s) (-expm1(-tau_c(s)))
// and writes chi2[b] = sum_s (data[r, s] - pred(s))^2.  Semantics follow
// the plain path (models/hyperfine.py): expm1 where the TPU kernel wrote
// exp(x)-1, no clamping of sigm/tex, line centres relative to the rest
// frequency.
//
// Bound on the H100: the SFU.  A row costs C*S*(nhf+2) exponentials
// (2*380*20 = 15,200 at C=2 on the (1,1) line) against 4 bytes of
// parameters per component and 4 bytes out, so the SFU's exponential
// rate (16 per clock per SM) sets the floor, not memory.
//
// Design: one warp per row, kRowsPerBlock rows per block.  The warp first
// folds its row's per-line terms into a shared table, one float4 per
// (component, line): {centre, -log2(e) / (2 hw^2), amplitude}.  Each lane
// owns K channels lane + 32k of a chunk of 32 K channels (K one of
// kChanPerLane; a spectrum runs in as many chunks as it needs) and keeps
// their dnu, one component's K opacity accumulators and the K
// predictions in registers.  The line loop is outermost: one
// broadcast shared load per line feeds K channels, each
//   d = x - cen;  tau += amp * ex2(d * d * k)
// that is one subtract, two multiplies, one MUFU.EX2 and one FMA, so the
// SFU and not instruction issue limits the loop (5.2 instructions per
// exponential in the SASS, unrolled by 4 lines).  The subtraction comes
// before the square: expanding (x s - m)^2 cancels at |x / hw| ~ 100.
// ex2.approx.ftz flushes results below 2^-126 to zero; such terms are
// below 1e-38 of tau.  The per-channel terms keep expm1f: they are 2 of
// every nhf + 2 exponentials, and 1 - exp(-tau) loses digits at small
// tau.  They cost ~75 instructions per component and channel, about as
// much issue as an 18-line loop, and run after the SFU-bound line loop
// rather than beside it: that phase, not the SFU, holds the kernel above
// its bound.  A lane's channels past S load finite stand-ins and are
// left out of the residual.  The data row is read from global memory
// (the T proposals of a launch share it through L2); the squared
// residual is reduced with warp shuffles.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxComp = 8;
constexpr int kRowsPerBlock = 2;    // one warp per row
// The channels per lane that are built: K = 12 covers S = 380 and 384
// (NH3) and K = 13 S = 400 (N2H+) in one chunk; any other S runs in
// chunks of the K that leaves the fewest idle channel slots.
constexpr int kChanPerLane[] = {4, 8, 12, 13, 16};
constexpr int kNumK = sizeof(kChanPerLane) / sizeof(kChanPerLane[0]);
// The per-row tables take kRowsPerBlock * C * nhf * 16 B of dynamic
// shared memory: 49,152 B at C = 8 and 192 lines, the most a launch may
// ask for without opting in.  N2H+ (3-2) has 45 lines.
constexpr int kMaxLines = 192;
constexpr float kNegHalfLog2e = -0.72134752044448170f;   // -log2(e) / 2

__device__ __forceinline__ float ex2_approx_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 14 blocks of 64 threads per SM (72 registers a thread) hold a
// compacted launch (B = 3,200: 1,600 blocks) in one wave on 132 SMs.
template <int K>
__global__ void __launch_bounds__(32 * kRowsPerBlock, 14)
hf_chi2_kernel(const float* __restrict__ voff, const float* __restrict__ tex,
               const float* __restrict__ tau0,
               const float* __restrict__ sigm,
               const float* __restrict__ data,
               const float* __restrict__ dnu, const float* __restrict__ t0,
               const float* __restrict__ tbg,
               const float* __restrict__ lines, float* __restrict__ out,
               int B, int C, int R, int S, int nhf) {
  extern __shared__ float4 s_tab[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kRowsPerBlock + warp;
  if (b >= B) return;   // whole warps exit together

  // this row's line terms; lines = [f_j | rb_j | w_j], f_j =
  // hf_freq_j / c and rb_j = nu * voff_j / c (float64 on the host)
  const int L = C * nhf;
  float4* tab = s_tab + warp * L;
  for (int k = lane; k < L; k += 32) {
    const int c = k / nhf;
    const int j = k - c * nhf;
    const float f = lines[j];
    const float hw = sigm[b * C + c] * f;
    tab[k] = make_float4(-lines[nhf + j] - voff[b * C + c] * f,
                         kNegHalfLog2e / (hw * hw),
                         tau0[b * C + c] * lines[2 * nhf + j], 0.0f);
  }
  __syncwarp();

  const float* drow = data + static_cast<size_t>(b % R) * S;
  float acc = 0.0f;
  for (int base = lane; base < S; base += 32 * K) {
    // channel base + 32k of this lane; past S the loads give finite
    // stand-ins (dnu 0, T0 1, Tbg 0) and the residual skips them
    float x[K], pred[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      x[k] = base + 32 * k < S ? dnu[base + 32 * k] : 0.0f;
      pred[k] = 0.0f;
    }
    for (int c = 0; c < C; ++c) {
      const float4* t = tab + c * nhf;
      float tau[K];
#pragma unroll
      for (int k = 0; k < K; ++k) tau[k] = 0.0f;
#pragma unroll 4
      for (int j = 0; j < nhf; ++j) {
        const float4 e = t[j];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float d = x[k] - e.x;
          tau[k] = fmaf(e.z, ex2_approx_ftz(d * d * e.y), tau[k]);
        }
      }
      const float rtex = 1.0f / tex[b * C + c];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool in = base + 32 * k < S;
        const float t0s = in ? t0[base + 32 * k] : 1.0f;
        const float tbgs = in ? tbg[base + 32 * k] : 0.0f;
        // T0/Tex > 0 keeps expm1 in the normal range of the fast divide
        const float iem = __fdividef(1.0f, expm1f(t0s * rtex));
        pred[k] += t0s * (iem - tbgs) * (-expm1f(-tau[k]));
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (base + 32 * k < S) {
        const float dev = drow[base + 32 * k] - pred[k];
        acc += dev * dev;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[b] = acc;
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, const float*, const float*,
                        const float*, const float*, const float*, float*,
                        int, int, int, int, int);

// kKernels[i] is the kernel whose lanes own kChanPerLane[i] channels
const Kernel kKernels[kNumK] = {hf_chi2_kernel<4>, hf_chi2_kernel<8>,
                                hf_chi2_kernel<12>, hf_chi2_kernel<13>,
                                hf_chi2_kernel<16>};

}  // namespace

// Launches on ``stream`` of card ``device``.  Returns cudaGetLastError()
// after the launch (0 on success); an argument outside the kernel's
// limits returns cudaErrorInvalidValue.
extern "C" int hf_chi2_launch(const float* voff, const float* tex,
                              const float* tau0, const float* sigm,
                              const float* data, const float* dnu,
                              const float* t0, const float* tbg,
                              const float* lines, float* out, int B, int C,
                              int R, int S, int nhf, int device, void* stream) {
  if (B <= 0) return 0;
  // the launch goes to the tensors' card, whatever this library's
  // runtime last had current
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (C < 1 || C > kMaxComp || nhf < 1 || nhf > kMaxLines || R < 1 ||
      S < 1 || B % R != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the K whose chunks of 32 K channels cover S with the fewest slots;
  // on a tie the larger K (fewer chunks)
  int best = 0, best_slots = 0;
  for (int i = 0; i < kNumK; ++i) {
    const int w = 32 * kChanPerLane[i];
    const int slots = (S + w - 1) / w * w;
    if (i == 0 || slots <= best_slots) best = i, best_slots = slots;
  }
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t smem = sizeof(float4) * kRowsPerBlock * C * nhf;
  kKernels[best]<<<blocks, 32 * kRowsPerBlock, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      voff, tex, tau0, sigm, data, dnu, t0, tbg, lines, out, B, C, R, S, nhf);
  return static_cast<int>(cudaGetLastError());
}
