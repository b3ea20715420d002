// Fused hyperfine spectrum synthesis + chi-square: kernel K1.
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
//
// Two entries share that per-row code (fold_lines, row_chi2):
// hf_chi2_launch takes one transition and the components' (voff, tex,
// tau0, sigm) as [B, C] arrays (the per-transition K1, which a likelihood
// whose channels are split over devices runs); hf_lnl_launch takes every
// transition of a likelihood and the packed parameter rows theta
// [B, N C], and writes lnL[b] = -sum_t chi2_t[b] / (2 noise_t[b % R]^2).
// Around two per-transition launches an NH3 likelihood ran ~100 small
// operations (the unpack, the partition sums, the copies, the noise
// scaling), each a kernel and a gap; here warp (b, t) computes its row's
// components for transition t from theta by the model's own formulas (a
// Prep, instantiated per model), runs the channel loop and scales its
// chi-square, and the row's first warp sums the transitions in order:
// no atomics, so a graph replay repeats bit for bit.  One warp per (row,
// transition) keeps as many warps in flight as the per-transition
// launches had.

#include <cuda_runtime.h>

// The one-launch likelihood's arguments stand outside the unnamed
// namespace: hf_lnl_launch takes them, and a parameter of a type with
// internal linkage would give the launcher internal linkage too.
constexpr int kMaxTrans = 4;

// One transition of a one-launch likelihood.
struct LnlTrans {
  const float* dnu;     // [S] channel terms
  const float* t0;
  const float* tbg;
  const float* data;    // [R, S]
  const float* noise;   // [R] (noise_stride 1) or one value (0)
  const float* lines;   // [3 nhf], as hf_chi2_launch's
  const float* prep;    // [n_prep], the model's constants (its Prep)
  int S, nhf, noise_stride, n_prep;
};

struct LnlArgs {
  LnlTrans t[kMaxTrans];
  int n_trans;
};

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
// The one-launch likelihood: a block of kLnlWarps warps takes
// kLnlWarps / T rows of T transitions, one warp a (row, transition).
constexpr int kLnlWarps = 4;

__device__ __forceinline__ float ex2_approx_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Folds a row's per-line terms into its warp's table ``tab``, one float4
// per (component, line): {centre, -log2(e) / (2 hw^2), amplitude}, from
// the components' voff, tau0 and sigm (C values each).
__device__ __forceinline__ void fold_lines(float4* __restrict__ tab,
                                           const float* __restrict__ lines,
                                           const float* __restrict__ voff,
                                           const float* __restrict__ tau0,
                                           const float* __restrict__ sigm,
                                           int C, int nhf, int lane) {
  // lines = [f_j | rb_j | w_j], f_j = hf_freq_j / c and rb_j = nu *
  // voff_j / c (float64 on the host)
  const int L = C * nhf;
  for (int k = lane; k < L; k += 32) {
    const int c = k / nhf;
    const int j = k - c * nhf;
    const float f = lines[j];
    const float hw = sigm[c] * f;
    tab[k] = make_float4(-lines[nhf + j] - voff[c] * f,
                         kNegHalfLog2e / (hw * hw),
                         tau0[c] * lines[2 * nhf + j], 0.0f);
  }
  __syncwarp();
}

// The squared residual of one row against ``drow`` over S channels, from
// its warp's table and the components' tex (C values), summed over the
// warp: lane 0 holds the sum.
template <int K>
__device__ __forceinline__ float row_chi2(const float4* __restrict__ tab,
                                          const float* __restrict__ tex,
                                          const float* __restrict__ drow,
                                          const float* __restrict__ dnu,
                                          const float* __restrict__ t0,
                                          const float* __restrict__ tbg,
                                          int C, int S, int nhf, int lane) {
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
      const float rtex = 1.0f / tex[c];
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
  return acc;
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
  float4* tab = s_tab + warp * C * nhf;
  fold_lines(tab, lines, voff + b * C, tau0 + b * C, sigm + b * C, C, nhf,
             lane);
  const float acc = row_chi2<K>(tab, tex + b * C,
                                data + static_cast<size_t>(b % R) * S, dnu,
                                t0, tbg, C, S, nhf, lane);
  if (lane == 0) out[b] = acc;
}

// ---- the one-launch likelihood ----

// The model's per-row step: component c's (voff, tex, tau0, sigm) of
// transition ``tr`` from the row's packed parameters th[p * C + c], into
// comp[q * kMaxComp + c] for q = 0..3, computed by the whole warp.

// N2H+: (voff, tex, ltau, sigm) a component, tau0 = 10^ltau.
struct DiazenyliumPrep {
  static constexpr int kParams = 4;
  __device__ static void components(const float* __restrict__ th, int C,
                                    const LnlTrans& tr, int lane,
                                    float* __restrict__ comp) {
    if (lane < C) {
      comp[lane] = th[lane];
      comp[kMaxComp + lane] = th[C + lane];
      comp[2 * kMaxComp + lane] = exp10f(th[2 * C + lane]);
      comp[3 * kMaxComp + lane] = th[3 * C + lane];
    }
  }
};

// NH3: (voff, trot, tex, ntot, sigm, orth) a component; tau0 is
// models/ammonia.py::tau_main in its float32 operation order.  ``tr.prep``
// = [H nu / KB, E_n / KB, 2n + 1, 1 (para) or 2 (ortho), 1 (para) or 0,
// c^2 A / (8 pi nu^2), nu, sqrt(2 pi), c, then (E_l / KB, 2l + 1) for every
// level of the transition's species] (the ``ammonia.lnl_constants``
// layout).  The warp's lanes share each partition sum over the levels;
// lane c then computes component c.
struct AmmoniaPrep {
  static constexpr int kParams = 6;
  static constexpr int kHead = 9;
  __device__ static void components(const float* __restrict__ th, int C,
                                    const LnlTrans& tr, int lane,
                                    float* __restrict__ comp) {
    const float* p = tr.prep;
    const int n_lev = (tr.n_prep - kHead) / 2;
    // the partition sums, one component at a time over the warp's lanes;
    // lane c keeps component c's
    float qc = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float trot = th[C + c];
      float q = 0.0f;
      for (int l = lane; l < n_lev; l += 32)
        q += p[kHead + 2 * l + 1] * expf(-p[kHead + 2 * l] / trot);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        q += __shfl_xor_sync(0xffffffffu, q, off);
      if (lane == c) qc = q;
    }
    if (lane < C) {
      const int c = lane;
      const float trot = th[C + c];
      const float tex = th[2 * C + c];
      const float sigm = th[4 * C + c];
      const float orth = th[5 * C + c];
      const float zlev = p[2] * expf((1.0f / trot) * -p[1]);
      const float qtot = p[3] * qc;
      const float species = p[4] != 0.0f ? 1.0f - orth : orth;
      const float pop = exp10f(th[3 * C + c]) * species * zlev / qtot;
      const float eterm = expf((1.0f / tex) * -p[0]);
      const float expterm = (1.0f - eterm) / (1.0f + eterm);
      const float width = (1.0f / (sigm * p[6] * p[7])) * p[8];
      comp[c] = th[c];
      comp[kMaxComp + c] = tex;
      comp[2 * kMaxComp + c] = pop * p[5] * expterm * width;
      comp[3 * kMaxComp + c] = sigm;
    }
  }
};

// One warp's share of a one-launch likelihood: row b's components of
// transition ``tr``, its chi-square against data row r, times 1 / (2
// sigma_r^2) as PyTorch rounds the runner's (lane 0 holds it).
template <class Prep, int K>
__device__ __forceinline__ float lnl_part(const LnlTrans& tr,
                                          const float* __restrict__ th,
                                          int C, int r, float4* tab,
                                          float* comp, int lane) {
  Prep::components(th, C, tr, lane, comp);
  __syncwarp();
  fold_lines(tab, tr.lines, comp, comp + 2 * kMaxComp, comp + 3 * kMaxComp,
             C, tr.nhf, lane);
  const float chi2 = row_chi2<K>(tab, comp + kMaxComp,
                                 tr.data + static_cast<size_t>(r) * tr.S,
                                 tr.dnu, tr.t0, tr.tbg, C, tr.S, tr.nhf,
                                 lane);
  const float n = tr.noise[r * tr.noise_stride];
  return __fmul_rn(chi2, 1.0f / __fmul_rn(2.0f * n, n));
}

// Blocks of 128 threads a kernel keeps on an SM: at K = 12 (NH3) 7, the
// per-transition kernel's 72 registers a thread and 28 warps an SM; from
// K = 13 (N2H+) 6 (85 registers), which frees the registers the
// transition's pointers take: at B = 51,200 on an H100, N2H+ 0.2881 ->
// 0.2731 ms, where NH3 went 0.622 -> 0.659 ms.
constexpr int lnl_min_blocks(int K) { return K >= 13 ? 6 : 7; }

// Warp w of a block takes row blockIdx.x * (kLnlWarps / T) + w / T and
// transition w % T.  One copy of the row code serves every transition,
// which it reads from the launch's constants by index: a copy a
// transition (constant indices) ran 1.4x slower on an H100, its code too
// large for the instruction cache.
template <class Prep, int K>
__global__ void __launch_bounds__(32 * kLnlWarps, lnl_min_blocks(K))
hf_chi2_lnl_kernel(const float* __restrict__ theta, float* __restrict__ out,
                   int B, int C, int R, int max_nhf, LnlArgs args) {
  extern __shared__ float4 s_tab[];
  __shared__ float s_comp[kLnlWarps][4 * kMaxComp];
  __shared__ float s_part[kLnlWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int T = args.n_trans;
  const int rows = kLnlWarps / T;
  const int t = warp % T;
  const int b = blockIdx.x * rows + warp / T;
  const bool live = warp / T < rows && b < B;
  if (live) {
    const float part = lnl_part<Prep, K>(
        args.t[t], theta + static_cast<size_t>(b) * Prep::kParams * C, C,
        b % R, s_tab + warp * C * max_nhf, s_comp[warp], lane);
    if (lane == 0) s_part[warp] = part;
  }
  __syncthreads();
  if (live && t == 0 && lane == 0) {
    float lnl = 0.0f;
    for (int u = 0; u < T; ++u) lnl = __fsub_rn(lnl, s_part[warp + u]);
    out[b] = lnl;
  }
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, const float*, const float*,
                        const float*, const float*, const float*, float*,
                        int, int, int, int, int);

// kKernels[i] is the kernel whose lanes own kChanPerLane[i] channels
const Kernel kKernels[kNumK] = {hf_chi2_kernel<4>, hf_chi2_kernel<8>,
                                hf_chi2_kernel<12>, hf_chi2_kernel<13>,
                                hf_chi2_kernel<16>};

using LnlKernel = void (*)(const float*, float*, int, int, int, int,
                           LnlArgs);

// kLnlKernels[model][i]: model 0 NH3, 1 N2H+ (hf_lnl_launch's ``model``)
const LnlKernel kLnlKernels[2][kNumK] = {
    {hf_chi2_lnl_kernel<AmmoniaPrep, 4>, hf_chi2_lnl_kernel<AmmoniaPrep, 8>,
     hf_chi2_lnl_kernel<AmmoniaPrep, 12>, hf_chi2_lnl_kernel<AmmoniaPrep, 13>,
     hf_chi2_lnl_kernel<AmmoniaPrep, 16>},
    {hf_chi2_lnl_kernel<DiazenyliumPrep, 4>,
     hf_chi2_lnl_kernel<DiazenyliumPrep, 8>,
     hf_chi2_lnl_kernel<DiazenyliumPrep, 12>,
     hf_chi2_lnl_kernel<DiazenyliumPrep, 13>,
     hf_chi2_lnl_kernel<DiazenyliumPrep, 16>}};

// The index of the K whose chunks of 32 K channels cover the n spectra of
// S[i] channels with the fewest slots; on a tie the larger K (fewer
// chunks).
int best_k(const int* S, int n) {
  int best = 0, best_slots = 0;
  for (int i = 0; i < kNumK; ++i) {
    const int w = 32 * kChanPerLane[i];
    int slots = 0;
    for (int s = 0; s < n; ++s) slots += (S[s] + w - 1) / w * w;
    if (i == 0 || slots <= best_slots) best = i, best_slots = slots;
  }
  return best;
}

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
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t smem = sizeof(float4) * kRowsPerBlock * C * nhf;
  kKernels[best_k(&S, 1)]<<<blocks, 32 * kRowsPerBlock, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      voff, tex, tau0, sigm, data, dnu, t0, tbg, lines, out, B, C, R, S, nhf);
  return static_cast<int>(cudaGetLastError());
}

// The one-launch likelihood of ``model`` (0 NH3, 1 N2H+): lnL[b] of the
// packed rows theta [B, N C] over the ``n_trans`` transitions ``trans``
// (host memory, copied into the launch), on ``stream`` of card
// ``device``.  Returns as hf_chi2_launch.
extern "C" int hf_lnl_launch(int model, const float* theta, float* out,
                             int B, int C, int R, const LnlTrans* trans,
                             int n_trans, int device, void* stream) {
  if (B <= 0) return 0;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (model < 0 || model > 1 || C < 1 || C > kMaxComp || R < 1 ||
      B % R != 0 || n_trans < 1 || n_trans > kMaxTrans)
    return static_cast<int>(cudaErrorInvalidValue);
  LnlArgs args = {};
  args.n_trans = n_trans;
  int S[kMaxTrans];
  int max_nhf = 0;
  for (int t = 0; t < n_trans; ++t) {
    const LnlTrans& tr = trans[t];
    if (tr.nhf < 1 || tr.nhf > kMaxLines || tr.S < 1 ||
        (tr.noise_stride != 0 && tr.noise_stride != 1))
      return static_cast<int>(cudaErrorInvalidValue);
    args.t[t] = tr;
    S[t] = tr.S;
    max_nhf = tr.nhf > max_nhf ? tr.nhf : max_nhf;
  }
  const LnlKernel kernel = kLnlKernels[model][best_k(S, n_trans)];
  const int rows = kLnlWarps / n_trans;
  const int blocks = (B + rows - 1) / rows;
  const size_t smem = sizeof(float4) * kLnlWarps * C * max_nhf;
  // past 32 KB of tables (C * nhf > 512) the launch opts in to more
  // than the default 48 KB of shared memory
  if (smem > 32 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, 32 * kLnlWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      theta, out, B, C, R, max_nhf, args);
  return static_cast<int>(cudaGetLastError());
}
