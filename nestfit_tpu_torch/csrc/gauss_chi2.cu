// Fused Gaussian-mixture spectrum synthesis + chi-square.
//
// Replaces the TPU kernel nestfit_tpu/ops/fused.py::gauss_chi2_fused
// (pallas_call at fused.py:233).  For each flat row b (proposal t, pixel
// r = b % R) it computes
//   pred(s) = sum_c peak_c exp(-(dnu_s + voff_c f)^2 / (2 (sigm_c f)^2))
// with f = rest_freq / c (folded in float64 on the host, passed as
// float32), and writes chi2[b] = sum_s (data[r, s] - pred(s))^2.
// Semantics follow the plain path (models/gaussian.py::mixture): no
// channel padding, no sentinel, no clamp of sigm (the Pallas kernel
// clamped only for its padded rows).
//
// Bound on the H100: the SFU.  A row costs C*S exponentials (2*380 =
// 760 at C=2 on a 380-channel axis) against 12 bytes of parameters per
// component and 4 bytes out, so the SFU's exponential rate (16 per clock
// per SM) sets the floor.  What stood above it: one warp per row re-read
// the pixel's 1.5 KB data row (and dnu) for each of the T proposals of a
// launch, 156 MB from L2 at B = 102,400, and each exponential was a full
// expf.
//
// Design: one warp per pixel and a group of P <= kMaxProps proposals of
// that pixel (rows t*R + r).  Each lane owns K channels lane + 32k of a
// chunk of 32 K channels (K one of kChanPerLane, as in hf_chi2.cu; a
// spectrum runs in as many chunks as it needs) and holds their dnu and
// the pixel's data in registers, loaded once for the whole group.  The
// warp first folds its group's components into a table in shared
// memory, one lane per (proposal, component): {centre,
// -log2(e) / (2 hw^2), peak}, so the division is done once and the
// proposal loop reads one broadcast 16-byte row per component (loading
// and dividing per proposal inside the loop measured 1.5x slower).
// Each (component, channel) is then one subtract, two multiplies, one
// ex2.approx.ftz and one FMA; each proposal's squared residual stays in
// its own register and is reduced by shuffles at the end.
// ex2.approx.ftz flushes results below 2^-126 to zero, where the plain
// path cuts at exp(-87); such terms are below 1e-37 of a peak.  The
// launcher takes the largest P of 8, 4, 2, 1 that still leaves 16 warps
// per SM: at B = 102,400 the time fell with every step of P up to 8.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxComp = 8;
constexpr int kMaxProps = 8;
constexpr int kWarps = 4;   // warps per block
constexpr int kChanPerLane[] = {4, 8, 12, 13, 16};
constexpr int kNumK = sizeof(kChanPerLane) / sizeof(kChanPerLane[0]);
constexpr float kNegHalfLog2e = -0.72134752044448170f;   // -log2(e) / 2

__device__ __forceinline__ float ex2_approx_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int K>
__global__ void __launch_bounds__(32 * kWarps)
gauss_chi2_kernel(const float* __restrict__ voff,
                  const float* __restrict__ sigm,
                  const float* __restrict__ peak,
                  const float* __restrict__ data,
                  const float* __restrict__ dnu, float* __restrict__ out,
                  int T, int R, int S, int C, int P, float fc) {
  __shared__ float4 s_tab[kWarps][kMaxProps * kMaxComp];
  const int lane = threadIdx.x & 31;
  const long long w =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int groups = (T + P - 1) / P;
  if (w >= static_cast<long long>(groups) * R) return;   // whole warps
  const int r = static_cast<int>(w % R);
  const int t0 = static_cast<int>(w / R) * P;
  const int np = min(P, T - t0);

  // the group's components: {centre, -log2(e) / (2 hw^2), peak}
  float4* tab = s_tab[threadIdx.x >> 5];
  for (int k = lane; k < np * C; k += 32) {
    const int p = k / C;
    const size_t i = (static_cast<size_t>(t0 + p) * R + r) * C + (k - p * C);
    const float hw = sigm[i] * fc;
    tab[k] = make_float4(-voff[i] * fc, kNegHalfLog2e / (hw * hw), peak[i],
                         0.0f);
  }
  __syncwarp();

  const float* drow = data + static_cast<size_t>(r) * S;
  float acc[kMaxProps];
#pragma unroll
  for (int p = 0; p < kMaxProps; ++p) acc[p] = 0.0f;
  for (int base = lane; base < S; base += 32 * K) {
    // channel base + 32k of this lane; past S: dnu 0 (a finite stand-in)
    // and no residual
    float x[K], dat[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool in = base + 32 * k < S;
      x[k] = in ? dnu[base + 32 * k] : 0.0f;
      dat[k] = in ? drow[base + 32 * k] : 0.0f;
    }
#pragma unroll
    for (int p = 0; p < kMaxProps; ++p) {
      if (p >= np) continue;   // unrolled: acc[p] stays in a register
      const float4* t = tab + p * C;
      float pred[K];
#pragma unroll
      for (int k = 0; k < K; ++k) pred[k] = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float4 e = t[c];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float d = x[k] - e.x;
          pred[k] = fmaf(e.z, ex2_approx_ftz(d * d * e.y), pred[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (base + 32 * k < S) {
          const float dev = dat[k] - pred[k];
          acc[p] = fmaf(dev, dev, acc[p]);
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kMaxProps; ++p) {
    if (p >= np) continue;
    float a = acc[p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      a += __shfl_down_sync(0xffffffffu, a, off);
    if (lane == 0) out[static_cast<size_t>(t0 + p) * R + r] = a;
  }
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, const float*, float*, int, int, int,
                        int, int, float);

// kKernels[i] is the kernel whose lanes own kChanPerLane[i] channels
const Kernel kKernels[kNumK] = {gauss_chi2_kernel<4>, gauss_chi2_kernel<8>,
                                gauss_chi2_kernel<12>, gauss_chi2_kernel<13>,
                                gauss_chi2_kernel<16>};

}  // namespace

// Launches on ``stream`` of card ``device``, with P the largest of 8, 4,
// 2, 1 that leaves at least 16 warps per SM.  Returns cudaGetLastError()
// after the launch (0 on success); an argument outside the kernel's
// limits returns cudaErrorInvalidValue.
extern "C" int gauss_chi2_launch(const float* voff, const float* sigm,
                                 const float* peak, const float* data,
                                 const float* dnu, float* out, int B, int C,
                                 int R, int S, float fc, int device,
                                 void* stream) {
  if (B <= 0) return 0;
  // the launch goes to the tensors' card, whatever this library's
  // runtime last had current
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (C < 1 || C > kMaxComp || R < 1 || S < 1 || B % R != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = B / R;
  // the K whose chunks of 32 K channels cover S with the fewest slots;
  // on a tie the larger K (fewer chunks)
  int best = 0, best_slots = 0;
  for (int i = 0; i < kNumK; ++i) {
    const int w = 32 * kChanPerLane[i];
    const int slots = (S + w - 1) / w * w;
    if (i == 0 || slots <= best_slots) best = i, best_slots = slots;
  }
  int n_sm = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int P = kMaxProps;
  while (P > 1 && static_cast<long long>((T + P - 1) / P) * R < 16LL * n_sm)
    P /= 2;
  const long long warps = static_cast<long long>((T + P - 1) / P) * R;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kKernels[best]<<<static_cast<unsigned>(blocks), 32 * kWarps, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      voff, sigm, peak, data, dnu, out, T, R, S, C, P, fc);
  return static_cast<int>(cudaGetLastError());
}
