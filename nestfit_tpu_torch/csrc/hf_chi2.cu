// Fused hyperfine spectrum synthesis + chi-square for one NH3 transition.
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
// Bound on the H100: arithmetic.  A row costs C*S*(nhf+2) exponentials
// (2*380*20 = 15,200 at C=2 on the (1,1) line) against 4 bytes of
// parameters per component and 4 bytes out, so the SFU's exponential
// rate (16 per clock per SM) sets the floor, not memory.  Design: one
// warp per row, channels across the lanes (~12 per lane at S=380).  The
// warp first computes its row's per-line centre, 1/(2 hw^2) and
// amplitude into shared memory (C*nhf entries, all lanes then read the
// same address: a broadcast), so the inner loop is one subtract, two
// multiplies, one exponential and one FMA per line and channel.  The
// data row is read from global memory; it is reused across the T
// proposals of a launch through L2.  The squared residual is reduced
// with warp shuffles; nothing but chi2 leaves the SM.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxComp = 8;
// N2H+ (3-2) has 45 lines.  The three per-row tables below take
// 3 * kRowsPerBlock * C * kMaxLines * 4 B: 36,864 B at C = 8, inside the
// 48 KB of static shared memory a block may hold.
constexpr int kMaxLines = 48;
constexpr int kRowsPerBlock = 8;   // one warp per row

template <int C>
__global__ void hf_chi2_kernel(const float* __restrict__ voff,
                               const float* __restrict__ tex,
                               const float* __restrict__ tau0,
                               const float* __restrict__ sigm,
                               const float* __restrict__ data,
                               const float* __restrict__ dnu,
                               const float* __restrict__ t0,
                               const float* __restrict__ tbg,
                               const float* __restrict__ lines,
                               float* __restrict__ out,
                               int B, int R, int S, int nhf) {
  __shared__ float s_cen[kRowsPerBlock][C * kMaxLines];
  __shared__ float s_idn[kRowsPerBlock][C * kMaxLines];
  __shared__ float s_amp[kRowsPerBlock][C * kMaxLines];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kRowsPerBlock + warp;
  if (b >= B) return;   // whole warps exit together

  // per-line tables of this row: lines = [f_j | rb_j | w_j], f_j =
  // hf_freq_j / c and rb_j = nu * voff_j / c (float64 on the host)
  const int K = C * nhf;
  for (int k = lane; k < K; k += 32) {
    const int c = k / nhf;
    const int j = k - c * nhf;
    const float f = lines[j];
    const float rb = lines[nhf + j];
    const float w = lines[2 * nhf + j];
    const float hw = sigm[b * C + c] * f;
    s_cen[warp][k] = -rb - voff[b * C + c] * f;
    s_idn[warp][k] = 0.5f / (hw * hw);
    s_amp[warp][k] = tau0[b * C + c] * w;
  }
  float tex_r[C];
#pragma unroll
  for (int c = 0; c < C; ++c) tex_r[c] = tex[b * C + c];
  __syncwarp();

  const float* drow = data + static_cast<size_t>(b % R) * S;
  float acc = 0.0f;
  for (int s = lane; s < S; s += 32) {
    const float x = dnu[s];
    const float t0s = t0[s];
    const float tbgs = tbg[s];
    float pred = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* cen = &s_cen[warp][c * nhf];
      const float* idn = &s_idn[warp][c * nhf];
      const float* amp = &s_amp[warp][c * nhf];
      float tau = 0.0f;
      for (int j = 0; j < nhf; ++j) {
        const float d = x - cen[j];
        tau += amp[j] * expf(-(d * d) * idn[j]);
      }
      const float iem = 1.0f / expm1f(t0s / tex_r[c]);
      pred += t0s * (iem - tbgs) * (-expm1f(-tau));
    }
    const float dev = drow[s] - pred;
    acc += dev * dev;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[b] = acc;
}

template <int C>
void launch(const float* voff, const float* tex, const float* tau0,
            const float* sigm, const float* data, const float* dnu,
            const float* t0, const float* tbg, const float* lines,
            float* out, int B, int R, int S, int nhf, cudaStream_t stream) {
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  hf_chi2_kernel<C><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
      voff, tex, tau0, sigm, data, dnu, t0, tbg, lines, out, B, R, S, nhf);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: launch<1>(voff, tex, tau0, sigm, data, dnu, t0, tbg, lines, out, B, R, S, nhf, st); break;
    case 2: launch<2>(voff, tex, tau0, sigm, data, dnu, t0, tbg, lines, out, B, R, S, nhf, st); break;
    case 3: launch<3>(voff, tex, tau0, sigm, data, dnu, t0, tbg, lines, out, B, R, S, nhf, st); break;
    case 4: launch<4>(voff, tex, tau0, sigm, data, dnu, t0, tbg, lines, out, B, R, S, nhf, st); break;
    case 5: launch<5>(voff, tex, tau0, sigm, data, dnu, t0, tbg, lines, out, B, R, S, nhf, st); break;
    case 6: launch<6>(voff, tex, tau0, sigm, data, dnu, t0, tbg, lines, out, B, R, S, nhf, st); break;
    case 7: launch<7>(voff, tex, tau0, sigm, data, dnu, t0, tbg, lines, out, B, R, S, nhf, st); break;
    case 8: launch<8>(voff, tex, tau0, sigm, data, dnu, t0, tbg, lines, out, B, R, S, nhf, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
