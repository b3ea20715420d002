// Fused Gaussian-mixture spectrum synthesis + chi-square.
//
// Replaces the TPU kernel nestfit_tpu/ops/fused.py::gauss_chi2_fused
// (pallas_call at fused.py:233).  For each flat row b (proposal t, pixel
// r = b % R) it computes
//   pred(s) = sum_c peak_c exp(-(dnu_s + voff_c f)^2 / (2 (sigm_c f)^2))
// with f = rest_freq / c (folded in float64 on the host, passed as
// float32), and writes chi2[b] = sum_s (data[r, s] - pred(s))^2.
// Semantics follow the plain path (models/gaussian.py::gauss_predict):
// no channel padding, no sentinel, no clamp of sigm (the Pallas kernel
// clamped only for its padded rows).
//
// Bound on the H100: arithmetic.  A row costs C*S exponentials (2*380 =
// 760 at C=2 on a 380-channel axis) against 12 bytes of parameters per
// component and 4 bytes out, so the SFU's exponential rate (16 per clock
// per SM) sets the floor, not memory.  Design: one warp per row,
// channels across the lanes (~12 per lane at S=380).  Each lane holds
// the row's C centres, 1/(2 hw^2) and peaks in registers (C is a
// template parameter, so the component loop unrolls), leaving one
// subtract, two multiplies, one exponential and one FMA per component
// and channel.  The data row is read from global memory; it is reused
// across the T proposals of a launch through L2.  The squared residual
// is reduced with warp shuffles; nothing but chi2 leaves the SM.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxComp = 8;
constexpr int kRowsPerBlock = 8;   // one warp per row

template <int C>
__global__ void gauss_chi2_kernel(const float* __restrict__ voff,
                                  const float* __restrict__ sigm,
                                  const float* __restrict__ peak,
                                  const float* __restrict__ data,
                                  const float* __restrict__ dnu,
                                  float* __restrict__ out,
                                  int B, int R, int S, float fc) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kRowsPerBlock + warp;
  if (b >= B) return;   // whole warps exit together

  float cen[C], idn[C], pk[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float hw = sigm[b * C + c] * fc;
    cen[c] = -voff[b * C + c] * fc;
    idn[c] = 0.5f / (hw * hw);
    pk[c] = peak[b * C + c];
  }

  const float* drow = data + static_cast<size_t>(b % R) * S;
  float acc = 0.0f;
  for (int s = lane; s < S; s += 32) {
    const float x = dnu[s];
    float pred = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float d = x - cen[c];
      pred += pk[c] * expf(-(d * d) * idn[c]);
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
void launch(const float* voff, const float* sigm, const float* peak,
            const float* data, const float* dnu, float* out, int B, int R,
            int S, float fc, cudaStream_t stream) {
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  gauss_chi2_kernel<C><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
      voff, sigm, peak, data, dnu, out, B, R, S, fc);
}

}  // namespace

// Launches on ``stream`` of card ``device``.  Returns cudaGetLastError()
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: launch<1>(voff, sigm, peak, data, dnu, out, B, R, S, fc, st); break;
    case 2: launch<2>(voff, sigm, peak, data, dnu, out, B, R, S, fc, st); break;
    case 3: launch<3>(voff, sigm, peak, data, dnu, out, B, R, S, fc, st); break;
    case 4: launch<4>(voff, sigm, peak, data, dnu, out, B, R, S, fc, st); break;
    case 5: launch<5>(voff, sigm, peak, data, dnu, out, B, R, S, fc, st); break;
    case 6: launch<6>(voff, sigm, peak, data, dnu, out, B, R, S, fc, st); break;
    case 7: launch<7>(voff, sigm, peak, data, dnu, out, B, R, S, fc, st); break;
    case 8: launch<8>(voff, sigm, peak, data, dnu, out, B, R, S, fc, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
