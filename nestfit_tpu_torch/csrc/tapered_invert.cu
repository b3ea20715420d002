// Inverse of the power-law-tapered, renormalised interval CDF.
//
// Replaces the TPU kernel nestfit_tpu/ops/tables.py::tapered_invert
// (pallas_call at tables.py:199), the centroid placement of the
// sequential ResolvedPlacementPrior.  For each element it brackets the
// grid interval [i_lo, i_hi) of [min(x_lo, x_hi), max(x_lo, x_hi)], forms
// the tapered cumulative
//   G(j) = sum_{i_lo < i <= j} trap_i ((i_hi - i)/span)^s,  s in {0, 1, 2}
// from the cumulative index-moment tables t0/t1c/t2c (binomial in the
// centred index ch = i_hi - center), normalises it by G(i_hi - 1), finds
// the first cell j with G(j) >= u and interpolates linearly inside
// [j-1, j].  The single-cell interval has its own case, and the "tiny"
// guards follow the plain version (priors/distributions.py).
//
// The TPU kernel counted G < u densely over all N cells, because a
// TPU core has lanes and no gather.  G is monotone inside [i_lo, i_hi)
// and pinned to 0 below and 1 above, so a lower-bound binary search
// (ceil(log2 N) probes, the same fixed count as the plain version) finds
// the same cell in O(log N) table reads.
//
// Bound on the H100: memory.  Each element reads u, x_lo, x_hi and
// writes the result (16 B per element); the four tables (4 x N x 4 B =
// 8 KB at N = 500) are loaded once per block into shared memory, where
// every probe reads them.  One thread per element, grid-stride loop.

#include <cuda_runtime.h>

namespace {

constexpr float kTiny = 1e-30f;

template <int SF>
struct Tapered {
  const float* t0;
  const float* t1;
  const float* t2;
  int i_lo, i_hi;
  bool degen;
  float ch, t0_lo, t1_lo, t2_lo, total;

  __device__ float raw(int j) const {
    const int jj = j < i_lo ? i_lo : (j > i_hi - 1 ? i_hi - 1 : j);
    const float d0 = t0[jj] - t0_lo;
    if (SF == 0) return d0;
    const float d1 = t1[jj] - t1_lo;
    if (SF == 1) return ch * d0 - d1;
    const float d2 = t2[jj] - t2_lo;
    return ch * ch * d0 - 2.0f * ch * d1 + d2;
  }

  __device__ float norm(int j) const {
    if (j < i_lo) return 0.0f;
    if (j >= i_hi) return 1.0f;
    if (degen) return 1.0f;
    return raw(j) / total;
  }
};

template <int SF>
__global__ void tapered_invert_kernel(const float* __restrict__ t0g,
                                      const float* __restrict__ t1g,
                                      const float* __restrict__ t2g,
                                      const float* __restrict__ xaxg,
                                      const float* __restrict__ u,
                                      const float* __restrict__ x_lo,
                                      const float* __restrict__ x_hi,
                                      float* __restrict__ out, long long B,
                                      int N, int n_probe, float xmin,
                                      float dx, float center) {
  extern __shared__ float smem[];
  float* t0 = smem;
  float* t1 = smem + N;
  float* t2 = smem + 2 * N;
  float* xax = smem + 3 * N;
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    t0[k] = t0g[k];
    t1[k] = t1g[k];
    t2[k] = t2g[k];
    xax[k] = xaxg[k];
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < B; e += stride) {
    const float a = fminf(x_lo[e], x_hi[e]);
    const float b = fmaxf(x_lo[e], x_hi[e]);
    Tapered<SF> g;
    g.t0 = t0;
    g.t1 = t1;
    g.t2 = t2;
    int i_lo = static_cast<int>((a - xmin) / dx);   // trunc, as astype
    i_lo = i_lo < 0 ? 0 : (i_lo > N - 1 ? N - 1 : i_lo);
    int i_hi = static_cast<int>((b - xmin) / dx);
    if (i_hi == i_lo) i_hi = i_lo + 1;
    i_hi = i_hi < 1 ? 1 : (i_hi > N ? N : i_hi);
    g.i_lo = i_lo;
    g.i_hi = i_hi;
    g.degen = (i_hi - i_lo) == 1;
    g.ch = static_cast<float>(i_hi) - center;
    g.t0_lo = t0[i_lo];
    g.t1_lo = t1[i_lo];
    g.t2_lo = t2[i_lo];
    g.total = fmaxf(g.raw(i_hi - 1), kTiny);

    const float uu = fmaxf(u[e], kTiny);
    // lower bound: first j in [0, N-1] with G(j) >= u
    int lo_j = 0, hi_j = N - 1;
    for (int p = 0; p < n_probe; ++p) {
      const int mid = (lo_j + hi_j) >> 1;
      if (g.norm(mid) < uu) {
        lo_j = mid + 1;
      } else {
        hi_j = mid;
      }
    }
    const int ih = lo_j < 1 ? 1 : (lo_j > N - 1 ? N - 1 : lo_j);
    const float y_lo = g.norm(ih - 1);
    const float y_hi = g.norm(ih);
    const float denom = fmaxf(y_hi - y_lo, kTiny);
    out[e] = xax[ih - 1] + (uu - y_lo) * (dx / denom);
  }
}

}  // namespace

// Launches on ``stream`` of card ``device``.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int tapered_invert_launch(const float* t0, const float* t1c,
                                     const float* t2c, const float* xax,
                                     const float* u, const float* x_lo,
                                     const float* x_hi, float* out,
                                     long long B, int N, int sfact,
                                     float xmin, float dx, float center,
                                     int n_sm, int device, void* stream) {
  if (B <= 0) return 0;
  // the launch goes to the tensors' card, whatever this library's
  // runtime last had current
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  // 4 tables in shared memory: 16 N bytes, within the default 48 KB
  if (N < 2 || N > 3072 || sfact < 0 || sfact > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int n_probe = 0;
  while ((1 << n_probe) < N) ++n_probe;   // ceil(log2 N)
  const int threads = 256;
  long long blocks = (B + threads - 1) / threads;
  const long long cap = 8LL * (n_sm > 0 ? n_sm : 132);
  if (blocks > cap) blocks = cap;
  const size_t smem = 4 * static_cast<size_t>(N) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(blocks);
  if (sfact == 0) {
    tapered_invert_kernel<0><<<g, threads, smem, st>>>(
        t0, t1c, t2c, xax, u, x_lo, x_hi, out, B, N, n_probe, xmin, dx, center);
  } else if (sfact == 1) {
    tapered_invert_kernel<1><<<g, threads, smem, st>>>(
        t0, t1c, t2c, xax, u, x_lo, x_hi, out, B, N, n_probe, xmin, dx, center);
  } else {
    tapered_invert_kernel<2><<<g, threads, smem, st>>>(
        t0, t1c, t2c, xax, u, x_lo, x_hi, out, B, N, n_probe, xmin, dx, center);
  }
  return static_cast<int>(cudaGetLastError());
}
