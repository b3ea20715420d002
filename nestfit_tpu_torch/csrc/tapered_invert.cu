// Inverse of the power-law-tapered, renormalised interval CDF.
//
// Replaces the TPU kernel nestfit_tpu/ops/tables.py::tapered_invert
// (pallas_call at tables.py:199), the centroid placement of the
// sequential ResolvedPlacementPrior.  For each element it brackets the
// grid interval [i_lo, i_hi) of [min(x_lo, x_hi), max(x_lo, x_hi)], forms
// the tapered cumulative
//   G(j) = sum_{i_lo < i <= j} trap_i ((i_hi - i)/span)^s,  s in {0, 1, 2}
// as differences of the cumulative index-moment tables t0/t1c/t2c
// (binomial in the centred index ch = i_hi - center), or, where the
// interval starts past the median (-r0[i_lo] < t0[i_lo]), of the tail
// tables r0/r1c/r2c (the same less their totals): near the right end t0
// is close to its total and its float32 differences cancel, by up to ~4
// cells of the float64 answer on the IRDC centroid prior, where the
// tail tables' do not.  It normalises G by G(i_hi - 1), finds
// the first cell j with G(j) >= u and interpolates linearly inside
// [j-1, j].  The single-cell interval has its own case, and the "tiny"
// guards follow the plain version.
//
// Exactness: every float32 operation is the one the plain version
// (ops/tables.py::tapered_invert_plain) performs, in the same order,
// rounded on its own: true division for (x - xmin) / dx, G / total and
// dx / denom, and no contraction of a product into the following add
// (the __f*_rn intrinsics; nvcc contracts a*b+c into an FMA otherwise,
// and -fmad=false would take the FMAs of the other kernels too).  One
// ulp in G or one cell in i_lo can move the result by a table step;
// rounded alike, kernel and plain version agree bit for bit.  The
// search is the plain version's fixed full-range lower-bound bisection
// (ceil(log2 N) probes): a float32 G need not be monotone, and another
// probe sequence could stop in another cell.  (The TPU kernel counted
// G < u densely over all N cells, because a TPU core has no gather.)
//
// Bound on the H100: memory, 16 B per element (u, x_lo, x_hi in, one
// result out); at the path's widths (B = 3,200 to 102,400) that is
// below the time any launch takes.  What is left is the latency of one
// element's chain of ceil(log2 N) dependent probes, each a table read
// and a comparison, so the design shortens the chain:
// - The tables are packed per cell as two float4 rows {t0, t1c, t2c,
//   xax} and {r0, r1c, r2c, xax} (32 N bytes, built once per
//   distribution and device): an element picks its side once, and a
//   probe reads one 16-byte row of it.
// - Each block copies the packed table into shared memory, every
//   thread's rows of it (and the element's inputs) in flight at once.
//   Read through L1 instead, the probes past the bisection's first
//   levels missed L1 and waited on L2: slower than the parent's staged
//   tables at every path width.
// - A probe decides fl(G(j) / total) < u without the divide: with
//   m = (pred(u) + u) / 2, the rounding boundary below u, the rounded
//   quotient is below u exactly when G(j) < total * m.  total * m is
//   exact in float64 (m has a 25-bit odd significand, so the product
//   takes at most 49 bits), so the comparison is exact and the probe
//   picks the plain version's cell; G(j) never equals total * m (that
//   needs more than float32's 24 bits), so no tie arises.  The divides
//   that produce values (the interval's cells, y_lo, y_hi, dx / denom)
//   stay.
// 128-thread blocks, one element per thread and no grid cap spread a
// compacted B = 3,200 over 25 SMs.
//
// The element arithmetic (the Tapered struct, the search, the staging)
// is prior_tables.cuh's, the one copy that the whole-transform kernel
// prior_transform.cu shares.

#include <cuda_runtime.h>

#include "prior_tables.cuh"

namespace {

constexpr int kThreads = 128;

template <int SF>
__global__ void __launch_bounds__(kThreads)
tapered_invert_kernel(const float4* __restrict__ cells_g,
                      const float* __restrict__ u,
                      const float* __restrict__ x_lo,
                      const float* __restrict__ x_hi,
                      float* __restrict__ out, long long B, int N,
                      int n_probe, float xmin, float dx, float center) {
  extern __shared__ float4 cells[];
  const long long e =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = e < B;
  // the element's inputs, then the copy of the table, all in flight at
  // once
  const float lo_in = live ? x_lo[e] : 0.0f;
  const float hi_in = live ? x_hi[e] : 0.0f;
  const float u_in = live ? u[e] : 1.0f;
  prior_tables::stage_rows<kThreads>(cells, cells_g, 2 * N);
  __syncthreads();
  if (!live) return;
  out[e] = prior_tables::tapered_invert<SF>(cells, N, n_probe, u_in, lo_in,
                                            hi_in, xmin, dx, center);
}

}  // namespace

// ``cells`` is the [N, 2, 4] float32 table {t0, t1c, t2c, xax},
// {r0, r1c, r2c, xax} per cell, 16-byte aligned.  Launches on ``stream``
// of card ``device``.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int tapered_invert_launch(const void* cells, const float* u,
                                     const float* x_lo, const float* x_hi,
                                     float* out, long long B, int N,
                                     int sfact, float xmin, float dx,
                                     float center, int device,
                                     void* stream) {
  if (B <= 0) return 0;
  // the launch goes to the tensors' card, whatever this library's
  // runtime last had current
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const long long blocks = (B + kThreads - 1) / kThreads;
  // the table in shared memory: 32 N bytes, within the default 48 KB
  if (N < 2 || N > 1536 || sfact < 0 || sfact > 2 ||
      blocks > 0x7fffffffLL ||
      reinterpret_cast<size_t>(cells) % sizeof(float4) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * sizeof(float4) * static_cast<size_t>(N);
  const int n_probe = prior_tables::probes(N);
  const float4* c = static_cast<const float4*>(cells);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(blocks);
  if (sfact == 0) {
    tapered_invert_kernel<0><<<g, kThreads, smem, st>>>(
        c, u, x_lo, x_hi, out, B, N, n_probe, xmin, dx, center);
  } else if (sfact == 1) {
    tapered_invert_kernel<1><<<g, kThreads, smem, st>>>(
        c, u, x_lo, x_hi, out, B, N, n_probe, xmin, dx, center);
  } else {
    tapered_invert_kernel<2><<<g, kThreads, smem, st>>>(
        c, u, x_lo, x_hi, out, B, N, n_probe, xmin, dx, center);
  }
  return static_cast<int>(cudaGetLastError());
}
