// The prior tables' element arithmetic, one copy for every kernel that
// reads them: K2's linear lookup (table_lerp.cu), K3's tapered interval
// inversion (tapered_invert.cu) and the whole prior transform of one row
// (prior_transform.cu).
//
// Exactness: every float32 operation is the one the plain versions
// (ops/tables.py::table_lerp_plain, ::tapered_invert_plain) perform, in
// the same order, each rounded on its own: the __f*_rn intrinsics forbid
// nvcc's contraction of a product into the following add (an FMA,
// rounded once instead of twice) here without -fmad=false for every
// kernel, and true division where the plain version divides by a tensor.

#pragma once

#include <cuda_runtime.h>

namespace prior_tables {

constexpr float kTiny = 1e-30f;
constexpr int kStage = 4;   // table rows a thread copies at once

// Linear interpolation of ``table`` [N] at the fractional position
// ``scaled``: s = clip(scaled, 0, N-1), i = min(floor(s), N-2),
// f = s - i, (1-f) table[i] + f table[i+1]; exact at the integer
// positions, so both endpoints come out exactly.  The table is read
// through the read-only path.
__device__ __forceinline__ float lerp(const float* __restrict__ table, int N,
                                      float scaled) {
  const float top = static_cast<float>(N - 1);
  const float s = scaled < 0.0f ? 0.0f : (scaled > top ? top : scaled);
  const int lo = min(static_cast<int>(s), N - 2);   // s >= 0: trunc = floor
  const float f = __fsub_rn(s, static_cast<float>(lo));
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, f), __ldg(table + lo)),
                   __fmul_rn(f, __ldg(table + lo + 1)));
}

// The ppf lookup of a unit-cube value: the lerp at u (N - 1), the
// product rounded as ``u * (size - 1)`` is.
__device__ __forceinline__ float ppf(const float* __restrict__ table, int N,
                                     float u) {
  return lerp(table, N, __fmul_rn(u, static_cast<float>(N - 1)));
}

// Copy ``rows`` float4 rows of a table into the block's shared memory,
// kStage rows a thread in flight before the first store waits on any.
// The caller synchronises the block after it.
template <int THREADS>
__device__ __forceinline__ void stage_rows(float4* __restrict__ dst,
                                           const float4* __restrict__ src,
                                           int rows) {
  for (int base = threadIdx.x; base < rows; base += kStage * THREADS) {
    float4 r[kStage];
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int k = base + i * THREADS;
      if (k < rows) r[i] = __ldg(src + k);
    }
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int k = base + i * THREADS;
      if (k < rows) dst[k] = r[i];
    }
  }
}

// The tapered cumulative G(j) of one element over its interval
// [i_lo, i_hi), from the packed cells {t0, t1c, t2c, xax},
// {r0, r1c, r2c, xax} (an element differences one side of them).
template <int SF>
struct Tapered {
  const float4* cells;   // the block's copy in shared memory
  int i_lo, i_hi, side;  // side: 0 cumulative tables, 1 tail tables
  bool degen;
  float ch, t0_lo, t1_lo, t2_lo, total;

  // the table row G(j) reads: j clamped into [i_lo, i_hi - 1]
  __device__ float4 row(int j) const {
    const int c = j < i_lo ? i_lo : (j > i_hi - 1 ? i_hi - 1 : j);
    return cells[2 * c + side];
  }

  // G(j) before normalisation, from its row c = row(j)
  __device__ float raw(const float4 c) const {
    const float d0 = __fsub_rn(c.x, t0_lo);
    if (SF == 0) return d0;
    const float d1 = __fsub_rn(c.y, t1_lo);
    if (SF == 1) return __fsub_rn(__fmul_rn(ch, d0), d1);
    const float d2 = __fsub_rn(c.z, t2_lo);
    // ch * ch * d0 - 2 * ch * d1 + d2, left to right
    return __fadd_rn(__fsub_rn(__fmul_rn(__fmul_rn(ch, ch), d0),
                               __fmul_rn(__fmul_rn(2.0f, ch), d1)),
                     d2);
  }

  __device__ float norm(int j) const {
    if (j < i_lo) return 0.0f;
    if (j >= i_hi) return 1.0f;
    if (degen) return 1.0f;
    return __fdiv_rn(raw(row(j)), total);
  }

  // norm(j) < u, exactly, without the divide: lim = total * m
  __device__ bool below(int j, float uu, double lim) const {
    if (j < i_lo) return 0.0f < uu;
    if (j >= i_hi || degen) return 1.0f < uu;
    return static_cast<double>(raw(row(j))) < lim;
  }
};

// The inverse of the power-law-tapered (exponent SF), renormalised CDF
// over [min(lo_in, hi_in), max(lo_in, hi_in)] at u_in, from the cells
// table [N, 2] of float4 (in shared memory).  n_probe = ceil(log2 N).
template <int SF>
__device__ float tapered_invert(const float4* cells, int N, int n_probe,
                                float u_in, float lo_in, float hi_in,
                                float xmin, float dx, float center) {
  const float a = fminf(lo_in, hi_in);
  const float b = fmaxf(lo_in, hi_in);
  Tapered<SF> g;
  g.cells = cells;
  // trunc toward zero, as the plain version's .to(int64)
  int i_lo = static_cast<int>(__fdiv_rn(__fsub_rn(a, xmin), dx));
  i_lo = i_lo < 0 ? 0 : (i_lo > N - 1 ? N - 1 : i_lo);
  int i_hi = static_cast<int>(__fdiv_rn(__fsub_rn(b, xmin), dx));
  if (i_hi == i_lo) i_hi = i_lo + 1;
  i_hi = i_hi < 1 ? 1 : (i_hi > N ? N : i_hi);
  g.i_lo = i_lo;
  g.i_hi = i_hi;
  g.degen = (i_hi - i_lo) == 1;
  g.ch = __fsub_rn(static_cast<float>(i_hi), center);
  g.side = -cells[2 * i_lo + 1].x < cells[2 * i_lo].x ? 1 : 0;
  const float4 c_lo = cells[2 * i_lo + g.side];
  g.t0_lo = c_lo.x;
  g.t1_lo = c_lo.y;
  g.t2_lo = c_lo.z;
  g.total = fmaxf(g.raw(g.row(i_hi - 1)), kTiny);

  const float uu = fmaxf(u_in, kTiny);
  const float pu = nextafterf(uu, 0.0f);
  const double lim = __dmul_rn(
      static_cast<double>(g.total),
      __dmul_rn(0.5, __dadd_rn(static_cast<double>(pu),
                               static_cast<double>(uu))));
  // lower bound: first j in [0, N-1] with G(j) >= u
  int lo_j = 0, hi_j = N - 1;
  for (int p = 0; p < n_probe; ++p) {
    const int mid = (lo_j + hi_j) >> 1;
    if (g.below(mid, uu, lim)) {
      lo_j = mid + 1;
    } else {
      hi_j = mid;
    }
  }
  const int ih = lo_j < 1 ? 1 : (lo_j > N - 1 ? N - 1 : lo_j);
  const float y_lo = g.norm(ih - 1);
  const float y_hi = g.norm(ih);
  const float denom = fmaxf(__fsub_rn(y_hi, y_lo), kTiny);
  return __fadd_rn(cells[2 * (ih - 1)].w,
                   __fmul_rn(__fsub_rn(uu, y_lo), __fdiv_rn(dx, denom)));
}

// ceil(log2 N): the probes of the lower-bound bisection
inline int probes(int N) {
  int n = 0;
  while ((1 << n) < N) ++n;
  return n;
}

}  // namespace prior_tables
