"""Prior table lookups: kernels K2 (``csrc/table_lerp.cu``) and K3
(``csrc/tapered_invert.cu``).

Ports of ``nestfit_tpu/ops/tables.py::table_lerp`` and
``::tapered_invert``.  Each wrapper launches its Hopper kernel for CUDA
tensors and runs the plain PyTorch version beside it for CPU tensors.
"""

import ctypes
import math

import torch

from nestfit_tpu_torch.ops import _build

LERP_SOURCE = "table_lerp.cu"
TAPER_SOURCE = "tapered_invert.cu"


# table, N, scaled, out, B, device, stream
_LERP_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
              ctypes.c_void_p]
# cells, u, x_lo, x_hi, out, B, N, sfact, xmin, dx, center, device, stream
_TAPER_ARGS = [ctypes.c_void_p] * 5 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _check(name, dev, tensors):
    for label, x in tensors:
        if x.device != dev or x.dtype != torch.float32 \
                or not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous float32 "
                             f"on {dev}, got {x.dtype} on {x.device}")


def table_lerp_plain(table, scaled):
    """Plain version of :func:`table_lerp`: gather the two bracketing
    entries and blend them, each operation rounded on its own (the
    kernel repeats them in order, so the two agree bit for bit)."""
    N = table.shape[0]
    s = torch.clamp(scaled, 0.0, N - 1.0)
    lo = torch.clamp(s.to(torch.int64), max=N - 2)   # s >= 0: trunc = floor
    f = s - lo.to(s.dtype)
    return (1.0 - f) * table[lo] + f * table[lo + 1]


def table_lerp(table, scaled):
    """Linear interpolation of the 1-D ``table`` ``[N]`` at fractional
    indices ``scaled`` (any shape), clipped to ``[0, N-1]``; exact at
    integer positions."""
    if scaled.device.type == "cpu":
        return table_lerp_plain(table, scaled)
    dev = scaled.device
    _check("table_lerp", dev, [("table", table), ("scaled", scaled)])
    if table.ndim != 1:
        raise ValueError("table_lerp: table must be one-dimensional")
    out = torch.empty_like(scaled)
    fn = _build.function(LERP_SOURCE, "table_lerp_launch", _LERP_ARGS)
    rc = fn(table.data_ptr(), table.shape[0], scaled.data_ptr(),
            out.data_ptr(), scaled.numel(), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "table_lerp")
    _build.count_launch(table_lerp)
    return out


table_lerp.launches = 0


def tapered_invert_plain(dist, u, x_lo, x_hi, sfact: int):
    """Plain version of :func:`tapered_invert`: the port of the jnp
    ``tapered_interval_invert`` body (gathers from the moment tables and
    a fixed-depth lower-bound bisection).

    Each division is a true division by a tensor: PyTorch divides a CUDA
    tensor by a Python float as a product with its rounded reciprocal,
    and ``float / tensor`` is ``reciprocal() * float``; either can be an
    ulp off the kernel's (and JAX's) division, and one ulp in
    ``(x - xmin) / dx`` can move the interval by a grid cell."""
    s = int(sfact)
    size, xmin, center, dx = dist.size, dist.xmin, dist.center, dist.dx_t
    t0, t1c, t2c, xax = dist.t0, dist.t1c, dist.t2c, dist.xax
    dtype = t0.dtype
    lo = torch.minimum(x_lo, x_hi)
    hi = torch.maximum(x_lo, x_hi)
    tiny = 1e-30
    i_lo = torch.clamp(((lo - xmin) / dx).to(torch.int64), 0, size - 1)
    i_hi = ((hi - xmin) / dx).to(torch.int64)
    i_hi = torch.where(i_hi == i_lo, i_lo + 1, i_hi)
    i_hi = torch.clamp(i_hi, 1, size)
    degenerate = (i_hi - i_lo) == 1
    ch = i_hi.to(dtype) - center
    t0_lo = t0[i_lo]
    t1_lo = t1c[i_lo] if s >= 1 else None
    t2_lo = t2c[i_lo] if s >= 2 else None

    def g_raw(j):
        jj = torch.minimum(torch.maximum(j, i_lo), i_hi - 1)
        d0 = t0[jj] - t0_lo
        if s == 0:
            return d0
        d1 = t1c[jj] - t1_lo
        if s == 1:
            return ch * d0 - d1
        d2 = t2c[jj] - t2_lo
        return ch * ch * d0 - 2.0 * ch * d1 + d2

    total = torch.clamp(g_raw(i_hi - 1), min=tiny)

    def g_norm(j):
        g = g_raw(j) / total
        g = torch.where(j < i_lo, 0.0, g)
        g = torch.where(j >= i_hi, 1.0, g)
        return torch.where(degenerate & (j >= i_lo), 1.0, g)

    u = torch.clamp(u, min=tiny).to(dtype)
    lo_j = torch.zeros_like(i_lo)
    hi_j = torch.full_like(i_lo, size - 1)
    for _ in range(int(math.ceil(math.log2(size)))):
        mid = (lo_j + hi_j) // 2
        below = g_norm(mid) < u
        lo_j = torch.where(below, mid + 1, lo_j)
        hi_j = torch.where(below, hi_j, mid)
    ih = torch.clamp(lo_j, 1, size - 1)
    y_lo = g_norm(ih - 1)
    y_hi = g_norm(ih)
    denom = torch.clamp(y_hi - y_lo, min=tiny)
    return xax[ih - 1] + (u - y_lo) * (dx / denom)


def tapered_invert(dist, u, x_lo, x_hi, sfact: int):
    """Invert the power-law-tapered interval CDF of ``dist`` (a
    ``priors.distributions.Distribution``) over ``[x_lo, x_hi]`` at
    ``u`` (``u``/``x_lo``/``x_hi`` of one shape; ``sfact`` in 0, 1, 2).
    The kernel reads the distribution's packed ``cells`` table."""
    s = int(sfact)
    if not 0 <= s <= 2:
        raise ValueError("tapered_invert supports sfact in (0, 1, 2)")
    if u.device.type == "cpu":
        return tapered_invert_plain(dist, u, x_lo, x_hi, s)
    dev = u.device
    cells = dist.cells
    _check("tapered_invert", dev, [("cells", cells), ("u", u),
                                   ("x_lo", x_lo), ("x_hi", x_hi)])
    if x_lo.shape != u.shape or x_hi.shape != u.shape \
            or cells.shape != (dist.size, 4):
        raise ValueError("tapered_invert: u/x_lo/x_hi must share a shape "
                         f"and the cells table be [{dist.size}, 4]")
    out = torch.empty_like(u)
    fn = _build.function(TAPER_SOURCE, "tapered_invert_launch",
                         _TAPER_ARGS)
    # the launcher refuses a table that is not 16-byte aligned
    rc = fn(cells.data_ptr(), u.data_ptr(), x_lo.data_ptr(),
            x_hi.data_ptr(), out.data_ptr(),
            u.numel(), dist.size, s, dist.xmin, dist.dx, dist.center,
            dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "tapered_invert")
    _build.count_launch(tapered_invert)
    return out


tapered_invert.launches = 0
