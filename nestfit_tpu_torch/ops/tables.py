"""Prior table lookups: kernels K2 (``csrc/table_lerp.cu``) and K3
(``csrc/tapered_invert.cu``), and the whole prior transform in one launch
(``csrc/prior_transform.cu``).

K2 and K3 are ports of ``nestfit_tpu/ops/tables.py::table_lerp`` and
``::tapered_invert``.  :func:`prior_transform_fused` runs a packed prior
transformer (:func:`pack_program`: the priors' op codes, rows, tables and
constants) over a batch of unit-cube rows in one launch, with K2's and
K3's arithmetic (``csrc/prior_tables.cuh``, one copy for the three
kernels).  Each wrapper launches its Hopper kernel for CUDA tensors and
runs the plain PyTorch version beside it for CPU tensors.
"""

import ctypes
import dataclasses
import math

import torch

from nestfit_tpu_torch.device import same_device
from nestfit_tpu_torch.ops import _build

LERP_SOURCE = "table_lerp.cu"
TAPER_SOURCE = "tapered_invert.cu"
PRIOR_SOURCE = "prior_transform.cu"
MAX_OPS = 16       # kMaxOps in prior_transform.cu
MAX_VALS = 48      # kMaxVals: parameters a row, n_param * ncomp
MAX_PLACED = 3     # kMaxPlaced: components a placement takes (sfact <= 2)
MAX_CELLS = 1536   # K3's shared-memory table (its launcher's limit)
# the op codes of prior_transform.cu
PPF, DUPLICATE, CONSTANT, PLACEMENT = range(4)


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
    a fixed-depth lower-bound bisection), differencing the tail tables
    ``r0``/``r1c``/``r2c`` where the interval starts past the median
    (``-r0[i_lo] < t0[i_lo]``), the cumulative ones elsewhere.

    Each division is a true division by a tensor: PyTorch divides a CUDA
    tensor by a Python float as a product with its rounded reciprocal,
    and ``float / tensor`` is ``reciprocal() * float``; either can be an
    ulp off the kernel's (and JAX's) division, and one ulp in
    ``(x - xmin) / dx`` can move the interval by a grid cell."""
    s = int(sfact)
    size, xmin, center, dx = dist.size, dist.xmin, dist.center, dist.dx_t
    xax = dist.xax
    dtype = xax.dtype
    lo = torch.minimum(x_lo, x_hi)
    hi = torch.maximum(x_lo, x_hi)
    tiny = 1e-30
    i_lo = torch.clamp(((lo - xmin) / dx).to(torch.int64), 0, size - 1)
    i_hi = ((hi - xmin) / dx).to(torch.int64)
    i_hi = torch.where(i_hi == i_lo, i_lo + 1, i_hi)
    i_hi = torch.clamp(i_hi, 1, size)
    degenerate = (i_hi - i_lo) == 1
    ch = i_hi.to(dtype) - center
    tail = -dist.r0[i_lo] < dist.t0[i_lo]

    def table(k, j):
        """Moment table ``k`` (0, 1, 2) at cells ``j``, on the side each
        element differences."""
        return torch.where(tail, (dist.r0, dist.r1c, dist.r2c)[k][j],
                           (dist.t0, dist.t1c, dist.t2c)[k][j])

    t0_lo = table(0, i_lo)
    t1_lo = table(1, i_lo) if s >= 1 else None
    t2_lo = table(2, i_lo) if s >= 2 else None

    def g_raw(j):
        jj = torch.minimum(torch.maximum(j, i_lo), i_hi - 1)
        d0 = table(0, jj) - t0_lo
        if s == 0:
            return d0
        d1 = table(1, jj) - t1_lo
        if s == 1:
            return ch * d0 - d1
        d2 = table(2, jj) - t2_lo
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
    The kernel reads the distribution's packed ``cells`` table, both
    sides of it."""
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
            or cells.shape != (dist.size, 2, 4):
        raise ValueError("tapered_invert: u/x_lo/x_hi must share a shape "
                         f"and the cells table be [{dist.size}, 2, 4]")
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


@dataclasses.dataclass(frozen=True)
class PriorOp:
    """One prior of a packed transform: ``code`` (``PPF``, ``DUPLICATE``,
    ``CONSTANT``, ``PLACEMENT``), the parameter ``row`` it writes,
    ``row2`` (a duplicate's second row; the placement's width row), its
    ``dist`` (a ``priors.distributions.Distribution``; the placement's
    centroid distribution) and ``value`` (a constant's value; the
    placement's ``sep_scale``)."""

    code: int
    row: int
    row2: int = -1
    dist: object = None
    value: float = 0.0


class _PriorOp(ctypes.Structure):
    """``PriorOp`` of ``prior_transform.cu``."""
    _fields_ = [("table", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("code", "row", "row2", "n")] + [
        (n, ctypes.c_float) for n in ("value", "xmin", "xmax", "v_range",
                                      "dx", "center")]


class _PriorProgram(ctypes.Structure):
    """``PriorProgram`` of ``prior_transform.cu``."""
    _fields_ = [("cells", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("n_cells", "n_op", "n_param",
                                    "ncomp")] + [
        ("ops", _PriorOp * MAX_OPS)]


@dataclasses.dataclass(frozen=True)
class PriorProgram:
    """A prior transformer packed for :func:`prior_transform_fused` at one
    ``ncomp`` on one ``device``: its ``ops`` in order, and ``packed``, the
    kernel's by-value program (the tables' addresses, each constant as the
    float32 the plain operations round it to).  It holds the ops'
    distributions, so the tables it points at live as long as it does."""

    ops: tuple
    n_param: int
    ncomp: int
    device: torch.device
    packed: _PriorProgram


def pack_program(ops, n_param: int, ncomp: int, device):
    """Pack ``ops`` (a sequence of :class:`PriorOp`) for rows of
    ``n_param * ncomp`` values on ``device``, or ``None`` where the
    one-launch kernel does not take them: more than ``MAX_OPS`` ops or
    ``MAX_VALS`` values a row, a placement past ``MAX_PLACED``
    components, a second placement (the kernel stages one cells table),
    a placement table past ``MAX_CELLS`` (from ncomp 2, where K3 reads
    it), or a table that is not float32 on ``device``."""
    device = torch.device(device)
    ops = tuple(ops)
    placed = [op for op in ops if op.code == PLACEMENT]
    if not 1 <= len(ops) <= MAX_OPS or n_param * ncomp > MAX_VALS \
            or len(placed) > 1 \
            or (placed and (ncomp > MAX_PLACED or ncomp > 1 and not
                            2 <= placed[0].dist.size <= MAX_CELLS)):
        return None
    for op in ops:
        if op.dist is None:
            continue
        for t in (op.dist.ppf, op.dist.cells):
            if t.dtype != torch.float32 or not t.is_contiguous() \
                    or not same_device(t.device, device):
                return None
    prog = _PriorProgram(n_op=len(ops), n_param=n_param, ncomp=ncomp)
    for k, op in enumerate(ops):
        c = prog.ops[k]
        c.code, c.row, c.row2, c.value = op.code, op.row, op.row2, op.value
        if op.dist is not None:
            d = op.dist
            c.table, c.n = d.ppf.data_ptr(), d.size
            c.xmin, c.xmax, c.dx, c.center = d.xmin, d.xmax, d.dx, d.center
            c.v_range = d.xmax - d.xmin
        if op.code == PLACEMENT and ncomp > 1:
            prog.cells, prog.n_cells = op.dist.cells.data_ptr(), op.dist.size
    return PriorProgram(ops, n_param, ncomp, device, prog)


def _placement_plain(op: PriorOp, c: _PriorOp, th, C: int):
    """The kernel's placement step on ``th`` ``[B, n_param, C]``, in
    PyTorch: the plain operations of ``ResolvedPlacementPrior.apply``
    with the packed float32 constants ``c``."""
    u = th[:, op.row, :].clone()
    if C == 1:
        th[:, op.row, 0] = table_lerp_plain(
            op.dist.ppf, (u[:, 0] * (c.n - 1)).contiguous())
        return
    sig = th[:, op.row2, :]
    seps = [torch.zeros_like(u[:, 0])]
    seps += [torch.sqrt(sig[:, i] * sig[:, i - 1]) * c.value
             for i in range(1, C)]
    sep_tot = seps[1]
    for s in seps[2:]:
        sep_tot = sep_tot + s
    # shrink to fit: v_range / sep_tot, as PyTorch divides a float by a
    # tensor
    factor = torch.where(sep_tot > c.v_range,
                         torch.reciprocal(sep_tot) * c.v_range, 1.0)
    sep_tot = sep_tot * factor
    v_lo = torch.full_like(sep_tot, c.xmin)
    v_hi = c.xmax - sep_tot
    for i in range(C):
        sep = seps[i] * factor
        v_lo = v_lo + sep
        v_hi = v_hi + sep
        v = tapered_invert_plain(op.dist, u[:, i].contiguous(), v_lo, v_hi,
                                 C - 1 - i)
        th[:, op.row, i] = v
        v_lo = v


def prior_transform_plain(program: PriorProgram, u):
    """Plain version of :func:`prior_transform_fused`: the packed ops in
    order over ``th`` ``[B, n_param, ncomp]``, through K2's and K3's plain
    versions, with the packed float32 constants."""
    C = program.ncomp
    th = u.reshape(u.shape[0], program.n_param, C).clone()
    for op, c in zip(program.ops, program.packed.ops):
        if op.code == CONSTANT:
            th[:, op.row, :] = c.value
        elif op.code == PLACEMENT:
            _placement_plain(op, c, th, C)
        else:
            v = table_lerp_plain(op.dist.ppf,
                                 (th[:, op.row, :] * (c.n - 1)).contiguous())
            th[:, op.row, :] = v
            if op.code == DUPLICATE:
                th[:, op.row2, :] = v
    return th.reshape(u.shape)


_PRIOR_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def prior_transform_fused(program: PriorProgram, u):
    """The prior transform of the unit-cube rows ``u``
    ``[B, n_param * ncomp]`` (parameter-major), every prior of
    ``program`` in order.  CUDA tensors: one launch (float32, contiguous,
    on the program's device); CPU tensors take the plain version."""
    B, D = u.shape
    if D != program.n_param * program.ncomp:
        raise ValueError(f"prior_transform_fused: rows of {D} values, the "
                         f"program takes {program.n_param * program.ncomp}")
    if u.device.type == "cpu":
        _build.count_call(prior_transform_fused)
        return prior_transform_plain(program, u)
    dev = u.device
    if not same_device(dev, program.device):
        raise ValueError(f"prior_transform_fused: rows on {dev}, the "
                         f"program's tables on {program.device}")
    _check("prior_transform_fused", dev, [("u", u)])
    out = torch.empty_like(u)
    fn = _build.function(PRIOR_SOURCE, "prior_transform_launch",
                         _PRIOR_ARGS)
    rc = fn(ctypes.addressof(program.packed), u.data_ptr(), out.data_ptr(),
            B, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "prior_transform_fused")
    _build.count_launch(prior_transform_fused)
    return out


prior_transform_fused.launches = 0
prior_transform_fused.counter = "prior.fused"
