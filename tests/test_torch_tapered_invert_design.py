"""The arithmetic of K3's Hopper kernel (``csrc/tapered_invert.cu``),
written out in numpy float32 on the CPU, against the port's plain
version and the JAX package's tapered inversion on the same inputs.

Numpy rounds every float32 operation on its own and never fuses a
multiply into an add, as the kernel's ``__f*_rn`` intrinsics do, so the
emulation below is the kernel's operation sequence, including its
bisection probe, which compares in float64 where the plain version
divides.  The file shows that it equals ``tapered_invert_plain`` bit
for bit (the card's bar), that the probe goes where the dividing one
goes, that it stays within half a grid cell of JAX, and that the bar
can tell a contracted or reciprocal-based variant apart: the cumulative
moment tables cancel for narrow intervals far from the grid centre
(the JAX package's within the right tail too, where the kernel takes
the tail tables and is held to a float64 inversion instead), so an ulp
in G or in ``(x - xmin) / dx`` moves the result by up to a table step.
JAX runs its Pallas kernel in interpret mode, as its own tests run it.
"""

import math
import types

import numpy as np
import pytest
import torch
from scipy import stats

import jax.numpy as jnp

from nestfit_tpu.ops import tables as jax_tables
from nestfit_tpu.priors import distributions as jax_dists

from nestfit_tpu_torch.ops import tables
from nestfit_tpu_torch.priors import make_distribution

from _k3_inputs import SEED1, f32_bits, k3_inputs

F32 = np.float32
TINY = F32(1e-30)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_tables, "INTERPRET", True)
    monkeypatch.setattr(jax_dists, "USE_PALLAS_TABLES", False)
    torch.set_num_threads(2)


def k3_emulated(dist, u, x_lo, x_hi, sfact, contract=False,
                reciprocal=False, probe="compare"):
    """The kernel's float32 operations, element-wise.  Returns the
    result ``out``, the interval's grid cells ``i_lo``/``i_hi``, the
    upper index ``cell`` of the cell the result lies in, and ``norm``,
    the normalised G at any cell.  ``contract`` fuses ``a * b - c`` and
    the final ``x + a * b`` into one rounding (what nvcc does unless told
    not to); ``reciprocal`` divides by ``dx`` and by ``denom`` through their
    rounded reciprocals (what PyTorch does for a Python float).  With
    ``probe="compare"`` (the kernel) each bisection probe decides
    ``fl(G / total) < u`` as ``G < total * m`` in float64, ``m`` the
    rounding boundary below ``u``; ``probe="divide"`` divides, as the
    plain version."""
    cells = dist.cells.numpy()
    N = cells.shape[0]
    xmin, dx, center = F32(dist.xmin), F32(dist.dx), F32(dist.center)

    def div(a, b):
        return a * (F32(1) / b) if reciprocal else a / b

    def mul_sub(a, b, c):                       # a * b - c
        if contract:
            return (a.astype(np.float64) * b - c).astype(F32)
        return a * b - c

    a, b = np.minimum(x_lo, x_hi), np.maximum(x_lo, x_hi)
    i_lo = np.clip(div(a - xmin, dx).astype(np.int64), 0, N - 1)
    i_hi = div(b - xmin, dx).astype(np.int64)
    i_hi = np.where(i_hi == i_lo, i_lo + 1, i_hi)
    i_hi = np.clip(i_hi, 1, N)
    degen = (i_hi - i_lo) == 1
    ch = i_hi.astype(F32) - center
    # the tail tables where the interval starts past the median
    side = (-cells[i_lo, 1, 0] < cells[i_lo, 0, 0]).astype(np.int64)
    c_lo = cells[i_lo, side]

    def raw(j):
        c = cells[np.clip(j, i_lo, i_hi - 1), side]
        d0 = c[:, 0] - c_lo[:, 0]
        if sfact == 0:
            return d0
        d1 = c[:, 1] - c_lo[:, 1]
        if sfact == 1:
            return mul_sub(ch, d0, d1)
        return mul_sub(ch * ch, d0, F32(2) * ch * d1) + (c[:, 2] - c_lo[:, 2])

    total = np.maximum(raw(i_hi - 1), TINY)

    def norm(j):
        g = raw(j) / total
        g = np.where(j < i_lo, F32(0), g)
        g = np.where(j >= i_hi, F32(1), g)
        return np.where(degen & (j >= i_lo), F32(1), g)

    uu = np.maximum(u, TINY)
    pu = np.nextafter(uu, F32(0))
    lim = total.astype(np.float64) * (0.5 * (pu.astype(np.float64) + uu))

    def is_below(j):
        if probe == "divide":
            return norm(j) < uu
        b = np.where(j < i_lo, F32(0) < uu, raw(j).astype(np.float64) < lim)
        return np.where((j >= i_hi) | (degen & (j >= i_lo)), F32(1) < uu, b)

    lo_j = np.zeros(u.shape, np.int64)
    hi_j = np.full(u.shape, N - 1)
    for _ in range(math.ceil(math.log2(N))):
        mid = (lo_j + hi_j) // 2
        below = is_below(mid)
        lo_j = np.where(below, mid + 1, lo_j)
        hi_j = np.where(below, hi_j, mid)
    ih = np.clip(lo_j, 1, N - 1)
    y_lo = norm(ih - 1)
    q = div(dx, np.maximum(norm(ih) - y_lo, TINY))
    x_left = cells[ih - 1, 0, 3]
    with np.errstate(over="ignore"):   # inf where the plain gives inf
        if contract:
            out = (x_left + (uu - y_lo).astype(np.float64) * q).astype(F32)
        else:
            out = x_left + (uu - y_lo) * q
    assert out.dtype == F32
    return types.SimpleNamespace(out=out, i_lo=i_lo, i_hi=i_hi, cell=ih,
                                 norm=norm, tail=side == 1)


def _grid(kind):
    """The voff grid of ``get_irdc_priors`` (beta(5, 5)) or of
    ``get_diazenylium_priors`` (flat), 500 points over [-4, 4]."""
    u = np.linspace(0, 1, 500)
    pdf = stats.beta(5.0, 5.0).pdf(u) if kind == "beta" \
        else np.ones_like(u) / 500
    return 8.0 * u - 4.0, pdf


def _inputs(dist, seed):
    return k3_inputs(dist.size, dist.xmin, dist.xmax, dist.dx, seed)


def _dist(kind):
    return make_distribution(*_grid(kind), device="cpu")


@pytest.mark.parametrize("kind", ["beta", "flat"])
@pytest.mark.parametrize("sfact", [0, 1, 2])
def test_k3_arithmetic_is_the_plain_version_bit_for_bit(kind, sfact):
    dist = _dist(kind)
    u, x_lo, x_hi = _inputs(dist, seed=sfact)
    got = k3_emulated(dist, u, x_lo, x_hi, sfact).out
    want = tables.tapered_invert_plain(
        dist, *(torch.as_tensor(a) for a in (u, x_lo, x_hi)), sfact).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _monotone(res, N):
    """Whether the normalised G of each element never falls from one
    cell to the next."""
    g = np.stack([res.norm(np.full(res.cell.shape, j)) for j in range(N)])
    return np.all(np.diff(g, axis=0) >= 0, axis=0)


def _float64_invert(pdf, res, u, sfact, xax, dx):
    """The tapered inversion in float64 on the grid cells ``res.i_lo``,
    ``res.i_hi`` of a float32 run: G(j) summed cell by cell, then the
    same lower bound and linear step."""
    trap = 0.5 * (pdf + np.roll(pdf, 1))
    trap[0] = 0.0
    N = pdf.size
    j = np.arange(N)[None, :]
    lo, hi = res.i_lo[:, None], res.i_hi[:, None]
    inside = (j > lo) & (j < hi)
    w = np.where(inside, trap * np.clip(hi - j, 0, None) ** sfact, 0.0)
    g = np.cumsum(w, axis=1)
    g = g / np.maximum(g[:, -1:], 1e-300)
    g = np.where(j >= hi, 1.0, np.where(j < lo, 0.0, g))
    g = np.where((hi - lo == 1) & (j >= lo), 1.0, g)
    uu = np.maximum(u.astype(np.float64), 1e-30)
    ih = np.clip(np.sum(g < uu[:, None], axis=1), 1, N - 1)
    y_lo = g[np.arange(u.size), ih - 1]
    y_hi = g[np.arange(u.size), ih]
    return xax[ih - 1] + (uu - y_lo) * dx / np.maximum(y_hi - y_lo, 1e-30)


@pytest.mark.parametrize("sfact", [0, 1, 2])
def test_k3_arithmetic_within_half_a_cell_of_jax(sfact):
    """Against JAX's eager jnp path (the same bisection) on every
    element whose interval starts before the median, where the kernel
    differences the cumulative tables as JAX does; past the median it
    differences the tail tables, and JAX's cumulative ones cancel in the
    right tail, so there the kernel is held to the float64 inversion on
    the same cells instead (save at ``u`` within 2^-20 of 1, which a
    float32 G does not resolve).  Against JAX's jitted Pallas kernel
    wherever the float32 G is monotone: there the kernel's dense count
    finds the bisection's cell.  XLA rewrites a division by
    a constant as a product with its reciprocal, so on elements whose
    cells the two divisions set apart the Pallas kernel is held against
    the reciprocal variant.  Where G is not monotone, JAX's own two
    paths part too."""
    x, pdf = _grid("beta")
    dist = make_distribution(x, pdf, device="cpu")
    jd = jax_dists.make_distribution(x, pdf, dtype=jnp.float32)
    u, x_lo, x_hi = _inputs(dist, seed=10 + sfact)
    got = k3_emulated(dist, u, x_lo, x_hi, sfact)
    recip = k3_emulated(dist, u, x_lo, x_hi, sfact, reciprocal=True)
    ju, jlo, jhi = map(jnp.asarray, (u, x_lo, x_hi))
    jnp_path = np.asarray(jax_dists.tapered_interval_invert(
        jd, ju, jlo, jhi, sfact))
    pallas = np.asarray(jax_tables.tapered_invert(
        jd.t0, jd.t1c, jd.t2c, jd.xax, ju, jlo, jhi, sfact, jd.size,
        jd.xmin, jd.dx, jd.center))
    bar = 0.51 * dist.dx
    exact = _float64_invert(pdf, got, u, sfact, x, dist.dx)
    ok = ~got.tail
    held = got.tail & (u < 1 - 2.0 ** -20)
    assert 0.2 < got.tail.mean() < 0.5
    np.testing.assert_allclose(got.out[held], exact[held], atol=bar, rtol=0)
    assert not (np.abs(jnp_path - exact) <= bar)[held].all()
    np.testing.assert_allclose(got.out[ok], jnp_path[ok], atol=bar, rtol=0)
    same = (got.i_lo == recip.i_lo) & (got.i_hi == recip.i_hi)
    near = np.abs(np.where(same, got.out, recip.out) - pallas) <= bar
    monotone = _monotone(got, dist.size) & _monotone(recip, dist.size)
    assert near[monotone & ok].all()
    assert near[ok].mean() > 0.97
    jax_paths_part = ~(np.abs(jnp_path - pallas) <= bar)
    assert (near | jax_paths_part)[ok].all()


@pytest.mark.parametrize("kind", ["beta", "flat"])
@pytest.mark.parametrize("sfact", [0, 1, 2])
def test_the_division_free_probe_picks_the_dividing_probes_cell(kind,
                                                                 sfact):
    """The kernel's probe compares ``G`` with ``total * m`` in float64
    instead of dividing: on the inputs, and with ``u`` set on each
    element's own ``fl(G / total)`` at probed cells and one ulp either
    side of it -- where the two could part if the comparison were not
    exact -- every probe goes the same way."""
    dist = _dist(kind)
    u, x_lo, x_hi = _inputs(dist, seed=20 + sfact)
    res = k3_emulated(dist, u, x_lo, x_hi, sfact, probe="divide")
    on = np.concatenate([res.norm(res.cell), res.norm(res.cell - 1),
                         res.norm((res.i_lo + res.i_hi) // 2)])
    cases = [np.tile(a, 9) for a in (x_lo, x_hi)]
    cases.insert(0, np.concatenate([
        on, np.nextafter(on, F32(0)), np.nextafter(on, F32(2))]))
    for args in ((u, x_lo, x_hi), cases):
        divide = k3_emulated(dist, *args, sfact, probe="divide")
        compare = k3_emulated(dist, *args, sfact)
        np.testing.assert_array_equal(compare.cell, divide.cell)
        np.testing.assert_array_equal(compare.out.view(np.uint32),
                                      divide.out.view(np.uint32))


def test_the_bar_tells_contracted_and_reciprocal_arithmetic_apart():
    """On these inputs each variant ends in another cell on some
    element, so bit-for-bit agreement with the plain version tests the
    operation sequence, not luck."""
    dist = _dist("beta")
    moved = {}
    for sfact in (0, 1, 2):
        u, x_lo, x_hi = _inputs(dist, seed=sfact)
        cell = k3_emulated(dist, u, x_lo, x_hi, sfact).cell
        for variant in ("contract", "reciprocal"):
            other = k3_emulated(dist, u, x_lo, x_hi, sfact,
                                **{variant: True}).cell
            moved[variant, sfact] = int((other != cell).sum())
    assert moved["contract", 1] + moved["contract", 2] > 0, moved
    assert all(moved["reciprocal", s] > 0 for s in (0, 1, 2)), moved


def test_the_seed_one_element_from_the_card():
    dist = _dist("flat")
    args = [f32_bits(SEED1[k]) for k in ("u", "x_lo", "x_hi")]
    got = k3_emulated(dist, *args, SEED1["sfact"])
    plain = tables.tapered_invert_plain(
        dist, *(torch.as_tensor(a) for a in args), SEED1["sfact"]).numpy()
    recip = k3_emulated(dist, *args, SEED1["sfact"], reciprocal=True)
    assert (got.i_lo[0], recip.i_lo[0]) == (281, 282)
    assert got.out.view(np.uint32)[0] == SEED1["kernel"]
    assert plain.view(np.uint32)[0] == SEED1["kernel"]
    assert recip.out.view(np.uint32)[0] == SEED1["reciprocal"]
    assert abs(float(recip.out[0] - got.out[0])) > 0.51 * dist.dx
