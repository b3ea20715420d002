"""The arithmetic and the work split of K4's Hopper kernel
(``csrc/gauss_chi2.cu``), emulated in float32 on the CPU, against the
JAX package's ``gauss_chi2_fused`` and the port's ``gauss_chi2_plain``
on the same inputs.

The kernel runs only on the card; this file shows that its form keeps
the card's bar (rtol 2e-4, atol 1e-3 on chi2): each warp takes one pixel
and a group of ``P`` of its proposals (rows ``t * R + r``, the last group
short when ``P`` does not divide ``T``), each component is folded into a
centre and a scale ``-log2(e) / (2 hw^2)`` so that one ``ex2`` (flushing
results below 2^-126 to zero) serves each exponential, the sums are
FMAs, and each lane's squared residual is reduced across the warp by
shuffles.  JAX runs its Pallas kernel in interpret mode, as its own
tests run it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nestfit_tpu.ops import fused as jax_fused

from nestfit_tpu_torch.constants import CKMS
from nestfit_tpu_torch.models.tables import AMMONIA_TRANSITIONS
from nestfit_tpu_torch.ops import fused
from nestfit_tpu_torch.utils import freq_axis_from_velocity

F32 = np.float32
NEG_HALF_LOG2E = F32(-0.5 * np.log2(np.e))   # kNegHalfLog2e
FTZ_EXPONENT = F32(-126.0)                   # ex2.approx.ftz


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_fused, "INTERPRET", True)
    torch.set_num_threads(2)


def _fma(a, b, c):
    """float32 fused multiply-add: the exact product and sum, one
    rounding."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def k4_rows(T, R, P):
    """The rows each warp takes, as the kernel maps them: warp ``w``
    holds pixel ``w % R`` and the proposals from ``(w // R) * P`` on,
    at most ``P`` of them.  Returns ``[warps, P]`` row indices, -1 where
    the last group of a pixel is short."""
    groups = -(-T // P)
    w = np.arange(groups * R)
    t = (w // R)[:, None] * P + np.arange(P)
    return np.where(t < T, t * R + (w % R)[:, None], -1)


def k4_emulated(fc, dnu, data, voff, sigm, peak, P):
    """Float32 emulation of the kernel, warp by warp."""
    B, C = voff.shape
    R, S = data.shape
    fc = F32(fc)
    rows = k4_rows(B // R, R, P)
    got = rows[rows >= 0]
    assert np.array_equal(np.sort(got), np.arange(B))   # each row once
    out = np.full(B, np.nan, F32)
    lanes = -(-S // 32) * 32
    x = np.zeros(lanes, F32)
    x[:S] = dnu
    for p in range(P):
        b = rows[:, p]
        b = b[b >= 0]
        pred = np.zeros((b.size, lanes), F32)
        for c in range(C):
            hw = sigm[b, c] * fc
            cen = -voff[b, c] * fc
            scale = NEG_HALF_LOG2E / (hw * hw)
            d = x - cen[:, None]
            a = d * d * scale[:, None]
            e = np.where(a < FTZ_EXPONENT, F32(0), np.exp2(a))
            pred = _fma(peak[b, c][:, None], e, pred)
        dat = np.zeros((b.size, lanes), F32)
        dat[:, :S] = data[b % R]
        dev = dat - pred
        dev[:, S:] = 0.0                    # channels past S: no residual
        # lane l sums channels l, l + 32, ... in order, then the shuffles
        lane_sum = np.zeros((b.size, 32), F32)
        for j in range(lanes // 32):
            blk = dev[:, 32 * j:32 * (j + 1)]
            lane_sum = _fma(blk, blk, lane_sum)
        for off in (16, 8, 4, 2, 1):
            lane_sum[:, :off] = lane_sum[:, :off] + lane_sum[:, off:2 * off]
        out[b] = lane_sum[:, 0]
    return out


def _case(C, T, R, seed, narrow):
    """Seeded inputs on the NH3 (1,1) axis of the Gaussian ladder (380
    channels of 0.158 km/s): components across ``get_gaussian_priors``'
    ranges; with ``narrow`` half the rows take widths of 0.01-0.06 km/s,
    below a channel."""
    rng = np.random.default_rng(seed)
    rest = AMMONIA_TRANSITIONS[0].nu
    dnu = (freq_axis_from_velocity(np.arange(-30, 30, 0.158), rest)
           - rest).astype(F32)
    S = dnu.shape[0]
    data = rng.normal(scale=0.15, size=(R, S)).astype(F32)
    B = T * R
    voff = rng.uniform(-4, 4, (B, C)).astype(F32)
    sigm = rng.uniform(0.05, 2.0, (B, C)).astype(F32)
    if narrow:
        sigm[::2] = rng.uniform(0.01, 0.06, (sigm[::2].shape)).astype(F32)
    peak = rng.uniform(0.01, 10, (B, C)).astype(F32)
    return rest / CKMS, dnu, data, voff, sigm, peak


@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("C", [1, 2, 3])
def test_k4_arithmetic_matches_jax_kernel_and_plain(C, narrow, P):
    fc, dnu, data, voff, sigm, peak = _case(C, T=5, R=4, seed=10 * C + P,
                                            narrow=narrow)
    got = k4_emulated(fc, dnu, data, voff, sigm, peak, P)
    want = np.asarray(jax_fused.gauss_chi2_fused(
        fc, *(jnp.asarray(a) for a in (dnu, data, voff, sigm, peak))))
    plain = fused.gauss_chi2_plain(
        fc, *(torch.as_tensor(a) for a in (dnu, data, voff, sigm, peak)))
    assert got.dtype == F32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(got, plain.numpy(), rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("T, R, P", [(1, 7, 8), (3, 5, 2), (100, 3, 8),
                                     (17, 2, 4)])
def test_k4_groups_cover_every_row_once(T, R, P):
    """Short last groups (``P`` not dividing ``T``) and ``T = 1``."""
    rows = k4_rows(T, R, P)
    assert np.array_equal(np.sort(rows[rows >= 0]), np.arange(T * R))
    # a warp's rows share one pixel
    assert all(len(set(r[r >= 0] % R)) == 1 for r in rows)
