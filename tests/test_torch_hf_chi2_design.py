"""The arithmetic of K1's Hopper kernel (``csrc/hf_chi2.cu``), emulated
in float32 on the CPU, against the JAX package's ``hf_chi2_fused`` and
the port's ``hf_chi2_plain`` on the same inputs.

The kernel runs only on the card; this file shows that its
reformulation keeps the card's bar (rtol 2e-4, atol 1e-3 on chi2):
the line loop outermost, the line terms folded on the host
(``fused.line_table``), log2(e) folded into each line's scale so that
one ``ex2`` (flushing results below 2^-126 to zero) serves each
exponential, the subtraction before the square, and ``expm1`` for the
per-channel terms.  JAX runs its Pallas kernel in interpret mode, as its
own tests run it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nestfit_tpu.models import tables as jax_tables
from nestfit_tpu.ops import fused as jax_fused
from nestfit_tpu.utils import freq_axis_from_velocity

from nestfit_tpu_torch.models import ammonia, diazenylium
from nestfit_tpu_torch.models.tables import (
    AMMONIA_TRANSITIONS,
    DIAZENYLIUM_TRANSITIONS,
)
from nestfit_tpu_torch.ops import fused

NEG_HALF_LOG2E = np.float32(-0.5 * np.log2(np.e))   # kNegHalfLog2e
FTZ_EXPONENT = -126.0                               # ex2.approx.ftz


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_fused, "INTERPRET", True)
    torch.set_num_threads(2)


def k1_emulated(trans, dnu, t0, tbg, data, voff, tex, tau0, sigm):
    """Float32 emulation of the kernel's arithmetic, row for row."""
    nhf = trans.nhf
    f, rb, w = fused.line_table(trans, "cpu").reshape(3, nhf)
    B, C = voff.shape
    R, S = data.shape
    pred = torch.zeros((B, S))
    for c in range(C):
        # the row's table: centre, -log2(e) / (2 hw^2), amplitude
        hw = sigm[:, c, None] * f
        cen = -rb - voff[:, c, None] * f
        scale = NEG_HALF_LOG2E / (hw * hw)
        amp = tau0[:, c, None] * w
        tau = torch.zeros((B, S))
        for j in range(nhf):
            d = dnu - cen[:, j, None]
            a = d * d * scale[:, j, None]
            prof = torch.where(a < FTZ_EXPONENT, 0.0,
                               torch.exp2(a.clamp(min=FTZ_EXPONENT)))
            tau = tau + amp[:, j, None] * prof
        # the kernel's 1/expm1 is a fast divide, within 2 ulp of this one
        rtex = 1.0 / tex[:, c, None]
        iem = 1.0 / torch.expm1(t0 * rtex)
        pred = pred + t0 * (iem - tbg) * (-torch.expm1(-tau))
    resid = data.repeat(B // R, 1) - pred
    return torch.sum(resid * resid, dim=-1)


def _components(B, C, rng, sigm_floor, voff_edge, tau_range):
    """``[B, C]`` float32 voff, tex, tau0, sigm: the first rows sit at the
    prior's centroid edges with the narrowest width, the rest are drawn
    across the priors."""
    voff = rng.uniform(-voff_edge, voff_edge, (B, C))
    sigm = sigm_floor + rng.uniform(0, 2, (B, C)) ** 2
    voff[0], voff[1] = -voff_edge, voff_edge
    sigm[:2] = sigm_floor
    tex = rng.uniform(2.8, 12.06, (B, C))
    tau0 = 10 ** rng.uniform(*tau_range, (B, C))
    return [torch.as_tensor(a, dtype=torch.float32)
            for a in (voff, tex, tau0, sigm)]


def _case(model, trans_id, ncomp, R=4, T=3):
    rng = np.random.default_rng(100 * trans_id + ncomp)
    if model == "nh3":
        jtrans = jax_tables.AMMONIA_TRANSITIONS[trans_id - 1]
        xarr = freq_axis_from_velocity(np.linspace(-30, 30, 380),
                                       AMMONIA_TRANSITIONS[trans_id - 1].nu)
        spec = ammonia.make_ammonia_spectrum(
            xarr, rng.normal(scale=0.2, size=(R, 380)), 0.2,
            trans_id=trans_id, device="cpu")
        # get_irdc_priors: sigm >= 0.067, voff within +-4 km/s
        comps = _components(T * R, ncomp, rng, 0.067, 4.0, (-3, 1.5))
    else:
        jtrans = jax_tables.DIAZENYLIUM_TRANSITIONS[trans_id - 1]
        xarr = freq_axis_from_velocity(
            np.arange(-20, 20, 0.1), DIAZENYLIUM_TRANSITIONS[trans_id - 1].nu)
        spec = diazenylium.make_diazenylium_spectrum(
            xarr, rng.normal(scale=0.1, size=(R, xarr.shape[0])), 0.1,
            trans_id=trans_id, device="cpu")
        # get_diazenylium_priors: sigm >= 0.05, voff within +-4, ltau +-2
        comps = _components(T * R, ncomp, rng, 0.05, 4.0, (-2, 2))
    trans = (AMMONIA_TRANSITIONS if model == "nh3"
             else DIAZENYLIUM_TRANSITIONS)[trans_id - 1]
    return jtrans, (trans, spec.dnu, spec.t0, spec.tbg, spec.data, *comps)


@pytest.mark.parametrize("ncomp", [1, 2])
@pytest.mark.parametrize("model, trans_id", [
    ("nh3", 1), ("nh3", 2), ("n2h+", 1), ("n2h+", 3)])
def test_k1_arithmetic_matches_jax_kernel_and_plain(model, trans_id, ncomp):
    jtrans, args = _case(model, trans_id, ncomp)
    assert jtrans.nhf == args[0].nhf
    got = k1_emulated(*args)
    plain = fused.hf_chi2_plain(*args)
    want = np.asarray(jax_fused.hf_chi2_fused(
        jtrans, *(jnp.asarray(a.numpy()) for a in args[1:])))
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-4,
                               atol=1e-3)
