"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Imports neither JAX nor ``nestfit_tpu``, so it also runs on a GPU
machine without them::

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_gpu.py

Without a card every test skips (decided inside the test).
"""

import dataclasses

import numpy as np
import pytest
import torch

from nestfit_tpu_torch.constants import CKMS
from nestfit_tpu_torch.models import ammonia, diazenylium
from nestfit_tpu_torch.models.tables import (
    AMMONIA_TRANSITIONS,
    DIAZENYLIUM_TRANSITIONS,
)
from nestfit_tpu_torch.ops import fused, tables
from nestfit_tpu_torch.priors import (
    get_diazenylium_priors,
    get_gaussian_priors,
    get_irdc_priors,
    make_distribution,
)
from nestfit_tpu_torch.utils import freq_axis_from_velocity


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("ncomp, trans_id, R, T, S", [
    (1, 1, 64, 5, 380), (1, 2, 64, 5, 380),
    (2, 1, 64, 5, 380), (2, 2, 64, 5, 380),
    (2, 1, 64, 50, 380),   # B = 3,200: the compacted slice round
    (2, 2, 7, 3, 380),     # B = 21: no multiple of the two rows per block
    (2, 1, 3, 5, 20),      # K = 4, lanes past S
    (2, 1, 3, 5, 256),     # K = 8
    (1, 2, 3, 5, 512),     # K = 16
    (2, 1, 5, 3, 600),     # five chunks of 128 channels (K = 4)
    (1, 1, 2, 3, 1100),    # three chunks of 384 channels (K = 12)
])
def test_hf_chi2_kernel_matches_plain(ncomp, trans_id, R, T, S):
    _card()
    rng = np.random.default_rng(3)
    xarr = freq_axis_from_velocity(np.linspace(-30, 30, S),
                                   AMMONIA_TRANSITIONS[trans_id - 1].nu)
    spec = ammonia.make_ammonia_spectrum(
        xarr, rng.normal(scale=0.2, size=(R, S)), 0.2, trans_id=trans_id)
    utrans = get_irdc_priors()
    u = torch.as_tensor(rng.uniform(size=(T * R, 6 * ncomp)),
                        dtype=torch.float32, device="cuda")
    theta = utrans.transform(u, ncomp, plain=True)
    trans, voff, tex, tau0, sigm = ammonia._component_params(
        spec, theta, False, False)
    args = (trans, spec.dnu, spec.t0, spec.tbg, spec.data,
            *(x.contiguous() for x in (voff, tex, tau0, sigm)))
    n0 = fused.hf_chi2_fused.launches
    got = fused.hf_chi2_fused(*args)
    torch.cuda.synchronize()
    assert fused.hf_chi2_fused.launches == n0 + 1
    assert got.shape == (T * R,)
    torch.testing.assert_close(got, fused.hf_chi2_plain(*args),
                               rtol=2e-4, atol=1e-3)


@pytest.mark.gpu
def test_hf_chi2_kernel_at_the_line_cap():
    """``MAX_LINES`` lines at ``MAX_COMP`` components: the per-row tables
    fill the 48 KB of dynamic shared memory."""
    _card()
    base = DIAZENYLIUM_TRANSITIONS[2]
    reps = -(-fused.MAX_LINES // base.nhf)
    voff = np.concatenate([base.voff + 0.37 * k for k in range(reps)])
    wts = np.tile(base.tau_wts, reps)[:fused.MAX_LINES]
    trans = dataclasses.replace(base, voff=voff[:fused.MAX_LINES],
                                tau_wts=wts / wts.sum())
    assert trans.nhf == fused.MAX_LINES
    R, T, C = 4, 5, fused.MAX_COMP
    rng = np.random.default_rng(8)
    xarr = freq_axis_from_velocity(np.arange(-20, 20, 0.1), trans.nu)
    spec = diazenylium.make_diazenylium_spectrum(
        xarr, rng.normal(scale=0.1, size=(R, xarr.shape[0])), 0.1,
        trans_id=3)
    comps = [torch.as_tensor(rng.uniform(lo, hi, (T * R, C)),
                             dtype=torch.float32, device="cuda")
             for lo, hi in ((-4, 4), (2.8, 12), (0.01, 2), (0.05, 1))]
    args = (trans, spec.dnu, spec.t0, spec.tbg, spec.data, *comps)
    got = fused.hf_chi2_fused(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fused.hf_chi2_plain(*args),
                               rtol=2e-4, atol=1e-3)


@pytest.mark.gpu
def test_table_kernels_match_plain():
    _card()
    x = np.linspace(-4, 4, 500)
    d = make_distribution(x, np.exp(-0.5 * (x / 1.7) ** 2) + 0.05)
    rng = np.random.default_rng(5)
    s = torch.as_tensor(rng.uniform(0, d.size - 1, 4096),
                        dtype=torch.float32, device="cuda")
    torch.testing.assert_close(tables.table_lerp(d.ppf, s),
                               tables.table_lerp_plain(d.ppf, s),
                               rtol=2e-6, atol=2e-6)
    ends = tables.table_lerp(d.ppf, torch.tensor([0.0, d.size - 1.0],
                                                 device="cuda"))
    assert torch.equal(ends, d.ppf[[0, -1]])
    lo = rng.uniform(-4, 3, size=4096)
    cols = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
            for a in (rng.uniform(size=4096), lo,
                      lo + rng.uniform(0.005, 6, size=4096))]
    for sf in (0, 1, 2):
        args = (d.t0, d.t1c, d.t2c, d.xax, *cols, sf, d.size, d.xmin, d.dx,
                d.center)
        err = (tables.tapered_invert(*args)
               - tables.tapered_invert_plain(*args)).abs().max().item()
        assert err < 0.51 * d.dx


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take():
    _card()
    x = np.linspace(-4, 4, 500)
    d = make_distribution(x, np.exp(-x**2))
    with pytest.raises(ValueError, match="float32"):
        tables.table_lerp(d.ppf, torch.zeros(8, dtype=torch.float64,
                                             device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        tables.table_lerp(d.ppf, torch.zeros(8, 2, device="cuda")[:, 0])


@pytest.mark.gpu
@pytest.mark.parametrize("trans_id", [2, 3])
def test_hf_chi2_kernel_on_n2hp_lines_matches_plain(trans_id):
    """N2H+ (2-1) and (3-2): 40 and 45 hyperfine lines."""
    _card()
    R, T, ncomp = 64, 5, 2
    rng = np.random.default_rng(4)
    xarr = freq_axis_from_velocity(np.arange(-20, 20, 0.1),
                                   DIAZENYLIUM_TRANSITIONS[trans_id - 1].nu)
    spec = diazenylium.make_diazenylium_spectrum(
        xarr, rng.normal(scale=0.1, size=(R, xarr.shape[0])), 0.1,
        trans_id=trans_id)
    u = torch.as_tensor(rng.uniform(size=(T * R, 4 * ncomp)),
                        dtype=torch.float32, device="cuda")
    theta = get_diazenylium_priors().transform(u, ncomp, plain=True)
    trans, voff, tex, tau0, sigm = diazenylium._component_params(spec, theta)
    assert trans.nhf > 32
    args = (trans, spec.dnu, spec.t0, spec.tbg, spec.data,
            *(x.contiguous() for x in (voff, tex, tau0, sigm)))
    got = fused.hf_chi2_fused(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fused.hf_chi2_plain(*args),
                               rtol=2e-4, atol=1e-3)


def _gauss_args(ncomp, R=64, T=5, seed=6):
    rng = np.random.default_rng(seed)
    rest = AMMONIA_TRANSITIONS[0].nu
    dnu = torch.as_tensor(
        freq_axis_from_velocity(np.arange(-30, 30, 0.158), rest) - rest,
        dtype=torch.float32, device="cuda")
    data = torch.as_tensor(rng.normal(scale=0.15, size=(R, dnu.shape[0])),
                           dtype=torch.float32, device="cuda")
    u = torch.as_tensor(rng.uniform(size=(T * R, 3 * ncomp)),
                        dtype=torch.float32, device="cuda")
    theta = get_gaussian_priors().transform(u, ncomp, plain=True)
    voff, sigm, peak = (theta[:, i * ncomp:(i + 1) * ncomp].contiguous()
                        for i in range(3))
    return rest / CKMS, dnu, data, voff, sigm, peak


@pytest.mark.gpu
@pytest.mark.parametrize("ncomp", [1, 2, 3])
def test_gauss_chi2_kernel_matches_plain(ncomp):
    _card()
    args = _gauss_args(ncomp)
    n0 = fused.gauss_chi2_fused.launches
    got = fused.gauss_chi2_fused(*args)
    torch.cuda.synchronize()
    assert fused.gauss_chi2_fused.launches == n0 + 1
    torch.testing.assert_close(got, fused.gauss_chi2_plain(*args),
                               rtol=2e-4, atol=1e-3)


@pytest.mark.gpu
def test_gauss_chi2_wrapper_rejects_what_the_kernel_does_not_take():
    _card()
    fc, dnu, data, voff, sigm, peak = _gauss_args(2)
    n0 = fused.gauss_chi2_fused.launches
    with pytest.raises(ValueError, match="float32"):
        fused.gauss_chi2_fused(fc, dnu, data, voff.double(), sigm, peak)
    wide = torch.stack([sigm, sigm], dim=-1)[..., 0]     # strided view
    assert not wide.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        fused.gauss_chi2_fused(fc, dnu, data, voff, wide, peak)
    assert fused.gauss_chi2_fused.launches == n0
