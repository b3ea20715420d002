"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Imports neither JAX nor ``nestfit_tpu``, so it also runs on a GPU
machine without them::

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_gpu.py

Without a card every test skips (decided inside the test).
"""

import numpy as np
import pytest
import torch

from nestfit_tpu_torch.models import ammonia
from nestfit_tpu_torch.models.tables import AMMONIA_TRANSITIONS
from nestfit_tpu_torch.ops import fused, tables
from nestfit_tpu_torch.priors import get_irdc_priors, make_distribution
from nestfit_tpu_torch.utils import freq_axis_from_velocity


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trans_id", [1, 2])
@pytest.mark.parametrize("ncomp", [1, 2])
def test_hf_chi2_kernel_matches_plain(ncomp, trans_id):
    _card()
    R, T = 64, 5
    rng = np.random.default_rng(3)
    xarr = freq_axis_from_velocity(np.linspace(-30, 30, 380),
                                   AMMONIA_TRANSITIONS[trans_id - 1].nu)
    spec = ammonia.make_ammonia_spectrum(
        xarr, rng.normal(scale=0.2, size=(R, 380)), 0.2, trans_id=trans_id)
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
