"""Port parity of the sampler knobs at NH3 rung 1 (the part (d) of
``test_torch_knobs.py``): ``fit_batch`` of both packages on the same
pixels (``test_torch_fit.py``'s cube: 4 px at noise 0.4, two copies each),
segmented, nlive 50, at the probe's ``iid``, ``diff3`` and ``kill12`` and
the sweep's ``slice_bound_every`` 2: the better of two runs per pixel
within combined errors, as in ``test_torch_fit.py``.

The sweep's ``kill_k`` 50 is not run here: at rung 1 (ndim 6) it resolves
to the auto width ``nlive // 2`` for every nlive up to 100
(``test_torch_knobs.py`` (a) holds the resolution), so the probe's
``kill12`` stands in for a width the auto rule does not give.
"""

import numpy as np
import pytest
import torch

from jax import random

from nestfit_tpu.sampling import NSConfig as JaxConfig
from nestfit_tpu.sampling.fit import fit_batch as jax_fit_batch

from nestfit_tpu_torch.sampling import NSConfig, fit_batch

from test_torch_fit import N_PIX, R, _better_of_two, _jax_runner, \
    _port_runner, cube  # noqa: F401
from test_torch_knobs import JAX_VARIANTS


@pytest.mark.parametrize("knob", [
    {"init_stratified": False},
    JAX_VARIANTS["diff3"],
    JAX_VARIANTS["kill12"],
    {"slice_bound_every": 2},
], ids=["iid", "diff3", "kill12", "sbe2"])
def test_nh3_rung1_matches_jax_at_knob(cube, knob):  # noqa: F811
    torch.set_num_threads(2)
    kw = dict(nlive=50, tol=1.0, **knob)
    jfit = jax_fit_batch(random.key(1), _jax_runner(cube, 1), R,
                         JaxConfig(**kw), segment_iters=250)
    tfit = fit_batch(torch.Generator().manual_seed(1), _port_runner(cube, 1),
                     R, NSConfig(**kw), segment_iters=250, device="cpu")
    assert tfit.ns.converged.all() and np.asarray(jfit.ns.converged).all()
    lnz_p, err_p = _better_of_two(tfit.lnz.numpy(), tfit.lnz_err.numpy())
    lnz_j, err_j = _better_of_two(jfit.lnz, jfit.lnz_err)
    bar = 4 * np.sqrt(err_p**2 + err_j**2) + 0.5
    assert np.all(np.abs(lnz_p - lnz_j) <= bar), (lnz_p, lnz_j, bar)
    assert lnz_p.shape == (N_PIX,)
