"""The frozen generator and reference against the port at small sizes."""

import importlib.util

import numpy as np
import pytest
import torch

from core import gen, manifest
from reference import evidence, hyperfine, priors

NH3 = manifest.cell_of("nh3", "nh3_irdc", "nh3_bright")
N2HP = manifest.cell_of("n2hp", "n2hp_10", "n2hp_bright")


def test_generator_is_deterministic_by_seed():
    a = gen.make_inputs(NH3.config, NH3.traffic, 5,
                        np.random.default_rng(2**31 + 11))
    b = gen.make_inputs(NH3.config, NH3.traffic, 5,
                        np.random.default_rng(2**31 + 11))
    c = gen.make_inputs(NH3.config, NH3.traffic, 5,
                        np.random.default_rng(2**31 + 12))
    for (ta, xa, da), (tb, xb, db), (_, _, dc) in zip(
            a.spectra, b.spectra, c.spectra):
        assert ta == tb and np.array_equal(xa, xb)
        assert np.array_equal(da, db) and not np.array_equal(da, dc)


@pytest.mark.parametrize("cell", [NH3, N2HP], ids=["nh3", "n2hp"])
def test_every_seed_deals_the_same_truths(cell):
    """Every run fits the same pixels, in its own order and under its own
    noise."""
    a, b = (gen.make_inputs(cell.config, cell.traffic, 7,
                            np.random.default_rng(2**31 + s))
            for s in (21, 22))
    rows = sorted(map(tuple, a.params))
    assert rows == sorted(map(tuple, b.params))
    assert not np.array_equal(a.params, b.params)
    assert not np.array_equal(a.spectra[0][2], b.spectra[0][2])


def one_generator(cell, n, rng):
    """The mix's truths and noise from one generator, as the port's
    generators draw them."""
    params = gen.draw_params(cell.traffic["params"], n, rng)
    return gen.observe(cell.config, params, cell.traffic["rms"], rng)


def test_nh3_mix_equals_the_ports_synthetic_cube():
    from nestfit_tpu_torch.synth import make_synth_cube_arrays

    got = one_generator(NH3, 6, np.random.default_rng(5))
    (xa11, d11), (xa22, d22), params = make_synth_cube_arrays(
        n_pix=6, noise=NH3.traffic["rms"], rng=np.random.default_rng(5))
    assert np.array_equal(got.params, params)
    for (_tid, x, d), (xw, dw) in zip(got.spectra, ((xa11, d11),
                                                    (xa22, d22))):
        np.testing.assert_allclose(x, xw, rtol=1e-15)
        np.testing.assert_allclose(d, dw, rtol=1e-9, atol=1e-9)


def test_n2hp_mix_equals_the_smoke_cube():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", manifest.ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    got = one_generator(N2HP, 4, np.random.default_rng(9))
    xarr, data = smoke.n2hp_cube(4, np.random.default_rng(9))
    np.testing.assert_allclose(got.spectra[0][1], xarr, rtol=1e-15)
    np.testing.assert_allclose(got.spectra[0][2], data, rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("cell", [NH3, N2HP], ids=["nh3", "n2hp"])
@pytest.mark.parametrize("ncomp", [1, 2])
def test_reference_transform_equals_the_ports_at_float64(cell, ncomp):
    """With float64 tables the port's transform (its plain K2/K3) is the
    reference's up to rounding."""
    import nestfit_tpu_torch.priors as pp

    ut = getattr(pp, cell.config["prior_constructor"])(
        dtype=torch.float64, device="cpu")
    ref = priors.Transform(cell.config["prior_set"])
    u = torch.rand(4000, ref.n_param * ncomp, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(ncomp))
    got = ref(u)
    want = ut.transform(u, ncomp, plain=True)
    cells = torch.as_tensor(np.repeat(ref.cells(), ncomp))
    assert float(((got - want).abs() / cells).max()) < 1e-6


@pytest.mark.parametrize("cell", [NH3, N2HP], ids=["nh3", "n2hp"])
def test_reference_model_equals_the_oracle(cell):
    from nestfit_tpu_torch import oracle

    inputs = gen.make_inputs(cell.config, cell.traffic, 3,
                             np.random.default_rng(4))
    model = gen.model_module(cell.config)
    fn = oracle.amm_predict if cell.config["model"] == "ammonia" \
        else oracle.nnhp_predict
    for tid, xarr, _d in inputs.spectra:
        ax = hyperfine.make_axis(cell.config["model"], tid, xarr)
        got = model.predict(ax, torch.as_tensor(inputs.params)).numpy()
        for i, p in enumerate(inputs.params):
            np.testing.assert_allclose(got[i], fn(xarr, p, trans_id=tid),
                                       rtol=1e-9, atol=1e-9)


def test_weight_tables_equal_the_samplers():
    from nestfit_tpu_torch.sampling.sampler import _weight_tables

    for args in ((100, 25, 12300, 300), (200, 50, 12300, 600),
                 (20, 10, 400, 60)):
        for a, b in zip(evidence.weight_tables(*args),
                        _weight_tables(*args)):
            assert np.array_equal(a, b)


def test_quantiles_equal_the_ports():
    from nestfit_tpu_torch.sampling.results import QUANTILES, \
        _weighted_quantiles

    g = torch.Generator().manual_seed(0)
    theta = torch.randn(300, 3, generator=g, dtype=torch.float64)
    lnp = torch.randn(300, generator=g, dtype=torch.float64) * 3
    theta[250:] = float("inf")
    lnp[250:] = -1e30
    want = _weighted_quantiles(theta.T[None].contiguous(), lnp[None],
                               torch.as_tensor(QUANTILES))[0].T
    got = evidence.weighted_quantiles(theta, lnp)
    assert torch.equal(got, want)
