"""Port parity of the synthetic-data helpers (``nestfit_tpu_torch/synth.py``)
against ``nestfit_tpu/synth.py``: NumPy on both sides, so with the same
``rng`` every array, header and FITS file is equal bit for bit."""

import os

import numpy as np
import pytest
import torch

from nestfit_tpu import synth as jsynth

from nestfit_tpu_torch import synth as tsynth
from nestfit_tpu_torch.cube import DataCube, read_fits

SPECTRUM_FIELDS = ("xarr", "params", "components", "sum_spec", "noise_spec",
                   "sampled_spec", "varr", "mod_spec")


@pytest.mark.parametrize("kind", [0, 1])
def test_get_test_spectra_matches_jax(kind):
    got, want = tsynth.get_test_spectra(kind), jsynth.get_test_spectra(kind)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert (g.trans_id, g.ncomp, g.noise, g.size) == \
            (w.trans_id, w.ncomp, w.noise, w.size)
        for name in SPECTRUM_FIELDS:
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
        spec = g.to_ammspec(device="cpu")
        jspec = w.to_ammspec()
        for name in ("dnu", "data", "noise", "t0", "tbg"):
            np.testing.assert_array_equal(getattr(spec, name).numpy(),
                                          np.asarray(getattr(jspec, name)))
        assert (spec.rest_freq, spec.trans_id, spec.size) == \
            (jspec.rest_freq, jspec.trans_id, jspec.size)


def test_get_test_spectra_rejects_unknown_kind():
    for module in (tsynth, jsynth):
        with pytest.raises(ValueError, match="Invalid kind"):
            module.get_test_spectra(2)


def test_synthetic_spectrum_resample_matches_jax():
    got, want = (m.get_test_spectra(0)[0] for m in (tsynth, jsynth))
    for s in (got, want):
        s.resample_spectrum(noise=0.5)
    assert got.sampled_spec.tobytes() == want.sampled_spec.tobytes()
    if not torch.cuda.is_available():
        # the port's spectrum goes to the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="cuda"):
            got.to_ammspec()


@pytest.mark.parametrize("kind", [0, 1])
def test_make_synth_cube_arrays_matches_jax(kind):
    kw = dict(n_pix=5, noise=0.2, kind=kind,
              sampler_kwargs={"vsep": (0.2, 1.0)})
    got = tsynth.make_synth_cube_arrays(rng=np.random.default_rng(3), **kw)
    want = jsynth.make_synth_cube_arrays(rng=np.random.default_rng(3), **kw)
    for g, w in zip((*got[0], *got[1], got[2]), (*want[0], *want[1], want[2])):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("extra", [{}, {"rms": 0.3, "rest_freq": 2.3e10}])
def test_make_fake_header_matches_jax(extra):
    xarr = np.linspace(2.3e10, 2.3001e10, 17)
    got = tsynth.make_fake_header(4, 3, xarr, **extra)
    want = jsynth.make_fake_header(4, 3, xarr, **extra)
    assert list(got.items()) == list(want.items())
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]


def test_make_indep_synth_cube_matches_jax(tmp_path):
    """The FITS harness at im_shape (2, 3) and two noise levels: the same
    files byte for byte, read back through the port's
    ``DataCube.from_fits``."""
    kw = dict(im_shape=(2, 3), noise_levels=[0.0, 0.2])
    got = tsynth.make_indep_synth_cube(
        tmp_path / "t", rng=np.random.default_rng(11), **kw)
    want = jsynth.make_indep_synth_cube(
        tmp_path / "j", rng=np.random.default_rng(11), **kw)
    assert set(got["cubes"]) == set(want["cubes"]) == {0.0, 0.2}
    pairs = [(got["params"], want["params"]), (got["peak"], want["peak"])]
    pairs += [(g, w) for rms in got["cubes"]
              for g, w in zip(got["cubes"][rms], want["cubes"][rms])]
    assert len(pairs) == 6
    for g, w in pairs:
        assert os.path.basename(g) == os.path.basename(w)
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read(), g
    p11, p22 = got["cubes"][0.2]
    c1 = DataCube.from_fits(p11, trans_id=1)
    c2 = DataCube.from_fits(p22, trans_id=2)
    assert c1.shape == c2.shape == (3, 2, 380)
    assert c1.noise_map.rms == pytest.approx(0.2)
    assert c1.xarr[1] > c1.xarr[0]
    assert abs(c1.rest_freq - c2.rest_freq) > 1e7
    pdata, _ = read_fits(got["params"])
    assert pdata.shape == (12, 2, 3)
