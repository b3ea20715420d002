"""The port's profiling helpers (``nestfit_tpu_torch/utils/profiling.py``)
on the CPU: ``trace`` writes a Chrome trace with the program's spans,
``time_fn`` and ``profile_predict`` time real work."""

import json

import numpy as np
import pytest
import torch

from nestfit_tpu_torch.models import AmmoniaRunner, ammonia
from nestfit_tpu_torch.models.tables import AMMONIA_TRANSITIONS
from nestfit_tpu_torch.priors import get_irdc_priors
from nestfit_tpu_torch.sampling import NSConfig, fit_batch
from nestfit_tpu_torch.utils import freq_axis_from_velocity
from nestfit_tpu_torch.utils.profiling import profile_predict, time_fn, trace


def _runner(n_pix=4):
    rng = np.random.default_rng(0)
    spectra = [ammonia.make_ammonia_spectrum(
        freq_axis_from_velocity(np.linspace(-10, 10, 64),
                                AMMONIA_TRANSITIONS[tid - 1].nu),
        rng.normal(scale=0.1, size=(n_pix, 64)), np.full(n_pix, 0.1),
        trans_id=tid, device="cpu") for tid in (1, 2)]
    return AmmoniaRunner(spectra, get_irdc_priors(device="cpu"), ncomp=1,
                         device="cpu")


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace(log_dir)`` exports the block's operations and, above them,
    the program's spans of a small segmented ``fit_batch``; the
    directory is required."""
    runner = _runner()
    gen = torch.Generator().manual_seed(0)
    with trace(tmp_path / "tr") as prof:
        fit_batch(gen, runner, 4, NSConfig(nlive=16, tol=5.0, max_iter=64),
                  n_post=16, segment_iters=32, device="cpu")
    path = tmp_path / "tr" / "trace.json"
    names = {str(e.get("name", ""))
             for e in json.loads(path.read_text())["traceEvents"]}
    assert any("mm" in n for n in names)
    assert {"fit.batch", "fit.sampler", "fit.products", "ns.init",
            "ns.segment", "ns.finalize"} <= names
    assert prof.key_averages()
    with pytest.raises(TypeError):
        trace()


def test_time_fn_on_the_cpu():
    x = torch.rand(256, 256)
    t = time_fn(torch.matmul, x, x, n_repeat=5, warmup=1)
    assert 0.0 < t < 10.0


def test_profile_predict_on_the_cpu():
    out = profile_predict(_runner(), batch=64, n_repeat=3)
    assert out["batch"] == 64
    assert out["sec_per_call"] > 0
    assert out["evals_per_sec"] == pytest.approx(64 / out["sec_per_call"])
    with pytest.raises(ValueError):
        profile_predict(_runner(), batch=6)
    with pytest.raises(ValueError):
        profile_predict(_runner(), ncomp=2)
