"""Whole runs on the CPU at a tiny size (the chip's look skipped): a
sound run is correct, and each fault planted in the timed path, and
the bfloat16 control in the program's place, make ``correct`` false."""

import dataclasses
import time

import numpy as np
import pytest
import torch

import run
from core import check, manifest


def tiny(entry, pixels):
    """The N2H+ configuration at a tiny size through ``entry``: the cube
    ladder, or ``fit_batch`` at its defaults."""
    cell = manifest.cell_of(f"tiny_{entry}", "n2hp_10", "n2hp_bright")
    cell.config = dict(cell.config, nlive=16, max_iter=600, batch_size=8)
    cell.traffic = dict(cell.traffic, pixels=pixels, entry=entry)
    return cell


def run_tiny(cell, seed=2**31 + 3, control=None):
    return run.run_cell(cell, seed, 0.1, device="cpu", t_proc=time.time(),
                        control_dtype=control, log=lambda *a, **k: None)


@pytest.mark.parametrize("entry,pixels", [("cube", 16), ("batch", 6)])
def test_sound_runs_are_correct_and_the_control_is_not(entry, pixels):
    cell = tiny(entry, pixels)
    result, control = run_tiny(cell, control=torch.bfloat16)
    assert result["correct"], result["checks"]
    # a 0.1-s window runs one unit: one batch of 8, or every pixel
    assert result["attempted"] == (8 if entry == "cube" else pixels)
    assert result["failed"] == 0
    limits = cell.config["limits"]
    ok, _ = check.verdict(control, {k: limits[k] for k in control})
    assert not ok, control


def _wrap_fit_batch(monkeypatch, change):
    from nestfit_tpu_torch.cube import fitter
    from nestfit_tpu_torch.sampling import fit

    real = fit.fit_batch

    def broken(*a, **k):
        return change(real(*a, **k))

    monkeypatch.setattr(fit, "fit_batch", broken)
    monkeypatch.setattr(fitter, "fit_batch", broken)


def _answer_altered(out):
    ns = dataclasses.replace(out.ns, lnz=out.ns.lnz + 0.5)
    return dataclasses.replace(out, ns=ns)


def _half_left_out(out):
    """The second half of the rows carry the first half's answers."""
    from nestfit_tpu_torch.sampling.fit import merge_fit_rows

    n = out.lnz.shape[0]
    h = n // 2
    return merge_fit_rows(out, out, np.arange(h, 2 * h), np.arange(h), n, n)


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out",
                                   "likelihood_off"])
@pytest.mark.parametrize("entry,pixels", [("cube", 16), ("batch", 6)])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, entry,
                                            pixels):
    if fault == "likelihood_off":
        from nestfit_tpu_torch.models import runner

        real = runner.Runner.log_likelihood
        monkeypatch.setattr(runner.Runner, "log_likelihood",
                            lambda self, *a, **k: real(self, *a, **k) - 1.0)
    else:
        _wrap_fit_batch(monkeypatch, {"answer_altered": _answer_altered,
                                      "half_left_out": _half_left_out}[fault])
    result, _ = run_tiny(tiny(entry, pixels))
    assert not result["correct"], result["checks"]


def test_a_ladder_decision_altered_is_not_correct(monkeypatch):
    from nestfit_tpu_torch.cube import fitter

    real = fitter.CubeFitter._fit_batch_ladder

    def flipped(self, *a, **k):
        nbest, records, rungs = real(self, *a, **k)
        nbest = nbest.copy()
        nbest[0] = 1 - min(nbest[0], 1)
        return nbest, records, rungs

    monkeypatch.setattr(fitter.CubeFitter, "_fit_batch_ladder", flipped)
    result, _ = run_tiny(tiny("cube", 16))
    assert not result["correct"]
    assert result["checks"]["ladder_mismatch"]["value"] > 0
