"""The SNR bucket plan (``reference/levels.py``) and the ``cube`` entry
and check that follow it: at ``nlive_snr_fact`` 0 the accepted cells
get what one batch per unit gave them; the plan is the port's bucketing
and batch order; at factor 5 one window runs a whole pass of every
level's batches, and a pixel run at a level the plan does not give it
makes the run not correct."""

import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import run
from core import check, gen, manifest, program, window
from reference import levels

DATA = Path(__file__).resolve().parent / "data"
CELLS = ["n2hp_cube_bright", "nh3_cube_bright"]


def inputs_of(cell, n_pix, seed=2**31 + 17):
    return gen.make_inputs(cell.config, cell.traffic, n_pix,
                           np.random.default_rng(seed))


def datas(inputs):
    return [d for _, _, d in inputs.spectra]


def bare_entry(cell, n_units, inputs):
    """The cube entry as set-up leaves it for ``unit``, without the
    fitter: its plan, its pass and its tap."""
    cls = manifest.entry_class("cube")
    n = cls.pixels(cell.config, cell.traffic, n_units)
    assert n == inputs.n_pix
    entry = cls.__new__(cls)
    entry.plan = levels.plan(cell.config, datas(inputs), inputs.rms)
    entry.tap = SimpleNamespace(unit=None)
    entry.gen, entry.expect = None, 0
    return entry


def fake_batch(chunk, ids, nlive):
    return SimpleNamespace(chunk=chunk, pixel_ix=ids, nlive=nlive,
                           nbest=np.zeros(ids.size, dtype=np.int32),
                           records=[])


@pytest.mark.parametrize("name", CELLS)
def test_factor_0_gives_what_one_batch_per_unit_gave(name, monkeypatch):
    """The pixels, the plan, the units' accounting and the ladder
    check's inputs of an accepted cell are those of one batch per unit
    (a pass with a batch skipped, then cut short)."""
    from nestfit_tpu_torch.cube.fitter import bucket_nlive

    cell = manifest.find_cell(name)
    config, size = cell.config, cell.config["batch_size"]
    assert config["nlive_snr_fact"] == 0 and "map_px" not in cell.traffic
    n_units = window.units_for(51, float(cell.traffic["unit_s"]))
    inputs = inputs_of(cell, n_units * size)
    entry = bare_entry(cell, n_units, inputs)
    assert [lv for lv, _ in entry.plan.batches] == [config["nlive"]] * n_units
    for c, (_, ids) in enumerate(entry.plan.batches):
        np.testing.assert_array_equal(ids, np.arange(c * size,
                                                     (c + 1) * size))
    level = int(bucket_nlive(np.full(inputs.n_pix, config["nlive"]))[1][0])
    assert level == config["nlive"]

    def px(lo, hi):      # the accounting of one batch per unit
        return sum(min(size, inputs.n_pix - c * size) for c in range(lo, hi))

    # chunk 0 skipped, chunk 1 run, then the pass ends short of chunk 2
    yielded = [fake_batch(1, entry.plan.batches[1][1], level)]
    entry.gen = iter(yielded)
    units = [entry.unit(k) for k in range(n_units - 1)]
    assert [(u["pixels"], u["attempted"], u["failed"]) for u in units] == [
        (size, px(0, 2), px(0, 1)), (0, px(2, 3), px(2, 3))]
    assert entry.unit(n_units - 1) is None

    seen = {}
    monkeypatch.setattr(check.ladder, "replay",
                        lambda *a: seen.update(pixels=a[3], base=a[4]) or [])
    numbers, _, _ = check.judge(config, inputs, SimpleNamespace(runs=[]),
                                units, "cube")
    np.testing.assert_array_equal(
        seen["pixels"], np.concatenate([b.pixel_ix for b in yielded]))
    np.testing.assert_array_equal(
        seen["base"], np.concatenate([np.full(b.pixel_ix.size, b.nlive)
                                      for b in yielded]))
    assert numbers["failed_px"] == sum(u["failed"] for u in units)
    assert numbers["ladder_mismatch"] == 0


@pytest.mark.parametrize("n_buckets", [1, 2, 3, 4, 5, 7])
def test_the_levels_are_the_ports_bucketing(n_buckets):
    from nestfit_tpu_torch.cube.fitter import bucket_nlive

    rng = np.random.default_rng(n_buckets)
    for n in (1, 2, 5, 64, 1000, 2048):
        for snr in (rng.gamma(2.0, 8.0, n), rng.uniform(0, 3, n),
                    np.full(n, 10.0), np.round(rng.uniform(0, 60, n))):
            nlive = 100 + (5 * snr).astype(int)
            want, want_levels = bucket_nlive(nlive, n_buckets=n_buckets)
            got, got_levels = levels.bucket(nlive, n_buckets)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got_levels, want_levels)


@pytest.mark.parametrize("fact,n_buckets,batch_size,n_pix", [
    (5, 4, 1024, 2048), (5, 4, 100, 700), (5, 3, 64, 333), (2, 4, 50, 96),
    (0, 4, 1024, 3072), (0, 4, 128, 200)])
def test_the_batches_are_the_fitters(fact, n_buckets, batch_size, n_pix):
    """The plan's batches are ``_fit_batches``' chunks: the same pixels
    at the same live count in the same order, on seeded random cubes of
    two transitions with a spread of signal."""
    cube, _, _, _, _, _, _ = program.modules()
    config = dict(manifest.find_cell("nh3_cube_bright").config,
                  nlive_snr_fact=fact, nlive_buckets=n_buckets,
                  batch_size=batch_size)
    rng = np.random.default_rng(n_pix)
    rms = 0.15
    amp = rng.gamma(1.5, 1.0, n_pix)[:, None]
    data = [amp * rng.uniform(0, 1, (n_pix, 40)) +
            rng.normal(0, rms, (n_pix, 40)) for _ in range(2)]
    xarr = np.linspace(23.69e9, 23.70e9, 40)
    stack = cube.CubeStack([cube.DataCube(d.reshape(n_pix, 1, 40), xarr,
                                          noise_map=rms, trans_id=t)
                            for t, d in zip((1, 2), data)])
    runner_cls, utrans = program.runner_parts(config, "cpu")
    fitter = cube.CubeFitter(
        stack, utrans, runner_cls, ns_kwargs=dict(nlive=config["nlive"]),
        nlive_snr_fact=fact, nlive_buckets=n_buckets,
        batch_size=batch_size, device="cpu")
    made = []

    def fake(ss, batch_ix, datas, noises, cfg, chunk=0):
        made.append((cfg.nlive, batch_ix.copy()))
        return (np.zeros(batch_ix.size, np.int32), [], []), 1

    fitter._run_batch_with_retry = fake
    chunks = [b.chunk for b in fitter._fit_batches(seed=3)]
    plan = levels.plan(config, data, rms)
    assert chunks == list(range(len(plan.batches)))
    assert [lv for lv, _ in plan.batches] == [lv for lv, _ in made]
    for (_, want), (_, got) in zip(made, plan.batches):
        np.testing.assert_array_equal(got, want)
    if fact:
        assert len({lv for lv, _ in made}) > 1


def snr_cell():
    """The test-only configuration of ``data/n2hp_snr_tiny.json``."""
    spec = json.loads((DATA / "n2hp_snr_tiny.json").read_text())
    cell = manifest.cell_of("n2hp_snr_tiny", spec["config"],
                            spec["traffic"])
    cell.config = dict(cell.config, **spec["config_changes"])
    cell.traffic = dict(cell.traffic, **spec["traffic_changes"])
    return cell, spec["seconds"]


def run_snr(cell, seconds, monkeypatch, seed=2**31 + 29):
    """A run of ``cell`` on the CPU; returns its result and the units the
    check was handed."""
    seen = {}
    judge = check.judge

    def keep(*a, **k):
        seen["units"] = a[3]
        return judge(*a, **k)

    monkeypatch.setattr(check, "judge", keep)
    result, _ = run.run_cell(cell, seed, seconds, device="cpu",
                             t_proc=time.time(), log=lambda *a, **k: None)
    return result, seen["units"]


def test_one_window_runs_every_levels_batch(monkeypatch):
    cell, seconds = snr_cell()
    result, units = run_snr(cell, seconds, monkeypatch)
    assert result["correct"], result["checks"]
    assert result["attempted"] == cell.traffic["map_px"] == 64
    assert result["failed"] == 0
    ran = [(u["batch"].nlive, u["batch"].pixel_ix.size) for u in units]
    assert len(ran) == seconds / cell.traffic["unit_s"]
    assert [lv for lv, _ in ran] == sorted(lv for lv, _ in ran)
    assert len({lv for lv, _ in ran}) >= 3
    assert sum(n for _, n in ran) == 64


def test_a_pixel_at_the_wrong_level_is_not_correct(monkeypatch):
    """The port's bucketing puts the top level's pixels one level down."""
    from nestfit_tpu_torch.cube import fitter

    real = fitter.bucket_nlive

    def moved(nlive_arr, **k):
        assign, lv = real(nlive_arr, **k)
        return np.where(assign == lv[-1], lv[-2], assign), lv[:-1]

    monkeypatch.setattr(fitter, "bucket_nlive", moved)
    cell, seconds = snr_cell()
    result, _ = run_snr(cell, seconds, monkeypatch)
    assert not result["correct"]
    assert result["checks"]["ladder_mismatch"]["value"] >= 1


def test_a_plan_that_is_not_the_windows_units_stops_set_up():
    cell, seconds = snr_cell()
    with pytest.raises(ValueError, match=r"has 6 batches .* and the window "
                                         r"5 units"):
        run.run_cell(cell, 2**31 + 29, seconds - 1, device="cpu",
                     t_proc=time.time(), log=lambda *a, **k: None)
