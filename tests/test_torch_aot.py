"""Preparing a fit before its first batch (``nestfit_tpu_torch/sampling/
aot.py``): the plan's tasks and keys, the traced keys against those a run
of the static-state block loop visits, the report's keys against the JAX
module's, the program cap, and fits after a preparation bit for bit equal
to fits without one.

The module imports neither JAX nor ``nestfit_tpu`` at its top (only
:func:`test_report_has_the_jax_keys` imports the JAX module), so the
card's case runs on a machine without them::

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_aot.py -m gpu
"""

import dataclasses
import time
import warnings

import numpy as np
import pytest
import torch

from nestfit_tpu_torch.models import AmmoniaRunner, ammonia
from nestfit_tpu_torch.ops import _build
from nestfit_tpu_torch.priors import get_irdc_priors
from nestfit_tpu_torch.sampling import NSConfig, aot, fit_batch, graphs
from nestfit_tpu_torch.synth import make_synth_cube_arrays

N_PIX, NOISE = 8, 0.15
# a death budget of 20 blocks keeps the CPU fits short
CFG = NSConfig(nlive=20, tol=1.0, init_factor=2, max_iter=160)


@pytest.fixture(autouse=True)
def _fresh():
    torch.set_num_threads(2)
    graphs.clear()
    yield
    graphs.clear()


def _runner(ncomp=1, n_pix=N_PIX, device="cpu"):
    (xa11, d11), (xa22, d22), _ = make_synth_cube_arrays(
        n_pix=n_pix, noise=NOISE, rng=np.random.default_rng(4))
    spectra = [ammonia.make_ammonia_spectrum(x, d, np.full(n_pix, NOISE),
                                             trans_id=tid, device=device)
               for tid, x, d in ((1, xa11, d11), (2, xa22, d22))]
    return AmmoniaRunner(spectra, get_irdc_priors(device=device),
                         ncomp=ncomp, device=device)


def _fit(runner, cfg, segment_iters, seed=3, device="cpu"):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return fit_batch(gen, runner, runner.spectra[0].data.shape[0], cfg,
                     segment_iters=segment_iters, device=device)


def _assert_same_fit(a, b):
    for f in ("lnz", "lnz_err", "n_dead", "ncall", "max_loglike", "dead_u"):
        assert torch.equal(getattr(a.ns, f), getattr(b.ns, f)), f
    assert torch.equal(a.products.posteriors, b.products.posteriors)


def test_plan_tasks_and_keys():
    runner = _runner()
    seg = aot.build_plan(runner, N_PIX, CFG, device="cpu")
    assert [t.name for t in seg] == ["warm@cpu"]
    assert seg[0].key == ("warm", torch.device("cpu"), id(runner))
    traced = aot.build_plan(runner, N_PIX, CFG, segment_iters=0,
                            device="cpu")
    assert [t.name for t in traced] == ["warm@cpu", f"n1:traced@{N_PIX}"]
    # the default block 8 / bound_every 4 meets one key
    assert traced[1].graph_keys == ((0, 8),)
    rcfg = dataclasses.replace(
        CFG, flat_dims=tuple(runner.utrans.flat_dims(1))).resolved(6)
    from nestfit_tpu_torch.sampling.fit import _loglike2_for

    want = graphs.program_key(
        _loglike2_for(runner, torch.float32), 0, True, rcfg,
        (N_PIX, CFG.nlive, 6), torch.float32, torch.device("cpu"),
        runner.data_tree())
    assert traced[1].key == ("traced",) + want
    odd = aot.build_plan(runner, N_PIX, dataclasses.replace(
        CFG, bound_every=3), segment_iters=0, device="cpu", label="x")
    assert odd[1].name == f"x:traced@{N_PIX}"
    assert odd[1].graph_keys == ((0, 8), (1, 8), (2, 8))
    # a card is the default device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            aot.build_plan(runner, N_PIX, CFG)


def test_jax_segmented_keywords_warn_and_traced_data_raises():
    runner = _runner()
    with pytest.warns(UserWarning, match="r_classes, kinds_full.*first use"):
        plan = aot.build_plan(runner, N_PIX, CFG, r_classes=[],
                              kinds_full=(), device="cpu")
    assert [t.name for t in plan] == ["warm@cpu"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        aot.build_plan(runner, N_PIX, CFG, device="cpu")
    with pytest.raises(ValueError, match="segment_iters > 0"):
        aot.build_plan(runner, N_PIX, CFG, data=runner.data_tree(),
                       segment_iters=0, device="cpu")


@pytest.mark.parametrize("block_iters,bound_every", [(8, 4), (8, 3)])
def test_traced_keys_are_the_keys_a_run_visits(monkeypatch, block_iters,
                                               bound_every):
    """The plan's keys are the ``(i0 % bound_every, n_iters)`` of every
    full block a CPU run of the static-state loop runs (the keys of the
    program's ``"block"`` unit)."""
    cfg = dataclasses.replace(CFG, block_iters=block_iters,
                              bound_every=bound_every)
    runner = _runner()
    plan = aot.build_plan(runner, N_PIX, cfg, segment_iters=0, device="cpu")
    seen = []
    run = graphs._Program.run

    def record(self, kind, flag, s, *rest):
        if kind == "block":
            assert flag == (s.i % bound_every, flag[1])
            seen.append(flag)
        return run(self, kind, flag, s, *rest)

    monkeypatch.setattr(graphs._Program, "run", record)
    _fit(runner, cfg, 0)
    assert len(seen) >= 4
    visited = {(phase, n) for phase, n in seen if n == block_iters}
    assert set(plan[-1].graph_keys) == visited


def test_report_has_the_jax_keys():
    from nestfit_tpu.sampling import aot as jaot

    want = set(jaot.compile_plan([]))
    runner = _runner()
    plan = aot.build_plan(runner, N_PIX, CFG, segment_iters=0, device="cpu")
    rep = aot.compile_plan(plan + plan, verbose=lambda s: None)
    assert want <= set(rep)
    assert rep["n_programs"] == 4 and rep["n_deduped"] == 2
    assert rep["n_errors"] == 0 and rep["n_abandoned"] == 0
    assert rep["cache_hits"] == rep["cache_misses"] == 0
    names = [r["name"] for r in rep["programs"]]
    assert names == [t.name for t in plan + plan]
    for r in rep["programs"]:
        assert {"name", "wall_s", "cache_hits", "cache_misses"} <= set(r)
    traced = rep["programs"][1]
    assert traced["warmups"] == 1 and traced["captures"] == 0
    assert traced["keys"] == [[0, 8]]
    assert rep["programs"][3]["deduped"]


def test_timeout_abandons_the_tasks_not_started():
    calls = []

    def slow():
        calls.append(1)
        time.sleep(0.05)
        return {}

    tasks = [aot._Task(f"t{i}", (i,), slow, torch.device("cpu"))
             for i in range(3)]
    rep = aot.compile_plan(tasks, timeout=0.01)
    assert len(calls) == 1 and rep["n_abandoned"] == 2
    assert [r["name"] for r in rep["programs"]] == ["t0"]


def test_a_plan_over_the_program_cap_raises():
    runner = _runner()
    plan = []
    for n in range(graphs._PROGRAMS_CAP + 1):
        plan += aot.build_plan(runner, N_PIX,
                               dataclasses.replace(CFG, nlive=20 + n),
                               segment_iters=0, device="cpu")
    with pytest.raises(ValueError, match="_PROGRAMS_CAP"):
        aot.compile_plan(plan)
    # within the cap, and the same program twice, is fine
    rep = aot.compile_plan(plan[:4] + plan[2:4])
    assert rep["n_deduped"] == 3


@pytest.mark.parametrize("segment_iters", [0, 250])
def test_fit_after_precompile_is_bit_for_bit(segment_iters):
    runner = _runner()
    want = _fit(runner, CFG, segment_iters)
    rep = aot.precompile_fit(runner, N_PIX, CFG, segment_iters=segment_iters,
                             device="cpu")
    assert [r["name"] for r in rep["programs"]][0] == "warm@cpu"
    assert len(rep["programs"]) == (2 if segment_iters == 0 else 1)
    _assert_same_fit(_fit(runner, CFG, segment_iters), want)


@pytest.mark.gpu
def test_prepared_program_replays_only_on_the_card():
    """On a card: prepared, the first call runs no warm-up block and
    captures no graph, and equals an unprepared call bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    runner = _runner(ncomp=2, n_pix=64, device="cuda")
    cfg = NSConfig(nlive=50, tol=1.0)
    want = _fit(runner, cfg, 0, device="cuda")
    lazy = graphs.last_stats
    assert lazy.warmups == 1 and lazy.captures > 0
    graphs.clear()
    rep = aot.precompile_fit(runner, 64, cfg, segment_iters=0)
    assert [r["name"] for r in rep["programs"]] == [
        "build", f"warm@{runner.spectra[0].dnu.device}", "n2:traced@64"]
    assert rep["programs"][0]["cache_hits"] \
        + rep["programs"][0]["cache_misses"] == len(_build.SOURCES)
    got = _fit(runner, cfg, 0, device="cuda")
    st = graphs.last_stats
    assert st.warmups == 0 and st.captures == 0 and st.replays > 0
    _assert_same_fit(got, want)
