"""The port's span-and-counter recorder (``nestfit_tpu_torch/utils/
profiling.py``) on the CPU: nesting, attributes and counters; nothing
recorded outside ``collect()``; the recorder's clock is the one
``torch.profiler`` stamps its events with; and a small cube ladder
(``CubeFitter._fit_batches``) whose ``BatchRecords.trace`` holds the
ladder's spans, the sampler's host reads and its iterations, with the
rung walls equal to the span lengths."""

import threading

import numpy as np
import pytest
import torch

from nestfit_tpu_torch import cube as tcube
from nestfit_tpu_torch.cube.fitter import CubeFitter
from nestfit_tpu_torch.models import AmmoniaRunner
from nestfit_tpu_torch.priors import get_irdc_priors
from nestfit_tpu_torch.utils import profiling as prof

from _cube_inputs import synth_stack


def test_spans_nest_with_attributes_and_counters():
    with prof.collect() as tr:
        with prof.span("outer", rows=4, name="any") as outer:
            prof.count("n")
            with prof.span("inner", mode="cand") as inner:
                inner.set(i1=8)
                prof.count("n", 3)
            prof.count("m", 2)
        with prof.span("second"):
            pass
    names = [(s[0], s[3], s[4]) for s in tr.spans]
    assert names == [("outer", 0, {"rows": 4, "name": "any"}),
                     ("inner", 1, {"mode": "cand", "i1": 8}),
                     ("second", 0, {})]
    (_, o0, o1, _, _), (_, i0, i1, _, _), (_, s0, _, _, _) = tr.spans
    assert o0 <= i0 <= i1 <= o1 <= s0
    assert outer.seconds == (o1 - o0) / 1e9
    assert tr.counters == {"n": 4, "m": 2}


def test_counters_keep_their_share_by_attributes():
    with prof.collect() as outer:
        prof.count("rows", 5, kind="a")
        with prof.collect() as inner:
            prof.count("rows", 2, kind="b")
            prof.count("rows", 1, kind="a")
            prof.count("rows", 4)
    assert inner.counters == {"rows": 7}
    assert inner.tagged == {("rows", (("kind", "a"),)): 1,
                            ("rows", (("kind", "b"),)): 2}
    assert outer.counters == {"rows": 12}
    assert outer.tagged == {("rows", (("kind", "a"),)): 6,
                            ("rows", (("kind", "b"),)): 2}


def test_host_reads_are_counted_by_site():
    x = torch.arange(6.0)
    with prof.collect() as tr:
        a = prof.to_host(x, "ns.done")
        prof.to_host(x.sum(), "ns.done")
        b = prof.to_host(x[:2], "cube.lnz")
    np.testing.assert_array_equal(a, x.numpy())
    np.testing.assert_array_equal(b, [0.0, 1.0])
    assert set(tr.syncs) == {"ns.done", "cube.lnz"}
    assert tr.syncs["ns.done"][0] == 2 and tr.syncs["cube.lnz"][0] == 1
    assert all(w >= 0 for _c, w in tr.syncs.values())


def test_nothing_is_recorded_outside_collect():
    x = torch.linspace(0.0, 1.0, 5)
    with prof.span("lost", a=1) as sp:
        prof.count("lost")
        got = prof.to_host(x, "lost")
    np.testing.assert_array_equal(got, x.numpy())
    # the span still times itself, for callers that read its length
    assert sp.t0_ns <= sp.t1_ns and sp.seconds >= 0
    with prof.collect() as tr:
        pass
    assert tr.spans == [] and tr.counters == {} and tr.syncs == {}


def test_collect_is_per_thread_and_nested_blocks_fold_outward():
    seen = []
    with prof.collect() as outer:
        with prof.span("a"):
            with prof.collect() as inner:
                with prof.span("b"):
                    prof.count("k")
                    prof.to_host(torch.ones(2), "s")
        def other():
            with prof.span("other thread") as sp:
                prof.count("other")
            seen.append(sp.seconds)

        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert [(s[0], s[3]) for s in inner.spans] == [("b", 0)]
    assert [(s[0], s[3]) for s in outer.spans] == [("a", 0), ("b", 1)]
    assert outer.counters == {"k": 1} and outer.syncs["s"][0] == 1
    assert len(seen) == 1 and seen[0] >= 0


def test_spans_share_the_profilers_clock():
    """A ``record_function`` range opened inside a span starts, on
    kineto's clock, between the span's stamps (within 1 ms): the spans
    need no alignment to sit on a ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    stamps = []
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with prof.collect() as tr:
            for k in range(3):
                with prof.span(f"span{k}"):
                    with record_function(f"mark{k}"):
                        torch.ones(64).sum()
    starts = {e.name(): e.start_ns()
              for e in p.profiler.kineto_results.events()
              if e.name().startswith("mark")}
    for k, (name, t0, t1, _d, _a) in enumerate(tr.spans):
        stamps.append(starts[f"mark{k}"])
        assert t0 - 1_000_000 <= starts[f"mark{k}"] <= t1 + 1_000_000
    assert stamps == sorted(stamps)


@pytest.fixture(scope="module")
def batch():
    """One ladder batch of the 4x2 synthetic stack on the CPU, rung 2
    with a boundary refit of every run."""
    torch.set_num_threads(2)
    fitter = CubeFitter(
        synth_stack(tcube), get_irdc_priors(vsys=0.0, device="cpu"),
        AmmoniaRunner, device="cpu", batch_size=8, nlive_buckets=1,
        ncomp_max=2, ns_kwargs={"nlive": 16, "tol": 5.0, "max_iter": 300},
        n_post=16, segment_iters=64, mode_loss_retries=1,
        boundary_band=1e7, lnZ_thresh=-1e6)
    (b,) = list(fitter._fit_batches(seed=11))
    return b


def _spans(tr, name):
    return [s for s in tr.spans if s[0] == name]


def test_batch_trace_holds_the_ladder(batch):
    tr = batch.trace
    rungs = _spans(tr, "cube.rung")
    assert len(rungs) == len(batch.rungs) == 2
    for (_n, t0, t1, _d, attrs), r in zip(rungs, batch.rungs):
        assert r["total_wall"] == (t1 - t0) / 1e9
        assert (attrs["ncomp"], attrs["rows"], attrs["r_pad"],
                attrs["nlive"]) == (r["ncomp"], r["R"], r["r_pad"],
                                    r["nlive"])
    firsts = _spans(tr, "cube.first_pass")
    assert [(t1 - t0) / 1e9 for _n, t0, t1, _d, _a in firsts] == \
        [r["wall"] for r in batch.rungs]
    bounds = _spans(tr, "cube.boundary")
    assert len(bounds) == 2
    assert [(t1 - t0) / 1e9 for _n, t0, t1, _d, _a in bounds] == \
        [r["boundary"]["wall"] for r in batch.rungs if r["boundary"]]
    retries = [a for r in batch.rungs for a in r["retries"]]
    assert retries
    assert [(t1 - t0) / 1e9 for _n, t0, t1, _d, _a in
            _spans(tr, "cube.mode_loss_retry")] == [a["wall"]
                                                    for a in retries]
    (top,) = [s for s in tr.spans if s[3] == 0]
    assert top[0] == "cube.batch" and top[4]["attempt"] == 1
    assert top[4]["rows"] == batch.pixel_ix.size
    for name in ("cube.records", "cube.merge", "fit.batch", "fit.sampler",
                 "fit.products", "ns.init", "ns.segment", "ns.finalize"):
        assert _spans(tr, name), name
    # every span lies inside the batch's
    assert all(top[1] <= t0 <= t1 <= top[2] for _n, t0, t1, _d, _a
               in tr.spans)
    for site in ("cube.lnz", "cube.converged", "cube.n_dead",
                 "cube.null_lnz", "cube.ncall", "cube.records"):
        assert tr.syncs[site][0] > 0, site


def test_batch_trace_counts_the_samplers_reads_and_iterations(batch):
    tr = batch.trace
    ns_reads = sum(c for site, (c, _w) in tr.syncs.items()
                   if site.startswith("ns."))
    assert ns_reads > 0
    assert tr.syncs["ns.done"][0] > 0 and tr.syncs["ns.running"][0] > 0
    fits = _spans(tr, "fit.batch")
    assert all(a["mode"] == "segmented" for *_x, a in fits)
    # each sampler call ran its last segment's end; the calls' ends sum
    # to the counter
    ends = {}
    for name, t0, _t1, _d, a in tr.spans:
        if name == "fit.sampler":
            ends[t0] = 0
            cur = t0
        elif name == "ns.segment":
            assert a["i1"] >= a["i0"]
            ends[cur] = max(ends[cur], a["i1"])
    assert len(ends) == len(fits)
    assert tr.counters["ns.iterations"] == sum(ends.values())
    assert tr.counters["ns.segments"] == len(_spans(tr, "ns.segment"))
    assert tr.counters["ns.blocks"] >= tr.counters["ns.segments"] \
        - sum(1 for *_x, a in _spans(tr, "ns.segment") if a["mode"]
              == "slice")


def test_batch_trace_counts_the_refit_rows_by_kind(batch):
    """``cube.refit_rows``: the rows of every mode-loss retry and
    boundary refit of the batch's rungs, split by ``kind``; the records'
    copy counts the resampling guard's moves (none on these rows)."""
    tr = batch.trace
    retry = sum(a["rows"] for r in batch.rungs for a in r["retries"])
    band = sum(r["boundary"]["rows"] for r in batch.rungs if r["boundary"])
    assert band > 0
    assert tr.counters["cube.refit_rows"] == retry + band
    assert tr.tagged[("cube.refit_rows", (("kind", "mode_loss"),))] == retry
    assert tr.tagged[("cube.refit_rows", (("kind", "boundary"),))] == band
    assert tr.counters["fit.resample_clamped"] >= 0


def _k1_runner(device):
    """A two-transition NH3 runner on the 4x2 synthetic stack's first
    row of pixels, and ``[3, 4, 12]`` parameters from its prior."""
    from _cube_inputs import synth_arrays

    from nestfit_tpu_torch.models import ammonia

    spectra = tuple(
        ammonia.make_ammonia_spectrum(xarr, data[:, 0], 0.1, trans_id=tid,
                                      device=device)
        for tid, xarr, data in synth_arrays())
    runner = AmmoniaRunner(spectra, get_irdc_priors(vsys=0.0, device=device),
                           ncomp=2, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    u = torch.rand((3, 4, 12), generator=gen, device=device)
    return runner, runner.transform(u)


def test_k1_counters_count_the_plain_versions():
    """On the CPU the likelihood entries' plain versions count as their
    launches: ``k1.lnl_fused`` once an evaluation, ``k1.lnl_split`` once
    a transition and channel slice."""
    runner, theta = _k1_runner("cpu")
    with prof.collect() as tr:
        runner._log_likelihood(theta, fused=True)
        runner.placed(["cpu", "cpu"])._log_likelihood(theta, fused=True)
        runner.log_likelihood(theta)      # the model_predict path
    assert tr.counters == {"k1.lnl_fused": 1, "k1.lnl_split": 4}


def test_k1_counters_count_each_replay():
    """A launch recorded while a graph is captured counts nothing then,
    and its counter once for each replay (``_build.add_launches``)."""
    from nestfit_tpu_torch.ops import _build, fused

    n0 = fused.hf_lnl_fused.launches
    with prof.collect() as tr:
        with _build.recording() as per_replay:
            _build.count_launch(fused.hf_lnl_fused)
            _build.count_launch(fused.hf_chi2_fused)
            _build.count_launch(fused.hf_chi2_fused)
        assert tr.counters == {}
        for _ in range(3):
            _build.add_launches(per_replay)
    assert tr.counters == {"k1.lnl_fused": 3, "k1.lnl_split": 6}
    assert fused.hf_lnl_fused.launches == n0 + 3


@pytest.mark.gpu
def test_k1_counters_count_each_replay_of_a_ladder_batch():
    """On the card a ladder batch's likelihoods are one-launch K1
    launches, most of them inside replayed graphs: the batch's
    ``k1.lnl_fused`` equals the wrapper's launch count (which counts
    replays), exceeds the graph replays, and no per-transition launch
    ran."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nestfit_tpu_torch.ops import fused

    fitter = CubeFitter(
        synth_stack(tcube), get_irdc_priors(vsys=0.0, device="cuda"),
        AmmoniaRunner, device="cuda", batch_size=8, nlive_buckets=1,
        ncomp_max=2, ns_kwargs={"nlive": 16, "tol": 5.0, "max_iter": 300},
        segment_iters=64)
    n0, s0 = fused.hf_lnl_fused.launches, fused.hf_chi2_fused.launches
    (b,) = list(fitter._fit_batches(seed=11))
    torch.cuda.synchronize()
    n = b.trace.counters
    assert n["k1.lnl_fused"] == fused.hf_lnl_fused.launches - n0
    assert n["k1.lnl_fused"] > n["ns.graph_steps"] > 0
    assert "k1.lnl_split" not in n
    assert fused.hf_chi2_fused.launches == s0


@pytest.mark.gpu
def test_prior_counters_count_each_replay_of_a_ladder_batch():
    """On the card every prior transform of a ladder batch (the sampler's
    and the products') is one launch of the prior kernel, most of them
    inside replayed graphs: the batch's ``prior.fused`` equals the
    wrapper's launch count, exceeds the graph replays, and neither the
    per-prior path nor K2/K3 ran."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nestfit_tpu_torch.ops import tables

    fitter = CubeFitter(
        synth_stack(tcube), get_irdc_priors(vsys=0.0, device="cuda"),
        AmmoniaRunner, device="cuda", batch_size=8, nlive_buckets=1,
        ncomp_max=2, ns_kwargs={"nlive": 16, "tol": 5.0, "max_iter": 300},
        segment_iters=64)
    n0 = tables.prior_transform_fused.launches
    k0 = tables.table_lerp.launches + tables.tapered_invert.launches
    (b,) = list(fitter._fit_batches(seed=11))
    torch.cuda.synchronize()
    n = b.trace.counters
    assert n["prior.fused"] == tables.prior_transform_fused.launches - n0
    assert n["prior.fused"] > n["ns.graph_steps"] > 0
    assert "prior.split" not in n
    assert tables.table_lerp.launches + tables.tapered_invert.launches == k0
