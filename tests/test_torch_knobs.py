"""Port parity of the sampler knobs that the mode-loss probe and the
iteration-cost sweep turn (``validation/mode_loss_probe.py``'s
``VARIANTS``; ``validation/iter_cost_sweep.py``'s combos, the default four
and ``32,1,4``, ``32,1,4,4``).

(a) Each variant's and combo's ``NSConfig(**kw).resolved(ndim)`` is the
    JAX package's, field for field, at ndim 6 and 12 (auto ``kill_k`` and
    auto ``fallback_repeats`` included).
(b) ``init_stratified``: both packages' initial set (live points and the
    oversampled init's dead points together) holds exactly one point in
    each of the L0 bins of every (run, dim) column; off, the port's set is
    its plain iid draw.
(c) Each variant and combo on the port in both sampler modes recovers the
    analytic D = 4 Gaussian evidence of the JAX package's efr test within
    that test's bars.  So that the slice knobs act, the segmented runs
    force the kill+slice regime (``cand_min_acc`` 0.5, as the compaction
    test does) and the traced runs leave part of each block's slots to the
    slice fill (``cand_factor`` 1).  ``slice_bound_every`` only paces the
    kill+slice regime's whitening refresh, which the traced mode never
    runs (in either package): traced, a cadence of 2 is held bit for bit
    to a cadence of 1.
(d) NH3 rung 1 against the JAX package at four of these knobs is
    ``test_torch_knobs_nh3.py`` (a file of its own, so that each stays
    under two minutes on the CPU).
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

from nestfit_tpu.sampling import NSConfig as JaxConfig
from nestfit_tpu.sampling import sampler as js

from nestfit_tpu_torch.sampling import NSConfig
from nestfit_tpu_torch.sampling import sampler as ts
from validation_torch import iter_cost_sweep, mode_loss_probe

VAL = Path(__file__).resolve().parent.parent / "validation"


def _jax_variants():
    spec = importlib.util.spec_from_file_location(
        "jax_mode_loss_probe", VAL / "mode_loss_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.VARIANTS


JAX_VARIANTS = _jax_variants()
SWEEP = ("0,1", "50,1", "0,2", "50,2", "32,1,4", "32,1,4,4")


def _combo_kw(arg):
    """``validation/iter_cost_sweep.py``'s parsing (its lines 70-75) and
    config (its ``NSConfig`` call), as a keyword dict."""
    f = [int(x) for x in arg.split(",")]
    f += [1, 6, 0, 2][len(f) - 2:]
    kk, sbe, inif, mc, rep, sw = tuple(f[:6])
    return dict(nlive=100, tol=1.0, kill_k=kk, slice_bound_every=sbe,
                init_factor=inif, max_contract=mc, fallback_repeats=rep,
                spec_width=sw)


CASES = [(f"variant:{k}", {"nlive": 100, "tol": 1.0, **v})
         for k, v in JAX_VARIANTS.items()] \
    + [(f"combo:{c}", _combo_kw(c)) for c in SWEEP]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# (a) the resolved configs


def test_variants_and_combos_are_the_jax_scripts():
    assert mode_loss_probe.VARIANTS == JAX_VARIANTS
    for c in SWEEP:
        combo, = iter_cost_sweep.parse_combos([c])
        assert dataclasses.asdict(iter_cost_sweep.combo_config(combo)) == \
            dataclasses.asdict(NSConfig(**_combo_kw(c)))
    for tag in JAX_VARIANTS:
        assert mode_loss_probe.config(tag) == NSConfig(
            **{"nlive": 100, "tol": 1.0, **JAX_VARIANTS[tag]})


@pytest.mark.parametrize("ndim", [6, 12])
@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_resolved_config_matches_jax(name, kw, ndim):
    got = dataclasses.asdict(NSConfig(**kw).resolved(ndim))
    want = dataclasses.asdict(JaxConfig(**kw).resolved(ndim))
    assert got == want
    assert got["kill_k"] > 0 and got["fallback_repeats"] > 0


# ---------------------------------------------------------------------------
# (b) the stratified initial set


def _initial_set(u, dead_u, n_id):
    """``[R, L0, D]``: the live points and the init's dead points."""
    return np.concatenate([np.asarray(u), np.asarray(dead_u)[:, :n_id]],
                          axis=1)


def _one_per_bin(pts):
    L0 = pts.shape[1]
    bins = np.sort(np.floor(pts * L0).astype(int), axis=1)
    return np.array_equal(bins, np.broadcast_to(
        np.arange(L0)[None, :, None], bins.shape))


@pytest.mark.parametrize("init_factor", [1, 3])
def test_init_stratified_one_point_per_bin(init_factor):
    R, D = 5, 4
    kw = dict(nlive=40, tol=1.0, init_factor=init_factor)
    n_id = (init_factor - 1) * 40
    jst = js.ns_init(random.key(2), lambda u, d: -jnp.sum(u**2, axis=-1),
                     None, D, R, JaxConfig(**kw), dtype=jnp.float64)
    tst = ts.ns_init(torch.Generator().manual_seed(2),
                     lambda u, d: -torch.sum(u**2, dim=-1), None, D, R,
                     NSConfig(**kw), torch.float64)
    for st in (jst, tst):
        pts = _initial_set(st.u, st.dead_u, n_id)
        assert pts.shape == (R, 40 + n_id, D)
        assert _one_per_bin(pts)
    # off: the port's set is its plain iid draw, which is not stratified
    kw["init_stratified"] = False
    gen = torch.Generator().manual_seed(2)
    tst = ts.ns_init(gen, lambda u, d: -torch.sum(u**2, dim=-1), None, D, R,
                     NSConfig(**kw), torch.float64)
    draw = torch.rand((40 + n_id, R, D), generator=torch.Generator()
                      .manual_seed(2), dtype=torch.float64).permute(1, 0, 2)
    pts = _initial_set(tst.u, tst.dead_u, n_id)
    np.testing.assert_array_equal(np.sort(pts, axis=1),
                                  np.sort(draw.numpy(), axis=1))
    assert not _one_per_bin(pts)


# ---------------------------------------------------------------------------
# (c) the analytic evidence at every knob, both modes


def _gauss_evidence(kw, segment_iters):
    D, sig = 4, 0.4

    def ll(u):
        x = (u - 0.5) * 8.0
        return -0.5 * torch.sum((x / sig) ** 2, dim=-1)

    lnz_true = D * (np.log(np.sqrt(2 * np.pi) * sig) - np.log(8.0))
    res = ts.run_nested(torch.Generator().manual_seed(3), ll, D, 8,
                        NSConfig(**kw), segment_iters=segment_iters)
    return res, lnz_true


def _forced(kw, segment_iters):
    kw = {**kw, "nlive": 2 * kw["nlive"], "tol": 0.5}
    kw.update({"cand_min_acc": 0.5} if segment_iters else {"cand_factor": 1})
    return kw


@pytest.mark.parametrize("segment_iters", [0, 250])
@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_gaussian_evidence_at_each_knob(name, kw, segment_iters):
    """The efr test's bars (``test_torch_sampler.py``: mean within 0.35,
    every run within 0.9) at nlive 2x the variant's, tol 0.5."""
    res, lnz_true = _gauss_evidence(_forced(kw, segment_iters),
                                    segment_iters)
    lnz = res.lnz.numpy()
    assert res.converged.all()
    assert abs(lnz.mean() - lnz_true) < 0.35, (lnz.mean(), lnz_true)
    assert np.max(np.abs(lnz - lnz_true)) < 0.9, (lnz, lnz_true)


def test_slice_cadence_is_inert_in_the_traced_mode():
    a, _ = _gauss_evidence(_forced(_combo_kw("0,1"), 0), 0)
    b, _ = _gauss_evidence(_forced(_combo_kw("0,2"), 0), 0)
    for f in ("lnz", "ncall", "n_dead", "dead_u"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    # ... and it acts in the kill+slice regime of the segmented mode
    a, _ = _gauss_evidence(_forced(_combo_kw("0,1"), 250), 250)
    b, _ = _gauss_evidence(_forced(_combo_kw("0,2"), 250), 250)
    assert not torch.equal(a.ncall, b.ncall)
