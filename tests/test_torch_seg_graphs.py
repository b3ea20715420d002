"""The segmented loop's units on kept static programs
(``graphs.SegmentedRun``) against the plain eager loop (``capture=False``),
on the CPU, where the static programs run without capture: the loads,
the copies back, the deferred writes into the run's dead buffers and
the clones out of the program are held bit for bit.  The CUDA graph
path is held against the eager loop on the card in
``tests/test_torch_seg_graphs_gpu.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nestfit_tpu_torch.sampling import graphs
from nestfit_tpu_torch.sampling import sampler as ts
from nestfit_tpu_torch.utils.profiling import collect

NDIM, R = 3, 256

#: every case: the NSConfig and what its run must show
CASES = {
    "compact": {},
    "probe": {"cand_min_acc": 0.5, "switch_back_margin": 0.01,
              "switch_back_every": 8, "kill_k": 4},
    "slice": {"method": "slice"},
    "ceff": {"ceff": True},
    "second_call": {},
}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _sigma(seed):
    """Per-run widths: one run in ten narrow, so most runs finish early
    and the stragglers are compacted (R 256 -> 64)."""
    rng = np.random.default_rng(seed)
    narrow = np.arange(R) % 10 == 0
    return np.where(narrow, 0.01, 0.05) * rng.uniform(0.9, 1.1, R)


def _loglike(u, data):
    return -0.5 * torch.sum((u - 0.5) ** 2, dim=-1) / data[0] ** 2


def _run(capture, cfg, sigma, seed=1):
    gen = torch.Generator().manual_seed(seed)
    with collect() as tr:
        res = ts._run_nested(gen, _loglike, NDIM, R, cfg, torch.float64,
                             (torch.as_tensor(sigma),), 8, True, None,
                             capture=capture)
    return res, gen.get_state(), tr


def _equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("case", list(CASES))
def test_static_segmented_loop_equals_plain_loop(case):
    """Bit for bit: lnZ, the dead points, the calls, the convergence
    flags and the caller's generator state, on runs that compact, switch
    to the kill+slice regime and back, run ``method="slice"`` and
    ``ceff``; and a second call on the kept program, with other data,
    leaves the first call's result as it was."""
    graphs.clear()
    cfg = ts.NSConfig(**({"nlive": 20, "tol": 0.5, "min_compact": 64}
                         | CASES[case]))
    sigma = _sigma(0)
    plain, gen_plain, _ = _run(False, cfg, sigma)
    static, gen_static, tr = _run(True, cfg, sigma)
    _equal(plain, static)
    assert torch.equal(gen_plain, gen_static)
    assert not static.lnz.isnan().any()
    modes = [a["mode"] for n, _t0, _t1, _d, a in tr.spans
             if n == "ns.segment"]
    compactions = [(a["rows_from"], a["rows_to"])
                   for n, _t0, _t1, _d, a in tr.spans if n == "ns.compact"]
    if case in ("compact", "second_call"):
        assert compactions == [(256, 64)], compactions
    if case == "probe":
        back = [m for k, m in enumerate(modes[1:])
                if m == "cand" and "slice" in modes[:k + 1]]
        assert back and any(n == "ns.probe" for n, *_ in tr.spans), modes
    if case == "slice":
        assert set(modes) == {"slice"}
    # one kept program per compaction class, both regimes in it
    assert len(graphs._SEG_PROGRAMS) == 1 + len(compactions)
    if case != "second_call":
        return
    kept = dict(graphs._SEG_PROGRAMS)
    sigma_b = _sigma(1)
    again, gen_again, _ = _run(True, cfg, sigma_b, seed=2)
    assert graphs._SEG_PROGRAMS == kept     # the same programs, reused
    _equal(plain, static)                   # the first result unchanged
    plain_b, gen_plain_b, _ = _run(False, cfg, sigma_b, seed=2)
    _equal(plain_b, again)
    assert torch.equal(gen_plain_b, gen_again)
    assert not torch.equal(again.lnz, static.lnz)
    graphs.clear()
    assert not graphs._SEG_PROGRAMS


def test_a_runner_on_a_shared_prior_keeps_the_prior_tables():
    """A graph reads the prior tables by address, and the cube ladder
    builds a runner for each batch size on one prior transformer, which
    each runner moves to its device in place: on the device it is on
    already, every table stays the very tensor it was."""
    from nestfit_tpu_torch.models import DiazenyliumRunner, diazenylium
    from nestfit_tpu_torch.models.tables import DIAZENYLIUM_TRANSITIONS
    from nestfit_tpu_torch.priors import get_diazenylium_priors
    from nestfit_tpu_torch.utils import freq_axis_from_velocity

    utrans = get_diazenylium_priors(device="cpu")

    def tables():
        dists = [p.dist for p in utrans.priors
                 if getattr(p, "dist", None) is not None]
        return [getattr(d, f) for d in dists for f in
                ("xax", "pdf", "cdf", "ppf", "cells", "dx_t")]

    xarr = freq_axis_from_velocity(np.arange(-20, 20, 0.1),
                                   DIAZENYLIUM_TRANSITIONS[0].nu)
    before = tables()
    for rows in (4, 1):
        spec = diazenylium.make_diazenylium_spectrum(
            xarr, np.zeros((rows, xarr.size)), np.full(rows, 0.1),
            trans_id=1, device="cpu")
        DiazenyliumRunner(spec, utrans, ncomp=2, device="cpu")
    after = tables()
    assert len(before) == len(after) > 0
    assert all(a is b for a, b in zip(before, after))
