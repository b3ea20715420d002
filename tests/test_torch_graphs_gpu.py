"""The traced sampler's CUDA graphs against its eager blocks, on the
card.  Imports neither JAX nor ``nestfit_tpu``, so it runs on a GPU
machine without them::

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_graphs_gpu.py

Without a card every test skips (decided inside the test).
"""

import pytest
import torch

from nestfit_tpu_torch.sampling import NSConfig, graphs
from nestfit_tpu_torch.sampling import sampler as ts


def _gauss(sigma, mu=0.5):
    def loglike(u):
        return -0.5 * torch.sum((u - mu) ** 2, dim=-1) / sigma**2
    return loglike


@pytest.mark.gpu
def test_graph_matches_eager_on_the_card():
    """On a card, the captured blocks (each key's first block eager, then
    captured; replays after it) against the eager plain block loop from
    the same generator state, and a second call on the kept graphs: bit
    for bit, and the caller's generator left where the eager run leaves
    it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ndim, R = 4, 64
    cfg = NSConfig(nlive=100, tol=0.3)

    def ll2(u, _d):
        return _gauss(0.05)(u)

    out, gens, stats = [], [], []
    for run in (ts.ns_traced, graphs.run_traced, graphs.run_traced):
        gen = torch.Generator(device="cuda").manual_seed(5)
        st = ts.ns_init(gen, ll2, None, ndim, R, cfg)
        out.append(ts.ns_finalize(run(st, ll2, None, cfg), cfg))
        gens.append(gen.get_state())
        stats.append(graphs.last_stats)
    assert stats[1].replays > 0 and stats[1].captures > 0
    assert stats[2].replays > 0 and stats[2].captures == 0
    for res, state in zip(out[1:], gens[1:]):
        for f in ("lnz", "n_dead", "max_loglike", "dead_u", "ncall"):
            assert torch.equal(getattr(out[0], f), getattr(res, f)), f
        assert torch.equal(state, gens[0])
    graphs.clear()


@pytest.mark.gpu
def test_each_capture_has_one_timed_first_run_on_the_card():
    """A segmented run on the card records one ``graphs.first_run`` span
    (the key's eager run) for each ``ns.graph_captures``, each beside its
    ``graphs.capture``; a second call on the kept programs replays every
    unit and records none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nestfit_tpu_torch.utils.profiling import collect

    ndim, R = 3, 256
    cfg = NSConfig(nlive=20, tol=0.5, min_compact=64)
    sigma = torch.where(torch.arange(R, device="cuda") % 10 == 0,
                        0.01, 0.05).to(torch.float32)

    def ll2(u, data):
        return -0.5 * torch.sum((u - 0.5) ** 2, dim=-1) / data[0] ** 2

    def run():
        gen = torch.Generator(device="cuda").manual_seed(1)
        with collect() as tr:
            ts._run_nested(gen, ll2, ndim, R, cfg, torch.float32,
                           (sigma,), 8, True, None)
        torch.cuda.synchronize()
        return ([n for n, *_ in tr.spans if n == "graphs.first_run"],
                [n for n, *_ in tr.spans if n == "graphs.capture"],
                tr.counters)

    graphs.clear()
    first, captures, counters = run()
    assert len(first) == len(captures) == counters["ns.graph_captures"] > 0
    assert counters["ns.eager_steps"] == len(first)
    first, captures, counters = run()
    assert first == captures == []
    assert "ns.graph_captures" not in counters
    assert counters["ns.graph_steps"] > 0
    graphs.clear()
