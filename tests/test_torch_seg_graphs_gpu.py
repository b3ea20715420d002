"""The segmented loop's units as CUDA graph replays against the same
loop run eagerly (``capture=False``), on the card.  Imports neither JAX
nor ``nestfit_tpu``, so it runs on a GPU machine without them::

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_seg_graphs_gpu.py

Without a card every test skips (decided inside the test).
"""

import dataclasses

import pytest
import torch

from nestfit_tpu_torch.sampling import graphs
from nestfit_tpu_torch.sampling import sampler as ts
from nestfit_tpu_torch.utils.profiling import collect

from test_torch_seg_graphs import CASES, NDIM, R, _loglike, _sigma


def _run(capture, cfg, sigma, seed=1):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    data = (torch.as_tensor(sigma, dtype=torch.float32, device="cuda"),)
    with collect() as tr:
        res = ts._run_nested(gen, _loglike, NDIM, R, cfg, torch.float32,
                             data, 8, True, None, capture=capture)
    torch.cuda.synchronize()
    return res, gen.get_state(), tr.counters


def _equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_seg_graphs_match_eager_on_the_card(case):
    """On a card, the captured units (each key's first run eager, then
    replays) against the eager loop from the same generator state, bit
    for bit, and the caller's generator left where the eager run leaves
    it; a second call on the kept programs captures nothing new."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    graphs.clear()
    cfg = ts.NSConfig(**({"nlive": 20, "tol": 0.5, "min_compact": 64}
                         | CASES[case]))
    sigma = _sigma(0)
    eager, gen_eager, c_eager = _run(False, cfg, sigma)
    graph, gen_graph, c_graph = _run(True, cfg, sigma)
    _equal(eager, graph)
    assert torch.equal(gen_eager, gen_graph)
    assert c_eager.get("ns.graph_steps", 0) == 0
    assert c_graph.get("ns.graph_steps", 0) > 0
    assert c_graph.get("ns.graph_captures", 0) > 0
    assert c_graph["ns.graph_steps"] > c_graph["ns.eager_steps"]
    again, gen_again, c_again = _run(True, cfg, sigma)
    _equal(eager, again)
    assert torch.equal(gen_eager, gen_again)
    assert c_again.get("ns.graph_captures", 0) == 0
    assert c_again.get("ns.eager_steps", 0) == 0
    if case == "second_call":
        sigma_b = _sigma(1)
        eager_b, gen_eager_b, _ = _run(False, cfg, sigma_b, seed=2)
        graph_b, gen_graph_b, _ = _run(True, cfg, sigma_b, seed=2)
        _equal(eager_b, graph_b)
        assert torch.equal(gen_eager_b, gen_graph_b)
        _equal(eager, graph)    # the first call's result unchanged
    graphs.clear()


@pytest.mark.gpu
def test_seg_graphs_survive_a_runner_built_on_the_same_prior():
    """The cube ladder's order on the card: a run's graphs captured, a
    runner of another batch size built on the same prior transformer and
    run, then the first runner again, replaying its graphs: bit for bit
    with the eager loop (the prior tables the graphs read stay put)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from nestfit_tpu_torch.models import DiazenyliumRunner, diazenylium
    from nestfit_tpu_torch.models.tables import DIAZENYLIUM_TRANSITIONS
    from nestfit_tpu_torch.priors import get_diazenylium_priors
    from nestfit_tpu_torch.sampling.fit import _loglike2_for
    from nestfit_tpu_torch.utils import freq_axis_from_velocity

    graphs.clear()
    utrans = get_diazenylium_priors(device="cuda")
    xarr = freq_axis_from_velocity(np.arange(-20, 20, 0.1),
                                   DIAZENYLIUM_TRANSITIONS[0].nu)
    rng = np.random.default_rng(0)

    def runner(rows):
        data = rng.normal(scale=0.1, size=(rows, xarr.size))
        data[:, 190:210] += 1.0
        spec = diazenylium.make_diazenylium_spectrum(
            xarr, data, np.full(rows, 0.1), trans_id=1, device="cuda")
        r = DiazenyliumRunner(spec, utrans, ncomp=2, device="cuda")
        return r, r.data_tree()

    def both(r, data, seed):
        cfg = ts.NSConfig(nlive=20, tol=1.0, flat_dims=tuple(
            utrans.flat_dims(2)))
        out = []
        for capture in (True, False):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            out.append(ts._run_nested(
                gen, _loglike2_for(r, torch.float32), r.ndim,
                data[0][0].shape[0], cfg, torch.float32, data, 8, True,
                None, capture=capture))
        _equal(*out)

    first, data = runner(64)
    both(first, data, 1)
    both(*runner(4), 2)
    both(first, data, 3)
    graphs.clear()
