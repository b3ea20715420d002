"""The reader of the sampler's graph-replay counters on hand-made
contexts: replays over all units of the untraced batches; a program
that counts neither reads None."""

from types import SimpleNamespace

import pytest

from core import manifest


def _unit(counters):
    return {"batch": SimpleNamespace(
        trace=SimpleNamespace(spans=[], counters=counters, syncs={}))}


def _ctx(units, traced):
    return SimpleNamespace(
        entry="cube", units=units, trace=None,
        untraced=[k for k in range(len(units)) if k != traced])


def test_graph_step_share_reads_the_untraced_batches():
    read = manifest.metric_reader("graph_step_share.cube").read
    units = [_unit({"ns.graph_steps": 570, "ns.eager_steps": 30}),
             {"batch": None},                  # the pass was over
             _unit({"ns.graph_steps": 396, "ns.eager_steps": 4}),
             _unit({"ns.eager_steps": 1000})]  # the traced unit
    assert read(_ctx(units, traced=3)) == pytest.approx(96.6)
    parent = [_unit({"ns.iterations": 500})] * 3
    assert read(_ctx(parent, traced=2)) is None
    assert read(SimpleNamespace(entry="batch")) is None
