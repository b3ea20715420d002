"""The reader of K1's lane counters on hand-made contexts: the live
rows' share of the rows over the untraced batches; a program that counts
no rows (one before the live-lane mask) reads None."""

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


def test_k1_live_share_reads_the_untraced_batches():
    read = manifest.metric_reader("k1_live_share.cube").read
    units = [_unit({"k1.lanes": 1000, "k1.lanes_live": 300}),
             {"batch": None},                  # the pass was over
             _unit({"k1.lanes": 3000, "k1.lanes_live": 1300}),
             _unit({"k1.lanes": 5000, "k1.lanes_live": 5000})]  # traced
    assert read(_ctx(units, traced=3)) == pytest.approx(40.0)
    unmasked = [_unit({"k1.lanes": 800, "k1.lanes_live": 800})] * 3
    assert read(_ctx(unmasked, traced=2)) == 100.0
    parent = [_unit({"k1.lnl_fused": 500, "ns.iterations": 50})] * 3
    assert read(_ctx(parent, traced=2)) is None
    assert read(SimpleNamespace(entry="batch")) is None
