"""The reader of K1's likelihood launch counters on hand-made contexts:
the one-launch entry's share of both entries' launches over the untraced
batches; a program that counts neither reads None."""

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


def test_lnl_fused_share_reads_the_untraced_batches():
    read = manifest.metric_reader("lnl_fused_share.cube").read
    units = [_unit({"k1.lnl_fused": 990, "k1.lnl_split": 10}),
             {"batch": None},                  # the pass was over
             _unit({"k1.lnl_fused": 1000}),
             _unit({"k1.lnl_split": 5000})]    # the traced unit
    assert read(_ctx(units, traced=3)) == pytest.approx(99.5)
    split = [_unit({"k1.lnl_split": 800, "ns.iterations": 40})] * 3
    assert read(_ctx(split, traced=2)) == 0.0
    parent = [_unit({"ns.iterations": 500})] * 3
    assert read(_ctx(parent, traced=2)) is None
    assert read(SimpleNamespace(entry="batch")) is None
