"""The readers of the program's spans and counters on hand-made
contexts: host reads and device operations per sampler iteration, and
the device's idle share inside the sampler's spans (a gap that straddles
a span's edge counts only inside it).  A program that keeps no batch
trace, or a traced unit with no device operation, reads None."""

from types import SimpleNamespace

import pytest

from core import manifest, readings
from core.trace import DeviceTrace

MS = 1_000_000     # ns


def _trace(spans=(), counters=None, syncs=None):
    return SimpleNamespace(spans=list(spans), counters=counters or {},
                           syncs=syncs or {})


def _unit(tr):
    return {"batch": SimpleNamespace(trace=tr)}


def _ctx(units, traced, kernels=None, wall=1.0):
    dtrace = None
    if kernels is not None:
        dtrace = DeviceTrace()
        dtrace.kernels = [("k", s, d) for s, d in kernels]
        dtrace.t_host0, dtrace.t_host1 = 0.0, wall
    return SimpleNamespace(
        entry="cube", units=units, trace=dtrace,
        untraced=[k for k in range(len(units)) if k != traced])


def _read(name, ctx):
    return manifest.metric_reader(name).read(ctx)


def test_host_syncs_per_iter_reads_the_untraced_batches():
    units = [
        _unit(_trace(counters={"ns.iterations": 100},
                     syncs={"ns.done": (10, 5), "ns.running": (30, 9),
                            "cube.lnz": (4, 1)})),
        {"batch": None},                       # the pass was over
        _unit(_trace(counters={"ns.iterations": 300},
                     syncs={"ns.fill_need": (20, 2)})),
        _unit(_trace(counters={"ns.iterations": 7},     # the traced unit
                     syncs={"ns.done": (1000, 1)})),
    ]
    assert _read("host_syncs_per_iter.cube", _ctx(units, traced=3)) == \
        pytest.approx(60 / 400)
    parent = [{"batch": SimpleNamespace(rungs=[])}] * 3
    assert _read("host_syncs_per_iter.cube", _ctx(parent, traced=2)) is None


def test_launches_per_iter_reads_the_traced_unit():
    units = [_unit(_trace(counters={"ns.iterations": 1000})),
             _unit(_trace(counters={"ns.iterations": 40}))]
    kernels = [(float(k), 1.0) for k in range(120)]
    assert _read("launches_per_iter.cube",
                 _ctx(units, traced=1, kernels=kernels)) == pytest.approx(3.0)
    assert _read("launches_per_iter.cube",
                 _ctx(units, traced=1, kernels=[])) is None
    assert _read("launches_per_iter.cube", _ctx(units, traced=1)) is None
    parent = [{"batch": SimpleNamespace(rungs=[])}] * 2
    assert _read("launches_per_iter.cube",
                 _ctx(parent, traced=1, kernels=kernels)) is None


def test_sampler_idle_share_counts_only_the_idle_inside_the_spans():
    spans = [("cube.batch", 0, 1000 * MS, 0, {}),
             ("fit.sampler", 100 * MS, 400 * MS, 2, {}),
             ("ns.segment", 120 * MS, 300 * MS, 3, {}),
             ("fit.sampler", 600 * MS, 800 * MS, 2, {})]
    # device intervals (us): one straddles the first span's start, one
    # its end, one the second span's end
    kernels = [(50e3, 100e3), (200e3, 50e3), (380e3, 70e3), (700e3, 200e3)]
    ctx = _ctx([_unit(_trace()), _unit(_trace(spans))], traced=1,
               kernels=kernels, wall=1.0)
    share = _read("sampler_idle_share.cube", ctx)
    # inside [100, 400] ms the device covers 50 + 50 + 20 ms; inside
    # [600, 800] ms it covers 100 ms: 180 + 100 ms idle of a 1 s wall
    assert share == pytest.approx(28.0)
    assert share <= readings.device_idle(ctx) == pytest.approx(58.0)
    assert _read("sampler_idle_share.cube",
                 _ctx([_unit(_trace()), _unit(_trace(spans))], traced=1,
                      kernels=[])) is None
    parent = [{"batch": SimpleNamespace(rungs=[])}] * 2
    assert _read("sampler_idle_share.cube",
                 _ctx(parent, traced=1, kernels=kernels)) is None


def test_the_readers_skip_other_entries():
    ctx = SimpleNamespace(entry="batch", units=[], untraced=[], trace=None)
    for name in ("host_syncs_per_iter.cube", "launches_per_iter.cube",
                 "sampler_idle_share.cube"):
        assert _read(name, ctx) is None
