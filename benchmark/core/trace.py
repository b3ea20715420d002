"""The device trace of a window's unit: ``torch.profiler`` with CUDA
activity only, read in memory (nothing is written).

From the trace: every device kernel's name, start and length; the
union of their intervals (the device's busy time); the idle gaps
between them, each named by the harness span the host was in; the
kernels that took most time.  Host spans are the window's units and the
program's ``fit_batch`` calls, timed on the host's clock and placed on
the trace's clock by the first kernel of the window.
"""

import contextlib
import time

import numpy as np


class Spans:
    """Host spans ``(name, t0, t1)`` on ``time.perf_counter``."""

    def __init__(self):
        self.items = []

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))

    def at(self, t):
        """The innermost span that holds host time ``t``."""
        best = None
        for name, t0, t1 in self.items:
            if t0 <= t <= t1 and (best is None or t1 - t0 < best[1]):
                best = (name, t1 - t0)
        return best[0] if best else "between units"


class DeviceTrace:
    def __init__(self):
        self.kernels = []          # (name, start_us, dur_us)
        self.t_host0 = self.t_host1 = None

    @contextlib.contextmanager
    def record(self):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            self.t_host0 = time.perf_counter()
            yield self
            self.t_host1 = time.perf_counter()
        self.kernels = _kernels(prof)

    @property
    def wall(self):
        """Seconds of the traced span, on the host's clock."""
        return self.t_host1 - self.t_host0

    def busy_s(self):
        return _union(self.kernels) / 1e6

    def by_name(self):
        tot = {}
        for name, _s, d in self.kernels:
            tot[name] = tot.get(name, 0.0) + d / 1e6
        return sorted(tot.items(), key=lambda kv: -kv[1])

    def idle_gaps(self, spans, top=10):
        """The ``top`` longest gaps ``(span name, seconds)``."""
        if not self.kernels:
            return []
        iv = sorted((s, s + d) for _n, s, d in self.kernels)
        origin = iv[0][0]
        gaps, end = [], iv[0][1]
        for s, e in iv[1:]:
            if s > end:
                gaps.append((end, s - end))
            end = max(end, e)
        gaps.sort(key=lambda g: -g[1])
        return [[spans.at(self.t_host0 + (g0 - origin + g / 2) / 1e6),
                 g / 1e6] for g0, g in gaps[:top]]


def _kernels(prof):
    """Device kernels ``(name, start_us, dur_us)`` of a finished
    profile, read from the raw events (no event tree is built)."""
    out = []
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        dur = e.duration_ns() / 1e3
        if dur <= 0:
            continue
        out.append((e.name(), e.start_ns() / 1e3, dur))
    return out


def _union(kernels):
    """Length of the union of the kernels' intervals (us)."""
    if not kernels:
        return 0.0
    iv = np.array(sorted((s, s + d) for _n, s, d in kernels))
    total, lo, hi = 0.0, iv[0, 0], iv[0, 1]
    for s, e in iv[1:]:
        if s > hi:
            total += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return total + hi - lo
