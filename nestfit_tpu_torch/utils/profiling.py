"""Profiling and timing helpers (port of
``nestfit_tpu/utils/profiling.py``) on ``torch.profiler`` and CUDA
events, and the port's span-and-counter recorder.

The recorder times the cube ladder, the fit orchestration and the
sampler from where their work happens:

- ``span(name, **attrs)``: a context manager, one timed range;
- ``count(name, n=1, **attrs)``: add to a counter (and to its share
  under the attributes ``attrs``);
- ``to_host(x, site)``: read a device tensor on the host (a NumPy
  array), counting the read under ``site`` and adding the time the host
  waited in it (the launch queue drains first);
- ``device_counter(name, device)``: a counter that kernels add to on the
  device, and ``read_device_counters(device)``: count what they gained
  since their last read (a caller reads them where the launch queue is
  already drained);
- ``collect()``: a context manager that yields the ``Trace`` of
  everything its thread recorded inside it.

With no ``collect()`` active on the thread the three cost one
thread-local lookup and record nothing (a span still stamps its own
ends, and ``to_host`` still reads).  The
stamps are :func:`now_ns`, the clock ``torch.profiler`` stamps its
events with, so the spans sit on a device trace without alignment.
While :func:`trace` exports a Chrome trace, each span also enters a
``torch.profiler.record_function`` range of its name.
"""

import contextlib
import threading
import time

import numpy as np
import torch


class _Local(threading.local):
    trace = None   # the thread's innermost collect() Trace


_local = _Local()
_exporting = 0     # trace() blocks active in the process
_DEVICE_COUNTERS = {}   # device -> {name: [int64 tensor, value last read]}
_DEVICE_LOCK = threading.Lock()


def now_ns() -> int:
    """The recorder's clock: unix time in ns, the clock of
    ``torch.profiler``'s event stamps (kineto converts its approximate
    clock to unix time, ``_ApproximateClockToUnixTimeConverter``, for
    host events and, through the CUPTI timestamp callback, for device
    kernels alike)."""
    return time.time_ns()


class Trace:
    """What one :func:`collect` block recorded on its thread.

    ``spans``: ``(name, t0_ns, t1_ns, depth, attrs)`` in start order
    (``depth`` 0 is outermost within the block); ``counters``: name ->
    total; ``tagged``: ``(name, ((attr, value), ...))`` -> the share of
    that total counted with those attributes; ``syncs``: site ->
    ``(count, wait_ns)`` of the host reads."""

    def __init__(self):
        self.spans = []
        self.counters = {}
        self.tagged = {}
        self.syncs = {}
        self._depth = 0

    def _absorb(self, inner: "Trace"):
        """Add an inner block's records, nested at this one's depth."""
        d = self._depth
        self.spans.extend((n, t0, t1, depth + d, a)
                          for n, t0, t1, depth, a in inner.spans)
        for k, v in inner.counters.items():
            self.counters[k] = self.counters.get(k, 0) + v
        for k, v in inner.tagged.items():
            self.tagged[k] = self.tagged.get(k, 0) + v
        for k, (c, w) in inner.syncs.items():
            c0, w0 = self.syncs.get(k, (0, 0))
            self.syncs[k] = (c0 + c, w0 + w)


class _Span:
    """One range: stamped on enter and exit, put in the thread's trace
    when one collects and, while :func:`trace` exports, into a
    ``record_function``."""

    __slots__ = ("_trace", "name", "attrs", "t0_ns", "t1_ns", "_slot",
                 "_depth", "_rf")

    def __init__(self, tr, name, attrs):
        self._trace, self.name, self.attrs = tr, name, attrs
        self.t0_ns = self.t1_ns = self._rf = None

    @property
    def seconds(self):
        return (self.t1_ns - self.t0_ns) / 1e9

    def set(self, **attrs):
        """Add attributes known only inside the range."""
        self.attrs.update(attrs)

    def __enter__(self):
        if _exporting:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        tr = self._trace
        if tr is not None:
            self._depth = tr._depth
            tr._depth += 1
            self._slot = len(tr.spans)
            tr.spans.append(None)
        self.t0_ns = now_ns()
        return self

    def __exit__(self, *exc):
        self.t1_ns = now_ns()
        tr = self._trace
        if tr is not None:
            tr._depth -= 1
            tr.spans[self._slot] = (self.name, self.t0_ns, self.t1_ns,
                                    self._depth, self.attrs)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name: str, /, **attrs):
    """A timed range ``name`` with attributes ``attrs``; the context
    manager yields the span, whose ``seconds`` is its length once it has
    closed.  It always stamps; only a ``collect()`` keeps it."""
    return _Span(_local.trace, name, attrs)


def count(name: str, n=1, /, **attrs):
    """Add ``n`` to the counter ``name``, and with ``attrs`` to its share
    under those attributes (``Trace.tagged``)."""
    tr = _local.trace
    if tr is not None:
        tr.counters[name] = tr.counters.get(name, 0) + n
        if attrs:
            key = (name, tuple(sorted(attrs.items())))
            tr.tagged[key] = tr.tagged.get(key, 0) + n


def to_host(x: torch.Tensor, site: str):
    """The tensor ``x`` as a NumPy array on the host, the read counted
    under ``site`` with the time it took."""
    tr = _local.trace
    if tr is None:
        return x.cpu().numpy()
    t0 = now_ns()
    out = x.cpu().numpy()
    wait = now_ns() - t0
    c, w = tr.syncs.get(site, (0, 0))
    tr.syncs[site] = (c + 1, w + wait)
    return out


def _device_key(device) -> str:
    """``device`` as a key: a CUDA device without an index is the current
    one."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def device_counter(name: str, device) -> torch.Tensor:
    """The counter ``name`` on ``device``: a ``[1]`` int64 tensor that
    kernels add to (as unsigned 64-bit atomics), made once and kept for
    the process, so a captured graph may hold its address."""
    key = _device_key(device)
    with _DEVICE_LOCK:
        entry = _DEVICE_COUNTERS.setdefault(key, {}).get(name)
        if entry is None:
            entry = _DEVICE_COUNTERS[key][name] = [
                torch.zeros((1,), dtype=torch.int64, device=device), 0]
        return entry[0]


def read_device_counters(device):
    """Add to each counter what its :func:`device_counter` on ``device``
    gained since its last read: a host read each (site
    ``device_counters``), whether or not a :func:`collect` records.
    Several threads on one device share its counters: each read counts
    what all of them added since the last."""
    with _DEVICE_LOCK:
        for name, entry in _DEVICE_COUNTERS.get(_device_key(device),
                                                {}).items():
            value = int(to_host(entry[0], "device_counters")[0])
            count(name, value - entry[1])
            entry[1] = value


@contextlib.contextmanager
def collect():
    """Record this thread's spans, counters and host reads while the
    block runs; yields the ``Trace``.  A block inside another keeps its
    own records and adds them to the outer one's when it closes."""
    outer = _local.trace
    tr = _local.trace = Trace()
    try:
        yield tr
    finally:
        _local.trace = outer
        if outer is not None:
            outer._absorb(tr)


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA when a
    card is present) and export a Chrome trace into ``log_dir``
    (``trace.json``, viewable in Perfetto), with the program's spans as
    ranges above the operations they launched.  Yields the profiler."""
    global _exporting
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        _exporting += 1
        try:
            yield prof
        finally:
            _exporting -= 1
    prof.export_chrome_trace(str(path / "trace.json"))


def time_fn(fn, *args, n_repeat=10, warmup=2, **kwargs):
    """Median seconds of one ``fn(*args, **kwargs)`` after ``warmup``
    calls.  When an argument is a CUDA tensor each call is timed with
    CUDA events on its device's current stream (the kernels' time, gaps
    between them included); otherwise with ``time.perf_counter``."""
    device = next((a.device for a in (*args, *kwargs.values())
                   if isinstance(a, torch.Tensor) and a.is_cuda), None)
    for _ in range(warmup):
        fn(*args, **kwargs)
    if device is not None:
        torch.cuda.synchronize(device)
    times = []
    for _ in range(n_repeat):
        if device is not None:
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            fn(*args, **kwargs)
            end.record(stream)
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def profile_predict(runner, ncomp=None, batch=1024, n_repeat=10, seed=0):
    """Time the runner's likelihood from the unit cube
    (``loglike_unit``: prior transform, model and chi-square) on
    ``batch`` uniform points, on the runner's device.  ``ncomp`` must be
    the runner's own."""
    ncomp = ncomp or runner.ncomp
    if ncomp != runner.ncomp:
        raise ValueError(f"the runner fits ncomp={runner.ncomp}, not {ncomp}")
    gen = torch.Generator(device=runner.device)
    gen.manual_seed(seed)
    # the points broadcast against the spectra's pixel rows
    data = runner.spectra[0].data
    n_rows = data.shape[0] if data.ndim > 1 else 1
    if batch % n_rows:
        raise ValueError(f"batch {batch} is no multiple of the runner's "
                         f"{n_rows} pixel rows")
    u = torch.rand((batch // n_rows, n_rows, runner.n_model * ncomp),
                   generator=gen, device=runner.device)
    dt = time_fn(runner.loglike_unit, u, n_repeat=n_repeat)
    return {"batch": batch, "sec_per_call": dt, "evals_per_sec": batch / dt}
