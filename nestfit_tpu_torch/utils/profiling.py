"""Profiling and timing helpers (port of
``nestfit_tpu/utils/profiling.py``) on ``torch.profiler`` and CUDA
events."""

import contextlib
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir="/tmp/nestfit_trace"):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA when a
    card is present) and export a Chrome trace into ``log_dir``
    (``trace.json``, viewable in Perfetto).  Yields the profiler; the
    trace's path is ``<log_dir>/trace.json``."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
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
