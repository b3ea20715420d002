"""Run one cell of the benchmark of ``nestfit_tpu_torch`` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up makes the cell's inputs from the
seed, builds the kernels (into the checkout's cache) and prepares the
runners; the window then runs the fixed number of whole units of the
cell's entry that fits into ``--seconds`` (``core/window.py``);
afterwards the window's own outputs are held against the plain
reference (``core/check.py``).  The last line of standard output is one
JSON object: ``correct``, ``attempted`` and ``failed`` pixels, the
metrics (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics: the device ones from a trace of the window's last
unit, the host-timed ones from its other units), the device and, last,
each number compared with its limit, which also end standard error.

Without a CUDA card, or with fewer cards than the cell asks for, it
exits with code 2 and prints no result; it exits with code 3 if JAX or
the JAX package was loaded.
"""

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nestfit_tpu")


def process_start() -> float:
    """The process's start on the epoch clock (``/proc``), or now."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        btime = next(int(line.split()[1]) for line in
                     Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_PROC = process_start()


def cache_env(root: Path = ROOT):
    """Every build and kernel cache of the run at a fixed place inside
    the checkout."""
    cache = root / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Ctx:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_cell(cell, seed, seconds, trace=False, device="cuda",
             control_dtype=None, t_proc=None, log=print):
    """Set-up, window and check of one cell; returns ``(result dict,
    control numbers or None)``."""
    import numpy as np
    import torch

    from core import check, gen, manifest, program, roofline, window
    from core import trace as tr
    from reference import hyperfine

    t_proc = T_PROC if t_proc is None else t_proc
    config, traffic = cell.config, cell.traffic
    on_card = torch.device(device).type == "cuda"
    ss_data, ss_prog, ss_tap = np.random.SeedSequence(
        seed % 2**64).spawn(3)
    if on_card:
        program.build_kernels()
    n_units = window.units_for(seconds, float(traffic["unit_s"]))
    entry_cls = manifest.entry_class(traffic["entry"])
    inputs = gen.make_inputs(config, traffic,
                             entry_cls.pixels(config, traffic, n_units),
                             np.random.default_rng(ss_data), device)
    tap = program.Tap(np.random.default_rng(ss_tap))
    entry = entry_cls(config, inputs, ss_prog, device, tap)
    try:
        entry.prepare()
        card = None
        if on_card:
            torch.cuda.synchronize()
            if trace:
                card = roofline.card()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.time() - t_proc
        spans = tr.Spans()
        # a traced run profiles its last unit only; the host-timed
        # per-layer metrics read the others, which the profiler leaves
        # at full speed
        traced = n_units - 1 if trace else None
        dtrace = tr.DeviceTrace() if (trace and on_card) else None

        def unit(k):
            profiled = dtrace is not None and k == traced
            tap.spans = spans if profiled else None
            with dtrace.record() if profiled else contextlib.nullcontext():
                with spans.span(f"unit {k}"):
                    out = entry.unit(k)
                    if on_card:
                        torch.cuda.synchronize()
            return out

        win = window.run(unit, n_units)
        peak = torch.cuda.max_memory_allocated() if on_card else None
    finally:
        entry.close()
    if on_card:
        torch.cuda.empty_cache()
    if dtrace is not None and dtrace.t_host1 is None:
        dtrace = None           # the work ran out before the traced unit
    units = win.units
    pixels = sum(u["pixels"] for u in units)
    attempted = sum(u["attempted"] for u in units)
    failed = sum(u["failed"] for u in units)
    log(f"window: {len(units)} units, {pixels} px in {win.wall:.3f} s "
        f"(unit walls {[round(w, 3) for w in win.walls]}); set-up "
        f"{setup_s:.3f} s", file=sys.stderr)

    t0 = time.perf_counter()
    numbers, control, notes = check.judge(
        config, inputs, tap, units, traffic["entry"], device, control_dtype)
    limits = dict(config["limits"], **traffic.get("limits", {}))
    correct, rows = check.verdict(numbers, limits)
    for n in notes:
        log(f"check note: {n}", file=sys.stderr)
    log(f"check: {time.perf_counter() - t0:.3f} s", file=sys.stderr)

    axes = [hyperfine.make_axis(config["model"], tid, xarr)
            for tid, xarr, _ in inputs.spectra]
    ctx = Ctx(entry=traffic["entry"], window=win, units=units,
              untraced=[k for k in range(len(units)) if k != traced],
              pixels=pixels, setup_s=setup_s, peak_bytes=peak,
              trace=dtrace, card=card, tap=tap,
              n_model=gen.model_module(config).N_PARAMS,
              lines_x_channels=roofline.lines_x_channels(axes))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = manifest.metric_reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak or 0}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if dtrace is not None:
        dev["busy_s"] = dtrace.busy_s()
        dev["window_s"] = dtrace.wall
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in dtrace.by_name()[:10]],
            "idle_gaps": dtrace.idle_gaps(spans)}
        if card is not None:
            log(f"card: {card}", file=sys.stderr)
    result["checks"] = {k: {"value": float(v), "limit": float(lim)}
                        for k, v, lim in rows}
    for k, v, lim in rows:
        log(f"check {k} {float(v)!r} limit {float(lim)!r}", file=sys.stderr)
    return result, control


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    sys.path[:0] = [str(BENCH), str(ROOT)]
    import torch

    from core import manifest

    cell = manifest.find_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the port "
              "alone", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
