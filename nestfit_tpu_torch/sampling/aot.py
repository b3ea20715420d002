"""Prepare a fit before its first batch (port of
``nestfit_tpu/sampling/aot.py``).

The JAX module compiles the XLA programs of a segmented fit in a thread
pool and installs them in the sampler's caches.  There is no XLA here: a
first ``fit_batch`` call on the card pays instead for the kernel build
(``ops/_build.build_all``), PyTorch's lazily loaded linear-algebra
library, the runner's device tables (K1's line tables, the kernels'
libraries and launchers), and, in the traced mode (``segment_iters=0``)
only, the program of ``sampling/graphs.py``: its static state, an eager
warm-up block and one captured CUDA graph per block key.
:func:`build_plan` lists that work as tasks, :func:`compile_plan` does
it, and a later ``fit_batch`` with the same runner, batch, config and
dtype finds its traced program warm and only replays it.

What each program kind of the JAX plan becomes:

=====================  ===============================================
JAX program            port task
=====================  ===============================================
(every program)        ``build``: ``_build.build_all()``; a library
                       already in ``_build/`` under its hash name is a
                       cache hit, a compiled one a miss (card only)
(first dispatch)       ``warm@<device>``: the linear-algebra library,
                       the kernels' libraries and one likelihood call
                       of the runner on its own data (its device tables)
``init@R``             eager, nothing to prepare
``cand@R``             not prepared: ``graphs.SegmentedRun`` captures
                       the candidate iteration and the slice fill as
                       CUDA graphs at first use, in the fit
``slice@R``            not prepared: the kill+slice iteration, captured
                       at first use likewise
``fin@R``              eager, nothing to prepare
``rebuild@R``          eager, nothing to prepare
``finalize@R``         eager, nothing to prepare
``slice@c`` classes    not prepared: each compaction class's units are
                       captured at first use likewise
(traced mode)          ``<label>:traced@R``: the program of ``graphs``
                       on the state ``ns_init`` gives for the runner's
                       own data, its warm-up block, and the graph of
                       every key ``(i0 % bound_every, block_iters)`` the
                       run meets (they repeat with period
                       ``lcm(block_iters, bound_every)`` in ``i0``)
=====================  ===============================================

The keywords of the JAX ``build_plan`` that select segmented programs
(``n_post``, ``r_classes``, ``kinds_full``, ``kinds_classes``, and
``data`` in the segmented mode) are accepted and warn: those programs
are captured at first use, in the fit, and the plan prepares nothing
for them.  ``compile_plan`` takes ``max_workers`` and leaves it unused:
the tasks run in order.

Deliberate departures from the JAX module:

- A failed build or capture raises.  JAX records a failed compile as a
  non-fatal error and compiles lazily later; on the card the lazy path
  would fail the same way, so ``n_errors`` stays 0.
- The tasks run one after another: captures take
  ``graphs._CAPTURE_LOCK`` one at a time, and ``build_all`` already runs
  one ``nvcc`` per source in parallel.
- ``timeout`` bounds the phase: tasks not started by then are reported
  as ``n_abandoned``, and their programs are prepared at first use, the
  normal path.
- ``graphs`` keeps ``_PROGRAMS_CAP`` traced programs per dp row; a plan
  that would install more on one row would evict its own programs, and
  ``compile_plan`` raises on it.

A prepared traced program holds its static state until
``graphs.clear()``: its dead-point buffers alone are
``R * (max_iter + nlive) * D`` float32 values.  Its key is that of
``graphs.program_key``: a runner rebuilt between plan and fit, a config
that ``NSConfig.resolved`` changes, or data of another dtype or shape
misses it and the fit prepares its own program, as without a plan.
"""

import dataclasses
import math
import warnings
from typing import Callable

import torch

from nestfit_tpu_torch.device import resolve_device
from nestfit_tpu_torch.ops import _build
from nestfit_tpu_torch.sampling import graphs
from nestfit_tpu_torch.sampling import sampler as _s
from nestfit_tpu_torch.utils.profiling import now_ns, span

_UNSET = object()
# the JAX build_plan's keywords that select segmented programs
_SEGMENTED_KW = ("n_post", "r_classes", "kinds_full", "kinds_classes")


@dataclasses.dataclass
class _Task:
    name: str
    key: tuple            # tasks with one key are prepared once
    run: Callable[[], dict]
    device: torch.device
    graph_keys: tuple = ()  # traced: the (i0 % bound_every, n_iters) keys


def _build_task() -> dict:
    hits = sum(_build._lib_path(s).exists() for s in _build.SOURCES)
    _build.build_all()
    return {"cache_hits": hits, "cache_misses": len(_build.SOURCES) - hits}


def _warm_task(runner, dtype) -> dict:
    from nestfit_tpu_torch.parallel import mesh

    dev = runner.device
    if dev.type == "cuda":
        mesh._warm(runner.spectra[0].dnu.device)
        for src in _build.SOURCES:
            _build.load(src)
    data = runner.spectra[0].data
    rows = data.shape[0] if data.ndim > 1 else 1
    u = torch.full((rows, runner.ndim), 0.5, dtype=dtype, device=dev)
    runner.loglike_unit(u)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {}


def _traced_blocks(cfg):
    """``(i0, n_iters)`` of one period of the run's full blocks after its
    first: ``i0 = k * block_iters`` for ``k = 1 .. lcm / block_iters``
    (the lazy path captures at these ``i0``; ``sampler._traced_block``
    reads ``i`` only as ``i % bound_every``)."""
    block, be = max(1, cfg.block_iters), max(1, cfg.bound_every)
    period = block * be // math.gcd(block, be)
    return tuple((k * block, block) for k in range(1, period // block + 1)
                 if (k + 1) * block <= cfg.max_iter)


def _traced_task(runner, n_runs, cfg, dtype, loglike2, data, blocks,
                 key) -> dict:
    gen = torch.Generator(device=runner.device)   # throwaway
    gen.manual_seed(0)
    state = _s.ns_init(gen, loglike2, data, runner.ndim, n_runs, cfg, dtype)
    stats = graphs.prepare(state, loglike2, data, cfg, blocks, key)
    return {"warmups": stats.warmups, "captures": stats.captures}


def build_plan(runner, n_runs, config=None, *, n_post=_UNSET,
               dtype=torch.float32, data=None, r_classes=_UNSET,
               kinds_full=_UNSET, kinds_classes=_UNSET, label=None,
               segment_iters=250, device="cuda"):
    """The tasks that prepare one ``fit_batch(gen, runner, n_runs, config,
    dtype=dtype, segment_iters=segment_iters, device=device)`` call:
    ``build`` (on a card), ``warm@<device>``, and in the traced mode
    ``<label>:traced@<n_runs>`` (module docstring).  ``data=None`` is the
    runner's own data, the only data the traced mode fits."""
    from nestfit_tpu_torch.sampling import fit as _fit
    from nestfit_tpu_torch.sampling.sampler import NSConfig

    given = dict(n_post=n_post, r_classes=r_classes, kinds_full=kinds_full,
                 kinds_classes=kinds_classes)
    named = [k for k in _SEGMENTED_KW if given[k] is not _UNSET]
    traced = not (segment_iters and segment_iters > 0)
    if data is not None:
        if traced:
            raise ValueError("data substitution needs segment_iters > 0; "
                             "the traced mode fits the runner's own spectra")
        named.append("data")
    if named:
        warnings.warn(
            f"build_plan: {', '.join(named)} select the JAX package's "
            "segmented programs, which are captured at first use here: "
            "nothing to prepare",
            stacklevel=2)
    dev = resolve_device(device)
    if runner.device != dev:
        raise ValueError(f"build_plan on {dev}: runner is on "
                         f"{runner.device}")
    config = config if config is not None else NSConfig()
    if not config.flat_dims and runner.utrans is not None:
        config = dataclasses.replace(
            config, flat_dims=tuple(runner.utrans.flat_dims(runner.ncomp)))
    # the device as the tensors carry it (with its index)
    tdev = runner.spectra[0].dnu.device
    tasks = []
    if dev.type == "cuda":
        tasks.append(_Task("build", ("build",), _build_task, tdev))
    tasks.append(_Task(f"warm@{tdev}", ("warm", tdev, id(runner)),
                       lambda: _warm_task(runner, dtype), tdev))
    if not traced:
        return tasks
    if runner.spans_devices:
        raise ValueError("build_plan prepares one device's traced program; "
                         "this runner's likelihood spans several devices")
    rcfg = config.resolved(runner.ndim)
    # the likelihood object fit_batch hands the sampler (memoized)
    loglike2 = _fit._loglike2_for(runner, dtype)
    if rcfg.log_zero > -1e60:
        loglike2 = _s._floored(loglike2, rcfg.log_zero)
    own = runner.data_tree()
    # ns_init's bounds: the slim 3-tuple for method "slice", else 7
    n_bounds = 3 if rcfg.method == "slice" else 7
    key = graphs.program_key(loglike2, 0, True, rcfg,
                             (n_runs, rcfg.nlive, runner.ndim), dtype, tdev,
                             n_bounds, own)
    blocks = _traced_blocks(rcfg)
    be = max(1, rcfg.bound_every)
    label = label or f"n{runner.ncomp}"
    tasks.append(_Task(
        f"{label}:traced@{n_runs}", ("traced",) + key,
        lambda: _traced_task(runner, n_runs, rcfg, dtype, loglike2, own,
                             blocks, key),
        tdev, tuple(sorted({(i0 % be, n) for i0, n in blocks}))))
    return tasks


def compile_plan(tasks, max_workers=12, verbose=None, timeout=None):
    """Run every task of the plan, in order, once per key; returns the
    JAX report's keys: ``wall_s``, ``n_programs``, ``n_errors`` (0: a
    failure raises), ``n_deduped``, ``n_abandoned`` (tasks not started
    within ``timeout`` seconds), ``cache_hits``, ``cache_misses`` (the
    build's libraries) and ``programs``, one record per task run or
    deduplicated (``name``, ``wall_s``, ``cache_hits``, ``cache_misses``,
    and ``warmups``/``captures``/``keys`` for a traced program).
    ``max_workers`` is unused (module docstring)."""
    del max_workers
    traced = {}
    for t in tasks:
        if t.graph_keys:
            traced.setdefault(t.key, t)
    rows = {}
    for t in traced.values():
        rows[t.device] = rows.get(t.device, 0) + 1
    over = {str(d): n for d, n in rows.items() if n > graphs._PROGRAMS_CAP}
    if over:
        raise ValueError(
            f"the plan installs {over} traced programs on one dp row, more "
            f"than graphs._PROGRAMS_CAP = {graphs._PROGRAMS_CAP} that the "
            "cache keeps: later ones would evict earlier ones")
    done, recs, n_abandoned = set(), [], 0
    # the report's walls are the lengths of the plan's and tasks' spans
    with span("aot.plan", n_tasks=len(tasks)) as plan:
        for task in tasks:
            if timeout is not None and \
                    (now_ns() - plan.t0_ns) / 1e9 > timeout:
                n_abandoned += 1
                continue
            rec = {"name": task.name, "cache_hits": 0, "cache_misses": 0}
            with span("aot.task", name=task.name) as t:
                if task.key in done:
                    rec["deduped"] = True
                else:
                    rec.update(task.run())
                    done.add(task.key)
            rec["wall_s"] = t.seconds
            if task.graph_keys:
                rec["keys"] = [list(k) for k in task.graph_keys]
            recs.append(rec)
            if verbose:
                verbose(f"aot: {task.name} {rec['wall_s']:.2f}s"
                        + (" (deduped)" if rec.get("deduped") else ""))
    if n_abandoned and verbose:
        verbose(f"aot: {n_abandoned} tasks not started within {timeout} s; "
                "they are prepared at first use")
    return {
        "wall_s": plan.seconds,
        "n_programs": len(tasks),
        "n_errors": 0,
        "n_deduped": sum(1 for r in recs if r.get("deduped")),
        "n_abandoned": n_abandoned,
        "cache_hits": sum(r["cache_hits"] for r in recs),
        "cache_misses": sum(r["cache_misses"] for r in recs),
        "programs": recs,
    }


def precompile_fit(runner, n_runs, config=None, **kw):
    """``compile_plan(build_plan(runner, n_runs, config, ...))``: the
    keywords ``max_workers``, ``verbose`` and ``timeout`` go to
    :func:`compile_plan`, the rest to :func:`build_plan`."""
    cp = {k: kw.pop(k) for k in ("max_workers", "verbose", "timeout")
          if k in kw}
    return compile_plan(build_plan(runner, n_runs, config, **kw), **cp)
