"""The sampler's units of work on kept static programs, as CUDA graphs on
the card: the traced mode's blocks and the segmented loop's iterations
(``sampling/aot.py`` prepares the traced ones before a fit's first
batch).

The JAX package traces ``run_nested(segment_iters=0)`` into one program:
``ns_init``, a ``lax.while_loop`` of blocks (``block_iters`` candidate
iterations and a masked slice fill), ``ns_finalize``.  Here
:func:`run_traced` keeps that loop on the host, reads the ``[R]`` done
mask once per block and runs each block as one unit of a program.  The
segmented mode (``segment_iters > 0``) keeps its host loop of segments,
done-mask reads, compactions, probes and regime switches;
:class:`SegmentedRun` runs each unit it launches (a candidate iteration,
the slice fill after a candidate block, a kill+slice iteration) on a
program, one per compaction class, both regimes in it.

A program is one static state of ``R`` runs: its small per-run tensors,
a static bounds tuple for each bounds form met, the data, a generator
and its graphs.  A unit reads the static tensors and copies its result
back into them.  The dead-point buffers stay the run's own, out of the
program: a unit leaves its dead records in small static tensors, one
slot per iteration, which are written into the run's buffers after it,
in iteration order (no iteration reads those buffers).

On a CUDA device a run goes on its dp row's stream (:func:`row_stream`).
A unit's first run on its key (unit, flag, bounds form; a block's flag
is ``(i0 % bound_every, n_iters)``) is eager, so that whatever its path
makes at first use exists (constant tables, library handles, the
kernels' line tables); then the key is captured, and every later run is
one replay.  The graphs share one pool and draw from the program's
generator: a run lends it its caller's generator state and takes the
advanced state back, so the caller's generator moves as it would
eagerly, and graph and eager runs agree bit for bit.  A failed capture
raises: there is no eager fallback on the card.  On the CPU every unit
runs eagerly on the static state.

The programs are kept for the next run with the same likelihood, dp row,
capture flag, config, ``[R, L, D]`` shape, dtype, device and data shapes
(:func:`program_key`), the ``_PROGRAMS_CAP`` most recently used of each
dp row; a traced and a segmented run with one key share one program.
:func:`clear` drops them.

The kernel wrappers count their launches on the host, which a replay
does not reach: a capture records how many launches its unit holds, and
every replay adds them to the counters.  The units count
``ns.graph_steps`` (replays), ``ns.eager_steps`` (run eagerly on the
card) and ``ns.graph_captures`` into the recorder, and time the eager
first run of a key that is then captured (span ``graphs.first_run``)
and its capture (``graphs.capture``); :func:`run_traced` also tallies
its :class:`TracedStats`.

The dp rows of a mesh run in threads of their own, one program per row.
Captures take a lock and run in ``"thread_local"`` error mode, so another
row's launches and host reads during a capture neither break it nor land
in it.  A likelihood that spans several devices is not captured
(``capture=False``): the traced mode runs its blocks eagerly, with a
warning, and the segmented mode runs the plain loop.  A graph reads
every table it uses by address (the prior's, the runner's, the sampler's
constants): they must stay where they are.
"""

import contextlib
import dataclasses
import logging
import threading

import torch

from nestfit_tpu_torch.ops import _build
from nestfit_tpu_torch.sampling import sampler as _s
from nestfit_tpu_torch.utils.profiling import (
    count,
    read_device_counters,
    span,
    to_host,
)

log = logging.getLogger("nestfit_tpu_torch.graphs")


@dataclasses.dataclass
class TracedStats:
    """What one :func:`run_traced` call did."""

    blocks: int = 0            # blocks run, eager and replayed
    replays: int = 0           # graph replays
    captures: int = 0          # graphs captured
    done_reads: int = 0        # host reads of the [R] done mask
    straggler_blocks: int = 0  # blocks run with < 10% of the rows active
    eager_blocks: int = 0      # blocks run eagerly on the card (no capture)
    warmups: int = 0           # blocks run eagerly as a key's first run

    def __add__(self, other: "TracedStats") -> "TracedStats":
        return TracedStats(*(getattr(self, f.name) + getattr(other, f.name)
                             for f in dataclasses.fields(self)))


#: the stats of the last :func:`run_traced` call (of a mesh run, the sum
#: over its dp rows: ``sampler.run_nested`` sets it)
last_stats = TracedStats()
_THREAD = threading.local()

_PROGRAMS = {}       # program_key -> _Program, least recently used first
_PROGRAMS_CAP = 12   # kept programs per dp row
_STREAMS = {}        # (device, dp row) -> the row's stream
_LOCK = threading.Lock()           # _PROGRAMS, _STREAMS
_CAPTURE_LOCK = threading.Lock()   # one capture at a time

#: the small per-run tensors of a state (the dead buffers stay the run's)
_SMALL = tuple(f for f in _s._RUN_FIELDS + ("acc_ema",)
               if f not in ("dead_u", "dead_lnl"))


def clear():
    """Drop the kept programs (their graphs and static tensors)."""
    with _LOCK:
        _PROGRAMS.clear()


def thread_stats() -> TracedStats:
    """The stats of this thread's last :func:`run_traced` call."""
    return getattr(_THREAD, "stats", TracedStats())


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in _leaves(t)]


def _clone_tree(tree):
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else tree.clone()
    return type(tree)(_clone_tree(t) for t in tree)


def _copy(dst, src):
    """Copy each tensor of ``src`` into its counterpart in ``dst``
    (those updated in place are the same tensor and stay)."""
    for a, b in zip(dst, src):
        if a is not b:
            a.copy_(b)


def _own(state: _s._State) -> _s._State:
    """``state`` with its small tensors cloned out of the program, whose
    next run overwrites them."""
    return dataclasses.replace(
        state, **{f: getattr(state, f).clone() for f in _SMALL})


@contextlib.contextmanager
def row_stream(device, shard: int):
    """Run the block on the dp row's stream (on a CUDA device), in order
    with the caller's stream on both sides.  The whole run goes there, so
    the libraries' per-stream handles and workspaces (cuBLAS keeps 32 MiB
    for each stream it runs on) serve the eager work, the captures and
    the replays alike."""
    device = torch.device(device)
    if device.type != "cuda":
        yield
        return
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    with _LOCK:
        if (device, shard) not in _STREAMS:
            _STREAMS[device, shard] = torch.cuda.Stream(device)
        stream = _STREAMS[device, shard]
    caller = torch.cuda.current_stream(device)
    stream.wait_stream(caller)
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        caller.wait_stream(stream)


class _Program:
    """The sampler's units on one static state of ``R`` runs (module
    docstring): ``"cand"`` (refresh flag), ``"fill"``, ``"slice"``
    (rebuild flag) and the traced ``"block"``."""

    def __init__(self, state: _s._State, loglike2, data, cfg,
                 capture=True):
        self.on_card = state.u.is_cuda
        self.capture = capture and self.on_card
        self.loglike2, self.cfg = loglike2, cfg
        self.state = dataclasses.replace(_own(state), dead_u=None,
                                         dead_lnl=None, bounds=())
        self.bounds = {}          # bounds form -> static tuple
        self.data = _clone_tree(data)
        self.kills = self._slots(1)[0]   # an iteration's dead records
        self.block_kills = None   # a block's, one slot per iteration
        self.gen = torch.Generator(device=state.u.device) if self.on_card \
            else None
        self.graphs = {}          # key -> (graph, launches per replay)
        self.pool = None

    def _slots(self, n: int):
        """``n`` slots of static dead records (:func:`sampler._kill_select`'s
        rows, columns, points, lnL and mask)."""
        R, _, D = self.state.u.shape
        K, dev = self.cfg.kill_k, self.state.u.device
        records = (
            torch.empty((n, R, K), dtype=torch.long, device=dev),
            torch.empty((n, R, K), dtype=torch.long, device=dev),
            torch.empty((n, R, K, D), dtype=self.state.u.dtype, device=dev),
            torch.empty((n, R, K), dtype=self.state.lnl.dtype, device=dev),
            torch.empty((n, R, K), dtype=torch.bool, device=dev))
        return [tuple(x[j] for x in records) for j in range(n)]

    def lend(self, gen: torch.Generator) -> torch.Generator:
        """The generator a run on this program draws from: on a card the
        program's own (its graphs draw from it), set to ``gen``'s state;
        the caller takes the advanced state back."""
        if self.gen is None or self.gen is gen:
            return gen
        self.gen.set_state(gen.get_state())
        return self.gen

    def load(self, state: _s._State, data, gen) -> _s._State:
        """The static view of ``state``: its small tensors, bounds and
        ``data`` copied into the static ones (tensors already static
        stay), its dead buffers its own, drawing from ``gen``."""
        _copy([getattr(self.state, f) for f in _SMALL],
              [getattr(state, f) for f in _SMALL])
        n = len(state.bounds)
        if n in self.bounds:
            _copy(self.bounds[n], state.bounds)
        else:
            self.bounds[n] = tuple(b.clone() for b in state.bounds)
        _copy(_leaves(self.data), _leaves(data))
        return dataclasses.replace(
            self.state, gen=gen, i=state.i, bounds=self.bounds[n],
            dead_u=state.dead_u, dead_lnl=state.dead_lnl)

    def _unit(self, kind: str, flag, s: _s._State):
        """One unit from the static view ``s``, its result copied back
        into the static tensors (eagerly, or into a capture)."""
        st = dataclasses.replace(s, dead_u=None, dead_lnl=None)
        args = (self.loglike2, self.data, self.cfg)
        if kind in ("cand", "slice"):
            step = _s._cand_iter if kind == "cand" else _s._slice_iter
            out, kills = step(st, *args, flag)
            _copy(self.kills, kills)
        elif kind == "fill":
            out = _s._slice_fill_pass(st, *args)
        else:
            # sampler._traced_block from i0 = phase (mod bound_every)
            phase, n_iters = flag
            be = max(1, self.cfg.bound_every)
            if self.block_kills is None:   # the first block, run eagerly
                self.block_kills = self._slots(max(1, self.cfg.block_iters))
            out = st
            for j, slot in enumerate(self.block_kills[:n_iters]):
                out, kills = _s._cand_iter(out, *args, (phase + j) % be == 0)
                _copy(slot, kills)
            out = _s._slice_fill_pass(out, *args)
        _copy([getattr(s, f) for f in _SMALL] + list(s.bounds),
              [getattr(out, f) for f in _SMALL] + list(out.bounds))

    def _capture(self, kind: str, flag, s: _s._State):
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.gen)
        n_iters = flag[1] if kind == "block" else 1
        # torch.cuda.graph would empty the allocator's cache first; a
        # capture here runs between eager units that refill it
        try:
            with span("graphs.capture", rows=s.u.shape[0], n_iters=n_iters,
                      mode=kind), \
                    _CAPTURE_LOCK, _build.recording() as per_replay:
                # on the current stream: the row's (row_stream)
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    self._unit(kind, flag, s)
                finally:
                    graph.capture_end()
        except RuntimeError as exc:
            raise RuntimeError(
                f"capturing the sampler's {kind} unit ({s.u.shape[0]} runs, "
                f"{n_iters} iterations) as a CUDA graph failed: "
                f"{exc}") from exc
        if self.pool is None:
            self.pool = graph.pool()
        count("ns.graph_captures")
        return graph, per_replay

    def run(self, kind: str, flag, s: _s._State,
            stats: TracedStats = None) -> _s._State:
        """Run unit ``kind`` (``"cand"``, refresh ``flag``; ``"fill"``;
        ``"slice"``, rebuild ``flag``; ``"block"``, ``flag`` its key
        ``(i0 % bound_every, n_iters)``) from the static view ``s``, write
        its dead records into ``s``'s dead buffers, and return the view
        after it; ``stats`` (the traced mode's) tallies how it ran."""
        key = (kind, flag, len(s.bounds))
        graph = self.graphs.get(key)
        if graph is not None:
            graph[0].replay()
            _build.add_launches(graph[1])
            count("ns.graph_steps")
        else:
            # the key's first run is eager, so that whatever its path
            # makes at first use exists; then its graph is captured (a
            # capture runs nothing) for its later runs.  The span closes
            # once the eager run's launches are issued.
            with span("graphs.first_run", kind=kind, rows=s.u.shape[0]) \
                    if self.capture else contextlib.nullcontext():
                self._unit(kind, flag, s)
            if self.on_card:
                count("ns.eager_steps")
            if self.capture:
                self.graphs[key] = self._capture(kind, flag, s)
        if stats is not None:
            stats.replays += graph is not None
            stats.warmups += graph is None and self.capture
            stats.captures += graph is None and self.capture
            stats.eager_blocks += self.on_card and not self.capture
        if kind == "fill":
            return s
        if kind == "block":
            for kills in self.block_kills[:flag[1]]:
                _s._record_kills(s.dead_u, s.dead_lnl, kills)
            return dataclasses.replace(s, i=s.i + flag[1])
        _s._record_kills(s.dead_u, s.dead_lnl, self.kills)
        return dataclasses.replace(s, i=s.i + 1)


def program_key(loglike2, shard: int, capture: bool, cfg, shape, dtype,
                device, data) -> tuple:
    """The key a program is kept under: the likelihood, the dp row, the
    capture flag, the resolved config, the state's ``[R, L, D]`` shape,
    dtype and device, and the data's shapes."""
    return (id(loglike2), shard, capture, cfg, tuple(shape), dtype,
            torch.device(device),
            tuple((tuple(x.shape), x.dtype, x.device) for x in _leaves(data)))


def _program(state: _s._State, loglike2, data, cfg, shard: int,
             capture: bool = True) -> _Program:
    """The kept program for ``state``, or a new one (each dp row keeps its
    ``_PROGRAMS_CAP`` most recently used)."""
    key = program_key(loglike2, shard, capture, cfg, state.u.shape,
                      state.u.dtype, state.u.device, data)
    with _LOCK:
        prog = _PROGRAMS.pop(key, None)
        if prog is None:
            mine = [k for k in _PROGRAMS if k[1] == shard]
            while len(mine) >= _PROGRAMS_CAP:
                _PROGRAMS.pop(mine.pop(0))
            # the program owns its data and the likelihood (whose id is
            # in the key): a later run copies its own data in
            prog = _Program(state, loglike2, data, cfg, capture)
        _PROGRAMS[key] = prog
        return prog


def prepare(state: _s._State, loglike2, data, cfg, blocks, key,
            shard: int = 0) -> TracedStats:
    """Make the program :func:`run_traced` would use for ``state`` (the
    same ``loglike2``, data, config and row) ready before its first call:
    run its first block and the block of every ``(i0, n_iters)`` in
    ``blocks`` on it, so that on a card the graph of each key ``(i0 %
    bound_every, n_iters)`` is captured.  ``state`` must draw from a
    throwaway generator; a later call lends its own.  ``key`` is the
    program key the caller planned for (:func:`program_key`): a state
    whose key differs raises."""
    cfg = cfg.resolved(state.u.shape[-1])
    if program_key(loglike2, shard, True, cfg, state.u.shape, state.u.dtype,
                   state.u.device, data) != key:
        raise ValueError("the traced program's key is not the planned one "
                         "(likelihood, config, shapes, dtype or device "
                         "differ)")
    be = max(1, cfg.bound_every)
    first = min(max(1, cfg.block_iters), cfg.max_iter - state.i)
    prog = _program(state, loglike2, data, cfg, shard)
    # the CPU captures nothing: its first block is the one warm-up
    stats = TracedStats(warmups=int(not prog.on_card))
    with row_stream(state.u.device, shard):
        s = prog.load(state, data, prog.lend(state.gen))
        for i0, n_iters in [(state.i, first), *blocks]:
            stats.blocks += 1
            s = prog.run("block", (i0 % be, n_iters), s, stats)
    if prog.on_card:
        torch.cuda.synchronize(state.u.device)
    read_device_counters(state.u.device)
    return stats


def run_traced(state: _s._State, loglike2, data, cfg, shard: int = 0,
               capture: bool = True) -> _s._State:
    """Run traced blocks from ``state`` until every run is done or ``i``
    reaches ``max_iter``: the blocks of ``sampler.ns_traced``, each one
    unit of a kept program (captured and replayed on a CUDA device).
    ``shard`` is the dp row of a mesh run; ``capture=False`` runs the
    blocks eagerly on the card (a likelihood that spans several devices).
    Returns the final state, its small tensors the caller's and its dead
    buffers ``state``'s (the caller's generator advanced); ``last_stats``
    holds what the call did."""
    global last_stats
    R, _, D = state.u.shape
    cfg = cfg.resolved(D)
    block, be = max(1, cfg.block_iters), max(1, cfg.bound_every)
    if state.u.is_cuda and not capture:
        log.warning("the likelihood spans several devices: the traced "
                    "blocks run eagerly, without CUDA graphs")
    prog = _program(state, loglike2, data, cfg, shard, capture)
    stats = TracedStats()
    with row_stream(state.u.device, shard):
        s = prog.load(state, data, prog.lend(state.gen))
        while True:
            # the one host read of each block
            done = to_host(s.done, "ns.running")
            stats.done_reads += 1
            if done.all() or s.i >= cfg.max_iter:
                break
            if (~done).sum() < 0.1 * R:
                stats.straggler_blocks += 1
            stats.blocks += 1
            s = prog.run("block", (s.i % be, min(block, cfg.max_iter - s.i)),
                         s, stats)
            count("ns.blocks")
        # the done read drained the launch queue
        read_device_counters(state.u.device)
        out = dataclasses.replace(_own(s), bounds=(), gen=state.gen)
    last_stats = _THREAD.stats = stats
    if s.gen is not state.gen:
        state.gen.set_state(s.gen.get_state())
    return out


class SegmentedRun(_s._Units):
    """One segmented run's units on kept static programs, one per
    compaction class: ``sampler._run_nested`` enters a segment with
    :meth:`enter` and runs its iterations and fills through it.

    The first program draws from its caller's generator state, and each
    next program from its predecessor's; :meth:`close` hands the state
    back, so the caller's generator moves as it would eagerly.  A state
    the caller keeps (the final one, the accumulator of a compaction)
    is cloned out of the program first: the next run with the same key
    overwrites the static tensors."""

    def __init__(self, loglike2, cfg, shard: int, gen: torch.Generator):
        super().__init__(loglike2, cfg)
        self.shard, self.caller_gen, self.gen = shard, gen, gen
        self.prog = None

    def enter(self, state: _s._State, data) -> _s._State:
        self.prog = _program(state, self.loglike2, data, self.cfg,
                             self.shard)
        self.gen = self.prog.lend(self.gen)
        return self.prog.load(state, data, self.gen)

    def own(self, state: _s._State) -> _s._State:
        return _own(state)

    def close(self, state: _s._State) -> _s._State:
        if self.gen is not self.caller_gen:
            self.caller_gen.set_state(self.gen.get_state())
        return dataclasses.replace(_own(state), gen=self.caller_gen)

    def cand(self, s, refresh):
        return self.prog.run("cand", refresh, s)

    def fill(self, s):
        return self.prog.run("fill", False, s)

    def slice(self, s, slim):
        return self.prog.run("slice", slim, s)
