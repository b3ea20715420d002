"""The traced mode's blocks, and the segmented loop's units, as CUDA
graphs (``sampling/aot.py`` prepares the traced ones before a fit's
first batch).

The JAX package traces ``run_nested(segment_iters=0)`` into one program:
``ns_init``, a ``lax.while_loop`` of blocks (``block_iters`` candidate
iterations and a masked slice fill), ``ns_finalize``.  Here one block is
the unit: :func:`run_traced` keeps the sampler state in *static* tensors,
runs a block that reads them and copies its result back into them, and
reads the ``[R]`` done mask on the host once per block.

On a CUDA device the first block of a program runs eagerly (it fills
every cache the block touches: constant tables, library handles, the
kernels' line tables), then the block is captured once per
(bound-refresh phase, block length) as a ``torch.cuda.CUDAGraph`` and
replayed.  The program draws from a generator of its own, registered
with each graph: a call copies its caller's generator state in and the
advanced state back out, so the caller's generator moves as it would
eagerly, and graph and eager runs agree bit for bit.  A failed capture
raises: there is no eager fallback on the card.  The large dead-point
buffers are updated in place by the replay.  The program is kept for the
next call with the same likelihood, batch, config and data shapes (the
last ``_PROGRAMS_CAP`` of them for each dp row; their static tensors,
the dead-point buffers included, stay allocated until :func:`clear`
drops them): that call copies its initial state and data into the
static tensors and replays the graphs already captured.

On the CPU the same static-state loop runs without capture.

The kernel wrappers count their launches on the host, which a replay
does not reach: capturing a block records how many launches it holds,
and every replay adds them to the counters.

The dp rows of a mesh run this loop in threads of their own, one program
per row (the row is part of the program's key).  Captures take a lock and
run in ``"thread_local"`` error mode, so another row's launches and host
reads during a capture neither break it nor land in it.  A program whose
likelihood spans several devices (a row split over ``sp`` devices) is not
captured: its blocks run eagerly, with a warning.

The segmented mode (``segment_iters > 0``) keeps its host loop of
segments, done-mask reads, compactions, probes and regime switches;
:class:`SegmentedRun` runs each unit of work the loop launches (a
candidate iteration, the slice fill after a candidate block, a
kill+slice iteration) on a kept static state, one per compaction class,
both regimes in it.  On a CUDA device the whole run goes on its dp
row's stream (:func:`row_stream`); a unit's first run on its key (unit,
refresh flag, bounds form) is eager and is followed by the key's
capture, and every later run is one replay.  The dead-point buffers stay
the run's own, out of the graphs: a unit leaves its dead records in
small static tensors, which are written into the run's buffers after
it.  The units count ``ns.graph_steps`` (replays), ``ns.eager_steps``
(run eagerly on the card) and ``ns.graph_captures`` into the recorder.
A likelihood that spans devices runs the plain loop (``capture=False``).
A graph reads every table it uses by address (the prior's, the
runner's, the sampler's constants): they must stay where they are.
"""

import contextlib
import dataclasses
import logging
import threading

import torch

from nestfit_tpu_torch.ops import _build
from nestfit_tpu_torch.sampling import sampler as _s
from nestfit_tpu_torch.utils.profiling import count, span, to_host

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
    warmups: int = 0           # warm-up blocks (a new program's first)

    def __add__(self, other: "TracedStats") -> "TracedStats":
        return TracedStats(*(getattr(self, f.name) + getattr(other, f.name)
                             for f in dataclasses.fields(self)))


#: the stats of the last :func:`run_traced` call (of a mesh run, the sum
#: over its dp rows: ``sampler.run_nested`` sets it)
last_stats = TracedStats()
_THREAD = threading.local()

_PROGRAMS = {}
_PROGRAMS_CAP = 2
_LOCK = threading.Lock()           # _PROGRAMS
_CAPTURE_LOCK = threading.Lock()   # one capture at a time


def clear():
    """Drop the kept programs (their graphs and static tensors), the
    segmented loop's too."""
    with _LOCK:
        _PROGRAMS.clear()
        _SEG_PROGRAMS.clear()


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


_FIELDS = _s._RUN_FIELDS + ("acc_ema",)


def _tensors(state: _s._State):
    """The static tensors of a state, in a fixed order."""
    return [getattr(state, f) for f in _FIELDS] + list(state.bounds)


def _copy(dst, src):
    """Copy each tensor of ``src`` into its counterpart in ``dst``
    (those updated in place are the same tensor and stay)."""
    for a, b in zip(dst, src):
        if a is not b:
            a.copy_(b)


class _Program:
    """The traced block on one static state."""

    def __init__(self, state: _s._State, loglike2, data, cfg,
                 capture=True):
        self.on_card = state.u.is_cuda
        self.capture = capture
        if self.on_card:
            # the graphs draw from the program's generator; each call
            # lends it its caller's state
            state = dataclasses.replace(
                state, gen=torch.Generator(device=state.u.device))
        self.state = state
        self.loglike2 = loglike2
        self.data = data
        self.cfg = cfg
        self.graphs = {}          # (phase, n_iters) -> (graph, launches)
        self.pool = None
        self.warm = False
        self.stream = torch.cuda.Stream(state.u.device) if self.on_card \
            else None

    def load(self, state: _s._State, data):
        """Copy a new call's initial state and data into the static
        tensors."""
        _copy(_tensors(self.state) + _leaves(self.data),
              _tensors(state) + _leaves(data))

    def _eager(self, i0: int, n_iters: int):
        out = _s._traced_block(dataclasses.replace(self.state, i=i0),
                               self.loglike2, self.data, self.cfg, n_iters)
        _copy(_tensors(self.state), _tensors(out))

    def _capture(self, i0: int, n_iters: int):
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.state.gen)
        # a capture launches nothing: the launches it records are added
        # on each replay
        try:
            with span("graphs.capture", rows=self.state.u.shape[0],
                      n_iters=n_iters), \
                    _CAPTURE_LOCK, _build.recording() as per_replay, \
                    torch.cuda.graph(graph, pool=self.pool,
                                     stream=self.stream,
                                     capture_error_mode="thread_local"):
                self._eager(i0, n_iters)
        except RuntimeError as exc:
            raise RuntimeError(
                f"capturing the traced block ({n_iters} iterations from "
                f"i = {i0}) as a CUDA graph failed: {exc}") from exc
        if self.pool is None:
            self.pool = graph.pool()
        return graph, per_replay

    def graph(self, i0: int, n_iters: int, stats: TracedStats):
        """The graph of the block of ``n_iters`` iterations from ``i0``,
        captured at its first use: the block reads ``i`` only as
        ``i % bound_every``, so the graph serves every such ``i0``."""
        key = (i0 % max(1, self.cfg.bound_every), n_iters)
        if key not in self.graphs:
            self.graphs[key] = self._capture(i0, n_iters)
            stats.captures += 1
        return self.graphs[key]

    def run_block(self, i0: int, n_iters: int, stats: TracedStats):
        stats.blocks += 1
        if not self.on_card:
            self._eager(i0, n_iters)
            return
        if not self.capture:
            self._eager(i0, n_iters)
            stats.eager_blocks += 1
            return
        if not self.warm:
            # the warm-up block: a real block of the run, run eagerly on
            # the capture stream
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                self._eager(i0, n_iters)
            torch.cuda.current_stream().wait_stream(self.stream)
            self.warm = True
            stats.warmups += 1
            return
        graph, per_replay = self.graph(i0, n_iters, stats)
        graph.replay()
        stats.replays += 1
        _build.add_launches(per_replay)


def program_key(loglike2, shard: int, capture: bool, cfg, shape, dtype,
                device, n_bounds: int, data) -> tuple:
    """The key a program is kept under: the likelihood, the dp row, the
    capture flag, the resolved config, the state's ``[R, L, D]`` shape,
    dtype, device and bounds tuple length, and the data's shapes."""
    return (id(loglike2), shard, capture, cfg, tuple(shape), dtype,
            torch.device(device), n_bounds,
            tuple((tuple(x.shape), x.dtype, x.device) for x in _leaves(data)))


def _state_key(state: _s._State, loglike2, data, cfg, shard: int,
               capture: bool) -> tuple:
    return program_key(loglike2, shard, capture, cfg, state.u.shape,
                       state.u.dtype, state.u.device, len(state.bounds), data)


def _program(state: _s._State, loglike2, data, cfg, shard: int,
             capture: bool) -> _Program:
    """The kept program for this call, loaded with ``state`` and
    ``data``, or a new one."""
    key = _state_key(state, loglike2, data, cfg, shard, capture)
    with _LOCK:
        prog = _PROGRAMS.get(key)
        if prog is None:
            # each dp row keeps its own last _PROGRAMS_CAP programs
            mine = [k for k in _PROGRAMS if k[1] == shard]
            while len(mine) >= _PROGRAMS_CAP:
                _PROGRAMS.pop(mine.pop(0))
            # the program owns its data and the likelihood (whose id is
            # in the key): a later call copies its own data in
            _PROGRAMS[key] = _Program(state, loglike2, _clone_tree(data),
                                      cfg, capture)
            return _PROGRAMS[key]
    prog.load(state, data)
    return prog


def prepare(state: _s._State, loglike2, data, cfg, blocks, key,
            shard: int = 0) -> TracedStats:
    """Make the program :func:`run_traced` would make for ``state`` (the
    same ``loglike2``, data, config and row) ready before its first call:
    run its warm-up block and capture the graph of every ``(i0,
    n_iters)`` in ``blocks``, each under its key ``(i0 % bound_every,
    n_iters)``, and keep it.  ``state`` must draw from a throwaway
    generator; a later call loads its own state and generator.  ``key``
    is the program key the caller planned for (:func:`program_key`): a
    state whose key differs raises.  On the CPU, where :func:`run_traced`
    keeps no program, the warm-up block runs and nothing is kept."""
    cfg = cfg.resolved(state.u.shape[-1])
    if _state_key(state, loglike2, data, cfg, shard, True) != key:
        raise ValueError("the traced program's key is not the planned one "
                         "(likelihood, config, shapes, dtype or device "
                         "differ)")
    stats = TracedStats()
    first = min(max(1, cfg.block_iters), cfg.max_iter - state.i)
    if not state.u.is_cuda:
        _Program(state, loglike2, data, cfg).run_block(state.i, first, stats)
        stats.warmups += 1
        return stats
    prog = _program(state, loglike2, data, cfg, shard, True)
    prog.state.gen.set_state(state.gen.get_state())
    if not prog.warm:
        prog.run_block(state.i, first, stats)
    for i0, n_iters in blocks:
        prog.graph(i0, n_iters, stats)
    torch.cuda.synchronize(state.u.device)
    return stats


def run_traced(state: _s._State, loglike2, data, cfg, shard: int = 0,
               capture: bool = True) -> _s._State:
    """Run traced blocks from ``state`` until every run is done or ``i``
    reaches ``max_iter``: the blocks of ``sampler.ns_traced``, on a
    static state, captured and replayed on a CUDA device.  ``shard`` is
    the dp row of a mesh run (its program is its own); ``capture=False``
    runs the blocks eagerly on the card (a likelihood that spans several
    devices).  Returns the final state (the caller's generator
    advanced); ``last_stats`` holds what the call did."""
    global last_stats
    R, _, D = state.u.shape
    cfg = cfg.resolved(D)
    block = max(1, cfg.block_iters)
    caller_gen = state.gen
    if state.u.is_cuda:
        if not capture:
            log.warning("the likelihood spans several devices: the traced "
                        "blocks run eagerly, without CUDA graphs")
        prog = _program(state, loglike2, data, cfg, shard, capture)
        prog.state.gen.set_state(caller_gen.get_state())
    else:
        prog = _Program(state, loglike2, data, cfg)
    stats = TracedStats()
    i = state.i
    while True:
        # the one host read of each block
        done = to_host(prog.state.done, "ns.running")
        stats.done_reads += 1
        if done.all() or i >= cfg.max_iter:
            break
        if (~done).sum() < 0.1 * R:
            stats.straggler_blocks += 1
        n = min(block, cfg.max_iter - i)
        prog.run_block(i, n, stats)
        count("ns.blocks")
        i += n
    last_stats = _THREAD.stats = stats
    out = dataclasses.replace(prog.state, i=i, bounds=(), gen=caller_gen)
    if prog.on_card:
        caller_gen.set_state(prog.state.gen.get_state())
        # the kept program's tensors serve the next call
        out = dataclasses.replace(out, **{
            f: getattr(out, f).clone() for f in _FIELDS})
    return out


# The segmented loop (segment_iters > 0): its units as graph replays.

#: the small per-run tensors of a state (the dead buffers stay the run's)
_SMALL = tuple(f for f in _FIELDS if f not in ("dead_u", "dead_lnl"))
_SEG_PROGRAMS = {}   # _seg_key -> _SegProgram, least recently used first
_SEG_CAP = 12        # kept segmented programs per dp row
_SEG_STREAMS = {}    # (device, dp row) -> the row's segmented stream


def _seg_stream(device, shard: int):
    """The stream of a dp row's segmented runs, on which their units run,
    are captured and are replayed.  The caller holds ``_LOCK``."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    key = (device, shard)
    if key not in _SEG_STREAMS:
        _SEG_STREAMS[key] = torch.cuda.Stream(device)
    return _SEG_STREAMS[key]


@contextlib.contextmanager
def row_stream(device, shard: int):
    """Run the block on the dp row's segmented stream (on a CUDA device),
    in order with the caller's stream on both sides.  The whole run goes
    there, so the libraries' per-stream handles and workspaces (cuBLAS
    keeps 32 MiB for each stream it runs on) serve the eager work, the
    captures and the replays alike."""
    device = torch.device(device)
    if device.type != "cuda":
        yield
        return
    with _LOCK:
        stream = _seg_stream(device, shard)
    caller = torch.cuda.current_stream(device)
    stream.wait_stream(caller)
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        caller.wait_stream(stream)


class _SegProgram:
    """The segmented loop's units on one static state of ``R`` runs: its
    small per-run tensors, a static bounds tuple for each bounds form
    met (the candidate regime's 7 tensors, the kill+slice regime's 3),
    the data, and the last unit's dead records, which the caller writes
    into the run's own dead buffers.  Both regimes share it.

    On a CUDA device, on the row's stream (:func:`row_stream`), each key
    ``(unit, flag, bounds form)`` runs eagerly the first time and is then
    captured as a CUDA graph, which every later run of the key replays;
    the graphs share one pool and draw from the program's generator.  On
    the CPU every unit runs eagerly on the static state."""

    def __init__(self, state: _s._State, loglike2, data, cfg):
        self.on_card = state.u.is_cuda
        self.loglike2, self.cfg = loglike2, cfg
        self.state = dataclasses.replace(
            state, dead_u=None, dead_lnl=None, bounds=(),
            **{f: getattr(state, f).clone() for f in _SMALL})
        self.bounds = {}          # bounds form -> static tuple
        self.data = _clone_tree(data)
        R, _, D = state.u.shape
        K, dev = cfg.kill_k, state.u.device
        # _kill_select's records: rows, columns, points, lnL, mask
        self.kills = (torch.empty((R, K), dtype=torch.long, device=dev),
                      torch.empty((R, K), dtype=torch.long, device=dev),
                      torch.empty((R, K, D), dtype=state.u.dtype, device=dev),
                      torch.empty((R, K), dtype=state.lnl.dtype, device=dev),
                      torch.empty((R, K), dtype=torch.bool, device=dev))
        self.gen = torch.Generator(device=dev) if self.on_card else None
        self.graphs = {}          # key -> (graph, launches per replay)
        self.pool = None

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

    def _unit(self, kind: str, flag: bool, s: _s._State):
        """One unit from the static view ``s``, its result copied back
        into the static tensors (eagerly, or into a capture)."""
        st = dataclasses.replace(s, dead_u=None, dead_lnl=None)
        args = (st, self.loglike2, self.data, self.cfg)
        kills = None
        if kind == "cand":
            out, kills = _s._cand_iter(*args, flag)
        elif kind == "slice":
            out, kills = _s._slice_iter(*args, flag)
        else:
            out = _s._slice_fill_pass(*args)
        _copy([getattr(s, f) for f in _SMALL] + list(s.bounds),
              [getattr(out, f) for f in _SMALL] + list(out.bounds))
        if kills is not None:
            _copy(self.kills, kills)

    def _capture(self, kind: str, flag: bool, s: _s._State):
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.gen)
        # torch.cuda.graph would empty the allocator's cache first; a
        # capture here runs between eager units that refill it
        try:
            with span("graphs.capture", rows=s.u.shape[0], n_iters=1,
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
                f"capturing the segmented loop's {kind} unit "
                f"({s.u.shape[0]} runs) as a CUDA graph failed: "
                f"{exc}") from exc
        if self.pool is None:
            self.pool = graph.pool()
        count("ns.graph_captures")
        return graph, per_replay

    def run(self, kind: str, flag: bool, s: _s._State) -> _s._State:
        """Run unit ``kind`` (``"cand"``, refresh ``flag``; ``"fill"``;
        ``"slice"``, rebuild ``flag``) from the static view ``s``, write
        its dead records into ``s``'s dead buffers, and return the view
        after it."""
        key = (kind, flag, len(s.bounds))
        if not self.on_card:
            self._unit(kind, flag, s)
        elif key not in self.graphs:
            # the key's first run is eager, so that whatever its path makes
            # at first use exists; then its graph is captured (a capture
            # runs nothing) for its later runs
            self._unit(kind, flag, s)
            count("ns.eager_steps")
            self.graphs[key] = self._capture(kind, flag, s)
        else:
            graph, per_replay = self.graphs[key]
            graph.replay()
            _build.add_launches(per_replay)
            count("ns.graph_steps")
        if kind == "fill":
            return s
        _s._record_kills(s.dead_u, s.dead_lnl, self.kills)
        return dataclasses.replace(s, i=s.i + 1)


def _seg_key(state: _s._State, loglike2, data, cfg, shard: int) -> tuple:
    """A segmented program's key: :func:`program_key` at the state's
    ``[R, L, D]`` (``R`` the compaction class), with the bounds form and
    the regime left to the graphs' keys."""
    return ("segmented",) + program_key(
        loglike2, shard, True, cfg, state.u.shape, state.u.dtype,
        state.u.device, 0, data)


def _seg_program(state: _s._State, loglike2, data, cfg,
                 shard: int) -> _SegProgram:
    """The kept segmented program for ``state``, or a new one (each dp
    row keeps its ``_SEG_CAP`` most recently used)."""
    key = _seg_key(state, loglike2, data, cfg, shard)
    with _LOCK:
        prog = _SEG_PROGRAMS.pop(key, None)
        if prog is None:
            mine = [k for k in _SEG_PROGRAMS if k[2] == shard]
            while len(mine) >= _SEG_CAP:
                _SEG_PROGRAMS.pop(mine.pop(0))
            prog = _SegProgram(state, loglike2, data, cfg)
        _SEG_PROGRAMS[key] = prog
        return prog


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
        prog = _seg_program(state, self.loglike2, data, self.cfg,
                            self.shard)
        if prog.on_card and prog.gen is not self.gen:
            prog.gen.set_state(self.gen.get_state())
            self.gen = prog.gen
        self.prog = prog
        return prog.load(state, data, self.gen)

    def own(self, state: _s._State) -> _s._State:
        return dataclasses.replace(
            state, **{f: getattr(state, f).clone() for f in _SMALL})

    def close(self, state: _s._State) -> _s._State:
        if self.gen is not self.caller_gen:
            self.caller_gen.set_state(self.gen.get_state())
        return dataclasses.replace(self.own(state), gen=self.caller_gen)

    def cand(self, s, refresh):
        return self.prog.run("cand", refresh, s)

    def fill(self, s):
        return self.prog.run("fill", False, s)

    def slice(self, s, slim):
        return self.prog.run("slice", slim, s)
