"""The traced mode's blocks as CUDA graphs (the port's counterpart of
``nestfit_tpu/sampling/aot.py``: it runs prebuilt programs).

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
last ``_PROGRAMS_CAP`` of them; their static tensors, the dead-point
buffers included, stay allocated until :func:`clear` drops them): that
call copies its initial state and data into the static tensors and
replays the graphs already captured.

On the CPU the same static-state loop runs without capture.

The kernel wrappers count their launches on the host, which a replay
does not reach: capturing a block records how many launches it holds,
and every replay adds them to the counters.
"""

import dataclasses

import torch

from nestfit_tpu_torch.sampling import sampler as _s


@dataclasses.dataclass
class TracedStats:
    """What one :func:`run_traced` call did."""

    blocks: int = 0            # blocks run, eager and replayed
    replays: int = 0           # graph replays
    captures: int = 0          # graphs captured
    done_reads: int = 0        # host reads of the [R] done mask
    straggler_blocks: int = 0  # blocks run with < 10% of the rows active


#: the stats of the last :func:`run_traced` call
last_stats = TracedStats()

_PROGRAMS = {}
_PROGRAMS_CAP = 2


def clear():
    """Drop the kept programs (their graphs and static tensors)."""
    _PROGRAMS.clear()


def _counted_wrappers():
    from nestfit_tpu_torch.ops import fused, tables

    return (fused.hf_chi2_fused, fused.gauss_chi2_fused, tables.table_lerp,
            tables.tapered_invert)


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

    def __init__(self, state: _s._State, loglike2, data, cfg):
        self.on_card = state.u.is_cuda
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
        counted = _counted_wrappers()
        before = [fn.launches for fn in counted]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.state.gen)
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                self._eager(i0, n_iters)
        except RuntimeError as exc:
            raise RuntimeError(
                f"capturing the traced block ({n_iters} iterations from "
                f"i = {i0}) as a CUDA graph failed: {exc}") from exc
        # a capture launches nothing: the launches it recorded are added
        # on each replay
        per_replay = [fn.launches - b for fn, b in zip(counted, before)]
        for fn, b in zip(counted, before):
            fn.launches = b
        if self.pool is None:
            self.pool = graph.pool()
        return graph, per_replay

    def run_block(self, i0: int, n_iters: int, stats: TracedStats):
        stats.blocks += 1
        if not self.on_card:
            self._eager(i0, n_iters)
            return
        if not self.warm:
            # the warm-up block: a real block of the run, run eagerly on
            # the capture stream
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                self._eager(i0, n_iters)
            torch.cuda.current_stream().wait_stream(self.stream)
            self.warm = True
            return
        key = (i0 % max(1, self.cfg.bound_every), n_iters)
        if key not in self.graphs:
            self.graphs[key] = self._capture(i0, n_iters)
            stats.captures += 1
        graph, per_replay = self.graphs[key]
        graph.replay()
        stats.replays += 1
        for fn, k in zip(_counted_wrappers(), per_replay):
            fn.launches += k


def _program(state: _s._State, loglike2, data, cfg) -> _Program:
    """The kept program for this call, loaded with ``state`` and
    ``data``, or a new one."""
    key = (id(loglike2), cfg, tuple(state.u.shape), state.u.dtype,
           state.u.device, len(state.bounds),
           tuple((tuple(x.shape), x.dtype, x.device)
                 for x in _leaves(data)))
    prog = _PROGRAMS.get(key)
    if prog is not None:
        prog.load(state, data)
        return prog
    while len(_PROGRAMS) >= _PROGRAMS_CAP:
        _PROGRAMS.pop(next(iter(_PROGRAMS)))
    # the program owns its data and the likelihood (whose id is in the
    # key): a later call copies its own data in
    prog = _Program(state, loglike2, _clone_tree(data), cfg)
    _PROGRAMS[key] = prog
    return prog


def run_traced(state: _s._State, loglike2, data, cfg) -> _s._State:
    """Run traced blocks from ``state`` until every run is done or ``i``
    reaches ``max_iter``: the blocks of ``sampler.ns_traced``, on a
    static state, captured and replayed on a CUDA device.  Returns the
    final state (the caller's generator advanced); ``last_stats`` holds
    what the call did."""
    global last_stats
    R, _, D = state.u.shape
    cfg = cfg.resolved(D)
    block = max(1, cfg.block_iters)
    caller_gen = state.gen
    if state.u.is_cuda:
        prog = _program(state, loglike2, data, cfg)
        prog.state.gen.set_state(caller_gen.get_state())
    else:
        prog = _Program(state, loglike2, data, cfg)
    stats = TracedStats()
    i = state.i
    while True:
        # the one host read of each block
        done = prog.state.done.cpu().numpy()
        stats.done_reads += 1
        if done.all() or i >= cfg.max_iter:
            break
        if (~done).sum() < 0.1 * R:
            stats.straggler_blocks += 1
        n = min(block, cfg.max_iter - i)
        prog.run_block(i, n, stats)
        i += n
    last_stats = stats
    out = dataclasses.replace(prog.state, i=i, bounds=(), gen=caller_gen)
    if prog.on_card:
        caller_gen.set_state(prog.state.gen.get_state())
        # the kept program's tensors serve the next call
        out = dataclasses.replace(out, **{
            f: getattr(out, f).clone() for f in _FIELDS})
    return out
