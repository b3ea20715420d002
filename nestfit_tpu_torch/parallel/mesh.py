"""Device meshes for multi-device fitting (port of
``nestfit_tpu/parallel/mesh.py``).

A :class:`Mesh` is a ``(dp, sp)`` array of ``torch.device``s:

* ``dp`` (data-parallel) rows split the pixels.  Every run is
  independent, so each row fits its own contiguous share of the batch on
  its own device, with its own generator and its own host loop (one
  thread per row), and no exchange between rows
  (:func:`run_shards`).
* ``sp`` (channel-parallel) columns split a row's spectra into contiguous
  channel slices, one on each device of the row; the likelihood runs its
  kernel on every slice for the same proposals and sums the partial
  chi-square on the row's first device (``Runner.placed``).  Useful only
  for very long spectra.

There is no ambient mesh: ``run_nested``, ``fit_batch``,
``posterior_modes`` and ``CubeFitter`` take ``mesh=`` explicitly.  A
device may appear more than once, which is how one card (or the CPU)
holds a mesh with ``dp`` or ``sp`` above 1.
"""

import concurrent.futures
import contextlib
import dataclasses

import numpy as np
import torch

from nestfit_tpu_torch.device import resolve_device, same_device


def _normalize(device) -> torch.device:
    """``device`` resolved (a CUDA device without a card raises), a bare
    ``"cuda"`` given the current card's index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(dp, sp)`` grid of devices (``devices[i][j]``: dp row ``i``,
    channel slice ``j``)."""

    devices: tuple            # dp rows, each a tuple of sp torch.devices

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "sp": len(self.devices[0])}

    @property
    def dp(self) -> int:
        return len(self.devices)

    @property
    def sp(self) -> int:
        return len(self.devices[0])


def make_mesh(n_devices=None, sp=1, devices=None) -> Mesh:
    """Build a ``(dp, sp)`` mesh over ``devices`` (default: every visible
    CUDA device; without a card that default raises).  Pass
    ``devices=["cpu"] * n`` for a CPU mesh; a device may repeat."""
    if devices is None:
        _normalize("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_normalize(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    assert n_devices % sp == 0, (n_devices, sp)
    if not 0 < n_devices <= len(devices):
        raise ValueError(f"a mesh of {n_devices} devices from "
                         f"{len(devices)}")
    dp = n_devices // sp
    return Mesh(tuple(tuple(devices[i * sp:(i + 1) * sp])
                      for i in range(dp)))


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tensor of a batch lives on a mesh: ``spec`` names the mesh
    axis of each leading tensor axis (``("dp",)``: rows over dp;
    ``("dp", "sp")``: rows over dp and the last axis over sp; ``()``:
    a copy on every dp row)."""

    mesh: Mesh
    spec: tuple


def pixel_sharding(mesh: Mesh, shard_channels: bool = False) -> Placement:
    """Placement of per-pixel tensors ``[R, ...]``: rows over ``dp``,
    optionally the trailing channel axis over ``sp``."""
    return Placement(mesh, ("dp", "sp") if shard_channels else ("dp",))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def shard_bounds(n: int, dp: int) -> np.ndarray:
    """Bounds of ``dp`` contiguous shards of ``n`` rows or channels (the
    sizes differ by at most one): the one split rule of dp rows and sp
    channel slices."""
    return np.linspace(0, n, dp + 1).astype(int)


@dataclasses.dataclass(frozen=True)
class ShardedBatch:
    """A tree of per-pixel tensors split over a mesh's dp rows: shard
    ``k`` holds rows ``bounds[k]:bounds[k + 1]`` on row ``k``'s first
    device (with ``shard_channels``, each ``[R, ..., S]`` leaf is a
    tuple of ``sp`` channel slices on the row's devices)."""

    mesh: Mesh
    bounds: np.ndarray
    shards: tuple
    shard_channels: bool = False

    @property
    def n_rows(self) -> int:
        return int(self.bounds[-1])


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def shard_pixel_batch(mesh: Mesh, tree, shard_channels: bool = False):
    """Place a tree of per-pixel tensors on the mesh: each leaf with a
    leading axis is split into ``dp`` contiguous row shards, shard ``k``
    on row ``k``'s first device; 0-d leaves are copied to every row.
    With ``shard_channels`` a leaf of two or more axes is also split on
    its last axis into ``sp`` contiguous slices, one on each device of
    its row.  Returns a :class:`ShardedBatch`.

    ``run_nested`` and ``fit_batch`` take only a batch split without
    ``shard_channels``: the sp axis reaches the likelihood through
    ``Runner.placed``, which splits each spectrum's channel terms by the
    same :func:`shard_bounds`.  ``shard_channels`` keeps the JAX
    package's placement for a caller that works on the slices itself."""
    tree = _map(torch.as_tensor, tree)
    lead = {x.shape[0] for x in _leaves(tree) if x.ndim}
    if len(lead) > 1:
        raise ValueError(f"per-pixel leaves disagree on the row count: "
                         f"{sorted(lead)}")
    n = lead.pop() if lead else 0
    bounds = shard_bounds(n, mesh.dp)

    def put(k):
        row = mesh.devices[k]
        lo, hi = int(bounds[k]), int(bounds[k + 1])

        def leaf(x):
            if x.ndim == 0:
                return x.to(row[0])
            x = x[lo:hi]
            if shard_channels and x.ndim >= 2:
                cb = shard_bounds(x.shape[-1], len(row))
                return tuple(x[..., cb[j]:cb[j + 1]].to(dev).contiguous()
                             for j, dev in enumerate(row))
            return x.to(row[0])

        return _map(leaf, tree)

    return ShardedBatch(mesh, bounds, tuple(put(k) for k in range(mesh.dp)),
                        shard_channels)


def shard_rows(tree, rows: slice, n_rows: int, device):
    """Rows ``rows`` of every leaf of ``tree`` whose leading axis is the
    ``n_rows`` run axis, on ``device``; other leaves (0-d, or shared by
    every run) are copied whole."""
    def leaf(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.ndim >= 1 and x.shape[0] == n_rows:
            x = x[rows]
        return x.to(device)

    return _map(leaf, tree)


def pad_to_multiple(arr, multiple, axis=0, fill=0.0):
    """Pad ``axis`` up to the next multiple (returns array, n_valid)."""
    arr = np.asarray(arr)
    n = arr.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr, n
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - n)
    return np.pad(arr, widths, constant_values=fill), n


def _device_ctx(dev):
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


_WARM = set()


def _warm(dev):
    """Load PyTorch's lazily loaded CUDA linear-algebra library from this
    thread: its loader may run only once, and two dp rows reaching their
    first ``cholesky_ex`` together would both run it."""
    if dev.type == "cuda" and dev not in _WARM:
        torch.linalg.cholesky_ex(torch.eye(2, device=dev))
        _WARM.add(dev)


def shard_generators(mesh: Mesh, gen: torch.Generator):
    """One generator per dp row, on the row's first device.  With one row
    on the generator's own device that is ``gen`` itself (a ``(1, sp)``
    mesh draws as no mesh does); otherwise one seed per row is drawn from
    ``gen``, as the JAX package splits the run key over dp.  Rows that
    draw nothing get None (``gen`` None)."""
    rows = [row[0] for row in mesh.devices]
    if gen is None:
        return [None] * mesh.dp
    if mesh.dp == 1 and same_device(rows[0], gen.device):
        return [gen]
    seeds = torch.randint(0, 2**62, (mesh.dp,), generator=gen,
                          device=gen.device).tolist()
    gens = []
    for dev, s in zip(rows, seeds):
        g = torch.Generator(device=dev)
        g.manual_seed(int(s))
        gens.append(g)
    return gens


def run_shards(mesh: Mesh, gen: torch.Generator, n_rows: int, fn):
    """``fn(k, rows, devices, gen_k)`` for every dp row ``k`` of the mesh:
    ``rows`` the row's ``slice`` of the ``n_rows`` runs, ``devices`` its
    sp devices, ``gen_k`` its generator (:func:`shard_generators`).  Each
    row runs in its own thread with its first device current (one row
    runs in the caller's thread).  Returns the rows' results in row
    order; a row that raised re-raises here once every row has ended."""
    bounds = shard_bounds(n_rows, mesh.dp)
    if (np.diff(bounds) == 0).any():
        raise ValueError(f"{n_rows} runs cannot fill {mesh.dp} dp rows")
    gens = shard_generators(mesh, gen)

    def one(k):
        row = mesh.devices[k]
        with _device_ctx(row[0]):
            return fn(k, slice(int(bounds[k]), int(bounds[k + 1])), row,
                      gens[k])

    if mesh.dp == 1:
        return [one(0)]
    for row in mesh.devices:
        _warm(row[0])
        if row[0].type == "cuda":
            # the rows read tensors the caller's streams wrote
            torch.cuda.current_stream(row[0]).synchronize()
    with concurrent.futures.ThreadPoolExecutor(mesh.dp) as pool:
        futures = [pool.submit(one, k) for k in range(mesh.dp)]
        concurrent.futures.wait(futures)
    for k, f in enumerate(futures):
        if f.exception() is not None:
            raise RuntimeError(f"dp row {k} of {mesh.dp} failed") \
                from f.exception()
    out = [f.result() for f in futures]
    for row in mesh.devices:
        if row[0].type == "cuda":
            torch.cuda.current_stream(row[0]).synchronize()
    return out


def gather_rows(parts, device):
    """The per-row results ``parts`` (tensors, dicts, dataclasses) joined
    along their leading run axis on ``device``; non-tensor fields must
    agree across rows."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        if first.ndim == 0:
            return first.to(device)
        return torch.cat([p.to(device) for p in parts])
    if isinstance(first, dict):
        return {k: gather_rows([p[k] for p in parts], device) for k in first}
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: gather_rows([getattr(p, f.name) for p in parts], device)
            for f in dataclasses.fields(first)})
    if any(p != first for p in parts[1:]):
        raise ValueError(f"dp rows disagree on {first!r}")
    return first
