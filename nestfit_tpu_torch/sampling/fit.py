"""Fit orchestration: runner + nested sampler + posterior products
(port of ``FitResult``, ``fit_batch``, ``align_fit_meta``,
``merge_fit_rows`` and ``fit_single`` of ``nestfit_tpu/sampling/fit.py``)."""

import dataclasses
import threading

import numpy as np
import torch

from nestfit_tpu_torch.device import resolve_device, same_device
from nestfit_tpu_torch.models.runner import Runner
from nestfit_tpu_torch.sampling.results import (
    PosteriorProducts,
    information_criteria,
    posterior_products,
    resolve_n_post,
)
from nestfit_tpu_torch.sampling.sampler import (
    NSConfig,
    NSResult,
    _memo,
    _run_nested,
    _shard_data,
)
from nestfit_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class FitResult:
    """Everything a fit persists, for a batch of R runs."""

    ns: NSResult
    products: PosteriorProducts
    null_lnz: torch.Tensor   # [R]
    ics: dict                # BIC/AIC/AICc + null variants, each [R]
    ncomp: int
    n_params: int
    n_chan_tot: int

    @property
    def lnz(self):
        return self.ns.lnz

    @property
    def lnz_err(self):
        return self.ns.lnz_err


def _loglike2_for(runner: Runner, dtype):
    """``loglike2(u, data, live)`` of ``runner`` on fresh pixel data (it
    takes the sampler's live masks, ``takes_live``), one per runner and
    dtype, so the traced mode's graphs serve every call on the same
    runner."""
    def make():
        def loglike2(u, d, live=None):
            return runner.with_data(d).loglike_unit(u, live=live).to(dtype)
        loglike2.takes_live = True
        return loglike2, runner

    return _memo(("runner", id(runner), dtype), make)


#: runners placed on a mesh row's devices, per (runner, devices): the
#: traced mode's graphs then serve every call on the same runner
_PLACED = {}
_PLACED_CAP = 16
_PLACED_LOCK = threading.Lock()


def _placed(runner: Runner, devices) -> Runner:
    """``runner`` on a mesh row: itself when the row is its own device."""
    if len(devices) == 1 and same_device(devices[0], runner.device):
        return runner
    key = (id(runner), tuple(devices))
    with _PLACED_LOCK:
        if key not in _PLACED:
            while len(_PLACED) >= _PLACED_CAP:
                _PLACED.pop(next(iter(_PLACED)))
            _PLACED[key] = (runner.placed(devices), runner)
        return _PLACED[key][0]


def fit_batch(
    gen: torch.Generator,
    runner: Runner,
    n_runs: int,
    config: NSConfig = NSConfig(),
    n_post: int = 0,
    dtype=torch.float32,
    segment_iters: int = 0,
    data=None,
    active=None,
    device="cuda",
    mesh=None,
) -> FitResult:
    """Fit a batch of ``n_runs`` pixels with nested sampling.

    The runner's spectra hold per-pixel data with leading dim ``n_runs``
    (or unbatched data shared by every run).  ``gen`` is a caller-seeded
    ``torch.Generator`` on ``device``, where the runner must live too.
    ``active`` marks padding rows of a partial batch as born done.

    ``segment_iters=0`` (the default, as in the JAX package) runs the
    traced sampler (CUDA graphs on the card) on the runner's own spectra:
    ``data`` must then be None.  ``segment_iters > 0`` runs the segmented
    host loop of bounded segments, which takes ``data``
    (``runner.data_tree()``-structured) to substitute fresh pixel data
    while reusing this runner's channel terms.

    ``mesh`` (``parallel.make_mesh``) splits the batch over its dp rows:
    each row fits its contiguous share of the pixels (sampler, posterior
    products, information criteria) on its first device, in a thread of
    its own, with the runner placed there (its spectra split over the
    row's sp devices when ``sp > 1``) and a generator seeded from one
    draw of ``gen`` per row; a ``(1, 1)`` mesh on ``device`` is no mesh.
    ``data`` may be a ``parallel.ShardedBatch`` over the same mesh.  The
    result is joined in pixel order on ``device``.
    """
    dev = resolve_device(device)
    if runner.device != dev or gen.device != dev:
        raise ValueError(f"fit_batch on {dev}: runner is on {runner.device}, "
                         f"generator on {gen.device}")
    n_post = resolve_n_post(n_post, config.nlive)
    if not config.flat_dims and runner.utrans is not None:
        config = dataclasses.replace(
            config, flat_dims=tuple(runner.utrans.flat_dims(runner.ncomp)))
    traced = not (segment_iters and segment_iters > 0)
    if traced and data is not None:
        raise ValueError("data substitution needs segment_iters > 0; the "
                         "traced mode fits the runner's own spectra")
    if data is None:
        data = runner.data_tree()
    with span("fit.batch", ncomp=runner.ncomp, rows=n_runs,
              nlive=config.nlive, mode="traced" if traced else "segmented"):
        if mesh is None:
            return _fit_rows(gen, runner, n_runs, config, n_post, dtype,
                             segment_iters, data, active)
        from nestfit_tpu_torch.parallel import mesh as _mesh
        from nestfit_tpu_torch.sampling import graphs

        def row(k, rows, devices, gen_k):
            r_k = _placed(runner, devices)
            d_k = _shard_data(data, k, rows, n_runs, devices[0])
            a_k = None if active is None else np.asarray(active)[rows]
            fit = _fit_rows(gen_k, r_k, rows.stop - rows.start, config,
                            n_post, dtype, segment_iters, d_k, a_k, shard=k)
            return fit, graphs.thread_stats()

        parts = _mesh.run_shards(mesh, gen, n_runs, row)
        if traced:
            graphs.last_stats = sum((p[1] for p in parts),
                                    graphs.TracedStats())
        return _mesh.gather_rows([p[0] for p in parts], dev)


def _fit_rows(gen, runner, n_runs, config, n_post, dtype, segment_iters,
              data, active, shard=0) -> FitResult:
    """:func:`fit_batch` of ``n_runs`` pixels on the runner's device."""
    dev = runner.device
    with span("fit.sampler"):
        ns = _run_nested(gen, _loglike2_for(runner, dtype), runner.ndim,
                         n_runs, config, dtype, data, segment_iters, True,
                         active, shard=shard,
                         capture=not runner.spans_devices)
    r2 = runner.with_data(data)
    with span("fit.products"):
        products = posterior_products(ns, r2.transform, gen, n_post=n_post)
    null_lnz = torch.broadcast_to(
        torch.as_tensor(r2.null_lnZ, dtype=dtype, device=dev), ns.lnz.shape)
    ics = information_criteria(ns.max_loglike, null_lnz, r2.n_chan_tot,
                               r2.n_params)
    return FitResult(
        ns=ns,
        products=products,
        null_lnz=null_lnz,
        ics=ics,
        ncomp=runner.ncomp,
        n_params=runner.n_params,
        n_chan_tot=runner.n_chan_tot,
    )


def align_fit_meta(fit_b: FitResult, like: FitResult) -> FitResult:
    """``fit_b`` with its NSResult metadata (nlive, ndim, max_iter) set to
    ``like``'s, so that ``merge_fit_rows`` can merge the two.

    Used where a re-fit ran at a higher ``nlive`` with the base run's
    ``max_iter``: live-point arrays whose length disagrees are truncated
    to ``like``'s (their rows become an arbitrary subset -- harmless, the
    posterior products were computed from the full set inside
    ``fit_batch``, and the store keeps only those and scalar attributes).
    ``n_samples`` of such rows then undercounts by the nlive difference.
    """
    ns_b, ns_a = fit_b.ns, like.ns
    if (ns_b.nlive, ns_b.ndim, ns_b.max_iter) == (
            ns_a.nlive, ns_a.ndim, ns_a.max_iter):
        return fit_b
    L = ns_a.nlive
    ns_new = dataclasses.replace(
        ns_b,
        live_u=ns_b.live_u[:, :L],
        live_lnl=ns_b.live_lnl[:, :L],
        live_lnw=ns_b.live_lnw[:, :L],
        dead_u=ns_b.dead_u[:, : ns_a.max_iter],
        dead_lnl=ns_b.dead_lnl[:, : ns_a.max_iter],
        dead_lnw=ns_b.dead_lnw[:, : ns_a.max_iter],
        nlive=ns_a.nlive,
        ndim=ns_a.ndim,
        max_iter=ns_a.max_iter,
    )
    return dataclasses.replace(fit_b, ns=ns_new)


def merge_fit_rows(fit_a: FitResult, fit_b: FitResult, dst_rows,
                   src_rows, n_rows_a: int, n_rows_b: int) -> FitResult:
    """``fit_a`` with its run rows ``dst_rows`` replaced by rows
    ``src_rows`` of ``fit_b``, leaf by leaf, on the device.

    A tensor leaf is merged when its leading axis is ``n_rows_a`` in
    ``fit_a`` and ``n_rows_b`` in ``fit_b`` and the trailing shapes agree;
    any other leaf passes through from ``fit_a``.  Merged leaves are
    clones, so ``fit_a`` is left unchanged.  Metadata (nlive, ndim,
    max_iter, ncomp, ...) must agree: call ``align_fit_meta`` first.
    """
    dev = fit_a.lnz.device
    dst = torch.as_tensor(np.asarray(dst_rows, dtype=np.int64), device=dev)
    src = torch.as_tensor(np.asarray(src_rows, dtype=np.int64), device=dev)

    def mg(a, b):
        if isinstance(a, torch.Tensor):
            if (a.ndim >= 1 and a.shape[0] == n_rows_a and b.ndim >= 1
                    and b.shape[0] == n_rows_b
                    and a.shape[1:] == b.shape[1:]):
                out = a.clone()
                out[dst] = b[src]
                return out
            return a
        if isinstance(a, dict):
            return {k: mg(a[k], b[k]) for k in a}
        if dataclasses.is_dataclass(a):
            return dataclasses.replace(a, **{
                f.name: mg(getattr(a, f.name), getattr(b, f.name))
                for f in dataclasses.fields(a)})
        if a != b:
            raise ValueError(f"merge_fit_rows: metadata differ ({a!r} and "
                             f"{b!r}); align_fit_meta the fits first")
        return a

    return mg(fit_a, fit_b)


def fit_single(gen: torch.Generator, runner: Runner,
               config: NSConfig = NSConfig(nlive=400, tol=0.5),
               n_post: int = 0, dtype=torch.float32,
               device="cuda") -> FitResult:
    """Fit one spectrum (single-fit defaults nlive 400, tol 0.5) with
    :func:`fit_batch` at its defaults: the traced sampler."""
    return fit_batch(gen, runner, 1, config, n_post=n_post, dtype=dtype,
                     device=device)
