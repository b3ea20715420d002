"""Fit orchestration: runner + nested sampler + posterior products
(port of ``FitResult`` and the segmented ``fit_batch`` of
``nestfit_tpu/sampling/fit.py``)."""

import dataclasses

import torch

from nestfit_tpu_torch.device import resolve_device
from nestfit_tpu_torch.models.runner import Runner
from nestfit_tpu_torch.sampling.results import (
    PosteriorProducts,
    information_criteria,
    posterior_products,
    resolve_n_post,
)
from nestfit_tpu_torch.sampling.sampler import NSConfig, NSResult, run_nested


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


def fit_batch(
    gen: torch.Generator,
    runner: Runner,
    n_runs: int,
    config: NSConfig = NSConfig(),
    n_post: int = 0,
    dtype=torch.float32,
    segment_iters: int = 250,
    data=None,
    active=None,
    device="cuda",
) -> FitResult:
    """Fit a batch of ``n_runs`` pixels with nested sampling.

    The runner's spectra hold per-pixel data with leading dim ``n_runs``
    (or unbatched data shared by every run); ``data``
    (``runner.data_tree()``-structured) substitutes fresh pixel data.
    ``gen`` is a caller-seeded ``torch.Generator`` on ``device``, where the
    runner must live too.  ``active`` marks padding rows of a partial
    batch as born done.  Only the segmented sampler is ported
    (``segment_iters > 0``).
    """
    dev = resolve_device(device)
    if runner.device != dev or gen.device != dev:
        raise ValueError(f"fit_batch on {dev}: runner is on {runner.device}, "
                         f"generator on {gen.device}")
    n_post = resolve_n_post(n_post, config.nlive)
    if not config.flat_dims and runner.utrans is not None:
        config = dataclasses.replace(
            config, flat_dims=tuple(runner.utrans.flat_dims(runner.ncomp)))
    if data is None:
        data = runner.data_tree()

    def loglike2(u, d):
        return runner.with_data(d).loglike_unit(u).to(dtype)

    ns = run_nested(gen, loglike2, runner.ndim, n_runs, config, dtype=dtype,
                    data=data, segment_iters=segment_iters, active=active)
    r2 = runner.with_data(data)
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
