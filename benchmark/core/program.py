"""The system under test: ``nestfit_tpu_torch``'s entries, driven as
users drive them, and the tap that reads what they produce.

This module and the entries (``entries/<entry>.py``, named by a traffic
mix's ``"entry"``, each an ``Entry`` class) are the only ones of the
benchmark that import the program.

The tap sits on the public ``fit_batch`` as the cube fitter's module
names it, so it sees every call the ladder makes, however the ladder
groups its pixels into calls.  It tells a call's pixels by their data
(an exact fingerprint of each row's float32 spectrum) and keeps, for
each real row, the evidence, its error, null evidence, best lnL, call
count, marginal quantiles and best-fit parameters, and for a few rows
drawn from the seed the sampled points themselves (dead points in death
order, the live points left, with their ln-likelihoods) and the
posterior samples drawn from them, copied to the host as the call
returns.
"""

import contextlib

import numpy as np
import torch

N_SAMPLE_ROWS = 16    # rows per call whose points the reference re-works


def fingerprint(x):
    """An exact fingerprint of each row of the float32 spectra ``x``
    ``[n, S]`` (a host array or a tensor): the bit patterns of its
    channels, weighted by channel, summed in int64."""
    if isinstance(x, torch.Tensor):
        bits = x.detach().to(torch.float32).contiguous().view(
            torch.int32).to(torch.int64)
        w = 2 * torch.arange(bits.shape[-1], device=bits.device) + 1
        return torch.sum(bits * w, dim=-1).cpu().numpy()
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.int32)
    w = 2 * np.arange(bits.shape[-1], dtype=np.int64) + 1
    return np.sum(bits.astype(np.int64) * w, axis=-1)


class Tap:
    def __init__(self, rng: np.random.Generator, n_sample=N_SAMPLE_ROWS):
        self.rng = rng
        self.n_sample = n_sample
        self.runs = []
        self.unit = 0
        self.spans = None      # trace.Spans of a traced run
        self.pixel_of = {}     # fingerprint -> flat pixel id

    def know_pixels(self, data):
        """Learn the pixels from the first spectrum ``data[n, S]`` as the
        program is handed it."""
        fp = fingerprint(data)
        self.pixel_of = {int(f): i for i, f in enumerate(fp)}
        if len(self.pixel_of) != len(fp):
            raise ValueError("two pixels share a fingerprint")

    def span(self, name):
        """A host span of the trace, named after the unit it lies in."""
        if self.spans is None:
            return contextlib.nullcontext()
        return self.spans.span(f"unit {self.unit}: {name}")

    @contextlib.contextmanager
    def on(self, module, name="fit_batch"):
        """Tap ``module.<name>`` (``fit_batch``) while the block runs."""
        real = getattr(module, name)

        def tapped(*a, **k):
            config = k.get("config", a[3] if len(a) > 3 else None)
            n_runs = k.get("n_runs", a[2] if len(a) > 2 else None)
            runner = k.get("runner", a[1] if len(a) > 1 else None)
            active = k.get("active")
            rows = np.arange(n_runs) if active is None else \
                np.flatnonzero(np.asarray(active))
            with self.span(f"fit_batch ncomp={runner.ncomp} "
                           f"rows={rows.size} nlive={config.nlive}"):
                out = real(*a, **k)
            fp = fingerprint(k["data"][0][0])[rows]
            self.take(out, rows, [self.pixel_of.get(int(f), -1) for f in fp],
                      config)
            return out

        setattr(module, name, tapped)
        try:
            yield
        finally:
            setattr(module, name, real)

    def take(self, fit, rows, pixels, cfg):
        """Record one ``fit_batch`` call: its real rows ``rows`` are the
        flat pixels ``pixels`` (-1: not a pixel of the cube), fitted with
        config ``cfg``."""
        ns, prod = fit.ns, fit.products
        rows = np.asarray(rows)
        at = torch.as_tensor(rows, device=ns.lnz.device)

        def host(x):
            return x[at].detach().to("cpu", copy=True).numpy()

        rc = cfg.resolved(ns.ndim)
        pick = np.sort(self.rng.choice(rows.size, min(rows.size,
                                                      self.n_sample),
                                       replace=False))
        idx = at[torch.as_tensor(pick, device=at.device)]
        n_dead = ns.n_dead[idx].to("cpu", copy=True).numpy()
        top = int(n_dead.max()) if n_dead.size else 0
        self.runs.append(dict(
            unit=self.unit, ncomp=fit.ncomp, nlive=ns.nlive, ndim=ns.ndim,
            kill_k=rc.kill_k, max_iter=ns.max_iter,
            n_init_dead=rc.n_init_dead(), pixels=np.asarray(pixels),
            lnz=host(fit.lnz), lnz_err=host(fit.lnz_err),
            null=host(fit.null_lnz), maxl=host(ns.max_loglike),
            ncall=host(ns.ncall), marg=host(prod.marginals),
            best=host(prod.bestfit_params),
            sample=dict(rows=pick, n_dead=n_dead,
                        dead_u=ns.dead_u[idx, :top].cpu().numpy(),
                        dead_lnl=ns.dead_lnl[idx, :top].cpu().numpy(),
                        live_u=ns.live_u[idx].cpu().numpy(),
                        live_lnl=ns.live_lnl[idx].cpu().numpy(),
                        post=prod.posteriors[idx].cpu().numpy())))


def modules():
    """The parts of the program the entries drive."""
    import nestfit_tpu_torch.cube as cube
    import nestfit_tpu_torch.models as models
    import nestfit_tpu_torch.priors as priors
    from nestfit_tpu_torch.sampling import aot, fit, graphs, sampler

    return cube, models, priors, aot, fit, graphs, sampler


def build_kernels():
    """Build the kernels into the checkout's cache (a hit after the first
    run of a checkout)."""
    from nestfit_tpu_torch.ops import _build

    return _build.build_all()


def ns_config(config):
    _, _, _, _, _, _, sampler = modules()
    return sampler.NSConfig(nlive=config["nlive"], tol=config["tol"],
                            init_factor=config["init_factor"],
                            max_iter=config.get("max_iter", 0))


def runner_parts(config, device):
    _, models, priors, _, _, _, _ = modules()
    runner_cls = getattr(models, config["runner"])
    utrans = getattr(priors, config["prior_constructor"])(device=device)
    return runner_cls, utrans


def next_pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


def fit_module_of_fitter():
    """The module whose ``fit_batch`` the cube fitter calls."""
    import nestfit_tpu_torch.cube.fitter as fitter

    return fitter
