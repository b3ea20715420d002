"""Runner layer: model + spectra + prior transform -> likelihood
(port of ``nestfit_tpu/models/runner.py``).

Broadcasting contract as in the JAX package: ``theta``/``u`` carry
leading batch dims ``[..., R, ndim]`` whose last batch axis is aligned
with the spectra's pixel axis.

Which path runs follows the tensors' device: on CUDA the likelihood is
one launch of the model's fused kernel per spectrum (its ``fused_chi2``:
K1 for NH3 and N2H+, K4 for the Gaussian mixture), on the CPU it is the
model's plain ``model_predict`` path.
``plain=True`` takes the plain path on any device; it is the reference
the kernels are held against.
"""

import dataclasses

import torch

from nestfit_tpu_torch.device import resolve_device
from nestfit_tpu_torch.models import ammonia as _ammonia
from nestfit_tpu_torch.models import diazenylium as _diazenylium
from nestfit_tpu_torch.models import gaussian as _gaussian
from nestfit_tpu_torch.models.spectrum import Spectrum


class Runner:
    """Evaluates the ln-likelihood of a model over a set of spectra.

    Attributes mirror the JAX package: ``n_model`` (params per
    component), ``ncomp``, ``n_params``, ``ndim``, ``n_chan_tot``,
    ``n_spec``, ``null_lnZ``.  The spectra and the prior tables are moved
    to ``device``.
    """

    model = None  # model module; set by subclasses

    def __init__(self, spectra, utrans, ncomp=1, device="cuda",
                 **predict_kwargs):
        self.device = resolve_device(device)
        if isinstance(spectra, Spectrum):
            spectra = (spectra,)
        if ncomp <= 0:
            raise ValueError("ncomp must be positive")
        self.spectra = tuple(s.to(self.device) for s in spectra)
        self.utrans = utrans.to(self.device) if utrans is not None else None
        self.ncomp = int(ncomp)
        self.predict_kwargs = predict_kwargs
        self.n_model = self.model.N
        self.n_params = self.n_model * self.ncomp
        self.ndim = self.n_params
        self.n_spec = len(self.spectra)
        self.n_chan_tot = sum(s.size for s in self.spectra)
        if utrans is not None and utrans.n_param != self.n_model:
            raise ValueError(f"prior transformer covers {utrans.n_param} "
                             f"parameters, model has {self.n_model}")

    @property
    def null_lnZ(self):
        """Ln-likelihood of the all-zero model."""
        return sum(s.null_lnZ for s in self.spectra)

    def data_tree(self):
        """The per-pixel tensors: ``((data, noise), ...)``."""
        return tuple((s.data, s.noise) for s in self.spectra)

    def with_data(self, data_tree):
        """New Runner with replaced per-pixel data/noise (the channel
        terms are shared with this instance)."""
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new.spectra = tuple(
            dataclasses.replace(spec, data=d, noise=n)
            for spec, (d, n) in zip(self.spectra, data_tree)
        )
        return new

    def predict(self, theta):
        """Model spectra per transition: tuple of ``[..., S_t]``."""
        return tuple(
            self.model.model_predict(spec, theta, **self.predict_kwargs)
            for spec in self.spectra
        )

    def log_likelihood(self, theta, plain: bool = False):
        """Summed chi-square ln-likelihood over all spectra."""
        if theta.is_cuda and not plain:
            return self._log_likelihood_fused(theta)
        preds = self.predict(theta)
        return sum(
            spec.loglikelihood(pred) for spec, pred in zip(self.spectra, preds)
        )

    def _log_likelihood_fused(self, theta):
        """Kernel path: one fused launch per transition.

        ``theta[..., R, ndim]`` is flattened to ``B = T * R`` rows; row
        ``b`` reads data row ``b % R``, so the per-pixel ``1/(2 sigma^2)``
        is tiled ``B // R`` times.
        """
        lead = theta.shape[:-1]
        flat = theta.reshape(-1, theta.shape[-1])
        B = flat.shape[0]
        total = 0.0
        for spec in self.spectra:
            chi2 = self.model.fused_chi2(spec, flat, **self.predict_kwargs)
            inv2v = 1.0 / (2.0 * spec.noise * spec.noise)
            if spec.noise.ndim:
                inv2v = inv2v.repeat(B // spec.noise.shape[0])
            total = total - chi2 * inv2v
        return total.reshape(lead)

    def transform(self, u, plain: bool = False):
        """Unit cube -> physical parameters via the prior transformer."""
        return self.utrans.transform(u, self.ncomp, plain)

    def loglike_unit(self, u, plain: bool = False):
        """Ln-likelihood straight from unit-cube coordinates (the
        function the sampler calls)."""
        return self.log_likelihood(self.transform(u, plain), plain)


class AmmoniaRunner(Runner):
    """Ammonia model runner; ``cold``/``lte`` map to the Swift conversion
    and Tex = Trot options."""

    model = _ammonia

    def __init__(self, spectra, utrans, ncomp=1, cold=False, lte=False,
                 device="cuda"):
        super().__init__(spectra, utrans, ncomp=ncomp, device=device,
                         cold=cold, lte=lte)


class GaussianRunner(Runner):
    """Gaussian mixture model runner."""

    model = _gaussian


class DiazenyliumRunner(Runner):
    """Diazenylium (N2H+) model runner."""

    model = _diazenylium


RUNNERS = {
    "ammonia": AmmoniaRunner,
    "gaussian": GaussianRunner,
    "diazenylium": DiazenyliumRunner,
}
