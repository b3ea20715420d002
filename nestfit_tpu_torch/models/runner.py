"""Runner layer: model + spectra + prior transform -> likelihood
(port of ``nestfit_tpu/models/runner.py``).

Broadcasting contract as in the JAX package: ``theta``/``u`` carry
leading batch dims ``[..., R, ndim]`` whose last batch axis is aligned
with the spectra's pixel axis.

Which path runs follows the tensors' device: on CUDA the likelihood is
one launch of the model's one-launch likelihood over every spectrum
(its ``fused_lnl``: K1's ``hf_lnl_fused`` for NH3 and N2H+) where the
runner's input allows it, else one launch of the model's fused kernel
per spectrum (its ``fused_chi2``: K1 for NH3 and N2H+, K4 for the
Gaussian mixture); on the CPU it is the model's plain ``model_predict``
path.  ``plain=True`` takes the plain path on any device; it is the
reference the kernels are held against.

The likelihood runs over channel slices: one per spectrum, or, on a
runner placed on a mesh row (:meth:`Runner.placed`) with several
devices, one contiguous slice per device.  The same kernel (or plain
path) runs on every slice for the same proposals and the partial
chi-square is summed on the row's first device, where the whole spectra
stay for ``null_lnZ``, ``n_chan_tot`` and the information criteria.
"""

import copy
import dataclasses

import numpy as np
import torch

from nestfit_tpu_torch.device import resolve_device, same_device
from nestfit_tpu_torch.models import ammonia as _ammonia
from nestfit_tpu_torch.models import diazenylium as _diazenylium
from nestfit_tpu_torch.models import gaussian as _gaussian
from nestfit_tpu_torch.models.spectrum import Spectrum
from nestfit_tpu_torch.parallel.mesh import shard_bounds


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
        # per spectrum, ((lo, hi, channel terms of the slice), ...): one
        # slice here, one per device of a mesh row after ``placed``
        self.channel_slices = _channel_slices(self.spectra, (self.device,))
        # the prior transformer moved to other devices (``transform``)
        self._utrans_on = {}
        if utrans is not None and utrans.n_param != self.n_model:
            raise ValueError(f"prior transformer covers {utrans.n_param} "
                             f"parameters, model has {self.n_model}")

    @classmethod
    def from_data(cls, spec_data, utrans, **kwargs):
        """Build from ``(xarr, data, noise, trans_id)`` tuples, one
        spectrum each, on the runner's ``device`` (``kwargs``, default
        ``"cuda"``); ``kwargs`` pass on to the constructor."""
        device = resolve_device(kwargs.pop("device", "cuda"))
        spectra = tuple(
            cls.model.make_model_spectrum(xarr, data, noise, trans_id=tid,
                                          device=device)
            for (xarr, data, noise, tid) in spec_data
        )
        return cls(spectra, utrans, device=device, **kwargs)

    def placed(self, devices) -> "Runner":
        """A copy of this runner on a mesh row: spectra and prior tables on
        ``devices[0]``, and each spectrum's channel terms split into
        ``len(devices)`` contiguous slices, slice ``j`` on ``devices[j]``
        (the likelihood then sums their partial chi-square)."""
        devices = tuple(torch.device(d) for d in devices)
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new.device = devices[0]
        new.spectra = tuple(s.to(devices[0]) for s in self.spectra)
        if self.utrans is not None and not same_device(devices[0],
                                                       self.device):
            new.utrans = copy.deepcopy(self.utrans).to(devices[0])
        new._utrans_on = {}
        new.channel_slices = _channel_slices(new.spectra, devices)
        return new

    @property
    def spans_devices(self) -> bool:
        """Whether the likelihood runs on more than one device."""
        return any(not same_device(terms.dnu.device, self.device)
                   for slices in self.channel_slices
                   for _, _, terms in slices)

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

    @property
    def one_launch(self) -> bool:
        """Whether the fused likelihood is the model's one launch over
        every spectrum (its ``fused_lnl``): the model has one, no
        ``predict_kwargs`` flag (``cold``, ``lte``) is set, and every
        spectrum is one channel slice on the runner's device."""
        return (hasattr(self.model, "fused_lnl")
                and not any(self.predict_kwargs.values())
                and all(len(slices) == 1
                        and same_device(slices[0][2].dnu.device, self.device)
                        for slices in self.channel_slices))

    def log_likelihood(self, theta, plain: bool = False, live=None):
        """Summed chi-square ln-likelihood over all spectra (``live``: see
        :meth:`_log_likelihood`)."""
        return self._log_likelihood(theta, fused=theta.is_cuda and not plain,
                                    live=live)

    def _log_likelihood(self, theta, fused: bool, live=None):
        """Per spectrum, the chi-square of every channel slice on the
        slice's device, summed on the runner's device, then scaled by
        ``1 / (2 sigma^2)``.

        ``fused``: where :attr:`one_launch`, the model's ``fused_lnl``
        (every spectrum, the scaling included); else the model's
        ``fused_chi2`` per slice (its kernel on CUDA tensors, the kernel's
        plain version on CPU tensors).  ``theta[..., R, ndim]`` is
        flattened to ``B = T * R`` rows; row ``b`` reads data row
        ``b % R``, so the per-pixel ``1/(2 sigma^2)`` is tiled ``B // R``
        times.  Otherwise the model's plain ``model_predict`` path,
        broadcast over ``theta``'s leading dims.

        ``live`` (``ops.fused.live_rows``: bool masks shaped as trailing
        dims of ``theta.shape[:-1]``) names the points the caller reads;
        the one launch computes only those, the others reading the
        sampler's log-zero.  Every other path computes every point.
        """
        lead = theta.shape[:-1]
        if fused:
            theta = theta.reshape(-1, theta.shape[-1])
            if self.one_launch:
                return self.model.fused_lnl(
                    self.spectra, theta.to(self.device),
                    live=live).reshape(lead)
        total = 0.0
        for spec, slices in zip(self.spectra, self.channel_slices):
            chi2 = 0.0
            for lo, hi, terms in slices:
                dev = terms.dnu.device
                part = dataclasses.replace(
                    terms, data=spec.data[..., lo:hi].to(dev).contiguous())
                th = theta.to(dev)
                if fused:
                    c = self.model.fused_chi2(part, th, **self.predict_kwargs)
                else:
                    resid = part.data - self.model.model_predict(
                        part, th, **self.predict_kwargs)
                    c = torch.sum(resid * resid, dim=-1)
                chi2 = chi2 + c.to(self.device)
            if fused:
                inv2v = 1.0 / (2.0 * spec.noise * spec.noise)
                if spec.noise.ndim:
                    inv2v = inv2v.repeat(theta.shape[0]
                                         // spec.noise.shape[0])
                total = total - chi2 * inv2v
            else:
                total = total - chi2 / (2.0 * spec.noise ** 2)
        return total.reshape(lead) if fused else total

    def transform(self, u, plain: bool = False):
        """Unit cube -> physical parameters via the prior transformer
        (points on another device than the runner's go through a copy of
        the tables there)."""
        if self.utrans is None or same_device(u.device, self.device):
            return self.utrans.transform(u, self.ncomp, plain)
        ut = self._utrans_on.get(u.device)
        if ut is None:
            ut = self._utrans_on[u.device] = copy.deepcopy(
                self.utrans).to(u.device)
        return ut.transform(u, self.ncomp, plain)

    def loglike_unit(self, u, plain: bool = False, live=None):
        """Ln-likelihood straight from unit-cube coordinates (the
        function the sampler calls; ``live``: the points it reads, see
        :meth:`_log_likelihood`)."""
        return self.log_likelihood(self.transform(u, plain), plain, live)

    def loglikelihood(self, utheta):
        """Host entry point: the ln-likelihood of unit-cube points
        ``utheta`` (array-like ``[..., ndim]``, as float32) through
        :meth:`loglike_unit` on the runner's device, as a NumPy array."""
        u = torch.as_tensor(utheta, dtype=torch.float32, device=self.device)
        return self.loglike_unit(u).cpu().numpy()


def _channel_slices(spectra, devices):
    """Per spectrum, ``((lo, hi, terms), ...)``: its channels split into
    ``len(devices)`` contiguous slices by ``parallel.mesh.shard_bounds``,
    ``terms`` the slice's channel terms on its device (no data: the
    likelihood slices the runner's current data).  On one device the
    terms are views of the spectrum's own tensors."""
    out = []
    for spec in spectra:
        bounds = shard_bounds(spec.size, len(devices))
        if (np.diff(bounds) == 0).any():
            raise ValueError(f"{spec.size} channels cannot fill "
                             f"{len(devices)} sp slices")
        out.append(tuple(
            (int(lo), int(hi), dataclasses.replace(
                spec, dnu=spec.dnu[lo:hi].to(dev).contiguous(),
                t0=spec.t0[lo:hi].to(dev).contiguous(),
                tbg=spec.tbg[lo:hi].to(dev).contiguous(),
                data=None, noise=None, size=int(hi - lo)))
            for lo, hi, dev in zip(bounds[:-1], bounds[1:], devices)))
    return tuple(out)


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
