"""Carry state across from the JAX package.

Each function takes one of the JAX package's objects as a plain dict of
NumPy arrays and Python scalars (its dataclass fields by name) and
returns the port's object on ``device``, so both packages can be fed the
same spectra, prior tables and sampler state.  Array dtypes are kept
(float32 stays float32, int32 int32, bool bool).  ``device`` defaults to
``"cuda"`` and raises without a card, as every entry point of the port.  This module imports
nothing of JAX; the caller turns JAX arrays into NumPy.
"""

import dataclasses

import numpy as np
import torch

from nestfit_tpu_torch.device import resolve_device
from nestfit_tpu_torch.models.spectrum import Spectrum
from nestfit_tpu_torch.priors.distributions import Distribution
from nestfit_tpu_torch.sampling.fit import FitResult
from nestfit_tpu_torch.sampling.results import PosteriorProducts
from nestfit_tpu_torch.sampling.sampler import NSResult, _State


def _tensor(x, device):
    return torch.as_tensor(np.array(x), device=device)


def _build(cls, fields: dict, device, skip=()):
    device = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in skip or not f.init:   # derived in __post_init__
            continue
        v = fields[f.name]
        kw[f.name] = _tensor(v, device) if isinstance(v, np.ndarray) else v
    return kw


def spectrum_from_dict(fields: dict, device="cuda") -> Spectrum:
    """``Spectrum`` from the fields of ``nestfit_tpu.models.spectrum.
    Spectrum``."""
    return Spectrum(**_build(Spectrum, fields, device))


def distribution_from_dict(fields: dict, device="cuda") -> Distribution:
    """``Distribution`` from the tables and metadata of
    ``nestfit_tpu.priors.distributions.Distribution``."""
    return Distribution(**_build(Distribution, fields, device))


def state_from_dict(fields: dict, gen: torch.Generator) -> _State:
    """Sampler state from the fields of ``nestfit_tpu.sampling.sampler.
    _State``.  The JAX PRNG ``key`` has no counterpart: ``gen`` (whose
    device is the state's) takes its place.  ``bounds`` is a tuple of
    arrays (or empty), ``i`` becomes a host integer."""
    dev = gen.device
    kw = _build(_State, fields, dev, skip=("gen", "i", "bounds"))
    return _State(gen=gen, i=int(fields["i"]),
                  bounds=tuple(_tensor(b, dev) for b in fields["bounds"]),
                  **kw)


def result_from_dict(fields: dict, device="cuda") -> NSResult:
    """``NSResult`` from the fields of ``nestfit_tpu.sampling.sampler.
    NSResult``."""
    return NSResult(**_build(NSResult, fields, device))


def fit_result_from_dict(fields: dict, device="cuda") -> FitResult:
    """``FitResult`` from the fields of ``nestfit_tpu.sampling.fit.
    FitResult``: ``ns`` and ``products`` are dicts of their own
    dataclasses' fields, ``ics`` a dict of arrays."""
    device = resolve_device(device)
    return FitResult(
        ns=result_from_dict(fields["ns"], device),
        products=PosteriorProducts(
            **_build(PosteriorProducts, fields["products"], device)),
        null_lnz=_tensor(fields["null_lnz"], device),
        ics={k: _tensor(v, device) for k, v in fields["ics"].items()},
        ncomp=int(fields["ncomp"]),
        n_params=int(fields["n_params"]),
        n_chan_tot=int(fields["n_chan_tot"]),
    )
