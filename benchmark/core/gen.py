"""The input generator: synthetic cubes of two-component spectra.

One generator serves every traffic mix; a mix is its parameters.  Per
pixel it draws the truth parameters of two velocity components, in the
order the mix lists them, with one ``numpy`` generator:

- a parameter given as ``{"first": F, "sep": [lo, hi]}`` (the
  centroid) is ``[v0, v0 + s]``, ``v0`` a draw from ``F`` (or ``F``
  itself when it is a number, which draws nothing) and ``s`` a draw from
  ``[lo, hi]``;
- a parameter given as ``[lo, hi]`` is two independent uniform draws;
- a parameter given as a number is that number for both (no draw).

Then the noise-free spectra come from the reference's float64 forward
model, and white noise of the mix's ``rms`` is added, transition by
transition, after every pixel's truth is drawn.

The truths come from the mix's own ``truth_seed``; the run's generator
only deals them out in an order of its own before it draws the noise.
Every run then fits the same set of pixels, so that runs of different
seeds do the same work, in another order and under other noise.  With the same
generator state this draws what ``nestfit_tpu_torch/synth.py``'s
``ParamSampler`` and ``make_synth_cube_arrays`` draw (the NH3 mixes),
and what ``chip_smoke.py::n2hp_cube`` draws (the N2H+ mix).
"""

import dataclasses
import importlib

import numpy as np
import torch

from reference import hyperfine

NCOMP = 2


@dataclasses.dataclass
class Inputs:
    """A synthetic cube: per transition ``(trans_id, xarr, data[n, S])``
    (float64, the host's), the noise rms and the truth."""

    spectra: list
    rms: float
    params: np.ndarray

    @property
    def n_pix(self) -> int:
        return self.params.shape[0]


def draw_params(spec, n_pix, rng):
    """Truth ``[n_pix, len(spec) * 2]``, parameter-major."""
    out = np.empty((n_pix, len(spec) * NCOMP))
    for i in range(n_pix):
        row = []
        for _name, p in spec:
            if isinstance(p, dict):
                first = p["first"]
                v0 = rng.uniform(*first) if isinstance(first, list) \
                    else float(first)
                row.append([v0, v0 + rng.uniform(*p["sep"])])
            elif isinstance(p, list):
                row.append(rng.uniform(*p, size=NCOMP))
            else:
                row.append(np.full(NCOMP, float(p)))
        out[i] = np.concatenate(row)
    return out


def axes(config):
    """``[(trans_id, xarr)]`` of the configuration's spectra."""
    va = config["velocity_axis"]
    vel = np.arange(va["start"], va["stop"], va["step"])
    return [(tid, hyperfine.freq_axis(
        vel, hyperfine.transition(config["model"], tid)["nu"]))
        for tid in config["transitions"]]


def model_module(config):
    return importlib.import_module(f"reference.model_{config['model']}")


def predict(config, xarr_list, params, device="cpu", chunk=4096):
    """Noise-free float64 spectra ``[n, S]`` per transition."""
    model = model_module(config)
    out = []
    for tid, xarr in xarr_list:
        ax = hyperfine.make_axis(config["model"], tid, xarr, torch.float64,
                                 device)
        parts = [model.predict(ax, torch.as_tensor(
            params[k:k + chunk], dtype=torch.float64, device=device))
            for k in range(0, params.shape[0], chunk)]
        out.append(torch.cat(parts).cpu().numpy())
    return out


def make_inputs(config, traffic, n_pix, rng, device="cpu") -> Inputs:
    """The mix's ``n_pix`` truths (from its ``truth_seed``), dealt out in
    an order drawn from ``rng``, and their noisy spectra."""
    params = draw_params(traffic["params"], n_pix, np.random.default_rng(
        int(traffic["truth_seed"])))[rng.permutation(n_pix)]
    return observe(config, params, float(traffic["rms"]), rng, device)


def observe(config, params, rms, rng, device="cpu") -> Inputs:
    """Spectra of the truths ``params`` with white noise of ``rms`` drawn
    from ``rng``, transition by transition."""
    xs = axes(config)
    clean = predict(config, xs, params, device)
    spectra = []
    for (tid, xarr), d in zip(xs, clean):
        spectra.append((tid, xarr, d + rng.normal(scale=rms, size=d.shape)))
    return Inputs(spectra, rms, params)
