"""The same priors built in both packages, for the port tests of the
prior classes (``test_torch_priors.py``) and of the native binding's
tables (``test_torch_native.py``)."""

import numpy as np

import jax.numpy as jnp

from nestfit_tpu import priors as jax_pr
from nestfit_tpu.priors import distributions as jax_dists

from nestfit_tpu_torch import priors as pr
from nestfit_tpu_torch.priors import make_distribution

PRIOR_KINDS = ["duplicate", "ordered", "spaced", "censep", "resolved_censep"]


def grid():
    x = np.linspace(-4, 4, 500)
    return x, np.exp(-0.5 * (x / 1.7) ** 2) + 0.05


def prior_pair(kind):
    """``(JAX transformer, port transformer)`` of one prior class over
    three grids: a centred Gaussian bump, positive offsets and widths."""
    x_sep = np.linspace(0.1, 2.6, 300)
    x_sig = np.linspace(0.05, 2.0, 300)
    grids = [grid(), (x_sep, np.ones_like(x_sep)), (x_sig, np.exp(-x_sig))]

    def build(m, mk):
        d = [mk(x, f) for x, f in grids]
        return {
            "duplicate": lambda: [m.DuplicatePrior(d[0], 0, 1)],
            "ordered": lambda: [m.OrderedPrior(d[0], 0), m.Prior(d[2], 1)],
            "spaced": lambda: [m.SpacedPrior(m.Prior(d[0], 0),
                                             m.Prior(d[1], 0)),
                               m.Prior(d[2], 1)],
            "censep": lambda: [m.CenSepPrior(m.Prior(d[0], 0),
                                             m.Prior(d[1], 0)),
                               m.Prior(d[2], 1)],
            "resolved_censep": lambda: [m.ResolvedCenSepPrior(
                m.Prior(d[0], 0), m.Prior(d[1], 0), m.Prior(d[2], 1),
                scale=1.2)],
        }[kind]()

    return (jax_pr.PriorTransformer(build(jax_pr, lambda x, f:
                                          jax_dists.make_distribution(
                                              x, f, dtype=jnp.float32))),
            pr.PriorTransformer(build(pr, lambda x, f: make_distribution(
                x, f, device="cpu"))))
