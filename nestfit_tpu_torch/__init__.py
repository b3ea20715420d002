"""PyTorch/CUDA port of ``nestfit_tpu``: batched Bayesian decomposition of
NH3 (1,1)+(2,2), N2H+ and Gaussian-mixture spectra by nested sampling,
on an NVIDIA Hopper card.

Module names mirror the JAX package (``models/ammonia.py`` here is the
counterpart of ``nestfit_tpu/models/ammonia.py``), so each piece can be
held against its reference.  This package imports neither JAX nor
anything of ``nestfit_tpu``; it keeps its own copies of the NumPy-only
tables and FITS reader it needs.

Tensors live on an explicit ``device``.  The entry points
(``make_*_spectrum``, the prior constructors such as ``get_irdc_priors``,
the runners, ``fit_batch``, and the cube pipeline:
``DataCube.from_fits`` -> ``CubeStack`` -> ``CubeFitter.fit_cube``)
default to ``device="cuda"`` and raise on a host without a card; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels there.
Randomness comes from a caller-seeded ``torch.Generator`` on that device
(``CubeFitter`` seeds its own from ``seed``).  ``HdfStore`` and
``CubeFitter.fit_cube`` need ``h5py``; the rest does not.

The four hand-written Hopper kernels (``ops/fused.py``,
``ops/tables.py``; CUDA sources in ``csrc/``) are built with ``nvcc`` at
first use into ``nestfit_tpu_torch/_build/``.
"""

_CUBE_NAMES = ("CubeFitter", "CubeStack", "DataCube", "HdfStore", "NoiseMap",
               "NoiseMapUniform", "read_fits", "write_fits")
_SAMPLING_NAMES = ("ModeProducts", "posterior_modes")


def __getattr__(name):
    # the cube and sampling layers (and torch) load on first use of one
    # of their names
    if name in _CUBE_NAMES:
        from nestfit_tpu_torch import cube

        return getattr(cube, name)
    if name in _SAMPLING_NAMES:
        from nestfit_tpu_torch import sampling

        return getattr(sampling, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
