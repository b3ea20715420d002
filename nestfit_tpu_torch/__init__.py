"""PyTorch/CUDA port of ``nestfit_tpu``: batched Bayesian decomposition of
NH3 (1,1)+(2,2) spectra by nested sampling, on an NVIDIA Hopper card.

Module names mirror the JAX package (``models/ammonia.py`` here is the
counterpart of ``nestfit_tpu/models/ammonia.py``), so each piece can be
held against its reference.  This package imports neither JAX nor
anything of ``nestfit_tpu``; it keeps its own copies of the NumPy-only
tables it needs.

Tensors live on an explicit ``device``.  The entry points
(``make_ammonia_spectrum``, ``get_irdc_priors``, ``AmmoniaRunner``,
``fit_batch``) default to ``device="cuda"`` and raise on a host without a
card; pass ``device="cpu"`` to run the plain PyTorch versions of the
kernels there.  Randomness comes from a caller-seeded ``torch.Generator``
on that device.

The three hand-written Hopper kernels (``ops/fused.py``,
``ops/tables.py``; CUDA sources in ``csrc/``) are built with ``nvcc`` at
first use into ``nestfit_tpu_torch/_build/``.
"""
