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
``DataCube.from_fits`` -> ``CubeStack`` -> ``CubeFitter.fit_cube`` ->
``postprocess_run``) default to ``device="cuda"`` and raise on a host
without a card; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels there.
Randomness comes from a caller-seeded ``torch.Generator`` on that device
(``CubeFitter`` seeds its own from ``seed``).  ``HdfStore``,
``CubeFitter.fit_cube`` and the store-reading product steps need
``h5py``; the rest does not (``FitTable.from_records`` and
``postprocess_table`` compute the map products from the fitter's host
records).

The four hand-written Hopper kernels (``ops/fused.py``,
``ops/tables.py``; CUDA sources in ``csrc/``) are built with ``nvcc`` at
first use into ``nestfit_tpu_torch/_build/``.
"""

_CUBE_NAMES = ("CubeFitter", "CubeStack", "DataCube", "HdfStore", "NoiseMap",
               "NoiseMapUniform", "read_fits", "write_fits")
_PRODUCT_NAMES = ("FitTable", "aggregate_run_attributes", "aggregate_run_pdfs",
                  "aggregate_run_products", "apply_circular_mask",
                  "convolve_evidence", "convolve_post_pdfs",
                  "create_fits_from_store", "deblend_hf_intensity",
                  "extended_masked_evidence", "generate_predicted_profiles",
                  "get_indep_info_kernel", "postprocess_run",
                  "postprocess_table", "quantize_conv_marginals",
                  "take_by_components")
_SAMPLING_NAMES = ("ModeProducts", "posterior_modes")
_SYNTH_NAMES = ("ParamSampler", "SyntheticSpectrum", "get_test_spectra",
                "make_fake_header", "make_indep_synth_cube",
                "make_synth_cube_arrays")
_UTILS_NAMES = ("freq_axis_from_velocity", "get_logger",
                "velocity_axis_from_freq")


def __getattr__(name):
    # each layer (and torch) loads on first use of one of its names
    if name in _CUBE_NAMES:
        from nestfit_tpu_torch import cube

        return getattr(cube, name)
    if name in _PRODUCT_NAMES:
        from nestfit_tpu_torch.cube import products

        return getattr(products, name)
    if name in _SAMPLING_NAMES:
        from nestfit_tpu_torch import sampling

        return getattr(sampling, name)
    if name in _SYNTH_NAMES:
        from nestfit_tpu_torch import synth

        return getattr(synth, name)
    if name in _UTILS_NAMES:
        from nestfit_tpu_torch import utils

        return getattr(utils, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
