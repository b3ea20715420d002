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

``sampling.aot.precompile_fit`` prepares a fit before its first batch
(the kernel build, the handles, the traced mode's CUDA graphs);
``plotting`` draws the maps and per-pixel figures, importing matplotlib
only to render.

The four hand-written Hopper kernels (``ops/fused.py``,
``ops/tables.py``; CUDA sources in ``csrc/``) are built with ``nvcc`` at
first use into ``nestfit_tpu_torch/_build/``.
"""

# the flat API of ``nestfit_tpu/__init__.py`` (and a few names of the
# port's own), by the module each name lives in: each module (and torch)
# loads on the first use of one of its names
_LAZY = {
    "nestfit_tpu_torch.constants": ("CKMS", "CCMS", "FWHM", "H", "KB",
                                    "TCMB"),
    "nestfit_tpu_torch.models": (
        "AMMONIA_TRANSITIONS", "DIAZENYLIUM_TRANSITIONS", "MODELS",
        "AmmoniaRunner", "DiazenyliumRunner", "GaussianRunner", "Runner",
        "Spectrum", "Transition", "ammonia", "diazenylium", "gaussian",
        "make_spectrum"),
    "nestfit_tpu_torch.models.ammonia": (
        "amm_predict", "make_ammonia_spectrum", "partition_func",
        "partition_level", "swift_convert"),
    "nestfit_tpu_torch.models.diazenylium": ("make_diazenylium_spectrum",
                                             "nnhp_predict"),
    "nestfit_tpu_torch.models.gaussian": ("gauss_predict",
                                          "make_gaussian_spectrum"),
    "nestfit_tpu_torch.priors": (
        "CenSepPrior", "ConstantPrior", "Distribution", "DuplicatePrior",
        "OrderedPrior", "Prior", "PriorTransformer", "ResolvedCenSepPrior",
        "ResolvedPlacementPrior", "SpacedPrior", "get_diazenylium_priors",
        "get_gaussian_priors", "get_irdc_priors", "get_synth_priors",
        "make_distribution"),
    "nestfit_tpu_torch.sampling": (
        "MARGINAL_COLS", "QUANTILES", "NSConfig", "NSResult",
        "ModeProducts", "PosteriorProducts", "information_criteria",
        "posterior_modes", "posterior_products", "run_nested",
        "FitResult", "fit_batch", "fit_single"),
    "nestfit_tpu_torch.cube": (
        "CubeFitter", "CubeStack", "DataCube", "HdfStore", "NoiseMap",
        "NoiseMapUniform", "read_fits", "write_fits"),
    "nestfit_tpu_torch.cube.products": (
        "FitTable", "aggregate_run_attributes", "aggregate_run_pdfs",
        "aggregate_run_products", "apply_circular_mask",
        "convolve_evidence", "convolve_post_pdfs", "create_fits_from_store",
        "deblend_hf_intensity", "extended_masked_evidence",
        "generate_predicted_profiles", "get_indep_info_kernel",
        "postprocess_run", "postprocess_table", "quantize_conv_marginals",
        "take_by_components"),
    "nestfit_tpu_torch.parallel": ("make_mesh", "pixel_sharding",
                                   "shard_pixel_batch"),
    "nestfit_tpu_torch.synth": (
        "ParamSampler", "SyntheticSpectrum", "get_test_spectra",
        "make_fake_header", "make_indep_synth_cube",
        "make_synth_cube_arrays"),
    "nestfit_tpu_torch.utils": ("freq_axis_from_velocity", "get_logger",
                                "velocity_axis_from_freq"),
}
_MODULE_OF = {name: mod for mod, names in _LAZY.items() for name in names}

__version__ = "0.1.0"


def __getattr__(name):
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_MODULE_OF))
