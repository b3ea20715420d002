"""The native C++ engine (``cpp/nestfit_native.cpp``) through ctypes."""

from nestfit_tpu_torch.native.bindings import (
    amm_predict_native,
    available,
    ns_gaussian,
    ns_spectral_ammonia,
    placement_spec_from_utrans,
    ppf_tables_from_utrans,
    transform_native,
)
