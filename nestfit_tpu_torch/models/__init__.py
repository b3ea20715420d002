"""Model registry: model names to their modules, as in
``nestfit_tpu/models/__init__.py``."""

from nestfit_tpu_torch.models import ammonia, diazenylium, gaussian
from nestfit_tpu_torch.models.runner import (
    AmmoniaRunner,
    DiazenyliumRunner,
    GaussianRunner,
    RUNNERS,
    Runner,
)
from nestfit_tpu_torch.models.spectrum import Spectrum, make_spectrum
from nestfit_tpu_torch.models.tables import (
    AMMONIA_TRANSITIONS,
    DIAZENYLIUM_TRANSITIONS,
    Transition,
)

MODELS = {module.NAME: module for module in (ammonia, diazenylium, gaussian)}
