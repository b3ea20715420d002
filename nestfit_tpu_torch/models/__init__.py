from nestfit_tpu_torch.models import ammonia
from nestfit_tpu_torch.models.runner import AmmoniaRunner, Runner
from nestfit_tpu_torch.models.spectrum import Spectrum, make_spectrum
from nestfit_tpu_torch.models.tables import AMMONIA_TRANSITIONS, Transition
