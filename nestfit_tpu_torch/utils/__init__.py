from nestfit_tpu_torch.utils.axes import (
    freq_axis_from_velocity,
    velocity_axis_from_freq,
)
from nestfit_tpu_torch.utils.logging import get_logger
