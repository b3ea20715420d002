from nestfit_tpu_torch.priors.constructors import get_irdc_priors
from nestfit_tpu_torch.priors.distributions import (
    Distribution,
    cdf_interp,
    cdf_over_interval,
    make_distribution,
    ppf_interp,
    tapered_interval_invert,
)
from nestfit_tpu_torch.priors.priors import (
    ConstantPrior,
    Prior,
    PriorTransformer,
    ResolvedPlacementPrior,
)
