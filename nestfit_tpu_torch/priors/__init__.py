from nestfit_tpu_torch.priors.constructors import (
    get_diazenylium_priors,
    get_gaussian_priors,
    get_irdc_priors,
    get_synth_priors,
)
from nestfit_tpu_torch.priors.distributions import (
    Distribution,
    cdf_interp,
    cdf_over_interval,
    make_distribution,
    ppf_interp,
    tapered_interval_invert,
)
from nestfit_tpu_torch.priors.priors import (
    CenSepPrior,
    ConstantPrior,
    DuplicatePrior,
    OrderedPrior,
    Prior,
    PriorTransformer,
    ResolvedCenSepPrior,
    ResolvedPlacementPrior,
    SpacedPrior,
)
