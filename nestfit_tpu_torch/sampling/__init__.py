from nestfit_tpu_torch.sampling.fit import (
    FitResult,
    align_fit_meta,
    fit_batch,
    fit_single,
    merge_fit_rows,
)
from nestfit_tpu_torch.sampling.results import (
    MARGINAL_COLS,
    QUANTILES,
    ModeProducts,
    PosteriorProducts,
    information_criteria,
    posterior_modes,
    posterior_products,
    resolve_n_post,
)
from nestfit_tpu_torch.sampling.sampler import NSConfig, NSResult, run_nested
