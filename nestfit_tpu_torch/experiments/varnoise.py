"""Evidence-vs-SNR model-selection study
(port of ``nestfit_tpu/experiments/varnoise.py``).

Synthetic two-component NH3 (1,1)+(2,2) spectra across a log-spaced SNR
ladder, fitted with ncomp = 1..``ncomp_max``; the evidence, BIC and AICc
each select a component count.  The whole (spectrum x noise level) grid
is one batched ``fit_batch`` per rung, in the traced mode by default
(CUDA graphs on the card).  The noise draws come from
``np.random.default_rng(seed)`` exactly as in the JAX package, so both
fit the same spectra.
"""

import logging

import numpy as np
import torch

from nestfit_tpu_torch import oracle
from nestfit_tpu_torch.device import resolve_device
from nestfit_tpu_torch.models import AmmoniaRunner, ammonia
from nestfit_tpu_torch.models.tables import AMMONIA_TRANSITIONS
from nestfit_tpu_torch.sampling import NSConfig, fit_batch
from nestfit_tpu_torch.utils import freq_axis_from_velocity

log = logging.getLogger("nestfit_tpu_torch.varnoise")


def run_varnoise_sweep(
    utrans,
    params=None,
    snr_levels=None,
    n_per_level=16,
    ncomp_max=2,
    nlive=100,
    tol=1.0,
    lnz_thresh=11.0,
    seed=5,
    vchan=0.158,
    segment_iters=0,
    device="cuda",
):
    """Fit synthetic 2-component spectra over an SNR ladder.

    Returns a dict of NumPy arrays keyed by metric, each of shape
    ``[n_levels, n_per_level]`` or ``[n_levels, n_per_level,
    ncomp_max + 1]`` (index 0 the null model): ``snr``, ``noise``,
    ``lnz``, ``lnz_err``, ``bic``, ``aicc`` and the selections
    ``nbest_lnz``, ``nbest_bic``, ``nbest_aicc``.  ``utrans`` must live on
    ``device`` (default the card); each rung draws from a
    ``torch.Generator`` seeded from ``np.random.SeedSequence(seed)``.
    """
    dev = resolve_device(device)
    if params is None:
        # canonical 2-comp truth (reference synth_spectra.py:251-258)
        params = np.array([
            -1.0, 1.5, 10.0, 15.0, 4.0, 6.0, 14.5, 15.0,
            0.3, 0.6, 0.0, 0.0,
        ])
    if snr_levels is None:
        snr_levels = np.geomspace(1.0, 100.0, 7)
    rng = np.random.default_rng(seed)

    vax = np.arange(-30, 30, vchan)
    xarrs = [freq_axis_from_velocity(vax, AMMONIA_TRANSITIONS[i].nu)
             for i in range(2)]
    truths = [oracle.amm_predict(x, params, trans_id=i + 1)
              for i, x in enumerate(xarrs)]
    peak = max(t.max() for t in truths)

    n_lev = len(snr_levels)
    R = n_lev * n_per_level
    noises = np.repeat(peak / np.asarray(snr_levels), n_per_level)  # [R]
    datas = [t[None, :] + rng.normal(scale=noises[:, None],
                                     size=(R, x.shape[0]))
             for x, t in zip(xarrs, truths)]

    shape = (n_lev, n_per_level)
    out = {
        "snr": np.asarray(snr_levels),
        "noise": noises.reshape(shape),
        **{k: np.full(shape + (ncomp_max + 1,), np.nan)
           for k in ("lnz", "lnz_err", "bic", "aicc")},
    }
    spectra = tuple(
        ammonia.make_ammonia_spectrum(x, d, noises.astype(np.float32),
                                      trans_id=i + 1, device=dev)
        for i, (x, d) in enumerate(zip(xarrs, datas)))
    for ncomp, ss in enumerate(np.random.SeedSequence(seed).spawn(ncomp_max),
                               start=1):
        runner = AmmoniaRunner(spectra, utrans, ncomp=ncomp, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(ss.generate_state(1, np.uint64)[0]
                            >> np.uint64(1)))
        log.info("varnoise: fitting ncomp=%d over %d spectra", ncomp, R)
        fit = fit_batch(gen, runner, R, NSConfig(nlive=nlive, tol=tol),
                        n_post=256, segment_iters=segment_iters, device=dev)

        def host(x):
            return x.cpu().numpy().reshape(shape)

        if ncomp == 1:
            out["lnz"][..., 0] = host(fit.null_lnz)
            out["bic"][..., 0] = host(fit.ics["null_BIC"])
            out["aicc"][..., 0] = host(fit.ics["null_AICc"])
        out["lnz"][..., ncomp] = host(fit.lnz)
        out["lnz_err"][..., ncomp] = host(fit.lnz_err)
        out["bic"][..., ncomp] = host(fit.ics["BIC"])
        out["aicc"][..., ncomp] = host(fit.ics["AICc"])

    # model selection per criterion (reference varnoise.py:77-209)
    lnz = out["lnz"]
    nbest = np.zeros(shape, dtype=int)
    for m in range(1, ncomp_max + 1):
        step = lnz[..., m] - lnz[..., m - 1]
        nbest[(nbest == m - 1) & (step > lnz_thresh)] = m
    out["nbest_lnz"] = nbest
    out["nbest_bic"] = np.nanargmin(out["bic"], axis=-1)
    out["nbest_aicc"] = np.nanargmin(out["aicc"], axis=-1)
    return out
