"""The cube ladder's SNR bucket plan: each pixel's live-point level and
the batches in the order the fitter runs them.

Written from NestFit's ``CubeFitter`` (main.py:380-472) and the bucketed
form the port states: a pixel's peak signal-to-noise ratio is the
largest channel over the noise, over every transition, and no less than
0; its live count is ``nlive + int(nlive_snr_fact * snr)``.  Those
counts are put into at most ``nlive_buckets`` levels: the upper
``1/n, 2/n, .. 1`` quantiles of the counts (linear interpolation),
each snapped up to a multiple of 50, duplicates merged; a pixel takes
the least level at or above its count.  The batches run the levels in
ascending order, and in each level its pixels in ascending flat id in
slices of ``batch_size``.  At ``nlive_snr_fact`` 0 every pixel takes
one level, ``nlive`` snapped up to 50, in ``ceil(n / batch_size)``
batches.

Float64 NumPy; it imports nothing of the program.
"""

import dataclasses

import numpy as np

QUANTUM = 50


@dataclasses.dataclass
class Plan:
    level: np.ndarray     # [n_pix] the live-point level of each flat pixel
    batches: list         # [(level, flat pixel ids)] in the fitter's order

    @property
    def sizes(self) -> list:
        return [ids.size for _, ids in self.batches]

    def first_batches(self) -> list:
        """The first batch of each level, levels ascending."""
        seen = {}
        for level, ids in self.batches:
            seen.setdefault(level, ids)
        return list(seen.items())


def peak_snr(datas, rms) -> np.ndarray:
    """Per pixel, the largest channel over the noise ``rms`` (a number or
    one per pixel) over the transitions' spectra ``datas`` (each
    ``[n, S]``), and no less than 0."""
    noise = np.asarray(rms, dtype=np.float64)
    snr = np.zeros(np.shape(datas[0])[0])
    for d in datas:
        snr = np.maximum(snr, np.max(np.asarray(d, dtype=np.float64),
                                     axis=1) / noise)
    return snr


def bucket(nlive, n_buckets):
    """``(level per pixel, levels)`` of the per-pixel live counts
    ``nlive``.  The quantiles' positions are taken as ``np.linspace``
    gives them: ``k / n`` differs from it in the last bit for some ``n``,
    and a quantile that lies on a multiple of 50 would then snap across
    it."""
    nlive = np.asarray(nlive, dtype=np.float64)
    tops = np.quantile(nlive, np.linspace(0.0, 1.0, n_buckets + 1)[1:])
    levels = np.unique(np.ceil(tops / QUANTUM).astype(np.int64) * QUANTUM)
    return levels[np.searchsorted(levels, nlive, side="left")], levels


def plan(config, datas, rms) -> Plan:
    """The plan of a cube whose transitions' spectra are ``datas`` (each
    ``[n, S]``, rows in flat pixel order) under noise ``rms``, at the
    configuration's ``nlive``, ``nlive_snr_fact``, ``nlive_buckets`` and
    ``batch_size``."""
    snr = peak_snr(datas, rms)
    nlive = config["nlive"] + np.trunc(
        config["nlive_snr_fact"] * snr).astype(np.int64)
    level, levels = bucket(nlive, config["nlive_buckets"])
    size = config["batch_size"]
    batches = []
    for lv in levels.tolist():
        ids = np.flatnonzero(level == lv)
        batches += [(lv, ids[lo:lo + size])
                    for lo in range(0, ids.size, size)]
    return Plan(level, batches)
