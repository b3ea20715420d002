"""Post-processing: dense map products (port of
``nestfit_tpu/cube/products.py``).

Two layers.

*Array layer* (no ``h5py``).  A ``FitTable`` -- read from a store, or
built from the fitter's ``BatchRecords`` with ``FitTable.from_records``
-- and the tensors of earlier products go in; each step returns its
products as tensors on one device, cast and laid out as the store holds
them: maps transposed to ``(..., b, l)``, ``nbest``/``conv_nbest`` int32,
``post_pdfs``, ``conv_post_pdfs``, ``conv_marginals``, ``hf_deblended``
and ``model_spec/*`` float32, the rest float64.  So a step sees exactly
what the JAX chain reads back from the store.  ``postprocess_table`` runs
every step.  The arithmetic is float64, as the reference's NumPy is,
except where the reference's own arithmetic is float32 (the log of the
float32 ``post_pdfs``, the CDF of the float32 ``conv_post_pdfs``, the FITS
sums): there its operations are reproduced in float32, one by one.

*Store layer*.  The JAX package's functions, with their names and
signatures and a ``device`` keyword (default ``"cuda"``, which raises
without a card): each reads its inputs from the store as the JAX one
does, calls the array layer and writes with ``store.create_dataset``.
It touches ``h5py`` only through the store it is handed.

Convolutions: ``convolve_nan`` is ``scipy.ndimage.convolve`` with
``mode="nearest"`` (replicated edges of any width) as a flipped-kernel
``conv2d``, NaN-normalised as astropy's ``convolve``;
``convolve_fft_unnorm`` is ``scipy.signal.fftconvolve(mode="same")`` at
the full linear size with ``torch.fft``.
"""

import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from nestfit_tpu_torch.device import resolve_device
from nestfit_tpu_torch.utils import get_logger

log = get_logger("nestfit_tpu_torch.products")

# posteriors go to the device in slices of pixel rows of at most this many
# bytes; each (parameter, component) column is then histogrammed in float64
ROW_SLICE_BYTES = 1 << 30
_F64 = torch.float64


def nans(shape, dtype=_F64, device="cuda"):
    return torch.full(shape, math.nan, dtype=dtype,
                      device=resolve_device(device))


def _stored(x):
    """``x`` with its axes reversed (NumPy's ``transpose()``), contiguous."""
    return x.permute(*reversed(range(x.ndim))).contiguous()


def _nanmin(x, dim):
    """``np.nanmin`` along ``dim``: NaN where every value is NaN."""
    nan = torch.isnan(x)
    out = torch.where(nan, math.inf, x).amin(dim)
    return torch.where(nan.all(dim), math.nan, out)


def _nanmax(x, dim):
    nan = torch.isnan(x)
    out = torch.where(nan, -math.inf, x).amax(dim)
    return torch.where(nan.all(dim), math.nan, out)


def _linspace(lo, hi, num):
    """``np.linspace(lo[i], hi[i], num)`` for each row ``i``, with NumPy's
    operations (``i * step + lo``, the last value ``hi``), so the values
    are NumPy's bit for bit (``torch.linspace`` computes them otherwise)."""
    lo, hi = lo.reshape(-1, 1), hi.reshape(-1, 1)
    div = num - 1
    delta = hi - lo
    step = delta / div
    i = torch.arange(num, dtype=lo.dtype, device=lo.device)
    # NumPy's branch for a step that underflows to zero
    y = torch.where(step == 0, (i / div) * delta, i * step) + lo
    y[:, -1] = hi[:, 0]
    return y


def _sequential_sum(x):
    """Sum over dim 0 in order, from ``x[0]``: NumPy's ``add.reduce`` over
    an axis that is not the innermost in memory, in ``x``'s dtype."""
    acc = x[0].clone()
    for i in range(1, x.shape[0]):
        acc += x[i]
    return acc


# ---------------------------------------------------------------------------
# convolution primitives (astropy.convolution equivalents)
# ---------------------------------------------------------------------------

def gaussian_kernel_2d(sigma):
    """Normalized 2-D Gaussian kernel (NumPy), odd-sized at 8 sigma like
    ``astropy.convolution.Gaussian2DKernel``."""
    size = int(8 * sigma + 0.5)
    size = size + 1 if size % 2 == 0 else size
    size = max(size, 3)
    ax = np.arange(size) - size // 2
    g = np.exp(-0.5 * (ax / sigma) ** 2)
    k = np.outer(g, g)
    return k / k.sum()


def _as_kernel(kernel):
    if isinstance(kernel, (int, float)):
        return gaussian_kernel_2d(kernel)
    return np.asarray(kernel)


def _correlate_same(x, w, extend):
    """``(P, 1, H, W)`` correlated with the 2-D ``w``, output ``(P, 1, H, W)``
    aligned as ``ndimage.convolve`` aligns the flipped kernel; edges
    replicated (``extend``) or zero."""
    H, W = x.shape[-2:]
    kh, kw = w.shape
    lo_h, lo_w = (kh - 1) // 2, (kw - 1) // 2
    if extend:
        # clamped indices replicate the edge however wide the pad
        ih = torch.arange(-lo_h, H + kh - 1 - lo_h, device=x.device)
        iw = torch.arange(-lo_w, W + kw - 1 - lo_w, device=x.device)
        x = x[:, :, ih.clamp(0, H - 1)][:, :, :, iw.clamp(0, W - 1)]
    else:
        x = F.pad(x, (lo_w, kw - 1 - lo_w, lo_h, kh - 1 - lo_h))
    # a direct convolution: where every input under the kernel is zero
    # the output is exactly zero (the NaN test below needs it; an FFT or
    # Winograd algorithm of cuDNN would leave rounding residue)
    with torch.backends.cudnn.flags(enabled=False):
        return F.conv2d(x, w[None, None])


def convolve_nan(data, kernel, boundary="extend"):
    """NaN-aware normalized convolution (astropy ``convolve`` semantics:
    NaN treated as missing and interpolated over; edges replicated with
    ``boundary="extend"``, zero otherwise) of the tensor ``data``, on its
    device, in float64.

    ``data`` may carry leading batch axes; the kernel (a Gaussian sigma
    in pixels, or a 2-D array) acts on the two trailing (sky) axes of
    every plane in one call.  Where no valid pixel lies under the kernel
    the result is NaN.
    """
    kernel = _as_kernel(kernel)
    kernel = kernel / kernel.sum()
    w = torch.as_tensor(kernel[::-1, ::-1].copy(), dtype=_F64,
                        device=data.device)
    x = data.to(_F64).reshape((-1, 1) + tuple(data.shape[-2:]))
    valid = torch.isfinite(x)
    extend = boundary == "extend"
    num = _correlate_same(torch.where(valid, x, 0.0), w, extend)
    den = _correlate_same(valid.to(_F64), w, extend)
    out = torch.where(den == 0, math.nan, num / den)
    return out.reshape(data.shape)


def convolve_fft_unnorm(data, kernel):
    """Unnormalized FFT convolution of the tensor ``data`` with NaNs
    zero-filled (the reference's ``convolve_fft(...,
    normalize_kernel=False)`` use; the caller re-masks NaN positions), in
    float64 on ``data``'s device.

    Batched: the kernel acts on the two trailing axes.  The transform is
    at the full linear size, cropped to ``data``'s size as
    ``scipy.signal.fftconvolve(mode="same")`` crops.
    """
    k = torch.as_tensor(_as_kernel(kernel), dtype=_F64, device=data.device)
    H, W = data.shape[-2:]
    kh, kw = k.shape
    size = (H + kh - 1, W + kw - 1)
    filled = torch.where(torch.isfinite(data), data, 0.0).to(_F64)
    full = torch.fft.irfft2(torch.fft.rfft2(filled, s=size)
                            * torch.fft.rfft2(k, s=size), s=size)
    h0, w0 = (kh - 1) // 2, (kw - 1) // 2
    return full[..., h0:h0 + H, w0:w0 + W]


# ---------------------------------------------------------------------------
# selection / kernel utilities
# ---------------------------------------------------------------------------

def take_by_components(data, comps, axis=0, incl_zero=True):
    """Per map pixel, pick the model plane matching its component count.

    ``data`` (a tensor) has a model axis ``axis`` of size ncomp_max and
    trailing sky axes matching the integer tensor ``comps``; pixels whose
    count is below the inclusion floor come back NaN.
    """
    planes = torch.movedim(data, axis, 0)          # [M, ..., *sky]
    run_ix = (comps.long() - 1).clamp(0, planes.shape[0] - 1)
    mid = planes.ndim - 1 - comps.ndim
    gather = run_ix.reshape((1,) * (mid + 1) + tuple(comps.shape))
    gather = gather.expand((1,) + tuple(planes.shape[1:]))
    out = torch.gather(planes, 0, gather)[0]
    floor = 0 if incl_zero else 1
    return torch.where(comps < floor, math.nan, out)


def apply_circular_mask(kernel, radius=None):
    """Exact circular-aperture weighting of a (NumPy) kernel by subpixel
    supersampling."""
    kernel = np.asarray(kernel, dtype=float)
    nx, ny = kernel.shape
    if radius is None:
        radius = min(nx, ny) / 2
    corner_dist = np.sqrt((nx / 2) ** 2 + (ny / 2) ** 2)
    if radius > corner_dist:
        return kernel
    if nx % 2 == 0 or ny % 2 == 0:
        raise ValueError(f"Kernel dimensions must be odd: ({nx}, {ny})")
    # subpixel-sampled circular overlap fraction per cell
    sub = 10
    yy, xx = np.mgrid[0:nx * sub, 0:ny * sub]
    xc = (xx + 0.5) / sub - nx / 2
    yc = (yy + 0.5) / sub - ny / 2
    inside = (xc**2 + yc**2) <= radius**2
    frac = inside.reshape(nx, sub, ny, sub).mean(axis=(1, 3))
    return frac * kernel


def get_indep_info_kernel(sigma, nrad=1, sigma_taper=None):
    """Independent-information weights (NumPy) for convolving maps
    produced with a Gaussian beam of width ``sigma`` (pixels).

    Each offset cell is weighted by one minus the fraction of the beam's
    information it shares with the center pixel, normalized by the
    points-per-beam, with the center pinned to 1.
    """
    from scipy import special

    if not isinstance(nrad, int) or nrad < 0:
        raise ValueError(f"nrad must be a non-negative int, not {nrad!r}")
    if nrad == 0:
        return np.array([[1.0]])
    side = np.arange(-nrad, nrad + 1, dtype=float)
    # integral of the unit Gaussian over each unit cell, per axis:
    # Phi((x+1/2)/sigma) - Phi((x-1/2)/sigma) via the normal CDF
    cell = special.ndtr((side + 0.5) / sigma) - special.ndtr(
        (side - 0.5) / sigma
    )
    shared = np.outer(cell, cell)                  # beam mass per cell
    peak_amp = 1.0 / (2 * np.pi * sigma**2)
    ppbeam = max(1.0, 2 * np.pi * sigma**2)
    weights = (1.0 - shared / peak_amp) / ppbeam
    if sigma_taper is not None:
        yy, xx = np.meshgrid(side, side, indexing="ij")
        weights = weights * np.exp(
            -0.5 * (xx**2 + yy**2) / sigma_taper**2
        )
    weights[nrad, nrad] = 1.0
    return weights


# ---------------------------------------------------------------------------
# store or records -> struct-of-arrays table (single pass)
# ---------------------------------------------------------------------------

class FitTable:
    """Struct-of-arrays view of every fit of a cube, on the host.

    ``pix``: dict of [n_pix] arrays (i_lon, i_lat, nbest).
    ``runs[ncomp]``: dict with [n_fit] attr arrays, [n_fit, ...] dataset
    stacks, and ``pix_row`` linking each fit to its pixel.
    The header values the steps read: ``n_lon``, ``n_lat``, ``ncomp_max``,
    ``n_params``, ``lnz_thresh`` and ``model`` (the model module).
    ``h2d_bytes`` counts the bytes the steps copied from the table to a
    CUDA device (``tensor``).
    """

    ATTR_KEYS = (
        "null_lnZ", "global_lnZ", "global_lnZ_err", "BIC", "AIC", "AICc",
        "null_BIC", "null_AIC", "null_AICc",
    )
    DSET_KEYS = ("map_params", "bestfit_params", "marginals", "posteriors")

    def __init__(self, store, with_posteriors=False):
        attrs = store.hdf.attrs
        pixels = ((g.attrs["i_lon"], g.attrs["i_lat"],
                   g.attrs.get("nbest", -1),
                   [(g[name].attrs, g[name]) for name in g])
                  for g in store.iter_pix_groups())
        self._fill(pixels, with_posteriors, attrs.get("naxis1"),
                   attrs.get("naxis2"), attrs.get("n_max_components"),
                   attrs.get("n_params"), attrs.get("lnZ_threshold"),
                   store.model)

    @classmethod
    def from_records(cls, batches, n_lon, n_lat, ncomp_max, n_params,
                     lnz_thresh, model, with_posteriors=False):
        """The table of the fitter's ``BatchRecords`` (``batches``), equal to
        ``FitTable(store)`` of the store ``fit_cube`` writes from them;
        the header values are those ``fit_cube`` writes into the store
        (``naxis1``, ``naxis2``, ``n_max_components``, ``n_params``,
        ``lnZ_threshold``, the model module)."""
        nbest, runs = {}, {}
        for batch in batches:
            nbest.update(zip(batch.pixel_ix.tolist(), batch.nbest.tolist()))
            for pix, ncomp, record in batch.records:
                runs.setdefault(pix, {})[ncomp] = record
        # the store's order: pixels by (lon, lat), runs by group name
        pixels = ((pix // n_lat, pix % n_lat, nbest[pix],
                   [runs[pix][n] for n in sorted(runs[pix], key=str)])
                  for pix in sorted(runs))
        table = cls.__new__(cls)
        table._fill(pixels, with_posteriors, n_lon, n_lat, ncomp_max,
                    n_params, lnz_thresh, model)
        return table

    def _fill(self, pixels, with_posteriors, n_lon, n_lat, ncomp_max,
              n_params, lnz_thresh, model):
        dsets = self.DSET_KEYS if with_posteriors else self.DSET_KEYS[:3]
        pix_cols = {"i_lon": [], "i_lat": [], "nbest": []}
        runs = {}
        self.marg_quantiles = None
        for row, (i_lon, i_lat, nbest, fits) in enumerate(pixels):
            pix_cols["i_lon"].append(i_lon)
            pix_cols["i_lat"].append(i_lat)
            pix_cols["nbest"].append(nbest)
            for attrs, data in fits:
                if self.marg_quantiles is None:
                    self.marg_quantiles = np.asarray(attrs["marg_quantiles"])
                rec = runs.setdefault(int(attrs["ncomp"]), {"pix_row": []})
                rec["pix_row"].append(row)
                for key in self.ATTR_KEYS:
                    rec.setdefault(key, []).append(attrs[key])
                for key in dsets:
                    rec.setdefault(key, []).append(data[key][...])
        self.pix = {k: np.asarray(v) for k, v in pix_cols.items()}
        self.runs = {
            n: {k: np.asarray(v) for k, v in rec.items()}
            for n, rec in runs.items()
        }
        self.n_lon, self.n_lat = int(n_lon), int(n_lat)
        self.ncomp_max, self.n_params = int(ncomp_max), int(n_params)
        self.lnz_thresh = lnz_thresh
        self.model = model
        self.h2d_bytes = 0

    @property
    def n_pix(self):
        return self.pix["i_lon"].size

    def tensor(self, array, device):
        """``array`` (host) as a tensor on ``device``, counted in
        ``h2d_bytes`` when that is a CUDA device."""
        array = np.asarray(array)
        if device.type == "cuda":
            self.h2d_bytes += array.nbytes
        return torch.as_tensor(array, device=device)


# ---------------------------------------------------------------------------
# array layer: one function per step, tensors in the store's layout out
# ---------------------------------------------------------------------------

def attribute_maps(tab, device="cuda"):
    """Dense ``nbest`` / ``evidence`` / ``evidence_err`` / ``BIC`` / ``AIC``
    / ``AICc`` maps by index scatters (``aggregate_run_attributes``)."""
    dev = resolve_device(device)
    n_lon, n_lat, m = tab.n_lon, tab.n_lat, tab.ncomp_max
    lons = tab.tensor(tab.pix["i_lon"], dev)
    lats = tab.tensor(tab.pix["i_lat"], dev)
    nbest = torch.full((n_lon, n_lat), -1, dtype=torch.int32, device=dev)
    nbest[lons, lats] = tab.tensor(tab.pix["nbest"], dev).to(torch.int32)
    planes = {name: nans((n_lon, n_lat, m + 1), device=dev)
              for name in ("evidence", "evidence_err", "BIC", "AIC", "AICc")}
    cols = {"evidence": "global_lnZ", "evidence_err": "global_lnZ_err",
            "BIC": "BIC", "AIC": "AIC", "AICc": "AICc"}
    for ncomp, rec in tab.runs.items():
        rows = tab.tensor(rec["pix_row"], dev)
        rl, rb = lons[rows], lats[rows]
        for name, key in cols.items():
            planes[name][rl, rb, ncomp] = tab.tensor(rec[key], dev)
            if ncomp == 1 and name != "evidence_err":
                # plane 0 holds the null (zero-component) model figures
                null = "null_lnZ" if name == "evidence" else f"null_{key}"
                planes[name][rl, rb, 0] = tab.tensor(rec[null], dev)
    out = {"nbest": _stored(nbest)}
    out.update((name, _stored(p)) for name, p in planes.items())
    return out


def evidence_convolution(evidence, nbest, kernel, ncomp_max, lnz_thresh):
    """``(conv_nbest, conv_evidence)`` from the stored ``evidence`` [m+1, b,
    l] and ``nbest`` [b, l]: the smoothed evidence and the model ladder
    climbed on it, each pixel held to one step above its own ``nbest``
    (``convolve_evidence``)."""
    smoothed = convolve_nan(evidence, kernel)
    chosen = torch.zeros(smoothed.shape[1:], dtype=torch.int32,
                         device=smoothed.device)
    for rung in range(int(ncomp_max)):
        clears = smoothed[rung + 1] - smoothed[rung] > float(lnz_thresh)
        chosen = chosen + ((chosen == rung) & clears).to(torch.int32)
    chosen = torch.where(nbest == -1, -1, chosen)
    chosen = torch.where(chosen - nbest >= 2,
                         torch.minimum(chosen, nbest + 1), chosen)
    return chosen.to(torch.int32), smoothed


def masked_evidence(evidence, gain_evidence, kernel, lnz_thresh=3):
    """``mext_evidence`` [b, l]: the evidence with confidently detected
    pixels (gain of ``gain_evidence`` above ``lnz_thresh``) blanked,
    smoothed again (``extended_masked_evidence``)."""
    gain = gain_evidence[1] - gain_evidence[0]
    detected = gain > lnz_thresh
    smoothed = convolve_nan(torch.where(detected[None], math.nan, evidence),
                            kernel)
    mext = smoothed[1] - smoothed[0]
    return torch.where(torch.isnan(gain) | detected, math.nan, mext)


def product_maps(tab, conv_nbest, device="cuda"):
    """Dense MAP / best-fit / marginal cubes of each pixel's run at its
    ``conv_nbest`` (``aggregate_run_products``)."""
    dev = resolve_device(device)
    n_lon, n_lat = tab.n_lon, tab.n_lat
    m, p = tab.ncomp_max, tab.n_params
    n_margs = len(tab.marg_quantiles)
    nbest_data = _stored(conv_nbest.to(dev))            # [l, b]
    lons = tab.tensor(tab.pix["i_lon"], dev)
    lats = tab.tensor(tab.pix["i_lat"], dev)
    maps = {"nbest_MAP": nans((n_lon, n_lat, p, m), device=dev),
            "nbest_bestfit": nans((n_lon, n_lat, p, m), device=dev),
            "nbest_marginals": nans((n_lon, n_lat, n_margs, p, m),
                                    device=dev)}
    keys = {"nbest_MAP": "map_params", "nbest_bestfit": "bestfit_params",
            "nbest_marginals": "marginals"}
    for ncomp, rec in tab.runs.items():
        rows = tab.tensor(rec["pix_row"], dev)
        rl, rb = lons[rows], lats[rows]
        # only pixels whose (convolved) selection equals this run count
        sel = nbest_data[rl, rb] == ncomp
        if not bool(sel.any()):
            continue
        rl, rb = rl[sel], rb[sel]
        for name, key in keys.items():
            vals = tab.tensor(rec[key], dev)[sel]
            maps[name][rl, rb, ..., :ncomp] = vals.reshape(
                (-1,) + tuple(maps[name].shape[2:-1]) + (ncomp,)).to(_F64)
    out = {"marg_quantiles": tab.tensor(tab.marg_quantiles, dev)}
    out.update((name, _stored(x)) for name, x in maps.items())
    return out


def _batched_histogram(values, edges):
    """Row-wise histogram: ``values[N, S]`` against shared ``edges[B]`` ->
    counts ``[N, B-1]`` with ``np.histogram``'s bins (right-open, the last
    right-closed; values outside the edges and NaN dropped), compared in
    the edges' dtype."""
    values = values.to(edges.dtype)
    n_rows = values.shape[0]
    n_bins = edges.numel() - 1
    idx = torch.searchsorted(edges, values, right=True) - 1
    # np.histogram puts values equal to the last edge into the final bin
    idx = torch.where(values == edges[-1], n_bins - 1, idx)
    ok = (idx >= 0) & (idx < n_bins) & ~torch.isnan(values)
    row = torch.arange(n_rows, device=values.device)[:, None]
    # dropped values count into one extra bin, cut off below
    flat = torch.where(ok, row * n_bins + idx, n_rows * n_bins)
    counts = torch.bincount(flat.reshape(-1), minlength=n_rows * n_bins + 1)
    return counts[:-1].reshape(n_rows, n_bins)


def pdf_maps(tab, nbest_marginals=None, par_bins=None, device="cuda"):
    """``(pdf_bins, post_pdfs)``: each run's posterior samples histogrammed
    per pixel, parameter and component, normalised per histogram
    (``aggregate_run_pdfs``).  Without ``par_bins`` each parameter gets
    200 edges from the smallest ``min`` to the largest ``max`` quantile of
    the stored ``nbest_marginals``.  The table must hold the posteriors;
    they go to the device in slices of pixel rows and are histogrammed
    one (parameter, component) column at a time in float64."""
    dev = resolve_device(device)
    n_lon, n_lat = tab.n_lon, tab.n_lat
    m, p = tab.ncomp_max, tab.n_params
    if par_bins is None:
        n_bins = 200
        marg = nbest_marginals.to(dev)                # [m, p, M, b, l]
        lo = _nanmin(marg[:, :, 0].transpose(0, 1).reshape(p, -1), 1)
        hi = _nanmax(marg[:, :, 8].transpose(0, 1).reshape(p, -1), 1)
        par_bins = _linspace(lo, hi, n_bins)
    else:
        par_bins = torch.as_tensor(np.asarray(par_bins), device=dev)
        n_bins = par_bins.shape[1]
    lons = tab.tensor(tab.pix["i_lon"], dev)
    lats = tab.tensor(tab.pix["i_lat"], dev)
    pdfs = nans((m, m, p, n_bins - 1, n_lat, n_lon), dtype=torch.float32,
                device=dev)
    for ncomp, rec in tab.runs.items():
        rows = tab.tensor(rec["pix_row"], dev)
        rl, rb = lons[rows], lats[rows]
        post = rec["posteriors"]                      # host [N, S, D+2]
        step = max(1, ROW_SLICE_BYTES // post[0].nbytes)
        for lo in range(0, post.shape[0], step):
            chunk = tab.tensor(post[lo:lo + step], dev)
            cl, cb = rl[lo:lo + step], rb[lo:lo + step]
            for i_p in range(p):
                for i_m in range(ncomp):
                    counts = _batched_histogram(
                        chunk[:, :, i_p * ncomp + i_m], par_bins[i_p])
                    counts = counts.to(_F64)
                    hist = counts / counts.sum(1, keepdim=True)
                    pdfs[ncomp - 1, i_m, i_p][:, cb, cl] = hist.T.float()
    bin_mids = (par_bins[:, :-1] + par_bins[:, 1:]) / 2
    return bin_mids, pdfs


def pdf_convolution(post_pdfs, evidence, conv_nbest, kernel,
                    evid_weight=True):
    """``conv_post_pdfs``: evidence-weighted log-space spatial smoothing of
    the stored float32 ``post_pdfs`` [r, m, p, h, b, l], one batched FFT
    convolution per run index, renormalised over the bins and re-masked
    with the input's NaNs (``convolve_post_pdfs``)."""
    nan_in = torch.isnan(post_pdfs)
    floor = torch.tensor(1e-32, dtype=post_pdfs.dtype,
                         device=post_pdfs.device)
    # the reference's float32 log, correctly rounded
    logp = torch.log(torch.where(post_pdfs > 0, post_pdfs, floor).to(_F64))
    logp = torch.where(nan_in, math.nan, logp.to(post_pdfs.dtype).to(_F64))
    if evid_weight:
        z_best = take_by_components(evidence[1:], conv_nbest)
        rel = z_best - evidence[0]
        rel = rel - _nanmin(rel.reshape(-1), 0)
        rel = rel / _nanmax(rel.reshape(-1), 0)
        logp = logp * rel
    out = torch.empty_like(post_pdfs)
    for r in range(logp.shape[0]):
        pdf = torch.exp(convolve_fft_unnorm(logp[r], kernel))
        pdf = pdf / torch.nansum(pdf, dim=2, keepdim=True)
        out[r] = torch.where(nan_in[r], math.nan, pdf).to(out.dtype)
    return out


def _invert_cdf_rows(cdf, xs, qs):
    """Vectorized CDF inversion: ``cdf[..., H]`` monotone rows against
    shared abscissa ``xs[H]`` at quantiles ``qs[Q]`` -> ``[..., Q]`` in
    float64 (the batched form of ``np.interp(qs, cdf_row, xs)``); rows
    that are not all finite come back NaN, quantiles outside a row are
    clamped to the table's ends, and flat segments interpolate at 0."""
    H = cdf.shape[-1]
    flat = cdf.reshape(-1, H).to(_F64)
    xs = xs.to(device=flat.device, dtype=_F64)
    bad = ~torch.isfinite(flat).all(dim=1)
    ramp = _linspace(flat.new_zeros(1), flat.new_ones(1), H)
    safe = torch.where(bad[:, None], ramp, flat)
    qs = torch.as_tensor(qs).tolist()
    out = torch.empty((flat.shape[0], len(qs)), dtype=_F64,
                      device=flat.device)
    for i_q, q in enumerate(qs):
        k = (safe < q).sum(1).clamp(1, H - 1)
        c0 = safe.gather(1, (k - 1)[:, None])[:, 0]
        c1 = safe.gather(1, k[:, None])[:, 0]
        t = ((q - c0) / (c1 - c0)).clamp(0.0, 1.0)
        t = torch.where(c1 > c0, t, 0.0)
        col = xs[k - 1] + t * (xs[k] - xs[k - 1])
        # clamp outside the table like np.interp
        col = torch.where(safe[:, 0] >= q, xs[0], col)
        out[:, i_q] = torch.where(safe[:, -1] < q, xs[-1], col)
    out[bad] = math.nan
    return out.reshape(tuple(cdf.shape[:-1]) + (len(qs),))


def pdf_quantiles(pdf_bins, marg_quantiles, conv_post_pdfs):
    """``conv_marginals`` [r, m, p, Q, b, l]: the quantiles of the stored
    float32 ``conv_post_pdfs`` by CDF inversion, vectorized over every
    pixel (``quantize_conv_marginals``).  The CDF is the reference's
    float32 running sum over the bins, divided by its last value."""
    H = conv_post_pdfs.shape[3]
    cdf = conv_post_pdfs.clone()
    for h in range(1, H):
        cdf[:, :, :, h] += cdf[:, :, :, h - 1]
    cdf = (cdf / cdf[:, :, :, H - 1:]).permute(0, 1, 2, 4, 5, 3)
    n_q = len(marg_quantiles)
    margs = nans(tuple(cdf.shape[:-1]) + (n_q,), device=cdf.device)
    for i_p in range(cdf.shape[2]):
        margs[:, :, i_p] = _invert_cdf_rows(cdf[:, :, i_p], pdf_bins[i_p],
                                            marg_quantiles)
    return margs.permute(0, 1, 2, 5, 3, 4).float().contiguous()


def map_predictions(nbest_map, runner, device="cuda"):
    """Single-component model spectra at the MAP parameters of every
    (pixel, component) the stored ``nbest_MAP`` [m, p, b, l] holds: one
    batched ``model_predict`` per transition on float32 parameter rows.

    Returns ``(pmap [l, b, p, m], valid [l, b, m], (l_ix, b_ix, m_ix),
    preds)``, ``preds`` a list per transition of ``[n_valid, S]``.
    """
    dev = resolve_device(device)
    pmap = _stored(nbest_map.to(dev))                   # (l, b, p, m)
    valid = ~torch.isnan(pmap).any(dim=2)               # (l, b, m)
    idx = torch.nonzero(valid, as_tuple=True)
    params_1c = pmap.permute(0, 1, 3, 2)[idx]           # [N, p]
    if params_1c.shape[0] == 0:
        return pmap, valid, idx, []
    params_1c = params_1c.to(torch.float32)
    preds = [runner.model.model_predict(spec.to(dev), params_1c)
             for spec in runner.spectra]
    return pmap, valid, idx, preds


def deblend_maps(predictions, pdf_bins, dvs, model):
    """``peak_intensity`` / ``integrated_intensity`` [t, m, b, l] of each
    MAP component per transition (the integral times the cube's ``dv``,
    ``dvs[t]``) and ``hf_deblended`` [t, m, h, b, l], each component as a
    single Gaussian on the velocity bins (``deblend_hf_intensity``)."""
    pmap, _valid, (l_ix, b_ix, m_ix), preds = predictions
    n_lon, n_lat, _n_params, m = pmap.shape
    dev = pmap.device
    intint = nans((n_lon, n_lat, m, len(dvs)), device=dev)
    pkint = nans(intint.shape, device=dev)
    for i_t, pred in enumerate(preds):
        pkint[l_ix, b_ix, m_ix, i_t] = _nanmax(pred, 1).to(_F64)
        intint[l_ix, b_ix, m_ix, i_t] = torch.nansum(pred.to(_F64), dim=1)
    intint = intint * torch.as_tensor(np.asarray(dvs, dtype=np.float64),
                                      device=dev)
    dv_bin = (pdf_bins[0, 1] - pdf_bins[0, 0]).abs()
    vaxis = pdf_bins[0].reshape(1, 1, 1, 1, -1)
    vcen = pmap[:, :, model.IX_VCEN, :][..., None, None]
    sigm = pmap[:, :, model.IX_SIGM, :][..., None, None]
    norm_fact = dv_bin / (sigm * math.sqrt(2 * math.pi))
    z = (vaxis - vcen) / sigm
    hfdb = norm_fact * intint[..., None] * torch.exp(-0.5 * (z * z))
    return {"peak_intensity": _stored(pkint),
            "integrated_intensity": _stored(intint),
            "hf_deblended": hfdb.permute(3, 2, 4, 1, 0).float().contiguous()}


def profile_maps(predictions, cubes):
    """``model_spec/trans<id>`` [m, S, b, l] float32 per transition: the
    MAP model spectrum of every component (``generate_predicted_profiles``);
    ``cubes`` the stack's cubes, in the runner's spectra order."""
    pmap, _valid, (l_ix, b_ix, m_ix), preds = predictions
    n_lon, n_lat, _n_params, m = pmap.shape
    out = {}
    for pred, dcube in zip(preds, cubes):
        mcube = nans((n_lon, n_lat, m, dcube.nchan), dtype=torch.float32,
                     device=pmap.device)
        mcube[l_ix, b_ix, m_ix] = pred
        out[f"model_spec/trans{dcube.trans_id}"] = \
            mcube.permute(2, 3, 1, 0).contiguous()
    return out


def _check_runner(runner):
    if runner.ncomp != 1:
        raise ValueError(f"the products need a one-component runner, not "
                         f"ncomp={runner.ncomp}")


def postprocess_table(tab, stack, runner, par_bins=None, evid_kernel=None,
                      post_kernel=None, evid_weight=True, device="cuda",
                      walls=None):
    """Every product of ``postprocess_run`` from the table ``tab`` (which
    must hold the posteriors) as tensors on ``device``, keyed by their
    dataset names under the store's ``/products``.  ``runner`` is a
    one-component runner over the stack's transitions.  With a dict
    ``walls``, each step's wall (s, the device synchronised) goes in it."""
    dev = resolve_device(device)
    _check_runner(runner)

    def timed(name, fn, *args):
        if walls is None:
            return fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        walls[name] = time.perf_counter() - t0
        return out

    prod = timed("attributes", attribute_maps, tab, dev)
    prod["conv_nbest"], prod["conv_evidence"] = timed(
        "conv_evidence", evidence_convolution, prod["evidence"],
        prod["nbest"], evid_kernel, tab.ncomp_max, tab.lnz_thresh)
    prod.update(timed("products", product_maps, tab, prod["conv_nbest"],
                      dev))
    prod["pdf_bins"], prod["post_pdfs"] = timed(
        "post_pdfs", pdf_maps, tab, prod["nbest_marginals"], par_bins, dev)
    prod["conv_post_pdfs"] = timed(
        "conv_post_pdfs", pdf_convolution, prod["post_pdfs"],
        prod["evidence"], prod["conv_nbest"], post_kernel, evid_weight)
    prod["conv_marginals"] = timed(
        "conv_marginals", pdf_quantiles, prod["pdf_bins"],
        prod["marg_quantiles"], prod["conv_post_pdfs"])
    pred = timed("predict", map_predictions, prod["nbest_MAP"], runner, dev)
    prod.update(timed("deblend", deblend_maps, pred, prod["pdf_bins"],
                      [c.dv for c in stack.cubes], tab.model))
    prod.update(timed("profiles", profile_maps, pred, stack.cubes))
    return prod


# ---------------------------------------------------------------------------
# store layer: the JAX package's step functions
# ---------------------------------------------------------------------------

def _read(store, name, device):
    return torch.as_tensor(store.hdf[f"{store.dpath}/{name}"][...],
                           device=device)


def _write(store, products):
    for name, value in products.items():
        group, _, leaf = f"{store.dpath}/{name}".rpartition("/")
        store.create_dataset(leaf, value.cpu().numpy(), group=group)


def aggregate_run_attributes(store, device="cuda"):
    """Dense nbest/evidence/err/AIC/AICc/BIC maps, via one store pass and
    index scatters."""
    dev = resolve_device(device)
    log.info("Aggregating store attributes")
    _write(store, attribute_maps(FitTable(store), dev))


def convolve_evidence(store, kernel, device="cuda"):
    """Spatially convolved evidence + re-selected conv_nbest with the
    one-step jump guard."""
    dev = resolve_device(device)
    log.info("Convolving evidence maps")
    attrs = store.hdf.attrs
    conv_nbest, smoothed = evidence_convolution(
        _read(store, "evidence", dev), _read(store, "nbest", dev), kernel,
        attrs["n_max_components"], attrs["lnZ_threshold"])
    _write(store, {"conv_nbest": conv_nbest, "conv_evidence": smoothed})


def extended_masked_evidence(store, kernel, conv=True, lnz_thresh=3,
                             device="cuda"):
    """Masked second convolution to surface weak extended features."""
    dev = resolve_device(device)
    log.info("Convolving masked evidence")
    src = "conv_evidence" if conv else "evidence"
    mext = masked_evidence(_read(store, "evidence", dev),
                           _read(store, src, dev), kernel, lnz_thresh)
    _write(store, {"mext_evidence": mext})


def aggregate_run_products(store, device="cuda"):
    """Dense MAP/bestfit/marginals cubes, filled by scatters from one
    pass."""
    dev = resolve_device(device)
    log.info("Aggregating store products")
    _write(store, product_maps(FitTable(store),
                               _read(store, "conv_nbest", dev), dev))


def aggregate_run_pdfs(store, par_bins=None, device="cuda"):
    """Histogrammed 1-D posterior PDFs per pixel/run/parameter, by batched
    histograms on the device."""
    dev = resolve_device(device)
    log.info("Aggregating marginalized posterior PDFs")
    marg = _read(store, "nbest_marginals", dev) if par_bins is None else None
    bin_mids, pdfs = pdf_maps(FitTable(store, with_posteriors=True), marg,
                              par_bins, dev)
    _write(store, {"pdf_bins": bin_mids, "post_pdfs": pdfs})


def convolve_post_pdfs(store, kernel, evid_weight=True, device="cuda"):
    """Evidence-weighted log-space spatial PDF smoothing as batched FFT
    convolutions over the (comp, param, bin) planes."""
    dev = resolve_device(device)
    log.info("Convolving posterior PDFs")
    evid = _read(store, "evidence", dev) if evid_weight else None
    nbest = _read(store, "conv_nbest", dev) if evid_weight else None
    out = pdf_convolution(_read(store, "post_pdfs", dev), evid, nbest,
                          kernel, evid_weight)
    _write(store, {"conv_post_pdfs": out})


def quantize_conv_marginals(store, device="cuda"):
    """Weighted quantiles of the convolved marginals by CDF inversion,
    vectorized over all pixels."""
    dev = resolve_device(device)
    log.info("Calculating convolved PDF quantiles")
    margs = pdf_quantiles(_read(store, "pdf_bins", dev),
                          _read(store, "marg_quantiles", dev),
                          _read(store, "conv_post_pdfs", dev))
    _write(store, {"conv_marginals": margs})


def _batched_map_predict(store, stack, runner, device="cuda"):
    """Batched model prediction at the MAP parameters for every valid
    pixel and component of the store (``map_predictions``)."""
    dev = resolve_device(device)
    return map_predictions(_read(store, "nbest_MAP", dev), runner, dev)


def deblend_hf_intensity(store, stack, runner, device="cuda"):
    """Peak/integrated intensity + hyperfine-deblended cube from MAP
    parameters."""
    _check_runner(runner)
    dev = resolve_device(device)
    log.info("Deblending HF structure in intensity map")
    pred = _batched_map_predict(store, stack, runner, dev)
    _write(store, deblend_maps(pred, _read(store, "pdf_bins", dev),
                               [c.dv for c in stack.cubes], store.model))


def generate_predicted_profiles(store, stack, runner, device="cuda"):
    """MAP model spectra cubes per transition."""
    _check_runner(runner)
    dev = resolve_device(device)
    log.info("Generating MAP model spectral profiles")
    _write(store, profile_maps(_batched_map_predict(store, stack, runner,
                                                    dev), stack.cubes))


def create_fits_from_store(store, prefix="source", device="cuda"):
    """FITS export of the deblended cubes, through the port's
    ``write_fits``; returns the paths written.

    As in the JAX package, file ``i`` holds the stored ``hf_deblended``
    summed over its velocity bins for component ``i``: a
    ``[transition, b, l]`` image per component (the float32 sum in bin
    order, NaN as 0)."""
    from nestfit_tpu_torch.cube.fits_io import write_fits

    dev = resolve_device(device)
    cube_header = store.read_header(full=True)
    bins = store.hdf[f"{store.dpath}/pdf_bins"][...]
    vaxis = bins[store.model.IX_VCEN]
    hfdb = _read(store, "hf_deblended", dev).permute(1, 2, 0, 3, 4)
    paths = []
    for i_t in range(hfdb.shape[0]):
        plane = hfdb[i_t]
        data = _sequential_sum(torch.where(torch.isnan(plane), 0.0, plane))
        header = dict(cube_header)
        header.update({
            "BUNIT": "K",
            "NAXIS3": vaxis.size,
            "CRPIX3": 1,
            "CDELT3": vaxis[1] - vaxis[0],
            "CUNIT3": "km/s",
            "CTYPE3": "VRAD",
            "CRVAL3": vaxis[0],
            "SPECSYS": "LSRK",
        })
        path = f"{prefix}_hf_deblended_trans{i_t}.fits"
        write_fits(path, data.cpu().numpy(), header)
        paths.append(path)
    return paths


def postprocess_run(store, stack, runner, par_bins=None, evid_kernel=None,
                    post_kernel=None, evid_weight=True, device="cuda"):
    """Run all post-processing steps on ``device``, each reading the
    store and writing its products there."""
    dev = resolve_device(device)
    aggregate_run_attributes(store, dev)
    convolve_evidence(store, evid_kernel, dev)
    aggregate_run_products(store, dev)
    aggregate_run_pdfs(store, par_bins=par_bins, device=dev)
    convolve_post_pdfs(store, post_kernel, evid_weight=evid_weight,
                       device=dev)
    quantize_conv_marginals(store, dev)
    deblend_hf_intensity(store, stack, runner, dev)
    generate_predicted_profiles(store, stack, runner, dev)
