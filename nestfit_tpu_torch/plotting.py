"""Analysis and visualization (port of ``nestfit_tpu/plotting.py``).

Map products, per-pixel spectrum overlays, posterior corner plots and
the model-precision figure, with the JAX module's names, signatures and
figure inventory.  Each figure is two steps:

- a *data step* (``StorePlotter.<figure>_data``, ``corner_plot_data``,
  ``info_kernel_data``, ``synth_spectra_data``,
  ``amm_predict_precision_data``): PyTorch on the plotter's ``device``
  (NumPy and SciPy for the kernel-density smoothing and the spectra), it
  returns as NumPy arrays exactly what the figure draws: the images
  handed to ``imshow``, the metric maps, the voxels, the spectra and
  model curves, the histograms (NumPy's bins and counts), the smoothed
  densities and their contour levels, the tick strings;
- a *renderer* (``plot_*``, ``corner_plot``), which imports matplotlib
  when it is called and draws only what its data step returned.

So this module imports, and every data step runs, where matplotlib is
missing (the card's machine has neither matplotlib nor ``h5py``).

``StorePlotter`` reads either a store (``cube.store.HdfStore``: its
attributes, ``/products/*``, the ``/pix/<lon>/<lat>`` groups and the
header) or, without ``h5py``, a :class:`RecordSource`: the fitter's
records as a ``products.FitTable`` (``FitTable.from_records``), the
product dict of ``products.postprocess_table`` and the stack's header.
Both sources give the same arrays.

Maps carry world-coordinate tick labels from the header through the
port's celestial WCS (:mod:`nestfit_tpu_torch.wcs`), else linear sky
offsets, else pixel indices.  ``runner_predict_full`` runs the runner's
plain ``predict`` on the runner's device; the draws of
``plot_spec_fit_draws`` go through it in one batch.
"""

import math
from pathlib import Path

import numpy as np
import torch

from nestfit_tpu_torch.cube.products import _nanmax, _sequential_sum
from nestfit_tpu_torch.device import resolve_device
from nestfit_tpu_torch.sampling.results import MARGINAL_COLS

_CMAP = "viridis"


def _pyplot():
    """matplotlib's pyplot on the Agg backend (imported at first use)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def format_ra_hms(ra_deg):
    """Right ascension [deg] -> ``h:mm:ss.s`` sexagesimal string."""
    h = (ra_deg % 360.0) / 15.0
    hh = int(h)
    m = (h - hh) * 60.0
    mm = int(m)
    ss = (m - mm) * 60.0
    return f"{hh:d}:{mm:02d}:{ss:04.1f}"


def format_dec_dms(dec_deg):
    """Declination [deg] -> ``+d:mm:ss`` sexagesimal string."""
    sign = "-" if dec_deg < 0 else "+"
    d = abs(dec_deg)
    dd = int(d)
    m = (d - dd) * 60.0
    mm = int(m)
    ss = (m - mm) * 60.0
    return f"{sign}{dd:d}:{mm:02d}:{ss:02.0f}"


class PaddingConfig:
    """Absolute-inches figure layout: edge paddings, subplot separations
    and the colorbar width in inches, converted to figure fractions at
    layout time, so panel sizes stay constant across map shapes."""

    def __init__(self, edge_pads=(0.7, 0.8, 0.6, 0.3),
                 sep_pads=(0.2, 0.2), cbar_width=0.15,
                 inch_per_pix=1.8e-2):
        self.edge_pads = edge_pads
        self.sep_pads = sep_pads
        self.cbar_width = cbar_width
        self.inch_per_pix = inch_per_pix

    def get_figsize(self, shape, nrows=1, ncols=1):
        """Figure size for an ``nrows x ncols`` grid of ``shape`` =
        (n_lon, n_lat) panels at ``inch_per_pix`` scale."""
        n_lon, n_lat = shape
        p_l, p_r, p_b, p_t = self.edge_pads
        p_w, p_h = self.sep_pads
        panel_w = max(n_lon * self.inch_per_pix, 1.0)
        panel_h = max(n_lat * self.inch_per_pix, 1.0)
        width = p_l + p_r + ncols * panel_w + (ncols - 1) * p_w
        height = p_b + p_t + nrows * panel_h + (nrows - 1) * p_h
        return width, height

    def get_colorbar_axis(self, fig=None):
        """(left, bottom, width, height) figure-fraction rect for a
        right-edge colorbar axes."""
        fig = fig or _pyplot().gcf()
        f_w, f_h = fig.get_size_inches()
        p_l, p_r, p_b, p_t = self.edge_pads
        p_w, p_h = self.sep_pads
        left = 1 - (p_r + self.cbar_width - p_w) / f_w
        bottom = p_b / f_h
        width = self.cbar_width / f_w
        height = 1 - (p_b + p_t) / f_h
        return left, bottom, width, height

    def subplots_adjust(self, fig=None, colorbar=False):
        fig = fig or _pyplot().gcf()
        f_w, f_h = fig.get_size_inches()
        p_l, p_r, p_b, p_t = self.edge_pads
        p_w, p_h = self.sep_pads
        right = 1 - p_r / f_w
        if colorbar:
            right -= self.cbar_width / f_w
        fig.subplots_adjust(
            left=p_l / f_w, right=right, bottom=p_b / f_h,
            top=1 - p_t / f_h, wspace=p_w / f_w, hspace=p_h / f_h,
        )


# ---------------------------------------------------------------------------
# sources: a store, or the records without h5py
# ---------------------------------------------------------------------------

class _StoreSource:
    """The reads ``StorePlotter`` makes of a store (``h5py`` only through
    the store it is handed)."""

    def __init__(self, store):
        self.store = store
        self.hdf = store.hdf
        self.dpath = store.dpath
        self.attrs = store.hdf.attrs

    def has_product(self, name):
        return f"{self.dpath}/{name}" in self.hdf

    def product(self, name):
        return self.hdf[f"{self.dpath}/{name}"][...]

    def pixel_nbest(self, i_lon, i_lat):
        return int(self.hdf[f"/pix/{i_lon}/{i_lat}"].attrs["nbest"])

    def pixel_runs(self, i_lon, i_lat):
        return sorted(int(k) for k in self.hdf[f"/pix/{i_lon}/{i_lat}"])

    def pixel_data(self, i_lon, i_lat, ncomp, name):
        return self.hdf[f"/pix/{i_lon}/{i_lat}/{ncomp}/{name}"][...]

    def header(self):
        return self.store.read_header(full=False)


class RecordSource:
    """What ``StorePlotter`` reads, from the fitter's records instead of a
    store: ``table`` a ``products.FitTable`` (``FitTable.from_records``,
    with the posteriors for the per-pixel figures), ``products`` the dict
    of ``products.postprocess_table`` (tensors, keyed by their names under
    the store's ``/products``; None for the per-pixel figures only), and
    ``header`` the stack's simple header (``CubeStack.simple_header``)."""

    def __init__(self, table, products=None, header=None):
        self.table = table
        self.products = {} if products is None else products
        self._header = {} if header is None else dict(header)
        # the attributes fit_cube writes into the store's table.hdf
        self.attrs = {
            "naxis1": table.n_lon, "naxis2": table.n_lat,
            "n_params": table.n_params,
            "n_max_components": table.ncomp_max,
            "lnZ_threshold": table.lnz_thresh,
        }
        if table.model is not None:
            self.attrs["par_names"] = list(table.model.PAR_NAMES)
        self._rows = {
            (int(lo), int(la)): r for r, (lo, la) in enumerate(
                zip(table.pix["i_lon"], table.pix["i_lat"]))}
        self._fits = {}
        for n, rec in table.runs.items():
            for k, r in enumerate(rec["pix_row"]):
                self._fits[int(r), int(n)] = k

    def has_product(self, name):
        return name in self.products

    def product(self, name):
        return self.products[name]

    def pixel_nbest(self, i_lon, i_lat):
        return int(self.table.pix["nbest"][self._rows[i_lon, i_lat]])

    def pixel_runs(self, i_lon, i_lat):
        row = self._rows[i_lon, i_lat]
        return sorted(n for (r, n) in self._fits if r == row)

    def pixel_data(self, i_lon, i_lat, ncomp, name):
        k = self._fits[self._rows[i_lon, i_lat], ncomp]
        return self.table.runs[ncomp][name][k]

    def header(self):
        return self._header


# ---------------------------------------------------------------------------
# NumPy's histograms on a device
# ---------------------------------------------------------------------------

def _host_scalar(x):
    """A 0-d tensor as the NumPy scalar of its dtype."""
    return x.cpu().numpy()[()]


def _histogram(values, bins, density=False):
    """``np.histogram(values, bins, density=density)`` of a 1-D tensor, on
    its device: NumPy's edges (they depend only on the values' minimum
    and maximum, in the values' dtype) and its bins (``edges[i] <= v <
    edges[i + 1]``, the last bin closed).  Returns NumPy arrays."""
    lo, hi = _host_scalar(values.min()), _host_scalar(values.max())
    edges_np = np.histogram_bin_edges(np.array([lo, hi]), bins)
    edges = torch.as_tensor(edges_np, device=values.device)
    idx = torch.searchsorted(edges, values.to(edges.dtype).contiguous(),
                             right=True) - 1
    idx = torch.where(idx == bins, bins - 1, idx)
    n = torch.bincount(idx, minlength=bins)
    if not density:
        return n.cpu().numpy(), edges_np
    db = (edges[1:] - edges[:-1]).to(torch.float64)
    dens = n.to(torch.float64) / db / n.sum().to(torch.float64)
    return dens.cpu().numpy(), edges_np


def _histogram2d(x, y, bins):
    """``np.histogram2d(x, y, bins)`` of two 1-D tensors on their device
    (NumPy's edges and bins, counts as float64).  Returns
    ``(h, xedges, yedges)`` as NumPy arrays."""
    ex = np.array([_host_scalar(x.min()), _host_scalar(x.max())])
    ey = np.array([_host_scalar(y.min()), _host_scalar(y.max())])
    _, xe_np, ye_np = np.histogram2d(ex, ey, bins=bins)
    idx = []
    for v, e_np in ((x, xe_np), (y, ye_np)):
        e = torch.as_tensor(e_np, device=v.device)
        v = v.to(e.dtype).contiguous()
        i = torch.searchsorted(e, v, right=True)
        idx.append(torch.where(v == e[-1], i - 1, i) - 1)
    h = torch.bincount(idx[0] * bins + idx[1], minlength=bins * bins)
    return (h.reshape(bins, bins).to(torch.float64).cpu().numpy(), xe_np,
            ye_np)


def _np(x):
    return x.cpu().numpy()


# ---------------------------------------------------------------------------
# StorePlotter
# ---------------------------------------------------------------------------

class StorePlotter:
    """Map plotting over a store's products, or over a
    :class:`RecordSource`.  The data steps run on ``device`` (default
    ``"cuda"``, which raises without a card)."""

    def __init__(self, store, plot_dir="plots", pad=None, device="cuda"):
        self.store = store
        self.source = store if isinstance(store, RecordSource) \
            else _StoreSource(store)
        self.device = resolve_device(device)
        self.plot_dir = Path(plot_dir)
        self.plot_dir.mkdir(parents=True, exist_ok=True)
        src = self.source
        self.n_lon = int(src.attrs["naxis1"])
        self.n_lat = int(src.attrs["naxis2"])
        self.par_names = list(src.attrs.get("par_names", []))
        self.pad = PaddingConfig() if pad is None else pad
        # absolute world-coordinate axes via the port's exact WCS; falls
        # back to linear sky offsets, then to plain pixel indices
        self.wcs = None
        self.sky_extent = None
        self.sky_labels = ("longitude pixel", "latitude pixel")
        try:
            hdr = src.header()
        except Exception:
            hdr = {}
        try:
            from nestfit_tpu_torch.wcs import CelestialWCS

            self.wcs = CelestialWCS(hdr)
            names = {"RA": "Right Ascension (J2000)",
                     "DEC": "Declination (J2000)",
                     "GLON": "Galactic Longitude",
                     "GLAT": "Galactic Latitude"}
            self.sky_labels = (
                names.get(self.wcs.lon_name, self.wcs.lon_name),
                names.get(self.wcs.lat_name, self.wcs.lat_name),
            )
        except Exception:
            try:
                cd1 = float(hdr.get("CDELT1", 0.0)) * 60.0  # deg->arcmin
                cd2 = float(hdr.get("CDELT2", 0.0)) * 60.0
                cr1 = float(hdr.get("CRPIX1", 1.0)) - 1.0   # FITS 1-based
                cr2 = float(hdr.get("CRPIX2", 1.0)) - 1.0
                if cd1 != 0.0 and cd2 != 0.0:
                    self.sky_extent = (
                        (-0.5 - cr1) * cd1,
                        (self.n_lon - 0.5 - cr1) * cd1,
                        (-0.5 - cr2) * cd2,
                        (self.n_lat - 0.5 - cr2) * cd2,
                    )
                    ct1 = str(hdr.get("CTYPE1", "RA"))[:8].split("-")[0]
                    ct2 = str(hdr.get("CTYPE2", "DEC"))[:8].split("-")[0]
                    self.sky_labels = (
                        f"{ct1} offset (arcmin)", f"{ct2} offset (arcmin)"
                    )
            except Exception:
                pass

    # -- helpers -----------------------------------------------------------

    def _t(self, x):
        """``x`` (an array, or a tensor on any device) on the device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _product(self, name):
        return self._t(self.source.product(name))

    def _par_name(self, p_ix):
        return (self.par_names[p_ix] if p_ix < len(self.par_names)
                else f"p{p_ix}")

    def _n_par(self):
        return len(self.par_names) or int(self.source.attrs["n_params"])

    def _save(self, fig, name):
        path = self.plot_dir / f"{name}.pdf"
        fig.savefig(path, bbox_inches="tight")
        _pyplot().close(fig)
        return path

    def _world_formatters(self):
        """Tick formatters ``f(p, pos) -> str`` mapping pixel index ->
        absolute world coordinate along the field center row/column
        (exact at the center; the curvature across these small fields is
        far below a tick width).  Plain callables: the renderer wraps
        them in matplotlib's ``FuncFormatter``."""
        wcs = self.wcs
        c_lat = (self.n_lat - 1) / 2.0
        c_lon = (self.n_lon - 1) / 2.0
        sexa = wcs.lon_name == "RA"

        def fx(p, _pos=None):
            lon, _ = wcs.pixel_to_world(p + 1.0, c_lat + 1.0)
            return format_ra_hms(float(lon)) if sexa \
                else f"{float(lon):.3f}"

        def fy(p, _pos=None):
            _, lat = wcs.pixel_to_world(c_lon + 1.0, p + 1.0)
            return format_dec_dms(float(lat)) if sexa \
                else f"{float(lat):.3f}"

        return fx, fy

    def world_tick_labels(self, x_ticks, y_ticks):
        """The tick strings of the map axes at pixel positions
        ``x_ticks`` (longitude) and ``y_ticks`` (latitude); None without
        a WCS."""
        if self.wcs is None:
            return None
        fx, fy = self._world_formatters()
        return ([fx(p, i) for i, p in enumerate(x_ticks)],
                [fy(p, i) for i, p in enumerate(y_ticks)])

    def _imshow(self, ax, img, **kwargs):
        # img in (b, l); origin lower to match sky maps
        from matplotlib import ticker as mticker

        if self.wcs is None and self.sky_extent is not None:
            kwargs.setdefault("extent", self.sky_extent)
            kwargs.setdefault("aspect", "auto")
        im = ax.imshow(img, origin="lower", cmap=kwargs.pop("cmap", _CMAP),
                       **kwargs)
        if self.wcs is not None:
            fx, fy = self._world_formatters()
            ax.xaxis.set_major_formatter(mticker.FuncFormatter(fx))
            ax.yaxis.set_major_formatter(mticker.FuncFormatter(fy))
            ax.xaxis.set_major_locator(mticker.MaxNLocator(4))
            ax.yaxis.set_major_locator(mticker.MaxNLocator(5))
            for lab in ax.get_xticklabels():
                lab.set_fontsize(8)
        ax.set_xlabel(self.sky_labels[0])
        ax.set_ylabel(self.sky_labels[1])
        return im

    # -- maps --------------------------------------------------------------

    def nbest_data(self, conv=False):
        """The N-best map (NaN where no pixel was fitted) and its colour
        boundaries."""
        dset = "conv_nbest" if conv else "nbest"
        x = self._product(dset).to(torch.float64)
        image = _np(torch.where(x < 0, math.nan, x))
        return {"title": dset, "image": image,
                "levels": np.arange(-0.5, np.nanmax(image) + 1.5)}

    def plot_nbest(self, name="map_nbest", conv=False):
        """N-best component map."""
        from matplotlib import colors as mcolors

        d = self.nbest_data(conv)
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(5, 4))
        im = self._imshow(ax, d["image"], cmap="magma",
                          norm=mcolors.BoundaryNorm(
                              d["levels"], plt.get_cmap("magma").N))
        fig.colorbar(im, ax=ax, label="N components")
        ax.set_title(d["title"])
        return self._save(fig, name)

    def evidence_diff_data(self, m_hi=1, m_lo=0, conv=False):
        ev = self._product("conv_evidence" if conv else "evidence")
        return {"image": _np(ev[m_hi] - ev[m_lo])}

    def plot_evidence_diff(self, name="map_evdiff", m_hi=1, m_lo=0,
                           conv=False):
        """Evidence-difference map."""
        from matplotlib import colors as mcolors

        d = self.evidence_diff_data(m_hi, m_lo, conv)
        fig, ax = _pyplot().subplots(figsize=(5, 4))
        im = self._imshow(ax, d["image"], cmap="RdBu_r",
                          norm=mcolors.TwoSlopeNorm(0.0))
        fig.colorbar(im, ax=ax, label=rf"$\ln Z_{m_hi} - \ln Z_{m_lo}$")
        return self._save(fig, name)

    def param_map_data(self, p_ix, m_ix=0, kind="MAP"):
        if kind == "MAP":
            img = self._product("nbest_MAP")[m_ix, p_ix]
        elif kind == "median":
            img = self._product("nbest_marginals")[m_ix, p_ix, 4]
        elif kind == "error":
            margs = self._product("nbest_marginals")
            img = (margs[m_ix, p_ix, 10] - margs[m_ix, p_ix, 9]) / 2
        else:
            raise ValueError(kind)
        return {"image": _np(img), "pname": self._par_name(p_ix),
                "kind": kind}

    def plot_param_map(self, p_ix, m_ix=0, kind="MAP", name=None):
        """Dense parameter map from the nbest products."""
        d = self.param_map_data(p_ix, m_ix, kind)
        fig, ax = _pyplot().subplots(figsize=(5, 4))
        im = self._imshow(ax, d["image"])
        fig.colorbar(im, ax=ax, label=f"{d['pname']} ({kind})")
        name = name or f"map_{d['pname']}_{kind}_m{m_ix}"
        return self._save(fig, name)

    def intensity_data(self, kind="peak", trans_ix=0, m_ix=0):
        dset = ("peak_intensity" if kind == "peak"
                else "integrated_intensity")
        return {"image": _np(self._product(dset)[trans_ix, m_ix])}

    def plot_intensity(self, kind="peak", trans_ix=0, m_ix=0, name=None):
        """Peak / integrated intensity maps."""
        d = self.intensity_data(kind, trans_ix, m_ix)
        fig, ax = _pyplot().subplots(figsize=(5, 4))
        im = self._imshow(ax, d["image"], cmap="inferno")
        unit = "K" if kind == "peak" else "K km/s"
        fig.colorbar(im, ax=ax, label=f"{kind} intensity [{unit}]")
        name = name or f"map_{kind}_t{trans_ix}_m{m_ix}"
        return self._save(fig, name)

    def deblend_peak_data(self):
        """Per transition, the max over components of the MAP-model peak
        brightness, and the shared colour limit."""
        data = _nanmax(self._product("peak_intensity"), 1)    # (t,b,l)
        vmax = float(_nanmax(data.reshape(-1), 0)) \
            if bool(torch.isfinite(data).any()) else 1.0
        return {"images": _np(data), "vmax": vmax}

    def _transition_panels(self, images, cmap, vmax, label, name,
                           extend=None):
        plt = _pyplot()
        n_trans = images.shape[0]
        figsize = self.pad.get_figsize((self.n_lon, self.n_lat),
                                       ncols=n_trans)
        fig, axes = plt.subplots(1, n_trans, figsize=figsize, squeeze=False)
        for i_t, ax in enumerate(axes[0]):
            im = self._imshow(ax, images[i_t], cmap=cmap, vmin=0, vmax=vmax)
            if i_t:
                ax.set_ylabel("")
                ax.set_yticklabels([])
        self.pad.subplots_adjust(fig, colorbar=True)
        cax = fig.add_axes(self.pad.get_colorbar_axis(fig))
        kw = {} if extend is None else {"extend": extend}
        fig.colorbar(im, cax=cax, label=label, **kw)
        path = self.plot_dir / f"{name}.pdf"
        fig.savefig(path)
        plt.close(fig)
        return path

    def plot_deblend_peak(self, name="hf_deblend_peak"):
        """Deblended peak-intensity figure: per transition, the max over
        components of the MAP-model peak brightness."""
        d = self.deblend_peak_data()
        return self._transition_panels(
            d["images"], "afmhot", d["vmax"],
            r"$\mathrm{max}(\tilde{T}_\mathrm{b})$ [K]", name)

    def deblend_intintens_data(self, vmax=10.0):
        """Per transition, the component-summed MAP integrated intensity,
        NaN where the first component has no peak; the colour limit and
        the colour bar's ``extend``."""
        data = self._product("integrated_intensity")           # (t,m,b,l)
        mask = self._product("peak_intensity")[:, 0]            # (t,b,l)
        # np.nansum over the component axis, in order
        data = _sequential_sum(
            torch.where(torch.isnan(data), 0.0, data).transpose(0, 1))
        data = torch.where(torch.isnan(mask), math.nan, data)
        if vmax is None:
            vmax = float(_nanmax(data.reshape(-1), 0)) \
                if bool(torch.isfinite(data).any()) else 1.0
            extend = "neither"
        else:
            extend = "max"
        return {"images": _np(data), "vmax": vmax, "extend": extend}

    def plot_deblend_intintens(self, vmax=10.0,
                               name="hf_deblend_intintens"):
        """Deblended integrated-intensity figure: per transition, the
        component-summed MAP integrated intensity, masked to pixels with
        a detected first component."""
        d = self.deblend_intintens_data(vmax)
        return self._transition_panels(
            d["images"], "cividis", d["vmax"],
            r"$\int \tilde{T}_\mathrm{b}\,dv$ [K km s$^{-1}$]", name,
            extend=d["extend"])

    def mext_evidence_data(self):
        return {"image": _np(self._product("mext_evidence"))}

    def plot_mext_evidence(self, name="map_mext_evdiff"):
        """Masked extended-evidence map."""
        from matplotlib import colors as mcolors

        d = self.mext_evidence_data()
        fig, ax = _pyplot().subplots(figsize=(5, 4))
        im = self._imshow(ax, d["image"], cmap="RdBu_r",
                          norm=mcolors.TwoSlopeNorm(0.0))
        fig.colorbar(im, ax=ax, label=r"masked $\Delta \ln Z$")
        return self._save(fig, name)

    def ncomp_metrics_data(self, lnz_thresh=None):
        """The preferred component count per criterion: the lnZ Bayes
        factor ladder and the BIC/AIC/AICc minima (NaN where no pixel
        was fitted)."""
        if lnz_thresh is None:
            lnz_thresh = float(self.source.attrs.get("lnZ_threshold", 11.0))
        ev = self._product("evidence")                     # [M+1, b, l]
        n_models = ev.shape[0] - 1
        nb = torch.zeros(ev.shape[1:], dtype=torch.float64,
                         device=self.device)
        for i in range(n_models):
            nb = nb + ((nb == i) & (ev[i + 1] - ev[i] > lnz_thresh)).to(
                torch.float64)
        metrics = {"lnZ": _np(torch.where(torch.isnan(ev[0]), math.nan,
                                          nb))}
        for crit in ("BIC", "AIC", "AICc"):
            if not self.source.has_product(crit):
                continue
            arr = self._product(crit)
            nb = torch.argmin(torch.where(torch.isnan(arr), math.inf, arr),
                              dim=0).to(torch.float64)
            metrics[crit] = _np(torch.where(torch.isnan(arr[0]), math.nan,
                                            nb))
        return {"metrics": metrics, "n_models": n_models}

    def plot_ncomp_metrics(self, name="map_ncomp_metrics", lnz_thresh=None):
        """Preferred component count per information criterion: lnZ Bayes
        factor vs BIC/AIC/AICc minima, side by side."""
        d = self.ncomp_metrics_data(lnz_thresh)
        metrics = d["metrics"]
        fig, axes = _pyplot().subplots(
            ncols=len(metrics), figsize=(3.2 * len(metrics), 3),
            squeeze=False,
        )
        for ax, (label, img) in zip(axes[0], metrics.items()):
            im = self._imshow(ax, img, cmap="magma", vmin=0,
                              vmax=d["n_models"])
            ax.set_title(label, fontsize=9)
            fig.colorbar(im, ax=ax, fraction=0.046)
        return self._save(fig, name)

    def _prop_data(self, img_fn, title):
        n_par = self._n_par()
        ncomp_max = int(self.source.attrs["n_max_components"])
        images = torch.stack([torch.stack([img_fn(m, p)
                                           for p in range(n_par)])
                              for m in range(ncomp_max)])
        return {"images": _np(images), "title": title,
                "pnames": [self._par_name(p) for p in range(n_par)]}

    def _prop_grid(self, d, name):
        """Parameter x component grid of sky maps."""
        images = d["images"]
        ncomp_max, n_par = images.shape[:2]
        fig, axes = _pyplot().subplots(
            nrows=ncomp_max, ncols=n_par,
            figsize=(2.4 * n_par, 2.2 * ncomp_max), squeeze=False,
        )
        for m_ix in range(ncomp_max):
            for p_ix in range(n_par):
                ax = axes[m_ix, p_ix]
                im = ax.imshow(images[m_ix, p_ix], origin="lower",
                               cmap=_CMAP)
                fig.colorbar(im, ax=ax, fraction=0.046)
                if m_ix == 0:
                    ax.set_title(d["pnames"][p_ix], fontsize=8)
                if p_ix == 0:
                    ax.set_ylabel(f"comp {m_ix + 1}", fontsize=8)
                ax.set_xticks([])
                ax.set_yticks([])
        fig.suptitle(d["title"], fontsize=10)
        return self._save(fig, name)

    def map_props_data(self):
        data = self._product("nbest_MAP")
        return self._prop_data(lambda m, p: data[m, p],
                               "MAP parameter maps")

    def plot_map_props(self, name="map_props"):
        """All-parameter MAP map grid."""
        return self._prop_grid(self.map_props_data(), name)

    def quan_props_data(self, quan_ix=4, conv=True):
        data = self._product("conv_marginals" if conv
                             else "nbest_marginals")
        if conv:
            # [r, m, p, M, b, l]: the (r == m) diagonal per component
            def img_fn(m, p):
                return data[m, m, p, quan_ix]
        else:
            def img_fn(m, p):
                return data[m, p, quan_ix]
        return self._prop_data(img_fn, f"quantile {quan_ix} parameter maps")

    def plot_quan_props(self, quan_ix=4, name="quan_props", conv=True):
        """Quantile parameter map grid; ``quan_ix=4`` is the median."""
        return self._prop_grid(self.quan_props_data(quan_ix, conv), name)

    def err_props_data(self, conv=True):
        data = self._product("conv_marginals" if conv
                             else "nbest_marginals")
        lo, hi = MARGINAL_COLS.index("1s_lo"), MARGINAL_COLS.index("1s_hi")
        if conv:
            def img_fn(m, p):
                return (data[m, m, p, hi] - data[m, m, p, lo]) / 2
        else:
            def img_fn(m, p):
                return (data[m, p, hi] - data[m, p, lo]) / 2
        return self._prop_data(img_fn, "1-sigma half-width maps")

    def plot_err_props(self, name="err_props", conv=True):
        """Half-width 1-sigma error map grid."""
        return self._prop_grid(self.err_props_data(conv), name)

    def volume_data(self, thresh_frac=0.1, trans_ix=0):
        """The (l, b, v) voxels of the component-summed deblended
        intensity above ``thresh_frac`` of its peak, and their values."""
        hfdb = self._product("hf_deblended")[trans_ix]          # [m,v,b,l]
        cube = _sequential_sum(torch.where(torch.isnan(hfdb), 0.0, hfdb))
        vmax = _host_scalar(_nanmax(cube.reshape(-1), 0))
        if not np.isfinite(vmax) or vmax <= 0:
            vmax = 1.0
        # the threshold as NumPy computes it, compared in the cube's dtype
        thr = torch.as_tensor(float(thresh_frac * vmax), dtype=cube.dtype,
                              device=self.device)
        iv, ib, il = torch.nonzero(cube > thr, as_tuple=True)
        return {"il": _np(il), "ib": _np(ib), "iv": _np(iv),
                "values": _np(cube[iv, ib, il])}

    def plot_3d_volume(self, name="volume_field", thresh_frac=0.1,
                       trans_ix=0):
        """3-D (l, b, v) rendering of the deblended intensity field:
        voxels above a fraction of the peak, coloured by brightness."""
        d = self.volume_data(thresh_frac, trans_ix)
        fig = _pyplot().figure(figsize=(6, 5))
        ax = fig.add_subplot(projection="3d")
        p = ax.scatter(d["il"], d["ib"], d["iv"], c=d["values"],
                       cmap="inferno", s=4, alpha=0.5, linewidths=0)
        ax.set_xlabel("lon pix")
        ax.set_ylabel("lat pix")
        ax.set_zlabel("velocity chan")
        fig.colorbar(p, ax=ax, shrink=0.6, label=r"$T_\mathrm{b}$ [K]")
        return self._save(fig, name)

    # -- per pixel ---------------------------------------------------------

    def _nbest(self, i_lon, i_lat, ncomp):
        return ncomp or max(self.source.pixel_nbest(i_lon, i_lat), 1)

    @staticmethod
    def _spectra(stack, i_lon, i_lat):
        out = [dcube.get_spec_data(i_lon, i_lat) for dcube in stack.cubes]
        return ([dcube.varr for dcube in stack.cubes], [o[1] for o in out],
                [o[3] for o in out])

    def spec_fit_data(self, i_lon, i_lat, stack, runner, ncomp=None):
        """Per transition: the velocity axis, the spectrum and the MAP
        model of the pixel's ``nbest`` (or ``ncomp``) fit."""
        nbest = self._nbest(i_lon, i_lat, ncomp)
        params = self.source.pixel_data(i_lon, i_lat, nbest, "map_params")
        varr, spectra, tids = self._spectra(stack, i_lon, i_lat)
        return {"nbest": nbest, "varr": varr, "spectra": spectra,
                "trans_ids": tids,
                "models": runner_predict_full(runner, params, nbest)}

    def plot_spec_fit(self, i_lon, i_lat, stack, runner, name=None,
                      ncomp=None):
        """Per-pixel spectrum with the MAP model overlaid."""
        d = self.spec_fit_data(i_lon, i_lat, stack, runner, ncomp)
        n_t = stack.n_cubes
        fig, axes = _pyplot().subplots(
            nrows=n_t, figsize=(8, 2.5 * n_t), sharex=False, squeeze=False
        )
        for i_t in range(n_t):
            ax = axes[i_t, 0]
            ax.step(d["varr"][i_t], d["spectra"][i_t], color="0.4", lw=0.8,
                    label=f"data t{d['trans_ids'][i_t]}")
            ax.plot(d["varr"][i_t], d["models"][i_t], color="tab:red",
                    lw=1.2, label="MAP")
            ax.axhline(0, color="0.8", lw=0.5)
            ax.legend(loc="upper right", fontsize=7)
            ax.set_ylabel(r"$T_\mathrm{b}$ [K]")
        axes[-1, 0].set_xlabel(r"$v_\mathrm{lsr}$ [km/s]")
        name = name or f"spec_fit_{i_lon}_{i_lat}"
        return self._save(fig, name)

    def post_stack_data(self, i_lon, i_lat):
        """The pixel's posterior histograms (60 bins, density), one per
        parameter, component and model run: a list of dicts with
        ``param``, ``ncomp``, ``comp``, ``density`` and ``edges``."""
        n_par = self._n_par()
        hists = []
        for n_run in self.source.pixel_runs(i_lon, i_lat):
            post = self._t(self.source.pixel_data(i_lon, i_lat, n_run,
                                                  "posteriors"))
            for p_ix in range(n_par):
                for i_m in range(n_run):
                    dens, edges = _histogram(post[:, p_ix * n_run + i_m],
                                             60, density=True)
                    hists.append({"param": p_ix, "ncomp": n_run,
                                  "comp": i_m, "density": dens,
                                  "edges": edges})
        return {"hists": hists, "n_par": n_par,
                "pnames": [self._par_name(p) for p in range(n_par)]}

    def plot_post_stack(self, i_lon, i_lat, name=None):
        """Per-pixel stacked posterior histograms: one row per parameter,
        one curve per component and per model run."""
        d = self.post_stack_data(i_lon, i_lat)
        n_par = d["n_par"]
        fig, axes = _pyplot().subplots(
            nrows=n_par, figsize=(6, 1.6 * n_par), squeeze=False,
        )
        for h in d["hists"]:
            edges = h["edges"]
            axes[h["param"], 0].stairs(
                h["density"], edges, lw=0.9, alpha=0.9,
                label=f"N={h['ncomp']} c{h['comp'] + 1}")
        for p_ix in range(n_par):
            axes[p_ix, 0].set_ylabel(d["pnames"][p_ix], fontsize=8)
            axes[p_ix, 0].tick_params(labelsize=7)
        axes[0, 0].legend(fontsize=6, ncol=2)
        name = name or f"post_stack_{i_lon}_{i_lat}"
        return self._save(fig, name)

    def spec_fit_draws_data(self, i_lon, i_lat, stack, runner, n_draw=30,
                            ncomp=None):
        """``spec_fit_data`` plus the models of ``n_draw`` posterior draws
        (``np.random.default_rng(0)``, without replacement), per
        transition ``[n_draw, S]``, predicted in one batch."""
        nbest = self._nbest(i_lon, i_lat, ncomp)
        post = np.asarray(self.source.pixel_data(i_lon, i_lat, nbest,
                                                 "posteriors"))
        map_params = self.source.pixel_data(i_lon, i_lat, nbest,
                                            "map_params")
        rng = np.random.default_rng(0)
        take = rng.choice(post.shape[0], size=min(n_draw, post.shape[0]),
                          replace=False)
        varr, spectra, tids = self._spectra(stack, i_lon, i_lat)
        return {"nbest": nbest, "varr": varr, "spectra": spectra,
                "trans_ids": tids,
                "map_models": runner_predict_full(runner, map_params, nbest),
                "draw_models": runner_predict_full(runner, post[take, :-2],
                                                   nbest)}

    def plot_spec_fit_draws(self, i_lon, i_lat, stack, runner, n_draw=30,
                            ncomp=None, name=None, animate=False):
        """Spectrum with MAP model plus posterior-draw overlays; with
        ``animate=True`` also writes a GIF cycling through the draws."""
        d = self.spec_fit_draws_data(i_lon, i_lat, stack, runner, n_draw,
                                     ncomp)
        n_t = stack.n_cubes
        fig, axes = _pyplot().subplots(
            nrows=n_t, figsize=(8, 2.5 * n_t), squeeze=False,
        )
        for i_t in range(n_t):
            ax = axes[i_t, 0]
            ax.step(d["varr"][i_t], d["spectra"][i_t], color="0.4", lw=0.8)
            for dp in d["draw_models"][i_t]:
                ax.plot(d["varr"][i_t], dp, color="tab:blue", lw=0.4,
                        alpha=0.25)
            ax.plot(d["varr"][i_t], d["map_models"][i_t], color="tab:red",
                    lw=1.2)
            ax.set_ylabel(rf"$T_\mathrm{{b}}$ t{d['trans_ids'][i_t]} [K]")
        axes[-1, 0].set_xlabel(r"$v_\mathrm{lsr}$ [km/s]")
        name = name or f"spec_draws_{i_lon}_{i_lat}"
        path = self._save(fig, name)
        if animate:
            draw_preds = [[m[i] for m in d["draw_models"]]
                          for i in range(d["draw_models"][0].shape[0])]
            path = self._animate_draws(i_lon, i_lat, stack, draw_preds,
                                       d["map_models"], name)
        return path

    def _animate_draws(self, i_lon, i_lat, stack, draw_preds, map_preds,
                       name):
        """GIF cycling through posterior-draw model curves
        (``draw_preds[i][t]``: draw ``i``, transition ``t``)."""
        from matplotlib.animation import FuncAnimation, PillowWriter

        plt = _pyplot()
        dcube = stack.cubes[0]
        _, arr, _, _, _ = dcube.get_spec_data(i_lon, i_lat)
        fig, ax = plt.subplots(figsize=(8, 3))
        ax.step(dcube.varr, arr, color="0.4", lw=0.8)
        ax.plot(dcube.varr, map_preds[0], color="tab:red", lw=1.0)
        line, = ax.plot(dcube.varr, draw_preds[0][0], color="tab:blue",
                        lw=0.9)
        ax.set_xlabel(r"$v_\mathrm{lsr}$ [km/s]")
        ax.set_ylabel(r"$T_\mathrm{b}$ [K]")

        def update(i):
            line.set_ydata(draw_preds[i % len(draw_preds)][0])
            return (line,)

        anim = FuncAnimation(fig, update, frames=len(draw_preds))
        path = self.plot_dir / f"{name}.gif"
        anim.save(path, writer=PillowWriter(fps=5))
        plt.close(fig)
        return path

    def spec_grid_data(self, stack, pix, rlon=2, rlat=2, trans_ix=0):
        """Postage stamps around ``pix``: the velocity axis and, per grid
        cell ``(row, col)`` (rows top to bottom = decreasing latitude), the
        spectrum, or None off the map or where it holds NaNs."""
        i_lon0, i_lat0 = pix
        dcube = stack.cubes[trans_ix]
        n_lon, n_lat = stack.spatial_shape
        cells = {}
        for dy in range(-rlat, rlat + 1):
            for dx in range(-rlon, rlon + 1):
                i_lon, i_lat = i_lon0 + dx, i_lat0 + dy
                arr = None
                if 0 <= i_lon < n_lon and 0 <= i_lat < n_lat:
                    _, spec, _, _, has_nans = dcube.get_spec_data(i_lon,
                                                                  i_lat)
                    arr = None if has_nans else spec
                cells[rlat - dy, dx + rlon] = arr
        return {"varr": dcube.varr, "cells": cells,
                "shape": (2 * rlat + 1, 2 * rlon + 1),
                "center": (rlat, rlon)}

    def plot_spec_grid(self, stack, pix, rlon=2, rlat=2, trans_ix=0,
                       name=None):
        """Postage-stamp grid of spectra around a central pixel."""
        d = self.spec_grid_data(stack, pix, rlon, rlat, trans_ix)
        nr, nc = d["shape"]
        fig, axes = _pyplot().subplots(
            nrows=nr, ncols=nc, figsize=(1.6 * nc, 1.1 * nr),
            sharex=True, sharey=True, squeeze=False,
        )
        for (row, col), arr in d["cells"].items():
            ax = axes[row, col]
            ax.tick_params(labelsize=5)
            if arr is None:
                ax.set_facecolor("0.9")
                continue
            ax.step(d["varr"], arr, color="0.2", lw=0.5)
            if (row, col) == d["center"]:
                for spine in ax.spines.values():
                    spine.set_color("tab:red")
        fig.subplots_adjust(hspace=0, wspace=0)
        name = name or f"spec_grid_{pix[0]}_{pix[1]}"
        return self._save(fig, name)

    def velo_2corr_data(self, i_lon, i_lat):
        """The 50x50 histogram of the two centroids of the pixel's
        two-component posterior and the diagonal's ends."""
        if 2 not in self.source.pixel_runs(i_lon, i_lat):
            raise ValueError(f"no 2-comp run at ({i_lon}, {i_lat})")
        post = self._t(self.source.pixel_data(i_lon, i_lat, 2, "posteriors"))
        v1, v2 = post[:, 0], post[:, 1]
        h, xe, ye = _histogram2d(v1, v2, 50)
        lo = min(_host_scalar(v1.min()), _host_scalar(v2.min()))
        hi = max(_host_scalar(v1.max()), _host_scalar(v2.max()))
        return {"hist": h, "xedges": xe, "yedges": ye, "diag": (lo, hi)}

    def plot_velo_2corr(self, i_lon, i_lat, name=None):
        """Joint posterior of the two component centroids for a 2-comp
        fit."""
        from matplotlib import colors as mcolors

        d = self.velo_2corr_data(i_lon, i_lat)
        fig, ax = _pyplot().subplots(figsize=(4, 4))
        ax.pcolormesh(d["xedges"], d["yedges"], d["hist"].T, cmap="Blues",
                      norm=mcolors.PowerNorm(0.5))
        lo, hi = d["diag"]
        ax.plot([lo, hi], [lo, hi], "k--", lw=0.6)
        ax.set_xlabel(r"$v_1$ [km/s]")
        ax.set_ylabel(r"$v_2$ [km/s]")
        name = name or f"velo_2corr_{i_lon}_{i_lat}"
        return self._save(fig, name)

    def corner_data(self, i_lon, i_lat, ncomp=None):
        """``corner_plot_data`` of the pixel's posterior samples."""
        nbest = self._nbest(i_lon, i_lat, ncomp)
        post = np.asarray(self.source.pixel_data(i_lon, i_lat, nbest,
                                                 "posteriors"))
        samples = post[:, :-2]
        ndim = samples.shape[1]
        labels = [
            f"{p}{i+1}" for p in
            (self.par_names or [f"p{i}" for i in range(ndim)])
            for i in range(nbest)
        ][:ndim]
        return dict(corner_plot_data(samples, labels=labels), nbest=nbest)

    def plot_corner(self, i_lon, i_lat, ncomp=None, name=None):
        """Posterior corner plot from the stored samples."""
        d = self.corner_data(i_lon, i_lat, ncomp)
        fig = _draw_corner(d)
        name = name or f"corner_{i_lon}_{i_lat}_n{d['nbest']}"
        return self._save(fig, name)


def runner_predict_full(runner, params, ncomp):
    """Model spectra per transition as NumPy arrays: ``[S_t]`` for one
    parameter vector, ``[n, S_t]`` for ``n`` of them (one batch through
    the runner's plain ``predict`` on its device)."""
    r = runner
    if r.ncomp != ncomp:
        r = type(runner)(runner.spectra, runner.utrans, ncomp=ncomp,
                         device=runner.device,
                         **getattr(runner, "predict_kwargs", {}))
    theta = torch.as_tensor(np.asarray(params, dtype=np.float32),
                            device=r.device)
    return [p.cpu().numpy() for p in r.predict(theta)]


def _kde_density_2d(x, y, bins=64, smooth=1.5):
    """Gaussian-KDE-smoothed 2-D density on a regular grid.

    Histogram the samples, then convolve with a Gaussian whose width is
    ``smooth`` grid cells scaled by Silverman's n^(-1/6) factor.  Returns
    (xc, yc, density, levels) where ``levels`` are the highest-density
    contour thresholds enclosing 39.3% / 86.5% of the posterior mass
    (the 2-D 1- and 2-sigma equivalents).
    """
    from scipy.ndimage import gaussian_filter

    h, xe, ye = np.histogram2d(x, y, bins=bins)
    n = max(x.size, 2)
    sig = smooth * (n / 100.0) ** (-1.0 / 6.0)
    h = gaussian_filter(h, sigma=max(sig, 0.6), mode="constant")
    # highest-density levels by mass fraction
    flat = np.sort(h.ravel())[::-1]
    csum = np.cumsum(flat)
    csum /= max(csum[-1], 1e-30)
    levels = []
    for frac in (0.865, 0.393):     # 2-sigma first (lower threshold)
        k = int(np.searchsorted(csum, frac))
        levels.append(flat[min(k, flat.size - 1)])
    xc = 0.5 * (xe[:-1] + xe[1:])
    yc = 0.5 * (ye[:-1] + ye[1:])
    return xc, yc, h.T, sorted(set(levels))


def corner_plot_data(samples, labels=None, bins=40, contours=True,
                     smooth=1.5):
    """What :func:`corner_plot` draws (NumPy and SciPy): ``diag[i]`` the
    smoothed 1-D density ``(centers, h)`` (``contours``) or the histogram
    ``(density, edges)``; ``lower[i, j]`` (``j < i``) the smoothed 2-D
    density ``(xc, yc, dens, levels)`` (``contours``) or
    ``np.histogram2d`` ``(h, xedges, yedges)``."""
    from scipy.ndimage import gaussian_filter1d

    samples = np.asarray(samples)
    ndim = samples.shape[1]
    diag, lower = [], {}
    for i in range(ndim):
        if contours:
            h, edges = np.histogram(samples[:, i], bins=2 * bins,
                                    density=True)
            h = gaussian_filter1d(h, sigma=max(
                smooth * (samples.shape[0] / 100.0) ** (-1 / 5.0), 0.6,
            ), mode="constant")
            diag.append((0.5 * (edges[:-1] + edges[1:]), h))
        else:
            diag.append(np.histogram(samples[:, i], bins=bins, density=True))
        for j in range(i):
            if contours:
                lower[i, j] = _kde_density_2d(
                    samples[:, j], samples[:, i], bins=max(bins, 48),
                    smooth=smooth)
            else:
                lower[i, j] = np.histogram2d(samples[:, j], samples[:, i],
                                             bins=bins)
    return {"ndim": ndim, "labels": labels, "contours": contours,
            "diag": diag, "lower": lower}


def _draw_corner(d, figsize=None):
    from matplotlib import colors as mcolors

    ndim, labels = d["ndim"], d["labels"]
    figsize = figsize or (1.6 * ndim, 1.6 * ndim)
    fig, axes = _pyplot().subplots(ndim, ndim, figsize=figsize,
                                   squeeze=False)
    for i in range(ndim):
        for j in range(ndim):
            ax = axes[i, j]
            if j > i:
                ax.set_visible(False)
                continue
            if i == j:
                if d["contours"]:
                    xc, h = d["diag"][i]
                    ax.plot(xc, h, color="0.25", lw=1.0)
                    ax.fill_between(xc, h, color="0.8", alpha=0.6)
                else:
                    dens, edges = d["diag"][i]
                    ax.stairs(dens, edges, color="0.3")
            elif d["contours"]:
                xc, yc, dens, levels = d["lower"][i, j]
                ax.contourf(xc, yc, dens,
                            levels=list(levels) + [dens.max() + 1e-30],
                            colors=["#b3cde3", "#6497bf"], alpha=0.85)
                ax.contour(xc, yc, dens, levels=levels,
                           colors="#30557f", linewidths=0.7)
            else:
                h, xe, ye = d["lower"][i, j]
                ax.pcolormesh(xe, ye, h.T, cmap="Blues",
                              norm=mcolors.PowerNorm(0.5))
            if i == ndim - 1 and labels:
                ax.set_xlabel(labels[j], fontsize=7)
            else:
                ax.set_xticklabels([])
            if j == 0 and i > 0 and labels:
                ax.set_ylabel(labels[i], fontsize=7)
            else:
                ax.set_yticklabels([])
            ax.tick_params(labelsize=6)
    fig.subplots_adjust(hspace=0.08, wspace=0.08)
    return fig


def corner_plot(samples, labels=None, bins=40, figsize=None,
                contours=True, smooth=1.5):
    """Corner plot: KDE-smoothed 1-D marginals on the diagonal, smoothed
    2-D density with 1/2-sigma highest-density contours below
    (``contours=False``: the plain histograms).  Returns the figure."""
    return _draw_corner(corner_plot_data(samples, labels, bins, contours,
                                         smooth), figsize)


def info_kernel_data(sigma_pix, nrad, clip_radius=None):
    """The independent-information convolution kernel (NumPy)."""
    from nestfit_tpu_torch.cube.products import (
        apply_circular_mask, get_indep_info_kernel,
    )

    kernel = get_indep_info_kernel(sigma_pix, nrad=nrad)
    if clip_radius is not None:
        kernel = apply_circular_mask(kernel, radius=clip_radius)
    return {"kernel": kernel}


def plot_info_kernel(sigma_pix, nrad, clip_radius=None,
                     out_path="info_kernel.pdf"):
    """Visualize the independent-information convolution kernel."""
    d = info_kernel_data(sigma_pix, nrad, clip_radius)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(4.5, 4))
    im = ax.imshow(d["kernel"], origin="lower", cmap="cividis")
    fig.colorbar(im, ax=ax, label="weight")
    ax.set_xlabel("pixel offset")
    ax.set_ylabel("pixel offset")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def synth_spectra_data(spectra):
    """Per synthetic spectrum: ``(varr, sampled_spec, sum_spec)``."""
    return [(syn.varr, syn.sampled_spec, syn.sum_spec) for syn in spectra]


def plot_synth_spectra(spectra, out_path="synth_spectra.pdf"):
    """Overview plot of synthetic truth spectra."""
    d = synth_spectra_data(spectra)
    plt = _pyplot()
    fig, axes = plt.subplots(
        nrows=len(d), figsize=(8, 2.2 * len(d)), squeeze=False,
    )
    for ax, (varr, sampled, truth) in zip(axes[:, 0], d):
        ax.step(varr, sampled, color="0.5", lw=0.7, label="sampled")
        ax.plot(varr, truth, color="tab:red", lw=1.0, label="truth")
        ax.set_ylabel(r"$T_\mathrm{b}$ [K]")
    axes[0, 0].legend(fontsize=7)
    axes[-1, 0].set_xlabel(r"$v_\mathrm{lsr}$ [km/s]")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def amm_predict_precision_data(trans_id=1, params=None, device="cuda",
                               dtype=torch.float32):
    """The port's ``amm_predict`` (in ``dtype`` on ``device``) against the
    float64 oracle on a 60 km/s axis: ``varr``, ``truth``, ``pred`` and
    ``diff = |pred - truth|``."""
    from nestfit_tpu_torch import oracle
    from nestfit_tpu_torch.models import ammonia
    from nestfit_tpu_torch.models.tables import AMMONIA_TRANSITIONS
    from nestfit_tpu_torch.utils import freq_axis_from_velocity

    if params is None:
        params = np.array([-1.0, 1.5, 10.0, 15.0, 4.0, 6.0,
                           14.5, 15.0, 0.3, 0.6, 0.0, 0.0])
    vaxis = np.arange(-30, 30, 0.158)
    xarr = freq_axis_from_velocity(vaxis,
                                   AMMONIA_TRANSITIONS[trans_id - 1].nu)
    spec = ammonia.make_ammonia_spectrum(
        xarr, np.zeros_like(xarr), 0.1, trans_id=trans_id, device=device,
        dtype=dtype)
    theta = torch.as_tensor(np.asarray(params),
                            device=resolve_device(device)).to(dtype)
    pred = ammonia.amm_predict(spec, theta).cpu().numpy()
    truth = oracle.amm_predict(xarr, params, trans_id=trans_id)
    return {"varr": vaxis[::-1], "truth": truth, "pred": pred,
            "diff": np.abs(pred - truth)}


def plot_amm_predict_precision(out_path="amm_precision.pdf", trans_id=1,
                               params=None, device="cuda"):
    """Model-precision verification plot: the port's float32
    ``amm_predict`` against the float64 oracle."""
    d = amm_predict_precision_data(trans_id, params, device)
    plt = _pyplot()
    fig, (ax0, ax1) = plt.subplots(nrows=2, figsize=(8, 5), sharex=True)
    ax0.plot(d["varr"], d["truth"], "k-", lw=1.0, label="oracle (f64)")
    ax0.plot(d["varr"], d["pred"], "r--", lw=0.8, label="port (f32)")
    ax0.set_ylabel(r"$T_\mathrm{b}$ [K]")
    ax0.legend()
    with np.errstate(divide="ignore"):
        ax1.semilogy(d["varr"], d["diff"], "0.3", lw=0.7)
    ax1.set_ylabel(r"$|\Delta T_\mathrm{b}|$ [K]")
    ax1.set_xlabel(r"$v_\mathrm{lsr}$ [km/s]")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path
