"""Port parity of the plots (``nestfit_tpu_torch/plotting.py``) against
``nestfit_tpu/plotting.py``.

A seeded NH3 store (ncomp_max 2, 9x7 px) is written with the port's
``write_chunk`` as ``tests/test_torch_products.py`` writes it, and its
products are computed by the port's ``postprocess_run``.  Each figure of
the JAX ``StorePlotter`` inventory runs with matplotlib's drawing calls
recorded (``Axes.imshow``, ``plot``, ``step``, ``hist``, ``hist2d``,
``scatter``, ``contour`` and ``contourf``, wrapped here for the length of
the call; nothing is saved), and the port's data step of the same figure
must hand back those arrays: store reads bit for bit, NumPy's histograms
bit for bit, float32 model predictions within rtol 1e-6.  The store-free
source (``RecordSource``) gives the store's arrays, and every renderer
writes its file.
"""

import contextlib
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import matplotlib

matplotlib.use("Agg")
from matplotlib.axes import Axes                        # noqa: E402
from matplotlib.figure import Figure                    # noqa: E402
from mpl_toolkits.mplot3d import Axes3D                 # noqa: E402

from nestfit_tpu import cube as jcube                   # noqa: E402
from nestfit_tpu import plotting as jplot               # noqa: E402
from nestfit_tpu import synth as jsynth                 # noqa: E402
from nestfit_tpu.models import RUNNERS as JAX_RUNNERS   # noqa: E402

from nestfit_tpu_torch import cube as tcube             # noqa: E402
from nestfit_tpu_torch import plotting as tplot         # noqa: E402
from nestfit_tpu_torch import synth as tsynth           # noqa: E402
from nestfit_tpu_torch.cube import products as tprod    # noqa: E402
from nestfit_tpu_torch.models import MODELS, RUNNERS    # noqa: E402
from nestfit_tpu_torch.synth import make_fake_header    # noqa: E402

from test_torch_products import (                       # noqa: E402
    N_LAT, N_LON, NCOMP_MAX, THRESH, _axes, _batches, _runner, _write_store)

PRED_RTOL = 1e-6
NAN_PIX = (1, 2)       # a spectrum holding NaNs (spec_grid's grey cell)
WRAPPED = ((Axes, ("imshow", "plot", "step", "hist", "hist2d", "scatter",
                   "contour", "contourf")),
           (Axes3D, ("scatter",)))


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _stack(cube_module):
    """The NH3 stack of the store, with seeded spectra."""
    rng = np.random.default_rng(11)
    cubes = []
    for tid, xarr, rest in _axes("ammonia"):
        data = rng.normal(scale=0.3, size=(N_LON, N_LAT, xarr.size))
        data[NAN_PIX][:4] = np.nan
        cubes.append(cube_module.DataCube(
            data, xarr, noise_map=0.1, trans_id=tid,
            header=make_fake_header(N_LON, N_LAT, xarr, rms=0.1,
                                    rest_freq=rest)))
    return cube_module.CubeStack(cubes)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """The store's name, its records and the port's product dict of them
    (``postprocess_table``, with the masked evidence)."""
    torch.set_num_threads(2)
    name = str(tmp_path_factory.mktemp("plots") / "nh3")
    batches = _batches("ammonia", 0, on_edges=False)
    _write_store(name, "ammonia", batches)
    stack = _stack(tcube)
    runner = _runner(RUNNERS, "ammonia", stack, device="cpu")
    with tcube.HdfStore(name) as store:
        tprod.postprocess_run(store, stack, runner, evid_kernel=1.0,
                              post_kernel=1.0, device="cpu")
        tprod.extended_masked_evidence(store, 1.0, device="cpu")
    table = tprod.FitTable.from_records(
        batches, N_LON, N_LAT, NCOMP_MAX, 6, THRESH, MODELS["ammonia"],
        with_posteriors=True)
    prod = tprod.postprocess_table(table, stack, runner, evid_kernel=1.0,
                                   post_kernel=1.0, device="cpu")
    prod["mext_evidence"] = tprod.masked_evidence(
        prod["evidence"], prod["conv_evidence"], 1.0)
    return name, table, prod, stack.simple_header


@contextlib.contextmanager
def recording(monkeypatch):
    """Record the outermost drawing calls (``(method, args, kwargs)``) of
    the wrapped Axes methods, and save nothing."""
    calls, local = [], threading.local()
    for cls, names in WRAPPED:
        for m in names:
            orig = cls.__dict__[m]

            def wrap(self, *a, _m=m, _orig=orig, **k):
                if getattr(local, "busy", False):
                    return _orig(self, *a, **k)
                calls.append((_m, a, k))
                local.busy = True
                try:
                    return _orig(self, *a, **k)
                finally:
                    local.busy = False

            monkeypatch.setattr(cls, m, wrap)
    monkeypatch.setattr(Figure, "savefig", lambda *a, **k: None)
    monkeypatch.setattr("matplotlib.animation.Animation.save",
                        lambda *a, **k: None)
    try:
        yield calls
    finally:
        monkeypatch.undo()


def _jax_calls(monkeypatch, fn):
    with recording(monkeypatch) as calls:
        fn()
    return calls


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _close_pred(got, want):
    """Float32 model curves: rtol 1e-6, with the wings (where the float32
    exponentials of the two packages part by more ulps) held at 1e-6 of
    the curve's peak."""
    np.testing.assert_allclose(got, want, rtol=PRED_RTOL,
                               atol=PRED_RTOL * np.abs(want).max())


def _images(calls):
    return [a[0] for m, a, _ in calls if m == "imshow"]


@pytest.fixture(scope="module")
def plotters(fitted, tmp_path_factory):
    """``(JAX plotter call, port plotter on the store)``; each opens its
    package's store for the length of a call."""
    name = fitted[0]
    plot_dir = tmp_path_factory.mktemp("made")

    @contextlib.contextmanager
    def jax():
        with jcube.HdfStore(name) as store:
            yield jplot.StorePlotter(store, plot_dir=plot_dir / "jax")

    @contextlib.contextmanager
    def port():
        with tcube.HdfStore(name) as store:
            yield tplot.StorePlotter(store, plot_dir=plot_dir / "port",
                                     device="cpu")

    return jax, port


MAPS = [
    ("plot_nbest", {}, "nbest_data", {}),
    ("plot_nbest", {"conv": True}, "nbest_data", {"conv": True}),
    ("plot_evidence_diff", {}, "evidence_diff_data", {}),
    ("plot_evidence_diff", {"conv": True, "m_hi": 2, "m_lo": 1},
     "evidence_diff_data", {"conv": True, "m_hi": 2, "m_lo": 1}),
    ("plot_mext_evidence", {}, "mext_evidence_data", {}),
    ("plot_param_map", {"p_ix": 0, "kind": "MAP"}, "param_map_data",
     {"p_ix": 0, "kind": "MAP"}),
    ("plot_param_map", {"p_ix": 4, "m_ix": 1, "kind": "median"},
     "param_map_data", {"p_ix": 4, "m_ix": 1, "kind": "median"}),
    ("plot_param_map", {"p_ix": 1, "kind": "error"}, "param_map_data",
     {"p_ix": 1, "kind": "error"}),
    ("plot_intensity", {"kind": "peak"}, "intensity_data", {"kind": "peak"}),
    ("plot_intensity", {"kind": "int", "trans_ix": 1, "m_ix": 1},
     "intensity_data", {"kind": "int", "trans_ix": 1, "m_ix": 1}),
]


@pytest.mark.parametrize("jax_name,jax_kw,step,kw", MAPS,
                         ids=[f"{m[0]}-{i}" for i, m in enumerate(MAPS)])
def test_map_images_match_jax(plotters, monkeypatch, jax_name, jax_kw,
                              step, kw):
    jax, port = plotters
    with jax() as sp:
        calls = _jax_calls(monkeypatch,
                           lambda: getattr(sp, jax_name)(**jax_kw))
    with port() as sp:
        d = getattr(sp, step)(**kw)
    (img,) = _images(calls)
    _same(d["image"], img)
    if step == "nbest_data":
        _same(d["levels"], np.arange(-0.5, np.nanmax(img) + 1.5))


def test_panels_and_grids_match_jax(plotters, monkeypatch):
    """The multi-panel maps: deblended peak and integrated intensity, the
    ncomp metrics, the three parameter grids."""
    jax, port = plotters
    figures = [("plot_deblend_peak", {}, "deblend_peak_data", {}),
               ("plot_deblend_intintens", {}, "deblend_intintens_data", {}),
               ("plot_deblend_intintens", {"vmax": None},
                "deblend_intintens_data", {"vmax": None}),
               ("plot_ncomp_metrics", {}, "ncomp_metrics_data", {}),
               ("plot_map_props", {}, "map_props_data", {}),
               ("plot_quan_props", {}, "quan_props_data", {}),
               ("plot_quan_props", {"quan_ix": 2, "conv": False},
                "quan_props_data", {"quan_ix": 2, "conv": False}),
               ("plot_err_props", {}, "err_props_data", {}),
               ("plot_err_props", {"conv": False}, "err_props_data",
                {"conv": False})]
    for jax_name, jax_kw, step, kw in figures:
        with jax() as sp:
            calls = _jax_calls(monkeypatch,
                               lambda: getattr(sp, jax_name)(**jax_kw))
        with port() as sp:
            d = getattr(sp, step)(**kw)
        imgs = _images(calls)
        if step == "ncomp_metrics_data":
            assert list(d["metrics"]) == ["lnZ", "BIC", "AIC", "AICc"]
            got = list(d["metrics"].values())
            assert all(k["vmax"] == d["n_models"]
                       for m, _, k in calls if m == "imshow")
        elif "images" in d and d["images"].ndim == 4:
            got = list(d["images"].reshape(-1, N_LAT, N_LON))
        else:
            got = list(d["images"])
            assert all(k["vmax"] == d["vmax"] for _, _, k in calls)
        assert len(got) == len(imgs), jax_name
        for g, w in zip(got, imgs):
            _same(g, w)


def test_volume_matches_jax(plotters, monkeypatch):
    jax, port = plotters
    for kw in ({}, {"thresh_frac": 0.3, "trans_ix": 1}):
        with jax() as sp:
            calls = _jax_calls(monkeypatch, lambda: sp.plot_3d_volume(**kw))
        with port() as sp:
            d = sp.volume_data(**kw)
        ((method, args, k),) = calls
        assert method == "scatter" and len(d["values"]) > 0
        for g, w in zip((d["il"], d["ib"], d["iv"], d["values"]),
                        (*args, k["c"])):
            _same(g, w)


def _jax_stack_and_runner():
    stack = _stack(jcube)
    return stack, _runner(JAX_RUNNERS, "ammonia", stack)


def _port_stack_and_runner():
    stack = _stack(tcube)
    return stack, _runner(RUNNERS, "ammonia", stack, device="cpu")


def test_spectra_match_jax(plotters, monkeypatch):
    """``spec_fit``, ``spec_fit_draws`` (the batched draws against the JAX
    per-draw loop) and ``spec_grid``."""
    jax, port = plotters
    jstack, jrunner = _jax_stack_and_runner()
    tstack, trunner = _port_stack_and_runner()
    with jax() as sp:
        fit = _jax_calls(monkeypatch,
                         lambda: sp.plot_spec_fit(0, 0, jstack, jrunner))
        draws = _jax_calls(monkeypatch, lambda: sp.plot_spec_fit_draws(
            0, 0, jstack, jrunner, n_draw=5, animate=True))
        fit1 = _jax_calls(monkeypatch, lambda: sp.plot_spec_fit(
            7, 2, jstack, jrunner, ncomp=2))
        grid = _jax_calls(monkeypatch, lambda: sp.plot_spec_grid(
            jstack, (0, 1), rlon=1, rlat=1, trans_ix=1))
    with port() as sp:
        d_fit = sp.spec_fit_data(0, 0, tstack, trunner)
        d_draws = sp.spec_fit_draws_data(0, 0, tstack, trunner, n_draw=5)
        d_fit1 = sp.spec_fit_data(7, 2, tstack, trunner, ncomp=2)
        d_grid = sp.spec_grid_data(tstack, (0, 1), rlon=1, rlat=1,
                                   trans_ix=1)
    for calls, d in ((fit, d_fit), (fit1, d_fit1)):
        assert d["nbest"] == 2
        steps = [a for m, a, _ in calls if m == "step"]
        plots = [a for m, a, _ in calls if m == "plot"]
        assert len(steps) == len(plots) == 2
        for i_t in range(2):
            _same(d["varr"][i_t], steps[i_t][0])
            _same(d["spectra"][i_t], steps[i_t][1])
            _same(d["varr"][i_t], plots[i_t][0])
            _close_pred(d["models"][i_t], plots[i_t][1])
    plots = [a for m, a, _ in draws if m == "plot"]
    # per transition: 5 draws, then the MAP model; then the GIF's first
    # frame: the MAP model and the first draw of the first transition
    assert len(plots) == 14 and d_draws["draw_models"][0].shape[0] == 5
    _close_pred(d_draws["map_models"][0], plots[12][1])
    _close_pred(d_draws["draw_models"][0][0], plots[13][1])
    for i_t in range(2):
        for i in range(5):
            _close_pred(d_draws["draw_models"][i_t][i],
                        plots[6 * i_t + i][1])
        _close_pred(d_draws["map_models"][i_t], plots[6 * i_t + 5][1])
    steps = [a for m, a, _ in grid if m == "step"]
    cells = [v for v in d_grid["cells"].values() if v is not None]
    # off the map (lon -1) and the NaN spectrum are grey
    assert len(d_grid["cells"]) == 9 and len(cells) == 5
    assert d_grid["cells"][0, 2] is None       # (lon 1, lat 2): NAN_PIX
    assert len(steps) == len(cells)
    for (x, y), arr in zip(steps, cells):
        _same(d_grid["varr"], x)
        _same(arr, y)


def test_histograms_match_jax(plotters, monkeypatch):
    """``post_stack`` (every run, parameter and component) and
    ``velo_2corr``: NumPy's histograms, bit for bit."""
    jax, port = plotters
    with jax() as sp:
        stack = _jax_calls(monkeypatch, lambda: sp.plot_post_stack(0, 0))
        corr = _jax_calls(monkeypatch, lambda: sp.plot_velo_2corr(0, 0))
        with pytest.raises(ValueError, match="no 2-comp run"):
            sp.plot_velo_2corr(5, 0)
    with port() as sp:
        d_stack = sp.post_stack_data(0, 0)
        d_corr = sp.velo_2corr_data(0, 0)
        with pytest.raises(ValueError, match="no 2-comp run"):
            sp.velo_2corr_data(5, 0)
    hists = [(a, k) for m, a, k in stack if m == "hist"]
    assert len(hists) == len(d_stack["hists"]) == 6 * (1 + 2)
    for (a, k), h in zip(hists, d_stack["hists"]):
        want, edges = np.histogram(a[0], bins=k["bins"],
                                   density=k["density"])
        _same(h["density"], want)
        _same(h["edges"], edges)
    ((_, a, k),) = [c for c in corr if c[0] == "hist2d"]
    want = np.histogram2d(a[0], a[1], bins=k["bins"])
    for g, w in zip((d_corr["hist"], d_corr["xedges"], d_corr["yedges"]),
                    want):
        _same(g, w)
    (line,) = [a for m, a, _ in corr if m == "plot"]
    _same(d_corr["diag"], line[0])


def _corner_matches(d, calls):
    """The recorded drawing calls of a corner plot against its data."""
    it = iter(calls)
    for i in range(d["ndim"]):
        for j in range(i + 1):
            if i == j and d["contours"]:
                m, a, _ = next(it)
                assert m == "plot"
                _same(d["diag"][i][0], a[0])
                _same(d["diag"][i][1], a[1])
            elif i == j:
                m, a, k = next(it)
                assert m == "hist"
                want = np.histogram(a[0], bins=k["bins"], density=True)
                for g, w in zip(d["diag"][i], want):
                    _same(g, w)
            elif d["contours"]:
                xc, yc, dens, levels = d["lower"][i, j]
                (m1, a1, k1), (m2, a2, k2) = next(it), next(it)
                assert (m1, m2) == ("contourf", "contour")
                for g, w in zip((xc, yc, dens), a1[:3]):
                    _same(g, w)
                _same(list(levels) + [dens.max() + 1e-30], k1["levels"])
                _same(levels, k2["levels"])
            else:
                m, a, k = next(it)
                assert m == "hist2d"
                want = np.histogram2d(a[0], a[1], bins=k["bins"])
                for g, w in zip(d["lower"][i, j], want):
                    _same(g, w)
    assert next(it, None) is None


def test_corner_matches_jax(plotters, monkeypatch):
    """The pixel corner plot, ``corner_plot`` with and without contours,
    and ``_kde_density_2d``."""
    jax, port = plotters
    with jax() as sp:
        calls = _jax_calls(monkeypatch, lambda: sp.plot_corner(7, 0))
    with port() as sp:
        d = sp.corner_data(7, 0)
    assert d["nbest"] == 1 and d["ndim"] == 6
    assert d["labels"] == ["voff1", "trot1", "tex1", "ntot1", "sigm1",
                           "orth1"]
    _corner_matches(d, calls)
    rng = np.random.default_rng(2)
    samples = rng.normal(size=(300, 3)) * [1.0, 0.1, 5.0] + [0, 2, -1]
    samples[:, 2] += samples[:, 0]
    for kw in ({}, {"contours": False, "bins": 20}, {"smooth": 0.5}):
        calls = _jax_calls(monkeypatch,
                           lambda: jplot.corner_plot(samples, **kw))
        d = tplot.corner_plot_data(samples, **kw)
        _corner_matches(d, calls)
    for bins, smooth in ((64, 1.5), (30, 0.3)):
        got = tplot._kde_density_2d(samples[:, 0], samples[:, 2], bins,
                                    smooth)
        want = jplot._kde_density_2d(samples[:, 0], samples[:, 2], bins,
                                     smooth)
        for g, w in zip(got, want):
            _same(g, w)


def test_module_figures_match_jax(monkeypatch):
    """``plot_info_kernel``, ``plot_synth_spectra`` and
    ``plot_amm_predict_precision``; the precision data in float64 within
    the bar of ``tests/test_models.py`` against the oracle."""
    calls = _jax_calls(monkeypatch, lambda: jplot.plot_info_kernel(
        1.5, 3, clip_radius=2.5))
    _same(tplot.info_kernel_data(1.5, 3, clip_radius=2.5)["kernel"],
          _images(calls)[0])
    calls = _jax_calls(monkeypatch, lambda: jplot.plot_synth_spectra(
        jsynth.get_test_spectra()))
    d = tplot.synth_spectra_data(tsynth.get_test_spectra())
    steps = [a for m, a, _ in calls if m == "step"]
    plots = [a for m, a, _ in calls if m == "plot"]
    assert len(d) == len(steps) == len(plots) == 2
    for (varr, sampled, truth), s, p in zip(d, steps, plots):
        _same(varr, s[0])
        _same(sampled, s[1])
        _same(truth, p[1])
    for trans_id in (1, 2):
        calls = _jax_calls(monkeypatch, lambda: jplot.plot_amm_predict_precision(
            trans_id=trans_id))
        d = tplot.amm_predict_precision_data(trans_id, device="cpu")
        (truth, pred, diff) = [a for m, a, _ in calls if m == "plot"]
        _same(d["varr"], truth[0])
        _same(d["truth"], truth[1])
        assert d["pred"].dtype == np.float32
        _close_pred(d["pred"], pred[1])
        np.testing.assert_allclose(d["diff"], diff[1],
                                   atol=PRED_RTOL * np.abs(d["truth"]).max())
        d64 = tplot.amm_predict_precision_data(trans_id, device="cpu",
                                               dtype=torch.float64)
        np.testing.assert_allclose(d64["pred"], d64["truth"], rtol=1e-8,
                                   atol=1e-5)
        assert d64["truth"].max() > 0.5


def test_world_ticks_and_formatters_match_jax(plotters):
    jax, port = plotters
    ticks = np.linspace(-0.5, 9.5, 11)
    with jax() as sp:
        fx, fy = sp._world_formatters()
        want = ([fx(p, i) for i, p in enumerate(ticks)],
                [fy(p, i) for i, p in enumerate(ticks)])
        labels = sp.sky_labels
    with port() as sp:
        assert sp.world_tick_labels(ticks, ticks) == want
        assert sp.sky_labels == labels
    for v in np.random.default_rng(0).uniform(-400.0, 400.0, 200):
        assert tplot.format_ra_hms(v) == jplot.format_ra_hms(v)
        assert tplot.format_dec_dms(v / 4.5) == jplot.format_dec_dms(v / 4.5)


def _all_data(sp, stack, runner):
    """Every data step of the inventory, keyed by its call."""
    steps = {
        "nbest": lambda: sp.nbest_data(),
        "conv_nbest": lambda: sp.nbest_data(conv=True),
        "evdiff": lambda: sp.evidence_diff_data(),
        "mext": lambda: sp.mext_evidence_data(),
        "metrics": lambda: sp.ncomp_metrics_data(),
        "map_props": lambda: sp.map_props_data(),
        "quan_props": lambda: sp.quan_props_data(),
        "err_props": lambda: sp.err_props_data(),
        "map": lambda: sp.param_map_data(0, kind="MAP"),
        "median": lambda: sp.param_map_data(0, kind="median"),
        "error": lambda: sp.param_map_data(0, kind="error"),
        "peak": lambda: sp.intensity_data(kind="peak"),
        "int": lambda: sp.intensity_data(kind="int"),
        "deblend_peak": lambda: sp.deblend_peak_data(),
        "deblend_int": lambda: sp.deblend_intintens_data(),
        "volume": lambda: sp.volume_data(),
        "post_stack": lambda: sp.post_stack_data(0, 0),
        "spec_fit": lambda: sp.spec_fit_data(0, 0, stack, runner),
        "draws": lambda: sp.spec_fit_draws_data(0, 0, stack, runner, 5),
        "grid": lambda: sp.spec_grid_data(stack, (1, 1), rlon=1, rlat=1),
        "velo": lambda: sp.velo_2corr_data(0, 0),
        "corner": lambda: sp.corner_data(0, 0),
        "ticks": lambda: sp.world_tick_labels([0.0, 3.0], [1.0, 5.0]),
    }
    return {k: fn() for k, fn in steps.items()}


def _assert_same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}/{i}")
    elif a is None or isinstance(a, str):
        assert a == b, path
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


def test_record_source_equals_store_source(fitted, plotters, tmp_path):
    """``RecordSource`` of the records, their ``postprocess_table`` products
    and the stack's header gives every data step the store's arrays."""
    _name, table, prod, header = fitted
    _jax, port = plotters
    stack, runner = _port_stack_and_runner()
    with port() as sp:
        want = _all_data(sp, stack, runner)
    sp = tplot.StorePlotter(tplot.RecordSource(table, prod, header),
                            plot_dir=tmp_path, device="cpu")
    assert (sp.n_lon, sp.n_lat) == (N_LON, N_LAT)
    assert sp.par_names == list(MODELS["ammonia"].PAR_NAMES)
    _assert_same_tree(_all_data(sp, stack, runner), want)


def test_renderers_write_their_files(fitted, tmp_path):
    """Every renderer of the inventory draws its data step's arrays into
    its file on the CPU, the GIF included."""
    _name, table, prod, header = fitted
    stack, runner = _port_stack_and_runner()
    sp = tplot.StorePlotter(tplot.RecordSource(table, prod, header),
                            plot_dir=tmp_path / "plots", device="cpu")
    made = [
        sp.plot_nbest(),
        sp.plot_nbest(name="map_conv_nbest", conv=True),
        sp.plot_evidence_diff(),
        sp.plot_mext_evidence(),
        sp.plot_ncomp_metrics(),
        sp.plot_map_props(),
        sp.plot_quan_props(),
        sp.plot_err_props(),
        sp.plot_param_map(0, kind="MAP"),
        sp.plot_param_map(0, kind="median"),
        sp.plot_param_map(0, kind="error"),
        sp.plot_intensity(kind="peak"),
        sp.plot_intensity(kind="int"),
        sp.plot_deblend_peak(),
        sp.plot_deblend_intintens(),
        sp.plot_3d_volume(),
        sp.plot_post_stack(0, 0),
        sp.plot_spec_fit(0, 0, stack, runner),
        sp.plot_spec_fit_draws(0, 0, stack, runner, n_draw=5,
                               animate=True),
        sp.plot_spec_grid(stack, (1, 1), rlon=1, rlat=1),
        sp.plot_velo_2corr(0, 0),
        sp.plot_corner(7, 0),
        tplot.plot_info_kernel(1.5, 3, clip_radius=3,
                               out_path=str(tmp_path / "ik.pdf")),
        tplot.plot_synth_spectra(tsynth.get_test_spectra(),
                                 out_path=str(tmp_path / "synth.pdf")),
        tplot.plot_amm_predict_precision(str(tmp_path / "prec.pdf"),
                                         device="cpu"),
    ]
    assert made[18].suffix == ".gif"
    for path in map(Path, made):
        assert path.exists() and path.stat().st_size > 0, path
    fig = tplot.corner_plot(np.random.default_rng(1).normal(size=(200, 3)),
                            labels=["a", "b", "c"], contours=False)
    assert len(fig.axes) == 9
