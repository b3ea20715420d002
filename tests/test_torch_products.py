"""Port parity of post-processing (``nestfit_tpu_torch/cube/products.py``)
against ``nestfit_tpu/cube/products.py``.

Seeded stores are written with the port's ``write_chunk`` for the NH3,
Gaussian and N2H+ models (ncomp_max 2, a 9x7 map): an absent pixel,
pixels at nbest 0, 1 and 2, a pixel the smoothed evidence promotes and one
the one-step cap holds, and posterior samples on the bin edges, below
the range and above it.  Each store is copied twice; the JAX package's
``postprocess_run`` runs on one copy and the port's (``device="cpu"``)
on the other, and every dataset under ``/products`` is compared at its
bar.  The functions are also held one by one at their edges."""

import os
import shutil
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from nestfit_tpu import cube as jcube
from nestfit_tpu.cube import products as jprod
from nestfit_tpu.models import RUNNERS as JAX_RUNNERS

from nestfit_tpu_torch import cube as tcube
from nestfit_tpu_torch.cube import HdfStore
from nestfit_tpu_torch.cube import products as tprod
from nestfit_tpu_torch.cube.fitter import BatchRecords
from nestfit_tpu_torch.cube.store import write_chunk
from nestfit_tpu_torch.models import MODELS, RUNNERS
from nestfit_tpu_torch.models.tables import AMMONIA_TRANSITIONS, \
    DIAZENYLIUM_TRANSITIONS
from nestfit_tpu_torch.sampling.results import MARGINAL_COLS, QUANTILES
from nestfit_tpu_torch.synth import make_fake_header
from nestfit_tpu_torch.utils import freq_axis_from_velocity

from _cube_inputs import hdf_tree

N_LON, N_LAT, N_POST, NCOMP_MAX, THRESH = 9, 7, 64, 2, 11
ABSENT = (8, 6)
HELD = (2, 3)          # nbest 0 amid nbest-2 pixels: promoted, capped at 1
PROMOTED = (2, 1)      # nbest 1 amid nbest-2 pixels: promoted to 2
# per-component parameters, parameter-major: (component 0, component 1)
COMPONENTS = {
    "ammonia": [(-0.8, 0.9), (12.0, 15.0), (6.0, 5.0), (14.5, 14.2),
                (0.4, 0.6), (0.0, 0.0)],
    "gaussian": [(-1.0, 1.2), (0.5, 0.7), (1.0, 0.6)],
    "diazenylium": [(-0.5, 1.0), (5.0, 6.0), (0.2, 0.8), (0.25, 0.5)],
}
# NH3 with given bins: edges float32 can hold exactly, so samples sit on them
NH3_BINS = np.array([np.linspace(lo, hi, 33) for lo, hi in (
    (-4.0, 4.0), (0.0, 32.0), (0.0, 16.0), (12.0, 16.0), (0.0, 2.0),
    (-1.0, 1.0))])

# bars: exact, one float32 ulp, float64, float32
# products, model-based products (tests/test_torch_models.py's amm_predict)
EXACT = ("nbest", "evidence", "evidence_err", "BIC", "AIC", "AICc",
         "nbest_MAP", "nbest_bestfit", "nbest_marginals", "marg_quantiles",
         "pdf_bins", "conv_nbest")
BARS = {"conv_evidence": (1e-9, 0.0), "mext_evidence": (1e-9, 0.0),
        "conv_post_pdfs": (1e-5, 1e-6)}
QUANTILE_BAR = (1e-5, 1e-6)
MODEL_BAR = (1e-5, 1e-5)


def _nbest_map():
    """nbest per (lon, lat): 2 on lon 0-4 (with HELD at 0 and PROMOTED at
    1), 0 on lon 5-6, 1 on lon 7-8; ABSENT has none."""
    nb = np.zeros((N_LON, N_LAT), dtype=np.int64)
    nb[:5] = 2
    nb[HELD] = 0
    nb[PROMOTED] = 1
    nb[7:] = 1
    return nb


def _axes(model):
    """``[(trans_id, xarr, rest)]`` of the model's transitions."""
    if model == "ammonia":
        v = np.linspace(-12, 12, 96)
        return [(t, freq_axis_from_velocity(v, AMMONIA_TRANSITIONS[t - 1].nu),
                 AMMONIA_TRANSITIONS[t - 1].nu) for t in (1, 2)]
    if model == "diazenylium":
        nu = DIAZENYLIUM_TRANSITIONS[0].nu
        return [(1, freq_axis_from_velocity(np.arange(-20, 20, 0.4), nu), nu)]
    return [(-1, freq_axis_from_velocity(np.linspace(-8, 8, 80),
                                         AMMONIA_TRANSITIONS[0].nu), None)]


def _stack(cube_module, model):
    return cube_module.CubeStack([
        cube_module.DataCube(
            np.zeros((N_LON, N_LAT, xarr.size)), xarr, noise_map=0.1,
            trans_id=tid,
            header=make_fake_header(N_LON, N_LAT, xarr, rms=0.1,
                                    rest_freq=rest))
        for tid, xarr, rest in _axes(model)])


def _record(rng, model, ncomp, lnz, null, truth, samples_at=()):
    """One ``records.fit_group_record``-form record: posterior samples about
    ``truth`` [n, ncomp], their quantiles as marginals, MAP and best fit;
    ``samples_at`` values overwrite the first samples of every column."""
    n = truth.shape[0]
    ndim = n * ncomp
    theta = truth[:, :ncomp].reshape(-1)             # parameter-major
    scale = np.maximum(0.05 * np.abs(theta), 0.02)
    if model == "ammonia":
        scale[-ncomp:] = 0.0                          # orth is held at 0
    post = theta + scale * rng.normal(size=(N_POST, ndim))
    for i, v in enumerate(samples_at):
        post[i] = v
    post = np.concatenate([post, rng.normal(size=(N_POST, 2))], axis=1)
    post = post.astype(np.float32)
    marg = np.quantile(post[:, :ndim], QUANTILES, axis=0).astype(np.float32)
    attrs = {"ncomp": ncomp, "null_lnZ": null, "n_chan_tot": 96,
             "n_samples": N_POST, "n_live": 100, "n_params": ndim,
             "global_lnZ": lnz, "global_lnZ_err": 0.1 + 0.01 * ncomp,
             "max_loglike": lnz + 5.0, "marg_cols": MARGINAL_COLS,
             "marg_quantiles": QUANTILES, "n_calls": 1000, "converged": True}
    for key, off in (("BIC", 1.0), ("AIC", 2.0), ("AICc", 3.0)):
        attrs[key] = -2 * lnz + off * ndim
        attrs[f"null_{key}"] = -2 * null
    return attrs, {"posteriors": post, "marginals": marg,
                   "bestfit_params": post[0, :ndim].copy(),
                   "map_params": post[1, :ndim].copy()}


def _batches(model, seed, on_edges):
    """The store's records as two ``BatchRecords`` (two chunk files)."""
    rng = np.random.default_rng(seed)
    truth = np.array(COMPONENTS[model])              # [n, 2]
    nb = _nbest_map()
    gains = {0: (2.0, None), 1: (60.0, 3.0), 2: (200.0, 100.0)}
    pix_all, records = [], []
    for il in range(N_LON):
        for ib in range(N_LAT):
            if (il, ib) == ABSENT:
                continue
            pix = il * N_LAT + ib
            pix_all.append(pix)
            null = -500.0 + rng.normal()
            g1, g2 = gains[nb[il, ib]]
            lnz = {1: null + g1 + rng.normal()}
            if nb[il, ib] >= 1:
                lnz[2] = lnz[1] + g2 + rng.normal()
            local = truth + 0.1 * rng.normal(size=truth.shape)
            for ncomp in lnz:
                at = ()
                if on_edges and ncomp == 1:
                    # on edges (first, interior, last) and outside the bins
                    at = [NH3_BINS[:, 0], NH3_BINS[:, 5], NH3_BINS[:, -1],
                          NH3_BINS[:, 0] - 1, NH3_BINS[:, -1] + 1]
                elif nb[il, ib] >= 1 and ncomp != nb[il, ib] and \
                        (il, ib) != PROMOTED and (il + ib) % 3 == 0:
                    # runs the smoothed selection leaves out: samples
                    # outside the bins
                    at = [local[:, :ncomp].reshape(-1) - 50,
                          local[:, :ncomp].reshape(-1) + 50]
                records.append((pix, ncomp, _record(
                    rng, model, ncomp, lnz[ncomp], null, local, at)))
    pix_all = np.array(pix_all)
    half = pix_all.size // 2
    out = []
    for chunk, sel in enumerate((pix_all[:half], pix_all[half:])):
        keep = set(sel.tolist())
        out.append(BatchRecords(
            chunk=chunk, nlive=100, pixel_ix=sel,
            nbest=np.array([nb[p // N_LAT, p % N_LAT] for p in sel],
                           dtype=np.int32),
            records=[r for r in records if r[0] in keep], rungs=[]))
    return out


def _write_store(name, model, batches):
    store = HdfStore(name, nchunks=2)
    store.insert_header(_stack(tcube, model))
    store.insert_fitter_pars(types.SimpleNamespace(
        lnZ_thresh=THRESH, ncomp_max=NCOMP_MAX, ns_kwargs={"nlive": 100}))
    store.insert_model_metadata(MODELS[model])
    for batch in batches:
        write_chunk(store.chunk_paths[batch.chunk], batch, N_LAT)
    store.link_files()
    store.close()


def _runner(runners, model, stack, **kw):
    cls = runners[model]
    spectra = tuple(
        cls.model.make_model_spectrum(c.xarr, np.zeros_like(c.xarr), 0.1,
                                      trans_id=c.trans_id, **kw)
        for c in stack.cubes)
    return cls(spectra, None, ncomp=1, **kw)


CASES = {"nh3": ("ammonia", NH3_BINS), "nh3_default_bins": ("ammonia", None),
         "gaussian": ("gaussian", None), "n2hp": ("diazenylium", None)}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Per case: the JAX and the port copies of its store after each
    package's ``postprocess_run``, with each package's FITS files."""
    torch.set_num_threads(2)
    out = {}
    for seed, (case, (model, bins)) in enumerate(CASES.items()):
        root = tmp_path_factory.mktemp(case)
        base = str(root / "base")
        batches = _batches(model, seed, on_edges=bins is not None)
        _write_store(base, model, batches)
        names = {}
        for tag, cube_mod, prod, runners, kw in (
                ("jax", jcube, jprod, JAX_RUNNERS, {}),
                ("port", tcube, tprod, RUNNERS, {"device": "cpu"})):
            name = str(root / tag)
            shutil.copytree(f"{base}.store", f"{name}.store")
            stack = _stack(cube_mod, model)
            with cube_mod.HdfStore(name) as store:
                prod.postprocess_run(store, stack,
                                     _runner(runners, model, stack, **kw),
                                     par_bins=bins, evid_kernel=1.0,
                                     post_kernel=1.0, **kw)
                prod.extended_masked_evidence(store, 1.0, **kw)
                fits = prod.create_fits_from_store(store, prefix=name, **kw)
            names[tag] = (f"{name}.store/table.hdf",
                          [Path(f) for f in fits])
        out[case] = (model, batches, base, names)
    return out


def _products(path):
    import h5py

    with h5py.File(path, "r") as f:
        out = {}
        f["products"].visititems(
            lambda k, v: out.__setitem__(k, v[...])
            if isinstance(v, h5py.Dataset) else None)
    return out


def _jax_quantiles_on(jax_table, conv_post_pdfs, tmp_path):
    """The JAX package's ``quantize_conv_marginals`` on a copy of its store
    holding ``conv_post_pdfs`` in place of its own."""
    src = os.path.dirname(jax_table)
    shutil.copytree(src, tmp_path / "requant.store")
    with jcube.HdfStore(str(tmp_path / "requant")) as store:
        store.create_dataset("conv_post_pdfs", conv_post_pdfs,
                             group=store.dpath)
        jprod.quantize_conv_marginals(store)
        return store.hdf[f"{store.dpath}/conv_marginals"][...]


@pytest.mark.parametrize("case", list(CASES))
def test_postprocess_run_matches_jax(stores, case, tmp_path):
    """Every ``/products`` dataset of the port's ``postprocess_run`` against
    the JAX package's, at its bar; NaN masks identical; the FITS export
    byte for byte.

    ``conv_marginals`` inverts a float32 CDF: where one of its values lies
    within float32 rounding of a quantile (always at q = 1, where the
    running sum reaches its total) the reference's answer jumps by bins
    when ``conv_post_pdfs`` moves by an ulp, which the two packages' FFTs
    do.  So the quantile step is held bit for bit against the JAX step on
    the port's own ``conv_post_pdfs``, and the end-to-end products at the
    bar on all but such jumps, which stay rare."""
    model, _batches_, _base, names = stores[case]
    t_tree = hdf_tree(names["port"][0], values=False)
    j_tree = hdf_tree(names["jax"][0], values=False)
    assert t_tree == j_tree
    got, want = _products(names["port"][0]), _products(names["jax"][0])
    assert sorted(got) == sorted(want)
    assert len(want) == 20 + len(_axes(model))
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w),
                                          err_msg=key)
        if key in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif key == "conv_marginals":
            requant = _jax_quantiles_on(names["jax"][0],
                                        got["conv_post_pdfs"], tmp_path)
            np.testing.assert_array_equal(g, requant)
            close = np.isclose(g, w, *QUANTILE_BAR, equal_nan=True)
            assert (~close).sum() <= 1e-3 * close.size, (~close).sum()
        elif key == "post_pdfs":
            ok = ~np.isnan(w)
            ulps = np.abs(g[ok].view(np.int32).astype(np.int64)
                          - w[ok].view(np.int32).astype(np.int64))
            assert ulps.max(initial=0) <= 1, key
        else:
            rtol, atol = BARS.get(key, MODEL_BAR)
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=key)
    # the FITS export: byte for byte the JAX export of the same store, and
    # the JAX package's own files at the model bar
    with jcube.HdfStore(str(Path(names["port"][0]).parent)
                        .removesuffix(".store")) as store:
        again = jprod.create_fits_from_store(store, prefix=str(tmp_path / "j"))
    assert len(again) == len(names["port"][1]) == len(names["jax"][1]) == 2
    for t_path, j_path, jt_path in zip(names["port"][1], names["jax"][1],
                                       again):
        assert t_path.read_bytes() == open(jt_path, "rb").read()
        (t_data, t_head), (j_data, j_head) = (
            tcube.read_fits(p) for p in (t_path, j_path))
        assert t_head == j_head
        np.testing.assert_allclose(t_data, j_data, *MODEL_BAR)
    # the case covers what it is for
    nb, conv = want["nbest"], want["conv_nbest"]
    assert nb[ABSENT[::-1]] == -1 and set(np.unique(nb)) == {-1, 0, 1, 2}
    assert (nb[HELD[::-1]], conv[HELD[::-1]]) == (0, 1)
    assert (nb[PROMOTED[::-1]], conv[PROMOTED[::-1]]) == (1, 2)
    assert np.isfinite(want["peak_intensity"]).any()
    if case == "nh3":
        assert (want["pdf_bins"] == (NH3_BINS[:, 1:] + NH3_BINS[:, :-1])
                / 2).all()


@pytest.mark.parametrize("case", ["nh3", "gaussian"])
def test_from_records_equals_store_table(stores, case):
    """``FitTable.from_records`` of the records equals ``FitTable(store)``
    of the store written from them, array for array."""
    model, batches, base, _names = stores[case]
    want = None
    with HdfStore(base) as store:
        want = tprod.FitTable(store, with_posteriors=True)
    got = tprod.FitTable.from_records(
        batches, N_LON, N_LAT, NCOMP_MAX, MODELS[model].N, THRESH,
        MODELS[model], with_posteriors=True)
    for attr in ("n_lon", "n_lat", "ncomp_max", "n_params", "lnz_thresh",
                 "model"):
        assert getattr(got, attr) == getattr(want, attr), attr
    np.testing.assert_array_equal(got.marg_quantiles, want.marg_quantiles)
    for k, w in want.pix.items():
        assert got.pix[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got.pix[k], w)
    assert sorted(got.runs) == sorted(want.runs) == [1, 2]
    for n, rec in want.runs.items():
        assert sorted(got.runs[n]) == sorted(rec)
        for k, w in rec.items():
            assert got.runs[n][k].dtype == w.dtype, (n, k)
            np.testing.assert_array_equal(got.runs[n][k], w, err_msg=k)


def test_postprocess_table_matches_store_chain(stores):
    """The array layer's one-call chain on a table of records gives the
    products the store-layer steps wrote, exactly."""
    model, batches, _base, names = stores["nh3"]
    tab = tprod.FitTable.from_records(
        batches, N_LON, N_LAT, NCOMP_MAX, MODELS[model].N, THRESH,
        MODELS[model], with_posteriors=True)
    stack = _stack(tcube, model)
    walls = {}
    got = tprod.postprocess_table(
        tab, stack, _runner(RUNNERS, model, stack, device="cpu"),
        par_bins=NH3_BINS, evid_kernel=1.0, post_kernel=1.0, device="cpu",
        walls=walls)
    want = _products(names["port"][0])
    assert sorted(got) == sorted(set(want) - {"mext_evidence"})
    for key, t in got.items():
        assert t.is_contiguous() and t.device.type == "cpu", key
        np.testing.assert_array_equal(t.numpy(), want[key], err_msg=key)
    assert sorted(walls) == sorted((
        "attributes", "conv_evidence", "products", "post_pdfs",
        "conv_post_pdfs", "conv_marginals", "predict", "deblend",
        "profiles"))
    assert tab.h2d_bytes == 0


# ---------------------------------------------------------------------------
# the functions one by one
# ---------------------------------------------------------------------------

def _map(shape, seed, holes=()):
    x = np.random.default_rng(seed).normal(size=shape) * 10.0
    for h in holes:
        x[h] = np.nan
    return x


CONV_CASES = {
    "smaller_than_kernel": (_map((4, 2), 0), 1.0, "extend"),
    "nan_holes": (_map((7, 9), 1, [(0, 0), (3, 4), (3, 5), (6, 8)]), 1.0,
                  "extend"),
    "all_nan_plane": (np.stack([_map((5, 6), 2), np.full((5, 6), np.nan)]),
                      0.7, "extend"),
    "batch_axes": (_map((2, 3, 5, 6), 3, [(0, 1, 2, 3)]), 1.5, "extend"),
    "even_kernel": (_map((6, 5), 4, [(2, 2)]),
                    np.array([[1.0, 2.0], [0.5, 1.5]]), "extend"),
    "info_kernel": (_map((8, 8), 5), jprod.get_indep_info_kernel(1.2, 2),
                    "extend"),
    "zero_boundary": (_map((5, 4), 6, [(0, 0)]), 1.0, "fill"),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_convolve_nan_matches_jax(case):
    data, kernel, boundary = CONV_CASES[case]
    want = jprod.convolve_nan(data, kernel, boundary=boundary)
    got = tprod.convolve_nan(torch.as_tensor(data), kernel,
                             boundary=boundary).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    if case == "all_nan_plane":
        assert np.isnan(got[1]).all() and np.isfinite(got[0]).all()


@pytest.mark.parametrize("case", ["smaller_than_kernel", "nan_holes",
                                  "batch_axes", "even_kernel"])
def test_convolve_fft_unnorm_matches_jax(case):
    data, kernel, _ = CONV_CASES[case]
    want = jprod.convolve_fft_unnorm(data, kernel)
    got = tprod.convolve_fft_unnorm(torch.as_tensor(data), kernel).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_batched_histogram_matches_jax():
    edges = np.linspace(-1.0, 1.0, 9)
    vals = np.random.default_rng(7).uniform(-1.5, 1.5, size=(6, 40))
    vals = vals.astype(np.float32)
    vals[0, :9] = edges                      # every edge, the last included
    vals[1, :3] = [np.nan, -np.inf, np.inf]
    vals[2] = np.nan                         # a row of NaN: no counts
    vals[3] = 5.0                            # a row out of range
    want = jprod._batched_histogram(vals, edges)
    got = tprod._batched_histogram(torch.as_tensor(vals),
                                   torch.as_tensor(edges))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0].sum() > 9 and want[2].sum() == want[3].sum() == 0


def test_invert_cdf_rows_matches_jax():
    H, xs = 12, np.linspace(-3.0, 3.0, 12)
    rng = np.random.default_rng(8)
    pdf = rng.random((10, H)).astype(np.float32)
    pdf[1, 4:8] = 0.0                        # flat segments
    pdf[2, :6] = 0.0                         # flat start
    pdf[3, 1:] = 0.0                         # one-bin mass
    cdf = np.cumsum(pdf, axis=1) / pdf.sum(axis=1, keepdims=True)
    cdf[4, 3] = np.nan                       # bad rows
    cdf[5] = np.inf
    cdf[6, 0] = 0.5                          # the table starts above q
    cdf = cdf.reshape(2, 5, H)
    qs = np.concatenate([QUANTILES, [0.0, 1.0, 0.05, 0.999]])
    want = jprod._invert_cdf_rows(cdf, xs, qs)
    got = tprod._invert_cdf_rows(torch.as_tensor(cdf), torch.as_tensor(xs),
                                 torch.as_tensor(qs))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(want[0, 4]).all() and np.isnan(want[1, 0]).all()


@pytest.mark.parametrize("incl_zero", [True, False])
def test_take_by_components_matches_jax(incl_zero):
    rng = np.random.default_rng(9)
    data = rng.normal(size=(3, 2, 4, 5))
    comps = rng.integers(-1, 4, size=(4, 5)).astype(np.int32)
    for axis, d in ((0, data), (1, data.transpose(1, 0, 2, 3))):
        want = jprod.take_by_components(d, comps, axis=axis,
                                        incl_zero=incl_zero)
        got = tprod.take_by_components(torch.as_tensor(d),
                                       torch.as_tensor(comps), axis=axis,
                                       incl_zero=incl_zero)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("args", [(1.0, 1), (1.5, 3), (0.8, 2, 1.5),
                                  (2.0, 0)])
def test_kernels_match_jax(args):
    want = jprod.get_indep_info_kernel(*args)
    got = tprod.get_indep_info_kernel(*args)
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
    for radius in (None, 1.2, 100.0):
        m_want = jprod.apply_circular_mask(want, radius)
        m_got = tprod.apply_circular_mask(got, radius)
        assert m_got.tobytes() == m_want.tobytes()
    g = tprod.gaussian_kernel_2d(args[0])
    assert g.tobytes() == jprod.gaussian_kernel_2d(args[0]).tobytes()


def test_product_entry_points_need_a_card_by_default(stores):
    """Every entry point defaults to ``device="cuda"`` and raises without a
    card; none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    model, batches, base, _names = stores["gaussian"]
    stack = _stack(tcube, model)
    runner = _runner(RUNNERS, model, stack, device="cpu")
    tab = tprod.FitTable.from_records(batches, N_LON, N_LAT, NCOMP_MAX,
                                      MODELS[model].N, THRESH, MODELS[model],
                                      with_posteriors=True)
    with pytest.raises(RuntimeError, match="cuda"):
        tprod.postprocess_table(tab, stack, runner, evid_kernel=1.0,
                                post_kernel=1.0)
    with pytest.raises(RuntimeError, match="cuda"):
        tprod.attribute_maps(tab)
    with pytest.raises(RuntimeError, match="cuda"):
        tprod.nans((2, 2))
    with HdfStore(base) as store:
        for call in (lambda: tprod.postprocess_run(store, stack, runner),
                     lambda: tprod.aggregate_run_attributes(store),
                     lambda: tprod.create_fits_from_store(store)):
            with pytest.raises(RuntimeError, match="cuda"):
                call()
    with pytest.raises(ValueError, match="one-component"):
        tprod.postprocess_table(tab, stack, RUNNERS[model](
            runner.spectra, None, ncomp=2, device="cpu"), device="cpu")
