"""Port parity of the cube fitter: ``bucket_nlive`` and ``_pad_quantum``
exact against the JAX package, the JAX fitter tests of
``tests/test_fit_cube.py`` (ladder smoke, injected mode loss, boundary
refinement, resume) on the port with their own bars, and a port store
against the JAX store of the same cube and settings.

Everything runs on ``device="cpu"`` (the kernels' plain versions) on the
4x2 synthetic stack: 3 empty pixels, 4 one-component pixels, 1 NaN."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from nestfit_tpu import cube as jcube
from nestfit_tpu.cube.fitter import bucket_nlive as jax_bucket_nlive
from nestfit_tpu.models import AmmoniaRunner as JaxRunner
from nestfit_tpu.priors import get_irdc_priors as jax_priors

from nestfit_tpu_torch import cube as tcube
from nestfit_tpu_torch.cube import HdfStore
from nestfit_tpu_torch.cube.fitter import CubeFitter, bucket_nlive
from nestfit_tpu_torch.models import AmmoniaRunner
from nestfit_tpu_torch.parallel import make_mesh
from nestfit_tpu_torch.priors import get_irdc_priors
from nestfit_tpu_torch.sampling import NSConfig, fit_single

from _cube_inputs import N_LAT, SIGNAL, hdf_tree, synth_stack

VALID = {(l, b) for l in range(4) for b in range(2)} - {(0, 1)}


@pytest.fixture(scope="module")
def stack():
    torch.set_num_threads(2)
    return synth_stack(tcube)


def _fitter(stack, **kw):
    kw = dict(dict(batch_size=8, nlive_buckets=1), **kw)
    return CubeFitter(stack, get_irdc_priors(vsys=0.0, device="cpu"),
                      AmmoniaRunner, device="cpu", **kw)


def _store_groups(name):
    """``{(lon, lat): (nbest, {ncomp: (lnZ, n_calls)})}`` of a store."""
    out = {}
    with HdfStore(name) as store:
        for g in store.iter_pix_groups():
            key = (int(g.attrs["i_lon"]), int(g.attrs["i_lat"]))
            out[key] = (int(g.attrs["nbest"]), {
                int(n): (float(g[n].attrs["global_lnZ"]),
                         int(g[n].attrs["n_calls"])) for n in g})
    return out


@pytest.mark.parametrize("case", [
    ("uniform", 1, 4), ("uniform", 7, 4), ("snr", 300, 4), ("snr", 300, 1),
    ("snr", 300, 7), ("ties", 50, 4), ("wide", 1000, 3)])
def test_bucket_nlive_matches_jax(case):
    kind, n, n_buckets = case
    rng = np.random.default_rng(n + n_buckets)
    nlive = {
        "uniform": np.full(n, 100),
        "snr": 100 + (5 * rng.gamma(1.5, 6.0, n)).astype(int),
        "ties": np.repeat([100, 160, 160, 420, 655], n // 5),
        "wide": 100 + (5 * rng.uniform(0, 110, n)).astype(int),
    }[kind]
    got = bucket_nlive(nlive, n_buckets=n_buckets)
    want = jax_bucket_nlive(nlive, n_buckets=n_buckets)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert np.all(got[0] >= nlive)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8, 9, 64, 100, 1024, 1025])
def test_pad_quantum_matches_jax(stack, n):
    jfit = jcube.CubeFitter(synth_stack(jcube), jax_priors(vsys=0.0),
                            JaxRunner)
    assert _fitter(stack)._pad_quantum(n) == jfit._pad_quantum(n)


def test_fit_cube_ladder_smoke(stack, tmp_path):
    """``tests/test_fit_cube.py::test_fit_cube_ladder_smoke`` on the port:
    every valid pixel gets a rung-1 group and ``nbest`` (the NaN pixel
    none), and the store assembles."""
    fitter = _fitter(stack, ncomp_max=2,
                     ns_kwargs={"nlive": 16, "tol": 5.0, "max_iter": 300},
                     n_post=16, segment_iters=64, mode_loss_retries=0)
    store_name = str(tmp_path / "smoke_cube")
    fitter.fit_cube(store_name=store_name, seed=11)
    store = HdfStore(store_name)
    try:
        pix = store.hdf["pix"]
        pixels = [pix[lon][lat] for lon in pix.keys()
                  for lat in pix[lon].keys()]
        assert len(pixels) == 7
        for grp in pixels:
            assert "1" in grp
            assert "nbest" in grp.attrs
    finally:
        store.close()


def test_mode_loss_refit(stack):
    """``tests/test_fit_cube.py::test_mode_loss_refit`` on the port: an
    injected loss on pixel 0 is re-fitted to a consistent evidence and
    the other rows keep their records."""
    fitter = _fitter(stack, ncomp_max=1, ns_kwargs={"nlive": 60, "tol": 1.0},
                     n_post=64, segment_iters=128)
    datas, noises, nan_mask, _snr = stack.get_flat_batch()
    cur_ix = np.nonzero(~nan_mask)[0][:4]
    cfg = NSConfig(nlive=60, tol=1.0)
    fit, r_pad = fitter._fit_rows(np.random.SeedSequence(2), cur_ix, 1, cfg,
                                  datas, noises)
    assert r_pad == fitter._pad_quantum(cur_ix.size)
    lnz_true = fit.lnz[: cur_ix.size].numpy().copy()
    prev = fit.null_lnz[: cur_ix.size].numpy()

    lnz_bad = lnz_true.copy()
    lnz_bad[0] = prev[0] - 500.0
    stats = {}
    fit2, lnz_fixed = fitter._refit_mode_losses(
        np.random.SeedSequence(3), fit, lnz_bad, prev, cur_ix, r_pad, 1, cfg,
        datas, noises, stats)
    assert lnz_fixed[0] > prev[0] - fitter.mode_loss_margin
    assert abs(lnz_fixed[0] - lnz_true[0]) < 25.0
    assert np.isclose(float(fit2.lnz[0]), lnz_fixed[0])
    np.testing.assert_allclose(lnz_fixed[1:], lnz_true[1:])
    np.testing.assert_allclose(fit2.lnz.numpy()[1: cur_ix.size],
                               lnz_true[1:])
    # the input fit is unchanged; the bookkeeping saw one row
    np.testing.assert_array_equal(fit.lnz[: cur_ix.size].numpy(), lnz_true)
    assert stats["bad_before"] == 1 and stats["bad_after"] == 0
    assert [(a["attempt"], a["rows"], a["nlive"], a["replaced"])
            for a in stats["retries"]] == [(1, 1, 60, 1)]
    # the attempt names the row it replaced, its retry and earlier lnZ
    (a,) = stats["retries"]
    assert a["pixels"].tolist() == [cur_ix[0]]
    assert a["lnz"].tolist() == [lnz_fixed[0]]
    assert a["old_lnz"].tolist() == [lnz_bad[0]]


def test_mode_loss_escalates_after_first_retry(stack):
    """A floor no refit can meet keeps the row through every attempt;
    attempts after the first run at ``boundary_nlive_mult`` x nlive with
    the base run's death budget, and their rows still merge."""
    fitter = _fitter(stack, ncomp_max=1, ns_kwargs={"nlive": 30, "tol": 1.0},
                     n_post=32, segment_iters=128, mode_loss_retries=2)
    datas, noises, nan_mask, _snr = stack.get_flat_batch()
    cur_ix = np.nonzero(~nan_mask)[0][:2]
    cfg = NSConfig(nlive=30, tol=1.0)
    fit, r_pad = fitter._fit_rows(np.random.SeedSequence(4), cur_ix, 1, cfg,
                                  datas, noises)
    lnz = fit.lnz[:2].numpy().copy()
    prev = lnz + np.array([0.0, 1000.0])        # row 1 can never pass
    stats = {}
    fit2, lnz2 = fitter._refit_mode_losses(
        np.random.SeedSequence(5), fit, lnz, prev, cur_ix, r_pad, 1, cfg,
        datas, noises, stats)
    assert [(a["attempt"], a["rows"], a["nlive"]) for a in stats["retries"]] \
        == [(1, 1, 30), (2, 1, 60)]
    assert stats["bad_before"] == stats["bad_after"] == 1
    assert fit2.ns.nlive == 30 and fit2.ns.max_iter == fit.ns.max_iter
    assert lnz2[1] >= lnz[1] and lnz2[0] == lnz[0]
    assert np.isclose(float(fit2.lnz[1]), lnz2[1])


def test_failed_batch_is_rerun_and_counted(stack, monkeypatch):
    """A ladder run that raises is re-run with fresh seeds and the batch
    records that it took two attempts; a clean batch took one."""
    fitter = _fitter(stack, ncomp_max=1,
                     ns_kwargs={"nlive": 16, "tol": 5.0, "max_iter": 300},
                     n_post=16, segment_iters=64, mode_loss_retries=0,
                     boundary_band=0, nlive_snr_fact=0)
    (batch,) = list(fitter._fit_batches(seed=2))
    assert batch.attempts == 1
    ladder, calls = fitter._fit_batch_ladder, []

    def flaky(*args):
        calls.append(len(calls))
        if len(calls) == 1:
            raise RuntimeError("injected launch failure")
        return ladder(*args)

    monkeypatch.setattr(fitter, "_fit_batch_ladder", flaky)
    (batch,) = list(fitter._fit_batches(seed=2))
    assert batch.attempts == 2 and len(calls) == 2
    assert len(batch.records) == 7


def test_fit_cube_boundary_refinement(stack, tmp_path):
    """``tests/test_fit_cube.py::test_fit_cube_boundary_refinement`` on the
    port: every rung-1 run through the boundary pass and a cross-nlive
    merge; the store is complete with finite evidences and the same
    strong-detection decisions as an unrefined run of the same seed."""
    def run(band):
        fitter = _fitter(stack, ncomp_max=1,
                         ns_kwargs={"nlive": 40, "tol": 1.0}, n_post=64,
                         nlive_snr_fact=0, boundary_band=band,
                         boundary_nlive_mult=2)
        name = str(tmp_path / f"band_{band}")
        fitter.fit_cube(store_name=name, seed=3)
        return {k: (nb, *rungs[1]) for k, (nb, rungs) in
                _store_groups(name).items()}

    plain = run(0.0)
    refined = run(1e9)
    assert set(plain) == set(refined) == VALID
    for k in plain:
        nb_p, lnz_p, _ = plain[k]
        nb_r, lnz_r, nc_r = refined[k]
        assert np.isfinite(lnz_r)
        assert nc_r > 0
        if abs(lnz_p) > 50:
            assert nb_p == nb_r, (k, plain[k], refined[k])


def test_boundary_records_carry_the_refit(stack):
    """The batch records of a boundary pass hold the refit's lnZ for every
    re-fitted row, at the base ``n_live``."""
    fitter = _fitter(stack, ncomp_max=1, ns_kwargs={"nlive": 20, "tol": 5.0},
                     n_post=16, nlive_snr_fact=0, boundary_band=1e9)
    (batch,) = list(fitter._fit_batches(seed=1))
    assert batch.nlive == 50            # 20 snapped up to the 50 quantum
    (rung,) = batch.rungs
    band = rung["boundary"]
    assert band["rows"] == 7 and band["nlive"] == 100 and band["r_pad"] == 8
    lnz_of = {pix: rec[0]["global_lnZ"] for pix, _n, rec in batch.records}
    for pix, z in zip(band["pixels"], band["lnz"]):
        assert lnz_of[pix] == float(z)
    assert all(rec[0]["n_live"] == 50 for _p, _n, rec in batch.records)


def test_fit_cube_resume(stack, tmp_path):
    """``tests/test_fit_cube.py::test_fit_cube_resume`` on the port: a
    partial completion manifest makes ``fit_cube`` fit only the rest."""
    import h5py

    fitter = _fitter(stack, ncomp_max=1, ns_kwargs={"nlive": 50, "tol": 1.0},
                     n_post=64)
    store_name = str(tmp_path / "resume_cube")
    pre_done = np.array([0, 1, 2, 3, 4])
    store = HdfStore(store_name, nchunks=1)
    with h5py.File(store.chunk_paths[0], "a") as chunk:
        HdfStore.mark_completed(chunk, pre_done)
    store.close()

    fitter.fit_cube(store_name=store_name, seed=6, resume=True)
    with HdfStore(store_name) as store:
        fitted = {(g.attrs["i_lon"], g.attrs["i_lat"])
                  for g in store.iter_pix_groups()}
        expect = {(int(p // N_LAT), int(p % N_LAT))
                  for p in range(8) if p not in set(pre_done)}
        expect = {(l, b) for (l, b) in expect
                  if not np.isnan(stack.cubes[0].data[l, b]).any()}
        assert fitted == expect, (fitted, expect)
        done = set(store.completed_pixels().tolist())
        assert set(pre_done.tolist()) <= done
        assert {5, 6, 7} <= done


# the ladder smoke test's sizes, first passes only (the JAX package's
# boundary refit at 2 x nlive = 300 > max_iter runs out of memory here)
LADDER = dict(ncomp_max=2, ns_kwargs={"nlive": 16, "tol": 5.0, "max_iter": 300},
              n_post=16, segment_iters=64, mode_loss_retries=0,
              boundary_band=0)


def test_fit_cube_store_matches_jax_store(stack, tmp_path):
    """The same cube and settings through both packages' ``fit_cube``:
    the same files, groups, attribute names and dtypes, dataset shapes;
    ``nbest`` agrees where the gain is far from the gate (signal pixels
    >= 1, empty pixels 0)."""
    tname, jname = str(tmp_path / "t"), str(tmp_path / "j")
    _fitter(stack, **LADDER).fit_cube(store_name=tname, seed=5)
    jcube.CubeFitter(synth_stack(jcube), jax_priors(vsys=0.0), JaxRunner,
                     batch_size=8, nlive_buckets=1,
                     **LADDER).fit_cube(store_name=jname, seed=5)
    got, want = _store_groups(tname), _store_groups(jname)
    assert set(got) == set(want) == VALID
    for k in VALID:
        nb_t, nb_j = got[k][0], want[k][0]
        if k in SIGNAL:
            assert nb_t >= 1 and nb_j >= 1, (k, got[k], want[k])
            assert sorted(got[k][1]) == sorted(want[k][1]) == [1, 2]
        else:
            assert nb_t == nb_j == 0, (k, got[k], want[k])
    for name in ("table.hdf", "chunk0.hdf"):
        t = hdf_tree(f"{tname}.store/{name}", values=False)
        j = hdf_tree(f"{jname}.store/{name}", values=False)
        assert t == j, name


def test_seed_replays_the_run(stack):
    """One seed gives the same records twice; another seed does not."""
    def lnz(seed):
        fitter = _fitter(stack, ncomp_max=1,
                         ns_kwargs={"nlive": 16, "tol": 5.0, "max_iter": 300},
                         n_post=16, segment_iters=64, mode_loss_retries=0,
                         boundary_band=0, nlive_snr_fact=0)
        (batch,) = list(fitter._fit_batches(seed=seed))
        return [rec[0]["global_lnZ"] for _p, _n, rec in batch.records]

    assert lnz(2) == lnz(2)
    assert lnz(2) != lnz(3)


def test_device_rules(stack, tmp_path):
    """``CubeFitter``, ``fit_single`` and a default mesh are on the card
    and raise without one; ``host_shard`` with one process runs."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    utrans = get_irdc_priors(vsys=0.0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        CubeFitter(stack, utrans, AmmoniaRunner)
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh()
    fitter = _fitter(stack, ncomp_max=1,
                     ns_kwargs={"nlive": 16, "tol": 5.0, "max_iter": 300},
                     n_post=16, segment_iters=64, mode_loss_retries=0,
                     boundary_band=0)
    name = str(tmp_path / "one_host")
    assert fitter.fit_cube(store_name=name, seed=3, host_shard=True,
                           process_id=0, process_count=1) is not None
    with HdfStore(name) as store:
        assert store.completed_pixels().size == len(VALID)
        assert [p.name for p in store.all_chunk_paths()] == ["chunk_h0_0.hdf"]
    # fit_single: one spectrum, on the card unless asked for the CPU
    datas, noises, _, _ = stack.get_flat_batch()
    one = [torch.as_tensor(d[:1], dtype=torch.float32) for d in datas]
    runner = fitter._make_runner(one, [torch.full((1,), 0.1)] * 2, 1)
    cfg = NSConfig(nlive=16, tol=5.0, max_iter=300)
    with pytest.raises(RuntimeError, match="cuda"):
        fit_single(torch.Generator(), runner, cfg)
    fit = fit_single(torch.Generator(), runner, cfg, device="cpu")
    assert fit.lnz.shape == (1,) and torch.isfinite(fit.lnz).all()


def test_cube_layer_runs_without_h5py(tmp_path):
    """With ``h5py`` missing, ``nestfit_tpu_torch.cube`` imports and a
    ``CubeFitter`` fits; only the store raises ``ImportError``."""
    code = "\n".join([
        "import sys; sys.modules['h5py'] = None",
        "sys.path.insert(0, 'tests')",
        "import numpy as np, torch",
        "import nestfit_tpu_torch as ntt",
        "from nestfit_tpu_torch import cube",
        "from nestfit_tpu_torch.models import AmmoniaRunner",
        "from nestfit_tpu_torch.priors import get_irdc_priors",
        "from _cube_inputs import synth_stack",
        "torch.set_num_threads(2)",
        "f = cube.CubeFitter(synth_stack(cube), get_irdc_priors(vsys=0.0,"
        " device='cpu'), AmmoniaRunner, ncomp_max=1, batch_size=8,"
        " nlive_buckets=1, ns_kwargs={'nlive': 16, 'tol': 5.0, 'max_iter': 300},"
        " n_post=16,"
        " boundary_band=0, nlive_snr_fact=0, device='cpu')",
        "(b,) = list(f._fit_batches(seed=0))",
        "assert len(b.records) == 7, b.records",
        "assert ntt.CubeFitter is cube.CubeFitter",
        "for get in (lambda: cube.HdfStore, lambda: ntt.HdfStore,",
        "            lambda: f.fit_cube(store_name='x')):",
        "    try:",
        "        get()",
        "    except ImportError:",
        "        pass",
        "    else:",
        "        raise AssertionError('the store imported without h5py')",
        "print('ok')",
    ])
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "ok" in out.stdout, out.stdout + out.stderr
