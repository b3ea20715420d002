"""The port's bench (``bench_torch.py``) on the CPU: it imports neither
JAX nor ``nestfit_tpu``; its cube is the native-truth artifact's; its
gates give ``bench.py``'s numbers and decisions on the same inputs; the
second pass picks and merges rows as ``bench.py`` does; a toy ladder runs
in both sampler modes; and ``main`` without a card prints an error line
and exits 1.

``bench.py`` imports only ``json``, ``os``, ``sys``, ``time`` and NumPy at
the top, so its module-level ``native_truth_comparison`` is called as it
is, and its selection rule (``score_pass``, a closure of its ``main``) is
lifted out of its source and run on the same fake fits."""

import ast
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
ARTIFACT = ROOT / "validation" / "native_truth_seed5.json"


def _load(name, file):
    spec = importlib.util.spec_from_file_location(name, ROOT / file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bt = _load("bench_torch", "bench_torch.py")


@pytest.fixture(autouse=True)
def _threads():
    # the suite's workers share the host's cores
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bench():
    return _load("bench_jax_reference", "bench.py")


@pytest.fixture(scope="module")
def cube():
    return bt.make_cube(1024, 5)


# ---------------------------------------------------------------------------
# (a) no JAX


def test_bench_torch_imports_neither_jax_nor_the_jax_package():
    tree = ast.parse((ROOT / "bench_torch.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "nestfit_tpu_torch.sampling" in names
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib",
                                                   "nestfit_tpu")]
    assert not bad, bad
    # every module the bench's pieces import, loaded in a fresh process
    code = "\n".join([
        "import sys",
        "import bench_torch as bt",
        "from nestfit_tpu_torch.sampling import NSConfig",
        "cube = bt.make_cube(4, 5, noise=0.4)",
        "setup = bt.make_setup(cube, NSConfig(nlive=8), 250, 6.0, 'cpu')",
        "bt.kernel_counters()",
        "import nestfit_tpu_torch.native, nestfit_tpu_torch.sampling.aot",
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'nestfit_tpu' or m.startswith('nestfit_tpu.'))",
        "assert 'nestfit_tpu_torch.sampling.fit' in sys.modules",
        "assert not bad, bad"])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ---------------------------------------------------------------------------
# (b) the cube


def test_default_cube_is_the_artifacts(cube):
    art = json.loads(ARTIFACT.read_text())
    assert (art["n_pix"], art["bench_seed"], art["noise"]) == \
        (*bt.DEFAULT_CUBE, bt.NOISE)
    assert bt.cube_checksum(cube) == art["cube_checksum"]
    assert bt.cube_checksum(bt.make_cube(128, 5)) != art["cube_checksum"]


# ---------------------------------------------------------------------------
# (c) the gates against bench.py


def _fake_ladder(rng, n_pix, art=None, spread=0.5):
    """lnZ arrays near the artifact's engine medians (random elsewhere),
    a null model below them, and fake rung fits carrying the MAP
    parameters and posterior stds near the engine's."""
    lnz1 = rng.normal(-400.0, 20.0, n_pix)
    lnz2 = lnz1 + rng.normal(15.0, 12.0, n_pix)
    bf = [rng.normal(0.0, 1.0, (n_pix, 6 * n)) for n in (1, 2)]
    for key, rec in (art or {}).get("records", {}).items():
        i = int(key)
        seeds = list(rec["seeds"].values())
        for n, z in ((1, lnz1), (2, lnz2)):
            z[i] = np.median([s[f"lnz{n}"] for s in seeds]) \
                + rng.normal(0.0, spread)
            nat = next((s.get(f"bestfit{n}") for s in seeds
                        if s.get(f"bestfit{n}")), None)
            if nat is not None:
                bf[n - 1][i] = np.asarray(nat) + rng.normal(0.0, 0.05,
                                                            6 * n)
    null = lnz1 - rng.uniform(0.0, 120.0, n_pix)
    lnz1, lnz2, null = (x.astype(np.float32) for x in (lnz1, lnz2, null))
    fits = []
    for n in (1, 2):
        sd = rng.uniform(0.02, 1.0, (n_pix, 6 * n))
        sd[:, 5 * n:] = 0.0               # the constant ortho fraction
        fits.append(SimpleNamespace(products=SimpleNamespace(
            bestfit_params=bf[n - 1].astype(np.float32),
            std_params=sd.astype(np.float32))))
    return lnz1, lnz2, null, tuple(fits)


@pytest.mark.parametrize("spread", [0.3, 3.0])
def test_native_truth_comparison_is_bench_pys(bench, cube, spread):
    art = json.loads(ARTIFACT.read_text())
    rng = np.random.default_rng(11)
    lnz1, lnz2, null, fits = _fake_ladder(rng, 1024, art, spread)
    nbest = bt.nbest_of(lnz1, lnz2, null)
    (_, d11), (_, d22) = cube
    want = bench.native_truth_comparison(d11, d22, lnz1, lnz2, null, nbest,
                                         fits=fits)
    got = bt.native_truth_comparison(d11, d22, lnz1, lnz2, null, nbest,
                                     fits=fits)
    assert want and "map_dz_n" in want
    assert got == want
    # the fits' tensors on the device the port hands over
    tfits = tuple(SimpleNamespace(products=SimpleNamespace(
        bestfit_params=torch.as_tensor(f.products.bestfit_params),
        std_params=torch.as_tensor(f.products.std_params))) for f in fits)
    assert bt.native_truth_comparison(d11, d22, lnz1, lnz2, null, nbest,
                                      fits=tfits) == want
    # bench.py's gate on the dict (bench.py:492-503)
    ok = (want["native400_dz_sigma_median"] < 4.0
          and want["native400_nbest_agree_frac"] >= 0.7
          and want["native400_dz_frac_gt10"] <= 0.15
          and want["map_dz_median"] < 1.0)
    assert bt.native_gate(got, required=True) == ok
    assert ok == (spread < 1.0)


def test_native_truth_on_another_cube_is_skipped_or_fails(bench):
    rng = np.random.default_rng(3)
    (_, d11), (_, d22) = bt.make_cube(128, 5)
    lnz1, lnz2, null, fits = _fake_ladder(rng, 128)
    nbest = bt.nbest_of(lnz1, lnz2, null)
    assert bench.native_truth_comparison(d11, d22, lnz1, lnz2, null,
                                         nbest, fits=fits) == {}
    got = bt.native_truth_comparison(d11, d22, lnz1, lnz2, null, nbest,
                                     fits=fits)
    assert got == {"native400": "skipped: cube differs"}
    assert bt.native_gate(got, required=False)
    assert not bt.native_gate(got, required=True)
    assert bt.native_truth_comparison(
        d11, d22, lnz1, lnz2, null, nbest,
        path=ROOT / "no_such_artifact.json")["native400"].startswith(
            "skipped: no artifact")


@pytest.mark.parametrize("key, value, ok", [
    ("native400_dz_sigma_median", 3.99, True),
    ("native400_dz_sigma_median", 4.0, False),
    ("native400_nbest_agree_frac", 0.7, True),
    ("native400_nbest_agree_frac", 0.69, False),
    ("native400_dz_frac_gt10", 0.15, True),
    ("native400_dz_frac_gt10", 0.16, False),
    ("map_dz_median", 0.99, True),
    ("map_dz_median", 1.0, False),
    ("native400_n_records", 15, True),     # too few records to gate
])
def test_native_gate_thresholds(key, value, ok):
    nt = {"native400_n_records": 96, "native400_dz_sigma_median": 1.0,
          "native400_nbest_agree_frac": 1.0, "native400_dz_frac_gt10": 0.0,
          "map_dz_n": 400, "map_dz_median": 0.4}
    nt[key] = value
    if key == "native400_n_records":
        nt["native400_dz_sigma_median"] = 99.0
    assert bt.native_gate(nt, required=True) == ok


def _bench_score_pass(bench, n_pix, mode_loss_remaining):
    """``bench.py``'s ``score_pass`` (a closure of its ``main``), lifted
    from its source with the names it closes over."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    fn = next(n for n in main.body
              if isinstance(n, ast.FunctionDef) and n.name == "score_pass")
    ns = {"np": np, "n_pix": n_pix, "RESULT": {}, "log": lambda *a: None,
          "mode_loss_remaining": mode_loss_remaining,
          "CPU_FITS_PER_SEC_FALLBACK": bench.CPU_FITS_PER_SEC_FALLBACK}
    exec(compile(ast.Module([fn], []), "bench.py", "exec"), ns)
    return ns["score_pass"], ns["RESULT"]


def _fake_rung(lnz, null, conv, ncall, n_dead, max_iter, n):
    D = 6 * n
    return SimpleNamespace(
        lnz=lnz, null_lnz=null,
        ns=SimpleNamespace(converged=conv, ncall=ncall, n_dead=n_dead,
                           max_iter=max_iter, lnz_err=np.full_like(lnz, .2)),
        products=SimpleNamespace(bestfit_params=np.zeros((lnz.size, D)),
                                 std_params=np.ones((lnz.size, D))))


SELECTION_CASES = ["pass", "few_ge1", "few_eq2", "unconverged", "tail",
                   "stalled"]


@pytest.mark.parametrize("case", SELECTION_CASES)
def test_selection_gate_is_bench_pys(bench, case):
    rng = np.random.default_rng(SELECTION_CASES.index(case))
    n_pix = 400
    null = rng.normal(-500.0, 5.0, n_pix).astype(np.float32)
    gain1 = rng.uniform(12.0, 200.0, n_pix)
    gain2 = np.where(rng.uniform(size=n_pix) < 0.5, 30.0, 2.0)
    conv = [np.ones(n_pix, bool), np.ones(n_pix, bool)]
    max_iter = 1000
    n_dead = [np.full(n_pix, 400), np.full(n_pix, 600)]
    if case == "few_ge1":
        gain1[:45] = 5.0                      # 88.75% with nbest >= 1
    elif case == "few_eq2":
        gain2[:] = 2.0
        gain2[:110] = 30.0                    # 27.5% with nbest = 2
    elif case == "unconverged":
        conv[1][:9] = False                   # 97.75% converged
        n_dead[1][:9] = max_iter
    elif case == "tail":
        gain1[:36] = rng.uniform(-5.0, 10.9, 36)   # > 32 nbest-0 margins
    elif case == "stalled":
        conv[0][:2] = False                   # 99.5% converged, but two
        n_dead[0][:2] = max_iter // 2         # runs stopped short
    lnz1 = (null + gain1).astype(np.float32)
    lnz2 = (lnz1 + gain2).astype(np.float32)
    ncall = [rng.integers(1000, 50000, n_pix).astype(np.int32)
             for _ in range(2)]
    fits = {n: _fake_rung(z, null, conv[n - 1], ncall[n - 1], n_dead[n - 1],
                          max_iter, n)
            for n, z in ((1, lnz1), (2, lnz2))}
    mlr = {1: 0, 2: 3}
    score_pass, result = _bench_score_pass(bench, n_pix, mlr)
    extra, elapsed = 123457, 7.5
    (_, _, _, nbest_b, _, _, fps_b, ok_b, gates_b) = score_pass(
        fits, elapsed, True, extra)

    lad = {"fits": fits, "extra": extra, "mode_loss_remaining": mlr}
    got = bt.score_ladder(SimpleNamespace(n_pix=n_pix), lad, elapsed)
    gates = dict(got["gates"])
    short = gates.pop("unconverged_short_of_budget")
    assert gates == gates_b
    assert np.array_equal(got["arrays"]["nbest"], nbest_b)
    assert got["fits_per_sec"] == fps_b
    assert int(got["evals_per_pixel"]) == result["evals_per_pixel"]
    assert short == (2 if case == "stalled" else 0)
    # the port's gate is bench.py's, and also fails a stalled run
    assert got["ok_selection"] == (ok_b and not short)
    assert ok_b == (case in ("pass", "tail", "stalled"))


# ---------------------------------------------------------------------------
# (d) the second pass's bookkeeping


def test_refit_rows_floor_first_then_band_nearest_the_rule():
    floor = np.zeros(12, dtype=np.float32)
    #                  0     1    2     3     4    5     6    7    8
    lnz = np.array([-20.0, 50.0, 11.5, -9.0, 16.0, 8.0, -3.0, 10.9, 30.0,
                    17.5, 4.0, -8.5], dtype=np.float32)
    rows, bad, n_floor = bt.refit_rows(lnz, floor, 0, 6.0, 128)
    assert bad.tolist() == [0, 3, 11] and n_floor == 3
    # band |gain - 11| <= 6 above the floor, nearest the rule first:
    # 7 (0.1), 2 (0.5), 8? no (19); 5 (3.0), 4 (5.0), 9 (6.5 out), 10 (7)
    assert rows.tolist() == [0, 3, 11, 7, 2, 5, 4]
    # the batch width caps the rows, floor rows kept first
    assert bt.refit_rows(lnz, floor, 0, 6.0, 4)[0].tolist() == [0, 3, 11, 7]
    # no band: floor rows only; round 1: the floor rows left
    assert bt.refit_rows(lnz, floor, 0, 0.0, 128)[0].tolist() == [0, 3, 11]
    rows1, bad1, n1 = bt.refit_rows(lnz, floor, 1, 6.0, 2)
    assert rows1.tolist() == [0, 3] and bad1.tolist() == [0, 3, 11] \
        and n1 == 2
    # rung 2's floor is rung 1's lnZ, pixel by pixel
    prev = np.array([0.0, 100.0], dtype=np.float32)
    assert bt.refit_rows(np.array([5.0, 80.0], np.float32), prev, 0, 6.0,
                         128)[1].tolist() == [1]


@pytest.mark.parametrize("n_rows, width", [(1, 32), (32, 32), (33, 128),
                                           (128, 128)])
def test_refit_width(n_rows, width):
    assert bt.refit_width(n_rows, 128, 32) == width


def test_refit_widths_of_a_small_cube():
    s = bt.make_setup(bt.make_cube(4, 5, noise=0.4),
                      SimpleNamespace(nlive=8), 250, 6.0, "cpu")
    assert (s.r_band, s.r_small) == (4, 4)
    assert set(s.band_runners) == {(1, 4), (2, 4)}
    assert bt.refit_width(3, s.r_band, s.r_small) == 4


def test_merge_choice_floor_keeps_better_band_supersedes():
    lnz = np.array([-30.0, 0.0, 12.0, -25.0, 9.0], dtype=np.float32)
    bad = np.array([0, 3])
    rows = np.array([0, 3, 2, 4])
    #                 floor 0 better, floor 3 worse, band 2 worse, band 4
    lnz_r = np.array([-1.0, -40.0, 5.0, 10.0], dtype=np.float32)
    nc_old = np.array([100, 200, 300, 400, 500])
    nc_new = np.array([1000, 2000, 3000, 4000])
    dst, src, extra = bt.merge_choice(rows, bad, lnz, lnz_r, nc_old, nc_new)
    assert dst.tolist() == [0, 2, 4] and src.tolist() == [0, 2, 3]
    # replaced rows' old calls + the discarded refit of row 3
    assert extra == 100 + 300 + 500 + 2000


def test_merge_choice_one_winner_per_destination():
    lnz = np.array([-30.0, 5.0], dtype=np.float32)
    rows = np.array([0, 1, 0])
    lnz_r = np.array([-20.0, 4.0, -10.0], dtype=np.float32)
    dst, src, extra = bt.merge_choice(rows, np.array([0]), lnz, lnz_r,
                                      np.array([7, 8]),
                                      np.array([10, 20, 30]))
    assert dst.tolist() == [0, 1] and src.tolist() == [2, 1]
    assert extra == 7 + 8 + 10
    # a floor row no refit beats keeps its record and costs its refits
    dst, src, extra = bt.merge_choice(rows, np.array([0]),
                                      np.array([0.0, 5.0], np.float32),
                                      lnz_r, np.array([7, 8]),
                                      np.array([10, 20, 30]))
    assert dst.tolist() == [1] and src.tolist() == [1]
    assert extra == 8 + 10 + 30


# ---------------------------------------------------------------------------
# (e) a toy ladder in both modes


@pytest.mark.parametrize("segment_iters, n_pix", [(250, 16), (0, 4)],
                         ids=["segmented", "traced"])
def test_toy_ladder(segment_iters, n_pix):
    from nestfit_tpu_torch.sampling import NSConfig

    cube = bt.make_cube(n_pix, 5, noise=0.4)
    cfg = NSConfig(nlive=16, tol=5.0, max_iter=60)
    setup = bt.make_setup(cube, cfg, segment_iters, 1e9, "cpu", r_band=8,
                          r_small=4, noise=0.4)
    pre = bt.precompile(setup, verbose=None)
    assert set(pre) == {"wall_s", "n_programs", "n_errors", "n_deduped",
                        "n_abandoned", "cache_hits", "cache_misses"}
    assert pre["n_errors"] == 0
    lad = bt.run_ladder(setup, torch.Generator().manual_seed(0), tag="toy")
    assert set(lad) == {"fits", "walls", "extra", "second_pass",
                        "mode_loss_remaining", "traced"}
    assert set(lad["fits"]) == set(lad["walls"]) == {1, 2}
    assert set(lad["mode_loss_remaining"]) == {1, 2}
    # a 1e9-nat band sends every pixel to the second pass on both rungs
    first = [r for r in lad["second_pass"] if r["round"] == 1]
    assert [r["ncomp"] for r in first] == [1, 2]
    for r in lad["second_pass"]:
        assert set(r) == {"ncomp", "round", "rows", "floor_rows", "width",
                          "replaced", "wall_s"}
        assert r["width"] == bt.refit_width(r["rows"], setup.r_band,
                                            setup.r_small)
    assert first[0]["rows"] == setup.r_band
    assert lad["extra"] > 0
    for n, fit in lad["fits"].items():
        assert fit.lnz.shape == (n_pix,) and fit.ns.nlive == 16
        assert torch.isfinite(fit.lnz).all()
    st = lad["traced"]
    assert (st.blocks > 0) == (segment_iters == 0)
    sc = bt.score_ladder(setup, lad, 1.0)
    assert set(sc) == {"fits_per_sec", "evals_per_pixel", "gates",
                       "ok_selection", "arrays"}
    assert {"converged_frac", "nbest_ge1_frac", "nbest_eq2_frac",
            "mode_loss_remaining", "unconverged_short_of_budget"} \
        <= set(sc["gates"])
    calls = sum(fit.ns.ncall.double().mean().item()
                for fit in lad["fits"].values())
    assert sc["evals_per_pixel"] == pytest.approx(
        calls + lad["extra"] / n_pix)
    json.dumps(sc["gates"])


# ---------------------------------------------------------------------------
# the engine baseline and its gate


def test_engine_baseline_agrees_with_the_engine():
    from nestfit_tpu_torch import native
    from nestfit_tpu_torch.priors import get_irdc_priors

    cube = bt.make_cube(2, 5, noise=0.4)
    utrans = get_irdc_priors(vsys=0.0, device="cpu")
    (xa11, d11), (xa22, d22) = cube
    spec = [(xa11, d11[0], 0.4, 1), (xa22, d22[0], 0.4, 2)]
    plc = native.placement_spec_from_utrans(utrans)
    runs = {n: native.ns_spectral_ammonia(
        spec, native.ppf_tables_from_utrans(utrans, n), ncomp=n, nlive=16,
        tol=1.0, seed=0, placement=plc) for n in (1, 2)}
    rung = {n: (np.array([runs[n]["lnz"], 0.0], np.float32),
                np.array([runs[n]["lnz_err"], 0.0], np.float32))
            for n in (1, 2)}
    rate, agree = bt.engine_baseline(cube, utrans, 16, rung[1], rung[2], 1,
                                     60.0, bt.Clock(1000.0), noise=0.4)
    assert rate > 0 and [a["pixel"] for a in agree] == [0, 0]
    assert max(abs(a["dz_sigma"]) for a in agree) < 1e-4
    gates, ok = bt.engine_gate(agree)
    assert ok and gates["lnz_dz_n"] == 2
    with pytest.raises(RuntimeError, match="budget"):
        bt.engine_baseline(cube, utrans, 16, rung[1], rung[2], 1, 60.0,
                           bt.Clock(10.0), noise=0.4)


@pytest.mark.parametrize("dz, ok", [
    ([1.0, -2.0, 0.5, 3.0, 1.0, 2.0], True),
    ([1.0, 12.0, 0.5, -11.0, 1.0, 2.0], True),      # 2 of 6 beyond 10
    ([1.0, 12.0, 0.5, -11.0, 13.0, 2.0], False),    # 3 of 6
    ([1.0, 1.0, 49.0], True),                       # one always allowed
    ([1.0, 1.0, 50.0], False),                      # max < 50
    ([6.0, 6.5, 1.0], False),                       # median < 6
])
def test_engine_gate_thresholds(dz, ok):
    gates, got = bt.engine_gate([{"pixel": i, "dz_sigma": z}
                                 for i, z in enumerate(dz)])
    assert got == ok
    assert gates["lnz_dz_frac_gt10"] == np.mean(np.abs(dz) > 10.0)


# ---------------------------------------------------------------------------
# settings and (f) main without a card


def test_settings_from_the_environment():
    s = bt.Settings.from_env([], {})
    assert (s.n_pix, s.nlive, s.seed, s.init_factor, s.segment_iters,
            s.band_nats, s.cpu_pixels, s.cpu_budget_s, s.deadline_lead_s,
            s.budget_s, s.timed_seeds) == (1024, 100, 5, 4, 250, 6.0, 3,
                                           150.0, 45.0, 1100.0, (5, 6, 7))
    assert s.mode == "segmented"
    fast = bt.Settings.from_env(["--fast"], {"BENCH_SEGMENT_ITERS": "0",
                                             "BENCH_TIMED_SEEDS": "9"})
    assert (fast.n_pix, fast.budget_s, fast.mode, fast.timed_seeds) == \
        (128, 900.0, "traced", (9,))
    assert bt.Settings.from_env(["--fast"], {"BENCH_PIXELS": "64"}).n_pix \
        == 64


def test_main_without_a_card_prints_an_error_and_exits_1(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", BENCH_BUDGET_S="120")
    out = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 1, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["value"] == 0.0 and "cuda" in line["error"]
    assert line["metric"] == "spectra_fit_per_sec_per_chip"
    assert (line["mode"], line["segment_iters"]) == ("segmented", 250)
