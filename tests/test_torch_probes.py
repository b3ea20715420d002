"""The sampler's progress lines and the rest of the port's ``validation/``
counterpart on the CPU.

(b) ``NESTFIT_NS_DEBUG``: the segmented host loop's progress lines, the JAX
    package's four kinds (its six ``if _NS_DEBUG`` blocks print four): the
    candidate segment, the regime check, the switch-back probe and the
    slice segment, each with fields that parse.  The lines change no
    result, bit for bit; with the flag off nothing is printed; the traced
    mode prints nothing; a process started with the variable set has the
    flag on.
(c) ``mode_loss_probe``: the JAX script's variants and margin; a toy run in
    both sampler modes gives its keys and finite counts, and a second call
    on the same ``--out`` fits nothing.
(d) ``iter_cost_sweep``: the combo parsing and tags of the JAX script
    (its lines 70-75 and its tag, reproduced here); a toy ladder gives its
    record keys.
(e) ``regime_probes``: a toy ``revival`` whose forced run never leaves the
    candidate regime while the default run switches; a toy ``hetero`` on
    the fixture cutouts gives the JAX script's summary fields.
(f) ``compute_native_truth`` equals the JAX script bit for bit at nlive 25
    on pixels 12 and 20 (the artifact's cheapest; JAX at x64, where both
    bindings' PPF tables are equal), both run through their backfill path
    on a stub of those two records; ``compare`` on a made-up pair.

The import check of the four new modules is (a) of
``test_torch_validation.py``.  Toy runs cap ``max_iter`` so that the file
stays well under two minutes.
"""

import contextlib
import importlib.util
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nestfit_tpu_torch.sampling import NSConfig
from nestfit_tpu_torch.sampling import sampler as ts
from validation_torch import compute_native_truth as cnt
from validation_torch import iter_cost_sweep as ics
from validation_torch import mode_loss_probe as mlp
from validation_torch import regime_probes as rp

ROOT = Path(__file__).resolve().parent.parent
VAL = ROOT / "validation"
TOY = {"nlive": 20, "max_iter": 60}

LINES = rp.LINES


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_validation_{name}", VAL / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# (b) the progress lines


def _gauss(u, data):
    return -0.5 * torch.sum((u - 0.5) ** 2, dim=-1) / data[0] ** 2


def _toy_run(segment_iters=4):
    """A segmented run that passes every kind of line: the slice regime
    forced early (``cand_min_acc``), probes every 4 slice iterations."""
    cfg = NSConfig(nlive=40, tol=0.2, cand_min_acc=0.5, switch_back_every=4)
    sigma = torch.full((6,), 0.05, dtype=torch.float64)
    return ts.run_nested(torch.Generator().manual_seed(4), _gauss, 3, 6, cfg,
                         dtype=torch.float64, data=(sigma,),
                         segment_iters=segment_iters)


def _captured(run, flag, monkeypatch):
    monkeypatch.setattr(ts, "_NS_DEBUG", flag)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = run()
    return res, buf.getvalue().splitlines()


def test_progress_lines_change_no_result(monkeypatch):
    off, quiet = _captured(_toy_run, False, monkeypatch)
    on, lines = _captured(_toy_run, True, monkeypatch)
    assert quiet == []
    for f in ("lnz", "lnz_err", "h", "n_dead", "ncall", "converged",
              "dead_u", "dead_lnl", "live_u", "live_lnl", "max_loglike"):
        assert torch.equal(getattr(off, f), getattr(on, f)), f
    kinds = rp.parse_lines(lines)
    assert all(kinds.values()), {k: len(v) for k, v in kinds.items()}
    for i0, i1, r, wall, ncall in kinds["cand_seg"]:
        assert int(i0) < int(i1) and int(r) == 6 and float(wall) >= 0
    for i, acc, in_cube, done in kinds["regime"]:
        assert 0 <= float(acc) <= 1 and 0 <= float(in_cube) <= 1
    for i, r, est, thresh, ready in kinds["probe"]:
        assert float(thresh) == pytest.approx(0.5) and ready == "True"
        assert np.isfinite(float(est))
    last = kinds["slice_seg"][-1]
    assert int(last[4]) == 6            # every run done at the end
    assert int(last[5]) == pytest.approx(on.ncall.double().mean().item(),
                                         abs=0.5)


def test_traced_mode_prints_nothing(monkeypatch):
    _, lines = _captured(lambda: _toy_run(0), True, monkeypatch)
    assert lines == []


def test_flag_is_read_from_the_environment():
    code = "\n".join([
        "import torch",
        "from nestfit_tpu_torch.sampling import sampler as ts",
        "assert ts._NS_DEBUG",
        "cfg = ts.NSConfig(nlive=40, tol=0.2, cand_min_acc=0.5)",
        "ts.run_nested(torch.Generator().manual_seed(1),",
        "              lambda u: -torch.sum((u - 0.5) ** 2, -1) / 0.01,",
        "              2, 2, cfg, segment_iters=8)"])
    env = {"NESTFIT_NS_DEBUG": "1", "PATH": "/usr/bin:/bin",
           "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = out.stdout.splitlines()
    assert got and all(ln.startswith("ns-debug: ") for ln in got)
    assert any(LINES["slice_seg"].match(ln) for ln in got)


# ---------------------------------------------------------------------------
# (c) mode_loss_probe


def test_mode_loss_probe_variants_are_the_jax_scripts():
    jax_mod = _jax_script("mode_loss_probe")
    assert mlp.VARIANTS == jax_mod.VARIANTS
    assert mlp.MARGIN == jax_mod.MARGIN


@pytest.mark.parametrize("mode", ["segmented", "traced"])
def test_mode_loss_probe_toy_run(tmp_path, mode, capsys):
    out = tmp_path / "probe.jsonl"
    kw = dict(n_seeds=1, n_px=16, variants="lhs,iid", mode=mode,
              device="cpu", out=str(out), overrides=TOY)
    res = mlp.probe(**kw)
    assert res["mode"] == mode and res["card"] is None
    for tag in ("lhs", "iid"):
        assert sorted(res[tag]) == ["evals_px", "viol1", "viol2", "wall_s"]
        assert all(len(v) == 1 for v in res[tag].values())
        assert 0 <= res[tag]["viol1"][0] <= 16
        assert 0 <= res[tag]["viol2"][0] <= 16
        assert np.isfinite(res[tag]["evals_px"][0])
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [(r["variant"], r["seed"]) for r in recs] == [("lhs", 0),
                                                         ("iid", 0)]
    assert all(len(r["viol2_px"]) == r["viol2"] for r in recs)
    printed = capsys.readouterr().out
    assert re.search(r"^lhs seed 0: viol1=\d+ viol2=\d+ evals/px=\d+ "
                     r"wall=\d+s$", printed, re.M)
    # the same --out again: every pair is done, nothing is fitted
    again = mlp.probe(**{**kw, "overrides": {"nlive": 10 ** 6}})
    assert again == json.loads(json.dumps(res))
    assert len(out.read_text().splitlines()) == 2


# ---------------------------------------------------------------------------
# (d) iter_cost_sweep


def _jax_combos(argv):
    """``validation/iter_cost_sweep.py``'s parsing, its lines 70-75."""
    combos = []
    for arg in (argv or ["0,1", "50,1", "0,2", "50,2"]):
        f = [int(x) for x in arg.split(",")]
        f += [1, 6, 0, 2][len(f) - 2:]
        combos.append(tuple(f[:6]))
    return combos


def _jax_tag(kk, sbe, inif, mc, rep, sw):
    return (f"kk{kk or 'auto'}-sbe{sbe}-if{inif}-mc{mc}"
            f"-rep{rep or 'auto'}-sw{sw}")


@pytest.mark.parametrize("argv", [[], ["32,1,4", "32,1,4,4"],
                                  ["0,1", "50,2", "32,1,4,4,3,1"]])
def test_sweep_combos_and_tags_are_the_jax_scripts(argv):
    got = ics.parse_combos(argv)
    assert got == _jax_combos(argv)
    assert [ics.combo_tag(c) for c in got] == [_jax_tag(*c) for c in got]


def test_sweep_toy_ladder(tmp_path):
    out = tmp_path / "sweep.jsonl"
    recs = list(ics.sweep(ics.parse_combos(["50,2"]), "segmented", "cpu",
                          str(out), n_pix=16, timed=False, overrides=TOY))
    rec, = recs
    assert rec["combo"] == "kk50-sbe2-if1-mc6-repauto-sw2"
    assert list(rec)[:7] == ["combo", "kill_k", "slice_bound_every",
                             "init_factor", "max_contract",
                             "fallback_repeats", "warmup_s"]
    warm = rec["warm"]
    assert sorted(map(str, warm)) == sorted(
        ["1", "2", "d10_mean", "d21_mean", "nbest_hist", "ladder_wall_s"])
    for n in (1, 2):
        assert sorted(warm[n]) == sorted(["wall_s", "evals_px", "deaths_px",
                                          "lnz_mean", "floor_viol", "conv"])
        assert np.isfinite(warm[n]["lnz_mean"])
    assert sum(warm["nbest_hist"]) == 16
    assert json.loads(out.read_text())["combo"] == rec["combo"]
    # resumed: the record comes back from --out
    again, = ics.sweep(ics.parse_combos(["50,2"]), "segmented", "cpu",
                       str(out), n_pix=16, timed=False,
                       overrides={"nlive": 10 ** 6})
    assert again == json.loads(json.dumps(rec))


# ---------------------------------------------------------------------------
# (e) regime_probes


def test_revival_toy_run(capsys):
    rec = rp.revival("cpu", 16, {"nlive": 20, "max_iter": 100})
    forced, default = rec["runs"]["forced_cand"], rec["runs"]["default"]
    assert forced["lines"]["slice_seg"] == 0 and forced["lines"]["probe"] == 0
    assert forced["lines"]["regime"] == len(forced["trajectory"]) > 0
    assert default["lines"]["slice_seg"] > 0
    assert len(default["trajectory"]) < len(forced["trajectory"])
    # the same generator: the two runs agree until the default one switches
    n = len(default["trajectory"])
    assert default["trajectory"] == forced["trajectory"][:n]
    assert default["trajectory"][-1][1] < 0.6 / (4 * 2.6 + 0.6)
    printed = capsys.readouterr().out
    assert len(re.findall(r"^RESULT mode=\w+ wall=\S+s ncall_mean=\d+ "
                          r"lnz_mean=\S+$", printed, re.M)) == 2


def test_hetero_toy_run(capsys):
    rec = rp.hetero("cpu", 16, TOY)
    assert rec["valid"] == 396 and rec["active"] == 16
    assert 0.0 <= rec["frac_prefer_cand"] <= 1.0
    assert rec["max_split_win_evals"] >= 0
    assert np.isfinite(rec["lnz_diff_median"])
    for run in rec["runs"].values():
        assert len(run["ncall"]) == 16
    printed = capsys.readouterr().out
    for rx in (r"^valid=396 R=16 snr \d+\.\d\.\.\d+\.\d$",
               r"^frac preferring cand \(>10% fewer evals\): \d\.\d{3}$",
               r"^max split win: \d+ evals \(\d+\.\d% of default\)$",
               r"^lnz agreement: median [+-]\d+\.\d\d max\|\.\| \d+\.\d\d$"):
        assert re.search(rx, printed, re.M), rx


# ---------------------------------------------------------------------------
# (f) compute_native_truth


PIXELS = (12, 20)


def _stub(path):
    """An artifact holding pixels 12 and 20 at seed 0 without best-fit
    vectors, for both scripts' backfill path at nlive 25."""
    art = {"bench_seed": 5, "noise": 0.15, "n_pix": 1024, "nlive": 25,
           "tol": 1.0, "placement": True, "cube_checksum": cnt.CHECKSUM,
           "records": {str(i): {"seeds": {"0": {"lnz2": 0.0}}}
                       for i in PIXELS}}
    path.write_text(json.dumps(art))


def test_native_truth_equals_the_jax_script(tmp_path, monkeypatch):
    jax_mod = _jax_script("compute_native_truth")
    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port.json"
    _stub(jax_out)
    _stub(port_out)
    monkeypatch.setattr(jax_mod, "NLIVE", 25)
    monkeypatch.setattr(jax_mod, "OUT", str(jax_out))
    argv = ["--pixels", "0", "--extra-seed-pixels", "0",
            "--backfill-bestfit"]
    monkeypatch.setattr(sys, "argv", ["compute_native_truth.py"] + argv)
    jax_mod.main()
    monkeypatch.setattr(cnt, "NLIVE", 25)
    assert cnt.main(argv + ["--out", str(port_out), "--device", "cpu"]) == 0
    want = json.loads(jax_out.read_text())
    got = json.loads(port_out.read_text())
    assert sorted(got["records"]) == sorted(map(str, PIXELS))
    assert got["records"] == want["records"]
    for k in want:
        assert got[k] == want[k], k
    assert sorted(got["walls"]) == [f"{i}/0" for i in PIXELS]
    assert got["card"] is None
    rec = got["records"]["12"]["seeds"]["0"]
    assert sorted(rec) == sorted(f.format(n) for f in (
        "lnz{}", "lnz{}_err", "ncall{}", "bestfit{}") for n in (1, 2))
    assert len(rec["bestfit2"]) == 12


def test_native_truth_refuses_another_cube(tmp_path, monkeypatch):
    monkeypatch.setattr(cnt, "CHECKSUM", "0" * 16)
    with pytest.raises(ValueError, match="checksum"):
        cnt.Truth(str(tmp_path / "x.json"), "cpu")
    assert not (tmp_path / "x.json").exists()


def test_native_truth_compare():
    def rec(lnz1, lnz2, e=0.2):
        return {"lnz1": lnz1, "lnz2": lnz2, "lnz1_err": e, "lnz2_err": e,
                "ncall1": 10, "ncall2": 20}

    art = {"cube_checksum": "c", "records": {
        "0": {"seeds": {"0": rec(-10.0, -5.0), "1": rec(-10.4, -5.0),
                        "2": rec(-9.6, -5.0)}},
        "1": {"seeds": {"0": rec(-20.0, -15.0)}}}}
    port = {"cube_checksum": "c", "records": {
        "0": {"seeds": {"0": rec(-9.0, -5.0)}},
        "1": {"seeds": {"0": rec(-20.0, -25.0), "1": rec(0.0, 0.0)}},
        "7": {"seeds": {"0": rec(0.0, 0.0)}}}}
    rows, summary = cnt.compare(port, art)
    assert [(r["pixel"], r["seed"], r["rung"]) for r in rows] == [
        (0, 0, 1), (0, 0, 2), (1, 0, 1), (1, 0, 2)]
    # pooled scatter: rung 1 the std of (-10, -10.4, -9.6) = 0.4, rung 2
    # 0 floored at 0.3
    assert summary["scatter"] == {"1": pytest.approx(0.4), "2": 0.3}
    s1 = np.sqrt(0.2**2 + 0.2**2 + 0.4**2)
    s2 = np.sqrt(0.2**2 + 0.2**2 + 0.3**2)
    assert rows[0]["dz"] == pytest.approx(1.0)
    assert rows[0]["dz_sigma"] == pytest.approx(1.0 / s1)
    assert rows[3]["dz_sigma"] == pytest.approx(-10.0 / s2)
    assert summary["n"] == 4 and summary["abs_dz_max"] == pytest.approx(10.0)
    assert summary["abs_dz_sigma_median"] == pytest.approx(
        np.median([1 / s1, 0.0, 0.0, 10 / s2]))
    with pytest.raises(ValueError):
        cnt.compare({**port, "cube_checksum": "d"}, art)
