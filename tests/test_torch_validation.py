"""The port's evidence-validation suite (``validation_torch/``) on the CPU.

(a) It imports neither JAX, ``nestfit_tpu`` nor ``validation/`` (the four
    probe modules included: ``mode_loss_probe``, ``iter_cost_sweep``,
    ``regime_probes``, ``compute_native_truth``).
(b) On the committed TPU record (``validation/tpu_agreement_seed5.json``)
    its postmortem and selection cross-tab give the JAX scripts' rows,
    classes, cross-tab and markdown.  The JAX scripts import only NumPy:
    each is loaded by ``importlib`` with its module-level ``HERE`` pointed
    at a temporary copy of the artifacts, run unchanged, and its ``main``'s
    locals are read as it returns.
(c) One made-up record per postmortem class: both give the same class
    and exit code.
(d) ``agreement.py``'s run on three artifact pixels padded to 4 rows at a
    toy nlive in both sampler modes: the record's schema, truth, checksum
    and null lnZ are the TPU record's, padding rows are left out, and a
    second call on the same file fits nothing.
(e) ``mode_loss_pixels.py`` reads the native lnZ2 from the artifact.
"""

import ast
import contextlib
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
VAL = ROOT / "validation"
PORT = ROOT / "validation_torch"
NATIVE = VAL / "native_truth_seed5.json"
TPU = VAL / "tpu_agreement_seed5.json"

sys.path.insert(0, str(ROOT))

from validation_torch import agreement as agr_mod  # noqa: E402
from validation_torch import mode_loss_pixels as mlp  # noqa: E402
from validation_torch import outlier_postmortem as pm  # noqa: E402
from validation_torch import selection_sharpness as ss  # noqa: E402


@pytest.fixture(autouse=True)
def _threads():
    # the suite's workers share the host's cores
    torch.set_num_threads(2)


def _jax_script(name, here):
    """``validation/<name>.py`` loaded afresh with ``HERE = here``."""
    spec = importlib.util.spec_from_file_location(
        f"jax_validation_{name}", VAL / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.HERE = str(here)
    return mod


def _run_main(mod):
    """``mod.main()`` unchanged: ``(return value, its locals at return)``."""
    seen = {}

    def hook(frame, event, _arg):
        if event == "return" and frame.f_code is mod.main.__code__:
            seen.update(frame.f_locals)

    old = sys.getprofile()
    sys.setprofile(hook)
    try:
        rc = mod.main()
    finally:
        sys.setprofile(old)
    return rc, seen


def _artifacts(tmp_path, native=NATIVE, agreement=TPU):
    """Copies under the JAX scripts' file names in ``tmp_path``."""
    shutil.copy(native, tmp_path / "native_truth_seed5.json")
    shutil.copy(agreement, tmp_path / "tpu_agreement_seed5.json")
    return tmp_path


# ---------------------------------------------------------------------------
# (a) no JAX


def test_validation_torch_imports_neither_jax_nor_the_jax_package():
    files = sorted(PORT.glob("*.py"))
    assert {f.name for f in files} >= {
        "agreement.py", "outlier_postmortem.py", "selection_sharpness.py",
        "mode_loss_pixels.py", "mode_loss_probe.py", "iter_cost_sweep.py",
        "regime_probes.py", "compute_native_truth.py"}
    for f in files:
        names = []
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names.append(node.module or "")
        bad = [n for n in names if n.split(".")[0] in (
            "jax", "jaxlib", "nestfit_tpu", "validation")]
        assert not bad, (f.name, bad)
    code = "\n".join([
        "import sys, json",
        "from validation_torch import agreement, mode_loss_pixels",
        "from validation_torch import outlier_postmortem, "
        "selection_sharpness",
        "from validation_torch import mode_loss_probe, iter_cost_sweep, "
        "regime_probes, compute_native_truth",
        "import nestfit_tpu_torch.sampling",
        f"art = json.load(open({str(NATIVE)!r}))",
        "agreement.make_runners(art, [0, 1], 4, 'cpu')",
        "mode_loss_pixels.native_lnz2([17])",
        "mode_loss_probe.make_runners(4, 'cpu')",
        "iter_cost_sweep.combo_config(iter_cost_sweep.parse_combos([])[0])",
        "regime_probes.fixture_batch(4)",
        "compute_native_truth.Truth('unused.json', 'cpu')",
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'nestfit_tpu' or m.startswith('nestfit_tpu.')"
        " or m == 'validation' or m.startswith('validation.'))",
        "assert 'nestfit_tpu_torch.sampling.fit' in sys.modules",
        "assert 'bench_torch' in sys.modules",
        "assert not bad, bad"])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ---------------------------------------------------------------------------
# (b) the TPU record through both packages' scripts


def test_postmortem_matches_the_jax_script_on_the_tpu_record(tmp_path):
    jax_pm = _jax_script("outlier_postmortem", _artifacts(tmp_path))
    rc, want = _run_main(jax_pm)
    nat, agr = pm.load(NATIVE, TPU)
    assert pm.engine_of(agr) == ("tpu", None)
    rows, outliers, s_model = pm.classify(nat, agr, "tpu")
    assert s_model == want["s_model"]
    assert len(rows) == len(want["rows"]) == 96
    for got, ref in zip(rows, want["rows"]):
        assert (got["pixel"], got["rung"]) == (ref["pixel"], ref["rung"])
        assert got["dz_sigma"] == pytest.approx(ref["dz_sigma"], abs=1e-12)
        assert got == ref
    assert [(r["pixel"], r["rung"], r["class"]) for r in outliers] == \
        [(r["pixel"], r["rung"], r["class"]) for r in want["outliers"]]
    assert outliers and rc == (1 if pm.failures(outliers) else 0)
    jax_md = (tmp_path / "outlier_postmortem.md").read_text().replace(
        "validation/outlier_postmortem.py",
        "validation_torch/outlier_postmortem.py")
    assert pm.render(nat, agr, rows, outliers, s_model) == jax_md
    # the port's labels: the engine word and the mode substituted back
    _, gpu_out, _ = pm.classify(nat, agr, "gpu")
    gpu_md = pm.render(nat, agr, rows, gpu_out, s_model, "gpu", "traced")
    assert "gpu-undersampled-at-nlive100" in gpu_md
    assert gpu_md.replace("GPU (traced)", "TPU").replace(
        "gpu-undersampled", "tpu-undersampled") == jax_md


def test_selection_sharpness_matches_the_jax_script_on_the_tpu_record(
        tmp_path):
    jax_ss = _jax_script("selection_sharpness", _artifacts(tmp_path))
    _, want = _run_main(jax_ss)
    nat, agr = pm.load(NATIVE, TPU)
    ct = ss.crosstab(nat, agr)
    np.testing.assert_array_equal(ct["tab"], want["tab"])
    assert ct["tab"].sum() == 48
    assert ct["agree"] == want["agree"]
    assert ct["rows"] == want["rows"]
    for key, ref in (("one", "tpu1"), ("agree1", "agree1"),
                     ("dis1", "dis1"), ("close", "close")):
        assert [r["pixel"] for r in ct[key]] == \
            [r["pixel"] for r in want[ref]], key
    jax_md = (tmp_path / "selection_sharpness.md").read_text().replace(
        "validation/selection_sharpness.py",
        "validation_torch/selection_sharpness.py")
    assert ss.render(ct) == jax_md
    gpu_md = ss.render(ct, "gpu", "segmented")
    note = ("The reading below is the JAX script's, written for its TPU "
            "record; the numbers above are this record's.\n\n")
    assert note in gpu_md
    assert gpu_md.replace(note, "").replace("GPU (segmented)", "TPU") == \
        jax_md


# ---------------------------------------------------------------------------
# (c) one made-up record per class


def _made_up(case):
    """A native truth and an agreement record on three pixels where pixel
    0 holds the case's outlier and every other record lies within 10
    sigma (sigma = sqrt(0.3^2 + 0.2^2) = 0.36 nats)."""
    nat_lnz = {1: -100.0, 2: -50.0}
    native, runs100, runs400 = {}, [{}, {}, {}], [{}]
    for p in range(3):
        scat2 = 10.0 if (p == 0 and case == "baseline-seed-scatter") \
            else 0.2
        seeds = {}
        for k, d in enumerate((0.0, -1.0, 1.0)):
            seeds[str(k)] = {
                "lnz1": nat_lnz[1] + 0.2 * d, "lnz1_err": 0.3,
                "lnz2": nat_lnz[2] + scat2 * d, "lnz2_err": 0.3}
        native[str(p)] = {"seeds": seeds}
        lnz = dict(nat_lnz)
        if p == 0:
            if case == "rung1-misfit-islands":
                lnz[1] = -90.0          # rung 1 high, both select 2 by > 33
            elif case == "undersampled":
                lnz[2] = -60.0          # the nlive-400 run agrees
            elif case == "baseline-seed-scatter":
                lnz[2] = -58.0          # inside 3x the engine's scatter
            elif case == "sampler-mode-loss":
                lnz[2] = -60.0
            else:
                lnz[2] = -40.0          # high, nothing explains it
        for r in runs100:
            r[str(p)] = {"lnz1": lnz[1], "lnz1_err": 0.3, "lnz2": lnz[2],
                         "lnz2_err": 0.3, "null_lnz": -200.0}
        runs400[0][str(p)] = {"lnz1": nat_lnz[1], "lnz2": nat_lnz[2]}
    runs = {f"nlive100/seed{s}": r for s, r in enumerate(runs100)}
    if case in ("undersampled", "rung1-misfit-islands"):
        runs["nlive400/seed0"] = runs400[0]
    nat = {"nlive": 400, "cube_checksum": "made-up", "records": native}
    agr = {"cube_checksum": "made-up", "pixels": [0, 1, 2],
           "truth_params": {str(p): [0.0] * 12 for p in range(3)},
           "runs": runs}
    return nat, agr


@pytest.mark.parametrize("case, cls, rc", [
    ("rung1-misfit-islands", "rung1-misfit-islands", 0),
    ("undersampled", "tpu-undersampled-at-nlive100", 0),
    ("baseline-seed-scatter", "baseline-seed-scatter", 0),
    ("sampler-mode-loss", "sampler-mode-loss", 1),
    ("unexplained", "unexplained", 1),
])
def test_each_postmortem_class_as_the_jax_script(tmp_path, case, cls, rc):
    nat, agr = _made_up(case)
    (tmp_path / "native_truth_seed5.json").write_text(json.dumps(nat))
    (tmp_path / "tpu_agreement_seed5.json").write_text(json.dumps(agr))
    jax_rc, want = _run_main(_jax_script("outlier_postmortem", tmp_path))
    assert [(r["pixel"], r["class"]) for r in want["outliers"]] == \
        [(0, cls)]
    with contextlib.redirect_stdout(None):
        port_rc = pm.main([
            "--agreement", str(tmp_path / "tpu_agreement_seed5.json"),
            "--native", str(tmp_path / "native_truth_seed5.json"),
            "--out", str(tmp_path / "port.md")])
    assert jax_rc == port_rc == rc
    _, outliers, _ = pm.classify(nat, agr, "tpu")
    assert [(r["pixel"], r["class"]) for r in outliers] == [(0, cls)]
    # a port record names its engine "gpu"
    _, outliers, _ = pm.classify(nat, dict(agr, mode="traced"), "gpu")
    assert outliers[0]["class"] == cls.replace("tpu-", "gpu-")
    assert f"**{cls}**" in (tmp_path / "outlier_postmortem.md").read_text()


def test_postmortem_refuses_records_of_another_cube(tmp_path):
    nat, agr = _made_up("undersampled")
    agr["cube_checksum"] = "another"
    (tmp_path / "n.json").write_text(json.dumps(nat))
    (tmp_path / "a.json").write_text(json.dumps(agr))
    with pytest.raises(ValueError, match="cube mismatch"):
        pm.load(tmp_path / "n.json", tmp_path / "a.json")


# ---------------------------------------------------------------------------
# (d) the agreement run on the CPU


@pytest.mark.parametrize("mode", ["segmented", "traced"])
def test_agreement_run_on_the_cpu(tmp_path, mode):
    tpu = json.loads(TPU.read_text())
    pixels = tpu["pixels"][:3]
    out = tmp_path / f"gpu_agreement_{mode}.json"
    kw = dict(out=str(out), mode=mode, plan=[(20, 0)], batch=4,
              device="cpu", pixels=pixels,
              cfg_overrides={"max_iter": 120})
    rec, done = agr_mod.run_agreement(**kw)
    assert done == ["nlive20/seed0"]
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    assert list(rec)[:6] == list(tpu)
    assert rec["mode"] == mode
    assert rec["segment_iters"] == agr_mod.SEGMENT_ITERS[mode]
    assert rec["card"] is None                  # no card on the CPU
    assert rec["cube_checksum"] == tpu["cube_checksum"] == "3ca4ac945c289ff3"
    assert rec["pixels"] == pixels
    assert rec["truth_params"] == {str(i): tpu["truth_params"][str(i)]
                                   for i in pixels}
    run = rec["runs"]["nlive20/seed0"]
    ref = tpu["runs"]["nlive100/seed0"]
    assert sorted(run) == sorted(map(str, pixels))   # no padding row
    for i in map(str, pixels):
        assert sorted(run[i]) == sorted(ref[i])
        for k in run[i]:
            assert np.shape(run[i][k]) == np.shape(ref[i][k]), k
        assert run[i]["null_lnz"] == pytest.approx(ref[i]["null_lnz"],
                                                   rel=1e-5)
        for n in (1, 2):
            assert np.isfinite(run[i][f"lnz{n}"])
            assert np.isfinite(run[i][f"lnz{n}_err"])
    stats = rec["run_stats"]["nlive20/seed0"]
    for n in ("1", "2"):
        assert 0 <= stats[n]["converged"] <= len(pixels)
        assert stats[n]["evals_per_px"] > 0
    # the same file again: every config is done, nothing is fitted
    rec2, done2 = agr_mod.run_agreement(**kw)
    assert done2 == []
    assert rec2["runs"] == rec["runs"]


def test_agreement_configs_and_compare():
    assert agr_mod.configs(3, 1) == [(100, 0), (100, 1), (100, 2),
                                     (400, 0)]
    assert agr_mod.configs(3, 4)[-1] == (400, 3)
    tpu = json.loads(TPU.read_text())
    same = agr_mod.compare(tpu, tpu)
    assert same["n_records"] == 96
    assert same["dz_sigma_median"] == 0.0 and same["n_beyond_4"] == 0
    # a port record 50 nats low on one rung of one pixel
    low = json.loads(json.dumps(tpu))
    for run in low["runs"].values():
        run["0"]["lnz2"] -= 50.0
    got = agr_mod.compare(low, tpu)
    assert (got["n_beyond_4"], got["n_beyond_10"]) == (1, 1)
    assert got["beyond_10"][0]["pixel"] == 0
    assert got["beyond_10"][0]["rung"] == 2


def test_agreement_refuses_another_cube(tmp_path):
    nat = json.loads(NATIVE.read_text())
    nat["cube_checksum"] = "0000000000000000"
    (tmp_path / "n.json").write_text(json.dumps(nat))
    out = tmp_path / "out.json"
    rc = agr_mod.main(["--native", str(tmp_path / "n.json"), "--out",
                       str(out), "--device", "cpu"])
    assert rc == 1 and not out.exists()


# ---------------------------------------------------------------------------
# (e) the mode-loss probe's native lnZ2


def test_mode_loss_pixels_reads_the_native_lnz2():
    got = mlp.native_lnz2([17, 23, 5000])
    assert got[17] == pytest.approx(-442.83, abs=0.01)
    assert got[23] == pytest.approx(-1069.30, abs=0.01)
    assert got[5000] is None
