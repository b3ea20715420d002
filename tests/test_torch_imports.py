"""The port stands alone: no module of ``nestfit_tpu_torch`` and not
``chip_smoke.py`` imports JAX or anything of ``nestfit_tpu``, and
importing them builds no kernel and no native library (no compiler
runs).  Only ``nestfit_tpu_torch.cube.store`` needs ``h5py``."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import nestfit_tpu_torch

ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    mods = sorted(m.name for m in pkgutil.walk_packages(
        nestfit_tpu_torch.__path__, "nestfit_tpu_torch."))
    assert "nestfit_tpu_torch.sampling.sampler" in mods
    for m in ("cube", "cube.cube", "cube.fits_io", "cube.fitter",
              "cube.products", "cube.records", "cube.store", "synth",
              "utils.logging", "parallel", "parallel.mesh",
              "parallel.distributed", "native", "native.bindings",
              "experiments", "experiments.varnoise", "utils.profiling"):
        assert f"nestfit_tpu_torch.{m}" in mods, m
    build = ROOT / "nestfit_tpu_torch" / "_build"

    def built():
        # the native library: another test file may build it meanwhile
        return sorted(p for p in build.glob("*")
                      if not p.name.startswith("nestfit_native")) \
            if build.exists() else []

    before = built()
    code = "\n".join(
        ["import importlib, os, runpy, subprocess, sys",
         "class NoBuild(subprocess.Popen):",
         "    def __init__(self, args, *a, **k):",
         "        prog = args if isinstance(args, str) else args[0]",
         "        name = os.path.basename(str(prog).split()[0])",
         "        assert name not in ('nvcc', 'g++', 'c++', 'clang++',",
         "                            'make'), f'an import ran {args!r}'",
         "        super().__init__(args, *a, **k)",
         "subprocess.Popen = NoBuild"]
        + [f"importlib.import_module({m!r})" for m in mods]
        + ["runpy.run_path('chip_smoke.py', run_name='chip_smoke')",
           "bad = sorted(m for m in sys.modules if m == 'jax'"
           " or m.startswith(('jax.', 'jaxlib'))"
           " or m == 'nestfit_tpu' or m.startswith('nestfit_tpu.'))",
           "print(len(sys.modules)); assert not bad, bad"])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert built() == before


def test_chip_smoke_fails_without_a_card_or_the_port(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, "chip_smoke.py"), (tmp_path, str(alone))):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_only_the_store_needs_h5py():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        nestfit_tpu_torch.__path__, "nestfit_tpu_torch."))
    code = "\n".join(
        ["import importlib, runpy, sys", "sys.modules['h5py'] = None",
         "failed = []",
         f"for m in {mods!r}:",
         "    try:",
         "        importlib.import_module(m)",
         "    except ImportError:",
         "        failed.append(m)",
         "runpy.run_path('chip_smoke.py', run_name='chip_smoke')",
         "import nestfit_tpu_torch as ntt",
         "assert ntt.DataCube is ntt.cube.DataCube",
         "print(failed); assert failed == ['nestfit_tpu_torch.cube.store']"])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
