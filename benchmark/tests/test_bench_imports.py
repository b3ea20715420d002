"""What the benchmark may import: never JAX or the JAX package (top-level
names compared whole), nor the repo's bench scripts or validation
suites; the reference nothing of the program."""

import ast
import subprocess
import sys

from core import manifest

BENCH = manifest.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "nestfit_tpu", "bench", "bench_torch",
             "validation", "validation_torch", "chip_smoke"}


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_a_forbidden_module():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "nestfit_tpu_torch" not in _imports(path), path
    code = ("import sys; sys.path[:0] = [%r]\n"
            "import reference.evidence, reference.hyperfine, "
            "reference.ladder, reference.levels, reference.priors, "
            "reference.model_ammonia, "
            "reference.model_diazenylium\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert "nestfit_tpu_torch" not in out and "'jax'" not in out


def test_a_run_loads_no_jax(tmp_path):
    """A whole run on the CPU at a tiny size, in its own process: the
    modules loaded after it hold no forbidden top-level name."""
    code = f"""
import sys, time
sys.path[:0] = [{str(BENCH)!r}, {str(manifest.ROOT)!r}]
import run
from core import manifest
cell = manifest.cell_of("tiny", "n2hp_10", "n2hp_bright")
cell.config = dict(cell.config, nlive=16, max_iter=300, batch_size=4)
cell.traffic = dict(cell.traffic, pixels=4)
run.run_cell(cell, 3, 0.1, device="cpu", t_proc=time.time(),
             log=lambda *a, **k: None)
print(run.loaded_forbidden())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_exits_2_with_no_result():
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "n2hp_cube_bright", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=manifest.ROOT)
    assert out.returncode == 2 and out.stdout == ""
