"""The port stands alone: no module of ``nestfit_tpu_torch`` and not
``chip_smoke.py`` imports JAX or anything of ``nestfit_tpu``, and
importing them builds no kernel and no native library (no compiler
runs).  Only ``nestfit_tpu_torch.cube.store`` needs ``h5py``, and
nothing needs matplotlib until a figure is drawn.  The port has every
module of the JAX package with its public names, every public function
and method with the JAX package's arguments and defaults, and its flat
API holds the JAX package's."""

import ast
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
              "experiments", "experiments.varnoise", "utils.profiling",
              "sampling.aot", "plotting", "wcs"):
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


def _public_names(path, imports=False):
    """The public top-level names a module defines (and, with
    ``imports``, those it imports)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif imports and isinstance(node, ast.ImportFrom):
            out |= {a.asname or a.name for a in node.names}
    return {n for n in out if not n.startswith("_")}


def test_every_jax_module_and_public_name_has_its_port():
    """Module by module, the JAX package's public top-level names are
    the port's, but for the Pallas switches, which mean nothing here."""
    jax_root, port_root = ROOT / "nestfit_tpu", ROOT / "nestfit_tpu_torch"
    missing = {}
    for path in sorted(jax_root.rglob("*.py")):
        port = port_root / path.relative_to(jax_root)
        assert port.exists(), port
        lost = _public_names(path) - _public_names(port)
        if lost:
            missing[str(port.relative_to(ROOT))] = sorted(lost)
    assert missing == {
        "nestfit_tpu_torch/ops/fused.py": ["INTERPRET", "LANE"],
        "nestfit_tpu_torch/ops/tables.py": ["INTERPRET", "LANE"],
        "nestfit_tpu_torch/priors/distributions.py": ["USE_PALLAS_TABLES"],
    }


def test_flat_api_holds_the_jax_package_names():
    """Every name ``nestfit_tpu/__init__.py`` exports resolves on the port's
    package, lazily: importing the package loads no torch."""
    names = _public_names(ROOT / "nestfit_tpu" / "__init__.py",
                          imports=True)
    assert {"fit_batch", "make_mesh", "NSConfig", "CKMS"} <= names
    code = "\n".join(
        ["import sys", "import nestfit_tpu_torch as ntt",
         "assert 'torch' not in sys.modules, 'torch at import'",
         f"names = {sorted(names)!r}",
         "missing = [n for n in names if not hasattr(ntt, n)]",
         "assert not missing, missing",
         "assert ntt.__version__ == '0.1.0'",
         "assert ntt.fit_batch is ntt.sampling.fit.fit_batch",
         "assert ntt.make_mesh is ntt.parallel.mesh.make_mesh",
         "assert ntt.ammonia is ntt.models.ammonia",
         "assert set(names) <= set(dir(ntt))"])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_plots_need_matplotlib_only_to_draw(tmp_path):
    """With matplotlib blocked, ``plotting`` imports, a ``StorePlotter``
    over the records runs its data steps, and a renderer raises."""
    code = "\n".join(
        ["import sys", "sys.modules['matplotlib'] = None",
         "sys.path.insert(0, 'tests')",
         "import numpy as np",
         "from nestfit_tpu_torch import plotting",
         "from nestfit_tpu_torch.cube import products",
         "from nestfit_tpu_torch.models import MODELS",
         "from test_torch_products import _batches",
         "table = products.FitTable.from_records(",
         "    _batches('ammonia', 0, False), 9, 7, 2, 6, 11.0,",
         "    MODELS['ammonia'], with_posteriors=True)",
         "src = plotting.RecordSource(table)",
         f"sp = plotting.StorePlotter(src, plot_dir={str(tmp_path)!r},",
         "                            device='cpu')",
         "h = sp.post_stack_data(0, 0)['hists']",
         "assert len(h) == 18 and np.isfinite(h[0]['density']).all()",
         "assert sp.velo_2corr_data(0, 0)['hist'].sum() == 64",
         "assert sp.corner_data(7, 0)['ndim'] == 6",
         "d = plotting.amm_predict_precision_data(device='cpu')",
         "assert d['pred'].shape == d['truth'].shape",
         "try:",
         "    sp.plot_corner(7, 0)",
         "except ImportError:",
         "    pass",
         "else:",
         "    raise AssertionError('drew without matplotlib')",
         "assert 'matplotlib.pyplot' not in sys.modules"])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _signatures(path):
    """``{name: [(arg, default source or None), ...]}`` of a module's
    public functions and of the public methods (``__init__`` and
    ``__call__`` too) of its public classes."""
    def args(fn):
        a = fn.args
        pos = a.posonlyargs + a.args
        defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
        out = list(zip((x.arg for x in pos), defaults))
        out += list(zip((x.arg for x in a.kwonlyargs), a.kw_defaults))
        out += [(f"*{x.arg}", None) for x in (a.vararg,) if x]
        out += [(f"**{x.arg}", None) for x in (a.kwarg,) if x]
        return [(n, None if d is None else ast.unparse(d)) for n, d in out]

    def public(name):
        return not name.startswith("_") or name in ("__init__", "__call__")

    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, funcs) and public(node.name):
            out[node.name] = args(node)
        elif isinstance(node, ast.ClassDef) and public(node.name):
            for sub in node.body:
                if isinstance(sub, funcs) and public(sub.name):
                    out[f"{node.name}.{sub.name}"] = args(sub)
    return out


#: the port's names for JAX arguments: a ``torch.Generator`` for a key
RENAMED = {"key": "gen"}
#: keywords the port adds: the device an entry point runs on, a mesh
#: where the JAX package takes its mesh from the ambient context, the
#: plain versions of the kernels
ADDED = {"device", "mesh", "plain"}
#: (module, function, argument) -> (JAX default, port default)
DEFAULTS = {
    ("utils/logging.py", "get_logger", "name"):
        ("'nestfit_tpu'", "'nestfit_tpu_torch'"),
    # both float64
    ("cube/products.py", "nans", "dtype"): ("None", "_F64"),
    # the port's exporter writes where it is told, not to a fixed path
    ("utils/profiling.py", "trace", "log_dir"):
        ("'/tmp/nestfit_trace'", None),
    # the port resolves these per mode (``segment_iters``)
    **{("sampling/aot.py", "build_plan", a): (j, "_UNSET") for a, j in (
        ("n_post", "0"), ("r_classes", "None"),
        ("kinds_full", "('init', 'cand', 'slice', 'fin', 'finalize', "
                       "'rebuild')"),
        ("kinds_classes", "('slice', 'rebuild')"))},
}
#: (module, function) -> more keywords the port adds: the JAX plan
#: always prepares the segmented sampler, the port's either mode
ADDED_TO = {("sampling/aot.py", "build_plan"): {"segment_iters"},
            # the units of work a segmented run hands its segments (its
            # CUDA graph programs, ``graphs.SegmentedRun``)
            **{("sampling/sampler.py", f): {"units"} for f in (
                "ns_segment", "ns_segment_slice", "ns_slice_fill")},
            # the points the sampler reads, which K1's one launch alone
            # computes (``ops.fused.hf_lnl_fused``)
            **{("models/runner.py", f"Runner.{f}"): {"live"} for f in (
                "log_likelihood", "loglike_unit")}}


def test_every_jax_function_has_its_arguments_and_defaults():
    """Every public function and public method of a public class of the
    JAX package (outside ``ops/``, whose tile sizes and Pallas switches
    have no counterpart) is in the port's module of the same path with
    every argument name, in the same order, and equal defaults, but for
    the named differences above (``jnp.<dtype>`` defaults are the port's
    ``torch.<dtype>``)."""
    jax_root, port_root = ROOT / "nestfit_tpu", ROOT / "nestfit_tpu_torch"
    diffs, used = [], set()
    for path in sorted(jax_root.rglob("*.py")):
        rel = str(path.relative_to(jax_root))
        if rel.startswith("ops/"):
            continue
        port_sigs = _signatures(port_root / rel)
        for name, jargs in _signatures(path).items():
            where = f"{rel}::{name}"
            if name not in port_sigs:
                diffs.append(f"{where}: missing")
                continue
            pargs = dict(port_sigs[name])
            want = [(RENAMED.get(a, a), d) for a, d in jargs]
            more = ADDED_TO.get((rel, name), set())
            if more & set(pargs):
                used.add((rel, name))
            extra = [a for a in pargs if a not in dict(want)
                     and a not in ADDED | more]
            if extra:
                diffs.append(f"{where}: adds {extra}")
            order = [a for a in pargs if a in dict(want)]
            if order != [a for a, _ in want if a in pargs]:
                diffs.append(f"{where}: argument order {order}")
            for a, d in want:
                if a not in pargs:
                    diffs.append(f"{where}: lacks {a}")
                    continue
                got = pargs[a]
                named = DEFAULTS.get((rel, name.split(".")[-1], a))
                if named is not None:
                    used.add((rel, name.split(".")[-1], a))
                    ok = (d, got) == named
                elif d is not None and d.startswith("jnp."):
                    ok = got == "torch." + d[len("jnp."):]
                else:
                    ok = got == d
                if not ok:
                    diffs.append(f"{where}: {a}={got}, the JAX package's "
                                 f"{d}")
    assert diffs == [], "\n".join(diffs)
    # every named difference is still one
    assert used == set(DEFAULTS) | set(ADDED_TO)
