#!/usr/bin/env python3
"""Time K3 ``tapered_invert`` and K4 ``gauss_chi2_fused`` against a
parent tree's kernels, in turns, on one card.

The parent's ``csrc/tapered_invert.cu`` and ``csrc/gauss_chi2.cu`` are
compiled with this tree's flags into ``<parent>/_turns/`` and called
through their own C signatures (those of the tree before K3's packed
table and K4's proposal groups), on the same inputs as this tree's
kernels: K3 on what the IRDC transform at ncomp 2 hands it (sfact 1 and
0) at the path's widths, K4 at the Gaussian ladder's candidate round
(T = 100, R = 1024, C = 2, S = 380).  Each kernel and width runs
parent, change, change, parent; each entry is the device time per launch from
``torch.profiler`` (``chip_smoke.time_ms``), with the launch floor (a
one-element ``fill_``) beside them.

Run from the root of this tree, with the parent unpacked inside it::

    python3 tools/kernel_turns.py --parent scratch/parent
"""

import argparse
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the parent's launchers: tapered_invert_launch(t0, t1c, t2c, xax, u,
# x_lo, x_hi, out, B, N, sfact, xmin, dx, center, n_sm, device, stream)
# and gauss_chi2_launch(voff, sigm, peak, data, dnu, out, B, C, R, S, fc,
# device, stream)
PARENT_K3_ARGS = [ctypes.c_void_p] * 8 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]
PARENT_K4_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def build_parent(parent: Path, source: str, name: str, argtypes):
    from nestfit_tpu_torch.ops import _build

    out_dir = parent / "_turns"
    out_dir.mkdir(exist_ok=True)
    lib = out_dir / f"{Path(source).stem}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(parent / "nestfit_tpu_torch" / "csrc" / source)],
                   check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def turns(label, parent_fn, change_fn, time_ms, reps=50):
    """Parent, change, change, parent; prints and returns the four
    device times (ms per launch)."""
    t = [time_ms(f, reps)[0]
         for f in (parent_fn, change_fn, change_fn, parent_fn)]
    print(f"{label}: parent {t[0]:.5f}, {t[3]:.5f}; change {t[1]:.5f}, "
          f"{t[2]:.5f} ms", flush=True)
    return t


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_turns: needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from nestfit_tpu_torch.constants import CKMS
    from nestfit_tpu_torch.models import gaussian
    from nestfit_tpu_torch.ops import fused, tables
    from nestfit_tpu_torch.priors import get_gaussian_priors, get_irdc_priors

    parent = args.parent.resolve()
    old_k3 = build_parent(parent, "tapered_invert.cu",
                          "tapered_invert_launch", PARENT_K3_ARGS)
    old_k4 = build_parent(parent, "gauss_chi2.cu", "gauss_chi2_launch",
                          PARENT_K4_ARGS)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"card {smoke.smi('name,power.limit')}; parent {parent}",
          flush=True)
    floor_ms, _ = smoke.launch_floor()
    print(f"launch floor (one-element fill_): {floor_ms:.5f} ms", flush=True)

    rng = np.random.default_rng(args.seed)
    utrans = get_irdc_priors(device="cuda")
    for B in smoke.K3_WIDTHS:
        u = torch.as_tensor(rng.uniform(size=(B, 12)), dtype=torch.float32,
                            device="cuda")
        for dist, uu, lo, hi, sf in smoke.capture_k3(utrans, u, 2):
            out = torch.empty_like(uu)

            def parent_k3():
                rc = old_k3(dist.t0.data_ptr(), dist.t1c.data_ptr(),
                            dist.t2c.data_ptr(), dist.xax.data_ptr(),
                            uu.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                            out.data_ptr(), B, dist.size, sf, dist.xmin,
                            dist.dx, dist.center, n_sm, 0, stream)
                if rc:
                    raise RuntimeError(f"parent K3: CUDA error {rc}")

            new = tables.tapered_invert(dist, uu, lo, hi, sf)
            parent_k3()
            torch.cuda.synchronize()
            err = (out - new).abs().max().item()
            turns(f"K3 B={B} sfact={sf} (parent vs change max |diff| "
                  f"{err:.3e})", parent_k3,
                  lambda: tables.tapered_invert(dist, uu, lo, hi, sf),
                  smoke.time_ms)

    R, T = 1024, 100
    xarr, rest, data, _ = smoke.gauss_cube(R, np.random.default_rng(
        args.seed))
    runner = smoke.make_gauss_runner(xarr, rest, data, 2,
                                     get_gaussian_priors(device="cuda"))
    spec = runner.spectra[0]
    u = torch.as_tensor(rng.uniform(size=(T, R, 6)), dtype=torch.float32,
                        device="cuda")
    flat = runner.transform(u, plain=True).reshape(T * R, -1)
    comps = [x.contiguous() for x in gaussian._components(spec, flat)]
    k4_args = (spec.rest_freq / CKMS, spec.dnu, spec.data, *comps)
    B, S = T * R, spec.size
    out = torch.empty(B, device="cuda")
    fc = float(np.float32(spec.rest_freq / CKMS))

    def parent_k4():
        rc = old_k4(*(x.data_ptr() for x in comps), spec.data.data_ptr(),
                    spec.dnu.data_ptr(), out.data_ptr(), B, 2, R, S, fc, 0,
                    stream)
        if rc:
            raise RuntimeError(f"parent K4: CUDA error {rc}")

    want = fused.gauss_chi2_plain(*k4_args)
    parent_k4()
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    print(f"K4 parent vs plain max |err| {err:.3e}", flush=True)
    got = fused.gauss_chi2_fused(*k4_args)
    torch.cuda.synchronize()
    rel = ((got - want).abs() / (1e-3 + 2e-4 * want.abs())).max().item()
    turns(f"K4 B={B} C=2 S={S} (max err/tol {rel:.3f})", parent_k4,
          lambda: fused.gauss_chi2_fused(*k4_args), smoke.time_ms, reps=20)


if __name__ == "__main__":
    main()
