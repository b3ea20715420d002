#!/usr/bin/env python3
"""Peak device memory of one ``fit_batch`` at the cube fitter's top bucket.

A batch of ``--rows`` synthetic NH3 (1,1)+(2,2) pixels (``synth.
make_synth_cube_arrays``, noise 0.15, seed 0) is fitted at ncomp 2 and
nlive 700 (the top SNR bucket of ``chip_smoke.py``'s synthetic cube)
with the cube fitter's sampler settings (tol 1.0, init_factor 4,
``segment_iters=256``, ``n_post`` 2048), once per row count.  The peak
is split where ``fit_batch`` hands the sampler's result to
``posterior_products``: the sampler's peak (``run_nested`` with
``ns_finalize``), the bytes its ``NSResult`` holds, and the posterior
products' own peak.  Each is printed beside the unit ``R x (max_iter +
nlive) x D`` float32 (one copy of the dead and live points), with the
allocator's reserved peak and its retries.  After the products,
``posterior_modes`` runs on the same result, and its peak above the
held bytes and its wall are printed too.  Each row count runs with the
products and the modes in their row slices (``results._PRODUCTS_BYTES``
of points a slice, as shipped) and, with ``--one-pass``, once more over
every row at once.  A run that runs out of memory is reported and the
next one runs.

Run from the root of the repository, on a card::

    python3 tools/cube_memory.py --rows 256 1024 --one-pass
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

GIB = 2**30
NCOMP, SEED, NLIVE = 2, 0, 700
N_POST = 2048            # CubeFitter's: 16 x its base nlive 100, to 2^k


def leaf_bytes(obj):
    """Bytes of the tensors a dataclass (or dict) holds, recursively."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(leaf_bytes(v) for v in obj.values())
    if dataclasses.is_dataclass(obj):
        return sum(leaf_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


def measure(rows, nlive, one_pass):
    import torch
    from chip_smoke import make_runner
    from nestfit_tpu_torch.priors import get_irdc_priors
    import nestfit_tpu_torch.sampling.fit as fit_mod
    from nestfit_tpu_torch.sampling import NSConfig, results
    from nestfit_tpu_torch.synth import make_synth_cube_arrays

    (xa11, d11), (xa22, d22), _ = make_synth_cube_arrays(
        n_pix=rows, noise=0.15, rng=np.random.default_rng(SEED))
    runner = make_runner((xa11, xa22), (d11, d22), 0.15, NCOMP,
                         get_irdc_priors(device="cuda"))
    cfg = NSConfig(nlive=nlive, tol=1.0, init_factor=4)
    D = runner.ndim
    max_iter = cfg.resolved(D).max_iter
    unit = rows * (max_iter + nlive) * D * 4
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    budget = results._PRODUCTS_BYTES
    row_bytes = unit // rows
    out = dict(rows=rows, nlive=nlive, ncomp=NCOMP, D=D, max_iter=max_iter,
               unit_gib=unit / GIB,
               slice_rows=rows if one_pass else max(1, budget // row_bytes))
    pp = fit_mod.posterior_products

    def split(ns, transform, g, n_post=512):
        torch.cuda.synchronize()
        out["sampler_peak_gib"] = torch.cuda.max_memory_allocated() / GIB
        out["held_at_products_gib"] = torch.cuda.memory_allocated() / GIB
        out["nsresult_gib"] = leaf_bytes(ns) / GIB
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        prod = pp(ns, transform, g, n_post=n_post)
        torch.cuda.synchronize()
        out["products_peak_gib"] = torch.cuda.max_memory_allocated() / GIB
        out["products_above_held_gib"] = (
            torch.cuda.max_memory_allocated() - held) / GIB
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        modes = results.posterior_modes(ns, transform)
        torch.cuda.synchronize()
        out["modes_s"] = time.perf_counter() - t0
        out["modes_above_held_gib"] = (
            torch.cuda.max_memory_allocated() - held) / GIB
        out["modes_finite"] = bool(
            torch.isfinite(modes.mode_lnz).any(dim=1).all())
        del modes
        return prod

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fit_mod.posterior_products = split
    if one_pass:
        results._PRODUCTS_BYTES = unit
    t0 = time.perf_counter()
    try:
        fit = fit_mod.fit_batch(gen, runner, rows, cfg, n_post=N_POST,
                                segment_iters=256, device="cuda")
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
        out["fit_gib"] = leaf_bytes(fit) / GIB
        out["lnz_finite"] = bool(torch.isfinite(fit.lnz).all())
        del fit
    except torch.cuda.OutOfMemoryError as exc:
        out["oom"] = str(exc).splitlines()[0][:200]
    finally:
        fit_mod.posterior_products = pp
        results._PRODUCTS_BYTES = budget
    st = torch.cuda.memory_stats()
    out.update(
        base_gib=base / GIB,
        reserved_peak_gib=st.get("reserved_bytes.all.peak", 0) / GIB,
        alloc_retries=st.get("num_alloc_retries", 0),
        ooms=st.get("num_ooms", 0))
    for k in ("sampler_peak_gib", "products_above_held_gib",
              "modes_above_held_gib"):
        if k in out:
            out[k.replace("_gib", "_units")] = out[k] * GIB / unit
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[256, 1024])
    ap.add_argument("--one-pass", action="store_true",
                    help="also run the products over every row at once")
    args = ap.parse_args()

    import subprocess
    import torch

    if not torch.cuda.is_available():
        sys.exit("cube_memory: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,memory.total",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    results = []
    for rows in args.rows:
        for one_pass in (False, True)[: 1 + args.one_pass]:
            res = measure(rows, NLIVE, one_pass)
            results.append(res)
            print(json.dumps(res), flush=True)
    print(json.dumps({"card": card, "cube_memory": results}), flush=True)


if __name__ == "__main__":
    main()
