#!/usr/bin/env python3
"""Probe a mesh that spans two cards.

1. Whether a CUDA graph captures the likelihood of a runner whose spectra
   are split over two cards (``Runner.placed(["cuda:0", "cuda:1"])``, the
   sp axis): the cross-card copies inside the block.  If it does, the
   replay is held against the eager call bit for bit.
2. A traced NH3 rung 1 (1024 px, nlive 100) on a dp = 2 mesh over two
   cards, on a dp = 2 mesh of one card and without a mesh: a warm-up
   run of each, then walls in turns, and the median lnZ.
3. A 64-px NH3 rung 1 on a (dp 1, sp 2) mesh over two cards, segmented
   and at ``fit_batch``'s default (the traced mode, whose blocks then run
   eagerly on the card): finite, on cuda:0, and within two median
   combined errors of the no-mesh run.

Run on a machine with at least two cards, from the repository root:
``python3 tools/mesh_probe.py [STEP ...]`` (default: all three steps).
Prints each card's name and power limit; exits non-zero when a check
fails.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="*", type=int, choices=(1, 2, 3),
                    default=[1, 2, 3], help="the steps to run")
    steps = set(ap.parse_args().steps)

    import torch
    from nestfit_tpu_torch.models import AmmoniaRunner, ammonia
    from nestfit_tpu_torch.parallel import make_mesh
    from nestfit_tpu_torch.priors import get_irdc_priors
    from nestfit_tpu_torch.sampling import NSConfig, fit_batch, graphs
    from nestfit_tpu_torch.synth import make_synth_cube_arrays

    if torch.cuda.device_count() < 2:
        sys.exit("mesh_probe: needs two cards")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    ok = True
    R, noise = 1024, 0.15
    (xa11, d11), (xa22, d22), _ = make_synth_cube_arrays(
        n_pix=R, noise=noise, rng=np.random.default_rng(0))
    utrans = get_irdc_priors(device="cuda:0")

    def runner(ncomp, rows):
        spectra = [ammonia.make_ammonia_spectrum(
            x, d[:rows], np.full(rows, noise), trans_id=tid, device="cuda:0")
            for tid, (x, d) in enumerate(((xa11, d11), (xa22, d22)), 1)]
        return AmmoniaRunner(spectra, utrans, ncomp=ncomp, device="cuda:0")

    cfg1 = NSConfig(nlive=100, tol=1.0, init_factor=4,
                    flat_dims=tuple(utrans.flat_dims(1)))

    # 1. capture across two cards
    if 1 in steps:
        whole = runner(2, R)
        sliced = whole.placed(["cuda:0", "cuda:1"])
        rng = np.random.default_rng(1)
        u = torch.as_tensor(rng.uniform(size=(50, R, 12)), dtype=torch.float32,
                            device="cuda:0")
        want = sliced.loglike_unit(u)
        rel = ((want - whole.loglike_unit(u)).abs()
               / whole.loglike_unit(u).abs()).max().item()
        print(f"sp=2 over two cards: eager likelihood max relative difference "
              f"to sp=1 {rel:.3e}", flush=True)
        ok &= rel <= 1e-5
        static = u.clone()
        stream = torch.cuda.Stream("cuda:0")
        stream.wait_stream(torch.cuda.current_stream("cuda:0"))
        with torch.cuda.stream(stream):
            sliced.loglike_unit(static)
        torch.cuda.current_stream("cuda:0").wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                out = sliced.loglike_unit(static)
            u2 = torch.as_tensor(rng.uniform(size=(50, R, 12)),
                                 dtype=torch.float32, device="cuda:0")
            static.copy_(u2)
            graph.replay()
            torch.cuda.synchronize()
            same = bool(torch.equal(out, sliced.loglike_unit(u2)))
            print(f"sp=2 over two cards: the capture accepted the cross-card "
                  f"block; replay equal to eager bit for bit: {same}",
                  flush=True)
        except Exception as exc:  # noqa: BLE001 - the probe reports it
            print(f"sp=2 over two cards: the capture refused the cross-card "
                  f"block: {type(exc).__name__}: {str(exc)[:300]}", flush=True)
        torch.cuda.synchronize()

    # 2. dp = 2 over two cards, over one card, no mesh: a warm-up run of
    if 2 in steps:
        # each, then timed in turns
        meshes = {"none": None,
                  "dp=2 one card": make_mesh(devices=["cuda:0", "cuda:0"]),
                  "dp=2 two cards": make_mesh(devices=["cuda:0", "cuda:1"])}
        order = list(meshes) + ["none", "dp=2 one card", "dp=2 two cards",
                                "dp=2 two cards", "dp=2 one card", "none"]
        runs = {}
        for turn, label in enumerate(order):
            mesh = meshes[label]
            if turn >= len(meshes):
                label = f"{label} (turn {turn - len(meshes) + 1})"
            else:
                label = f"{label} (warm-up)"
            gen = torch.Generator(device="cuda:0")
            gen.manual_seed(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit = fit_batch(gen, runner(1, R), R, cfg1, segment_iters=0,
                            device="cuda:0", mesh=mesh)
            for d in range(2):
                torch.cuda.synchronize(d)
            wall = time.perf_counter() - t0
            z, e = fit.lnz.cpu().numpy(), fit.lnz_err.cpu().numpy()
            runs[label] = (z, e)
            print(f"traced rung ncomp=1 R={R} {label}: wall {wall:.2f} s, "
                  f"converged {int(fit.ns.converged.sum())}/{R}, lnZ median "
                  f"{np.median(z):.3f}", flush=True)
            ok &= bool(np.isfinite(z).all())
        for label in ("dp=2 one card", "dp=2 two cards"):
            d = runs[f"{label} (warm-up)"][0] - runs["none (warm-up)"][0]
            comb = np.sqrt(runs[f"{label} (warm-up)"][1] ** 2
                           + runs["none (warm-up)"][1] ** 2)
            ok &= abs(np.median(d)) <= 2 * np.median(comb)

    # 3. sp = 2 over two cards through the sampler
    if 3 in steps:
        mesh = make_mesh(devices=["cuda:0", "cuda:1"], sp=2)
        for mode in ({"segment_iters": 250}, {}):
            res = {}
            for m in (None, mesh):
                gen = torch.Generator(device="cuda:0")
                gen.manual_seed(2)
                graphs.last_stats = graphs.TracedStats()
                t0 = time.perf_counter()
                fit = fit_batch(gen, runner(1, 64), 64, cfg1,
                                device="cuda:0", mesh=m, **mode)
                torch.cuda.synchronize()
                res[m is None] = (fit.lnz.cpu().numpy(),
                                  fit.lnz_err.cpu().numpy(),
                                  time.perf_counter() - t0, fit.lnz.device,
                                  graphs.last_stats)
            d = res[False][0] - res[True][0]
            comb = np.sqrt(res[False][1] ** 2 + res[True][1] ** 2)
            st = res[False][4]
            # at the default the blocks over two cards run eagerly
            good = bool(np.isfinite(res[False][0]).all()) and \
                res[False][3] == torch.device("cuda:0") and \
                abs(np.median(d)) <= 2 * np.median(comb) and \
                (bool(mode) or (st.eager_blocks == st.blocks > 0
                                and st.replays == 0))
            ok &= good
            how = "segment_iters=250" if mode else "the default (traced)"
            print(f"(dp 1, sp 2) over two cards, {how}, rung ncomp=1 R=64: "
                  f"wall {res[False][2]:.2f} s against {res[True][2]:.2f} s "
                  f"without a mesh, result on {res[False][3]}, "
                  f"{st.blocks} blocks ({st.eager_blocks} eager, "
                  f"{st.replays} replays), lnZ - no mesh median "
                  f"{np.median(d):.3f} (combined error median "
                  f"{np.median(comb):.3f}): {'ok' if good else 'FAIL'}",
                  flush=True)

    print("mesh_probe:", "ok" if ok else "FAIL", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
