#!/usr/bin/env python3
"""Sweep the kill+slice regime's iteration-cost knobs on the port.

The counterpart of ``validation/iter_cost_sweep.py`` on
``nestfit_tpu_torch``.  Each combo ``kk,sbe[,init_factor[,max_contract[,
repeats[,specw]]]]`` (``kill_k``, ``slice_bound_every``, ``init_factor``,
``max_contract``, ``fallback_repeats``, ``spec_width``; ``kill_k`` and
``repeats`` 0 = auto) runs the bench-protocol ladder: rung 1 then rung 2
of ``fit_batch`` on ``SWEEP_PIXELS`` pixels of the synthetic NH3 cube of
seed ``SWEEP_SEED`` (noise 0.15, the IRDC priors, nlive 100, tol 1.0), no
second pass and no retry, once as a warm-up (key 0) and once timed (key
``SWEEP_SEED``; skipped when ``SWEEP_TIMED`` is 0).  Each JAX key
``random.key(k)`` becomes one generator per rung ``n``, seeded ``10 * k +
n``.  Per rung: wall, evals/px, deaths/px, mean lnZ, floor violations
(lnZ more than 8 nats below the null model on rung 1, below rung 1 on
rung 2) and the converged share; per ladder the mean lnZ gains, the
nbest histogram (11-nat thresholds) and the ladder's wall.  One JSON
line per combo on stdout, as the JAX script prints it, adding ``mode``,
``n_pix`` and ``card``; progress goes to stderr.

``--mode segmented|traced`` replaces the JAX script's
``BENCH_SEGMENT_ITERS`` (``segment_iters`` 250 or 0).  Traced, the
warm-up ladder carries each combo's graph warm-ups and captures, the
timed one replays them.  ``--out``: the combo lines are appended there,
and a second call with the same ``--out`` skips the combos it already
holds at the same mode and width.

Usage: python validation_torch/iter_cost_sweep.py [combo ...]
         [--mode segmented|traced] [--out PATH] [--device cuda]
Default sweep: 0,1 50,1 0,2 50,2.
Env: SWEEP_PIXELS (1024), SWEEP_SEED (5), SWEEP_TIMED (1).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
from bench_torch import log  # noqa: E402
from validation_torch.agreement import SEGMENT_ITERS, card_or_none  # noqa
from validation_torch.mode_loss_probe import make_runners, read_out  # noqa

DEFAULT_COMBOS = ("0,1", "50,1", "0,2", "50,2")
SWEEP_PIXELS, SWEEP_SEED, SWEEP_TIMED = 1024, 5, 1
THRESH, FLOOR_NATS = 11.0, 8.0


def parse_combos(args):
    """``[(kill_k, sbe, init_factor, max_contract, repeats, spec_width),
    ...]`` of the combo strings (the JAX script's padding rule)."""
    combos = []
    for arg in (args or DEFAULT_COMBOS):
        f = [int(x) for x in arg.split(",")]
        f += [1, 6, 0, 2][len(f) - 2:]
        combos.append(tuple(f[:6]))
    return combos


def combo_tag(combo):
    kk, sbe, inif, mc, rep, sw = combo
    return (f"kk{kk or 'auto'}-sbe{sbe}-if{inif}-mc{mc}"
            f"-rep{rep or 'auto'}-sw{sw}")


def combo_config(combo, overrides=None):
    """The combo's ``NSConfig`` (``overrides`` last: a toy run's)."""
    from nestfit_tpu_torch.sampling import NSConfig

    kk, sbe, inif, mc, rep, sw = combo
    kw = dict(nlive=100, tol=1.0, kill_k=kk, slice_bound_every=sbe,
              init_factor=inif, max_contract=mc, fallback_repeats=rep,
              spec_width=sw)
    kw.update(overrides or {})
    return NSConfig(**kw)


def ladder(runners, n_pix, key, cfg, mode, device):
    """Both rungs from JAX key ``key``: the JAX script's ladder record."""
    import torch
    from nestfit_tpu_torch.sampling import fit_batch

    out = {}
    prev = null = None
    for n in (1, 2):
        gen = torch.Generator(device=device).manual_seed(10 * key + n)
        bench_torch.sync(device)
        t0 = time.perf_counter()
        r = fit_batch(gen, runners[n], n_pix, cfg,
                      segment_iters=SEGMENT_ITERS[mode], device=device)
        bench_torch.sync(device)
        wall = time.perf_counter() - t0
        lnz = r.lnz.cpu().numpy()
        if n == 1:
            null = r.null_lnz.cpu().numpy()
        floor = null if n == 1 else prev
        out[n] = {
            "wall_s": round(wall, 2),
            "evals_px": float(r.ns.ncall.cpu().numpy().astype(
                np.int64).mean()),
            "deaths_px": float(r.ns.n_dead.cpu().numpy().mean()),
            "lnz_mean": float(lnz.mean()),
            "floor_viol": int(np.sum(lnz < floor - FLOOR_NATS)),
            "conv": float(r.ns.converged.cpu().numpy().mean()),
        }
        if n == 1:
            out["d10_mean"] = float((lnz - null).mean())
        else:
            out["d21_mean"] = float((lnz - prev).mean())
            nbest = np.where(prev - null < THRESH, 0,
                             np.where(lnz - prev < THRESH, 1, 2))
            out["nbest_hist"] = np.bincount(nbest, minlength=3).tolist()
        prev = lnz
    out["ladder_wall_s"] = out[1]["wall_s"] + out[2]["wall_s"]
    return out


def sweep(combos, mode="segmented", device="cuda", out=None,
          n_pix=SWEEP_PIXELS, seed=SWEEP_SEED, timed=SWEEP_TIMED,
          overrides=None):
    """Yield one record per combo (those ``out`` holds without a fit)."""
    done = read_out(out, lambda rec: rec["combo"], n_pix=n_pix, mode=mode)
    card = card_or_none(device)
    log(f"sweep: device={device} mode={mode} n_pix={n_pix} "
        f"combos={combos}")
    runners = None
    for combo in combos:
        tag = combo_tag(combo)
        if tag in done:
            yield done[tag]
            continue
        if runners is None:
            runners = make_runners(n_pix, device, seed)
        kk, sbe, inif, mc, rep, _sw = combo
        cfg = combo_config(combo, overrides)
        t0 = time.perf_counter()
        warm = ladder(runners, n_pix, 0, cfg, mode, device)
        t_warm = time.perf_counter() - t0
        log(f"sweep: {tag} warmup {t_warm:.1f}s "
            f"(ladder {warm['ladder_wall_s']:.1f}s)")
        rec = {"combo": tag, "kill_k": kk, "slice_bound_every": sbe,
               "init_factor": inif, "max_contract": mc,
               "fallback_repeats": rep,
               "warmup_s": round(t_warm, 1), "warm": warm,
               "mode": mode, "n_pix": n_pix, "card": card}
        if timed:
            rec["timed"] = ladder(runners, n_pix, seed, cfg, mode, device)
            rec["fits_per_sec"] = round(
                n_pix / rec["timed"]["ladder_wall_s"], 2)
        if out:
            with open(out, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
        yield rec


def main(argv=None, environ=None):
    env = os.environ if environ is None else environ
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("combos", nargs="*")
    ap.add_argument("--mode", choices=sorted(SEGMENT_ITERS),
                    default="segmented")
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for rec in sweep(parse_combos(args.combos), args.mode, args.device,
                     args.out,
                     n_pix=int(env.get("SWEEP_PIXELS", SWEEP_PIXELS)),
                     seed=int(env.get("SWEEP_SEED", SWEEP_SEED)),
                     timed=env.get("SWEEP_TIMED", "1") != "0"):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
