#!/usr/bin/env python3
"""Classify every large-sigma evidence disagreement between a batched
sampler's agreement record and the sequential C++ engine.

The port's counterpart of ``validation/outlier_postmortem.py``, with its
thresholds, error model, rules and classes, split into :func:`load`,
:func:`classify` and :func:`render`.  Inputs:

* the native truth (``validation/native_truth_seed5.json``): the
  sequential engine's nlive=400 lnZ, joint placement prior;
* an agreement record on the same pixels: the JAX package's TPU record
  (``validation/tpu_agreement_seed5.json``) or the port's
  (``validation_torch/agreement.py``, ``gpu_agreement_seed5_<mode>.json``)
  -- nlive=100 multi-seed plus nlive=400 runs.

For every per-rung record with ``|dz|/sigma > 10`` (``bench.py``'s
outlier bound) the postmortem gives one class:

* ``rung1-misfit-islands``: the rung-1 model fits neither engine's data
  and both select nbest=2 by more than three times the 11-nat rule;
* ``<engine>-undersampled-at-nlive100``: the sampler's nlive=400 median
  agrees with the native truth within 3 sigma (live-set resolution);
* ``baseline-seed-scatter``: the native engine's own across-seed scatter
  on this pixel exceeds a third of the deviation;
* ``sampler-mode-loss``: the sampler's median sits LOW of the native
  truth beyond all the above -- a failure to fix, not to explain;
* ``unexplained``: none of the above -- also a failure.

``<engine>`` is ``tpu`` for a record without a ``mode`` (the JAX
package's) and ``gpu`` for the port's; the markdown's labels carry the
engine and, for the port, the sampler mode.  Exits 1 if any record lands
in the last two classes.

Usage: python validation_torch/outlier_postmortem.py --agreement PATH
         --out PATH [--native PATH]
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(ROOT, "validation", "native_truth_seed5.json")
LNZ_THRESH = 11.0
OUTLIER_SIGMA = 10.0
SIGMA_FLOOR = 0.3
FAILURES = ("sampler-mode-loss", "unexplained")


def load(native_path=NATIVE, agreement_path=None):
    """The native truth and the agreement record, ``(nat, agr)``; raises
    ``ValueError`` when they were made on different cubes."""
    with open(native_path) as fh:
        nat = json.load(fh)
    with open(agreement_path) as fh:
        agr = json.load(fh)
    if nat["cube_checksum"] != agr["cube_checksum"]:
        raise ValueError(f"cube mismatch: native {nat['cube_checksum']}, "
                         f"agreement {agr['cube_checksum']}")
    return nat, agr


def engine_of(agr):
    """``(engine, mode)`` of an agreement record: the port's records carry
    their sampler mode, the JAX package's TPU record none."""
    mode = agr.get("mode")
    return ("gpu" if mode else "tpu"), mode


def label(engine, mode=None):
    """The sampler's name in the markdown: ``TPU``, ``GPU (traced)``."""
    return engine.upper() + (f" ({mode})" if mode else "")


def seed_scatter_model(recs):
    """The native engine's pooled across-seed scatter by rung: the median
    over its multi-seed pixels of the lnZ standard deviation."""
    scat = {1: [], 2: []}
    for rec in recs.values():
        seeds = list(rec["seeds"].values())
        if len(seeds) >= 2:
            for n in (1, 2):
                scat[n].append(np.std([s[f"lnz{n}"] for s in seeds],
                                      ddof=1))
    return {n: float(np.median(scat[n])) if scat[n] else 0.0
            for n in (1, 2)}


def runs_of(agr, nlive):
    """The agreement record's runs at ``nlive``, in record order."""
    return [v for k, v in agr["runs"].items()
            if k.startswith(f"nlive{nlive}")]


def classify(nat, agr, engine="tpu"):
    """Every per-rung record of the pixels both artifacts hold, and the
    classified outliers: ``(rows, outliers, s_model)``.  Each row holds
    ``dz_sigma`` (the nlive=100 seed median against the native median in
    sigma), the medians, scatters and the nbest decisions; an outlier row
    also its ``class``."""
    recs = nat["records"]
    s_model = seed_scatter_model(recs)
    t100, t400 = runs_of(agr, 100), runs_of(agr, 400)

    rows, outliers = [], []
    for i, rec in sorted(recs.items(), key=lambda kv: int(kv[0])):
        seeds = list(rec["seeds"].values())
        nat_med = {n: float(np.median([s[f"lnz{n}"] for s in seeds]))
                   for n in (1, 2)}
        nat_err = {n: float(np.median([s[f"lnz{n}_err"] for s in seeds]))
                   for n in (1, 2)}
        nat_scat = {
            n: (float(np.std([s[f"lnz{n}"] for s in seeds], ddof=1))
                if len(seeds) >= 2 else None)
            for n in (1, 2)
        }
        if not t100 or i not in t100[0]:
            continue
        null = t100[0][i]["null_lnz"]
        nat_nbest = 0 if nat_med[1] - null < LNZ_THRESH else (
            1 if nat_med[2] - nat_med[1] < LNZ_THRESH else 2)
        med100 = [float(np.median([r[i]["lnz1"] for r in t100])),
                  float(np.median([r[i]["lnz2"] for r in t100]))]
        nbest = 0 if med100[0] - null < LNZ_THRESH else (
            1 if med100[1] - med100[0] < LNZ_THRESH else 2)
        for n in (1, 2):
            tv = [r[i][f"lnz{n}"] for r in t100 if i in r]
            med = float(np.median(tv))
            scat = float(np.std(tv, ddof=1)) if len(tv) >= 2 else 0.0
            sig = max(float(np.sqrt(nat_err[n] ** 2 + s_model[n] ** 2)),
                      SIGMA_FLOOR)
            dz = (med - nat_med[n]) / sig
            t4v = [float(r[i][f"lnz{n}"]) for r in t400 if i in r]
            t4 = float(np.median(t4v)) if t4v else None
            row = {
                "pixel": int(i), "rung": n, "dz_sigma": dz,
                "tpu_med": med, "tpu_scat": scat,
                "nat_med": nat_med[n], "nat_err": nat_err[n],
                "nat_scat": nat_scat[n], "sigma": sig,
                "tpu_nlive400": t4,
                "tpu_nbest": nbest, "nat_nbest": nat_nbest,
                "truth": agr["truth_params"].get(i),
            }
            rows.append(row)
            if abs(dz) <= OUTLIER_SIGMA:
                continue
            bf = med100[1] - med100[0]
            bf_nat = nat_med[2] - nat_med[1]
            if (n == 1 and nbest == nat_nbest == 2
                    and bf > 3 * LNZ_THRESH and bf_nat > 3 * LNZ_THRESH):
                cls = "rung1-misfit-islands"
            elif t4 is not None and abs(t4 - nat_med[n]) < 3 * sig:
                cls = f"{engine}-undersampled-at-nlive100"
            elif (nat_scat[n] is not None
                  and abs(med - nat_med[n]) < 3 * nat_scat[n]):
                cls = "baseline-seed-scatter"
            elif med < nat_med[n]:
                cls = "sampler-mode-loss"
            else:
                cls = "unexplained"
            row["class"] = cls
            outliers.append(row)
    return rows, outliers, s_model


def failures(outliers):
    """The outliers that no benign class explains."""
    return [r for r in outliers if r["class"] in FAILURES]


def render(nat, agr, rows, outliers, s_model, engine="tpu", mode=None):
    """The postmortem's markdown (the JAX script's layout)."""
    lab = label(engine, mode)
    n100, n400 = len(runs_of(agr, 100)), len(runs_of(agr, 400))
    md = [
        f"# Outlier postmortem: {lab} sampler vs sequential C++ engine",
        "",
        f"Generated by `validation_torch/outlier_postmortem.py` from "
        f"{len(rows)} per-rung records on "
        f"{len(set(r['pixel'] for r in rows))} pixels "
        f"(native nlive={nat['nlive']}, joint placement prior; "
        f"{lab} nlive=100 x {n100} seeds + nlive=400 x {n400}).",
        "",
        f"Pooled native seed scatter: lnZ1 {s_model[1]:.3f}, "
        f"lnZ2 {s_model[2]:.3f} nats.",
        "",
        f"Records with |dz|/sigma > {OUTLIER_SIGMA:.0f}: "
        f"{len(outliers)} / {len(rows)} "
        f"({100 * len(outliers) / max(len(rows), 1):.1f}%).",
        "",
        f"| pixel | rung | dz/sigma | {lab} median | native median | "
        f"{lab}@400 | class |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in outliers:
        t4s = f"{r['tpu_nlive400']:.1f}" if r["tpu_nlive400"] is not None \
            else "-"
        md.append(
            f"| {r['pixel']} | {r['rung']} | {r['dz_sigma']:+.1f} | "
            f"{r['tpu_med']:.1f} | {r['nat_med']:.1f} | {t4s} | "
            f"**{r['class']}** |"
        )
    md.append("")
    for r in outliers:
        md += [
            f"## pixel {r['pixel']}, rung {r['rung']} -- {r['class']}",
            "",
            f"* dz/sigma = {r['dz_sigma']:+.1f} "
            f"(sigma = {r['sigma']:.3f}; native quoted err "
            f"{r['nat_err']:.3f}, pooled seed scatter folded in)",
            f"* {lab} nlive=100 median {r['tpu_med']:.2f} "
            f"(seed scatter {r['tpu_scat']:.2f}); "
            f"{lab} nlive=400 "
            + (f"{r['tpu_nlive400']:.2f}" if r["tpu_nlive400"] is not None
               else "n/a"),
            f"* native nlive=400 median {r['nat_med']:.2f}"
            + (f" (seed scatter {r['nat_scat']:.2f})"
               if r["nat_scat"] is not None else ""),
            f"* model selection: {lab} nbest={r['tpu_nbest']}, "
            f"native nbest={r['nat_nbest']}",
            f"* truth params (param-major [voff trot tex ntot sigm "
            f"orth] x 2 comps): {r['truth']}",
            "",
        ]
    bad = failures(outliers)
    md += [
        "## Verdict",
        "",
        ("All outliers are classified as benign (rung-1 misfit islands, "
         "nlive resolution, or baseline scatter)." if not bad else
         f"**{len(bad)} record(s) are NOT explained** -- fix the "
         "sampler, do not widen the gate."),
        "",
    ]
    return "\n".join(md)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--agreement", required=True,
                    help="agreement record (JSON) to classify")
    ap.add_argument("--out", required=True, help="markdown to write")
    ap.add_argument("--native", default=NATIVE,
                    help="native-engine truth (JSON)")
    args = ap.parse_args(argv)
    nat, agr = load(args.native, args.agreement)
    engine, mode = engine_of(agr)
    rows, outliers, s_model = classify(nat, agr, engine)
    with open(args.out, "w") as fh:
        fh.write(render(nat, agr, rows, outliers, s_model, engine, mode))
    bad = failures(outliers)
    med = float(np.median([abs(r["dz_sigma"]) for r in rows]))
    print(f"wrote {args.out}: {len(outliers)} outliers, {len(bad)} "
          f"unexplained; |dz|/sigma median {med:.3f} over {len(rows)} "
          "records")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
