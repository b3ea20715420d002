#!/usr/bin/env python3
"""Split the pixels a sampler selects as one component into physics and
sampler bias, against the sequential C++ engine.

The port's counterpart of ``validation/selection_sharpness.py``: the
nbest cross-tab of a sampler's nlive=100 across-seed lnZ medians against
the native nlive=400 medians (11-nat ladder rule), the split of the
sampler's nbest==1 pixels into those where the engine agrees (SNR-limited
physics) and those where it does not (candidate sampler bias), the
margin of the agreements and the truth signature of each disagreement.
:func:`crosstab` computes, :func:`render` writes the JAX script's
markdown; the labels carry the engine (``TPU`` for the JAX package's
record, ``GPU (<mode>)`` for the port's).

Usage: python validation_torch/selection_sharpness.py --agreement PATH
         --out PATH [--native PATH]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from validation_torch.outlier_postmortem import (  # noqa: E402
    LNZ_THRESH,
    NATIVE,
    engine_of,
    label,
    load,
    runs_of,
)


def crosstab(nat, agr):
    """The cross-tab and the nbest==1 split: a dict of ``rows`` (per
    pixel: both nbest, both bf21, the truth signature), ``tab`` ([3, 3],
    rows the sampler, columns the engine), ``agree`` (trace share),
    ``one`` (the sampler's nbest==1 rows), ``agree1``/``dis1`` (the
    engine agrees / disagrees) and ``close`` (agreements within 5 nats
    of the rule on the engine's side)."""
    t100 = runs_of(agr, 100)
    rows = []
    for key, rec in sorted(nat["records"].items(),
                           key=lambda kv: int(kv[0])):
        if key not in t100[0]:
            continue
        seeds = list(rec["seeds"].values())
        nat_med = {n: float(np.median([s[f"lnz{n}"] for s in seeds]))
                   for n in (1, 2)}
        null = t100[0][key]["null_lnz"]
        med = {n: float(np.median([r[key][f"lnz{n}"] for r in t100]))
               for n in (1, 2)}

        def nbest(lnz1, lnz2):
            if lnz1 - null < LNZ_THRESH:
                return 0
            return 1 if lnz2 - lnz1 < LNZ_THRESH else 2

        truth = agr["truth_params"].get(key)
        # truth signature: velocity separation and the narrower sigma
        vsep = smin = dntot = None
        if truth:
            t = np.asarray(truth, dtype=float)
            vsep = abs(t[1] - t[0])
            smin = min(t[8], t[9])
            dntot = t[7] - t[6]   # ntot difference (dex)
        rows.append({
            "pixel": int(key),
            "tpu_nbest": nbest(med[1], med[2]),
            "nat_nbest": nbest(nat_med[1], nat_med[2]),
            "tpu_bf21": med[2] - med[1],
            "nat_bf21": nat_med[2] - nat_med[1],
            "vsep": vsep, "sig_min": smin, "dntot": dntot,
        })
    tab = np.zeros((3, 3), dtype=int)
    for r in rows:
        tab[r["tpu_nbest"], r["nat_nbest"]] += 1
    one = [r for r in rows if r["tpu_nbest"] == 1]
    agree1 = [r for r in one if r["nat_nbest"] == 1]
    return {
        "rows": rows, "tab": tab,
        "agree": float(np.trace(tab)) / max(len(rows), 1),
        "one": one, "agree1": agree1,
        "dis1": [r for r in one if r["nat_nbest"] != 1],
        "close": [r for r in agree1
                  if abs(r["nat_bf21"] - LNZ_THRESH) < 5.0],
    }


def render(ct, engine="tpu", mode=None):
    """The cross-tab's markdown (the JAX script's layout)."""
    lab = label(engine, mode)
    md = [
        f"# Selection sharpness: {lab}==1 pixels, physics or bias?",
        "",
        f"Generated by `validation_torch/selection_sharpness.py` from the "
        f"committed artifacts ({len(ct['rows'])} pixels; native nlive=400 "
        f"medians vs {lab} nlive=100 across-seed medians; 11-nat ladder "
        "rule).",
        "",
        f"## nbest cross-tab (rows = {lab}, cols = native)",
        "",
        f"| {lab} \\ native | 0 | 1 | 2 |",
        "|---|---|---|---|",
    ]
    tab = ct["tab"]
    for i in range(3):
        md.append(f"| **{i}** | " + " | ".join(
            str(tab[i, j]) for j in range(3)) + " |")
    md += [
        "",
        f"Overall agreement: **{ct['agree']:.2f}**.",
        "",
        f"## The {lab}==1 split ({len(ct['one'])} pixels)",
        "",
        f"* native ALSO selects 1: **{len(ct['agree1'])}** -- SNR-limited "
        f"physics (the second component is genuinely below the 11-nat "
        f"evidence bar for both engines on this data realization).",
        f"* native selects differently: **{len(ct['dis1'])}** -- candidate "
        f"sampler bias; each listed below.",
        "",
    ]
    if ct["dis1"]:
        md += [
            f"| pixel | {lab} bf21 | native bf21 | vsep km/s | "
            "min sigma | dntot dex |",
            "|---|---|---|---|---|---|",
        ]
        for r in ct["dis1"]:
            md.append(
                f"| {r['pixel']} | {r['tpu_bf21']:.1f} | "
                f"{r['nat_bf21']:.1f} | {r['vsep']:.2f} | "
                f"{r['sig_min']:.2f} | {r['dntot']:+.2f} |")
        md.append("")
    md += [
        f"Of the physics-limited pixels, {len(ct['close'])} sit within 5 "
        f"nats of the 11-nat threshold on the NATIVE side too -- "
        f"seed-level evidence scatter flips those in either engine.",
        "",
        "## Reading",
        "",
    ]
    if engine != "tpu":
        md += ["The reading below is the JAX script's, written for its "
               "TPU record; the numbers above are this record's.", ""]
    md += [
        "The not-2 fraction is dominated by pixels where the native "
        "nlive=400 engine, on the same data, also refuses the second "
        "component: the synthetic cube draws many low-contrast pairs "
        "(small vsep, faint secondary) whose Bayes factor genuinely "
        "falls under 11 nats at this noise level.  The residual "
        "disagreements concentrate at narrow-sigma secondaries -- the "
        "mode-loss signature attacked by NSConfig.init_factor.  Note "
        "this artifact compares the RAW nlive=100 sampler (seed "
        "medians); the production path adds the boundary-band second "
        "pass at 2x nlive, which lifts the bench's live single-run "
        "agreement on the same pixels to 1.00 "
        "(native400_nbest_agree_frac).",
        "",
    ]
    return "\n".join(md)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--agreement", required=True,
                    help="agreement record (JSON)")
    ap.add_argument("--out", required=True, help="markdown to write")
    ap.add_argument("--native", default=NATIVE,
                    help="native-engine truth (JSON)")
    args = ap.parse_args(argv)
    nat, agr = load(args.native, args.agreement)
    ct = crosstab(nat, agr)
    with open(args.out, "w") as fh:
        fh.write(render(ct, *engine_of(agr)))
    print(f"wrote {args.out}: agreement {ct['agree']:.3f}, "
          f"{label(*engine_of(agr))}==1 {len(ct['one'])} (physics "
          f"{len(ct['agree1'])}, disagree {len(ct['dis1'])})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
