"""The cube ladder's decisions, replayed pixel by pixel from the runs
that covered each pixel.

Copied from ``nestfit_tpu_torch/cube/fitter.py`` (``CubeFitter``:
``_fit_batch_ladder``, ``_fit_rung``, ``_refit_mode_losses``,
``_refine_boundary``; the defaults of the original NestFit cube fit).
Per pixel and rung, on the pixels that passed the rung before: the
first pass at the base live count; up to ``retries`` mode-loss refits
while the kept evidence lies below the nested-model floor ``prev -
margin`` (``null lnZ`` on rung 1), the first at the base live count and
later ones at ``mult`` x, each kept where it reports the higher
evidence; then, where the gain lies within ``band`` of the gate
``thresh``, one refit at ``mult`` x, which replaces it.  A pixel passes
the rung when its gain reaches the gate, and its ``nbest`` is the last
rung it passed.

:func:`replay` judges only what the ladder answers: for each pixel, the
runs that covered it at each rung, in the order they were made, however
they were grouped into calls; the record kept of each rung; and
``nbest``.  The comparisons are made in float32, the type of the
evidences the program reports, so that a gain at the gate rounds as it
did there.
"""

import numpy as np

f32 = np.float32


def replay(runs, records, nbest, pixels, base, rule):
    """Every place where the runs or the answers part from the rules.

    ``runs``: the runs in the order they were made, each a dict with
    ``ncomp``, ``nlive``, ``pixels`` (flat ids of its real rows) and per
    row ``lnz``, ``null``, ``lnz_err``, ``maxl``, ``ncall``, ``marg``,
    ``best``; ``records``: ``{(pixel, ncomp): (attrs, datasets)}`` as
    the ladder reported them; ``nbest``, ``base`` (the base live count):
    per pixel of ``pixels``; ``rule``: ``margin``, ``retries``, ``band``,
    ``thresh``, ``mult``, ``ncomp_max``.  Returns a list of strings,
    empty when everything follows the rules."""
    cover = {}
    for run in runs:
        for j, p in enumerate(run["pixels"]):
            cover.setdefault((int(p), run["ncomp"]), []).append((run, j))
    bad = []
    for i, p in enumerate(np.asarray(pixels).tolist()):
        want, prev = 0, None
        for ncomp in range(1, rule["ncomp_max"] + 1):
            seq = cover.pop((p, ncomp), [])
            if ncomp > want + 1:
                if seq:
                    bad.append(f"pixel {p} ncomp={ncomp}: {len(seq)} runs "
                               "after the pixel failed the gate")
                if (p, ncomp) in records:
                    bad.append(f"pixel {p} ncomp={ncomp}: a record the "
                               "rules do not ask for")
                continue
            lnz, prev, why = _rung(p, ncomp, seq, prev, int(base[i]), rule,
                                   records)
            bad += why
            if lnz is None:
                break
            if f32(lnz - prev) >= rule["thresh"]:
                want, prev = ncomp, lnz
        if int(nbest[i]) != want:
            bad.append(f"pixel {p}: nbest {int(nbest[i])}, the rule {want}")
    return bad


def _rung(p, ncomp, seq, prev, base, rule, records):
    """``(kept lnZ, the evidence it is gated against, mismatches)`` of
    pixel ``p`` at rung ``ncomp`` from its runs ``seq``; None for the
    lnZ where the runs part from the rules."""
    what = f"pixel {p} ncomp={ncomp}"
    it = iter(seq)

    def take(step, nlive):
        nxt = next(it, None)
        if nxt is None:
            return None, [f"{what}: no {step} run"]
        if nxt[0]["nlive"] != nlive:
            return None, [f"{what}: the {step} run has nlive="
                          f"{nxt[0]['nlive']}, the rule {nlive}"]
        return nxt, []

    kept, why = take("first pass", base)
    if kept is None:
        return None, prev, why
    lnz = f32(kept[0]["lnz"][kept[1]])
    if ncomp == 1:
        prev = f32(kept[0]["null"][kept[1]])
    floor = f32(prev - f32(rule["margin"]))
    for attempt in range(rule["retries"]):
        if not lnz < floor:
            break
        nl = base if attempt == 0 else rule["mult"] * base
        r, why = take(f"mode-loss retry {attempt + 1}", nl)
        if r is None:
            return None, prev, why
        lz = f32(r[0]["lnz"][r[1]])
        if lz > lnz:
            lnz, kept = lz, r
    if rule["band"] > 0 and rule["mult"] > 1 and \
            abs(f32(f32(lnz - prev) - f32(rule["thresh"]))) <= rule["band"]:
        r, why = take("boundary refit", rule["mult"] * base)
        if r is None:
            return None, prev, why
        lnz, kept = f32(r[0]["lnz"][r[1]]), r
    extra = sum(1 for _ in it)
    why = [f"{what}: {extra} runs the rules do not ask for"] if extra else []
    return lnz, prev, why + _record(what, records.get((p, ncomp)), *kept)


def _record(what, rec, r, j):
    """Where the record ``rec`` differs from row ``j`` of run ``r``."""
    if rec is None:
        return [f"{what}: no record"]
    attrs, arrays = rec
    bad = []
    for key, field in (("marginals", "marg"), ("bestfit_params", "best")):
        if not np.array_equal(arrays[key], r[field][j], equal_nan=True):
            bad.append(f"{what}: record {key} differs from the kept run's")
    for key, field in (("global_lnZ", "lnz"), ("global_lnZ_err", "lnz_err"),
                       ("max_loglike", "maxl"), ("n_calls", "ncall"),
                       ("null_lnZ", "null")):
        if float(attrs[key]) != float(r[field][j]):
            bad.append(f"{what}: record {key} {attrs[key]!r}, the kept "
                       f"run's {float(r[field][j])!r}")
    return bad
