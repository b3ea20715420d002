"""Readings that set the limits of the output checks of a cell.

    python3 benchmark/control.py --workload <cell> --seeds <s1,s2,...>
        [--control-seeds <n>] [--seconds <s>] [--out <file.jsonl>]

For each seed, one run of the cell as ``run.py`` makes it (set-up,
window, check), all in one process; for the first ``--control-seeds``
seeds, the control as well: the reference in bfloat16 put in the
program's place on the same points (``core/check.py``).  One JSON line
per seed: the program's numbers, the control's, and the run's
``correct``.  The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.cache_env()
    import torch

    from core import manifest

    cell = manifest.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        result, control = run.run_cell(
            cell, seed, args.seconds, t_proc=t0,
            control_dtype=torch.bfloat16 if k < args.control_seeds else None)
        line = json.dumps(dict(
            workload=args.workload, seed=seed, correct=result["correct"],
            program={c: v["value"] for c, v in result["checks"].items()},
            control=control, metrics=result["metrics"],
            wall_s=time.time() - t0))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
