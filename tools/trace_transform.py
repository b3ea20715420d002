#!/usr/bin/env python3
"""Trace where the kernel prior transform and the plain one part, on a card.

For each forward case of ``chip_smoke.py`` (NH3, Gaussian, N2H+ at
ncomp 2 and ``--seed``), the same unit cube goes through
``runner.transform(u)`` (kernels K2 ``table_lerp`` and K3
``tapered_invert``) and ``runner.transform(u, plain=True)`` (their plain
PyTorch versions), and the two are compared bit for bit.  For the pixel
whose log-likelihood differs most, each step of the centroid placement
is printed on both paths: the width (K2), the interval ``[v_lo, v_hi]``
handed to each K3 launch, its grid cells ``i_lo``/``i_hi`` by true
division and by the product with the rounded reciprocal, K3's result
and the cell it lies in, and K3 run on the plain path's own inputs.
Last, it counts how often the card's ``x / dx`` (a Python float) and
``dx / x`` differ from true float32 division.

Run from the root of a tree::

    python3 tools/trace_transform.py --seed 1
    python3 tools/trace_transform.py --seed 1 --tree scratch/parent

``--tree`` imports the port's package from another tree (for example a
parent commit unpacked with ``git archive``) and drives it with this
tree's forward cases.
"""

import argparse
import importlib.util
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def bits(x):
    """A float32 value with its bit pattern."""
    v = np.float32(x)
    return f"{float(v):.9g} (0x{v.view(np.uint32):08x})"


def k3_args(args):
    """``(u, x_lo, x_hi, sfact)`` of a K3 call in either signature:
    ``(t0, t1c, t2c, xax, u, x_lo, x_hi, sfact, ...)`` or
    ``(dist, u, x_lo, x_hi, sfact)``."""
    if len(args) >= 12:
        return args[4], args[5], args[6], int(args[7])
    return args[1], args[2], args[3], int(args[4])


def capture(tables, name, log):
    """Replace ``tables.<name>`` by a wrapper that records its calls."""
    fn = getattr(tables, name)

    def rec(*args):
        out = fn(*args)
        log.append((args, out.clone()))
        return out

    # the wrapper counts launches through the module's name, now ``rec``
    rec.launches = 0
    setattr(tables, name, rec)
    return fn


def cells(x, xmin, dx):
    """Grid cell of ``x``: float64, float32 true division, float32
    product with the rounded reciprocal (what the card does for a
    tensor divided by a Python float)."""
    x = np.float32(x)
    d = np.float32(x - np.float32(xmin))
    return (f"f64 {(float(x) - xmin) / dx:.7f}, "
            f"true div {np.float32(d / np.float32(dx)):.7f}, "
            f"recip {np.float32(d * (np.float32(1) / np.float32(dx))):.7f}")


def trace_case(label, runner, u, tables):
    import torch

    k3_log, plain_log = [], []
    k3 = capture(tables, "tapered_invert", k3_log)
    plain = capture(tables, "tapered_invert_plain", plain_log)
    try:
        theta = runner.transform(u)
        want = runner.transform(u, plain=True)
    finally:
        tables.tapered_invert, tables.tapered_invert_plain = k3, plain
    lnl = runner.log_likelihood(theta)
    lnl_plain = runner.log_likelihood(want, plain=True)
    torch.cuda.synchronize()
    n_param, ncomp = runner.n_model, runner.ncomp
    diff = (theta != want).reshape(-1, n_param, ncomp)
    print(f"{label}: {int(diff.any(-1).any(-1).sum())} of {u.shape[0]} "
          f"pixels differ; differing entries by parameter row: "
          f"{diff.sum(dim=(0, 2)).tolist()}; lnL max |err| "
          f"{(lnl - lnl_plain).abs().max().item():.4g}", flush=True)
    if not diff.any():
        return
    p = int((lnl - lnl_plain).abs().argmax())
    prior = runner.utrans.priors[0]
    dist = prior.vcen_prior.dist
    ix_s = prior.sigm_prior.p_ix
    th_k = theta[p].reshape(n_param, ncomp).cpu().numpy()
    th_p = want[p].reshape(n_param, ncomp).cpu().numpy()
    print(f"  pixel {p}: lnL kernel {lnl[p].item():.6f}, plain "
          f"{lnl_plain[p].item():.6f}", flush=True)
    print(f"  u = {u[p].cpu().numpy().tolist()}", flush=True)
    for c in range(ncomp):
        print(f"  sigm[{c}] (K2): kernel {bits(th_k[ix_s, c])}, plain "
              f"{bits(th_p[ix_s, c])}", flush=True)
    print(f"  grid: xmin {dist.xmin!r}, dx {dist.dx!r}, N {dist.size}",
          flush=True)
    for (ka, kout), (pa, pout) in zip(k3_log, plain_log):
        ku, klo, khi, sf = (a.reshape(-1)[p].item() if hasattr(a, "reshape")
                            else a for a in k3_args(ka))
        pu, plo, phi, _ = (a.reshape(-1)[p].item() if hasattr(a, "reshape")
                           else a for a in k3_args(pa))
        ko, po = kout.reshape(-1)[p].item(), pout.reshape(-1)[p].item()
        # K3 on the plain path's own inputs separates K3 from what fed it
        ku_t, klo_t, khi_t = (a.reshape(-1)[p:p + 1].contiguous()
                              for a in k3_args(pa)[:3])
        args = list(pa)
        if len(args) >= 12:
            args[4:7] = ku_t, klo_t, khi_t
        else:
            args[1:4] = ku_t, klo_t, khi_t
        own = k3(*args).item()
        print(f"  K3 sfact {sf}:", flush=True)
        for tag, uu, lo, hi, out in (("kernel", ku, klo, khi, ko),
                                     ("plain ", pu, plo, phi, po)):
            print(f"    {tag} u {bits(uu)}, v_lo {bits(lo)}, v_hi "
                  f"{bits(hi)}", flush=True)
            print(f"      i_lo: {cells(min(lo, hi), dist.xmin, dist.dx)}",
                  flush=True)
            print(f"      i_hi: {cells(max(lo, hi), dist.xmin, dist.dx)}",
                  flush=True)
            print(f"      out {bits(out)}, cell "
                  f"{(out - dist.xmin) / dist.dx:.4f}", flush=True)
        print(f"    K3 kernel on the plain path's inputs: {bits(own)} "
              f"({'equal to' if own == po else 'differs from'} plain)",
              flush=True)


def division_check(dx):
    import torch

    x = torch.rand(1 << 20, device="cuda") * 8 - 4
    dx32 = torch.tensor(dx, dtype=torch.float32, device="cuda")
    d = x + 2.0
    by_float = x / dx
    by_tensor = x / dx32
    rdiv = dx / d
    true_rdiv = dx32 / d
    torch.cuda.synchronize()
    print(f"division on the card, 2^20 float32 values: x / dx (Python "
          f"float) differs from x / dx (0-dim tensor) in "
          f"{int((by_float != by_tensor).sum())}; dx / x (Python float, "
          f"Tensor.__rdiv__) from the tensor division in "
          f"{int((rdiv != true_rdiv).sum())}; x * fl(1/dx) equals x / dx "
          f"(Python float) in "
          f"{bool(torch.equal(by_float, x * (1.0 / dx32)))} ", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="tree whose nestfit_tpu_torch is traced")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("trace_transform: needs a CUDA card")
    from nestfit_tpu_torch.ops import tables

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    print(f"tree {args.tree} (package {tables.__file__}), seed {args.seed}, "
          f"card {smoke.smi('name,power.limit')}", flush=True)
    dx = None
    for label, runner, u in smoke.forward_cases(args.seed):
        trace_case(label, runner, u, tables)
        dx = runner.utrans.priors[0].vcen_prior.dist.dx
    division_check(dx)


if __name__ == "__main__":
    main()
