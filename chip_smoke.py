#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nestfit_tpu_torch``) on one NVIDIA card.

Phases, in order; any failure exits non-zero:

1. device   -- require CUDA; print the card's name and power limit.
2. build    -- compile the three Hopper kernels from ``nestfit_tpu_torch/
               csrc`` (one ``nvcc`` per source, in parallel).
3. kernels  -- hold K1 ``hf_chi2_fused``, K2 ``table_lerp`` and K3
               ``tapered_invert`` against their plain PyTorch versions on
               the same CUDA tensors at main-path shapes, and time them
               (kernel, plain version, library call): device time per
               call from ``torch.profiler``, and per-call time with CUDA
               events, which also counts host gaps between launches.
4. forward  -- ``loglike_unit`` at 256 px x 384 ch, ncomp 2, both
               transitions: kernel path against plain path on the card.
5. ladder   -- ``fit_batch`` on a seeded synthetic NH3 (1,1)+(2,2) cube
               (``--pixels``, default 1024; noise 0.15), ncomp 1 then 2,
               nlive 100, tol 1.0, init_factor 4, segment_iters 250.  The
               kernels' launch counters are set to 0 before each rung and
               must have risen after it.
6. profile  -- only with ``--profile N``: the rung of ncomp N again under
               ``torch.profiler``: device time by kernel, busy share.

The line before last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Run from the repository root:
``python3 chip_smoke.py``.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SFU_EXP_PER_CLOCK_PER_SM = 16


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps, warmup=3):
    """``(device_ms, call_ms)`` per call of ``fn`` over ``reps`` calls
    after ``warmup``: the device time of the kernels it launched
    (``torch.profiler``), and the CUDA-event time per call, which also
    holds any gap the host leaves between launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    dev_us = sum(
        getattr(ev, "self_device_time_total",
                getattr(ev, "self_cuda_time_total", 0))
        for ev in prof.key_averages()
        if ev.device_type == torch.autograd.DeviceType.CUDA)
    return dev_us / 1e3 / reps, start.elapsed_time(end) / reps


def make_runner(xa, data, noise, ncomp, utrans):
    import torch
    from nestfit_tpu_torch.models import AmmoniaRunner, ammonia

    spectra = [
        ammonia.make_ammonia_spectrum(
            x, d, np.full(d.shape[0], noise), trans_id=tid, device="cuda")
        for tid, (x, d) in enumerate(zip(xa, data), start=1)
    ]
    assert all(s.noise.dtype == torch.float32 for s in spectra)
    return AmmoniaRunner(spectra, utrans, ncomp=ncomp, device="cuda")


def phase_kernels(seed, n_sm, clock_hz):
    """Hold each kernel against its plain version; returns the kernel
    records of the JSON line (without their launch counts)."""
    import torch
    from nestfit_tpu_torch.models import ammonia
    from nestfit_tpu_torch.ops import fused, tables
    from nestfit_tpu_torch.priors import get_irdc_priors
    from nestfit_tpu_torch.synth import make_synth_cube_arrays

    rng = np.random.default_rng(seed)
    records = {}
    utrans = get_irdc_priors(device="cuda")

    # ---- K1 at the D=12 candidate round: T = n_cand = 50, R = 1024
    R, T, S = 1024, 50, 380
    (xa11, d11), (xa22, d22), _ = make_synth_cube_arrays(
        n_pix=R, noise=0.15, rng=np.random.default_rng(seed))
    worst, timing = 0.0, None
    for ncomp in (1, 2):
        runner = make_runner((xa11, xa22), (d11, d22), 0.15, ncomp, utrans)
        u = torch.as_tensor(rng.uniform(size=(T, R, 6 * ncomp)),
                            dtype=torch.float32, device="cuda")
        flat = runner.transform(u, plain=True).reshape(T * R, -1)
        for spec in runner.spectra:
            trans, voff, tex, tau0, sigm = ammonia._component_params(
                spec, flat, False, False)
            args = (trans, spec.dnu, spec.t0, spec.tbg, spec.data,
                    *(x.contiguous() for x in (voff, tex, tau0, sigm)))
            got = fused.hf_chi2_fused(*args)
            want = fused.hf_chi2_plain(*args)
            torch.cuda.synchronize()
            err = (got - want).abs()
            tol = 1e-3 + 2e-4 * want.abs()
            print(f"K1 hf_chi2_fused ncomp={ncomp} trans={spec.trans_id} "
                  f"B={T * R}: max_abs_err={err.max().item():.3e} "
                  f"max_err/tol={(err / tol).max().item():.3f}", flush=True)
            if not bool(torch.all(err <= tol)) or not bool(
                    torch.isfinite(got).all()):
                fail(f"K1 disagrees with its plain version (ncomp={ncomp}, "
                     f"trans={spec.trans_id})")
            worst = max(worst, err.max().item())
            if ncomp == 2 and spec.trans_id == 1:
                timing = args
    B, C, nhf = T * R, 2, timing[0].nhf
    ms, call = time_ms(lambda: fused.hf_chi2_fused(*timing), 20)
    plain_ms, _ = time_ms(lambda: fused.hf_chi2_plain(*timing), 3, warmup=1)
    n_exp = B * C * S * (nhf + 2)
    t_exp = n_exp / (SFU_EXP_PER_CLOCK_PER_SM * n_sm * clock_hz)
    t_fma = B * C * S * nhf * 8 * 2 / FP32_FLOP_PER_S
    n_bytes = 4 * (4 * B * C + R * S + 3 * S + 3 * nhf + B)
    t_mem = n_bytes / HBM_BYTES_PER_S
    t_ops = max(t_exp, t_fma)
    records["hf_chi2_fused"] = dict(
        name="hf_chi2_fused", route="cuda",
        source="nestfit_tpu_torch/csrc/hf_chi2.cu",
        replaces="nestfit_tpu/ops/fused.py:159",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_mem) * 1e3,
        bound_by="operations" if t_ops >= t_mem else "bytes",
        library_ms=None)
    print(f"K1 timing (ncomp=2, (1,1), B={B}): kernel {ms:.4f} ms "
          f"(per call {call:.4f} ms), plain "
          f"{plain_ms:.3f} ms, bound "
          f"{records['hf_chi2_fused']['bound_ms']:.4f} ms ({n_exp:.3e} exp "
          f"at {clock_hz / 1e6:.0f} MHz)", flush=True)

    # ---- K2: the trot PPF (N = 500) at ~1e6 positions, plus endpoints
    dist = utrans.priors[1].dist
    N = dist.size
    scaled = torch.as_tensor(rng.uniform(0, N - 1, size=1 << 20),
                             dtype=torch.float32, device="cuda")
    got = tables.table_lerp(dist.ppf, scaled)
    want = tables.table_lerp_plain(dist.ppf, scaled)
    ends = tables.table_lerp(dist.ppf, torch.tensor(
        [0.0, N - 1.0], device="cuda"))
    torch.cuda.synchronize()
    err = (got - want).abs()
    print(f"K2 table_lerp B={scaled.numel()}: max_abs_err="
          f"{err.max().item():.3e}", flush=True)
    if not bool(torch.all(err <= 2e-6 + 2e-6 * want.abs())):
        fail("K2 disagrees with its plain version")
    if not torch.equal(ends, dist.ppf[[0, N - 1]]):
        fail(f"K2 endpoints not exact: {ends.tolist()}")
    ms, call = time_ms(lambda: tables.table_lerp(dist.ppf, scaled), 50)
    plain_ms, _ = time_ms(lambda: tables.table_lerp_plain(dist.ppf, scaled),
                          20)
    # the library yardstick: grid_sample (bilinear, align_corners) on the
    # table as a 1 x N image is the same lerp; its grid is built up front
    grid = torch.stack([scaled / (N - 1) * 2 - 1, torch.zeros_like(scaled)],
                       dim=-1)[None, None]
    img = dist.ppf[None, None, None, :]

    def lib():
        return torch.nn.functional.grid_sample(
            img, grid, mode="bilinear", padding_mode="border",
            align_corners=True)

    lib_err = (lib().reshape(-1) - want).abs().max().item()
    library_ms, _ = time_ms(lib, 50)
    n_bytes = 8 * scaled.numel() + 4 * N
    records["table_lerp"] = dict(
        name="table_lerp", route="cuda",
        source="nestfit_tpu_torch/csrc/table_lerp.cu",
        replaces="nestfit_tpu/ops/tables.py:81",
        max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
        bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=library_ms)
    print(f"K2 timing: kernel {ms:.4f} ms (per call {call:.4f} ms), plain "
          f"{plain_ms:.4f} ms, "
          f"grid_sample {library_ms:.4f} ms (err {lib_err:.2e})", flush=True)

    # ---- K3: voff placement tables, sfact 0/1/2, B ~ 1e5
    dist = utrans.priors[0].vcen_prior.dist
    B = 1 << 17
    lo = rng.uniform(-4, 3, size=B)
    hi = lo + rng.uniform(0.005, 6, size=B)
    cols = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
            for a in (rng.uniform(size=B), lo, hi)]
    worst = 0.0
    for sf in (0, 1, 2):
        args = (dist.t0, dist.t1c, dist.t2c, dist.xax, *cols, sf, dist.size,
                dist.xmin, dist.dx, dist.center)
        got = tables.tapered_invert(*args)
        want = tables.tapered_invert_plain(*args)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        print(f"K3 tapered_invert sfact={sf} B={B}: max_abs_err={e:.3e} "
              f"(bar {0.51 * dist.dx:.3e})", flush=True)
        if not e < 0.51 * dist.dx or not bool(torch.isfinite(got).all()):
            fail(f"K3 disagrees with its plain version (sfact={sf})")
        worst = max(worst, e)
        if sf == 1:
            timing = args
    ms, call = time_ms(lambda: tables.tapered_invert(*timing), 50)
    plain_ms, _ = time_ms(lambda: tables.tapered_invert_plain(*timing), 10)
    n_bytes = 16 * B + 16 * dist.size
    records["tapered_invert"] = dict(
        name="tapered_invert", route="cuda",
        source="nestfit_tpu_torch/csrc/tapered_invert.cu",
        replaces="nestfit_tpu/ops/tables.py:199",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None)
    print(f"K3 timing (sfact=1): kernel {ms:.4f} ms (per call {call:.4f} "
          f"ms), plain {plain_ms:.4f} ms", flush=True)
    return records


def phase_forward(seed):
    """The forward step at the ``__graft_entry__.entry()`` shapes."""
    import torch
    from nestfit_tpu_torch.models.tables import AMMONIA_TRANSITIONS
    from nestfit_tpu_torch.priors import get_irdc_priors
    from nestfit_tpu_torch.utils import freq_axis_from_velocity

    n_pix, n_chan, ncomp = 256, 384, 2
    rng = np.random.default_rng(seed)
    vaxis = np.linspace(-30, 30, n_chan)
    xa = [freq_axis_from_velocity(vaxis, AMMONIA_TRANSITIONS[t].nu)
          for t in (0, 1)]
    data = [rng.normal(scale=0.2, size=(n_pix, n_chan)) for _ in (0, 1)]
    runner = make_runner(xa, data, 0.2, ncomp, get_irdc_priors(device="cuda"))
    u = np.clip(0.5 + rng.normal(scale=0.1, size=(n_pix, 6 * ncomp)), 0, 1)
    u = torch.as_tensor(u, dtype=torch.float32, device="cuda")
    got = runner.loglike_unit(u)
    want = runner.loglike_unit(u, plain=True)
    torch.cuda.synchronize()
    if got.shape != (n_pix,) or not bool(torch.isfinite(got).all()):
        fail(f"forward step: bad lnL {tuple(got.shape)}")
    err = (got - want).abs()
    tol = 5e-2 + 2e-4 * want.abs()
    print(f"forward: loglike_unit {n_pix} px x {n_chan} ch ncomp={ncomp}: "
          f"max_abs_err={err.max().item():.3e} "
          f"max_err/tol={(err / tol).max().item():.3f}", flush=True)
    if not bool(torch.all(err <= tol)):
        fail("forward step: kernel path disagrees with plain path")


def phase_ladder(seed, n_pix, counters):
    import torch
    from nestfit_tpu_torch.priors import get_irdc_priors
    from nestfit_tpu_torch.sampling import NSConfig, fit_batch
    from nestfit_tpu_torch.synth import make_synth_cube_arrays

    noise = 0.15
    (xa11, d11), (xa22, d22), _ = make_synth_cube_arrays(
        n_pix=n_pix, noise=noise, rng=np.random.default_rng(seed))
    utrans = get_irdc_priors(device="cuda")
    cfg = NSConfig(nlive=100, tol=1.0, init_factor=4)
    lnz, launches = {}, {}
    for ncomp in (1, 2):
        runner = make_runner((xa11, xa22), (d11, d22), noise, ncomp, utrans)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed + ncomp)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = fit_batch(gen, runner, n_pix, cfg, segment_iters=250,
                        device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[ncomp] = {k: fn.launches for k, fn in counters.items()}
        z = fit.lnz.cpu().numpy()
        ncall = fit.ns.ncall.cpu().numpy().astype(np.int64)
        conv = fit.ns.converged.cpu().numpy()
        lnz[ncomp] = z
        print(f"ladder rung ncomp={ncomp} R={n_pix}: wall {wall:.2f} s, "
              f"evals/px {ncall.mean():.1f}, converged {int(conv.sum())}/"
              f"{n_pix}, lnZ median {np.median(z):.3f}, kernels "
              f"{json.dumps(launches[ncomp])}", flush=True)
        if not conv.all():
            fail(f"rung {ncomp}: {int((~conv).sum())} runs not converged")
        if not np.isfinite(z).all():
            fail(f"rung {ncomp}: non-finite lnZ")
        post = fit.products.posteriors
        if not bool(torch.isfinite(post).all()) or post.shape[0] != n_pix:
            fail(f"rung {ncomp}: bad posterior samples")
        need = ["hf_chi2_fused", "table_lerp"] + (
            ["tapered_invert"] if ncomp == 2 else [])
        for k in need:
            if launches[ncomp][k] <= 0:
                fail(f"rung {ncomp}: kernel {k} never launched")
    gain = lnz[2] - lnz[1]
    print(f"ladder: median lnZ2 - lnZ1 = {np.median(gain):.3f} over "
          f"{n_pix} two-component truth pixels", flush=True)
    if not np.median(gain) > 0:
        fail("ladder: median lnZ2 - lnZ1 is not positive")
    return {k: launches[1][k] + launches[2][k] for k in counters}


def phase_profile(seed, n_pix, ncomp):
    """One rung under ``torch.profiler``: device time by kernel and the
    device's busy share of the rung wall (the profiler's own host cost
    lengthens the wall, so the share is a lower bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nestfit_tpu_torch.priors import get_irdc_priors
    from nestfit_tpu_torch.sampling import NSConfig, fit_batch
    from nestfit_tpu_torch.synth import make_synth_cube_arrays

    (xa11, d11), (xa22, d22), _ = make_synth_cube_arrays(
        n_pix=n_pix, noise=0.15, rng=np.random.default_rng(seed))
    runner = make_runner((xa11, xa22), (d11, d22), 0.15, ncomp,
                         get_irdc_priors(device="cuda"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + ncomp)
    cfg = NSConfig(nlive=100, tol=1.0, init_factor=4)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit_batch(gen, runner, n_pix, cfg, segment_iters=250, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        # kernel events only: an operator's row repeats its kernels' time
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"profile rung ncomp={ncomp} R={n_pix}: wall {wall:.2f} s under "
          f"the profiler, device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f}%)", flush=True)
    for dev_us, count, key in rows[:15]:
        print(f"  {dev_us / 1e3:10.2f} ms {count:8d} x  {key[:90]}",
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pixels", type=int, default=1024,
                    help="pixels of the synthetic cube the ladder fits")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", type=int, choices=(1, 2),
                    help="also profile the rung of this ncomp")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    try:
        from nestfit_tpu_torch.ops import _build, fused, tables
    except ImportError as exc:
        fail(f"the port is missing: {exc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"device: {kind} ({n_sm} SMs, max SM clock {clock_hz / 1e6:.0f} "
          f"MHz); nvidia-smi: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)

    secs = _build.build_all()
    print(f"build: {secs:.1f} s", flush=True)
    for src in _build.SOURCES:
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}", flush=True)

    records = phase_kernels(args.seed, n_sm, clock_hz)
    phase_forward(args.seed)
    counters = {"hf_chi2_fused": fused.hf_chi2_fused,
                "table_lerp": tables.table_lerp,
                "tapered_invert": tables.tapered_invert}
    launches = phase_ladder(args.seed, args.pixels, counters)
    if args.profile:
        phase_profile(args.seed, args.pixels, args.profile)

    kernels = [dict(records[k], launches=launches[k]) for k in counters]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
