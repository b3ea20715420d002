#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nestfit_tpu_torch``) on one NVIDIA card.

Phases, in order; any failure exits non-zero:

1. device   -- require CUDA; print the card's name and power limit.
2. build    -- compile the four Hopper kernels from ``nestfit_tpu_torch/
               csrc`` (one ``nvcc`` per source, in parallel); print their
               registers and spills.
3. kernels  -- hold K1 ``hf_chi2_fused`` (NH3 at B = 51,200 and at the
               compacted B = 3,200, and N2H+ (1-0) and (3-2): 15 and 45
               lines) and K4 ``gauss_chi2_fused`` against their plain
               PyTorch versions on the same CUDA tensors at main-path
               shapes, K2 ``table_lerp`` and K3 ``tapered_invert`` bit for
               bit (K3 at B = 3,200, 51,200 and 102,400 on what the IRDC
               transform hands it), and time them (kernel, plain version,
               library call): device time per call from
               ``torch.profiler``, and per-call time with CUDA events in a
               loop of its own, which also counts host gaps between
               launches; beside them the launch floor, a one-element
               ``fill_``.
4. forward  -- at ``--seed`` and ``--seed`` + 1, ncomp 2, 256 px on the
               card: the kernel prior transform bit for bit equal to the
               plain one, and ``loglike_unit`` of the kernel path against
               the plain path: NH3 (1,1)+(2,2) at 384 ch, the Gaussian
               model at 380 ch, N2H+ (1-0)+(3-2) at 400 ch.
5. ladder   -- ``fit_batch`` on a seeded synthetic NH3 (1,1)+(2,2) cube
               (``--pixels``, default 1024; noise 0.15), ncomp 1 then 2,
               nlive 100, tol 1.0, init_factor 4, segment_iters 250.  The
               kernels' launch counters are set to 0 before each rung and
               must have risen after it.  Every lnZ is finite; at least
               98% of the runs converge (``bench.py``'s gate), and a run
               that does not must have spent its whole death budget.
6. gauss ladder -- the same on a seeded Gaussian-mixture cube on the NH3
               (1,1) velocity axis (noise 0.15; half the pixels one
               component, half two): lnZ2 - lnZ1 must clear 11 on the
               two-component pixels and not on the others.
7. n2h+ ladder  -- the same on a seeded two-component N2H+ (1-0) cube
               (400 ch, noise 0.1).
8. profile  -- only with ``--profile N``: the NH3 rung of ncomp N again
               under ``torch.profiler``: device time by kernel, busy
               share.

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

LADDER = dict(nlive=100, tol=1.0, init_factor=4)
CONVERGED_SHARE = 0.98   # bench.py's selection gate on converged runs
GAUSS_NOISE, N2HP_NOISE = 0.15, 0.1
K1_COMPACT_ROWS = 64     # NSConfig.min_compact: the narrowest K1 launch
# K3's launch widths T x R on the ladders: the compacted slice round,
# the NH3/N2H+ and the Gaussian candidate rounds
K3_WIDTHS = (50 * 64, 50 * 1024, 100 * 1024)


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
    (``torch.profiler``), and, in a loop of its own outside the
    profiler (whose host cost would lengthen it), the CUDA-event time
    per call, which also holds any gap the host leaves between
    launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(
        getattr(ev, "self_device_time_total",
                getattr(ev, "self_cuda_time_total", 0))
        for ev in prof.key_averages()
        if ev.device_type == torch.autograd.DeviceType.CUDA)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return dev_us / 1e3 / reps, start.elapsed_time(end) / reps


def launch_floor():
    """``(device_ms, call_ms)`` of a one-element ``fill_``: what any
    launch costs on this card, under the same profiler."""
    import torch

    x = torch.empty(1, device="cuda")
    return time_ms(lambda: x.fill_(1.0), 200)


def capture_k3(utrans, u, ncomp):
    """The K3 launches of ``utrans.transform(u, ncomp)``: a list of
    ``(dist, u, x_lo, x_hi, sfact)``, copied as the transform hands them
    over."""
    from nestfit_tpu_torch.ops import tables

    k3, calls = tables.tapered_invert, []

    def record(dist, uu, x_lo, x_hi, sfact):
        calls.append((dist, uu.clone(), x_lo.clone(), x_hi.clone(), sfact))
        return k3(dist, uu, x_lo, x_hi, sfact)

    # the wrapper counts its launches through the module's name
    record.launches = 0
    tables.tapered_invert = record
    try:
        utrans.transform(u, ncomp)
    finally:
        tables.tapered_invert = k3
    return calls


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


def gauss_cube(n_pix, rng):
    """A Gaussian-mixture cube on the NH3 (1,1) velocity axis (380 ch):
    the first half of the pixels hold one component, the second half two
    well separated ones (peaks 0.75-3 K, sigm 0.2-0.8 km/s, centroids
    inside the +-4 km/s of ``get_gaussian_priors``).  Truth from the
    float64 oracle.  Returns ``(xarr, rest_freq, data, ncomp_truth)``."""
    from nestfit_tpu_torch import oracle
    from nestfit_tpu_torch.models.tables import AMMONIA_TRANSITIONS
    from nestfit_tpu_torch.utils import freq_axis_from_velocity

    rest = AMMONIA_TRANSITIONS[0].nu
    xarr = freq_axis_from_velocity(np.arange(-30, 30, 0.158), rest)
    ncomp = np.where(np.arange(n_pix) < n_pix // 2, 1, 2)
    data = np.empty((n_pix, xarr.shape[0]))
    for i, n in enumerate(ncomp):
        voff = rng.uniform(-2, 2, 1) if n == 1 else np.array(
            [rng.uniform(-3, -1.5), rng.uniform(1.5, 3)])
        params = np.concatenate([voff, rng.uniform(0.2, 0.8, n),
                                 rng.uniform(0.75, 3, n)])
        data[i] = oracle.gauss_predict(xarr, params, rest)
    data += rng.normal(scale=GAUSS_NOISE, size=data.shape)
    return xarr, rest, data, ncomp


def n2hp_cube(n_pix, rng, trans_id=1):
    """A two-component N2H+ cube (``arange(-20, 20, 0.1)``, 400 ch): voff
    -1.5..-0.5 and 1-2.5 km/s above it, tex 4-10 K, log10 tau -0.5..0.5,
    sigm 0.2-0.5 km/s.  Truth from the float64 oracle."""
    from nestfit_tpu_torch import oracle
    from nestfit_tpu_torch.models.tables import DIAZENYLIUM_TRANSITIONS
    from nestfit_tpu_torch.utils import freq_axis_from_velocity

    xarr = freq_axis_from_velocity(np.arange(-20, 20, 0.1),
                                   DIAZENYLIUM_TRANSITIONS[trans_id - 1].nu)
    data = np.empty((n_pix, xarr.shape[0]))
    for i in range(n_pix):
        v1 = rng.uniform(-1.5, -0.5)
        params = np.concatenate([[v1, v1 + rng.uniform(1.0, 2.5)],
                                 rng.uniform(4, 10, 2),
                                 rng.uniform(-0.5, 0.5, 2),
                                 rng.uniform(0.2, 0.5, 2)])
        data[i] = oracle.nnhp_predict(xarr, params, trans_id=trans_id)
    data += rng.normal(scale=N2HP_NOISE, size=data.shape)
    return xarr, data


def make_gauss_runner(xarr, rest, data, ncomp, utrans):
    from nestfit_tpu_torch.models import GaussianRunner, gaussian

    spec = gaussian.make_gaussian_spectrum(
        xarr, data, np.full(data.shape[0], GAUSS_NOISE), rest_freq=rest,
        device="cuda")
    return GaussianRunner(spec, utrans, ncomp=ncomp, device="cuda")


def make_n2hp_runner(cubes, ncomp, utrans):
    """``cubes`` is ``[(trans_id, xarr, data), ...]``."""
    from nestfit_tpu_torch.models import DiazenyliumRunner, diazenylium

    spectra = [diazenylium.make_diazenylium_spectrum(
        xa, d, np.full(d.shape[0], N2HP_NOISE), trans_id=tid, device="cuda")
        for tid, xa, d in cubes]
    return DiazenyliumRunner(spectra, utrans, ncomp=ncomp, device="cuda")


def check_close(label, got, want, atol, rtol=2e-4):
    """Fail unless ``got`` is finite and within ``atol + rtol |want|``;
    returns the largest absolute error."""
    import torch

    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = atol + rtol * want.abs()
    print(f"{label}: max_abs_err={err.max().item():.3e} "
          f"max_err/tol={(err / tol).max().item():.3f}", flush=True)
    if not bool(torch.all(err <= tol)) or not bool(torch.isfinite(got).all()):
        fail(f"{label}: the kernel disagrees with its plain version")
    return err.max().item()


def k1_bound(B, C, R, S, nhf, n_sm, clock_hz):
    """``(bound_ms, bound_by, n_exp)`` of one K1 launch: C S (nhf + 2)
    exponentials a row at the SFU's rate, against the bytes in and out."""
    n_exp = B * C * S * (nhf + 2)
    t_exp = n_exp / (SFU_EXP_PER_CLOCK_PER_SM * n_sm * clock_hz)
    t_fma = B * C * S * nhf * 8 * 2 / FP32_FLOP_PER_S
    n_bytes = 4 * (4 * B * C + R * S + 3 * S + 3 * nhf + B)
    t_mem = n_bytes / HBM_BYTES_PER_S
    t_ops = max(t_exp, t_fma)
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes", n_exp)


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

    # ---- K1 at the D=12 candidate round (T = n_cand = 50, R = 1024) and
    # at the compacted slice round (T = 50, R_active = min_compact = 64:
    # the first 64 pixels)
    R, T, S = 1024, 50, 380
    (xa11, d11), (xa22, d22), _ = make_synth_cube_arrays(
        n_pix=R, noise=0.15, rng=np.random.default_rng(seed))
    worst, timing = 0.0, {}
    for ncomp in (1, 2):
        runner = make_runner((xa11, xa22), (d11, d22), 0.15, ncomp, utrans)
        u = torch.as_tensor(rng.uniform(size=(T, R, 6 * ncomp)),
                            dtype=torch.float32, device="cuda")
        flat = runner.transform(u, plain=True).reshape(T * R, -1)
        for spec in runner.spectra:
            trans, voff, tex, tau0, sigm = ammonia._component_params(
                spec, flat, False, False)
            comps = [x.contiguous() for x in (voff, tex, tau0, sigm)]
            for rows in (R, K1_COMPACT_ROWS):
                args = (trans, spec.dnu, spec.t0, spec.tbg, spec.data[:rows],
                        *(x.reshape(T, R, ncomp)[:, :rows].reshape(
                            T * rows, ncomp).contiguous() for x in comps))
                worst = max(worst, check_close(
                    f"K1 hf_chi2_fused ncomp={ncomp} trans={spec.trans_id} "
                    f"B={T * rows}", fused.hf_chi2_fused(*args),
                    fused.hf_chi2_plain(*args), atol=1e-3))
                if ncomp == 2 and spec.trans_id == 1:
                    timing[rows] = args
    rec = dict(name="hf_chi2_fused", route="cuda",
               source="nestfit_tpu_torch/csrc/hf_chi2.cu",
               replaces="nestfit_tpu/ops/fused.py:159", max_abs_err=worst,
               library_ms=None)
    for rows, suffix in ((R, ""), (K1_COMPACT_ROWS, "_compacted")):
        args = timing[rows]
        ms, call = time_ms(lambda: fused.hf_chi2_fused(*args), 20)
        plain_ms, _ = time_ms(lambda: fused.hf_chi2_plain(*args), 3,
                              warmup=1)
        bound_ms, bound_by, n_exp = k1_bound(T * rows, 2, rows, S,
                                             args[0].nhf, n_sm, clock_hz)
        rec.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain_ms,
                    f"bound_ms{suffix}": bound_ms})
        if not suffix:
            rec["bound_by"] = bound_by
        print(f"K1 timing (ncomp=2, (1,1), B={T * rows}): kernel {ms:.4f} ms "
              f"(per call {call:.4f} ms), plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms ({n_exp:.3e} exp at {clock_hz / 1e6:.0f} "
              f"MHz, {bound_by})", flush=True)
    records["hf_chi2_fused"] = rec

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
          f"{err.max().item():.3e}, bit for bit: "
          f"{torch.equal(got, want)}", flush=True)
    if not torch.equal(got, want):
        fail("K2 is not its plain version bit for bit")
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

    # ---- K3 on what the IRDC transform at ncomp 2 hands it (sfact 1,
    # then sfact 0), at the path's widths T x R: 50 x 64 (the compacted
    # slice round), 50 x 1024 (the NH3 and N2H+ candidate rounds),
    # 100 x 1024 (the Gaussian candidate round); bit for bit against the
    # plain version, at sfact 2 on the same inputs too
    floor_ms, floor_call = launch_floor()
    print(f"launch floor (one-element fill_): device {floor_ms:.4f} ms, "
          f"per call {floor_call:.4f} ms", flush=True)
    rec = dict(name="tapered_invert", route="cuda",
               source="nestfit_tpu_torch/csrc/tapered_invert.cu",
               replaces="nestfit_tpu/ops/tables.py:199", max_abs_err=0.0,
               bound_by="bytes", library_ms=None, floor_ms=floor_ms)
    for B in K3_WIDTHS:
        u = torch.as_tensor(rng.uniform(size=(B, 12)), dtype=torch.float32,
                            device="cuda")
        calls = capture_k3(utrans, u, 2)
        if [c[4] for c in calls] != [1, 0]:
            fail(f"K3: the ncomp-2 transform launched sfact "
                 f"{[c[4] for c in calls]}, not [1, 0]")
        for dist, *cols, sf in calls:
            for s in (sf, 2):
                got = tables.tapered_invert(dist, *cols, s)
                want = tables.tapered_invert_plain(dist, *cols, s)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                if not torch.equal(got, want):
                    fail(f"K3 is not its plain version bit for bit (B={B}, "
                         f"sfact={s}, max |err| {err:.3e})")
            ms, call = time_ms(lambda: tables.tapered_invert(dist, *cols, sf),
                               50)
            suffix = f"_{B}" + ("_sf0" if sf == 0 else "")
            rec[f"ms{suffix}"] = ms
            rec[f"call_ms{suffix}"] = call
            if sf == 1:
                rec[f"plain_ms_{B}"], _ = time_ms(
                    lambda: tables.tapered_invert_plain(dist, *cols, sf), 10)
                n_bytes = 16 * B + 16 * dist.size
                rec[f"bound_ms_{B}"] = n_bytes / HBM_BYTES_PER_S * 1e3
            print(f"K3 tapered_invert B={B} sfact={sf}: bit for bit; kernel "
                  f"{ms:.4f} ms (per call {call:.4f} ms), bound "
                  f"{rec[f'bound_ms_{B}']:.5f} ms", flush=True)
    B = K3_WIDTHS[1]
    rec.update(ms=rec[f"ms_{B}"], plain_ms=rec[f"plain_ms_{B}"],
               bound_ms=rec[f"bound_ms_{B}"])
    records["tapered_invert"] = rec

    # ---- K4 at the Gaussian ladder's candidate round: D <= 6 gives
    # kill_k = nlive / 2 = 50, so T = n_cand = 100; R = 1024, S = 380
    from nestfit_tpu_torch.constants import CKMS
    from nestfit_tpu_torch.models import gaussian
    from nestfit_tpu_torch.priors import get_diazenylium_priors, \
        get_gaussian_priors

    R, T = 1024, 100
    xarr, rest, data, _ = gauss_cube(R, np.random.default_rng(seed))
    g_utrans = get_gaussian_priors(device="cuda")
    worst = 0.0
    for ncomp in (1, 2):
        runner = make_gauss_runner(xarr, rest, data, ncomp, g_utrans)
        spec = runner.spectra[0]
        u = torch.as_tensor(rng.uniform(size=(T, R, 3 * ncomp)),
                            dtype=torch.float32, device="cuda")
        flat = runner.transform(u, plain=True).reshape(T * R, -1)
        voff, sigm, peak = gaussian._components(spec, flat)
        args = (spec.rest_freq / CKMS, spec.dnu, spec.data,
                *(x.contiguous() for x in (voff, sigm, peak)))
        worst = max(worst, check_close(
            f"K4 gauss_chi2_fused ncomp={ncomp} B={T * R}",
            fused.gauss_chi2_fused(*args), fused.gauss_chi2_plain(*args),
            atol=1e-3))
        timing = args
    B, C, S = T * R, 2, spec.size
    ms, call = time_ms(lambda: fused.gauss_chi2_fused(*timing), 20)
    plain_ms, _ = time_ms(lambda: fused.gauss_chi2_plain(*timing), 3,
                          warmup=1)
    n_exp = B * C * S
    t_exp = n_exp / (SFU_EXP_PER_CLOCK_PER_SM * n_sm * clock_hz)
    t_fma = B * C * S * 4 / FP32_FLOP_PER_S
    n_bytes = 4 * (3 * B * C + R * S + S + B)
    t_mem = n_bytes / HBM_BYTES_PER_S
    t_ops = max(t_exp, t_fma)
    records["gauss_chi2_fused"] = dict(
        name="gauss_chi2_fused", route="cuda",
        source="nestfit_tpu_torch/csrc/gauss_chi2.cu",
        replaces="nestfit_tpu/ops/fused.py:233",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_mem) * 1e3,
        bound_by="operations" if t_ops >= t_mem else "bytes",
        library_ms=None)
    print(f"K4 timing (ncomp=2, B={B}, S={S}): kernel {ms:.4f} ms (per call "
          f"{call:.4f} ms), plain {plain_ms:.3f} ms, bound "
          f"{records['gauss_chi2_fused']['bound_ms']:.4f} ms ({n_exp:.3e} "
          f"exp at {clock_hz / 1e6:.0f} MHz)", flush=True)

    # ---- K1 on N2H+ (1-0) and (3-2), 15 and 45 lines, at the N2H+
    # ladder's D = 8 candidate round: kill_k = nlive / 4, T = 50
    from nestfit_tpu_torch.models import diazenylium

    R, T = 1024, 50
    n_utrans = get_diazenylium_priors(device="cuda")
    for tid in (1, 3):
        xa, d = n2hp_cube(R, np.random.default_rng(seed + tid), tid)
        spec = make_n2hp_runner([(tid, xa, d)], 2, n_utrans).spectra[0]
        u = torch.as_tensor(rng.uniform(size=(T * R, 8)),
                            dtype=torch.float32, device="cuda")
        theta = n_utrans.transform(u, 2, plain=True)
        trans, voff, tex, tau0, sigm = diazenylium._component_params(
            spec, theta)
        args = (trans, spec.dnu, spec.t0, spec.tbg, spec.data,
                *(x.contiguous() for x in (voff, tex, tau0, sigm)))
        check_close(f"K1 hf_chi2_fused N2H+ trans={tid} ({trans.nhf} lines) "
                    f"ncomp=2 B={T * R}", fused.hf_chi2_fused(*args),
                    fused.hf_chi2_plain(*args), atol=1e-3)
    return records


FORWARD_PIXELS = 256


def forward_cases(seed):
    """``[(label, runner, u), ...]``: the forward step at the
    ``__graft_entry__.entry()`` shapes, ncomp 2, for the NH3 (1,1)+(2,2)
    (384 ch), Gaussian (380 ch) and N2H+ (1-0)+(3-2) (400 ch) runners,
    with a unit cube ``u`` near its centre for each."""
    import torch
    from nestfit_tpu_torch.models.tables import AMMONIA_TRANSITIONS
    from nestfit_tpu_torch.priors import get_diazenylium_priors, \
        get_gaussian_priors, get_irdc_priors
    from nestfit_tpu_torch.utils import freq_axis_from_velocity

    n_pix, n_chan, ncomp = FORWARD_PIXELS, 384, 2
    rng = np.random.default_rng(seed)
    vaxis = np.linspace(-30, 30, n_chan)
    xa = [freq_axis_from_velocity(vaxis, AMMONIA_TRANSITIONS[t].nu)
          for t in (0, 1)]
    data = [rng.normal(scale=0.2, size=(n_pix, n_chan)) for _ in (0, 1)]

    def unit(n_model):
        u = np.clip(0.5 + rng.normal(scale=0.1, size=(n_pix, n_model * ncomp)),
                    0, 1)
        return torch.as_tensor(u, dtype=torch.float32, device="cuda")

    cases = [(f"NH3 {n_chan} ch", make_runner(
        xa, data, 0.2, ncomp, get_irdc_priors(device="cuda")), unit(6))]
    xarr, rest, data, _ = gauss_cube(n_pix, rng)
    cubes = [(tid, *n2hp_cube(n_pix, rng, tid)) for tid in (1, 3)]
    cases += [
        ("gaussian 380 ch", make_gauss_runner(
            xarr, rest, data, ncomp, get_gaussian_priors(device="cuda")),
         unit(3)),
        ("n2h+ (1-0)+(3-2) 400 ch", make_n2hp_runner(
            cubes, ncomp, get_diazenylium_priors(device="cuda")), unit(4))]
    return cases


def phase_forward(seed):
    """Each forward case: the kernel transform bit for bit equal to the
    plain one, and ``loglike_unit`` (kernels) within atol 5e-2 / rtol
    2e-4 of ``loglike_unit(plain=True)``."""
    import torch

    for label, runner, u in forward_cases(seed):
        theta = runner.transform(u)
        want = runner.transform(u, plain=True)
        torch.cuda.synchronize()
        n_diff = int((theta != want).sum())
        print(f"forward seed {seed}: {label} transform: {n_diff} of "
              f"{want.numel()} parameters differ from the plain path",
              flush=True)
        if n_diff:
            fail(f"forward {label}: the kernel transform is not the plain one "
                 "(python3 tools/trace_transform.py traces it)")
        got = runner.loglike_unit(u)
        if got.shape != (u.shape[0],):
            fail(f"forward {label}: bad lnL shape {tuple(got.shape)}")
        check_close(f"forward seed {seed}: {label} loglike_unit "
                    f"{u.shape[0]} px ncomp={runner.ncomp}", got,
                    runner.loglike_unit(u, plain=True), atol=5e-2)


def run_ladder(label, runner_for, n_pix, seed, counters, need, idle):
    """``fit_batch`` rungs ncomp 1 then 2 on ``runner_for(ncomp)``.  Each
    rung starts with every launch counter at 0; after it, the kernels in
    ``need`` (and K3 on rung 2) must have risen and those in ``idle``
    stayed at 0.  Returns ``(lnz by ncomp, launches by ncomp)``."""
    import torch
    from nestfit_tpu_torch.sampling import NSConfig, fit_batch

    cfg = NSConfig(**LADDER)
    lnz, launches = {}, {}
    for ncomp in (1, 2):
        runner = runner_for(ncomp)
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
        print(f"{label} rung ncomp={ncomp} R={n_pix}: wall {wall:.2f} s, "
              f"evals/px {ncall.mean():.1f}, converged {int(conv.sum())}/"
              f"{n_pix}, lnZ median {np.median(z):.3f}, kernels "
              f"{json.dumps(launches[ncomp])}", flush=True)
        # the reference's own gate (bench.py: converged share >= 0.98),
        # and a run may miss the tolerance only by spending its whole
        # death budget (a very bright pixel); a stalled run fails
        n_dead = fit.ns.n_dead.cpu().numpy()
        for p in np.flatnonzero(~conv)[:8]:
            print(f"  not converged: pixel {p}, deaths {n_dead[p]} of "
                  f"{fit.ns.max_iter}, evals {ncall[p]}, lnZ {z[p]:.3f} +- "
                  f"{float(fit.ns.lnz_err[p]):.3f}, max lnL "
                  f"{float(fit.ns.max_loglike[p]):.3f}", flush=True)
        if conv.mean() < CONVERGED_SHARE or \
                (n_dead[~conv] < fit.ns.max_iter).any():
            fail(f"{label} rung {ncomp}: {int((~conv).sum())} runs not "
                 f"converged ({int((n_dead[~conv] < fit.ns.max_iter).sum())}"
                 " of them short of the death budget)")
        if not np.isfinite(z).all():
            fail(f"{label} rung {ncomp}: non-finite lnZ")
        post = fit.products.posteriors
        if not bool(torch.isfinite(post).all()) or post.shape[0] != n_pix:
            fail(f"{label} rung {ncomp}: bad posterior samples")
        for k in need + (["tapered_invert"] if ncomp == 2 else []):
            if launches[ncomp][k] <= 0:
                fail(f"{label} rung {ncomp}: kernel {k} never launched")
        for k in idle:
            if launches[ncomp][k] != 0:
                fail(f"{label} rung {ncomp}: kernel {k} launched "
                     f"{launches[ncomp][k]} times off its path")
    return lnz, launches


def phase_ladder(seed, n_pix, counters):
    from nestfit_tpu_torch.priors import get_irdc_priors
    from nestfit_tpu_torch.synth import make_synth_cube_arrays

    noise = 0.15
    (xa11, d11), (xa22, d22), _ = make_synth_cube_arrays(
        n_pix=n_pix, noise=noise, rng=np.random.default_rng(seed))
    utrans = get_irdc_priors(device="cuda")
    lnz, launches = run_ladder(
        "ladder", lambda ncomp: make_runner(
            (xa11, xa22), (d11, d22), noise, ncomp, utrans),
        n_pix, seed, counters, ["hf_chi2_fused", "table_lerp"],
        ["gauss_chi2_fused"])
    gain = lnz[2] - lnz[1]
    print(f"ladder: median lnZ2 - lnZ1 = {np.median(gain):.3f} over "
          f"{n_pix} two-component truth pixels", flush=True)
    if not np.median(gain) > 0:
        fail("ladder: median lnZ2 - lnZ1 is not positive")
    return launches


def phase_gauss_ladder(seed, n_pix, counters):
    """The Gaussian-mixture ladder: K4 carries every likelihood."""
    from nestfit_tpu_torch.priors import get_gaussian_priors

    xarr, rest, data, truth = gauss_cube(n_pix,
                                         np.random.default_rng(seed + 10))
    utrans = get_gaussian_priors(device="cuda")
    lnz, launches = run_ladder(
        "gauss ladder", lambda ncomp: make_gauss_runner(
            xarr, rest, data, ncomp, utrans),
        n_pix, seed, counters, ["gauss_chi2_fused", "table_lerp"],
        ["hf_chi2_fused"])
    gain = lnz[2] - lnz[1]
    g1, g2 = np.median(gain[truth == 1]), np.median(gain[truth == 2])
    keep = gain > 11.0
    print(f"gauss ladder: median lnZ2 - lnZ1 = {g2:.3f} over "
          f"{int((truth == 2).sum())} two-component pixels, {g1:.3f} over "
          f"{int((truth == 1).sum())} one-component pixels; a second "
          f"component kept (> 11) on {int(keep[truth == 2].sum())} and "
          f"{int(keep[truth == 1].sum())} of them", flush=True)
    if not g2 > 11.0:
        fail("gauss ladder: median lnZ2 - lnZ1 on two-component pixels "
             "is not above 11")
    if not g1 < 11.0:
        fail("gauss ladder: median lnZ2 - lnZ1 on one-component pixels "
             "is not below 11")
    return launches


def phase_n2hp_ladder(seed, n_pix, counters):
    """The N2H+ (1-0) ladder: K1 at 15 lines carries every likelihood."""
    from nestfit_tpu_torch.priors import get_diazenylium_priors

    xarr, data = n2hp_cube(n_pix, np.random.default_rng(seed + 20))
    utrans = get_diazenylium_priors(device="cuda")
    lnz, launches = run_ladder(
        "n2h+ ladder", lambda ncomp: make_n2hp_runner(
            [(1, xarr, data)], ncomp, utrans),
        n_pix, seed, counters, ["hf_chi2_fused", "table_lerp"],
        ["gauss_chi2_fused"])
    gain = lnz[2] - lnz[1]
    print(f"n2h+ ladder: median lnZ2 - lnZ1 = {np.median(gain):.3f} over "
          f"{n_pix} two-component truth pixels", flush=True)
    if not np.median(gain) > 0:
        fail("n2h+ ladder: median lnZ2 - lnZ1 is not positive")
    return launches


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
                    help="pixels of each synthetic cube the ladders fit")
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
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"  {src}: {line.strip()}", flush=True)

    records = phase_kernels(args.seed, n_sm, clock_hz)
    phase_forward(args.seed)
    phase_forward(args.seed + 1)
    counters = {"hf_chi2_fused": fused.hf_chi2_fused,
                "table_lerp": tables.table_lerp,
                "tapered_invert": tables.tapered_invert,
                "gauss_chi2_fused": fused.gauss_chi2_fused}
    ladders = [phase_ladder(args.seed, args.pixels, counters),
               phase_gauss_ladder(args.seed, args.pixels, counters),
               phase_n2hp_ladder(args.seed, args.pixels, counters)]
    if args.profile:
        phase_profile(args.seed, args.pixels, args.profile)

    # launches on the main paths: every rung of the three ladders
    launches = {k: sum(rung[k] for lad in ladders for rung in lad.values())
                for k in counters}
    kernels = [dict(records[k], launches=launches[k]) for k in counters]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
