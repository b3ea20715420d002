#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nestfit_tpu_torch``) on one NVIDIA card.

Phases, in order; any failure exits non-zero:

1. device   -- require CUDA; print the card's name and power limit.
2. build    -- compile the four Hopper kernels from ``nestfit_tpu_torch/
               csrc`` (one ``nvcc`` per source, in parallel); print their
               registers and spills.
3. kernels  -- hold K1 ``hf_chi2_fused`` (NH3 at B = 51,200 and at the
               compacted B = 3,200, and N2H+ (1-0) and (3-2): 15 and 45
               lines), K1's one-launch likelihood ``hf_lnl_fused`` (NH3
               (1,1)+(2,2) at both widths, also against the runner's
               two-launch path, and timed against it) and K4
               ``gauss_chi2_fused`` against their plain
               PyTorch versions on the same CUDA tensors at main-path
               shapes, K2 ``table_lerp`` and K3 ``tapered_invert`` bit for
               bit (K3 at B = 3,200, 51,200 and 102,400 on what the IRDC
               transform's per-prior path hands it), the one-launch prior
               transform ``prior_transform_fused`` bit for bit against its
               plain version and the per-prior path at those widths (and
               timed against that path), and time them (kernel, plain version,
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
8. traced   -- the traced sampler (``segment_iters=0``, the default of
               ``fit_batch``, ``run_nested`` and ``fit_single``): every
               block of candidate iterations and slice fill a replayed
               CUDA graph.  (a) Graph against the eager block loop from
               the same generator state, 64 px of the NH3 ladder cube,
               rungs 1 and 2, and a second graph run on the first one's
               kept graphs: lnZ, n_dead, max lnL and calls bit for bit;
               (b) both rungs at 1024 px, ``fit_batch`` called at its
               defaults, under the ladder's gates, every block but each
               key's first (an eager warm-up, then captured) a replay and
               K1, K2 (and K3 on rung 2) launched by replays, each pixel's lnZ held against
               phase *ladder*'s (median difference within two median
               combined errors); (c) a 64-px rung 1 with each knob
               (``efr``, ``ceff``, ``log_zero``, ``pwrap_dims``) and a
               64-px Gaussian rung 2 (K4 in the graph), each under the
               same gates; (d) ``posterior_modes`` of the 1024-px rung 2,
               a finite mode on every pixel; (e) the rung-2 runner built
               by ``AmmoniaRunner.from_data`` from the cube's ``(xarr,
               data, noise, trans_id)`` tuples: ``loglike_unit`` on 51,200
               proposals bit for bit the directly built runner's, and
               ``loglikelihood`` (NumPy in and out) equal to it through
               K1, K2 and K3; then ``fit_single`` at its defaults (nlive
               400, tol 0.5, traced) on one pixel: converged, a finite
               lnZ, graph replays.  Walls, replays, host reads of the done
               mask, blocks with < 10% of the rows active, launches (per
               captured block times replays; those by replays apart in
               (b)) and peak memory are printed.
9. cube     -- the cube pipeline through ``CubeFitter`` at its production
               defaults (SNR buckets, batch 1024, mode-loss retry,
               boundary pass): (a) the committed fixture cutouts
               (``tests/data``: 20x20 px, 379 ch, RMS 0.35 K, NaN corners,
               primary-beam noise map) read by the port's ``read_fits``
               and ``DataCube.from_fits``; (b) the synthetic NH3 cube of
               phase *ladder* (1024 px) laid out as a DataCube pair.  The fitter's batch method hands back
               host records (no ``h5py`` on the card); the gates hold
               them to the fixture's truth, the ladder decision, the
               evidence floor and the boundary refits.  Walls per bucket,
               batch and rung, launches, retry and boundary rows, and the
               peak device memory are printed.
10. products -- the map products (``cube/products.py``) of phase *cube*'s
               records, built into a ``FitTable`` with
               ``FitTable.from_records`` (no ``h5py`` on the card's machine)
               and run through ``postprocess_table`` (both smoothings a
               1-px Gaussian): each case on the card and on the CPU, every
               product held between the two (integers and NaN masks equal,
               float64 maps rtol 1e-9, float32 products rtol 1e-5, model
               products rtol 1e-5 / atol 1e-5), the store spec's shapes,
               ``nbest`` the records' decision, ``nbest_MAP`` finite exactly
               on components below ``conv_nbest``; then the synthetic
               case's records tiled into a 256x256 map (65,536 px) on the
               card: the wall of each step, the bytes copied host to
               device, the peak device memory.  Case (b) and the tiled map
               also run at finite PDF bins (33 edges per parameter over
               the IRDC priors' support): on every run a pixel holds,
               ``post_pdfs`` and ``conv_post_pdfs`` finite and each
               histogram summing to 1 within 1e-4, ``conv_marginals``
               finite inside the bins, ``hf_deblended`` finite on the
               components ``nbest_MAP`` holds where ``nbest`` >= 1.
11. mesh    -- multi-device and multi-process fitting on the one card:
               (a) dp: the NH3 rungs of phase *traced* on a dp = 2 mesh
               (both rows on cuda:0, a host thread each), traced then
               segmented rung 1, under the same gates and against the
               no-mesh runs (walls side by side), each dp row keeping
               both rungs' CUDA-graph programs, and a 64-px rung in
               each mode on a (1, 1) mesh bit for bit equal to no mesh;
               (b) sp: the likelihood over two channel slices against the
               whole spectra at 51,200 proposals (NH3 and N2H+ through
               K1, Gaussian through K4, rtol 1e-5), and a 64-px NH3 rung 2
               on a (dp 1, sp 2) mesh in each mode against no mesh;
               (c) hosts: two processes of this script
               (``--host-worker``) joined by gloo on a localhost TCP
               store, each fitting its ``host_shard`` stripe of phase
               *cube*'s fixture case through the store-free path: one
               record per valid pixel across them, seed streams that
               differ, phase *cube*'s gates on the union; (d)
               ``run_varnoise_sweep`` at its defaults and at the JAX
               package's slow-test settings with that test's assertions;
               (e) the IRDC transform through K2/K3 (and at ncomp 4 the
               dense placement step) on 4,096 vectors at ncomp 2, 3 and
               4 against the native C++ engine (built at first use), and
               256 ncomp-2 vectors against the scalar oracle.
12. aot      -- preparing a fit before its first batch
               (``sampling/aot.py``): two fresh processes of this script
               (``--aot-worker``) fit phase *traced*'s NH3 cube at 1024 px,
               segmented rung 1, then traced rungs 1 and 2: (i) with no
               preparation, then again after a stale plan (prepared at
               R = 512, which misses); (ii) after ``precompile_fit`` of
               each mode (the segmented plan holds the build and warm
               tasks; the traced plan both rungs' programs, within the
               cap).  (ii)'s fits equal (i)'s bit for bit (lnZ, n_dead,
               calls, max lnL), the stale plan's too; (ii)'s traced first
               calls warm up and capture no block but a tail block at
               ``max_iter``; the reports have no error and the
               build task's cache hits and misses number 4.  Prints each
               process's wall from its start to its first result, the
               preparation's wall per task and the first-call walls with
               and without preparation.
13. plots    -- every ``StorePlotter`` data step (``plotting.py``) from the
               store-free ``RecordSource``, on the card and on the CPU,
               held against each other at phase *products*' bars: the map
               steps on phase *products*' 65,536-px map at finite bins
               (the 3-D volume must hold voxels), the per-pixel
               steps (``spec_fit``, ``spec_fit_draws`` at 30 draws,
               ``post_stack``, ``velo_2corr``, ``corner``, ``spec_grid``)
               on a two-component pixel of phase *cube*'s case (b), each
               step's wall printed; the float64 ``amm_predict`` on the card
               within rtol 1e-8, atol 1e-5 of the oracle.  No figure is
               drawn: the card's machine has no matplotlib.
14. bench    -- ``bench_torch.py --fast`` (128 px) in a process of its
               own, segmented, one timed seed (``BENCH_TIMED_SEEDS=5``) and
               one engine-baseline pixel (``BENCH_CPU_PIXELS=1``): exit code
               0, its JSON line carrying every key of the bench's contract
               and the card, the selection and engine-agreement gates
               passed, K1 and the prior kernel launched on the timed
               ladder (added to the launch counts below).  The run's wall
               and rate are printed.
15. profile -- only with ``--profile N``: the NH3 rung of ncomp N again,
               segmented and traced, under ``torch.profiler``: device time
               by kernel, busy share.
16. validation -- the port's evidence-validation suite
               (``validation_torch/``) on the native-truth artifact's first
               16 pixels, padded to 32 rows: ``agreement.run_agreement`` at
               nlive 100, one seed, traced, then ``outlier_postmortem
               .classify`` against the engine's nlive-400 truth.  Every lnZ
               finite, >= 98% of the runs converged and a run that did not
               spent its death budget, K1 and the prior kernel launched
               (added to the launch counts below), the |dz|/sigma median
               under ``bench_torch.py``'s bar of 4.  Prints the wall, and
               the count and class of the records beyond 10 sigma.
17. probes  -- the sampler's progress lines and the probes of
               ``validation_torch/``, each with the kernels' launch
               counters at 0 before it and K1 and the prior kernel risen
               after it: (a) a
               segmented NH3 rung 2 on 128 px of the bench cube with
               ``NESTFIT_NS_DEBUG``'s lines on (``sampler._NS_DEBUG``), every
               line of one of the JAX package's four kinds, and its lnZ
               within 1e-5 relative of the same run with the lines off (the
               largest difference printed); (b) ``mode_loss_probe`` at
               ``lhs,iid``, one seed, 128 px, traced; (c) one
               ``iter_cost_sweep`` ladder at ``50,2`` (``kill_k`` 50, slice
               cadence 2), 128 px, traced.  Fails on a non-finite lnZ.
               Prints the phase's wall.

The line before last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Run from the repository root:
``python3 chip_smoke.py``.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

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
PRIOR_THREADS = 128      # kThreads of csrc/prior_transform.cu
# phase cube: the committed cutouts and their bright pixels and bars
# (tests/test_fixture_cubes.py)
FIXTURES = Path(__file__).resolve().parent / "tests" / "data"
FIXTURE_RMS = 0.35
BRIGHT = [(10, 10), (9, 10), (10, 9), (11, 10)]        # (i_lon, i_lat)
VOFF_BAR, SIGM_BAR = 0.15, 0.25
NBEST2_SHARE = 0.05      # the fixture's truth has one component
CUBE_PIXELS = 1024       # the synthetic cube of phase cube, 32 x 32
PRODUCT_SIDE = 256       # phase products: 65,536 px, the survey's 1e4-1e5
PRODUCT_KERNEL = 1.0     # Gaussian sigma (px) of both product smoothings
PDF_BINS = 200           # edges of the products' histograms
# phase products' finite-bin runs: 33 edges per parameter over the support
# of get_irdc_priors (nestfit_tpu_torch/priors/constructors.py) -- voff,
# trot, tex, ntot, sigm and the constant ortho fraction -- ending at the
# float32 grid ends, so that every posterior sample falls inside
PAR_BINS = np.array([
    np.linspace(float(np.float32(lo)), float(np.float32(hi)), 33)
    for lo, hi in ((-4.0, 4.0), (7.0, 30.0), (2.80, 12.06), (12.5, 16.5),
                   (0.067, 2.067), (-1.0, 1.0))])
PDF_SUM_ATOL = 1e-4      # each finite histogram sums to 1
MODEL_PRODUCTS = ("peak_intensity", "integrated_intensity", "hf_deblended")
TRACED_PIXELS = 1024     # phase traced at full width
GRAPH_PIXELS = 64        # phase traced's graph-vs-eager and knob runs
# phase mesh (e): the port's plain float32 transform against the native
# engine's at ncomp 2-4 (tests/test_torch_native.py, where the JAX
# package's own transform is as far from the engine: on-grid centroids
# within 1.75 / 3.99 / 3.992 cells at ncomp 2 / 3 / 4, median <= 8.8e-6;
# centroids off the grid, ROADMAP R3, in both and <= 1.3e-7 apart
# relative, on <= 41 of 4096 rows) and the scalar oracle
# (tests/test_torch_oracle.py)
NATIVE_INDEP_ATOL = 2e-2
NATIVE_VOFF_MAX_CELLS = {2: 2.0, 3: 4.5, 4: 4.5}
NATIVE_VOFF_MEDIAN_CELLS = 1e-2
NATIVE_OFF_GRID_RTOL, NATIVE_OFF_GRID_SHARE = 1e-6, 0.02
ORACLE_VOFF_CELLS = 0.25
SP_RTOL = 1e-5           # phase mesh (b): sp = 2 against sp = 1
HOST_TIMEOUT = 600       # phase mesh (c): each worker process, seconds
AOT_TIMEOUT = 600        # phase aot: each worker process, seconds
AOT_STALE_PIXELS = 512   # phase aot: the stale plan's batch
DRAWS = 30               # phase plots: spec_fit_draws' posterior draws
BENCH_TIMEOUT = 300      # phase bench: the bench process, seconds
VALIDATION_PIXELS, VALIDATION_ROWS = 16, 32   # phase validation
PROBE_PIXELS = 128       # phase probes: the revival probe's width
PROBE_LNZ_RTOL = 1e-5    # phase probes (a): progress lines on against off
# phase bench: the keys of bench_torch.py's JSON line
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "timed_clean",
              "warmup_s", "precompile", "evals_per_pixel", "gates", "mode",
              "segment_iters", "seeds", "card", "peak_mem_gib", "launches",
              "traced")
WALLS = {}               # rung label -> wall seconds (run_rung)
REPLAYED = {}            # rung label -> launches by graph replays (run_rung)


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
    """The K3 launches of ``utrans.transform(u, ncomp)`` on the per-prior
    path: a list of ``(dist, u, x_lo, x_hi, sfact)``, copied as the
    transform hands them over."""
    from nestfit_tpu_torch.ops import tables
    from nestfit_tpu_torch.priors.priors import transform_per_prior

    k3, calls = tables.tapered_invert, []

    def record(dist, uu, x_lo, x_hi, sfact):
        calls.append((dist, uu.clone(), x_lo.clone(), x_hi.clone(), sfact))
        return k3(dist, uu, x_lo, x_hi, sfact)

    # the wrapper counts its launches through the module's name
    record.launches = 0
    tables.tapered_invert = record
    try:
        transform_per_prior(utrans.priors, u, ncomp)
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


def split_lnl(runner, theta):
    """The runner's two-launch likelihood of flat rows ``theta``: the
    model's prep ops, a K1 ``hf_chi2_fused`` launch a transition and the
    scaling by ``1 / (2 sigma^2)``, as a runner that cannot take the
    one-launch entry runs it."""
    cls = type(runner)
    cls.one_launch = False
    try:
        return runner._log_likelihood(theta, fused=True)
    finally:
        del cls.one_launch


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

    # ---- K1's one-launch likelihood on the same ncomp-2 proposals (both
    # transitions): against its plain version and the runner's two-launch
    # path (the model's prep ops, a K1 launch a transition, the scaling),
    # and timed against that path
    rec = dict(name="hf_lnl_fused", route="cuda",
               source="nestfit_tpu_torch/csrc/hf_chi2.cu",
               replaces="nestfit_tpu/models/runner.py:113 (every "
                        "transition's hf_chi2_fused and the ops around them)",
               library_ms=None)
    worst = 0.0
    for rows, suffix in ((R, ""), (K1_COMPACT_ROWS, "_compacted")):
        sub = runner.with_data(tuple(
            (d[:rows], n[:rows] if n.ndim else n)
            for d, n in runner.data_tree()))
        th = flat.reshape(T, R, -1)[:, :rows].reshape(T * rows, -1) \
            .contiguous()
        got = fused.hf_lnl_fused(ammonia.lnl_model(), sub.spectra, th)
        worst = max(worst, check_close(
            f"K1 hf_lnl_fused ncomp=2 B={T * rows}", got,
            fused.hf_lnl_plain(ammonia.lnl_model(), sub.spectra, th),
            atol=1e-3))
        check_close(f"K1 hf_lnl_fused ncomp=2 B={T * rows} against the "
                    "two-launch path", got, split_lnl(sub, th), atol=1e-3)
        ms, call = time_ms(lambda: sub.model.fused_lnl(sub.spectra, th), 20)
        split_ms, split_call = time_ms(lambda: split_lnl(sub, th), 20)
        plain_ms, _ = time_ms(lambda: fused.hf_lnl_plain(
            ammonia.lnl_model(), sub.spectra, th), 3, warmup=1)
        bound = [k1_bound(T * rows, 2, rows, S, spec_nhf, n_sm, clock_hz)
                 for spec_nhf in (18, 21)]
        bound_ms = sum(b[0] for b in bound)
        rec.update({f"ms{suffix}": ms, f"call_ms{suffix}": call,
                    f"split_ms{suffix}": split_ms,
                    f"split_call_ms{suffix}": split_call,
                    f"plain_ms{suffix}": plain_ms,
                    f"bound_ms{suffix}": bound_ms})
        print(f"K1 one-launch timing (ncomp=2, (1,1)+(2,2), B={T * rows}): "
              f"kernel {ms:.4f} ms (per call {call:.4f} ms), two-launch path "
              f"{split_ms:.4f} ms (per call {split_call:.4f} ms), plain "
              f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms", flush=True)
    rec.update(max_abs_err=worst, bound_by="operations")
    records["hf_lnl_fused"] = rec

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

    # ---- the one-launch prior transform at the IRDC priors' ncomp 2, at
    # K3's widths, against its plain version (bit for bit) and against
    # the per-prior path it replaces (its launches and its time)
    from nestfit_tpu_torch.priors.priors import transform_per_prior

    rec = dict(name="prior_transform_fused", route="cuda",
               source="nestfit_tpu_torch/csrc/prior_transform.cu",
               replaces="the per-prior chain of K2/K3 launches",
               max_abs_err=0.0, bound_by="bytes", library_ms=None)
    for B in K3_WIDTHS:
        u = torch.as_tensor(rng.uniform(size=(B, 12)), dtype=torch.float32,
                            device="cuda")
        prog = utrans.program(2, u.device)
        got = tables.prior_transform_fused(prog, u)
        want = tables.prior_transform_plain(prog, u)
        split = transform_per_prior(utrans.priors, u, 2)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, split)):
            fail(f"prior_transform_fused B={B}: not the plain version and "
                 "the per-prior path bit for bit")
        ms, call = time_ms(lambda: tables.prior_transform_fused(prog, u), 50)
        split_ms, split_call = time_ms(
            lambda: transform_per_prior(utrans.priors, u, 2), 20)
        k0 = tables.table_lerp.launches + tables.tapered_invert.launches
        transform_per_prior(utrans.priors, u, 2)
        k23 = tables.table_lerp.launches + tables.tapered_invert.launches \
            - k0
        # the row in and out, and each block's copy of the cells table
        # (32 N bytes), counted at HBM's rate though L2 serves all but
        # the first; the ppf tables (4 N bytes each) are read once
        packed = prog.packed
        n_blocks = -(-B // PRIOR_THREADS)
        n_bytes = 8 * u.shape[1] * B + 32 * packed.n_cells * n_blocks \
            + sum(4 * packed.ops[k].n for k in range(packed.n_op))
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        rec.update({f"ms_{B}": ms, f"call_ms_{B}": call,
                    f"bound_ms_{B}": bound, f"split_ms_{B}": split_ms,
                    f"split_call_ms_{B}": split_call, "split_k2_k3": k23})
        print(f"prior_transform_fused B={B}: bit for bit; kernel {ms:.4f} "
              f"ms (per call {call:.4f} ms), bound {bound:.5f} ms "
              f"({n_bytes} B); per-prior path {split_ms:.4f} ms of device "
              f"time (per call {split_call:.4f} ms, {k23} K2/K3 launches)",
              flush=True)
    B = K3_WIDTHS[1]
    rec.update(ms=rec[f"ms_{B}"], plain_ms=None,
               bound_ms=rec[f"bound_ms_{B}"])
    records["prior_transform_fused"] = rec

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
        if tid == 1:
            # the N2H+ cell's likelihood: one transition, one launch
            # against the prep op, a K1 launch and the scaling
            runner = make_n2hp_runner([(tid, xa, d)], 2, n_utrans)
            got = runner.model.fused_lnl(runner.spectra, theta)
            check_close(f"K1 hf_lnl_fused N2H+ trans=1 ncomp=2 B={T * R}",
                        got, fused.hf_lnl_plain(diazenylium.lnl_model(),
                                                runner.spectra, theta),
                        atol=1e-3)
            ms, call = time_ms(
                lambda: runner.model.fused_lnl(runner.spectra, theta), 20)
            split_ms, split_call = time_ms(
                lambda: split_lnl(runner, theta), 20)
            records["hf_lnl_fused"].update(ms_n2hp=ms,
                                           split_ms_n2hp=split_ms)
            print(f"K1 one-launch timing (N2H+ (1-0), ncomp=2, B={T * R}): "
                  f"kernel {ms:.4f} ms (per call {call:.4f} ms), two-launch "
                  f"path {split_ms:.4f} ms (per call {split_call:.4f} ms)",
                  flush=True)
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


@contextlib.contextmanager
def replay_launches(counters):
    """Tally, by kernel name, the launches that graph replays add to the
    counters (``_build.add_launches``) while the context is open."""
    from nestfit_tpu_torch.ops import _build

    names = {fn: k for k, fn in counters.items()}
    counts = dict.fromkeys(counters, 0)
    add = _build.add_launches

    def counted(per_replay):
        for fn, n in per_replay.items():
            counts[names[fn]] += n
        add(per_replay)

    _build.add_launches = counted
    try:
        yield counts
    finally:
        _build.add_launches = add


def run_rung(label, gen_seed, runner, n_pix, cfg, counters, need, idle,
             segment_iters=250, mesh=None, prepared=False):
    """One ``fit_batch`` rung with every launch counter at 0 before it.
    Prints its wall, calls, convergence and launches (and, traced, its
    blocks, graph replays, done-mask reads, straggler blocks, the
    launches the replays added and peak memory); fails on a non-finite
    lnZ or posterior sample, on fewer than 98% converged runs or a
    stalled one, if a kernel in ``need`` was never launched or one in
    ``idle`` was, or if a traced rung did not run as CUDA graphs
    (replayed, and captured unless ``prepared``: a program made ready by
    ``sampling.aot`` only replays).  ``segment_iters=None`` calls
    ``fit_batch`` at its default, the traced mode.  ``mesh`` passes on to
    ``fit_batch``; the wall is kept in ``WALLS[label]`` and the launches
    by replays in ``REPLAYED[label]``.  Returns ``(fit, launches)``."""
    import torch
    from nestfit_tpu_torch.sampling import fit_batch, graphs

    mode = {} if segment_iters is None else {"segment_iters": segment_iters}
    is_traced = not segment_iters
    gen = torch.Generator(device="cuda")
    gen.manual_seed(gen_seed)
    for fn in counters.values():
        fn.launches = 0
    graphs.last_stats = graphs.TracedStats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with replay_launches(counters) as replayed:
        fit = fit_batch(gen, runner, n_pix, cfg, device="cuda", mesh=mesh,
                        **mode)
        torch.cuda.synchronize()
    wall = WALLS[label] = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    z = fit.lnz.cpu().numpy()
    ncall = fit.ns.ncall.cpu().numpy().astype(np.int64)
    conv = fit.ns.converged.cpu().numpy()
    traced = ""
    if is_traced:
        st = graphs.last_stats
        traced = (f"{st.blocks} blocks ({st.replays} graph replays, "
                  f"{st.captures} captures, {st.warmups} warm-up blocks, "
                  f"{st.eager_blocks} eager blocks), {st.done_reads} host "
                  f"reads of the done mask, {st.straggler_blocks} blocks "
                  "with < 10% of the rows active, replays' launches "
                  f"{json.dumps(replayed)}, peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, ")
    print(f"{label}: wall {wall:.2f} s, {traced}evals/px {ncall.mean():.1f}, "
          f"converged {int(conv.sum())}/{n_pix}, lnZ median "
          f"{np.median(z):.3f}, kernels {json.dumps(launches)}", flush=True)
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
        fail(f"{label}: {int((~conv).sum())} runs not converged "
             f"({int((n_dead[~conv] < fit.ns.max_iter).sum())} of them short "
             "of the death budget)")
    if not np.isfinite(z).all():
        fail(f"{label}: non-finite lnZ")
    post = fit.products.posteriors
    if not bool(torch.isfinite(post).all()) or post.shape[0] != n_pix:
        fail(f"{label}: bad posterior samples")
    for k in need:
        if launches[k] <= 0:
            fail(f"{label}: kernel {k} never launched")
    for k in idle:
        if launches[k] != 0:
            fail(f"{label}: kernel {k} launched {launches[k]} times off its "
                 "path")
    if is_traced and (st.replays == 0 or (
            st.captures == 0 and not prepared)):
        fail(f"{label}: the traced blocks did not run as CUDA graphs")
    REPLAYED[label] = replayed
    return fit, launches


def run_ladder(label, runner_for, n_pix, seed, counters, need, idle):
    """``fit_batch`` rungs ncomp 1 then 2 on ``runner_for(ncomp)``
    (:func:`run_rung`); the kernels in ``need`` must
    have risen and those in ``idle`` stayed at 0.  Returns ``(lnz by
    ncomp, launches by ncomp, lnz errors by ncomp)``."""
    from nestfit_tpu_torch.sampling import NSConfig

    lnz, launches, errs = {}, {}, {}
    for ncomp in (1, 2):
        fit, launches[ncomp] = run_rung(
            f"{label} rung ncomp={ncomp} R={n_pix}", seed + ncomp,
            runner_for(ncomp), n_pix, NSConfig(**LADDER), counters,
            need, idle)
        lnz[ncomp] = fit.lnz.cpu().numpy()
        errs[ncomp] = fit.lnz_err.cpu().numpy()
    return lnz, launches, errs


def phase_ladder(seed, n_pix, counters, keep=None):
    """The NH3 ladder; ``keep`` receives its ``(lnz, lnz_err)`` by ncomp
    for phase *traced*."""
    from nestfit_tpu_torch.priors import get_irdc_priors
    from nestfit_tpu_torch.synth import make_synth_cube_arrays

    noise = 0.15
    (xa11, d11), (xa22, d22), _ = make_synth_cube_arrays(
        n_pix=n_pix, noise=noise, rng=np.random.default_rng(seed))
    utrans = get_irdc_priors(device="cuda")
    lnz, launches, errs = run_ladder(
        "ladder", lambda ncomp: make_runner(
            (xa11, xa22), (d11, d22), noise, ncomp, utrans),
        n_pix, seed, counters, ["hf_lnl_fused", "prior_transform_fused"],
        ["gauss_chi2_fused", "hf_chi2_fused"])
    gain = lnz[2] - lnz[1]
    print(f"ladder: median lnZ2 - lnZ1 = {np.median(gain):.3f} over "
          f"{n_pix} two-component truth pixels", flush=True)
    if not np.median(gain) > 0:
        fail("ladder: median lnZ2 - lnZ1 is not positive")
    if keep is not None:
        keep.update({n: (lnz[n], errs[n]) for n in lnz})
    return launches


def phase_gauss_ladder(seed, n_pix, counters):
    """The Gaussian-mixture ladder: K4 carries every likelihood."""
    from nestfit_tpu_torch.priors import get_gaussian_priors

    xarr, rest, data, truth = gauss_cube(n_pix,
                                         np.random.default_rng(seed + 10))
    utrans = get_gaussian_priors(device="cuda")
    lnz, launches, _ = run_ladder(
        "gauss ladder", lambda ncomp: make_gauss_runner(
            xarr, rest, data, ncomp, utrans),
        n_pix, seed, counters,
        ["gauss_chi2_fused", "prior_transform_fused"],
        ["hf_chi2_fused", "hf_lnl_fused"])
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
    lnz, launches, _ = run_ladder(
        "n2h+ ladder", lambda ncomp: make_n2hp_runner(
            [(1, xarr, data)], ncomp, utrans),
        n_pix, seed, counters, ["hf_lnl_fused", "prior_transform_fused"],
        ["gauss_chi2_fused", "hf_chi2_fused"])
    gain = lnz[2] - lnz[1]
    print(f"n2h+ ladder: median lnZ2 - lnZ1 = {np.median(gain):.3f} over "
          f"{n_pix} two-component truth pixels", flush=True)
    if not np.median(gain) > 0:
        fail("n2h+ ladder: median lnZ2 - lnZ1 is not positive")
    return launches


def phase_traced(seed, counters, ladder, keep=None):
    """The traced mode (``segment_iters=0``): blocks of candidate
    iterations and a slice fill, each a replayed CUDA graph.  (a) Graph
    against eager on the first 64 pixels of the NH3 ladder cube, rungs 1
    and 2, bit for bit; (b) both rungs at full width (1024 px) through
    ``fit_batch`` at its defaults under the ladder's gates, each pixel's
    lnZ held against phase *ladder*'s segmented lnZ; (c) one 64-px rung 1
    per sampler knob and a 64-px Gaussian rung 2 (K4 in the graph); (d)
    ``posterior_modes`` of the full-width rung 2; (e)
    :func:`traced_entry_points`.  Returns the launches of (b), (c) and
    (e)'s ``fit_single``; ``keep`` receives (b)'s ``(lnz, lnz_err)`` by
    ncomp for phase *mesh*."""
    import torch
    from nestfit_tpu_torch.priors import get_gaussian_priors, get_irdc_priors
    from nestfit_tpu_torch.sampling import NSConfig, graphs, posterior_modes
    from nestfit_tpu_torch.sampling import sampler as ts
    from nestfit_tpu_torch.sampling.fit import _loglike2_for
    from nestfit_tpu_torch.synth import make_synth_cube_arrays

    noise, n_pix, n_small = 0.15, TRACED_PIXELS, GRAPH_PIXELS
    (xa11, d11), (xa22, d22), _ = make_synth_cube_arrays(
        n_pix=n_pix, noise=noise, rng=np.random.default_rng(seed))
    utrans = get_irdc_priors(device="cuda")

    def nh3(ncomp, rows):
        return make_runner((xa11, xa22), (d11[:rows], d22[:rows]), noise,
                           ncomp, utrans)

    def config(ncomp, **kw):
        return NSConfig(**LADDER, flat_dims=tuple(utrans.flat_dims(ncomp)),
                        **kw)

    # (a) the graph against the eager block loop, same generator state
    for ncomp in (1, 2):
        runner = nh3(ncomp, n_small)
        cfg, ll2, data = config(ncomp), _loglike2_for(
            runner, torch.float32), runner.data_tree()
        # the second graph run reuses the first one's program and graphs
        res, walls, stats = {}, {}, {}
        for how in ("eager", "graph", "graph again"):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed + 100 + ncomp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if how == "eager":
                st = ts.ns_init(gen, ll2, data, runner.ndim, n_small, cfg)
                res[how] = ts.ns_finalize(ts.ns_traced(st, ll2, data, cfg),
                                          cfg)
            else:
                res[how] = ts.run_nested(gen, ll2, runner.ndim, n_small, cfg,
                                         data=data, segment_iters=0)
                stats[how] = graphs.last_stats
            torch.cuda.synchronize()
            walls[how] = time.perf_counter() - t0
        same = {f"{f} {how}": bool(torch.equal(getattr(res["eager"], f),
                                               getattr(res[how], f)))
                for how in stats
                for f in ("lnz", "n_dead", "max_loglike", "ncall")}
        print(f"traced graph vs eager ncomp={ncomp} R={n_small}: "
              + ", ".join(f"{h} {w:.2f} s" for h, w in walls.items())
              + ", " + ", ".join(
                  f"{h}: {st.blocks} blocks, {st.replays} replays, "
                  f"{st.captures} captures" for h, st in stats.items())
              + f"; bit for bit {json.dumps(same)}", flush=True)
        if not all(same.values()) or stats["graph"].replays == 0 \
                or stats["graph again"].captures != 0:
            fail(f"traced ncomp={ncomp}: the graph runs are not the eager "
                 "one, or the second did not reuse the first's graphs")

    # (b) full width, both rungs, at fit_batch's defaults (the traced
    # mode), against the segmented ladder
    runs, fits = [], {}
    for ncomp in (1, 2):
        label = f"traced rung ncomp={ncomp} R={n_pix}"
        need = ["hf_lnl_fused", "prior_transform_fused"]
        fits[ncomp], launches = run_rung(
            label, seed + ncomp, nh3(ncomp, n_pix), n_pix, config(ncomp),
            counters, need, ["gauss_chi2_fused", "hf_chi2_fused"],
            segment_iters=None)
        runs.append(launches)
        st, replayed = graphs.last_stats, REPLAYED[label]
        print(f"traced rung ncomp={ncomp} at the defaults: "
              f"{json.dumps(dataclasses.asdict(st))}; launches by replays "
              + ", ".join(f"{k} {replayed[k]} of {launches[k]}"
                          for k in need)
              + " (the rest: the initial live points, the warm-up "
              "blocks, the posterior products)", flush=True)
        # each key's first block is its warm-up, run eagerly and then
        # captured; every other block is a replay, and each kernel rose
        # by replays
        if st.eager_blocks or st.warmups != st.captures or \
                st.blocks != st.warmups + st.replays or \
                any(replayed[k] <= 0 for k in need):
            fail(f"{label}: a block at the defaults was not a replay, or a "
                 "kernel of the path was not launched by replays")
        if keep is not None:
            keep[ncomp] = (fits[ncomp].lnz.cpu().numpy(),
                           fits[ncomp].lnz_err.cpu().numpy())
        if ncomp in ladder and ladder[ncomp][0].shape == (n_pix,):
            z_seg, e_seg = ladder[ncomp]
            d = fits[ncomp].lnz.cpu().numpy() - z_seg
            comb = np.sqrt(fits[ncomp].lnz_err.cpu().numpy() ** 2
                           + e_seg ** 2)
            print(f"traced rung ncomp={ncomp}: lnZ - segmented lnZ median "
                  f"{np.median(d):.3f} (combined error median "
                  f"{np.median(comb):.3f}), beyond 4 combined errors on "
                  f"{int((np.abs(d) > 4 * comb).sum())} of {n_pix} pixels",
                  flush=True)
            # the traced mode fills every collapsed-acceptance slot by a
            # slice chain, whose correlated inserts bias lnZ high by up to
            # ~1.7 nats at D = 12 (the JAX package's slice-fill pins):
            # the median may sit up to two combined errors off
            if not abs(np.median(d)) <= 2 * np.median(comb):
                fail(f"traced rung {ncomp}: lnZ off the segmented ladder's")

    # (c) each sampler knob through the graph, and K4 captured; the
    # logZero floor is the lowest pixel's null-model lnL, so it excludes
    # the prior's worse-than-empty models there and less elsewhere
    floor = float(nh3(1, n_small).null_lnZ.min())
    for kw in ({"efr": 0.3}, {"ceff": True, "efr": 0.3},
               {"log_zero": floor}, {"pwrap_dims": (0,)}):
        _, launches = run_rung(
            f"traced knob {json.dumps(kw)} rung ncomp=1 R={n_small}",
            seed + 1, nh3(1, n_small), n_small, config(1, **kw), counters,
            ["hf_lnl_fused", "prior_transform_fused"],
            ["gauss_chi2_fused", "hf_chi2_fused"], segment_iters=0)
        runs.append(launches)
    xarr, rest, data, _ = gauss_cube(n_small,
                                     np.random.default_rng(seed + 10))
    g_utrans = get_gaussian_priors(device="cuda")
    _, launches = run_rung(
        f"traced gauss rung ncomp=2 R={n_small}", seed + 2,
        make_gauss_runner(xarr, rest, data, 2, g_utrans), n_small,
        NSConfig(**LADDER), counters,
        ["gauss_chi2_fused", "prior_transform_fused"],
        ["hf_chi2_fused", "hf_lnl_fused"], segment_iters=0)
    runs.append(launches)

    # (d) the modes of the full-width rung 2
    runner = nh3(2, n_pix)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    modes = posterior_modes(fits[2].ns, runner.transform)
    torch.cuda.synchronize()
    nm = modes.n_modes.cpu().numpy()
    used = torch.isfinite(modes.mode_lnz)
    ok = bool(torch.isfinite(modes.mode_mean[used]).all()) and \
        bool(torch.isfinite(modes.mode_sigma[used]).all()) and nm.min() >= 1
    print(f"traced modes R={n_pix}: {time.perf_counter() - t0:.2f} s, "
          f"modes per pixel {np.bincount(nm).tolist()}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    if not ok:
        fail("traced modes: a pixel without a finite mode")

    # (e) the rung-2 runner from (xarr, data, noise, trans_id) tuples, the
    # host entry point, and fit_single at its defaults on one pixel
    t_e = time.perf_counter()
    runs.append(traced_entry_points(seed, counters, utrans, nh3(2, n_pix),
                                    (xa11, xa22), (d11, d22), noise))
    print(f"traced (e): {time.perf_counter() - t_e:.2f} s", flush=True)
    graphs.clear()
    return runs


def traced_entry_points(seed, counters, utrans, direct, xa, data, noise):
    """Phase *traced* (e): ``AmmoniaRunner.from_data`` on the NH3 cube's
    ``(xarr, data, noise, trans_id)`` tuples at rung 2 against the
    directly built runner ``direct``, ``loglike_unit`` on 51,200 proposals
    bit for bit; ``loglikelihood`` (NumPy in, NumPy out) equal to it and
    through K1, K2 and K3; then ``fit_single`` at its defaults on the
    cube's first pixel: converged, a finite lnZ, CUDA-graph replays.
    Returns ``fit_single``'s launches."""
    import torch
    from nestfit_tpu_torch.models import AmmoniaRunner
    from nestfit_tpu_torch.sampling import fit_single, graphs

    n_pix = data[0].shape[0]

    def tuples(rows):
        return [(x, d[:rows], np.full(rows, noise), tid)
                for tid, (x, d) in enumerate(zip(xa, data), start=1)]

    runner = AmmoniaRunner.from_data(tuples(n_pix), utrans, ncomp=2)
    if runner.device != direct.device:
        fail(f"traced (e): from_data built its runner on {runner.device}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 300)
    u = torch.rand((51200 // n_pix, n_pix, runner.ndim), generator=gen,
                   device="cuda")
    got, want = runner.loglike_unit(u), direct.loglike_unit(u)
    for fn in counters.values():
        fn.launches = 0
    host = runner.loglikelihood(u.cpu().numpy())
    torch.cuda.synchronize()
    used = {k: fn.launches for k, fn in counters.items()}
    same = bool(torch.equal(got, want))
    same_host = isinstance(host, np.ndarray) and np.array_equal(
        host, got.cpu().numpy())
    print(f"traced (e): from_data rung 2 loglike_unit on {u.shape[0] * n_pix}"
          f" proposals bit for bit the direct runner's: {same}; "
          f"loglikelihood (NumPy) equal: {same_host}, launches "
          f"{json.dumps(used)}", flush=True)
    if not (same and same_host) or not all(
            used[k] > 0 for k in ("hf_lnl_fused",
                                  "prior_transform_fused")) \
            or used["gauss_chi2_fused"]:
        fail("traced (e): from_data or loglikelihood is not the direct "
             "runner's likelihood through its kernels")

    one = AmmoniaRunner.from_data(tuples(1), utrans, ncomp=2)
    gen.manual_seed(seed + 301)
    for fn in counters.values():
        fn.launches = 0
    graphs.last_stats = graphs.TracedStats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit = fit_single(gen, one)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    st = graphs.last_stats
    z = float(fit.lnz[0])
    print(f"traced (e): fit_single at its defaults (nlive 400, tol 0.5, "
          f"ncomp 2, traced) on pixel 0: wall {wall:.2f} s, lnZ {z:.3f} +- "
          f"{float(fit.lnz_err[0]):.3f}, converged "
          f"{bool(fit.ns.converged[0])}, evals {int(fit.ns.ncall[0])}, "
          f"{json.dumps(dataclasses.asdict(st))}, kernels "
          f"{json.dumps(launches)}", flush=True)
    if not (bool(fit.ns.converged[0]) and np.isfinite(z)
            and st.replays > 0):
        fail("traced (e): fit_single did not converge to a finite lnZ "
             "through CUDA-graph replays")
    return launches


def ladder_decision(recs, thresh):
    """``nbest`` from a pixel's records ``{ncomp: attrs}``: the largest N
    whose every rung up to N gained at least ``thresh`` over the one
    before (``null_lnZ`` for N = 1), in the fitter's float32."""
    nbest, prev = 0, None
    for n in sorted(recs):
        lnz = np.float32(recs[n]["global_lnZ"])
        base = np.float32(recs[n]["null_lnZ"]) if n == 1 else prev
        if not lnz - base >= thresh:
            break
        nbest, prev = n, lnz
    return nbest


def run_cube(label, fitter, seed, counters, host_shard=False):
    """Drive ``fitter._fit_batches`` over every valid pixel with the launch
    counters at 0, printing each batch and rung as it comes.  Returns
    ``(batches, launches, wall, peak bytes per batch)``."""
    import torch

    fit_rung = fitter._fit_rung

    def counted_rung(*args, **kwargs):
        before = {k: fn.launches for k, fn in counters.items()}
        out = fit_rung(*args, **kwargs)
        out[3]["launches"] = {k: fn.launches - before[k]
                              for k, fn in counters.items()}
        return out

    fitter._fit_rung = counted_rung
    batches, peaks = [], []
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for batch in fitter._fit_batches(seed, host_shard=host_shard):
        peaks.append(torch.cuda.max_memory_allocated())
        batches.append(batch)
        print(f"{label} batch {batch.chunk}: nlive {batch.nlive}, R "
              f"{batch.pixel_ix.size}, padded R {batch.rungs[0]['r_pad']}, "
              f"{batch.attempts} attempt(s), peak device memory "
              f"{peaks[-1] / 2**30:.3f} GiB", flush=True)
        for r in batch.rungs:
            print(f"  rung ncomp={r['ncomp']} R={r['R']} (pad {r['r_pad']}): "
                  f"first pass {r['wall']:.2f} s, with retry and boundary "
                  f"{r['total_wall']:.2f} s, evals/px "
                  f"{r['evals_per_px']:.1f}, converged {r['converged']}/"
                  f"{r['R']}, kernels {json.dumps(r['launches'])}",
                  flush=True)
            for a in r["retries"]:
                print(f"    mode-loss attempt {a['attempt']}: {a['rows']} rows "
                      f"(pad {a['r_pad']}) at nlive {a['nlive']}, "
                      f"{a['replaced']} records replaced, {a['wall']:.2f} s",
                      flush=True)
            print(f"    below the floor by > {fitter.mode_loss_margin:g} nats: "
                  f"{r['bad_before']} before the retry, {r['bad_after']} "
                  "after", flush=True)
            b = r["boundary"]
            if b is not None:
                print(f"    boundary pass: {b['rows']} rows (pad {b['r_pad']}) "
                      f"at nlive {b['nlive']}, {b['replaced']} records "
                      f"replaced, {b['wall']:.2f} s", flush=True)
        torch.cuda.reset_peak_memory_stats()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    fitter._fit_rung = fit_rung
    rungs = [r for b in batches for r in b.rungs]
    t_retry = sum(a["wall"] for r in rungs for a in r["retries"])
    t_band = sum(r["boundary"]["wall"] for r in rungs if r["boundary"])
    print(f"{label}: wall {wall:.2f} s over {len(batches)} batches "
          f"({sum(r['wall'] for r in rungs):.2f} s first passes, mode-loss "
          f"retry {t_retry:.2f} s = {100 * t_retry / wall:.1f}%, boundary "
          f"pass {t_band:.2f} s = {100 * t_band / wall:.1f}%), peak device "
          f"memory {max(peaks) / 2**30:.3f} GiB, kernels "
          f"{json.dumps(launches)}", flush=True)
    return batches, launches, wall, peaks


def check_refits(label, fitter, batch, rung, recs):
    """The records of one rung hold every merged refit: each row a
    mode-loss attempt or the boundary pass replaced carries the lnZ of
    the last refit that replaced it, and no row the retry replaced (and
    the boundary pass did not) still shows the lnZ it had before; rows
    of the rung's records below the evidence floor (the previous rung's
    record, ``null_lnZ`` on rung 1, less the margin) number no more
    than the fitter found before the retry."""
    n = rung["ncomp"]
    want, before = {}, {}
    for a in rung["retries"]:
        for p, z, z0 in zip(a["pixels"].tolist(), a["lnz"].tolist(),
                            a["old_lnz"].tolist()):
            want[p] = z
            before.setdefault(p, z0)
    band = set()
    if rung["boundary"] is not None:
        bd = rung["boundary"]
        band = set(bd["pixels"].tolist())
        want.update(zip(bd["pixels"].tolist(), bd["lnz"].tolist()))
    wrong = [p for p, z in want.items() if recs[p][n]["global_lnZ"] != z]
    stale = [p for p, z0 in before.items()
             if p not in band and recs[p][n]["global_lnZ"] == z0]
    if wrong or stale:
        fail(f"{label} batch {batch.chunk} rung {n}: the records of "
             f"re-fitted pixels {wrong[:8]} do not hold their refit's lnZ, "
             f"of {stale[:8]} still hold the first pass's")
    rows = [p for p in batch.pixel_ix.tolist() if n in recs[p]]
    prev = np.array([recs[p][n - 1]["global_lnZ"] if n > 1 else
                     recs[p][n]["null_lnZ"] for p in rows], np.float32)
    lnz = np.array([recs[p][n]["global_lnZ"] for p in rows], np.float32)
    below = int((lnz < prev - np.float32(fitter.mode_loss_margin)).sum())
    if below > rung["bad_before"]:
        fail(f"{label} batch {batch.chunk} rung {n}: {below} records below "
             f"the evidence floor, {rung['bad_before']} before the retry")
    return len(want)


def check_cube(label, fitter, batches, valid_ix):
    """Gates both cube cases share; returns ``{pixel: {ncomp: attrs}}``
    and ``{pixel: nbest}``.  Every batch ran its ladder once (no run
    raised); every valid pixel has a rung-1 record with a finite lnZ and
    no other pixel has any; every lnZ is finite; ``nbest`` is the ladder
    decision recomputed from the records; the records hold every merged
    refit (``check_refits``); K1 and K2 launched on every rung, K3 on
    rung 2, K4 never."""
    recs, nbest = {}, {}
    for b in batches:
        if b.attempts != 1:
            fail(f"{label} batch {b.chunk}: {b.attempts} attempts (a ladder "
                 "run raised and the batch was re-run)")
        nbest.update(zip(b.pixel_ix.tolist(), b.nbest.tolist()))
        for pix, ncomp, (attrs, dsets) in b.records:
            recs.setdefault(pix, {})[ncomp] = dict(attrs, **dsets)
    if set(recs) != set(valid_ix.tolist()) or \
            any(1 not in r for r in recs.values()):
        fail(f"{label}: records for {len(recs)} pixels, "
             f"{len(set(recs) - set(valid_ix.tolist()))} of them not valid; "
             f"{valid_ix.size} valid pixels")
    lnz = np.array([a["global_lnZ"] for r in recs.values()
                    for a in r.values()])
    if not np.isfinite(lnz).all():
        fail(f"{label}: {int((~np.isfinite(lnz)).sum())} non-finite lnZ")
    bad = [p for p, r in recs.items()
           if ladder_decision(r, fitter.lnZ_thresh) != nbest[p]]
    if bad:
        fail(f"{label}: nbest is not the ladder decision on pixels {bad[:8]}")
    n_refit = 0
    for b in batches:
        for r in b.rungs:
            n_refit += check_refits(label, fitter, b, r, recs)
            need = ["hf_lnl_fused", "prior_transform_fused"]
            if any(r["launches"][k] <= 0 for k in need) or \
                    r["launches"]["gauss_chi2_fused"] or \
                    r["launches"]["hf_chi2_fused"]:
                fail(f"{label} rung {r['ncomp']}: kernels "
                     f"{r['launches']}, need {need} and no K4")
    hist = np.bincount(list(nbest.values()), minlength=fitter.ncomp_max + 1)
    print(f"{label}: nbest histogram {hist.tolist()} over {len(nbest)} "
          f"pixels; {n_refit} re-fitted rows checked in their records; "
          "every gate on the records passed", flush=True)
    return recs, nbest, hist


def fixture_case():
    """The committed cutouts through the port's FITS reader, and a
    ``CubeFitter`` at its defaults on them: ``(stack, fitter, valid flat
    pixel ids)``."""
    from nestfit_tpu_torch.cube import CubeFitter, CubeStack, DataCube, \
        NoiseMap, read_fits
    from nestfit_tpu_torch.models import AmmoniaRunner
    from nestfit_tpu_torch.priors import get_irdc_priors

    pb, _ = read_fits(FIXTURES / "pb_cutout.fits")
    nmap = NoiseMap.from_pbimg(FIXTURE_RMS, pb)
    stack = CubeStack([
        DataCube.from_fits(FIXTURES / f"nh3_{tag}_cutout.fits",
                           noise_map=nmap, trans_id=tid)
        for tid, tag in ((1, "11"), (2, "22"))])
    fitter = CubeFitter(stack, get_irdc_priors(vsys=0.0, device="cuda"),
                        AmmoniaRunner)
    _, _, nan_mask, _ = stack.get_flat_batch()
    return stack, fitter, np.flatnonzero(~nan_mask)


def check_fixture(label, fitter, batches, stack, valid_ix):
    """Phase *cube*'s gates on the fixture's records: ``check_cube``, the
    bright pixels at their truth, ``nbest`` 2 on at most 5% of a
    one-component truth."""
    from nestfit_tpu_torch.cube import read_fits

    truth, _ = read_fits(FIXTURES / "truth_params.fits")      # [5, b, l]
    recs, nbest, hist = check_cube(label, fitter, batches, valid_ix)
    n_lat = stack.spatial_shape[1]
    for il, ib in BRIGHT:
        pix = il * n_lat + ib
        best = recs[pix][1]["bestfit_params"]
        dv = abs(best[0] - truth[0, ib, il])
        ds = abs(best[4] - truth[4, ib, il])
        print(f"{label}: pixel ({il}, {ib}) nbest {nbest[pix]}, voff "
              f"{best[0]:.4f} (truth {truth[0, ib, il]:.4f}), sigm "
              f"{best[4]:.4f} (truth {truth[4, ib, il]:.4f})", flush=True)
        if nbest[pix] < 1 or not (dv < VOFF_BAR and ds < SIGM_BAR):
            fail(f"{label}: bright pixel ({il}, {ib}) off its truth")
    if hist[2:].sum() > NBEST2_SHARE * valid_ix.size:
        fail(f"{label}: nbest 2 on {int(hist[2:].sum())} of "
             f"{valid_ix.size} pixels of a one-component truth")


def phase_cube(seed, n_pix, counters, keep=None):
    """The cube pipeline at ``CubeFitter``'s production defaults on the
    fixture cutouts and on the synthetic NH3 cube.  Returns the launches
    of the two cases; ``keep`` receives each case's ``(stack, fitter,
    batches)`` for phase *products*."""
    from nestfit_tpu_torch.cube import CubeFitter, CubeStack, DataCube
    from nestfit_tpu_torch.models import AmmoniaRunner
    from nestfit_tpu_torch.priors import get_irdc_priors
    from nestfit_tpu_torch.synth import make_synth_cube_arrays

    # (a) the committed cutouts, through the port's FITS reader
    stack, fitter, valid_ix = fixture_case()
    print(f"cube fixture: {stack.spatial_shape[0]}x{stack.spatial_shape[1]} "
          f"px, {stack.cubes[0].nchan} ch, {valid_ix.size} valid", flush=True)
    batches, launches_a, _, _ = run_cube("cube fixture", fitter, seed,
                                         counters)
    check_fixture("cube fixture", fitter, batches, stack, valid_ix)
    if keep is not None:
        keep["fixture"] = (stack, fitter, batches)

    # (b) the synthetic NH3 cube of phase ladder as a DataCube pair
    noise = 0.15
    (xa11, d11), (xa22, d22), _ = make_synth_cube_arrays(
        n_pix=n_pix, noise=noise, rng=np.random.default_rng(seed))
    shape = (n_pix // 32, 32)
    stack = CubeStack([
        DataCube(d.reshape(*shape, -1), xa, noise_map=noise, trans_id=tid)
        for tid, xa, d in ((1, xa11, d11), (2, xa22, d22))])
    fitter = CubeFitter(stack, get_irdc_priors(device="cuda"), AmmoniaRunner)
    print(f"cube synth: {shape[0]}x{shape[1]} px, {stack.cubes[0].nchan} ch",
          flush=True)
    batches, launches_b, _, _ = run_cube("cube synth", fitter, seed, counters)
    check_cube("cube synth", fitter, batches, np.arange(n_pix))
    if keep is not None:
        keep["synth"] = (stack, fitter, batches)
    for b in batches:
        for r in b.rungs:
            if r["converged"] < CONVERGED_SHARE * r["R"] or \
                    r["unconverged_short"]:
                fail(f"cube synth batch {b.chunk} rung {r['ncomp']}: "
                     f"{r['R'] - r['converged']} of {r['R']} first-pass runs "
                     f"not converged, {r['unconverged_short']} of them short "
                     "of the death budget")
    return [launches_a, launches_b]


def product_runner(stack, device):
    """The one-component NH3 runner the products predict with."""
    from nestfit_tpu_torch.models import AmmoniaRunner

    spectra = tuple(AmmoniaRunner.model.make_model_spectrum(
        c.xarr, np.zeros_like(c.xarr), 0.1, trans_id=c.trans_id,
        device=device) for c in stack.cubes)
    return AmmoniaRunner(spectra, None, ncomp=1, device=device)


def product_table(stack, fitter, batches, n_lon, n_lat):
    from nestfit_tpu_torch.cube.products import FitTable

    model = fitter.runner_cls.model
    return FitTable.from_records(batches, n_lon, n_lat, fitter.ncomp_max,
                                 model.N, fitter.lnZ_thresh, model,
                                 with_posteriors=True)


def check_product_shapes(label, prod, n_lon, n_lat, fitter, stack,
                         n_edges=PDF_BINS):
    """Every product has its store-spec shape (tests/test_fit_cube.py);
    ``n_edges`` is the number of PDF bin edges."""
    m, p = fitter.ncomp_max, fitter.runner_cls.model.N
    M, h = len(prod["marg_quantiles"]), n_edges - 1
    nb = prod["pdf_bins"].shape[1]
    want = {"evidence": (m + 1, n_lat, n_lon), "nbest": (n_lat, n_lon),
            "conv_nbest": (n_lat, n_lon), "conv_evidence": (m + 1, n_lat,
                                                            n_lon),
            "nbest_MAP": (m, p, n_lat, n_lon), "marg_quantiles": (M,),
            "nbest_marginals": (m, p, M, n_lat, n_lon), "pdf_bins": (p, h),
            "post_pdfs": (m, m, p, h, n_lat, n_lon),
            "conv_post_pdfs": (m, m, p, h, n_lat, n_lon),
            "conv_marginals": (m, m, p, M, n_lat, n_lon),
            "peak_intensity": (2, m, n_lat, n_lon),
            "hf_deblended": (2, m, nb, n_lat, n_lon)}
    for k in ("evidence_err", "BIC", "AIC", "AICc"):
        want[k] = want["evidence"]
    want["nbest_bestfit"] = want["nbest_MAP"]
    want["integrated_intensity"] = want["peak_intensity"]
    for c in stack.cubes:
        want[f"model_spec/trans{c.trans_id}"] = (m, c.nchan, n_lat, n_lon)
    got = {k: tuple(v.shape) for k, v in prod.items()}
    if got != want:
        fail(f"{label}: product shapes {got}, the store spec {want}")


def check_product_gates(label, prod, batches, n_lon, n_lat, ncomp):
    """``nbest`` is each pixel's ladder decision in the records (-1 where
    no pixel was fitted); ``nbest_MAP`` is finite on components 0 ..
    conv_nbest - 1 of every pixel and NaN elsewhere."""
    import torch

    want = np.full((n_lat, n_lon), -1, dtype=np.int32)
    for b in batches:
        il, ib = np.divmod(b.pixel_ix, n_lat)
        want[ib, il] = b.nbest
    if not np.array_equal(prod["nbest"].cpu().numpy(), want):
        fail(f"{label}: the nbest product is not the records' ladder "
             "decision")
    conv, pmap = prod["conv_nbest"], prod["nbest_MAP"]
    for c in range(ncomp):
        sel = conv > c
        if not (torch.isfinite(pmap[c]).all(0) == sel).all() or \
                not (torch.isnan(pmap[c]).all(0) == ~sel).all():
            fail(f"{label}: nbest_MAP component {c} is not finite exactly "
                 "where conv_nbest exceeds it")


def check_finite_pdfs(label, prod, tab):
    """The PDF products at finite bins: on every run a pixel holds,
    ``post_pdfs`` and ``conv_post_pdfs`` finite with each histogram
    summing to 1 within ``PDF_SUM_ATOL``, and ``conv_marginals`` finite
    and inside the bins; NaN on the components a run does not have and
    on the runs a pixel does not hold; ``hf_deblended`` finite on every
    component ``nbest_MAP`` holds (those below ``conv_nbest``) of every
    pixel with ``nbest`` >= 1."""
    import torch

    m = tab.ncomp_max
    held = torch.zeros((m, tab.n_lat, tab.n_lon), dtype=torch.bool)
    for ncomp, rec in tab.runs.items():
        rows = np.asarray(rec["pix_row"])
        held[ncomp - 1, tab.pix["i_lat"][rows], tab.pix["i_lon"][rows]] = True
    # the bin centres, rounded as the float32 quantiles are
    bins = prod["pdf_bins"].cpu().float()
    lo, hi = bins[:, 0], bins[:, -1]
    n_hist = 0
    for r in range(m):
        for c in range(m):
            have = held[r] if c <= r else torch.zeros_like(held[r])
            for key in ("post_pdfs", "conv_post_pdfs", "conv_marginals"):
                x = prod[key][r, c].cpu()          # [p, h or Q, b, l]
                if not torch.isfinite(x[..., have]).all() or \
                        not torch.isnan(x[..., ~have]).all():
                    fail(f"{label} {key}: run {r + 1} component {c} is not "
                         "finite exactly on the pixels that hold the run")
                vals = x[..., have]                 # [p, h or Q, n]
                if key == "conv_marginals":
                    if ((vals < lo[:, None, None]) |
                            (vals > hi[:, None, None])).any():
                        fail(f"{label} conv_marginals: run {r + 1} "
                             f"component {c} outside the bins")
                    continue
                dev = (vals.double().sum(1) - 1.0).abs()
                n_hist += dev.numel()
                if dev.numel() and float(dev.max()) > PDF_SUM_ATOL:
                    fail(f"{label} {key}: run {r + 1} component {c}: a "
                         f"histogram sums to 1 +- {float(dev.max()):.2e}")
    nbest, conv = prod["nbest"].cpu(), prod["conv_nbest"].cpu()
    hfdb = prod["hf_deblended"].cpu()               # [t, m, h, b, l]
    for c in range(m):
        sel = (nbest >= 1) & (conv > c)
        if not torch.isfinite(hfdb[:, c][..., sel]).all():
            fail(f"{label} hf_deblended: component {c} not finite where "
                 "nbest >= 1 and nbest_MAP holds it")
    print(f"{label}: {n_hist} histograms finite and summing to 1 (atol "
          f"{PDF_SUM_ATOL:g}), conv_marginals inside the bins, hf_deblended "
          f"finite on {int((nbest >= 1).sum())} pixels with nbest >= 1",
          flush=True)


def compare_products(label, card, cpu):
    """Card against CPU, product by product, at its bar: integers and NaN
    masks equal; float64 maps rtol 1e-9, atol 1e-12; float32 products
    rtol 1e-5, atol 1e-6; model-based products rtol 1e-5, atol 1e-5.
    ``conv_marginals`` inverts a float32 CDF whose running sum reaches
    its total (q = 1) at a bin that an ulp of ``conv_post_pdfs`` can move:
    the card's is held against the CPU's quantile step on the card's own
    ``conv_post_pdfs``, and the jumps end to end must stay under 0.1%."""
    import torch
    from nestfit_tpu_torch.cube.products import pdf_quantiles

    worst = {}
    for key, g in card.items():
        w = cpu[key]
        g = g.cpu()
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{label} {key}: card {g.dtype} {tuple(g.shape)}, CPU "
                 f"{w.dtype} {tuple(w.shape)}")
        if not g.is_floating_point():
            if not torch.equal(g, w):
                fail(f"{label} {key}: card and CPU differ")
            continue
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            fail(f"{label} {key}: NaN masks differ")
        if key in MODEL_PRODUCTS or key.startswith("model_spec/"):
            rtol, atol = 1e-5, 1e-5
        elif g.dtype == torch.float32:
            rtol, atol = 1e-5, 1e-6
        else:
            rtol, atol = 1e-9, 1e-12
        ok = torch.isclose(g, w, rtol=rtol, atol=atol, equal_nan=True)
        worst[key] = float(torch.nan_to_num((g - w).abs().double()).max())
        if key == "conv_marginals":
            again = pdf_quantiles(cpu["pdf_bins"], cpu["marg_quantiles"],
                                  card["conv_post_pdfs"].cpu())
            if not torch.isclose(g, again, rtol=rtol, atol=atol,
                                 equal_nan=True).all():
                fail(f"{label} conv_marginals: the card's quantile step "
                     "differs from the CPU's on the same input")
            jumps = int((~ok).sum())
            print(f"{label}: conv_marginals end to end, {jumps} of "
                  f"{ok.numel()} values moved by the float32 CDF", flush=True)
            if jumps > 1e-3 * ok.numel():
                fail(f"{label} conv_marginals: {jumps} values beyond the bar")
        elif not ok.all():
            fail(f"{label} {key}: {int((~ok).sum())} values beyond rtol "
                 f"{rtol:g}, atol {atol:g}; max |diff| {worst[key]:.3g}")
    print(f"{label}: card against CPU, every product within its bar; max "
          f"|diff| " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()
                                  if v), flush=True)


def tile_records(batches, side, reps):
    """``batches`` of a side x side map copied into a (reps * side)^2 map,
    tile by tile, pixel ids offset (the records themselves are shared)."""
    n = side * reps
    out = []
    for tx in range(reps):
        for ty in range(reps):
            def move(pix):
                il, ib = np.divmod(np.asarray(pix), side)
                return (il + side * tx) * n + ib + side * ty
            for b in batches:
                out.append(dataclasses.replace(
                    b, pixel_ix=move(b.pixel_ix),
                    records=[(int(move(p)), c, r) for p, c, r in b.records]))
    return out


def phase_products(cases, counters, keep=None):
    """The map products of phase *cube*'s records on the card and on the
    CPU, at the default PDF bins and, for case (b), at ``PAR_BINS`` too;
    then at 65,536 pixels on the card, at both.  Returns its launches;
    ``keep`` receives the 65,536-px map's table (without its posteriors),
    finite-bin products and a header for phase *plots*."""
    import torch
    from nestfit_tpu_torch.cube.products import postprocess_table

    for fn in counters.values():
        fn.launches = 0
    for label, (stack, fitter, batches) in cases.items():
        n_lon, n_lat = stack.spatial_shape
        bin_runs = [("", None)]
        if label == "synth":
            bin_runs.append((" finite bins", PAR_BINS))
        for tag, par_bins in bin_runs:
            name = f"products {label}{tag}"
            out = {}
            for dev in ("cuda", "cpu"):
                tab = product_table(stack, fitter, batches, n_lon, n_lat)
                t0 = time.perf_counter()
                out[dev] = postprocess_table(
                    tab, stack, product_runner(stack, dev),
                    par_bins=par_bins, evid_kernel=PRODUCT_KERNEL,
                    post_kernel=PRODUCT_KERNEL, device=dev)
                print(f"{name}: {n_lon}x{n_lat} px on {dev}, "
                      f"{time.perf_counter() - t0:.2f} s", flush=True)
            n_edges = PDF_BINS if par_bins is None else par_bins.shape[1]
            check_product_shapes(name, out["cuda"], n_lon, n_lat, fitter,
                                 stack, n_edges)
            check_product_gates(name, out["cuda"], batches, n_lon, n_lat,
                                fitter.ncomp_max)
            compare_products(name, out["cuda"], out["cpu"])
            if par_bins is not None:
                check_finite_pdfs(name, out["cuda"], tab)
            del out

    # the synthetic cube's records as a map users work at
    stack, fitter, batches = cases["synth"]
    side = stack.spatial_shape[1]
    reps = PRODUCT_SIDE // side
    if stack.spatial_shape != (side, side) or reps * side != PRODUCT_SIDE:
        fail(f"products tiled: a {stack.spatial_shape} map does not tile "
             f"a {PRODUCT_SIDE}-px square")
    tiled = tile_records(batches, side, reps)
    t0 = time.perf_counter()
    tab = product_table(stack, fitter, tiled, PRODUCT_SIDE, PRODUCT_SIDE)
    t_table = time.perf_counter() - t0
    post_gb = sum(r["posteriors"].nbytes for r in tab.runs.values()) / 1e9
    print(f"products tiled: {PRODUCT_SIDE}x{PRODUCT_SIDE} = {tab.n_pix} px "
          f"({reps}x{reps} copies of the {side}x{side} synth map), table "
          f"from records {t_table:.2f} s on the host, posteriors "
          f"{post_gb:.2f} GB float32, n_post "
          f"{tab.runs[1]['posteriors'].shape[1]}", flush=True)
    runner = product_runner(stack, "cuda")
    card = smi("name,power.limit")
    for tag, par_bins in (("", None), (" finite bins", PAR_BINS)):
        name = f"products tiled{tag}"
        walls, prod = {}, None
        h2d = tab.h2d_bytes
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        prod = postprocess_table(tab, stack, runner, par_bins=par_bins,
                                 evid_kernel=PRODUCT_KERNEL,
                                 post_kernel=PRODUCT_KERNEL, device="cuda",
                                 walls=walls)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        print(f"{name}: chain wall {wall:.2f} s on the card; per step "
              + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()),
              flush=True)
        print(f"{name}: host -> device {(tab.h2d_bytes - h2d) / 1e9:.3f} GB "
              f"from the table; peak device memory {peak / 2**30:.3f} GiB "
              f"above the {base / 2**30:.3f} GiB held before; card: {card}",
              flush=True)
        n_edges = PDF_BINS if par_bins is None else par_bins.shape[1]
        check_product_shapes(name, prod, PRODUCT_SIDE, PRODUCT_SIDE, fitter,
                             stack, n_edges)
        check_product_gates(name, prod, tiled, PRODUCT_SIDE, PRODUCT_SIDE,
                            fitter.ncomp_max)
        if par_bins is not None:
            check_finite_pdfs(name, prod, tab)
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"products: kernel launches {json.dumps(launches)} (the path runs "
          "the plain model_predict, no hand-written kernel)", flush=True)
    if keep is not None:
        from nestfit_tpu_torch.synth import make_fake_header

        for run in tab.runs.values():
            run.pop("posteriors")
        keep["tiled"] = (tab, prod, make_fake_header(
            PRODUCT_SIDE, PRODUCT_SIDE, stack.cubes[0].xarr, rms=0.15))
    return launches


def median_gate(label, z, e, z_ref, e_ref, k=2.0):
    """Fail unless the median lnZ difference to the reference run lies
    within ``k`` median combined errors; prints both."""
    d = z - z_ref
    comb = np.sqrt(e ** 2 + e_ref ** 2)
    print(f"{label}: lnZ - reference median {np.median(d):.3f} (combined "
          f"error median {np.median(comb):.3f}), beyond 4 combined errors "
          f"on {int((np.abs(d) > 4 * comb).sum())} of {d.size} pixels",
          flush=True)
    if not abs(np.median(d)) <= k * np.median(comb):
        fail(f"{label}: lnZ off the reference run's")


def mesh_dp(seed, counters, traced):
    """Phase *mesh* (a): the NH3 ladder on a dp = 2 mesh of the one card
    (both rows on cuda:0), traced then segmented, against the no-mesh
    runs, and a (1, 1) mesh bit for bit equal to no mesh."""
    import torch
    from nestfit_tpu_torch.parallel import make_mesh
    from nestfit_tpu_torch.priors import get_irdc_priors
    from nestfit_tpu_torch.sampling import NSConfig, fit_batch, graphs
    from nestfit_tpu_torch.synth import make_synth_cube_arrays

    noise, n_pix = 0.15, TRACED_PIXELS
    (xa11, d11), (xa22, d22), _ = make_synth_cube_arrays(
        n_pix=n_pix, noise=noise, rng=np.random.default_rng(seed))
    utrans = get_irdc_priors(device="cuda")

    def nh3(ncomp, rows):
        return make_runner((xa11, xa22), (d11[:rows], d22[:rows]), noise,
                           ncomp, utrans)

    def config(ncomp):
        return NSConfig(**LADDER, flat_dims=tuple(utrans.flat_dims(ncomp)))

    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    runs = []
    for ncomp, mode, segment_iters, ref in (
            (1, "traced", 0, "traced rung ncomp=1 R=1024"),
            (2, "traced", 0, "traced rung ncomp=2 R=1024"),
            (1, "segmented", 250, "ladder rung ncomp=1 R=1024")):
        label = f"mesh dp=2 {mode} rung ncomp={ncomp} R={n_pix}"
        fit, launches = run_rung(
            label, seed + ncomp, nh3(ncomp, n_pix), n_pix, config(ncomp),
            counters, ["hf_lnl_fused", "prior_transform_fused"],
            ["gauss_chi2_fused", "hf_chi2_fused"],
            segment_iters=segment_iters, mesh=mesh)
        runs.append(launches)
        print(f"{label}: wall {WALLS[label]:.2f} s at dp = 2 against "
              f"{WALLS.get(ref, float('nan')):.2f} s without a mesh "
              f"({ref})", flush=True)
        if mode == "traced" and ncomp in traced:
            median_gate(label, fit.lnz.cpu().numpy(),
                        fit.lnz_err.cpu().numpy(), *traced[ncomp])
    # each dp row keeps both traced rungs' programs (the segmented rung
    # shares rung 1's): a second ladder captures no block again
    kept = [sum(key[1] == k and any(g[0] == "block" for g in prog.graphs)
                for key, prog in graphs._PROGRAMS.items()) for k in (0, 1)]
    print(f"mesh dp=2: programs with traced blocks kept per dp row {kept}",
          flush=True)
    if kept != [2, 2]:
        fail(f"mesh dp=2: the rows keep {kept} traced programs, not both "
             "rungs'")
    # a (1, 1) mesh on the card is no mesh, bit for bit
    one = make_mesh(devices=["cuda:0"])
    for segment_iters in (250, 0):
        fits = []
        for m in (None, one):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed + 300)
            fits.append(fit_batch(gen, nh3(1, GRAPH_PIXELS), GRAPH_PIXELS,
                                  config(1), segment_iters=segment_iters,
                                  device="cuda", mesh=m))
        same = {f: bool(torch.equal(getattr(fits[0].ns, f),
                                    getattr(fits[1].ns, f)))
                for f in ("lnz", "n_dead", "ncall", "max_loglike", "dead_u")}
        same["posteriors"] = bool(torch.equal(fits[0].products.posteriors,
                                              fits[1].products.posteriors))
        print(f"mesh (1, 1) segment_iters={segment_iters} rung ncomp=1 "
              f"R={GRAPH_PIXELS}: "
              f"bit for bit {json.dumps(same)}", flush=True)
        if not all(same.values()):
            fail(f"mesh (1, 1) segment_iters={segment_iters}: not the "
                 "no-mesh run")
    return runs


def mesh_sp(seed, counters):
    """Phase *mesh* (b): the likelihood over two channel slices (both on
    cuda:0) against the whole spectra at 51,200 proposals for NH3, N2H+
    (K1) and the Gaussian model (K4); then a 64-px NH3 rung 2 on a
    (dp 1, sp 2) mesh in both modes against the no-mesh run."""
    import torch
    from nestfit_tpu_torch.parallel import make_mesh
    from nestfit_tpu_torch.priors import get_diazenylium_priors, \
        get_gaussian_priors, get_irdc_priors
    from nestfit_tpu_torch.sampling import NSConfig
    from nestfit_tpu_torch.synth import make_synth_cube_arrays

    R, T = 1024, 50
    rng = np.random.default_rng(seed + 40)
    (xa11, d11), (xa22, d22), _ = make_synth_cube_arrays(
        n_pix=R, noise=0.15, rng=np.random.default_rng(seed))
    xg, rest, dg, _ = gauss_cube(R, np.random.default_rng(seed + 10))
    xn, dn = n2hp_cube(R, np.random.default_rng(seed + 20))
    utrans = get_irdc_priors(device="cuda")
    runners = {
        "NH3 (K1)": make_runner((xa11, xa22), (d11, d22), 0.15, 2, utrans),
        "N2H+ (K1)": make_n2hp_runner(
            [(1, xn, dn)], 2, get_diazenylium_priors(device="cuda")),
        "Gaussian (K4)": make_gauss_runner(
            xg, rest, dg, 2, get_gaussian_priors(device="cuda")),
    }
    for label, runner in runners.items():
        sliced = runner.placed(["cuda:0", "cuda:0"])
        u = torch.as_tensor(rng.uniform(size=(T, R, runner.ndim)),
                            dtype=torch.float32, device="cuda")
        want = runner.loglike_unit(u)
        got = sliced.loglike_unit(u)
        torch.cuda.synchronize()
        rel = ((got - want).abs() / want.abs()).max().item()
        print(f"mesh sp=2 {label} loglike at {T * R} proposals: max relative "
              f"difference to sp=1 {rel:.3e} (rtol {SP_RTOL:g})", flush=True)
        if not rel <= SP_RTOL or not bool(torch.isfinite(got).all()):
            fail(f"mesh sp=2 {label}: the sliced likelihood is not the "
                 "whole one")
    mesh = make_mesh(devices=["cuda:0", "cuda:0"], sp=2)
    runner = make_runner((xa11, xa22), (d11[:GRAPH_PIXELS],
                                        d22[:GRAPH_PIXELS]), 0.15, 2, utrans)
    cfg = NSConfig(**LADDER, flat_dims=tuple(utrans.flat_dims(2)))
    runs = []
    for segment_iters in (250, 0):
        res = {}
        for m in (None, mesh):
            label = (f"mesh {'(1, 2)' if m else 'none'} segment_iters="
                     f"{segment_iters} rung ncomp=2 R={GRAPH_PIXELS}")
            k1 = ["hf_chi2_fused", "hf_lnl_fused"][::1 if m else -1]
            fit, launches = run_rung(
                label, seed + 2, runner, GRAPH_PIXELS, cfg, counters,
                [k1[0], "prior_transform_fused"],
                ["gauss_chi2_fused", k1[1]], segment_iters=segment_iters,
                mesh=m)
            runs.append(launches)
            res[m is None] = (fit.lnz.cpu().numpy(),
                              fit.lnz_err.cpu().numpy())
        median_gate(f"mesh (1, 2) segment_iters={segment_iters}",
                    *res[False], *res[True])
    return runs


def host_worker(rank, world, address, out, seed):
    """One process of phase *mesh* (c): join the gloo group, fit this
    process's stripe of the fixture case on cuda:0 through the
    store-free batch path, and pickle the records, launches, wall and
    the root of its seed stream to ``out``."""
    import pickle

    import torch
    from nestfit_tpu_torch.cube.fitter import host_share
    from nestfit_tpu_torch.ops import fused, tables
    from nestfit_tpu_torch.parallel import initialize_distributed

    counters = {"hf_chi2_fused": fused.hf_chi2_fused,
                "hf_lnl_fused": fused.hf_lnl_fused,
                "table_lerp": tables.table_lerp,
                "tapered_invert": tables.tapered_invert,
                "prior_transform_fused": tables.prior_transform_fused,
                "gauss_chi2_fused": fused.gauss_chi2_fused}
    initialize_distributed(address, world, rank)
    stack, fitter, valid_ix = fixture_case()
    batches, launches, wall, _ = run_cube(f"host {rank}/{world}", fitter,
                                          seed, counters, host_shard=True)
    _, root = host_share(valid_ix, seed, rank, world)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(dict(batches=batches, launches=launches, wall=wall,
                         state=root.generate_state(4).tolist()), f)


def mesh_hosts(seed):
    """Phase *mesh* (c): two processes of this script, both on cuda:0,
    joined through gloo on a localhost TCP store, each fitting its
    ``host_shard`` stripe of phase *cube*'s fixture case; every valid
    pixel must have one record across them, their seed streams must
    differ, and phase *cube*'s gates must hold on the union."""
    import pickle
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_hosts_"))
    outs = [tmp / f"host{r}.pkl" for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--host-worker",
         str(r), "2", f"127.0.0.1:{port}", str(outs[r]), str(seed)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=HOST_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        fail(f"mesh hosts: a worker ran past {HOST_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        for line in log.splitlines():
            if "wall" in line or "FAIL" in line or "Error" in line:
                print(f"  [host {r}] {line}", flush=True)
        if p.returncode != 0:
            print(log[-3000:], flush=True)
            fail(f"mesh hosts: worker {r} exited {p.returncode}")
    res = []
    for o in outs:
        with open(o, "rb") as f:
            res.append(pickle.load(f))
        o.unlink()
    tmp.rmdir()
    stack, fitter, valid_ix = fixture_case()
    owned = [{int(x) for b in r["batches"] for x in b.pixel_ix}
             for r in res]
    print(f"mesh hosts: 2 processes on cuda:0 in {wall:.2f} s (their fits "
          f"{res[0]['wall']:.2f} s and {res[1]['wall']:.2f} s), "
          f"{len(owned[0])} + {len(owned[1])} of {valid_ix.size} valid "
          f"pixels; seed roots {res[0]['state'][:2]} and "
          f"{res[1]['state'][:2]}", flush=True)
    if owned[0] & owned[1] or owned[0] | owned[1] != set(valid_ix.tolist()):
        fail("mesh hosts: the processes' pixels are not a partition of the "
             "valid pixels")
    if res[0]["state"] == res[1]["state"]:
        fail("mesh hosts: both processes drew one seed stream")
    batches = [b for r in res for b in r["batches"]]
    check_fixture("mesh hosts", fitter, batches, stack, valid_ix)
    return [r["launches"] for r in res]


def mesh_varnoise(counters):
    """Phase *mesh* (d): ``run_varnoise_sweep`` at its defaults on the
    card (7 SNR levels x 16 spectra, nlive 100, traced), then at the
    settings of the JAX package's slow test with its four assertions."""
    import torch
    from nestfit_tpu_torch.experiments import run_varnoise_sweep
    from nestfit_tpu_torch.priors import get_irdc_priors

    runs = []
    utrans = get_irdc_priors(vsys=0.0, device="cuda")
    for label, kw in (("defaults", {}),
                      ("slow-test settings", dict(
                          snr_levels=np.array([1.0, 40.0]), n_per_level=8,
                          ncomp_max=2, nlive=60, tol=1.0, seed=7))):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_varnoise_sweep(utrans, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        runs.append(launches)
        nbest = out["nbest_lnz"]
        print(f"mesh varnoise {label}: wall {wall:.2f} s, {nbest.size} "
              f"spectra at SNR {np.round(out['snr'], 2).tolist()}, nbest_lnz "
              f"per level {nbest.mean(axis=1).round(3).tolist()}, "
              f"nbest_bic {out['nbest_bic'].mean(axis=1).round(3).tolist()}, "
              f"kernels {json.dumps(launches)}", flush=True)
        if not np.isfinite(out["lnz"]).all() or \
                any(launches[k] <= 0 for k in ("hf_lnl_fused",
                                               "prior_transform_fused")):
            fail(f"mesh varnoise {label}: non-finite lnZ or a kernel never "
                 "launched")
        if kw:
            lnz = out["lnz"]
            ok = (nbest.shape == (2, 8) and nbest[0].mean() < 1.0
                  and (nbest[1] >= 1).all() and (nbest[1] == 2).mean() >= 0.5
                  and np.all(lnz[1, :, 2] > lnz[1, :, 0]))
            if not ok:
                fail(f"mesh varnoise {label}: the slow test's assertions "
                     f"fail (nbest {nbest.tolist()})")
    return runs


def engine_gap(th, tc, ncomp, dist):
    """The IRDC transform ``th`` against the engine's ``tc`` (both
    ``[n, 6 * ncomp]``): ``(independent dims' max |diff|, on-grid
    centroids' cells, off-grid centroid count, off-grid rows' share, the
    off-grid centroids' max relative diff, whether both put the same
    centroids off the grid)``."""
    a, c = th.reshape(-1, 6, ncomp), tc.reshape(-1, 6, ncomp)
    va, vc = a[:, 0], c[:, 0]
    lo, hi = dist.xmin - dist.dx, dist.xmax + dist.dx
    off = (vc < lo) | (vc > hi)
    same = bool(np.array_equal(off, (va < lo) | (va > hi)))
    rel = float((np.abs(va[off] - vc[off]) / np.abs(vc[off])).max()) \
        if off.any() else 0.0
    return (float(np.abs(a[:, 1:] - c[:, 1:]).max()),
            np.abs(va[~off] - vc[~off]) / dist.dx, int(off.sum()),
            float(off.any(1).mean()), rel, same)


def mesh_transforms(seed, counters):
    """Phase *mesh* (e): the IRDC transform on the card for 4,096 unit
    vectors at ncomp 2, 3 and 4 -- K2/K3, and at ncomp 4 the dense
    placement step before K3 -- against the native C++ engine's
    transform (built at first use), and 256 of the ncomp-2 vectors
    against the scalar oracle's placement.  Returns the transforms'
    launches."""
    import torch
    from nestfit_tpu_torch import oracle
    from nestfit_tpu_torch.native import bindings
    from nestfit_tpu_torch.priors import get_irdc_priors

    t0 = time.perf_counter()
    if not bindings.available():
        fail("mesh transforms: no C++ compiler for the native library")
    lib = bindings.build()
    t_build = time.perf_counter() - t0
    utrans = get_irdc_priors(vsys=0.0, device="cuda")
    prior = utrans.priors[0]
    dist = prior.vcen_prior.dist
    print(f"mesh transforms: native library {lib.name} ready in "
          f"{t_build:.2f} s", flush=True)
    us = {n: np.random.default_rng(seed + 50).uniform(
        size=(4096, 6 * n)).astype(np.float32) for n in (2, 3, 4)}
    for fn in counters.values():
        fn.launches = 0
    ths = {n: utrans.transform(torch.as_tensor(u, device="cuda"), n)
           for n, u in us.items()}
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    if not launches["table_lerp"] or not launches["tapered_invert"]:
        fail(f"mesh transforms: K2/K3 not launched ({launches})")
    ok = True
    for n, u in us.items():
        th = ths[n].double().cpu().numpy()
        t0 = time.perf_counter()
        tc = bindings.transform_native(utrans, n, u.astype(np.float64))
        t_engine = time.perf_counter() - t0
        indep, cells, n_off, share, rel, same = engine_gap(th, tc, n, dist)
        print(f"mesh transforms: ncomp {n}, 4096 vectors against the "
              f"engine ({t_engine:.2f} s with its tables): independent dims "
              f"max {indep:.3e} (atol {NATIVE_INDEP_ATOL:g}); on-grid "
              f"centroids max {cells.max():.3f}, median "
              f"{np.median(cells):.2e} cells (bars "
              f"{NATIVE_VOFF_MAX_CELLS[n]:g}, {NATIVE_VOFF_MEDIAN_CELLS:g}); "
              f"{n_off} centroids off the grid in both: {same}, max "
              f"relative diff {rel:.2e} (bar {NATIVE_OFF_GRID_RTOL:g}), rows "
              f"{100 * share:.2f}% (bar {100 * NATIVE_OFF_GRID_SHARE:g}%)",
              flush=True)
        ok &= (indep <= NATIVE_INDEP_ATOL
               and cells.max() <= NATIVE_VOFF_MAX_CELLS[n]
               and np.median(cells) <= NATIVE_VOFF_MEDIAN_CELLS and same
               and rel <= NATIVE_OFF_GRID_RTOL
               and share <= NATIVE_OFF_GRID_SHARE)
    th = ths[2].double().cpu().numpy().reshape(-1, 6, 2)
    od = oracle.OracleDistribution(dist.xax.double().cpu().numpy(),
                                   dist.pdf.double().cpu().numpy())
    o_cells = max(np.abs(th[i, 0] - oracle.resolved_placement_interp(
        od, us[2][i].reshape(6, 2)[0].astype(np.float64), th[i, 4],
        prior.sep_scale)).max() for i in range(256)) / dist.dx
    print(f"mesh transforms: 256 ncomp-2 vectors against the scalar "
          f"oracle: max {o_cells:.3f} cells (bar {ORACLE_VOFF_CELLS:g}); "
          f"kernel launches {json.dumps(launches)}", flush=True)
    if not ok or o_cells > ORACLE_VOFF_CELLS:
        fail("mesh transforms: the kernels' transform is off the "
             "independent ones")
    return [launches]


def phase_mesh(seed, counters, traced):
    """Multi-device and multi-process fitting, and the independent checks
    of item 15: (a) dp, (b) sp, (c) hosts, (d) varnoise, (e) the native
    and oracle transforms.  Returns the launches of the fitting runs and
    of the transforms."""
    runs = []
    for part, fn in (("a dp", lambda: mesh_dp(seed, counters, traced)),
                     ("b sp", lambda: mesh_sp(seed, counters)),
                     ("c hosts", lambda: mesh_hosts(seed)),
                     ("d varnoise", lambda: mesh_varnoise(counters)),
                     ("e transforms", lambda: mesh_transforms(seed,
                                                              counters))):
        t0 = time.perf_counter()
        runs += fn() or []
        print(f"phase mesh ({part}): {time.perf_counter() - t0:.1f} s",
              flush=True)
    return runs


def aot_setup(seed, rows=TRACED_PIXELS):
    """Phase *aot*'s runners (phase *traced*'s NH3 cube, rungs 1 and 2,
    the first ``rows`` pixels) and configs."""
    from nestfit_tpu_torch.priors import get_irdc_priors
    from nestfit_tpu_torch.sampling import NSConfig
    from nestfit_tpu_torch.synth import make_synth_cube_arrays

    noise = 0.15
    (xa11, d11), (xa22, d22), _ = make_synth_cube_arrays(
        n_pix=TRACED_PIXELS, noise=noise, rng=np.random.default_rng(seed))
    utrans = get_irdc_priors(device="cuda")
    runners = {n: make_runner((xa11, xa22), (d11[:rows], d22[:rows]), noise,
                              n, utrans) for n in (1, 2)}
    configs = {n: NSConfig(**LADDER, flat_dims=tuple(utrans.flat_dims(n)))
               for n in (1, 2)}
    return runners, configs


def aot_worker(mode, out, seed):
    """One process of phase *aot*: ``lazy`` (i) fits segmented rung 1,
    then traced rungs 1 and 2, with no preparation, then the traced rungs
    again after a stale plan (R = 512); ``prepared`` (ii) runs
    ``precompile_fit`` before each mode's first fit.  Pickles the results,
    walls, traced stats, reports, kept graph keys and launches to
    ``out``."""
    import pickle

    from nestfit_tpu_torch.ops import fused, tables
    from nestfit_tpu_torch.sampling import aot, graphs

    counters = {"hf_chi2_fused": fused.hf_chi2_fused,
                "hf_lnl_fused": fused.hf_lnl_fused,
                "table_lerp": tables.table_lerp,
                "tapered_invert": tables.tapered_invert,
                "prior_transform_fused": tables.prior_transform_fused,
                "gauss_chi2_fused": fused.gauss_chi2_fused}
    runners, configs = aot_setup(seed)
    prepared = mode == "prepared"
    res = {"fits": {}, "walls": {}, "stats": {}, "reports": {},
           "launches": [], "graph_keys": {}, "plan_keys": {}}

    def fit(label, ncomp, segment_iters):
        name = f"aot {mode} {label}"
        f, launches = run_rung(
            name, seed + ncomp, runners[ncomp], TRACED_PIXELS,
            configs[ncomp], counters,
            ["hf_lnl_fused", "prior_transform_fused"],
            ["gauss_chi2_fused", "hf_chi2_fused"],
            segment_iters=segment_iters,
            prepared=prepared and segment_iters == 0)
        res.setdefault("first_result", time.time())
        res["fits"][label] = {k: getattr(f.ns, k).cpu().numpy() for k in (
            "lnz", "n_dead", "ncall", "max_loglike")}
        res["walls"][label] = WALLS[name]
        res["launches"].append(launches)
        if segment_iters == 0:
            res["stats"][label] = dataclasses.asdict(graphs.last_stats)

    def prepare(label, plan):
        rep = aot.compile_plan(plan)
        res["reports"][label] = rep
        for t in plan:
            if t.graph_keys:
                res["plan_keys"][t.name] = (t.key[1:], t.graph_keys)
        print(f"aot {mode} prepare {label}: {rep['wall_s']:.3f} s, "
              + ", ".join(f"{r['name']} {r['wall_s']:.3f} s"
                          for r in rep["programs"]), flush=True)

    if prepared:
        prepare("segmented", aot.build_plan(runners[1], TRACED_PIXELS,
                                            configs[1], segment_iters=250))
    fit("segmented rung 1", 1, 250)
    if prepared:
        prepare("traced", [t for n in (1, 2) for t in aot.build_plan(
            runners[n], TRACED_PIXELS, configs[n], segment_iters=0)])
    fit("traced rung 1", 1, 0)
    fit("traced rung 2", 2, 0)
    if prepared:
        # the graphs each prepared program holds after its fit
        for name, (key, _) in res["plan_keys"].items():
            prog = graphs._PROGRAMS.get(key)
            res["graph_keys"][name] = None if prog is None \
                else sorted(k[1] for k in prog.graphs if k[0] == "block")
    else:
        # a stale plan: prepared at another batch, it misses
        graphs.clear()
        stale, _ = aot_setup(seed, AOT_STALE_PIXELS)
        prepare("stale", [t for n in (1, 2) for t in aot.build_plan(
            stale[n], AOT_STALE_PIXELS, configs[n], segment_iters=0)])
        fit("stale traced rung 1", 1, 0)
        fit("stale traced rung 2", 2, 0)
    with open(out, "wb") as f:
        pickle.dump(res, f)


def phase_aot(seed):
    """Phase *aot*: two fresh processes of this script fit the NH3 cube of
    phase *traced* (segmented rung 1, traced rungs 1 and 2), (i) with no
    preparation, (ii) after ``precompile_fit``; the fits agree bit for
    bit, (ii)'s traced first calls warm up and capture no block (but a
    tail block at ``max_iter``), and a stale plan (R = 512)
    gives (i)'s results.  Prints each process's wall from its start to
    its first result, the preparation's wall per task and the first-call
    walls side by side.  Returns the fits' launches."""
    import pickle
    import tempfile

    from nestfit_tpu_torch.ops import _build
    from nestfit_tpu_torch.sampling import NSConfig

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_aot_"))
    res = {}
    for mode in ("lazy", "prepared"):
        out = tmp / f"{mode}.pkl"
        t_spawn = time.time()
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--aot-worker",
             mode, str(out), str(seed)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            log = proc.communicate(timeout=AOT_TIMEOUT)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail(f"aot: the {mode} worker ran past {AOT_TIMEOUT} s")
        wall = time.time() - t_spawn
        for line in log.splitlines():
            if line.startswith("aot") or "FAIL" in line or "Error" in line:
                print(f"  [{mode}] {line}", flush=True)
        if proc.returncode != 0:
            print(log[-3000:], flush=True)
            fail(f"aot: the {mode} worker exited {proc.returncode}")
        with open(out, "rb") as f:
            res[mode] = pickle.load(f)
        out.unlink()
        print(f"aot {mode}: process wall {wall:.2f} s, start to first result "
              f"{res[mode]['first_result'] - t_spawn:.2f} s", flush=True)
    tmp.rmdir()
    lazy, prep = res["lazy"], res["prepared"]
    for label in ("segmented rung 1", "traced rung 1", "traced rung 2"):
        print(f"aot first call {label}: {lazy['walls'][label]:.3f} s "
              f"unprepared, {prep['walls'][label]:.3f} s prepared "
              f"(card: {smi('name,power.limit')})", flush=True)

    def same(a, b):
        return all(np.array_equal(a[k], b[k]) for k in a)

    for label in ("segmented rung 1", "traced rung 1", "traced rung 2"):
        if not same(prep["fits"][label], lazy["fits"][label]):
            fail(f"aot {label}: the prepared fit is not the unprepared one "
                 "bit for bit")
    for label in ("traced rung 1", "traced rung 2"):
        if not same(lazy["fits"][f"stale {label}"], lazy["fits"][label]):
            fail(f"aot stale {label}: not the unprepared fit bit for bit")
        # missed, the stale plan leaves the fit every warm-up of (i)'s
        stale = lazy["stats"][f"stale {label}"]["warmups"]
        if stale < 1 or stale != lazy["stats"][label]["warmups"]:
            fail(f"aot stale {label}: the stale plan did not miss")
    for name, rep in prep["reports"].items():
        names = [r["name"] for r in rep["programs"]]
        build = rep["programs"][0]
        if rep["n_errors"] or names[0] != "build" or \
                build["cache_hits"] + build["cache_misses"] \
                != len(_build.SOURCES):
            fail(f"aot {name}: report {json.dumps(rep)}")
    seg = [r["name"] for r in prep["reports"]["segmented"]["programs"]]
    if seg != ["build", "warm@cuda:0"]:
        fail(f"aot: the segmented plan holds {seg}")
    plans = prep["plan_keys"]
    if sorted(plans) != [f"n{n}:traced@{TRACED_PIXELS}" for n in (1, 2)]:
        fail(f"aot: the traced plan's programs are {sorted(plans)}")
    block = NSConfig(**LADDER).block_iters
    for n, label in ((1, "traced rung 1"), (2, "traced rung 2")):
        st = prep["stats"][label]
        key = f"n{n}:traced@{TRACED_PIXELS}"
        kept = prep["graph_keys"][key]
        tails = [k for k in (kept or []) if tuple(k) not in
                 set(map(tuple, plans[key][1]))]
        print(f"aot prepared {label}: {st['warmups']} warm-up blocks, "
              f"{st['captures']} captures ({len(tails)} tail blocks at "
              f"max_iter: {tails}), {st['replays']} replays; planned keys "
              f"{list(plans[key][1])}", flush=True)
        if kept is None or st["warmups"] != len(tails) or \
                st["captures"] != len(tails) or \
                any(k[1] >= block for k in tails):
            fail(f"aot prepared {label}: the first call was not warm")
    print("aot: prepared fits bit for bit equal to unprepared ones, the "
          "stale plan's too", flush=True)
    return lazy["launches"] + prep["launches"]


def _close_tree(label, card, cpu, path=""):
    """Card against CPU, leaf by leaf, at phase *products*' bars: integers,
    strings and NaN masks equal; float64 rtol 1e-9, atol 1e-12; float32
    rtol 1e-5, atol 1e-6; model curves (``models`` and ``*_models``)
    rtol 1e-5, atol 1e-5."""
    if isinstance(card, dict):
        if card.keys() != cpu.keys():
            fail(f"{label}{path}: keys {sorted(card)} and {sorted(cpu)}")
        for k in card:
            _close_tree(label, card[k], cpu[k], f"{path}/{k}")
        return
    if isinstance(card, (list, tuple)):
        if len(card) != len(cpu):
            fail(f"{label}{path}: {len(card)} and {len(cpu)} items")
        for i, (a, b) in enumerate(zip(card, cpu)):
            _close_tree(label, a, b, f"{path}/{i}")
        return
    if card is None or isinstance(card, str):
        if card != cpu:
            fail(f"{label}{path}: {card!r} and {cpu!r}")
        return
    a, b = np.asarray(card), np.asarray(cpu)
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"{label}{path}: {a.dtype} {a.shape} and {b.dtype} {b.shape}")
    if a.dtype.kind != "f":
        if not np.array_equal(a, b):
            fail(f"{label}{path}: card and CPU differ")
        return
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        fail(f"{label}{path}: NaN masks differ")
    if "models" in path:
        rtol, atol = 1e-5, 1e-5
    elif a.dtype == np.float32:
        rtol, atol = 1e-5, 1e-6
    else:
        rtol, atol = 1e-9, 1e-12
    if not np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True):
        fail(f"{label}{path}: beyond rtol {rtol:g}, atol {atol:g}; max "
             f"|diff| {np.nanmax(np.abs(a - b)):.3g}")


def _timed_steps(plotter, steps):
    """Each data step's output and wall (the device synchronised)."""
    import torch

    out, walls = {}, {}
    for name, fn in steps.items():
        if plotter.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn(plotter)
        if plotter.device.type == "cuda":
            torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    return out, walls


MAP_STEPS = {
    "nbest": lambda sp: sp.nbest_data(),
    "conv_nbest": lambda sp: sp.nbest_data(conv=True),
    "evidence_diff": lambda sp: sp.evidence_diff_data(),
    "mext_evidence": lambda sp: sp.mext_evidence_data(),
    "ncomp_metrics": lambda sp: sp.ncomp_metrics_data(),
    "param_map MAP": lambda sp: sp.param_map_data(0, kind="MAP"),
    "param_map median": lambda sp: sp.param_map_data(0, kind="median"),
    "param_map error": lambda sp: sp.param_map_data(0, kind="error"),
    "intensity peak": lambda sp: sp.intensity_data(kind="peak"),
    "intensity int": lambda sp: sp.intensity_data(kind="int"),
    "deblend_peak": lambda sp: sp.deblend_peak_data(),
    "deblend_intintens": lambda sp: sp.deblend_intintens_data(),
    "map_props": lambda sp: sp.map_props_data(),
    "quan_props": lambda sp: sp.quan_props_data(),
    "err_props": lambda sp: sp.err_props_data(),
    "3d_volume": lambda sp: sp.volume_data(),
    "world ticks": lambda sp: sp.world_tick_labels(
        np.linspace(0, sp.n_lon - 1, 5), np.linspace(0, sp.n_lat - 1, 5)),
}


def phase_plots(tiled, synth):
    """Phase *plots*: every ``StorePlotter`` data step from the store-free
    source (``RecordSource``), on the card and on the CPU, held against
    each other: the map steps on phase *products*' 65,536-px map
    (``tiled``: its table, finite-bin products and header; the 3-D
    volume must hold voxels), the per-pixel steps on
    phase *cube*'s case (b) records (``synth``: stack, fitter, batches);
    then the precision data in float64 against the oracle.  No figure is
    drawn here."""
    import tempfile

    import torch
    from nestfit_tpu_torch.cube.products import masked_evidence
    from nestfit_tpu_torch.plotting import (RecordSource, StorePlotter,
                                            amm_predict_precision_data)

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_plots_")
    print("plots: the data steps only; no figure is drawn on the card's "
          "machine, which has no matplotlib", flush=True)
    tab, prod, header = tiled
    prod["mext_evidence"] = masked_evidence(
        prod["evidence"], prod["conv_evidence"], PRODUCT_KERNEL)
    out, walls = {}, {}
    for dev in ("cuda", "cpu"):
        p = prod if dev == "cuda" else {k: v.cpu() for k, v in prod.items()}
        sp = StorePlotter(RecordSource(tab, p, header),
                          plot_dir=Path(tmp.name) / dev, device=dev)
        out[dev], walls[dev] = _timed_steps(sp, MAP_STEPS)
    n = out["cuda"]["3d_volume"]["values"].size
    print(f"plots map {tab.n_lon}x{tab.n_lat} px: step walls card / CPU "
          + ", ".join(f"{k} {walls['cuda'][k]:.4f} / {walls['cpu'][k]:.4f} s"
                      for k in MAP_STEPS)
          + f"; {n} voxels; card: {smi('name,power.limit')}", flush=True)
    _close_tree("plots map", out["cuda"], out["cpu"])
    if n == 0:
        fail("plots map: the 3-D volume of the finite-bin products holds no "
             "voxel")
    nb = out["cuda"]["nbest"]["image"]
    if not np.isfinite(nb).all() or out["cuda"]["nbest"]["image"].shape \
            != (tab.n_lat, tab.n_lon):
        fail("plots map: the nbest image is not the finite map")

    stack, fitter, batches = synth
    n_lon, n_lat = stack.spatial_shape
    table = product_table(stack, fitter, batches, n_lon, n_lat)
    two = [(int(il), int(ib)) for il, ib, nbest in zip(
        table.pix["i_lon"], table.pix["i_lat"], table.pix["nbest"])
        if nbest == 2]
    if not two:
        fail("plots: the synth records hold no two-component pixel")
    il, ib = two[0]
    out, walls = {}, {}
    for dev in ("cuda", "cpu"):
        runner = product_runner(stack, dev)
        pix_steps = {
            "spec_fit": lambda sp: sp.spec_fit_data(il, ib, stack, runner),
            "spec_fit_draws": lambda sp: sp.spec_fit_draws_data(
                il, ib, stack, runner, n_draw=DRAWS),
            "post_stack": lambda sp: sp.post_stack_data(il, ib),
            "velo_2corr": lambda sp: sp.velo_2corr_data(il, ib),
            "corner": lambda sp: sp.corner_data(il, ib),
            "spec_grid": lambda sp: sp.spec_grid_data(stack, (il, ib)),
        }
        sp = StorePlotter(RecordSource(table, None, stack.simple_header),
                          plot_dir=Path(tmp.name) / dev, device=dev)
        out[dev], walls[dev] = _timed_steps(sp, pix_steps)
    print(f"plots pixel ({il}, {ib}) of the synth records: step walls card "
          "/ CPU " + ", ".join(
              f"{k} {walls['cuda'][k]:.4f} / {walls['cpu'][k]:.4f} s"
              for k in pix_steps), flush=True)
    _close_tree("plots pixel", out["cuda"], out["cpu"])
    draws = out["cuda"]["spec_fit_draws"]["draw_models"]
    if any(d.shape[0] != DRAWS or not np.isfinite(d).all() for d in draws):
        fail("plots pixel: the draws' models are not finite")

    worst = {}
    for trans_id in (1, 2):
        got = {dev: amm_predict_precision_data(trans_id, device=dev,
                                               dtype=torch.float64)
               for dev in ("cuda", "cpu")}
        _close_tree(f"plots precision t{trans_id}", got["cuda"], got["cpu"])
        d = got["cuda"]
        if not np.allclose(d["pred"], d["truth"], rtol=1e-8, atol=1e-5):
            fail(f"plots precision t{trans_id}: float64 amm_predict beyond "
                 "rtol 1e-8, atol 1e-5 of the oracle")
        worst[trans_id] = float(d["diff"].max())
    print(f"plots precision: float64 amm_predict on the card against the "
          f"oracle, max |diff| {worst[1]:.3g} K (1,1), {worst[2]:.3g} K "
          "(2,2)", flush=True)
    tmp.cleanup()


def phase_bench():
    """Phase *bench*: ``bench_torch.py --fast`` in a process of its own
    (segmented, one timed seed, one engine-baseline pixel).  Fails unless
    it exits 0 with a JSON line that holds every key, the card, passed
    selection and engine gates, launches of K1 and the prior kernel on the
    timed ladder and none of K2 or K3 there.  Returns those launches."""
    env = dict(os.environ, BENCH_TIMED_SEEDS="5", BENCH_CPU_PIXELS="1",
               BENCH_SEGMENT_ITERS="250")
    script = Path(__file__).resolve().parent / "bench_torch.py"
    t0 = time.perf_counter()
    try:
        out = subprocess.run([sys.executable, str(script), "--fast"],
                             env=env, capture_output=True, text=True,
                             timeout=BENCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"bench: bench_torch.py ran past {BENCH_TIMEOUT} s")
    wall = time.perf_counter() - t0
    for line in out.stderr.splitlines():
        if line.startswith("bench:") and any(
                w in line for w in ("timed seed", "gate", "baseline",
                                    "precompile", "FAIL")):
            print(f"  {line}", flush=True)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        print(out.stderr[-3000:], flush=True)
        fail(f"bench: bench_torch.py exited {out.returncode}")
    res = json.loads(lines[-1])
    missing = [k for k in BENCH_KEYS if k not in res]
    if missing or "error" in res or "deadline_hit" in res:
        fail(f"bench: the JSON line lacks {missing} or holds an error: "
             f"{lines[-1][:2000]}")
    gates = res["gates"]["pass"]
    if not (gates["selection"] and gates["engine"]) or not res["card"]:
        fail(f"bench: gates {gates}, card {res['card']!r}")
    launches = {k: sum(r[k] for r in res["launches"])
                for k in ("hf_lnl_fused", "prior_transform_fused",
                          "table_lerp", "tapered_invert")}
    if min(launches["hf_lnl_fused"], launches["prior_transform_fused"]) <= 0 \
            or launches["table_lerp"] or launches["tapered_invert"] \
            or len(res["seeds"]) != 1:
        fail(f"bench: launches {launches}, {len(res['seeds'])} timed seeds")
    sd = res["seeds"][0]
    print(f"bench: process wall {wall:.1f} s; {res['value']} "
          f"{res['unit']} (vs_baseline {res['vs_baseline']}), timed ladder "
          f"{sd['wall_s']:.2f} s (rungs {sd['rung_s']}, second pass "
          f"{sd['second_pass_s']:.2f} s), evals/px {res['evals_per_pixel']}, "
          f"gates {gates}, native truth "
          f"{res['gates'].get('native400', 'compared')}, launches "
          f"{json.dumps(launches)}; card {res['card']}", flush=True)
    return [dict(launches, gauss_chi2_fused=0, hf_chi2_fused=0)]


def phase_validation(counters):
    """Phase *validation*: the agreement run of ``validation_torch/`` on the
    artifact's first ``VALIDATION_PIXELS`` pixels (padded to
    ``VALIDATION_ROWS`` rows; nlive 100, seed 0, traced), classified against
    the native truth.  Fails on a non-finite lnZ, fewer than 98% converged
    runs or a stalled one, a K1 or prior-kernel counter that did not rise,
    or a
    |dz|/sigma median at or above ``bench_torch.NT_DZ_MEDIAN``.  Returns
    the launches."""
    import torch
    from bench_torch import NT_DZ_MEDIAN
    from validation_torch import agreement
    from validation_torch import outlier_postmortem as pm

    with open(agreement.NATIVE) as fh:
        nat = json.load(fh)
    pixels = sorted(int(k) for k in nat["records"])[:VALIDATION_PIXELS]
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec, _ = agreement.run_agreement(None, "traced", [(100, 0)],
                                     VALIDATION_ROWS, "cuda", pixels=pixels)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: int(fn.launches) for k, fn in counters.items()}
    run, stats = rec["runs"]["nlive100/seed0"], \
        rec["run_stats"]["nlive100/seed0"]
    if sorted(map(int, run)) != pixels:
        fail(f"validation: records of {sorted(run)}, not of {pixels}")
    z = np.array([[d[f"lnz{n}"], d[f"lnz{n}_err"]] for d in run.values()
                  for n in (1, 2)])
    if not np.isfinite(z).all():
        fail("validation: non-finite lnZ")
    n_runs = 2 * len(pixels)
    n_conv = sum(stats[n]["converged"] for n in ("1", "2"))
    n_short = sum(stats[n]["short_of_budget"] for n in ("1", "2"))
    if n_conv < CONVERGED_SHARE * n_runs or n_short:
        fail(f"validation: {n_runs - n_conv} of {n_runs} runs not converged "
             f"({n_short} short of the death budget)")
    for k in ("hf_lnl_fused", "prior_transform_fused"):
        if launches[k] <= 0:
            fail(f"validation: kernel {k} never launched")
    rows, outliers, _ = pm.classify(nat, rec, "gpu")
    med = float(np.median([abs(r["dz_sigma"]) for r in rows]))
    print(f"validation: wall {wall:.2f} s ({len(pixels)} px in "
          f"{VALIDATION_ROWS} rows, nlive 100, traced; rung walls "
          f"{stats['1']['wall_s']:.2f} / {stats['2']['wall_s']:.2f} s, "
          f"evals/px {stats['1']['evals_per_px']:.0f} / "
          f"{stats['2']['evals_per_px']:.0f}), converged {n_conv}/{n_runs}; "
          f"native truth |dz|/sigma median {med:.3f} over {len(rows)} "
          f"records (bar {NT_DZ_MEDIAN}), {len(outliers)} beyond "
          f"{pm.OUTLIER_SIGMA:.0f} sigma: "
          + (", ".join(f"pixel {r['pixel']} rung {r['rung']} "
                       f"{r['dz_sigma']:+.1f} {r['class']}"
                       for r in outliers) or "none")
          + f"; kernels {json.dumps(launches)}", flush=True)
    if not med < NT_DZ_MEDIAN:
        fail(f"validation: |dz|/sigma median {med:.3f} >= {NT_DZ_MEDIAN}")
    return launches


def phase_probes(counters):
    """Phase *probes*: (a) the progress lines on a segmented NH3 rung 2 of
    ``PROBE_PIXELS`` px against the same rung without them, (b)
    ``mode_loss_probe`` at ``lhs,iid`` and (c) one ``iter_cost_sweep``
    ladder at ``50,2``, both traced at ``PROBE_PIXELS`` px.  Fails on a
    line of no kind, an lnZ off by more than ``PROBE_LNZ_RTOL`` relative,
    a non-finite lnZ or a K1 or prior-kernel counter that did not rise.
    Returns the
    launches of the three."""
    import torch
    import bench_torch
    from nestfit_tpu_torch.priors import get_irdc_priors
    from nestfit_tpu_torch.sampling import NSConfig, fit_batch
    from validation_torch import iter_cost_sweep, mode_loss_probe
    from validation_torch import regime_probes

    total = dict.fromkeys(counters, 0)

    def counted(label, run):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: int(fn.launches) for k, fn in counters.items()}
        for k in ("hf_lnl_fused", "prior_transform_fused"):
            if launches[k] <= 0:
                fail(f"probes {label}: kernel {k} never launched")
        for k in total:
            total[k] += launches[k]
        return out, wall, launches

    # (a) the progress lines change no result
    runner = bench_torch.make_runner(
        bench_torch.make_cube(1024, 5), 2,
        get_irdc_priors(vsys=0.0, device="cuda"), "cuda", rows=PROBE_PIXELS)
    cfg = NSConfig(nlive=100, tol=1.0)

    def rung():
        gen = torch.Generator(device="cuda").manual_seed(
            10 * regime_probes.REVIVAL_KEY + 2)
        return fit_batch(gen, runner, PROBE_PIXELS, cfg, segment_iters=250,
                         device="cuda")

    off, wall_off, _ = counted("(a) lines off", rung)
    (on, lines), wall_on, launches = counted(
        "(a) lines on", lambda: regime_probes.debug_lines(rung))
    try:
        kinds = regime_probes.parse_lines(lines)
    except ValueError as exc:
        fail(f"probes (a): {exc}")
    z_off, z_on = off.lnz.cpu().numpy(), on.lnz.cpu().numpy()
    if not (np.isfinite(z_off).all() and np.isfinite(z_on).all()):
        fail("probes (a): non-finite lnZ")
    rel = float(np.max(np.abs(z_on - z_off) / np.abs(z_off)))
    print(f"probes (a): segmented rung 2, {PROBE_PIXELS} px: lines off "
          f"{wall_off:.2f} s, on {wall_on:.2f} s; lines by kind "
          f"{json.dumps({k: len(v) for k, v in kinds.items()})}; largest "
          f"relative lnZ difference {rel:.3e} (bar {PROBE_LNZ_RTOL}); "
          f"kernels {json.dumps(launches)}", flush=True)
    if not kinds["cand_seg"] or not kinds["slice_seg"]:
        fail("probes (a): no candidate or no slice segment line")
    if rel > PROBE_LNZ_RTOL:
        fail(f"probes (a): lnZ moved by {rel:.3e} relative with the lines "
             "on")

    # (b) the mode-loss probe, traced
    probe_runners = mode_loss_probe.make_runners(PROBE_PIXELS, "cuda")
    recs, wall, launches = counted("(b)", lambda: [
        mode_loss_probe.probe_pair(probe_runners, PROBE_PIXELS, tag, 0,
                                   "traced", "cuda")
        for tag in ("lhs", "iid")])
    print(f"probes (b): mode_loss_probe lhs,iid, 1 seed, {PROBE_PIXELS} px, "
          f"traced: {wall:.2f} s; "
          + "; ".join(f"{r['variant']} viol1={r['viol1']} "
                      f"viol2={r['viol2']} evals/px={r['evals_px']:.0f}"
                      for r in recs)
          + f"; kernels {json.dumps(launches)}", flush=True)
    for r in recs:
        if not r["lnz_finite"]:
            fail(f"probes (b): {r['variant']}: non-finite lnZ")

    # (c) one sweep ladder at kill_k 50, cadence 2, traced
    rec, wall, launches = counted("(c)", lambda: next(iter_cost_sweep.sweep(
        iter_cost_sweep.parse_combos(["50,2"]), "traced", "cuda",
        n_pix=PROBE_PIXELS, timed=False)))
    warm = rec["warm"]
    print(f"probes (c): sweep ladder {rec['combo']}, {PROBE_PIXELS} px, "
          f"traced: {wall:.2f} s; rung walls {warm[1]['wall_s']} / "
          f"{warm[2]['wall_s']} s, evals/px {warm[1]['evals_px']:.0f} / "
          f"{warm[2]['evals_px']:.0f}, nbest {warm['nbest_hist']}; kernels "
          f"{json.dumps(launches)}", flush=True)
    if not all(np.isfinite(warm[n]["lnz_mean"]) for n in (1, 2)):
        fail("probes (c): non-finite lnZ")
    return total


def phase_profile(seed, n_pix, ncomp):
    """One rung under ``torch.profiler`` in each sampler mode (its
    ``segment_iters``): device time by kernel and the device's busy
    share of the rung wall (the profiler's own host cost lengthens the
    wall, so the share is a lower bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nestfit_tpu_torch.priors import get_irdc_priors
    from nestfit_tpu_torch.sampling import NSConfig, fit_batch
    from nestfit_tpu_torch.synth import make_synth_cube_arrays

    (xa11, d11), (xa22, d22), _ = make_synth_cube_arrays(
        n_pix=n_pix, noise=0.15, rng=np.random.default_rng(seed))
    runner = make_runner((xa11, xa22), (d11, d22), 0.15, ncomp,
                         get_irdc_priors(device="cuda"))
    cfg = NSConfig(**LADDER)
    for segment_iters in (250, 0):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed + ncomp)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fit_batch(gen, runner, n_pix, cfg, segment_iters=segment_iters,
                      device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = []
        for ev in prof.key_averages():
            # kernel events only: an operator's row repeats its kernels'
            # time
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0))
            rows.append((dev_us, ev.count, ev.key))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows) / 1e6
        print(f"profile rung ncomp={ncomp} R={n_pix} segment_iters="
              f"{segment_iters}: wall {wall:.2f} s under the profiler, "
              f"device busy {busy:.3f} s ({100 * busy / wall:.1f}%)",
              flush=True)
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
    ap.add_argument("--host-worker", nargs=5,
                    metavar=("RANK", "WORLD", "ADDRESS", "OUT", "SEED"),
                    help="run one process of phase mesh (c) and exit")
    ap.add_argument("--aot-worker", nargs=3, metavar=("MODE", "OUT", "SEED"),
                    help="run one process of phase aot and exit")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    try:
        from nestfit_tpu_torch.ops import _build, fused, tables
    except ImportError as exc:
        fail(f"the port is missing: {exc}")
    if args.host_worker:
        rank, world, address, out, seed = args.host_worker
        host_worker(int(rank), int(world), address, out, int(seed))
        return
    if args.aot_worker:
        mode, out, seed = args.aot_worker
        aot_worker(mode, out, int(seed))
        return
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

    t_start = time.perf_counter()
    records = phase_kernels(args.seed, n_sm, clock_hz)
    phase_forward(args.seed)
    phase_forward(args.seed + 1)
    counters = {"hf_chi2_fused": fused.hf_chi2_fused,
                "hf_lnl_fused": fused.hf_lnl_fused,
                "table_lerp": tables.table_lerp,
                "tapered_invert": tables.tapered_invert,
                "prior_transform_fused": tables.prior_transform_fused,
                "gauss_chi2_fused": fused.gauss_chi2_fused}
    # launches on the main paths: every rung of the three ladders and
    # both cases of the cube phase
    runs, ladder = [], {}
    runs += list(phase_ladder(args.seed, args.pixels, counters,
                              ladder).values())
    for phase in (phase_gauss_ladder, phase_n2hp_ladder):
        runs += list(phase(args.seed, args.pixels, counters).values())
    t0 = time.perf_counter()
    traced = {}
    runs += phase_traced(args.seed, counters, ladder, traced)
    print(f"phase traced: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cube_cases = {}
    runs += phase_cube(args.seed, CUBE_PIXELS, counters, cube_cases)
    print(f"phase cube: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    plots_in = {}
    runs.append(phase_products(cube_cases, counters, plots_in))
    plots_in["synth"] = cube_cases["synth"]
    del cube_cases
    print(f"phase products: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    runs += phase_mesh(args.seed, counters, traced)
    print(f"phase mesh: {time.perf_counter() - t0:.1f} s", flush=True)
    # the workers of phase aot share the card: hand back the cached blocks
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runs += phase_aot(args.seed)
    print(f"phase aot: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_plots(plots_in["tiled"], plots_in["synth"])
    del plots_in
    print(f"phase plots: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runs += phase_bench()
    print(f"phase bench: {time.perf_counter() - t0:.1f} s", flush=True)
    if args.profile:
        phase_profile(args.seed, args.pixels, args.profile)
    t0 = time.perf_counter()
    runs.append(phase_validation(counters))
    print(f"phase validation: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    runs.append(phase_probes(counters))
    print(f"phase probes: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the "
          "build", flush=True)

    launches = {k: sum(run[k] for run in runs) for k in counters}
    kernels = [dict(records[k], launches=launches[k]) for k in counters]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
