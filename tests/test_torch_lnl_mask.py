"""K1's live-lane mask (``ops/fused.py::hf_lnl_fused``'s ``live``): the
rows a caller does not read cost no channel loop and read the sampler's
log-zero, and the rows it reads are those of the unmasked call bit for
bit.

On the CPU: the plain version under random masks; one segmented
``fit_batch`` of NH3 and of N2H+ through the one-launch entry's plain
version, masked against unmasked, with every answer equal; the
recorder's ``k1.lanes`` and ``k1.lanes_live``.  On the card (skipped
without one): the kernel, masked against unmasked.  Imports neither JAX
nor ``nestfit_tpu``, so it also runs on a GPU machine without them::

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_lnl_mask.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from nestfit_tpu_torch import oracle, synth
from nestfit_tpu_torch.models import (
    AmmoniaRunner,
    DiazenyliumRunner,
    ammonia,
    diazenylium,
)
from nestfit_tpu_torch.models.runner import Runner
from nestfit_tpu_torch.models.tables import DIAZENYLIUM_TRANSITIONS
from nestfit_tpu_torch.ops import fused
from nestfit_tpu_torch.priors import get_diazenylium_priors, get_irdc_priors
from nestfit_tpu_torch.sampling import NSConfig, fit_batch
from nestfit_tpu_torch.utils import freq_axis_from_velocity, profiling


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _nh3(R, device, seed=0):
    (xa11, d11), (xa22, d22), _ = synth.make_synth_cube_arrays(
        n_pix=R, noise=0.15, rng=np.random.default_rng(seed))
    specs = [ammonia.make_ammonia_spectrum(
        x, d, np.random.default_rng(seed + t).uniform(0.1, 0.2, R),
        trans_id=t, device=device)
        for t, (x, d) in enumerate(((xa11, d11), (xa22, d22)), 1)]
    return AmmoniaRunner(specs, get_irdc_priors(vsys=0.0, device=device),
                         ncomp=2, device=device)


def _n2hp(R, device, seed=0):
    rng = np.random.default_rng(seed + 1)
    xa = freq_axis_from_velocity(np.arange(-20, 20, 0.1),
                                 DIAZENYLIUM_TRANSITIONS[0].nu)
    p = np.stack([rng.uniform(-1.5, -0.5, R), rng.uniform(4, 10, R),
                  rng.uniform(-0.5, 0.5, R), rng.uniform(0.2, 0.5, R)], 1)
    d = np.stack([oracle.nnhp_predict(xa, q, trans_id=1) for q in p])
    spec = diazenylium.make_diazenylium_spectrum(
        xa, d + rng.normal(scale=0.1, size=d.shape), np.full(R, 0.1),
        trans_id=1, device=device)
    return DiazenyliumRunner(spec, get_diazenylium_priors(device=device),
                             ncomp=2, device=device)


RUNNERS = {"nh3": _nh3, "n2hp": _n2hp}


def _theta(runner, T, R, seed):
    """``[T * R, N C]`` packed parameters from the runner's prior."""
    g = torch.Generator(device=runner.device).manual_seed(seed)
    u = torch.rand((T * R, runner.ndim), generator=g, device=runner.device)
    return runner.transform(u)


def _masks(T, R, seed, device, p_live=0.5):
    """The sampler's candidate masks: ``[T, R]`` twice and ``[R]``."""
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.uniform(size=s) < p_live,
                                 device=device)
                 for s in ((T, R), (T, R), (R,)))


def _keep(masks, T, R):
    keep = np.ones((T, R), bool)
    for m in masks:
        keep &= m.cpu().numpy()
    return torch.as_tensor(keep.reshape(-1))


@pytest.mark.parametrize("p_live", [1.0, 0.6, 0.25, 0.0])
@pytest.mark.parametrize("model", sorted(RUNNERS))
def test_plain_mask_keeps_live_rows_bit_for_bit(model, p_live):
    """(a) ``hf_lnl_plain`` under random masks: the live rows equal the
    unmasked call's bit for bit, the masked rows read ``MASKED_LNL``; a
    single ``[T, R]`` mask and one ``[R]`` mask broadcast the same way."""
    T, R = 5, 4
    runner = RUNNERS[model](R, "cpu")
    theta = _theta(runner, T, R, seed=2)
    model_ = runner.model.lnl_model()
    want = fused.hf_lnl_plain(model_, runner.spectra, theta)
    for seed in range(3):
        masks = _masks(T, R, seed, "cpu", p_live)
        keep = _keep(masks, T, R)
        for live in (masks, masks[0], masks[2]):
            got = fused.hf_lnl_plain(model_, runner.spectra, theta, live)
            k = _keep(live if isinstance(live, tuple) else (live,), T, R)
            assert torch.equal(got[k], want[k])
            assert bool((got[~k] == fused.MASKED_LNL).all())
        # the entry on CPU tensors is the plain version
        got = fused.hf_lnl_fused(model_, runner.spectra, theta, masks)
        assert torch.equal(got[keep], want[keep])
        assert bool((got[~keep] == np.float32(fused.MASKED_LNL)).all())


def test_live_rows_rejects_what_the_kernel_does_not_take():
    m = torch.ones(6, dtype=torch.bool)
    assert fused.live_rows(None, 12) == ()
    assert fused.live_rows(m, 12) == (m,)
    with pytest.raises(ValueError, match="bool"):
        fused.live_rows(m.float(), 12)
    with pytest.raises(ValueError, match="divides"):
        fused.live_rows(torch.ones(5, dtype=torch.bool), 12)
    with pytest.raises(ValueError, match="exceed"):
        fused.live_rows((m,) * (fused.MAX_MASKS + 1), 12)


def _one_launch_on_cpu(monkeypatch):
    """The runners take the one-launch entry on the CPU too (its plain
    version, which honours the masks), as they do on the card."""
    monkeypatch.setattr(
        Runner, "log_likelihood",
        lambda self, theta, plain=False, live=None: self._log_likelihood(
            theta, fused=True, live=live))


def _fit(runner, cfg, segment_iters):
    gen = torch.Generator().manual_seed(11)
    with profiling.collect() as tr:
        fit = fit_batch(gen, runner, runner.spectra[0].data.shape[0], cfg,
                        n_post=64, segment_iters=segment_iters,
                        device="cpu")
    return fit, tr.counters


FIT_CASES = {
    # candidate iterations and the block's slice fills
    "nh3_cand": ("nh3", dict(), 250),
    # the kill+slice regime from the 8th iteration on
    "nh3_slice": ("nh3", dict(cand_min_acc=0.99), 250),
    "n2hp_cand": ("n2hp", dict(), 250),
    "n2hp_slice": ("n2hp", dict(cand_min_acc=0.99), 250),
    # the traced mode's blocks
    "nh3_traced": ("nh3", dict(), 0),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_masked_fit_equals_unmasked_bit_for_bit(monkeypatch, case):
    """(b) A ``fit_batch`` whose likelihood skips the lanes the sampler
    does not read against the same fit computing every lane: the
    evidence, its error, the calls, the dead points and the posterior
    samples equal bit for bit; and (d) the recorder's live lanes are
    fewer than its lanes there, and equal to them unmasked."""
    model, knobs, seg = FIT_CASES[case]
    cfg = NSConfig(nlive=20, tol=1.0, max_iter=120, **knobs)
    runner = RUNNERS[model](4, "cpu")
    _one_launch_on_cpu(monkeypatch)
    masked, c_masked = _fit(runner, cfg, seg)
    with monkeypatch.context() as m:
        m.setattr(fused, "live_rows", lambda live, B: ())
        plain, c_plain = _fit(runner, cfg, seg)
    for f in ("lnz", "lnz_err", "ncall", "n_dead", "dead_u", "dead_lnl",
              "live_u", "live_lnl", "max_loglike"):
        assert torch.equal(getattr(masked.ns, f), getattr(plain.ns, f)), f
    for f in dataclasses.fields(masked.products):
        a, b = (getattr(p.products, f.name) for p in (masked, plain))
        assert torch.equal(a, b), f.name
    assert c_plain["k1.lanes_live"] == c_plain["k1.lanes"] > 0
    assert c_masked["k1.lanes"] == c_plain["k1.lanes"]
    assert 0 < c_masked["k1.lanes_live"] < c_masked["k1.lanes"]


def test_lane_counters_without_a_mask_count_every_lane():
    """(d) An unmasked call counts all its lanes as live; a masked one its
    live lanes, no more than its lanes."""
    T, R = 3, 4
    runner = _nh3(R, "cpu")
    theta = _theta(runner, T, R, seed=4)
    masks = _masks(T, R, 5, "cpu")
    with profiling.collect() as tr:
        runner._log_likelihood(theta.reshape(T, R, -1), fused=True)
    assert tr.counters["k1.lanes"] == tr.counters["k1.lanes_live"] == T * R
    with profiling.collect() as tr:
        runner._log_likelihood(theta.reshape(T, R, -1), fused=True,
                               live=masks)
    assert tr.counters["k1.lanes"] == T * R
    assert tr.counters["k1.lanes_live"] == int(_keep(masks, T, R).sum())
    # a likelihood path with no masked form ignores the masks
    with profiling.collect() as tr:
        got = runner.log_likelihood(theta.reshape(T, R, -1), live=masks)
    assert "k1.lanes" not in tr.counters
    assert bool((got > fused.MASKED_LNL).all())


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("B", [3200, 51200])
@pytest.mark.parametrize("model", sorted(RUNNERS))
def test_kernel_mask_keeps_live_rows_bit_for_bit(model, B):
    """(c) The kernel at the main path's widths, masked against
    unmasked: all live, all masked and random masks; the live rows equal
    bit for bit, the masked rows read ``MASKED_LNL``, the device counter
    gains the live rows; and a captured masked launch replays the same."""
    _card()
    R = 64
    T = B // R
    runner = RUNNERS[model](R, "cuda")
    theta = _theta(runner, T, R, seed=7)
    model_ = runner.model.lnl_model()
    want = fused.hf_lnl_fused(model_, runner.spectra, theta)
    n0 = fused.hf_lnl_fused.launches
    # what earlier masked launches added, outside any reading here
    torch.cuda.synchronize()
    profiling.read_device_counters("cuda")
    for p_live in (1.0, 0.0, 0.5, 0.25):
        for seed in range(2):
            masks = _masks(T, R, seed, "cuda", p_live)
            keep = _keep(masks, T, R).cuda()
            with profiling.collect() as tr:
                got = fused.hf_lnl_fused(model_, runner.spectra, theta,
                                         masks)
                torch.cuda.synchronize()
                profiling.read_device_counters("cuda")
            assert torch.equal(got[keep], want[keep])
            assert bool((got[~keep] == np.float32(fused.MASKED_LNL)).all())
            assert tr.counters["k1.lanes"] == B
            assert tr.counters["k1.lanes_live"] == int(keep.sum())
    assert fused.hf_lnl_fused.launches == n0 + 8
    # captured on the stream of its eager run, replayed on new masks
    static = _masks(T, R, 9, "cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fused.hf_lnl_fused(model_, runner.spectra, theta, static)
        graph.capture_begin()
        try:
            out = fused.hf_lnl_fused(model_, runner.spectra, theta, static)
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    for seed in (10, 11):
        for s, m in zip(static, _masks(T, R, seed, "cuda")):
            s.copy_(m)
        graph.replay()
        torch.cuda.synchronize()
        keep = _keep(static, T, R).cuda()
        assert torch.equal(out[keep], want[keep])
        assert bool((out[~keep] == np.float32(fused.MASKED_LNL)).all())
