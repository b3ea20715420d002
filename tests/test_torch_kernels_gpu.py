"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Imports neither JAX nor ``nestfit_tpu``, so it also runs on a GPU
machine without them::

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_gpu.py

Without a card every test skips (decided inside the test).
"""

import dataclasses

import numpy as np
import pytest
import torch

from nestfit_tpu_torch.constants import CKMS
from nestfit_tpu_torch.models import ammonia, diazenylium
from nestfit_tpu_torch.models.tables import (
    AMMONIA_TRANSITIONS,
    DIAZENYLIUM_TRANSITIONS,
)
from nestfit_tpu_torch.ops import fused, tables
from nestfit_tpu_torch.priors import (
    get_diazenylium_priors,
    get_gaussian_priors,
    get_irdc_priors,
    make_distribution,
)
from nestfit_tpu_torch.priors import priors as pr
from nestfit_tpu_torch.utils import freq_axis_from_velocity

from _k3_inputs import k3_inputs


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("ncomp, trans_id, R, T, S", [
    (1, 1, 64, 5, 380), (1, 2, 64, 5, 380),
    (2, 1, 64, 5, 380), (2, 2, 64, 5, 380),
    (2, 1, 64, 50, 380),   # B = 3,200: the compacted slice round
    (2, 2, 7, 3, 380),     # B = 21: no multiple of the two rows per block
    (2, 1, 3, 5, 20),      # K = 4, lanes past S
    (2, 1, 3, 5, 256),     # K = 8
    (1, 2, 3, 5, 512),     # K = 16
    (2, 1, 5, 3, 600),     # five chunks of 128 channels (K = 4)
    (1, 1, 2, 3, 1100),    # three chunks of 384 channels (K = 12)
])
def test_hf_chi2_kernel_matches_plain(ncomp, trans_id, R, T, S):
    _card()
    rng = np.random.default_rng(3)
    xarr = freq_axis_from_velocity(np.linspace(-30, 30, S),
                                   AMMONIA_TRANSITIONS[trans_id - 1].nu)
    spec = ammonia.make_ammonia_spectrum(
        xarr, rng.normal(scale=0.2, size=(R, S)), 0.2, trans_id=trans_id)
    utrans = get_irdc_priors()
    u = torch.as_tensor(rng.uniform(size=(T * R, 6 * ncomp)),
                        dtype=torch.float32, device="cuda")
    theta = utrans.transform(u, ncomp, plain=True)
    trans, voff, tex, tau0, sigm = ammonia._component_params(
        spec, theta, False, False)
    args = (trans, spec.dnu, spec.t0, spec.tbg, spec.data,
            *(x.contiguous() for x in (voff, tex, tau0, sigm)))
    n0 = fused.hf_chi2_fused.launches
    got = fused.hf_chi2_fused(*args)
    torch.cuda.synchronize()
    assert fused.hf_chi2_fused.launches == n0 + 1
    assert got.shape == (T * R,)
    torch.testing.assert_close(got, fused.hf_chi2_plain(*args),
                               rtol=2e-4, atol=1e-3)


@pytest.mark.gpu
def test_hf_chi2_kernel_at_the_line_cap():
    """``MAX_LINES`` lines at ``MAX_COMP`` components: the per-row tables
    fill the 48 KB of dynamic shared memory."""
    _card()
    base = DIAZENYLIUM_TRANSITIONS[2]
    reps = -(-fused.MAX_LINES // base.nhf)
    voff = np.concatenate([base.voff + 0.37 * k for k in range(reps)])
    wts = np.tile(base.tau_wts, reps)[:fused.MAX_LINES]
    trans = dataclasses.replace(base, voff=voff[:fused.MAX_LINES],
                                tau_wts=wts / wts.sum())
    assert trans.nhf == fused.MAX_LINES
    R, T, C = 4, 5, fused.MAX_COMP
    rng = np.random.default_rng(8)
    xarr = freq_axis_from_velocity(np.arange(-20, 20, 0.1), trans.nu)
    spec = diazenylium.make_diazenylium_spectrum(
        xarr, rng.normal(scale=0.1, size=(R, xarr.shape[0])), 0.1,
        trans_id=3)
    comps = [torch.as_tensor(rng.uniform(lo, hi, (T * R, C)),
                             dtype=torch.float32, device="cuda")
             for lo, hi in ((-4, 4), (2.8, 12), (0.01, 2), (0.05, 1))]
    args = (trans, spec.dnu, spec.t0, spec.tbg, spec.data, *comps)
    got = fused.hf_chi2_fused(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fused.hf_chi2_plain(*args),
                               rtol=2e-4, atol=1e-3)


@pytest.mark.gpu
def test_table_kernels_match_plain():
    """K2 and K3 are their plain versions bit for bit: the same float32
    operations, in the same order, each rounded on its own."""
    _card()
    x = np.linspace(-4, 4, 500)
    d = make_distribution(x, np.exp(-0.5 * (x / 1.7) ** 2) + 0.05)
    rng = np.random.default_rng(5)
    s = torch.as_tensor(rng.uniform(0, d.size - 1, 4096),
                        dtype=torch.float32, device="cuda")
    assert torch.equal(tables.table_lerp(d.ppf, s),
                       tables.table_lerp_plain(d.ppf, s))
    ends = tables.table_lerp(d.ppf, torch.tensor([0.0, d.size - 1.0],
                                                 device="cuda"))
    assert torch.equal(ends, d.ppf[[0, -1]])
    cols = [torch.as_tensor(a, device="cuda")
            for a in k3_inputs(d.size, d.xmin, d.xmax, d.dx, seed=5)]
    for sf in (0, 1, 2):
        assert torch.equal(tables.tapered_invert(d, *cols, sf),
                           tables.tapered_invert_plain(d, *cols, sf))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [3200, 51200, 102400])
@pytest.mark.parametrize("grid", ["irdc", "flat"])
def test_tapered_invert_kernel_equals_plain_at_path_widths(grid, B):
    """K3 at the widths the path launches (the compacted slice round,
    the NH3/N2H+ and the Gaussian candidate rounds), on the voff grids
    of ``get_irdc_priors`` and ``get_diazenylium_priors``; the edge cases
    and the seed-1 element repeat through the batch."""
    _card()
    ctor = get_irdc_priors if grid == "irdc" else get_diazenylium_priors
    d = ctor().priors[0].vcen_prior.dist
    cols = [torch.as_tensor(np.resize(a, B), device="cuda")
            for a in k3_inputs(d.size, d.xmin, d.xmax, d.dx, seed=B)]
    n0 = tables.tapered_invert.launches
    for sf in (0, 1, 2):
        got = tables.tapered_invert(d, *cols, sf)
        assert got.shape == (B,)
        assert torch.equal(got, tables.tapered_invert_plain(d, *cols, sf))
    assert tables.tapered_invert.launches == n0 + 3


@pytest.mark.gpu
@pytest.mark.parametrize("ctor, n_param", [
    (get_irdc_priors, 6), (get_gaussian_priors, 3),
    (get_diazenylium_priors, 4)])
def test_transform_kernel_path_equals_plain(ctor, n_param):
    """The whole prior transform at ncomp 2, kernels against plain
    versions: bit for bit, so the forward check compares likelihoods
    on one set of parameters."""
    _card()
    u = torch.as_tensor(np.random.default_rng(9).uniform(
        size=(50, 1024, 2 * n_param)), dtype=torch.float32, device="cuda")
    utrans = ctor()
    assert torch.equal(utrans.transform(u, 2),
                       utrans.transform(u, 2, plain=True))


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take():
    _card()
    x = np.linspace(-4, 4, 500)
    d = make_distribution(x, np.exp(-x**2))
    with pytest.raises(ValueError, match="float32"):
        tables.table_lerp(d.ppf, torch.zeros(8, dtype=torch.float64,
                                             device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        tables.table_lerp(d.ppf, torch.zeros(8, 2, device="cuda")[:, 0])


@pytest.mark.gpu
@pytest.mark.parametrize("trans_id", [2, 3])
def test_hf_chi2_kernel_on_n2hp_lines_matches_plain(trans_id):
    """N2H+ (2-1) and (3-2): 40 and 45 hyperfine lines."""
    _card()
    R, T, ncomp = 64, 5, 2
    rng = np.random.default_rng(4)
    xarr = freq_axis_from_velocity(np.arange(-20, 20, 0.1),
                                   DIAZENYLIUM_TRANSITIONS[trans_id - 1].nu)
    spec = diazenylium.make_diazenylium_spectrum(
        xarr, rng.normal(scale=0.1, size=(R, xarr.shape[0])), 0.1,
        trans_id=trans_id)
    u = torch.as_tensor(rng.uniform(size=(T * R, 4 * ncomp)),
                        dtype=torch.float32, device="cuda")
    theta = get_diazenylium_priors().transform(u, ncomp, plain=True)
    trans, voff, tex, tau0, sigm = diazenylium._component_params(spec, theta)
    assert trans.nhf > 32
    args = (trans, spec.dnu, spec.t0, spec.tbg, spec.data,
            *(x.contiguous() for x in (voff, tex, tau0, sigm)))
    got = fused.hf_chi2_fused(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fused.hf_chi2_plain(*args),
                               rtol=2e-4, atol=1e-3)


def _gauss_args(ncomp, R=64, T=5, seed=6, S=380):
    """Gaussian-ladder inputs: ``S`` channels of 0.158 km/s around the
    NH3 (1,1) line, components from the ``get_gaussian_priors``
    transform."""
    rng = np.random.default_rng(seed)
    rest = AMMONIA_TRANSITIONS[0].nu
    dnu = torch.as_tensor(
        freq_axis_from_velocity(0.158 * (np.arange(S) - S // 2), rest)
        - rest, dtype=torch.float32, device="cuda")
    data = torch.as_tensor(rng.normal(scale=0.15, size=(R, S)),
                           dtype=torch.float32, device="cuda")
    u = torch.as_tensor(rng.uniform(size=(T * R, 3 * ncomp)),
                        dtype=torch.float32, device="cuda")
    theta = get_gaussian_priors().transform(u, ncomp, plain=True)
    voff, sigm, peak = (theta[:, i * ncomp:(i + 1) * ncomp].contiguous()
                        for i in range(3))
    return rest / CKMS, dnu, data, voff, sigm, peak


@pytest.mark.gpu
@pytest.mark.parametrize("ncomp", [1, 2, 3])
def test_gauss_chi2_kernel_matches_plain(ncomp):
    _card()
    args = _gauss_args(ncomp)
    n0 = fused.gauss_chi2_fused.launches
    got = fused.gauss_chi2_fused(*args)
    torch.cuda.synchronize()
    assert fused.gauss_chi2_fused.launches == n0 + 1
    torch.testing.assert_close(got, fused.gauss_chi2_plain(*args),
                               rtol=2e-4, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [380, 400, 1000])
@pytest.mark.parametrize("T, R", [(1, 64), (3, 64), (100, 64), (1, 1024),
                                  (3, 1024), (100, 1024)])
def test_gauss_chi2_kernel_matches_plain_at_every_width(T, R, S):
    """C = 1..8; the launcher groups 8 proposals a warp at T = 100,
    R = 1024 (the last group short), fewer on smaller grids; S = 1000
    runs in chunks."""
    _card()
    for ncomp in range(1, fused.MAX_COMP + 1):
        args = _gauss_args(ncomp, R=R, T=T, seed=ncomp, S=S)
        got = fused.gauss_chi2_fused(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, fused.gauss_chi2_plain(*args),
                                   rtol=2e-4, atol=1e-3)


@pytest.mark.gpu
def test_gauss_chi2_wrapper_rejects_what_the_kernel_does_not_take():
    _card()
    fc, dnu, data, voff, sigm, peak = _gauss_args(2)
    n0 = fused.gauss_chi2_fused.launches
    with pytest.raises(ValueError, match="float32"):
        fused.gauss_chi2_fused(fc, dnu, data, voff.double(), sigm, peak)
    wide = torch.stack([sigm, sigm], dim=-1)[..., 0]     # strided view
    assert not wide.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        fused.gauss_chi2_fused(fc, dnu, data, voff, wide, peak)
    assert fused.gauss_chi2_fused.launches == n0


#: one-launch likelihood cases: model, (trans_id, channels) a spectrum,
#: ncomp, R, T, noise per row (else one value)
LNL_CASES = {
    "nh3_c1": ("ammonia", ((1, 380), (2, 380)), 1, 64, 5, True),
    "nh3_c2": ("ammonia", ((1, 380), (2, 380)), 2, 64, 5, True),
    # B = 3,200: the compacted slice round
    "nh3_compacted": ("ammonia", ((1, 380), (2, 380)), 2, 64, 50, True),
    # B = 21, no multiple of the two rows a block; one noise value
    "nh3_odd": ("ammonia", ((1, 380), (2, 380)), 2, 7, 3, False),
    # three transitions (one warp a block idle), the ortho (3,3), and a
    # channel count a transition (the K that fits them all)
    "nh3_three": ("ammonia", ((1, 380), (2, 256), (3, 600)), 2, 5, 3, True),
    "nh3_four": ("ammonia", ((1, 384), (2, 384), (3, 384), (4, 384)), 3, 4,
                 3, True),
    "n2hp_c1": ("diazenylium", ((1, 400),), 1, 64, 5, True),
    "n2hp_c2": ("diazenylium", ((1, 400),), 2, 64, 5, True),
    "n2hp_two": ("diazenylium", ((1, 400), (3, 400)), 2, 64, 5, True),
}


def _lnl_case(name, seed=11):
    """The case's runner on the card and ``[T * R, ndim]`` parameters
    drawn from its prior."""
    from nestfit_tpu_torch.models import RUNNERS

    model, spectra, ncomp, R, T, per_row = LNL_CASES[name]
    mod = ammonia if model == "ammonia" else diazenylium
    vmax, noise = (30, 0.2) if model == "ammonia" else (20, 0.1)
    rng = np.random.default_rng(seed)
    specs = []
    for tid, S in spectra:
        xarr = freq_axis_from_velocity(np.linspace(-vmax, vmax, S),
                                       mod.TRANSITIONS[tid - 1].nu)
        sig = rng.uniform(0.7, 1.3, R) * noise if per_row else noise
        specs.append(mod.make_model_spectrum(
            xarr, rng.normal(scale=noise, size=(R, S)), sig,
            trans_id=tid))
    utrans = (get_irdc_priors if model == "ammonia"
              else get_diazenylium_priors)()
    runner = RUNNERS[model](tuple(specs), utrans, ncomp=ncomp)
    u = torch.as_tensor(rng.uniform(size=(T * R, runner.ndim)),
                        dtype=torch.float32, device="cuda")
    return runner, utrans.transform(u, ncomp, plain=True)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(LNL_CASES))
def test_hf_lnl_kernel_matches_plain_and_the_split_path(name, monkeypatch):
    """The one-launch likelihood against its plain version on the same
    CUDA tensors, and against the runner's two-launch path (a K1 launch a
    transition after the model's prep ops, scaled by the runner), at
    K1's bar."""
    _card()
    runner, theta = _lnl_case(name)
    assert runner.one_launch
    n0, s0 = fused.hf_lnl_fused.launches, fused.hf_chi2_fused.launches
    got = runner.model.fused_lnl(runner.spectra, theta)
    torch.cuda.synchronize()
    assert fused.hf_lnl_fused.launches == n0 + 1
    assert fused.hf_chi2_fused.launches == s0
    assert got.shape == (theta.shape[0],) and got.dtype == torch.float32
    plain = fused.hf_lnl_plain(runner.model.lnl_model(), runner.spectra,
                               theta)
    torch.testing.assert_close(got, plain, rtol=2e-4, atol=1e-3)
    # the runner's path on [T, R, ndim] proposals, then the split one
    R = runner.spectra[0].data.shape[0]
    th = theta.reshape(-1, R, theta.shape[-1])
    lnl = runner._log_likelihood(th, fused=True)
    assert torch.equal(lnl.reshape(-1), got)
    with monkeypatch.context() as m:
        m.setattr(type(runner), "one_launch", False)
        split = runner._log_likelihood(th, fused=True)
    torch.cuda.synchronize()
    assert fused.hf_chi2_fused.launches == s0 + len(runner.spectra)
    torch.testing.assert_close(lnl, split, rtol=2e-4, atol=1e-3)


@pytest.mark.gpu
def test_hf_lnl_kernel_at_the_line_cap():
    """``MAX_LINES`` lines at ``MAX_COMP`` components in two transitions:
    the launch opts in to 96 KB of tables."""
    _card()
    base = DIAZENYLIUM_TRANSITIONS[2]
    reps = -(-fused.MAX_LINES // base.nhf)
    voff = np.concatenate([base.voff + 0.37 * k for k in range(reps)])
    wts = np.tile(base.tau_wts, reps)[:fused.MAX_LINES]
    trans = dataclasses.replace(base, voff=voff[:fused.MAX_LINES],
                                tau_wts=wts / wts.sum())
    model = dataclasses.replace(
        diazenylium.lnl_model(), transitions=(trans,) * 3,
        components=lambda spec, p: (
            trans, *diazenylium._component_params(spec, p)[1:]))
    R, T, C = 4, 5, fused.MAX_COMP
    rng = np.random.default_rng(8)
    xarr = freq_axis_from_velocity(np.arange(-20, 20, 0.1), trans.nu)
    specs = tuple(diazenylium.make_diazenylium_spectrum(
        xarr, rng.normal(scale=0.1, size=(R, xarr.shape[0])), 0.1,
        trans_id=tid) for tid in (1, 3))
    theta = torch.as_tensor(np.concatenate(
        [rng.uniform(lo, hi, (T * R, C)) for lo, hi in
         ((-4, 4), (2.8, 12), (-2, 0.3), (0.05, 1))], axis=1),
        dtype=torch.float32, device="cuda")
    got = fused.hf_lnl_fused(model, specs, theta)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fused.hf_lnl_plain(model, specs, theta),
                               rtol=2e-4, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["nh3_c2", "n2hp_two"])
def test_hf_lnl_graph_replay_equals_eager(name):
    """The entry captured in a CUDA graph and replayed on new parameters
    (copied into the captured input) gives the eager launch's lnL bit
    for bit: the transitions are summed in a fixed order."""
    _card()
    runner, theta = _lnl_case(name)
    _, theta2 = _lnl_case(name, seed=12)
    static = theta.clone()
    eager = runner.model.fused_lnl(runner.spectra, static)   # warm-up
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = runner.model.fused_lnl(runner.spectra, static)
    n0 = fused.hf_lnl_fused.launches
    for th in (theta2, theta):
        static.copy_(th)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, runner.model.fused_lnl(runner.spectra, th))
    assert torch.equal(out, eager)
    assert fused.hf_lnl_fused.launches == n0 + 2


@pytest.mark.gpu
def test_hf_lnl_wrapper_rejects_what_the_kernel_does_not_take():
    _card()
    runner, theta = _lnl_case("n2hp_c2")
    with pytest.raises(ValueError, match="contiguous"):
        fused.hf_lnl_fused(runner.model.lnl_model(), runner.spectra,
                           theta.repeat(1, 2)[:, ::2])
    with pytest.raises(ValueError, match="exceed"):
        runner.model.fused_lnl(runner.spectra, torch.zeros(
            (theta.shape[0], 4 * 9), device="cuda"))
    with pytest.raises(ValueError, match="exceed"):
        runner.model.fused_lnl(runner.spectra * 5, theta)


PRIOR_CASES = {"irdc_c1": (get_irdc_priors, 1),
               "irdc_c2": (get_irdc_priors, 2),
               "irdc_c3": (get_irdc_priors, 3),
               "n2hp_c2": (get_diazenylium_priors, 2),
               "gauss_c3": (get_gaussian_priors, 3)}


def _prior_rows(utrans, ncomp, B, seed):
    """``[B, n_param * ncomp]`` unit-cube rows on the card: uniform
    draws, rows of 0 and 1, grid nodes, and a tenth with the widths near
    the top of their prior (the placement's shrink-to-fit at ncomp 3)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(B, utrans.n_param, ncomp))
    u[:8], u[8:16] = 0.0, 1.0
    size = utrans.priors[0].dist.size
    u[16:216] = rng.integers(0, size, size=(200,) + u.shape[1:]) / (size - 1)
    u[-B // 10:, utrans.priors[0].sigm_prior.p_ix] = rng.uniform(
        0.99, 1.0, size=(B // 10, ncomp))
    return torch.as_tensor(u.reshape(B, -1), dtype=torch.float32,
                           device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B", [3200, 51200])
@pytest.mark.parametrize("case", list(PRIOR_CASES))
def test_prior_transform_kernel_equals_plain(case, B):
    """The one-launch transform at the path's widths (the compacted
    slice round, the candidate round) is its plain version, the per-prior
    plain path and the per-prior kernel path, bit for bit."""
    _card()
    ctor, ncomp = PRIOR_CASES[case]
    utrans = ctor()
    u = _prior_rows(utrans, ncomp, B, seed=B + ncomp)
    prog = utrans.program(ncomp, u.device)
    n0 = tables.prior_transform_fused.launches
    got = tables.prior_transform_fused(prog, u)
    assert tables.prior_transform_fused.launches == n0 + 1
    assert torch.equal(got, tables.prior_transform_plain(prog, u))
    assert torch.equal(got, utrans.transform(u, ncomp, plain=True))
    assert torch.equal(got, pr.transform_per_prior(utrans.priors, u, ncomp))
    assert torch.equal(utrans.transform(u, ncomp), got)


@pytest.mark.gpu
def test_prior_transform_kernel_replays_after_a_rebuild():
    """The launch captured in a CUDA graph reads the tables by address:
    replayed after another transformer and a runner on this one were
    built in between, on new rows, it equals the eager launch and the
    plain version."""
    _card()
    utrans = get_irdc_priors()
    u1 = _prior_rows(utrans, 2, 3200, seed=1)
    u2 = _prior_rows(utrans, 2, 3200, seed=2)
    static = u1.clone()
    eager = utrans.transform(static, 2)   # warm-up
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = utrans.transform(static, 2)
    from nestfit_tpu_torch.models import AmmoniaRunner

    runner, _ = _lnl_case("nh3_c2")
    AmmoniaRunner(runner.spectra, utrans, ncomp=2, device="cuda")
    get_irdc_priors().transform(u2, 2)
    n0 = tables.prior_transform_fused.launches
    for u in (u2, u1):
        static.copy_(u)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, utrans.transform(u, 2, plain=True))
        assert torch.equal(out, utrans.transform(u, 2))
    assert torch.equal(out, eager)
    # the two eager launches; a bare replay counts nothing
    assert tables.prior_transform_fused.launches == n0 + 2


@pytest.mark.gpu
@pytest.mark.parametrize("segment_iters", [250, 0])
def test_fit_batch_through_the_one_launch_equals_the_per_prior_path(
        segment_iters, monkeypatch):
    """A rung-2 NH3 ``fit_batch`` (R = 64, fixed seed) through the one
    launch and through the per-prior path (the dispatch patched to refuse
    every transformer): the same lnZ, calls and dead points; the first
    counts only ``prior.fused``, the second only ``prior.split``."""
    _card()
    from nestfit_tpu_torch import synth
    from nestfit_tpu_torch.models import AmmoniaRunner
    from nestfit_tpu_torch.sampling import NSConfig, fit_batch, graphs
    from nestfit_tpu_torch.utils import profiling

    arrays = synth.make_synth_cube_arrays(
        n_pix=64, noise=0.15, rng=np.random.default_rng(0))[:2]
    specs = [ammonia.make_ammonia_spectrum(x, d, np.full(64, 0.15),
                                           trans_id=t, device="cuda")
             for t, (x, d) in enumerate(arrays, 1)]
    runner = AmmoniaRunner(specs, get_irdc_priors(), ncomp=2, device="cuda")
    cfg = NSConfig(nlive=100, tol=1.0, init_factor=4)

    def fit():
        graphs.clear()
        gen = torch.Generator(device="cuda").manual_seed(7)
        with profiling.collect() as tr:
            res = fit_batch(gen, runner, 64, cfg, n_post=64,
                            segment_iters=segment_iters, device="cuda")
        torch.cuda.synchronize()
        return res.ns, tr.counters

    fused_ns, c_fused = fit()
    monkeypatch.setattr(pr.PriorTransformer, "program",
                        lambda self, ncomp, device: None)
    split_ns, c_split = fit()
    graphs.clear()
    for f in ("lnz", "lnz_err", "ncall", "n_dead", "dead_u", "dead_lnl",
              "dead_lnw", "live_u", "live_lnl"):
        assert torch.equal(getattr(fused_ns, f), getattr(split_ns, f)), f
    assert c_fused["prior.fused"] > 0 and "prior.split" not in c_fused
    assert c_split["prior.split"] == c_fused["prior.fused"]
    assert "prior.fused" not in c_split
