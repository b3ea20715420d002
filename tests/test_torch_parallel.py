"""Port parity of multi-device fitting (``nestfit_tpu_torch/parallel``,
``run_nested``/``fit_batch``/``posterior_modes``/``CubeFitter`` with
``mesh=``) on CPU meshes, where a device repeats: the mesh helpers and
the per-process pixel partitions against ``nestfit_tpu.parallel``, a
``(2, 2)`` ``fit_batch`` against the JAX package's own ``(4, 2)`` mesh
run of ``tests/test_parallel.py``, a ``(1, 1)`` mesh bit for bit equal
to no mesh, and the channel-sliced (sp = 2) likelihood against sp = 1."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random
from jax.sharding import PartitionSpec as P

from nestfit_tpu.models import AmmoniaRunner as JaxRunner, ammonia as jammonia
from nestfit_tpu.parallel import distributed as jdist
from nestfit_tpu.parallel import make_mesh as jax_make_mesh
from nestfit_tpu.parallel import pad_to_multiple as jax_pad
from nestfit_tpu.parallel import shard_pixel_batch as jax_shard
from nestfit_tpu.priors import get_irdc_priors as jax_priors
from nestfit_tpu.sampling import NSConfig as JaxConfig
from nestfit_tpu.sampling.fit import fit_batch as jax_fit_batch

from nestfit_tpu_torch import cube as tcube
from nestfit_tpu_torch import oracle
from nestfit_tpu_torch.cube import CubeFitter, HdfStore
from nestfit_tpu_torch.models import (
    AmmoniaRunner,
    DiazenyliumRunner,
    GaussianRunner,
    ammonia,
    diazenylium,
    gaussian,
)
from nestfit_tpu_torch.models.tables import (
    AMMONIA_TRANSITIONS,
    DIAZENYLIUM_TRANSITIONS,
)
from nestfit_tpu_torch.ops import _build
from nestfit_tpu_torch.parallel import (
    distributed,
    make_mesh,
    pad_to_multiple,
    pixel_sharding,
    replicated,
    shard_pixel_batch,
)
from nestfit_tpu_torch.priors import (
    get_diazenylium_priors,
    get_gaussian_priors,
    get_irdc_priors,
)
from nestfit_tpu_torch.sampling import (
    NSConfig,
    fit_batch,
    graphs,
    information_criteria,
    posterior_modes,
    run_nested,
)
from nestfit_tpu_torch.sampling.sampler import ns_init
from nestfit_tpu_torch.utils import freq_axis_from_velocity

from _cube_inputs import SIGNAL, synth_stack

CPU = "cpu"
# tests/test_parallel.py::test_fit_batch_on_mesh
N_PIX, N_CHAN = 16, 64
PARAMS = np.array([0.0, 11.0, 5.0, 14.3, 0.5, 0.0])
CFG = dict(nlive=40, tol=1.0, max_iter=1200)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def test_mesh_helpers_match_jax():
    """``make_mesh`` shapes, ``shard_pixel_batch`` shard shapes, and the
    placement descriptors against the JAX helpers on 8 devices."""
    jmesh = jax_make_mesh(8, sp=2)
    mesh = make_mesh(devices=[CPU] * 8, sp=2)
    assert mesh.shape == dict(jmesh.shape) == {"dp": 4, "sp": 2}
    assert make_mesh(4, devices=[CPU] * 8).shape == \
        dict(jax_make_mesh(4).shape)
    with pytest.raises(AssertionError):
        make_mesh(6, sp=4, devices=[CPU] * 8)
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    for shard_channels in (False, True):
        jt = jax_shard(jmesh, {"d": jnp.asarray(x)}, shard_channels)
        want = {s.data.shape for s in jt["d"].addressable_shards}
        got = shard_pixel_batch(mesh, x, shard_channels)
        shapes = {tuple(t.shape) for s in got.shards
                  for t in (s if shard_channels else (s,))}
        assert shapes == want
        flat = torch.cat([torch.cat(s, dim=-1) if shard_channels else s
                          for s in got.shards])
        assert torch.equal(flat, torch.as_tensor(x))
    assert pixel_sharding(mesh, True).spec == tuple(P("dp", "sp"))
    assert pixel_sharding(mesh).spec == tuple(P("dp"))
    assert replicated(mesh).spec == tuple(P())


@pytest.mark.parametrize("shape,multiple,axis", [
    ((6, 3), 4, 0), ((8, 3), 4, 0), ((5,), 3, 0), ((2, 7), 4, 1),
    ((0, 2), 2, 0)])
def test_pad_to_multiple_matches_jax(shape, multiple, axis):
    arr = np.arange(int(np.prod(shape)), dtype=float).reshape(shape)
    got, n = pad_to_multiple(arr, multiple, axis=axis, fill=-1.0)
    want, n_j = jax_pad(arr, multiple, axis=axis, fill=-1.0)
    assert n == n_j
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 10, 103])
@pytest.mark.parametrize("pc", [1, 2, 3, 4])
def test_host_partitions_match_jax(n, pc):
    for pi in range(pc):
        assert distributed.host_pixel_shard(n, pi, pc) == \
            jdist.host_pixel_shard(n, pi, pc)
        np.testing.assert_array_equal(
            distributed.host_pixel_stripe(n, pi, pc),
            jdist.host_pixel_stripe(n, pi, pc))


def _spectra():
    """The toy NH3 pair of ``tests/test_parallel.py`` (same draws)."""
    rng = np.random.default_rng(2)
    vaxis = np.linspace(-10, 10, N_CHAN)
    out = []
    for tid in (1, 2):
        xarr = freq_axis_from_velocity(vaxis,
                                       AMMONIA_TRANSITIONS[tid - 1].nu)
        d = rng.normal(scale=0.2, size=(N_PIX, N_CHAN)) + \
            oracle.amm_predict(xarr, PARAMS, trans_id=tid)
        out.append((tid, xarr, d))
    return out


def _runner(ncomp=1):
    spectra = [ammonia.make_ammonia_spectrum(x, d, np.full(N_PIX, 0.2),
                                             trans_id=tid, device=CPU)
               for tid, x, d in _spectra()]
    return AmmoniaRunner(spectra, get_irdc_priors(vsys=0.0, device=CPU),
                         ncomp=ncomp, device=CPU)


def _jax_mesh_fit():
    """``tests/test_parallel.py::test_fit_batch_on_mesh``: the JAX
    package's fit of the same spectra on its ``(4, 2)`` mesh."""
    import jax

    spectra = []
    for tid, x, d in _spectra():
        spec = jammonia.make_ammonia_spectrum(x, d, 0.2, trans_id=tid)
        spectra.append(dataclasses.replace(
            spec, noise=jnp.full((N_PIX,), 0.2, dtype=spec.data.dtype)))
    runner = JaxRunner(spectra, jax_priors(vsys=0.0), ncomp=1)
    mesh = jax_make_mesh(8, sp=2)
    data = jax_shard(mesh, runner.data_tree())
    with jax.set_mesh(mesh):
        fit = jax_fit_batch(random.key(7), runner, N_PIX, JaxConfig(**CFG),
                            n_post=64, segment_iters=200, data=data)
        return np.asarray(fit.lnz), np.asarray(fit.lnz_err)


def test_fit_batch_on_mesh_matches_jax_mesh_run():
    """A ``(2, 2)`` CPU mesh at the toy size of the JAX mesh test: every
    lnZ finite, the centroid within 1.0 of the truth, the null evidence
    and the information criteria those of the whole spectra, and lnZ
    within the combined errors of the JAX ``(4, 2)`` run."""
    runner = _runner()
    mesh = make_mesh(devices=[CPU] * 4, sp=2)
    gen = torch.Generator().manual_seed(7)
    fit = fit_batch(gen, runner, N_PIX, NSConfig(**CFG), n_post=64,
                    segment_iters=200, device=CPU, mesh=mesh)
    lnz, err = fit.lnz.numpy(), fit.lnz_err.numpy()
    assert lnz.shape == (N_PIX,) and np.isfinite(lnz).all()
    assert torch.isfinite(fit.products.bestfit_params).all()
    med = fit.products.marginals[:, 4, 0].numpy()
    assert np.all(np.abs(med - PARAMS[0]) < 1.0)
    assert fit.n_chan_tot == 2 * N_CHAN
    torch.testing.assert_close(fit.null_lnz, runner.null_lnZ, rtol=0, atol=0)
    want = information_criteria(fit.ns.max_loglike, runner.null_lnZ,
                                runner.n_chan_tot, runner.n_params)
    for k, v in want.items():
        torch.testing.assert_close(fit.ics[k], v, rtol=0, atol=0)
    j_lnz, j_err = _jax_mesh_fit()
    d = lnz - j_lnz
    comb = np.sqrt(err ** 2 + j_err ** 2)
    assert abs(np.median(d)) <= np.median(comb), (d, comb)
    assert np.all(np.abs(d) <= 4 * comb), (d, comb)


@pytest.mark.parametrize("segment_iters", [200, 0])
def test_one_by_one_mesh_is_no_mesh(segment_iters):
    """A ``(1, 1)`` mesh on the runner's device gives the no-mesh result
    bit for bit, in both sampler modes."""
    runner = _runner()
    fits = []
    for mesh in (None, make_mesh(devices=[CPU])):
        gen = torch.Generator().manual_seed(11)
        fits.append(fit_batch(gen, runner, N_PIX, NSConfig(**CFG),
                              n_post=32, segment_iters=segment_iters,
                              device=CPU, mesh=mesh))
    a, b = fits
    for f in dataclasses.fields(a.ns):
        x, y = getattr(a.ns, f.name), getattr(b.ns, f.name)
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    for f in dataclasses.fields(a.products):
        assert torch.equal(getattr(a.products, f.name),
                           getattr(b.products, f.name)), f.name


def _u(shape, seed=0):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed),
                      dtype=torch.float32)


def _gauss_runner():
    rng = np.random.default_rng(4)
    rest = AMMONIA_TRANSITIONS[0].nu
    xarr = freq_axis_from_velocity(np.arange(-30, 30, 0.158), rest)
    data = np.stack([oracle.gauss_predict(xarr, np.array([0.5, 0.4, 2.0]),
                                          rest) for _ in range(8)])
    data += rng.normal(scale=0.15, size=data.shape)
    spec = gaussian.make_gaussian_spectrum(xarr, data, np.full(8, 0.15),
                                           rest_freq=rest, device=CPU)
    return GaussianRunner(spec, get_gaussian_priors(device=CPU), ncomp=2,
                          device=CPU)


def _n2hp_runner():
    rng = np.random.default_rng(5)
    spectra = []
    for tid in (1, 3):
        xarr = freq_axis_from_velocity(
            np.arange(-20, 20, 0.1), DIAZENYLIUM_TRANSITIONS[tid - 1].nu)
        data = np.stack([oracle.nnhp_predict(
            xarr, np.array([-1.0, 1.0, 6.0, 7.0, 0.2, -0.1, 0.3, 0.4]),
            trans_id=tid)] * 8) + rng.normal(scale=0.1, size=(8, 400))
        spectra.append(diazenylium.make_diazenylium_spectrum(
            xarr, data, np.full(8, 0.1), trans_id=tid, device=CPU))
    return DiazenyliumRunner(spectra, get_diazenylium_priors(device=CPU),
                             ncomp=2, device=CPU)


@pytest.mark.parametrize("which", ["ammonia", "gaussian", "diazenylium"])
def test_sp2_loglike_matches_sp1(which):
    """The likelihood over two channel slices (each slice's partial
    chi-square, summed, then scaled once) equals the whole-spectrum one
    within rtol 1e-6; ``null_lnZ`` and ``n_chan_tot`` stay the whole
    spectra's."""
    runner = {"ammonia": lambda: _runner(ncomp=2),
              "gaussian": _gauss_runner,
              "diazenylium": _n2hp_runner}[which]()
    sliced = runner.placed([CPU, CPU])
    assert [len(s) for s in runner.channel_slices] == [1] * runner.n_spec
    assert [len(s) for s in sliced.channel_slices] == [2] * runner.n_spec
    assert not sliced.spans_devices
    R = runner.spectra[0].data.shape[0]
    u = _u((5, R, runner.ndim))
    want = runner.loglike_unit(u)
    got = sliced.loglike_unit(u)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert sliced.n_chan_tot == runner.n_chan_tot
    assert torch.equal(sliced.null_lnZ, runner.null_lnZ)
    assert [sum(hi - lo for lo, hi, _ in s) for s in sliced.channel_slices] \
        == [s.size for s in runner.spectra]


def test_run_nested_on_a_mesh():
    """``run_nested`` with a likelihood of explicit data splits the runs
    over dp = 2: the evidence of a normalized Gaussian (lnZ = 0) on every
    run, and ``posterior_modes`` on the mesh equals no mesh."""
    ndim, sigma, R = 3, 0.1, 8
    lnz_true = 0.0       # a normalized density well inside the cube
    centre = torch.full((R, ndim), 0.5)

    def loglike(u, c):
        return torch.sum(-0.5 * ((u - c) / sigma) ** 2, dim=-1) \
            - ndim * np.log(sigma * np.sqrt(2 * np.pi))

    mesh = make_mesh(devices=[CPU] * 2)
    res = run_nested(torch.Generator().manual_seed(3), loglike, ndim, R,
                     NSConfig(nlive=60, tol=0.5), data=centre,
                     segment_iters=100, mesh=mesh)
    lnz, err = res.lnz.numpy(), res.lnz_err.numpy()
    assert lnz.shape == (R,)
    assert np.all(np.abs(lnz - lnz_true) < 4 * err + 0.1), (lnz, err)
    whole = posterior_modes(res, lambda u: u)
    split = posterior_modes(res, lambda u: u, mesh=mesh)
    for f in dataclasses.fields(whole):
        assert torch.equal(getattr(whole, f.name), getattr(split, f.name))


def test_cube_fitter_with_mesh(tmp_path):
    """``CubeFitter(mesh=)`` at dp = 2 on the 4x2 stack: batches padded to
    a multiple of dp, every valid pixel recorded, the signal pixels
    detected."""
    mesh = make_mesh(devices=[CPU] * 2)
    fitter = CubeFitter(
        synth_stack(tcube), get_irdc_priors(vsys=0.0, device=CPU),
        AmmoniaRunner, ncomp_max=1, ns_kwargs={"nlive": 40, "tol": 1.0},
        batch_size=8, n_post=64, nlive_buckets=1, segment_iters=128,
        mode_loss_retries=0, boundary_band=0, mesh=mesh, device=CPU)
    assert fitter._dp_size == 2
    assert fitter._pad_quantum(5) % 2 == 0 and fitter._pad_quantum(7) == 8
    name = str(tmp_path / "mesh_cube")
    fitter.fit_cube(store_name=name, seed=4)
    with HdfStore(name) as store:
        groups = {(int(g.attrs["i_lon"]), int(g.attrs["i_lat"])):
                  int(g.attrs["nbest"]) for g in store.iter_pix_groups()}
    assert len(groups) == 7
    assert {p for p, n in groups.items() if n == 1} == set(SIGNAL)


def test_launch_counts_are_thread_safe():
    """Launch counters add up over threads, and a thread's recording (a
    graph capture) keeps its launches off them."""
    def wrapper():
        _build.count_launch(wrapper)

    wrapper.launches = 0

    def many():
        for _ in range(2000):
            wrapper()

    threads = [threading.Thread(target=many) for _ in range(4)]
    with _build.recording() as rec:
        for _ in range(3):
            wrapper()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert rec == {wrapper: 3}
    assert wrapper.launches == 8000
    _build.add_launches({wrapper: 5})
    assert wrapper.launches == 8005


def test_programs_are_kept_per_dp_row():
    """Each dp row keeps its own last ``_PROGRAMS_CAP`` traced programs:
    the two rungs of a ladder on dp = 2 (four programs) evict none, and
    a third rung evicts only the oldest of each row."""
    cfg = NSConfig(nlive=8).resolved(2)
    gen = torch.Generator().manual_seed(0)
    rungs = [lambda u, d, k=k: -k * torch.sum(u * u, dim=-1)
             for k in (1.0, 2.0, 3.0)]
    states = {}
    graphs.clear()
    try:
        for r, loglike2 in enumerate(rungs):
            for shard in (0, 1):
                state = ns_init(gen, loglike2, None, 2, 4, cfg)
                states[r, shard] = graphs._program(state, loglike2, None,
                                                   cfg, shard, True)
            if r == 1:
                assert len(graphs._PROGRAMS) == 4
        kept = {id(p) for p in graphs._PROGRAMS.values()}
        assert kept == {id(states[r, k]) for r in (1, 2) for k in (0, 1)}
        # a later call of a kept rung finds its program again
        state = ns_init(gen, rungs[2], None, 2, 4, cfg)
        assert graphs._program(state, rungs[2], None, cfg, 1, True) \
            is states[2, 1]
    finally:
        graphs.clear()


def test_default_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh(devices=["cuda", "cuda"])
