"""The one-launch prior transform on the CPU: its plain version
(``ops/tables.py::prior_transform_plain``, which walks the packed
program the kernel runs) against the per-prior path's plain versions,
bit for bit; which transformers take the one launch; and the
``prior.fused`` / ``prior.split`` counters.  ``test_torch_kernels_gpu.py``
holds the kernel against the plain version on the card."""

import copy

import numpy as np
import pytest
import torch

from nestfit_tpu_torch import priors as pr
from nestfit_tpu_torch.ops import _build, tables
from nestfit_tpu_torch.priors import (
    get_diazenylium_priors,
    get_gaussian_priors,
    get_irdc_priors,
    get_synth_priors,
    make_distribution,
)
from nestfit_tpu_torch.priors.priors import transform_per_prior
from nestfit_tpu_torch.utils import profiling

CTORS = {"irdc": get_irdc_priors, "n2hp": get_diazenylium_priors,
         "gauss": get_gaussian_priors, "synth": get_synth_priors}


def _unit_rows(utrans, ncomp, n=3000, seed=0):
    """Unit-cube rows ``[n, n_param * ncomp]``: uniform draws, rows of
    0 and of 1, and rows on the ppf grid's nodes ``k / (size - 1)``."""
    rng = np.random.default_rng(seed + ncomp)
    u = rng.uniform(size=(n, utrans.n_param * ncomp))
    u[:8] = 0.0
    u[8:16] = 1.0
    size = utrans.priors[0].dist.size
    k = min(200, n - 16)
    u[16:16 + k] = rng.integers(0, size, size=(k, u.shape[1])) / (size - 1)
    return torch.as_tensor(u, dtype=torch.float32)


def _shrink_rows(utrans, u, ncomp):
    """``u`` with its last 500 rows' widths near the top of their prior,
    so that the placement's separations exceed the velocity range; and
    the number of rows whose separations do."""
    place = utrans.priors[0]
    ix_s, ix_v = place.sigm_prior.p_ix, place.vcen_prior.p_ix
    u = u.clone().reshape(u.shape[0], utrans.n_param, ncomp)
    u[-500:, ix_s, :] = torch.linspace(0.99, 1.0, 500)[:, None]
    u = u.reshape(u.shape[0], -1)
    sig = utrans.transform(u, ncomp, plain=True).reshape(
        u.shape[0], utrans.n_param, ncomp)[:, ix_s, :]
    seps = place.sep_scale * torch.sqrt(sig[:, 1:] * sig[:, :-1])
    d = place.vcen_prior.dist
    assert ix_v != ix_s
    return u, int((seps.sum(-1) > d.xmax - d.xmin).sum())


@pytest.mark.parametrize("ncomp", [1, 2, 3])
@pytest.mark.parametrize("name", ["irdc", "n2hp", "gauss"])
def test_plain_program_equals_the_per_prior_plain_path(name, ncomp):
    """The packed program walked with K2's and K3's plain versions is
    ``transform(plain=True)`` bit for bit, at 0, 1 and the grid nodes; at
    ncomp 3 on the IRDC priors rows whose separations exceed the velocity
    range take the shrink-to-fit branch."""
    utrans = CTORS[name](device="cpu")
    u = _unit_rows(utrans, ncomp)
    if name == "irdc" and ncomp == 3:
        u, n_shrunk = _shrink_rows(utrans, u, ncomp)
        assert n_shrunk > 100
    want = utrans.transform(u, ncomp, plain=True)
    prog = utrans.program(ncomp, "cpu")
    assert prog is not None
    assert torch.equal(tables.prior_transform_plain(prog, u), want)
    # the entry, on rows with leading dimensions
    lead = u.reshape(3, -1, u.shape[-1])
    assert torch.equal(utrans.transform(lead, ncomp),
                       want.reshape(lead.shape))


def _odd_transformers():
    """Transformers of classes the one launch does not take, or that its
    packing refuses."""
    x = np.linspace(-4, 4, 500)
    f = np.exp(-0.5 * (x / 1.7) ** 2) + 0.05

    def d(dtype=torch.float32):
        return make_distribution(x, f, dtype=dtype, device="cpu")

    sig = make_distribution(np.linspace(0.05, 2, 500), np.ones(500),
                            device="cpu")
    return {
        "ordered": pr.PriorTransformer([pr.OrderedPrior(d(), 0),
                                        pr.Prior(sig, 1)]),
        "spaced": pr.PriorTransformer([pr.SpacedPrior(pr.Prior(d(), 0),
                                                      pr.Prior(sig, 0)),
                                       pr.Prior(sig, 1)]),
        "two_placements": pr.PriorTransformer([
            pr.ResolvedPlacementPrior(pr.Prior(d(), 0), pr.Prior(sig, 1)),
            pr.ResolvedPlacementPrior(pr.Prior(d(), 2), pr.Prior(sig, 3))]),
        "float64": pr.PriorTransformer([pr.Prior(d(torch.float64), 0)]),
        "wide_table": pr.PriorTransformer([pr.ResolvedPlacementPrior(
            pr.Prior(make_distribution(np.linspace(-4, 4, 2000),
                                       np.ones(2000), device="cpu"), 0),
            pr.Prior(sig, 1))]),
    }


@pytest.mark.parametrize("name, ncomp, fused", [
    ("irdc", 1, True), ("irdc", 2, True), ("irdc", 3, True),
    ("irdc", 4, False), ("n2hp", 2, True), ("n2hp", 4, False),
    ("gauss", 3, True), ("gauss", 4, False), ("synth", 1, False),
    ("synth", 2, False), ("ordered", 2, False), ("spaced", 2, False),
    ("two_placements", 2, False), ("float64", 2, False),
    ("wide_table", 1, True), ("wide_table", 2, False)])
def test_which_transformers_take_the_one_launch(name, ncomp, fused):
    """Only the four packed classes (a placement at ncomp <= 3, one a
    transformer, its cells table within K3's) take the one launch; the
    synth priors, ncomp 4, the ordered and spaced priors and float64
    tables keep the per-prior path, and count as it."""
    utrans = CTORS[name](device="cpu") if name in CTORS \
        else _odd_transformers()[name]
    assert (utrans.program(ncomp, "cpu") is not None) == fused
    u = _unit_rows(utrans, ncomp, n=64)
    if name == "float64":
        u = u.double()
    with profiling.collect() as tr:
        got = utrans.transform(u, ncomp)
    assert tr.counters == {"prior.fused" if fused else "prior.split": 1}
    assert torch.equal(got, utrans.transform(u, ncomp, plain=True))


def test_the_counters_count_on_the_cpu_and_per_replay():
    """On the CPU the one-launch entry's plain version counts
    ``prior.fused`` and the per-prior path ``prior.split`` (the plain
    reference counts nothing); a launch recorded during a graph capture
    counts once a replay."""
    irdc, synth = get_irdc_priors(device="cpu"), get_synth_priors(
        device="cpu")
    u = torch.rand(32, 12, generator=torch.Generator().manual_seed(4))
    with profiling.collect() as tr:
        irdc.transform(u, 2)
        irdc.transform(u[:, :6], 1)
        synth.transform(u, 2)
        irdc.transform(u, 2, plain=True)
    assert tr.counters == {"prior.fused": 2, "prior.split": 1}
    n0 = tables.prior_transform_fused.launches
    s0 = transform_per_prior.launches
    with profiling.collect() as tr:
        with _build.recording() as per_replay:
            _build.count_launch(tables.prior_transform_fused)
            _build.count_launch(transform_per_prior)
        assert tr.counters == {}
        for _ in range(3):
            _build.add_launches(per_replay)
    assert tr.counters == {"prior.fused": 3, "prior.split": 3}
    assert tables.prior_transform_fused.launches == n0 + 3
    assert transform_per_prior.launches == s0 + 3


def test_runner_and_copies_use_the_one_entry():
    """The runner's transform (the sampler's and the products') takes the
    one launch, a copy of the transformer packs programs of its own, and
    the packed constants are the float32 values the plain operations
    round their Python scalars to."""
    from nestfit_tpu_torch.models import AmmoniaRunner, ammonia

    from _cube_inputs import synth_arrays

    utrans = get_irdc_priors(device="cpu")
    prog = utrans.program(2, "cpu")
    place = prog.packed.ops[1]
    d = utrans.priors[0].vcen_prior.dist
    assert prog.ops[1].code == tables.PLACEMENT
    assert (place.xmin, place.xmax, place.v_range, place.value) == tuple(
        float(np.float32(v)) for v in (d.xmin, d.xmax, d.xmax - d.xmin,
                                       utrans.priors[0].sep_scale))
    assert place.row == 0 and place.row2 == 4 and prog.packed.n_op == 6
    dup = copy.deepcopy(utrans)
    assert dup._programs == {} and dup.program(2, "cpu") is not prog
    assert utrans.to("cpu").program(2, "cpu") is not prog
    spectra = tuple(
        ammonia.make_ammonia_spectrum(xarr, data[:, 0], 0.1, trans_id=tid,
                                      device="cpu")
        for tid, xarr, data in synth_arrays())
    runner = AmmoniaRunner(spectra, utrans, ncomp=2, device="cpu")
    u = torch.rand(2, 4, 12, generator=torch.Generator().manual_seed(8))
    with profiling.collect() as tr:
        lnl = runner.loglike_unit(u)
        row = runner.placed(["cpu", "cpu"])
        row.loglike_unit(u)
    assert tr.counters["prior.fused"] == 2
    assert "prior.split" not in tr.counters
    assert torch.equal(lnl, runner.loglike_unit(u, plain=True))
    with pytest.raises(ValueError, match="rows of"):
        tables.prior_transform_fused(prog, u[0, :, :6])
