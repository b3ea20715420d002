"""Port parity of the HDF5 store and of the row merges the ladder makes.

One JAX ``fit_batch`` per case on the 4x2 synthetic stack of
``tests/test_fit_cube.py`` is carried across to the port with
``convert.fit_result_from_dict``; then the same fit goes through both
packages' writers and merges.  Everything is compared bit for bit."""

import h5py
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

from nestfit_tpu import cube as jcube
from nestfit_tpu.cube.store import HdfStore as JaxStore
from nestfit_tpu.cube.store import completed_pixels as jax_completed
from nestfit_tpu.cube.store import write_fit_group as jax_write
from nestfit_tpu.models import AmmoniaRunner as JaxRunner
from nestfit_tpu.priors import get_irdc_priors as jax_priors
from nestfit_tpu.sampling import NSConfig as JaxConfig
from nestfit_tpu.sampling.fit import align_fit_meta as jax_align
from nestfit_tpu.sampling.fit import fit_batch as jax_fit_batch
from nestfit_tpu.sampling.fit import merge_fit_rows as jax_merge

from nestfit_tpu_torch import convert
from nestfit_tpu_torch import cube as tcube
from nestfit_tpu_torch.cube import records, store
from nestfit_tpu_torch.cube.fitter import BatchRecords
from nestfit_tpu_torch.models import AmmoniaRunner
from nestfit_tpu_torch.priors import get_irdc_priors
from nestfit_tpu_torch.sampling import align_fit_meta, merge_fit_rows

from _cube_inputs import assert_fits_equal, fixture_stack, hdf_tree, \
    jax_fit_fields, synth_stack

NLIVE = 16


@pytest.fixture(scope="module")
def jstack():
    return synth_stack(jcube)


def _jax_fit(stack, ncomp, rows, cfg, seed):
    """The JAX ``fit_batch`` of flat pixels ``rows`` (padded to a power of
    two, as the fitter pads), through a JAX ``CubeFitter``'s template
    runner."""
    fitter = jcube.CubeFitter(stack, jax_priors(vsys=0.0), JaxRunner,
                              batch_size=8, n_post=16, nlive_buckets=1)
    datas, noises, _, _ = stack.get_flat_batch()
    r_pad = fitter._pad_quantum(rows.size)
    pad_ix = np.concatenate([rows, np.full(r_pad - rows.size, rows[0])])
    d_b = [jnp.asarray(d[pad_ix], dtype=jnp.float32) for d in datas]
    n_b = [jnp.asarray(np.maximum(n[pad_ix], 1e-30), dtype=jnp.float32)
           for n in noises]
    template = fitter._get_template_runner(ncomp, r_pad, d_b, n_b)
    return fit_batch_padded(template, r_pad, rows.size, cfg, seed,
                            tuple(zip(d_b, n_b)))


def fit_batch_padded(template, r_pad, n, cfg, seed, data):
    return jax_fit_batch(random.key(seed), template, r_pad, cfg, n_post=16,
                         segment_iters=64, data=data,
                         active=np.arange(r_pad) < n)


VALID = np.array([0, 2, 3, 4, 5, 6, 7])
BASE = JaxConfig(nlive=NLIVE, tol=1.0)


@pytest.fixture(scope="module")
def jfits(jstack):
    """``{name: jax FitResult}``: rungs 1 and 2 at nlive 16 over the 7
    valid pixels, and a 4-pixel rung-1 refit at 2x nlive with the base
    run's death budget (the escalated retry / boundary configuration)."""
    import dataclasses

    esc = dataclasses.replace(BASE, nlive=2 * NLIVE,
                              max_iter=BASE.resolved(6).max_iter)
    return {
        "rung1": _jax_fit(jstack, 1, VALID, BASE, 1),
        "rung2": _jax_fit(jstack, 2, VALID[[0, 2, 3, 6]], BASE, 2),
        "refit": _jax_fit(jstack, 1, VALID[[1, 0, 4]], esc, 3),
    }


def _carry(jfit):
    return convert.fit_result_from_dict(jax_fit_fields(jfit), device="cpu")


def test_fit_result_from_dict_carries_every_leaf(jfits):
    for jfit in jfits.values():
        assert_fits_equal(_carry(jfit), jfit)


@pytest.mark.parametrize("name", ["rung1", "rung2", "refit"])
def test_fit_group_write_matches_jax(jfits, name, tmp_path):
    """Every row of the fit, padding rows too, through both writers:
    the same groups, attributes (name, dtype, order, value) and
    datasets."""
    jfit = jfits[name]
    tfit = _carry(jfit)
    n_rows = tfit.lnz.shape[0]
    with h5py.File(tmp_path / "j.hdf", "w") as hj, \
            h5py.File(tmp_path / "t.hdf", "w") as ht:
        for row in range(n_rows):
            il, ib = divmod(row, 2)
            jax_write(hj, il, ib, jfit.ncomp, jfit, row)
            store.write_fit_group(ht, il, ib, tfit.ncomp, tfit, row)
    assert hdf_tree(tmp_path / "t.hdf") == hdf_tree(tmp_path / "j.hdf")
    # the batched records equal the one-row ones
    batched = records.fit_group_records(tfit, np.arange(n_rows))
    for row, (attrs, dsets) in enumerate(batched):
        a1, d1 = records.fit_group_record(tfit, row)
        assert list(attrs) == list(a1) and attrs == a1
        for k in d1:
            np.testing.assert_array_equal(dsets[k], d1[k])


def test_write_chunk_matches_jax_chunk(jfits, tmp_path):
    """A batch of records (two rungs, ``nbest``, completion manifest)
    written by ``store.write_chunk`` equals the chunk the JAX fitter's
    writer loop makes from the same fits."""
    j1, j2 = jfits["rung1"], jfits["rung2"]
    ids1, ids2 = VALID, VALID[[0, 2, 3, 6]]
    nbest = np.array([2, 0, 1, 2, 0, 0, 2], dtype=np.int32)
    n_lat = 2
    with h5py.File(tmp_path / "j.hdf", "a") as hdf:
        for ncomp, fit, ids in ((1, j1, ids1), (2, j2, ids2)):
            for run_ix, pix in enumerate(ids):
                g = jax_write(hdf, int(pix // n_lat), int(pix % n_lat),
                              ncomp, fit, run_ix)
                g.parent.attrs["nbest"] = int(nbest[list(ids1).index(pix)])
        JaxStore.mark_completed(hdf, ids1)
    recs = []
    for ncomp, jfit, ids in ((1, j1, ids1), (2, j2, ids2)):
        rows = records.fit_group_records(_carry(jfit), np.arange(ids.size))
        recs.extend(zip(ids.tolist(), [ncomp] * ids.size, rows))
    batch = BatchRecords(chunk=0, nlive=NLIVE, pixel_ix=ids1, nbest=nbest,
                         records=recs, rungs=[])
    store.write_chunk(tmp_path / "t.hdf", batch, n_lat)
    assert hdf_tree(tmp_path / "t.hdf") == hdf_tree(tmp_path / "j.hdf")


def test_hdfstore_metadata_and_links_match_jax(tmp_path):
    """Header, fitter parameters, model metadata, the completion manifest
    and the external links of ``table.hdf``, from both stores on the
    fixture cutouts."""
    import os

    from nestfit_tpu.cube import fits_io as jf
    from nestfit_tpu_torch.cube import fits_io as tf

    stacks = {"j": fixture_stack(jcube, jf), "t": fixture_stack(tcube, tf)}
    fitters = {
        "j": jcube.CubeFitter(stacks["j"], jax_priors(vsys=0.0), JaxRunner,
                              ns_kwargs={"nlive": 40}, ncomp_max=3),
        "t": tcube.CubeFitter(stacks["t"], get_irdc_priors(vsys=0.0,
                                                           device="cpu"),
                              AmmoniaRunner, ns_kwargs={"nlive": 40},
                              ncomp_max=3, device="cpu"),
    }
    classes = {"j": (JaxStore, jax_completed),
               "t": (tcube.HdfStore, store.completed_pixels)}
    for side, (cls, completed) in classes.items():
        s = cls(str(tmp_path / side / "cube"), nchunks=3)
        s.insert_header(stacks[side])
        s.insert_fitter_pars(fitters[side])
        s.insert_model_metadata(fitters[side].runner_cls.model)
        for j, ids in enumerate(([4, 1, 9], [9, 30], [])):
            with h5py.File(s.chunk_paths[j], "a") as chunk:
                cls.mark_completed(chunk, ids)
                if ids:
                    g = chunk.require_group(f"/pix/{j}/{ids[0]}")
                    g.attrs["i_lon"] = j
        with h5py.File(s.chunk_paths[0], "a") as chunk:
            cls.mark_completed(chunk, [2, 4])
        np.testing.assert_array_equal(s.completed_pixels(), [1, 2, 4, 9, 30])
        np.testing.assert_array_equal(completed(s.store_dir),
                                      [1, 2, 4, 9, 30])
        s.link_files()
        assert s.read_header(full=False) == dict(
            h5py.File(s.store_dir / "table.hdf", "r")["simple_header"].attrs)
        s.close()
        reopened = cls(str(tmp_path / side / "cube"), nchunks=99)
        assert reopened.nchunks == 3
        assert reopened.model.NAME == "ammonia"
        assert [g.name for g in reopened.iter_pix_groups()] == \
            ["/pix/0/4", "/pix/1/9"]
        reopened.close()
    for name in ("table.hdf", "chunk0.hdf", "chunk1.hdf", "chunk2.hdf"):
        assert hdf_tree(tmp_path / "t" / "cube.store" / name) == \
            hdf_tree(tmp_path / "j" / "cube.store" / name), name
    assert sorted(os.listdir(tmp_path / "t" / "cube.store")) == \
        sorted(os.listdir(tmp_path / "j" / "cube.store"))


MERGES = {
    # (base, other, dst rows, src rows)
    "same_nlive": ("rung1", "rung1", [0, 3], [5, 1]),
    "cross_nlive": ("rung1", "refit", [2, 0, 6], [0, 1, 2]),
    "nothing": ("rung1", "refit", [], []),
}


@pytest.mark.parametrize("case", sorted(MERGES))
def test_align_and_merge_match_jax(jfits, case):
    """``align_fit_meta`` then ``merge_fit_rows`` on the carried fits
    equal the JAX package's on the originals, leaf by leaf, and leave
    the inputs unchanged."""
    a, b, dst, src = MERGES[case]
    ja, jb = jfits[a], jfits[b]
    ta, tb = _carry(ja), _carry(jb)
    n_a, n_b = ta.lnz.shape[0], tb.lnz.shape[0]
    want = jax_merge(ja, jax_align(jb, ja), dst, src, n_a, n_b)
    aligned = align_fit_meta(tb, ta)
    assert_fits_equal(aligned, jax_align(jb, ja))
    got = merge_fit_rows(ta, aligned, dst, src, n_a, n_b)
    assert_fits_equal(got, want)
    # inputs untouched
    assert_fits_equal(ta, ja)
    assert_fits_equal(tb, jb)
    if dst:
        assert torch.equal(got.lnz[dst], tb.lnz[src])


def test_merge_refuses_unaligned_metadata(jfits):
    ta, tb = _carry(jfits["rung1"]), _carry(jfits["refit"])
    with pytest.raises(ValueError, match="align_fit_meta"):
        merge_fit_rows(ta, tb, [0], [0], 8, 4)
