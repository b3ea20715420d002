"""Shared inputs of the cube-layer port tests: the 4x2 synthetic NH3 stack
of ``tests/test_fit_cube.py`` and the fixture cutouts, built with either
package; a JAX ``FitResult`` carried across to the port; and a walk of
an HDF5 file by which two stores are compared."""

import dataclasses
import os

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
RMS = 0.35               # the fixture cutouts' RMS (tests/data/make_fixtures.py)

N_LON, N_LAT, N_CHAN, NOISE = 4, 2, 128, 0.1
PARAMS = np.array([0.5, 11.0, 5.5, 14.6, 0.4, 0.0])
SIGNAL = [(0, 0), (1, 1), (2, 0), (3, 1)]
NAN_PIXEL = (0, 1)


def synth_arrays():
    """``[(trans_id, xarr, data[l, b, S]), ...]``: 3 empty pixels, 4
    one-component pixels, 1 NaN pixel (``tests/test_fit_cube.py``)."""
    from nestfit_tpu_torch import oracle
    from nestfit_tpu_torch.models.tables import AMMONIA_TRANSITIONS
    from nestfit_tpu_torch.utils import freq_axis_from_velocity

    rng = np.random.default_rng(7)
    vaxis = np.linspace(-15, 15, N_CHAN)
    out = []
    for tid in (1, 2):
        xarr = freq_axis_from_velocity(vaxis, AMMONIA_TRANSITIONS[tid - 1].nu)
        data = rng.normal(scale=NOISE, size=(N_LON, N_LAT, N_CHAN))
        truth = oracle.amm_predict(xarr, PARAMS, trans_id=tid)
        for (l, b) in SIGNAL:
            data[l, b] += truth
        data[NAN_PIXEL[0], NAN_PIXEL[1], 3] = np.nan
        out.append((tid, xarr, data))
    return out


def synth_stack(cube_module):
    """The stack built with ``cube_module`` (``nestfit_tpu.cube`` or
    ``nestfit_tpu_torch.cube``)."""
    return cube_module.CubeStack([
        cube_module.DataCube(data, xarr, noise_map=NOISE, trans_id=tid)
        for tid, xarr, data in synth_arrays()])


def fixture_stack(cube_module, io_module, **from_fits):
    """The committed NH3 (1,1)+(2,2) cutouts as a stack, read with one
    package's ``cube`` and ``fits_io`` modules, noise from the
    primary-beam image."""
    pb, _ = io_module.read_fits(os.path.join(DATA_DIR, "pb_cutout.fits"))
    nmap = cube_module.NoiseMap.from_pbimg(RMS, pb)
    return cube_module.CubeStack([
        cube_module.DataCube.from_fits(
            os.path.join(DATA_DIR, f"nh3_{t}_cutout.fits"), noise_map=nmap,
            trans_id=i, **from_fits)
        for i, t in ((1, "11"), (2, "22"))])


def jax_fit_fields(jfit):
    """A JAX ``FitResult`` as the dict ``convert.fit_result_from_dict``
    takes."""
    def fields(obj):
        return {f.name: (v if isinstance(v, (int, float)) else np.asarray(v))
                for f in dataclasses.fields(obj)
                for v in [getattr(obj, f.name)]}

    return {"ns": fields(jfit.ns), "products": fields(jfit.products),
            "null_lnz": np.asarray(jfit.null_lnz),
            "ics": {k: np.asarray(v) for k, v in jfit.ics.items()},
            "ncomp": jfit.ncomp, "n_params": jfit.n_params,
            "n_chan_tot": jfit.n_chan_tot}


def assert_fits_equal(tfit, jfit):
    """Leaf by leaf: a port ``FitResult`` against a JAX one, exact."""
    def walk(t, j, where):
        if dataclasses.is_dataclass(j):
            for f in dataclasses.fields(j):
                walk(getattr(t, f.name), getattr(j, f.name),
                     f"{where}.{f.name}")
        elif isinstance(j, dict):
            assert sorted(t) == sorted(j), where
            for k in j:
                walk(t[k], j[k], f"{where}[{k}]")
        elif isinstance(j, (int, float)):
            assert t == j, where
        else:
            got, want = t.numpy(), np.asarray(j)
            assert got.dtype == want.dtype, where
            np.testing.assert_array_equal(got, want, err_msg=where)

    walk(tfit, jfit, "fit")


def hdf_tree(path, values=True):
    """Every group, dataset, attribute and external link of an HDF5 file
    as a list of tuples, in name order (links are not followed)."""
    import h5py

    out = []

    def attrs(obj, name):
        for k in obj.attrs:
            v = obj.attrs[k]
            a = np.asarray(v)
            # bytes compare NaN payloads exactly; strings by value
            val = a.tobytes() if a.dtype.kind in "biufc" else a.tolist()
            out.append(("attr", name, k, a.dtype.str, a.shape,
                        val if values else None))

    def walk(grp, name):
        attrs(grp, name)
        for k in sorted(grp):
            link = grp.get(k, getlink=True)
            sub = f"{name}/{k}"
            if isinstance(link, h5py.ExternalLink):
                out.append(("extlink", sub, link.filename, link.path))
                continue
            obj = grp[k]
            if isinstance(obj, h5py.Group):
                out.append(("group", sub))
                walk(obj, sub)
            else:
                d = obj[...]
                out.append(("dataset", sub, d.dtype.str, d.shape,
                            d.tobytes() if values else None))
                attrs(obj, sub)

    with h5py.File(path, "r") as f:
        walk(f, "")
    return out
