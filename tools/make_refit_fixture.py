"""Record the JAX package's store of a cube fit whose every row is a
merged boundary refit, as ``tests/data/torch_refit_store.json``.

``tests/test_torch_fitter.py::test_fit_cube_refit_store_matches_jax_fixture``
holds the port's ``CubeFitter.fit_cube`` to this record at the same
settings, so the test runs only the port (a live JAX fit of the cube
spends about a minute compiling).

The cube is the 4x2 synthetic NH3 stack of ``tests/_cube_inputs.py`` (3
empty pixels, 4 one-component pixels, 1 NaN pixel).  The settings are
those of ``test_fit_cube_store_matches_jax_store`` but for
``boundary_band=1e9``, which puts every row of both rungs in the
boundary band: each is re-fitted at ``boundary_nlive_mult`` (2) times
the bucketed nlive (``bucket_nlive`` raises 16 to 150) and merged into
its batch with ``merge_fit_rows``.  The growth of host memory once seen
in the JAX package's ``_refine_boundary`` at 2 x nlive >= ``max_iter``
does not occur here (peak resident memory about 1.2 GB at
``max_iter`` 300), so ``max_iter`` stays the test's.

The record holds the JAX version, the settings, the
``hdf_tree(..., values=False)`` walk of ``table.hdf`` and
``chunk0.hdf`` (groups, datasets, attribute names, dtypes, shapes) and,
per pixel, ``nbest`` and each rung's ``global_lnZ`` and ``n_calls``.
Regenerate it only when the JAX store format changes.  On the CPU,
from the repository root (about a minute)::

    python tools/make_refit_fixture.py
"""

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_refit_store.json")
SEED = 5
SETTINGS = dict(ncomp_max=2,
                ns_kwargs={"nlive": 16, "tol": 5.0, "max_iter": 300},
                n_post=16, segment_iters=64, mode_loss_retries=0,
                boundary_band=1e9, batch_size=8, nlive_buckets=1)


def store_groups(name, store_cls):
    """``{"lon,lat": [nbest, {ncomp: [lnZ, n_calls]}]}`` of a store."""
    out = {}
    with store_cls(name) as store:
        for g in store.iter_pix_groups():
            key = f"{int(g.attrs['i_lon'])},{int(g.attrs['i_lat'])}"
            out[key] = [int(g.attrs["nbest"]), {
                n: [float(g[n].attrs["global_lnZ"]),
                    int(g[n].attrs["n_calls"])] for n in g}]
    return out


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)    # as tests/conftest.py
    from nestfit_tpu import cube
    from nestfit_tpu.cube import HdfStore
    from nestfit_tpu.models import AmmoniaRunner
    from nestfit_tpu.priors import get_irdc_priors

    from _cube_inputs import hdf_tree, synth_stack

    with tempfile.TemporaryDirectory() as tmp:
        name = os.path.join(tmp, "j")
        cube.CubeFitter(synth_stack(cube), get_irdc_priors(vsys=0.0),
                        AmmoniaRunner, **SETTINGS).fit_cube(
            store_name=name, seed=SEED)
        record = {
            "jax_version": jax.__version__,
            "seed": SEED,
            "settings": SETTINGS,
            "groups": store_groups(name, HdfStore),
            "trees": {f: hdf_tree(f"{name}.store/{f}", values=False)
                      for f in ("table.hdf", "chunk0.hdf")},
        }
    with open(OUT, "w") as fh:
        json.dump(record, fh, indent=1)
        fh.write("\n")
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
