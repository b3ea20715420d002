"""Cube layer (port of ``nestfit_tpu/cube``): FITS cubes, the cube stack,
the batched ``CubeFitter`` ladder, the chunked HDF5 store and the map
products.

``HdfStore`` and the names of ``products`` are resolved on first use:
the store is the only module that needs ``h5py``, so the rest imports
and runs without it.
"""

from nestfit_tpu_torch.cube.cube import (
    CubeStack,
    DataCube,
    NoiseMap,
    NoiseMapUniform,
)
from nestfit_tpu_torch.cube.fits_io import read_fits, write_fits
from nestfit_tpu_torch.cube.fitter import CubeFitter


def __getattr__(name):
    if name == "HdfStore":
        from nestfit_tpu_torch.cube.store import HdfStore

        return HdfStore
    from nestfit_tpu_torch import _LAZY

    if name in _LAZY["nestfit_tpu_torch.cube.products"]:
        from nestfit_tpu_torch.cube import products

        return getattr(products, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
