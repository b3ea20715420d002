"""HDF5 result store (port of ``nestfit_tpu/cube/store.py``; the only
module of the port that imports ``h5py``).

The same on-disk layout (``docs/store_spec.md``): a ``<name>.store/``
directory holding one ``chunk<i>.hdf`` per pixel batch plus a master
``table.hdf`` that external-links every chunk's pixel groups.  Per-pixel
groups live at ``/pix/<lon>/<lat>/<N>``; pixel-level attributes
(``i_lon``/``i_lat``/``nbest``) are written while the chunk file is
open, and each chunk records a ``/completed`` dataset of flat pixel
indices, the manifest ``fit_cube(resume=True)`` reads.

``write_fit_group`` of the JAX package is split in two: the record of a
pixel group (``records.fit_group_record``: NumPy and Python scalars,
built on the host without ``h5py``) and its write (``write_fit_record``).
"""

import warnings
from pathlib import Path

import h5py
import numpy as np

from nestfit_tpu_torch.cube.records import fit_group_record
from nestfit_tpu_torch.models import MODELS


def check_ext(store_name, ext="hdf"):
    name = str(store_name)
    return name if name.endswith(f".{ext}") else f"{name}.{ext}"


def discover_chunks(store_dir):
    """All chunk files in a store directory, sorted by name.

    Matches both the single-host numbered chunks (``chunk<j>.hdf``)
    and per-host shards (``chunk_h<process>_<j>.hdf``); works without
    opening ``table.hdf``, so multi-host worker processes can use it
    concurrently with the writer."""
    return sorted(Path(store_dir).glob("chunk*.hdf"))


def completed_pixels(store_dir):
    """Flat pixel indices recorded as completed across all chunk files
    of a store directory (standalone: no table.hdf access, safe from
    any host process)."""
    done = []
    for chunk_path in discover_chunks(store_dir):
        with h5py.File(chunk_path, "r") as chunk:
            if "completed" in chunk:
                done.append(chunk["completed"][...])
    if not done:
        return np.empty(0, dtype=np.int64)
    return np.unique(np.concatenate(done))


class HdfStore:
    """Chunked HDF5 store with the reference-compatible layout."""

    linked_table = Path("table.hdf")
    chunk_prefix = "chunk"
    dpath = "/products"

    def __init__(self, store_name, nchunks=1):
        self.store_name = str(store_name)
        self.store_dir = Path(check_ext(self.store_name, ext="store"))
        self.store_dir.mkdir(parents=True, exist_ok=True)
        self.hdf = h5py.File(self.store_dir / self.linked_table, "a")
        # the chunk count is fixed at creation; reopening an existing
        # store keeps the original value
        stored = self.hdf.attrs.get("nchunks")
        if stored is None:
            self.hdf.attrs["nchunks"] = nchunks
            stored = nchunks
        self.nchunks = int(stored)
        model_name = self.hdf.attrs.get("model_name")
        self.model = MODELS.get(model_name) if model_name else None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.close()

    @property
    def chunk_paths(self):
        return [
            self.store_dir / f"{self.chunk_prefix}{i}.hdf"
            for i in range(self.nchunks)
        ]

    def all_chunk_paths(self):
        """Every chunk file present in the store directory, including
        per-host shards (``chunk_h<process>_<j>.hdf``) that a multi-host
        run of the JAX package writes."""
        return discover_chunks(self.store_dir)

    @property
    def is_open(self):
        # an h5py.File is falsy once closed
        return bool(self.hdf)

    def close(self):
        if self.is_open:
            self.hdf.flush()
            self.hdf.close()

    def iter_pix_groups(self):
        """Yield every linked pixel group, in (lon, lat) numeric order."""
        assert self.is_open
        pix = self.hdf.get("/pix")
        if pix is None:
            return
        for lon in sorted(pix, key=int):
            lon_group = pix[lon]
            for lat in sorted(lon_group, key=int):
                node = lon_group[lat]
                if isinstance(node, h5py.Group):
                    yield node

    def find_first_valid_group(self):
        assert self.is_open
        for group in self.iter_pix_groups():
            if "1" in group:
                return group["1"]
        raise ValueError("No valid pix groups found.")

    def link_files(self):
        """External-link every chunk's pixel groups into table.hdf
        (layout per ``docs/store_spec.md``), per-host shard chunks
        included."""
        assert self.is_open
        for chunk_path in self.all_chunk_paths():
            if not chunk_path.exists():
                continue
            with h5py.File(chunk_path, "r") as chunk:
                pix = chunk.get("/pix")
                if pix is None:
                    continue
                for lon in pix:
                    for lat in pix[lon]:
                        name = f"/pix/{lon}/{lat}"
                        if name in self.hdf:
                            del self.hdf[name]
                        self.hdf[name] = h5py.ExternalLink(
                            chunk_path.name, name
                        )
            self.hdf.flush()

    def reset_pix_links(self):
        assert self.is_open
        if "/pix" in self.hdf:
            del self.hdf["/pix"]

    # ------------------------------------------------------------------
    # completion manifest (resume support)
    # ------------------------------------------------------------------

    def completed_pixels(self):
        """Flat pixel indices recorded as completed across all chunks."""
        return completed_pixels(self.store_dir)

    @staticmethod
    def mark_completed(chunk_hdf, flat_ix):
        """Append flat pixel indices to an open chunk's manifest."""
        flat_ix = np.asarray(flat_ix, dtype=np.int64)
        if "completed" in chunk_hdf:
            prev = chunk_hdf["completed"][...]
            del chunk_hdf["completed"]
            flat_ix = np.concatenate([prev, flat_ix])
        chunk_hdf.create_dataset("completed", data=np.unique(flat_ix))

    # ------------------------------------------------------------------
    # metadata
    # ------------------------------------------------------------------

    def insert_header(self, stack):
        if not self.is_open:
            warnings.warn(
                "Could not insert header: the HDF5 file is closed.",
                category=RuntimeWarning,
            )
            return
        simple = self.hdf.require_group("simple_header")
        for key, val in stack.simple_header.items():
            simple.attrs[key] = val
        full = self.hdf.require_group("full_header")
        for key, val in stack.full_header.items():
            if val is None:
                continue
            if isinstance(val, float) and not np.isfinite(val):
                continue
            full.attrs[key] = val
        self.hdf.attrs["naxis1"] = stack.shape[2]  # n_lon
        self.hdf.attrs["naxis2"] = stack.shape[1]  # n_lat

    def read_header(self, full=True):
        assert self.is_open
        return dict(self.hdf["full_header" if full else "simple_header"].attrs)

    def create_dataset(self, dset_name, data, group="", clobber=True):
        assert dset_name
        parent = self.hdf.require_group(group) if group else self.hdf
        if dset_name in parent:
            if not clobber:
                raise ValueError(f"dataset exists: {group}/{dset_name}")
            del parent[dset_name]
        return parent.create_dataset(dset_name, data=data)

    def insert_fitter_pars(self, fitter):
        assert self.is_open
        self.hdf.attrs["lnZ_threshold"] = fitter.lnZ_thresh
        self.hdf.attrs["n_max_components"] = fitter.ncomp_max
        self.hdf.attrs["multinest_kwargs"] = str(fitter.ns_kwargs)

    def insert_model_metadata(self, model_module):
        assert self.is_open
        self.hdf.attrs["n_params"] = model_module.N
        self.hdf.attrs["model_name"] = model_module.NAME
        self.hdf.attrs["par_names"] = model_module.PAR_NAMES
        self.hdf.attrs["par_names_short"] = model_module.PAR_NAMES_SHORT
        self.hdf.attrs["tex_labels"] = model_module.TEX_LABELS
        self.hdf.attrs["tex_labels_with_units"] = (
            model_module.TEX_LABELS_WITH_UNITS
        )
        self.model = model_module


def write_fit_record(hdf, i_lon, i_lat, ncomp, record):
    """Write one pixel's one-ncomp record (``records.fit_group_record``)
    into ``/pix/<lon>/<lat>/<N>`` of the open file ``hdf``."""
    pix_group = hdf.require_group(f"/pix/{i_lon}/{i_lat}")
    pix_group.attrs["i_lon"] = i_lon
    pix_group.attrs["i_lat"] = i_lat
    group = pix_group.require_group(str(ncomp))
    attrs, datasets = record
    for name, value in attrs.items():
        group.attrs[name] = value
    for name, value in datasets.items():
        group.create_dataset(name, data=value)
    return group


def write_fit_group(hdf, i_lon, i_lat, ncomp, fit, run_ix):
    """Write run row ``run_ix`` of the batched ``FitResult`` ``fit`` into
    ``/pix/<lon>/<lat>/<N>`` (the JAX package's ``write_fit_group``)."""
    return write_fit_record(hdf, i_lon, i_lat, ncomp,
                            fit_group_record(fit, run_ix))


def write_chunk(chunk_path, batch, n_lat):
    """Write one batch of the fitter (``fitter.BatchRecords``) into its
    chunk file: every pixel group, each pixel's ``nbest``, and the batch's
    pixels in the completion manifest."""
    nbest_of = dict(zip(batch.pixel_ix.tolist(), batch.nbest.tolist()))
    with h5py.File(chunk_path, "a") as hdf:
        for pix, ncomp, record in batch.records:
            group = write_fit_record(hdf, int(pix // n_lat), int(pix % n_lat),
                                     ncomp, record)
            group.parent.attrs["nbest"] = int(nbest_of[pix])
        HdfStore.mark_completed(hdf, batch.pixel_ix)
        hdf.flush()
