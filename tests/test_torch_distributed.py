"""Multi-process fitting in the port (``parallel/distributed.py`` and
``CubeFitter.fit_cube(host_shard=True)``): the single-process no-op, and
two processes joined by a ``gloo`` group on a localhost TCP store, each
fitting its stripe of the 4x2 stack into its own ``chunk_h<p>_<j>.hdf``
files, process 0 linking them after the group's barrier.

The worker is this file: ``python tests/test_torch_distributed.py
--worker ADDRESS RANK WORLD STORE`` (one process per rank, on the CPU)."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
# the JAX worker's settings (tests/_dist_worker.py)
FITTER = dict(ncomp_max=1, ns_kwargs={"nlive": 40, "tol": 1.0},
              batch_size=4, n_post=64, nlive_buckets=1, segment_iters=128)
SEED = 4
WORKER_TIMEOUT = 300


def _fitter():
    from nestfit_tpu_torch import cube as tcube
    from nestfit_tpu_torch.cube import CubeFitter
    from nestfit_tpu_torch.models import AmmoniaRunner
    from nestfit_tpu_torch.priors import get_irdc_priors

    sys.path.insert(0, str(HERE))
    from _cube_inputs import synth_stack

    return CubeFitter(synth_stack(tcube),
                      get_irdc_priors(vsys=0.0, device="cpu"),
                      AmmoniaRunner, device="cpu", **FITTER)


def _worker(address, rank, world, store_name):
    import torch

    from nestfit_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(2)
    assert initialize_distributed(address, int(world), int(rank))
    store = _fitter().fit_cube(store_name=store_name, seed=SEED,
                               host_shard=True)
    assert (store is not None) == (int(rank) == 0)
    torch.distributed.destroy_process_group()
    print(f"worker {rank}/{world} done", flush=True)


def _lnz(store_name):
    """``{(lon, lat): (lnZ, lnZ_err)}`` of every rung-1 record, and the
    number of pixel groups."""
    from nestfit_tpu_torch.cube import HdfStore

    out, n = {}, 0
    with HdfStore(store_name) as store:
        for g in store.iter_pix_groups():
            n += 1
            a = g["1"].attrs
            out[int(g.attrs["i_lon"]), int(g.attrs["i_lat"])] = (
                float(a["global_lnZ"]), float(a["global_lnZ_err"]))
    return out, n


def test_single_process_is_a_no_op():
    from nestfit_tpu_torch.parallel import distributed

    assert distributed.initialize_distributed() is False
    assert distributed.barrier() is False
    assert distributed.host_pixel_shard(100) == (0, 100)
    np.testing.assert_array_equal(distributed.host_pixel_stripe(10),
                                  np.arange(10))
    assert distributed.host_chunk_name() == "chunk0"


def test_two_process_host_shard(tmp_path):
    """Two gloo processes fit the 4x2 stack with ``host_shard=True``: each
    writes only ``chunk_h<rank>_<j>.hdf`` files, process 0 links them, the
    linked ``table.hdf`` holds every valid pixel once, and each pixel's
    lnZ lies within three combined errors of the single-process store."""
    import torch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    name = str(tmp_path / "hosts")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__)), "--worker",
         f"127.0.0.1:{port}", str(rank), "2", name],
        cwd=str(HERE.parent), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    # the single-process store, fitted while the workers run
    torch.set_num_threads(2)
    single = str(tmp_path / "single")
    _fitter().fit_cube(store_name=single, seed=SEED)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]

    chunks = sorted(q.name for q in (tmp_path / "hosts.store").glob(
        "chunk*.hdf"))
    assert chunks and all(c.startswith(("chunk_h0_", "chunk_h1_"))
                          for c in chunks), chunks
    assert {c[:8] for c in chunks} == {"chunk_h0", "chunk_h1"}
    got, n_groups = _lnz(name)
    want, _ = _lnz(single)
    assert n_groups == len(got) == len(want) == 7
    for pix, (z, e) in want.items():
        z2, e2 = got[pix]
        assert abs(z2 - z) <= 3 * np.hypot(e, e2), (pix, z, z2, e, e2)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.path.insert(0, str(HERE.parent))
        _worker(*sys.argv[2:6])
