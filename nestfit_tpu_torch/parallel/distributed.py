"""Multi-process fitting (port of ``nestfit_tpu/parallel/distributed.py``).

As in the JAX package, each process fits its own interleaved stripe of
the valid pixels and writes its own ``chunk_h<process>_<j>.hdf`` files;
no pixel data crosses processes.  The only collective is the barrier
before process 0 links the shards into ``table.hdf``, so the process
group is ``gloo`` (on the host): NCCL would refuse two ranks on one card
("Duplicate GPU detected"), and the fitter never reduces tensors.  On a
machine with several cards, one process per card (each with its own
``device=f"cuda:{rank}"``) is the route that keeps every host loop off
the others' interpreter lock.
"""

import logging

import numpy as np
import torch

log = logging.getLogger("nestfit_tpu_torch.distributed")


def _initialized() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return torch.distributed.get_rank() if _initialized() else 0


def world_size() -> int:
    """The number of processes (1 without a process group)."""
    return torch.distributed.get_world_size() if _initialized() else 1


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None):
    """Join a ``gloo`` process group (a no-op returning False for a single
    process).

    ``coordinator_address`` is ``host:port`` of rank 0's TCP store (for
    example ``localhost:29500``); ``num_processes`` and ``process_id`` the
    world size and this rank.  Nothing here discovers a cluster: pass all
    three for a multi-process run.  Returns True once the group is up.
    """
    if num_processes in (None, 1) and coordinator_address is None:
        log.info("single-process run; torch.distributed not initialized")
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process run needs coordinator_address, "
                         "num_processes and process_id")
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))
    log.info("distributed: process %d/%d", rank(), world_size())
    return True


def barrier() -> bool:
    """Wait for every process of the group; False (and no wait) without
    one."""
    if not _initialized():
        return False
    torch.distributed.barrier()
    return True


def host_pixel_shard(n_pix, process_index=None, process_count=None):
    """Contiguous flat-pixel range ``(lo, hi)`` owned by this process.
    Prefer :func:`host_pixel_stripe` for fitting work: a contiguous range
    hands one process all the slow pixels when signal clusters
    spatially."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    bounds = np.linspace(0, n_pix, pc + 1).astype(int)
    return int(bounds[pi]), int(bounds[pi + 1])


def host_pixel_stripe(n_pix, process_index=None, process_count=None):
    """Interleaved flat-pixel indices owned by this process (pixel ``i``
    to process ``i % process_count``): the stripes of all processes
    partition ``range(n_pix)`` exactly and spread clustered signal
    evenly."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    return np.arange(pi, n_pix, pc)


def host_chunk_name(prefix="chunk"):
    """Per-process chunk file stem (``chunk<process_index>``)."""
    return f"{prefix}{rank()}"
