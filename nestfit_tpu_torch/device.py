"""Device selection for the port's entry points."""

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device without a card raises.

    The entry points default to ``"cuda"``.  On a host without a card
    that default must fail loudly rather than carry on on the CPU:
    callers that want the CPU (the plain PyTorch versions of the
    kernels) ask for it with ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev
