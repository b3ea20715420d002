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


def same_device(a, b) -> bool:
    """Whether ``a`` and ``b`` name one device (a bare ``"cuda"`` is the
    current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda" or (a.index is None and b.index is None):
        return a.index == b.index
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)
