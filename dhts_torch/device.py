"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``.

    A CUDA device without a GPU raises instead of falling back to the CPU:
    the CPU runs only when the caller names it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dhts_torch: no CUDA device is available; pass device='cpu' to "
            "run the plain PyTorch path on the CPU")
    return dev
