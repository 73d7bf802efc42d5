"""Stateless physics ops on tensors (counterpart of :mod:`dhts.ops`).

``dhts_torch.ops.cuda`` holds the hand-written CUDA kernels; its modules
import nothing CUDA-specific until a kernel is launched.
"""

from dhts_torch.ops import arz, dmath, idm

__all__ = ["arz", "dmath", "idm"]
