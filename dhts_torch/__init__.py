"""dhts_torch — the PyTorch/CUDA port of :mod:`dhts` for NVIDIA Hopper.

The layout mirrors ``dhts/`` so that each ported module sits where its JAX
counterpart does:

    dhts_torch.ops       ARZ Riemann solver and Godunov update, IDM, soft
                         logic, and ``ops.cuda`` — hand-written CUDA kernels
                         with their plain PyTorch versions
    dhts_torch.models    vehicle parameters, scene builder, network state and
                         step, hybrid conversion, single-lane rollouts
    dhts_torch.utils     running statistics, CMA-ES
    dhts_torch.parallel  the one-device (data, lane) mesh
    dhts_torch.apps      the ITSCP signal-control environment, controller,
                         trainer and training CLI; the inverse initial-state
                         benchmarks (macro, micro, hybrid) and their CLIs

The port imports ``torch`` and ``numpy`` only. Every entry point takes an
explicit ``device``; it defaults to ``cuda`` and raises when no GPU is
present, so a run never drops to the CPU unless the caller asks for it.
"""

from dhts_torch.device import resolve_device

__version__ = "0.1.0"
__all__ = ["resolve_device"]
