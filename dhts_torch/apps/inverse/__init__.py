"""Inverse initial-state benchmarks (port of :mod:`dhts.apps.inverse`):
macro, micro and hybrid problems on :class:`InverseProblem`."""

from dhts_torch.apps.inverse.problem import InverseProblem

__all__ = ["InverseProblem"]
