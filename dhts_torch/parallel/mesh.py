"""Device mesh of the port (counterpart of :mod:`dhts.parallel.mesh`, its
one-device part).

A mesh here is a plain description of the ``(data, lane)`` layout: the
episode batch over ``data``, each episode's lanes over ``lane``. The port
runs one device: every axis must have size 1, so the episode batch and the
scene stay whole on that device and every collective of the sharded step
is an identity. Larger meshes (``torch.distributed`` over several cards)
belong to the multi-device item of ``ROADMAP.md`` and raise here; they
never run unsharded in silence.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dhts_torch.device import resolve_device

MULTI_DEVICE = ("meshes of more than one device (the multi-device item of "
                "ROADMAP.md queue 1: K6's sharded bodies over "
                "torch.distributed) are not ported yet")


class Mesh(NamedTuple):
    """Named axes and their sizes, on one device."""

    axis_names: tuple
    sizes: tuple
    device: torch.device

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_mesh(mesh_shape: dict, device=None) -> Mesh:
    """A mesh from ``{"data": d, "lane": l, ...}`` (row-major) on
    ``device`` (default ``cuda``). Raises ``NotImplementedError`` unless it
    holds exactly one device."""
    names = tuple(mesh_shape.keys())
    sizes = tuple(int(v) for v in mesh_shape.values())
    if any(s < 1 for s in sizes):
        raise ValueError(f"mesh sizes must be positive, got {mesh_shape}")
    if math.prod(sizes) != 1:
        raise NotImplementedError(f"mesh {mesh_shape}: {MULTI_DEVICE}")
    return Mesh(names, sizes, resolve_device(device))


def shard_episode_batch(mesh: Mesh, rand):
    """Place a batch of episode draws ``[B, T, L]`` on the data axis: on a
    one-device mesh, the mesh's device."""
    return rand.to(mesh.device)
