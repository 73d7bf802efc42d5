"""Device mesh of the port (counterpart of :mod:`dhts.parallel.mesh`).

A mesh here is a description of the ``(data, lane)`` layout: the episode
batch over ``data``, each episode's lanes over ``lane``. A one-device mesh
keeps the batch and the scene whole on that device, and every collective
of the sharded step is an identity. A mesh with a lane axis of S > 1
shards runs one process per shard: it needs an initialised default
``torch.distributed`` process group of world size S, whose rank r holds
shard r, lanes ``[r * L / S, (r + 1) * L / S)`` (row-major, as JAX's
``devices.reshape(dims)``); the collectives between the per-shard kernels
run over that group (:mod:`dhts_torch.parallel.collectives`). A data axis
of more than one device is not ported yet and raises, as does a mesh of
more than one device without a process group: nothing runs unsharded in
silence.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dhts_torch.device import resolve_device

DATA_AXIS = ("a data axis of more than one device (the episode batch over "
             "ranks: ROADMAP.md queue 1, the data axis item) is not ported "
             "yet")


class Mesh(NamedTuple):
    """Named axes and their sizes, this process's device, and for a lane
    axis of more than one shard the lane process group and this process's
    shard index (``lane_group`` None: one device)."""

    axis_names: tuple
    sizes: tuple
    device: torch.device
    lane_group: object = None
    lane_index: int = 0

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def lanes(self) -> int:
        """Shards of the lane axis."""
        return self.shape.get("lane", 1)

    @property
    def writer(self) -> bool:
        """Whether this process writes logs and checkpoints (rank 0)."""
        return self.lane_index == 0


def make_mesh(mesh_shape: dict, device=None) -> Mesh:
    """A mesh from ``{"data": d, "lane": l, ...}`` (row-major) on
    ``device`` (default ``cuda``). A lane axis of S > 1 needs an
    initialised default process group of world size S; raises
    ``NotImplementedError`` for a data axis of more than one device and
    ``RuntimeError`` for a mesh of more than one device without a process
    group of its size."""
    import torch.distributed as dist

    names = tuple(mesh_shape.keys())
    sizes = tuple(int(v) for v in mesh_shape.values())
    if any(s < 1 for s in sizes):
        raise ValueError(f"mesh sizes must be positive, got {mesh_shape}")
    shape = dict(zip(names, sizes))
    extra = {n: s for n, s in shape.items() if n not in ("data", "lane")}
    if shape.get("data", 1) > 1 or any(s > 1 for s in extra.values()):
        raise NotImplementedError(f"mesh {mesh_shape}: {DATA_AXIS}")
    dev = resolve_device(device)
    S = shape.get("lane", 1)
    if S == 1:
        return Mesh(names, sizes, dev)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"mesh {mesh_shape}: a lane axis of {S} shards runs one process "
            f"per shard; initialise torch.distributed (world size {S}) "
            f"first, e.g. under torchrun --nproc_per_node {S}")
    if dist.get_world_size() != S:
        raise RuntimeError(f"mesh {mesh_shape} needs a world of {S} ranks, "
                           f"not {dist.get_world_size()}")
    # the lane group of data index 0: ranks 0 .. S - 1 (row-major)
    group = dist.new_group(list(range(S)))
    return Mesh(names, sizes, dev, group, dist.get_rank())


def shard_episode_batch(mesh: Mesh, rand):
    """Place a batch of episode draws ``[B, T, L]`` on the mesh: the data
    axis has one device, so every lane rank holds all the draws (each reads
    its lanes' columns) on its device."""
    return rand.to(mesh.device)
