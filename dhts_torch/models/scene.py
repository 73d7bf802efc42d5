"""Host-side scene construction (port of :mod:`dhts.models.scene`).

Scene structure is resolved once on the host into a static
:class:`SceneSpec` of fixed-shape tensors; all dynamic state lives in
:class:`dhts_torch.models.network.NetworkState`. The builder draws its
random routes with the same numpy calls in the same order as
``dhts.models.scene.SceneBuilder``, so the same generator state gives the
same routes bit for bit.

Padding conventions:
  C  max cells per macro lane        (cell axis of ``r``/``y``)
  V  max vehicles per micro lane     (slot axis; slot i is behind slot i+1)
  K  max graph neighbours per side   (adjacency lists, -1 padded)
  R  max route length
  P  per-lane pool of pre-drawn routes for vehicles created by emission
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from dhts_torch.models import vehicle as vehicle_mod

MAX_ROUTE_LENGTH = 32


class SceneSpec(NamedTuple):
    """Static network geometry/topology as tensors on one device."""

    is_macro: torch.Tensor  # bool[L]
    length: torch.Tensor  # f32[L]
    num_cell: torch.Tensor  # i32[L] (0 for micro lanes)
    cell_length: torch.Tensor  # f32[L] (= length/num_cell; 1.0 for micro)
    cell_mask: torch.Tensor  # bool[L, C]
    next_lanes: torch.Tensor  # i32[L, K], -1 padded
    prev_lanes: torch.Tensor  # i32[L, K], -1 padded
    num_next: torch.Tensor  # i32[L]
    num_prev: torch.Tensor  # i32[L]
    speed_limit: float
    vehicle_length: float

    @property
    def num_lanes(self):
        return self.is_macro.shape[0]

    @property
    def max_cells(self):
        return self.cell_mask.shape[1]

    @property
    def device(self):
        return self.is_macro.device


class SceneBuilder:
    """Imperative scene assembly, resolved to tensors by :meth:`build`."""

    def __init__(self, speed_limit: float,
                 vehicle_length: float = vehicle_mod.DEFAULT_VEHICLE_LENGTH,
                 max_vehicles_per_lane: int = 16,
                 max_route_length: int = MAX_ROUTE_LENGTH,
                 route_pool_size: int = 8):
        self.speed_limit = float(speed_limit)
        self.vehicle_length = float(vehicle_length)
        self.V = int(max_vehicles_per_lane)
        self.R = int(max_route_length)
        self.P = int(route_pool_size)
        self._lanes = []  # (is_macro, length, num_cell)
        self._next = {}
        self._prev = {}

    def add_macro_lane(self, lane_length: float, cell_length: float) -> int:
        """ARZ lane with ``ceil(length / cell_length)`` cells."""
        num_cell = math.ceil(lane_length / cell_length)
        assert num_cell > 0, "macro lane must have at least one cell"
        return self._add(True, float(lane_length), num_cell)

    def add_micro_lane(self, lane_length: float) -> int:
        return self._add(False, float(lane_length), 0)

    def _add(self, is_macro, length, num_cell) -> int:
        lane_id = len(self._lanes)
        self._lanes.append((is_macro, length, num_cell))
        self._next[lane_id] = []
        self._prev[lane_id] = []
        return lane_id

    def connect(self, prev_id: int, next_id: int):
        """Directed graph edge prev -> next."""
        self._next[prev_id].append(next_id)
        self._prev[next_id].append(prev_id)

    def random_route(self, start_lane: int, rng: np.random.Generator):
        """Random forward walk from ``start_lane`` avoiding revisits: pick a
        uniformly random next lane; if already on the route, scan forward
        cyclically for an unvisited one, else keep the first choice."""
        route = []
        cur = start_lane
        for _ in range(self.R):
            route.append(cur)
            nxt_ids = self._next[cur]
            if not nxt_ids:
                break
            i = rng.integers(0, len(nxt_ids))
            first = i
            while nxt_ids[i] in route:
                i = (i + 1) % len(nxt_ids)
                if i == first:
                    break
            cur = nxt_ids[i]
        return route

    def random_macro_route(self, rng: np.random.Generator):
        """Random 1:1 matching of macro lanes to next lanes."""
        L = len(self._lanes)
        macro_next = np.full(L, -1, np.int32)
        macro_prev = np.full(L, -1, np.int32)
        for lane_id in rng.permutation(L):
            if not self._lanes[lane_id][0]:
                continue
            for nxt in rng.permutation(np.asarray(self._next[lane_id],
                                                  np.int64)) if self._next[
                                                      lane_id] else []:
                if macro_prev[nxt] == -1:
                    macro_next[lane_id] = nxt
                    macro_prev[nxt] = lane_id
                    break
        return macro_next, macro_prev

    def build_spec(self, device="cpu") -> SceneSpec:
        L = len(self._lanes)
        assert L > 0, "empty scene"
        is_macro = np.array([l[0] for l in self._lanes])
        length = np.array([l[1] for l in self._lanes], np.float32)
        num_cell = np.array([l[2] for l in self._lanes], np.int32)
        C = max(1, int(num_cell.max()))
        cell_length = np.where(num_cell > 0, length / np.maximum(num_cell, 1),
                               1.0).astype(np.float32)
        K = max(1, max(len(v) for v in self._next.values()),
                max(len(v) for v in self._prev.values()))
        nxt = np.full((L, K), -1, np.int32)
        prv = np.full((L, K), -1, np.int32)
        for i in range(L):
            nxt[i, :len(self._next[i])] = self._next[i]
            prv[i, :len(self._prev[i])] = self._prev[i]
        cell_mask = np.arange(C)[None, :] < num_cell[:, None]
        num_next = np.array([len(self._next[i]) for i in range(L)], np.int32)
        num_prev = np.array([len(self._prev[i]) for i in range(L)], np.int32)
        t = lambda a: torch.as_tensor(a, device=device)
        return SceneSpec(
            is_macro=t(is_macro), length=t(length), num_cell=t(num_cell),
            cell_length=t(cell_length), cell_mask=t(cell_mask),
            next_lanes=t(nxt), prev_lanes=t(prv), num_next=t(num_next),
            num_prev=t(num_prev), speed_limit=self.speed_limit,
            vehicle_length=self.vehicle_length)

    def build_route_pool(self, rng: np.random.Generator, device="cpu"):
        """Pre-draw P random routes per lane for vehicles created by
        emission: int32 ``[L, P, R]``, -1 padded."""
        L = len(self._lanes)
        pool = np.full((L, self.P, self.R), -1, np.int32)
        for lane_id in range(L):
            for p in range(self.P):
                rt = self.random_route(lane_id, rng)
                pool[lane_id, p, :len(rt)] = rt
        return torch.as_tensor(pool, device=device)

    def build(self, rng: np.random.Generator | None = None, device="cpu"):
        """Returns ``(spec, empty NetworkState)`` on ``device``."""
        from dhts_torch.models import network  # local: avoid import cycle

        rng = rng or np.random.default_rng(0)
        spec = self.build_spec(device)
        state = network.empty_state(spec, max_vehicles_per_lane=self.V,
                                    max_route_length=self.R,
                                    route_pool=self.build_route_pool(
                                        rng, device))
        return spec, state
