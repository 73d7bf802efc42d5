"""ITSCP grid scene: N x N four-way intersections (port of
:mod:`dhts.apps.control.itscp.scene`, host-side numpy).

Rebuild of the reference's ``ItscpEnv._make_road``
(``example/control/itscp/_env.py:221-439``) without the highway-env
dependency: lane endpoint geometry is computed with plain NumPy (rotations of
a canonical corner layout), the simulation graph goes into a
:class:`dhts_torch.models.scene.SceneBuilder`, and per-lane signal metadata is
resolved into arrays consumed by the signal logic.

Per intersection and corner there are ``num_lane`` approaching and
``num_lane`` leaving lanes (loc in {north, south, east, west}); inside the
box, every approaching lane gets a straight connector and the rightmost lane
additionally a right-turn connector (left turns are disabled in the
reference, ``_env.py:320-324``). Adjacent intersections are stitched
leaving -> approaching (``_env.py:395-439``). Hybrid mode places macro lanes
on the grid border rows/cols and micro lanes inside (``_env.py:489-498``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from dhts_torch.models.scene import SceneBuilder

LANE_WIDTH = 4.0  # highway-env AbstractLane.DEFAULT_WIDTH (reference :233)


@dataclasses.dataclass(frozen=True)
class LaneKey:
    """Identity of a lane in the grid (reference ``LaneID``, _env.py:24-62).

    ``loc``: which arm ('north'/'south'/'east'/'west') or 'mid' for an
    in-intersection connector; ``ploc``: for 'mid', the approaching arm it
    comes from; ``approaching``: True if traffic on it drives toward the
    intersection; ``lane``: 0-based lane index within the arm (0 = leftmost
    seen from the approaching side).
    """

    row: int
    col: int
    loc: str
    ploc: str | None
    approaching: bool
    lane: int

    def __str__(self):
        app = "approaching" if self.approaching else "leaving"
        return (f"{self.row}_{self.col}_{self.loc}_{self.ploc}_{app}"
                f"_{self.lane}")


@dataclasses.dataclass
class GridScene:
    """Everything the env needs: sim spec inputs + per-lane metadata."""

    builder: SceneBuilder
    keys: List[LaneKey]  # index = sim lane id
    key_to_id: Dict[LaneKey, int]
    segments: np.ndarray  # f32[L, 2, 2]: lane start/end points (travel dir)
    approaching: np.ndarray  # bool[L] (non-mid approaching arms)
    is_mid: np.ndarray  # bool[L]
    is_we: np.ndarray  # bool[L]: signal axis is west/east
    intersection: np.ndarray  # i32[L]: row * N + col
    num_intersection: int
    num_lane: int


def _corner_frame(corner: int):
    angle = np.radians(90 * corner)
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s], [s, c]])


def _arm_locs(corner: int) -> Tuple[str, str]:
    """(approaching, leaving) arm names for a canonical corner, matching the
    reference's corner->loc table (_env.py:271-278)."""
    return [("south", "east"), ("west", "south"), ("north", "west"),
            ("east", "north")][corner]


def build_grid(num_intersection: int, num_lane: int, lane_length: float,
               speed_limit: float, cell_length: float, mode: str,
               max_vehicles_per_lane: int = 16,
               route_pool_size: int = 8) -> GridScene:
    """Construct the grid; ``mode`` in {'macro', 'micro', 'hybrid'}."""
    N = num_intersection
    right_turn_radius = LANE_WIDTH + 10.0
    outer = right_turn_radius + LANE_WIDTH * (num_lane - 3 + 0.5)
    pitch = 2.0 * (outer + lane_length)

    b = SceneBuilder(speed_limit, max_vehicles_per_lane=max_vehicles_per_lane,
                     route_pool_size=route_pool_size)
    keys: List[LaneKey] = []
    key_to_id: Dict[LaneKey, int] = {}
    segments: List[np.ndarray] = []

    def lane_is_macro(row, col):
        if mode == "macro":
            return True
        if mode == "micro":
            return False
        # hybrid: border intersections macro, interior micro (_env.py:489-498)
        return row in (0, N - 1) or col in (0, N - 1)

    def add_lane(key: LaneKey, start: np.ndarray, end: np.ndarray):
        length = float(np.linalg.norm(end - start))
        if lane_is_macro(key.row, key.col):
            lid = b.add_macro_lane(length, cell_length)
        else:
            lid = b.add_micro_lane(length)
        assert lid == len(keys)
        keys.append(key)
        key_to_id[key] = lid
        segments.append(np.stack([start, end]))
        return lid

    for row in range(N):
        for col in range(N):
            center = np.array([col * pitch, row * pitch])
            approaching_keys: List[LaneKey] = []
            for corner in range(4):
                rot = _corner_frame(corner)
                app_loc, leave_loc = _arm_locs(corner)
                for approaching in (True, False):
                    loc = app_loc if approaching else leave_loc
                    for lane_i in range(num_lane):
                        key = LaneKey(row, col, loc, None, approaching,
                                      lane_i)
                        lat = LANE_WIDTH * (lane_i + 0.5)
                        far = np.array([lat, lane_length + outer])
                        near = np.array([lat, outer])
                        if approaching:
                            start, end = far, near
                        else:
                            # leaving arms travel inner -> outer; the
                            # reference stores their geometry reversed and
                            # flips at render time, so the *sim* direction
                            # here is near -> far with flipped coordinates
                            start, end = np.flip(near), np.flip(far)
                        add_lane(key, center + rot @ start, center + rot @ end)
                        if approaching:
                            approaching_keys.append(key)

            # in-intersection connectors (straight + right turns)
            mid_idx = 0
            for akey in approaching_keys:
                a_id = key_to_id[akey]
                a_end = segments[a_id][1]
                for turn in ("straight", "right"):
                    if turn == "right" and akey.lane != num_lane - 1:
                        continue
                    n_loc = _turn_target(akey.loc, turn)
                    nkey = LaneKey(row, col, n_loc, None, False, akey.lane)
                    n_id = key_to_id[nkey]
                    n_start = segments[n_id][0]
                    mkey = LaneKey(row, col, "mid", akey.loc, True, mid_idx)
                    mid_idx += 1
                    m_id = add_lane(mkey, a_end, n_start)
                    b.connect(a_id, m_id)
                    b.connect(m_id, n_id)

    # stitch adjacent intersections: leaving arm -> facing approaching arm
    for row in range(N):
        for col in range(N):
            for lane_i in range(num_lane):
                if row > 0:
                    up_leave = key_to_id[LaneKey(row - 1, col, "south", None,
                                                 False, lane_i)]
                    here_app = key_to_id[LaneKey(row, col, "north", None,
                                                 True, lane_i)]
                    b.connect(up_leave, here_app)
                    here_leave = key_to_id[LaneKey(row, col, "north", None,
                                                   False, lane_i)]
                    up_app = key_to_id[LaneKey(row - 1, col, "south", None,
                                               True, lane_i)]
                    b.connect(here_leave, up_app)
                if col > 0:
                    left_leave = key_to_id[LaneKey(row, col - 1, "east", None,
                                                   False, lane_i)]
                    here_app = key_to_id[LaneKey(row, col, "west", None, True,
                                                 lane_i)]
                    b.connect(left_leave, here_app)
                    here_leave = key_to_id[LaneKey(row, col, "west", None,
                                                   False, lane_i)]
                    left_app = key_to_id[LaneKey(row, col - 1, "east", None,
                                                 True, lane_i)]
                    b.connect(here_leave, left_app)

    L = len(keys)
    is_mid = np.array([k.loc == "mid" for k in keys])
    approaching = np.array([k.approaching and k.loc != "mid" for k in keys])
    # signal axis of an approaching arm: traffic FROM west/east crosses on
    # the WE phase (reference lane_signal_info, _env.py:952-960)
    is_we = np.array([k.loc in ("west", "east") for k in keys])
    inter = np.array([k.row * N + k.col for k in keys], np.int32)
    return GridScene(builder=b, keys=keys, key_to_id=key_to_id,
                     segments=np.asarray(segments, np.float32),
                     approaching=approaching, is_mid=is_mid, is_we=is_we,
                     intersection=inter, num_intersection=N,
                     num_lane=num_lane)


def _turn_target(loc: str, turn: str) -> str:
    """Destination arm for a movement out of ``loc`` (reference
    _env.py:339-365; arms are named by their compass position, so going
    straight from the north arm exits via the south arm)."""
    if turn == "straight":
        return {"north": "south", "south": "north", "west": "east",
                "east": "west"}[loc]
    if turn == "right":
        return {"north": "west", "west": "south", "east": "north",
                "south": "east"}[loc]
    raise ValueError(turn)
