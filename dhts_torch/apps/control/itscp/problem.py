"""Structured incoming-traffic schedules for ITSCP (port of
:mod:`dhts.apps.control.itscp.problem`, host-side numpy).

Parity: reference ``example/control/itscp/problem.py:5-81`` — the horizon is
split into k sessions; each session is randomly NS-heavy or WE-heavy
(alternating after the first draw); arms in the heavy direction receive
inflow density 0.9 + 0.1 r, the others 0.0 + 0.01 r, constant within a
session. ``random_schedule`` is the reference's default
``itscp_random_schedule`` (``_env.py:64-93``): 5 sessions of uniformly
random inflow per lane.

Schedules are returned as a dense ``f32[num_timestep, L]`` array over *all*
lanes (only lanes with no predecessor consume them, like the reference).
"""

from __future__ import annotations

import numpy as np


def sessioned_problem(locs, num_timestep: int, num_session: int,
                      rng: np.random.Generator) -> np.ndarray:
    L = len(locs)
    out = np.zeros((num_timestep, L), np.float32)
    per = num_timestep // num_session

    heavy_ns = bool(rng.random() > 0.5)
    directions = []
    for s in range(num_session):
        directions.append("NS" if heavy_ns else "WE")
        heavy_ns = not heavy_ns

    for li, loc in enumerate(locs):
        t = 0
        for s in range(num_session):
            r = float(rng.random())
            if directions[s] == "NS":
                val = 0.9 + r * 0.1 if loc in ("north", "south") else r * 0.01
            else:
                val = 0.9 + r * 0.1 if loc in ("west", "east") else r * 0.01
            n = per if s < num_session - 1 else num_timestep - t
            out[t: t + n, li] = val
            t += n
    return out


def problem_1(locs, num_timestep, rng):
    return sessioned_problem(locs, num_timestep, 1, rng)


def problem_2(locs, num_timestep, rng):
    return sessioned_problem(locs, num_timestep, 2, rng)


def problem_3(locs, num_timestep, rng):
    return sessioned_problem(locs, num_timestep, 3, rng)


def random_schedule(locs, num_timestep, rng, num_session: int = 5):
    """Uniformly random per-lane inflow held constant within each of 5
    sessions (reference ``itscp_random_schedule``, ``_env.py:64-93``)."""
    L = len(locs)
    out = np.zeros((num_timestep, L), np.float32)
    per = max(1, num_timestep // num_session)
    for li in range(L):
        t = 0
        for s in range(num_session):
            n = per if s < num_session - 1 else num_timestep - t
            if n <= 0:
                break
            out[t: t + n, li] = rng.random()
            t += n
    return out


PROBLEMS = {1: problem_1, 2: problem_2, 3: problem_3, 0: random_schedule}
