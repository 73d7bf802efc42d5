"""Where a launch of the lane-sharded step's B, C, D3 and E goes, from
in-kernel cycle stamps.

    python -m dhts_torch.ops.cuda.shard_clock [--launches 50] [--repeats 5]

Builds ``csrc/itscp_spatial_shard.cu`` with ``-DDHTS_SHARD_CLOCK`` (in
block 0, the thread that does a part adds up its cycles: the running
mean's fold, and on thread 0's path its set-up and any wait for the mean,
its own lane's update, the rows out, its wait for the other lanes and the
wave maximum in C; its way to its gates (set-up, first cells, any wait),
its lane's queue and the store in E; on the path of one lane's thread its
set-up, its signals, the injection and ghosts, the head's blend, the
leader walk, the rows out and the injection count (with any wait for the
other lanes) in B, and its set-up, its share of the want table, its wait
at the table's barrier, its arbitration, ``convert``, ``static_partials``,
the next step's A rows (``next_A``: their loads and arithmetic, which the
unstamped build issues ahead of ``static_partials``', and their stores)
and the emit and absorb counts in D3; the whole launch; each lane its own
update's cycles in C, its whole path before the count in B and D3) and
runs the 3x3 hybrid preset
of ``run_itscp_hybrid.sh`` (T = 600, 144 lanes, S = 4 shards of 36 lanes,
all in this process, B = 1, action 0.55, the draws of ``chip_smoke.py``'s
``shard_timing``) on the card through three kernels of each body: the
hard forward, the soft forward and the derivative (``Dual``, 45 blocks,
block 0 seeds action entry 0). Each steps the episode to the first quiet
step from 100 (:func:`quiet_step`, the step ``shard_timing`` times at) and
relaunches each shard's B, C, D3 and E there (shard 0 first:
``shard_timing`` times it), with that step's gathered rows in place. B's
and D3's parts are stamped on the path of the lane that took the most
cycles in a first stamped run (its local index is ``clock_lane``). Prints
one JSON line per kernel, shard and body: the stamped launch's
cycles by part, each lane's own cycles (the most and the mean over macro
and over micro lanes), the ms a launch of both builds (CUDA events around
``--launches`` launches back to back, median of ``--repeats``, the state
restored before each), the launch's cycles at the SM clock beside its ms,
and whether one stamped and one unstamped launch from the same state
wrote the same bits (every buffer of the shard). Then the card's name,
power limit and SM clocks. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from dhts_torch.ops.cuda import _build, _launch
from dhts_torch.ops.cuda import itscp_spatial_shard as ks
from dhts_torch.ops.cuda import itscp_spatial_step as k6
from dhts_torch.ops.cuda import spatial_clock

# the parts of csrc/itscp_spatial_shard.cu's ShardPart, in order, and the
# bodies whose launches it counts (ShardLaunch)
PARTS = ("C_fold", "C_wait", "C_lane", "C_rows", "C_end_wait", "C_wave",
         "C_total", "E_fold", "E_wait", "E_queue", "E_store", "E_total",
         "B_setup", "B_signals", "B_ghosts", "B_blend", "B_walk", "B_rows",
         "B_count", "B_total", "D3_setup", "D3_table", "D3_wait",
         "D3_arbitrate", "D3_convert", "D3_static", "D3_next_A", "D3_count",
         "D3_total")
LAUNCHED = ("C", "E", "B", "D3")
BODIES = ("B", "C", "D3", "E")
SHARDS, WARM = 4, 100
KINDS = ("hard", "soft", "dual")


def bind_clock(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The stamped build's launcher and its stamp readers, declared."""
    ks.bind(lib)
    lib.itscp_shard_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.itscp_shard_clock.restype = ctypes.c_int
    lib.itscp_shard_clock_lanes.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int]
    lib.itscp_shard_clock_lanes.restype = ctypes.c_int
    lib.itscp_shard_clock_lane.argtypes = [ctypes.c_int]
    lib.itscp_shard_clock_lane.restype = ctypes.c_int
    return lib


def read_cycles(lib, reset: bool = False) -> list[int]:
    """The stamps summed since the last reset: one count per part, then
    the launches stamped of each body of :data:`LAUNCHED` (``reset``: zero
    them)."""
    buf = (ctypes.c_longlong * (len(PARTS) + len(LAUNCHED)))()
    _launch.raise_on(lib.itscp_shard_clock(buf, int(reset)), "shard clock")
    return list(buf)


def read_lane_cycles(lib, n: int, reset: bool = False) -> list[int]:
    """Each local lane's own cycles (block 0; C's update, B's and D3's
    path before the count) summed since the last reset."""
    buf = (ctypes.c_longlong * n)()
    _launch.raise_on(lib.itscp_shard_clock_lanes(buf, n, int(reset)),
                     "shard lane clock")
    return list(buf)


def quiet_step(run: ks.ShardRun, t0: int) -> int:
    """Step a ShardRun of one process (all shards local) from t0 to the
    first step before the last without an injection (the step's gathered A
    rows, read before the step: D3 rewrites A's buffer), a conversion want
    or an arbitrated insert or deposit (:func:`ks.plain_arbitration` of the
    step's gathered rows), and return it: every body can be relaunched
    there on that step's inputs without growing a lane's vehicles, D3
    writing the next step's A rows as it does on the main path."""
    for t in range(t0, run.plan.T - 1):
        held = run.g_next.get("gA_v") if run.t_next == t else None
        injects = held is None or float(held[:, 8].sum()) != 0.0
        run.step(t)
        pred, verdicts = ks.plain_arbitration(run.plan, run.geom,
                                              run.g["gF_v"], run.g["gI"])
        if (not injects and int(pred.abs().sum()) == 0 and
                bool((verdicts == run.plan.L).all())):
            return t
    raise RuntimeError("no quiet step to time the bodies at")


class Quiet:
    """A ShardRun of ``kind`` (hard, soft or dual; ``plans``: the hard and
    the soft plan) over ``inputs`` on S local shards, stepped through
    ``warm`` steps and on to the next quiet step ``t`` (without ``warm``:
    step 0 run, ``t`` = 0), with shard i's buffers saved there (shard 0
    until :meth:`use` picks another); :meth:`launch` relaunches a body on
    shard i through any library of the source."""

    def __init__(self, plans, kind: str, inputs, lib, S: int = SHARDS,
                 warm: int = WARM):
        hard, soft = plans
        self.plan = soft if kind != "hard" else hard
        self.kind = kind
        L = self.plan.L
        self.comm = ks.LaneComm(L, ks.shards_of(L, S))
        saved = dict(ks.launches)
        self.run = ks.ShardRun(self.plan, self.comm, inputs,
                               dual=kind == "dual", lib=lib)
        for t in range(warm):
            self.run.step(t)
        self.t = quiet_step(self.run, warm) if warm else 0
        if not warm:
            self.run.step(0)
        ks.launches.update(saved)
        self.use(0)

    def use(self, i: int):
        """Relaunch on shard i from its state at the quiet step."""
        self.i = i
        self.shard, _, self.bufs, _ = self.run.shards[i]
        self.saved = self.snapshot()

    def snapshot(self) -> dict:
        return {k: v.clone() for k, v in self.bufs.items() if v is not None}

    def restore(self):
        for k, v in self.saved.items():
            self.bufs[k].copy_(v)

    def launch(self, lib, body: str, repeat: int = 1):
        """``repeat`` launches of ``body`` on shard i at the quiet step
        through ``lib`` (not counted in ``ks.launches``)."""
        saved = dict(ks.launches)
        self.run.lib = lib
        self.run.launch(body, self.t, [self.i], repeat=repeat)
        ks.launches.update(saved)

    def same_bits(self, libs, body: str) -> bool:
        """Whether one launch of ``body`` from the saved state writes the
        same bits through each library of ``libs``."""
        outs = []
        for lib in libs:
            self.restore()
            self.launch(lib, body)
            if self.bufs["fbuf"].is_cuda:
                torch.cuda.synchronize()
            outs.append(self.snapshot())
        self.restore()
        return all(torch.equal(outs[0][k], o[k]) for o in outs[1:]
                   for k in outs[0])


def timed_ms(q: Quiet, lib, body: str, launches: int, repeats: int) -> float:
    """Median ms a launch of ``launches`` back to back, the state restored
    before each run (CUDA events around the launches alone)."""
    times = []
    for _ in range(repeats):
        q.restore()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        q.launch(lib, body, launches)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    q.restore()
    return sorted(times)[repeats // 2]


def lane_summary(plan, shard, per_launch) -> dict:
    """The most and the mean of the lanes' own cycles a launch, by
    kind."""
    macro = plan.lane_i[0, shard.off:shard.off + shard.n].cpu().numpy() != 0
    per = np.asarray(per_launch, dtype=np.float64)
    return {kind: {"max": float(per[m].max()), "mean": float(per[m].mean()),
                   "lanes": int(m.sum()),
                   "argmax": int(shard.off + np.flatnonzero(m)[
                       per[m].argmax()])}
            for kind, m in (("macro", macro), ("micro", ~macro)) if m.any()}


def stamp(q: Quiet, clocked, body: str, launches: int,
          lane: int = 0) -> dict:
    """The stamped build's cycles a launch of ``body`` by part (over
    ``launches`` launches from the saved state; B's and D3's on the path of
    local lane ``lane``'s thread), and the lanes' own."""
    _launch.raise_on(clocked.itscp_shard_clock_lane(lane), "shard clock")
    read_cycles(clocked, reset=True)
    read_lane_cycles(clocked, q.shard.n, reset=True)
    q.restore()
    q.launch(clocked, body, launches)
    if q.bufs["fbuf"].is_cuda:
        torch.cuda.synchronize()
    cyc = read_cycles(clocked)
    lanes = read_lane_cycles(clocked, q.shard.n)
    q.restore()
    n = cyc[len(PARTS) + LAUNCHED.index(body)]
    parts = {p: c / max(n, 1) for p, c in zip(PARTS, cyc)
             if p.startswith(body + "_")}
    rec = {"launches_stamped": n, "cycles_per_launch": parts}
    if body != "E":
        rec[f"{body}_lane_cycles_per_launch"] = lane_summary(
            q.plan, q.shard, [c / max(n, 1) for c in lanes])
    if body in ("B", "D3"):
        rec["clock_lane"] = lane
    return rec


def slowest_lane(rec, body: str) -> int:
    """The global id of the lane that took the most cycles in ``rec`` (a
    :func:`stamp` record of ``body``)."""
    return max(rec[f"{body}_lane_cycles_per_launch"].values(),
               key=lambda v: v["max"])["argmax"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--launches", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("shard_clock: needs a CUDA device")
    dev = torch.device("cuda")
    clocked = bind_clock(ctypes.CDLL(str(_build.build(
        "itscp_spatial_shard", defines=("DHTS_SHARD_CLOCK",)))))
    plain = ks._library()
    env = spatial_clock.preset_env(dev)
    plans = (k6.make_plan(env, False), k6.make_plan(env, True))
    sm_mhz = float(spatial_clock.smi("clocks.max.sm", units=False))
    ok = True
    for kind in KINDS:
        ins = spatial_clock.inputs(env, 1, 301, 0.55)
        q = Quiet(plans, kind, ins, plain)
        for i, body in ((i, b) for i in range(SHARDS) for b in BODIES):
            if q.i != i:
                q.use(i)
            rec = {"kernel": kind, "body": body, "S": SHARDS, "shard": i,
                   "B": 1, "n": q.shard.n, "L": q.plan.L,
                   "quiet_step": q.t, "blocks": q.run.N}
            rec["bit_equal"] = q.same_bits((clocked, plain), body)
            ok = ok and rec["bit_equal"]
            rec.update(stamp(q, clocked, body, args.launches))
            if body in ("B", "D3"):
                lane = slowest_lane(rec, body) - q.shard.off
                rec.update(stamp(q, clocked, body, args.launches, lane))
            rec["ms_stamped"] = timed_ms(q, clocked, body, args.launches,
                                         args.repeats)
            rec["ms"] = timed_ms(q, plain, body, args.launches, args.repeats)
            total = rec["cycles_per_launch"][f"{body}_total"]
            rec["sm_clock_mhz"] = sm_mhz
            rec["stamped_launch_us_at_sm_clock"] = total / sm_mhz
            print(json.dumps(rec), flush=True)
    print(spatial_clock.smi("name,power.limit,clocks.sm,clocks.max.sm"),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
