"""Where a step of STEP goes, from in-kernel cycle stamps.

    python -m dhts_torch.ops.cuda.spatial_clock [--repeats 5]

Builds ``csrc/itscp_spatial_step.cu`` with ``-DDHTS_STEP_CLOCK`` (thread 0
of block 0 reads the clock after each barrier of a step and adds up the
cycles of each part: the prologue from kernel entry to A, A, B (ghosts,
leader walk, blend), the signal running mean, C (Godunov or IDM), D1, D2,
D3 (with the static partials), the static running mean, E and the final
reductions) and runs the 3x3 hybrid preset of ``run_itscp_hybrid.sh`` (T =
600, 144 lanes, B = 1, action 0.55) on the card through three kernels: the
hard forward, the soft forward and the derivative (``Dual``, 45 blocks,
block 0 seeds action entry 0). Each runs the first 100 steps unstamped,
then steps 100 to 149 in one launcher call from that state, stamped and
unstamped. Prints one JSON line per kernel: the cycles per step of each
part on the lanes' path and their shares, beside it the reduction warp's
cycles (``reduction_warp``) and each lane's own C cycles (the most and
the mean over macro and over micro lanes), the launcher call's ms of both
builds (CUDA events, median of ``--repeats`` calls, the state restored
before each), the unstamped step's us split in the stamps' shares, the
launch gap (the unstamped call's time less 50 times the stamped step's
cycles at the SM clock; it holds the carry's load and store too), and
the kernels' registers and blocks an SM. The stamped and unstamped
outputs (carry, queues, events, waves; the derivative's carry, tangents
and gradient) must be bit-equal. Then the card's name, power limit and SM
clocks. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from dhts_torch.ops.cuda import _build, _launch
from dhts_torch.ops.cuda import itscp_spatial_step as k6

# the parts of csrc/itscp_spatial_step.cu's StepPart, in order
PARTS = ("prologue", "A", "B", "signal_mean", "C", "D1", "D2", "D3",
         "static_mean", "E", "final", "reduction_warp")
OFF_PATH = ("reduction_warp",)  # beside the lanes' path
WARM, STEPS = 100, 50
# the 3x3 hybrid preset of run_itscp_hybrid.sh (problem 1)
PRESET = dict(num_intersection=3, num_lane=1, lane_length=5, speed_limit=60,
              policy_length=20, signal_length=4, simulation_frequency=30,
              mode="hybrid", use_fused_episode=True, random_seed=3)


def bind_clock(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The stamped build's launchers and its stamp readers, declared."""
    k6.bind(lib)
    lib.itscp_spatial_step_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.itscp_spatial_step_clock.restype = ctypes.c_int
    lib.itscp_spatial_step_clock_lanes.argtypes = [ctypes.c_void_p,
                                                   ctypes.c_int, ctypes.c_int]
    lib.itscp_spatial_step_clock_lanes.restype = ctypes.c_int
    return lib


def read_cycles(lib, reset: bool = False) -> list[int]:
    """The stamps summed since the last reset: one count per part, then
    the steps stamped (``reset``: zero them)."""
    buf = (ctypes.c_longlong * (len(PARTS) + 1))()
    _launch.raise_on(lib.itscp_spatial_step_clock(buf, int(reset)),
                     "spatial step clock")
    return list(buf)


def read_lane_cycles(lib, L: int, reset: bool = False) -> list[int]:
    """Each lane's own cycles in C (block 0) summed since the last reset."""
    buf = (ctypes.c_longlong * L)()
    _launch.raise_on(lib.itscp_spatial_step_clock_lanes(buf, L, int(reset)),
                     "spatial step lane clock")
    return list(buf)


def kernel_info(lib, plan, dual: bool) -> dict:
    """Registers and stack bytes a thread, and blocks an SM with the carry
    in shared memory and without."""
    out = (ctypes.c_int * 4)()
    fn = lib.itscp_spatial_step_kernel_info
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _launch.raise_on(fn(plan.L, plan.C, plan.V, plan.K, int(dual), out),
                     "spatial step kernel info")
    return dict(zip(("registers", "stack_bytes", "blocks_per_sm_carry_smem",
                     "blocks_per_sm_carry_global"), out))


def preset_env(dev):
    from dhts_torch.apps.control.itscp import problem
    from dhts_torch.apps.control.itscp.env import ItscpEnv

    env = ItscpEnv(config=PRESET, schedule_fn=problem.problem_1, device=dev)
    env.reset(3)
    return env


def inputs(env, B: int, seed: int, action: float):
    """The kernels' step inputs for B episodes of ``env``'s scene."""
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)
    rand = torch.stack([env.draw_rand(gen) for _ in range(B)])
    a = torch.full((env.n_phases, env.action_size() // env.n_phases),
                   action, device=env.device)
    d = env.data
    return (a, rand, d.schedule, d.mroute_next, d.mroute_prev,
            k6.route_table(d.inj_routes, env.base_state.route_pool))


class Run:
    """One kernel's packed state and outputs at B episodes of ``env``'s
    scene (draws from ``seed``), kept empty and after the first ``warm``
    steps, and a launcher call over steps [t0, t0 + n) of ``lib``."""

    def __init__(self, kernel: str, env, B: int, dev, lib, seed: int = 1234,
                 warm: int = WARM):
        self.kernel = kernel
        soft = kernel != "hard"
        self.plan = plan = k6.make_plan(env, soft)
        self.ins = inputs(env, B, seed, 0.55)
        T = plan.T
        if kernel == "dual":
            self.launcher = "launch_itscp_spatial_step_bwd"
            fb, db, ib = k6.dual_state(plan, B, dev)
            self.state = [fb, db, ib]
            self.outs = [torch.full((B, T), -1.0, device=dev),
                         torch.zeros(fb.shape[0], dtype=torch.float64,
                                     device=dev), None]
            self.written = [1]
        else:
            self.launcher = "launch_itscp_spatial_step_fwd"
            fb, ib = k6.empty_state(plan, B, dev)
            self.state = [fb, None, ib]
            self.outs = [torch.zeros((B, T), device=dev),
                         torch.zeros((B, T, 3), dtype=torch.int32,
                                     device=dev),
                         torch.zeros((B, T), device=dev)]
            self.written = [0, 1, 2]
        self.B = B
        self.empty = self.snapshot()
        if warm:
            self.call(lib, 0, warm)
            torch.cuda.synchronize()
        self.saved = self.snapshot()

    def snapshot(self):
        return [None if x is None else x.clone()
                for x in self.state + self.outs]

    def restore(self, snap=None):
        """Set state and outputs to ``snap`` (by default after the
        warm-up)."""
        for x, y in zip(self.state + self.outs, snap or self.saved):
            if x is not None:
                x.copy_(y)

    def call(self, lib, t0: int, n: int):
        stream = _launch.stream(self.ins[0].device)
        args = k6.kernel_args(self.plan, self.state, self.ins, self.outs,
                              self.B, t0, n, stream)
        _launch.raise_on(getattr(lib, self.launcher)(*args), self.kernel)

    def results(self):
        return [x.clone() for x in self.state if x is not None] + [
            self.outs[i].clone() for i in self.written]


def timed_ms(run: Run, lib, repeats: int, t0: int = WARM, n: int = STEPS,
             snap=None) -> float:
    """Median ms of one launcher call of n steps from t0, the state
    restored to ``snap`` (by default after the warm-up) before each call
    (CUDA events around the call alone)."""
    times = []
    for _ in range(repeats):
        run.restore(snap)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run.call(lib, t0, n)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[repeats // 2]


def smi(query: str, units: bool = True) -> str:
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           f"--format={fmt}"],
                          capture_output=True, text=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("spatial_clock: needs a CUDA device")
    dev = torch.device("cuda")
    clocked = bind_clock(ctypes.CDLL(str(_build.build(
        "itscp_spatial_step", defines=("DHTS_STEP_CLOCK",)))))
    plain = k6._library()
    env = preset_env(dev)
    sm_mhz = float(smi("clocks.max.sm", units=False))
    ok = True
    for kernel in ("hard", "soft", "dual"):
        run = Run(kernel, env, 1, dev, plain)
        res = {}
        for key, lib in (("stamped", clocked), ("unstamped", plain)):
            run.restore()
            if key == "stamped":
                read_cycles(clocked, reset=True)
                read_lane_cycles(clocked, run.plan.L, reset=True)
            run.call(lib, WARM, STEPS)
            torch.cuda.synchronize()
            res[key] = run.results()
            if key == "stamped":
                stamps = read_cycles(clocked)
                lanes = read_lane_cycles(clocked, run.plan.L)
        rec = {"kernel": kernel, "T": run.plan.T, "L": run.plan.L, "B": 1,
               "steps": STEPS, "from_step": WARM,
               "blocks": run.B * (run.plan.n_phases * run.plan.n_inter
                                  if kernel == "dual" else 1)}
        rec["bit_equal"] = all(torch.equal(a, b) for a, b in
                               zip(res["stamped"], res["unstamped"]))
        ok = ok and rec["bit_equal"]
        steps = stamps[-1]
        cyc = dict(zip(PARTS, stamps[:-1]))
        total = sum(c for q, c in cyc.items() if q not in OFF_PATH)
        rec["steps_stamped"] = steps
        rec["cycles_per_step"] = {p: c / max(steps, 1)
                                  for p, c in cyc.items()}
        rec["cycles_per_step_total"] = total / max(steps, 1)
        # each lane's own C work (beside the path: C ends at the slowest)
        macro = run.plan.lane_i[0].cpu().numpy() != 0
        per = np.asarray(lanes, dtype=np.float64) / max(steps, 1)
        rec["C_lane_cycles_per_step"] = {
            kind: {"max": float(per[m].max()), "mean": float(per[m].mean()),
                   "argmax": int(np.flatnonzero(m)[per[m].argmax()])}
            for kind, m in (("macro", macro), ("micro", ~macro)) if m.any()}
        rec["kernel_info"] = kernel_info(plain, run.plan, kernel == "dual")
        rec["share"] = {p: c / max(total, 1) for p, c in cyc.items()}
        rec["ms_stamped_call"] = timed_ms(run, clocked, args.repeats)
        rec["ms_call"] = timed_ms(run, plain, args.repeats)
        rec["us_per_step"] = rec["ms_call"] * 1e3 / STEPS
        rec["us_per_step_by_part"] = {
            p: rec["us_per_step"] * v for p, v in rec["share"].items()}
        # the call's time beyond its stamped cycles at the SM clock
        busy_ms = STEPS * rec["cycles_per_step_total"] / (sm_mhz * 1e3)
        rec["sm_clock_mhz"] = sm_mhz
        rec["launch_gap_ms_per_call"] = rec["ms_call"] - busy_ms
        rec["launch_gap_us_per_step"] = (rec["ms_call"] - busy_ms) * 1e3 / \
            STEPS
        print(json.dumps(rec), flush=True)
    print(smi("name,power.limit,clocks.sm,clocks.max.sm"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
