"""Where a step of K1 goes, from in-kernel cycle stamps.

    python -m dhts_torch.ops.cuda.k1_clock [--repeats 5]

Builds ``csrc/itscp_hybrid_episode.cu`` with ``-DDHTS_K1_CLOCK`` (thread 0
of block 0 reads the clock after each barrier of a step and adds up the
cycles of each phase: A, the B1 leader walk (with the soft blend fold),
B2, C1, C2, C3 (with the soft static fold), the lane queue; beside the
lanes' path, the first thread of the reduction warp its cycles from a
step's records to their release, and the first macro and micro lane's
threads their B2 work) and runs one episode of the 3x3 hybrid preset of
``run_itscp_hybrid.sh`` (T = 600, 144 lanes, B = 1, action 0.5) on the
card in three kernels: the hard forward, the soft forward and the
backward (``Dual``, block 0 seeds action entry 0). Prints
one JSON line per kernel: the cycles per step of each phase, their shares
of the lanes' path, the clocked kernel's ms and the build without stamps'
ms (CUDA events, median of ``--repeats`` runs of 5 launches back to back),
the unstamped step's us split in the stamps' shares, and the threads of a
block and the blocks an SM holds at once. The clocked and unclocked
outputs must be bit-equal (the stamps change nothing). Then the card's
name, power limit and SM clocks. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from dhts_torch.ops.cuda import _build, _launch
from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

# the phases of csrc/itscp_hybrid_episode.cu's K1Phase, in order; the last
# three are beside the lanes' path: the reduction warp's cycles and the B2
# work of a macro lane's and of a micro lane's thread
PHASES = ("A", "walk", "B2", "C1", "C2", "C3", "lane_queue",
          "reduction_warp", "B2_macro_work", "B2_micro_work")
OFF_PATH = ("reduction_warp", "B2_macro_work", "B2_micro_work")
# the 3x3 hybrid preset of run_itscp_hybrid.sh (problem 1)
PRESET = dict(num_intersection=3, num_lane=1, lane_length=5, speed_limit=60,
              policy_length=20, signal_length=4, simulation_frequency=30,
              mode="hybrid", use_fused_episode=True, random_seed=3)


def clocked_library():
    """The clocked build, its launchers bound."""
    return k1.bind(ctypes.CDLL(str(_build.build(
        "itscp_hybrid_episode", defines=("DHTS_K1_CLOCK",)))))


def stamps(lib, reader: str, n: int, reset: bool = False) -> list[int]:
    """The ``n`` stamps that a clocked build's ``int reader(long long* out,
    int reset)`` summed since the last reset (``reset``: zero them
    first)."""
    fn = getattr(lib, reader)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_longlong * n)()
    _launch.raise_on(fn(buf, int(reset)), reader)
    return list(buf)


def read_cycles(lib, reset: bool = False) -> list[int]:
    """The stamps of the last clocked launch (``reset``: zero them)."""
    return stamps(lib, "itscp_hybrid_episode_clock", len(PHASES), reset)


def preset_inputs(dev, action: float = 0.5):
    """The preset's hard and soft plans and one episode's inputs."""
    from dhts_torch.apps.control.itscp import problem
    from dhts_torch.apps.control.itscp.env import ItscpEnv

    env = ItscpEnv(config=PRESET, schedule_fn=problem.problem_1, device=dev)
    env.reset(3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rand = env.draw_rand(gen)
    act = torch.full((env.n_phases, env.action_size() // env.n_phases),
                     action, device=dev)
    ins = (act, env.data.schedule, env.data.mroute_next,
           env.data.mroute_prev, rand, env.data.inj_routes,
           env.base_state.route_pool)
    return env.fused_plan(False), env.fused_plan(True), ins


def runs(plan_hard, plan_soft, ins, dev):
    """``{kernel: (launcher name, plan, outputs)}`` of the three kernels."""
    T = plan_hard.T
    w = torch.full((T,), -1.0, device=dev)
    fwd = lambda: (torch.empty((), device=dev), torch.empty(T, device=dev),
                   torch.empty((T, 8), device=dev))
    grad = torch.empty((plan_soft.n_phases, plan_soft.n_inter), device=dev)
    return {"hard": ("launch_itscp_hybrid_episode_fwd", plan_hard, fwd()),
            "soft": ("launch_itscp_hybrid_episode_fwd", plan_soft, fwd()),
            "dual": ("launch_itscp_hybrid_episode_bwd", plan_soft,
                     (w, grad))}


def events_ms(fn, repeats: int, launches: int = 5) -> float:
    """Median ms of one ``fn()`` over ``repeats`` runs, each timed by CUDA
    events around ``launches`` calls back to back."""
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return sorted(times)[repeats // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_clock: needs a CUDA device")
    dev = torch.device("cuda")
    clocked = clocked_library()
    plain = k1._library()
    hard, soft, ins = preset_inputs(dev)
    stream = _launch.stream(dev)
    ok = True
    for name, (launcher, plan, outs) in runs(hard, soft, ins, dev).items():
        kargs = k1.kernel_args(plan, ins, outs, stream)
        calls = {"ms_clocked": lambda: getattr(clocked, launcher)(*kargs),
                 "ms": lambda: getattr(plain, launcher)(*kargs)}
        results, rec = {}, {"kernel": name, "T": plan.T, "L": plan.L, "B": 1,
                            "threads": plan.lane_perm.numel() + 32}
        rec["blocks_per_sm"] = clocked.itscp_hybrid_episode_blocks_per_sm(
            plan.L, plan.C, plan.V, plan.K, int(name == "dual"),
            plan.lane_perm.numel())
        written = outs[1:] if name == "dual" else outs
        for key, call in calls.items():
            for x in written:
                x.fill_(float("nan"))
            _launch.raise_on(call(), f"{name} {key}")
            torch.cuda.synchronize()
            results[key] = [x.clone() for x in written]
            rec[key] = events_ms(call, args.repeats)
        rec["bit_equal"] = all(torch.equal(a, b) for a, b in zip(
            results["ms_clocked"], results["ms"]))
        ok = ok and rec["bit_equal"]
        read_cycles(clocked, reset=True)
        _launch.raise_on(calls["ms_clocked"](), name)
        torch.cuda.synchronize()
        cyc = dict(zip(PHASES, read_cycles(clocked)))
        total = sum(c for p, c in cyc.items() if p not in OFF_PATH)
        rec["cycles_per_step"] = {p: c / plan.T for p, c in cyc.items()}
        rec["cycles_per_step_total"] = total / plan.T
        # shares of the lanes' path (the reduction warp's of it too)
        rec["share"] = {p: c / max(total, 1) for p, c in cyc.items()}
        rec["us_per_step"] = rec["ms"] * 1e3 / plan.T
        rec["us_per_step_by_phase"] = {
            p: rec["us_per_step"] * v for p, v in rec["share"].items()}
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
