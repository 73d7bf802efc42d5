"""Where a step of K4 goes, from in-kernel cycle stamps.

    python -m dhts_torch.ops.cuda.k4_clock [--repeats 5]

Builds ``csrc/itscp_macro_episode.cu`` with ``-DDHTS_K4_CLOCK`` (the parts
of a step that its ``K4Part`` names, each stamped by the thread that does
it: lane 0's first thread on the lanes' path, the reduction warp's first
thread beside it; see the source) and runs one episode of K4's two scenes
on the card: the macro preset of ``run_itscp_macro.sh`` (L = 40, C = 7, T =
300) and the 3x3 preset of ``run_itscp_hybrid.sh`` in macro mode (L = 144,
C = 4, T = 600), and three that only the wide sweep takes: the 5x5 grid
of ``run_itscp_5x5.sh`` in macro mode (L = 400, C = 4, T = 600) and the
macro preset's lanes on the 3x3 grid (L = 360, C = 7, T = 300: the sweep's
state in global memory) and on the 4x4 grid (L = 640, C = 7, T = 300: the
forward's too), problem 1, seed 3, action 0.5, from the empty state,
through each kernel: the forward (``float``), the forward-mode derivative
(``Dual``; one block, seeding action entry 0; where its block fits the
scene) and the reverse sweep over the forward's saved trajectory. Prints
one JSON line per kernel and scene:
the threads a lane, the cycles per step of each part (the lanes' path and
the warp's apart), the clocked launch's ms and the unstamped build's ms
(CUDA events, median of ``--repeats`` runs of 5 launches back to back),
and whether the stamped and unstamped outputs are bit-equal (the stamps
change nothing). Then the card's name, power limit and SM clocks. Needs
one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from dhts_torch.ops.cuda import _build, _launch
from dhts_torch.ops.cuda import itscp_macro_episode as k4
from dhts_torch.ops.cuda.k1_clock import PRESET, events_ms, stamps

# csrc/itscp_macro_episode.cu's K4Part, in order: the forward's, then the
# reverse sweep's
PARTS = ("signals", "wait_edges", "ghosts", "godunov",
         "static_partials", "wait_update", "mean_fold", "wait_mean",
         "lane_queue", "wait_queue", "queue_sum", "steps", "reverse_load",
         "reverse_wait_edges", "reverse_riemann", "reverse_terms",
         "reverse_transpose", "reverse_wait_slots", "reverse_gather",
         "reverse_wait_empty", "reverse_fold", "reverse_wait_full",
         "reverse_steps")
# the reduction warp's parts (the rest are the lanes' path)
WARP_PARTS = ("wait_update", "mean_fold", "wait_queue", "queue_sum",
              "reverse_fold", "reverse_wait_full")
READER = "itscp_macro_episode_clock"
# the macro preset of run_itscp_macro.sh, the 3x3 preset and the 5x5 grid
# in macro mode, the macro preset's lanes on the 3x3 and 4x4 grids
MACRO_PRESET = dict(num_intersection=1, num_lane=3, lane_length=30,
                    speed_limit=60, policy_length=10, signal_length=2,
                    mode="macro", random_seed=3)
SCENES = {
    "macro_preset": MACRO_PRESET,
    "grid3_macro": dict(PRESET, mode="macro"),
    "grid5_macro": dict(PRESET, mode="macro", num_intersection=5),
    "macro_preset_grid3": dict(MACRO_PRESET, num_intersection=3),
    "macro_preset_grid4": dict(MACRO_PRESET, num_intersection=4)}


def clocked_library() -> ctypes.CDLL:
    """The stamped build for the card, its launchers bound."""
    return k4.bind(ctypes.CDLL(str(_build.build(
        "itscp_macro_episode", defines=("DHTS_K4_CLOCK",)))))


def read_cycles(lib, reset: bool = False) -> dict:
    """``{part: cycles}`` summed since the last reset."""
    return dict(zip(PARTS, stamps(lib, READER, len(PARTS), reset)))


def scene_inputs(cfg, dev, action: float = 0.5):
    """A scene's plan and one episode's inputs from the empty state."""
    from dhts_torch.apps.control.itscp import problem
    from dhts_torch.apps.control.itscp.env import ItscpEnv

    env = ItscpEnv(config=cfg, schedule_fn=problem.problem_1, device=dev)
    env.reset()
    plan = k4.make_plan(env.spec, env.meta, env.config, dev)
    zero = torch.zeros((plan.L, plan.C), device=dev)
    d = env.data
    a = torch.full((plan.n_phases, plan.n_inter), action, device=dev)
    return plan, (a, d.schedule, d.mroute_next, d.mroute_prev, zero,
                  zero.clone())


def kernels(plan, ins, dev) -> dict:
    """``{kernel: (launcher, outputs, args, query id, inputs)}``: the
    forward, the derivative's block of action entry 0 (where its block fits
    the scene), and the reverse sweep over the forward's trajectory (saved
    here first). ``args`` holds raw pointers: ``inputs`` keeps the tensors
    they point to alive."""
    T = plan.T
    w = torch.full((T,), -1.0, device=dev)
    grad = torch.zeros(plan.n_action + 2 * plan.L * plan.C, device=dev)
    rgrad = torch.empty_like(grad)
    stream = _launch.stream(dev)
    fwd_out = (torch.empty((), device=dev), torch.empty(T, device=dev))
    traj = k4.macro_episode_fwd(plan, *ins, trajectory=True)[2]
    out = {
        "fwd": ("launch_itscp_macro_episode_fwd", fwd_out,
                k4.kernel_args(plan, ins, fwd_out, stream), k4.KERNEL_FWD,
                ins),
        "dual": ("launch_itscp_macro_episode_bwd", (grad,),
                 k4.kernel_args(plan, ins, (w, grad), stream, (1, 0, 0)),
                 k4.KERNEL_TANGENTS, (ins, w)),
        "reverse": ("launch_itscp_macro_episode_reverse", (rgrad,),
                    k4.kernel_args(plan, ins, (w, *traj, rgrad), stream,
                                   replay=False), k4.KERNEL_REVERSE,
                    (ins, w, traj))}
    if not k4.lane_threads(k4._library(), plan, k4.KERNEL_TANGENTS):
        del out["dual"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k4_clock: needs a CUDA device")
    dev = torch.device("cuda")
    clocked = clocked_library()
    plain = k4._library()
    ok = True
    for scene, cfg in SCENES.items():
        plan, ins = scene_inputs(cfg, dev)
        for name, (launcher, outs, kargs, kid, _) in kernels(
                plan, ins, dev).items():
            calls = {"ms_clocked": lambda: getattr(clocked, launcher)(*kargs),
                     "ms": lambda: getattr(plain, launcher)(*kargs)}
            rec = {"kernel": name, "scene": scene, "T": plan.T, "L": plan.L,
                   "C": plan.C,
                   "lane_threads": k4.lane_threads(plain, plan, kid)}
            results = {}
            for key, call in calls.items():
                for x in outs:
                    x.fill_(float("nan"))
                _launch.raise_on(call(), f"{name} {key}")
                torch.cuda.synchronize()
                results[key] = [x.clone() for x in outs]
                rec[key] = events_ms(call, args.repeats)
            rec["bit_equal"] = all(
                torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(results["ms_clocked"], results["ms"]))
            ok = ok and rec["bit_equal"]
            read_cycles(clocked, reset=True)
            _launch.raise_on(calls["ms_clocked"](), name)
            torch.cuda.synchronize()
            cyc = read_cycles(clocked)
            rev = name == "reverse"
            steps = max(cyc.pop("reverse_steps" if rev else "steps"), 1)
            cyc = {p: c for p, c in cyc.items()
                   if p.startswith("reverse_") == rev and p != "steps"}
            rec["steps_stamped"] = steps
            rec["cycles_per_step"] = {p: c / steps for p, c in cyc.items()}
            rec["cycles_per_step_lanes_path"] = sum(
                c for p, c in cyc.items() if p not in WARP_PARTS) / steps
            rec["cycles_per_step_warp"] = sum(
                c for p, c in cyc.items() if p in WARP_PARTS) / steps
            rec["us_per_step"] = rec["ms"] * 1e3 / plan.T
            print(json.dumps(rec), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
