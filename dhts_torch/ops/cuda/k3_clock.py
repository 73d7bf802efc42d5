"""Where a step of K3 goes, from in-kernel cycle stamps.

    python -m dhts_torch.ops.cuda.k3_clock [--V 10] [--T 500] [--repeats 5]

Builds ``csrc/micro_rollout.cu`` with ``-DDHTS_STEP_CLOCK`` (every thread
adds up the ``clock64()`` cycles of each part of its steps; thread 0 of
block 0 writes its sums; a part ends when its last value is ready, so the
stamps serialise what the unstamped step overlaps) and runs one platoon (B
= 1) at the micro inverse benchmark's defaults (dt 0.01, head deltas 1000
and 0) on the card, once spaced as the benchmark draws its platoons and
once dense (the acceleration floor binds, vehicles collide), through each
kernel the build has: the shared-memory forward (``smem``) and the ``Dual``
backward (``dual``, block 0 seeds pos0[0]), and the warp kernels (``warp``,
``warp_save`` with the trajectory saved, the reverse sweep over a saved
trajectory ``reverse`` and over one it replays first ``replay``). Prints
one JSON line per kernel and platoon: the cycles per step of each part,
their shares, the clocked kernel's ms and the unstamped build's ms (CUDA
events, median of ``--repeats`` runs of 20 launches back to back) with the
step's us split in the stamps' shares. The stamped outputs must equal the
unstamped build's bit for bit and the forwards' the plain version's. Then
the card's name, power limit and SM clocks. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from dhts_torch.models.vehicle import default_params
from dhts_torch.ops.cuda import _build, _launch
from dhts_torch.ops.cuda import micro_rollout as k3
from dhts_torch.ops.cuda.step_clock import events_ms

# the stamp slots of csrc/micro_rollout.cu: a forward step (the smem
# kernel's last part is its stores and barrier, the warp kernel's its
# trajectory store), then a reverse step
FWD_PARTS = ("exchange", "gap", "div_den", "spacing", "div_tgt", "div_gap",
             "acc", "div_dt", "euler", "store")
REV_PARTS = ("rows", "recompute", "partials", "update")
SLOTS = FWD_PARTS + REV_PARTS
# kernel: (direction, clocked launcher's kernel id, unstamped launcher,
# whether it reads or writes a trajectory, its parts)
KERNELS = {
    "smem": ("fwd", 0, "launch_micro_rollout_fwd_smem", False, FWD_PARTS),
    "warp": ("fwd", 1, "launch_micro_rollout_fwd", False, FWD_PARTS),
    "warp_save": ("fwd", 1, "launch_micro_rollout_fwd_save", True,
                  FWD_PARTS),
    "dual": ("bwd", 0, "launch_micro_rollout_bwd", False, FWD_PARTS),
    "reverse": ("bwd", 1, "launch_micro_rollout_bwd_saved", True,
                REV_PARTS),
    "replay": ("bwd", 2, "launch_micro_rollout_bwd_replay", True, SLOTS),
}
U_MAX, DT, HEAD_PD, HEAD_SD = 30.0, 0.01, 1000.0, 0.0


def platoon(V: int, dense: bool, seed: int, dev):
    """One seeded platoon ``[1, V]``: about four lengths apart at 0.3-0.7
    of the speed limit, as the benchmark draws them, or ``dense``: gaps of
    -1 to 0.6 m between 5 m vehicles, under 3 m/s."""
    rng = np.random.default_rng(seed)
    if dense:
        gap, vel = rng.uniform(4.0, 5.6, (1, V)), rng.uniform(0, 3, (1, V))
    else:
        gap = 20.0 + rng.uniform(0, 10.0, (1, V))
        vel = (0.3 + 0.4 * rng.uniform(0, 1, (1, V))) * U_MAX
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    return t(np.cumsum(gap, axis=1)), t(vel)


def bind_clock(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare a stamped build's launchers (the card's or the host's): the
    clocked ones take a trajectory after the outputs, and the kernel id and
    the stamps' pointer after the stream."""
    k3.bind(lib)
    for name, n_ptr in (("launch_micro_rollout_fwd_clock", 6),
                        ("launch_micro_rollout_bwd_clock", 7)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3 +
                       [ctypes.c_float] * 3 +
                       [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def clocked_library():
    """The stamped build for the card, its launchers bound."""
    return bind_clock(ctypes.CDLL(str(_build.build(
        "micro_rollout", defines=("DHTS_STEP_CLOCK",)))))


def measure(clocked, plain, kernel: str, consts, ins, repeats: int):
    """One kernel on one platoon: the stamped and unstamped runs' outputs
    and times, and the stamps; None if the build lacks the kernel."""
    direction, kid, launcher, traj_used, parts = KERNELS[kernel]
    if not hasattr(plain, launcher):
        return None
    dev = ins[0].device
    B, V = ins[0].shape
    T = consts.num_steps
    stream = _launch.stream(dev)
    traj = torch.empty((B, T, 2, V), device=dev) if traj_used else None
    if direction == "fwd":
        outs = (torch.empty((B, V), device=dev),
                torch.empty((B, V), device=dev))
        tensors = (*ins, *outs)
    else:
        cot = (torch.ones((B, V), device=dev),
               torch.full((B, V), 0.5, device=dev))
        outs = (torch.empty((B, 2 * V), device=dev),)
        tensors = (*ins, *cot, *outs)
        if kernel == "reverse":  # the trajectory a forward saved
            k3.launch_checked(plain, "launch_micro_rollout_fwd_save",
                              consts, (*ins, torch.empty_like(ins[0]),
                                       torch.empty_like(ins[0]), traj),
                              B, V, stream)
    args = k3.kernel_args(consts, tensors, B, V, stream)
    cl_args = k3.kernel_args(consts, (*tensors, traj), B, V, stream)
    cycles = torch.zeros(len(SLOTS), dtype=torch.int64, device=dev)
    clock_fn = getattr(clocked, f"launch_micro_rollout_{direction}_clock")
    unstamped_args = cl_args if traj_used else args
    calls = {"ms_clocked": lambda: clock_fn(
                 *cl_args, kid, ctypes.c_void_p(cycles.data_ptr())),
             "ms": lambda: getattr(plain, launcher)(*unstamped_args)}
    rec, results = {"kernel": kernel, "B": B, "V": V, "T": T}, {}
    for key, call in calls.items():
        for x in outs:
            x.fill_(float("nan"))
        err = call()
        if err == 1 and key == "ms_clocked":
            return None
        _launch.raise_on(err, f"{kernel} {key}")
        torch.cuda.synchronize()
        results[key] = [x.clone() for x in outs]
        rec[key] = events_ms(call, repeats)
    rec["bit_equal"] = all(torch.equal(a, b) for a, b in zip(
        results["ms_clocked"], results["ms"]))
    if direction == "fwd":
        ref = k3.plain_micro_rollout(consts, *ins)
        rec["bit_equal_plain"] = all(torch.equal(a, b) for a, b in zip(
            results["ms"], ref))
    cycles.zero_()
    _launch.raise_on(calls["ms_clocked"](), kernel)
    torch.cuda.synchronize()
    cyc = dict(zip(SLOTS, cycles.tolist()))
    total = sum(cyc[p] for p in parts)
    rec["cycles_per_step"] = {p: cyc[p] / max(T, 1) for p in parts}
    rec["cycles_per_step_total"] = total / max(T, 1)
    rec["share"] = {p: cyc[p] / max(total, 1) for p in parts}
    rec["us_per_step"] = rec["ms"] * 1e3 / max(T, 1)
    rec["us_per_step_by_part"] = {p: rec["us_per_step"] * s
                                  for p, s in rec["share"].items()}
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--V", type=int, default=10)
    ap.add_argument("--T", type=int, default=500)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k3_clock: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    clocked = clocked_library()
    plain = k3._library()
    consts = k3.micro_consts(default_params(U_MAX, (args.V,)), HEAD_PD,
                             HEAD_SD, DT, args.T, dev)
    ok = True
    for scene, dense in (("spaced", False), ("dense", True)):
        ins = platoon(args.V, dense, 21, dev)
        hits = int(k3.floor_hits(consts, *ins).sum())
        for kernel in KERNELS:
            rec = measure(clocked, plain, kernel, consts, ins, args.repeats)
            if rec is None:
                continue
            rec.update(platoon=scene, floor_hits=hits)
            ok = ok and rec["bit_equal"] and rec.get("bit_equal_plain", True)
            print(json.dumps(rec), flush=True)
    print(smi.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
