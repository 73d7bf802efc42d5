"""Where a step of K2's forward goes, from in-kernel cycle stamps.

    python -m dhts_torch.ops.cuda.step_clock [--B 1] [--C 10] [--T 500]

Builds ``csrc/macro_rollout.cu`` with ``-DDHTS_STEP_CLOCK`` (thread 0 of
block 0 adds up the ``clock64()`` cycles of each part of a step) and runs
the forward at the inverse benchmark's macro defaults on the card through
each kernel that takes the lane: the warp kernel (cells in registers, C <=
31) and the shared-memory one. Prints one JSON line per kernel: the cycles
per step of each part, their shares, the clocked kernel's ms (CUDA events,
median of 5 runs of 20 launches back to back) and, for the kernel the
launcher picks at this C, the ms of the build without stamps with the
step's us split in the stamps' shares. Every run's outputs must equal the
plain version's bit for bit. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from dhts_torch.ops import arz
from dhts_torch.ops.cuda import _build, _launch
from dhts_torch.ops.cuda import macro_rollout as k2

PARTS = ("neighbour_states", "riemann", "flux_exchange", "cell_update")
KERNELS = {"warp": 1, "smem": 0}
WARP_CELLS = 31  # the most cells of the warp kernel (csrc/macro_rollout.cu)


def inputs(B: int, C: int, u_max: float, seed: int, dev):
    """Seeded scenarios drawn as ``chip_smoke.py``'s ``macro_inputs``."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    r0 = t(rng.uniform(0, 1, (B, C)))
    y0 = arz.compute_y(r0, t(rng.uniform(0, u_max, (B, C))),
                       u_max).contiguous()
    ghosts = [t(rng.uniform(0, hi, B)) for hi in (1.0, u_max, 1.0, u_max)]
    return (r0, y0, *ghosts)


def events_ms(fn, repeats: int = 5, launches: int = 20) -> float:
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
    ap.add_argument("--B", type=int, default=1)
    ap.add_argument("--C", type=int, default=10)
    ap.add_argument("--T", type=int, default=500)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_clock: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    lib = k2.bind(ctypes.CDLL(str(_build.build(
        "macro_rollout", defines=("DHTS_STEP_CLOCK",)))))
    fn = lib.launch_macro_rollout_fwd_clock
    fn.argtypes = list(k2._ARGTYPES) + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    consts = k2.MacroConsts(30.0, 0.01, 5.0, args.T)
    B, C = args.B, args.C
    ins = inputs(B, C, consts.u_max, 21, dev)
    ref = k2.plain_macro_rollout(consts, *ins)
    out = (torch.empty((B, C), device=dev), torch.empty((B, C), device=dev),
           torch.empty((B,), device=dev))
    cycles = torch.zeros(4, dtype=torch.int64, device=dev)
    kargs = k2.kernel_args(consts, (*ins, *out), B, C, _launch.stream(dev))
    picked = "warp" if C <= WARP_CELLS else "smem"
    ok = True
    for name, warp in KERNELS.items():
        if warp and C > WARP_CELLS:
            continue
        calls = {"ms_clocked": lambda: fn(*kargs, warp, ctypes.c_void_p(
            cycles.data_ptr()))}
        if name == picked:
            calls["ms"] = lambda: k2._library().launch_macro_rollout_fwd(
                *kargs)
        rec = {"kernel": name, "picked": name == picked, "B": B, "C": C,
               "T": args.T}
        for key, call in calls.items():
            for x in out:
                x.fill_(float("nan"))
            _launch.raise_on(call(), f"{name} {key}")
            torch.cuda.synchronize()
            rec[f"{key}_bit_equal"] = all(bool(torch.equal(a, b))
                                          for a, b in zip(out, ref))
            ok = ok and rec[f"{key}_bit_equal"]
            rec[key] = events_ms(call)
        _launch.raise_on(calls["ms_clocked"](), name)
        torch.cuda.synchronize()
        cyc = cycles.tolist()
        total = sum(cyc)
        rec["cycles_per_step"] = {p: c / args.T for p, c in zip(PARTS, cyc)}
        rec["share"] = {p: c / total for p, c in zip(PARTS, cyc)}
        rec["cycles_per_step_total"] = total / args.T
        if "ms" in rec:
            # the unclocked step's us split in the stamps' shares
            rec["us_per_step"] = rec["ms"] * 1e3 / args.T
            rec["us_per_step_by_part"] = {
                p: rec["us_per_step"] * v for p, v in rec["share"].items()}
        print(json.dumps(rec), flush=True)
    print(smi.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
