"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path on the 3x3 hybrid ITSCP preset of
``run_itscp_hybrid.sh`` (144 lanes, T = 600 steps at 30 Hz), through the
hand-written CUDA forward of the fused episode kernel (K1), and nothing of
the JAX package. Each phase prints one JSON line with its wall seconds:

1. ``device``  card name and power limit (``nvidia-smi``), PyTorch/CUDA
2. ``build``   every ``dhts_torch/ops/cuda/csrc/*.cu`` compiled with nvcc,
               all at once, one process each
3. ``k1_vs_plain``  the kernel against its plain PyTorch version on the card,
               same inputs: events[T, 8] exactly equal, reward rel <= 1e-4,
               queues abs <= 1e-4, at least one emission
4. ``serve``   a seeded random controller answers 3 requests (seeds 3, 4, 5):
               reset -> observe -> controller -> squash -> hard episode; the
               kernel's launch count must rise by exactly 3
5. ``timing``  kernel ms per episode (CUDA events, median of 10 after a
               warm-up) and the plain version's ms (median of 3)
6. ``kernels`` the per-kernel record (launches, error, times, bound)

then the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero without that
line; a watchdog ends a run that hangs. Needs one CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
WATCHDOG_SECONDS = 900
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, non-tensor-core float32
# float32 operations per Riemann interface and per cell update, counted
# from csrc/itscp_hybrid_episode.cu (riemann, comp_u and the flux update)
OPS_PER_INTERFACE = 60
OPS_PER_CELL = 14
PRESET = dict(num_intersection=3, num_lane=1, lane_length=5, speed_limit=60,
              policy_length=20, signal_length=4, simulation_frequency=30,
              mode="hybrid", use_fused_episode=True)

_phase = {"name": "start", "t0": time.perf_counter()}


def _start_watchdog(seconds: float):
    def bark():
        time.sleep(seconds)
        print(json.dumps({"watchdog": f"phase {_phase['name']!r} still "
                          f"running after {seconds:.0f} s; exiting"}),
              flush=True)
        os._exit(1)

    threading.Thread(target=bark, daemon=True).start()


def phase(name: str):
    _phase["name"] = name
    _phase["t0"] = time.perf_counter()


def report(**fields):
    rec = {"phase": _phase["name"],
           "seconds": time.perf_counter() - _phase["t0"], **fields}
    print(json.dumps(rec), flush=True)
    return rec


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats: int):
    """Median milliseconds of ``fn()`` over ``repeats`` runs, each timed by
    CUDA events on the current stream."""
    import torch

    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def main() -> int:
    if not (HERE / "dhts_torch" / "ops" / "cuda" / "csrc").is_dir():
        print("chip_smoke.py: the dhts_torch package is not beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this run "
              "needs one CUDA device", file=sys.stderr)
        return 3
    _start_watchdog(WATCHDOG_SECONDS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- 1. device
    phase("device")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    report(nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
           torch=torch.__version__, cuda=torch.version.cuda,
           python=sys.version.split()[0])

    # ---- 2. build: one nvcc per source, all started together
    phase("build")
    from dhts_torch.ops.cuda import _build

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        paths = dict(zip(names, pool.map(_build.build, names)))
    ptxas = {n: [ln.strip() for ln in
                 (_build.BUILD_DIR / f"{p.stem}.ptxas.txt").read_text(
                 ).splitlines() if "registers" in ln or "spill" in ln][-2:]
             for n, p in paths.items()
             if (_build.BUILD_DIR / f"{p.stem}.ptxas.txt").exists()}
    report(libraries={n: str(p.relative_to(HERE)) for n, p in paths.items()},
           nvcc_seconds={n: _build.build_seconds.get(n) for n in names},
           ptxas=ptxas)

    from dhts_torch.apps.control.controller import (init_controller,
                                                     squash_action)
    from dhts_torch.apps.control.itscp import problem
    from dhts_torch.apps.control.itscp.env import ItscpEnv
    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

    kfn = k1.itscp_hybrid_episode_fwd
    dev = torch.device("cuda")

    # ---- 3. K1 against its plain version, same inputs, on the card
    phase("k1_vs_plain")
    env = ItscpEnv(config=dict(PRESET, random_seed=3),
                   schedule_fn=problem.problem_1, device=dev)
    env.reset()
    T, L = env.num_timestep, env.spec.num_lanes
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rand = env.draw_rand(gen)
    env._fused_episode_one(False)  # builds the plan
    plan = env._fused[0].plan

    def k1_inputs(action_flat):
        return (action_flat.reshape(env.n_phases, -1).contiguous(),
                env.data.schedule, env.data.mroute_next,
                env.data.mroute_prev, rand, env.data.inj_routes,
                env.base_state.route_pool)

    checks = []
    max_abs_err = 0.0
    for a in (0.3, 0.7):
        inputs = k1_inputs(torch.full((env.action_size(),), a, device=dev))
        kr, kq, ke = kfn(plan, *inputs)
        pr, pq, pe = k1.plain_episode(plan, *inputs)
        torch.cuda.synchronize()
        ev_equal = bool(torch.equal(ke, pe))
        rel = abs(float(kr) - float(pr)) / max(abs(float(pr)), 1e-30)
        q_err = float((kq - pq).abs().max())
        max_abs_err = max(max_abs_err, q_err, abs(float(kr) - float(pr)))
        tot = pe[:, :3].sum(0).tolist()
        rec = dict(action=a, events_equal=ev_equal,
                   events_mismatch_steps=int((ke != pe).any(1).sum()),
                   reward_kernel=float(kr), reward_plain=float(pr),
                   reward_rel_err=rel, queues_max_abs_err=q_err,
                   injected=tot[0], emitted=tot[1], absorbed=tot[2],
                   finite=bool(torch.isfinite(kq).all()))
        checks.append(rec)
        ok = (ev_equal and rel <= 1e-4 and q_err <= 1e-4 and tot[1] >= 1
              and rec["finite"] and tuple(kq.shape) == (T,)
              and tuple(ke.shape) == (T, 8))
        if not ok:
            report(checks=checks, status="FAIL")
            raise SystemExit(f"k1_vs_plain failed at action {a}: {rec}")
    lib = _build.load("itscp_hybrid_episode")
    smem_fn = lib.itscp_hybrid_episode_fwd_smem
    smem_fn.argtypes = [ctypes.c_int] * 4
    smem_fn.restype = ctypes.c_size_t
    smem_bytes = smem_fn(plan.L, plan.C, plan.V, plan.K)
    report(T=T, L=L, window=plan.W, smem_bytes=smem_bytes, checks=checks,
           tolerance=dict(events="exact", reward_rel=1e-4, queues_abs=1e-4))

    # ---- 4. serve: the main path, through the user's entry points
    phase("serve")
    model = init_controller(torch.Generator().manual_seed(0),
                            env.observation_size(), env.action_size(),
                            device=dev)
    low, high = env.action_bounds()
    served = []
    kfn.launches = 0
    for seed in (3, 4, 5):
        obs = env.reset(seed)
        with torch.no_grad():
            raw = model(torch.as_tensor(obs, device=dev))
            action = squash_action(raw, low, high)
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        res = env.episode(action, differentiable=False, generator=g)
        torch.cuda.synchronize()
        ok = (bool(torch.isfinite(res.reward)) and
              tuple(res.queue_per_step.shape) == (T,) and
              tuple(res.events_per_step.shape) == (T, 3) and
              bool((action >= low).all() and (action <= high).all()))
        served.append(dict(seed=seed, reward=float(res.reward),
                           emitted=int(res.emitted),
                           absorbed=int(res.absorbed),
                           injected=int(res.injected), ok=ok))
        if not ok:
            report(served=served, status="FAIL")
            raise SystemExit(f"serve failed for seed {seed}")
    serve_launches = kfn.launches
    if serve_launches != 3:
        report(served=served, launches=serve_launches, status="FAIL")
        raise SystemExit(f"expected 3 kernel launches, saw {serve_launches}")
    report(served=served, launches=serve_launches)

    # ---- 5. timing at the preset's shapes
    phase("timing")
    env.reset(3)
    plan = env._fused[0].plan
    inputs = k1_inputs(torch.full((env.action_size(),), 0.5, device=dev))
    for _ in range(2):
        kfn(plan, *inputs)
    torch.cuda.synchronize()
    launches_before = kfn.launches
    ms = cuda_ms(lambda: kfn(plan, *inputs), 10)
    kfn.launches = launches_before  # timing launches are not the main path
    plain_ms = cuda_ms(lambda: k1.plain_episode(plan, *inputs), 3)
    in_bytes = sum(x.numel() * x.element_size() for x in
                   (*inputs, plan.prog, plan.lane_i, plan.lane_f))
    out_bytes = (1 + T + 8 * T) * 4
    n_macro = int(env.spec.is_macro.sum())
    ops = T * n_macro * ((plan.C + 1) * OPS_PER_INTERFACE +
                         plan.C * OPS_PER_CELL)
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    report(kernel_ms=ms, plain_ms=plain_ms, bytes=in_bytes + out_bytes,
           ops=ops, bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=bound_ms,
           bound_by=bound_by, speedup_vs_plain=plain_ms / ms,
           nvidia_smi=smi)

    # ---- 6. per-kernel record
    phase("kernels")
    kernels = [{"name": k1.KERNEL_NAME, "route": "cuda",
                "source": k1.SOURCE, "replaces": k1.REPLACES,
                "launches": serve_launches, "max_abs_err": max_abs_err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}]
    report(total_seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
