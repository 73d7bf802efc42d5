"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving and training paths on the 3x3 hybrid ITSCP
preset of ``run_itscp_hybrid.sh`` (144 lanes, T = 600 steps at 30 Hz),
through the hand-written CUDA kernels of the fused episode (K1: hard
forward, soft/straight-through forward, backward), and nothing of the JAX
package. Each phase prints one JSON line with its wall seconds:

1. ``device``  card name and power limit (``nvidia-smi``), PyTorch/CUDA
2. ``build``   every ``dhts_torch/ops/cuda/csrc/*.cu`` compiled with nvcc,
               all at once, one process each
3. ``k1_vs_plain``  the hard forward against its plain PyTorch version on
               the card, same inputs: events[T, 8] exactly equal, reward rel
               <= 1e-4, queues abs <= 1e-4, at least one emission
4. ``k1_soft_vs_plain``  the same for the soft and straight-through forward
               (action 0.55)
5. ``k1_bwd_vs_plain``  the backward's action gradient against autograd of
               the plain version, soft and straight-through: cosine > 0.999,
               allclose(rtol 2e-2, atol 2e-3 * max|g|), finite, nonzero
6. ``serve``   a seeded random controller answers 3 requests (seeds 3, 4, 5):
               reset -> observe -> controller -> squash -> hard episode; the
               hard kernel's launch count must rise by exactly 3
7. ``train``   the Trainer (seed 3, one episode per step, lr 1e-4) takes 3
               steps and 1 evaluation: losses finite, parameters changed,
               the soft forward and the backward launched 3 times each
8. ``timing``  each kernel's ms per launch (CUDA events, median of 10 after
               a warm-up), fwd+bwd episodes per second, and the plain hard
               version's ms (median of 3)
9. ``kernels`` the per-kernel record (launches, error, times, bound)

then the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero without that
line; a watchdog ends a run that hangs. Needs one CUDA device.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
WATCHDOG_SECONDS = 900
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, non-tensor-core float32
SMEM_PER_BLOCK = 232448  # bytes of shared memory one Hopper block can use
# float32 operations per Riemann interface and per cell update, counted
# from csrc/itscp_hybrid_episode.cu (riemann, comp_u and the flux update)
OPS_PER_INTERFACE = 60
OPS_PER_CELL = 14
# d(loss)/d(action) is one vector-Jacobian product, which reverse mode
# computes for a small constant multiple of the function's own operations,
# its forward sweep included (the cheap gradient principle: Griewank and
# Walther, Evaluating Derivatives, 2nd ed., SIAM 2008). The
# backward's bound takes 3x the forward's operations, whatever the kernel's
# own design (forward-mode tangents, one episode per action entry) does.
VJP_OPS_MULTIPLE = 3
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
                 ).splitlines() if "registers" in ln or "spill" in ln][-4:]
             for n, p in paths.items()
             if (_build.BUILD_DIR / f"{p.stem}.ptxas.txt").exists()}
    report(libraries={n: str(p.relative_to(HERE)) for n, p in paths.items()},
           nvcc_seconds={n: _build.build_seconds.get(n) for n in names},
           ptxas=ptxas)

    from dhts_torch.apps.control.controller import (init_controller,
                                                     squash_action)
    from dhts_torch.apps.control.itscp import problem
    from dhts_torch.apps.control.itscp.env import ItscpEnv
    from dhts_torch.apps.control.trainer import Trainer
    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

    kfn = k1.itscp_hybrid_episode_fwd  # counts launches per gate mode
    kfn_bwd = k1.itscp_hybrid_episode_bwd
    dev = torch.device("cuda")

    def reset_counts():
        kfn.launches.update(dict.fromkeys(kfn.launches, 0))
        kfn_bwd.launches = 0

    # ---- 3. K1 against its plain version, same inputs, on the card
    phase("k1_vs_plain")
    env = ItscpEnv(config=dict(PRESET, random_seed=3),
                   schedule_fn=problem.problem_1, device=dev)
    env.reset()
    T, L = env.num_timestep, env.spec.num_lanes
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rand = env.draw_rand(gen)
    plan = env.fused_plan(False)

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
    lib = k1._library()
    modes = (("forward", 0), ("backward", 1))
    smem_bytes = {kind: lib.itscp_hybrid_episode_smem(
        plan.L, plan.C, plan.V, plan.K, tangent) for kind, tangent in modes}
    # the most lanes one block's shared memory holds at these C, V, K
    max_lanes = {kind: max(n for n in range(1, 1025) if
                           lib.itscp_hybrid_episode_smem(
                               n, plan.C, plan.V, plan.K, tangent) <=
                           SMEM_PER_BLOCK) for kind, tangent in modes}
    report(T=T, L=L, window=plan.W, smem_bytes=smem_bytes,
           max_lanes=max_lanes, checks=checks,
           tolerance=dict(events="exact", reward_rel=1e-4, queues_abs=1e-4))

    # ---- 4. the soft and straight-through forward against the plain version
    phase("k1_soft_vs_plain")
    soft_env, soft_err, soft_checks, plain_soft_s = {}, 0.0, [], {}
    for mode in ("soft", "st"):
        e = ItscpEnv(config=dict(PRESET, random_seed=3, gate_mode=mode),
                     schedule_fn=problem.problem_1, device=dev)
        e.reset()
        soft_env[mode] = e
        p = e.fused_plan(True)
        inputs = k1_inputs(torch.full((e.action_size(),), 0.55, device=dev))
        kr, kq, ke = kfn(p, *inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            pr, pq, pe = k1.plain_episode(p, *inputs)
        torch.cuda.synchronize()
        plain_soft_s[mode] = time.perf_counter() - t0
        rel = abs(float(kr) - float(pr)) / max(abs(float(pr)), 1e-30)
        q_err = float((kq - pq).abs().max())
        soft_err = max(soft_err, q_err, abs(float(kr) - float(pr)))
        tot = pe[:, :3].sum(0).tolist()
        rec = dict(gate_mode=mode, mode=p.mode,
                   events_equal=bool(torch.equal(ke, pe)),
                   events_mismatch_steps=int((ke != pe).any(1).sum()),
                   reward_kernel=float(kr), reward_plain=float(pr),
                   reward_rel_err=rel, queues_max_abs_err=q_err,
                   injected=tot[0], emitted=tot[1], absorbed=tot[2],
                   plain_seconds=plain_soft_s[mode],
                   finite=bool(torch.isfinite(kq).all()))
        soft_checks.append(rec)
        if not (rec["events_equal"] and rel <= 1e-4 and q_err <= 1e-4 and
                tot[1] >= 1 and rec["finite"]):
            report(checks=soft_checks, status="FAIL")
            raise SystemExit(f"k1_soft_vs_plain failed for {mode}: {rec}")
    report(checks=soft_checks,
           tolerance=dict(events="exact", reward_rel=1e-4, queues_abs=1e-4))

    # ---- 5. the backward against autograd of the plain version
    phase("k1_bwd_vs_plain")
    bwd_err, bwd_checks, plain_bwd_s = 0.0, [], {}
    rng = np.random.default_rng(1)
    action_off_grid = torch.as_tensor(
        rng.uniform(0.3, 0.7, env.action_size()), dtype=torch.float32,
        device=dev)
    w = torch.full((T,), -1.0, device=dev)  # d(reward)/d(queues)
    for mode in ("soft", "st"):
        p = soft_env[mode].fused_plan(True)
        inputs = k1_inputs(action_off_grid)
        g = kfn_bwd(p, w, *inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g_ref = k1.plain_episode_bwd(p, w, *inputs)
        torch.cuda.synchronize()
        plain_bwd_s[mode] = time.perf_counter() - t0
        got, ref = g.double().flatten(), g_ref.double().flatten()
        cos = float(got @ ref / (got.norm() * ref.norm()))
        abs_err = float((got - ref).abs().max())
        bwd_err = max(bwd_err, abs_err)
        rec = dict(gate_mode=mode, cos=cos, max_abs_err=abs_err,
                   max_abs_ref=float(ref.abs().max()),
                   max_rel_err=abs_err / max(float(ref.abs().max()), 1e-30),
                   norm=float(got.norm()), plain_seconds=plain_bwd_s[mode],
                   finite=bool(torch.isfinite(got).all()))
        bwd_checks.append(rec)
        close = bool(torch.allclose(got, ref, rtol=2e-2,
                                    atol=2e-3 * float(ref.abs().max())))
        if not (cos > 0.999 and close and rec["finite"] and rec["norm"] > 0):
            report(checks=bwd_checks, status="FAIL")
            raise SystemExit(f"k1_bwd_vs_plain failed for {mode}: {rec}")
    report(checks=bwd_checks, tolerance=dict(cos=0.999, rtol=2e-2,
                                             atol="2e-3 * max|g_plain|"))

    # ---- 4. serve: the main path, through the user's entry points
    phase("serve")
    model = init_controller(torch.Generator().manual_seed(0),
                            env.observation_size(), env.action_size(),
                            device=dev)
    low, high = env.action_bounds()
    served = []
    reset_counts()
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
    serve_launches = kfn.launches[k1.HARD]
    if serve_launches != 3:
        report(served=served, launches=serve_launches, status="FAIL")
        raise SystemExit(f"expected 3 kernel launches, saw {serve_launches}")
    report(served=served, launches=serve_launches)

    # ---- 7. train: the Trainer through the soft forward and the backward
    phase("train")
    tenv = ItscpEnv(config=dict(PRESET, random_seed=3),
                    schedule_fn=problem.problem_1, device=dev)
    tenv.reset()
    trainer = Trainer(tenv, lr=1e-4, seed=3)
    before = [x.detach().clone() for x in trainer.model.parameters()]
    reset_counts()
    losses = [trainer.train_step(1) for _ in range(3)]
    # the evaluation's logs and checkpoint go beside the built kernels
    eval_reward = trainer.evaluate(
        3, 1, str(_build.BUILD_DIR / "smoke_train"), False)
    torch.cuda.synchronize()
    train_launches = dict(
        fwd_soft=kfn.launches[k1.SOFT] + kfn.launches[k1.ST],
        bwd=kfn_bwd.launches, fwd_hard=kfn.launches[k1.HARD])
    changed = any(not torch.equal(a, b.detach()) for a, b in
                  zip(before, trainer.model.parameters()))
    ok = (all(math.isfinite(x) for x in losses) and changed and
          math.isfinite(eval_reward) and train_launches["fwd_soft"] == 3 and
          train_launches["bwd"] == 3 and train_launches["fwd_hard"] == 1)
    report(losses=losses, eval_reward=eval_reward, params_changed=changed,
           launches=train_launches)
    if not ok:
        raise SystemExit("train failed")

    # ---- 5. timing at the preset's shapes
    phase("timing")
    env.reset(3)
    plan = env.fused_plan(False)
    splan = soft_env["soft"].fused_plan(True)
    inputs = k1_inputs(torch.full((env.action_size(),), 0.5, device=dev))
    counts = (dict(kfn.launches), kfn_bwd.launches)
    runs = {"fwd": lambda: kfn(plan, *inputs),
            "fwd_soft": lambda: kfn(splan, *inputs),
            "bwd": lambda: kfn_bwd(splan, w, *inputs)}
    for fn in runs.values():
        for _ in range(2):
            fn()
    torch.cuda.synchronize()
    times = {name: cuda_ms(fn, 10) for name, fn in runs.items()}
    # timing launches are not the main path
    kfn.launches.update(counts[0])
    kfn_bwd.launches = counts[1]
    plain_ms = cuda_ms(lambda: k1.plain_episode(plan, *inputs), 3)
    in_bytes = sum(x.numel() * x.element_size() for x in
                   (*inputs, plan.prog, plan.lane_i, plan.lane_f))
    out_bytes = (1 + T + 8 * T) * 4
    n_macro = int(env.spec.is_macro.sum())
    ops = T * n_macro * ((plan.C + 1) * OPS_PER_INTERFACE +
                         plan.C * OPS_PER_CELL)
    n_act = plan.n_phases * plan.n_inter
    # the backward reads the forward's inputs and the loss weights, writes
    # the gradient, and does one vector-Jacobian product's operations
    work = {"fwd": (in_bytes + out_bytes, ops),
            "fwd_soft": (in_bytes + out_bytes, ops),
            "bwd": (in_bytes + 4 * T + 4 * n_act, ops * VJP_OPS_MULTIPLE)}
    bounds = {}
    for name, (nbytes, nops) in work.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / FP32_OPS_PER_S * 1e3
        bounds[name] = dict(bytes=nbytes, ops=nops, bytes_ms=bytes_ms,
                            ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
                            bound_by="bytes" if bytes_ms >= ops_ms
                            else "operations")
    report(kernel_ms=times, plain_ms=plain_ms, bounds=bounds,
           ms_over_bound={n: times[n] / bounds[n]["bound_ms"] for n in times},
           fwd_bwd_episodes_per_s=1e3 / (times["fwd_soft"] + times["bwd"]),
           speedup_vs_plain=plain_ms / times["fwd"], nvidia_smi=smi)

    # ---- 6. per-kernel record
    phase("kernels")
    plain = {"fwd": plain_ms,
             "fwd_soft": plain_soft_s["soft"] * 1e3,
             "bwd": plain_bwd_s["soft"] * 1e3}
    launches = {"fwd": serve_launches, "fwd_soft": train_launches["fwd_soft"],
                "bwd": train_launches["bwd"]}
    errors = {"fwd": max_abs_err, "fwd_soft": soft_err, "bwd": bwd_err}
    replaces = {"fwd": k1.REPLACES_FWD, "fwd_soft": k1.REPLACES_FWD,
                "bwd": k1.REPLACES_BWD}
    kernels = [{"name": f"itscp_hybrid_episode_{name}", "route": "cuda",
                "source": k1.SOURCE, "replaces": replaces[name],
                "launches": launches[name], "max_abs_err": errors[name],
                "ms": times[name], "plain_ms": plain[name],
                "bound_ms": bounds[name]["bound_ms"],
                "bound_by": bounds[name]["bound_by"], "library_ms": None}
               for name in ("fwd", "fwd_soft", "bwd")]
    report(total_seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
