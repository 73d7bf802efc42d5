"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving and training paths on the 3x3 hybrid ITSCP
preset of ``run_itscp_hybrid.sh`` (144 lanes, T = 600 steps at 30 Hz),
through the hand-written CUDA kernels of the fused episode (K1: hard
forward, soft/straight-through forward, backward), and the inverse
initial-state benchmarks at their CLI defaults through the fused rollouts
(K2: ARZ macro lane, K3: IDM platoon, forward and backward), and nothing of
the JAX package, and the 3x3 preset's training on the fused spatial step
of a one-device mesh (``run --mesh 1,1 --mesh_fused``: K6's STEP body as a
forward and a forward-mode derivative kernel, one launch per simulation
step), and the all-macro ITSCP episode of ``run_itscp_macro.sh`` through
K4's forward and backward kernels (the action, r0 and y0 gradients), which
a controller trains through, and the 3x3 preset's training on the
lane-sharded fused spatial step (``run --mesh 1,4 --mesh_fused``: K6's
per-shard bodies A (step 0 only), B, C, D3 (JAX's D1, D2 and D3 in one
launch, and the next step's A rows) and E,
four gloo ranks that share the card, spawned once after the build with a
``FileStore`` in a temporary directory and kept for the slice's phases,
with two more for the S = 2 check; a rank that fails or outlives its
time fails the run), and K1's scenario batch: B episodes in one launch, the
packed Trainer (``run --packed``). Each
phase prints one JSON line with its wall seconds:

1. ``device``  card name and power limit (``nvidia-smi``), PyTorch/CUDA
2. ``build``   every ``dhts_torch/ops/cuda/csrc/*.cu`` compiled with nvcc,
               all at once, one process each
   ``plain_submit``  the inputs of phases 3-5, of ``k1_batch_vs_plain``
               and of ``k4_vs_plain``; their plain episodes (18 K1 jobs and
               16 K4 jobs, one episode's forward or backward each, K4's
               with its gradients) go to the gloo ranks of both groups
               (six processes), which run them on the card while this
               process goes on; phases 3-5 run after ``inverse_hybrid``
               and wait for them
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
8. ``k2_vs_plain``  K2 at the macro defaults (C = 10, T = 500, dt 0.01,
               dx 5, u_max 30), B = 12 seeded scenarios: forward
               allclose(rtol 1e-6, atol 1e-6); backward against autograd of
               the plain version, cosine > 0.9999, allclose(rtol 5e-3, atol
               5e-4 * max|g|), finite, nonzero (the right ghost density's
               gradient is 0 on both sides); the segmented rollout (chunk
               128) bit-equal to one call; all of it again at C = 40 (a
               lane above one warp of cells)
9. ``k3_vs_plain``  K3 at the micro defaults (V = 10, T = 500), B = 12, half
               the platoons dense: the same, atol 1e-5 * max|g|; prints the
               acceleration-floor hits, which must be > 0; the backward
               replaying its trajectory, over the trajectory the forward
               saved, and through ``MicroRolloutFunction``'s autograd (the
               forward saves, the backward sweeps it); all of it again at
               V = 40 (above one warp: PR 6's kernels)
10. ``inverse``  MacroInverseProblem and MicroInverseProblem at the CLI
               defaults with the fused rollout, 1 trial, 100 episodes, all
               four methods: errors finite, GD's last end error below its
               first, and K2's and K3's launches, counted from 0 in this
               phase, equal to what the solvers imply (the target roll, one
               forward and one backward per GD episode, one forward per
               CMA-ES generation and per scipy evaluation)
11. ``inverse_hybrid``  HybridInverseProblem (n_cell 10, T = 500), GD, 2
               episodes, on the card: vehicles emitted and absorbed, errors
               finite, the estimate moved
12. ``spatial_vs_plain``  the STEP forward at the preset, hard and soft, B =
               1 and 4 episodes per launch: at every 50th step the kernel's
               carry goes through one plain step on the card (integers
               equal, floats allclose(rtol 1e-6, atol 1e-6)); each whole
               episode against K1 on the same draws (reward rel 1e-5, queues
               abs 1e-4, per-step injected/emitted/absorbed equal, emitted
               > 0)
13. ``spatial_bwd_vs_plain``  the STEP derivative against autograd of the
               plain episode over the first 60 steps only (cut to keep the
               phase short; cosine > 0.9999, allclose(rtol 2e-2, atol 2e-3 *
               max|g|)) and against K1's backward at T = 600 (cosine >
               0.99999), finite
14. ``spatial_train``  ``python -m dhts_torch.apps.control.itscp.run
               --mesh 1,1 --mesh_fused`` at the ``run_itscp_hybrid.sh``
               flags, problem 1, 2 epochs with an evaluation each, the CLI's
               own one episode per epoch: losses finite, and the STEP
               kernels' steps, counted from 0 in this phase, equal to T
               per train step plus T per evaluation (forward) and T per
               train step (derivative), in one kernel launch per episode
15. ``spatial_timing``  STEP forward (hard and soft) and derivative ms per
               step at B = 1 and 4 (CUDA events around one launcher call
               of 50 steps from the state after 100, restored before each;
               median of 5) and per episode (one call of T steps), with
               their bounds, and the plain step's ms at B = 1
16. ``k4_vs_plain``  K4 (the all-macro episode) at the macro preset of
               ``run_itscp_macro.sh`` (L = 40, C = 7, T = 300) and the 3x3
               preset in macro mode (L = 144, C = 4, T = 600), actions 0.3
               and 0.7, from the empty state and a seeded one: forward
               against the plain version on the card (reward rel <= 1e-5,
               queues abs <= 1e-4), the reverse sweep's action, r0 and y0
               gradients against its autograd (cosine > 0.999,
               allclose(rtol 2e-2, atol 2e-3 * max|g|), finite, nonzero,
               padded cells exactly 0) and against the forward-mode
               derivative (cosine > 0.9999, the same allclose), over the
               saved trajectory bit-equal to replaying it, one case with a
               loss on queues[t]; the plain episodes ran in the gloo ranks
               (``plain_submit``)
17. ``k4_vs_scan``  K4 against the port's eager soft scan episode at the
               macro preset: reward rel 2e-4, queues rtol 2e-3 atol 1e-5,
               action gradient rtol 1e-2 atol 1e-5
18. ``k4_vs_k1``  K4 against K1's soft forward at the 3x3 macro scene: the
               same reward and queue tolerances
19. ``k4_train``  the caller: a seeded controller (256, 256) takes 3 Adam
               steps at lr 1e-4 through K4 at the macro preset; losses
               finite, parameters changed, K4's forward (saving the
               trajectory) and its reverse sweep launched 3 times each (a
               grid of one block), the forward-mode blocks never
20. ``k4_timing``  K4 forward, the forward saving the trajectory, the
               reverse sweep over it (the action alone and all three
               gradients) and replaying it, and the forward-mode derivative
               with the action alone and with all three gradients, ms per
               launch at both scenes (median of 5 runs of 20 launches back
               to back) with their bounds, and the plain version's ms
               (median of the k4_vs_plain runs, each timed in a gloo rank
               beside the others)
21. ``shard_vs_plain``  the sharded forward at the preset, hard and soft,
               B = 1, on S = 4 ranks: at every 50th step each rank holds the
               inputs of its launches through their plain versions on
               the card (D3's: ``plain_body_D``, the whole conversion, and
               ``plain_body_A`` on its carry with the next step's draws:
               the next step's A rows; integers equal, floats
               allclose(rtol 1e-6, atol 1e-6));
               the Q kernel's queues bit-equal to ``plain_queues`` of the
               same gathered rows; each episode at S = 4 and S = 2 against
               the single-shard STEP kernel's on the same draws (run once,
               in this process): events, queues, waves bit-equal, emitted >
               0; the ranks' draws and scene agree; the host-staged gloo
               time per collective call
22. ``shard_bwd_vs_plain``  the sharded derivative (S = 4 in the ranks, S = 2
               and 4 in this process, T = 600) against the STEP derivative
               (bit-equal, cosine > 0.99999, allclose(rtol 2e-2, atol 2e-3
               * max|g|), finite; its Q kernel bit-equal to
               ``plain_gradient`` of the same gathered tangent rows; in
               this process at S = 2 and at the main path's S = 4 the
               ``Dual`` D3 launches of steps 107, 307 and 507 against
               ``plain_body_D`` and the next step's ``plain_body_A`` under
               forward-mode AD on the card, values
               allclose(rtol 1e-6, atol 1e-6), tangents allclose(rtol
               1e-5, atol 1e-5 * the largest)) and
               over the first 60 steps against the plain forward-mode
               derivative (one shard); both references run once, in this
               process, while the ranks work
23. ``shard_train``  ``python -m dhts_torch.apps.control.itscp.run --mesh
               1,4 --mesh_fused`` in 4 ranks at the ``run_itscp_hybrid.sh``
               flags, problem 1, 2 epochs with an evaluation each: losses
               finite and equal on every rank, parameters equal on every
               rank afterwards, each body's launches, counted from 0 on each
               rank, T per forward episode (train step and evaluation) and
               T per train step for the derivative, A and Q once per
               episode, no D1 or D2 launch; the collectives as derived (per
               step 1 gather and 2 sums in soft mode, 1 sum in hard mode,
               the next step's A rows riding in the static terms' sum; per
               episode A's gather at step 0, the queues' gather and the
               events' and waves' reductions)
24. ``shard_timing``  each body's ms per launch at S = 4, B = 1 and 4 (D3's
               the whole conversion), and
               of the derivative's bodies (CUDA events, median of 5 runs of
               50 launches back to back of one shard's kernel at a quiet
               step, its gathered rows in place: no collective inside), the
               plain bodies' ms, the bytes bounds; Q's ms per launch on the
               gathered q^2 rows with its plain ms and the library's (one
               PyTorch call, 50 back to back, as Q's launches); the wall ms
               of an
               unchecked sharded step (from ``shard_vs_plain``: four
               launches and the collectives between them, host-staged gloo,
               not a collective number of the card)
25. ``timing``  each K1 kernel's ms per launch (CUDA events, median of 10
               after a warm-up), fwd+bwd episodes per second, the plain hard
               version's ms (the mean of its two runs in ``k1_vs_plain``);
               K2 and K3 forward and backward ms at B = 1, 12, 128 (median
               of 5 runs of 20 launches back to back) with their bounds,
               and their plain versions' ms at B = 1
26. ``kernels`` the per-kernel record (launches, error, times, bound); K6's
               D3 rows name D1's, D2's and A's ``pallas_call`` sites in
               ``replaces`` too: D3's launch does their work (A's for the
               next step; A's own launch is step 0's, once an episode)

Slice 8 (K1 with B episodes per launch; a scene wider than one block on the
sharded step) adds, where they run:

* in ``train``: one ``train_step(4)``, four draws of the controller's
  action in one soft forward and one backward launch;
* after ``train``, ``k1_batch_vs_single``: the preset's
  ``reset_batch(4, seed=3)``, four seeded actions; one launch of the four
  episodes, hard and soft forward and the backward (per-episode loss
  weights), bit-equal to four single launches (reward, queues, all eight
  event rows, gradients), emitted > 0; the same for four draws of one
  scene with the scene data and action shared (stride 0; the preset's
  open boundaries are macro lanes, so its episodes read no draw);
* after ``k1_bwd_vs_plain``, ``k1_batch_vs_plain``: one launch of the four
  scenarios, hard and soft forward and the backward (loss weights -1),
  against the plain version's four episodes with the tolerances of phases
  3-5; the ``kernels`` line's batched rows take their error and the plain
  ms (the four episodes' sum) from here;
* ``packed_train``: ``Trainer(multi_scenario=True, packed=True)`` on those
  four scenarios takes 3 steps and 1 evaluation: exactly one soft forward
  and one backward launch per step and one hard launch for the
  evaluation, counted from 0 in this phase; the first loss equal to minus
  the mean of four single soft launches' rewards; losses finite,
  parameters changed;
* after ``shard_train``, ``shard9_vs_plain``: the 9x9 hybrid scene (the
  preset's lanes and signals, 1,296 lanes, policy_length 2: T = 60) on the
  S = 4 ranks (324 lanes a shard), hard and soft: at every 20th step each
  launch against its plain body on the card (integers equal, floats
  allclose(rtol 1e-6, atol 1e-6)), each episode bit-equal to the plain
  single-shard episode, run here while the ranks work;
* before ``timing``, ``k1_batch_timing``: K1's hard, soft and backward ms
  per launch at B = 1, 2, 4, 8, 32 episodes of the four scenarios in turn
  (CUDA events, median of 5 after a warm-up), fwd+bwd episodes per second
  and each launch's bound; the ``kernels`` line gains K1's rows at B = 4
  (``packed_train``'s launches).

Slice 17 (K1 on grids wider than one block: ``run_itscp_5x5.sh``'s flags
on the 5x5, 7x7 and 9x9 grids, 400, 784 and 1,296 lanes) adds:

* in ``plain_submit``: the grids at policy_length 5 (T = 150: every
  grid emits vehicles; at T = 60 none has an event yet) and at the
  script's T = 600, and 22 plain episodes for the gloo ranks;
* after ``k1_batch_vs_plain``, ``k1_wide_vs_plain``: on each grid K1's
  forward (hard and soft; ``st`` at 5x5 and 9x9) against the plain
  version (events equal, reward rel 1e-5, queues abs 1e-4, vehicles
  emitted) and its backward (soft; ``st`` at 5x5 and 9x9) against
  autograd of the plain version (cosine > 0.999, allclose(rtol 2e-2,
  atol 2e-3 * max|g|), finite, nonzero), at T = 150, and at T = 600 on
  the timing's inputs the launches the main path makes there (on every
  grid the hard and soft forward and the backward), with the same
  standards; in the layout ``make_plan`` picks (5x5: forward in shared
  memory, backward global; 7x7 global; 9x9 global, two lanes a thread);
  at 5x5 one launch of four episodes, hard, soft and the backward,
  bit-equal to four single launches;
* ``train_5x5``: ``python -m dhts_torch.apps.control.itscp.run`` with the
  script's flags (T = 600), two Adam steps (``--n_episode 1``) with an
  evaluation each: K1's launches, counted from 0 here, one soft forward
  and one backward a step and one hard forward an evaluation, and no call
  of the plain version;
* ``serve_train_wide``: at 7x7 and 9x9 (T = 600) a seeded controller's
  hard episode and one Trainer step, one launch each, counted from 0;
* ``k1_wide_timing``: K1's hard, soft and backward ms per launch on each
  grid at T = 600 (CUDA events around 3 launches back to back, median of
  5), the bounds and the layouts; the ``kernels`` line gains a row for
  each grid and launch, its launches from ``train_5x5`` and
  ``serve_train_wide``, its error and plain ms from ``k1_wide_vs_plain``
  at T = 600 on the same inputs.

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
import tempfile
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
# float32 operations of one IDM + Euler update of a vehicle, counted from
# csrc/dhts_scalar.cuh (idm_step) and csrc/micro_rollout.cu (gap, speed
# difference): K3's per vehicle-step work
OPS_PER_VEHICLE = 30
# the inverse benchmarks at their CLI defaults (dhts_torch/apps/inverse)
MACRO = dict(u_max=30.0, dt=0.01, dx=5.0, T=500, C=10)
K2_WIDE_C = 40  # a lane above one warp of cells (K2's shared-memory kernel)
MICRO = dict(u_max=30.0, dt=0.01, T=500, V=10)
K3_WIDE_V = 40  # a platoon above one warp (K3's shared-memory kernels)
INVERSE_EPISODES = 100
ROLLOUT_BATCHES = (1, 12, 128)
PRESET = dict(num_intersection=3, num_lane=1, lane_length=5, speed_limit=60,
              policy_length=20, signal_length=4, simulation_frequency=30,
              mode="hybrid", use_fused_episode=True)
# K4's all-macro scenes: the macro preset of run_itscp_macro.sh (L = 40,
# C = 7, T = 300, 5 actions) and the 3x3 preset in macro mode (L = 144, C =
# 4, T = 600, 45 actions); problem 1, seed 3
K4_SCENES = {
    "macro_preset": dict(num_intersection=1, num_lane=3, lane_length=30,
                         speed_limit=60, policy_length=10, signal_length=2,
                         mode="macro", random_seed=3),
    "grid3_macro": dict(PRESET, mode="macro", random_seed=3)}

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


def cuda_ms(fn, repeats: int, launches: int = 1):
    """Median milliseconds of ``fn()`` over ``repeats`` runs, each timed by
    CUDA events on the current stream around ``launches`` calls back to
    back and divided by their number. Back to back, the host enqueues the
    next call while the card runs the last, so a short kernel's time is
    not its wrapper's host time."""
    import torch

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
    times.sort()
    return times[len(times) // 2]


def bound_of(nbytes: float, nops: float) -> dict:
    """The least time of a kernel: the larger of its bytes over the card's
    memory rate and its float32 operations over the card's peak rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / FP32_OPS_PER_S * 1e3
    return dict(bytes=nbytes, ops=nops, bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def macro_inputs(B: int, seed: int, dev, C: int = MACRO["C"]):
    """Seeded scenarios of the macro benchmark: densities and speeds drawn
    as the inverse problem draws its truth, ``y0`` from them."""
    import torch

    from dhts_torch.ops import arz

    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    u_max = MACRO["u_max"]
    r0 = t(rng.uniform(0, 1, (B, C)))
    y0 = arz.compute_y(r0, t(rng.uniform(0, u_max, (B, C))),
                       u_max).contiguous()
    ghosts = [t(rng.uniform(0, hi, B)) for hi in (1.0, u_max, 1.0, u_max)]
    return (r0, y0, *ghosts)


def micro_inputs(B: int, seed: int, dev, V: int = MICRO["V"]):
    """Seeded platoons of the micro benchmark (about four lengths apart,
    0.3-0.7 of the speed limit); from scenario B // 2 on, dense and slow
    platoons (gaps of -1 to 0.6 m, speeds under 3 m/s), where the
    acceleration floor stops vehicles and some collide."""
    import torch

    rng = np.random.default_rng(seed)
    u_max = MICRO["u_max"]
    gap = 20.0 + rng.uniform(0, 10.0, (B, V))
    vel = (0.3 + 0.4 * rng.uniform(0, 1, (B, V))) * u_max
    dense = slice(B // 2, B)
    gap[dense] = rng.uniform(4.0, 5.6, gap[dense].shape)
    vel[dense] = rng.uniform(0.0, 3.0, vel[dense].shape)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    return t(np.cumsum(gap, axis=1)), t(vel)


def check_k2(dev) -> dict:
    """K2 forward, backward and the segmented rollout against the plain
    version at the macro defaults, B = 12, and at C = 40 cells (above one
    warp: the shared-memory kernel); raises on a failed check."""
    import torch

    from dhts_torch.ops.cuda import macro_rollout as k2

    B = 12
    consts = k2.MacroConsts(MACRO["u_max"], MACRO["dt"], MACRO["dx"],
                            MACRO["T"])
    cases, fwd_err, bwd_err, ok = [], 0.0, 0.0, True
    for C in (MACRO["C"], K2_WIDE_C):
        inputs = macro_inputs(B, 12, dev, C)
        out = k2.macro_rollout_fwd(consts, *inputs)
        ref = k2.plain_macro_rollout(consts, *inputs)
        torch.cuda.synchronize()
        f_err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
        f_ok = all(bool(torch.isfinite(a).all()) and
                   bool(torch.allclose(a, b, rtol=1e-6, atol=1e-6))
                   for a, b in zip(out, ref))
        rng = np.random.default_rng(13)
        cot = [torch.as_tensor(rng.normal(size=(B, C)), dtype=torch.float32,
                               device=dev) for _ in range(2)]
        got = k2.macro_rollout_bwd(consts, *inputs, *cot)
        want = k2.plain_macro_rollout_bwd(consts, *inputs, *cot)
        torch.cuda.synchronize()
        grads, b_err, b_ok = {}, 0.0, True
        for name, a, b in zip(("r0", "y0", "bl_r", "bl_u", "br_r", "br_u"),
                              got, want):
            err = float((a - b).abs().max())
            b_err = max(b_err, err)
            scale = float(b.abs().max())
            rec = dict(max_abs_err=err, max_abs_ref=scale,
                       finite=bool(torch.isfinite(a).all()))
            if name == "br_r":
                # the right ghost density enters only the right-vacuum test
                # of the Riemann solver: its gradient is 0 on both sides
                g_ok = rec["finite"] and scale == 0.0 and err == 0.0
            else:
                rec["cos"] = cosine(a, b)
                g_ok = (rec["finite"] and scale > 0 and
                        rec["cos"] > 0.9999 and
                        bool(torch.allclose(a, b, rtol=5e-3,
                                            atol=5e-4 * scale)))
            grads[name] = dict(rec, ok=g_ok)
            b_ok = b_ok and g_ok
        args = (MACRO["u_max"], MACRO["dt"], MACRO["dx"], MACRO["T"], C, B)
        one = k2.make_fused_macro_rollout(*args, device=dev)(*inputs)
        seg = k2.make_segmented_macro_rollout(*args, chunk=128,
                                              device=dev)(*inputs)
        seg_equal = all(bool(torch.equal(a, b)) for a, b in zip(one, seg))
        cases.append(dict(C=C, B=B, forward_max_abs_err=f_err,
                          forward_bit_equal=all(bool(torch.equal(a, b))
                                                for a, b in zip(out, ref)),
                          forward_ok=f_ok, max_wave=float(out[2].max()),
                          grads=grads, segmented_bit_equal=seg_equal))
        fwd_err, bwd_err = max(fwd_err, f_err), max(bwd_err, b_err)
        ok = ok and f_ok and b_ok and seg_equal
    rec = dict(cases=cases,
               tolerance=dict(forward="allclose(rtol 1e-6, atol 1e-6)",
                              backward="cos > 0.9999, allclose(rtol 5e-3, "
                                       "atol 5e-4 * max|g_plain|)"))
    if not ok:
        report(**rec, status="FAIL")
        raise SystemExit("k2_vs_plain failed")
    report(**rec)
    return dict(max_abs_err=max(fwd_err, bwd_err), fwd_err=fwd_err,
                bwd_err=bwd_err)


def check_k3(dev) -> dict:
    """K3 forward and backward against the plain version at the micro
    defaults, B = 12, half of the platoons dense, and at V = 40 vehicles
    (above one warp: the shared-memory kernels); the backward without a
    trajectory, over the saved one, and through MicroRolloutFunction's
    autograd; raises on a failed check."""
    import torch

    from dhts_torch.models.vehicle import default_params
    from dhts_torch.ops.cuda import micro_rollout as k3

    B = 12
    cases, fwd_err, bwd_err, ok = [], 0.0, 0.0, True
    for V in (MICRO["V"], K3_WIDE_V):
        params = default_params(MICRO["u_max"], (V,))
        consts = k3.micro_consts(params, 1000.0, 0.0, MICRO["dt"],
                                 MICRO["T"], dev)
        inputs = micro_inputs(B, 14, dev, V)
        out = k3.micro_rollout_fwd(consts, *inputs, trajectory=True)
        ref = k3.plain_micro_rollout(consts, *inputs)
        hits = k3.floor_hits(consts, *inputs)
        torch.cuda.synchronize()
        f_err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
        f_ok = all(bool(torch.isfinite(a).all()) and
                   bool(torch.allclose(a, b, rtol=1e-6, atol=1e-6))
                   for a, b in zip(out, ref))
        traj = out[2]
        traj_equal = None if traj is None else bool(torch.equal(
            traj, k3.plain_micro_trajectory(consts, *inputs)))
        f_ok = f_ok and traj_equal is not False
        rng = np.random.default_rng(15)
        cot = [torch.as_tensor(rng.normal(size=(B, V)), dtype=torch.float32,
                               device=dev) for _ in range(2)]
        want = k3.plain_micro_rollout_bwd(consts, *inputs, *cot)
        fn = k3.make_fused_micro_rollout(MICRO["dt"], MICRO["T"], V, B,
                                         params, 1000.0, 0.0, device=dev)
        x = [t.clone().requires_grad_(True) for t in inputs]
        torch.autograd.backward(fn(*x), cot)
        routes = {"own_trajectory": k3.micro_rollout_bwd(consts, *inputs,
                                                         *cot),
                  "autograd": [t.grad for t in x]}
        if traj is not None:
            routes["saved_trajectory"] = k3.micro_rollout_bwd(
                consts, *inputs, *cot, traj=traj)
        torch.cuda.synchronize()
        grads, b_err, b_ok = {}, 0.0, True
        for route, got in routes.items():
            for name, a, b in zip(("pos0", "vel0"), got, want):
                err = float((a - b).abs().max())
                b_err = max(b_err, err)
                scale = float(b.abs().max())
                rec = dict(max_abs_err=err, max_abs_ref=scale,
                           cos=cosine(a, b),
                           finite=bool(torch.isfinite(a).all()))
                g_ok = (rec["finite"] and scale > 0 and rec["cos"] > 0.9999
                        and bool(torch.allclose(a, b, rtol=5e-3,
                                                atol=1e-5 * scale)))
                grads[f"{route}.{name}"] = dict(rec, ok=g_ok)
                b_ok = b_ok and g_ok
        cases.append(dict(V=V, B=B, forward_max_abs_err=f_err,
                          forward_bit_equal=all(bool(torch.equal(a, b))
                                                for a, b in zip(out, ref)),
                          trajectory_bit_equal=traj_equal, forward_ok=f_ok,
                          floor_hits=hits.tolist(), grads=grads))
        fwd_err, bwd_err = max(fwd_err, f_err), max(bwd_err, b_err)
        ok = ok and f_ok and b_ok and int(hits.sum()) > 0
    rec = dict(cases=cases,
               tolerance=dict(forward="allclose(rtol 1e-6, atol 1e-6)",
                              backward="cos > 0.9999, allclose(rtol 5e-3, "
                                       "atol 1e-5 * max|g_plain|)"))
    if not ok:
        report(**rec, status="FAIL")
        raise SystemExit("k3_vs_plain failed")
    report(**rec)
    return dict(max_abs_err=max(fwd_err, bwd_err), fwd_err=fwd_err,
                bwd_err=bwd_err)


def run_inverse(dev, log_root: str) -> dict:
    """The macro and micro inverse benchmarks at the CLI defaults through
    the fused rollouts: one trial, 100 episodes, all four methods. Returns
    the kernels' launches in this run; raises if a check fails."""
    from dhts_torch.apps.inverse.macro import MacroInverseProblem
    from dhts_torch.apps.inverse.micro import MicroInverseProblem
    from dhts_torch.ops.cuda import macro_rollout as k2
    from dhts_torch.ops.cuda import micro_rollout as k3

    counters = {"k2_fwd": k2.macro_rollout_fwd, "k2_bwd": k2.macro_rollout_bwd,
                "k3_fwd": k3.micro_rollout_fwd, "k3_bwd": k3.micro_rollout_bwd}
    E = INVERSE_EPISODES
    common = dict(num_trial=1, num_timestep=MACRO["T"], num_episode=E,
                  delta_time=0.01, speed_limit=30.0, log_root=log_root,
                  seed=3, fused_rollout=True, device=dev)
    problems = {
        "macro": MacroInverseProblem(run_name="macro", num_cell=10,
                                     cell_length=5.0, **common),
        "micro": MicroInverseProblem(run_name="micro", num_vehicle=10,
                                     vehicle_length=5.0, **common)}
    for fn in counters.values():
        fn.launches = 0
    results, expected = {}, {}
    for kind, prob in problems.items():
        t0 = time.perf_counter()
        beg, end = prob.evaluate(verbose=False)
        seconds = time.perf_counter() - t0
        n = 2 * prob.num_cell if kind == "macro" else 2 * prob.num_vehicle
        popsize = 4 + int(3 * np.log(n))
        generations = math.ceil(E / popsize)
        scipy_n = dict(prob.scipy_evaluations)
        # the target roll, one forward per GD episode, one per CMA-ES
        # generation (B = popsize), one per scipy evaluation; one backward
        # per GD episode
        fwd = 1 + E + generations + sum(scipy_n.values())
        k = "k2" if kind == "macro" else "k3"
        expected[f"{k}_fwd"], expected[f"{k}_bwd"] = fwd, E
        results[kind] = dict(
            seconds=seconds, popsize=popsize, cma_generations=generations,
            scipy_evaluations=scipy_n,
            first_end={mt: v[0][0] for mt, v in end.items()},
            last_end={mt: v[0][-1] for mt, v in end.items()},
            finite=all(np.isfinite(v[0]).all() for v in end.values()),
            gd_improved=end["gd"][0][-1] < end["gd"][0][0])
    launches = {name: fn.launches for name, fn in counters.items()}
    ok = (launches == expected and
          all(r["finite"] and r["gd_improved"] for r in results.values()))
    report(problems=results, launches=launches, expected_launches=expected,
           status="ok" if ok else "FAIL")
    if not ok:
        raise SystemExit("inverse failed")
    return launches


def run_inverse_hybrid(dev, log_root: str):
    """The hybrid chain at n_cell 10, T = 500 on the card: GD, 2 episodes,
    through the port's eager network step (no kernel). The second
    episode's error is finite only if the first episode's gradient was
    (Adam carries a NaN into the state), and the estimate moves only if it
    was nonzero."""
    from dhts_torch.apps.inverse.hybrid import HybridInverseProblem

    prob = HybridInverseProblem(1, MACRO["T"], 2, 0.01, 30.0, "hybrid", 10,
                                5.0,
                                log_root=log_root, seed=3, device=dev)
    rng = np.random.default_rng(3)
    prob.initialize(rng)
    target_conv = [int(x) for x in prob.conversions]
    est0 = prob.random_initial_state(rng)
    beg, end = prob.solve_gd(est0)
    conv = [int(x) for x in prob.conversions]
    ok = (all(math.isfinite(x) for x in beg + end) and beg[1] != beg[0] and
          min(target_conv) >= 1 and min(conv) >= 1)
    report(beg=beg, end=end, emitted_absorbed_target=target_conv,
           emitted_absorbed_last_gd=conv, status="ok" if ok else "FAIL")
    if not ok:
        raise SystemExit("inverse_hybrid failed")


def time_rollouts(dev) -> dict:
    """K2 and K3 ms per launch, forward and backward, at B = 1, 12, 128
    (CUDA events, median of 5 runs of 20 back-to-back launches after two
    warm-up launches), each with its bound; the plain versions' ms at B = 1
    (one run each). K3's forward also saving the trajectory (``k3_fwd_save``,
    a GD episode's), its backward over that trajectory (``k3_bwd``, the GD
    episode's) and replaying its own (``k3_bwd_replay``); K3's ms are its
    launchers' called directly, ``ms_wrapper`` the wrapper's calls. Timing
    launches are not the main path's: the counters are restored."""
    import torch

    from dhts_torch.models.vehicle import default_params
    from dhts_torch.ops.cuda import macro_rollout as k2
    from dhts_torch.ops.cuda import micro_rollout as k3

    C, V, T = MACRO["C"], MICRO["V"], MACRO["T"]
    mc = k2.MacroConsts(MACRO["u_max"], MACRO["dt"], MACRO["dx"], T)
    uc = k3.micro_consts(default_params(MICRO["u_max"], (V,)), 1000.0, 0.0,
                         MICRO["dt"], MICRO["T"], dev)
    saved = [(fn, fn.launches) for fn in (
        k2.macro_rollout_fwd, k2.macro_rollout_bwd, k3.micro_rollout_fwd,
        k3.micro_rollout_bwd)]
    ms, ms_wrapper, bounds, plain = {}, {}, {}, {}
    for B in ROLLOUT_BATCHES:
        mi = macro_inputs(B, 21, dev)
        ui = micro_inputs(B, 22, dev)
        mcot = [torch.ones((B, C), device=dev)] * 2
        ucot = [torch.ones((B, V), device=dev)] * 2
        traj = k3.micro_rollout_fwd(uc, *ui, trajectory=True)[2]
        runs = {"k2_fwd": lambda: k2.macro_rollout_fwd(mc, *mi),
                "k2_bwd": lambda: k2.macro_rollout_bwd(mc, *mi, *mcot),
                "k3_fwd": lambda: k3.micro_rollout_fwd(uc, *ui),
                "k3_fwd_save": lambda: k3.micro_rollout_fwd(
                    uc, *ui, trajectory=True),
                "k3_bwd": lambda: k3.micro_rollout_bwd(uc, *ui, *ucot,
                                                       traj=traj),
                "k3_bwd_replay": lambda: k3.micro_rollout_bwd(uc, *ui,
                                                              *ucot)}
        for fn in runs.values():
            fn()
            fn()
        torch.cuda.synchronize()
        for name, fn in runs.items():
            ms.setdefault(name, {})[B] = cuda_ms(fn, 5, launches=20)
        # K3's kernels alone: the wrapper's host time per call (above) is
        # longer than the warp kernels, so back to back it would time the
        # host; its launchers with their arguments made once
        from dhts_torch.ops.cuda import _launch

        lib, stream = k3._library(), _launch.stream(dev)
        out = [torch.empty((B, V), device=dev) for _ in range(2)]
        g = torch.empty((B, 2 * V), device=dev)
        scratch = torch.empty_like(traj)
        direct = {"k3_fwd": ("fwd", (*ui, *out)),
                  "k3_fwd_save": ("fwd_save", (*ui, *out, scratch)),
                  "k3_bwd": ("bwd_saved", (*ui, *ucot, g, traj)),
                  "k3_bwd_replay": ("bwd_replay", (*ui, *ucot, g, scratch))}
        for name, (launcher, ts) in direct.items():
            args = k3.kernel_args(uc, ts, B, V, stream)
            fn = getattr(lib, f"launch_micro_rollout_{launcher}")
            _launch.raise_on(fn(*args), name)
            ms_wrapper.setdefault(name, {})[B] = ms[name][B]
            ms[name][B] = cuda_ms(lambda: fn(*args), 5, launches=20)
        # bytes: each input read once, each output written once; ops: the
        # Riemann solves and cell updates (K2) or IDM updates (K3) of T
        # steps, 3x for a vector-Jacobian product
        k2_ops = T * B * ((C + 1) * OPS_PER_INTERFACE + C * OPS_PER_CELL)
        k3_ops = T * B * V * OPS_PER_VEHICLE
        k2_in, k3_in = (2 * C + 4) * B * 4, (2 * V * B + 6 * V) * 4
        k3_traj = 2 * T * V * B * 4  # the saved trajectory
        work = {"k2_fwd": (k2_in + (2 * C + 1) * B * 4, k2_ops),
                "k2_bwd": (k2_in + 2 * C * B * 4 + (2 * C + 4) * B * 4,
                           k2_ops * VJP_OPS_MULTIPLE),
                "k3_fwd": (k3_in + 2 * V * B * 4, k3_ops),
                "k3_fwd_save": (k3_in + 2 * V * B * 4 + k3_traj, k3_ops),
                "k3_bwd": (k3_in + 4 * V * B * 4 + k3_traj,
                           k3_ops * VJP_OPS_MULTIPLE),
                "k3_bwd_replay": (k3_in + 4 * V * B * 4,
                                  k3_ops * VJP_OPS_MULTIPLE)}
        for name, (nbytes, nops) in work.items():
            bounds.setdefault(name, {})[B] = bound_of(nbytes, nops)
        if B == 1:
            plain = {
                "k2_fwd": cuda_ms(lambda: k2.plain_macro_rollout(mc, *mi), 1),
                "k2_bwd": cuda_ms(lambda: k2.plain_macro_rollout_bwd(
                    mc, *mi, *mcot), 1),
                "k3_fwd": cuda_ms(lambda: k3.plain_micro_rollout(uc, *ui), 1),
                "k3_bwd": cuda_ms(lambda: k3.plain_micro_rollout_bwd(
                    uc, *ui, *ucot), 1)}
    for fn, n in saved:
        fn.launches = n
    ms_over_bound = {name: {B: ms[name][B] / bounds[name][B]["bound_ms"]
                            for B in ROLLOUT_BATCHES} for name in ms}
    return dict(ms=ms, ms_wrapper=ms_wrapper, bounds=bounds, plain_ms=plain,
                ms_over_bound=ms_over_bound)


def spatial_inputs(env, B: int, seed: int, action):
    """The STEP kernels' inputs for B episodes of ``env``'s scene: the
    action as ``[n_phases, n_inter]``, B seeded draws, the scene's data."""
    import torch

    from dhts_torch.ops.cuda import itscp_spatial_step as k6

    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)
    rand = torch.stack([env.draw_rand(gen) for _ in range(B)])
    a = torch.as_tensor(action, dtype=torch.float32, device=env.device)
    d = env.data
    return (a.reshape(env.n_phases, -1).contiguous(), rand, d.schedule,
            d.mroute_next, d.mroute_prev,
            k6.route_table(d.inj_routes, env.base_state.route_pool))


def check_spatial_fwd(env) -> dict:
    """STEP forward, hard and soft, B = 1 and 4: every 50th step of T
    calls of one step against the plain step on the card, the episode in
    one call (the main path's launch) bit-equal to those calls, each
    episode against K1; raises on a failed check. Returns the largest error
    and the mean vehicles per step."""
    import torch

    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1
    from dhts_torch.ops.cuda import itscp_spatial_step as k6

    dev = env.device
    checks, max_err, veh_steps = [], 0.0, []
    for differentiable in (False, True):
        plan = k6.make_plan(env, differentiable)
        g = k6.geometry(plan, dev)
        p1 = env.fused_plan(differentiable)
        for B in (1, 4):
            ins = spatial_inputs(env, B, 100 + B, np.full(
                env.action_size(), 0.55))
            fb, ib = k6.empty_state(plan, B, dev)
            q = torch.zeros((B, plan.T), device=dev)
            ev = torch.zeros((B, plan.T, 3), dtype=torch.int32, device=dev)
            w = torch.zeros((B, plan.T), device=dev)
            step_err, step_ok, n_veh = 0.0, True, 0
            for t in range(plan.T):
                check = t % 50 == 0
                if check:
                    carry, sg, ss = k6.unpack(plan, fb, ib)
                    carry = tuple(x.clone() for x in carry)
                    sg, ss = sg.clone(), ss.clone()
                k6.spatial_step_fwd(plan, fb, ib, t, 1, ins, q, ev, w)
                if check:
                    out = k6.plain_spatial_step(
                        plan, carry, sg, ss, t, ins[0], ins[1][:, t],
                        ins[2][t], ins[3][t], ins[4][t], ins[5], g)
                    f2, i2 = k6.pack(plan, out.carry, out.sg_ms, out.ss_ms)
                    step_err = max(step_err, float((f2 - fb).abs().max()),
                                   float((out.queue - q[:, t]).abs().max()))
                    step_ok = (step_ok and bool(torch.equal(i2, ib)) and
                               bool(torch.allclose(f2, fb, rtol=1e-6,
                                                   atol=1e-6)) and
                               bool(torch.equal(out.events, ev[:, t])) and
                               bool(torch.allclose(out.queue, q[:, t],
                                                   rtol=1e-6, atol=1e-6)))
                    n_veh += int(ib[0, :plan.L].sum())
            veh_steps.append(n_veh * 50 / plan.T)
            # the main path's launch: the whole episode in one call, whose
            # steps keep the carry on chip; bit-equal to the calls of one
            # step just held against the plain step
            fb1, ib1 = k6.empty_state(plan, B, dev)
            q1, ev1, w1 = (torch.zeros_like(x) for x in (q, ev, w))
            k6.spatial_step_fwd(plan, fb1, ib1, 0, plan.T, ins, q1, ev1, w1)
            one_call_ok = all(bool(torch.equal(x, y)) for x, y in (
                (fb1, fb), (ib1, ib), (q1, q), (ev1, ev), (w1, w)))
            ep_ok, ep_err = True, 0.0
            for b in range(B):
                r1, q1, e1 = k1.itscp_hybrid_episode_fwd(
                    p1, ins[0], ins[2], ins[3], ins[4], ins[1][b],
                    env.data.inj_routes, env.base_state.route_pool)
                reward = -float(q[b].sum())
                rel = abs(reward - float(r1)) / max(abs(float(r1)), 1e-30)
                err = float((q[b] - q1).abs().max())
                ep_err = max(ep_err, err)
                ep_ok = (ep_ok and bool(torch.equal(ev[b].float(),
                                                    e1[:, :3])) and
                         rel <= 1e-5 and err <= 1e-4)
            tot = ev.sum((0, 1)).tolist()
            rec = dict(mode="soft" if differentiable else "hard", B=B,
                       step_checks_ok=step_ok, step_max_abs_err=step_err,
                       one_call_equals_steps=one_call_ok,
                       k1_ok=ep_ok, k1_queues_max_abs_err=ep_err,
                       injected=tot[0], emitted=tot[1], absorbed=tot[2],
                       finite=bool(torch.isfinite(q).all()))
            checks.append(rec)
            max_err = max(max_err, step_err, ep_err)
            if not (step_ok and one_call_ok and ep_ok and tot[1] > 0 and
                    rec["finite"]):
                report(checks=checks, status="FAIL")
                raise SystemExit(f"spatial_vs_plain failed: {rec}")
    report(checks=checks, tolerance=dict(
        step="integers equal, floats allclose(rtol 1e-6, atol 1e-6)",
        one_call="carry, queues, events, waves after one call of T steps "
                 "bit-equal to T calls of one step",
        vs_k1="events equal, reward rel 1e-5, queues abs 1e-4"))
    return dict(max_abs_err=max_err,
                vehicles_per_step=sum(veh_steps) / len(veh_steps))


def check_spatial_bwd(env) -> dict:
    """STEP derivative against autograd of the plain episode over the first
    60 steps (B = 2) and against K1's backward at T = 600 (B = 1), and the
    latter's one call of T steps bit-equal to T calls of one step; raises
    on a failed check. Returns the errors and the plain derivative's ms per
    step."""
    import torch

    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1
    from dhts_torch.ops.cuda import itscp_spatial_step as k6

    dev, T60 = env.device, 60
    rng = np.random.default_rng(3)
    plan = k6.make_plan(env, True)
    p60 = plan._replace(T=T60)
    ins = list(spatial_inputs(env, 2, 200, rng.uniform(
        0.3, 0.7, env.action_size())))
    ins[1] = ins[1][:, :T60].contiguous()
    ins[2:5] = [x[:T60].contiguous() for x in ins[2:5]]
    w = torch.as_tensor(rng.uniform(-1, 1, (2, T60)), dtype=torch.float32,
                        device=dev)
    got = k6.spatial_episode_bwd(p60, w, *ins).double().flatten()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = k6.plain_spatial_episode_bwd(p60, w, *ins).double().flatten()
    torch.cuda.synchronize()
    plain_step_ms = (time.perf_counter() - t0) * 1e3 / (2 * T60)
    scale = float(ref.abs().max())
    rec60 = dict(T=T60, B=2, cos=cosine(got, ref),
                 max_abs_err=float((got - ref).abs().max()),
                 max_abs_ref=scale, finite=bool(torch.isfinite(got).all()))
    ok60 = (rec60["finite"] and scale > 0 and rec60["cos"] > 0.9999 and
            bool(torch.allclose(got, ref, rtol=2e-2, atol=2e-3 * scale)))
    ins = spatial_inputs(env, 1, 201, rng.uniform(0.3, 0.7,
                                                  env.action_size()))
    wf = torch.full((1, plan.T), -1.0, device=dev)
    got = k6.spatial_episode_bwd(plan, wf, *ins).double().flatten()
    # the main path's launch (one call of T steps) against T calls of one
    # step: carry, tangents and float64 gradient bit-equal
    split = []
    for n_steps in (plan.T, 1):
        st = k6.dual_state(plan, 1, dev)
        g64 = torch.zeros(st[0].shape[0], dtype=torch.float64, device=dev)
        for t in range(0, plan.T, n_steps):
            k6.spatial_step_bwd(plan, *st, t, n_steps, ins, wf, g64)
        split.append((*st, g64))
    one_call_ok = all(bool(torch.equal(x, y)) for x, y in zip(*split))
    ref = k1.itscp_hybrid_episode_bwd(
        env.fused_plan(True), wf[0], ins[0], ins[2], ins[3], ins[4],
        ins[1][0], env.data.inj_routes,
        env.base_state.route_pool).double().flatten()
    torch.cuda.synchronize()
    rec600 = dict(T=plan.T, B=1, cos=cosine(got, ref),
                  max_abs_err=float((got - ref).abs().max()),
                  max_abs_ref=float(ref.abs().max()),
                  finite=bool(torch.isfinite(got).all()))
    ok600 = rec600["finite"] and rec600["cos"] > 0.99999 and one_call_ok
    rec600["one_call_equals_steps"] = one_call_ok
    report(vs_plain_autograd=rec60, vs_k1_backward=rec600,
           note="the plain autograd check runs the first 60 of 600 steps "
                "to keep the phase short",
           tolerance=dict(vs_plain="cos > 0.9999, allclose(rtol 2e-2, atol "
                                   "2e-3 * max|g_plain|)",
                          vs_k1="cos > 0.99999",
                          one_call="carry, tangents, float64 gradient "
                                   "bit-equal"),
           status="ok" if ok60 and ok600 else "FAIL")
    if not (ok60 and ok600):
        raise SystemExit("spatial_bwd_vs_plain failed")
    return dict(max_abs_err=rec60["max_abs_err"],
                plain_step_ms=plain_step_ms)


def run_spatial_train(log_root: str) -> dict:
    """The training CLI on the fused spatial step at the preset, 2 epochs
    with an evaluation each; the STEP launches, counted from 0 here, must
    equal what the run implies. Raises on a failed check."""
    from dhts_torch.apps.control.itscp import run
    from dhts_torch.ops.cuda import itscp_spatial_step as k6

    argv = ["--mode", "hybrid", "--problem", "1", "--n_trial", "1",
            "--n_intersection", "3", "--n_lane", "1", "--lane_length", "5",
            "--speed_limit", "60", "--simulation_length", "20",
            "--signal_length", "4", "--lr", "1e-4", "--seed", "3",
            "--n_episode", "1", "--mesh", "1,1", "--mesh_fused",
            "--log_root", log_root]
    k6.launches.update(fwd=0, bwd=0)
    k6.kernel_launches.update(fwd=0, bwd=0)
    run.main(argv)
    launches = dict(k6.launches)
    kernel_launches = dict(k6.kernel_launches)
    (metrics,) = Path(log_root).glob("hybrid_*/trial_0/metrics.jsonl")
    rows = [json.loads(x) for x in metrics.read_text().splitlines()]
    losses = [r["loss_train"] for r in rows if "loss_train" in r]
    evals = [r["reward_eval"] for r in rows if "reward_eval" in r]
    T, steps, ep_per_epoch = 600, len(losses), 1
    expected = dict(fwd=T * (steps * ep_per_epoch + len(evals)),
                    bwd=T * steps)
    # one kernel launch runs an episode's T steps
    expected_kernel = {k: v // T for k, v in expected.items()}
    ok = (steps == 2 and len(evals) == 2 and launches == expected and
          kernel_launches == expected_kernel and
          all(math.isfinite(x) for x in losses + evals))
    report(argv=argv, episodes_per_epoch=ep_per_epoch, losses=losses,
           eval_rewards=evals, launches=launches, expected_launches=expected,
           kernel_launches=kernel_launches,
           expected_kernel_launches=expected_kernel,
           status="ok" if ok else "FAIL")
    if not ok:
        raise SystemExit("spatial_train failed")
    return dict(steps=launches, kernel=kernel_launches)


def time_spatial(env, vehicles_per_step: float) -> dict:
    """STEP forward (hard, and soft: the train path's mode) and derivative
    ms per step at B = 1 and 4 (the launcher called directly, one call of
    50 steps from the state after 100, the state restored before each call
    outside the CUDA events; median of 5) and per episode (the wrapper, one
    call of T steps from the empty state, state set-up included; median of
    3), with the bounds of both calls; the plain step's ms at B = 1. Timing
    launches are not the main path's: the wrappers' counters are
    restored."""
    import torch

    from dhts_torch.ops.cuda import itscp_spatial_step as k6
    from dhts_torch.ops.cuda import spatial_clock as clock

    saved = dict(k6.launches)
    saved_kernel = dict(k6.kernel_launches)
    dev = env.device
    lib = k6._library()
    soft, hard = k6.make_plan(env, True), k6.make_plan(env, False)
    T, L, C = soft.T, soft.L, soft.C
    n_act = soft.n_phases * soft.n_inter
    n_macro = int(env.spec.is_macro.sum())
    li = soft.lane_i.cpu().numpy()
    K = soft.K
    is_macro, num_cell, nxt = li[0] != 0, li[1], li[8 + K:8 + 2 * K]
    n_cells = int(num_cell[is_macro].sum())
    # capacitor slots a step fills: macro lane toward a micro lane
    n_caps = int(sum(((nxt[q] >= 0) & is_macro &
                      ~is_macro[np.clip(nxt[q], 0, L - 1)]).sum()
                     for q in range(K)))
    # one step of one episode: the Riemann solves and cell updates of the
    # macro lanes and the IDM updates of this run's vehicles
    step_ops = (n_macro * ((C + 1) * OPS_PER_INTERFACE + C * OPS_PER_CELL) +
                vehicles_per_step * OPS_PER_VEHICLE)
    # the state one episode must read and write once a launcher call (the
    # call keeps it on chip between its steps): r, y of the macro lanes'
    # cells; pos, vel, av, five IDM parameters, length, route id and index
    # of this run's vehicles; those capacitors; the lane counters
    # (vehicles, waiting pool, emission cursor); the two running means. The
    # empty vehicle slots, and the vehicle slots of macro lanes, which
    # never hold a vehicle, need not move.
    state = 2 * 4 * (2 * n_cells + 11 * vehicles_per_step + n_caps +
                     3 * L + 4)
    tables = sum(x.numel() * x.element_size() for x in
                 (soft.lane_i, soft.lane_f, soft.prog))

    def call_bound(B: int, n: int, dual: bool) -> dict:
        """The bound of one launcher call of n steps of B episodes: the
        state, the static tables and the action once a call; each step's
        rows of the draws and scene data and its outputs (queue, 3 event
        counts, wave; the derivative reads the loss weight instead and
        writes the float64 gradient once, and does one vector-Jacobian
        product's operations). The route entries the leader walks read
        depend on the data and are not counted."""
        per_step = (B * L + 3 * L) * 4 + B * (4 if dual else 5 * 4)
        nbytes = (B * state + tables + n_act * 4 + n * per_step +
                  (B * n_act * 8 if dual else 0))
        ops = n * B * step_ops * (VJP_OPS_MULTIPLE if dual else 1)
        return bound_of(nbytes, ops)

    def per_step(bound: dict, n: int) -> dict:
        return {k: v / n for k, v in bound.items() if k != "bound_by"} | \
            dict(bound_by=bound["bound_by"])

    ms, per_episode, bounds, episode_bounds = {}, {}, {}, {}
    for B in (1, 4):
        for name, kernel in (("fwd", "hard"), ("fwd_soft", "soft"),
                             ("bwd", "dual")):
            # steps 100 to 149 of a state that has run the first 100
            run = clock.Run(kernel, env, B, dev, lib, seed=300 + B)
            ms.setdefault(name, {})[B] = clock.timed_ms(
                run, lib, 5) / clock.STEPS
            bounds.setdefault(name, {})[B] = per_step(call_bound(
                B, clock.STEPS, name == "bwd"), clock.STEPS)
            episode_bounds.setdefault(name, {})[B] = call_bound(
                B, T, name == "bwd")
        ins = spatial_inputs(env, B, 300 + B, np.full(env.action_size(),
                                                      0.55))
        wq = torch.ones((B, T), device=dev)
        per_episode.setdefault("fwd", {})[B] = cuda_ms(
            lambda: k6.spatial_episode_fwd(hard, *ins), 3)
        per_episode.setdefault("fwd_soft", {})[B] = cuda_ms(
            lambda: k6.spatial_episode_fwd(soft, *ins), 3)
        per_episode.setdefault("bwd", {})[B] = cuda_ms(
            lambda: k6.spatial_episode_bwd(soft, wq, *ins), 3)
    ins = spatial_inputs(env, 1, 310, np.full(env.action_size(), 0.55))
    carry, sg, ss = k6.initial_carry(soft, 1, dev)
    g = k6.geometry(soft, dev)
    plain_ms = cuda_ms(lambda: k6.plain_spatial_step(
        soft, carry, sg, ss, 100, ins[0], ins[1][:, 100], ins[2][100],
        ins[3][100], ins[4][100], ins[5], g), 5)
    k6.launches.update(saved)
    k6.kernel_launches.update(saved_kernel)
    smem = lib.itscp_spatial_step_smem
    carry = lambda dual: lib.itscp_spatial_step_smem_carry(
        L, C, soft.V, K, dual)
    return dict(ms=ms, ms_per_episode=per_episode, bounds=bounds,
                bounds_per_episode=episode_bounds,
                bound_note=f"bounds: per step of a {clock.STEPS}-step "
                           "call (state, tables and action once a call, "
                           f"divided by {clock.STEPS}); per episode: one "
                           f"call of {T} steps",
                state_bytes_per_episode=state, table_bytes=tables,
                plain_step_ms=plain_ms,
                smem_bytes=dict(fwd=smem(L, 0), bwd=smem(L, 1)),
                smem_bytes_with_carry=dict(fwd=carry(0), bwd=carry(1)),
                ms_over_bound={n: {B: ms[n][B] / bounds[n][B]["bound_ms"]
                                   for B in ms[n]} for n in ms},
                ms_per_episode_over_bound={
                    n: {B: per_episode[n][B] /
                        episode_bounds[n][B]["bound_ms"]
                        for B in per_episode[n]} for n in per_episode})


# ---------------------------------------------------------------------------
# slice 6: the lane-sharded fused spatial step (K6's per-shard bodies, K5's
# stop-gradient op) over S gloo ranks that share the card
# ---------------------------------------------------------------------------

SHARDS = 4
SHARD_CHECK_EVERY = 50
# each call of the spawned ranks must end within this (they fail the run
# if they do not)
RANK_SECONDS = 240


def preset_env(dev):
    """The 3x3 hybrid preset's env as the spatial phases use it (problem 1,
    seed 3, reset with seed 3)."""
    from dhts_torch.apps.control.itscp import problem
    from dhts_torch.apps.control.itscp.env import ItscpEnv

    env = ItscpEnv(config=dict(PRESET, random_seed=3),
                   schedule_fn=problem.problem_1, device=dev)
    env.reset(3)
    return env


def _lane_comm(plan, S, rank):
    from dhts_torch.ops.cuda import itscp_spatial_shard as ks
    from dhts_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"data": 1, "lane": S}, "cuda")
    return ks.LaneComm(plan.L, [ks.shards_of(plan.L, S)[rank]],
                       mesh.lane_group)


def _shard_fwd_rank(rank, S, check_every):
    """One rank of ``shard_vs_plain``: the sharded forward, hard and soft,
    B = 1, every ``check_every``-th step's launches held against the
    plain bodies on the card (``checked_step`` raises on a difference), and
    the Q kernel's queues against ``plain_queues`` of the same gathered
    rows; returns the episode for the parent to hold against the STEP
    kernel's."""
    import torch

    from dhts_torch.ops.cuda import itscp_spatial_shard as ks
    from dhts_torch.ops.cuda import itscp_spatial_step as k6
    from dhts_torch.parallel import collectives

    env = preset_env(torch.device("cuda"))
    out = {"checks": [], "errors": {}}
    for differentiable in (False, True):
        plan = k6.make_plan(env, differentiable)
        comm = _lane_comm(plan, S, rank)
        ins = spatial_inputs(env, 1, 101, np.full(env.action_size(), 0.55))
        if not differentiable:
            out["scene"] = [float(x.double().sum()) for x in ins]
        run = ks.ShardRun(plan, comm, ins, dual=False)
        torch.cuda.synchronize()
        counts = dict(collectives.counts)
        secs = dict(collectives.seconds)
        t0 = time.perf_counter()
        plain_steps, stepped = 0, 0.0
        for t in range(plan.T):
            if check_every and t % check_every == 0:
                for body, e in run.checked_step(t, 1e-6, 1e-6).items():
                    out["errors"][body] = max(out["errors"].get(body, 0.0), e)
                continue
            # wall time of an unchecked step: four launches and the
            # collectives between them (host-staged gloo, not the card's)
            t1 = time.perf_counter()
            run.step(t)
            torch.cuda.synchronize()
            stepped += time.perf_counter() - t1
            plain_steps += 1
        q, ev, w = run.outputs()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        calls = {k: collectives.counts[k] - counts[k] for k in counts}
        # the Q kernel against its plain version on the same gathered rows
        q_plain = ks.plain_queues(plan, run.g["gq"].cpu())
        q = q.cpu()
        rec = dict(mode="soft" if differentiable else "hard", S=S,
                   seconds=seconds, q_kernel_equal=bool(torch.equal(
                       q, q_plain)),
                   q_kernel_max_abs_err=float((q - q_plain).abs().max()),
                   episode=(q, ev.cpu(), w.cpu()),
                   step_wall_ms_host_staged_gloo=stepped / plain_steps * 1e3,
                   collectives=calls,
                   collective_ms_host_staged_gloo={
                       k: (collectives.seconds[k] - secs[k]) / n * 1e3
                       for k, n in calls.items() if n})
        out["checks"].append(rec)
    return out


def _step_episodes(env):
    """The single-shard STEP kernel's episodes on the inputs of
    ``_shard_fwd_rank`` (hard, soft), and the inputs' checksums."""
    from dhts_torch.ops.cuda import itscp_spatial_step as k6

    ins = spatial_inputs(env, 1, 101, np.full(env.action_size(), 0.55))
    refs = [tuple(x.cpu() for x in k6.spatial_episode_fwd(
        k6.make_plan(env, d), *ins)) for d in (False, True)]
    return refs, [float(x.double().sum()) for x in ins]


def check_shard_fwd(ranks) -> dict:
    """``shard_vs_plain``: the S = 4 ranks of ``ranks`` with per-launch
    checks, then its S = 2 ranks; every rank's episode against the STEP
    kernel's, run once here while the S = 4 ranks work; raises on a
    failure."""
    import torch

    recs, errors, ok, wall, coll = [], {}, True, {}, {}
    submitted = ranks[SHARDS].submit(_shard_fwd_rank, (SHARD_CHECK_EVERY,))
    refs, scene = _step_episodes(preset_env(torch.device("cuda")))
    for S, every in ((SHARDS, SHARD_CHECK_EVERY), (2, 0)):
        outs = (ranks[S].result(submitted) if S == SHARDS else
                ranks[S].run(_shard_fwd_rank, (every,)))
        for o in outs:
            for body, e in o["errors"].items():
                errors[body] = max(errors.get(body, 0.0), e)
            ok = ok and o["scene"] == scene
        for rank, o in enumerate(outs):
            for rec, ref in zip(o["checks"], refs):
                (q, ev, w), (qs, evs, ws) = rec.pop("episode"), ref
                rec.update(events_equal=bool(torch.equal(ev, evs)),
                           queues_equal=bool(torch.equal(q, qs)),
                           waves_equal=bool(torch.equal(w, ws)),
                           reward=float(-q.sum()), reward_step=float(
                               -qs.sum()),
                           queues_max_abs_err=float((q - qs).abs().max()),
                           emitted=int(ev[..., 1].sum()),
                           absorbed=int(ev[..., 2].sum()))
                ok = (ok and rec["events_equal"] and rec["queues_equal"] and
                      rec["waves_equal"] and rec["emitted"] > 0 and
                      rec["q_kernel_equal"])
                errors["Q"] = max(errors.get("Q", 0.0),
                                  rec["q_kernel_max_abs_err"])
                if rank == 0:
                    recs.append(rec)
        wall[S] = {c["mode"]: c["step_wall_ms_host_staged_gloo"]
                   for c in outs[0]["checks"]}
        coll[S] = {c["mode"]: c["collective_ms_host_staged_gloo"]
                   for c in outs[0]["checks"]}
    report(checks=recs, per_launch_max_abs_err=errors,
           step_wall_ms_host_staged_gloo=wall,
           collective_ms_host_staged_gloo=coll,
           tolerance=dict(per_launch="integers equal, floats allclose(rtol "
                                     "1e-6, atol 1e-6), every 50th step",
                          q_kernel="bit-equal to plain_queues of the same "
                                   "gathered rows",
                          vs_step="events, queues, waves bit-equal"),
           status="ok" if ok else "FAIL")
    if not ok:
        raise SystemExit("shard_vs_plain failed")
    return dict(errors=errors, step_wall_ms=wall, collective_ms=coll)


T_PLAIN_BWD = 60  # steps of the plain forward-mode derivative's check


def _shard_bwd_inputs(env):
    """``shard_bwd_vs_plain``'s soft plan, inputs and loss weights at T =
    600, and the same cut to the first ``T_PLAIN_BWD`` steps."""
    import torch

    from dhts_torch.ops.cuda import itscp_spatial_step as k6

    plan = k6.make_plan(env, True)
    rng = np.random.default_rng(3)
    ins = spatial_inputs(env, 1, 201, rng.uniform(0.3, 0.7,
                                                  env.action_size()))
    wf = torch.full((1, plan.T), -1.0, device=env.device)
    T = T_PLAIN_BWD
    ins60 = list(ins)
    ins60[1] = ins[1][:, :T].contiguous()
    ins60[2:5] = [x[:T].contiguous() for x in ins[2:5]]
    w60 = torch.as_tensor(rng.uniform(-1, 1, (1, T)), dtype=torch.float32,
                          device=env.device)
    return (plan, ins, wf), (plan._replace(T=T), ins60, w60)


SHARD_BWD_CHECKS = (107, 307, 507)  # the derivative's D3 held at these


def _shard_bwd_rank(rank, S):
    """One rank of ``shard_bwd_vs_plain``: the sharded derivative at T =
    600 (its Q kernel against ``plain_gradient`` of the same gathered
    tangent rows) and over the first 60 steps, for the parent to hold
    against the STEP derivative and the plain forward-mode derivative."""
    import torch

    from dhts_torch.ops.cuda import itscp_spatial_shard as ks

    env = preset_env(torch.device("cuda"))
    (plan, ins, wf), (p60, ins60, w60) = _shard_bwd_inputs(env)
    comm = _lane_comm(plan, S, rank)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = ks.ShardRun(plan, comm, ins, dual=True).run()
    got = run.gradient(wf)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    q_plain = ks.plain_gradient(plan, run.g["gq"].cpu(), wf.cpu())
    got60 = ks.shard_episode_bwd(p60, comm, w60, *ins60)
    return dict(grad=got.cpu(), grad60=got60.cpu(), wall_s=seconds,
                q_kernel_equal=bool(torch.equal(got.cpu(), q_plain)),
                q_kernel_max_abs_err=float((got.cpu() - q_plain).abs().max()))


def check_shard_bwd(ranks) -> dict:
    """``shard_bwd_vs_plain``: the ranks' derivatives against the STEP
    derivative and the plain forward-mode derivative (one shard), both run
    once here while the ranks work, as are the derivatives on S = 2 and on
    the main path's S = 4 shards, whose ``Dual`` D3 launches of
    ``SHARD_BWD_CHECKS`` are held against ``plain_body_D`` under
    forward-mode AD (``checked_dual_step`` raises on a difference); raises
    on a failure."""
    import torch

    from dhts_torch.ops.cuda import itscp_spatial_shard as ks
    from dhts_torch.ops.cuda import itscp_spatial_step as k6

    submitted = ranks.submit(_shard_bwd_rank)
    env = preset_env(torch.device("cuda"))
    (plan, ins, wf), (p60, ins60, w60) = _shard_bwd_inputs(env)
    ref = k6.spatial_episode_bwd(plan, wf, *ins).cpu()
    # the derivative on S = 2 and 4 shards in this process, its D3 checked
    local, d3_err = {}, {}
    for S in (2, SHARDS):
        run = ks.ShardRun(plan, ks.LaneComm(plan.L, ks.shards_of(plan.L, S)),
                          ins, dual=True)
        d3_err[S] = 0.0
        for t in range(plan.T):
            if t in SHARD_BWD_CHECKS:
                d3_err[S] = max(d3_err[S], run.checked_dual_step(
                    t, ("D3",), value_tol=(1e-6, 1e-6)).get("D3", 0.0))
            else:
                run.step(t)
        local[S] = run.gradient(wf).cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref60 = ks.plain_sharded_episode_bwd(p60, ks.LaneComm.whole(p60.L), w60,
                                         *ins60).cpu()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    outs = ranks.result(submitted)

    def versus(got, r, **extra):
        g, r = got.double().flatten(), r.double().flatten()
        scale = float(r.abs().max())
        return dict(cos=cosine(g, r), bit_equal=bool(torch.equal(g, r)),
                    max_abs_err=float((g - r).abs().max()),
                    max_abs_ref=scale, finite=bool(torch.isfinite(g).all()),
                    close=bool(torch.allclose(g, r, rtol=2e-2,
                                              atol=2e-3 * scale)), **extra)

    in_process = {S: versus(g, ref, T=plan.T, S=S) for S, g in local.items()}
    ok, recs = all(r["bit_equal"] for r in in_process.values()), []
    for o in outs:
        a = versus(o["grad"], ref, T=plan.T,
                   wall_s_host_staged_gloo=o["wall_s"])
        b = versus(o["grad60"], ref60, T=p60.T, plain_wall_s=plain_s)
        ok = (ok and a["finite"] and a["cos"] > 0.99999 and a["close"] and
              a["max_abs_ref"] > 0 and a["bit_equal"] and b["finite"] and
              b["cos"] > 0.99999 and b["close"] and b["max_abs_ref"] > 0 and
              o["q_kernel_equal"])
        recs.append((a, b))
    report(S=SHARDS, vs_step_derivative=recs[0][0],
           in_process_vs_step_derivative=in_process,
           vs_plain_forward_mode=recs[0][1],
           q_kernel_max_abs_err=max(o["q_kernel_max_abs_err"] for o in outs),
           d3_checked_steps=SHARD_BWD_CHECKS,
           d3_max_abs_tangent_err_by_shards=d3_err,
           ranks_equal=all(torch.equal(o["grad"], outs[0]["grad"])
                           for o in outs),
           tolerance=dict(vs_step="bit-equal at S = 4 (the ranks) and S = "
                                  "2 and 4 (this process); cos > 0.99999, "
                                  "allclose(rtol 2e-2, atol 2e-3 * max|g|)",
                          vs_plain="first 60 steps: cos > 0.99999, the same "
                                   "allclose",
                          q_kernel="bit-equal to plain_gradient of the same "
                                   "gathered tangent rows",
                          d3="values allclose(rtol 1e-6, atol 1e-6), "
                             "tangents allclose(rtol 1e-5, atol 1e-5 * the "
                             "largest) against plain_body_D under "
                             "forward-mode AD"),
           status="ok" if ok else "FAIL")
    if not ok:
        raise SystemExit("shard_bwd_vs_plain failed")
    return dict(max_abs_err=max(max(a["max_abs_err"], b["max_abs_err"])
                                for a, b in recs),
                q_max_abs_err=max(o["q_kernel_max_abs_err"] for o in outs),
                d3_tangent_err=max(d3_err.values()))


def _shard_train_rank(rank, S, argv):
    """One rank of ``shard_train``: the CLI in this rank's process group,
    its launches and collectives counted from 0."""
    from dhts_torch.apps.control.itscp import run
    from dhts_torch.ops.cuda import itscp_spatial_shard as ks
    from dhts_torch.parallel import collectives

    ks.launches.update(dict.fromkeys(ks.launches, 0))
    collectives.counts.update(dict.fromkeys(collectives.counts, 0))
    ((trainer, losses),) = run.main(argv)
    return dict(launches=dict(ks.launches), counts=dict(collectives.counts),
                losses=losses, T=trainer.env.num_timestep,
                params=[p.detach().cpu() for p in trainer.model.parameters()])


def run_shard_train(ranks, log_root: str) -> dict:
    """``run --mesh 1,4 --mesh_fused`` at the run_itscp_hybrid.sh flags
    in the 4 ranks of ``ranks``; raises on a failed check."""
    from dhts_torch.ops.cuda import itscp_spatial_shard as ks

    argv = ["--mode", "hybrid", "--problem", "1", "--n_trial", "1",
            "--n_intersection", "3", "--n_lane", "1", "--lane_length", "5",
            "--speed_limit", "60", "--simulation_length", "20",
            "--signal_length", "4", "--lr", "1e-4", "--seed", "3",
            "--n_episode", "1", "--mesh", f"1,{SHARDS}", "--mesh_fused",
            "--log_root", log_root]
    outs = ranks.run(_shard_train_rank, (argv,))
    (metrics,) = Path(log_root).glob("hybrid_*/trial_0/metrics.jsonl")
    rows = [json.loads(x) for x in metrics.read_text().splitlines()]
    evals = [r["reward_eval"] for r in rows if "reward_eval" in r]
    T, steps = outs[0]["T"], len(outs[0]["losses"])
    # forward episodes: one per train step and per evaluation; derivative
    # episodes: one per train step; D3's launch does D1's and D2's work and
    # writes the next step's A rows
    fwd_eps, bwd_eps = steps + len(evals), steps
    expected = {b: T * fwd_eps for b in ks.EVERY_STEP}
    expected.update({f"{b}_bwd": T * bwd_eps for b in ks.EVERY_STEP})
    # A (step 0's rows) and Q: once per episode
    expected.update(A=fwd_eps, A_bwd=bwd_eps, Q=fwd_eps, Q_bwd=bwd_eps)
    # collectives: per step 1 gather (gF with gI) and the running means'
    # sums (the signal mean's in soft mode only: train steps soft,
    # evaluations hard; the static terms' carries the next step's A rows);
    # per episode A's gather at step 0; per forward episode the queues'
    # gather, the events' psum and the waves' pmax; per derivative
    # episode the tangents' gather: 2T + 1 calls between the bodies of a
    # hard episode, 3T + 1 of a soft one
    expected_coll = {
        "all_gather": (T + 1) * (fwd_eps + bwd_eps),
        "psum": (2 * T * (steps + bwd_eps) + T * len(evals) + 2 * fwd_eps +
                 bwd_eps),
        "pmax": fwd_eps}
    episodes = fwd_eps + bwd_eps
    per_step = {k: v / (T * episodes) for k, v in outs[0]["counts"].items()}
    ok = (steps == 2 and len(evals) == 2 and
          all(o["launches"] == expected for o in outs) and
          all(o["counts"] == expected_coll for o in outs) and
          all(math.isfinite(x) for x in outs[0]["losses"] + evals) and
          all(o["losses"] == outs[0]["losses"] for o in outs) and
          all(all(bool((p == q).all()) for p, q in zip(o["params"],
                                                       outs[0]["params"]))
              for o in outs))
    report(argv=argv, ranks=SHARDS, losses=outs[0]["losses"],
           eval_rewards=evals, launches=outs[0]["launches"],
           expected_launches=expected, collectives=outs[0]["counts"],
           expected_collectives=expected_coll,
           collectives_per_step=per_step,
           note="collectives are gloo over host memory between ranks that "
                "share the card, not the card's",
           status="ok" if ok else "FAIL")
    if not ok:
        raise SystemExit("shard_train failed")
    return outs[0]["launches"]


def _quiet_step(run, t0: int) -> int:
    """The first quiet step from t0 (``shard_clock.quiet_step``: no
    injection, conversion want or arbitrated insert or deposit), stepping
    the run to it."""
    from dhts_torch.ops.cuda import shard_clock

    return shard_clock.quiet_step(run, t0)


def _plain_call(run, body: str, t: int):
    """A zero-argument call of ``body``'s plain version on shard 0's inputs
    of step t as they stand in ``run`` (after the step), on the card; for a
    derivative run the plain body under forward-mode AD over the same dual
    rows."""
    import torch
    import torch.autograd.forward_ad as fwad

    def call():
        with torch.no_grad(), fwad.dual_level():
            return run.plain(body, 0, t)

    return call


def shard_body_work(plan, env, body: str, N: int, n: int, dual: bool):
    """``(bytes, operations)`` one launch of ``body`` must move and do for N
    rows of a shard of n lanes at the 3x3 preset: the rows, scene and state
    it reads once and writes once (float entries 4 bytes, twice in a
    derivative for value and tangent; the static-mean terms 8 + 4), the
    shard's share of the macro cells standing for the state a body touches
    (the vehicles present are few and not counted); the operations of C's
    Riemann solves and cell updates (3x in a derivative: one VJP)."""
    L, K, C = plan.L, plan.K, plan.C
    S = L // n
    cells = int(env.spec.num_cell[env.spec.is_macro].sum()) / S
    macro = int(env.spec.is_macro.sum()) / S
    f = 8 if dual else 4  # a differentiable float row entry
    per_row = {
        # A: edge cells (r, y of two cells) per macro lane, count, tail and
        # waiting pool per lane, the draw and schedule; out 9 rows
        "A": n * (4 * f + 4 * 4 + 2 * 4) + 9 * n * f,
        # B: gathered 9 rows; head and counters per lane; out 10 + 2 rows
        "B": 9 * L * f + n * 6 * 4 + 10 * n * f + 2 * n * 4,
        # C: B's 10 rows and the signal terms; r, y of the cells read and
        # written; out 15 + 4 rows
        "C": 10 * n * f + 2 * L * 4 + cells * 2 * 2 * f + n * K * f +
             15 * n * f + 4 * n * 4,
        # D3, the whole conversion at the timed (quiet) step: the want
        # table reads the values of 6 gathered rows (count, capacitor, the
        # head's position and length, the tail's position and length) and
        # 2 int rows (mn, hnext) at every lane; no lane takes a vehicle in
        # there, so convert reads no source lane's rows (the head's
        # speeds, acceleration and parameters, the route rows), only each
        # lane's own capacitor, whose value the table has read (its
        # tangent in a derivative); the cells for the static terms; out
        # the terms; and the next step's A rows from the carry it left (as
        # A's: the counters, the tail, the draw and schedule; the edge
        # cells are among the cells above), out 9 rows
        "D3": 6 * L * 4 + 2 * L * 4 + (n * 4 if dual else 0) +
              cells * 2 * f + 2 * n * (8 + 4) + n * (4 * 4 + 2 * 4) +
              9 * n * f,
        # E: the gathered terms, the cells; out one row entry per step
        "E": 2 * L * (8 + 4) + cells * 2 * f + n * f,
    }[body]
    shared = 4 * (8 + 2 * K) * n + 4 * 2 * n  # the shard's lane tables
    if body == "D3":  # every lane's kind and length, for the wants
        shared += 2 * L * 4
    ops = 0.0
    if body == "C":
        ops = N * macro * ((C + 1) * OPS_PER_INTERFACE + C * OPS_PER_CELL)
        ops *= VJP_OPS_MULTIPLE if dual else 1
    return N * per_row + shared, ops


def time_shard(env) -> dict:
    """Each body's ms per launch at S = 4, B = 1 and 4 (forward) and at the
    derivative's 45 B rows: CUDA events, median of 5 runs of 50 launches
    back to back of shard 0's kernel at a quiet step, with that step's
    gathered rows in place (all four shards in this process, so no
    collective is inside the timing); the plain body's ms on the same
    inputs; each launch's bytes bound. Q likewise on the q^2 rows gathered
    so far, with the library's lane sum (forward) and weighted sum
    (derivative) beside it, timed as Q is: 50 calls back to back between
    one pair of events. Timing launches are not the main path's: the
    counters are restored."""
    import torch

    from dhts_torch.ops.cuda import itscp_spatial_shard as ks
    from dhts_torch.ops.cuda import itscp_spatial_step as k6

    saved = dict(ks.launches)
    hard, soft = k6.make_plan(env, False), k6.make_plan(env, True)
    L, S = hard.L, SHARDS
    n = L // S
    n_act = soft.n_phases * soft.n_inter
    comm = ks.LaneComm(L, ks.shards_of(L, S))
    ms, plain, bounds, steps, host, library = {}, {}, {}, {}, {}, {}
    for dual in (False, True):
        plan = soft if dual else hard
        for B in (1, 4):
            ins = spatial_inputs(env, B, 300 + B, np.full(env.action_size(),
                                                          0.55))
            run = ks.ShardRun(plan, comm, ins, dual=dual)
            for t in range(100):
                run.step(t)
            t_q = _quiet_step(run, 100)
            N = run.N
            bufs = run.shards[0][2]
            snap = {k: v.clone() for k, v in bufs.items() if v is not None}

            def restore():
                for k, v in snap.items():
                    bufs[k].copy_(v)

            for body in ks.BODIES:
                key = f"{body}_bwd" if dual else body
                restore()
                # 50 launches back to back in one call of the launcher,
                # so that the host's cost of a launch is not in the time
                fn = lambda: run.launch(body, t_q, [0], repeat=50)
                fn()
                torch.cuda.synchronize()
                ms.setdefault(key, {})[B] = cuda_ms(fn, 5) / 50
                # the wrapper's own time per launch, one call per launch
                # as on the main path
                one = lambda: run.launch(body, t_q, [0])
                host.setdefault(key, {})[B] = cuda_ms(one, 5, 50)
                bounds.setdefault(key, {})[B] = bound_of(*shard_body_work(
                    plan, env, body, N, n, dual))
                if B == 1:
                    restore()
                    call = _plain_call(run, body, t_q)
                    call()
                    plain[key] = cuda_ms(call, 5)
            restore()
            steps[("bwd" if dual else "fwd", B)] = t_q
            # Q, once per episode, on the rows the run has gathered so far
            key = "Q_bwd" if dual else "Q"
            run.g = {}
            run.gather(["q_d" if dual else "q_v"], "psum")
            gq = run.g["gq"]
            wq = torch.full((B, plan.T), -1.0, device=gq.device)
            run.g["q_weight"] = wq
            fn = lambda: run.launch("Q", 0, [0], repeat=50)
            fn()
            torch.cuda.synchronize()
            ms.setdefault(key, {})[B] = cuda_ms(fn, 5) / 50
            host.setdefault(key, {})[B] = cuda_ms(
                lambda: run.launch("Q", 0, [0]), 5, 50)
            # bytes: the gathered rows read once, the queues written once
            # (the derivative: also the weights read, the row terms written)
            nbytes = gq.numel() * 4 + N * plan.T * 4 + (
                B * plan.T * 4 + N * 8 if dual else 0)
            # one float64 add per entry, counted twice: the card's float64
            # rate is half its float32 rate
            bounds.setdefault(key, {})[B] = bound_of(nbytes, 2 * gq.numel())
            if B == 1:
                if dual:
                    plain[key] = cuda_ms(lambda: ks.plain_gradient(
                        plan, gq, wq), 5)
                    wrows = wq.repeat_interleave(n_act, 0)
                    library[key] = cuda_ms(lambda: torch.einsum(
                        "ntl,nt->n", gq, wrows), 5, 50)
                else:
                    plain[key] = cuda_ms(lambda: ks.plain_queues(plan, gq),
                                         5)
                    library[key] = cuda_ms(lambda: torch.sum(
                        gq, -1, dtype=torch.float64), 5, 50)
    ks.launches.update(saved)
    return dict(ms=ms, plain_ms=plain, bounds=bounds, S=S, library_ms=library,
                ms_one_call_per_launch=host,
                quiet_steps={f"{k[0]}_B{k[1]}": v for k, v in steps.items()},
                derivative_rows=n_act,
                ms_over_bound={k: {B: ms[k][B] / bounds[k][B]["bound_ms"]
                                   for B in ms[k]} for k in ms})


def k4_scene(cfg, dev):
    """An all-macro scene for K4: the env (problem 1, reset with its seed)
    and the factory's episode function on the card."""
    from dhts_torch.apps.control.itscp import problem
    from dhts_torch.apps.control.itscp.env import ItscpEnv
    from dhts_torch.ops.cuda import itscp_macro_episode as k4

    env = ItscpEnv(config=cfg, schedule_fn=problem.problem_1, device=dev)
    env.reset()
    return env, k4.make_fused_itscp_macro_episode(env.spec, env.meta,
                                                  env.config, device=dev)


def k4_inputs(env, plan, action: float, seeded: bool):
    """K4's inputs: ``action`` in every entry, the env's draws, and an
    empty initial state (the ITSCP case) or a seeded one: r0 uniform in
    [0.05, 0.6] on the valid cells, y0 = compute_y(r0, u) with u in [0.3,
    1] u_max."""
    import torch

    from dhts_torch.ops import arz

    dev = env.device
    L, C, u_max = plan.L, plan.C, plan.floats[0]
    r0 = torch.zeros((L, C), device=dev)
    y0 = torch.zeros((L, C), device=dev)
    if seeded:
        rng = np.random.default_rng(11)
        t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        m = plan.cell_mask
        r0 = torch.where(m, t(rng.uniform(0.05, 0.6, (L, C))), 0.0)
        y0 = torch.where(m, arz.compute_y(
            r0, t(rng.uniform(0.3, 1.0, (L, C)) * u_max), u_max), 0.0)
    a = torch.full((plan.n_phases, plan.n_inter), float(action), device=dev)
    d = env.data
    return (a, d.schedule, d.mroute_next, d.mroute_prev, r0.contiguous(),
            y0.contiguous())


def k4_cases(scenes) -> dict:
    """K4's check cases: both scenes, actions 0.3 and 0.7, empty and seeded
    initial state; on the seeded state at action 0.7 the loss also weights
    queues[t]. ``{key: (scene, action, seeded, inputs, w)}``."""
    import torch

    cases = {}
    for name, (env, fn) in scenes.items():
        plan = fn.plan
        for action in (0.3, 0.7):
            for seeded in (False, True):
                w = torch.full((plan.T,), -1.0, device=env.device)
                if seeded and action == 0.7:
                    w = w + torch.linspace(0.0, 2.0, plan.T,
                                           device=env.device)
                cases[f"k4_{name}_{action}_{int(seeded)}"] = (
                    name, action, seeded,
                    k4_inputs(env, plan, action, seeded), w)
    return cases


def k4_plain_job(scene: str, inputs, w) -> dict:
    """One case of K4's plain version for a rank: the scene's name (of
    ``K4_SCENES``), the inputs and the loss weights ``[T]``."""
    return dict(kind="k4", scene=scene, inputs=tuple(x.cpu() for x in inputs),
                w=w.cpu())


def k4_plain_run(plan, ins, w):
    """K4's plain forward with its graph and the three gradients of
    ``sum(queues * w)`` by autograd, on the card: ``(reward, queues, g_action,
    g_r0, g_y0)`` on the CPU and the ms of the forward and of both."""
    import torch

    from dhts_torch.ops.cuda import itscp_macro_episode as k4

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.enable_grad():
        leaves = [ins[i].detach().requires_grad_(True) for i in (0, 4, 5)]
        pr, pq = k4.plain_macro_episode(plan, leaves[0], *ins[1:4],
                                        leaves[1], leaves[2])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pg = torch.autograd.grad(torch.sum(pq * w), leaves)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return ((pr.detach().cpu(), pq.detach().cpu(), *(g.cpu() for g in pg)),
            ((t1 - t0) * 1e3, (t2 - t0) * 1e3))


def check_k4_plain(scenes, cases, plain) -> dict:
    """K4's forward and reverse sweep (all three gradients) against the
    plain version on the card, case by case (:func:`k4_cases`), the plain
    episodes from the ranks (``plain``); the sweep also against the
    forward-mode derivative, and over the saved trajectory against
    replaying it. Returns the largest errors and the plain version's ms
    (median of the scene's four runs: the forward with its graph, and
    forward plus backward). Raises on a failed check."""
    import torch

    from dhts_torch.ops.cuda import itscp_macro_episode as k4

    checks, plain_ms = [], {}
    fwd_err = bwd_err = tangent_err = 0.0
    ok = True
    for name, (env, fn) in scenes.items():
        plan = fn.plan
        pad = (~plan.cell_mask).cpu()
        t_fwd, t_bwd = [], []
        for key, (scene, action, seeded, ins, w) in cases.items():
            if scene != name:
                continue
            kr, kq, traj = k4.macro_episode_fwd(plan, *ins, trajectory=True)
            kg = k4.macro_episode_bwd(plan, w, *ins, traj=traj)
            replayed = k4.macro_episode_bwd(plan, w, *ins)
            kt = k4.macro_episode_tangents(plan, w, *ins)
            (pr, pq, *pg), (ms_fwd, ms_bwd) = plain[key]
            kr, kq, kg = kr.cpu(), kq.cpu(), [g.cpu() for g in kg]
            kt = [g.cpu() for g in kt]
            rec_replay = all(torch.equal(a.cpu(), b) for a, b in
                             zip(replayed, kg))
            t_fwd.append(ms_fwd)
            t_bwd.append(ms_bwd)
            rel = abs(float(kr) - float(pr)) / abs(float(pr))
            q_err = float((kq - pq).abs().max())
            fwd_err = max(fwd_err, q_err, abs(float(kr) - float(pr)))
            rec = dict(scene=name, action=action, seeded=seeded,
                       queue_weights=bool(seeded and action == 0.7),
                       reward_kernel=float(kr),
                       reward_plain=float(pr), reward_rel_err=rel,
                       queues_max_abs_err=q_err,
                       finite=bool(torch.isfinite(kq).all()),
                       sweep_saved_equals_replayed=rec_replay)
            c_ok = (rel <= 1e-5 and q_err <= 1e-4 and rec["finite"] and
                    tuple(kq.shape) == (plan.T,) and rec_replay)
            for gname, a, b, tg in zip(("action", "r0", "y0"), kg, pg, kt):
                pad_zero = gname == "action" or \
                    float(a[pad].abs().max()) == 0.0
                a, b = a.double().flatten(), b.double().flatten()
                scale = float(b.abs().max())
                err = float((a - b).abs().max())
                bwd_err = max(bwd_err, err)
                g = dict(cos=cosine(a, b), max_abs_err=err,
                         max_abs_ref=scale, padded_zero=pad_zero,
                         finite=bool(torch.isfinite(a).all()))
                tg = tg.double().flatten()
                t_scale = float(tg.abs().max())
                g["cos_vs_tangents"] = cosine(a, tg)
                g["max_abs_err_vs_tangents"] = float((a - tg).abs().max())
                tangent_err = max(tangent_err, g["max_abs_err_vs_tangents"])
                g["ok"] = (g["finite"] and scale > 0 and pad_zero and
                           g["cos"] > 0.999 and
                           bool(torch.allclose(a, b, rtol=2e-2,
                                               atol=2e-3 * scale)) and
                           g["cos_vs_tangents"] > 0.9999 and
                           bool(torch.allclose(a, tg, rtol=2e-2,
                                               atol=2e-3 * t_scale)))
                rec[f"grad_{gname}"] = g
                c_ok = c_ok and g["ok"]
            checks.append(dict(rec, ok=c_ok))
            ok = ok and c_ok
        plain_ms[name] = dict(fwd=float(np.median(t_fwd)),
                              bwd=float(np.median(t_bwd)))
    report(checks=checks, plain_ms=plain_ms,
           tolerance=dict(reward_rel=1e-5, queues_abs=1e-4,
                          grads="cos > 0.999, allclose(rtol 2e-2, atol "
                                "2e-3 * max|g_plain|), padded cells 0",
                          grads_vs_tangents="cos > 0.9999, allclose(rtol "
                                            "2e-2, atol 2e-3 * max|g|)",
                          sweep_saved_vs_replayed="bit-equal"),
           status="ok" if ok else "FAIL")
    if not ok:
        raise SystemExit("k4_vs_plain failed")
    return dict(fwd_err=fwd_err, bwd_err=bwd_err, tangent_err=tangent_err,
                plain_ms=plain_ms)


def check_k4_scan(env, fn):
    """K4 against the port's own soft scan episode (``env.episode(action,
    True)``, eager) at the macro preset, actions 0.3 and 0.7: reward rel
    2e-4, queues rtol 2e-3 atol 1e-5, action gradient rtol 1e-2 atol 1e-5
    (``tests/test_itscp_fused.py``). Raises on a failed check."""
    import torch

    plan, dev = fn.plan, env.device
    zero = torch.zeros((plan.L, plan.C), device=dev)
    d = env.data
    checks, ok = [], True
    for action in (0.3, 0.7):
        a_scan = torch.full((env.action_size(),), action, device=dev,
                            requires_grad=True)
        ref = env.episode(a_scan, True)
        (-ref.reward).backward()
        a_k4 = torch.full((plan.n_phases, plan.n_inter), action, device=dev,
                          requires_grad=True)
        reward, queues = fn(a_k4, d.schedule, d.mroute_next, d.mroute_prev,
                            zero, zero)
        (-reward).backward()
        torch.cuda.synchronize()
        r_k, r_s = float(reward.detach()), float(ref.reward.detach())
        q_k, q_s = queues.detach(), ref.queue_per_step.detach()
        g_k, g_s = a_k4.grad.flatten(), a_scan.grad
        rec = dict(action=action, reward_k4=r_k, reward_scan=r_s,
                   reward_rel_err=abs(r_k - r_s) / abs(r_s),
                   queues_max_abs_err=float((q_k - q_s).abs().max()),
                   grad_max_abs_err=float((g_k - g_s).abs().max()),
                   grad_max_abs_ref=float(g_s.abs().max()))
        rec["ok"] = (abs(r_k - r_s) <= max(2e-4 * abs(r_s), 2e-4) and
                     bool(torch.allclose(q_k, q_s, rtol=2e-3,
                                         atol=1e-5)) and
                     bool(torch.isfinite(g_k).all()) and
                     bool(torch.allclose(g_k, g_s, rtol=1e-2, atol=1e-5)))
        checks.append(rec)
        ok = ok and rec["ok"]
    report(checks=checks, tolerance=dict(
        reward_rel=2e-4, queues="rtol 2e-3, atol 1e-5",
        action_grad="rtol 1e-2, atol 1e-5"), status="ok" if ok else "FAIL")
    if not ok:
        raise SystemExit("k4_vs_scan failed")


def check_k4_k1(env, fn):
    """K4 against K1's soft forward on the same all-macro scene (the 3x3
    preset in macro mode) and action, from the empty state K1 starts from:
    reward rel 2e-4, queues rtol 2e-3 atol 1e-5. Raises on a failed
    check."""
    import torch

    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

    plan, dev = fn.plan, env.device
    p1 = env.fused_plan(True)
    zero = torch.zeros((plan.L, plan.C), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rand = env.draw_rand(gen)
    d = env.data
    checks, ok = [], True
    for action in (0.3, 0.7):
        a = torch.full((plan.n_phases, plan.n_inter), action, device=dev)
        r4, q4 = fn(a, d.schedule, d.mroute_next, d.mroute_prev, zero, zero)
        r1, q1, _ = k1.itscp_hybrid_episode_fwd(
            p1, a, d.schedule, d.mroute_next, d.mroute_prev, rand,
            d.inj_routes, env.base_state.route_pool)
        torch.cuda.synchronize()
        rec = dict(action=action, reward_k4=float(r4), reward_k1=float(r1),
                   reward_rel_err=abs(float(r4) - float(r1)) /
                   abs(float(r1)),
                   queues_max_abs_err=float((q4 - q1).abs().max()))
        rec["ok"] = (rec["reward_rel_err"] <= 2e-4 and
                     bool(torch.allclose(q4, q1, rtol=2e-3, atol=1e-5)))
        checks.append(rec)
        ok = ok and rec["ok"]
    report(checks=checks, L=plan.L, C=plan.C, T=plan.T,
           tolerance=dict(reward_rel=2e-4, queues="rtol 2e-3, atol 1e-5"),
           status="ok" if ok else "FAIL")
    if not ok:
        raise SystemExit("k4_vs_k1 failed")


def run_k4_train(env, fn) -> dict:
    """The caller: a seeded controller (256, 256) takes 3 Adam steps at lr
    1e-4 on the macro preset, each on a fresh scenario (seeds 3, 4, 5):
    observation -> controller -> squash -> K4 from the empty state ->
    -reward -> backward. K4's launches, counted from 0 here, must be 3
    forward and 3 reverse sweeps (the C launcher's grid is one block), and
    no forward-mode blocks. Raises on a failed check."""
    import torch

    from dhts_torch.apps.control.controller import (init_controller,
                                                     squash_action)
    from dhts_torch.ops.cuda import itscp_macro_episode as k4

    plan, dev = fn.plan, env.device
    model = init_controller(torch.Generator().manual_seed(3),
                            env.observation_size(), env.action_size(),
                            (256, 256), device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    before = [x.detach().clone() for x in model.parameters()]
    low, high = env.action_bounds()
    zero = torch.zeros((plan.L, plan.C), device=dev)
    k4.macro_episode_fwd.launches = 0
    k4.macro_episode_bwd.launches = 0
    k4.macro_episode_tangents.launches = 0
    losses = []
    for seed in (3, 4, 5):
        obs = torch.as_tensor(env.reset(seed), device=dev)
        action = squash_action(model(obs), low, high)
        d = env.data
        reward, _ = fn(action.reshape(plan.n_phases, plan.n_inter),
                       d.schedule, d.mroute_next, d.mroute_prev, zero, zero)
        loss = -reward
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    launches = dict(fwd=k4.macro_episode_fwd.launches,
                    bwd=k4.macro_episode_bwd.launches,
                    tangents=k4.macro_episode_tangents.launches)
    expected = dict(fwd=3, bwd=3, tangents=0)
    changed = any(not torch.equal(a, b.detach()) for a, b in
                  zip(before, model.parameters()))
    ok = (launches == expected and changed and
          all(math.isfinite(x) for x in losses))
    report(losses=losses, params_changed=changed, launches=launches,
           expected_launches=expected, status="ok" if ok else "FAIL")
    if not ok:
        raise SystemExit("k4_train failed")
    return launches


def time_k4(scenes, plain_ms) -> dict:
    """K4's launches at both scenes from the empty state: the forward, the
    forward saving the trajectory, the reverse sweep over it (the action
    alone and all three gradients: the same launch) and replaying it, and
    the forward-mode derivative with the action alone and with all three
    gradients; ms per launch (CUDA events, median of 5 runs of 20 launches
    back to back, after two warm-up launches), each with its bound; the
    plain version's ms from the k4_vs_plain runs. Timing launches are not
    the main path's: the counters are restored."""
    import torch

    from dhts_torch.ops.cuda import itscp_macro_episode as k4

    counters = (k4.macro_episode_fwd, k4.macro_episode_bwd,
                k4.macro_episode_tangents)
    saved = [(f.launches, getattr(f, "blocks", 0)) for f in counters]
    ms, bounds, smem, lane_threads = {}, {}, {}, {}
    lib = k4._library()
    action = (True, False, False)
    for name, (env, fn) in scenes.items():
        plan = fn.plan
        ins = k4_inputs(env, plan, 0.5, False)
        w = torch.full((plan.T,), -1.0, device=env.device)
        traj = k4.macro_episode_fwd(plan, *ins, trajectory=True)[2]
        runs = {"fwd": lambda: k4.macro_episode_fwd(plan, *ins),
                "fwd_save": lambda: k4.macro_episode_fwd(
                    plan, *ins, trajectory=True),
                "bwd_action": lambda: k4.macro_episode_bwd(
                    plan, w, *ins, needs=action, traj=traj),
                "bwd_all": lambda: k4.macro_episode_bwd(plan, w, *ins,
                                                        traj=traj),
                "bwd_replay": lambda: k4.macro_episode_bwd(plan, w, *ins),
                "tangents_action": lambda: k4.macro_episode_tangents(
                    plan, w, *ins, needs=action),
                "tangents_all": lambda: k4.macro_episode_tangents(
                    plan, w, *ins)}
        for fn_run in runs.values():
            fn_run()
            fn_run()
        torch.cuda.synchronize()
        ms[name] = {k: cuda_ms(f, 5, launches=20) for k, f in runs.items()}
        # bytes: each input read once (the six inputs and the scene's
        # tables), each output written once (the trajectory too where the
        # forward saves it, and read once by the sweep over it);
        # operations: the Riemann solves (num_cell + 1 per lane) and cell
        # updates of the valid cells, T steps, 3x for one vector-Jacobian
        # product (whichever gradients it returns; the replay's forward once
        # more)
        n_valid, L, C, T = int(plan.cells.numel()), plan.L, plan.C, plan.T
        ops = T * ((n_valid + L) * OPS_PER_INTERFACE + n_valid * OPS_PER_CELL)
        in_bytes = sum(x.numel() * x.element_size() for x in
                       (*ins, plan.prog, plan.lane_i, plan.lane_f))
        na = plan.n_action * 4
        traj_bytes = (2 * L * C + 1) * T * 4
        grads = na + 2 * L * C * 4
        work = {"fwd": (in_bytes + (1 + T) * 4, ops),
                "fwd_save": (in_bytes + (1 + T) * 4 + traj_bytes, ops),
                "bwd_action": (in_bytes + T * 4 + traj_bytes + grads,
                               ops * VJP_OPS_MULTIPLE),
                "bwd_all": (in_bytes + T * 4 + traj_bytes + grads,
                            ops * VJP_OPS_MULTIPLE),
                "bwd_replay": (in_bytes + T * 4 + grads,
                               ops * (VJP_OPS_MULTIPLE + 1)),
                "tangents_action": (in_bytes + T * 4 + na,
                                    ops * VJP_OPS_MULTIPLE),
                "tangents_all": (in_bytes + T * 4 + n_valid * 4 + na +
                                 2 * L * C * 4, ops * VJP_OPS_MULTIPLE)}
        bounds[name] = {k: bound_of(*v) for k, v in work.items()}
        kids = (("fwd", k4.KERNEL_FWD), ("tangents", k4.KERNEL_TANGENTS),
                ("bwd", k4.KERNEL_REVERSE))
        smem[name] = {k: lib.itscp_macro_episode_smem(L, C, kid)
                      for k, kid in kids}
        lane_threads[name] = {k: k4.lane_threads(lib, plan, kid)
                              for k, kid in kids}
    for f, (n, b) in zip(counters, saved):
        f.launches = n
        if hasattr(f, "blocks"):
            f.blocks = b
    return dict(ms=ms, bounds=bounds, plain_ms=plain_ms, library_ms=None,
                smem_bytes=smem, lane_threads=lane_threads,
                blocks={n: dict(fwd=1, fwd_save=1, bwd_action=1, bwd_all=1,
                                bwd_replay=1,
                                tangents_action=fn.plan.n_action,
                                tangents_all=fn.plan.n_action +
                                2 * int(fn.plan.cells.numel()))
                        for n, (_, fn) in scenes.items()},
                ms_over_bound={n: {k: ms[n][k] / bounds[n][k]["bound_ms"]
                                   for k in ms[n]} for n in ms})


# ---------------------------------------------------------------------------
# slice 8: K1 runs B episodes per launch (the scenario batch, the packed
# Trainer), and the lane-sharded step on a scene of more than 1,024 lanes
# ---------------------------------------------------------------------------

K1_BATCH = 4  # scenarios of k1_batch_vs_single and packed_train
K1_TIMING_BATCHES = (1, 2, 4, 8, 32)
# the 9x9 hybrid scene (1,296 lanes) on the preset's lanes and signals, at a
# short horizon (policy_length 2: T = 60 steps, 81 actions)
SHARD9 = dict(PRESET, num_intersection=9, policy_length=2, random_seed=3)
SHARD9_CHECK_EVERY = 20


def batch_env(dev):
    """The 3x3 preset after ``reset_batch(K1_BATCH, seed=3)`` (problem 1)."""
    from dhts_torch.apps.control.itscp import problem
    from dhts_torch.apps.control.itscp.env import ItscpEnv

    env = ItscpEnv(config=dict(PRESET, random_seed=3),
                   schedule_fn=problem.problem_1, device=dev)
    env.reset_batch(K1_BATCH, seed=3)
    return env


def k1_batch_inputs(env, B: int, seed: int, scenarios: bool = True):
    """K1's inputs for B episodes of the preset: episode e takes scenario
    e % K1_BATCH of ``env.batch_data`` (``scenarios``), or every episode
    the last reset's scene data and one action (stride 0); B seeded
    actions (scenarios) and B seeded draws."""
    import torch

    dev = env.device
    n_inter = env.action_size() // env.n_phases
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rand = torch.stack([env.draw_rand(gen) for _ in range(B)])
    if not scenarios:
        d = env.data
        action = torch.as_tensor(rng.uniform(0.3, 0.7, (env.n_phases,
                                                        n_inter)),
                                 dtype=torch.float32, device=dev)
        return (action, d.schedule, d.mroute_next, d.mroute_prev, rand,
                d.inj_routes, env.base_state.route_pool)
    bd = env.batch_data
    idx = torch.arange(B, device=dev) % bd.schedule.shape[0]
    action = torch.as_tensor(rng.uniform(0.3, 0.7, (B, env.n_phases,
                                                    n_inter)),
                             dtype=torch.float32, device=dev)
    return (action, bd.schedule[idx].contiguous(),
            bd.mroute_next[idx].contiguous(),
            bd.mroute_prev[idx].contiguous(), rand,
            bd.inj_routes[idx].contiguous(), env.base_state.route_pool)


def k1_row(plan, inputs, e: int):
    """Episode e's inputs of a batch, as a launch of one episode takes
    them."""
    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

    return tuple((x[e] if x.dim() == len(shape) + 1 else x).contiguous()
                 for x, (shape, _) in zip(inputs, k1._rows(plan)))


def k1_batch_weights(B: int, T: int, dev):
    """Seeded loss weights ``[B, T]`` of a batched backward, one row per
    episode."""
    import torch

    return torch.as_tensor(np.random.default_rng(6).uniform(
        -1.0, 1.0, (B, T)), dtype=torch.float32, device=dev)


# K1's and K4's plain episodes run in the gloo ranks of both groups
# (PLAIN_WORKERS processes; job i goes to worker i % PLAIN_WORKERS), on the
# card, while this process goes on with the phases that follow; each job is
# one episode's forward or backward
PLAIN_WORKERS = SHARDS + 2
_rank_envs = {}


def k1_plain_job(gate_mode, differentiable: bool, inputs, w=None) -> dict:
    """One episode of K1's plain version for a rank: the preset's plan in
    ``gate_mode`` (None: the preset's own), the inputs, the backward's loss
    weights ``[T]`` (None: the forward)."""
    return dict(kind="k1", gate_mode=gate_mode,
                differentiable=differentiable,
                inputs=tuple(x.cpu() for x in inputs),
                w=None if w is None else w.cpu())


def _plain_rank(rank, S, jobs, first):
    """This rank's jobs (worker ``first + rank``) on the card: each one's
    outputs on the CPU and its ms, by job index."""
    import torch

    from dhts_torch.apps.control.itscp import problem
    from dhts_torch.apps.control.itscp.env import ItscpEnv
    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

    dev, out = torch.device("cuda"), {}
    for i, job in enumerate(jobs):
        if i % PLAIN_WORKERS != first + rank:
            continue
        if job["kind"] == "k4":
            key = ("k4", job["scene"])
            if key not in _rank_envs:
                _rank_envs[key] = k4_scene(K4_SCENES[job["scene"]], dev)
            out[i] = k4_plain_run(_rank_envs[key][1].plan,
                                  [x.to(dev) for x in job["inputs"]],
                                  job["w"].to(dev))
            continue
        mode = job["gate_mode"]
        if job.get("grid"):  # slice 17's wide grids, T = 150 or 600
            key = ("wide", job["grid"], job["policy"])
            if key not in _rank_envs:
                _rank_envs[key] = wide_env(job["grid"], job["policy"], dev)
            plan = wide_plan(_rank_envs[key], mode or "hard")
        else:
            if mode not in _rank_envs:
                cfg = dict(PRESET, random_seed=3)
                if mode is not None:
                    cfg["gate_mode"] = mode
                _rank_envs[mode] = ItscpEnv(config=cfg, device=dev,
                                            schedule_fn=problem.problem_1)
                _rank_envs[mode].reset()
            plan = _rank_envs[mode].fused_plan(job["differentiable"])
        ins = [x.to(dev) for x in job["inputs"]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if job["w"] is None:
            with torch.no_grad():
                res = k1.plain_episode(plan, *ins)
        else:
            res = (k1.plain_episode_bwd(plan, job["w"].to(dev), *ins),)
        torch.cuda.synchronize()
        out[i] = (tuple(x.cpu() for x in res),
                  (time.perf_counter() - t0) * 1e3)
    return out


def submit_plain(ranks: dict, jobs: dict):
    """Start ``jobs`` (name -> :func:`k1_plain_job` or :func:`k4_plain_job`,
    the longest first) in the ranks of ``ranks`` (S -> LocalRanks);
    :func:`collect_plain` waits for them."""
    first, calls = 0, []
    for S, r in sorted(ranks.items(), reverse=True):
        calls.append((r, r.submit(_plain_rank, (list(jobs.values()),
                                                first))))
        first += S
    return list(jobs), calls


def collect_plain(submitted) -> dict:
    """The jobs' results, name -> (outputs, ms)."""
    names, calls = submitted
    out = {}
    for r, call in calls:
        for part in r.result(call):
            out.update(part)
    return {name: out[i] for i, name in enumerate(names)}


def check_k1_batch_plain(env, ins, w, plain) -> dict:
    """``k1_batch_vs_plain``: one launch of the K1_BATCH scenarios, hard
    and soft forward and the backward, against the plain version's
    episodes from the ranks (``plain``, :func:`collect_plain`), with the
    single launches' tolerances; returns each launch's largest abs error
    and the plain version's ms (its episodes' sum); raises on a failure."""
    import torch

    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

    kfn, kfn_bwd = k1.itscp_hybrid_episode_fwd, k1.itscp_hybrid_episode_bwd
    hard, soft = env.fused_plan(False), env.fused_plan(True)
    recs, err, ms, ok = [], {}, {}, True
    for key, plan in (("fwd", hard), ("fwd_soft", soft)):
        r, q, ev = (x.cpu() for x in kfn(plan, *ins))
        err[key], ms[key], emitted = 0.0, 0.0, 0.0
        for e in range(K1_BATCH):
            (pr, pq, pe), t = plain[f"batch_{key}_{e}"]
            rel = abs(float(r[e]) - float(pr)) / max(abs(float(pr)), 1e-30)
            q_err = float((q[e] - pq).abs().max())
            err[key] = max(err[key], q_err, abs(float(r[e]) - float(pr)))
            ms[key] += t
            emitted += float(pe[:, 1].sum())
            rec = dict(launch=key, episode=e,
                       events_equal=bool(torch.equal(ev[e], pe)),
                       reward_kernel=float(r[e]), reward_plain=float(pr),
                       reward_rel_err=rel, queues_max_abs_err=q_err,
                       plain_ms=t)
            recs.append(rec)
            ok = ok and rec["events_equal"] and rel <= 1e-4 and q_err <= 1e-4
        ok = ok and emitted >= 1
    g = kfn_bwd(soft, w, *ins).cpu()
    err["bwd"], ms["bwd"] = 0.0, 0.0
    for e in range(K1_BATCH):
        (gp,), t = plain[f"batch_bwd_{e}"]
        got, ref = g[e].double().flatten(), gp.double().flatten()
        abs_err = float((got - ref).abs().max())
        err["bwd"] = max(err["bwd"], abs_err)
        ms["bwd"] += t
        rec = dict(launch="bwd", episode=e, cos=cosine(got, ref),
                   max_abs_err=abs_err, max_abs_ref=float(ref.abs().max()),
                   finite=bool(torch.isfinite(got).all()),
                   norm=float(got.norm()), plain_ms=t)
        recs.append(rec)
        close = bool(torch.allclose(got, ref, rtol=2e-2,
                                    atol=2e-3 * float(ref.abs().max())))
        ok = (ok and rec["cos"] > 0.999 and close and rec["finite"] and
              rec["norm"] > 0)
    report(B=K1_BATCH, checks=recs, plain_ms=ms, max_abs_err=err,
           tolerance=dict(events="exact", reward_rel=1e-4, queues_abs=1e-4,
                          gradient=dict(cos=0.999, rtol=2e-2,
                                        atol="2e-3 * max|g_plain|")),
           status="ok" if ok else "FAIL")
    if not ok:
        raise SystemExit("k1_batch_vs_plain failed")
    return dict(err=err, plain_ms=ms)


def check_k1_batch(env) -> dict:
    """``k1_batch_vs_single``: one launch of K1_BATCH episodes against as
    many launches of one episode, hard and soft forward and the backward,
    for the scenarios of ``env`` and for draws of one scene; raises on a
    difference."""
    import torch

    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

    kfn, kfn_bwd = k1.itscp_hybrid_episode_fwd, k1.itscp_hybrid_episode_bwd
    hard, soft = env.fused_plan(False), env.fused_plan(True)
    B, T = K1_BATCH, hard.T
    recs, ok, err = [], True, {"fwd": 0.0, "fwd_soft": 0.0, "bwd": 0.0}
    for scenarios in (True, False):
        ins = k1_batch_inputs(env, B, 5, scenarios)
        strides = k1.episode_rows(hard, ins, B)[1]
        w = k1_batch_weights(B, T, env.device)
        rec = dict(batch="scenarios" if scenarios else "draws",
                   episode_strides=strides)
        for key, plan in (("fwd", hard), ("fwd_soft", soft)):
            r, q, ev = kfn(plan, *ins)
            singles = [kfn(plan, *k1_row(plan, ins, e)) for e in range(B)]
            equal = all(torch.equal(r[e], s[0]) and torch.equal(q[e], s[1])
                        and torch.equal(ev[e], s[2])
                        for e, s in enumerate(singles))
            diff = max(float((q[e] - s[1]).abs().max()) for e, s in
                       enumerate(singles))
            err[key] = max(err[key], diff)
            tot = ev[..., :3].sum((0, 1)).tolist()
            # the preset's open boundaries are macro lanes: its episodes
            # read no draw, so one scene's draws give equal episodes
            rec[key] = dict(bit_equal=equal, rewards=r.tolist(),
                            distinct_rewards=len(set(r.tolist())),
                            injected=tot[0], emitted=tot[1],
                            absorbed=tot[2], queues_max_abs_err=diff)
            ok = ok and equal and (tot[1] > 0 or not scenarios)
        g = kfn_bwd(soft, w, *ins)
        singles = [kfn_bwd(soft, w[e].contiguous(), *k1_row(soft, ins, e))
                   for e in range(B)]
        equal = all(torch.equal(g[e], s) for e, s in enumerate(singles))
        diff = max(float((g[e] - s).abs().max()) for e, s in
                   enumerate(singles))
        err["bwd"] = max(err["bwd"], diff)
        finite = bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
        rec["bwd"] = dict(bit_equal=equal, max_abs_err=diff, finite=finite,
                          norm=float(g.norm()))
        ok = ok and equal and finite
        recs.append(rec)
    report(B=B, T=T, L=hard.L, checks=recs,
           tolerance="reward, queues, events[T, 8] and gradients bit-equal "
                     "to single launches",
           status="ok" if ok else "FAIL")
    if not ok:
        raise SystemExit("k1_batch_vs_single failed")
    return err


def run_packed_train(env, log_root: str) -> dict:
    """``packed_train``: ``Trainer(multi_scenario=True, packed=True)`` on
    the scenarios of ``env``, three steps and one evaluation, K1's
    launches counted from 0 in this phase; raises on a failed check."""
    import torch

    from dhts_torch.apps.control.trainer import Trainer
    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

    kfn, kfn_bwd = k1.itscp_hybrid_episode_fwd, k1.itscp_hybrid_episode_bwd
    dev, B = env.device, K1_BATCH
    trainer = Trainer(env, lr=1e-4, seed=3, multi_scenario=True, packed=True)
    before = [x.detach().clone() for x in trainer.model.parameters()]
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    rands = [torch.stack([env.draw_rand(gen) for _ in range(B)])
             for _ in range(3)]
    # the first loss from four single soft launches at the first actions
    plan, bd = env.fused_plan(True), env.batch_data
    with torch.no_grad():
        actions = trainer.action().reshape(B, env.n_phases, -1)
        ref = -torch.mean(torch.stack([kfn(
            plan, actions[e].contiguous(), bd.schedule[e],
            bd.mroute_next[e], bd.mroute_prev[e], rands[0][e],
            bd.inj_routes[e], env.base_state.route_pool)[0]
            for e in range(B)]))
    kfn.launches.update(dict.fromkeys(kfn.launches, 0))
    kfn_bwd.launches = 0
    losses, per_step = [], []
    for r in rands:
        f0, b0 = kfn.launches[k1.SOFT], kfn_bwd.launches
        losses.append(trainer.train_step(rand=r))
        per_step.append((kfn.launches[k1.SOFT] - f0, kfn_bwd.launches - b0))
    eval_reward = trainer.evaluate(3, 1, log_root, False)
    torch.cuda.synchronize()
    launches = dict(fwd_soft=kfn.launches[k1.SOFT] + kfn.launches[k1.ST],
                    bwd=kfn_bwd.launches, fwd=kfn.launches[k1.HARD])
    changed = any(not torch.equal(a, b.detach()) for a, b in
                  zip(before, trainer.model.parameters()))
    ok = (all(s == (1, 1) for s in per_step) and changed and
          all(math.isfinite(x) for x in losses) and
          losses[0] == float(ref) and math.isfinite(eval_reward) and
          launches == dict(fwd_soft=3, bwd=3, fwd=1))
    report(B=B, losses=losses, first_loss_from_singles=float(ref),
           eval_reward=eval_reward, params_changed=changed,
           launches_per_step=per_step, launches=launches,
           status="ok" if ok else "FAIL")
    if not ok:
        raise SystemExit("packed_train failed")
    return launches


def time_k1_batches(env) -> dict:
    """K1's hard, soft and backward ms per launch at each of
    K1_TIMING_BATCHES episodes (CUDA events, median of 5 after a warm-up),
    fwd+bwd episodes per second, and each launch's bound; the launches are
    not counted."""
    import torch

    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

    kfn, kfn_bwd = k1.itscp_hybrid_episode_fwd, k1.itscp_hybrid_episode_bwd
    counts = (dict(kfn.launches), kfn_bwd.launches)
    hard, soft = env.fused_plan(False), env.fused_plan(True)
    T, n_act = hard.T, hard.n_phases * hard.n_inter
    n_macro = int(env.spec.is_macro.sum())
    ops1 = T * n_macro * ((hard.C + 1) * OPS_PER_INTERFACE +
                          hard.C * OPS_PER_CELL)
    tables = sum(x.numel() * x.element_size() for x in
                 (hard.prog, hard.lane_i, hard.lane_f))
    ms, bounds, eps = {}, {}, {}
    for B in K1_TIMING_BATCHES:
        ins = k1_batch_inputs(env, B, 100 + B)
        w = torch.full((B, T), -1.0, device=env.device)
        runs = {"fwd": lambda: kfn(hard, *ins),
                "fwd_soft": lambda: kfn(soft, *ins),
                "bwd": lambda: kfn_bwd(soft, w, *ins)}
        for fn in runs.values():
            fn()
        torch.cuda.synchronize()
        for key, fn in runs.items():
            ms.setdefault(key, {})[B] = cuda_ms(fn, 5)
        in_bytes = tables + sum(x.numel() * x.element_size() for x in ins)
        out_bytes = B * (1 + T + 8 * T) * 4
        work = {"fwd": (in_bytes + out_bytes, B * ops1),
                "fwd_soft": (in_bytes + out_bytes, B * ops1),
                "bwd": (in_bytes + 4 * B * T + 4 * B * n_act,
                        B * ops1 * VJP_OPS_MULTIPLE)}
        for key, (nbytes, nops) in work.items():
            bounds.setdefault(key, {})[B] = bound_of(nbytes, nops)
        eps[B] = B * 1e3 / (ms["fwd_soft"][B] + ms["bwd"][B])
    kfn.launches.update(counts[0])
    kfn_bwd.launches = counts[1]
    return dict(ms=ms, bounds=bounds, fwd_bwd_episodes_per_s=eps,
                ms_per_episode={k: {B: v / B for B, v in m.items()}
                                for k, m in ms.items()})


def shard9_env(dev):
    from dhts_torch.apps.control.itscp import problem
    from dhts_torch.apps.control.itscp.env import ItscpEnv

    env = ItscpEnv(config=SHARD9, schedule_fn=problem.problem_1, device=dev)
    env.reset(3)
    return env


def _shard9_rank(rank, S, check_every):
    """One rank of ``shard9_vs_plain``: the sharded forward of the 9x9
    scene, hard and soft, B = 1, every ``check_every``-th step's launches
    held against the plain bodies on the card; returns the episodes."""
    import torch

    from dhts_torch.ops.cuda import itscp_spatial_shard as ks
    from dhts_torch.ops.cuda import itscp_spatial_step as k6

    env = shard9_env(torch.device("cuda"))
    out = {"checks": [], "errors": {}}
    for differentiable in (False, True):
        plan = k6.make_plan(env, differentiable)
        comm = _lane_comm(plan, S, rank)
        ins = spatial_inputs(env, 1, 101, np.full(env.action_size(), 0.55))
        run = ks.ShardRun(plan, comm, ins, dual=False)
        t0 = time.perf_counter()
        for t in range(plan.T):
            if t % check_every == 0:
                for body, e in run.checked_step(t, 1e-6, 1e-6).items():
                    out["errors"][body] = max(out["errors"].get(body, 0.0), e)
            else:
                run.step(t)
        q, ev, w = run.outputs()
        torch.cuda.synchronize()
        out["checks"].append(dict(
            mode="soft" if differentiable else "hard", L=plan.L,
            lanes_per_shard=comm.shards[0].n, T=plan.T,
            seconds=time.perf_counter() - t0,
            episode=(q.cpu(), ev.cpu(), w.cpu())))
    return out


def check_shard9(ranks) -> dict:
    """``shard9_vs_plain``: the 9x9 scene on the S = 4 ranks of ``ranks``,
    every launch of every SHARD9_CHECK_EVERY-th step against its plain
    body, and each episode against the plain single-shard episode on the
    card, run here while the ranks work; raises on a failure."""
    import torch

    from dhts_torch.ops.cuda import itscp_spatial_step as k6

    submitted = ranks.submit(_shard9_rank, (SHARD9_CHECK_EVERY,))
    env = shard9_env(torch.device("cuda"))
    ins = spatial_inputs(env, 1, 101, np.full(env.action_size(), 0.55))
    t0 = time.perf_counter()
    refs = [tuple(x.cpu() for x in k6.plain_spatial_episode(
        k6.make_plan(env, d), *ins)) for d in (False, True)]
    plain_seconds = time.perf_counter() - t0
    outs = ranks.result(submitted)
    recs, errors, ok = [], {}, env.spec.num_lanes == 1296
    for rank, o in enumerate(outs):
        for body, e in o["errors"].items():
            errors[body] = max(errors.get(body, 0.0), e)
        for rec, (qs, evs, ws) in zip(o["checks"], refs):
            q, ev, w = rec.pop("episode")
            rec.update(events_equal=bool(torch.equal(ev, evs)),
                       queues_equal=bool(torch.equal(q, qs)),
                       waves_equal=bool(torch.equal(w, ws)),
                       reward=float(-q.sum()), reward_plain=float(-qs.sum()),
                       queues_max_abs_err=float((q - qs).abs().max()))
            ok = (ok and rec["events_equal"] and rec["queues_equal"] and
                  rec["waves_equal"])
            if rank == 0:
                recs.append(rec)
    report(checks=recs, per_launch_max_abs_err=errors, ranks=SHARDS,
           plain_episodes_seconds=plain_seconds,
           tolerance=dict(per_launch="integers equal, floats allclose(rtol "
                                     "1e-6, atol 1e-6), every 20th step",
                          vs_plain="events, queues, waves bit-equal to the "
                                   "plain single-shard episode"),
           status="ok" if ok else "FAIL")
    if not ok:
        raise SystemExit("shard9_vs_plain failed")
    return errors


# Slice 17: K1 on the hybrid grids of run_itscp_5x5.sh's flags (lane length
# 5, 60 m/s, 30 Hz, signal length 4, problem 1), 5x5, 7x7 and 9x9 (400,
# 784, 1,296 lanes), wider than one block's shared memory or threads.
WIDE_GRIDS = (5, 7, 9)
WIDE = dict(num_lane=1, lane_length=5, speed_limit=60, signal_length=4,
            simulation_frequency=30, mode="hybrid", use_fused_episode=True,
            random_seed=3)
# the checks' episodes: policy_length 5, T = 150, where every grid emits
# vehicles (at T = 60 none has an event yet); the timing's and the
# training's: the script's T = 600
WIDE_CHECK_POLICY = 5
WIDE_POLICY = 20
# what k1_wide_vs_plain holds against the plain version, by grid
WIDE_FWD_MODES = {5: ("hard", "soft", "st"), 7: ("hard", "soft"),
                  9: ("hard", "soft", "st")}
WIDE_BWD_MODES = {5: ("soft", "st"), 7: ("soft",), 9: ("soft", "st")}
# the layouts make_plan picks: (lanes a thread, (forward, backward))
WIDE_LAYOUTS = {5: (1, ("shared", "global")), 7: (1, ("global", "global")),
                9: (2, ("global", "global"))}
WIDE_BATCH = 4  # 5x5 episodes of one launch against single launches
# the main path's own launches, held against the plain version at its T =
# 600 on the timing's inputs: train_5x5's (5x5: the soft forward and the
# backward, the evaluations' hard forward) and serve_train_wide's (7x7
# and 9x9: the hard episode, the Trainer step's soft forward and backward)
WIDE_MAIN_FWD = ("hard", "soft")
WIDE_MAIN_BWD = ("soft",)
WIDE_TIMING_SEED = 5


def wide_env(n: int, policy_length: int, dev):
    """The n x n grid at ``run_itscp_5x5.sh``'s flags, reset (seed 3)."""
    from dhts_torch.apps.control.itscp import problem
    from dhts_torch.apps.control.itscp.env import ItscpEnv

    env = ItscpEnv(config=dict(WIDE, num_intersection=n,
                               policy_length=policy_length),
                   schedule_fn=problem.problem_1, device=dev)
    env.reset()
    return env


def wide_plan(env, mode: str):
    """K1's plan of ``env`` in gate mode ``mode`` (hard, soft or st)."""
    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

    p = env.fused_plan(mode != "hard")
    if mode != "st":
        return p
    return k1.make_plan(env.spec, env.meta, dict(env.config, gate_mode="st"),
                        p.V, p.R, p.P, p.P2, window=p.W, differentiable=True)


def wide_inputs(env, seed: int):
    """K1's inputs of one episode of ``env``: a seeded action in [0.3,
    0.7] and a seeded draw."""
    import torch

    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)
    action = torch.as_tensor(np.random.default_rng(seed).uniform(
        0.3, 0.7, (env.n_phases, env.action_size() // env.n_phases)),
        dtype=torch.float32, device=env.device)
    return (action, env.data.schedule, env.data.mroute_next,
            env.data.mroute_prev, env.draw_rand(gen), env.data.inj_routes,
            env.base_state.route_pool)


def wide_weights(T: int, dev):
    """The backward's seeded loss weights ``[T]``."""
    import torch

    return torch.as_tensor(np.random.default_rng(0).uniform(-1.0, 1.0, T),
                           dtype=torch.float32, device=dev)


def wide_plain_jobs(envs, long_envs) -> dict:
    """The plain episodes ``k1_wide_vs_plain`` holds K1 against, as jobs
    for the gloo ranks, the longest first: the main path's at T = 600
    (``long_envs``, the timing's inputs), then T = 150's (``envs``)."""
    jobs = {}
    for n in WIDE_GRIDS[::-1]:
        env = long_envs[n]
        for mode in WIDE_MAIN_BWD:
            jobs[f"wide{n}_T600_bwd_{mode}"] = dict(
                k1_plain_job(mode, True, wide_inputs(env, WIDE_TIMING_SEED),
                             wide_weights(env.num_timestep, env.device)),
                grid=n, policy=WIDE_POLICY)
    for n in WIDE_GRIDS:
        for mode in WIDE_MAIN_FWD:
            jobs[f"wide{n}_T600_fwd_{mode}"] = dict(
                k1_plain_job(mode, mode != "hard",
                             wide_inputs(long_envs[n], WIDE_TIMING_SEED)),
                grid=n, policy=WIDE_POLICY)
    for n in WIDE_GRIDS[::-1]:
        env = envs[n]
        for mode in WIDE_BWD_MODES[n]:
            jobs[f"wide{n}_bwd_{mode}"] = dict(
                k1_plain_job(mode, True, wide_inputs(env, 4),
                             wide_weights(env.num_timestep, env.device)),
                grid=n, policy=WIDE_CHECK_POLICY)
    for n in WIDE_GRIDS:
        for mode in WIDE_FWD_MODES[n]:
            jobs[f"wide{n}_fwd_{mode}"] = dict(
                k1_plain_job(mode, mode != "hard",
                             wide_inputs(envs[n], 3)),
                grid=n, policy=WIDE_CHECK_POLICY)
    return jobs


def check_k1_wide(envs, long_envs, plain) -> dict:
    """``k1_wide_vs_plain``: on each grid K1's forward against the plain
    version (events equal, reward rel 1e-5, queues abs 1e-4, vehicles
    emitted) and its backward against autograd of the plain version
    (cosine > 0.999, allclose(rtol 2e-2, atol 2e-3 * max|g|), finite,
    nonzero), in the layout make_plan picked: at T = 150 (``envs``) hard,
    soft and st; at the main path's T = 600 (``long_envs``, the timing's
    inputs) its launches, WIDE_MAIN_FWD and WIDE_MAIN_BWD; at 5x5 a launch
    of WIDE_BATCH episodes, hard, soft and the backward, bit-equal to
    single launches. The launches are not counted. Returns the largest
    errors and the plain version's ms by T; raises on a failure."""
    import torch

    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

    kfn, kfn_bwd = k1.itscp_hybrid_episode_fwd, k1.itscp_hybrid_episode_bwd
    counts = (dict(kfn.launches), kfn_bwd.launches)
    checks, ok = [], True
    errors = {T: {} for T in (150, 600)}
    plain_ms = {T: {} for T in (150, 600)}

    def forward(n, env, mode, seed, name):
        plan = wide_plan(env, mode)
        kr, kq, ke = (x.cpu() for x in kfn(plan, *wide_inputs(env, seed)))
        (pr, pq, pe), ms = plain[name]
        rel = abs(float(kr) - float(pr)) / max(abs(float(pr)), 1e-30)
        q_err = float((kq - pq).abs().max())
        key = "fwd" if mode == "hard" else "fwd_soft"
        err = errors[plan.T].setdefault(n, {})
        err[key] = max(err.get(key, 0.0), q_err, abs(float(kr) - float(pr)))
        plain_ms[plan.T].setdefault(n, {}).setdefault(key, ms)
        tot = pe[:, :7].sum(0).tolist()
        rec = dict(grid=f"{n}x{n}", gate_mode=mode, L=plan.L, T=plan.T,
                   lanes_per_thread=plan.lanes_per_thread,
                   placement=plan.placement[0], events_equal=bool(torch.equal(ke, pe)),
                   reward_kernel=float(kr), reward_plain=float(pr),
                   reward_rel_err=rel, queues_max_abs_err=q_err,
                   emitted=tot[1], transferred=tot[3],
                   plain_ms=ms, finite=bool(torch.isfinite(kq).all()))
        checks.append(rec)
        return (rec["events_equal"] and rel <= 1e-5 and q_err <= 1e-4 and
                tot[1] >= 1 and rec["finite"] and
                (plan.lanes_per_thread, plan.placement) == WIDE_LAYOUTS[n])

    def backward(n, env, mode, seed, name):
        plan = wide_plan(env, mode)
        w = wide_weights(env.num_timestep, env.device)
        got = kfn_bwd(plan, w, *wide_inputs(env, seed)).cpu().double()
        (ref,), ms = plain[name]
        got, ref = got.flatten(), ref.double().flatten()
        cos = float(got @ ref / (got.norm() * ref.norm()))
        abs_err = float((got - ref).abs().max())
        err = errors[plan.T].setdefault(n, {})
        err["bwd"] = max(err.get("bwd", 0.0), abs_err)
        plain_ms[plan.T].setdefault(n, {}).setdefault("bwd", ms)
        close = bool(torch.allclose(got, ref, rtol=2e-2,
                                    atol=2e-3 * float(ref.abs().max())))
        rec = dict(grid=f"{n}x{n}", gate_mode=mode, direction="bwd",
                   T=plan.T, lanes_per_thread=plan.lanes_per_thread,
                   placement=plan.placement[1], cos=cos,
                   max_abs_err=abs_err, max_abs_ref=float(ref.abs().max()),
                   plain_ms=ms, norm=float(got.norm()),
                   finite=bool(torch.isfinite(got).all()))
        checks.append(rec)
        return cos > 0.999 and close and rec["finite"] and rec["norm"] > 0

    for n in WIDE_GRIDS:
        for mode in WIDE_FWD_MODES[n]:
            ok = forward(n, envs[n], mode, 3, f"wide{n}_fwd_{mode}") and ok
        for mode in WIDE_BWD_MODES[n]:
            ok = backward(n, envs[n], mode, 4, f"wide{n}_bwd_{mode}") and ok
        for mode in WIDE_MAIN_FWD:
            ok = forward(n, long_envs[n], mode, WIDE_TIMING_SEED,
                         f"wide{n}_T600_fwd_{mode}") and ok
        for mode in WIDE_MAIN_BWD:
            ok = backward(n, long_envs[n], mode, WIDE_TIMING_SEED,
                          f"wide{n}_T600_bwd_{mode}") and ok
    # a launch of WIDE_BATCH 5x5 episodes against single launches
    env, B = envs[5], WIDE_BATCH
    rows = [wide_inputs(env, 10 + e) for e in range(B)]
    stacked = tuple(torch.stack([r[i] for r in rows]) if i in (0, 4)
                    else rows[0][i] for i in range(7))
    wb = torch.as_tensor(np.random.default_rng(1).uniform(
        -1.0, 1.0, (B, env.num_timestep)), dtype=torch.float32,
        device=env.device)
    batch_equal = {}
    for mode in ("hard", "soft", "bwd"):
        plan = wide_plan(env, "soft" if mode == "bwd" else mode)
        if mode == "bwd":
            batch = (kfn_bwd(plan, wb, *stacked),)
            singles = [(kfn_bwd(plan, wb[e].contiguous(), *rows[e]),)
                       for e in range(B)]
        else:
            batch = kfn(plan, *stacked)
            singles = [kfn(plan, *rows[e]) for e in range(B)]
        batch_equal[mode] = all(torch.equal(x[e], y)
                                for e in range(B)
                                for x, y in zip(batch, singles[e]))
        ok = ok and batch_equal[mode]
    kfn.launches.update(counts[0])
    kfn_bwd.launches = counts[1]
    report(checks=checks, batch_equal_to_single_launches=batch_equal,
           batch=B, errors_by_T=errors,
           tolerance=dict(events="exact", reward_rel=1e-5, queues_abs=1e-4,
                          cos=0.999, rtol=2e-2, atol="2e-3 * max|g_plain|",
                          batch="bit-equal"),
           status="ok" if ok else "FAIL")
    if not ok:
        raise SystemExit("k1_wide_vs_plain failed")
    return dict(errors=errors, plain_ms=plain_ms)


def run_train_5x5(log_root: str) -> tuple:
    """``train_5x5``: the training CLI with ``run_itscp_5x5.sh``'s flags,
    two Adam steps (``--n_episode 1``: the CLI trains one epoch more) with
    an evaluation each; K1's launches, counted from 0 here, one soft
    forward and one backward per step and one hard forward per
    evaluation, and no call of the plain version. Returns the launches.
    Raises on a failed check."""
    from dhts_torch.apps.control.itscp import run
    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

    argv = ["--mode", "hybrid", "--problem", "1", "--n_trial", "1",
            "--n_intersection", "5", "--n_lane", "1", "--lane_length", "5",
            "--speed_limit", "60", "--simulation_length", "20",
            "--signal_length", "4", "--n_episode", "1", "--lr", "1e-4",
            "--seed", "21", "--fused_episode", "--log_root", log_root]
    kfn, kfn_bwd = k1.itscp_hybrid_episode_fwd, k1.itscp_hybrid_episode_bwd
    plain_calls = {"plain_episode": 0, "plain_episode_bwd": 0}
    originals = {name: getattr(k1, name) for name in plain_calls}

    def counted(name):
        def call(*args, **kwargs):
            plain_calls[name] += 1
            return originals[name](*args, **kwargs)
        return call

    kfn.launches.update(dict.fromkeys(kfn.launches, 0))
    kfn_bwd.launches = 0
    for name in plain_calls:
        setattr(k1, name, counted(name))
    try:
        ((trainer, _),) = run.main(argv)
    finally:
        for name, fn in originals.items():
            setattr(k1, name, fn)
    launches = dict(fwd=kfn.launches[k1.HARD],
                    fwd_soft=kfn.launches[k1.SOFT] + kfn.launches[k1.ST],
                    bwd=kfn_bwd.launches)
    (metrics,) = Path(log_root).glob("hybrid_*/trial_0/metrics.jsonl")
    rows = [json.loads(x) for x in metrics.read_text().splitlines()]
    losses = [r["loss_train"] for r in rows if "loss_train" in r]
    evals = [r["reward_eval"] for r in rows if "reward_eval" in r]
    plan = trainer.env.fused_plan(True)
    expected = dict(fwd=len(evals), fwd_soft=len(losses), bwd=len(losses))
    ok = (len(losses) == 2 and len(evals) == 2 and launches == expected and
          not any(plain_calls.values()) and plan.L == 400 and
          all(math.isfinite(x) for x in losses + evals))
    report(argv=argv, losses=losses, eval_rewards=evals, launches=launches,
           expected_launches=expected, plain_calls=plain_calls, L=plan.L,
           T=plan.T, lanes_per_thread=plan.lanes_per_thread,
           placement=plan.placement, status="ok" if ok else "FAIL")
    if not ok:
        raise SystemExit("train_5x5 failed")
    return launches


def drive_wide(env) -> dict:
    """``serve_train_wide``'s drive of one grid (T = 600): a seeded
    controller's hard episode through ``env.episode``, then one Trainer
    step; K1's launches counted from 0 here: one each. Raises on a failed
    check."""
    import torch

    from dhts_torch.apps.control.controller import (init_controller,
                                                     squash_action)
    from dhts_torch.apps.control.trainer import Trainer
    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

    kfn, kfn_bwd = k1.itscp_hybrid_episode_fwd, k1.itscp_hybrid_episode_bwd
    kfn.launches.update(dict.fromkeys(kfn.launches, 0))
    kfn_bwd.launches = 0
    dev = env.device
    model = init_controller(torch.Generator().manual_seed(0),
                            env.observation_size(), env.action_size(),
                            device=dev)
    low, high = env.action_bounds()
    obs = env.reset(3)
    with torch.no_grad():
        action = squash_action(model(torch.as_tensor(obs, device=dev)),
                               low, high)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    res = env.episode(action, differentiable=False, generator=g)
    loss = Trainer(env, lr=1e-4, seed=3).train_step(1)
    torch.cuda.synchronize()
    launches = dict(fwd=kfn.launches[k1.HARD],
                    fwd_soft=kfn.launches[k1.SOFT] + kfn.launches[k1.ST],
                    bwd=kfn_bwd.launches)
    rec = dict(L=env.spec.num_lanes, T=env.num_timestep,
               reward=float(res.reward), emitted=int(res.emitted),
               loss=loss, launches=launches)
    if not (launches == dict(fwd=1, fwd_soft=1, bwd=1) and
            math.isfinite(loss) and bool(torch.isfinite(res.reward))):
        report(**rec, status="FAIL")
        raise SystemExit(f"serve_train_wide failed: {rec}")
    return rec


def time_k1_wide(envs) -> dict:
    """``k1_wide_timing``: K1's hard, soft and backward ms per launch on
    each grid at T = 600 (``envs``, the inputs k1_wide_vs_plain held
    there): CUDA events around 3 launches back to back, median of 5 after
    a warm-up; each launch's bound and layout. The launches are not
    counted."""
    import torch

    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

    kfn, kfn_bwd = k1.itscp_hybrid_episode_fwd, k1.itscp_hybrid_episode_bwd
    counts = (dict(kfn.launches), kfn_bwd.launches)
    ms, bounds, layout = {}, {}, {}
    for n in WIDE_GRIDS:
        env = envs[n]
        hard, soft = env.fused_plan(False), env.fused_plan(True)
        ins = wide_inputs(env, WIDE_TIMING_SEED)
        w = wide_weights(env.num_timestep, env.device)
        runs = {"fwd": lambda: kfn(hard, *ins),
                "fwd_soft": lambda: kfn(soft, *ins),
                "bwd": lambda: kfn_bwd(soft, w, *ins)}
        for fn in runs.values():
            fn()
        torch.cuda.synchronize()
        ms[n] = {key: cuda_ms(fn, 5, 3) for key, fn in runs.items()}
        T, n_act = hard.T, hard.n_phases * hard.n_inter
        in_bytes = sum(x.numel() * x.element_size() for x in
                       (*ins, hard.prog, hard.lane_i, hard.lane_f))
        out_bytes = (1 + T + 8 * T) * 4
        ops = T * int(env.spec.is_macro.sum()) * (
            (hard.C + 1) * OPS_PER_INTERFACE + hard.C * OPS_PER_CELL)
        bounds[n] = {"fwd": bound_of(in_bytes + out_bytes, ops),
                     "fwd_soft": bound_of(in_bytes + out_bytes, ops),
                     "bwd": bound_of(in_bytes + 4 * T + 4 * n_act,
                                     ops * VJP_OPS_MULTIPLE)}
        layout[n] = dict(L=hard.L, lanes_per_thread=soft.lanes_per_thread,
                         placement=dict(zip(("forward", "backward"),
                                            soft.placement)))
    kfn.launches.update(counts[0])
    kfn_bwd.launches = counts[1]
    return dict(ms=ms, bounds=bounds, layout=layout)


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

    # the gloo ranks of the slice-6 phases (4 and 2, sharing the card),
    # started now: they start up while the phases before them run and
    # then wait on their task queues, idle, without a CUDA context
    from dhts_torch.parallel.local_ranks import LocalRanks

    shard_ranks = {S: LocalRanks(S, RANK_SECONDS) for S in (SHARDS, 2)}

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

    # ---- 3. K1's and K4's plain episodes, submitted to the gloo ranks:
    # they run on the card while this process goes on, and phases 3-5,
    # k1_batch_vs_plain and k4_vs_plain hold the kernels against them
    phase("plain_submit")
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

    soft_env = {}
    for mode in ("soft", "st"):
        soft_env[mode] = ItscpEnv(
            config=dict(PRESET, random_seed=3, gate_mode=mode),
            schedule_fn=problem.problem_1, device=dev)
        soft_env[mode].reset()
    hard_inputs = {a: k1_inputs(torch.full((env.action_size(),), a,
                                           device=dev)) for a in (0.3, 0.7)}
    soft_inputs = k1_inputs(torch.full((env.action_size(),), 0.55,
                                       device=dev))
    rng = np.random.default_rng(1)
    bwd_inputs = k1_inputs(torch.as_tensor(
        rng.uniform(0.3, 0.7, env.action_size()), dtype=torch.float32,
        device=dev))
    w = torch.full((T,), -1.0, device=dev)  # d(reward)/d(queues)
    # the scenario batch of slice 8 and its plain episodes
    benv = batch_env(dev)
    bins = k1_batch_inputs(benv, K1_BATCH, 5)
    bw = torch.full((K1_BATCH, T), -1.0, device=dev)
    bplan = benv.fused_plan(False)
    # slice 17's wide grids at the checks' T = 150 and the main path's T =
    # 600 (the timing's too)
    wide_envs = {n: wide_env(n, WIDE_CHECK_POLICY, dev) for n in WIDE_GRIDS}
    long_envs = {n: wide_env(n, WIDE_POLICY, dev) for n in WIDE_GRIDS}
    jobs = wide_plain_jobs(wide_envs, long_envs)  # the longest first
    for mode in ("soft", "st"):
        jobs[f"bwd_{mode}"] = k1_plain_job(mode, True, bwd_inputs, w)
    for e in range(K1_BATCH):
        jobs[f"batch_bwd_{e}"] = k1_plain_job(
            None, True, k1_row(bplan, bins, e), bw[e])
    for a in (0.3, 0.7):
        jobs[f"fwd_{a}"] = k1_plain_job(None, False, hard_inputs[a])
    for mode in ("soft", "st"):
        jobs[f"fwd_{mode}"] = k1_plain_job(mode, True, soft_inputs)
    for e in range(K1_BATCH):
        jobs[f"batch_fwd_{e}"] = k1_plain_job(None, False,
                                              k1_row(bplan, bins, e))
        jobs[f"batch_fwd_soft_{e}"] = k1_plain_job(None, True,
                                                   k1_row(bplan, bins, e))
    # slice 5's all-macro scenes and K4's check cases
    k4_scenes = {name: k4_scene(cfg, dev) for name, cfg in K4_SCENES.items()}
    k4_checks = k4_cases(k4_scenes)
    for key, (scene, _, _, ins, kw) in k4_checks.items():
        jobs[key] = k4_plain_job(scene, ins, kw)
    t_plain = time.perf_counter()
    plain_calls = submit_plain(shard_ranks, jobs)
    report(jobs=len(jobs), workers=PLAIN_WORKERS)

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
    # a step of four draws: one forward and one backward launch
    counts = (kfn.launches[k1.SOFT], kfn_bwd.launches)
    loss4 = trainer.train_step(4)
    torch.cuda.synchronize()
    step4_launches = dict(fwd_soft=kfn.launches[k1.SOFT] - counts[0],
                          bwd=kfn_bwd.launches - counts[1])
    ok = (all(math.isfinite(x) for x in losses) and changed and
          math.isfinite(eval_reward) and train_launches["fwd_soft"] == 3 and
          train_launches["bwd"] == 3 and train_launches["fwd_hard"] == 1 and
          math.isfinite(loss4) and step4_launches == dict(fwd_soft=1, bwd=1))
    report(losses=losses, eval_reward=eval_reward, params_changed=changed,
           launches=train_launches, loss_4_draws=loss4,
           launches_4_draws=step4_launches)
    if not ok:
        raise SystemExit("train failed")

    # ---- slice 8: K1 with B episodes per launch, the packed Trainer
    t_slice8 = time.perf_counter()
    phase("k1_batch_vs_single")
    k1_batch_err = check_k1_batch(benv)
    with tempfile.TemporaryDirectory() as log_root:
        phase("packed_train")
        packed_launches = run_packed_train(benv, log_root)
    slice8_seconds = time.perf_counter() - t_slice8

    # ---- 8-11. slice 3: the inverse benchmarks through K2 and K3
    t_slice3 = time.perf_counter()
    phase("k2_vs_plain")
    k2_check = check_k2(dev)
    phase("k3_vs_plain")
    k3_check = check_k3(dev)
    with tempfile.TemporaryDirectory() as log_root:
        phase("inverse")
        inverse_launches = run_inverse(dev, log_root)
        phase("inverse_hybrid")
        run_inverse_hybrid(dev, log_root)
    slice3_seconds = time.perf_counter() - t_slice3

    # ---- 3-5. K1 against its plain version, same inputs, on the card
    phase("k1_vs_plain")
    t0 = time.perf_counter()
    plain_out = collect_plain(plain_calls)
    plain_wait_s = time.perf_counter() - t0
    plain_wall_s = time.perf_counter() - t_plain
    checks, plain_hard_ms = [], []
    max_abs_err = 0.0
    for a in (0.3, 0.7):
        kr, kq, ke = (x.cpu() for x in kfn(plan, *hard_inputs[a]))
        (pr, pq, pe), ms = plain_out[f"fwd_{a}"]
        plain_hard_ms.append(ms)
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
           plain_jobs_wall_seconds=plain_wall_s,
           plain_wait_seconds=plain_wait_s,
           tolerance=dict(events="exact", reward_rel=1e-4, queues_abs=1e-4))

    # ---- 4. the soft and straight-through forward against the plain version
    phase("k1_soft_vs_plain")
    soft_err, soft_checks, plain_soft_s = 0.0, [], {}
    for mode in ("soft", "st"):
        p = soft_env[mode].fused_plan(True)
        kr, kq, ke = (x.cpu() for x in kfn(p, *soft_inputs))
        (pr, pq, pe), ms = plain_out[f"fwd_{mode}"]
        plain_soft_s[mode] = ms / 1e3
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
    for mode in ("soft", "st"):
        p = soft_env[mode].fused_plan(True)
        g = kfn_bwd(p, w, *bwd_inputs).cpu()
        (g_ref,), ms = plain_out[f"bwd_{mode}"]
        plain_bwd_s[mode] = ms / 1e3
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

    # ---- slice 8: the batched launches against the plain version
    phase("k1_batch_vs_plain")
    batch_plain = check_k1_batch_plain(benv, bins, bw, plain_out)

    # ---- slice 17: K1 on the 5x5, 7x7 and 9x9 grids
    t_slice17 = time.perf_counter()
    phase("k1_wide_vs_plain")
    wide_check = check_k1_wide(wide_envs, long_envs, plain_out)
    with tempfile.TemporaryDirectory() as log_root:
        phase("train_5x5")
        wide_launches = {5: run_train_5x5(log_root)}
    phase("serve_train_wide")
    drives = []
    for n in WIDE_GRIDS[1:]:
        drives.append(drive_wide(wide_env(n, WIDE_POLICY, dev)))
        wide_launches[n] = drives[-1]["launches"]
    report(drives=drives)
    phase("k1_wide_timing")
    wide_times = time_k1_wide(long_envs)
    report(**wide_times, nvidia_smi=smi)
    slice17_seconds = time.perf_counter() - t_slice17

    # ---- 12-15. slice 4: training on the fused spatial step (mesh 1,1)
    t_slice4 = time.perf_counter()
    phase("spatial_vs_plain")
    env.reset(3)
    spatial_fwd = check_spatial_fwd(env)
    phase("spatial_bwd_vs_plain")
    spatial_bwd = check_spatial_bwd(soft_env["soft"])
    with tempfile.TemporaryDirectory() as log_root:
        phase("spatial_train")
        spatial_launches = run_spatial_train(log_root)
    phase("spatial_timing")
    env.reset(3)
    spatial_times = time_spatial(env, spatial_fwd["vehicles_per_step"])
    report(**spatial_times, nvidia_smi=smi)
    slice4_seconds = time.perf_counter() - t_slice4

    # ---- 16-20. slice 5: the all-macro episode through K4
    t_slice5 = time.perf_counter()
    phase("k4_vs_plain")
    k4_check = check_k4_plain(k4_scenes, k4_checks, plain_out)
    phase("k4_vs_scan")
    check_k4_scan(*k4_scenes["macro_preset"])
    phase("k4_vs_k1")
    check_k4_k1(*k4_scenes["grid3_macro"])
    phase("k4_train")
    k4_launches = run_k4_train(*k4_scenes["macro_preset"])
    phase("k4_timing")
    k4_times = time_k4(k4_scenes, k4_check["plain_ms"])
    report(**k4_times, nvidia_smi=smi)
    slice5_seconds = time.perf_counter() - t_slice5

    # ---- 21-24. slice 6: the lane-sharded spatial step over gloo ranks
    t_slice6 = time.perf_counter()
    phase("shard_vs_plain")
    shard_fwd = check_shard_fwd(shard_ranks)
    shard_ranks[2].close()
    phase("shard_bwd_vs_plain")
    shard_bwd = check_shard_bwd(shard_ranks[SHARDS])
    with tempfile.TemporaryDirectory() as log_root:
        phase("shard_train")
        shard_launches = run_shard_train(shard_ranks[SHARDS], log_root)
    slice6_seconds = time.perf_counter() - t_slice6
    t0 = time.perf_counter()
    phase("shard9_vs_plain")
    check_shard9(shard_ranks[SHARDS])
    slice8_seconds += time.perf_counter() - t0
    t_slice6 = time.perf_counter()
    shard_ranks[SHARDS].close()
    phase("shard_timing")
    shard_times = time_shard(preset_env(dev))
    report(**shard_times, step_wall_ms_host_staged_gloo=shard_fwd[
        "step_wall_ms"], nvidia_smi=smi,
        note="per-launch kernel times on one rank, no collective inside; "
             "the step wall times (by shard count and mode) include gloo "
             "collectives staged through host memory between ranks that "
             "share the card and are not a collective measurement of the "
             "card")
    slice6_seconds += time.perf_counter() - t_slice6

    # ---- slice 8: K1's ms per launch by episodes per launch
    t0 = time.perf_counter()
    phase("k1_batch_timing")
    k1_batch_times = time_k1_batches(benv)
    report(**k1_batch_times, nvidia_smi=smi)
    slice8_seconds += time.perf_counter() - t0

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
    # the plain episode takes seconds on the card's host: the mean of its
    # two runs in k1_vs_plain, not a third
    plain_ms = float(np.mean(plain_hard_ms))
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
    t0 = time.perf_counter()
    rollouts = time_rollouts(dev)
    slice3_seconds += time.perf_counter() - t0
    report(kernel_ms=times, plain_ms=plain_ms, bounds=bounds,
           ms_over_bound={n: times[n] / bounds[n]["bound_ms"] for n in times},
           fwd_bwd_episodes_per_s=1e3 / (times["fwd_soft"] + times["bwd"]),
           speedup_vs_plain=plain_ms / times["fwd"], rollouts=rollouts,
           nvidia_smi=smi)

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
    # K2 and K3 at B = 1, the shape of the GD episodes and scipy
    # evaluations that make most of the inverse path's launches
    from dhts_torch.ops.cuda import macro_rollout as k2
    from dhts_torch.ops.cuda import micro_rollout as k3

    errors = {"k2_fwd": k2_check["fwd_err"], "k2_bwd": k2_check["bwd_err"],
              "k3_fwd": k3_check["fwd_err"], "k3_bwd": k3_check["bwd_err"]}
    names = {"k2_fwd": ("macro_rollout_fwd", k2.SOURCE, k2.REPLACES_FWD),
             "k2_bwd": ("macro_rollout_bwd", k2.SOURCE, k2.REPLACES_BWD),
             "k3_fwd": ("micro_rollout_fwd", k3.SOURCE, k3.REPLACES_FWD),
             "k3_bwd": ("micro_rollout_bwd", k3.SOURCE, k3.REPLACES_BWD)}
    for key, (name, source, replaces) in names.items():
        b1 = rollouts["bounds"][key][1]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": inverse_launches[key],
            "max_abs_err": errors[key], "ms": rollouts["ms"][key][1],
            "plain_ms": rollouts["plain_ms"][key],
            "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
            "library_ms": None, "batch": 1,
            "ms_by_batch": rollouts["ms"][key]})
        if key in rollouts["ms_wrapper"]:
            kernels[-1]["ms_wrapper"] = rollouts["ms_wrapper"][key][1]
        # K3's other launches of the inverse path: the GD episodes'
        # forward saves the trajectory; the backward without one (this
        # script's checks) replays it first
        tag, other = {"k3_fwd": ("save", "k3_fwd_save"),
                      "k3_bwd": ("replay", "k3_bwd_replay")}.get(key,
                                                                 (0, 0))
        if other:
            kernels[-1].update({
                f"ms_{tag}": rollouts["ms"][other][1],
                f"bound_ms_{tag}": rollouts["bounds"][other][1]["bound_ms"],
                f"ms_{tag}_by_batch": rollouts["ms"][other]})
    # the STEP kernels at B = 1, the CLI's episodes per launch at mesh 1,1
    from dhts_torch.ops.cuda import itscp_spatial_step as k6

    for key, replaces, err, plain_ms in (
            ("fwd", k6.REPLACES_FWD, spatial_fwd["max_abs_err"],
             spatial_times["plain_step_ms"]),
            ("bwd", k6.REPLACES_BWD, spatial_bwd["max_abs_err"],
             spatial_bwd["plain_step_ms"])):
        b1 = spatial_times["bounds"][key][1]
        kernels.append({
            "name": f"itscp_spatial_step_{key}", "route": "cuda",
            "source": k6.SOURCE, "replaces": replaces,
            "body": k6.REPLACES_STEP,
            "launches": spatial_launches["steps"][key],
            "kernel_launches": spatial_launches["kernel"][key],
            "max_abs_err": err, "ms": spatial_times["ms"][key][1],
            "plain_ms": plain_ms, "bound_ms": b1["bound_ms"],
            "bound_by": b1["bound_by"], "library_ms": None, "batch": 1,
            "ms_by_batch": spatial_times["ms"][key],
            "ms_per_episode": spatial_times["ms_per_episode"][key],
            "bound_ms_per_episode": {
                B: b["bound_ms"] for B, b in
                spatial_times["bounds_per_episode"][key].items()}})
        if key == "fwd":
            kernels[-1].update(
                ms_soft=spatial_times["ms"]["fwd_soft"][1],
                ms_soft_by_batch=spatial_times["ms"]["fwd_soft"],
                ms_soft_per_episode=spatial_times["ms_per_episode"][
                    "fwd_soft"])
    # K4 at the macro preset, the shape of the k4_train phase: the forward
    # that saves the trajectory, and the reverse sweep over it (the action
    # alone, as training asks; all three gradients take the same launch);
    # beside them the forward without the trajectory, the sweep replaying
    # it and the forward-mode derivative that k4_vs_plain holds it against
    from dhts_torch.ops.cuda import itscp_macro_episode as k4

    main_scene = "macro_preset"
    k4_ms = k4_times["ms"][main_scene]
    for key, timed, replaces, err, extra in (
            ("fwd", "fwd_save", k4.REPLACES_FWD, k4_check["fwd_err"],
             {"ms_without_trajectory": k4_ms["fwd"]}),
            ("bwd", "bwd_action", k4.REPLACES_BWD, k4_check["bwd_err"],
             {"ms_replay": k4_ms["bwd_replay"],
              "ms_all_gradients": k4_ms["bwd_all"],
              "ms_forward_mode_action": k4_ms["tangents_action"],
              "ms_forward_mode_all": k4_ms["tangents_all"],
              "max_abs_err_vs_forward_mode": k4_check["tangent_err"]})):
        b = k4_times["bounds"][main_scene][timed]
        kernels.append({
            "name": f"itscp_macro_episode_{key}", "route": "cuda",
            "source": k4.SOURCE, "replaces": replaces,
            "launches": k4_launches[key], "max_abs_err": err,
            "ms": k4_ms[timed],
            "plain_ms": k4_check["plain_ms"][main_scene][key],
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": None, "scene": main_scene, **extra,
            "ms_by_scene": k4_times["ms"]})
    # K6's per-shard bodies at S = 4, B = 1, the CLI's episodes per launch
    from dhts_torch.ops.cuda import itscp_spatial_shard as ks

    pallas_call = {"fwd": k6.REPLACES_FWD, "bwd": k6.REPLACES_BWD,
                   "sg": ks.REPLACES_SG}
    for body in ks.KERNELS + tuple(f"{b}_bwd" for b in ks.KERNELS):
        name = body.split("_")[0]
        dual = body.endswith("_bwd")
        b1 = shard_times["bounds"][body][1]
        err = (shard_bwd["q_max_abs_err"] if body == "Q_bwd" else
               shard_bwd["d3_tangent_err"] if body == "D3_bwd" else
               shard_bwd["max_abs_err"] if dual else
               shard_fwd["errors"].get(name, 0.0))
        also = ks.ALSO_REPLACES.get(name, ())
        row = {
            "name": f"itscp_spatial_shard_{name}_{'bwd' if dual else 'fwd'}",
            "route": "cuda", "source": ks.SOURCE,
            # D3's launch also does JAX's D1 and D2, which reach K5's
            # stop-gradient pallas_call in the forward and the derivative
            "replaces": "; ".join(ks.REPLACES[x] for x in (name, *also)),
            "pallas_call": pallas_call["bwd" if dual else "fwd"],
            **({"pallas_call_also": pallas_call["sg"]} if also else {}),
            "launches": shard_launches[body],
            "max_abs_err": err, "ms": shard_times["ms"][body][1],
            "plain_ms": shard_times["plain_ms"][body],
            "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
            "library_ms": shard_times["library_ms"].get(body),
            "batch": 1, "shards": SHARDS,
            "ms_by_batch": shard_times["ms"][body]}
        if name == "A":
            row["launched"] = ("once an episode, for step 0: D3's launch "
                               "writes the later steps' A rows")
        kernels.append(row)
    # K1's batched launches at K1_BATCH episodes, the packed Trainer's
    # (packed_train), against the plain version's episodes
    # (k1_batch_vs_plain; it loops over them: its ms is their sum)
    for key, replaces in (("fwd", k1.REPLACES_FWD),
                          ("fwd_soft", k1.REPLACES_FWD),
                          ("bwd", k1.REPLACES_BWD)):
        b = k1_batch_times["bounds"][key][K1_BATCH]
        kernels.append({
            "name": f"itscp_hybrid_episode_{key}_batch", "route": "cuda",
            "source": k1.SOURCE, "replaces": replaces,
            "launches": packed_launches[key],
            "max_abs_err": batch_plain["err"][key],
            "ms": k1_batch_times["ms"][key][K1_BATCH],
            "plain_ms": batch_plain["plain_ms"][key],
            "plain_ms_from": f"the sum of the plain version's {K1_BATCH} "
                             "episodes, each timed in a gloo rank beside "
                             "the others",
            "bit_equal_to_single_launches": True,
            "max_abs_err_vs_single_launches": k1_batch_err[key],
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": None, "batch": K1_BATCH,
            "ms_by_batch": k1_batch_times["ms"][key]})
    # K1 on the wide grids at T = 600, B = 1: the launches of train_5x5
    # and serve_train_wide; the error and the plain version's ms from
    # k1_wide_vs_plain on the same inputs at T = 600
    for n in WIDE_GRIDS:
        lay = wide_times["layout"][n]
        for key, replaces in (("fwd", k1.REPLACES_FWD),
                              ("fwd_soft", k1.REPLACES_FWD),
                              ("bwd", k1.REPLACES_BWD)):
            b = wide_times["bounds"][n][key]
            kernels.append({
                "name": f"itscp_hybrid_episode_{key}_{n}x{n}",
                "route": "cuda", "source": k1.SOURCE, "replaces": replaces,
                "launches": wide_launches[n][key],
                "max_abs_err": wide_check["errors"][600][n][key],
                "ms": wide_times["ms"][n][key],
                "plain_ms": wide_check["plain_ms"][600][n][key],
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "library_ms": None, "scene": f"{n}x{n}", "L": lay["L"],
                "T": WIDE_POLICY * 30,
                "lanes_per_thread": lay["lanes_per_thread"],
                "placement": lay["placement"][
                    "backward" if key == "bwd" else "forward"]})
    report(total_seconds=time.perf_counter() - t_start,
           slice3_seconds=slice3_seconds, slice4_seconds=slice4_seconds,
           slice5_seconds=slice5_seconds, slice6_seconds=slice6_seconds,
           slice8_seconds=slice8_seconds, slice17_seconds=slice17_seconds)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
