"""K1's and K4's launches of another tree and of this checkout, in
alternating pairs on one card.

    python tools/gate_timing.py --parent build/parent [--pairs 10]
    python tools/gate_timing.py --parent build/parent --compare
    python tools/gate_timing.py --parent build/parent --sass

``TREE`` is a checkout (e.g. ``git archive`` of the parent commit unpacked
into the git-ignored ``build/parent``); its ``csrc/itscp_hybrid_episode.cu``
and ``csrc/itscp_macro_episode.cu`` are built with this checkout's ``nvcc``
flags into this checkout's build directory (``tools/k3_timing.py``'s
``build_tree``) and loaded beside this checkout's libraries, so both run in
one process through the same C launchers (the same signatures since the
NaN repair). The cases: K1 at the 3x3 hybrid preset of
``run_itscp_hybrid.sh`` (T = 600, 144 lanes, action 0.5, one episode a
launch; ``tools/k1_timing.py``'s inputs) hard, soft and backward; K4 at the
macro preset of ``run_itscp_macro.sh``, the 3x3 preset and the 5x5 grid of
``run_itscp_5x5.sh`` in macro mode (action 0.5, empty state;
``chip_smoke.py``'s ``k4_timing`` inputs): the forward, and each tree's
backward for the action alone and for all three gradients (a tree with ``launch_itscp_macro_episode_reverse`` takes its
reverse sweep over the saved trajectory, which the autograd Function runs;
an older one its forward-mode blocks). Cases that only this checkout has
(the forward saving the trajectory, the sweep replaying it) are timed in
its visits alone.

In each of ``--pairs`` pairs: the parent, this checkout, this checkout, the
parent; each visit takes every case's ms a launch (CUDA events around 5
launches back to back, median of ``--repeats``). Prints one JSON line: the
card's name and power limit, the medians and interquartile ranges of both
arms, and how many pairs this checkout won.

``--compare``: K4's reward and queues of both trees at its scenes, from
the empty and a seeded state (``chip_smoke.py``'s ``k4_inputs``), and the
largest difference (0: bit-equal); this checkout's gradients (action, r0,
y0) against the parent's backward with all three: cosine and
allclose(rtol 2e-2, atol 2e-3 * max|g|). ``--sass``: the ``cuobjdump
-sass`` digests of every kernel of every source of both trees
(``tools/k3_timing.py``'s), and the kernels whose digests differ.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))


def bind_k4_launchers(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the K4 launchers that ``lib`` exports, with this checkout's
    signatures (a tree from before the reverse sweep has only the forward
    and the forward-mode blocks; the two have kept their signatures)."""
    from dhts_torch.ops.cuda import itscp_macro_episode as k4

    for name, types in k4._ARGTYPES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = types
            fn.restype = ctypes.c_int
    return lib


def k4_scenes() -> dict:
    """K4's scenes: ``chip_smoke.py``'s two and the 5x5 grid of
    ``run_itscp_5x5.sh`` in macro mode (400 lanes: this tree's wide
    sweep)."""
    import chip_smoke

    return {**chip_smoke.K4_SCENES,
            "grid5_macro": dict(chip_smoke.PRESET, mode="macro",
                                random_seed=3, num_intersection=5)}


def libraries(tree: Path) -> dict:
    """``{kernel: library}`` of TREE's K1 and K4 sources, their launchers
    bound."""
    from k3_timing import build_tree

    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

    return {"k1": k1.bind(ctypes.CDLL(str(build_tree(
                tree, "itscp_hybrid_episode")))),
            "k4": bind_k4_launchers(ctypes.CDLL(str(build_tree(
                tree, "itscp_macro_episode"))))}


def k4_calls(lib, plan, ins, stream, seeded_grad=None):
    """``{case: call}`` of K4's launches through ``lib``: the forward, the
    backward for the action and for all three gradients (the reverse sweep
    over a trajectory saved here where ``lib`` has it, else the
    forward-mode blocks), and the cases only a sweeping tree has. The
    calls keep their tensors alive."""
    import torch

    from dhts_torch.ops.cuda import itscp_macro_episode as k4

    dev = ins[0].device
    T = plan.T
    out = (torch.empty((), device=dev), torch.empty(T, device=dev))
    w = torch.full((T,), -1.0, device=dev)
    size = plan.n_action + 2 * plan.L * plan.C
    calls = {"fwd": lambda: lib.launch_itscp_macro_episode_fwd(
        *k4.kernel_args(plan, ins, out, stream))}
    if hasattr(lib, "launch_itscp_macro_episode_reverse"):
        traj = k4.new_trajectory(plan, dev)
        g = torch.empty(size, device=dev)
        save = lambda: lib.launch_itscp_macro_episode_fwd_traj(
            *k4.kernel_args(plan, ins, (*out, *traj), stream))
        assert save() == 0
        sweep = lambda: lib.launch_itscp_macro_episode_reverse(
            *k4.kernel_args(plan, ins, (w, *traj, g), stream, replay=False))
        scratch = k4.new_trajectory(plan, dev)
        calls.update(
            fwd_save=save, bwd_action=sweep, bwd_all=sweep,
            bwd_replay=lambda: lib.launch_itscp_macro_episode_reverse(
                *k4.kernel_args(plan, ins, (w, *scratch, g), stream,
                                replay=True)))
        calls["grad"] = g
    else:
        ga = torch.zeros(size, device=dev)
        gall = torch.zeros(size, device=dev)
        seeds = (k4.seed_counts(plan, (True, False, False)),
                 k4.seed_counts(plan, (True, True, True)))
        calls.update(
            bwd_action=lambda: lib.launch_itscp_macro_episode_bwd(
                *k4.kernel_args(plan, ins, (w, ga), stream, seeds[0])),
            bwd_all=lambda: lib.launch_itscp_macro_episode_bwd(
                *k4.kernel_args(plan, ins, (w, gall), stream, seeds[1])))
        calls["grad"] = gall
    calls["out"] = out
    return calls


def cases(dev) -> dict:
    """``{case: call(libs)}``: one launch of each case through ``libs``
    (a call that returns None: the tree has no such launch)."""
    import torch

    import chip_smoke
    from dhts_torch.apps.control.itscp import problem
    from dhts_torch.apps.control.itscp.env import ItscpEnv
    from dhts_torch.ops.cuda import _launch
    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1
    from dhts_torch.ops.cuda import itscp_macro_episode as k4

    stream = _launch.stream(dev)
    env = ItscpEnv(config=dict(chip_smoke.PRESET, random_seed=3),
                   schedule_fn=problem.problem_1, device=dev)
    env.reset(3)
    hard, soft = env.fused_plan(False), env.fused_plan(True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    ins = (torch.full((env.n_phases, env.action_size() // env.n_phases),
                      0.5, device=dev), env.data.schedule,
           env.data.mroute_next, env.data.mroute_prev, env.draw_rand(gen),
           env.data.inj_routes, env.base_state.route_pool)
    out = (torch.empty((), device=dev), torch.empty(hard.T, device=dev),
           torch.empty(hard.T, 8, device=dev))
    w = torch.full((hard.T,), -1.0, device=dev)
    grad = torch.empty(soft.n_phases, soft.n_inter, device=dev)
    runs = {
        "k1_hard": lambda L: L["k1"].launch_itscp_hybrid_episode_fwd(
            *k1.kernel_args(hard, ins, out, stream)),
        "k1_soft": lambda L: L["k1"].launch_itscp_hybrid_episode_fwd(
            *k1.kernel_args(soft, ins, out, stream)),
        "k1_bwd": lambda L: L["k1"].launch_itscp_hybrid_episode_bwd(
            *k1.kernel_args(soft, ins, (w, grad), stream))}
    k4_cases = {}
    for name, cfg in k4_scenes().items():
        kenv, fn = chip_smoke.k4_scene(cfg, dev)
        k4_cases[name] = (fn.plan, chip_smoke.k4_inputs(kenv, fn.plan, 0.5,
                                                         False))
    calls = {}  # per library, made once: the sweep's trajectory saved

    def k4_case(name, key):
        def run(L):
            lib = L["k4"]
            if id(lib) not in calls:
                calls[id(lib)] = {n: k4_calls(lib, *c, stream)
                                  for n, c in k4_cases.items()}
            call = calls[id(lib)][name].get(key)
            return None if call is None else call()
        return run

    for name in k4_cases:
        for key in ("fwd", "fwd_save", "bwd_action", "bwd_all",
                    "bwd_replay"):
            runs[f"k4_{key}_{name}"] = k4_case(name, key)
    return runs


def compare(parent: Path) -> dict:
    """K4's outputs of both trees (``--compare``)."""
    import torch

    import chip_smoke
    from dhts_torch.ops.cuda import _launch

    dev = torch.device("cuda")
    stream = _launch.stream(dev)
    libs = {"parent": libraries(parent)["k4"], "this": libraries(ROOT)["k4"]}
    out, ok = {}, True
    for name, cfg in k4_scenes().items():
        kenv, fn = chip_smoke.k4_scene(cfg, dev)
        for seeded in (False, True):
            ins = chip_smoke.k4_inputs(kenv, fn.plan, 0.5, seeded)
            got = {}
            for arm, lib in libs.items():
                c = k4_calls(lib, fn.plan, ins, stream)
                for key in ("fwd", "bwd_all"):
                    assert c[key]() == 0, (arm, key)
                torch.cuda.synchronize()
                got[arm] = (*c["out"], c["grad"])
            (pr, pq, pg), (tr, tq, tg) = got["parent"], got["this"]
            fwd = max(float((tr - pr).abs()), float((tq - pq).abs().max()))
            a, b = tg.double(), pg.double()
            scale = float(b.abs().max())
            rec = dict(forward_max_abs_diff=fwd,
                       forward_bit_equal=bool(torch.equal(tr, pr) and
                                              torch.equal(tq, pq)),
                       grad_cos=chip_smoke.cosine(a, b),
                       grad_max_abs_diff=float((a - b).abs().max()),
                       grad_allclose=bool(torch.allclose(
                           a, b, rtol=2e-2, atol=2e-3 * scale)))
            ok = ok and rec["forward_bit_equal"] and rec["grad_allclose"] \
                and rec["grad_cos"] > 0.9999
            out[f"{name}_{'seeded' if seeded else 'empty'}"] = rec
    return dict(k4=out, ok=ok)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path, required=True)
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--compare", action="store_true")
    p.add_argument("--sass", action="store_true")
    args = p.parse_args(argv)
    import torch

    import chip_smoke
    from k3_timing import sass
    from shard_timing import stats

    if args.sass:
        rec = sass(args.parent)
        print(json.dumps({"unequal": rec["unequal"]}), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("gate_timing.py needs a CUDA device", file=sys.stderr)
        return 1
    if args.compare:
        rec = compare(args.parent)
        print(json.dumps({"nvidia_smi": chip_smoke.nvidia_smi(), **rec}),
              flush=True)
        return 0 if rec["ok"] else 1
    dev = torch.device("cuda")
    arms = {"parent": libraries(args.parent), "this": libraries(ROOT)}
    runs = cases(dev)
    has = {a: [k for k, run in runs.items() if run(libs) is not None]
           for a, libs in arms.items()}  # the warm-up launches
    torch.cuda.synchronize()

    def visit(arm):
        out = {}
        for name in has[arm]:
            def call():
                assert runs[name](arms[arm]) == 0, name
            out[name] = chip_smoke.cuda_ms(call, args.repeats, 5)
        return out

    visits = {"parent": [], "this": []}
    for _ in range(args.pairs):
        for arm in ("parent", "this", "this", "parent"):
            visits[arm].append(visit(arm))
    per_pair = {a: [{k: (v[2 * i][k] + v[2 * i + 1][k]) / 2 for k in has[a]}
                    for i in range(args.pairs)] for a, v in visits.items()}
    both = [k for k in has["this"] if k in has["parent"]]
    print(json.dumps({
        "tree": str(ROOT), "parent": str(args.parent),
        "nvidia_smi": chip_smoke.nvidia_smi(), "pairs": args.pairs,
        "summary_ms_per_launch": {a: {k: stats([pp[k] for pp in pps])
                                      for k in has[a]}
                                  for a, pps in per_pair.items()},
        "this_faster_in_pairs": {k: sum(per_pair["this"][i][k] <
                                        per_pair["parent"][i][k]
                                        for i in range(args.pairs))
                                 for k in both},
        "per_pair": per_pair}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
