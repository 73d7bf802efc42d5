"""K1's and K4's launches of another tree and of this checkout, in
alternating pairs on one card.

    python tools/gate_timing.py --parent build/parent [--pairs 10]

``TREE`` is a checkout (e.g. ``git archive`` of the parent commit unpacked
into the git-ignored ``build/parent``); its ``csrc/itscp_hybrid_episode.cu``
and ``csrc/itscp_macro_episode.cu`` are built with this checkout's ``nvcc``
flags into this checkout's build directory (``tools/k3_timing.py``'s
``build_tree``) and loaded beside this checkout's libraries, so both run in
one process through the same C launchers (the same signatures since the
NaN repair). The cases: K1 at the 3x3 hybrid preset of
``run_itscp_hybrid.sh`` (T = 600, 144 lanes, action 0.5, one episode a
launch; ``tools/k1_timing.py``'s inputs) hard, soft and backward; K4 at the
macro preset of ``run_itscp_macro.sh`` and the 3x3 preset in macro mode
(action 0.5, empty state; ``chip_smoke.py``'s ``k4_timing`` inputs),
forward and the action's backward.

In each of ``--pairs`` pairs: the parent, this checkout, this checkout, the
parent; each visit takes every case's ms a launch (CUDA events around 5
launches back to back, median of ``--repeats``). Prints one JSON line: the
card's name and power limit, the medians and interquartile ranges of both
arms, and how many pairs this checkout won.
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


def libraries(tree: Path) -> dict:
    """``{kernel: library}`` of TREE's K1 and K4 sources, bound."""
    from k3_timing import build_tree

    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1
    from dhts_torch.ops.cuda import itscp_macro_episode as k4

    return {"k1": k1.bind(ctypes.CDLL(str(build_tree(
                tree, "itscp_hybrid_episode")))),
            "k4": k4.bind(ctypes.CDLL(str(build_tree(
                tree, "itscp_macro_episode"))))}


def cases(dev) -> dict:
    """``{case: call(libs)}``: one launch of each case through ``libs``."""
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
    for name, cfg in chip_smoke.K4_SCENES.items():
        kenv, fn = chip_smoke.k4_scene(cfg, dev)
        plan = fn.plan
        kins = chip_smoke.k4_inputs(kenv, plan, 0.5, False)
        kout = (torch.empty((), device=dev), torch.empty(plan.T, device=dev))
        kw = torch.full((plan.T,), -1.0, device=dev)
        kg = torch.zeros(plan.n_action + 2 * plan.L * plan.C, device=dev)
        seeds = k4.seed_counts(plan, (True, False, False))
        runs[f"k4_fwd_{name}"] = (
            lambda L, p=plan, i=kins, o=kout:
            L["k4"].launch_itscp_macro_episode_fwd(
                *k4.kernel_args(p, i, o, stream)))
        runs[f"k4_bwd_{name}"] = (
            lambda L, p=plan, i=kins, o=(kw, kg), s=seeds:
            L["k4"].launch_itscp_macro_episode_bwd(
                *k4.kernel_args(p, i, o, stream, s)))
    return runs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path, required=True)
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)
    import torch

    import chip_smoke
    from shard_timing import stats

    if not torch.cuda.is_available():
        print("gate_timing.py needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    arms = {"parent": libraries(args.parent), "this": libraries(ROOT)}
    runs = cases(dev)

    def visit(libs):
        out = {}
        for name, run in runs.items():
            def call():
                assert run(libs) == 0, name
            out[name] = chip_smoke.cuda_ms(call, args.repeats, 5)
        return out

    for libs in arms.values():  # warm-up launches
        for run in runs.values():
            assert run(libs) == 0
    torch.cuda.synchronize()
    visits = {"parent": [], "this": []}
    for _ in range(args.pairs):
        for arm in ("parent", "this", "this", "parent"):
            visits[arm].append(visit(arms[arm]))
    per_pair = {a: [{k: (v[2 * i][k] + v[2 * i + 1][k]) / 2 for k in runs}
                    for i in range(args.pairs)] for a, v in visits.items()}
    print(json.dumps({
        "tree": str(ROOT), "parent": str(args.parent),
        "nvidia_smi": chip_smoke.nvidia_smi(), "pairs": args.pairs,
        "summary_ms_per_launch": {a: {k: stats([pp[k] for pp in pps])
                                      for k in runs}
                                  for a, pps in per_pair.items()},
        "this_faster_in_pairs": {k: sum(per_pair["this"][i][k] <
                                        per_pair["parent"][i][k]
                                        for i in range(args.pairs))
                                 for k in runs},
        "per_pair": per_pair}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
