"""STEP's launchers of another tree and of this checkout, in alternating
pairs on one card; their outputs against each other; the SASS of both
trees' kernels.

    python tools/step_timing.py --parent build/parent [--pairs 10]
    python tools/step_timing.py --compare build/parent
    python tools/step_timing.py --parent build/parent --sass

``TREE`` is a checkout (e.g. ``git archive`` of the parent commit unpacked
into the git-ignored ``build/parent``); its ``csrc/itscp_spatial_step.cu``
is built with this checkout's ``nvcc`` flags into this checkout's build
directory and loaded beside this checkout's library, so both run in one
process on one card through the same C launchers (the same signature since
the kernel's port). The cases are the 3x3 hybrid preset of
``run_itscp_hybrid.sh`` (T = 600, 144 lanes, action 0.55, the draws of
``chip_smoke.py``'s ``spatial_timing``) at B = 1 and 4, each a
``dhts_torch.ops.cuda.spatial_clock.Run``: the hard forward, the soft
forward (the train path's mode) and the derivative (``Dual``, 45 B dual
episodes).

``--parent`` times, in each of ``--pairs`` pairs, the parent, this checkout,
this checkout, the parent; each visit takes every case's ms a step (one
launcher call of 50 steps from the state after 100, the state restored
before each call; CUDA events around the call; median of ``--repeats``
calls) and ms an episode (one call of T steps from the empty state;
median of 3). Prints one JSON line: the card's name and power limit, each
pair's ms (the mean of its two visits), the medians, the parent's
interquartile range, and how many pairs this checkout won in each case.

``--compare`` runs every case's whole episode in one call with both
libraries from the empty state, hard and soft forward and the derivative,
and prints the largest absolute difference of the packed carry (floats,
tangents and ints), the queues, the events, the waves and the gradient:
0 where the two trees compute the same bits.

``--sass`` prints the SHA-256 of the SASS of every kernel of every
``csrc/*.cu`` of both trees and the kernels whose digests differ (see
``tools/k3_timing.py``).
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

BATCHES = (1, 4)
CASES = ("hard", "soft", "dual")


def libraries(parent: Path):
    from k3_timing import build_tree

    from dhts_torch.ops.cuda import itscp_spatial_step as k6

    return {"parent": k6.bind(ctypes.CDLL(str(build_tree(
                parent, "itscp_spatial_step")))),
            "this": k6._library()}


def compare(env, libs) -> dict:
    """The largest absolute difference between the two libraries' outputs
    of every case's whole episode (one call of T steps)."""
    import torch

    from dhts_torch.ops.cuda import spatial_clock as clock

    out = {}
    for B in BATCHES:
        for kind in CASES:
            run = clock.Run(kind, env, B, env.device, libs["this"],
                            seed=300 + B, warm=0)
            res = {}
            for name, lib in libs.items():
                run.restore(run.empty)
                run.call(lib, 0, run.plan.T)
                torch.cuda.synchronize()
                res[name] = run.results()
            names = (["fbuf", "dbuf", "ibuf", "grad"] if kind == "dual" else
                     ["fbuf", "ibuf", "queues", "events", "waves"])
            out[f"{kind}_B{B}"] = {
                n: float((a.double() - b.double()).abs().max())
                for n, a, b in zip(names, res["parent"], res["this"])}
    return out


def stats(xs):
    xs = sorted(xs)
    q = lambda f: xs[min(len(xs) - 1, int(f * (len(xs) - 1) + 0.5))]
    return {"median": q(0.5), "iqr": q(0.75) - q(0.25), "min": xs[0],
            "max": xs[-1]}


def pairs(env, libs, n_pairs: int, repeats: int) -> dict:
    from dhts_torch.ops.cuda import spatial_clock as clock

    runs = {(kind, B): clock.Run(kind, env, B, env.device, libs["this"],
                                 seed=300 + B)
            for B in BATCHES for kind in CASES}
    # a first call of each library builds nothing more and warms the card
    for lib in libs.values():
        for run in runs.values():
            clock.timed_ms(run, lib, 1)

    def visit(lib):
        rec = {}
        for (kind, B), run in runs.items():
            step = clock.timed_ms(run, lib, repeats) / clock.STEPS
            episode = clock.timed_ms(run, lib, 3, 0, run.plan.T, run.empty)
            rec[f"{kind}_B{B}"] = {"ms_per_step": step,
                                   "ms_per_episode": episode}
        return rec

    visits = {"parent": [], "this": []}
    for _ in range(n_pairs):
        for t in ("parent", "this", "this", "parent"):
            visits[t].append(visit(libs[t]))
    per_pair = {t: [{k: {m: (vs[2 * i][k][m] + vs[2 * i + 1][k][m]) / 2
                         for m in vs[2 * i][k]} for k in vs[2 * i]}
                    for i in range(n_pairs)] for t, vs in visits.items()}
    keys = list(per_pair["this"][0])
    metrics = ("ms_per_step", "ms_per_episode")
    summary = {t: {k: {m: stats([pp[k][m] for pp in pps]) for m in metrics}
                   for k in keys} for t, pps in per_pair.items()}
    won = {k: {m: sum(per_pair["this"][i][k][m] < per_pair["parent"][i][k][m]
                      for i in range(n_pairs)) for m in metrics}
           for k in keys}
    return {"summary": summary, "this_faster_in_pairs": won,
            "per_pair": per_pair}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path)
    p.add_argument("--compare", type=Path)
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--sass", action="store_true")
    args = p.parse_args(argv)
    tree = args.parent or args.compare
    if tree is None:
        p.error("give --parent TREE or --compare TREE")
    import chip_smoke

    if args.sass:
        from k3_timing import sass

        print(json.dumps({"tree": str(ROOT), "parent": str(tree),
                          **sass(tree)}), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("step_timing.py needs a CUDA device", file=sys.stderr)
        return 1
    from dhts_torch.ops.cuda import spatial_clock as clock

    env = clock.preset_env(torch.device("cuda"))
    libs = libraries(tree)
    rec = {"tree": str(ROOT), "parent": str(tree),
           "nvidia_smi": chip_smoke.nvidia_smi()}
    if args.compare:
        rec["max_abs_diff"] = diff = compare(env, libs)
        rec["all_zero"] = all(v == 0.0 for d in diff.values()
                              for v in d.values())
        print(json.dumps(rec), flush=True)
        return 0 if rec["all_zero"] else 1
    rec.update(pairs=args.pairs, **pairs(env, libs, args.pairs,
                                         args.repeats))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
