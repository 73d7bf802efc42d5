"""The lane-sharded step's A, B, C, D3 and E of another tree and of this
checkout, in alternating pairs on one card; the sharded episodes of both against each
other; the SASS of both trees' kernels.

    python tools/shard_timing.py --parent build/parent [--pairs 10]
    python tools/shard_timing.py --compare build/parent
    python tools/shard_timing.py --parent build/parent --sass

``TREE`` is a checkout (e.g. ``git archive`` of the parent commit unpacked
into the git-ignored ``build/parent``); its
``csrc/itscp_spatial_shard.cu`` is built with this checkout's ``nvcc``
flags into this checkout's build directory and loaded beside this
checkout's library, so both run in one process on one card through the
same C launcher (the same signature since the bodies' port). The cases
are the 3x3 hybrid preset of ``run_itscp_hybrid.sh`` (T = 600, 144 lanes,
action 0.55, the draws of ``chip_smoke.py``'s ``shard_timing``) at S = 4
and 2 shards, B = 1 and 4: the hard forward, the soft forward and the
derivative (``Dual``, 45 B rows), each a
``dhts_torch.ops.cuda.shard_clock.Quiet`` run stepped by this checkout's
library to the quiet step after 100.

``--parent`` times, in each of ``--pairs`` pairs, the parent, this
checkout, this checkout, the parent; each visit takes every case's ms a
launch of shard 0's A, B, C, D3 and E (``shard_clock.timed_ms``: 50
launches back to back between CUDA events, the state restored before
each, median of ``--repeats``). Then as many pairs of this checkout's C with its lanes one
thread each (its source built with ``-DDHTS_SHARD_ONE_THREAD``) and split
where they fit. Prints one JSON
line: the card's name and power limit, each pair's ms (the mean of its
two visits), the medians and interquartile ranges of both arms, and how
many pairs the second arm won.

``--compare`` runs every case's whole sharded episode (all shards in this
process) through each library from the empty state and prints the
largest absolute difference of the queues, events and waves (forward),
the gradient (derivative) and every shard's packed carry (floats,
tangents and ints): 0 where the two trees compute the same bits.

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

SHARDS = (4, 2)
BATCHES = (1, 4)
KINDS = ("hard", "soft", "dual")
BODIES = ("A", "B", "C", "D3", "E")


def libraries(parent: Path):
    from k3_timing import build_tree

    from dhts_torch.ops.cuda import itscp_spatial_shard as ks

    return {"parent": ks.bind(ctypes.CDLL(str(build_tree(
                parent, "itscp_spatial_shard")))),
            "this": ks._library()}


def one_thread_library():
    """This checkout's source built with C one thread a lane always."""
    from dhts_torch.ops.cuda import _build
    from dhts_torch.ops.cuda import itscp_spatial_shard as ks

    return ks.bind(ctypes.CDLL(str(_build.build(
        "itscp_spatial_shard", defines=("DHTS_SHARD_ONE_THREAD",)))))


def case_inputs(env, B: int):
    from dhts_torch.ops.cuda import spatial_clock as clock

    return clock.inputs(env, B, 300 + B, 0.55)


def compare(env, plans, libs) -> dict:
    """The largest absolute difference between the two libraries' sharded
    episodes of every case (queues, events, waves or gradient; carry)."""
    import torch

    from dhts_torch.ops.cuda import itscp_spatial_shard as ks

    out = {}
    for S in SHARDS:
        for B in BATCHES:
            ins = case_inputs(env, B)
            wq = torch.full((B, plans[0].T), -1.0, device=env.device)
            for kind in KINDS:
                plan = plans[kind != "hard"]
                comm = ks.LaneComm(plan.L, ks.shards_of(plan.L, S))
                res = {}
                for name, lib in libs.items():
                    run = ks.ShardRun(plan, comm, ins, dual=kind == "dual",
                                      lib=lib).run()
                    outs = ([run.gradient(wq)] if kind == "dual" else
                            list(run.outputs()))
                    bufs = [b[k] for _, _, b, _ in run.shards
                            for k in ("fbuf", "dbuf", "ibuf")
                            if b[k] is not None]
                    torch.cuda.synchronize()
                    res[name] = [x.clone() for x in outs + bufs]
                names = (["gradient"] if kind == "dual" else
                         ["queues", "events", "waves"])
                diff = {n: float((a.double() - b.double()).abs().max())
                        for n, a, b in zip(names, res["parent"],
                                           res["this"])}
                diff["carry"] = max(
                    float((a.double() - b.double()).abs().max())
                    for a, b in zip(res["parent"][len(names):],
                                    res["this"][len(names):]))
                out[f"{kind}_S{S}_B{B}"] = diff
    return out


def stats(xs):
    xs = sorted(xs)
    q = lambda f: xs[min(len(xs) - 1, int(f * (len(xs) - 1) + 0.5))]
    return {"median": q(0.5), "iqr": q(0.75) - q(0.25), "min": xs[0],
            "max": xs[-1]}


def quiet_runs(env, plans, lib) -> dict:
    from dhts_torch.ops.cuda import shard_clock

    return {(kind, S, B): shard_clock.Quiet(plans, kind, case_inputs(env, B),
                                            lib, S=S)
            for S in SHARDS for B in BATCHES for kind in KINDS}


def pairs(quiet, arms, n_pairs: int, repeats: int, bodies=BODIES) -> dict:
    """``n_pairs`` pairs of the two ``arms`` (``(name, library)``), the
    first, the second, the second, the first; each visit times ``bodies``
    in every case."""
    from dhts_torch.ops.cuda import shard_clock

    # a first launch of each arm warms the card
    for _, lib in arms:
        for q in quiet.values():
            for body in bodies:
                shard_clock.timed_ms(q, lib, body, 5, 1)

    def visit(lib):
        return {f"{body}_{kind}_S{S}_B{B}":
                shard_clock.timed_ms(q, lib, body, 50, repeats)
                for (kind, S, B), q in quiet.items() for body in bodies}

    (a, lib_a), (b, lib_b) = arms
    visits = {a: [], b: []}
    for _ in range(n_pairs):
        for t, lib in ((a, lib_a), (b, lib_b), (b, lib_b), (a, lib_a)):
            visits[t].append(visit(lib))
    per_pair = {t: [{k: (vs[2 * i][k] + vs[2 * i + 1][k]) / 2
                     for k in vs[2 * i]} for i in range(n_pairs)]
                for t, vs in visits.items()}
    keys = list(per_pair[b][0])
    summary = {t: {k: stats([pp[k] for pp in pps]) for k in keys}
               for t, pps in per_pair.items()}
    won = {k: sum(per_pair[b][i][k] < per_pair[a][i][k]
                  for i in range(n_pairs)) for k in keys}
    return {"arms": [a, b], "summary_ms_per_launch": summary,
            f"{b}_faster_in_pairs": won, "per_pair": per_pair}


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
        print("shard_timing.py needs a CUDA device", file=sys.stderr)
        return 1
    from dhts_torch.ops.cuda import itscp_spatial_step as k6
    from dhts_torch.ops.cuda import spatial_clock as clock

    env = clock.preset_env(torch.device("cuda"))
    plans = (k6.make_plan(env, False), k6.make_plan(env, True))
    libs = libraries(tree)
    rec = {"tree": str(ROOT), "parent": str(tree),
           "nvidia_smi": chip_smoke.nvidia_smi()}
    if args.compare:
        rec["max_abs_diff"] = diff = compare(env, plans, libs)
        rec["all_zero"] = all(v == 0.0 for d in diff.values()
                              for v in d.values())
        print(json.dumps(rec), flush=True)
        return 0 if rec["all_zero"] else 1
    this = libs["this"]
    quiet = quiet_runs(env, plans, this)
    rec["quiet_steps"] = {f"{k}_S{S}_B{B}": q.t
                          for (k, S, B), q in quiet.items()}
    rec["pairs"] = args.pairs
    rec["parent_vs_this"] = pairs(
        quiet, (("parent", libs["parent"]), ("this", this)), args.pairs,
        args.repeats)
    # C's lanes one thread each against the split, in this checkout
    rec["one_thread_vs_split"] = pairs(
        quiet, (("one_thread", one_thread_library()), ("split", this)),
        args.pairs, args.repeats, ("C",))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
