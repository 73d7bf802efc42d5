"""The lane-sharded step of another tree and of this checkout, in
alternating pairs on one card: each body's ms a launch, and the wall ms of
a step over gloo ranks that share the card; the sharded episodes of both
against each other; the SASS of both trees' kernels.

    python tools/shard_timing.py --parent build/parent [--pairs 10]
    python tools/shard_timing.py --compare build/parent
    python tools/shard_timing.py --parent build/parent --sass

``TREE`` is a checkout (e.g. ``git archive`` of the parent commit unpacked
into the git-ignored ``build/parent``). Its
``csrc/itscp_spatial_shard.cu`` is built with this checkout's ``nvcc``
flags into this checkout's build directory, and its
``dhts_torch/ops/cuda/itscp_spatial_shard.py`` is loaded beside this
checkout's (over this checkout's other modules), so that each library is
driven by its own tree's ``ShardRun``, argument struct and bodies, in one
process on one card. The cases are the 3x3 hybrid preset of
``run_itscp_hybrid.sh`` (T = 600, 144 lanes, action 0.55, the draws of
``chip_smoke.py``'s ``shard_timing``) at S = 4 and 2 shards, B = 1 and 4:
the hard forward, the soft forward and the derivative (``Dual``, 45 B
rows), each a ``dhts_torch.ops.cuda.shard_clock.Quiet`` run of each tree
stepped by its own library to the quiet step after 100 (this checkout's
run finds it, the other tree's steps to it).

``--parent`` times, in each of ``--pairs`` pairs, the parent, this
checkout, this checkout, the parent; each visit takes every case's ms a
launch of each body of shard 0 that the tree launches
(``shard_clock.timed_ms``: 50 launches back to back between CUDA events,
the state restored before each, median of ``--repeats``), and sums each
tree's conversion (``conversion``: D1, D2 and D3 where the tree launches
them apart, D3 where D3's launch does all three), its conversion with A
where the tree launches A at every step (``a_conversion``: the parent's A
and D3 against this checkout's D3, which writes the next step's A rows)
and all its launches of a step after the first (``step_launches``: the
bodies of the module's ``EVERY_STEP``, every body where it has none).
Then ``step_wall``: S = 4
gloo ranks that share the card run each tree's unchecked forward steps 0 to
``--steps`` - 1 of the preset (B = 1, hard and soft, ``chip_smoke.py``'s
``shard_vs_plain`` draws), in the same order of visits, and report the
mean wall ms a step after the first 20 (the launches and the host-staged
gloo collectives between them, rank 0's clock; not a collective number of
the card). Then as many pairs of this checkout's C with its lanes one
thread each (its source built with ``-DDHTS_SHARD_ONE_THREAD``) and split
where they fit. Prints one JSON line: the card's name and power limit,
each pair's figures (the mean of its two visits), the medians and
interquartile ranges of both arms, and how many pairs the second arm won.

``--compare`` runs every case's whole sharded episode (all shards in this
process) through each tree and prints the largest absolute difference of
the queues, events and waves (forward), the gradient (derivative) and
every shard's packed carry (floats, tangents and ints): 0 where the two
trees compute the same bits.

``--sass`` prints the SHA-256 of the SASS of every kernel of every
``csrc/*.cu`` of both trees and the kernels whose digests differ (see
``tools/k3_timing.py``), and the same with every kernel-parameter offset
(``c[0x0][...]``) blanked: a kernel that differs only there reads the
same fields of an argument struct that lost or gained others; and the
registers a thread of each kernel of both trees'
``itscp_spatial_shard.cu`` takes (``cuobjdump -res-usage``: the count
``cudaFuncGetAttributes`` reports).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

SHARDS = (4, 2)
BATCHES = (1, 4)
KINDS = ("hard", "soft", "dual")
CONVERSION = ("D1", "D2", "D3")  # the bodies a tree's conversion launches
WALL_SHARDS, WALL_SKIP = 4, 20


def tree_module(tree: Path):
    """TREE's ``itscp_spatial_shard`` module (this checkout's own for this
    checkout)."""
    from dhts_torch.ops.cuda import itscp_spatial_shard as ks

    path = tree / "dhts_torch" / "ops" / "cuda" / "itscp_spatial_shard.py"
    if path.resolve() == Path(ks.__file__).resolve():
        return ks
    spec = importlib.util.spec_from_file_location("tree_itscp_spatial_shard",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def libraries(parent: Path) -> dict:
    """``{"parent": (module, library), "this": (module, library)}``."""
    from k3_timing import build_tree

    from dhts_torch.ops.cuda import itscp_spatial_shard as ks

    mod = tree_module(parent)
    return {"parent": (mod, mod.bind(ctypes.CDLL(str(build_tree(
                parent, "itscp_spatial_shard"))))),
            "this": (ks, ks._library())}


def registers(tree: Path) -> dict:
    """``{kernel: registers a thread}`` of TREE's
    ``itscp_spatial_shard.cu`` (``cuobjdump -res-usage``; the kernel's
    mangled name without its anonymous namespace's tag)."""
    import re
    import subprocess

    from k3_timing import build_tree

    from dhts_torch.ops.cuda import _build

    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-res-usage",
                           str(build_tree(tree, "itscp_spatial_shard"))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "(anon)",
                          m.group(1))
            continue
        m = re.search(r"REG:(\d+)", line)
        if name and m:
            out[name] = int(m.group(1))
            name = None
    return out


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
    """The largest absolute difference between the two trees' sharded
    episodes of every case (queues, events, waves or gradient; carry)."""
    import torch

    out = {}
    for S in SHARDS:
        for B in BATCHES:
            ins = case_inputs(env, B)
            wq = torch.full((B, plans[0].T), -1.0, device=env.device)
            for kind in KINDS:
                plan = plans[kind != "hard"]
                res = {}
                for name, (mod, lib) in libs.items():
                    comm = mod.LaneComm(plan.L, mod.shards_of(plan.L, S))
                    run = mod.ShardRun(plan, comm, ins, dual=kind == "dual",
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


def quiet_like(mod, q, inputs, lib):
    """A ``shard_clock.Quiet`` of the case of ``q`` driven by ``mod``'s
    ShardRun (another tree's module) over ``inputs``: stepped through
    ``q.t`` and relaunched there, its launches kept out of ``mod.launches``
    as ``Quiet`` keeps them out of this checkout's."""
    from dhts_torch.ops.cuda import shard_clock

    class TreeQuiet(shard_clock.Quiet):
        def __init__(self):
            self.plan, self.kind, self.t = q.plan, q.kind, q.t
            L, S = q.plan.L, len(q.run.shards)
            self.comm = mod.LaneComm(L, mod.shards_of(L, S))
            saved = dict(mod.launches)
            self.run = mod.ShardRun(self.plan, self.comm, inputs,
                                    dual=q.kind == "dual", lib=lib)
            for t in range(q.t + 1):
                self.run.step(t)
            mod.launches.update(saved)
            self.use(0)

        def launch(self, lib, body: str, repeat: int = 1):
            saved = dict(mod.launches)
            self.run.lib = lib
            self.run.launch(body, self.t, [self.i], repeat=repeat)
            mod.launches.update(saved)

    return TreeQuiet()


def quiet_runs(env, plans, libs) -> dict:
    """``{arm: {(kind, S, B): Quiet}}``: this checkout's runs find each
    case's quiet step, the other tree's runs step to it."""
    from dhts_torch.ops.cuda import shard_clock

    lib = libs["this"][1]
    this = {(kind, S, B): shard_clock.Quiet(plans, kind, case_inputs(env, B),
                                            lib, S=S)
            for S in SHARDS for B in BATCHES for kind in KINDS}
    out = {"this": this}
    for name, (mod, lib) in libs.items():
        if name != "this":
            out[name] = {c: quiet_like(mod, q, case_inputs(env, c[2]), lib)
                         for c, q in this.items()}
    return out


def pair_up(visit, arms, n_pairs: int) -> dict:
    """``n_pairs`` pairs of the two ``arms``: the first, the second, the
    second, the first; ``visit(arm)`` returns ``{key: figure}``. Each
    pair's figure is the mean of its arm's two visits."""
    a, b = arms
    visits = {a: [], b: []}
    for _ in range(n_pairs):
        for t in (a, b, b, a):
            visits[t].append(visit(t))
    per_pair = {t: [{k: (vs[2 * i][k] + vs[2 * i + 1][k]) / 2
                     for k in vs[2 * i]} for i in range(n_pairs)]
                for t, vs in visits.items()}
    summary = {t: {k: stats([pp[k] for pp in pps]) for k in pps[0]}
               for t, pps in per_pair.items()}
    common = [k for k in per_pair[b][0] if k in per_pair[a][0]]
    won = {k: sum(per_pair[b][i][k] < per_pair[a][i][k]
                  for i in range(n_pairs)) for k in common}
    return {"arms": [a, b], "summary": summary,
            f"{b}_lower_in_pairs": won, "per_pair": per_pair}


def launch_pairs(quiet, libs, n_pairs: int, repeats: int,
                 bodies=None) -> dict:
    """Pairs of the arms of ``libs`` (``{arm: (module, library)}``, two
    arms), each visit every case's ms a launch of each body the arm's
    module launches (or of ``bodies``), and its conversion's sum."""
    from dhts_torch.ops.cuda import shard_clock

    def launched(arm):
        mod = libs[arm][0]
        return [b for b in mod.BODIES if bodies is None or b in bodies]

    # a first launch of each arm warms the card
    for arm, (_, lib) in libs.items():
        for q in quiet[arm].values():
            for body in launched(arm):
                shard_clock.timed_ms(q, lib, body, 5, 1)

    def visit(arm):
        mod, lib = libs[arm]
        every = getattr(mod, "EVERY_STEP", mod.BODIES)
        out = {}
        for (kind, S, B), q in quiet[arm].items():
            case = f"{kind}_S{S}_B{B}"
            for body in launched(arm):
                out[f"{body}_{case}"] = shard_clock.timed_ms(q, lib, body,
                                                             50, repeats)
            if bodies is None:
                out[f"conversion_{case}"] = sum(
                    out[f"{b}_{case}"] for b in CONVERSION
                    if f"{b}_{case}" in out)
                out[f"a_conversion_{case}"] = sum(
                    out[f"{b}_{case}"] for b in ("A",) + CONVERSION
                    if b in every and f"{b}_{case}" in out)
                out[f"step_launches_{case}"] = sum(
                    out[f"{b}_{case}"] for b in every)
        return out

    return pair_up(visit, list(libs), n_pairs)


def _wall_rank(rank, S, tree, lib_paths, n_pairs, steps):
    """One gloo rank of ``step_wall``: each tree's unchecked forward steps
    in turn (parent, this, this, parent, ... as :func:`pair_up` visits),
    hard and soft; rank 0's mean wall ms a step after the first
    ``WALL_SKIP``."""
    import torch

    from dhts_torch.ops.cuda import spatial_clock as clock
    from dhts_torch.ops.cuda import itscp_spatial_step as k6
    from dhts_torch.parallel.mesh import make_mesh

    mods = {"parent": tree_module(Path(tree)), "this": tree_module(ROOT)}
    libs = {n: mods[n].bind(ctypes.CDLL(p)) for n, p in lib_paths.items()}
    mesh = make_mesh({"data": 1, "lane": S}, "cuda")
    env = clock.preset_env(torch.device("cuda"))
    ins = clock.inputs(env, 1, 101, 0.55)
    plans = {m: k6.make_plan(env, m == "soft") for m in ("hard", "soft")}

    def visit(arm):
        mod, out = mods[arm], {}
        for mode, plan in plans.items():
            comm = mod.LaneComm(plan.L, [mod.shards_of(plan.L, S)[rank]],
                                mesh.lane_group)
            run = mod.ShardRun(plan, comm, ins, dual=False, lib=libs[arm])
            wall = 0.0
            for t in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run.step(t)
                torch.cuda.synchronize()
                if t >= WALL_SKIP:
                    wall += time.perf_counter() - t0
            out[mode] = wall / (steps - WALL_SKIP) * 1e3
        return out

    return pair_up(visit, ["parent", "this"], n_pairs)


def step_wall(parent: Path, n_pairs: int, steps: int) -> dict:
    """:func:`_wall_rank` in ``WALL_SHARDS`` gloo ranks; rank 0's
    figures."""
    from k3_timing import build_tree

    from dhts_torch.ops.cuda import _build
    from dhts_torch.parallel.local_ranks import run_local

    paths = {"parent": str(build_tree(parent, "itscp_spatial_shard")),
             "this": str(_build.build("itscp_spatial_shard"))}
    outs = run_local(_wall_rank, WALL_SHARDS,
                     (str(parent), paths, n_pairs, steps), timeout=1800)
    return dict(outs[0], S=WALL_SHARDS, steps=steps, skipped=WALL_SKIP)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path)
    p.add_argument("--compare", type=Path)
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--sass", action="store_true")
    args = p.parse_args(argv)
    tree = args.parent or args.compare
    if tree is None:
        p.error("give --parent TREE or --compare TREE")
    import chip_smoke

    if args.sass:
        from k3_timing import sass

        print(json.dumps({"tree": str(ROOT), "parent": str(tree),
                          **sass(tree), "unequal_params_blanked": sass(
                              tree, params=False)["unequal"],
                          "registers": registers(ROOT),
                          "parent_registers": registers(tree)}), flush=True)
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
    quiet = quiet_runs(env, plans, libs)
    rec["quiet_steps"] = {f"{k}_S{S}_B{B}": q.t
                          for (k, S, B), q in quiet["this"].items()}
    rec["pairs"] = args.pairs
    rec["parent_vs_this"] = launch_pairs(quiet, libs, args.pairs,
                                         args.repeats)
    rec["step_wall_ms_host_staged_gloo"] = step_wall(tree, args.pairs,
                                                     args.steps)
    # C's lanes one thread each against the split, in this checkout
    this = libs["this"][0]
    rec["one_thread_vs_split"] = launch_pairs(
        {"one_thread": quiet["this"], "split": quiet["this"]},
        {"one_thread": (this, one_thread_library()),
         "split": libs["this"]}, args.pairs, args.repeats, ("C",))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
