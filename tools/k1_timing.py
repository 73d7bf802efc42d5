"""K1's hard, soft and backward milliseconds per launch at the 3x3 hybrid
preset of ``run_itscp_hybrid.sh`` (T = 600, 144 lanes, one episode per
launch, action 0.5), or with ``--scene 5x5|7x7|9x9`` at the same flags on
the wider grids of ``run_itscp_5x5.sh`` (400, 784, 1,296 lanes), on the
card, with the ``dhts_torch`` package of a given checkout: the ``timing``
phase of ``chip_smoke.py`` (its preset and its ``cuda_ms``) for another
tree, so that two trees can be timed in turns in one call on one card::

    for i in 1 2 3 4 5; do for t in ../parent . . ../parent; do
        python tools/k1_timing.py $t; done; done

``TREE`` (default: this checkout) gives the package; the preset and the
timer are this checkout's. Prints one JSON line: the tree, the scene, its
layout (lanes a thread, the forward's and the backward's placement), the
card's name and power limit, and the median of ``--repeats`` CUDA-event
timings of each launch after two warm-up launches, alone (``ms``: the
wrapper's host time before the launch counts, as in ``timing``) and, at
the 3x3 preset, five back to back (``ms_back_to_back``: the host enqueues
the next launch while the card runs the last, so the kernel's own time);
with ``--batches 1,4,8,32`` also each launch of B episodes of
``chip_smoke.py``'s four scenarios (alone, after a warm-up;
``k1_batch_timing``'s inputs) and fwd+bwd episodes per second at each B.

``--parent TREE`` times TREE's K1 and this checkout's in one process
instead: TREE's ``csrc/itscp_hybrid_episode.cu`` built with this
checkout's flags (``tools/k3_timing.py``'s ``build_tree``) beside this
checkout's library, both called through this checkout's ``kernel_args``
(the arguments after the stream, lanes a thread, placement and workspace,
are ones an older launcher ignores; the 3x3 preset's layout is one lane a
thread in shared memory, the only one an older library has), in
``--pairs`` pairs of visits (the parent, this checkout, this checkout,
the parent), each visit every launch's ms (CUDA events around five
launches back to back, median of ``--repeats``); prints the medians and
interquartile ranges of both arms and how many pairs this checkout won.

``--sass`` prints instead, for each instantiation of K1's kernels in TREE's
build, its SASS instruction count and the SHA-256 of its instructions
(``cuobjdump -sass``, addresses and encodings dropped), and ptxas's lines
of registers and stack: equal digests of two trees mean the same machine
code. The shared-memory kernel is named by its scalar type and
``+episodes`` for an episode axis in its parameters, the wide kernel (the
state in global memory) as ``wide<scalar, lanes a thread>``.

``--compare TREE`` prints instead the largest absolute difference between
TREE's K1 and this checkout's on the same inputs: reward, queues and
events of the hard and the soft forward and the backward's gradient, at
the preset (B = 1) and on the four scenarios of ``chip_smoke.py``'s batch
in one launch (B = 4); 0 everywhere means bit-equal outputs. TREE's
outputs come from a child process (``--dump``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def sass_digest() -> dict:
    """K1's kernels in the imported package's build: ``{"sass": {kernel:
    {"instructions": n, "sha256": digest}}, "ptxas": [...]}``; a kernel is
    named by its scalar type and ``+episodes`` for an episode axis in its
    parameters."""
    import hashlib
    import re
    import subprocess

    from dhts_torch.ops.cuda import _build

    lib = _build.build("itscp_hybrid_episode")
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            name = None
            scalar = "Dual" if "Dual" in fn else "float"
            if "itscp_hybrid_episode_kernel" in fn:
                name = scalar + ("+episodes" if "Episodes" in fn else "")
                out[name] = []
            wide = re.search(r"itscp_hybrid_episode_wide.*?Li(\d)E", fn)
            if wide:
                name = f"wide<{scalar}, {wide.group(1)}>"
                out[name] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if name and ins:
            out[name].append(ins.group(1))
    ptxas = _build.BUILD_DIR / f"{lib.stem}.ptxas.txt"
    return {"sass": {k: {"instructions": len(v), "sha256": hashlib.sha256(
        "\n".join(v).encode()).hexdigest()} for k, v in out.items()},
            "ptxas": [ln.strip() for ln in ptxas.read_text().splitlines()
                      if "registers" in ln or "stack" in ln]
            if ptxas.exists() else None}


def outputs(chip_smoke, benv, k1, ins, hard, soft) -> dict:
    """K1's outputs at the preset (B = 1) and on the batch of four
    scenarios (B = 4): ``{run: [tensors]}`` on the host."""
    import torch

    dev = ins[0].device
    w = torch.full((hard.T,), -1.0, device=dev)
    bins = chip_smoke.k1_batch_inputs(benv, chip_smoke.K1_BATCH, 5)
    bw = torch.full((chip_smoke.K1_BATCH, hard.T), -1.0, device=dev)
    bhard, bsoft = benv.fused_plan(False), benv.fused_plan(True)
    runs = {"hard": lambda: k1.itscp_hybrid_episode_fwd(hard, *ins),
            "soft": lambda: k1.itscp_hybrid_episode_fwd(soft, *ins),
            "bwd": lambda: (k1.itscp_hybrid_episode_bwd(soft, w, *ins),),
            "hard_b4": lambda: k1.itscp_hybrid_episode_fwd(bhard, *bins),
            "soft_b4": lambda: k1.itscp_hybrid_episode_fwd(bsoft, *bins),
            "bwd_b4": lambda: (k1.itscp_hybrid_episode_bwd(bsoft, bw, *bins),)}
    return {k: [x.cpu() for x in fn()] for k, fn in runs.items()}


def compare(mine: dict, theirs: dict) -> dict:
    """The largest absolute difference of each output of each run."""
    names = {"bwd": ("gradient",), "bwd_b4": ("gradient",)}
    out = {}
    for run, xs in mine.items():
        keys = names.get(run, ("reward", "queues", "events"))
        out[run] = {k: float((a.double() - b.double()).abs().max())
                    for k, a, b in zip(keys, xs, theirs[run])}
    return out


SCENES = ("3x3", "5x5", "7x7", "9x9")


def scene_config(chip_smoke, scene: str) -> dict:
    """The preset's flags on the ``scene`` grid (seed 3)."""
    return dict(chip_smoke.PRESET, num_intersection=int(scene[0]),
                random_seed=3)


def bind_launchers(lib):
    """Declare K1's two launchers on ``lib`` (a tree's build) with this
    checkout's signatures."""
    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

    for fn, types in ((lib.launch_itscp_hybrid_episode_fwd, k1._ARGTYPES),
                      (lib.launch_itscp_hybrid_episode_bwd,
                       k1._ARGTYPES_BWD)):
        fn.argtypes, fn.restype = types, ctypes.c_int
    return lib


def parent_pairs(chip_smoke, parent: Path, env, ins, pairs: int,
                 repeats: int) -> dict:
    """``--parent``: both libraries' launches in alternating visits."""
    import torch

    sys.path.insert(0, str(ROOT / "tools"))
    from k3_timing import build_tree

    from dhts_torch.ops.cuda import _launch
    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

    dev = ins[0].device
    stream = _launch.stream(dev)
    hard, soft = env.fused_plan(False), env.fused_plan(True)
    libs = {"parent": bind_launchers(ctypes.CDLL(str(build_tree(
                parent, "itscp_hybrid_episode")))),
            "this": k1._library()}
    out = (torch.empty((), device=dev), torch.empty(hard.T, device=dev),
           torch.empty(hard.T, 8, device=dev))
    w = torch.full((hard.T,), -1.0, device=dev)
    grad = torch.empty(soft.n_phases, soft.n_inter, device=dev)
    cases = {
        "fwd": lambda L: L.launch_itscp_hybrid_episode_fwd(
            *k1.kernel_args(hard, ins, out, stream)),
        "fwd_soft": lambda L: L.launch_itscp_hybrid_episode_fwd(
            *k1.kernel_args(soft, ins, out, stream)),
        "bwd": lambda L: L.launch_itscp_hybrid_episode_bwd(
            *k1.kernel_args(soft, ins, (w, grad), stream))}

    def call(case, lib):
        _launch.raise_on(cases[case](lib), f"k1 {case}")

    for lib in libs.values():
        for case in cases:
            call(case, lib)
    torch.cuda.synchronize()
    ms = {arm: {c: [] for c in cases} for arm in libs}
    won = dict.fromkeys(cases, 0)
    for _ in range(pairs):
        visit = {arm: {c: [] for c in cases} for arm in libs}
        for arm in ("parent", "this", "this", "parent"):
            for c in cases:
                t = chip_smoke.cuda_ms(lambda: call(c, libs[arm]), repeats,
                                       5)
                visit[arm][c].append(t)
                ms[arm][c].append(t)
        for c in cases:
            won[c] += sum(visit["this"][c]) < sum(visit["parent"][c])

    def stats(xs):
        q = np.percentile(xs, [25, 50, 75])
        return {"median": float(q[1]), "iqr": float(q[2] - q[0])}

    return {arm: {c: stats(v) for c, v in d.items()}
            for arm, d in ms.items()} | {"this_won": won, "pairs": pairs}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("tree", nargs="?", default=str(ROOT))
    p.add_argument("--scene", choices=SCENES, default="3x3")
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--sass", action="store_true")
    p.add_argument("--batches", metavar="B,B,...",
                   help="also time B episodes per launch of the batch's "
                        "scenarios (single launches)")
    p.add_argument("--compare", metavar="TREE")
    p.add_argument("--parent", metavar="TREE",
                   help="time TREE's K1 against this checkout's in "
                        "alternating pairs, in one process")
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--dump", metavar="PATH", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.compare:
        import subprocess
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "theirs.pt")
            subprocess.run([sys.executable, __file__, args.compare,
                            "--dump", path], check=True, timeout=600)
            import torch

            theirs = torch.load(path)
        args.tree, args.dump = str(ROOT), None
    else:
        theirs = None
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # noqa: E402  (this checkout's preset and timer)

    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    from dhts_torch.apps.control.itscp import problem
    from dhts_torch.apps.control.itscp.env import ItscpEnv
    from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

    if args.sass:
        print(json.dumps({"tree": args.tree, **sass_digest()}), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("k1_timing.py needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    env = ItscpEnv(config=scene_config(chip_smoke, args.scene),
                   schedule_fn=problem.problem_1, device=dev)
    env.reset(3)
    hard, soft = env.fused_plan(False), env.fused_plan(True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rand = env.draw_rand(gen)
    action = torch.full((env.n_phases, env.action_size() // env.n_phases),
                        0.5, device=dev)
    ins = (action, env.data.schedule, env.data.mroute_next,
           env.data.mroute_prev, rand, env.data.inj_routes,
           env.base_state.route_pool)
    if args.dump or theirs is not None:
        mine = outputs(chip_smoke, chip_smoke.batch_env(dev), k1, ins, hard,
                       soft)
        if args.dump:
            torch.save(mine, args.dump)
            return 0
        print(json.dumps({"tree": str(ROOT), "versus": args.compare,
                          "nvidia_smi": chip_smoke.nvidia_smi(),
                          "max_abs_diff": compare(mine, theirs)}),
              flush=True)
        return 0
    layout = {"lanes_per_thread": getattr(soft, "lanes_per_thread", 1),
              "placement": getattr(soft, "placement", ("shared",) * 2)}
    if args.parent:
        rec = parent_pairs(chip_smoke, Path(args.parent), env, ins,
                           args.pairs, args.repeats)
        print(json.dumps({"tree": str(ROOT), "parent": args.parent,
                          "scene": args.scene, **layout,
                          "nvidia_smi": chip_smoke.nvidia_smi(), **rec}),
              flush=True)
        return 0
    w = torch.full((hard.T,), -1.0, device=dev)
    runs = {"fwd": lambda: k1.itscp_hybrid_episode_fwd(hard, *ins),
            "fwd_soft": lambda: k1.itscp_hybrid_episode_fwd(soft, *ins),
            "bwd": lambda: k1.itscp_hybrid_episode_bwd(soft, w, *ins)}
    for fn in runs.values():
        fn()
        fn()
    torch.cuda.synchronize()
    ms = {k: chip_smoke.cuda_ms(fn, args.repeats) for k, fn in runs.items()}
    rec = {"tree": args.tree, "scene": args.scene, **layout,
           "nvidia_smi": chip_smoke.nvidia_smi(), "ms": ms}
    if args.scene == "3x3":
        rec["ms_back_to_back"] = {k: chip_smoke.cuda_ms(fn, args.repeats, 5)
                                  for k, fn in runs.items()}
    if args.batches:
        benv = chip_smoke.batch_env(dev)
        bhard, bsoft = benv.fused_plan(False), benv.fused_plan(True)
        by_b, eps = {}, {}
        for B in (int(x) for x in args.batches.split(",")):
            bins = chip_smoke.k1_batch_inputs(benv, B, 100 + B)
            bw = torch.full((B, hard.T), -1.0, device=dev)
            runs = {"fwd": lambda: k1.itscp_hybrid_episode_fwd(bhard, *bins),
                    "fwd_soft": lambda: k1.itscp_hybrid_episode_fwd(
                        bsoft, *bins),
                    "bwd": lambda: k1.itscp_hybrid_episode_bwd(bsoft, bw,
                                                               *bins)}
            for fn in runs.values():
                fn()
            torch.cuda.synchronize()
            by_b[B] = {k: chip_smoke.cuda_ms(fn, args.repeats)
                       for k, fn in runs.items()}
            eps[B] = B * 1e3 / (by_b[B]["fwd_soft"] + by_b[B]["bwd"])
        rec.update(ms_by_batch=by_b, fwd_bwd_episodes_per_s=eps)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
