"""K3's launches of another tree and of this checkout, in alternating pairs
on one card, and the SASS of both trees' kernels.

    python tools/k3_timing.py --parent build/parent [--pairs 10]
    python tools/k3_timing.py --parent build/parent --sass

``--parent TREE`` is a checkout (e.g. ``git archive`` of the parent commit
unpacked into the git-ignored ``build/parent``); its
``csrc/micro_rollout.cu`` is built with this checkout's ``nvcc`` flags
into this checkout's build directory and loaded beside this checkout's
library, so both run in one process on one card. Each pair times the
parent, this checkout, this checkout, the parent, each visit at B = 1, 12
and 128 on ``chip_smoke.py``'s micro inputs (V = 10, T = 500, half the
platoons dense) with ``chip_smoke.cuda_ms`` (median of ``--repeats`` runs
of 20 launches back to back) for every launcher the library has: the
forward (``fwd``), the forward that saves the trajectory (``fwd_save``),
the ``Dual`` backward (``bwd``) and the reverse sweeps over a saved and a
replayed trajectory (``bwd_saved``, ``bwd_replay``); and a GD episode
(``episode``: the forward autograd runs and its backward, ``fwd`` + ``bwd``
for a tree without a saved trajectory, ``fwd_save`` + ``bwd_saved`` with
one). Prints one JSON line: the card's name and power limit, each pair's
ms (the mean of its two visits), the medians, the parent's interquartile
range over the pairs, and how many pairs this checkout won (its ``fwd``
against the parent's ``fwd``, ``bwd_saved`` against ``bwd``, ``episode``
against ``episode``). The outputs of both libraries are compared first:
the forwards bit for bit, the gradients by their largest difference.

``--sass`` prints instead, for every kernel of every ``csrc/*.cu`` of both
trees, its SASS instruction count and the SHA-256 of its instructions
(``cuobjdump -sass``, addresses and encodings dropped), and whether the
digests of a kernel of the same name are equal.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BATCHES = (1, 12, 128)


def build_tree(tree: Path, name: str) -> Path:
    """``TREE/dhts_torch/ops/cuda/csrc/<name>.cu`` built with this
    checkout's flags, named by its content (this checkout's build
    directory)."""
    from dhts_torch.ops.cuda import _build

    if tree.resolve() == ROOT.resolve():
        return _build.build(name)
    csrc = tree / "dhts_torch" / "ops" / "cuda" / "csrc"
    lib = _build.library_path(name, csrc)
    out = lib.with_name(lib.stem + "_tree.so")
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(tmp), str(csrc / f"{name}.cu")], check=True,
                       capture_output=True, timeout=600)
        os.replace(tmp, out)
    return out


def sass_digest(lib: Path, params: bool = True) -> dict:
    """``{kernel: {"instructions": n, "sha256": digest}}`` of a library; a
    kernel's mangled name without its anonymous namespace's tag, which
    differs between two trees' builds. Without ``params`` every offset into
    the kernel's parameters (``c[0x0][...]``) is blanked first."""
    from dhts_torch.ops.cuda import _build

    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "(anon)",
                          m.group(1))
            out[name] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if name and ins:
            text = ins.group(1)
            if not params:
                text = re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][.]",
                              text)
            out[name].append(text)
    return {k: {"instructions": len(v),
                "sha256": hashlib.sha256("\n".join(v).encode()).hexdigest()}
            for k, v in out.items()}


def sass(parent: Path, params: bool = True) -> dict:
    """Both trees' digests of every kernel (:func:`sass_digest`) and the
    kernels whose digests differ."""
    from concurrent.futures import ThreadPoolExecutor

    from dhts_torch.ops.cuda import _build

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    jobs = [(t, n) for t in (ROOT, parent) for n in names]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda j: build_tree(*j), jobs)))
    mine = {n: sass_digest(libs[ROOT, n], params) for n in names}
    theirs = {n: sass_digest(libs[parent, n], params) for n in names}
    equal = {n: {k: theirs[n].get(k) == d for k, d in mine[n].items()}
             for n in names}
    return {"unequal": [f"{n}: {k}" for n in names for k, e in
                        equal[n].items() if not e],
            "sass": mine, "parent_sass": theirs}


def runs(lib, consts, B: int, dev) -> dict:
    """``{launcher: call}`` of every K3 launcher ``lib`` has, at B."""
    import chip_smoke
    import torch

    from dhts_torch.ops.cuda import _launch
    from dhts_torch.ops.cuda import micro_rollout as k3

    V, T = chip_smoke.MICRO["V"], consts.num_steps
    ins = chip_smoke.micro_inputs(B, 22, dev)
    out = (torch.empty((B, V), device=dev), torch.empty((B, V), device=dev))
    cot = (torch.ones((B, V), device=dev), torch.ones((B, V), device=dev))
    g = torch.empty((B, 2 * V), device=dev)
    traj = torch.empty((B, T, 2, V), device=dev)
    s = _launch.stream(dev)
    tensors = {"fwd": (*ins, *out), "fwd_save": (*ins, *out, traj),
               "bwd": (*ins, *cot, g), "bwd_saved": (*ins, *cot, g, traj),
               "bwd_replay": (*ins, *cot, g, torch.empty_like(traj))}
    calls = {}
    for key, ts in tensors.items():
        name = f"launch_micro_rollout_{key}"
        if hasattr(lib, name):
            # the call keeps its tensors alive: the launcher gets pointers
            args = k3.kernel_args(consts, ts, B, V, s)
            calls[key] = (lambda f=getattr(lib, name), a=args, keep=ts:
                          _launch.raise_on(f(*a), "k3"))
    if "fwd_save" in calls:  # the trajectory bwd_saved reads
        calls["fwd_save"]()
    return calls, (out, g)


def outputs(lib, consts, B: int, dev) -> list:
    import torch

    calls, (out, g) = runs(lib, consts, B, dev)
    calls["fwd"]()
    res = [x.clone() for x in out]
    calls["bwd_saved" if "bwd_saved" in calls else "bwd"]()
    torch.cuda.synchronize()
    return res + [g.clone()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True, type=Path)
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--sass", action="store_true")
    args = p.parse_args(argv)
    import chip_smoke

    if args.sass:
        print(json.dumps({"tree": str(ROOT), "parent": str(args.parent),
                          **sass(args.parent)}), flush=True)
        return 0
    import torch

    from dhts_torch.models.vehicle import default_params
    from dhts_torch.ops.cuda import micro_rollout as k3

    if not torch.cuda.is_available():
        print("k3_timing.py needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    V = chip_smoke.MICRO["V"]
    consts = k3.micro_consts(default_params(chip_smoke.MICRO["u_max"], (V,)),
                             1000.0, 0.0, chip_smoke.MICRO["dt"],
                             chip_smoke.MICRO["T"], dev)
    libs = {"parent": k3.bind(ctypes.CDLL(str(build_tree(args.parent,
                                                         "micro_rollout")))),
            "this": k3._library()}
    # the same outputs: forwards bit for bit, gradients to rounding
    diff = {}
    for B in BATCHES:
        a, b = (outputs(libs[t], consts, B, dev) for t in ("parent", "this"))
        diff[B] = {"fwd_bit_equal": all(torch.equal(x, y) for x, y in
                                        zip(a[:2], b[:2])),
                   "grad_max_abs_diff": float((a[2] - b[2]).abs().max()),
                   "grad_max_abs": float(a[2].abs().max())}
    calls = {t: {B: runs(lib, consts, B, dev)[0] for B in BATCHES}
             for t, lib in libs.items()}
    for by_b in calls.values():
        for cs in by_b.values():
            for fn in cs.values():
                fn()
    torch.cuda.synchronize()
    visits = {"parent": [], "this": []}
    for _ in range(args.pairs):
        for t in ("parent", "this", "this", "parent"):
            visits[t].append({B: {k: chip_smoke.cuda_ms(fn, args.repeats, 20)
                                  for k, fn in calls[t][B].items()}
                              for B in BATCHES})
    pairs = {}
    for t, vs in visits.items():
        per_pair = []
        for i in range(args.pairs):
            two = vs[2 * i:2 * i + 2]
            rec = {B: {k: (two[0][B][k] + two[1][B][k]) / 2
                       for k in two[0][B]} for B in BATCHES}
            for B in BATCHES:
                r = rec[B]
                r["episode"] = (r["fwd_save"] + r["bwd_saved"]
                                if "bwd_saved" in r else r["fwd"] + r["bwd"])
            per_pair.append(rec)
        pairs[t] = per_pair

    def stats(xs):
        xs = sorted(xs)
        q = lambda f: xs[min(len(xs) - 1, int(f * (len(xs) - 1) + 0.5))]
        return {"median": q(0.5), "iqr": q(0.75) - q(0.25),
                "min": xs[0], "max": xs[-1]}

    summary, won = {}, {}
    versus = {"fwd": "fwd", "bwd_saved": "bwd", "episode": "episode"}
    for t, per_pair in pairs.items():
        summary[t] = {B: {k: stats([pp[B][k] for pp in per_pair])
                          for k in per_pair[0][B]} for B in BATCHES}
    for mine, theirs in versus.items():
        if mine not in pairs["this"][0][1]:
            continue
        won[mine] = {B: sum(pairs["this"][i][B][mine] <
                            pairs["parent"][i][B][theirs]
                            for i in range(args.pairs)) for B in BATCHES}
    print(json.dumps({"tree": str(ROOT), "parent": str(args.parent),
                      "nvidia_smi": chip_smoke.nvidia_smi(),
                      "pairs": args.pairs, "outputs": diff,
                      "summary": summary, "this_faster_in_pairs": won,
                      "versus": versus, "per_pair": pairs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
