"""ITSCP training entry point of the port (counterpart of
:mod:`dhts.apps.control.itscp.run`, its single-device path).

The hybrid preset of ``run_itscp_hybrid.sh`` on the card, through kernel
K1's forward and backward::

    python -m dhts_torch.apps.control.itscp.run --mode hybrid --problem 1 \\
        --n_trial 1 --n_intersection 3 --n_lane 1 --lane_length 5 \\
        --speed_limit 60 --simulation_length 20 --signal_length 4 \\
        --n_episode 100 --lr 1e-4 --fused_episode

``--mesh 1,1 --mesh_fused`` trains through the fused spatial step (K6's
STEP body, one launch per simulation step, forward and derivative) on a
one-device ``(data, lane)`` mesh, one episode per data shard per epoch, as
the JAX CLI does. ``--mesh 1,S --mesh_fused`` shards the scene's lanes over
S processes, one per shard, through K6's per-shard bodies between
collectives; run it under ``torchrun --nproc_per_node S``. The CLI sets up
the process group from torchrun's environment (or uses one its caller has
set up): NCCL where each rank has a card of its own, gloo where ranks share
a card or run on the CPU; it prints the choice on its first line. Only rank
0 writes logs and checkpoints. A data axis of more than one device, and
``--mesh`` without ``--mesh_fused`` (the sharded scan step), raise
``NotImplementedError``. The spatial step has soft gates only: ``--gate_mode
st`` with ``--mesh_fused`` trains soft, as in JAX, and says so.

``--packed B`` trains one controller against B scenarios
(``env.reset_batch``) through ``env.packed_episode_fn``: one launch of K1's
forward and one of its backward per epoch for all B episodes, each with its
own observation and action. It implies ``--fused_episode`` and excludes
``--mesh``, as in JAX. ``--ep_per_epoch E`` runs a step's E draws as one
launch too.

``--device cpu`` runs the plain PyTorch path on the CPU. ``--wide_ops`` is
a TPU layout switch with no counterpart here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.apps.control.itscp.problem import PROBLEMS
from dhts_torch.apps.control.trainer import Trainer


def _warm_start_params(model, json_path, env):
    """Overwrite the controller head so ``squash(model(obs))`` reproduces a
    CMA-ES per-intersection action (``bench/itscp_floor.py --cma per_int``
    JSON, key ``cma_per_int_best_x``): head weight zeroed, head bias = the
    action logits. Hidden layers keep their random init."""
    with open(json_path) as f:
        ws = json.load(f)
    x = np.asarray(ws["cma_per_int_best_x"], np.float64)
    lo, hi = env.action_bounds()
    n_phases = env.action_size() // x.size
    tgt = np.tile(x, n_phases)
    pr = np.clip((tgt - lo) / (hi - lo), 1e-4, 1.0 - 1e-4)
    raw = np.log(pr / (1.0 - pr))  # inverse of squash_action's sigmoid
    if tuple(model.head.bias.shape) != raw.shape:
        raise ValueError(f"warm start has {raw.shape} logits for a head of "
                         f"{tuple(model.head.bias.shape)}")
    with torch.no_grad():
        model.head.weight.zero_()
        model.head.bias.copy_(torch.as_tensor(raw, dtype=torch.float32))


def build_parser():
    p = argparse.ArgumentParser("Intersection signal control (ITSCP), "
                                "PyTorch/CUDA port")
    p.add_argument("--mode", choices=["macro", "micro", "hybrid"],
                   default="macro")
    p.add_argument("--problem", type=int, choices=[0, 1, 2, 3], default=1,
                   help="0 = random schedule; 1-3 = sessioned NS/WE problems")
    p.add_argument("--n_trial", type=int, default=5)
    p.add_argument("--n_intersection", type=int, default=1)
    p.add_argument("--n_lane", type=int, default=3)
    p.add_argument("--lane_length", type=float, default=20.0)
    p.add_argument("--speed_limit", type=float, default=60.0)
    p.add_argument("--simulation_length", type=int, default=10,
                   help="policy length in seconds")
    p.add_argument("--signal_length", type=int, default=2)
    p.add_argument("--n_episode", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr_schedule", choices=["const", "cosine"],
                   default="const",
                   help="cosine: warmup + cosine decay over n_episode epochs")
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="global-norm gradient clip (0 = off)")
    p.add_argument("--ep_per_epoch", type=int, default=1,
                   help="episodes (random injection draws) averaged per "
                        "update")
    p.add_argument("--n_eval_episode", type=int, default=1,
                   help="hard-mode episodes averaged per eval point (fixed "
                        "draws, comparable across epochs)")
    p.add_argument("--gate_mode", choices=["soft", "st"], default="soft",
                   help="st: straight-through gates (hard forward values, "
                        "soft gradients); soft: reference parity")
    p.add_argument("--soft_gate_scale", type=float, default=1.0,
                   help="sharpen the soft signal gates by this factor "
                        "(training only; hard eval unchanged)")
    p.add_argument("--warm_start", type=str, default=None, metavar="JSON",
                   help="with --anneal_gates: warm-start the controller head "
                        "from a CMA-ES floor solution (cma_per_int_best_x)")
    p.add_argument("--eval_every", type=int, default=0, metavar="N",
                   help="hard-eval every N epochs (0 = n_episode // 10)")
    p.add_argument("--carry", choices=["last", "best"], default="last",
                   help="parameters carried across --anneal_gates stages")
    p.add_argument("--anneal_gates", type=str, default=None,
                   metavar="S:E,S:E,...",
                   help="staged gate-scale annealing: soft_gate_scale:epochs "
                        "stages; overrides --soft_gate_scale/--n_episode")
    p.add_argument("--network_size", type=int, nargs=2, default=(256, 256),
                   help="controller hidden widths")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_root", type=str,
                   default="result/control/itscp_torch")
    p.add_argument("--fused_episode", action="store_true",
                   help="train through the fused episode kernel K1 (forward "
                        "and backward on the card)")
    p.add_argument("--mesh", type=str, default=None, metavar="D,L",
                   help="train on a (data, lane) device mesh: 1,1 on one "
                        "device, 1,S over S processes (torchrun)")
    p.add_argument("--mesh_fused", action="store_true",
                   help="with --mesh: run each step as the fused spatial "
                        "step kernel (forward and derivative on the card)")
    p.add_argument("--packed", type=int, default=0, metavar="B",
                   help="train against B scenarios in one launch of the "
                        "fused episode (implies --fused_episode)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def _env(args, scale):
    return ItscpEnv(config=dict(
        num_intersection=args.n_intersection, num_lane=args.n_lane,
        lane_length=args.lane_length, speed_limit=args.speed_limit,
        policy_length=args.simulation_length,
        signal_length=args.signal_length, mode=args.mode,
        random_seed=args.seed, use_fused_episode=args.fused_episode,
        soft_gate_scale=scale, gate_mode=args.gate_mode),
        schedule_fn=PROBLEMS[args.problem], device=args.device)


def _trainer(args, env, seed, schedule_epochs, mesh=None):
    return Trainer(env, lr=args.lr, seed=seed,
                   network_size=tuple(args.network_size),
                   mesh=mesh, mesh_fused=args.mesh_fused,
                   multi_scenario=bool(args.packed), packed=bool(args.packed),
                   lr_schedule=args.lr_schedule,
                   schedule_epochs=schedule_epochs,
                   grad_clip=args.grad_clip)


MESH_WITHOUT_FUSED = ("--mesh without --mesh_fused runs the sharded scan "
                      "step (dhts/parallel/spatial.py), which is not ported "
                      "yet: ROADMAP.md queue 1, item 4")


def init_lanes(device: str, lanes: int):
    """Set up the default process group for a lane axis of ``lanes``
    shards from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``),
    unless the caller has set one up. NCCL where each local rank has a card
    of its own, gloo where ranks share a card or run on the CPU. Returns a
    line saying which."""
    import torch.distributed as dist

    if dist.is_initialized():
        return (f"process group: the caller's, {dist.get_backend()}, "
                f"{dist.get_world_size()} ranks")
    if "WORLD_SIZE" not in os.environ:
        return "process group: none (not started by torchrun)"
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ["WORLD_SIZE"]))
    own_card = (torch.device(device).type == "cuda" and
                torch.cuda.device_count() >= local_world)
    if own_card:
        torch.cuda.set_device(local_rank)
        backend, why = "nccl", "a card per rank"
    else:
        backend = "gloo"
        why = ("ranks on the CPU" if torch.device(device).type == "cpu" else
               f"{local_world} ranks share {torch.cuda.device_count()} "
               f"card(s); gloo stages CUDA tensors through host memory")
    dist.init_process_group(backend)
    return (f"process group: {backend} ({why}), rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, {lanes} lane shards")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.packed:
        if args.mesh:
            raise ValueError("--packed and --mesh are mutually exclusive")
        args.fused_episode = True
    mesh = None
    if args.mesh:
        from dhts_torch.parallel.mesh import make_mesh

        if not args.mesh_fused:
            raise NotImplementedError(MESH_WITHOUT_FUSED)
        d, l = (int(x) for x in args.mesh.split(","))
        if d == 1 and l > 1:
            import torch.distributed as dist

            line = init_lanes(args.device, l)
            if not dist.is_initialized() or dist.get_rank() == 0:
                print(line, flush=True)
        mesh = make_mesh({"data": d, "lane": l}, args.device)
        if args.mesh_fused and args.gate_mode == "st":
            print("--gate_mode st: the fused spatial step has soft gates "
                  "only; training soft", file=sys.stderr)
    run_name = os.path.join(args.log_root, f"{args.mode}_{int(time.time())}")
    trial_seed = lambda trial: args.seed + trial if args.seed > 0 else None

    if args.anneal_gates:
        if mesh is not None or args.packed:
            raise ValueError("--anneal_gates supports the single-device "
                             "paths only")
        stages = [(float(s.split(":")[0]), int(s.split(":")[1]))
                  for s in args.anneal_gates.split(",")]
        cadence = (args.eval_every if args.eval_every > 0 else
                   max(1, sum(e for _, e in stages) // 10))
        for trial in range(args.n_trial):
            log_path = os.path.join(run_name, f"trial_{trial}")
            os.makedirs(log_path, exist_ok=True)
            with open(os.path.join(log_path, "stages.json"), "w") as f:
                json.dump({"anneal_gates": stages}, f)
            params, best, offset = None, -float("inf"), 0
            for si, (scale, n_ep) in enumerate(stages):
                env = _env(args, scale)
                env.reset(seed=trial_seed(trial))
                trainer = _trainer(args, env, args.seed + trial, n_ep)
                if params is not None:
                    trainer.model.load_state_dict(params)  # params only
                elif args.warm_start:
                    _warm_start_params(trainer.model, args.warm_start, env)
                # the last stage gets the trailing +1 epoch so the final
                # eval point lands
                n = n_ep + (1 if si == len(stages) - 1 else 0)
                trainer.train(max(1, args.ep_per_epoch), n, cadence,
                              max(1, args.n_eval_episode), log_path,
                              initial_best=best, epoch_offset=offset)
                params = trainer.model.state_dict()
                best = trainer.best_eval_reward
                best_ckpt = os.path.join(log_path, "best", "model.pt")
                if args.carry == "best" and os.path.exists(best_ckpt):
                    params = torch.load(best_ckpt,
                                        map_location=env.device)["params"]
                offset += n
        return

    env = _env(args, args.soft_gate_scale)
    trained = []
    for trial in range(args.n_trial):
        if args.packed:
            env.reset_batch(args.packed, seed=trial_seed(trial))
        else:
            env.reset(seed=trial_seed(trial))
        trainer = _trainer(args, env, args.seed + trial, args.n_episode + 1,
                           mesh)
        log_path = os.path.join(run_name, f"trial_{trial}")
        # one episode per data shard per epoch on a mesh, as in JAX
        ep_per_epoch = (mesh.shape["data"] if mesh is not None
                        else max(1, args.ep_per_epoch))
        losses = trainer.train(ep_per_epoch, args.n_episode + 1,
                               (args.eval_every if args.eval_every > 0 else
                                max(1, args.n_episode // 10)),
                               max(1, args.n_eval_episode), log_path)
        trained.append((trainer, losses))
    # every rank's trainers and losses, for a caller that checks the ranks
    return trained


if __name__ == "__main__":
    main()
