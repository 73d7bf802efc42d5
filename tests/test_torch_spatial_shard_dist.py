"""The lane-sharded fused spatial step across processes: S gloo ranks on the
CPU, one lane shard each, joined by a ``FileStore`` (no ports;
``dhts_torch.parallel.local_ranks``), at the 3x3 hybrid scene of the JAX
package's spatial tests with a short horizon (policy_length 2: T = 20 steps,
144 lanes, 9 actions).

In one spawn per shard count (S = 2, 4), every rank:

* holds the same draws ``[B, T, L]``, schedule and routes (compared across
  ranks);
* runs the sharded episode through ``make_fused_spatial_episode`` on a
  ``(1, S)`` mesh, hard and soft: queues, events and wave maxima bit-equal
  to the one-process single-shard episode on every rank; the collectives
  per step are 2 lane gathers (gA; gF with gI) and 2 sums of
  per-lane terms (the running means; hard mode skips the signal mean's,
  as JAX does), and per episode one gather-and-sum of the queues, one
  psum of the events and one pmax;
* differentiates the soft reward by K5's op (forward mode through the
  ranks): the whole action gradient on every rank, bit-equal to the
  single-shard forward-mode derivative and within cosine 0.99999 of
  ``jax.grad`` of JAX's sharded episode on 2 virtual devices (the draw is
  off the acceleration floor: its floor-hit count is asserted to be 0);
* takes one Trainer step on the mesh: the loss equals the one-process
  loss, and the parameters are bit-identical on every rank afterwards.

Then ``python -m dhts_torch.apps.control.itscp.run --mesh 1,2 --mesh_fused
--device cpu`` trains one epoch under ``torchrun`` through the CLI's own
process-group set-up, which says on its first line that it chose gloo;
rank 0 alone writes the logs and checkpoints.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.apps.control.trainer import Trainer
from dhts_torch.ops.cuda import itscp_spatial_step as k6
from dhts_torch.parallel.local_ranks import run_local
from dhts_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

SHORT_CFG = dict(num_intersection=3, num_lane=1, lane_length=5.0,
                 speed_limit=20.0, cell_length=5.0, policy_length=2,
                 signal_length=2, simulation_frequency=10, random_seed=3,
                 max_num_micro_vehicle_per_lane=4, mode="hybrid")
WIDTHS = (8, 8)
REPO = Path(__file__).resolve().parents[1]


def port_env():
    env = ItscpEnv(config=SHORT_CFG, schedule_fn=problem.problem_1,
                   device="cpu")
    env.reset()
    return env


# JAX is imported where it is used: the spawned ranks import this module
# to find their function, and need the port alone


@functools.lru_cache(maxsize=None)
def draws():
    """The JAX test's draw ``uniform(PRNGKey(0), (T, L))`` and an action
    off the floor (``test_torch_spatial_grad.py``)."""
    import jax

    from dhts.apps.control.itscp import problem as jproblem
    from dhts.apps.control.itscp.env import ItscpEnv as JaxEnv

    jenv = JaxEnv(config=SHORT_CFG, schedule_fn=jproblem.problem_1)
    jenv.reset()
    key = jax.random.PRNGKey(0)
    rand = np.array(jax.random.uniform(key, (jenv.num_timestep,
                                             jenv.spec.num_lanes)))
    action = np.random.default_rng(2).uniform(
        0.1, 0.15, jenv.action_size()).astype(np.float32)
    return jenv, key, rand, action


def _rank(rank, S, rand, action):
    """One rank's share of the checks; returns what the parent compares."""
    from dhts_torch.parallel import collectives

    env = port_env()
    mesh = make_mesh({"data": 1, "lane": S}, "cpu")
    rand = torch.as_tensor(rand)
    d = env.data
    out = dict(scene=[rand, d.schedule, d.mroute_next, d.mroute_prev,
                      k6.route_table(d.inj_routes,
                                     env.base_state.route_pool)])
    hard = k6.make_fused_spatial_episode(env, mesh, differentiable=False)
    before = dict(collectives.counts)
    res = hard(torch.as_tensor(action), rand)
    out["hard_counts"] = {k: collectives.counts[k] - before[k]
                          for k in before}
    out["hard"] = (res.queue_per_step, res.events_per_step)
    soft = k6.make_fused_spatial_episode(env, mesh)
    a = torch.tensor(action, requires_grad=True)
    before = dict(collectives.counts)
    res = soft(a, rand)
    out["counts"] = {k: collectives.counts[k] - before[k] for k in before}
    res.reward.backward()
    out["soft"] = (res.queue_per_step.detach(), res.events_per_step,
                   res.max_wave_speed)
    out["grad"] = a.grad
    trainer = Trainer(env, network_size=WIDTHS, lr=1e-2, seed=5, mesh=mesh,
                      mesh_fused=True)
    gen = torch.Generator().manual_seed(9)
    out["train_rand"] = torch.stack([env.draw_rand(gen)])
    out["loss"] = trainer.train_step(rand=out["train_rand"])
    out["params"] = [p.detach().clone() for p in trainer.model.parameters()]
    return out


@functools.lru_cache(maxsize=None)
def jax_sharded_grad():
    """``jax.grad`` of the reward of JAX's sharded episode on 2 virtual
    devices at the draws of :func:`draws` (computed once: its compilation
    takes most of its time; the port's gradient is bit-equal at every
    shard count)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from dhts.ops.pallas.itscp_spatial_step import \
        make_fused_spatial_episode as jax_spatial_episode

    jenv, key, _, action = draws()
    ep = jax_spatial_episode(jenv, Mesh(np.array(jax.devices()[:2]),
                                        ("lane",)), differentiable=True)
    return np.asarray(jax.grad(lambda a: ep(a, key).reward)(
        jnp.asarray(action)))


def cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@functools.lru_cache(maxsize=None)
def single_shard():
    """The one-process references on the draws of :func:`draws`: the soft
    plan, the episode inputs, the hard and soft plain episodes, the
    single-shard forward-mode derivative of the reward (computed once for
    every shard count; read only)."""
    _, _, rand, action = draws()
    env = port_env()
    plan = k6.make_plan(env, True)
    d = env.data
    inputs = (torch.as_tensor(action).reshape(plan.n_phases, -1),
              torch.as_tensor(rand)[None], d.schedule, d.mroute_next,
              d.mroute_prev, k6.route_table(d.inj_routes,
                                            env.base_state.route_pool))
    hard_ref = k6.plain_spatial_episode(k6.make_plan(env, False), *inputs)
    soft_ref = k6.plain_spatial_episode(plan, *inputs)
    w = torch.full((1, plan.T), -1.0)  # d(reward)/d(queues)
    fb, db, ib = k6.dual_state(plan, 1, "cpu")
    g64 = torch.zeros(fb.shape[0], dtype=torch.float64)
    k6.plain_spatial_step_bwd(plan, fb, db, ib, 0, plan.T, inputs, w, g64)
    return plan, inputs, hard_ref, soft_ref, g64.to(torch.float32)


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_episode_gradient_and_train_step_across_ranks(S):
    _, _, rand, action = draws()
    outs = run_local(_rank, S, args=(rand, action), timeout=300)

    plan, inputs, hard_ref, soft_ref, grad_ref = single_shard()
    T = plan.T
    for r, o in enumerate(outs):
        for x, y in zip(o["scene"], outs[0]["scene"]):
            assert torch.equal(x, y), r
        assert torch.equal(o["hard"][0], hard_ref[0][0]), r
        assert torch.equal(o["hard"][1], hard_ref[1][0]), r
        assert torch.equal(o["soft"][0], soft_ref[0][0].detach()), r
        assert torch.equal(o["soft"][1], soft_ref[1][0]), r
        assert torch.equal(o["soft"][2], soft_ref[2][0].amax()), r
        # per step the post-physics rows' gather and the two sums (the
        # next step's A rows ride in the static terms' gather), and A's
        # gather once, at step 0: 3T + 1 calls between the bodies
        assert o["counts"] == {"all_gather": T + 1, "psum": 2 * T + 2,
                               "pmax": 1}, o["counts"]
        # hard mode skips the signal mean's sum (JAX: ``if diff``): 2T + 1
        assert o["hard_counts"] == {"all_gather": T + 1, "psum": T + 2,
                                    "pmax": 1}, o["hard_counts"]
        assert torch.equal(o["grad"], grad_ref), r
        assert o["loss"] == outs[0]["loss"]
        for p, q in zip(o["params"], outs[0]["params"]):
            assert torch.equal(p, q), r
    got = outs[0]["grad"].numpy()
    assert np.all(np.isfinite(got)) and np.linalg.norm(got) > 0
    hits = k6.floor_hits(plan, inputs[0], *inputs[1:])
    assert int(hits) == 0
    assert cosine(got, jax_sharded_grad()) > 0.99999
    # the loss of the one-process Trainer on the same draws
    single = Trainer(port_env(), network_size=WIDTHS, lr=1e-2, seed=5,
                     mesh=make_mesh({"data": 1, "lane": 1}, "cpu"),
                     mesh_fused=True)
    assert outs[0]["loss"] == single.train_step(rand=outs[0]["train_rand"])


def test_run_cli_trains_on_two_lane_shards_under_torchrun(tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "dhts_torch.apps.control.itscp.run",
           "--device", "cpu", "--mode", "hybrid", "--n_intersection", "1",
           "--n_lane", "1", "--lane_length", "10", "--simulation_length",
           "2", "--n_episode", "0", "--n_trial", "1", "--seed", "3",
           "--network_size", "8", "8", "--mesh", "1,2", "--mesh_fused",
           "--log_root", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("process group: gloo"), lines[:3]
    assert sum("loss" in ln for ln in lines) == 1  # rank 0 only, 1 epoch
    (trial,) = tmp_path.glob("hybrid_*/trial_0")
    for name in ("metrics.jsonl", "eval.txt", "model.pt", "best/model.pt"):
        assert (trial / name).exists(), name
    assert len(list(tmp_path.glob("hybrid_*"))) == 1
