"""The scenario batch of the port against :mod:`dhts.apps.control.itscp.env`
and :mod:`dhts.apps.control.trainer`: ``reset_batch``, ``episode_batch``,
``packed_episode_fn``, the multi-scenario and packed Trainer, and ``run
--packed``.

On the CPU the port's fused episode is K1's plain version, one episode after
another; on the card it is one launch for the batch (held against single
launches by ``test_torch_episode_batch_host.py`` and, on the card,
``test_torch_card_batch.py``). The JAX side runs its own fused kernel in
interpret mode (or its scan env where its ``episode_batch`` takes it: the
hard episodes). The draws are JAX's ``uniform(key, (T, L))`` of the same
keys, passed to the port as ``rand``.

* ``reset_batch(3, seed=11)``: batch data, observations, the emission pool
  and the leader window equal to JAX's.
* ``episode_batch``, hard and soft: event rows 0-6 exact (all eight rows
  from the kernel, its EpisodeResult's three from ``episode_batch``), max
  wave speed rel 1e-5, reward rel 1e-4, queues abs 1e-4.
* ``packed_episode_fn``: JAX's own packed standard
  (``tests/test_itscp_hybrid_fused.py``): rewards rtol 1e-5, pack totals
  equal, emissions > 0, the soft action gradient of the rewards' sum within
  cosine 0.99999 and max rel 1e-4.
* The Trainer's first step (single scenario with E = 2 draws in one fused
  call, multi-scenario, packed) against the JAX Trainer's jitted step from
  the same parameters (``params_from_flax``): loss rel 1e-4, updated
  parameters as in ``test_torch_trainer.py``.
* ``run.main([... "--packed", "2"])`` at a 1x1 config writes its logs.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhts.apps.control.itscp import problem as jproblem
from dhts.apps.control.itscp.env import ItscpEnv as JaxEnv
from dhts.apps.control.trainer import Trainer as JaxTrainer
from dhts_torch.apps.control.controller import params_from_flax
from dhts_torch.apps.control.itscp import problem, run
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.apps.control.trainer import Trainer
from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

torch.set_num_threads(1)

EMISSION_CFG = dict(num_intersection=3, num_lane=1, lane_length=5.0,
                    speed_limit=20.0, cell_length=5.0, policy_length=16,
                    signal_length=2, simulation_frequency=10, random_seed=3,
                    max_num_micro_vehicle_per_lane=4, mode="hybrid",
                    use_fused_episode=True)
TRAIN_CFG = dict(EMISSION_CFG, num_intersection=2, policy_length=8)
NET = (16, 16)
B = 3


def jax_rand(keys, T, L):
    return np.stack([np.asarray(jax.random.uniform(k, (T, L)))
                     for k in keys])


@functools.lru_cache(maxsize=None)
def batch_envs(cfg_items=tuple(sorted(EMISSION_CFG.items())), batch=B,
               seed=11):
    """The JAX and port envs after ``reset_batch(batch, seed)`` (read
    only)."""
    cfg = dict(cfg_items)
    jenv = JaxEnv(config=cfg, schedule_fn=jproblem.problem_1)
    jobs = jenv.reset_batch(batch, seed=seed)
    env = ItscpEnv(config=cfg, schedule_fn=problem.problem_1, device="cpu")
    obs = env.reset_batch(batch, seed=seed)
    return jenv, jobs, env, obs


def actions_of(env, batch=B, seed=0):
    return np.random.default_rng(seed).uniform(
        0.3, 0.7, (batch, env.action_size())).astype(np.float32)


def test_reset_batch_matches_jax():
    jenv, jobs, env, obs = batch_envs()
    assert obs.shape == (B, env.observation_size())
    np.testing.assert_array_equal(obs, jobs)
    assert len(np.unique(obs.sum(axis=1))) == B  # the scenarios differ
    for name, x in env.batch_data._asdict().items():
        ref = np.asarray(getattr(jenv.batch_data, name))
        assert x.shape[0] == B
        np.testing.assert_array_equal(x.numpy(), ref, err_msg=name)
        # ``data`` is the last scenario's
        np.testing.assert_array_equal(getattr(env.data, name).numpy(),
                                      ref[-1], err_msg=name)
    np.testing.assert_array_equal(env.base_state.route_pool.numpy(),
                                  np.asarray(jenv.base_state.route_pool))
    assert env._fused_win_needed == jenv._fused_win_needed


def jax_kernel_events(jenv, actions, keys, differentiable, n_phases):
    """All eight event rows of JAX's fused kernel on the batch, vmapped as
    its ``episode_batch`` runs it."""
    jenv._fused_episode_one(differentiable)
    fn = (jenv._fused_hyb_fn if differentiable else jenv._fused_hyb_fn_hard)
    T, L = jenv.num_timestep, jenv.spec.num_lanes
    pool = jenv.base_state.route_pool

    def one(a, d, k):
        return fn(a.reshape(n_phases, -1),
                  d.schedule, d.mroute_next, d.mroute_prev,
                  jax.random.uniform(k, (T, L)), d.inj_routes, pool,
                  with_events=True)[2]

    return np.asarray(jax.vmap(one)(jnp.asarray(actions), jenv.batch_data,
                                    keys))


@pytest.mark.parametrize("differentiable", [False, True],
                         ids=["hard", "soft"])
def test_episode_batch_matches_jax(differentiable):
    jenv, _, env, _ = batch_envs()
    actions = actions_of(env)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    rand = torch.as_tensor(jax_rand(keys, env.num_timestep,
                                    env.spec.num_lanes))
    ref = jenv.episode_batch(jnp.asarray(actions), differentiable, keys)
    ref_ev = jax_kernel_events(jenv, actions, keys, differentiable,
                               env.n_phases)
    with torch.no_grad():
        got = env.episode_batch(torch.as_tensor(actions), differentiable,
                                rand)
        a2 = torch.as_tensor(actions).reshape(B, env.n_phases, -1)
        bd = env.batch_data
        _, _, got_ev = env._fused_episode_fn(differentiable)(
            a2, bd.schedule, bd.mroute_next, bd.mroute_prev, rand,
            bd.inj_routes, env.base_state.route_pool, with_events=True)
    assert got_ev.shape == (B, env.num_timestep, 8)
    np.testing.assert_array_equal(got_ev[..., :7].numpy(), ref_ev[..., :7])
    np.testing.assert_allclose(got_ev[..., 7].numpy(), ref_ev[..., 7],
                               rtol=1e-5)
    np.testing.assert_array_equal(got.events_per_step.numpy(),
                                  np.asarray(ref.events_per_step))
    np.testing.assert_allclose(got.reward.numpy(), np.asarray(ref.reward),
                               rtol=1e-4)
    np.testing.assert_allclose(got.queue_per_step.numpy(),
                               np.asarray(ref.queue_per_step), rtol=0,
                               atol=1e-4)
    for name in ("emitted", "absorbed", "injected"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert len(set(got.reward.tolist())) == B


def test_episode_batch_without_the_fused_episode_runs_the_scan_env():
    _, _, env, _ = batch_envs()
    scan = ItscpEnv(config=dict(EMISSION_CFG, use_fused_episode=False),
                    schedule_fn=problem.problem_1, device="cpu")
    scan.reset_batch(B, seed=11)
    actions = torch.as_tensor(actions_of(env))
    gen = torch.Generator().manual_seed(3)
    rand = torch.stack([env.draw_rand(gen) for _ in range(B)])
    got = scan.episode_batch(actions, False, rand)
    ref = env.episode_batch(actions, False, rand)
    assert torch.equal(got.events_per_step, ref.events_per_step)
    np.testing.assert_allclose(got.reward.numpy(), ref.reward.numpy(),
                               rtol=1e-5)
    # a generator draws one rand per scenario, as draw_rand does
    res = scan.episode_batch(actions, False, torch.Generator().manual_seed(3))
    assert torch.equal(res.reward, got.reward)


def cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_packed_episode_fn_matches_jax():
    jenv, _, env, _ = batch_envs()
    actions = np.stack([np.full(env.action_size(), 0.45, np.float32),
                        np.full(env.action_size(), 0.62, np.float32),
                        np.full(env.action_size(), 0.55, np.float32)])
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    rand = torch.as_tensor(jax_rand(keys, env.num_timestep,
                                    env.spec.num_lanes))
    jrun = jenv.packed_episode_fn()
    ref = jax.jit(jrun)(jnp.asarray(actions), keys)
    g_ref = np.asarray(jax.jit(jax.grad(
        lambda a: jnp.sum(jrun(a, keys).reward)))(jnp.asarray(actions)))

    prun = env.packed_episode_fn()
    a = torch.tensor(actions, requires_grad=True)
    got = prun(a, rand)
    torch.sum(got.reward).backward()
    np.testing.assert_allclose(got.reward.detach().numpy(),
                               np.asarray(ref.reward), rtol=1e-5)
    np.testing.assert_allclose(got.queue_per_step.detach().numpy(),
                               np.asarray(ref.queue_per_step), atol=1e-4)
    for name in ("emitted", "absorbed", "injected"):
        assert int(getattr(got, name)) == int(getattr(ref, name)), name
    assert int(got.emitted) > 0
    assert got.events_per_step.shape == (env.num_timestep, 3)
    g = a.grad.numpy()
    assert np.all(np.isfinite(g))
    assert cosine(g, g_ref) > 0.99999
    assert np.max(np.abs(g - g_ref)) / np.max(np.abs(g_ref)) < 1e-4


@pytest.mark.parametrize("kind", ["single", "multi", "packed"])
def test_first_train_step_matches_jax_trainer(kind):
    multi = kind != "single"
    jenv = JaxEnv(config=TRAIN_CFG, schedule_fn=jproblem.problem_1)
    env = ItscpEnv(config=TRAIN_CFG, schedule_fn=problem.problem_1,
                   device="cpu")
    if multi:
        jenv.reset_batch(2, seed=5)
        env.reset_batch(2, seed=5)
    else:
        jenv.reset()
        env.reset()
    jt = JaxTrainer(jenv, network_size=NET, lr=1e-3, seed=0,
                    multi_scenario=multi, packed=kind == "packed")
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    rand = jax_rand(keys, jenv.num_timestep, jenv.spec.num_lanes)
    params0 = jax.tree_util.tree_map(np.asarray, jt.params)
    new_params, _, loss_ref = jt._train_step(jt.params, jt.opt_state, keys)

    tr = Trainer(env, network_size=NET, lr=1e-3, seed=0,
                 multi_scenario=multi, packed=kind == "packed")
    tr.model.load_state_dict(params_from_flax(params0))
    assert tuple(tr.action().shape) == ((2,) if multi else ()) + (
        env.action_size(),)
    loss = tr.train_step(2, rand=torch.as_tensor(rand))
    assert loss == pytest.approx(float(loss_ref), rel=1e-4)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, new_params))
    got = tr.model.state_dict()
    for name, value in ref.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   rtol=1e-3, atol=1e-3 * 1e-3, err_msg=name)


def test_trainer_checks_the_scenario_batch():
    env = ItscpEnv(config=dict(TRAIN_CFG, num_intersection=1),
                   schedule_fn=problem.problem_1, device="cpu")
    env.reset()
    with pytest.raises(ValueError, match="reset_batch"):
        Trainer(env, network_size=NET, multi_scenario=True)
    with pytest.raises(ValueError, match="multi_scenario=True"):
        Trainer(env, network_size=NET, packed=True)
    with pytest.raises(ValueError, match="reset_batch"):
        env.packed_episode_fn()


def test_episode_axes_must_agree():
    _, _, env, _ = batch_envs()
    plan = env.fused_plan(False)
    bd = env.batch_data
    rand = torch.zeros((2, env.num_timestep, env.spec.num_lanes))
    action = torch.full((B, env.n_phases, plan.n_inter), 0.5)
    inputs = (action, bd.schedule, bd.mroute_next, bd.mroute_prev, rand,
              bd.inj_routes, env.base_state.route_pool)
    with pytest.raises(ValueError, match="disagree"):
        k1.episode_count(inputs)


def test_run_cli_trains_packed(tmp_path):
    run.main(["--device", "cpu", "--mode", "hybrid", "--n_intersection",
              "1", "--n_lane", "1", "--lane_length", "10",
              "--simulation_length", "4", "--signal_length", "2",
              "--n_episode", "1", "--n_trial", "1", "--seed", "3",
              "--network_size", "16", "16", "--packed", "2",
              "--log_root", str(tmp_path)])
    (trial,) = tmp_path.glob("hybrid_*/trial_0")
    lines = [json.loads(x) for x in
             (trial / "metrics.jsonl").read_text().splitlines()]
    train = [x for x in lines if "loss_train" in x]
    assert [x["epoch"] for x in train] == [0, 1]
    assert all(np.isfinite(x["loss_train"]) for x in train)
    assert len((trial / "eval.txt").read_text().splitlines()) == 2
    for name in ("model.pt", "best/model.pt"):
        assert (trial / name).exists(), name
    with pytest.raises(ValueError, match="mutually exclusive"):
        run.main(["--device", "cpu", "--packed", "2", "--mesh", "1,1",
                  "--mesh_fused"])
