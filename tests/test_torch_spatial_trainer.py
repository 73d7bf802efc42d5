"""The port's Trainer and ``run`` CLI on the fused spatial step
(``mesh_fused`` on a one-device ``(data, lane)`` mesh), on the CPU.

* The first loss of ``Trainer(mesh=make_mesh({"data": 1, "lane": 1}),
  mesh_fused=True)`` equals the loss of the JAX package's fused spatial
  train step on a one-device mesh (rel 1e-5): the controller carried across
  with ``params_from_flax``, the same two draws ``uniform(key_b, (T, L))``.
  The yardstick is the single-axis ``make_fused_spatial_train_step``: the
  JAX package's ``make_fused_spatial_train_step_2d``, which its Trainer
  runs for ``mesh_fused``, raises on a ``(1, 1)`` mesh (its one-shard path
  hands the step kernel a ``[lp]`` draw row where the kernel's custom VJP
  expects ``[1, lp]``), as asserted here; the JAX package's own test holds
  the two variants' losses equal (rtol 1e-5) on a 2 x 4 mesh. Two steps:
  finite losses, moved parameters.
* The port's single-axis ``make_fused_spatial_train_step`` with the
  Trainer's ``apply_update`` takes the same two steps as the Trainer's own
  ``(data, lane)`` step, which runs ``make_fused_spatial_train_step_2d``.
* ``python -m dhts_torch.apps.control.itscp.run --mesh 1,1 --mesh_fused
  --device cpu`` trains one small epoch and evaluates; ``--gate_mode st``
  trains soft and says so.
* A data axis of more than one device and ``--mesh`` without
  ``--mesh_fused`` raise ``NotImplementedError``; lane shards without a
  process group raise ``RuntimeError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from dhts.apps.control.controller import Controller as JaxController
from dhts.apps.control.itscp import problem as jproblem
from dhts.apps.control.itscp.env import ItscpEnv as JaxEnv
from dhts.ops.pallas.itscp_spatial_step import (
    make_fused_spatial_train_step, make_fused_spatial_train_step_2d)
from dhts_torch.apps.control.controller import params_from_flax
from dhts_torch.apps.control.itscp import problem, run
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.apps.control.trainer import Trainer
from dhts_torch.ops.cuda import itscp_spatial_step as k6
from dhts_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

MICRO_CFG = dict(num_intersection=1, num_lane=2, lane_length=20.0,
                 speed_limit=20.0, cell_length=5.0, policy_length=4,
                 signal_length=2, simulation_frequency=10, random_seed=3,
                 max_num_micro_vehicle_per_lane=4, mode="micro")
WIDTHS = (16, 16)


def test_first_loss_matches_jax_fused_spatial_train_step():
    jenv = JaxEnv(config=MICRO_CFG, schedule_fn=jproblem.problem_1)
    jenv.reset()
    obs = jnp.asarray(jenv.observe())
    low, high = jenv.action_bounds()
    model = JaxController(output_size=jenv.action_size(),
                          network_size=WIDTHS)
    params = model.init(jax.random.PRNGKey(0), obs)
    opt = optax.adam(1e-3)
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    mesh2 = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "lane"))
    step2d = make_fused_spatial_train_step_2d(jenv, model, opt, mesh2, obs,
                                              low, high)
    with pytest.raises(ValueError, match="Custom VJP"):
        step2d(params, opt.init(params), keys)
    step = make_fused_spatial_train_step(
        jenv, model, opt, Mesh(np.array(jax.devices()[:1]), ("lane",)), obs,
        low, high)
    _, _, jax_loss = step(params, opt.init(params), keys)
    T, L = jenv.num_timestep, jenv.spec.num_lanes
    rand = torch.stack([torch.as_tensor(np.array(jax.random.uniform(
        k, (T, L)))) for k in keys])

    env = ItscpEnv(config=MICRO_CFG, schedule_fn=problem.problem_1,
                   device="cpu")
    env.reset()
    trainer = Trainer(env, network_size=WIDTHS, lr=1e-3,
                      mesh=make_mesh({"data": 1, "lane": 1}, "cpu"),
                      mesh_fused=True)
    trainer.model.load_state_dict(params_from_flax(params))
    before = [p.detach().clone() for p in trainer.model.parameters()]
    loss = trainer.train_step(2, rand=rand)
    assert loss == pytest.approx(float(jax_loss), rel=1e-5)
    loss2 = trainer.train_step(2)
    assert np.isfinite(loss2)
    assert any(not torch.equal(a, b.detach()) for a, b in
               zip(before, trainer.model.parameters()))


def test_fused_spatial_train_step_updates_the_controller():
    """The single-axis factory on a ``("lane",)`` mesh, with the Trainer's
    update, takes the same steps as the Trainer's own (data, lane) step:
    equal losses, equal parameters after two updates, and the parameters
    moved."""
    env = ItscpEnv(config=MICRO_CFG, schedule_fn=problem.problem_1,
                   device="cpu")
    env.reset()
    ref = Trainer(env, network_size=WIDTHS, lr=1e-2,
                  mesh=make_mesh({"data": 1, "lane": 1}, "cpu"),
                  mesh_fused=True)
    trainer = Trainer(env, network_size=WIDTHS, lr=1e-2)
    step = k6.make_fused_spatial_train_step(
        env, trainer.model, trainer.apply_update,
        make_mesh({"lane": 1}, "cpu"), env.observe(), *env.action_bounds())
    with pytest.raises(ValueError, match="data"):
        k6.make_fused_spatial_train_step_2d(
            env, trainer.model, trainer.apply_update,
            make_mesh({"lane": 1}, "cpu"), env.observe(),
            *env.action_bounds())
    gen = torch.Generator().manual_seed(4)
    rand = torch.stack([env.draw_rand(gen) for _ in range(2)])
    before = [p.detach().clone() for p in trainer.model.parameters()]
    losses = [step(rand), step(rand)]
    assert losses == [ref.train_step(rand=rand), ref.train_step(rand=rand)]
    assert all(np.isfinite(losses)) and trainer.step_count == 2
    assert any(not torch.equal(a, b.detach()) for a, b in
               zip(before, trainer.model.parameters()))
    for a, b in zip(ref.model.parameters(), trainer.model.parameters()):
        assert torch.equal(a, b)


def test_run_cli_trains_on_the_fused_spatial_step(tmp_path, capsys):
    run.main(["--device", "cpu", "--mode", "hybrid", "--n_intersection", "1",
              "--n_lane", "1", "--lane_length", "10",
              "--simulation_length", "4", "--n_episode", "1", "--n_trial",
              "1", "--seed", "3", "--network_size", "8", "8", "--mesh",
              "1,1", "--mesh_fused", "--gate_mode", "st", "--log_root",
              str(tmp_path)])
    out = capsys.readouterr()
    assert "soft gates only" in out.err
    assert "loss" in out.out and "eval" in out.out
    (trial,) = tmp_path.glob("hybrid_*/trial_0")
    for name in ("metrics.jsonl", "eval.txt", "model.pt", "best/model.pt"):
        assert (trial / name).exists(), name


@pytest.mark.parametrize("mesh", ["2,1", "1,2"])
def test_run_cli_refuses_meshes_of_more_than_one_device(tmp_path, mesh):
    """What still raises: a data axis of more than one device (not ported,
    naming ROADMAP.md), and lane shards in a process that torchrun did not
    start (no process group; the sharded run is in
    ``tests/test_torch_spatial_shard_dist.py``)."""
    error, match = ((NotImplementedError, "ROADMAP") if mesh == "2,1" else
                    (RuntimeError, "torch.distributed"))
    with pytest.raises(error, match=match):
        run.main(["--device", "cpu", "--mesh", mesh, "--mesh_fused",
                  "--log_root", str(tmp_path)])


def test_mesh_without_mesh_fused_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="mesh without.*ROADMAP"):
        run.main(["--device", "cpu", "--mesh", "1,1", "--n_intersection",
                  "1", "--n_lane", "1", "--simulation_length", "4",
                  "--log_root", str(tmp_path)])
