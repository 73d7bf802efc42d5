"""The port's Trainer and run CLI against :mod:`dhts.apps.control.trainer`.

One ``train_step`` of the port against the JAX Trainer's jitted step, both
starting from the same controller parameters (``params_from_flax``) and fed
the same ``rand[E, T, L]`` (drawn by JAX from the step's keys, passed to the
port as numpy): loss rel 1e-4 and updated parameters rtol 1e-3 (float32
sums in another order; Adam divides by ``sqrt(v) + eps``) with an absolute
floor of a thousandth of one Adam step (``1e-3 * lr``: a weight drawn near
zero cancels against its first step of about ``lr``), for a constant
learning rate and for the cosine schedule with a global-norm clip that
fires. Then ``run.py`` on the CPU at a 1x1 hybrid config writes its
metrics, eval log and checkpoints.
"""

import json

import jax
import numpy as np
import pytest
import torch

from dhts.apps.control.itscp import problem as jproblem
from dhts.apps.control.itscp.env import ItscpEnv as JaxEnv
from dhts.apps.control.trainer import Trainer as JaxTrainer
from dhts_torch.apps.control.controller import params_from_flax
from dhts_torch.apps.control.itscp import problem, run
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.apps.control.trainer import Trainer, warmup_cosine_decay

# small tensors: one intra-op thread is fastest and leaves the cores to
# the other test workers
torch.set_num_threads(1)

CFG = dict(num_intersection=3, num_lane=1, lane_length=5.0,
           speed_limit=20.0, cell_length=5.0, policy_length=8,
           signal_length=2, simulation_frequency=10, random_seed=3,
           max_num_micro_vehicle_per_lane=4, mode="hybrid")
NET = (32, 32)


@pytest.mark.parametrize("schedule,clip", [("const", None), ("cosine", 1e-3)],
                         ids=["const", "cosine-clip"])
def test_train_step_matches_jax_trainer(schedule, clip):
    jenv = JaxEnv(config=CFG, schedule_fn=jproblem.problem_1)
    jenv.reset()
    jt = JaxTrainer(jenv, network_size=NET, lr=1e-3, seed=0,
                    lr_schedule=schedule, schedule_epochs=40, grad_clip=clip)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    rand = np.stack([np.asarray(jax.random.uniform(
        k, (jenv.num_timestep, jenv.spec.num_lanes))) for k in keys])
    params0 = jax.tree_util.tree_map(np.asarray, jt.params)
    new_params, _, loss_ref = jt._train_step(jt.params, jt.opt_state, keys)

    env = ItscpEnv(config=CFG, schedule_fn=problem.problem_1, device="cpu")
    env.reset()
    tr = Trainer(env, network_size=NET, lr=1e-3, seed=0,
                 lr_schedule=schedule, schedule_epochs=40, grad_clip=clip)
    tr.model.load_state_dict(params_from_flax(params0))
    loss = tr.train_step(2, rand=torch.as_tensor(rand))
    if clip:  # the clip fired: the gradient's norm was above it
        assert tr.grad_norm > clip
    assert loss == pytest.approx(float(loss_ref), rel=1e-4)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, new_params))
    got = tr.model.state_dict()
    for name, value in ref.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   rtol=1e-3, atol=1e-3 * 1e-3, err_msg=name)
    assert tr.step_count == 1


def test_warmup_cosine_decay_matches_optax():
    import optax

    ref = optax.warmup_cosine_decay_schedule(
        init_value=1e-4, peak_value=1e-3, warmup_steps=5, decay_steps=101,
        end_value=1e-4)
    for step in (0, 1, 4, 5, 6, 50, 100, 101, 150):
        assert warmup_cosine_decay(step, 1e-4, 1e-3, 5, 101, 1e-4) == \
            pytest.approx(float(ref(step)), rel=1e-5)


def test_trainer_refuses_paths_not_ported():
    env = ItscpEnv(config=dict(CFG, num_intersection=1),
                   schedule_fn=problem.problem_1, device="cpu")
    env.reset()
    for kwargs in (dict(mesh=object()), dict(render_eval=True)):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            Trainer(env, network_size=NET, **kwargs)


def test_run_cli_writes_logs_and_checkpoints(tmp_path):
    run.main(["--device", "cpu", "--mode", "hybrid", "--n_intersection",
              "1", "--n_lane", "1", "--lane_length", "10",
              "--simulation_length", "4", "--signal_length", "2",
              "--n_episode", "1", "--n_trial", "1", "--seed", "3",
              "--network_size", "16", "16", "--fused_episode",
              "--log_root", str(tmp_path)])
    (trial,) = tmp_path.glob("hybrid_*/trial_0")
    lines = [json.loads(x) for x in
             (trial / "metrics.jsonl").read_text().splitlines()]
    train = [x for x in lines if "loss_train" in x]
    evals = [x for x in lines if "reward_eval" in x]
    assert [x["epoch"] for x in train] == [0, 1]
    assert len(evals) == 2 and all(np.isfinite(x["loss_train"])
                                   for x in train)
    assert len((trial / "eval.txt").read_text().splitlines()) == 2
    blob = torch.load(trial / "model.pt")
    assert set(blob) >= {"params", "opt_state"} and blob["step"] == 2
    assert (trial / "best" / "model.pt").exists()
    # the checkpoint restores a trainer
    env = ItscpEnv(config=dict(CFG, num_intersection=1, lane_length=10.0,
                               policy_length=4, random_seed=3),
                   schedule_fn=problem.problem_1, device="cpu")
    env.reset()
    tr = Trainer(env, network_size=(16, 16), seed=9)
    tr.load(str(trial / "model.pt"))
    assert tr.step_count == 2
    for name, value in blob["params"].items():
        assert torch.equal(tr.model.state_dict()[name], value)


def test_warm_start_reproduces_the_floor_action(tmp_path):
    env = ItscpEnv(config=dict(CFG, num_intersection=2),
                   schedule_fn=problem.problem_1, device="cpu")
    env.reset()
    x = [0.2, 0.4, 0.6, 0.8]  # one action per intersection
    path = tmp_path / "floor.json"
    path.write_text(json.dumps({"cma_per_int_best_x": x}))
    tr = Trainer(env, network_size=NET, seed=0)
    run._warm_start_params(tr.model, str(path), env)
    with torch.no_grad():
        action = tr.action().numpy()
    np.testing.assert_allclose(action, np.tile(x, env.n_phases), rtol=1e-5)


def test_run_cli_defaults_to_the_card():
    assert run.build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run.main(["--n_trial", "1", "--n_episode", "1"])
