"""The port's inverse benchmarks (:mod:`dhts_torch.apps.inverse`) against
:mod:`dhts.apps.inverse` on the CPU.

Both sides build the trial from ``np.random.default_rng(seed)`` with the
same numpy draws in the same order, so scenes, true states and starting
points are equal. Tolerances: the target end state and the GD end-error
trajectory rtol 1e-3, atol 1e-5 (the JAX package's own fused-vs-scan
standard, ``tests/test_inverse.py``; float32 rollouts an ulp apart here
and there, and Adam's first steps are nearly sign steps). Small sizes: 6
cells or vehicles, T = 40 steps (80 for the hybrid chain, where the first
vehicle is emitted onto the micro lane), 6 episodes.

On the CPU the fused rollout (``fused_rollout=True``) runs
:class:`MacroRolloutFunction` / :class:`MicroRolloutFunction` around the
plain versions, the kernels' specification; it must give the unfused
path's numbers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhts.apps.inverse.hybrid import HybridInverseProblem as JHybrid
from dhts.apps.inverse.macro import MacroInverseProblem as JMacro
from dhts.apps.inverse.micro import MicroInverseProblem as JMicro
from dhts.models import network as jnetwork
from dhts.models import scene as jscene
from dhts_torch.apps.inverse import hybrid, macro, micro
from dhts_torch.models import network, scene

torch.set_num_threads(1)

SEED = 11
KINDS = {
    "macro": (macro.MacroInverseProblem, JMacro,
              dict(num_cell=6, cell_length=5.0), 40),
    "micro": (micro.MicroInverseProblem, JMicro,
              dict(num_vehicle=6, vehicle_length=5.0), 40),
    "hybrid": (hybrid.HybridInverseProblem, JHybrid,
               dict(num_cell=6, cell_length=5.0), 80),
}


def problem(cls, kw, T, tmp_path, episodes=6, **extra):
    prob = cls(num_trial=1, num_timestep=T, num_episode=episodes,
               delta_time=0.01, speed_limit=30.0, run_name="t",
               log_root=str(tmp_path), seed=SEED, **kw, **extra)
    rng = np.random.default_rng(SEED)
    prob.initialize(rng)
    return prob, prob.random_initial_state(rng)


def port_problem(kind, tmp_path, **extra):
    cls, _, kw, T = KINDS[kind]
    return problem(cls, kw, T, tmp_path, device="cpu", **extra)


def close(got, ref):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("kind", list(KINDS))
def test_gd_matches_dhts(kind, tmp_path):
    _, jcls, kw, T = KINDS[kind]
    jprob, jest0 = problem(jcls, kw, T, tmp_path / "jax")
    prob, est0 = port_problem(kind, tmp_path / "port")
    for a, b in zip(est0, jest0):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(prob.target_end, jprob.target_end):
        close(a.numpy(), b)
    begs, ends = prob.solve_gd(est0)
    jbegs, jends = jprob.solve_gd(jest0)
    close(begs, jbegs)
    close(ends, jends)
    assert ends[-1] < ends[0]
    if kind == "hybrid":
        assert int(prob.conversions[0]) >= 1  # a vehicle was emitted


@pytest.mark.parametrize("kind", ["macro", "micro"])
def test_batch_errors_match_dhts(kind, tmp_path):
    _, jcls, kw, T = KINDS[kind]
    jprob, jest0 = problem(jcls, kw, T, tmp_path / "jax")
    prob, est0 = port_problem(kind, tmp_path / "port", fused_rollout=True)
    v = np.concatenate([np.asarray(est0[0]), np.asarray(est0[1])])
    batch = np.stack([v, v * 0.99, v * 1.01])
    with torch.no_grad():
        got = prob.end_error(prob.split(batch)).numpy()
    np.testing.assert_allclose(got, np.asarray(jprob._end_error_batch(
        jnp.asarray(batch, jnp.float32))), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("kind", ["macro", "micro"])
def test_fused_rollout_matches_unfused(kind, tmp_path):
    runs = {}
    for fused in (False, True):
        prob, est0 = port_problem(kind, tmp_path / str(fused),
                                  fused_rollout=fused)
        _, ends = prob.solve_gd(est0)
        cma_beg, cma_end = prob.solve_cma(est0)
        runs[fused] = (ends, cma_beg, cma_end)
    for a, b in zip(runs[False], runs[True]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("kind", ["macro", "micro"])
def test_gd_restarts_run_as_one_batch(kind, tmp_path):
    """Restart 0 of a batch of B equals a standalone solve_gd; the fused
    rollout runs each episode of all restarts as one forward and one
    backward (the Function is called once per episode)."""
    prob, est0 = port_problem(kind, tmp_path, fused_rollout=True)
    rng = np.random.default_rng(3)
    ests = [est0] + [prob.random_initial_state(rng) for _ in range(3)]
    batch = tuple(np.stack([e[i] for e in ests]) for i in range(2))
    calls = []
    fused = prob._fused(4)
    prob._fused_cache[4] = lambda *a: calls.append(1) or fused(*a)
    begs, ends, best = prob.solve_gd_restarts(batch)
    assert len(calls) == prob.num_episode
    assert begs.shape == ends.shape == (4, prob.num_episode)
    assert np.isfinite(ends).all()
    assert len(np.unique(np.round(ends[:, -1], 10))) > 1
    _, single = prob.solve_gd(est0)
    np.testing.assert_allclose(ends[0], single, rtol=1e-6)
    assert best[0].shape == (prob.num_episode,)


@pytest.mark.parametrize("kind", ["macro", "micro"])
def test_cma_matches_dhts(kind, tmp_path):
    _, jcls, kw, T = KINDS[kind]
    jprob, jest0 = problem(jcls, kw, T, tmp_path / "jax", episodes=24)
    prob, est0 = port_problem(kind, tmp_path / "port", episodes=24)
    begs, ends = prob.solve_cma(est0)
    jbegs, jends = jprob.solve_cma(jest0)
    assert len(ends) == 24
    close(begs, jbegs)
    close(ends, jends)


def test_scipy_methods_run(tmp_path):
    prob, est0 = port_problem("macro", tmp_path, fused_rollout=True)
    for method in ("Nelder-Mead", "SLSQP"):
        begs, ends = prob.solve_scipy(est0, method)
        assert len(begs) == len(ends) == prob.num_episode
        assert np.isfinite(ends).all()
        assert prob.scipy_evaluations[method] >= 1


def scenes():
    jb = jscene.SceneBuilder(30.0, max_vehicles_per_lane=8)
    tb = scene.SceneBuilder(30.0, max_vehicles_per_lane=8)
    for b in (jb, tb):
        l0 = b.add_macro_lane(30.0, 5.0)
        l1 = b.add_micro_lane(30.0)
        b.add_macro_lane(30.0, 5.0)
        b.connect(l0, l1)
        b.connect(l1, 2)
    _, jstate = jb.build(np.random.default_rng(2))
    tspec, tstate = tb.build(np.random.default_rng(2))
    jspec, _ = jb.build(np.random.default_rng(2))
    return jspec, jstate, tspec, tstate


def test_setters_match_dhts():
    jspec, js, tspec, ts = scenes()
    r, u = np.linspace(0.1, 0.6, 6), np.linspace(5.0, 20.0, 6)
    pos, spd = np.array([2.0, 9.0, 17.5]), np.array([4.0, 6.0, 8.5])
    routes = np.array([[1, 2, -1], [1, -1, -1], [1, 2, -1]], np.int32)
    f32 = lambda x: np.asarray(x, np.float32)
    js = jnetwork.set_macro_lane_state(js, 0, jnp.asarray(f32(r)),
                                       jnp.asarray(f32(u)), jspec)
    js = jnetwork.set_external_boundary(js, 2, left_r=0.3, right_u=12.0)
    jroutes = jnp.asarray(np.pad(routes, ((0, 0), (0, 29)),
                                 constant_values=-1))
    js = jnetwork.set_micro_lane_vehicles(js, 1, jnp.asarray(f32(pos)),
                                          jnp.asarray(f32(spd)),
                                          routes=jroutes, spec=jspec)
    ts = network.set_macro_lane_state(ts, 0, torch.as_tensor(f32(r)),
                                      torch.as_tensor(f32(u)), tspec)
    ts = network.set_external_boundary(ts, 2, left_r=0.3, right_u=12.0)
    ts = network.set_micro_lane_vehicles(
        ts, 1, torch.as_tensor(f32(pos)), torch.as_tensor(f32(spd)),
        routes=torch.as_tensor(np.array(jroutes)), spec=tspec)
    for name in ("r", "y", "ext_left_r", "ext_left_u", "ext_right_r",
                 "ext_right_u"):
        np.testing.assert_allclose(getattr(ts.macro, name).numpy(),
                                   np.asarray(getattr(js.macro, name)),
                                   rtol=1e-6, err_msg=name)
    for name in ("position", "speed", "count", "route", "route_idx", "vid"):
        np.testing.assert_array_equal(getattr(ts.micro, name).numpy(),
                                      np.asarray(getattr(js.micro, name)),
                                      err_msg=name)
    for a, b in zip(ts.micro.params, js.micro.params):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_setters_keep_the_gradient():
    """The setters are out of place: a gradient flows from the values set,
    through network steps, and the base state is left unchanged."""
    _, _, spec, base = scenes()
    r = torch.full((6,), 0.5, requires_grad=True)
    u = torch.full((6,), 12.0, requires_grad=True)
    st = network.set_macro_lane_state(base, 0, r, u, spec)
    st = network.set_external_boundary(st, 0, left_r=0.4, left_u=10.0)
    for _ in range(30):
        st, _ = network.network_step(spec, st, 0.01, True)
    torch.sum(st.macro.r[0] ** 2).backward()
    assert torch.isfinite(r.grad).all() and float(r.grad.norm()) > 0
    assert torch.isfinite(u.grad).all() and float(u.grad.norm()) > 0
    assert float(base.macro.r.abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["macro", "micro"])
def test_cli_runs_on_the_cpu(kind, tmp_path):
    mod = {"macro": macro, "micro": micro}[kind]
    size = "--n_cell" if kind == "macro" else "--n_vehicle"
    beg, end = mod.main([size, "4", "--n_timestep", "20", "--n_episode",
                         "5", "--n_trial", "1", "--seed", "3",
                         "--methods", "gd,cma-es", "--fused_rollout",
                         "--device", "cpu", "--run_name", "cli",
                         "--log_root", str(tmp_path)])
    for method in ("gd", "cma-es"):
        lines = (tmp_path / "cli" / method / "trial_0.txt").read_text(
        ).strip().splitlines()
        assert len(lines) == 5 and len(lines[0].split()) == 2
        assert np.isfinite(end[method]).all()
