"""Kernel K4, the fused all-macro ITSCP episode: its plain PyTorch pair
against the JAX package.

* The plain forward and backward (``make_fused_itscp_macro_episode`` on CPU
  tensors: :class:`MacroEpisodeFunction` around ``plain_macro_episode`` and
  its autograd) against ``dhts.ops.pallas.itscp_episode.
  make_fused_itscp_macro_episode`` in interpret mode, on identical numpy
  inputs, at ``tests/test_itscp_fused.py``'s config (T = 60) and at the
  macro preset of ``run_itscp_macro.sh`` (T = 300), from an empty and from a
  seeded initial state: reward rel <= 1e-5, queues abs <= 1e-5; the
  gradients with respect to the action, r0 and y0 (``jax.grad`` against
  autograd) cosine > 0.99999 and allclose(rtol 1e-3, atol 1e-5 * max|g|).
  The two sum a lane's cells and the lanes in other orders, and JAX's K4
  keeps a padded cell beyond every lane: rounding-level differences.
* The plain version against the port's own scan episode
  (``env.episode(action, True)`` in macro mode) at the JAX test's
  tolerances: reward rel 2e-4, queues rtol 2e-3 atol 1e-5, action gradient
  rtol 1e-2 atol 1e-5.
* The Function launches only the gradients ``ctx.needs_input_grad`` asks
  for; a loss on ``queues`` alone; NaN probes (a vacuum lane, a jammed lane,
  routed neighbours of -1); and the traps of K4's step, one case each, on
  one step of :func:`plain_macro_step` from a seeded state.

The CUDA source runs in ``tests/test_torch_macro_episode_host.py`` (host
build) and ``tests/test_torch_card_macro_episode.py`` (the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhts.apps.control.itscp import problem as jproblem
from dhts.apps.control.itscp.env import ItscpEnv as JaxEnv
from dhts.ops.pallas import itscp_episode as jk4
from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv, signal_progress_table
from dhts_torch.ops import arz
from dhts_torch.ops.cuda import itscp_macro_episode as k4
from dhts_torch.utils import rms

torch.set_num_threads(1)

# tests/test_itscp_fused.py's config: 16 lanes of up to 4 cells, T = 60
CFG = dict(num_intersection=1, num_lane=1, lane_length=20.0,
           speed_limit=20.0, cell_length=5.0, policy_length=6,
           signal_length=2, simulation_frequency=10, random_seed=3,
           max_num_micro_vehicle_per_lane=4, mode="macro")
# run_itscp_macro.sh: 40 lanes of up to 7 cells, T = 300, 5 actions
PRESET = dict(num_intersection=1, num_lane=3, lane_length=30.0,
              speed_limit=60.0, policy_length=10, signal_length=2,
              random_seed=3, mode="macro")
# a policy length that is no multiple of the signal length: the last
# steps' phase index t // nsf = 2 is clamped to the last phase, 1
CLAMP_CFG = dict(CFG, policy_length=5)

_jax_fns = {}


def port_env(cfg):
    env = ItscpEnv(config=cfg, schedule_fn=problem.problem_1, device="cpu")
    env.reset()
    return env


def jax_k4(cfg):
    key = tuple(sorted(cfg.items()))
    if key not in _jax_fns:
        env = JaxEnv(config=cfg, schedule_fn=jproblem.problem_1)
        env.reset()
        _jax_fns[key] = jk4.make_fused_itscp_macro_episode(
            env.spec, env.meta, env.config, interpret=True)
    return _jax_fns[key]


def case(env, plan, seeded, seed=5):
    """numpy inputs ``(action2d, schedule, mnext, mprev, r0, y0)``: a
    seeded action, the env's draws, and an empty or a seeded initial state
    (r0 in [0.05, 0.6] on the valid cells, y0 of speeds in [0.3, 1]
    u_max, zero elsewhere)."""
    rng = np.random.default_rng(seed)
    L, C, u_max = plan.L, plan.C, plan.floats[0]
    m = plan.cell_mask.numpy()
    r0 = np.zeros((L, C), np.float32)
    y0 = np.zeros((L, C), np.float32)
    if seeded:
        r0 = np.where(m, rng.uniform(0.05, 0.6, (L, C)), 0.0).astype(
            np.float32)
        u0 = torch.as_tensor(rng.uniform(0.3, 1.0, (L, C)) * u_max,
                             dtype=torch.float32)
        y0 = np.where(m, arz.compute_y(torch.as_tensor(r0), u0, u_max),
                      0.0).astype(np.float32)
    action = rng.uniform(0.3, 0.7, (plan.n_phases, plan.n_inter)).astype(
        np.float32)
    d = env.data
    return (action, d.schedule.numpy(), d.mroute_next.numpy(),
            d.mroute_prev.numpy(), r0, y0)


def port_run(fn, args, w_reward, w_queues):
    """Reward, queues and the gradients of ``w_reward * reward +
    sum(w_queues * queues)`` with respect to ``(action2d, r0, y0)``."""
    ins = [torch.as_tensor(args[i]).requires_grad_(True) for i in (0, 4, 5)]
    reward, queues = fn(ins[0], *map(torch.as_tensor, args[1:4]), ins[1],
                        ins[2])
    loss = torch.sum(queues * torch.as_tensor(w_queues))
    if w_reward:
        loss = loss + w_reward * reward
    loss.backward()
    return reward, queues, [x.grad for x in ins]


def jax_run(jfn, args, w_reward, w_queues):
    def loss(a, r0, y0):
        reward, queues = jfn(a, *map(jnp.asarray, args[1:4]), r0, y0)
        return w_reward * reward + jnp.sum(queues * w_queues), (reward,
                                                                 queues)

    (_, (reward, queues)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
            *(jnp.asarray(args[i]) for i in (0, 4, 5)))
    return reward, queues, grads


def assert_close_to_jax(got, want):
    reward, queues, grads = got
    j_reward, j_queues, j_grads = want
    reward = float(reward.detach())
    assert abs(reward - float(j_reward)) <= 1e-5 * abs(float(j_reward))
    np.testing.assert_allclose(queues.detach().numpy(), np.asarray(j_queues),
                               rtol=0, atol=1e-5)
    for name, g, w in zip(("action", "r0", "y0"), grads, j_grads):
        g, w = g.numpy().ravel().astype(np.float64), np.asarray(w).ravel()
        assert np.isfinite(g).all() and np.abs(w).max() > 0, name
        cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
        assert cos > 0.99999, (name, cos)
        np.testing.assert_allclose(g, w, rtol=1e-3,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def queue_weights(T, seed=9):
    return np.random.default_rng(seed).uniform(-1, 1, T).astype(np.float32)


@pytest.mark.parametrize("seeded", [False, True], ids=["empty", "seeded"])
@pytest.mark.parametrize("cfg", [CFG, PRESET], ids=["small", "preset"])
def test_plain_matches_jax_kernel(cfg, seeded):
    env = port_env(cfg)
    fn = k4.make_fused_itscp_macro_episode(env.spec, env.meta, env.config,
                                           device="cpu")
    args = case(env, fn.plan, seeded)
    w = 0.1 * queue_weights(fn.plan.T)
    got = port_run(fn, args, -1.0, w)
    assert_close_to_jax(got, jax_run(jax_k4(cfg), args, -1.0, w))


def test_loss_on_queues_alone_matches_jax_kernel():
    env = port_env(CFG)
    fn = k4.make_fused_itscp_macro_episode(env.spec, env.meta, env.config,
                                           device="cpu")
    args = case(env, fn.plan, True, seed=6)
    w = queue_weights(fn.plan.T, seed=10)
    got = port_run(fn, args, 0.0, w)
    assert_close_to_jax(got, jax_run(jax_k4(CFG), args, 0.0, w))


def test_phase_clamps_to_the_last_phase():
    env = port_env(CLAMP_CFG)
    fn = k4.make_fused_itscp_macro_episode(env.spec, env.meta, env.config,
                                           device="cpu")
    plan = fn.plan
    assert plan.n_phases == 2 and (plan.T - 1) // plan.nsf == 2
    # the phase progress is the host-rounded table, not t / nsf on the
    # device
    assert torch.equal(plan.prog, torch.as_tensor(
        signal_progress_table(plan.nsf)))
    args = case(env, plan, True, seed=7)
    w = 0.1 * queue_weights(plan.T)
    got = port_run(fn, args, -1.0, w)
    assert_close_to_jax(got, jax_run(jax_k4(CLAMP_CFG), args, -1.0, w))


@pytest.mark.parametrize("a", [0.15, 0.5, 0.85])
def test_plain_matches_scan_episode(a):
    env = port_env(CFG)
    fn = k4.make_fused_itscp_macro_episode(env.spec, env.meta, env.config,
                                           device="cpu")
    action = torch.full((env.action_size(),), a)
    ref = env.episode(action, True)
    d = env.data
    zero = torch.zeros((fn.plan.L, fn.plan.C))
    reward, queues = fn(action.reshape(env.n_phases, 1), d.schedule,
                        d.mroute_next, d.mroute_prev, zero, zero)
    assert float(reward) == pytest.approx(float(ref.reward), rel=2e-4,
                                          abs=2e-4)
    np.testing.assert_allclose(queues.numpy(), ref.queue_per_step.numpy(),
                               rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("cfg", [CFG, PRESET], ids=["small", "preset"])
def test_action_gradient_matches_scan_episode(cfg):
    env = port_env(cfg)
    fn = k4.make_fused_itscp_macro_episode(env.spec, env.meta, env.config,
                                           device="cpu")
    d = env.data
    zero = torch.zeros((fn.plan.L, fn.plan.C))
    a_scan = torch.full((env.action_size(),), 0.4, requires_grad=True)
    (-env.episode(a_scan, True).reward).backward()
    a_k4 = torch.full((env.n_phases, fn.plan.n_inter), 0.4,
                      requires_grad=True)
    reward, _ = fn(a_k4, d.schedule, d.mroute_next, d.mroute_prev, zero,
                   zero)
    (-reward).backward()
    g = a_k4.grad.flatten().numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    np.testing.assert_allclose(g, a_scan.grad.numpy(), rtol=1e-2, atol=1e-5)


NEEDS = [(True, False, False), (False, True, False), (False, False, True),
         (False, True, True), (True, True, True)]


@pytest.mark.parametrize("needs", NEEDS,
                         ids=["action", "r0", "y0", "state", "all"])
def test_backward_computes_only_the_requested_gradients(needs, monkeypatch):
    env = port_env(CFG)
    fn = k4.make_fused_itscp_macro_episode(env.spec, env.meta, env.config,
                                           device="cpu")
    args = case(env, fn.plan, True)
    asked = []
    plain_bwd = k4.plain_macro_episode_bwd

    def spy(*a, needs):
        asked.append(needs)
        return plain_bwd(*a, needs=needs)

    monkeypatch.setattr(k4, "plain_macro_episode_bwd", spy)
    ins = [torch.as_tensor(args[i]).requires_grad_(n)
           for i, n in zip((0, 4, 5), needs)]
    reward, _ = fn(ins[0], *map(torch.as_tensor, args[1:4]), ins[1], ins[2])
    (-reward).backward()
    assert asked == [needs]
    _, _, full = port_run(fn, args, -1.0, np.zeros(fn.plan.T, np.float32))
    for x, n, g in zip(ins, needs, full):
        assert (x.grad is not None) == n
        if n:
            torch.testing.assert_close(x.grad, g, rtol=0, atol=0)
    # the wrappers ran their plain versions: nothing was launched
    assert k4.macro_episode_fwd.launches == 0
    assert k4.macro_episode_bwd.launches == 0


def probe_args(env, plan, kind):
    """A seeded case with one probe: a vacuum lane, a jammed lane, or every
    routed neighbour -1 (the lanes with one neighbour keep it, those with
    several see none; a -1 predecessor closes the left ghost)."""
    args = list(case(env, plan, True, seed=8))
    u_max = plan.floats[0]
    m = plan.cell_mask.numpy()
    if kind == "vacuum":
        args[4][0], args[5][0] = 0.0, 0.0
        args[4][8], args[5][8] = 0.0, 0.0
    elif kind == "jam":
        jam = torch.ones(plan.C)
        y_jam = arz.compute_y(jam, torch.zeros(plan.C), u_max).numpy()
        for lane in (1, 9):
            args[4][lane] = np.where(m[lane], 1.0, 0.0)
            args[5][lane] = np.where(m[lane], y_jam, 0.0)
    else:
        args[2] = np.full_like(args[2], -1)
        args[3] = np.full_like(args[3], -1)
    return tuple(args)


@pytest.mark.parametrize("kind", ["vacuum", "jam", "routes"])
def test_nan_probes_give_finite_gradients(kind):
    env = port_env(CFG)
    fn = k4.make_fused_itscp_macro_episode(env.spec, env.meta, env.config,
                                           device="cpu")
    args = probe_args(env, fn.plan, kind)
    w = 0.1 * queue_weights(fn.plan.T)
    got = port_run(fn, args, -1.0, w)
    assert torch.isfinite(got[1]).all()
    assert_close_to_jax(got, jax_run(jax_k4(CFG), args, -1.0, w))


# ---------------------------------------------------------------------------
# the traps of K4's step (itscp_episode.py:148-224), one step each
# ---------------------------------------------------------------------------


def one_step(cfg=CFG, t=7, seed=4, edit=None):
    """One plain step from a seeded state at step ``t``; ``edit(mnext_t,
    mprev_t)`` may change the routed neighbours first."""
    env = port_env(cfg)
    plan = k4.make_plan(env.spec, env.meta, env.config)
    args = [torch.as_tensor(x) for x in case(env, plan, True, seed=seed)]
    mnext_t, mprev_t = args[2][t].clone(), args[3][t].clone()
    if edit is not None:
        edit(mnext_t, mprev_t)
    g = k4.geometry(plan, "cpu")
    r, y = args[4], args[5]
    out = k4.plain_macro_step(plan, g, r, y, rms.init_mean_state(), t,
                              args[0], args[1][t], mnext_t, mprev_t)
    u = arz.compute_u(r, y, plan.floats[0])
    return plan, g, args, (r, u), out


def test_left_ghost_takes_the_graph_neighbour_behind_the_routed_signal():
    # lane 9 has one predecessor (lane 0); route it to lane 2, whose
    # signal differs from lane 0's: the ghost is lane 0's last cell behind
    # lane 2's signal
    def edit(mnext_t, mprev_t):
        mprev_t[9] = 2

    plan, g, args, (r, u), out = one_step(edit=edit)
    assert int(g.num_prev[9]) == 1 and int(g.prev0[9]) == 0
    sig = out.sig
    assert float(sig[2]) != float(sig[0])
    last0 = int(g.last[0])
    bl_r, bl_u = out.ghosts[:2]
    assert float(bl_r[9]) == float(r[0, last0] * sig[2])
    u_max = plan.floats[0]
    assert float(bl_u[9]) == float(u[0, last0] * sig[2] +
                                   u_max * (1.0 - sig[2]))


def test_invalid_routed_neighbour_reads_as_an_open_road():
    # lane 0 has two successors and lane 1 two predecessors; with routes of
    # -1 neither sees a neighbour: the right ghost is empty at the speed
    # limit behind the lane's gate, the left one closed
    def edit(mnext_t, mprev_t):
        mnext_t[0] = -1
        mprev_t[1] = -1

    plan, g, args, _, out = one_step(edit=edit)
    assert int(g.num_next[0]) == 2 and int(g.num_prev[1]) == 2
    u_max = plan.floats[0]
    bl_r, bl_u, br_r, br_u = out.ghosts
    s = k4.soft_sigmoid(out.sig[0] - 0.5, k4.GATE)
    assert float(br_r[0]) == float(0.0 * s + 1.0 * (1.0 - s))
    assert float(br_u[0]) == float(u_max * s)
    assert float(bl_r[1]) == 0.0 and float(bl_u[1]) == u_max


def test_right_ghost_of_a_lane_without_signal_blends_by_sigmoid_16():
    # lane 9 carries no signal (sig = 1): its own gate is sigmoid(16),
    # not 1
    plan, g, args, (r, u), out = one_step()
    assert not bool(g.approaching[9]) and float(out.sig[9]) == 1.0
    s16 = torch.sigmoid(torch.tensor(16.0, dtype=torch.float64)).float()
    assert float(s16) < 1.0
    nxt = int(g.next0[9])
    br_r, br_u = out.ghosts[2:]
    assert float(r[nxt, 0]) < 1.0
    assert float(br_r[9]) == float(r[nxt, 0] * s16 + 1.0 * (1.0 - s16))
    assert float(br_r[9]) != float(r[nxt, 0])
    assert float(br_u[9]) == float(u[nxt, 0] * s16)


def test_source_lane_takes_the_schedule_at_equilibrium_speed():
    plan, g, args, _, out = one_step(t=11)
    src = torch.nonzero(~g.has_prev)[:, 0]
    sched_t = args[1][11]
    bl_r, bl_u = out.ghosts[:2]
    torch.testing.assert_close(bl_r[src], sched_t[src], rtol=0, atol=0)
    torch.testing.assert_close(
        bl_u[src], arz.compute_u_eq(sched_t, plan.floats[0])[src], rtol=0,
        atol=0)


def test_queue_sharpness_is_a_detached_running_mean_of_valid_cells():
    plan, g, args, _, out = one_step()
    n_valid = int(g.cmask.sum())
    u_new = arz.compute_u(out.r, out.y, plan.floats[0])
    data = (plan.floats[3] - u_new)[g.cmask]
    assert float(out.ms.count) == n_valid
    assert float(out.ms.total) == float(data.double().sum().float())
    assert not out.ms.total.requires_grad
    # a second step adds its own cells
    a, sched, mnext, mprev = args[:4]
    out2 = k4.plain_macro_step(plan, g, out.r, out.y, out.ms, 8, a,
                               sched[8], mnext[8], mprev[8])
    assert float(out2.ms.count) == 2 * n_valid


def test_signals_take_the_host_rounded_progress_table():
    # on the device, t / nsf may become t * (1 / nsf), an ulp off the
    # correctly rounded quotient at some steps: the gates read the table
    env = port_env(CFG)
    plan = k4.make_plan(env.spec, env.meta, env.config)
    g = k4.geometry(plan, "cpu")
    args = [torch.as_tensor(x) for x in case(env, plan, True, seed=4)]
    tab = torch.as_tensor(signal_progress_table(plan.nsf))
    t32 = torch.arange(plan.nsf, dtype=torch.float32)
    assert not torch.equal(t32 * torch.tensor(1.0 / plan.nsf), tab)
    a = args[0]
    for t in range(plan.nsf):
        out = k4.plain_macro_step(plan, g, args[4], args[5],
                                  rms.init_mean_state(), t, a, args[1][t],
                                  args[2][t], args[3][t])
        a_lane = a[0][g.inter]
        gate = torch.where(g.is_we, k4.soft_sigmoid(a_lane - tab[t], 32.0),
                           k4.soft_sigmoid(tab[t] - a_lane, 32.0))
        want = torch.where(g.approaching, gate, torch.ones_like(gate))
        assert torch.equal(out.sig, want), t


def test_factory_needs_a_device_and_an_all_macro_scene():
    env = port_env(CFG)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            k4.make_fused_itscp_macro_episode(env.spec, env.meta,
                                              env.config)
    micro = port_env(dict(CFG, mode="micro"))
    with pytest.raises(ValueError, match="all-macro"):
        k4.make_fused_itscp_macro_episode(micro.spec, micro.meta,
                                          micro.config, device="cpu")
