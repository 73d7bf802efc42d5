"""The port's plain fused spatial step against the JAX package's own step
body, and the one-device mesh and K5 op around it.

JAX's ``make_fused_spatial_episode`` on a one-device ``Mesh`` keeps the
plain jnp ``body_STEP`` in ``episode._conv_kernels["STEP"][0]`` (no
Pallas, no ``shard_map``). Its scan is driven here step by step from the
empty state, and at every fourth step the same carry goes through the
port's :func:`plain_spatial_step` as well. The port keeps the true sizes
(JAX pads lanes to 128, cells and vehicles to 8) and a route id per vehicle
(JAX a copy of the route): the carries are converted both ways, routes
compared by content.

Integers (counts, route ids as routes, route indices, pool cursors) and the
step's injected/emitted/absorbed counts must be equal. Floats pass
allclose(rtol 1e-6, atol 5e-6): the two take their lane and cell sums in
different orders (JAX in float32 over padded axes, the port in float64
rounded once), take the flux at the last cell against the ghost's speed
(JAX against the speed recomputed from a padded ghost cell), and XLA's CPU
code may contract multiply-adds, each worth an ulp or two at positions of
tens of metres. Both scenes of the JAX package's spatial tests run, hard
and soft: the micro one injects and transfers vehicles, the 3x3 hybrid one
emits and absorbs them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dhts.apps.control.itscp import problem as jproblem
from dhts.apps.control.itscp.env import ItscpEnv as JaxEnv
from dhts.ops.pallas.itscp_spatial_step import \
    make_fused_spatial_episode as jax_spatial_episode
from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import itscp_spatial_step as k6
from dhts_torch.ops.cuda.dkernel import make_dkernel
from dhts_torch.parallel.mesh import make_mesh, shard_episode_batch

torch.set_num_threads(1)

MICRO_CFG = dict(num_intersection=1, num_lane=2, lane_length=20.0,
                 speed_limit=20.0, cell_length=5.0, policy_length=4,
                 signal_length=2, simulation_frequency=10, random_seed=3,
                 max_num_micro_vehicle_per_lane=4, mode="micro")
HYBRID_CFG = dict(num_intersection=3, num_lane=1, lane_length=5.0,
                  speed_limit=20.0, cell_length=5.0, policy_length=16,
                  signal_length=2, simulation_frequency=10, random_seed=3,
                  max_num_micro_vehicle_per_lane=4, mode="hybrid")
RTOL, ATOL = 1e-6, 5e-6


class JaxStep:
    """JAX's body_STEP with its constants and initial carry, and the
    conversions between its padded carry and the port's."""

    def __init__(self, cfg, differentiable):
        self.jenv = JaxEnv(config=cfg, schedule_fn=jproblem.problem_1)
        self.jenv.reset()
        self.env = ItscpEnv(config=cfg, schedule_fn=problem.problem_1,
                            device="cpu")
        self.env.reset()
        ep = jax_spatial_episode(self.jenv,
                                 Mesh(np.array(jax.devices()[:1]), ("lane",)),
                                 differentiable=differentiable)
        body, ex = ep._conv_kernels["STEP"]
        self.parts = ep._parts
        self.body = jax.jit(body)
        self.consts = ex[k6.N_CARRY + 10:]
        self.Cp, self.lp = ex[0].shape
        self.Vp, self.R = ex[2].shape[0], ex[12].shape[1]
        self.K = ex[14].shape[0]
        self.plan = k6.make_plan(self.env, differentiable)
        self.routes = k6.route_table(self.env.data.inj_routes,
                                     self.env.base_state.route_pool)
        rt = self.routes.numpy()
        self.rt = rt
        self.row_id = {}
        for i in range(rt.shape[0] - 1, -1, -1):
            self.row_id[tuple(rt[i])] = i

    def carry0(self):
        p, f = self.parts, self.plan.floats
        lc = {k: v[0] for k, v in p.lc_dev.items()}
        inj_left = jnp.where(
            (lc["has_prev"] == 0) & (lc["is_macro"] < 0.5) &
            (lc["lane_mask"] > 0), self.jenv.data.inj_routes.shape[1],
            0).astype(jnp.int32)
        zf = lambda *s: jnp.zeros(s, jnp.float32)
        zi = lambda *s: jnp.zeros(s, jnp.int32)
        Cp, lp, Vp = self.Cp, self.lp, self.Vp
        params = tuple(jnp.full((Vp, lp), v, jnp.float32)
                       for v in (f[6], f[7], f[8], f[9], f[10], f[2]))
        return ((zf(Cp, lp), zf(Cp, lp), zf(Vp, lp), zf(Vp, lp), zf(Vp, lp))
                + params + (zi(1, lp), jnp.full((Vp, self.R, lp), -1,
                                                jnp.int32),
                            zi(Vp, lp), zf(self.K, lp), inj_left, zi(1, lp)))

    def step_inputs(self, t, rand, action_p, sg, ss):
        pad = lambda x, fill: jnp.asarray(np.concatenate(
            [np.asarray(x), np.full(self.lp - self.plan.L, fill,
                                    np.asarray(x).dtype)])[None])
        d = self.jenv.data
        return (pad(rand[t], 2.0), pad(d.schedule[t], 0.0), action_p,
                jnp.full((1, 1), t, jnp.int32), pad(d.mroute_next[t], -1),
                pad(d.mroute_prev[t], -1), self.parts.inj_dev[0],
                self.parts.pool_dev[0], sg, ss)

    def to_port(self, carry, sg, ss):
        p = self.plan
        out = []
        for name, x in zip(k6.CNAMES, carry):
            x = np.asarray(x)
            if name in ("r", "y"):
                x = x[:p.C, :p.L]
            elif name in ("count", "inj_left", "cursor"):
                x = x[0, :p.L]
            elif name == "cap":
                x = x[:, :p.L]
            elif name == "rid":
                x = self.route_ids(x[:p.V, :, :p.L])
            else:
                x = x[:p.V, :p.L]
            out.append(torch.as_tensor(np.array(x))[None])
        return (tuple(out), torch.as_tensor(np.array(sg)),
                torch.as_tensor(np.array(ss)))

    def route_ids(self, route):
        out = np.full(route.shape[::2], -1, np.int32)
        for v in range(route.shape[0]):
            for l in range(route.shape[2]):
                row = tuple(route[v, :, l])
                if any(x >= 0 for x in row):
                    out[v, l] = self.row_id[row]
        return out

    def routes_of(self, rid):
        rid = rid.numpy()
        return np.where(rid[..., None] >= 0, self.rt[np.maximum(rid, 0)], -1)


@pytest.mark.parametrize("differentiable", [False, True],
                         ids=["hard", "soft"])
@pytest.mark.parametrize("cfg", [MICRO_CFG, HYBRID_CFG],
                         ids=["micro", "hybrid"])
def test_step_matches_jax_body(cfg, differentiable):
    js = JaxStep(cfg, differentiable)
    plan, env = js.plan, js.env
    T, L = plan.T, plan.L
    rand = np.array(jax.random.uniform(jax.random.PRNGKey(0), (T, L)))
    action = np.random.default_rng(2).uniform(
        0.3, 0.7, env.action_size()).astype(np.float32)
    action_p = jnp.zeros((js.parts.NPp, js.parts.NIp)).at[
        :plan.n_phases, :plan.n_inter].set(
            jnp.asarray(action).reshape(plan.n_phases, plan.n_inter))
    a2 = torch.as_tensor(action).reshape(plan.n_phases, -1)
    g = k6.geometry(plan, "cpu")
    carry, sg, ss = js.carry0(), jnp.zeros((1, 2)), jnp.zeros((1, 2))
    N = k6.N_CARRY
    totals = np.zeros(3, np.int64)
    for t in range(T):
        out = js.body(*carry, *js.step_inputs(t, rand, action_p, sg, ss),
                      *js.consts)
        jev = np.asarray(out[N + 1])[0]
        jax_events = [float(np.asarray(out[N + 2])[0, 0]), jev[0], jev[1]]
        totals += np.asarray(jax_events, np.int64)
        if t % 4 == 0:
            pc, psg, pss = js.to_port(carry, sg, ss)
            po = k6.plain_spatial_step(
                plan, pc, psg, pss, t, a2, torch.as_tensor(rand[t])[None],
                env.data.schedule[t], env.data.mroute_next[t],
                env.data.mroute_prev[t], js.routes, g)
            jc, jsg, jss = js.to_port(out[:N], out[N + 4], out[N + 5])
            for name, a, b in zip(k6.CNAMES, po.carry, jc):
                if name in ("r", "y"):  # padded cells hold other values
                    a, b = a[g.cmask[None]], b[g.cmask[None]]
                if name == "rid":
                    np.testing.assert_array_equal(js.routes_of(a),
                                                  js.routes_of(b), err_msg=t)
                elif a.is_floating_point():
                    torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL,
                                               msg=f"{name} at step {t}")
                else:
                    assert torch.equal(a, b), (name, t)
            for a, b in ((po.sg_ms, jsg), (po.ss_ms, jss),
                         (po.queue, torch.as_tensor(np.array(out[N][0]))),
                         (po.max_wave,
                          torch.as_tensor(np.array(out[N + 3][0])))):
                torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
            assert po.events[0].tolist() == jax_events, t
        carry, sg, ss = out[:N], out[N + 4], out[N + 5]
    if cfg is MICRO_CFG:
        assert totals[0] > 0  # injected
    else:
        assert totals[1] > 0  # emitted


def test_mesh_is_one_device():
    """A one-device mesh needs no process group; a data axis of more than
    one device is not ported (raises, naming ROADMAP.md); a lane axis of
    more than one shard needs an initialised process group of its size
    (raises without one: lane shards run one process each)."""
    mesh = make_mesh({"data": 1, "lane": 1}, "cpu")
    assert mesh.shape == {"data": 1, "lane": 1} and mesh.size == 1
    rand = torch.zeros(2, 3, 4)
    assert shard_episode_batch(mesh, rand).device == mesh.device
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_mesh({"data": 2, "lane": 1}, "cpu")
    for shape in ({"data": 1, "lane": 2}, {"lane": 4}):
        with pytest.raises(RuntimeError, match="torch.distributed"):
            make_mesh(shape, "cpu")
    with pytest.raises(ValueError):
        make_mesh({"data": 0, "lane": 1}, "cpu")


def test_spatial_episode_refuses_sharded_mesh():
    """A mesh of two lane shards without a lane process group is refused;
    the sharded episode itself runs in
    ``tests/test_torch_spatial_shard_dist.py``."""
    env = ItscpEnv(config=MICRO_CFG, schedule_fn=problem.problem_1,
                   device="cpu")
    env.reset()
    fake = make_mesh({"data": 1, "lane": 1}, "cpu")._replace(sizes=(1, 2))
    with pytest.raises(ValueError, match="process group"):
        k6.make_fused_spatial_episode(env, fake)


def test_dkernel_routes_cpu_tensors_to_the_body_with_autograd():
    calls = []

    def body(x, n):
        return x * x, n + 1

    def never(*args):
        calls.append(args)
        raise AssertionError("the CUDA launchers must not run on the CPU")

    op = make_dkernel(body, never, never, (0,), name="square")
    x = torch.tensor([1.5, -2.0], requires_grad=True)
    y, n = op(x, torch.tensor([3], dtype=torch.int32))
    y.sum().backward()
    assert op.body is body and not calls
    assert torch.equal(x.grad, 2 * x.detach()) and int(n) == 4


def test_dkernel_function_gives_nondiff_outputs_no_gradient():
    """The card's path (``op.function``, here on CPU tensors): the float
    output listed in ``nondiff_outputs`` has no gradient, so a loss on it
    raises; the derivative gets the cotangents of the others only."""
    seen = []

    def fwd(x):
        return x * x, torch.amax(x, 0, keepdim=True)

    def derivative(args, cots):
        seen.append(len(cots))
        return (2 * args[0] * cots[0],)

    op = make_dkernel(fwd, fwd, derivative, (0,), name="square",
                      nondiff_outputs=(1,))
    x = torch.tensor([1.5, -2.0], requires_grad=True)
    y, peak = op.function.apply(x)
    assert y.requires_grad and not peak.requires_grad
    with pytest.raises(RuntimeError):
        peak.sum().backward()
    y.sum().backward()
    assert seen == [1] and torch.equal(x.grad, 2 * x.detach())
    env = ItscpEnv(config=MICRO_CFG, schedule_fn=problem.problem_1,
                   device="cpu")
    env.reset()
    ep = k6.make_fused_spatial_episode(env, make_mesh(
        {"data": 1, "lane": 1}, "cpu"))
    a = torch.full((env.action_size(),), 0.5, requires_grad=True)
    res = ep(a, generator=torch.Generator().manual_seed(2))
    assert res.reward.requires_grad and not res.max_wave_speed.requires_grad
