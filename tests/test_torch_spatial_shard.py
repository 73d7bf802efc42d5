"""The port's plain per-shard bodies of the lane-sharded fused spatial step
against the JAX package's own bodies, and the sharded composition against
the single-shard step.

* Bodies against JAX. JAX's ``make_fused_spatial_episode`` on a 2-shard
  and a 4-shard virtual mesh keeps its seven plain jnp bodies in
  ``episode._shard_kernels[name][0].body`` (no Pallas). They are driven
  here shard by shard, eagerly, with ``jnp.concatenate`` as the gather and
  the shards' partial sums added as the psum (``step_sharded``); the port's
  plain bodies are driven the same way with in-process gathers. Each
  compared step starts both from the same mid-episode carry: the port's
  single-shard episode is run to that step and its carry converted to JAX's
  padded per-shard layout (lanes to 128, cells and vehicles to 8; routes by
  content). The steps are chosen around the scene's first emission,
  deposit and transfer (asserted). The port's fused conversion
  (``plain_body_D``: D1, D2 and D3 from the rows gathered after C, the D3
  kernel's plain version) equals its three bodies with their gathers bit
  for bit, carry, terms and events. Integers (counts, route contents,
  indices, wants, arbitration verdicts, events) must be equal; floats pass
  allclose(rtol 1e-6, atol 5e-6), the tolerance of
  ``test_torch_spatial_step.py`` (the two sum in different orders; XLA may
  contract multiply-adds).
* Sharded against single-shard, in one process: the plain bodies over S =
  2, 3, 4 shards with in-process gathers hold the whole episode's queues,
  events and wave maxima bit-exact to ``plain_spatial_step`` (the running
  means and the queue are summed from per-lane terms in lane order, so the
  shard count does not change a bit); the forward-mode derivative over S
  shards is bit-exact to the single-shard forward-mode derivative
  (``plain_spatial_step_bwd``).
* The mesh, K5's stop-gradient op and ``make_dkernel(body_autograd=False)``.
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
from dhts_torch.ops.cuda import itscp_spatial_shard as ks
from dhts_torch.ops.cuda import itscp_spatial_step as k6
from dhts_torch.ops.cuda.dkernel import make_dkernel, make_kernel_sg
from dhts_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

MICRO_CFG = dict(num_intersection=1, num_lane=2, lane_length=20.0,
                 speed_limit=20.0, cell_length=5.0, policy_length=4,
                 signal_length=2, simulation_frequency=10, random_seed=3,
                 max_num_micro_vehicle_per_lane=4, mode="micro")
HYBRID_CFG = dict(num_intersection=3, num_lane=1, lane_length=5.0,
                  speed_limit=20.0, cell_length=5.0, policy_length=16,
                  signal_length=2, simulation_frequency=10, random_seed=3,
                  max_num_micro_vehicle_per_lane=4, mode="hybrid")
SHORT_CFG = dict(HYBRID_CFG, policy_length=2)
RTOL, ATOL = 1e-6, 5e-6
N = k6.N_CARRY


def port_env(cfg):
    env = ItscpEnv(config=cfg, schedule_fn=problem.problem_1, device="cpu")
    env.reset()
    return env


def port_inputs(env, plan, B=1, seed=7, action_seed=2):
    gen = torch.Generator().manual_seed(seed)
    rand = torch.stack([env.draw_rand(gen) for _ in range(B)])
    action = torch.as_tensor(np.random.default_rng(action_seed).uniform(
        0.3, 0.7, env.action_size()), dtype=torch.float32)
    d = env.data
    return (action.reshape(plan.n_phases, -1).contiguous(), rand,
            d.schedule, d.mroute_next, d.mroute_prev,
            k6.route_table(d.inj_routes, env.base_state.route_pool))


# ---------------------------------------------------------------------------
# bodies against JAX
# ---------------------------------------------------------------------------


class JaxShards:
    """JAX's per-shard bodies with their per-shard constants, and the
    conversions between the port's carry and JAX's padded shard carry."""

    def __init__(self, cfg, S, differentiable):
        self.jenv = JaxEnv(config=cfg, schedule_fn=jproblem.problem_1)
        self.jenv.reset()
        ep = jax_spatial_episode(self.jenv,
                                 Mesh(np.array(jax.devices()[:S]), ("lane",)),
                                 differentiable=differentiable)
        self.body = {k: v[0].body for k, v in ep._shard_kernels.items()}
        p = ep._parts
        self.parts, self.S = p, S
        names = sorted(p.lc_dev.keys())
        ex_A = ep._shard_kernels["A"][1]
        gvals = ex_A[N + 2 + len(names):]
        self.consts = [tuple(p.lc_dev[k][s] for k in names) + tuple(gvals)
                       for s in range(S)]
        self.lp, self.l = p.lp, p.l_loc
        self.Cp, self.Vp = ex_A[0].shape[0], ex_A[2].shape[0]

    def shard_carry(self, plan, rt, carry, s):
        """Port carry ``(B=1)`` -> JAX's padded carry of shard s."""
        l, lp, Cp, Vp = self.l, self.lp, self.Cp, self.Vp
        cols = slice(s * l, (s + 1) * l)
        dflt = dict(p_amax=plan.floats[6], p_apref=plan.floats[7],
                    p_vt=plan.floats[8], p_ms=plan.floats[9],
                    p_tp=plan.floats[10], p_len=plan.floats[2])
        out = []
        for name, x in zip(k6.CNAMES, carry):
            x = x[0].numpy()[..., cols]
            if name in ("r", "y"):
                a = np.zeros((Cp, lp), np.float32)
                a[:plan.C, :l] = x
            elif name in ("count", "inj_left", "cursor"):
                a = np.zeros((1, lp), np.int32)
                a[0, :l] = x
            elif name == "cap":
                a = np.zeros((plan.K, lp), np.float32)
                a[:, :l] = x
            elif name == "rid":
                a = np.full((Vp, plan.R, lp), -1, np.int32)
                a[:plan.V, :, :l] = np.where(
                    x[:, None] >= 0, rt[np.maximum(x, 0)].transpose(0, 2, 1),
                    -1)
            elif name == "ridx":
                a = np.zeros((Vp, lp), np.int32)
                a[:plan.V, :l] = x
            else:
                a = np.full((Vp, lp), dflt.get(name, 0.0), np.float32)
                a[:plan.V, :l] = x
            out.append(jnp.asarray(a))
        return tuple(out)

    def row(self, x, s, t=None, fill=0):
        """A ``[T, L]`` input -> shard s's ``[1, lp]`` block at step t."""
        b = self.parts.to_blocks(x, fill)
        return b[t, s] if t is not None else b[:, s]

    def gather(self, xs, fill):
        g = jnp.concatenate([x[:, :self.l] for x in xs], axis=1)
        Lgp = ((self.S * self.l + 127) // 128) * 128
        return jnp.concatenate(
            [g, jnp.full((g.shape[0], Lgp - g.shape[1]), fill, g.dtype)], 1)


def pairs_equal(jx, px, what, exact=False):
    jx = torch.as_tensor(np.array(jx))
    px = px.to(jx.dtype) if not exact else px
    if exact or not jx.is_floating_point():
        assert torch.equal(jx.to(px.dtype), px), what
    else:
        torch.testing.assert_close(
            px, jx, rtol=RTOL, atol=ATOL,
            msg=lambda m: f"{what}: port {px.tolist()}, JAX {jx.tolist()}\n"
                          f"{m}" if px.numel() < 8 else f"{what}\n{m}")


def edges(rows, lg):
    """Summary rows with the edge-cell rows (density and speed of the
    first and last cell: rows 0-3 of sumA, 0-1 of sumF) zeroed on micro
    lanes: JAX picks them for macro lanes only, the port's rows hold the
    empty cells' values there, and no lane reads them."""
    rows = torch.as_tensor(np.array(rows)).clone()
    k = 4 if rows.shape[0] == 9 else 2
    rows[:k, ~lg.is_macro] = 0.0
    return rows


def mean_gate(ms, scale):
    """JAX's sigmoid constant of a running mean ``(sum, count)``:
    ``scale / max(|sum / max(count, 1)|, 1e-6)`` in float32."""
    ms = jnp.asarray(ms, jnp.float32)
    mean = ms[0, 0] / jnp.maximum(ms[0, 1], 1.0)
    return (scale / jnp.maximum(jnp.abs(mean), 1e-6)).reshape(1, 1)


def first_events(plan, env, inputs, steps):
    """The port's single-shard run: the carry at the start of every step,
    and per step the local events (injected, emitted, absorbed,
    transferred)."""
    a2, rand, sched, mnext, mprev, routes = inputs
    g = k6.geometry(plan, "cpu")
    comm = ks.LaneComm.whole(plan.L)
    state = ks.initial_states(plan, comm, 1, "cpu")[0]
    carries, events = [], []
    for t in range(steps):
        carries.append(state)
        (o,) = ks.plain_shard_step(plan, g, comm, [state], t, a2, rand[:, t],
                                   sched[t], mnext[t], mprev[t], routes)
        events.append([int(o.n_inj[0])] + o.ev[0].tolist())
        state = (o.carry, o.sg_ms, o.ss_ms)
    return carries, np.asarray(events)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("differentiable", [False, True],
                         ids=["hard", "soft"])
@pytest.mark.parametrize("cfg", [MICRO_CFG, HYBRID_CFG],
                         ids=["micro", "hybrid"])
def test_bodies_match_jax_bodies(cfg, differentiable, S):
    env = port_env(cfg)
    plan = k6.make_plan(env, differentiable)
    T, L, l = plan.T, plan.L, plan.L // S
    js = JaxShards(cfg, S, differentiable)
    rand = np.array(jax.random.uniform(jax.random.PRNGKey(0), (T, L)))
    # the hybrid scene's first emission, deposit and transfer all fall
    # within its 160 steps at this action
    action = np.random.default_rng(2 if cfg is MICRO_CFG else 1).uniform(
        0.3, 0.7, env.action_size()).astype(np.float32)
    inputs = list(port_inputs(env, plan))
    inputs[0] = torch.as_tensor(action).reshape(plan.n_phases, -1)
    inputs[1] = torch.as_tensor(rand)[None]
    a2, prand, sched, mnext, mprev, routes = inputs
    carries, events = first_events(plan, env, inputs, T)
    # the steps of the scene's first events of each kind
    # micro: injection, transfer; hybrid: emission, deposit, transfer
    kinds = (0, 3) if cfg is MICRO_CFG else (1, 2, 3)
    steps = sorted({int(np.argmax(events[:, k] > 0)) for k in kinds})
    assert all(events[:, k].sum() > 0 for k in kinds), events.sum(0)
    rt = routes.numpy()
    routes_of = lambda rid: np.where(rid[..., None] >= 0,
                                     rt[np.maximum(rid, 0)], -1)
    jd = js.jenv.data
    action_p = jnp.zeros((js.parts.NPp, js.parts.NIp)).at[
        :plan.n_phases, :plan.n_inter].set(jnp.asarray(action).reshape(
            plan.n_phases, plan.n_inter))
    g = k6.geometry(plan, "cpu")
    shards = ks.shards_of(L, S)
    lgs = [ks.local_geometry(g, s) for s in shards]
    seen = np.zeros(4, np.int64)
    deposits = 0
    for t in steps:
        carry, sg_ms, ss_ms = carries[t]
        jc = [js.shard_carry(plan, rt, carry, s) for s in range(S)]
        pc = [ks.slice_carry(carry, s) for s in shards]
        cols = [s.cols for s in shards]
        cn = js.consts
        blk = lambda x, s, fill=0: js.row(x, s, t, fill)
        # ---- A
        jA = [js.body["A"](*jc[s], blk(rand, s, 2.0), blk(jd.schedule, s),
                           *cn[s])[0] for s in range(S)]
        pA = [ks.plain_body_A(plan, lgs[s], pc[s], prand[:, t, cols[s]],
                              sched[t, cols[s]]) for s in range(S)]
        for s in range(S):
            pairs_equal(edges(jA[s][:, :l], lgs[s]),
                        edges(pA[s][0], lgs[s]), f"A rows, shard {s}")
        gA_j = js.gather(jA, 0.0)
        gA_p = torch.cat(pA, -1)
        # ---- B
        t2d = jnp.full((1, 1), t, jnp.int32)
        jB = [js.body["B"](*jc[s], gA_j, action_p, t2d,
                           blk(jd.mroute_next, s, -1),
                           blk(jd.mroute_prev, s, -1), blk(jd.schedule, s),
                           js.parts.inj_dev[s], *cn[s]) for s in range(S)]
        pB = [ks.plain_body_B(plan, g, lgs[s], pc[s], gA_p, a2, t,
                              mnext[t, cols[s]], mprev[t, cols[s]],
                              sched[t, cols[s]], routes) for s in range(S)]
        for s in range(S):
            jo, po = jB[s], pB[s]
            for j, name in zip(range(12), k6.CNAMES[2:14]):
                if name == "rid":
                    assert np.array_equal(
                        np.array(jo[j])[:plan.V, :, :l].transpose(0, 2, 1),
                        routes_of(po.carry[12][0].numpy())), ("B route", s)
                else:
                    x = jo[j][:plan.V, :l] if jo[j].shape[0] > 1 else \
                        jo[j][0, :l]
                    pairs_equal(x, po.carry[2 + j][0], f"B {name}, {s}")
            pairs_equal(jo[12][0, :l], po.carry[15][0], f"B inj_left {s}")
            for j in range(10):
                pairs_equal(jo[13 + j][0, :l], po.bc[0, j],
                            f"B {ks.BC_ROWS[j]}, shard {s}")
            pairs_equal(jo[23][0, 0], po.n_inj[0].float(), "B n_inj")
            sg_p = torch.stack([po.sg[0, 0].double().sum(),
                                po.sg[0, 1].double().sum()]).float()
            pairs_equal(jo[24][0], sg_p, f"B sg partial, shard {s}")
        # JAX's carry after B: r, y, B's pos .. ridx, cap, B's inj_left,
        # cursor
        jc = [jc[s][:2] + tuple(jB[s][:12]) + (jc[s][14], jB[s][12],
                                               jc[s][16]) for s in range(S)]
        pc = [o.carry for o in pB]
        sg_j = sg_ms.numpy() + sum(np.array(o[24]) for o in jB)
        (gsg,) = ks.LaneComm(L, shards).gather([[o.sg] for o in pB])
        sg_p, c_sig = ks.fold_sg(plan, sg_ms, gsg)
        pairs_equal(sg_j, sg_p, "sg_ms")
        c_sig_j = (mean_gate(sg_j, 32.0) if differentiable else
                   jnp.ones((1, 1)))
        # ---- C
        jC = [js.body["C"](*jc[s], *jB[s][13:23], c_sig_j,
                           blk(jd.mroute_next, s, -1), *cn[s])
              for s in range(S)]
        pC = [ks.plain_body_C(plan, g, lgs[s], pc[s], pB[s].bc, c_sig,
                              mnext[t, cols[s]], routes) for s in range(S)]
        cm = [lg.cmask for lg in lgs]
        for s in range(S):
            jo, po = jC[s], pC[s]
            for j, name in ((0, "r"), (1, "y")):
                pairs_equal(np.array(jo[j])[:plan.C, :l][cm[s].numpy()],
                            po.carry[j][0][cm[s]], f"C {name}, {s}")
            pairs_equal(jo[2][:plan.V, :l], po.carry[2][0], f"C pos {s}")
            pairs_equal(jo[3][:plan.V, :l], po.carry[3][0], f"C vel {s}")
            pairs_equal(jo[4][:, :l], po.carry[14][0], f"C cap {s}")
            pairs_equal(jo[5][0, 0], po.wave[0], f"C wave {s}")
            pairs_equal(edges(jo[6][:, :l], lgs[s]),
                        edges(po.sumF[0], lgs[s]), f"C sumF {s}")
            pairs_equal(jo[7][:, :l], po.sumI[0, :3], f"C sumI {s}")
            assert np.array_equal(np.array(jo[8])[:, :l].T,
                                  routes_of(po.sumI[0, 3].numpy())), \
                ("C route_h", s)
        jc = [(jC[s][0], jC[s][1], jC[s][2], jC[s][3]) + jc[s][4:14] +
              (jC[s][4],) + jc[s][15:] for s in range(S)]
        pc = [o.carry for o in pC]
        gF_j = js.gather([o[6] for o in jC], 0.0)
        gI_j = js.gather([o[7] for o in jC], -1)
        gR_j = js.gather([o[8] for o in jC], -1)
        gF_p, gI_p = ks.LaneComm(L, shards).gather(
            [[o.sumF, o.sumI] for o in pC])
        # ---- D1, D2
        jD1 = [js.body["D1"](*jc[s], jC[s][6], jC[s][7], gF_j, gI_j, *cn[s])
               for s in range(S)]
        pD1 = [ks.plain_body_D1(plan, g, lgs[s], pc[s], pC[s].sumF,
                                pC[s].sumI, gF_p, gI_p) for s in range(S)]
        for s in range(S):
            pairs_equal(np.array(jD1[s][0])[:, :l].astype(np.int32),
                        pD1[s][0][0], f"D1 wrow {s}")
            pairs_equal(np.array(jD1[s][1])[:, :l].astype(np.int32),
                        pD1[s][1][0], f"D1 pred {s}")
        gW_j = js.gather([o[0] for o in jD1], -2.0)
        gW_p = torch.cat([w for w, _ in pD1], -1)
        jD2 = [js.body["D2"](gI_j, gW_j, *cn[s]) for s in range(S)]
        pD2 = [ks.plain_body_D2(plan, lgs[s], gI_p, gW_p) for s in range(S)]
        Lgp = gF_j.shape[1]
        for s in range(S):
            jb = np.concatenate([np.array(x)[:, :l] for x in jD2[s]])
            pairs_equal(np.where(jb == Lgp, L, jb), pD2[s][0], f"D2 {s}")
        gV_j = js.gather([jnp.concatenate(o, axis=0) for o in jD2], Lgp)
        gV_p = torch.cat(pD2, -1)
        deposits += int((gV_p[:, 1] < L).sum())
        # ---- D3
        jD3 = [js.body["D3"](*jc[s], gF_j, gI_j, gR_j, gV_j, jD1[s][1],
                             jD2[s][0], jD2[s][1], jC[s][7],
                             js.parts.pool_dev[s], *cn[s]) for s in range(S)]
        pD3 = [ks.plain_body_D3(plan, g, lgs[s], pc[s], gF_p, gI_p, gV_p,
                                pD1[s][1], pD2[s], pC[s].sumI)
               for s in range(S)]
        for s in range(S):
            fused = ks.plain_body_D(plan, g, lgs[s], pc[s], gF_p, gI_p)
            for a, b in zip(fused.carry + fused[1:], pD3[s].carry +
                            pD3[s][1:]):
                assert torch.equal(a, b), ("plain_body_D", s)
        for s in range(S):
            jo, po = jD3[s], pD3[s]
            for j, name in enumerate(k6.CNAMES[:15] + ("cursor",)):
                pi = 16 if name == "cursor" else j
                px = po.carry[pi][0]
                if name in ("r", "y"):
                    pairs_equal(np.array(jo[j])[:plan.C, :l][cm[s].numpy()],
                                px[cm[s]], f"D3 {name}, {s}")
                elif name == "rid":
                    assert np.array_equal(
                        np.array(jo[j])[:plan.V, :, :l].transpose(0, 2, 1),
                        routes_of(px.numpy())), ("D3 route", s)
                elif name in ("count", "cursor"):
                    pairs_equal(jo[j][0, :l], px, f"D3 {name}, {s}")
                elif name == "cap":
                    pairs_equal(jo[j][:, :l], px, f"D3 cap, {s}")
                else:
                    pairs_equal(jo[j][:plan.V, :l], px, f"D3 {name}, {s}")
            ss_p = torch.stack([po.ss[0].sum(), po.ssn[0].sum().double()])
            pairs_equal(jo[16][0], ss_p.float(), f"D3 ss partial, {s}")
            pairs_equal(np.array(jo[17][0]).astype(np.int64), po.ev[0],
                        f"D3 events, {s}")
            seen += np.array([int(pB[s].n_inj[0])] + po.ev[0].tolist())
        gss, gssn = ks.LaneComm(L, shards).gather(
            [[o.ss, o.ssn] for o in pD3])
        ss_p, c_st = ks.fold_ss(plan, ss_ms, gss, gssn)
        ss_j = ss_ms.numpy() + sum(np.array(o[16]) for o in jD3)
        pairs_equal(ss_j, ss_p, "ss_ms")
        c_st_j = mean_gate(ss_j, 16.0)
        # ---- E
        for s in range(S):
            jc_s = tuple(jD3[s][:15]) + (jc[s][15], jD3[s][15])
            (jq,) = js.body["E"](*jc_s, c_st_j, *cn[s])
            pq = ks.plain_body_E(plan, lgs[s], pD3[s].carry, c_st)
            # JAX's partial is the shard's sum of q^2 times dt
            pairs_equal(jq[0, 0], pq[0].double().sum().float() *
                        plan.floats[1], f"E {s}")
    assert all(seen[k] > 0 for k in kinds), seen
    assert deposits > 0 or cfg is MICRO_CFG


# ---------------------------------------------------------------------------
# sharded against single-shard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg, S", [(MICRO_CFG, 2), (MICRO_CFG, 4),
                                    (HYBRID_CFG, 2), (HYBRID_CFG, 3),
                                    (HYBRID_CFG, 4)],
                         ids=["micro-2", "micro-4", "hybrid-2", "hybrid-3",
                              "hybrid-4"])
@pytest.mark.parametrize("differentiable", [False, True],
                         ids=["hard", "soft"])
def test_sharded_episode_is_bit_exact_to_single_shard(cfg, S,
                                                      differentiable):
    env = port_env(cfg)
    plan = k6.make_plan(env, differentiable)
    inputs = port_inputs(env, plan, B=2)
    ref = k6.plain_spatial_episode(plan, *inputs)
    comm = ks.LaneComm(plan.L, ks.shards_of(plan.L, S))
    got = ks.plain_sharded_episode(plan, comm, *inputs)
    for a, b, name in zip(ref, got, ("queues", "events", "waves")):
        assert torch.equal(a.detach(), b), name
    tot = ref[1].sum((0, 1))
    assert int(tot[0] if cfg is MICRO_CFG else tot[1]) > 0


@pytest.mark.parametrize("cfg, S", [(MICRO_CFG, 2), (MICRO_CFG, 4),
                                    (SHORT_CFG, 2), (SHORT_CFG, 3),
                                    (SHORT_CFG, 4)],
                         ids=["micro-2", "micro-4", "hybrid-2", "hybrid-3",
                              "hybrid-4"])
def test_sharded_derivative_is_bit_exact_to_single_shard(cfg, S):
    """Against the single-shard forward-mode derivative (one action entry
    at a time); also close to autograd of the plain episode (reverse mode
    rounds differently)."""
    env = port_env(cfg)
    plan = k6.make_plan(env, True)
    B = 2
    inputs = port_inputs(env, plan, B=B)
    wq = torch.as_tensor(np.random.default_rng(0).uniform(
        -1, 1, (B, plan.T)), dtype=torch.float32)
    fb, db, ib = k6.dual_state(plan, B, "cpu")
    g64 = torch.zeros(fb.shape[0], dtype=torch.float64)
    k6.plain_spatial_step_bwd(plan, fb, db, ib, 0, plan.T, inputs, wq, g64)
    ref = g64.view(B, -1).sum(0).to(torch.float32).view(plan.n_phases, -1)
    comm = ks.LaneComm(plan.L, ks.shards_of(plan.L, S))
    got = ks.plain_sharded_episode_bwd(plan, comm, wq, *inputs)
    assert torch.isfinite(got).all() and got.abs().max() > 0
    assert torch.equal(got, ref)
    auto = k6.plain_spatial_episode_bwd(plan, wq, *inputs)
    torch.testing.assert_close(got, auto, rtol=1e-4,
                               atol=1e-6 * float(auto.abs().max()))


def test_shard_episode_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers launch nothing; K5's op over the sharded
    episode differentiates through its derivative (no autograd of the
    body), and its gradient equals the wrapper's."""
    env = port_env(SHORT_CFG)
    plan = k6.make_plan(env, True)
    inputs = port_inputs(env, plan)
    comm = ks.LaneComm(plan.L, ks.shards_of(plan.L, 2))
    before = dict(ks.launches)
    q, ev, w = ks.shard_episode_fwd(plan, comm, *inputs)
    op = ks.make_shard_episode_op(plan, comm)
    a = inputs[0].clone().requires_grad_(True)
    q2, ev2, w2 = op(a, *inputs[1:])
    assert q2.requires_grad and not w2.requires_grad
    assert torch.equal(q, q2.detach()) and torch.equal(ev, ev2)
    q2.sum().backward()
    ref = ks.shard_episode_bwd(plan, comm, torch.ones_like(q), *inputs)
    assert torch.equal(a.grad, ref)
    assert ks.launches == before
    with pytest.raises(ValueError, match="hard"):
        ks.shard_episode_bwd(k6.make_plan(env, False), comm,
                             torch.ones_like(q), *inputs)
    with pytest.raises(ValueError, match="shards"):
        ks.shards_of(plan.L, 5)


# ---------------------------------------------------------------------------
# mesh and K5's ops
# ---------------------------------------------------------------------------


def test_mesh_of_one_lane_shard_needs_no_process_group():
    mesh = make_mesh({"data": 1, "lane": 1}, "cpu")
    assert mesh.lanes == 1 and mesh.lane_group is None and mesh.writer
    with pytest.raises(RuntimeError, match="torch.distributed"):
        make_mesh({"lane": 2}, "cpu")
    with pytest.raises(NotImplementedError, match="data axis"):
        make_mesh({"data": 2, "lane": 2}, "cpu")


def test_kernel_sg_detaches_and_runs_the_body_on_the_cpu():
    calls = []

    def body(x, n):
        return x * 2.0, n + 1

    def kernel(*args):
        calls.append(args)
        raise AssertionError("the kernel must not run on CPU tensors")

    op = make_kernel_sg(body, kernel, name="twice")
    x = torch.tensor([1.0, -3.0], requires_grad=True)
    y, n = op(x, torch.tensor([4], dtype=torch.int32))
    assert not y.requires_grad and y.grad_fn is None and not calls
    assert torch.equal(y, torch.tensor([2.0, -6.0])) and int(n) == 5
    assert op.body is body and op.forward is kernel


def test_dkernel_without_body_autograd_uses_the_derivative_on_the_cpu():
    seen = []

    def derivative(args, cots):
        seen.append(len(cots))
        return (3.0 * cots[0],)

    op = make_dkernel(lambda x: (x * 3.0,), lambda x: (x * 3.0,),
                      derivative, (0,), name="triple", body_autograd=False)
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    (y,) = op(x)
    y.sum().backward()
    assert seen == [1] and torch.equal(x.grad, torch.full((2,), 3.0))
