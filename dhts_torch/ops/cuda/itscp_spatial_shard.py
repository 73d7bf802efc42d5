"""Fused spatial step of the ITSCP hybrid episode with the lanes sharded:
kernel K6's per-shard bodies A, B, C, D1, D2, D3 and E between collectives
over the lane axis (D1, D2 and D3 as one launch, D3's, which also writes
the next step's A rows), and K5's derivative around the episode.

Port of the ``n_shard > 1`` part of
:mod:`dhts.ops.pallas.itscp_spatial_step` (``body_A`` ... ``body_E`` and
``step_sharded``). Each shard holds lanes ``[off, off + n)`` of the scene:
its carry is the single-shard step's carry at ``n`` lanes (the layout of
:mod:`dhts_torch.ops.cuda.itscp_spatial_step`), and every read of another
lane goes through rows gathered over the lane axis, ``[B, rows, L]``, with
the true sizes (no padding; where JAX compares with its padded width, the
port uses L):

====  ===================================================================
A     pre-physics summary ``sumA [9]``: edge cells, tail, injection bit;
      launched for step 0 only (from step 1 on D3 writes it, below)
      --- all_gather -> gA ---
B     injection; signal-blended macro ghosts; the leader walk over the
      gathered tails; the head's signal; per-lane signal terms ``sg [2]``
      --- psum (the terms gathered, summed in lane order) -> sg_ms ---
C     signal blend, Godunov and IDM, flux capacitors; post-physics rows
      ``sumF [15]`` and ``sumI [4]`` (JAX's ``sumI [3]`` and, in place of
      its ``route_h [R]``, the head's route id: the port's vehicles hold
      route ids into the shared route table)
      --- all_gather -> gF, gI ---
D     the conversion, one launch (D3's): JAX's D1, D2 and D3 and the two
      gathers between them. Every lane's wants from the gathered rows
      (D1: emit, transfer or deposit target), each destination's lowest
      wanting predecessor (D2: ``best``, ``dep_best``), then the local
      lanes' verdicts, removals, inserts, deposits (D3); per-lane
      static-mean terms; before the last step, the next step's A rows
      from the carry the conversion left
      --- psum (gathered, summed in lane order) -> ss_ms; with the
          next step's A rows -> its gA ---
E     the lanes' squared soft queues ``q^2`` (one row per step)
====  ===================================================================

From step 1 on a step is four launches (B, C, D3, E), one gather and two
sums in soft mode (one sum in hard mode on a split lane axis); step 0
also launches A and gathers its rows. JAX gathers the wants (``gW``) and
the arbitration (``gV``) between D1, D2 and D3 to keep its one-hot
gathers at O(L l_loc) a device; every input of D1 and D2 is in the rows
gathered after C or in the scene, so the port computes them where D3
reads them. A reads only its own lane's carry, which nothing after D3
changes (E writes only the static mean), so D3's lane thread writes the
next step's A rows and they travel in the collective of D3's terms: an
episode of T steps makes 2T + 1 collective calls between the bodies in
hard mode on a split lane axis and 3T + 1 in soft mode.

Per episode the lanes' ``q^2`` rows are gathered once and summed in lane
order (on the card by a kernel of its own, Q), and the event counts and
wave maxima are reduced once (one psum, one pmax), as JAX reduces its
partials once per episode. In hard mode a split lane axis skips the
signal terms' sum, as JAX does (:func:`gathers_sg`).

Sums: the two running means and the queue are summed from per-lane terms
in lane order on every rank (float64, rounded once), exactly as the
single-shard STEP kernel sums them. So the sharded episode is bit-exact to
the single-shard episode at any shard count, every rank holds the same
values without a broadcast, and the controller's parameters stay
replicated without a gradient all-reduce.

* ``plain_body_A`` ... ``plain_body_E`` are the plain PyTorch bodies
  (JAX's seven; :func:`plain_body_D` composes D1, D2 and D3 over the
  gathered rows), :func:`plain_shard_step` composes them over this
  process's shards with a :class:`LaneComm` gathering between them, on
  the kernels' schedule (it takes the step's gathered A rows and returns
  the next step's; the single-shard ``plain_spatial_step`` is this
  composition on one shard, whose gathers are identities), and
  :func:`plain_sharded_episode` /
  :func:`plain_sharded_episode_bwd` run an episode and its forward-mode
  derivative (the bodies under ``torch.autograd.forward_ad``, primal and
  tangent rows gathered together).
* :class:`ShardRun` launches the hand-written kernels of
  ``csrc/itscp_spatial_shard.cu`` (one launch per body and step, A's at
  step 0 only, one block per episode, one thread per local lane; a
  ``Dual`` variant of each with one block per episode and action entry;
  Q once per
  episode, one block per tile of up to 32 steps of a row) between the
  same gathers; each launch counts in
  :data:`launches`. :data:`STEP` describes each body once: its plain
  version on the run's buffers, where its kernel writes, and what is
  gathered after it; the run's step, its checked step and the card's
  timing of the plain bodies all go through it.
* :func:`shard_episode_fwd` and :func:`shard_episode_bwd` are the wrappers:
  CPU tensors run the plain versions, CUDA tensors the kernels.
  :func:`make_shard_episode_op` is K5's op around the episode.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dhts_torch.ops import arz, dmath, idm
from dhts_torch.ops.cuda import _launch
from dhts_torch.ops.cuda import itscp_spatial_step as k6
from dhts_torch.ops.cuda.dkernel import make_dkernel
from dhts_torch.ops.dmath import soft_sigmoid
from dhts_torch.parallel import collectives

SOURCE = "dhts_torch/ops/cuda/csrc/itscp_spatial_shard.cu"
PALLAS = "dhts/ops/pallas/itscp_spatial_step.py"
REPLACES = {"A": f"{PALLAS}:279", "B": f"{PALLAS}:302", "C": f"{PALLAS}:440",
            "D1": f"{PALLAS}:544", "D2": f"{PALLAS}:592",
            "D3": f"{PALLAS}:621", "E": f"{PALLAS}:847"}
# the pallas_call each body reaches: K5's make_dkernel forward and
# backward, and make_kernel_sg for D1 and D2
REPLACES_SG = "dhts/ops/pallas/dkernel.py:154"
# the TPU kernels whose work a body's launch does besides its own: D3's
# does D1's and D2's, and A's for the next step (A launches for step 0)
ALSO_REPLACES = {"D3": ("D1", "D2", "A")}
HARD = k6.HARD
# a shard's lanes: one thread each, and C's and E's reduction warp beside
# them, in a block of 1,024 threads (MAX_LANES in the kernels' source)
MAX_LANES = k6.MAX_LANES - 32

BODIES = ("A", "B", "C", "D3", "E")
# the bodies launched at every step; A only where no step before wrote and
# gathered the step's A rows (step 0)
EVERY_STEP = BODIES[1:]
# the kernels: the bodies, and Q, body_E's lane sum of q^2 (:861-865) once
# per episode over the gathered rows (in a derivative, with the loss
# weights' sum over the steps); each has a `Dual` variant
KERNELS = BODIES + ("Q",)
REPLACES["Q"] = f"{PALLAS}:861"
# launches per kernel: forward "A" ... "Q", derivative "A_bwd" ... "Q_bwd"
launches = {**{b: 0 for b in KERNELS}, **{f"{b}_bwd": 0 for b in KERNELS}}

# rows of the summaries (JAX's names and order)
A_ROWS = ("r_first", "u_first", "r_last", "u_last", "count", "tail_pos",
          "tail_vel", "tail_len", "inject")
BC_ROWS = ("bl_r", "bl_u", "gr_r", "gr_u", "sig", "pd_g", "sd_g", "red_pd",
           "fsig", "blend")
F_RLAST, F_ULAST, F_COUNT, F_TPOS, F_TLEN, F_CAP = range(6)
F_HPOS, F_HVEL, F_HLEN, F_HA, F_AMAX = 6, 7, 8, 9, 10  # F_AMAX .. + 4: tp
N_F = 15
I_MN, I_RIDX, I_HNEXT, I_RID = range(4)
N_I = 4


class Shard(NamedTuple):
    """Lanes ``[off, off + n)`` of the scene."""

    off: int
    n: int

    @property
    def cols(self) -> slice:
        return slice(self.off, self.off + self.n)


def shards_of(L: int, S: int) -> list:
    """The S equal shards of L lanes (JAX requires L % S == 0)."""
    if S < 1 or L % S:
        raise ValueError(f"{L} lanes do not split into {S} equal shards")
    n = L // S
    return [Shard(s * n, n) for s in range(S)]


def local_geometry(g: k6.Geometry, sh: Shard) -> k6.Geometry:
    """The per-lane tables of the shard's lanes (``gid`` holds their global
    ids)."""
    return k6.Geometry(*(x[..., sh.cols] for x in g))


def slice_carry(carry, sh: Shard):
    return tuple(x[..., sh.cols] for x in carry)


def _clamp(L):
    return lambda j: torch.clamp(j, 0, L - 1).long()


def _seq_sum64(x, dim: int):
    """Float64 sum over ``dim``, term after term in index order (the
    kernels' order; on CPU tensors ``cumsum`` adds sequentially)."""
    return torch.cumsum(x.to(torch.float64), dim).select(dim, -1)


def lane_sum32(x):
    """Sum over the last (lane) axis in float64 in lane order, rounded
    once to float32."""
    return _seq_sum64(x, -1).to(torch.float32)


# ---------------------------------------------------------------------------
# plain bodies (one shard's carry [B, ., n]; cross-lane reads through the
# gathered rows [B, rows, L])
# ---------------------------------------------------------------------------


def plain_body_A(plan, lg, carry, rand_t, sched_t):
    """``sumA [B, 9, n]``: first and last cell (density, speed), vehicle
    count, tail position, speed and length, and the injection bit. ``rand_t
    [B, n]`` and ``sched_t [n]`` are the shard's columns."""
    u_max, veh_len = plan.floats[0], plan.floats[2]
    r, y, pos, vel, p_len = carry[0], carry[1], carry[2], carry[3], carry[10]
    count, inj_left = carry[11], carry[15]
    B, n = count.shape
    u = arz.compute_u(r, y, u_max)
    lastB = lg.last[None, None].expand(B, 1, n)
    r_last = r.gather(1, lastB).squeeze(1)
    u_last = u.gather(1, lastB).squeeze(1)
    incoming = torch.where(lg.has_prev, -1.0, sched_t)
    free = torch.where(count > 0, pos[:, 0] - 0.5 * p_len[:, 0], lg.length)
    inject = (~lg.has_prev & ~lg.is_macro & (free > 0.5 * veh_len) &
              (rand_t < incoming) & (inj_left > 0) & (count < plan.V))
    return torch.stack([r[:, 0], u[:, 0], r_last, u_last,
                        count.to(torch.float32), pos[:, 0], vel[:, 0],
                        p_len[:, 0], inject.to(torch.float32)], 1)


class OutB(NamedTuple):
    carry: tuple
    bc: torch.Tensor  # f32[B, 10, n], BC_ROWS
    sg: torch.Tensor  # f32[B, 2, n]: the head's signal where blended, 0/1
    n_inj: torch.Tensor  # [B]


def plain_body_B(plan, g, lg, carry, gA, action2d, t, mnext_t, mprev_t,
                 sched_t, routes) -> OutB:
    """Apply the injections of ``gA``'s bit; the macro ghosts from the
    neighbours' gathered edge cells behind the signals; the leader walk
    along the head's route over the gathered tails and counts; the signal
    the head sees. ``mnext_t``, ``mprev_t``, ``sched_t`` are the shard's
    columns; ``action2d`` is ``[n_phases, n_inter]`` or, with a row per
    episode, ``[B, n_phases, n_inter]``."""
    (u_max, _, veh_len, _, _, _, amax0, apref0, vt0, ms0, tp0, _,
     _) = plan.floats
    soft = plan.mode != HARD
    L, V, R, P = plan.L, plan.V, plan.R, plan.P
    (r, y, pos, vel, av, p_amax, p_apref, p_vt, p_ms, p_tp, p_len, count,
     rid, ridx, cap, inj_left, cursor) = carry
    B, n = count.shape
    dev = count.device
    clampL = _clamp(L)
    _take = k6._take
    f = lambda v: torch.full((B, n), v, dtype=torch.float32, device=dev)
    zeros = f(0.0)
    sig_rows = k6.lane_signals(plan, action2d, t, soft, g).expand(B, L)
    sig = sig_rows[:, lg.gid]
    incoming = torch.where(lg.has_prev, -1.0, sched_t)

    # the gathered tails and counts after this step's injections
    g_inj = gA[:, 8] > 0.5
    gcount = gA[:, 4].to(torch.int32) + g_inj.to(torch.int32)
    gtail_pos = torch.where(g_inj, 0.0, gA[:, 5])
    gtail_vel = torch.where(g_inj, 0.0, gA[:, 6])
    gtail_len = torch.where(g_inj, veh_len, gA[:, 7])

    # apply the local injections
    inject = g_inj[:, lg.gid]
    pool_idx = torch.clamp(P - inj_left, 0, P - 1)
    new_rid = (lg.gid * P + pool_idx).to(torch.int32)
    ins = k6._insert
    pos = ins(pos, zeros, inject)
    vel = ins(vel, zeros, inject)
    av = ins(av, f(veh_len), inject)
    p_amax = ins(p_amax, f(amax0), inject)
    p_apref = ins(p_apref, f(apref0), inject)
    p_vt = ins(p_vt, f(vt0), inject)
    p_ms = ins(p_ms, f(ms0), inject)
    p_tp = ins(p_tp, f(tp0), inject)
    p_len = ins(p_len, f(veh_len), inject)
    rid = ins(rid, new_rid, inject)
    ridx = ins(ridx, torch.zeros_like(count), inject)
    count = count + inject.to(torch.int32)
    inj_left = inj_left - inject.to(torch.int32)
    n_inj = inject.sum(1)

    # macro ghosts from the neighbours' summaries
    adjp = torch.where(lg.num_prev == 1, lg.prev_k[0], mprev_t)
    use_l = (lg.num_prev > 0) & (adjp >= 0) & g.is_macro[clampL(adjp)]
    gl_r = torch.where(lg.has_prev,
                       torch.where(use_l, _take(gA[:, 2], clampL(adjp)), 0.0),
                       incoming)
    gl_u = torch.where(lg.has_prev,
                       torch.where(use_l, _take(gA[:, 3], clampL(adjp)),
                                   u_max),
                       arz.compute_u_eq(incoming, u_max))
    prev_sig = torch.where(~lg.has_prev, 1.0,
                           torch.where(mprev_t < 0, 0.0,
                                       _take(sig_rows, clampL(mprev_t))))
    bl_r = gl_r * prev_sig
    bl_u = gl_u * prev_sig + u_max * (1.0 - prev_sig)
    adjn = torch.where(lg.num_next == 1, lg.next_k[0], mnext_t)
    use_r = (lg.num_next > 0) & (adjn >= 0) & g.is_macro[clampL(adjn)]
    gr_r = torch.where(use_r, _take(gA[:, 0], clampL(adjn)), 0.0)
    gr_u = torch.where(use_r, _take(gA[:, 1], clampL(adjn)), u_max)

    # leader walk along the head's route
    h = torch.clamp(count - 1, 0, V - 1)
    pick = k6._pick
    hv_pos, hv_vel, hv_len = pick(pos, h), pick(vel, h), pick(p_len, h)
    h_rid, h_ridx = pick(rid, h), pick(ridx, h)
    h_exists = count > 0
    base = (lg.length - hv_pos) - hv_len * 0.5
    done = ~h_exists
    found = torch.zeros_like(done)
    wstar = torch.full_like(count, -1)
    cdel_st = zeros
    cur = base
    for o in range(plan.W):
        wl = k6._route_at(routes, h_rid, h_ridx + 1 + o, R)
        exists = wl >= 0
        wl_c = clampL(wl)
        w_macro = exists & g.is_macro[wl_c]
        occupied = exists & ~w_macro & (_take(gcount, wl_c) > 0)
        term_default = ~done & (~exists | w_macro)
        term_leader = ~done & occupied
        wstar = torch.where(term_leader, wl, wstar)
        cdel_st = torch.where(term_leader, cur.detach(), cdel_st)
        found = found | term_leader
        done = done | term_default | term_leader
        cur = torch.where(~done, cur + torch.where(exists, g.length[wl_c],
                                                   0.0), cur)
    w_c = clampL(wstar)
    gt_pos = torch.where(found, _take(gtail_pos, w_c), 0.0)
    gt_vel = torch.where(found, _take(gtail_vel, w_c), 0.0)
    gt_len = torch.where(found, _take(gtail_len, w_c), 0.0)
    cdel = cdel_st + (base - base.detach())
    pd_g = torch.where(found, dmath.maximum((cdel + gt_pos) - gt_len * 0.5,
                                            0.0), 1000.0)
    sd_g = torch.where(found, hv_vel - gt_vel, 0.0)

    # the signal the head sees: blended over its previous, current and
    # next route lane
    red_pd = dmath.maximum((lg.length - hv_pos) - hv_len * 0.5, 0.0)
    prev_l = k6._route_at(routes, h_rid, h_ridx - 1, R)
    next_l = k6._route_at(routes, h_rid, h_ridx + 1, R)
    curr_l = k6._route_at(routes, h_rid, h_ridx, R)
    prev_exist, next_exist = prev_l >= 0, next_l >= 0
    if soft:
        p_sc = torch.where(prev_exist, soft_sigmoid(-hv_pos, 16.0), 0.0)
        c_sc = soft_sigmoid(hv_pos, 16.0) * soft_sigmoid(lg.length - hv_pos,
                                                         16.0)
        n_sc = torch.where(next_exist, soft_sigmoid(hv_pos - lg.length,
                                                    16.0), 0.0)
    else:
        p_sc, c_sc, n_sc = zeros, f(1.0), zeros
    ssum = (p_sc + c_sc) + n_sc
    p_sc, c_sc, n_sc = p_sc / ssum, c_sc / ssum, n_sc / ssum
    sig_at = lambda j: torch.where(j >= 0, _take(sig_rows, clampL(j)), 0.0)
    fsig = c_sc * sig_at(curr_l)
    fsig = fsig + torch.where(prev_exist, p_sc * sig_at(prev_l), 0.0)
    fsig = fsig + torch.where(next_exist, n_sc * sig_at(next_l), 0.0)
    blend = h_exists & ~lg.is_macro
    bc = torch.stack(torch.broadcast_tensors(
        bl_r, bl_u, gr_r, gr_u, sig, pd_g, sd_g, red_pd, fsig,
        blend.to(torch.float32)), 1)
    sg = torch.stack([torch.where(blend, fsig.detach(), 0.0),
                      blend.to(torch.float32)], 1)
    carry = (r, y, pos, vel, av, p_amax, p_apref, p_vt, p_ms, p_tp, p_len,
             count, rid, ridx, cap, inj_left, cursor)
    return OutB(carry, bc, sg, n_inj)


def fold_sg(plan, sg_ms, gsg):
    """The signal running mean after this step's gathered terms ``gsg [B,
    2, L]``, and its sigmoid constant (the detached mean sharpens the
    blend gate)."""
    sg_ms = sg_ms + torch.stack([lane_sum32(gsg[:, 0]),
                                 lane_sum32(gsg[:, 1])], 1)
    mean = sg_ms[:, 0] / dmath.maximum(sg_ms[:, 1], 1.0)
    c_sig = arz.rdiv(plan.floats[12], dmath.maximum(torch.abs(mean), 1e-6))
    return sg_ms, c_sig


class OutC(NamedTuple):
    carry: tuple
    sumF: torch.Tensor  # f32[B, 15, n]
    sumI: torch.Tensor  # i32[B, 4, n]: mnext, head ridx, head next, head rid
    wave: torch.Tensor  # f32[B]: the shard's largest wave speed
    floor_hits: torch.Tensor  # [B]


def plain_body_C(plan, g, lg, carry, bc, c_sig, mnext_t, routes) -> OutC:
    """Signal blend of the head deltas, Godunov and IDM physics, flux
    capacitors, and the post-physics summaries of the shard's lanes."""
    (u_max, dt, veh_len, _, _, _, _, _, _, _, _, _, gate32) = plan.floats
    soft = plan.mode != HARD
    L, C, V, R = plan.L, plan.C, plan.V, plan.R
    (r, y, pos, vel, av, p_amax, p_apref, p_vt, p_ms, p_tp, p_len, count,
     rid, ridx, cap, inj_left, cursor) = carry
    B, n = count.shape
    dev = count.device
    clampL = _clamp(L)
    bl_r, bl_u, gr_r, gr_u, sig, pd_g, sd_g, red_pd, fsig, blend = \
        bc.unbind(1)
    blend = blend > 0.5
    if soft:
        fs = soft_sigmoid(fsig - 0.5, c_sig[:, None])
        pd = pd_g * fs + red_pd * (1.0 - fs)
        sd = sd_g * fs
        s_own = soft_sigmoid(sig - 0.5, gate32)
    else:
        green = fsig >= 0.5
        pd = torch.where(green, pd_g, red_pd)
        sd = torch.where(green, sd_g, 0.0)
        s_own = (sig > 0.5).to(torch.float32)
    pd = torch.where(blend, pd, pd_g)
    sd = torch.where(blend, sd, sd_g)
    br_r = gr_r * s_own + (1.0 - s_own)
    br_u = gr_u * s_own

    right_y = arz.compute_y(br_r, br_u, u_max)
    rp = torch.where(lg.cmask, r, br_r[:, None])
    yp = torch.where(lg.cmask, y, right_y[:, None])
    res = arz.godunov_step(rp.transpose(1, 2), yp.transpose(1, 2), bl_r,
                           bl_u, br_r, br_u, u_max, dt, lg.cell_len)
    r = torch.where(lg.cmask, res.r.transpose(1, 2), r)
    y = torch.where(lg.cmask, res.y.transpose(1, 2), y)
    wave = torch.amax(torch.where(lg.is_macro, res.max_wave_speed, 0.0), 1)

    rows = torch.arange(V, device=dev)[None, :, None]
    active = rows < count[:, None]
    is_head = rows == (count - 1)[:, None]
    zeros = torch.zeros((B, n), dtype=torch.float32, device=dev)
    lead = lambda x, top: torch.cat([x[:, 1:], top], 1)
    gap = (torch.abs(lead(pos, zeros[:, None]) - pos) -
           (lead(p_len, p_len[:, :1]) + p_len) * 0.5)
    dv = vel - lead(vel, zeros[:, None])
    gap = torch.where(is_head, pd[:, None], gap)
    dv = torch.where(is_head, sd[:, None], dv)
    coll = gap < 0.0
    gap = dmath.maximum(torch.where(coll, 0.0, gap), idm.POSITION_DELTA_EPS)
    dv = torch.where(coll, 0.0, dv)
    acc_res = idm.idm_acceleration(p_amax, p_apref, vel, p_vt, gap, dv, p_ms,
                                   p_tp, dt)
    acc = torch.where(active, acc_res.acceleration, 0.0)
    pos = torch.where(active, pos + dt * vel, pos)
    new_vel = vel + dt * acc
    # stopped by the acceleration floor: the new speed does not depend on
    # the old one (dhts_torch/ops/idm.py)
    new_vel = torch.where(active & acc_res.clipped_acceleration,
                          new_vel.detach(), new_vel)
    vel = torch.where(active, new_vel, vel)

    u = arz.compute_u(r, y, u_max)
    lastB = lg.last[None, None].expand(B, 1, n)
    r_last = r.gather(1, lastB).squeeze(1)
    u_last = u.gather(1, lastB).squeeze(1)
    mn = mnext_t
    next_is_micro = lg.is_macro & (mn >= 0) & ~g.is_macro[clampL(mn)]
    inc = torch.where(next_is_micro, (r_last * u_last) * dt, 0.0)
    match = (lg.next_k == mn) & (lg.next_k >= 0)  # [K, n]
    has_slot = match.any(0)
    slot = torch.argmax(match.to(torch.int32), 0)
    cap = torch.where(match, cap + inc[:, None], cap)
    cap_val = torch.where(has_slot, cap.gather(
        1, slot[None, None].expand(B, 1, n)).squeeze(1), 0.0)

    # post-physics head of every lane (the conversion's source fields)
    h = torch.clamp(count - 1, 0, V - 1)
    pick = k6._pick
    hs_rid, hs_ridx = pick(rid, h), pick(ridx, h)
    hnext = k6._route_at(routes, hs_rid, hs_ridx + 1, R)
    sumF = torch.stack(torch.broadcast_tensors(
        r_last, u_last, count.to(torch.float32), pos[:, 0], p_len[:, 0],
        cap_val, pick(pos, h), pick(vel, h), pick(p_len, h), pick(av, h),
        *(pick(x, h) for x in (p_amax, p_apref, p_vt, p_ms, p_tp))), 1)
    sumI = torch.stack(torch.broadcast_tensors(
        mn.to(torch.int32), hs_ridx, hnext.to(torch.int32), hs_rid), 1)
    carry = (r, y, pos, vel, av, p_amax, p_apref, p_vt, p_ms, p_tp, p_len,
             count, rid, ridx, cap, inj_left, cursor)
    floor_hits = (active & acc_res.clipped_acceleration).sum((1, 2))
    return OutC(carry, sumF, sumI.to(torch.int32), wave.detach(),
                floor_hits)


def plain_body_D1(plan, g, lg, carry, sumF, sumI, gF, gI):
    """Wants of the shard's source lanes at their gathered destinations:
    ``wrow [B, 3, n]`` (emit bit, transfer target, deposit target; -2 for
    none) and ``pred [B, 4, n]`` (exit, emit, transfer, deposit)."""
    veh_len = plan.floats[2]
    L, V = plan.L, plan.V
    clampL = _clamp(L)
    _take = k6._take
    mn, hnext = sumI[:, I_MN], sumI[:, I_HNEXT]
    mn_c, hn_c = clampL(mn), clampL(hnext)
    next_is_micro = lg.is_macro & (mn >= 0) & ~g.is_macro[mn_c]
    gcount = gF[:, F_COUNT].to(torch.int32)
    dest_count = torch.where(mn >= 0, _take(gcount, mn_c), 0)
    free_n = torch.where(dest_count > 0,
                         _take(gF[:, F_TPOS], mn_c) -
                         0.5 * _take(gF[:, F_TLEN], mn_c),
                         torch.where(mn >= 0, g.length[mn_c], 0.0))
    want_emit = (next_is_micro & (sumF[:, F_CAP].detach() >= veh_len) &
                 (free_n >= veh_len) & (dest_count < V))
    h_exists = carry[11] > 0
    hs_pos, hs_len = sumF[:, F_HPOS], sumF[:, F_HLEN]
    past_end = h_exists & (hs_pos >= lg.length)
    hn_macro = (hnext >= 0) & g.is_macro[hn_c]
    hn_micro = (hnext >= 0) & ~hn_macro
    exit_none = past_end & (hnext < 0)
    want_tr = past_end & hn_micro & (_take(gcount, hn_c) < V)
    want_dep = h_exists & hn_macro & (hs_pos > lg.length + hs_len)
    wrow = torch.stack([want_emit.to(torch.int32),
                        torch.where(want_tr, hnext, -2),
                        torch.where(want_dep, hnext, -2)], 1)
    pred = torch.stack([exit_none, want_emit, want_tr, want_dep], 1)
    return wrow.to(torch.int32), pred.to(torch.int32)


def plain_body_D2(plan, lg, gI, gW):
    """Arbitration: each of the shard's destination lanes takes the lowest
    predecessor id that wants to emit or transfer into it (``best``) and
    the lowest that wants to deposit (``dep_best``), L for none: ``[B, 2,
    n]``."""
    L = plan.L
    clampL = _clamp(L)
    _take = k6._take
    mn_g = gI[:, I_MN]
    want_emit, tr_tgt, dep_tgt = gW[:, 0] != 0, gW[:, 1], gW[:, 2]
    B, n = gI.shape[0], lg.gid.shape[0]
    best = torch.full((B, n), L, dtype=torch.int32, device=gI.device)
    dep_best = torch.full_like(best, L)
    for k in range(plan.K):
        pk = lg.prev_k[k]
        ok = pk >= 0
        pk_c = clampL(pk)
        c_emit = _take(want_emit, pk_c) & (_take(mn_g, pk_c) == lg.gid)
        c_tr = _take(tr_tgt, pk_c) == lg.gid
        best = torch.minimum(best, torch.where(ok & (c_emit | c_tr), pk, L))
        dep_best = torch.minimum(dep_best, torch.where(
            ok & (_take(dep_tgt, pk_c) == lg.gid), pk, L))
    return torch.stack([best, dep_best], 1).to(torch.int32)


class OutD3(NamedTuple):
    carry: tuple
    ss: torch.Tensor  # f64[B, 2, n]: per-lane sums of (static_speed - u)
    ssn: torch.Tensor  # i32[B, 2, n]: their cell and vehicle counts
    ev: torch.Tensor  # [B, 3]: emitted, exited or deposited, transferred


def plain_body_D3(plan, g, lg, carry, gF, gI, gV, pred, bd, sumI) -> OutD3:
    """Verdicts at the gathered arbitration rows, removals, the capacitor
    decrement, inserts of the winning sources' vehicles (fields from the
    gathered post-physics rows), deposits; the lanes' static-mean terms."""
    (u_max, _, veh_len, static_speed, _, _, amax0, apref0, vt0, ms0, tp0,
     rho_hi, _) = plan.floats
    L, C, V, P, P2 = plan.L, plan.C, plan.V, plan.P, plan.P2
    (r, y, pos, vel, av, p_amax, p_apref, p_vt, p_ms, p_tp, p_len, count,
     rid, ridx, cap, inj_left, cursor) = carry
    B, n = count.shape
    dev = count.device
    clampL = _clamp(L)
    _take = k6._take
    mn, hnext = sumI[:, I_MN], sumI[:, I_HNEXT]
    mn_c, hn_c = clampL(mn), clampL(hnext)
    exit_none, want_emit, want_tr, want_dep = (pred[:, i] != 0
                                               for i in range(4))
    emit_win = want_emit & (_take(gV[:, 0], mn_c) == lg.gid)
    tr_win = want_tr & (_take(gV[:, 0], hn_c) == lg.gid)
    dep_win = want_dep & (_take(gV[:, 1], hn_c) == lg.gid)
    remove = exit_none | dep_win | tr_win
    count = count - remove.to(torch.int32)
    match = (lg.next_k == mn[:, None]) & (lg.next_k >= 0)  # [B, K, n]
    slot = torch.argmax(match.to(torch.int32), 1)
    cap_val = torch.where(match.any(1), cap.gather(1, slot[:, None]).squeeze(
        1), 0.0)
    cap_dec = torch.where(emit_win, (cap_val - veh_len).detach(), cap_val)
    cap = torch.where(match, cap_dec[:, None], cap)

    best, dep_best = bd[:, 0], bd[:, 1]
    has_ins = best < L
    src = clampL(best)
    is_emit = has_ins & g.is_macro[src]
    fro = lambda i, s=src: _take(gF[:, i], s)
    cap_g = gF[:, F_CAP]
    carrier = (veh_len + cap_g) - cap_g.detach()
    new_pos = torch.where(is_emit, 0.0, fro(F_HPOS) - g.length[src])
    new_vel = torch.where(is_emit, fro(F_ULAST), fro(F_HVEL))
    new_a = torch.where(is_emit, _take(carrier, src), fro(F_HA))
    new_par = [torch.where(is_emit, d, fro(i)) for d, i in zip(
        (amax0, apref0, vt0, ms0, tp0, veh_len),
        (F_AMAX, F_AMAX + 1, F_AMAX + 2, F_AMAX + 3, F_AMAX + 4, F_HLEN))]
    new_rid = torch.where(is_emit, (L * P + lg.gid * P2 + cursor % P2).to(
        torch.int32), _take(gI[:, I_RID], src))
    new_ridx = torch.where(is_emit, 0, _take(gI[:, I_RIDX], src) + 1).to(
        torch.int32)
    ins = k6._insert
    pos = ins(pos, new_pos, has_ins)
    vel = ins(vel, new_vel, has_ins)
    av = ins(av, new_a, has_ins)
    p_amax, p_apref, p_vt, p_ms, p_tp, p_len = (
        ins(x, v, has_ins) for x, v in zip(
            (p_amax, p_apref, p_vt, p_ms, p_tp, p_len), new_par))
    rid = ins(rid, new_rid, has_ins)
    ridx = ins(ridx, new_ridx, has_ins)
    count = count + has_ins.to(torch.int32)
    cursor = cursor + is_emit.to(torch.int32)

    # micro -> macro deposit from the winning source (gathered at a clamped
    # index: a dead branch's operands stay finite)
    dep_has = dep_best < L
    dsrc = clampL(dep_best)
    v_head = fro(F_HPOS, dsrc) - g.length[dsrc]
    d_len = fro(F_HLEN, dsrc)
    v_tail = v_head - d_len
    cells = torch.arange(C, dtype=torch.float32, device=dev)[:, None]
    c_tail = cells * lg.cell_len
    c_head = (cells + 1.0) * lg.cell_len
    v_head3, v_tail3 = v_head[:, None], v_tail[:, None]
    ov = ((c_head > v_tail3) & (c_tail < v_head3) & lg.cmask &
          dep_has[:, None] & (lg.cell_len > v_tail3))
    overlap = ((lg.cell_len + d_len)[:, None] -
               (torch.maximum(c_head, v_head3) -
                torch.minimum(c_tail, v_tail3)))
    add_r = ((fro(F_HA, dsrc) / d_len.detach())[:, None] *
             (overlap / lg.cell_len))
    n_r = dmath.st_clip(r + add_r, 1e-5, rho_hi)
    r = torch.where(ov, n_r, r)
    y = torch.where(ov, arz.compute_y(n_r, fro(F_HVEL, dsrc)[:, None],
                                      u_max), y)

    # the static running mean's terms of each lane, after the conversion
    u_cells = arz.compute_u(r, y, u_max)
    rows = torch.arange(V, device=dev)[None, :, None]
    veh_m = (rows < count[:, None]) & ~lg.is_macro
    ss = torch.stack([
        _seq_sum64(torch.where(lg.cmask, static_speed - u_cells.detach(),
                               0.0), 1),
        _seq_sum64(torch.where(veh_m, static_speed - vel.detach(), 0.0), 1)],
        1)
    ssn = torch.stack([lg.cmask.sum(0).expand(B, n), veh_m.sum(1)], 1)
    ev = torch.stack([is_emit.sum(1), (exit_none | dep_win).sum(1),
                      tr_win.sum(1)], 1)
    carry = (r, y, pos, vel, av, p_amax, p_apref, p_vt, p_ms, p_tp, p_len,
             count, rid, ridx, cap, inj_left, cursor)
    return OutD3(carry, ss, ssn.to(torch.int32), ev)


def plain_arbitration(plan, g, gF, gI):
    """The conversion's wants and arbitration over the whole scene from the
    gathered post-physics rows: :func:`plain_body_D1` at every lane (the
    lane's count is C's row ``F_COUNT``), then :func:`plain_body_D2` at
    every lane. Returns ``pred [B, 4, L]`` (exit, emit, transfer, deposit)
    and ``gV [B, 2, L]`` (``best``, ``dep_best``; L for none): what JAX
    gathers as D1's and D2's outputs."""
    # plain_body_D1 reads only the carry's count (entry 11) of the carry
    count = gF[:, F_COUNT].detach().to(torch.int32)
    wrow, pred = plain_body_D1(plan, g, g, (None,) * 11 + (count,), gF, gI,
                               gF, gI)
    return pred, plain_body_D2(plan, g, gI, wrow)


def plain_body_D(plan, g, lg, carry, gF, gI) -> OutD3:
    """Plain version of the D3 kernel: JAX's D1, D2 and D3 of the shard's
    lanes from the rows gathered after C alone (:func:`plain_arbitration`
    over the whole scene, then :func:`plain_body_D3` with its rows in place
    of the gathered ``gW`` and ``gV``): bit-equal to the three bodies with
    their two gathers."""
    pred, gV = plain_arbitration(plan, g, gF, gI)
    cols = lambda x: x[..., lg.gid]
    return plain_body_D3(plan, g, lg, carry, gF, gI, gV, cols(pred),
                         cols(gV), cols(gI))


def fold_ss(plan, ss_ms, gss, gssn):
    """The static running mean after this step's gathered terms (``gss [B,
    2, L]`` float64, ``gssn`` their counts), and the queue's sigmoid
    constant."""
    ss_sum = lane_sum32(gss[:, 0]) + lane_sum32(gss[:, 1])
    ss_cnt = (gssn[:, 0].sum(1).to(torch.float32) +
              gssn[:, 1].sum(1).to(torch.float32))
    ss_ms = ss_ms + torch.stack([ss_sum, ss_cnt], 1)
    mean = ss_ms[:, 0] / dmath.maximum(ss_ms[:, 1], 1.0)
    c_st = arz.rdiv(16.0, dmath.maximum(torch.abs(mean), 1e-6))
    return ss_ms, c_st


def plain_body_E(plan, lg, carry, c_st):
    """``[B, n]``: the squared soft (or hard) queue of each lane: stopped
    vehicles of a macro lane's cells or of a micro lane's vehicles."""
    u_max, veh_len, static_speed = (plan.floats[0], plan.floats[2],
                                    plan.floats[3])
    r, y, vel, count = carry[0], carry[1], carry[3], carry[11]
    B, n = count.shape
    u_cells = arz.compute_u(r, y, u_max)
    rows = torch.arange(plan.V, device=r.device)[None, :, None]
    veh_m = (rows < count[:, None]) & ~lg.is_macro
    if plan.mode != HARD:
        stat_c = soft_sigmoid(static_speed - u_cells, c_st[:, None, None])
        stat_v = soft_sigmoid(static_speed - vel, c_st[:, None, None])
    else:
        stat_c = (u_cells < static_speed).to(torch.float32)
        stat_v = (vel < static_speed).to(torch.float32)
    n_veh = arz.div(r * lg.cell_len, veh_len)
    zeros = torch.zeros((B, n), dtype=torch.float32, device=r.device)
    q_macro, q_micro = zeros, zeros
    for c in range(plan.C):
        q_macro = q_macro + torch.where(lg.cmask[c], stat_c[:, c] *
                                        n_veh[:, c], 0.0)
    for v in range(plan.V):
        q_micro = q_micro + torch.where(veh_m[:, v], stat_v[:, v], 0.0)
    q_lane = torch.where(lg.is_macro, q_macro, q_micro)
    return q_lane * q_lane


# ---------------------------------------------------------------------------
# the lane axis as this process sees it
# ---------------------------------------------------------------------------


class LaneComm:
    """This process's share of the lane axis: its shards (adjacent, in lane
    order) and the process group over which other ranks hold the rest, or
    ``None`` when this process holds every lane (the gathers then join the
    local shards' rows)."""

    def __init__(self, L: int, shards, group=None):
        self.L, self.shards, self.group = L, list(shards), group
        lanes = sum(s.n for s in self.shards)
        if group is None and lanes != L:
            raise ValueError(f"without a process group the shards must hold "
                             f"all {L} lanes, not {lanes}")

    @classmethod
    def whole(cls, L: int) -> "LaneComm":
        return cls(L, [Shard(0, L)])

    @property
    def split(self) -> bool:
        """Whether the lane axis is cut into more than one shard."""
        return self.group is not None or len(self.shards) > 1

    def gather(self, parts, kind: str = "all_gather"):
        """``parts[i]``: the rows ``[..., n_i]`` of local shard i (the same
        list of tensors for every shard). Returns each tensor of the list
        joined over the lane axis, ``[..., L]``. Forward-mode dual tensors
        are gathered with their tangents."""
        local = [p[0] if len(p) == 1 else torch.cat(p, -1)
                 for p in zip(*parts)]
        if self.group is None:
            return local
        import torch.autograd.forward_ad as fwad

        duals = [fwad.unpack_dual(x) for x in local]
        has_t = [d.tangent is not None for d in duals]
        flat = [d.primal for d in duals] + [d.tangent for d in duals
                                            if d.tangent is not None]
        out = collectives.all_gather_lanes(flat, self.group, kind)
        res, k = [], len(local)
        for i, t in enumerate(has_t):
            if t:
                res.append(fwad.make_dual(out[i], out[k]))
                k += 1
            else:
                res.append(out[i])
        return res

    def psum(self, x):
        return x if self.group is None else collectives.psum(x, self.group)

    def pmax(self, x):
        return x if self.group is None else collectives.pmax(x, self.group)


# ---------------------------------------------------------------------------
# the plain step over this process's shards
# ---------------------------------------------------------------------------


class ShardOut(NamedTuple):
    carry: tuple
    sg_ms: torch.Tensor
    ss_ms: torch.Tensor
    q2: torch.Tensor  # f32[B, n]: the lanes' squared queues
    n_inj: torch.Tensor  # [B]
    ev: torch.Tensor  # [B, 3]
    wave: torch.Tensor  # f32[B]
    floor_hits: torch.Tensor  # [B]
    # the next step's A rows gathered over the lane axis [B, 9, L] (the
    # same tensor in every local shard's), where the step was given the
    # next step's draws
    gA_next: torch.Tensor = None


def gathers_sg(plan, comm: LaneComm) -> bool:
    """Whether a step gathers the signal mean's terms after B and folds
    them in C: in the soft modes, whose blend gate the mean sharpens, and
    on a lane axis of one shard (where it costs no collective). A split
    lane axis in hard mode leaves the mean as it is, as JAX's sharded step
    does (``if diff``); the mean reaches no output there."""
    return plan.mode != HARD or not comm.split


def plain_shard_step(plan, g, comm: LaneComm, states, t: int, action2d,
                     rand_t, sched_t, mnext_t, mprev_t, routes, gA=None,
                     rand_n=None, sched_n=None):
    """One step of this process's shards (``states[i] = (carry, sg_ms,
    ss_ms)`` of shard ``comm.shards[i]``) through the plain bodies, the
    gathers of ``comm`` between them, on the kernels' schedule: ``gA``,
    this step's A rows as the step before gathered them (None: A and its
    gather here, as at step 0), then B, C, :func:`plain_body_D` and E, one
    gather (``gF``, ``gI``) and two sums (one in hard mode on a split lane
    axis). Given step t + 1's draws ``rand_n [B, L]`` and schedule
    ``sched_n [L]``, the static terms' gather also carries the next
    step's A rows (:func:`plain_body_A` on D3's carry), returned as each
    :class:`ShardOut`'s ``gA_next``. ``rand_t [B, L]`` and the scene rows
    ``[L]`` are the whole scene's. Returns one :class:`ShardOut` per
    shard."""
    lgs = [local_geometry(g, s) for s in comm.shards]
    cols = [s.cols for s in comm.shards]
    if gA is None:
        (gA,) = comm.gather([[plain_body_A(plan, lg, st[0], rand_t[:, c],
                                           sched_t[c])]
                             for lg, st, c in zip(lgs, states, cols)])
    outB = [plain_body_B(plan, g, lg, st[0], gA, action2d, t, mnext_t[c],
                         mprev_t[c], sched_t[c], routes)
            for lg, st, c in zip(lgs, states, cols)]
    sg_ms, c_sig = states[0][1], None
    if gathers_sg(plan, comm):
        (gsg,) = comm.gather([[o.sg] for o in outB], "psum")
        sg_ms, c_sig = fold_sg(plan, sg_ms, gsg)
    outC = [plain_body_C(plan, g, lg, o.carry, o.bc, c_sig, mnext_t[c],
                         routes) for lg, o, c in zip(lgs, outB, cols)]
    gF, gI = comm.gather([[o.sumF, o.sumI] for o in outC])
    outD3 = [plain_body_D(plan, g, lg, o.carry, gF, gI)
             for lg, o in zip(lgs, outC)]
    rows = [[o.ss, o.ssn] for o in outD3]
    if rand_n is not None:
        rows = [r + [plain_body_A(plan, lg, o.carry, rand_n[:, c],
                                  sched_n[c])]
                for r, lg, o, c in zip(rows, lgs, outD3, cols)]
    gss, gssn, *ahead = comm.gather(rows, "psum")
    ss_ms, c_st = fold_ss(plan, states[0][2], gss, gssn)
    gA_next = ahead[0] if ahead else None
    return [ShardOut(d3.carry, sg_ms, ss_ms,
                     plain_body_E(plan, lg, d3.carry, c_st), b.n_inj, d3.ev,
                     c.wave, c.floor_hits, gA_next)
            for lg, b, c, d3 in zip(lgs, outB, outC, outD3)]


def initial_states(plan, comm: LaneComm, N: int, device):
    """``(carry, sg_ms, ss_ms)`` of N empty episodes for each local
    shard."""
    carry, sg, ss = k6.initial_carry(plan, N, device)
    return [(tuple(x.clone() for x in slice_carry(carry, s)), sg.clone(),
             ss.clone()) for s in comm.shards]


def _run_plain(plan, comm, action2d, rand, sched, mnext, mprev, routes,
               tangents: bool):
    """The plain episode of ``rand [N, T, L]``'s rows; returns the local
    shards' ``[N, T, n]`` squared queues (their forward-mode tangents when
    ``tangents``), events ``[N, T, 3]`` and wave maxima ``[N, T]``."""
    import torch.autograd.forward_ad as fwad

    g = k6.geometry(plan, rand.device)
    states = initial_states(plan, comm, rand.shape[0], rand.device)
    q2s, evs, waves = [], [], []
    gA = None
    for t in range(plan.T):
        ahead = (rand[:, t + 1], sched[t + 1]) if t + 1 < plan.T else ()
        outs = plain_shard_step(plan, g, comm, states, t, action2d,
                                rand[:, t], sched[t], mnext[t], mprev[t],
                                routes, gA, *ahead)
        states = [(o.carry, o.sg_ms, o.ss_ms) for o in outs]
        gA = outs[0].gA_next
        if tangents:
            q2 = [fwad.unpack_dual(o.q2).tangent for o in outs]
            q2 = [torch.zeros_like(fwad.unpack_dual(o.q2).primal)
                  if q is None else q for q, o in zip(q2, outs)]
        else:
            q2 = [o.q2 for o in outs]
        q2s.append(q2)
        evs.append(sum(torch.stack([o.n_inj, o.ev[:, 0], o.ev[:, 1]], 1)
                       for o in outs))
        waves.append(torch.stack([o.wave for o in outs]).amax(0))
    q2 = [torch.stack([q[i] for q in q2s], 1)
          for i in range(len(comm.shards))]
    return q2, torch.stack(evs, 1).to(torch.int32), torch.stack(waves, 1)


def _episode_outputs(plan, comm, q2, events, waves):
    """Queues ``[B, T]`` (the lanes' squared queues gathered once and
    summed in lane order), events and wave maxima reduced once."""
    (q2g,) = comm.gather([[q] for q in q2], "psum")
    return plain_queues(plan, q2g), comm.psum(events), comm.pmax(waves)


def plain_queues(plan, q2g):
    """Plain version of the Q kernel: the queues ``[N, T]`` of the
    gathered ``q^2`` rows ``[N, T, L]``, summed in lane order in float64,
    rounded once and scaled by dt (in lane order on CPU tensors)."""
    return lane_sum32(q2g) * plan.floats[1]


def plain_sharded_episode(plan, comm, action2d, rand, sched, mnext, mprev,
                          routes):
    """``(queues[B, T], events[B, T, 3], max_wave[B, T])`` of B episodes
    from the empty state through the plain bodies, this process's shards of
    the lane axis; every rank returns the whole result."""
    with torch.no_grad():
        q2, events, waves = _run_plain(plan, comm, action2d, rand, sched,
                                       mnext, mprev, routes, False)
        return _episode_outputs(plan, comm, q2, events, waves)


def plain_gradient(plan, qd, q_weight):
    """Plain version of the Q kernel's derivative with its sum over the
    episodes: ``sum_{b,t} q_weight[b, t] * d(queue[b, t]) / d(action)``
    from the tangents ``qd [B * n_act, T, L]`` of the lanes' squared
    queues (row ``b * n_act + j`` seeds action entry j): each step's
    tangent summed over the lanes in float64 in lane order, rounded once
    and scaled by dt, then accumulated over the steps in float64, as the
    STEP derivative kernel accumulates it."""
    n_act = plan.n_phases * plan.n_inter
    tq = plain_queues(plan, qd)  # [N, T]
    w = q_weight.repeat_interleave(n_act, 0).to(torch.float64)
    g64 = _seq_sum64(w * tq.to(torch.float64), -1)
    B = q_weight.shape[0]
    return g64.view(B, -1).sum(0).to(torch.float32).view(
        plan.n_phases, plan.n_inter)


def dual_rows(plan, action2d, rand):
    """The derivative's rows: ``B * n_act`` dual episodes, row ``b * n_act
    + j`` is episode b with action entry j seeded: the action ``[N,
    n_phases, n_inter]``, its unit tangents and the draws ``[N, T, L]``."""
    n_act = plan.n_phases * plan.n_inter
    B = rand.shape[0]
    eye = torch.eye(n_act, dtype=torch.float32, device=rand.device)
    seeds = eye.repeat(B, 1).view(B * n_act, plan.n_phases, plan.n_inter)
    action = action2d.detach().expand(B * n_act, -1, -1).contiguous()
    return action, seeds, rand.repeat_interleave(n_act, 0)


def plain_sharded_episode_bwd(plan, comm, q_weight, action2d, rand, sched,
                              mnext, mprev, routes):
    """Plain version of the sharded derivative: the plain bodies in
    PyTorch's forward-mode AD over ``B * n_act`` rows (the action's
    tangent is each row's unit vector), the gathers carrying primal and
    tangent rows; returns the action gradient ``[n_phases, n_inter]``."""
    import torch.autograd.forward_ad as fwad

    if plan.mode == HARD:
        raise ValueError("the hard step has no derivative; use a soft plan")
    action, seeds, rand_n = dual_rows(plan, action2d, rand)
    with torch.no_grad(), fwad.dual_level():
        a = fwad.make_dual(action, seeds)
        qd, _, _ = _run_plain(plan, comm, a, rand_n, sched, mnext, mprev,
                              routes, True)
    (qdg,) = comm.gather([[q] for q in qd], "psum")
    return plain_gradient(plan, qdg, q_weight)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

# the pointers of ShardArgs in csrc/itscp_spatial_shard.cu, in order
PTRS = ("fbuf", "dbuf", "ibuf", "action", "rand", "sched", "mnext", "mprev",
        "routes", "prog", "lane_i", "lane_f", "sumA_v", "sumA_d", "gA_v",
        "gA_d", "bc_v", "bc_d", "sg", "events", "gsg", "sumF_v", "sumF_d",
        "sumI", "waves", "gF_v", "gF_d", "gI", "ss", "ssn", "gss", "gssn",
        "q_v", "q_d", "gq", "queues", "q_weight", "grad", "q_count")
# the pointers to this step's gathered rows and Q's weights (set before
# every launch; the others are fixed for a ShardRun)
GATHERED = ("gA_v", "gA_d", "gsg", "gF_v", "gF_d", "gI", "gss", "gssn", "gq",
            "q_weight")
# the gathered name of a local row where it is not "g" + its name
GATHERED_AS = {"sumA_v": "gA_v", "sumA_d": "gA_d", "sumF_v": "gF_v",
               "sumF_d": "gF_d", "q_v": "gq", "q_d": "gq", "sumI": "gI"}
DIMS = ("T", "L", "C", "V", "R", "P", "P2", "K", "W", "nsf", "n_phases",
        "n_inter", "mode")
CONSTS = ("u_max", "dt", "veh_len", "static_speed", "rare_den", "third",
          "amax", "apref", "tgt", "min_space", "time_pref", "rho_hi",
          "gate32")


class ShardArgs(ctypes.Structure):
    _fields_ = ([(p, ctypes.c_void_p) for p in PTRS] +
                [(i, ctypes.c_int) for i in ("N", "t", "off", "n")] +
                [(f"d_{x}", ctypes.c_int) for x in DIMS] +
                [(f"k_{x}", ctypes.c_float) for x in CONSTS])


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launcher's C signature on a loaded library (the card's
    build or the host build of the same source) and check that the
    argument struct has the size the library expects."""
    lib.launch_itscp_shard.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(ShardArgs),
                                       ctypes.c_int, ctypes.c_void_p]
    lib.launch_itscp_shard.restype = ctypes.c_int
    lib.itscp_shard_args_size.argtypes = []
    lib.itscp_shard_args_size.restype = ctypes.c_size_t
    if lib.itscp_shard_args_size() != ctypes.sizeof(ShardArgs):
        raise RuntimeError("ShardArgs does not match the library's layout")
    return lib


def _library() -> ctypes.CDLL:
    from dhts_torch.ops.cuda import _build

    lib = _build.load("itscp_spatial_shard")
    if lib.launch_itscp_shard.argtypes is None:
        bind(lib)
    return lib


class ShardRun:
    """One episode of the local shards through the kernels: the packed
    carry of each shard (``k6``'s layout at the shard's lanes), its
    per-step rows and the gathers between the launches. ``dual``: the
    derivative's ``B * n_act`` rows with their tangent buffers.

    ``lib`` is the kernels' library: the card's build for CUDA tensors
    (default), or the host build of the same source for CPU tensors (the
    tests). Each launch counts in :data:`launches`. The step is
    :data:`STEP`, one entry per body: step 0 launches A, B, C, D3 and E,
    a later step :data:`EVERY_STEP` on the A rows that D3 of the step
    before wrote and gathered, which the run holds between the steps
    (:meth:`begin`)."""

    def __init__(self, plan, comm: LaneComm, inputs, dual: bool, lib=None):
        action2d, rand, sched, mnext, mprev, routes = inputs
        self.plan, self.comm, self.dual = plan, comm, dual
        self.inputs = inputs
        self.dev = dev = rand.device
        self.lib = _library() if lib is None else lib
        self.stream = _launch.stream(dev) if dev.type == "cuda" else 0
        self.geom = g = k6.geometry(plan, dev)
        self.sg_gathered = gathers_sg(plan, comm)
        n_act = plan.n_phases * plan.n_inter
        self.B = B = rand.shape[0]
        self.N = N = B * n_act if dual else B
        T = plan.T
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        carry, sg, ss = k6.initial_carry(plan, N, dev)
        # Q's outputs: the episode's queues (their tangents in a derivative)
        # and the gradient's terms of each row, with the derivative's count
        # of each row's finished tiles (the kernel leaves it at 0)
        self.queues = torch.zeros((N, T), **f32)
        self.grad = (torch.zeros(N, dtype=torch.float64, device=dev) if dual
                     else None)
        self.q_count = torch.zeros(N, **i32) if dual else None
        self.shards = []
        for s in comm.shards:
            p_n = plan._replace(L=s.n)
            fbuf, ibuf = k6.pack(p_n, slice_carry(carry, s), sg, ss)
            bufs = dict(
                fbuf=fbuf, dbuf=torch.zeros_like(fbuf) if dual else None,
                ibuf=ibuf,
                sumA_v=torch.zeros((N, 9, s.n), **f32),
                bc_v=torch.zeros((N, 10, s.n), **f32),
                sg=torch.zeros((N, 2, s.n), **f32),
                sumF_v=torch.zeros((N, N_F, s.n), **f32),
                sumI=torch.zeros((N, N_I, s.n), **i32),
                ss=torch.zeros((N, 2, s.n), dtype=torch.float64, device=dev),
                ssn=torch.zeros((N, 2, s.n), **i32),
                q_v=torch.zeros((N, T, s.n), **f32),
                events=None if dual else torch.zeros((N, T, 3), **i32),
                waves=None if dual else torch.zeros((N, T), **f32))
            for name in ("sumA", "bc", "sumF", "q"):
                bufs[f"{name}_d"] = (torch.zeros_like(bufs[f"{name}_v"])
                                     if dual else None)
            args = ShardArgs(N=N, off=s.off, n=s.n)
            for name, v in zip(DIMS, (T, plan.L, plan.C, plan.V, plan.R,
                                      plan.P, plan.P2, plan.K, plan.W,
                                      plan.nsf, plan.n_phases, plan.n_inter,
                                      plan.mode)):
                setattr(args, f"d_{name}", v)
            for name, v in zip(CONSTS, plan.floats):
                setattr(args, f"k_{name}", v)
            fixed = dict(bufs, action=action2d, rand=rand, sched=sched,
                         mnext=mnext, mprev=mprev, routes=routes,
                         prog=plan.prog, lane_i=plan.lane_i,
                         lane_f=plan.lane_f, queues=self.queues,
                         grad=self.grad, q_count=self.q_count)
            for name in PTRS:
                x = fixed.get(name)
                if name not in GATHERED and x is not None:
                    setattr(args, name, x.data_ptr())
            self.shards.append((s, p_n, bufs, args))
        self.g = {}  # this step's gathered rows (and Q's weights)
        # the next step's A rows, gathered with D3's static terms, and the
        # step they are for
        self.g_next, self.t_next = {}, None

    def launch(self, body: str, t: int, which=None, repeat: int = 1):
        """Launch ``body``'s kernel (one of :data:`KERNELS`) for step t on
        the local shards ``which`` (default all), reading this step's
        gathered rows; ``repeat`` times back to back (a timing's
        launches)."""
        for i in range(len(self.shards)) if which is None else which:
            _, _, bufs, args = self.shards[i]
            args.t = t
            for name in GATHERED:
                x = self.g.get(name)
                setattr(args, name, None if x is None else x.data_ptr())
            err = self.lib.launch_itscp_shard(KERNELS.index(body),
                                              int(self.dual),
                                              ctypes.byref(args), repeat,
                                              ctypes.c_void_p(self.stream))
            _launch.raise_on(err, f"itscp_spatial_shard {body}")
            launches[f"{body}_bwd" if self.dual else body] += repeat

    def gather(self, names, kind="all_gather", ahead=()):
        """Gather the local rows ``names`` (with their tangent rows in the
        derivative) in one collective into this step's gathered rows:
        ``sumA_v`` -> ``gA_v``, ``sg`` -> ``gsg``, ``q_v`` -> ``gq``; those
        of ``ahead`` (A's rows that D3 wrote) into the next step's,
        :attr:`g_next`."""
        full, into = [], []
        for name in names:
            dest = self.g_next if name in ahead else self.g
            tan = name[:-2] + "_d" if name.endswith("_v") else None
            for x in (name, tan) if self.dual and tan else (name,):
                full.append(x)
                into.append(dest)
        parts = [[bufs[x] for x in full] for _, _, bufs, _ in self.shards]
        out = self.comm.gather(parts, kind)
        for x, y, dest in zip(full, out, into):
            dest[GATHERED_AS.get(x, "g" + x)] = y.contiguous()

    def begin(self, t: int) -> tuple:
        """Start step t: its gathered rows are the A rows that D3 of step t
        - 1 wrote and gathered, where the run holds them. Returns the
        bodies step t launches: :data:`EVERY_STEP`, after A where the run
        holds no A rows of step t (step 0, or a step not after the last
        one run)."""
        held = self.t_next == t
        self.g = self.g_next if held else {}
        self.drop_ahead()
        return EVERY_STEP if held else BODIES

    def drop_ahead(self):
        """Forget the A rows held for the next step: after an edit of the
        carry between two steps, the next step launches A on the carry as
        it stands."""
        self.g_next, self.t_next = {}, None

    def after(self, body: str, t: int):
        """The gather after ``body``'s launch of step t: :data:`STEP`'s
        (B's signal terms only where :func:`gathers_sg`) and, after D3
        before the last step, the next step's A rows in the same
        collective."""
        spec = STEP[body]
        names = () if body == "B" and not self.sg_gathered else spec.gather
        ahead = spec.ahead if t + 1 < self.plan.T else ()
        if names or ahead:
            self.gather(names + ahead, spec.kind, ahead)
        if ahead:
            self.t_next = t + 1

    def step(self, t: int):
        """Step t: its launches on every local shard and the gathers
        between them (:meth:`begin`, :meth:`after`)."""
        for body in self.begin(t):
            self.launch(body, t)
            self.after(body, t)

    def run(self):
        for t in range(self.plan.T):
            self.step(t)
        return self

    def carry(self, i: int):
        """``(carry, sg_ms, ss_ms)`` of local shard i (views)."""
        _, p_n, bufs, _ = self.shards[i]
        return k6.unpack(p_n, bufs["fbuf"], bufs["ibuf"])

    def view(self, i: int, t: int, state=None) -> "ShardView":
        """Shard i's inputs of step t as they stand in the buffers, from
        ``state`` (``(carry, sg_ms, ss_ms)``; default: the shard's state
        now). In a derivative run the float rows, the carry and the action
        are forward-mode duals: use it inside
        ``torch.autograd.forward_ad.dual_level()``, with the default
        state."""
        import torch.autograd.forward_ad as fwad

        plan = self.plan
        s, p_n, b, _ = self.shards[i]
        a2, rand, sched, mnext, mprev, routes = self.inputs
        c = s.cols
        carry, sg, ss = self.carry(i) if state is None else state
        if self.dual:
            if state is not None:
                raise ValueError("a derivative's view starts from now")
            tans = k6.unpack(p_n, b["dbuf"], b["ibuf"])[0]
            carry = tuple(fwad.make_dual(x, d) if j in k6.CARRY_DIFF else x
                          for j, (x, d) in enumerate(zip(carry, tans)))
            action, seeds, rand = dual_rows(plan, a2, rand)
            a2 = fwad.make_dual(action, seeds)
        nxt = t + 1 < plan.T
        return ShardView(self, b, self.g, plan, self.geom,
                         local_geometry(self.geom, s), t, i, carry, sg, ss,
                         a2, rand[:, t, c], sched[t, c], mnext[t, c],
                         mprev[t, c], routes,
                         rand[:, t + 1, c] if nxt else None,
                         sched[t + 1, c] if nxt else None)

    def plain(self, body: str, i: int, t: int, state=None) -> dict:
        """``body``'s plain version on shard i's inputs of step t (see
        :meth:`view`): ``{output: tensor}``."""
        return STEP[body].plain(self.view(i, t, state))

    def checked_step(self, t: int, rtol: float = 0.0, atol: float = 0.0,
                     edit=None):
        """Step t of a forward with every launch held against its plain
        version on the same inputs, output by output as
        :data:`STEP` names them: integers equal, floats allclose(rtol,
        atol). ``edit(run, body)``, where given, is called after each
        body's launch and the gathers after it (a test's hook: it may
        change the gathered rows and the state the next launch reads).
        Returns ``{body: max_abs_err}`` and raises ``AssertionError``
        naming the first output that differs."""
        if self.dual:
            raise ValueError("the check runs the forward")
        errs = {}

        def same(body, name, ref, got):
            ref = ref.to(got.dtype)
            if got.is_floating_point():
                err = float((ref - got).abs().max()) if got.numel() else 0.0
                errs[body] = max(errs.get(body, 0.0), err)
                ok = torch.allclose(ref, got, rtol=rtol, atol=atol)
            else:
                ok = torch.equal(ref, got)
            if not ok:
                raise AssertionError(f"step {t}, body {body}: {name} differs"
                                     f" from its plain body")

        def snap(i):
            carry, sg, ss = self.carry(i)
            return tuple(x.clone() for x in carry), sg.clone(), ss.clone()

        for body in self.begin(t):
            before = [snap(i) for i in range(len(self.shards))]
            self.launch(body, t)
            for i in range(len(self.shards)):
                ref = self.plain(body, i, t, before[i])
                got = STEP[body].written(self.view(i, t))
                for name, r in ref.items():
                    if name == "carry":
                        for cn, a, b in zip(k6.CNAMES, r, got[name]):
                            same(body, cn, a, b)
                    else:
                        same(body, name, r, got[name])
            self.after(body, t)
            if edit is not None:
                edit(self, body)
        return errs

    def checked_dual_step(self, t: int, bodies=("C", "E"), rtol=1e-5,
                          atol=1e-5, value_tol=(0.0, 0.0), edit=None):
        """Step t of a derivative with each launch of ``bodies`` (any of B,
        C, D3, E) held against its plain body under forward-mode AD on the
        same dual inputs (the outputs a derivative writes: no events, no
        wave): integers equal, values allclose(*value_tol) (equal by
        default), tangents allclose(rtol, atol * the output's largest
        reference tangent). ``edit``: as for :meth:`checked_step`. Returns
        ``{body: max_abs_tangent_err}`` and raises ``AssertionError`` naming
        the first output that differs."""
        import torch.autograd.forward_ad as fwad

        if not self.dual or not set(bodies) <= {"B", "C", "D3", "E"}:
            raise ValueError("the dual check runs B, C, D3 and E of a "
                             "derivative")
        errs = {}

        def parts(x):
            p, d = fwad.unpack_dual(x)
            return p.clone(), None if d is None else d.clone()

        def same(body, name, ref, got):
            (rv, rd), (gv, gd) = ref, got
            rv = rv.to(gv.dtype)
            ok = (torch.allclose(rv, gv, *value_tol)
                  if gv.is_floating_point() and any(value_tol)
                  else torch.equal(rv, gv))
            if not ok:
                raise AssertionError(f"step {t}, body {body}: {name} values "
                                     f"differ from its plain body")
            if gd is None:
                return
            rd = torch.zeros_like(gv) if rd is None else rd
            err = float((rd - gd).abs().max()) if gd.numel() else 0.0
            errs[body] = max(errs.get(body, 0.0), err)
            scale = float(rd.abs().max()) if rd.numel() else 0.0
            if not torch.allclose(rd, gd, rtol=rtol, atol=atol * scale):
                raise AssertionError(f"step {t}, body {body}: {name} "
                                     f"tangents differ from its plain body")

        for body in self.begin(t):
            if body in bodies:
                with torch.no_grad(), fwad.dual_level():
                    refs = [{k: tuple(parts(x) for x in v) if k == "carry"
                             else parts(v)
                             for k, v in self.plain(body, i, t).items()
                             if k not in ("wave", "n_inj", "events")}
                            for i in range(len(self.shards))]
                self.launch(body, t)
                for i, ref in enumerate(refs):
                    got = self._dual_written(body, i, t)
                    for name, r in ref.items():
                        if name == "carry":
                            for cn, a, b in zip(k6.CNAMES, r, got[name]):
                                same(body, cn, a, b)
                        else:
                            same(body, name, r, got[name])
            else:
                self.launch(body, t)
            self.after(body, t)
            if edit is not None:
                edit(self, body)
        return errs

    def _dual_written(self, body: str, i: int, t: int) -> dict:
        """What B, C, D3 or E of step t wrote on shard i of a derivative:
        ``{output: (values, tangents or None)}``."""
        _, p_n, b, _ = self.shards[i]
        carry, sg_ms, ss_ms = k6.unpack(p_n, b["fbuf"], b["ibuf"])
        tans = k6.unpack(p_n, b["dbuf"], b["ibuf"])[0]
        carry = tuple((x, tans[j] if j in k6.CARRY_DIFF else None)
                      for j, x in enumerate(carry))
        if body == "B":
            return dict(carry=carry, bc=(b["bc_v"], b["bc_d"]),
                        sg=(b["sg"], None))
        if body == "C":
            return dict(carry=carry, sg_ms=(sg_ms, None),
                        sumF=(b["sumF_v"], b["sumF_d"]),
                        sumI=(b["sumI"], None))
        if body == "D3":
            ahead = ({"sumA": (b["sumA_v"], b["sumA_d"])}
                     if t + 1 < self.plan.T else {})
            return dict(carry=carry, ss=(b["ss"], None),
                        ssn=(b["ssn"], None), **ahead)
        return dict(carry=carry, ss_ms=(ss_ms, None),
                    q2=(b["q_v"][:, t], b["q_d"][:, t]))

    def outputs(self):
        """The episode's queues ``[B, T]``, events and wave maxima (every
        rank the whole result) after :meth:`run` of a forward: the lanes'
        ``q^2`` rows gathered once and summed by the Q kernel."""
        bufs = [b for _, _, b, _ in self.shards]
        self.g = {}
        self.gather(["q_v"], "psum")
        self.launch("Q", 0, [0])
        return (self.queues, self.comm.psum(sum(b["events"] for b in bufs)),
                self.comm.pmax(torch.stack([b["waves"] for b in bufs]).amax(
                    0)))

    def gradient(self, q_weight):
        """The action gradient ``[n_phases, n_inter]`` after :meth:`run` of
        a derivative: the lanes' ``q^2`` tangent rows gathered once, the Q
        kernel's float64 terms of each row summed over the episodes."""
        self.g = {}
        self.gather(["q_d"], "psum")
        self.g["q_weight"] = q_weight.contiguous()
        self.launch("Q", 0, [0])
        return self.grad.view(self.B, -1).sum(0).to(torch.float32).view(
            self.plan.n_phases, self.plan.n_inter)


class ShardView(NamedTuple):
    """Shard ``i`` of a :class:`ShardRun` at step ``t``: its buffers ``b``,
    this step's gathered rows ``G``, the state a launch starts from, and
    the scene's columns at step t."""

    run: ShardRun
    b: dict
    G: dict
    plan: object
    g: k6.Geometry
    lg: k6.Geometry
    t: int
    i: int
    carry: tuple
    sg_ms: torch.Tensor
    ss_ms: torch.Tensor
    action: torch.Tensor
    rand_t: torch.Tensor
    sched_t: torch.Tensor
    mnext_t: torch.Tensor
    mprev_t: torch.Tensor
    routes: torch.Tensor
    # step t + 1's draws and schedule (None at the last step)
    rand_n: torch.Tensor
    sched_n: torch.Tensor

    def dual(self, rows: dict, name: str):
        """``rows[name]``, with its tangents ``rows[name[:-2] + "_d"]`` as a
        forward-mode dual in a derivative run."""
        import torch.autograd.forward_ad as fwad

        d = rows.get(name[:-2] + "_d") if self.run.dual else None
        return rows[name] if d is None else fwad.make_dual(rows[name], d)

    def now(self):
        """The shard's ``(carry, sg_ms, ss_ms)`` as the kernels left it."""
        return self.run.carry(self.i)


class BodySpec(NamedTuple):
    """One body of the step: its plain version on a :class:`ShardView`
    (``{output: tensor}``), where its kernel wrote the same outputs, the
    local rows gathered after it over the lane axis, by kind, and those it
    wrote for the next step, gathered in the same call before the last
    step."""

    plain: object
    written: object
    gather: tuple
    kind: str = "all_gather"
    ahead: tuple = ()


def _plain_C(v: ShardView):
    sg_ms, c_sig = v.sg_ms, None
    if "gsg" in v.G:
        sg_ms, c_sig = fold_sg(v.plan, v.sg_ms, v.G["gsg"])
    o = plain_body_C(v.plan, v.g, v.lg, v.carry, v.dual(v.b, "bc_v"), c_sig,
                     v.mnext_t, v.routes)
    return dict(carry=o.carry, sg_ms=sg_ms, sumF=o.sumF, sumI=o.sumI,
                wave=o.wave)


def _plain_D3(v: ShardView):
    o = plain_body_D(v.plan, v.g, v.lg, v.carry, v.dual(v.G, "gF_v"),
                     v.G["gI"])
    out = dict(carry=o.carry, ss=o.ss, ssn=o.ssn, events=o.ev[:, :2])
    if v.rand_n is not None:  # the next step's A rows, from D3's carry
        out["sumA"] = plain_body_A(v.plan, v.lg, o.carry, v.rand_n,
                                   v.sched_n)
    return out


def _written_D3(v: ShardView):
    out = dict(carry=v.now()[0], ss=v.b["ss"], ssn=v.b["ssn"],
               events=v.b["events"][:, v.t, 1:])
    if v.rand_n is not None:
        out["sumA"] = v.b["sumA_v"]
    return out


def _plain_E(v: ShardView):
    ss_ms, c_st = fold_ss(v.plan, v.ss_ms, v.G["gss"], v.G["gssn"])
    return dict(carry=v.carry, ss_ms=ss_ms,
                q2=plain_body_E(v.plan, v.lg, v.carry, c_st))


# the step, body by body in launch order (A at step 0 only: D3 writes
# the later steps' A rows); ``written`` reads a forward run
STEP = {
    "A": BodySpec(
        lambda v: dict(sumA=plain_body_A(v.plan, v.lg, v.carry, v.rand_t,
                                         v.sched_t)),
        lambda v: dict(sumA=v.b["sumA_v"]), ("sumA_v",)),
    "B": BodySpec(
        lambda v: dict(zip(("carry", "bc", "sg", "n_inj"), plain_body_B(
            v.plan, v.g, v.lg, v.carry, v.dual(v.G, "gA_v"), v.action, v.t,
            v.mnext_t, v.mprev_t, v.sched_t, v.routes))),
        lambda v: dict(carry=v.now()[0], bc=v.b["bc_v"], sg=v.b["sg"],
                       n_inj=v.b["events"][:, v.t, 0]), ("sg",), "psum"),
    "C": BodySpec(
        _plain_C,
        lambda v: dict(carry=v.now()[0], sg_ms=v.now()[1],
                       sumF=v.b["sumF_v"], sumI=v.b["sumI"],
                       wave=v.b["waves"][:, v.t]), ("sumF_v", "sumI")),
    "D3": BodySpec(_plain_D3, _written_D3, ("ss", "ssn"), "psum",
                   ("sumA_v",)),
    "E": BodySpec(
        _plain_E,
        lambda v: dict(carry=v.now()[0], ss_ms=v.now()[2],
                       q2=v.b["q_v"][:, v.t]), ()),
}


def _check(plan, comm, inputs, dual):
    action2d, rand, sched, mnext, mprev, routes = inputs
    dev = rand.device
    T, L = plan.T, plan.L
    wide = [sh.n for sh in comm.shards if sh.n > MAX_LANES]
    if wide:
        raise ValueError(f"a body runs one thread per local lane and C's "
                         f"and E's a reduction warp beside them: a shard of "
                         f"{wide[0]} lanes exceeds the cap of {MAX_LANES}; "
                         f"take more shards")
    if comm.L != L:
        raise ValueError(f"the lane axis has {comm.L} lanes, the plan {L}")
    n_routes = L * plan.P + L * plan.P2
    for x, (name, shape, dtype) in zip(inputs, (
            ("action2d", (plan.n_phases, plan.n_inter), torch.float32),
            ("rand", (rand.shape[0], T, L), torch.float32),
            ("schedule", (T, L), torch.float32),
            ("mnext", (T, L), torch.int32), ("mprev", (T, L), torch.int32),
            ("routes", (n_routes, plan.R), torch.int32))):
        _launch.check(name, x, shape, dtype, dev)
    if dual and plan.mode == HARD:
        raise ValueError("the hard step has no derivative; use a soft plan")
    return dev


def shard_episode_fwd(plan, comm, action2d, rand, sched, mnext, mprev,
                      routes):
    """``(queues[B, T], events[B, T, 3], max_wave[B, T])`` of B episodes
    from the empty state over this process's shards (every rank the whole
    result). CPU tensors run :func:`plain_sharded_episode`; CUDA tensors
    launch the forward kernels (A once, B, C, D3 and E once per step),
    counted in :data:`launches`, or raise."""
    inputs = (action2d, rand, sched, mnext, mprev, routes)
    dev = _check(plan, comm, inputs, False)
    if _launch.device_of(rand).type == "cpu":
        return plain_sharded_episode(plan, comm, *inputs)
    with torch.cuda.device(dev):
        return ShardRun(plan, comm, inputs, dual=False).run().outputs()


def shard_episode_bwd(plan, comm, q_weight, action2d, rand, sched, mnext,
                      mprev, routes):
    """``grad[n_phases, n_inter] = sum_{b,t} q_weight[b, t] *
    d(queues[b, t]) / d(action2d)`` of the soft episodes, on every rank.
    CPU tensors run :func:`plain_sharded_episode_bwd`; CUDA tensors launch
    the ``Dual`` kernels (one block per episode and action entry) of A
    once and of B, C, D3 and E once per step."""
    inputs = (action2d, rand, sched, mnext, mprev, routes)
    dev = _check(plan, comm, inputs, True)
    _launch.check("q_weight", q_weight, (rand.shape[0], plan.T),
                  torch.float32, dev)
    if _launch.device_of(rand).type == "cpu":
        return plain_sharded_episode_bwd(plan, comm, q_weight, *inputs)
    with torch.cuda.device(dev):
        return ShardRun(plan, comm, inputs, dual=True).run().gradient(
            q_weight)


def make_shard_episode_op(plan, comm: LaneComm):
    """K5's op around the sharded episode: ``op(action2d, rand, sched,
    mnext, mprev, routes) -> (queues, events, max_wave)``, differentiable in
    ``action2d`` on every device: the collectives between the bodies are
    outside autograd's reach, so the op's derivative is
    :func:`shard_episode_bwd` on the CPU too (``body_autograd=False``)."""
    fwd = lambda *args: shard_episode_fwd(plan, comm, *args)

    def derivative(args, cots):
        (g_queues,) = cots
        return (shard_episode_bwd(plan, comm, g_queues.contiguous(), *args),)

    return make_dkernel(
        lambda *args: plain_sharded_episode(plan, comm, *args), fwd,
        derivative, (0,), name="spatialShard", nondiff_outputs=(2,),
        body_autograd=False)
