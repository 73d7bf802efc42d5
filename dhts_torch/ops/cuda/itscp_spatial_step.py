"""Fused spatial step of the ITSCP hybrid episode on one lane shard: kernel
K6's STEP body and K5's forward and derivative around it.

Port of the single-shard part of :mod:`dhts.ops.pallas.itscp_spatial_step`
(``make_fused_spatial_episode`` with ``n_shard == 1``, where every
collective of the sharded step is an identity and ``body_STEP`` carries a
whole simulation step in one kernel, wrapped by ``make_dkernel``), with
:func:`make_fused_spatial_train_step` and
:func:`make_fused_spatial_train_step_2d`. On a lane axis of more than one
shard these factories run the per-shard bodies of
:mod:`dhts_torch.ops.cuda.itscp_spatial_shard` instead.

The carry is the JAX step's 17 arrays in its lane-minor layout with the
true sizes (no padding) and a batch axis ``B`` in front: ``r, y [B, C,
L]``; ``pos, vel, av`` and the six vehicle parameters ``[B, V, L]``;
``count [B, L]``; ``rid, ridx [B, V, L]``; ``cap [B, K, L]``; ``inj_left,
cursor [B, L]``; plus the running-mean sums ``sg_ms, ss_ms [B, 2]``
(``(sum, count)``, read through ``mean_of``). One layout difference: a
vehicle holds a route id ``rid`` (a row of the read-only route table
``routes = [inj_routes of every lane; emission pool of every lane]``,
``[L * P + L * P2, R]``, or -1) instead of a copy of its route, since every
route of an episode is such a row and vehicles only ever copy routes.

* :func:`plain_spatial_step` is the plain PyTorch version of one step,
  vectorised over episodes and lanes, and the kernels' specification op for
  op: the composition of the plain per-shard bodies on one shard holding
  every lane, so the port has one copy of the step's math;
  :func:`plain_spatial_episode` loops it over T, and autograd through it is
  the derivative's specification.
* :func:`spatial_step_fwd` is the wrapper of the forward kernel
  (``csrc/itscp_spatial_step.cu``, one launch per call, which runs the
  call's steps one after another, one block per episode) and
  :func:`spatial_step_bwd` that of the derivative kernel (forward-mode dual
  numbers, one block per (episode, action entry)); :func:`spatial_episode_fwd`
  and :func:`spatial_episode_bwd` run them over a whole episode from the
  empty state. On CUDA tensors they launch the kernels, count the steps in
  ``launches`` (one per step of one launch, a step as the JAX episode's
  scan launches it) and the kernel launches in ``kernel_launches``; on CPU
  tensors they run the plain versions (the derivative's is
  :func:`plain_spatial_step_bwd`, the plain step in forward-mode AD).
* :func:`make_spatial_episode_op` is K5's op around the episode
  (:func:`dhts_torch.ops.cuda.dkernel.make_dkernel`): its derivative is the
  action gradient of a whole episode in forward mode, the design of K1's
  backward, since the episode starts from the fixed empty state and the
  per-step vector-Jacobian products of the JAX step chain only to the
  action.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from dhts_torch.ops.cuda import _launch
from dhts_torch.ops.cuda import itscp_hybrid_episode as k1
from dhts_torch.ops.cuda.dkernel import make_dkernel
from dhts_torch.ops.dmath import soft_sigmoid

SOURCE = "dhts_torch/ops/cuda/csrc/itscp_spatial_step.cu"
REPLACES_FWD = "dhts/ops/pallas/dkernel.py:63"
REPLACES_BWD = "dhts/ops/pallas/dkernel.py:91"
REPLACES_STEP = "dhts/ops/pallas/itscp_spatial_step.py:826"
HARD, SOFT = k1.HARD, k1.SOFT

CNAMES = ("r", "y", "pos", "vel", "av", "p_amax", "p_apref", "p_vt", "p_ms",
          "p_tp", "p_len", "count", "rid", "ridx", "cap", "inj_left",
          "cursor")
N_CARRY = len(CNAMES)
CARRY_DIFF = (0, 1, 2, 3, 4, 14)  # r y pos vel av cap
PARAMS = ("p_amax", "p_apref", "p_vt", "p_ms", "p_tp", "p_len")
MAX_LANES = 1024  # one thread per lane

# steps run by the forward (one step of B episodes) and derivative (one
# step of B x n_act dual episodes) kernels, and their kernel launches (one
# per call, whatever its steps)
launches = {"fwd": 0, "bwd": 0}
kernel_launches = {"fwd": 0, "bwd": 0}


def make_plan(env, differentiable: bool) -> k1.EpisodePlan:
    """The kernels' static inputs for ``env``'s scene: K1's plan (geometry
    tables, sizes, constants) in hard or soft mode. The spatial step reads
    only ``soft_gate_scale``: there is no straight-through mode."""
    V = env.base_state.micro.position.shape[1]
    R = env.base_state.micro.route.shape[2]
    P = env.data.inj_routes.shape[1]
    P2 = env.base_state.route_pool.shape[1]
    cfg = dict(env.config, gate_mode="soft")
    return k1.make_plan(env.spec, env.meta, cfg, V, R, P, P2,
                        window=env._fused_win_needed,
                        differentiable=differentiable)


def route_table(inj_routes, emit_routes):
    """``[L * P + L * P2, R]``: route id ``l * P + p`` is ``inj_routes[l,
    p]``, ``L * P + l * P2 + q`` is ``emit_routes[l, q]``."""
    R = inj_routes.shape[2]
    return torch.cat([inj_routes.reshape(-1, R),
                      emit_routes.reshape(-1, R)]).contiguous()


# ---------------------------------------------------------------------------
# packed state: the carry as one float and one int buffer per episode (the
# kernels' layout; the offsets are repeated in the CUDA source)
# ---------------------------------------------------------------------------


def float_layout(plan) -> dict:
    """Offsets of the float fields in a row of the float buffer, and its
    size ``"size"``: r, y ``[C, L]``; pos ... p_len ``[V, L]``; cap ``[K,
    L]``; sg_ms, ss_ms ``[2]``."""
    CL, VL, KL = plan.C * plan.L, plan.V * plan.L, plan.K * plan.L
    off = {"r": 0, "y": CL}
    o = 2 * CL
    for name in ("pos", "vel", "av") + PARAMS:
        off[name] = o
        o += VL
    off["cap"] = o
    off["sg_ms"] = o + KL
    off["ss_ms"] = o + KL + 2
    off["size"] = o + KL + 4
    return off


def int_layout(plan) -> dict:
    """Offsets of the int fields: count ``[L]``; rid, ridx ``[V, L]``;
    inj_left, cursor ``[L]``."""
    L, VL = plan.L, plan.V * plan.L
    return {"count": 0, "rid": L, "ridx": L + VL, "inj_left": L + 2 * VL,
            "cursor": 2 * L + 2 * VL, "size": 3 * L + 2 * VL}


def _shape(plan, name):
    if name in ("r", "y"):
        return (plan.C, plan.L)
    if name == "cap":
        return (plan.K, plan.L)
    if name in ("count", "inj_left", "cursor"):
        return (plan.L,)
    if name in ("sg_ms", "ss_ms"):
        return (2,)
    return (plan.V, plan.L)


def unpack(plan, fbuf, ibuf):
    """``(carry, sg_ms, ss_ms)`` as views of the packed buffers."""
    fo, io = float_layout(plan), int_layout(plan)
    N = fbuf.shape[0]

    def view(buf, o, name):
        shape = _shape(plan, name)
        n = int(np.prod(shape))
        return buf[:, o[name]:o[name] + n].reshape(N, *shape)

    carry = tuple(view(ibuf, io, n) if n in io else view(fbuf, fo, n)
                  for n in CNAMES)
    return carry, view(fbuf, fo, "sg_ms"), view(fbuf, fo, "ss_ms")


def pack(plan, carry, sg_ms, ss_ms):
    """The packed ``(fbuf, ibuf)`` of a carry (a copy)."""
    io = int_layout(plan)
    B = carry[0].shape[0]
    fl = [x.reshape(B, -1) for n, x in zip(CNAMES, carry) if n not in io]
    il = [carry[CNAMES.index(n)].reshape(B, -1) for n in
          ("count", "rid", "ridx", "inj_left", "cursor")]
    # float_layout's order: r y pos vel av params cap, then the two sums
    fbuf = torch.cat([*fl, sg_ms, ss_ms], 1)
    return fbuf.contiguous(), torch.cat(il, 1).contiguous()


def empty_state(plan, B: int, device):
    """Packed buffers of B episodes at the empty network state (the JAX
    step's ``carry0``): no vehicles, default parameters in every slot,
    routes -1, waiting pools full on the open micro lanes."""
    fo, io = float_layout(plan), int_layout(plan)
    L, VL = plan.L, plan.V * plan.L
    fbuf = torch.zeros((B, fo["size"]), dtype=torch.float32, device=device)
    ibuf = torch.zeros((B, io["size"]), dtype=torch.int32, device=device)
    dflt = plan.floats[6:11] + (plan.floats[2],)  # amax .. time_pref, len
    for name, v in zip(PARAMS, dflt):
        fbuf[:, fo[name]:fo[name] + VL] = v
    ibuf[:, io["rid"]:io["rid"] + VL] = -1
    lane_i = plan.lane_i.to(device)
    open_micro = (lane_i[5] == 0) & (lane_i[0] == 0)
    ibuf[:, io["inj_left"]:io["inj_left"] + L] = torch.where(
        open_micro, plan.P, 0).to(torch.int32)
    return fbuf, ibuf


# ---------------------------------------------------------------------------
# plain version of one step (body_STEP: A + B + C + conversion + E)
# ---------------------------------------------------------------------------


class Geometry(NamedTuple):
    is_macro: torch.Tensor  # bool[L]
    num_cell: torch.Tensor
    approaching: torch.Tensor
    is_we: torch.Tensor
    inter: torch.Tensor
    has_prev: torch.Tensor
    num_prev: torch.Tensor
    num_next: torch.Tensor
    prev_k: torch.Tensor  # i32[K, L]
    next_k: torch.Tensor
    length: torch.Tensor  # f32[L]
    cell_len: torch.Tensor
    cmask: torch.Tensor  # bool[C, L]: real cells of macro lanes
    last: torch.Tensor  # i64[L]: last cell (0 for micro lanes)
    gid: torch.Tensor  # i64[L]


def geometry(plan, device) -> Geometry:
    li = plan.lane_i.to(device)
    lf = plan.lane_f.to(device)
    K, C, L = plan.K, plan.C, plan.L
    is_macro = li[0] != 0
    num_cell = li[1]
    cmask = (torch.arange(C, device=device)[:, None] < num_cell[None]) & \
        is_macro[None]
    return Geometry(
        is_macro=is_macro, num_cell=num_cell, approaching=li[2] != 0,
        is_we=li[3] != 0, inter=li[4].long(), has_prev=li[5] != 0,
        num_prev=li[6], num_next=li[7], prev_k=li[8:8 + K],
        next_k=li[8 + K:8 + 2 * K], length=lf[0], cell_len=lf[1],
        cmask=cmask, last=torch.clamp(num_cell - 1, 0, C - 1).long(),
        gid=torch.arange(L, device=device))


def _take(x, idx):
    """``x[b, idx]`` for ``x`` of ``[B, L]`` and ``idx`` of ``[L]`` or ``[B,
    L]`` (clamped by the caller)."""
    idx = idx.long()
    if idx.dim() == 1:
        idx = idx.expand(x.shape[0], -1)
    return torch.gather(x, 1, idx)


def _pick(x, h):
    """Row ``h[b, l]`` of ``x[B, V, L]``."""
    return torch.gather(x, 1, h.long()[:, None]).squeeze(1)


def _insert(x, new, mask):
    """Shift the vehicle rows of ``x[B, V, L]`` up by one where ``mask[B,
    L]`` and put ``new[B, L]`` in row 0 (the tail; the top row drops)."""
    shifted = torch.cat([new[:, None], x[:, :-1]], 1)
    return torch.where(mask[:, None], shifted, x)


def _route_at(routes, rid, j, R):
    """Entry ``j`` of route ``rid`` (``-1`` for no route or out of range)."""
    ok = (rid >= 0) & (j >= 0) & (j < R)
    flat = torch.clamp(rid, min=0).long() * R + torch.clamp(j, 0, R - 1)
    return torch.where(ok, routes.reshape(-1)[flat], -1)


class StepOut(NamedTuple):
    carry: tuple
    sg_ms: torch.Tensor  # f32[B, 2]
    ss_ms: torch.Tensor
    queue: torch.Tensor  # f32[B]
    events: torch.Tensor  # i32[B, 3] injected, emitted, absorbed
    max_wave: torch.Tensor  # f32[B]
    floor_hits: torch.Tensor  # i64[B] vehicles stopped by the IDM floor


def lane_signals(plan, action2d, t: int, soft: bool, g: Geometry):
    """Per-lane signal of step ``t`` (``lane_sig_global``): approaching arms
    gate the action against the phase progress, other lanes are open.
    ``[L]`` for an action ``[n_phases, n_inter]``, ``[N, L]`` for one action
    per row ``[N, n_phases, n_inter]``."""
    phase = min(t // plan.nsf, plan.n_phases - 1)
    a = action2d[..., phase, :][..., g.inter]
    progress = plan.prog[t % plan.nsf]
    c = plan.floats[12]
    if soft:
        g_we = soft_sigmoid(a - progress, c)
        g_ns = soft_sigmoid(progress - a, c)
    else:
        g_we = (a > progress).to(torch.float32)
        g_ns = (progress > a).to(torch.float32)
    sig = torch.where(g.is_we, g_we, g_ns)
    return torch.where(g.approaching, sig, torch.ones_like(sig))


def plain_spatial_step(plan, carry, sg_ms, ss_ms, t: int, action2d, rand_t,
                       sched_t, mnext_t, mprev_t, routes, g=None) -> StepOut:
    """One step of B episodes (``body_STEP``): the composition of the plain
    per-shard bodies A, B, C, D (JAX's D1, D2 and D3) and E of
    :mod:`dhts_torch.ops.cuda.itscp_spatial_shard` on one shard holding
    every lane, whose gathers are identities: injection, signal-blended
    ghosts and the leader walk, Godunov and IDM physics, the flux
    capacitors, conversion (wants, arbitration, removals, inserts,
    deposits) and the queue. ``rand_t`` is ``[B, L]``; ``sched_t``,
    ``mnext_t``, ``mprev_t`` are ``[L]`` (shared by the batch); ``action2d``
    ``[n_phases, n_inter]``. Lane and vehicle sums are taken in a fixed
    order (cells and vehicles one after another, then lanes in float64 in
    lane order, rounded once), as the kernels take them."""
    from dhts_torch.ops.cuda import itscp_spatial_shard as shard

    g = geometry(plan, rand_t.device) if g is None else g
    (o,) = shard.plain_shard_step(plan, g, shard.LaneComm.whole(plan.L),
                                  [(carry, sg_ms, ss_ms)], t, action2d,
                                  rand_t, sched_t, mnext_t, mprev_t, routes)
    queue = shard.lane_sum32(o.q2) * plan.floats[1]
    events = torch.stack([o.n_inj, o.ev[:, 0], o.ev[:, 1]], 1).to(
        torch.int32)
    return StepOut(o.carry, o.sg_ms, o.ss_ms, queue, events, o.wave,
                   o.floor_hits)


def initial_carry(plan, B: int, device):
    """``(carry, sg_ms, ss_ms)`` of B empty episodes (fresh tensors)."""
    fbuf, ibuf = empty_state(plan, B, device)
    carry, sg, ss = unpack(plan, fbuf, ibuf)
    return tuple(x.clone() for x in carry), sg.clone(), ss.clone()


def _plain_steps(plan, action2d, rand, sched, mnext, mprev, routes):
    B = rand.shape[0]
    g = geometry(plan, rand.device)
    carry, sg, ss = initial_carry(plan, B, rand.device)
    for t in range(plan.T):
        out = plain_spatial_step(plan, carry, sg, ss, t, action2d,
                                 rand[:, t], sched[t], mnext[t], mprev[t],
                                 routes, g)
        carry, sg, ss = out.carry, out.sg_ms, out.ss_ms
        yield out


def plain_spatial_episode(plan, action2d, rand, sched, mnext, mprev,
                          routes):
    """Plain PyTorch version of the episode: ``(queues[B, T], events[B, T,
    3], max_wave[B, T])`` of B episodes from the empty state, ``rand`` of
    ``[B, T, L]``; differentiable in ``action2d`` in soft mode."""
    outs = list(_plain_steps(plan, action2d, rand, sched, mnext, mprev,
                             routes))
    return tuple(torch.stack([getattr(o, f) for o in outs], 1)
                 for f in ("queue", "events", "max_wave"))


def floor_hits(plan, action2d, rand, sched, mnext, mprev, routes):
    """``[B]``: vehicle steps of each episode that the IDM acceleration
    floor stopped (where the port's derivative and JAX's reverse mode
    differ by a rounding residue, ``dhts_torch/ops/idm.py``)."""
    with torch.no_grad():
        return sum(o.floor_hits for o in _plain_steps(
            plan, action2d, rand, sched, mnext, mprev, routes))


def plain_spatial_episode_bwd(plan, q_weight, action2d, *inputs):
    """Plain version of the derivative: ``sum_{b,t} q_weight[b, t] *
    d(queues[b, t]) / d(action2d)`` by autograd through
    :func:`plain_spatial_episode`."""
    with torch.enable_grad():
        a = action2d.detach().requires_grad_(True)
        queues, _, _ = plain_spatial_episode(plan, a, *inputs)
        (grad,) = torch.autograd.grad(torch.sum(queues * q_weight), a)
    return grad


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

_TAIL = [ctypes.c_int] * 13 + [ctypes.c_float] * 13 + [ctypes.c_void_p]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launchers' C signatures on a loaded library (the card's
    build or the host build of the same source)."""
    for fn in (lib.launch_itscp_spatial_step_fwd,
               lib.launch_itscp_spatial_step_bwd):
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + _TAIL
        fn.restype = ctypes.c_int
    lib.itscp_spatial_step_smem.argtypes = [ctypes.c_int] * 2
    lib.itscp_spatial_step_smem.restype = ctypes.c_size_t
    # (an earlier tree's library, which tools/step_timing.py loads, has
    # only the launchers and the smem size)
    if hasattr(lib, "itscp_spatial_step_smem_carry"):
        lib.itscp_spatial_step_smem_carry.argtypes = [ctypes.c_int] * 5
        lib.itscp_spatial_step_smem_carry.restype = ctypes.c_size_t
        lib.itscp_spatial_step_set_smem_cap.argtypes = [ctypes.c_longlong]
        lib.itscp_spatial_step_set_smem_cap.restype = None
        lib.itscp_spatial_step_set_reduction_warp.argtypes = [ctypes.c_int]
        lib.itscp_spatial_step_set_reduction_warp.restype = None
    return lib


def _library() -> ctypes.CDLL:
    from dhts_torch.ops.cuda import _build

    lib = _build.load("itscp_spatial_step")
    if lib.launch_itscp_spatial_step_fwd.argtypes is None:
        bind(lib)
    return lib


def kernel_args(plan, bufs, inputs, outputs, B, t0, n_steps, stream):
    """A launcher's arguments: the packed state ``(fbuf, dbuf, ibuf)``
    (``dbuf`` the tangents, or None in the forward), the step inputs
    ``(action2d, rand, sched, mnext, mprev, routes)``, the plan's tables,
    three outputs (forward: queues ``[B, T]``, events ``[B, T, 3]``, max
    wave ``[B, T]``; derivative: the loss weights ``[B, T]``, the float64
    gradient accumulator ``[B * n_act]`` and None), the batch, the first
    step and the step count, the plan's sizes and constants and the
    stream."""
    ptr = lambda x: ctypes.c_void_p(None if x is None else x.data_ptr())
    ptrs = [ptr(x) for x in (*bufs, *inputs, plan.prog, plan.lane_i,
                             plan.lane_f, *outputs)]
    ints = (plan.T, plan.L, plan.C, plan.V, plan.R, plan.P, plan.P2, plan.K,
            plan.W, plan.nsf, plan.n_phases, plan.n_inter, plan.mode)
    return (*ptrs, B, t0, n_steps, *ints, *plan.floats,
            ctypes.c_void_p(stream))


def _check(plan, inputs, B):
    action2d, rand, sched, mnext, mprev, routes = inputs
    dev = action2d.device
    T, L = plan.T, plan.L
    if L > MAX_LANES:
        raise ValueError(f"the spatial step kernel runs one thread per lane: "
                         f"{L} lanes exceed its cap of {MAX_LANES}")
    n_routes = L * plan.P + L * plan.P2
    for x, (name, shape, dtype) in zip(inputs, (
            ("action2d", (plan.n_phases, plan.n_inter), torch.float32),
            ("rand", (B, T, L), torch.float32),
            ("schedule", (T, L), torch.float32),
            ("mnext", (T, L), torch.int32), ("mprev", (T, L), torch.int32),
            ("routes", (n_routes, plan.R), torch.int32))):
        _launch.check(name, x, shape, dtype, dev)
    for name in ("lane_i", "lane_f", "prog"):
        if getattr(plan, name).device != dev:
            raise ValueError(f"plan.{name} is on "
                             f"{getattr(plan, name).device}, expected {dev}")
    return dev


def _check_state(plan, fbuf, ibuf, N, dev, dbuf=None):
    fs, isz = float_layout(plan)["size"], int_layout(plan)["size"]
    _launch.check("fbuf", fbuf, (N, fs), torch.float32, dev)
    _launch.check("ibuf", ibuf, (N, isz), torch.int32, dev)
    if dbuf is not None:
        _launch.check("dbuf", dbuf, (N, fs), torch.float32, dev)


def spatial_step_fwd(plan, fbuf, ibuf, t0: int, n_steps: int, inputs,
                     queues, events, waves):
    """Advance the B episodes of the packed state ``(fbuf, ibuf)`` (updated
    in place) by ``n_steps`` steps from step ``t0``, writing step ``t``'s
    queue, events and max wave speed at column ``t`` of ``queues[B, T]``,
    ``events[B, T, 3]`` and ``waves[B, T]``. ``inputs`` are ``(action2d,
    rand[B, T, L], sched, mnext, mprev, routes)``.

    CPU tensors run :func:`plain_spatial_step`; CUDA tensors launch the
    forward kernel once (one block per episode, the steps in a loop), the
    steps counted in ``launches["fwd"]`` and the launch in
    ``kernel_launches["fwd"]``, or raise.
    """
    B = fbuf.shape[0]
    dev = _check(plan, inputs, B)
    _check_state(plan, fbuf, ibuf, B, dev)
    _launch.check("queues", queues, (B, plan.T), torch.float32, dev)
    _launch.check("events", events, (B, plan.T, 3), torch.int32, dev)
    _launch.check("waves", waves, (B, plan.T), torch.float32, dev)
    if t0 < 0 or t0 + n_steps > plan.T:
        raise ValueError(f"steps {t0}..{t0 + n_steps} outside 0..{plan.T}")
    action2d, rand, sched, mnext, mprev, routes = inputs
    if _launch.device_of(fbuf).type == "cpu":
        g = geometry(plan, dev)
        carry, sg, ss = unpack(plan, fbuf, ibuf)
        for t in range(t0, t0 + n_steps):
            out = plain_spatial_step(plan, carry, sg, ss, t, action2d,
                                     rand[:, t], sched[t], mnext[t],
                                     mprev[t], routes, g)
            carry, sg, ss = out.carry, out.sg_ms, out.ss_ms
            queues[:, t], events[:, t], waves[:, t] = (
                out.queue, out.events, out.max_wave)
        f2, i2 = pack(plan, carry, sg, ss)
        fbuf.copy_(f2)
        ibuf.copy_(i2)
        return
    lib = _library()
    err = lib.launch_itscp_spatial_step_fwd(*kernel_args(
        plan, (fbuf, None, ibuf), inputs, (queues, events, waves), B, t0,
        n_steps, _launch.stream(dev)))
    _launch.raise_on(err, "itscp_spatial_step forward")
    launches["fwd"] += n_steps
    kernel_launches["fwd"] += int(n_steps > 0)


def spatial_episode_fwd(plan, action2d, rand, sched, mnext, mprev, routes):
    """``(queues[B, T], events[B, T, 3], max_wave[B, T])`` of B episodes
    from the empty state, without a graph for autograd; CPU tensors run
    :func:`plain_spatial_episode`, CUDA tensors one forward launch of T
    steps."""
    if _launch.device_of(action2d).type == "cpu":
        return plain_spatial_episode(plan, action2d, rand, sched, mnext,
                                     mprev, routes)
    B, dev = rand.shape[0], action2d.device
    fbuf, ibuf = empty_state(plan, B, dev)
    queues = torch.empty((B, plan.T), dtype=torch.float32, device=dev)
    events = torch.empty((B, plan.T, 3), dtype=torch.int32, device=dev)
    waves = torch.empty((B, plan.T), dtype=torch.float32, device=dev)
    spatial_step_fwd(plan, fbuf, ibuf, 0, plan.T,
                     (action2d, rand, sched, mnext, mprev, routes), queues,
                     events, waves)
    return queues, events, waves


def dual_state(plan, B: int, device):
    """Packed value, tangent and int buffers of the derivative: one dual
    episode per (episode, action entry), ``B * n_act`` rows, at the empty
    state with zero tangents."""
    n = B * plan.n_phases * plan.n_inter
    fbuf, ibuf = empty_state(plan, n, device)
    return fbuf, torch.zeros_like(fbuf), ibuf


def plain_spatial_step_bwd(plan, fbuf, dbuf, ibuf, t0: int, n_steps: int,
                           inputs, q_weight, grad64):
    """Plain version of the derivative kernel: :func:`plain_spatial_step`
    in PyTorch's forward-mode AD, the rows of action entry j at a time (the
    tangent of ``action2d`` is entry j's unit vector), the carry's tangents
    read from and written to ``dbuf``."""
    import torch.autograd.forward_ad as fwad

    action2d, rand, sched, mnext, mprev, routes = inputs
    n_act = plan.n_phases * plan.n_inter
    g = geometry(plan, fbuf.device)
    for j in range(n_act):
        rows = slice(j, fbuf.shape[0], n_act)
        seed = torch.zeros(n_act, dtype=torch.float32, device=fbuf.device)
        seed[j] = 1.0
        for t in range(t0, t0 + n_steps):
            carry, sg, ss = unpack(plan, fbuf[rows], ibuf[rows])
            tans, _, _ = unpack(plan, dbuf[rows], ibuf[rows])
            with fwad.dual_level():
                dual = tuple(fwad.make_dual(x, d) if i in CARRY_DIFF else x
                             for i, (x, d) in enumerate(zip(carry, tans)))
                a = fwad.make_dual(action2d, seed.view_as(action2d))
                out = plain_spatial_step(plan, dual, sg, ss, t, a,
                                         rand[:, t], sched[t], mnext[t],
                                         mprev[t], routes, g)
                parts = [fwad.unpack_dual(x) for x in out.carry]
                q = fwad.unpack_dual(out.queue).tangent
            values = tuple(p.primal for p in parts)
            tangents = tuple(
                p.tangent if i in CARRY_DIFF and p.tangent is not None
                else torch.zeros_like(p.primal) for i, p in enumerate(parts))
            fbuf[rows], ibuf[rows] = pack(plan, values, out.sg_ms, out.ss_ms)
            dbuf[rows] = pack(plan, tangents, torch.zeros_like(out.sg_ms),
                              torch.zeros_like(out.ss_ms))[0]
            if q is not None:
                grad64[rows] += q_weight[:, t].double() * q.double()


def spatial_step_bwd(plan, fbuf, dbuf, ibuf, t0: int, n_steps: int, inputs,
                     q_weight, grad64):
    """Advance the dual episodes of ``(fbuf, dbuf, ibuf)`` (row ``b * n_act
    + j`` differentiates episode b with respect to action entry j; updated
    in place) by ``n_steps`` steps, adding ``q_weight[b, t] *
    d(queue_t)/d(action_j)`` to ``grad64[b * n_act + j]`` (float64).

    CPU tensors run :func:`plain_spatial_step_bwd`; CUDA tensors launch the
    derivative kernel once (one block per episode and action entry, the
    steps in a loop), the steps counted in ``launches["bwd"]`` and the
    launch in ``kernel_launches["bwd"]``, or raise."""
    n_act = plan.n_phases * plan.n_inter
    N = fbuf.shape[0]
    if N % n_act:
        raise ValueError(f"{N} dual rows are not a multiple of {n_act}")
    B = N // n_act
    dev = _check(plan, inputs, B)
    _check_state(plan, fbuf, ibuf, N, dev, dbuf)
    _launch.check("q_weight", q_weight, (B, plan.T), torch.float32, dev)
    _launch.check("grad64", grad64, (N,), torch.float64, dev)
    if plan.mode == HARD:
        raise ValueError("the hard step has no derivative; use a soft plan")
    if _launch.device_of(fbuf).type == "cpu":
        plain_spatial_step_bwd(plan, fbuf, dbuf, ibuf, t0, n_steps, inputs,
                               q_weight, grad64)
        return
    lib = _library()
    err = lib.launch_itscp_spatial_step_bwd(*kernel_args(
        plan, (fbuf, dbuf, ibuf), inputs, (q_weight, grad64, None), B, t0,
        n_steps, _launch.stream(dev)))
    _launch.raise_on(err, "itscp_spatial_step derivative")
    launches["bwd"] += n_steps
    kernel_launches["bwd"] += int(n_steps > 0)


def spatial_episode_bwd(plan, q_weight, action2d, rand, sched, mnext, mprev,
                        routes):
    """``grad[n_phases, n_inter] = sum_{b,t} q_weight[b, t] *
    d(queues[b, t]) / d(action2d)`` of the soft episodes. CPU tensors use
    :func:`plain_spatial_episode_bwd`; CUDA tensors one launch of the
    derivative kernel over T steps (one block per episode and action
    entry)."""
    inputs = (action2d, rand, sched, mnext, mprev, routes)
    if _launch.device_of(action2d).type == "cpu":
        return plain_spatial_episode_bwd(plan, q_weight, *inputs)
    B, dev = rand.shape[0], action2d.device
    fbuf, dbuf, ibuf = dual_state(plan, B, dev)
    grad64 = torch.zeros(fbuf.shape[0], dtype=torch.float64, device=dev)
    spatial_step_bwd(plan, fbuf, dbuf, ibuf, 0, plan.T, inputs,
                     q_weight.contiguous(), grad64)
    return grad64.view(B, -1).sum(0).to(torch.float32).view(
        plan.n_phases, plan.n_inter)


def make_spatial_episode_op(plan):
    """K5's op around the episode: ``op(action2d, rand, sched, mnext, mprev,
    routes) -> (queues, events, max_wave)``, differentiable in ``action2d``
    (plain version and autograd on the CPU; the forward and derivative
    kernels on the card). Only the queues carry a cotangent into the
    derivative; the max wave speed is a diagnostic without a gradient on
    both devices."""
    body = lambda *args: plain_spatial_episode(plan, *args)
    fwd = lambda *args: spatial_episode_fwd(plan, *args)

    def derivative(args, cots):
        (g_queues,) = cots
        return (spatial_episode_bwd(plan, g_queues.contiguous(), *args),)

    return make_dkernel(body, fwd, derivative, (0,), name="spatialSTEP",
                        nondiff_outputs=(2,))


# ---------------------------------------------------------------------------
# the JAX package's factories
# ---------------------------------------------------------------------------


def make_fused_spatial_episode(env, mesh, differentiable: bool = True):
    """``episode(action_flat, rand=None, generator=None) -> EpisodeResult``
    through the fused spatial step, from the empty network state. ``rand``
    is ``[T, L]`` (one episode) or ``[B, T, L]`` (B episodes in each
    launch; the result's fields gain a leading B); without it one draw
    comes from ``env.draw_rand(generator)``. The scene's data (schedule,
    routes, pools) is read from ``env`` at each call; the plan is rebuilt
    when a reset needs a wider leader window.

    On a one-device mesh each step is one STEP launch. On a mesh whose lane
    axis has S > 1 shards (one process per shard, every rank calling with
    the same action and draws) each step runs the per-shard bodies of
    :mod:`dhts_torch.ops.cuda.itscp_spatial_shard` on this rank's lanes
    between collectives over the mesh's lane group, and every rank returns
    the whole result."""
    sharded = mesh.lanes > 1
    if sharded and mesh.lane_group is None:
        raise ValueError(f"mesh {mesh.shape}: {mesh.lanes} lane shards need "
                         f"the mesh's lane process group (make_mesh)")
    built = {}

    def op_of():
        win = env._fused_win_needed
        if built.get("win", -1) < win:
            plan = make_plan(env, differentiable)
            built["plan"] = plan
            if sharded:
                from dhts_torch.ops.cuda import itscp_spatial_shard as shard

                sh = shard.shards_of(plan.L, mesh.lanes)[mesh.lane_index]
                built["comm"] = shard.LaneComm(plan.L, [sh], mesh.lane_group)
                built["op"] = shard.make_shard_episode_op(plan,
                                                          built["comm"])
                built["fwd"] = lambda *a: shard.shard_episode_fwd(
                    plan, built["comm"], *a)
            else:
                built["op"] = make_spatial_episode_op(plan)
                built["fwd"] = lambda *a: spatial_episode_fwd(plan, *a)
            built["win"] = win
        return built["plan"], built["op"], built["fwd"]

    def batch(action_flat, rand):
        plan, op, fwd = op_of()
        action2d = torch.as_tensor(action_flat, dtype=torch.float32,
                                   device=env.device).reshape(
            plan.n_phases, plan.n_inter).contiguous()
        d = env.data
        routes = route_table(d.inj_routes, env.base_state.route_pool)
        args = (action2d, rand.contiguous(), d.schedule, d.mroute_next,
                d.mroute_prev, routes)
        if differentiable:
            return op(*args)
        with torch.no_grad():
            return fwd(*args)

    def episode(action_flat, rand=None, generator=None):
        from dhts_torch.apps.control.itscp.env import EpisodeResult

        if rand is None:
            rand = env.draw_rand(generator)
        single = rand.dim() == 2
        queues, events, waves = batch(action_flat,
                                      rand[None] if single else rand)
        res = EpisodeResult(
            reward=-torch.sum(queues, -1), queue_per_step=queues,
            emitted=events[..., 1].sum(-1), absorbed=events[..., 2].sum(-1),
            injected=events[..., 0].sum(-1),
            max_wave_speed=torch.amax(waves, -1), events_per_step=events)
        return EpisodeResult(*(x[0] for x in res)) if single else res

    episode.batch = batch
    episode.plan = lambda: op_of()[0]
    return episode


def _train_step(env, model, update, mesh, obs, low, high):
    from dhts_torch.apps.control.controller import squash_action
    from dhts_torch.parallel.mesh import shard_episode_batch

    if mesh.device != env.device:
        raise ValueError(f"mesh on {mesh.device}, env on {env.device}")
    ep = make_fused_spatial_episode(env, mesh, differentiable=True)
    obs = torch.as_tensor(obs, device=env.device)
    n_data = mesh.shape.get("data", 1)

    def train_step(rand):
        """One update on the mean soft reward of the B episodes of
        ``rand[B, T, L]`` (all in each launch); returns the loss."""
        if rand.shape[0] % n_data:
            raise ValueError(f"{rand.shape[0]} episodes per step must be a "
                             f"multiple of the mesh's data axis ({n_data})")
        rand = shard_episode_batch(mesh, rand)
        action = squash_action(model(obs), low, high)
        queues, _, _ = ep.batch(action, rand)
        loss = -torch.mean(-torch.sum(queues, -1))  # -mean(reward)
        update(loss)
        return float(loss.detach())

    return train_step


def make_fused_spatial_train_step(env, model, update, mesh, obs, low,
                                  high):
    """``fn(rand[B, T, L]) -> loss``: the controller's training step over
    the fused spatial episode on a ``("lane",)`` mesh, the B episodes in
    each launch. ``update(loss)`` backpropagates the loss and steps the
    optimiser (the Trainer's ``apply_update``: global-norm clip,
    learning-rate schedule, Adam). On S > 1 lane shards every rank computes
    the same loss and the whole action gradient, so the controller's
    parameters stay replicated without a gradient all-reduce."""
    if tuple(mesh.axis_names) != ("lane",):
        raise ValueError(f"mesh axes {mesh.axis_names} must be ('lane',)")
    return _train_step(env, model, update, mesh, obs, low, high)


def make_fused_spatial_train_step_2d(env, model, update, mesh, obs, low,
                                     high):
    """The ``(data, lane)`` composition of the JAX package, the Trainer's
    ``mesh_fused`` step, on a ``(1, S)`` mesh: the same step as
    :func:`make_fused_spatial_train_step`, the episode batch placed on the
    data axis (B must be a multiple of its size, here 1)."""
    if set(mesh.axis_names) != {"data", "lane"}:
        raise ValueError(f"mesh axes {mesh.axis_names} must be "
                         f"('data', 'lane')")
    return _train_step(env, model, update, mesh, obs, low, high)
