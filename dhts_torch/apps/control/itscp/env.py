"""ITSCP environment on tensors (port of :mod:`dhts.apps.control.itscp.env`).

* the per-phase **action** (one float per intersection per signal phase) is
  the green split between the WE and NS arms within the phase: an arm's gate
  compares the action value against the phase progress;
* **macro lanes** see signal-blended ghost cells — green = upstream state or
  schedule inflow at equilibrium speed, red = a stopped wall downstream /
  vacuum upstream;
* **micro lanes** inject vehicles from pre-drawn waiting pools at open
  boundaries and blend green (route leader) vs red (stop at lane end)
  virtual-leader deltas by the signal of the lane the head vehicle is on;
* the **reward** is the negative squared queue length, where "queued" is a
  test of speed below ``static_speed``.

The episode is an eager PyTorch loop over the T steps; each step is
vectorised over lanes, cells and vehicles. In every gate mode (hard, soft,
straight-through) it is the specification of the hand-written CUDA kernel
in :mod:`dhts_torch.ops.cuda.itscp_hybrid_episode`, and autograd through it
that of the kernel's backward. The running means that sharpen the soft
sigmoids are detached ``(sum, count)`` states updated once per step.

Randomness is host numpy at ``reset`` (the same draws, in the same order,
as ``dhts``) and one ``rand[T, L]`` tensor per episode, drawn with an
explicit ``torch.Generator`` or passed in.

``reset_batch`` draws a batch of B scenarios; ``episode_batch`` and
``packed_episode_fn`` run them, on the fused path as one launch of K1.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dhts_torch.apps.control.itscp import problem as problem_mod
from dhts_torch.apps.control.itscp import scene as grid_scene
from dhts_torch.device import resolve_device
from dhts_torch.models import conversion, network
from dhts_torch.models.scene import SceneSpec
from dhts_torch.models.vehicle import default_params
from dhts_torch.ops import arz, dmath
from dhts_torch.ops.dmath import soft_sigmoid
from dhts_torch.utils import rms

DEFAULT_CONFIG = dict(
    num_intersection=1,
    num_lane=3,
    lane_length=20.0,
    speed_limit=60.0,
    cell_length=5.0,
    vehicle_length=5.0,
    simulation_frequency=30,
    policy_length=10,  # seconds one action vector persists
    signal_length=2,  # seconds per signal phase
    action_min=0.1,
    action_max=0.9,
    duration=1,  # actions per episode
    static_speed=0.2,  # queue threshold (m/s)
    num_schedule_obs=10,
    soft_gate_scale=1.0,  # soft-mode signal-gate sharpness multiplier
    gate_mode="soft",  # "soft" | "st" (straight-through gates)
    max_num_micro_vehicle_per_lane=10,
    mode="macro",  # macro | micro | hybrid
    # 0 draws from an UNSEEDED generator (numpy default_rng(None)): two envs
    # then get different schedules and pools. Parity runs set a seed > 0.
    random_seed=0,
)


class EpisodeData(NamedTuple):
    """Per-episode tensors (drawn at reset, constant during the rollout)."""

    schedule: torch.Tensor  # f32[T, L] inflow density
    mroute_next: torch.Tensor  # i32[T, L] per-step MacroRoute
    mroute_prev: torch.Tensor  # i32[T, L]
    inj_routes: torch.Tensor  # i32[L, P, R] waiting-pool routes


class LaneMeta(NamedTuple):
    """Static signal metadata per lane."""

    approaching: torch.Tensor  # bool[L] non-mid approaching arms
    is_we: torch.Tensor  # bool[L]
    inter: torch.Tensor  # i32[L] intersection index
    has_prev: torch.Tensor  # bool[L]


class EpisodeResult(NamedTuple):
    reward: torch.Tensor
    queue_per_step: torch.Tensor  # f32[T] summed squared queue * dt
    emitted: torch.Tensor
    absorbed: torch.Tensor
    injected: torch.Tensor
    max_wave_speed: torch.Tensor
    # i32[T, 3] per-step (injected, emitted, absorbed) counts
    events_per_step: torch.Tensor | None = None


def signal_progress_table(num_signal_frame: int) -> np.ndarray:
    """Phase progress ``(t % nsf) / nsf`` computed on the host in float64 and
    rounded once to float32. A device-side division can land 1 ulp off the
    correctly rounded quotient and flip the hard ``progress > action`` gate
    when an action ties a progress grid point."""
    nsf = int(num_signal_frame)
    return np.minimum(np.arange(nsf) / nsf, 1.0).astype(np.float32)


def lane_signals(meta: LaneMeta, action2d, t: int, num_signal_frame: int,
                 n_phases: int, differentiable: bool, progress_table,
                 gate_scale: float = 1.0, st_mode: bool = False):
    """Per-lane stored signal: approaching arms gate on the
    action-vs-progress comparison; mid connectors and leaving arms are
    always open. ``progress_table`` is :func:`signal_progress_table` as a
    float32 tensor on the action's device."""
    phase = min(t // num_signal_frame, n_phases - 1)
    a = action2d[phase][meta.inter.long()]  # [L]
    progress = progress_table[t % num_signal_frame]
    if differentiable:
        gate_we = soft_sigmoid(a - progress, 32.0 * gate_scale)
        gate_ns = soft_sigmoid(progress - a, 32.0 * gate_scale)
        if st_mode:
            gate_we = gate_we + ((a > progress).to(torch.float32) -
                                 gate_we).detach()
            gate_ns = gate_ns + ((progress > a).to(torch.float32) -
                                 gate_ns).detach()
    else:
        gate_we = (a > progress).to(torch.float32)
        gate_ns = (progress > a).to(torch.float32)
    gate = torch.where(meta.is_we, gate_we, gate_ns)
    return torch.where(meta.approaching, gate, torch.ones_like(gate))


def _make_episode_fn(spec: SceneSpec, meta: LaneMeta, config,
                     differentiable: bool):
    """Build the eager episode rollout for one scene/config.

    Returns ``episode(action_flat, data, state0, rand) -> EpisodeResult``;
    ``episode.run(action2d, data, state0, rand) -> (queues[T],
    events[T, 8])`` is the same loop with the full per-step event record
    (the fused kernel's outputs).
    """
    gsc = float(config.get("soft_gate_scale", 1.0))
    st_mode = str(config.get("gate_mode", "soft")) == "st"

    def stg(hard_val, soft_val):
        if not st_mode:
            return soft_val
        return soft_val + (hard_val.to(torch.float32) - soft_val).detach()

    T = (config["policy_length"] * config["duration"] *
         config["simulation_frequency"])
    nsf = config["simulation_frequency"] * config["signal_length"]
    n_phases = max(1, (config["policy_length"] * config["duration"]) //
                   config["signal_length"])
    n_inter = config["num_intersection"] ** 2
    dt = 1.0 / config["simulation_frequency"]
    static_speed = config["static_speed"]
    veh_len = config["vehicle_length"]
    diff = differentiable
    L = spec.num_lanes
    dev = spec.device
    all_macro = bool(spec.is_macro.all())
    prog_tab = torch.as_tensor(signal_progress_table(nsf), device=dev)
    ar = torch.arange(L, device=dev)
    zeros_l = torch.zeros(L, dtype=torch.float32, device=dev)
    ones_l = torch.ones(L, dtype=torch.float32, device=dev)
    i32 = lambda m: m.to(torch.int32)
    clip_l = lambda x: torch.clamp(x, 0, L - 1).long()

    def boundary_and_step(state, t, action2d, sched_t, rand_t, inj_routes,
                          inj_left, is_static_ms, signal_ms):
        mic = state.micro
        V = mic.position.shape[1]
        lane_sig = lane_signals(meta, action2d, t, nsf, action2d.shape[0],
                                diff, prog_tab, gate_scale=gsc,
                                st_mode=st_mode)
        incoming = torch.where(meta.has_prev, -ones_l, sched_t)

        # ---- micro injection (before the leader search)
        if not all_macro:
            free = torch.where(
                mic.count > 0,
                mic.position[:, 0] - 0.5 * mic.params.length[:, 0],
                spec.length)
            inject = (~meta.has_prev & ~spec.is_macro &
                      (free > 0.5 * veh_len) & (rand_t < incoming) &
                      (inj_left > 0) & (mic.count < V))
            P = inj_routes.shape[1]
            pool_idx = torch.clamp(P - inj_left, 0, P - 1).long()
            new_route = inj_routes[ar, pool_idx]
            rank = torch.cumsum(i32(inject), dim=0) - 1
            new_vid = torch.where(inject,
                                  (state.veh_counter + rank).to(torch.int32),
                                  torch.full_like(mic.count, -1))
            dflt = default_params(spec.speed_limit, (L,), veh_len,
                                  device=dev)

            def tail_insert(x, newval):
                return network.tail_insert_rows(x, newval, inject)

            mic = mic._replace(
                position=tail_insert(mic.position, zeros_l),
                speed=tail_insert(mic.speed, zeros_l),
                params=mic.params.zip_map(tail_insert, dflt),
                route=tail_insert(mic.route, new_route),
                route_idx=tail_insert(mic.route_idx,
                                      torch.zeros_like(mic.count)),
                vid=tail_insert(mic.vid, new_vid),
                count=mic.count + i32(inject))
            n_inj = torch.sum(i32(inject))
            state = state._replace(micro=mic,
                                   veh_counter=state.veh_counter + n_inj)
            inj_left = inj_left - i32(inject)
        else:
            n_inj = torch.zeros((), dtype=torch.int32, device=dev)

        # ---- macro boundary: signal-blended ghost cells
        u_all = network.macro_cell_u(spec, state.macro)
        gl_r, gl_u = network.get_macro_boundary(spec, state, left=True,
                                                u_all=u_all)
        gl_r = torch.where(meta.has_prev, gl_r, incoming)
        gl_u = torch.where(meta.has_prev, gl_u,
                           arz.compute_u_eq(incoming, spec.speed_limit))
        mp = state.macro_prev
        prev_sig = torch.where(
            ~meta.has_prev, ones_l,
            torch.where(mp < 0, zeros_l, lane_sig[clip_l(mp)]))
        bl_r = gl_r * prev_sig  # red upstream ghost: r=0
        bl_u = gl_u * prev_sig + spec.speed_limit * (1.0 - prev_sig)

        gr_r, gr_u = network.get_macro_boundary(spec, state, left=False,
                                                u_all=u_all)
        if diff:
            s = stg(lane_sig > 0.5, soft_sigmoid(lane_sig - 0.5, 32.0 * gsc))
        else:
            s = (lane_sig > 0.5).to(torch.float32)
        br_r = gr_r * s + 1.0 * (1.0 - s)  # red downstream ghost: jam wall
        br_u = gr_u * s  # red: u=0

        if all_macro:
            bv = network.BoundaryValues(
                left_r=bl_r, left_u=bl_u, right_r=br_r, right_u=br_u,
                head_position_delta=torch.full(
                    (L,), network.DEFAULT_HEAD_POSITION_DELTA, device=dev),
                head_speed_delta=zeros_l)
            state, max_wave, _ = network.lanes_forward(spec, state, bv, dt,
                                                       skip_micro=True)
            z = torch.zeros((), dtype=torch.int32, device=dev)
            ev = conversion.ConversionEvents(z, z, z, z, z, z)
            return _queue_reward(state, is_static_ms, inj_left, signal_ms,
                                 n_inj, ev, max_wave, lane_sig)

        # ---- micro boundary: green leader vs red stop-at-end
        pd_g, sd_g = network.find_micro_leader(spec, state)
        head = network.micro_head_info(spec, state)
        red_pd = dmath.maximum(
            spec.length - head["position"] - head["length"] * 0.5, 0.0)

        R = state.micro.route.shape[2]
        ridx = head["route_idx"]
        pick = lambda j: torch.gather(head["route"], 1,
                                      torch.clamp(j, 0, R - 1).long()[:, None]
                                      )[:, 0]
        minus1 = torch.full_like(ridx, -1)
        prev_l = torch.where(ridx > 0, pick(ridx - 1), minus1)
        next_l = torch.where(ridx + 1 < R, pick(ridx + 1), minus1)
        curr_l = pick(ridx)
        prev_exist = prev_l >= 0
        next_exist = next_l >= 0
        hp = head["position"]
        if diff:
            p_score = torch.where(prev_exist,
                                  stg(zeros_l, soft_sigmoid(-hp, 16.0)),
                                  zeros_l)
            c_score = stg(ones_l, soft_sigmoid(hp, 16.0) *
                          soft_sigmoid(spec.length - hp, 16.0))
            n_score = torch.where(
                next_exist, stg(zeros_l, soft_sigmoid(hp - spec.length, 16.0)),
                zeros_l)
        else:
            p_score, c_score, n_score = zeros_l, ones_l, zeros_l
        ssum = p_score + c_score + n_score
        p_score, c_score, n_score = (x / ssum for x in (p_score, c_score,
                                                        n_score))
        fsig = c_score * lane_sig[clip_l(curr_l)]
        fsig = fsig + torch.where(prev_exist,
                                  p_score * lane_sig[clip_l(prev_l)], zeros_l)
        fsig = fsig + torch.where(next_exist,
                                  n_score * lane_sig[clip_l(next_l)], zeros_l)

        blend_mask = head["exists"] & ~spec.is_macro
        if diff:
            signal_ms = rms.update_mean_masked(signal_ms, fsig, blend_mask)
            const = arz.rdiv(32.0 * gsc, dmath.maximum(
                torch.abs(rms.mean_of(signal_ms, 1.0)), 1e-6))
            fs = stg(fsig >= 0.5, soft_sigmoid(fsig - 0.5, const))
            pd = pd_g * fs + red_pd * (1.0 - fs)
            sd = sd_g * fs  # red speed delta is 0
        else:
            green = fsig >= 0.5
            pd = torch.where(green, pd_g, red_pd)
            sd = torch.where(green, sd_g, zeros_l)
        pd = torch.where(blend_mask, pd, pd_g)
        sd = torch.where(blend_mask, sd, sd_g)

        bv = network.BoundaryValues(left_r=bl_r, left_u=bl_u, right_r=br_r,
                                    right_u=br_u, head_position_delta=pd,
                                    head_speed_delta=sd)

        # ---- lane forward + conversion
        state, max_wave, _ = network.lanes_forward(spec, state, bv, dt)
        state, ev = conversion.apply_with_events(spec, state, dt)
        return _queue_reward(state, is_static_ms, inj_left, signal_ms, n_inj,
                             ev, max_wave, lane_sig)

    def _queue_reward(state, is_static_ms, inj_left, signal_ms, n_inj, ev,
                      max_wave, lane_sig):
        u_cells = network.macro_cell_u(spec, state.macro)
        cell_m = spec.cell_mask & spec.is_macro[:, None]
        is_static_ms = rms.update_mean_masked(
            is_static_ms, static_speed - u_cells, cell_m)
        if not all_macro:
            veh_m = state.micro.active & ~spec.is_macro[:, None]
            is_static_ms = rms.update_mean_masked(
                is_static_ms, static_speed - state.micro.speed, veh_m)
        if diff:
            const = arz.rdiv(16.0, dmath.maximum(
                torch.abs(rms.mean_of(is_static_ms, 1.0)), 1e-6))
            stat_c = stg(u_cells < static_speed,
                         soft_sigmoid(static_speed - u_cells, const))
        else:
            stat_c = (u_cells < static_speed).to(torch.float32)
        n_veh_per_cell = arz.div(state.macro.r * spec.cell_length[:, None],
                                 veh_len)
        q_macro = torch.sum(stat_c * n_veh_per_cell * cell_m, dim=1)
        if all_macro:
            q_lane = q_macro
        else:
            if diff:
                stat_v = stg(state.micro.speed < static_speed,
                             soft_sigmoid(static_speed - state.micro.speed,
                                          const))
            else:
                stat_v = (state.micro.speed < static_speed).to(torch.float32)
            q_micro = torch.sum(stat_v * veh_m, dim=1)
            q_lane = torch.where(spec.is_macro, q_macro, q_micro)
        queue = torch.sum(q_lane * q_lane) * dt
        return (state, inj_left, is_static_ms, signal_ms, queue, n_inj, ev,
                torch.amax(max_wave), lane_sig)

    def run(action2d, data: EpisodeData, state0, rand):
        """The T-step loop; returns ``(queues[T], events[T, 8])``: float32
        rows of injected, emitted, absorbed, transferred, transfer wins,
        deposit wins, removals and max wave speed per step."""
        P = data.inj_routes.shape[1]
        inj_left = i32(torch.where(~meta.has_prev & ~spec.is_macro,
                                   torch.full_like(meta.inter, P),
                                   torch.zeros_like(meta.inter)))
        state = state0
        ms_stat = rms.init_mean_state(dev)
        ms_sig = rms.init_mean_state(dev)
        queues, events = [], []
        for t in range(T):
            state = state._replace(macro_next=data.mroute_next[t],
                                   macro_prev=data.mroute_prev[t])
            (state, inj_left, ms_stat, ms_sig, queue, n_inj, ev, max_wave,
             _) = boundary_and_step(state, t, action2d, data.schedule[t],
                                    rand[t], data.inj_routes, inj_left,
                                    ms_stat, ms_sig)
            queues.append(queue)
            events.append(torch.stack(
                [n_inj.to(torch.float32)] +
                [x.to(torch.float32) for x in ev] +
                [max_wave.detach().to(torch.float32)]))
        return torch.stack(queues), torch.stack(events)

    def episode(action_flat, data: EpisodeData, state0, rand):
        """Full rollout; ``action_flat`` is the ``[n_phases * n_inter]``
        action vector."""
        action2d = action_flat.reshape(n_phases, n_inter)
        queues, events = run(action2d, data, state0, rand)
        return result_from_events(-torch.sum(queues), queues, events)

    episode.run = run
    return episode


def result_from_events(reward, queues, events) -> EpisodeResult:
    """EpisodeResult from the fused kernel's outputs ``(-qsum, queues[T],
    events[T, 8])``, or of B episodes ``(reward[B], queues[B, T],
    events[B, T, 8])`` (every field then has the leading B)."""
    ev = events[..., :3].to(torch.int32)
    return EpisodeResult(reward=reward, queue_per_step=queues,
                         emitted=torch.sum(ev[..., 1], -1),
                         absorbed=torch.sum(ev[..., 2], -1),
                         injected=torch.sum(ev[..., 0], -1),
                         max_wave_speed=torch.amax(events[..., 7], -1),
                         events_per_step=ev)


def stack_results(results) -> EpisodeResult:
    """One EpisodeResult with a leading batch axis from single episodes'."""
    return EpisodeResult(*(torch.stack(x) for x in zip(*results)))


class ItscpEnv:
    """Host-side environment wrapper: config, reset, observe, episode.

    ``device`` defaults to ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, config=None, schedule_fn=None, device=None):
        self.device = resolve_device(device)
        self.config = dict(DEFAULT_CONFIG)
        if config:
            self.config.update(config)
        self.schedule_fn = schedule_fn or problem_mod.random_schedule
        self.grid: grid_scene.GridScene | None = None
        self._episode_soft = None
        self._episode_hard = None
        # {differentiable: (fused episode fn, its leader window)}
        self._fused = {}

    # -- sizes ------------------------------------------------------------

    @property
    def num_timestep(self):
        c = self.config
        return (c["policy_length"] * c["duration"] *
                c["simulation_frequency"])

    @property
    def n_phases(self):
        c = self.config
        return max(1, (c["policy_length"] * c["duration"]) //
                   c["signal_length"])

    def action_size(self):
        return self.n_phases * self.config["num_intersection"] ** 2

    def observation_size(self):
        return self.config["num_schedule_obs"] * len(self.grid.keys)

    def action_bounds(self):
        c = self.config
        return c["action_min"], c["action_max"]

    # -- lifecycle ----------------------------------------------------------

    def reset(self, seed: int | None = None) -> np.ndarray:
        """Draw a scenario (schedule, per-step MacroRoutes, waiting pools
        and, on the first call, the scene) with numpy; the draws and their
        order match ``dhts.apps.control.itscp.env.ItscpEnv.reset``. A seed
        of 0 (the default ``random_seed``) means an unseeded generator."""
        c = self.config
        dev = self.device
        seed = c["random_seed"] if seed is None else seed
        rng = np.random.default_rng(seed if seed > 0 else None)
        rebuild = self.grid is None
        if rebuild:
            self.grid = grid_scene.build_grid(
                c["num_intersection"], c["num_lane"], c["lane_length"],
                c["speed_limit"], c["cell_length"], c["mode"],
                max_vehicles_per_lane=max(
                    16, c["max_num_micro_vehicle_per_lane"] + 6))
            self.spec, self.base_state = self.grid.builder.build(rng, dev)
            self.meta = LaneMeta(
                approaching=torch.as_tensor(self.grid.approaching,
                                            device=dev),
                is_we=torch.as_tensor(self.grid.is_we, device=dev),
                inter=torch.as_tensor(self.grid.intersection, device=dev),
                has_prev=torch.as_tensor(
                    self.spec.num_prev.cpu().numpy() > 0, device=dev))
        else:
            # the same leading draws as the first build, so reset(seed) is
            # idempotent and the emission pool is fresh per episode
            self.base_state = self.base_state._replace(
                route_pool=self.grid.builder.build_route_pool(rng, dev))

        T = self.num_timestep
        assert T >= c["num_schedule_obs"], (
            f"horizon T={T} shorter than num_schedule_obs="
            f"{c['num_schedule_obs']}: observation windows would be empty")
        locs = [k.loc for k in self.grid.keys]
        self.schedule = self.schedule_fn(locs, T, rng)

        # per-timestep random MacroRoute
        nxts, prvs = [], []
        for _ in range(T):
            n, p = self.grid.builder.random_macro_route(rng)
            nxts.append(n)
            prvs.append(p)
        self.mroute_next = np.asarray(nxts, np.int32)
        self.mroute_prev = np.asarray(prvs, np.int32)

        # waiting pools: default vehicles with random routes, P per lane
        P = c["max_num_micro_vehicle_per_lane"]
        L = len(self.grid.keys)
        R = self.grid.builder.R
        inj = np.full((L, P, R), -1, np.int32)
        for l in range(L):
            for p in range(P):
                rt = self.grid.builder.random_route(l, rng)
                inj[l, p, : len(rt)] = rt
        self.inj_routes = inj

        self.data = EpisodeData(
            schedule=torch.as_tensor(self.schedule, device=dev),
            mroute_next=torch.as_tensor(self.mroute_next, device=dev),
            mroute_prev=torch.as_tensor(self.mroute_prev, device=dev),
            inj_routes=torch.as_tensor(inj, device=dev))

        if rebuild or self._episode_soft is None:
            self._episode_soft = _make_episode_fn(self.spec, self.meta, c,
                                                  True)
            self._episode_hard = _make_episode_fn(self.spec, self.meta, c,
                                                  False)
            self._fused = {}
        # the leader walk's window bound: it depends on the fresh pools
        from dhts_torch.ops.cuda.itscp_hybrid_episode import leader_window
        is_macro = self.spec.is_macro.cpu().numpy()
        self._fused_win_needed = max(
            leader_window(is_macro, inj),
            leader_window(is_macro, self.base_state.route_pool.cpu().numpy()))
        return self.observe()

    def observe(self) -> np.ndarray:
        """Windowed schedule averages for open-boundary lanes, zeros
        elsewhere (float32 numpy, host-side)."""
        k = self.config["num_schedule_obs"]
        T = self.schedule.shape[0]
        has_prev = self.spec.num_prev.cpu().numpy() > 0
        obs = []
        win = T // k
        for li in range(self.schedule.shape[1]):
            if has_prev[li]:
                obs.extend([0.0] * k)
            else:
                for j in range(k):
                    t0, t1 = j * win, min(j * win + win, T)
                    obs.append(float(self.schedule[t0:t1, li].mean()))
        return np.asarray(obs, np.float32)

    def draw_rand(self, generator: torch.Generator | None = None):
        """The episode's ``rand[T, L]`` uniform draw on the env's device
        (``generator`` defaults to one seeded with ``random_seed``)."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(max(int(self.config["random_seed"]), 0))
        return torch.rand((self.num_timestep, self.spec.num_lanes),
                          generator=generator, device=self.device)

    def episode(self, action, differentiable: bool,
                generator: torch.Generator | None = None,
                rand=None) -> EpisodeResult:
        """Simulate the full horizon under ``action``.

        ``rand`` (f32 ``[T, L]``) is the injection stream; without it one is
        drawn from ``generator``. With ``config["use_fused_episode"]`` the
        episode runs through the fused kernel K1 (the hand-written CUDA
        kernels on a GPU, their plain version on the CPU); differentiable
        episodes then back-propagate through K1's backward kernel.
        """
        action = torch.as_tensor(action, dtype=torch.float32,
                                 device=self.device)
        if rand is None:
            rand = self.draw_rand(generator)
        if self.config.get("use_fused_episode"):
            return self._fused_episode_one(differentiable)(action, self.data,
                                                           rand)
        fn = self._episode_soft if differentiable else self._episode_hard
        return fn(action, self.data, self.base_state, rand)

    def _fused_episode_fn(self, differentiable: bool):
        """The fused episode of this scene in the given mode, rebuilt when a
        reset needs a wider leader window."""
        from dhts_torch.ops.cuda.itscp_hybrid_episode import \
            make_fused_itscp_episode

        win = self._fused_win_needed
        built = self._fused.get(differentiable)
        if built is None or win > built[1]:
            V = self.base_state.micro.position.shape[1]
            R = self.base_state.micro.route.shape[2]
            P = self.data.inj_routes.shape[1]
            P2 = self.base_state.route_pool.shape[1]
            fn = make_fused_itscp_episode(self.spec, self.meta, self.config,
                                          V, R, P, P2,
                                          differentiable=differentiable,
                                          window=win)
            self._fused[differentiable] = built = (fn, win)
        return built[0]

    def fused_plan(self, differentiable: bool = False):
        """The fused kernel's :class:`EpisodePlan` for this scene."""
        return self._fused_episode_fn(differentiable).plan

    def _fused_episode_one(self, differentiable: bool = False):
        """Return ``one(action_flat, data, rand) -> EpisodeResult`` through
        the fused episode (built once per scene, mode and leader window).

        ``one`` also runs B episodes in one launch: ``action_flat[B,
        n_act]``, ``rand[B, T, L]`` and the fields of ``data`` (a
        ``batch_data``) may each have a leading episode axis, and the
        inputs without it are shared (an ``[n_act]`` action: E draws of one
        controller's episode); the result's fields then have the leading B.
        Every episode takes the emission pool of the last reset, as JAX's
        ``episode_batch`` and ``packed_episode_fn`` do."""
        fn = self._fused_episode_fn(differentiable)
        n_phases = self.n_phases
        pool = self.base_state.route_pool

        def one(action_flat, data, rand, pool=pool):
            reward, queues, events = fn(
                action_flat.reshape(*action_flat.shape[:-1], n_phases, -1),
                data.schedule, data.mroute_next, data.mroute_prev, rand,
                data.inj_routes, pool, with_events=True)
            return result_from_events(reward, queues, events)

        return one

    # -- multi-scenario batching --------------------------------------------

    def reset_batch(self, batch: int, seed: int | None = None) -> np.ndarray:
        """Draw ``batch`` independent scenarios (schedules, per-step macro
        routes, waiting pools) with the seeds ``seed + i`` (an unseeded
        generator each when the base seed is 0, as in JAX) and stack them
        into ``batch_data``, an EpisodeData with a leading B. Returns the
        per-scenario observations ``batch_obs[B, obs]``. The leader window
        covers every scenario's pools; ``data`` and the emission pool are
        the last scenario's."""
        base_seed = self.config["random_seed"] if seed is None else seed
        datas, obss, wins = [], [], []
        for i in range(batch):
            obss.append(self.reset(seed=base_seed + i if base_seed > 0
                                   else None))
            datas.append(self.data)
            wins.append(self._fused_win_needed)
        self.batch_data = EpisodeData(*(torch.stack(x) for x in
                                        zip(*datas)))
        self.batch_obs = np.stack(obss)
        self._fused_win_needed = max(wins)
        return self.batch_obs

    def _batch_rand(self, rand):
        """``rand[B, T, L]`` as given, or B draws of ``draw_rand`` from a
        ``torch.Generator`` (or from the default one when None)."""
        if isinstance(rand, torch.Tensor):
            return rand
        B = int(self.batch_data.schedule.shape[0])
        return torch.stack([self.draw_rand(rand) for _ in range(B)])

    def episode_batch(self, actions, differentiable: bool,
                      rand=None) -> EpisodeResult:
        """The episodes of the scenario batch (``reset_batch``):
        ``actions[B, n_act]``, ``rand[B, T, L]`` or a ``torch.Generator``
        -> EpisodeResult with a leading B. With
        ``config["use_fused_episode"]`` the B episodes are one launch of
        the fused kernel K1 (forward; and one backward launch when
        differentiated); without it the eager scan env runs them one after
        another."""
        actions = torch.as_tensor(actions, dtype=torch.float32,
                                  device=self.device)
        rand = self._batch_rand(rand)
        bd = self.batch_data
        if self.config.get("use_fused_episode"):
            return self._fused_episode_one(differentiable)(actions, bd, rand)
        fn = self._episode_soft if differentiable else self._episode_hard
        return stack_results(
            fn(actions[b], EpisodeData(*(x[b] for x in bd)),
               self.base_state, rand[b]) for b in range(actions.shape[0]))

    def packed_episode_fn(self):
        """The JAX package's packed scenario batch: ``run(actions[B,
        n_act], rand[B, T, L]) -> EpisodeResult`` with per-episode
        ``reward[B]`` and ``queue_per_step[B, T]`` and pack totals of
        ``emitted``, ``absorbed``, ``injected``, ``max_wave_speed`` and
        ``events_per_step[T, 3]``, differentiable (soft or ``st`` gates).

        JAX packs the B episodes side by side in one kernel instance's lane
        axis. Here it is the same single batched launch as
        :meth:`episode_batch` (one block per episode, whatever
        ``use_fused_episode`` says): the B episodes keep their own running
        means, queue sums and events, and equal B single launches bit for
        bit. Like JAX's, ``run`` holds the batch data, emission pool and
        leader window of the ``reset_batch`` before it; a later
        ``reset_batch`` needs a new ``run``."""
        if getattr(self, "batch_data", None) is None:
            raise ValueError("call env.reset_batch(B) first")
        one = self._fused_episode_one(True)
        bd = self.batch_data

        def run(actions, rand):
            res = one(torch.as_tensor(actions, dtype=torch.float32,
                                      device=self.device), bd, rand)
            return res._replace(emitted=res.emitted.sum(),
                                absorbed=res.absorbed.sum(),
                                injected=res.injected.sum(),
                                max_wave_speed=res.max_wave_speed.amax(),
                                events_per_step=res.events_per_step.sum(0))

        return run
