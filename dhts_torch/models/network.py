"""Network state and the per-step orchestrator (port of
:mod:`dhts.models.network`).

Boundary resolution -> lane stepping -> hybrid conversion, each one masked
tensor op over the whole network. Vehicle containers are fixed-capacity
rows packed tail -> head: slot ``i`` is directly behind slot ``i + 1``, the
live slots are ``0..count-1`` and the head is slot ``count-1``. Inserts
happen only at the tail (shift right), removals only at the head (count
decrement).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from dhts_torch.models.scene import SceneSpec
from dhts_torch.models.vehicle import VehicleParams, default_params
from dhts_torch.ops import arz, dmath, idm

# virtual leader of a head vehicle with nothing ahead
DEFAULT_HEAD_POSITION_DELTA = 1000.0
DEFAULT_HEAD_SPEED_DELTA = 0.0


class MacroState(NamedTuple):
    """ARZ cells, external boundary cells and flux capacitors
    (``flux_capacitor[l, k]`` accumulates flux toward
    ``spec.next_lanes[l, k]``)."""

    r: torch.Tensor  # f32[L, C]
    y: torch.Tensor  # f32[L, C]
    ext_left_r: torch.Tensor  # f32[L]
    ext_left_u: torch.Tensor  # f32[L]
    ext_right_r: torch.Tensor  # f32[L]
    ext_right_u: torch.Tensor  # f32[L]
    flux_capacitor: torch.Tensor  # f32[L, K]


class MicroState(NamedTuple):
    """Fixed-capacity per-lane vehicle rows (tail -> head packing)."""

    position: torch.Tensor  # f32[L, V]
    speed: torch.Tensor  # f32[L, V]
    params: VehicleParams  # each f32[L, V]
    count: torch.Tensor  # i32[L]
    route: torch.Tensor  # i32[L, V, R] lane-id sequence, -1 padded
    route_idx: torch.Tensor  # i32[L, V] cursor into route
    vid: torch.Tensor  # i32[L, V] global vehicle id (-1 = none)

    @property
    def active(self):
        V = self.position.shape[-1]
        return (torch.arange(V, device=self.count.device) <
                self.count[..., None])


class NetworkState(NamedTuple):
    macro: MacroState
    micro: MicroState
    macro_next: torch.Tensor  # i32[L] MacroRoute next map (-1 = none)
    macro_prev: torch.Tensor  # i32[L]
    veh_counter: torch.Tensor  # i32 scalar: ids handed out so far
    route_pool: torch.Tensor  # i32[L, P, R] pre-drawn emission routes
    route_pool_cursor: torch.Tensor  # i32[L]


class StepDiagnostics(NamedTuple):
    max_wave_speed: torch.Tensor  # f32[L]
    num_collisions: torch.Tensor  # i32 scalar
    emitted: torch.Tensor  # i32 scalar
    absorbed: torch.Tensor  # i32 scalar


class BoundaryValues(NamedTuple):
    """Resolved per-step boundary inputs for every lane."""

    left_r: torch.Tensor  # f32[L] macro ghost cells
    left_u: torch.Tensor
    right_r: torch.Tensor
    right_u: torch.Tensor
    head_position_delta: torch.Tensor  # f32[L] micro virtual leader
    head_speed_delta: torch.Tensor


BoundaryFn = Callable[[SceneSpec, NetworkState, bool],
                      tuple[NetworkState, BoundaryValues]]


def tail_insert_rows(x, newval, mask):
    """Shift every slot of ``x[L, V, ...]`` up by one and write
    ``newval[L, ...]`` at slot 0, on the rows where ``mask[L]``."""
    shifted = torch.cat([newval[:, None, ...], x[:, :-1, ...]], dim=1)
    m = mask.reshape(mask.shape[:1] + (1,) * (x.dim() - 1))
    return torch.where(m, shifted, x)


def empty_state(spec: SceneSpec, max_vehicles_per_lane: int,
                max_route_length: int, route_pool) -> NetworkState:
    L, C = spec.num_lanes, spec.max_cells
    V, R = max_vehicles_per_lane, max_route_length
    dev = spec.device
    f = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    full_f = lambda v: torch.full((L,), v, dtype=torch.float32, device=dev)
    macro = MacroState(
        r=f(L, C), y=f(L, C), ext_left_r=f(L),
        ext_left_u=full_f(spec.speed_limit), ext_right_r=f(L),
        ext_right_u=full_f(spec.speed_limit),
        flux_capacitor=f(L, spec.next_lanes.shape[1]))
    micro = MicroState(
        position=f(L, V), speed=f(L, V),
        params=default_params(spec.speed_limit, (L, V), device=dev),
        count=torch.zeros((L,), dtype=torch.int32, device=dev),
        route=torch.full((L, V, R), -1, dtype=torch.int32, device=dev),
        route_idx=torch.zeros((L, V), dtype=torch.int32, device=dev),
        vid=torch.full((L, V), -1, dtype=torch.int32, device=dev))
    return NetworkState(
        macro=macro, micro=micro,
        macro_next=torch.full((L,), -1, dtype=torch.int32, device=dev),
        macro_prev=torch.full((L,), -1, dtype=torch.int32, device=dev),
        veh_counter=torch.zeros((), dtype=torch.int32, device=dev),
        route_pool=torch.as_tensor(route_pool, dtype=torch.int32,
                                   device=dev),
        route_pool_cursor=torch.zeros((L,), dtype=torch.int32, device=dev))


def _ar(n, device):
    return torch.arange(n, device=device)


# ---------------------------------------------------------------------------
# boundary resolution
# ---------------------------------------------------------------------------


def macro_cell_u(spec: SceneSpec, mac: MacroState):
    return arz.compute_u(mac.r, mac.y, spec.speed_limit)


def get_macro_boundary(spec: SceneSpec, state: NetworkState, left: bool,
                       u_all=None):
    """Neighbour-edge (density, speed) for every lane's left/right side:
    no neighbour -> the lane's external cell; one neighbour -> that
    neighbour; several -> the MacroRoute entry; a micro neighbour -> the
    external cell (its mass arrives through conversion events)."""
    mac = state.macro
    L = spec.num_lanes
    if u_all is None:
        u_all = macro_cell_u(spec, mac)
    if left:
        num_adj, adj_list, routed = spec.num_prev, spec.prev_lanes, \
            state.macro_prev
        ext_r, ext_u = mac.ext_left_r, mac.ext_left_u
    else:
        num_adj, adj_list, routed = spec.num_next, spec.next_lanes, \
            state.macro_next
        ext_r, ext_u = mac.ext_right_r, mac.ext_right_u

    adj = torch.where(num_adj == 1, adj_list[:, 0], routed)
    adj_c = torch.clamp(adj, 0, L - 1).long()
    adj_macro = (adj >= 0) & spec.is_macro[adj_c]
    # the left side peeks the neighbour's LAST cell, the right its FIRST
    if left:
        cell_idx = torch.clamp(spec.num_cell[adj_c] - 1, min=0).long()
    else:
        cell_idx = torch.zeros((L,), dtype=torch.long, device=adj.device)
    nb_r = mac.r[adj_c, cell_idx]
    nb_u = u_all[adj_c, cell_idx]
    use_nb = (num_adj > 0) & adj_macro
    return torch.where(use_nb, nb_r, ext_r), torch.where(use_nb, nb_u, ext_u)


def _route_next_lane(mic: MicroState):
    """Each vehicle's next lane id along its route (-1 at route end)."""
    R = mic.route.shape[2]
    idx = torch.clamp(mic.route_idx + 1, 0, R - 1).long()
    nxt = torch.gather(mic.route, 2, idx[..., None])[..., 0]
    return torch.where(mic.route_idx + 1 < R, nxt, torch.full_like(nxt, -1))


def _route_prev_lane(mic: MicroState):
    idx = torch.clamp(mic.route_idx - 1, min=0).long()
    prv = torch.gather(mic.route, 2, idx[..., None])[..., 0]
    return torch.where(mic.route_idx > 0, prv, torch.full_like(prv, -1))


def micro_lane_macro_state(spec: SceneSpec, state: NetworkState,
                           differentiable: bool):
    """Aggregate (density, speed) view of every micro lane: vehicles on the
    lane, on micro prev-lanes routed here and on micro next-lanes routed
    from here contribute membership x (length / lane length) to density and
    membership-weighted speed."""
    mic = state.micro
    L, V = mic.position.shape
    lane_len = spec.length[:, None]

    def membership(pos, length_of_lane):
        if differentiable:
            return dmath.soft_sigmoid(pos, 16.0) * dmath.soft_sigmoid(
                length_of_lane - pos, 16.0)
        return ((pos >= 0) & (pos <= length_of_lane)).to(torch.float32)

    act = mic.active.to(torch.float32)
    mem = membership(mic.position, lane_len) * act
    density = torch.sum(mem * mic.params.length / lane_len, dim=1)
    speed_sum = torch.sum(mem * mic.speed, dim=1)
    weight = torch.sum(mem, dim=1)

    ar = _ar(L, mic.count.device)
    nxt_of = _route_next_lane(mic)
    for adj_k in range(spec.prev_lanes.shape[1]):
        p = spec.prev_lanes[:, adj_k]
        pc = torch.clamp(p, 0, L - 1).long()
        ok = (p >= 0) & ~spec.is_macro[pc]
        vpos = -(spec.length[pc][:, None] - mic.position[pc])
        sel = (nxt_of[pc] == ar[:, None]) & mic.active[pc] & ok[:, None]
        mem = membership(vpos, lane_len) * sel.to(torch.float32)
        density = density + torch.sum(mem * mic.params.length[pc] / lane_len,
                                      dim=1)
        speed_sum = speed_sum + torch.sum(mem * mic.speed[pc], dim=1)
        weight = weight + torch.sum(mem, dim=1)

    prv_of = _route_prev_lane(mic)
    for adj_k in range(spec.next_lanes.shape[1]):
        nx = spec.next_lanes[:, adj_k]
        nc = torch.clamp(nx, 0, L - 1).long()
        ok = (nx >= 0) & ~spec.is_macro[nc]
        vpos = spec.length[:, None] + mic.position[nc]
        sel = (prv_of[nc] == ar[:, None]) & mic.active[nc] & ok[:, None]
        mem = membership(vpos, lane_len) * sel.to(torch.float32)
        density = density + torch.sum(mem * mic.params.length[nc] / lane_len,
                                      dim=1)
        speed_sum = speed_sum + torch.sum(mem * mic.speed[nc], dim=1)
        weight = weight + torch.sum(mem, dim=1)

    density = dmath.minimum(density, 1.0)
    speed = torch.where(weight > 0,
                        speed_sum / dmath.maximum(weight, 1e-12),
                        torch.full_like(weight, spec.speed_limit))
    return density, speed


def micro_head_info(spec: SceneSpec, state: NetworkState):
    """Per-lane head-vehicle fields (valid where count > 0; an empty lane
    reads slot 0, which keeps masked-out values finite)."""
    mic = state.micro
    L, V = mic.position.shape
    ar = _ar(L, mic.count.device)
    h = torch.clamp(mic.count - 1, 0, V - 1).long()
    return dict(
        exists=mic.count > 0, slot=h, position=mic.position[ar, h],
        speed=mic.speed[ar, h], length=mic.params.length[ar, h],
        a=mic.params.a[ar, h], route=mic.route[ar, h],
        route_idx=mic.route_idx[ar, h])


def find_micro_leader(spec: SceneSpec, state: NetworkState):
    """Route-walking virtual leader for every micro lane at once.

    From the head vehicle, walk its route: an occupied micro lane ends the
    walk with that lane's tail vehicle as leader; a macro lane or the route
    end ends it with the default virtual leader; an empty micro lane adds its
    length and the walk goes on. The whole window is gathered at once and
    the first terminating entry found with ``argmax``. The distance crossed
    is summed in float64 (exact for these few lengths) and rounded once, so
    it does not depend on the order of the additions.
    """
    mic = state.micro
    L, V = mic.position.shape
    R = mic.route.shape[2]
    dev = mic.count.device
    ar = _ar(L, dev)
    head = micro_head_info(spec, state)

    offs = torch.arange(1, R, device=dev)
    j = head["route_idx"][:, None] + offs[None, :]  # [L, W]
    in_route = j < R
    w = torch.gather(head["route"], 1, torch.clamp(j, 0, R - 1).long())
    w = torch.where(in_route, w, torch.full_like(w, -1))
    exists = w >= 0
    wc = torch.clamp(w, 0, L - 1).long()
    w_macro = exists & spec.is_macro[wc]
    occupied = exists & ~spec.is_macro[wc] & (mic.count[wc] > 0)

    term = ~exists | w_macro | occupied
    any_term = torch.any(term, dim=1)
    first = torch.argmax(term.to(torch.int32), dim=1)  # [L]

    pass_len = torch.where(exists & ~term, spec.length[wc],
                           torch.zeros((), device=dev))
    cum = torch.cumsum(pass_len.to(torch.float64), dim=1) - pass_len.to(
        torch.float64)
    cum_first = cum[ar, first].to(torch.float32)
    cur_delta = (spec.length - head["position"] - head["length"] * 0.5 +
                 cum_first)

    lead_lane = wc[ar, first]
    leader_found = head["exists"] & any_term & occupied[ar, first]
    tail_pos = mic.position[lead_lane, 0]
    tail_vel = mic.speed[lead_lane, 0]
    tail_len = mic.params.length[lead_lane, 0]

    pd = torch.where(leader_found,
                     dmath.maximum(cur_delta + tail_pos - tail_len * 0.5,
                                   0.0),
                     torch.full_like(tail_pos, DEFAULT_HEAD_POSITION_DELTA))
    sd = torch.where(leader_found, head["speed"] - tail_vel,
                     torch.full_like(tail_pos, DEFAULT_HEAD_SPEED_DELTA))
    return pd, sd


def default_boundary(spec: SceneSpec, state: NetworkState,
                     differentiable: bool):
    """Macro ghost cells from neighbours / external cells and micro virtual
    leaders from the route walk."""
    u_all = macro_cell_u(spec, state.macro)
    left_r, left_u = get_macro_boundary(spec, state, left=True, u_all=u_all)
    right_r, right_u = get_macro_boundary(spec, state, left=False,
                                          u_all=u_all)
    pd, sd = find_micro_leader(spec, state)
    return state, BoundaryValues(left_r=left_r, left_u=left_u,
                                 right_r=right_r, right_u=right_u,
                                 head_position_delta=pd, head_speed_delta=sd)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def lanes_forward(spec: SceneSpec, state: NetworkState, bv: BoundaryValues,
                  delta_time, skip_micro: bool = False):
    """Advance every lane once. Each macro lane's unused cells are padded
    with its right ghost, so one Godunov update covers lanes of any cell
    count; ``skip_micro`` elides the IDM step for all-macro scenes."""
    mac, mic = state.macro, state.micro

    right_y = arz.compute_y(bv.right_r, bv.right_u, spec.speed_limit)
    r_pad = torch.where(spec.cell_mask, mac.r, bv.right_r[:, None])
    y_pad = torch.where(spec.cell_mask, mac.y, right_y[:, None])
    res = arz.godunov_step(r_pad, y_pad, bv.left_r, bv.left_u, bv.right_r,
                           bv.right_u, spec.speed_limit, delta_time,
                           spec.cell_length)
    keep = spec.cell_mask & spec.is_macro[:, None]
    new_r = torch.where(keep, res.r, mac.r)
    new_y = torch.where(keep, res.y, mac.y)
    max_wave = torch.where(spec.is_macro, res.max_wave_speed,
                           torch.zeros_like(res.max_wave_speed))

    if skip_micro:
        state = state._replace(macro=mac._replace(r=new_r, y=new_y))
        return state, max_wave, torch.zeros((), dtype=torch.int32,
                                            device=new_r.device)

    p = mic.params
    mres = idm.micro_lane_step(
        mic.position, mic.speed, accel_max=p.accel_max,
        accel_pref=p.accel_pref, target_speed=p.target_speed,
        min_space=p.min_space, time_pref=p.time_pref, length=p.length,
        head_position_delta=bv.head_position_delta,
        head_speed_delta=bv.head_speed_delta, active=mic.active,
        delta_time=delta_time)
    state = state._replace(
        macro=mac._replace(r=new_r, y=new_y),
        micro=mic._replace(position=mres.position, speed=mres.speed))
    return state, max_wave, torch.sum(mres.collided.to(torch.int32))


def network_step(spec: SceneSpec, state: NetworkState, delta_time: float,
                 differentiable: bool,
                 boundary_fn: Optional[BoundaryFn] = None):
    """One full step: boundary -> lane forward -> conversion. Returns
    ``(new_state, StepDiagnostics)``."""
    from dhts_torch.models import conversion

    bfn = boundary_fn or default_boundary
    state, bv = bfn(spec, state, differentiable)
    state, max_wave, n_coll = lanes_forward(spec, state, bv, delta_time)
    state, emitted, absorbed = conversion.apply(spec, state, delta_time)
    return state, StepDiagnostics(max_wave_speed=max_wave,
                                  num_collisions=n_coll, emitted=emitted,
                                  absorbed=absorbed)
