"""Hybrid macro<->micro coupling as masked dense events (port of
:mod:`dhts.models.conversion`).

* macro -> micro (emission): a macro lane whose MacroRoute successor is micro
  accumulates ``r_last * u_last * dt`` in a flux capacitor; at one vehicle
  length, with free entering space, it emits a vehicle at position 0. The
  emitted vehicle's ancillary mass ``a`` carries the capacitor's gradient and
  the capacitor is decremented detached.
* micro -> macro (absorption): a head vehicle one length past its lane end
  deposits ``a / length`` into the overlapping leading cells of its macro
  successor (straight-through density clamp; cell speed = vehicle speed).
* micro -> micro (transfer): a head past the lane end moves to the
  successor's tail with position reduced by the lane length.
* micro -> none: past the end with no successor, the vehicle leaves.

Inserts and deposits are arbitrated to one per destination per step; among
the predecessors that want in, the lowest source lane id wins and the others
retry next step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dhts_torch.models import network as net
from dhts_torch.models.scene import SceneSpec
from dhts_torch.models.vehicle import default_params
from dhts_torch.ops import arz
from dhts_torch.ops.dmath import detached, grad_carrier, st_clip


class ConversionEvents(NamedTuple):
    """Per-step event counts (int32 scalars) of one conversion pass."""

    emitted: torch.Tensor
    absorbed: torch.Tensor  # exits with no successor + won deposits
    transferred: torch.Tensor  # micro -> micro inserts at destinations
    transfer_wins: torch.Tensor  # sources whose transfer won arbitration
    deposit_wins: torch.Tensor
    removals: torch.Tensor  # head pops


def apply(spec: SceneSpec, state: "net.NetworkState", delta_time):
    """Run the conversion pass; returns ``(state, emitted, absorbed)``."""
    state, ev = apply_with_events(spec, state, delta_time)
    return state, ev.emitted, ev.absorbed


def apply_with_events(spec: SceneSpec, state: "net.NetworkState",
                      delta_time):
    """The conversion pass; returns ``(state, ConversionEvents)``."""
    mac, mic = state.macro, state.micro
    L, C = spec.num_lanes, spec.max_cells
    V = mic.position.shape[1]
    R = mic.route.shape[2]
    P = state.route_pool.shape[1]
    dev = mic.count.device
    ar = torch.arange(L, device=dev)
    INF = L
    veh_len = spec.vehicle_length
    i32 = lambda m: m.to(torch.int32)
    u_all = net.macro_cell_u(spec, mac)

    # ---------------- 1. flux-capacitor accumulation (macro sources) -----
    mn = state.macro_next
    mn_c = torch.clamp(mn, 0, L - 1).long()
    macro_src = spec.is_macro & (mn >= 0)
    next_is_micro = macro_src & ~spec.is_macro[mn_c]
    last = torch.clamp(spec.num_cell - 1, 0, C - 1).long()
    r_last = mac.r[ar, last]
    u_last = u_all[ar, last]
    inc = torch.where(next_is_micro, r_last * u_last * delta_time,
                      torch.zeros_like(r_last))
    # capacitor slot k of the routed successor in the adjacency list
    slot = torch.argmax(i32(spec.next_lanes == mn[:, None]), dim=1)
    cap_val = mac.flux_capacitor[ar, slot] + inc

    # ---------------- 2. emission requests -------------------------------
    dest_count = mic.count[mn_c]
    free_space = torch.where(dest_count > 0,
                             mic.position[mn_c, 0] -
                             0.5 * mic.params.length[mn_c, 0],
                             spec.length[mn_c])
    want_emit = (next_is_micro & (detached(cap_val) >= veh_len) &
                 (free_space >= veh_len) & (dest_count < V))

    # ---------------- 3. micro head-exit requests -------------------------
    head = net.micro_head_info(spec, state)
    h_exists = head["exists"]
    j = torch.clamp(head["route_idx"] + 1, 0, R - 1).long()
    hnext = head["route"][ar, j]
    hnext = torch.where(head["route_idx"] + 1 < R, hnext,
                        torch.full_like(hnext, -1))
    hn_c = torch.clamp(hnext, 0, L - 1).long()

    past_end = h_exists & (head["position"] >= spec.length)
    exit_none = past_end & (hnext < 0)
    nxt_micro = (hnext >= 0) & ~spec.is_macro[hn_c]
    nxt_macro = (hnext >= 0) & spec.is_macro[hn_c]
    want_transfer = past_end & nxt_micro & (mic.count[hn_c] < V)
    # absorption waits until the vehicle is a full length past the end
    want_deposit = (h_exists & nxt_macro &
                    (head["position"] > spec.length + head["length"]))

    # ---------------- 4. arbitration: one insert per destination ----------
    # every insert source is a graph predecessor of its destination, so the
    # winner is the lowest id among each lane's predecessors that want in
    prev = spec.prev_lanes  # [L, K]
    pc = torch.clamp(prev, 0, L - 1).long()
    prev_valid = prev >= 0
    inf = torch.full_like(pc, INF)
    cand_emit = prev_valid & want_emit[pc] & (mn_c[pc] == ar[:, None])
    cand_tr = prev_valid & want_transfer[pc] & (hn_c[pc] == ar[:, None])
    best = torch.amin(torch.where(cand_emit | cand_tr, pc, inf), dim=1)
    emit_win = want_emit & (best[mn_c] == ar)
    tr_win = want_transfer & (best[hn_c] == ar)

    cand_dep = prev_valid & want_deposit[pc] & (hn_c[pc] == ar[:, None])
    dep_best = torch.amin(torch.where(cand_dep, pc, inf), dim=1)
    dep_win = want_deposit & (dep_best[hn_c] == ar)

    # ---------------- 5. removals (head pops) ----------------------------
    remove = exit_none | dep_win | tr_win
    count_after_remove = mic.count - i32(remove)

    # ---------------- 6. capacitor decrement on emission ------------------
    cap_after = torch.where(emit_win, detached(cap_val - veh_len), cap_val)
    onehot = torch.arange(mac.flux_capacitor.shape[1],
                          device=dev)[None, :] == slot[:, None]
    cap = torch.where(onehot, cap_after[:, None], mac.flux_capacitor)

    # ---------------- 7. inserts (tail pushes) ----------------------------
    has_insert = best < INF
    src = torch.clamp(best, 0, L - 1)
    is_emit = has_insert & spec.is_macro[src]  # else it is a transfer
    src_slot = head["slot"][src]
    g = lambda x: x[src, src_slot]  # a [L, V] field at the source heads

    defaults = default_params(spec.speed_limit, (L,), veh_len, device=dev)
    emit_a = grad_carrier(torch.full((L,), veh_len, dtype=torch.float32,
                                     device=dev), cap_val)[src]
    new_pos = torch.where(is_emit, torch.zeros_like(r_last),
                          head["position"][src] - spec.length[src])
    new_vel = torch.where(is_emit, u_last[src], head["speed"][src])
    new_params = defaults.zip_map(
        lambda dflt, srcf: torch.where(is_emit, dflt, g(srcf)), mic.params)
    new_params = new_params._replace(
        a=torch.where(is_emit, emit_a, g(mic.params.a)))

    # emission pops the destination lane's pre-drawn pool; a transfer
    # carries the vehicle's route with the cursor advanced
    pool_idx = (state.route_pool_cursor % P).long()
    pooled_route = state.route_pool[ar, pool_idx]  # [L, R]
    new_route = torch.where(is_emit[:, None], pooled_route,
                            mic.route[src, src_slot])
    new_route_idx = torch.where(is_emit, torch.zeros_like(mic.count),
                                mic.route_idx[src, src_slot] + 1)

    n_emit = torch.sum(i32(is_emit))
    emit_rank = torch.cumsum(i32(is_emit), dim=0) - 1
    new_vid = torch.where(is_emit, (state.veh_counter + emit_rank).to(
        torch.int32), mic.vid[src, src_slot])

    def tail_insert(x, newval):
        return net.tail_insert_rows(x, newval, has_insert)

    micro = mic._replace(
        position=tail_insert(mic.position, new_pos),
        speed=tail_insert(mic.speed, new_vel),
        params=mic.params.zip_map(tail_insert, new_params),
        route=tail_insert(mic.route, new_route),
        route_idx=tail_insert(mic.route_idx, new_route_idx),
        vid=tail_insert(mic.vid, new_vid),
        count=count_after_remove + i32(has_insert))
    cursor = state.route_pool_cursor + i32(is_emit)

    # ---------------- 8. micro -> macro mass deposits ---------------------
    dep_has = dep_best < INF
    s = torch.clamp(dep_best, 0, L - 1)  # winning source per destination
    v_head = head["position"][s] - spec.length[s]
    v_tail = v_head - head["length"][s]
    cells = torch.arange(C, dtype=torch.float32, device=dev)
    cl = spec.cell_length[:, None]
    c_tail = cells[None, :] * cl
    c_head = (cells[None, :] + 1.0) * cl
    overlap_cells = ((c_head > v_tail[:, None]) & (c_tail < v_head[:, None]) &
                     spec.cell_mask & dep_has[:, None])
    # cells are scanned from 0 and the scan stops at the first gap
    overlap_cells = overlap_cells & (spec.cell_length > v_tail)[:, None]
    max_head = torch.maximum(c_head, v_head[:, None])
    min_tail = torch.minimum(c_tail, v_tail[:, None])
    overlap = cl + head["length"][s][:, None] - (max_head - min_tail)
    add_r = (head["a"][s][:, None] / detached(head["length"][s])[:, None] *
             (overlap / cl))
    n_r = st_clip(mac.r + add_r, 1e-5, 1.0 - 1e-5)
    dep_u = head["speed"][s][:, None].expand(L, C)
    new_r = torch.where(overlap_cells, n_r, mac.r)
    new_y = torch.where(overlap_cells,
                        arz.compute_y(n_r, dep_u, spec.speed_limit), mac.y)

    macro = mac._replace(r=new_r, y=new_y, flux_capacitor=cap)
    state = state._replace(macro=macro, micro=micro,
                           veh_counter=state.veh_counter + n_emit,
                           route_pool_cursor=cursor)
    ev = ConversionEvents(
        emitted=n_emit,
        absorbed=torch.sum(i32(exit_none | dep_win)),
        transferred=torch.sum(i32(has_insert & ~is_emit)),
        transfer_wins=torch.sum(i32(tr_win)),
        deposit_wins=torch.sum(i32(dep_win)),
        removals=torch.sum(i32(remove)))
    return state, ev
