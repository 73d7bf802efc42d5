// The per-lane phases of one ITSCP hybrid simulation step, shared by the
// fused episode (itscp_hybrid_episode.cu, kernel K1: the whole episode in
// one block, its state in shared memory) and the fused spatial step
// (itscp_spatial_step.cu: one step per launch, the carry in global memory).
// The all-macro episode (itscp_macro_episode.cu, kernel K4) runs the macro
// phases in soft mode: signal, edges, ghosts, Godunov, the static partials
// and the lane queue.
// Each thread runs one lane; a phase reads other lanes only through the
// block's per-lane summaries (`Sm`, a kernel's shared-memory struct with the
// fields used here), so the kernel puts a __syncthreads() between phases.
//
// The network state is addressed through LaneState<S, F, PV>: the float
// fields are S* (K1: values, or dual numbers, in shared memory,
// lane-major) or FA (the spatial step: a value row and a tangent row in
// global memory, lane-minor); strides give cell c, vehicle v and capacitor
// slot q of lane l. The spatial step carries per-vehicle IDM parameters
// and lengths (PV, and the heads' in the summaries hs_par, hs_len); K1's
// vehicles are all the default vehicle, a compile-time choice that keeps
// K1's per-vehicle work what it was.
//
// What differs between the two kernels stays in each: the leader walk,
// the micro blend with its running mean, the static running mean's fold,
// and the block reductions, which each repeat their own plain version.
#pragma once

// every clamp keeps a NaN, as the plain versions' (dhts_scalar.cuh)
#define DHTS_KEEP_NAN
#include "dhts_scalar.cuh"

namespace {

constexpr int MAXC = 16;  // cells per macro lane held in registers
constexpr int HARD = 0, SOFT = 1, ST = 2;  // gate modes
constexpr int W_EMIT = 1, W_TRANSFER = 2, W_DEPOSIT = 4;  // want bits

struct Consts {
  float u_max, dt, veh_len, static_speed;
  float rare_den;  // (GAMMA + 1) * u_max, rounded once from double
  float third;     // GAMMA / (GAMMA + 1), rounded once from double
  float amax, apref, tgt, min_space, time_pref;  // default vehicle
  float rho_hi;    // 1 - 1e-5, rounded once from double
  float gate32;    // 32 * soft_gate_scale, rounded once from double
};

struct Dims {
  int T, L, C, V, R, P, P2, K, W, nsf, n_phases, n_inter, mode;
};

// ---------------------------------------------------------------------------
// straight-through gates
// ---------------------------------------------------------------------------

// straight-through value: soft + (hard - soft), the soft gate's tangent
__device__ __forceinline__ float st_value(float soft, float hard) {
  return soft + (hard - soft);
}
__device__ __forceinline__ Dual st_value(Dual soft, float hard) {
  return Dual(soft.v + (hard - soft.v), soft.d);
}
// straight-through gate (env `stg`): the soft value in soft mode
template <class S>
__device__ __forceinline__ S stg(bool hard, S soft_val, int mode) {
  return mode == ST ? st_value(soft_val, hard ? 1.0f : 0.0f) : soft_val;
}

// a soft gate's sharpness from a detached running mean, num / max(|mean|,
// 1e-6): NaN for a NaN mean, as jnp.maximum and torch.maximum keep it
__device__ __forceinline__ float sharpness(float num, float mean) {
  return num / max_of(fabsf(mean), 1e-6f);
}

// ---------------------------------------------------------------------------
// scene and state access
// ---------------------------------------------------------------------------

// entry j of the route with id `rid` (-1 for no route / out of range):
// ids below L * P are rows of the waiting pools, the rest of the emission
// pools
__device__ __forceinline__ int route_at(const int* __restrict__ inj,
                                        const int* __restrict__ emit,
                                        int rid, int j, const Dims& d) {
  if (rid < 0 || j < 0 || j >= d.R) return -1;
  const int n_inj = d.L * d.P;
  return rid < n_inj ? inj[rid * d.R + j] : emit[(rid - n_inj) * d.R + j];
}

// the static tables: lane_i rows is_macro, num_cell, approaching, is_we,
// inter, has_prev, num_prev, num_next, prev[K], next[K]; lane_f rows
// length, cell_length; the route pools
struct Scene {
  const int* lane_i;
  const float* lane_f;
  const int* inj;
  const int* emit;
  __device__ bool macro_at(int j) const { return lane_i[j] != 0; }
  __device__ float length_at(int j) const { return lane_f[j]; }
};

struct LaneGeom {
  int is_macro = 0, num_cell = 0, approaching = 0, is_we = 0, inter = 0;
  int has_prev = 0, num_prev = 0, num_next = 0, prev0 = -1, next0 = -1;
  float length = 1.0f, cell_len = 1.0f;
};

__device__ __forceinline__ LaneGeom lane_geom(const Scene& sc, int L, int K,
                                              int l) {
  const int* li = sc.lane_i;
  LaneGeom g;
  g.is_macro = li[0 * L + l]; g.num_cell = li[1 * L + l];
  g.approaching = li[2 * L + l]; g.is_we = li[3 * L + l];
  g.inter = li[4 * L + l]; g.has_prev = li[5 * L + l];
  g.num_prev = li[6 * L + l]; g.num_next = li[7 * L + l];
  g.prev0 = li[8 * L + l]; g.next0 = li[(8 + K) * L + l];
  g.length = sc.lane_f[0 * L + l]; g.cell_len = sc.lane_f[1 * L + l];
  return g;
}

// a float field of the spatial step's carry: values, and tangents in the
// derivative
struct FA {
  float* v;
  float* d;
};
template <class S>
__device__ __forceinline__ S ld(const S* a, int i) {
  return a[i];
}
template <class S>
__device__ __forceinline__ S ld(const FA& a, int i);
template <>
__device__ __forceinline__ float ld<float>(const FA& a, int i) {
  return a.v[i];
}
template <>
__device__ __forceinline__ Dual ld<Dual>(const FA& a, int i) {
  return Dual(a.v[i], a.d[i]);
}
template <class S>
__device__ __forceinline__ void put(S* a, int i, S x) {
  a[i] = x;
}
__device__ __forceinline__ void put(const FA& a, int i, float x) {
  a.v[i] = x;
}
__device__ __forceinline__ void put(const FA& a, int i, Dual x) {
  a.v[i] = x.v;
  a.d[i] = x.d;
}

// The network state: cells r, y; vehicles pos, vel, av (mass), IDM
// parameters and lengths, route id and index; per-lane vehicle counts,
// waiting-pool and emission-pool cursors; flux capacitors.
template <class S, class F, bool PV>
struct LaneState {
  static constexpr bool per_vehicle = PV;
  F r, y, pos, vel, av, cap;
  float* par[6];  // PV: amax, apref, tgt, min_space, time_pref, length
  int *rid, *ridx, *count, *inj_left, *cursor;
  int cl, cc;  // cell c of lane l at l * cl + c * cc
  int vl, vv;  // vehicle v of lane l at l * vl + v * vv
  int kl, kq;  // capacitor slot q of lane l at l * kl + q * kq
  float dflt[6];   // the default vehicle's parameters and length
  float dflt_den;  // its 2 * sqrt(amax * apref)

  __device__ int ci(int l, int c) const { return l * cl + c * cc; }
  __device__ int vi(int l, int v) const { return l * vl + v * vv; }
  __device__ int ki(int l, int q) const { return l * kl + q * kq; }
  __device__ float param(int q, int i) const {
    if constexpr (PV) return par[q][i];
    else return dflt[q];
  }
  __device__ float idm_den(int i) const {
    if constexpr (PV) return 2.0f * sqrtf(par[0][i] * par[1][i]);
    else return dflt_den;
  }
  // shift lane l's vehicles up one slot and put a new tail in slot 0
  // (npar null: the default vehicle)
  __device__ void insert_tail(int l, int V, S npos, S nvel, S na,
                              const float* npar, int nrid, int nridx) {
    for (int v = V - 1; v > 0; --v) {
      const int i = vi(l, v), j = vi(l, v - 1);
      put(pos, i, ld<S>(pos, j));
      put(vel, i, ld<S>(vel, j));
      put(av, i, ld<S>(av, j));
      if constexpr (PV)
        for (int q = 0; q < 6; ++q) par[q][i] = par[q][j];
      rid[i] = rid[j];
      ridx[i] = ridx[j];
    }
    const int i = vi(l, 0);
    put(pos, i, npos); put(vel, i, nvel); put(av, i, na);
    if constexpr (PV)
      for (int q = 0; q < 6; ++q) par[q][i] = npar ? npar[q] : dflt[q];
    rid[i] = nrid;
    ridx[i] = nridx;
  }
};

template <class S, class F, bool PV>
__device__ __forceinline__ void set_defaults(LaneState<S, F, PV>& st,
                                             const Consts& k) {
  const float d[6] = {k.amax, k.apref, k.tgt, k.min_space, k.time_pref,
                      k.veh_len};
  for (int q = 0; q < 6; ++q) st.dflt[q] = d[q];
  st.dflt_den = 2.0f * sqrtf(k.amax * k.apref);
}

// ---------------------------------------------------------------------------
// A: signal, injection, edge cells
// ---------------------------------------------------------------------------

// this lane's signal at step t (1 where no signal controls the lane); a
// derivative block seeds action entry `seed`
template <class S>
__device__ __forceinline__ S lane_signal(const float* action,
                                         const float* prog, const Dims& d,
                                         const Consts& k, const LaneGeom& g,
                                         int t, int seed) {
  const int phase = min(t / d.nsf, d.n_phases - 1);
  const int ai = phase * d.n_inter + g.inter;
  const S a = action_at<S>(action[ai], ai == seed);
  const float progress = prog[t % d.nsf];
  const bool hard_g = g.is_we ? (val(a) > progress) : (progress > val(a));
  S gate;
  if (d.mode == HARD) {
    gate = hard_g ? 1.0f : 0.0f;
  } else {
    gate = stg(hard_g, soft(g.is_we ? a - S(progress) : S(progress) - a,
                            k.gate32), d.mode);
  }
  return g.approaching ? gate : S(1.0f);
}

// a vehicle of the waiting pool enters a source micro lane with room at
// its entry, when the draw is below the schedule; returns whether it did
template <class S, class St>
__device__ __forceinline__ bool inject(St& st, const LaneGeom& g,
                                       const Dims& d, const Consts& k, int l,
                                       float draw, float incoming) {
  if (g.has_prev || g.is_macro) return false;
  const int n = st.count[l];
  const int i0 = st.vi(l, 0);
  const float free_sp =
      n > 0 ? val(ld<S>(st.pos, i0)) - 0.5f * st.param(5, i0) : g.length;
  if (!((free_sp > 0.5f * k.veh_len) && (draw < incoming) &&
        (st.inj_left[l] > 0) && (n < d.V)))
    return false;
  const int pool_idx = min(max(d.P - st.inj_left[l], 0), d.P - 1);
  st.insert_tail(l, d.V, S(0.0f), S(0.0f), S(k.veh_len), nullptr,
                 l * d.P + pool_idx, 0);
  st.count[l] = n + 1;
  st.inj_left[l] -= 1;
  return true;
}

// the lane's first and last cells, which neighbours read as ghosts
template <class S, class St, class Sm>
__device__ __forceinline__ void publish_edges(const St& st, Sm& s, int l,
                                              int last, float u_max) {
  const S rf = ld<S>(st.r, st.ci(l, 0)), rl = ld<S>(st.r, st.ci(l, last));
  s.r_first[l] = rf;
  s.u_first[l] = comp_u(rf, ld<S>(st.y, st.ci(l, 0)), u_max);
  s.r_last[l] = rl;
  s.u_last[l] = comp_u(rl, ld<S>(st.y, st.ci(l, last)), u_max);
}

// ---------------------------------------------------------------------------
// B, C: ghost cells and physics
// ---------------------------------------------------------------------------

template <class S>
struct Ghosts {
  S bl_r, bl_u, br_r, br_u;
};

// left ghost: the upstream neighbour's last cell behind its signal (the
// schedule on a source lane); right ghost: the downstream neighbour's
// first cell, or a red wall
template <class S, class Sm>
__device__ __forceinline__ Ghosts<S> ghosts(const Sm& s, const Scene& sc,
                                            const LaneGeom& g, int L, int l,
                                            int mp, int mn, float incoming,
                                            int mode, const Consts& k) {
  auto clampL = [&](int j) { return min(max(j, 0), L - 1); };
  const float u_max = k.u_max;
  const int adjp = g.num_prev == 1 ? g.prev0 : mp;
  const int adjp_c = clampL(adjp);
  const bool use_l = (g.num_prev > 0) && (adjp >= 0) && sc.macro_at(adjp_c);
  S gl_r = use_l ? s.r_last[adjp_c] : S(0.0f);
  S gl_u = use_l ? s.u_last[adjp_c] : S(u_max);
  if (!g.has_prev) { gl_r = incoming; gl_u = u_eq(S(incoming), u_max); }
  const S prev_sig = !g.has_prev ? S(1.0f)
                                 : (mp < 0 ? S(0.0f) : s.sig[clampL(mp)]);
  Ghosts<S> o;
  o.bl_r = gl_r * prev_sig;
  o.bl_u = gl_u * prev_sig + S(u_max) * (S(1.0f) - prev_sig);
  const int adjn = g.num_next == 1 ? g.next0 : mn;
  const int adjn_c = clampL(adjn);
  const bool use_r = (g.num_next > 0) && (adjn >= 0) && sc.macro_at(adjn_c);
  const S gr_r = use_r ? s.r_first[adjn_c] : S(0.0f);
  const S gr_u = use_r ? s.u_first[adjn_c] : S(u_max);
  const S sig_l = s.sig[l];
  S sg;
  if (mode == HARD) {
    sg = val(sig_l) > 0.5f ? 1.0f : 0.0f;
  } else {
    sg = stg(val(sig_l) > 0.5f, soft(sig_l - S(0.5f), k.gate32), mode);
  }
  o.br_r = gr_r * sg + S(1.0f) * (S(1.0f) - sg);
  o.br_u = gr_u * sg;
  return o;
}

// Godunov update of a macro lane between its ghosts, in place; returns the
// lane's largest wave speed
template <class S, class St>
__device__ __forceinline__ float godunov_lane(St& st, const LaneGeom& g,
                                              int l, int C,
                                              const Ghosts<S>& gh,
                                              const Consts& k) {
  const float u_max = k.u_max;
  const S right_y = comp_y(gh.br_r, gh.br_u, u_max);
  const S left_y = comp_y(gh.bl_r, gh.bl_u, u_max);
  S rp[MAXC], yp[MAXC], up[MAXC];
  for (int c = 0; c < C; ++c) {
    rp[c] = c < g.num_cell ? ld<S>(st.r, st.ci(l, c)) : gh.br_r;
    yp[c] = c < g.num_cell ? ld<S>(st.y, st.ci(l, c)) : right_y;
    up[c] = comp_u(rp[c], yp[c], u_max);
  }
  const float coeff = k.dt / g.cell_len;
  float lane_wave = 0.0f;
  S fr_prev = 0.f, fy_prev = 0.f;
  for (int i = 0; i <= C; ++i) {
    S fr, fy;
    float wave;
    if (i == 0)
      riemann(gh.bl_r, left_y, gh.bl_u, rp[0], up[0], u_max, k.rare_den,
              k.third, fr, fy, wave);
    else if (i == C)
      riemann(rp[C - 1], yp[C - 1], up[C - 1], gh.br_r, gh.br_u, u_max,
              k.rare_den, k.third, fr, fy, wave);
    else
      riemann(rp[i - 1], yp[i - 1], up[i - 1], rp[i], up[i], u_max,
              k.rare_den, k.third, fr, fy, wave);
    lane_wave = i == 0 ? wave : max_of(lane_wave, wave);
    if (i > 0 && i - 1 < g.num_cell) {
      put(st.r, st.ci(l, i - 1), rp[i - 1] + (fr_prev - fr) * S(coeff));
      put(st.y, st.ci(l, i - 1), yp[i - 1] + (fy_prev - fy) * S(coeff));
    }
    fr_prev = fr; fy_prev = fy;
  }
  return lane_wave;
}

// IDM + Euler update of a micro lane's vehicles; the head follows the gap
// `hpd` and speed difference `hsd` to its (virtual) leader
template <class S, class St>
__device__ __forceinline__ void idm_lane(St& st, int l, S hpd, S hsd,
                                         const Consts& k) {
  const int n = st.count[l];
  for (int v = 0; v < n; ++v) {
    const int i = st.vi(l, v);
    const S pv = ld<S>(st.pos, i), sp = ld<S>(st.vel, i);
    S pdel, sdel;
    if (v == n - 1) {
      pdel = hpd; sdel = hsd;
    } else {
      const int j = st.vi(l, v + 1);
      pdel = vabs(ld<S>(st.pos, j) - pv) -
             S((st.param(5, j) + st.param(5, i)) * 0.5f);
      sdel = sp - ld<S>(st.vel, j);
    }
    S np_, nv_;
    idm_step(pv, sp, pdel, sdel, st.param(0, i), st.param(2, i),
             st.param(3, i), st.param(4, i), st.idm_den(i), k.dt, np_, nv_);
    put(st.pos, i, np_);
    put(st.vel, i, nv_);
  }
}

// ---------------------------------------------------------------------------
// D: conversion (requests, pull arbitration, verdicts and deposits)
// ---------------------------------------------------------------------------

template <class S>
struct Request {
  int want, slot, mn, hnext;  // slot: the capacitor toward mn, or -1
  bool exit_none;             // the head leaves the network
  S cap_v;                    // that capacitor after this step's inflow
};

// What the lane asks of its neighbours after the physics: emit a vehicle
// from its flux capacitor into a micro lane, hand its head to the next
// micro lane, or deposit its head's mass into the next macro lane.
// Publishes the want bits, the targets and the head's fields.
template <class S, class St, class Sm>
__device__ __forceinline__ Request<S> request(const St& st, Sm& s,
                                              const Scene& sc,
                                              const LaneGeom& g,
                                              const Dims& d, const Consts& k,
                                              int l, int mn, int last) {
  const int L = d.L, K = d.K, V = d.V;
  auto clampL = [&](int j) { return min(max(j, 0), L - 1); };
  Request<S> q;
  q.want = 0; q.slot = -1; q.mn = mn; q.cap_v = 0.0f;
  const S rl = ld<S>(st.r, st.ci(l, last));
  const S ul = comp_u(rl, ld<S>(st.y, st.ci(l, last)), k.u_max);
  s.u_last[l] = ul;
  const int mn_c = clampL(mn);
  const bool next_is_micro = g.is_macro && mn >= 0 && !sc.macro_at(mn_c);
  const S inc = next_is_micro ? (rl * ul) * S(k.dt) : S(0.0f);
  for (int j = 0; j < K; ++j) {
    const int nq = sc.lane_i[(8 + K + j) * L + l];
    if (nq >= 0 && nq == mn) { q.slot = j; break; }
  }
  if (q.slot >= 0) q.cap_v = ld<S>(st.cap, st.ki(l, q.slot)) + inc;
  s.cap_val[l] = q.cap_v;
  const int dest_n = mn >= 0 ? st.count[mn_c] : 0;
  const int dt_i = st.vi(mn_c, 0);
  const float free_n =
      dest_n > 0 ? val(ld<S>(st.pos, dt_i)) - 0.5f * st.param(5, dt_i)
                 : (mn >= 0 ? sc.length_at(mn_c) : 0.0f);
  if (next_is_micro && val(q.cap_v) >= k.veh_len && free_n >= k.veh_len &&
      dest_n < V)
    q.want |= W_EMIT;

  // the head after the physics (the conversion's source fields)
  const int n = st.count[l];
  const bool exists = n > 0;
  const int hi = st.vi(l, min(max(n - 1, 0), V - 1));
  const S hpos = ld<S>(st.pos, hi);
  const float hlen = st.param(5, hi);
  s.hs_pos[l] = hpos;
  s.hs_vel[l] = ld<S>(st.vel, hi);
  s.hs_a[l] = ld<S>(st.av, hi);
  if constexpr (St::per_vehicle) {
    s.hs_len[l] = hlen;
    for (int j = 0; j < 5; ++j) s.hs_par[j * L + l] = st.par[j][hi];
  }
  s.hs_rid[l] = st.rid[hi];
  s.hs_ridx[l] = st.ridx[hi];
  q.hnext = route_at(sc.inj, sc.emit, st.rid[hi], st.ridx[hi] + 1, d);
  const int hn_c = clampL(q.hnext);
  const bool past_end = exists && val(hpos) >= g.length;
  q.exit_none = past_end && q.hnext < 0;
  const bool hn_macro = q.hnext >= 0 && sc.macro_at(hn_c);
  const bool hn_micro = q.hnext >= 0 && !hn_macro;
  if (past_end && hn_micro && st.count[hn_c] < V) q.want |= W_TRANSFER;
  if (exists && hn_macro && val(hpos) > g.length + hlen) q.want |= W_DEPOSIT;
  s.want[l] = q.want;
  s.mn[l] = mn;
  s.hn[l] = q.hnext;
  return q;
}

// pull arbitration: each destination takes the lowest source id that
// wants in (L: none); no atomics
template <class Sm>
__device__ __forceinline__ void arbitrate(Sm& s, const Scene& sc, int L,
                                          int K, int l) {
  int best = L, dep_best = L;
  for (int q = 0; q < K; ++q) {
    const int pk = sc.lane_i[(8 + q) * L + l];
    if (pk < 0) continue;
    const int pw = s.want[pk];
    if (((pw & W_EMIT) && s.mn[pk] == l) ||
        ((pw & W_TRANSFER) && s.hn[pk] == l))
      best = min(best, pk);
    if ((pw & W_DEPOSIT) && s.hn[pk] == l) dep_best = min(dep_best, pk);
  }
  s.best[l] = best;
  s.dep_best[l] = dep_best;
}

struct Verdict {
  bool is_emit, has_insert, exit_none, tr_win, dep_win, remove;
  int n;  // the lane's vehicles after the conversion
};

// The lane's verdicts: remove a head that left, update the capacitor,
// insert the winning source's vehicle (emitted or transferred) as the new
// tail, and deposit the winning micro head's mass into the cells.
template <class S, class St, class Sm>
__device__ __forceinline__ Verdict convert(St& st, const Sm& s,
                                           const Scene& sc, const LaneGeom& g,
                                           const Request<S>& q,
                                           const Dims& d, const Consts& k,
                                           int l) {
  const int L = d.L;
  auto clampL = [&](int j) { return min(max(j, 0), L - 1); };
  const int mn_c = clampL(q.mn), hn_c = clampL(q.hnext);
  Verdict o;
  const bool emit_win = (q.want & W_EMIT) && s.best[mn_c] == l;
  o.tr_win = (q.want & W_TRANSFER) && s.best[hn_c] == l;
  o.dep_win = (q.want & W_DEPOSIT) && s.dep_best[hn_c] == l;
  o.exit_none = q.exit_none;
  o.remove = q.exit_none || o.dep_win || o.tr_win;
  int n = st.count[l] - (o.remove ? 1 : 0);
  // the decremented capacitor is detached
  if (q.slot >= 0)
    put(st.cap, st.ki(l, q.slot),
        emit_win ? detached(q.cap_v - S(k.veh_len)) : q.cap_v);

  const int src = s.best[l];
  o.has_insert = src < L;
  o.is_emit = false;
  if (o.has_insert) {
    o.is_emit = sc.macro_at(src);
    if (o.is_emit) {
      st.insert_tail(l, d.V, S(0.0f), s.u_last[src],
                     grad_carrier(k.veh_len, s.cap_val[src]), nullptr,
                     L * d.P + l * d.P2 + st.cursor[l] % d.P2, 0);
      st.cursor[l] += 1;
    } else {
      float npar[6];
      if constexpr (St::per_vehicle) {
        for (int j = 0; j < 5; ++j) npar[j] = s.hs_par[j * L + src];
        npar[5] = s.hs_len[src];
      }
      st.insert_tail(l, d.V, s.hs_pos[src] - S(sc.length_at(src)),
                     s.hs_vel[src], s.hs_a[src], npar, s.hs_rid[src],
                     s.hs_ridx[src] + 1);
    }
    n += 1;
  }
  st.count[l] = n;
  o.n = n;

  // micro -> macro mass deposit from the winning source
  const int sd = s.dep_best[l];
  if (sd < L) {
    const float cell_len = g.cell_len;
    const S v_head = s.hs_pos[sd] - S(sc.length_at(sd));
    float dlen = k.veh_len;
    if constexpr (St::per_vehicle) dlen = s.hs_len[sd];
    const S v_tail = v_head - S(dlen);
    const S ha = s.hs_a[sd], hv = s.hs_vel[sd];
    for (int c = 0; c < g.num_cell; ++c) {
      const float c_tail = (float)c * cell_len;
      const float c_head = ((float)c + 1.0f) * cell_len;
      const bool ov = c_head > val(v_tail) && c_tail < val(v_head) &&
                      cell_len > val(v_tail);
      if (!ov) continue;
      const S max_head = vmax(S(c_head), v_head);
      const S min_tail = vmin(S(c_tail), v_tail);
      const S overlap = S(cell_len + dlen) - (max_head - min_tail);
      const S add_r = (ha / S(dlen)) * (overlap / S(cell_len));
      const int i = st.ci(l, c);
      const S n_r = st_clip(ld<S>(st.r, i) + add_r, k.rho_hi);
      put(st.r, i, n_r);
      put(st.y, i, comp_y(n_r, hv, k.u_max));
    }
  }
  return o;
}

// ---------------------------------------------------------------------------
// E: the static running mean's partial sums and the lane's queue
// ---------------------------------------------------------------------------

// sum of (static_speed - speed) over the macro lane's cells (slot l) or
// the micro lane's n vehicles (slot L + l), in float64, with the counts;
// `u_cells` (K1), when given, receives the macro lane's cell speeds for
// lane_queue
template <class S, class St, class Sm>
__device__ __forceinline__ void static_partials(const St& st, Sm& s,
                                                const LaneGeom& g, int L,
                                                int l, int n,
                                                const Consts& k,
                                                S* u_cells = nullptr) {
  double cells = 0.0, vehs = 0.0;
  if (g.is_macro) {
    for (int c = 0; c < g.num_cell; ++c) {
      const S u = comp_u(ld<S>(st.r, st.ci(l, c)), ld<S>(st.y, st.ci(l, c)),
                         k.u_max);
      if (u_cells) u_cells[c] = u;
      cells += (double)(k.static_speed - val(u));
    }
  } else {
    for (int v = 0; v < n; ++v)
      vehs += (double)(k.static_speed - val(ld<S>(st.vel, st.vi(l, v))));
  }
  s.red_sum[l] = cells; s.red_cnt[l] = g.is_macro ? g.num_cell : 0;
  s.red_sum[L + l] = vehs; s.red_cnt[L + l] = g.is_macro ? 0 : n;
}

// the lane's queue: stopped vehicles of a macro lane's cells, or stopped
// vehicles of a micro lane's n; soft gates sharpened by `c_st` (the
// detached static running mean's constant) outside hard mode; `u_cells`
// (K1), when given, holds the cells' speeds from static_partials on the
// same state
template <class S, class St>
__device__ __forceinline__ S lane_queue(const St& st, const LaneGeom& g,
                                        int l, int n, int mode, float c_st,
                                        const Consts& k,
                                        const S* u_cells = nullptr) {
  const float ss = k.static_speed;
  S q = 0.0f;
  if (g.is_macro) {
    for (int c = 0; c < g.num_cell; ++c) {
      const S rc = ld<S>(st.r, st.ci(l, c));
      const S u = u_cells ? u_cells[c]
                          : comp_u(rc, ld<S>(st.y, st.ci(l, c)), k.u_max);
      const S stat = mode == HARD ? S(val(u) < ss ? 1.0f : 0.0f)
                                  : stg(val(u) < ss, soft(S(ss) - u, c_st),
                                        mode);
      q = q + stat * ((rc * S(g.cell_len)) / S(k.veh_len));
    }
  } else {
    for (int v = 0; v < n; ++v) {
      const S sp = ld<S>(st.vel, st.vi(l, v));
      q = q + (mode == HARD ? S(val(sp) < ss ? 1.0f : 0.0f)
                            : stg(val(sp) < ss, soft(S(ss) - sp, c_st),
                                  mode));
    }
  }
  return q;
}

// The most threads a block of `kernel` takes (its registers decide), asked
// of the runtime once for each kernel; 0 where the query fails (a launch
// that needs more threads then fails). The host build: `bound`, the block
// the caller compiled the kernel for.
template <class Kernel>
int max_threads_of(Kernel kernel, int bound) {
#ifdef DHTS_CPU_EMULATION
  (void)kernel;
  return bound;
#else
  (void)bound;
  constexpr int KNOWN = 8;
  static Kernel known[KNOWN];
  static int threads[KNOWN];
  static int n_known = 0;
  for (int i = 0; i < n_known; ++i)
    if (known[i] == kernel) return threads[i];
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return 0;
  if (n_known < KNOWN) {
    known[n_known] = kernel;
    threads[n_known++] = attr.maxThreadsPerBlock;
  }
  return attr.maxThreadsPerBlock;
#endif
}

}  // namespace
