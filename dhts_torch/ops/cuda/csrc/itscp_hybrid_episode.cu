// Fused ITSCP hybrid episode, hard-mode forward, for Hopper (sm_90a).
//
// Replaces the forward of the TPU kernel K1,
// dhts/ops/pallas/itscp_hybrid_episode.py::make_fused_itscp_episode
// (make_fwd_kernel / run_forward, pallas_call at :2130; per-step `step`
// at :661). It runs a whole episode of T steps and returns
// (-sum(queues), queues[T], events[T, 8]). Its specification is the plain
// PyTorch version beside its wrapper (dhts_torch/ops/cuda/
// itscp_hybrid_episode.py::plain_episode, built on the eager
// boundary_and_step): every per-lane value is computed with the same IEEE
// operations in the same order (the build passes -fmad=false and no fast
// math), so events agree bit for bit and queues to the rounding of the
// lane sums.
//
// Design. One thread block per episode and one thread per lane; the T loop
// runs inside the kernel. Cells, vehicles, counters and flux capacitors
// live in shared memory. The [L, V, R] route container of the JAX kernel
// is not materialised: every route in an episode is a row of one of the
// two read-only pools (waiting pool [L, P, R], emission pool [L, P2, R]),
// and vehicles only ever copy routes, so each vehicle slot holds a route
// id (the pool row) and route entries are read from global memory, where
// the pools stay L2-resident. Each step syncs the block six times, where a
// lane reads another lane's values: after injection (signals, boundary
// cells), after the boundary/leader reads (before lanes write their new
// state), after the lanes' forward step, after the conversion requests are
// published, after arbitration, and after the conversion (before the block
// reductions).
//   arbitration  pull form: each destination scans its predecessor list
//                and takes the lowest source id that wants in; no atomics.
//   reductions   queue, event counts and max wave speed are summed by one
//                thread in lane order: deterministic.
//   randomness   rand[T, L] is an input.
// The RMS running statistics of the JAX kernel only sharpen soft gates;
// this hard-mode kernel never reads them and does not compute them.
//
// Bound. The episode is a chain of T dependent steps, each a handful of
// block-wide barriers and short dependent global loads (the route walk);
// its inputs and outputs are a few MB, so it is latency-bound, far above
// the bytes / 3.35 TB/s floor.

#ifdef DHTS_CPU_EMULATION
#include "cpu_emulation.h"
#else
#include <cuda_runtime.h>
#define DHTS_DYNAMIC_SMEM(name) extern __shared__ __align__(16) char name[]
#endif

namespace {

constexpr float EPS = 1e-5f;
constexpr int MAXC = 16;  // cells per macro lane held in registers
constexpr int NEV = 7;    // integer event rows
constexpr int INF_ID = 1 << 30;

struct Consts {
  float u_max, dt, veh_len, static_speed;
  float rare_den;  // (GAMMA + 1) * u_max, rounded once from double
  float third;     // GAMMA / (GAMMA + 1), rounded once from double
  float amax, apref, tgt, min_space, time_pref;  // default vehicle
  float rho_hi;    // 1 - 1e-5, rounded once from double
};

struct Dims {
  int T, L, C, V, R, P, P2, K, W, nsf, n_phases, n_inter;
};

__device__ __forceinline__ float u_eq(float r, float u_max) {
  r = fmaxf(r, 0.0f);
  return u_max * (1.0f - sqrtf(r + EPS));
}

__device__ __forceinline__ float u_eq_prime(float r, float u_max) {
  r = fmaxf(r, EPS);
  return (-(u_max * 0.5f)) * (1.0f / sqrtf(r));
}

__device__ __forceinline__ float comp_y(float r, float u, float u_max) {
  return r * (u - u_eq(r, u_max));
}

__device__ __forceinline__ float comp_u(float r, float y, float u_max) {
  r = fmaxf(r, EPS);
  return y / r + u_eq(r, u_max);
}

__device__ __forceinline__ float lambda0(float r, float u, float u_max) {
  return u + r * u_eq_prime(r, u_max);
}

// exact ARZ Riemann solver (dhts_torch.ops.arz.riemann_solve)
__device__ __forceinline__ void riemann(float rl, float yl, float ul,
                                        float rr, float ur, const Consts& k,
                                        float& fr, float& fy, float& wave) {
  const float u_max = k.u_max;
  const float u_eq_l = u_eq(rl, u_max);
  const float lam0_l = lambda0(rl, ul, u_max);
  const float r_l_pow = sqrtf(fmaxf(rl, EPS));

  const float tm = r_l_pow + (ul - ur) / u_max;
  const float r_m = tm * tm;
  const float u_m = ur;
  const float lam0_m = lambda0(r_m, u_m, u_max);
  const float flux_r_m = r_m * u_m;

  const float u_vac = (u_max + ul) - u_eq_l;

  const float inv = ul + u_max * r_l_pow;
  const float tc = inv / k.rare_den;
  const float r_c = tc * tc;
  const float u_c = k.third * inv;

  const bool vac_l = rl < EPS;
  const bool vac_r = !vac_l && (rr < EPS);
  bool taken = vac_l || vac_r;
  const bool equal = !taken && (fabsf(ul - ur) < EPS);
  taken = taken || equal;
  const bool shock = !taken && (ul > ur);
  taken = taken || shock;
  const bool rare = !taken && (u_vac > ur);

  const float shock_speed = (flux_r_m - rl * ul) / fmaxf(r_m - rl, EPS);
  const float half_lam_m = (lam0_l + lam0_m) * 0.5f;
  const float half_lam_vac = (lam0_l + u_vac) * 0.5f;

  float speed0, speed1;
  int c;
  const int l_or_c = lam0_l >= 0.0f ? 0 : 2;
  if (vac_l) {
    speed0 = 0.0f; speed1 = ul; c = 0;
  } else if (vac_r) {
    speed0 = half_lam_vac; speed1 = half_lam_vac; c = l_or_c;
  } else if (equal) {
    speed0 = 0.0f; speed1 = ur; c = 0;
  } else if (shock) {
    speed0 = shock_speed; speed1 = ur; c = shock_speed >= 0.0f ? 0 : 1;
  } else if (rare) {
    speed0 = half_lam_m; speed1 = ur;
    c = lam0_l >= 0.0f ? 0 : (lam0_m <= 0.0f ? 1 : 2);
  } else {
    speed0 = half_lam_vac; speed1 = ur; c = l_or_c;
  }
  float r0, u0, y0;
  if (c == 1) {
    r0 = r_m; u0 = u_m; y0 = comp_y(r0, u0, u_max);
  } else if (c == 2) {
    r0 = r_c; u0 = u_c; y0 = comp_y(r0, u0, u_max);
  } else {
    r0 = rl; u0 = ul; y0 = yl;
  }
  fr = r0 * u0;
  fy = y0 * u0;
  wave = fmaxf(fabsf(speed0), fabsf(speed1));
}

// entry j of the route with id `rid` (-1 for no route / out of range)
__device__ __forceinline__ int route_at(const int* __restrict__ inj,
                                        const int* __restrict__ emit,
                                        int rid, int j, const Dims& d) {
  if (rid < 0 || j < 0 || j >= d.R) return -1;
  const int n_inj = d.L * d.P;
  return rid < n_inj ? inj[rid * d.R + j] : emit[(rid - n_inj) * d.R + j];
}

struct Smem {
  float *r, *y, *pos, *vel, *av, *cap;
  float *sig, *r_last, *u_last, *r_first, *u_first;
  float *cap_val, *hs_pos, *hs_vel, *hs_a, *red_q, *red_wave;
  int *rid, *ridx, *count, *inj_left, *cursor;
  int *want, *mn_c, *hn_c, *hs_rid, *hs_ridx, *best, *dep_best, *red_ev;
};

__host__ __device__ inline size_t smem_bytes(const Dims& d, Smem* s,
                                             char* base) {
  size_t off = 0;
  auto f = [&](float** p, size_t n) {
    if (s) *p = reinterpret_cast<float*>(base + off);
    off += ((n * sizeof(float) + 15) / 16) * 16;
  };
  auto i = [&](int** p, size_t n) {
    if (s) *p = reinterpret_cast<int*>(base + off);
    off += ((n * sizeof(int) + 15) / 16) * 16;
  };
  Smem dummy;
  Smem* t = s ? s : &dummy;
  const size_t L = d.L, LC = d.L * d.C, LV = d.L * d.V, LK = d.L * d.K;
  f(&t->r, LC); f(&t->y, LC);
  f(&t->pos, LV); f(&t->vel, LV); f(&t->av, LV); f(&t->cap, LK);
  f(&t->sig, L); f(&t->r_last, L); f(&t->u_last, L); f(&t->r_first, L);
  f(&t->u_first, L); f(&t->cap_val, L); f(&t->hs_pos, L); f(&t->hs_vel, L);
  f(&t->hs_a, L); f(&t->red_q, L); f(&t->red_wave, L);
  i(&t->rid, LV); i(&t->ridx, LV); i(&t->count, L); i(&t->inj_left, L);
  i(&t->cursor, L); i(&t->want, L); i(&t->mn_c, L); i(&t->hn_c, L);
  i(&t->hs_rid, L); i(&t->hs_ridx, L); i(&t->best, L); i(&t->dep_best, L);
  i(&t->red_ev, NEV * L);
  return off;
}

// want bits published for arbitration
constexpr int W_EMIT = 1, W_TRANSFER = 2, W_DEPOSIT = 4;

__global__ void itscp_hybrid_episode_fwd_kernel(
    const float* __restrict__ action, const float* __restrict__ sched,
    const int* __restrict__ mnext, const int* __restrict__ mprev,
    const float* __restrict__ rand, const int* __restrict__ inj_routes,
    const int* __restrict__ emit_routes, const float* __restrict__ prog,
    const int* __restrict__ lane_i, const float* __restrict__ lane_f,
    float* __restrict__ out_reward, float* __restrict__ out_queues,
    float* __restrict__ out_events, Dims d, Consts k) {
  DHTS_DYNAMIC_SMEM(smem_raw);
  Smem s;
  smem_bytes(d, &s, smem_raw);

  const int L = d.L, C = d.C, V = d.V, K = d.K;
  const int l = threadIdx.x;
  const bool lane = l < L;
  const float u_max = k.u_max;

  // this lane's static geometry (lane_i rows: is_macro, num_cell,
  // approaching, is_we, inter, has_prev, num_prev, num_next, prev[K],
  // next[K]; lane_f rows: length, cell_length)
  int is_macro = 0, num_cell = 0, approaching = 0, is_we = 0, inter = 0;
  int has_prev = 0, num_prev = 0, num_next = 0, prev0 = -1, next0 = -1;
  float length = 1.0f, cell_len = 1.0f;
  if (lane) {
    is_macro = lane_i[0 * L + l];
    num_cell = lane_i[1 * L + l];
    approaching = lane_i[2 * L + l];
    is_we = lane_i[3 * L + l];
    inter = lane_i[4 * L + l];
    has_prev = lane_i[5 * L + l];
    num_prev = lane_i[6 * L + l];
    num_next = lane_i[7 * L + l];
    prev0 = lane_i[8 * L + l];
    next0 = lane_i[(8 + K) * L + l];
    length = lane_f[0 * L + l];
    cell_len = lane_f[1 * L + l];
  }
  auto geom_macro = [&](int j) { return lane_i[0 * L + j] != 0; };
  auto geom_len = [&](int j) { return lane_f[0 * L + j]; };
  const float coeff = k.dt / cell_len;
  const int last = min(max(num_cell - 1, 0), C - 1);
  const float idm_den = 2.0f * sqrtf(k.amax * k.apref);

  // ---- initial (empty) state
  if (lane) {
    for (int c = 0; c < C; ++c) { s.r[l * C + c] = 0.0f; s.y[l * C + c] = 0.0f; }
    for (int v = 0; v < V; ++v) {
      s.pos[l * V + v] = 0.0f; s.vel[l * V + v] = 0.0f;
      s.av[l * V + v] = k.veh_len; s.rid[l * V + v] = -1;
      s.ridx[l * V + v] = 0;
    }
    for (int q = 0; q < K; ++q) s.cap[l * K + q] = 0.0f;
    s.count[l] = 0;
    s.inj_left[l] = (!has_prev && !is_macro) ? d.P : 0;
    s.cursor[l] = 0;
  }
  float qsum = 0.0f;
  __syncthreads();

  for (int t = 0; t < d.T; ++t) {
    const int tl = t * L + l;
    // ================= A: signal, injection, boundary cells ============
    int ev_inj = 0;
    float incoming = -1.0f;
    if (lane) {
      const int phase = min(t / d.nsf, d.n_phases - 1);
      const float a = action[phase * d.n_inter + inter];
      const float progress = prog[t % d.nsf];
      const float g = is_we ? (a > progress ? 1.0f : 0.0f)
                            : (progress > a ? 1.0f : 0.0f);
      s.sig[l] = approaching ? g : 1.0f;
      incoming = has_prev ? -1.0f : sched[tl];

      if (!is_macro) {
        int n = s.count[l];
        const float free_sp = n > 0 ? s.pos[l * V] - 0.5f * k.veh_len : length;
        const bool inject = !has_prev && (free_sp > 0.5f * k.veh_len) &&
                            (rand[tl] < incoming) && (s.inj_left[l] > 0) &&
                            (n < V);
        if (inject) {
          const int pool_idx = min(max(d.P - s.inj_left[l], 0), d.P - 1);
          for (int v = V - 1; v > 0; --v) {
            s.pos[l * V + v] = s.pos[l * V + v - 1];
            s.vel[l * V + v] = s.vel[l * V + v - 1];
            s.av[l * V + v] = s.av[l * V + v - 1];
            s.rid[l * V + v] = s.rid[l * V + v - 1];
            s.ridx[l * V + v] = s.ridx[l * V + v - 1];
          }
          s.pos[l * V] = 0.0f; s.vel[l * V] = 0.0f; s.av[l * V] = k.veh_len;
          s.rid[l * V] = l * d.P + pool_idx; s.ridx[l * V] = 0;
          s.count[l] = n + 1;
          s.inj_left[l] -= 1;
          ev_inj = 1;
        }
      }
      // edge cells other lanes read as boundary values
      const float rl = s.r[l * C + last], yl = s.y[l * C + last];
      const float rf = s.r[l * C], yf = s.y[l * C];
      s.r_last[l] = rl; s.u_last[l] = comp_u(rl, yl, u_max);
      s.r_first[l] = rf; s.u_first[l] = comp_u(rf, yf, u_max);
    }
    __syncthreads();

    // ================= B1: ghosts, leader walk (reads only) ============
    float bl_r = 0.f, bl_u = 0.f, br_r = 0.f, br_u = 0.f, hpd = 0.f,
          hsd = 0.f;
    if (lane) {
      const int mp = mprev[tl], mn = mnext[tl];
      // left ghost: the upstream neighbour's last cell
      const int adjp = num_prev == 1 ? prev0 : mp;
      const int adjp_c = min(max(adjp, 0), L - 1);
      const bool use_l = (num_prev > 0) && (adjp >= 0) && geom_macro(adjp_c);
      float gl_r = use_l ? s.r_last[adjp_c] : 0.0f;
      float gl_u = use_l ? s.u_last[adjp_c] : u_max;
      if (!has_prev) { gl_r = incoming; gl_u = u_eq(incoming, u_max); }
      const float prev_sig =
          !has_prev ? 1.0f : (mp < 0 ? 0.0f : s.sig[min(max(mp, 0), L - 1)]);
      bl_r = gl_r * prev_sig;
      bl_u = gl_u * prev_sig + u_max * (1.0f - prev_sig);
      // right ghost: the downstream neighbour's first cell, or a red wall
      const int adjn = num_next == 1 ? next0 : mn;
      const int adjn_c = min(max(adjn, 0), L - 1);
      const bool use_r = (num_next > 0) && (adjn >= 0) && geom_macro(adjn_c);
      const float gr_r = use_r ? s.r_first[adjn_c] : 0.0f;
      const float gr_u = use_r ? s.u_first[adjn_c] : u_max;
      const float sg = s.sig[l] > 0.5f ? 1.0f : 0.0f;
      br_r = gr_r * sg + 1.0f * (1.0f - sg);
      br_u = gr_u * sg;

      if (!is_macro) {
        // virtual leader: walk the head vehicle's route
        const int n = s.count[l];
        const bool exists = n > 0;
        const int h = min(max(n - 1, 0), V - 1);
        const float hpos = s.pos[l * V + h], hvel = s.vel[l * V + h];
        const int hrid = s.rid[l * V + h], hridx = s.ridx[l * V + h];
        bool any_term = false, occupied = false;
        int lead = 0;
        double crossed = 0.0;  // exact for these few lengths
        for (int o = 1; o <= d.W; ++o) {
          const int w = route_at(inj_routes, emit_routes, hrid, hridx + o, d);
          if (w < 0) { any_term = true; break; }
          if (geom_macro(w)) { any_term = true; break; }
          if (s.count[w] > 0) {
            any_term = true; occupied = true; lead = w; break;
          }
          crossed += (double)geom_len(w);
        }
        const float cur_delta = (length - hpos) - k.veh_len * 0.5f +
                                (float)crossed;
        const bool found = exists && any_term && occupied;
        const float pd_g =
            found ? fmaxf((cur_delta + s.pos[lead * V]) - k.veh_len * 0.5f,
                          0.0f)
                  : 1000.0f;
        const float sd_g = found ? hvel - s.vel[lead * V] : 0.0f;
        // hard signal of the lane the head is on
        const float red_pd = fmaxf((length - hpos) - k.veh_len * 0.5f, 0.0f);
        const int curr = route_at(inj_routes, emit_routes, hrid,
                                  min(max(hridx, 0), d.R - 1), d);
        const float fsig = s.sig[min(max(curr, 0), L - 1)];
        if (exists) {
          const bool green = fsig >= 0.5f;
          hpd = green ? pd_g : red_pd;
          hsd = green ? sd_g : 0.0f;
        } else {
          hpd = pd_g; hsd = sd_g;
        }
      }
    }
    __syncthreads();

    // ================= B2: Godunov (macro) and IDM (micro) =============
    float lane_wave = 0.0f;
    if (lane) {
      if (is_macro) {
        const float right_y = comp_y(br_r, br_u, u_max);
        const float left_y = comp_y(bl_r, bl_u, u_max);
        float rp[MAXC], yp[MAXC], up[MAXC];
        for (int c = 0; c < C; ++c) {
          rp[c] = c < num_cell ? s.r[l * C + c] : br_r;
          yp[c] = c < num_cell ? s.y[l * C + c] : right_y;
          up[c] = comp_u(rp[c], yp[c], u_max);
        }
        float fr_prev = 0.f, fy_prev = 0.f;
        for (int i = 0; i <= C; ++i) {
          float fr, fy, wave;
          if (i == 0)
            riemann(bl_r, left_y, bl_u, rp[0], up[0], k, fr, fy, wave);
          else if (i == C)
            riemann(rp[C - 1], yp[C - 1], up[C - 1], br_r, br_u, k, fr, fy,
                    wave);
          else
            riemann(rp[i - 1], yp[i - 1], up[i - 1], rp[i], up[i], k, fr,
                    fy, wave);
          lane_wave = i == 0 ? wave : fmaxf(lane_wave, wave);
          if (i > 0 && i - 1 < num_cell) {
            s.r[l * C + i - 1] = rp[i - 1] + (fr_prev - fr) * coeff;
            s.y[l * C + i - 1] = yp[i - 1] + (fy_prev - fy) * coeff;
          }
          fr_prev = fr; fy_prev = fy;
        }
      } else {
        const int n = s.count[l];
        for (int v = 0; v < n; ++v) {
          const float p = s.pos[l * V + v], sp = s.vel[l * V + v];
          float pdel, sdel;
          if (v == n - 1) {
            pdel = hpd; sdel = hsd;
          } else {
            pdel = fabsf(s.pos[l * V + v + 1] - p) -
                   (k.veh_len + k.veh_len) * 0.5f;
            sdel = sp - s.vel[l * V + v + 1];
          }
          if (pdel < 0.0f) { pdel = 0.0f; sdel = 0.0f; }
          pdel = fmaxf(pdel, EPS);
          const float os = fmaxf(
              (k.min_space + sp * k.time_pref) + (sp * sdel) / idm_den, 0.0f);
          const float q = sp / k.tgt;
          const float q2 = q * q;
          const float z = os / pdel;
          const float acc_raw = k.amax * ((1.0f - q2 * q2) - z * z);
          const float acc = fmaxf(acc_raw, -sp / k.dt);
          s.pos[l * V + v] = p + k.dt * sp;
          s.vel[l * V + v] = sp + k.dt * acc;
        }
      }
    }
    __syncthreads();

    // ================= C1: conversion requests ==========================
    int want = 0, slot = 0, mn_c = 0, hn_c = 0, hnext = -1;
    bool exit_none = false;
    float cap_v = 0.0f;
    if (lane) {
      const int mn = mnext[tl];
      mn_c = min(max(mn, 0), L - 1);
      const bool next_is_micro = is_macro && mn >= 0 && !geom_macro(mn_c);
      const float rl = s.r[l * C + last];
      const float ul = comp_u(rl, s.y[l * C + last], u_max);
      const float inc = next_is_micro ? rl * ul * k.dt : 0.0f;
      slot = 0;
      for (int q = 0; q < K; ++q)
        if (lane_i[(8 + K + q) * L + l] == mn) { slot = q; break; }
      cap_v = s.cap[l * K + slot] + inc;
      const int dest_n = s.count[mn_c];
      const float free_sp = dest_n > 0
                                ? s.pos[mn_c * V] - 0.5f * k.veh_len
                                : geom_len(mn_c);
      if (next_is_micro && cap_v >= k.veh_len && free_sp >= k.veh_len &&
          dest_n < V)
        want |= W_EMIT;

      const int n = s.count[l];
      const bool exists = n > 0;
      const int h = min(max(n - 1, 0), V - 1);
      const float hpos = s.pos[l * V + h];
      const int hrid = s.rid[l * V + h], hridx = s.ridx[l * V + h];
      hnext = hridx + 1 < d.R
                  ? route_at(inj_routes, emit_routes, hrid,
                             min(max(hridx + 1, 0), d.R - 1), d)
                  : -1;
      hn_c = min(max(hnext, 0), L - 1);
      const bool past_end = exists && hpos >= length;
      exit_none = past_end && hnext < 0;
      const bool nxt_micro = hnext >= 0 && !geom_macro(hn_c);
      const bool nxt_macro = hnext >= 0 && geom_macro(hn_c);
      if (past_end && nxt_micro && s.count[hn_c] < V) want |= W_TRANSFER;
      if (exists && nxt_macro && hpos > length + k.veh_len) want |= W_DEPOSIT;

      s.want[l] = want; s.mn_c[l] = mn_c; s.hn_c[l] = hn_c;
      s.cap_val[l] = cap_v; s.u_last[l] = ul;
      s.hs_pos[l] = hpos; s.hs_vel[l] = s.vel[l * V + h];
      s.hs_a[l] = s.av[l * V + h]; s.hs_rid[l] = hrid; s.hs_ridx[l] = hridx;
    }
    __syncthreads();

    // ================= C2: arbitration (pull, lowest source id) ========
    if (lane) {
      int best = INF_ID, dep_best = INF_ID;
      for (int q = 0; q < K; ++q) {
        const int p = lane_i[(8 + q) * L + l];
        if (p < 0) continue;
        const int pw = s.want[p];
        if (((pw & W_EMIT) && s.mn_c[p] == l) ||
            ((pw & W_TRANSFER) && s.hn_c[p] == l))
          best = min(best, p);
        if ((pw & W_DEPOSIT) && s.hn_c[p] == l) dep_best = min(dep_best, p);
      }
      s.best[l] = best; s.dep_best[l] = dep_best;
    }
    __syncthreads();

    // ================= C3: verdicts, removals, inserts, deposits =======
    int ev[NEV] = {ev_inj, 0, 0, 0, 0, 0, 0};
    float q_lane = 0.0f;
    if (lane) {
      const bool emit_win = (want & W_EMIT) && s.best[mn_c] == l;
      const bool tr_win = (want & W_TRANSFER) && s.best[hn_c] == l;
      const bool dep_win = (want & W_DEPOSIT) && s.dep_best[hn_c] == l;
      const bool remove = exit_none || dep_win || tr_win;
      int n = s.count[l] - (remove ? 1 : 0);
      s.cap[l * K + slot] = emit_win ? cap_v - k.veh_len : cap_v;

      const int best = s.best[l];
      const bool has_insert = best < INF_ID;
      bool is_emit = false;
      if (has_insert) {
        const int src = best;
        is_emit = geom_macro(src);
        float npos, nvel, na;
        int nrid, nridx;
        if (is_emit) {
          npos = 0.0f;
          nvel = s.u_last[src];
          na = (k.veh_len + s.cap_val[src]) - s.cap_val[src];
          nrid = L * d.P + l * d.P2 + s.cursor[l] % d.P2;
          nridx = 0;
          s.cursor[l] += 1;
        } else {
          npos = s.hs_pos[src] - geom_len(src);
          nvel = s.hs_vel[src];
          na = s.hs_a[src];
          nrid = s.hs_rid[src];
          nridx = s.hs_ridx[src] + 1;
        }
        for (int v = V - 1; v > 0; --v) {
          s.pos[l * V + v] = s.pos[l * V + v - 1];
          s.vel[l * V + v] = s.vel[l * V + v - 1];
          s.av[l * V + v] = s.av[l * V + v - 1];
          s.rid[l * V + v] = s.rid[l * V + v - 1];
          s.ridx[l * V + v] = s.ridx[l * V + v - 1];
        }
        s.pos[l * V] = npos; s.vel[l * V] = nvel; s.av[l * V] = na;
        s.rid[l * V] = nrid; s.ridx[l * V] = nridx;
        n += 1;
      }
      s.count[l] = n;

      // micro -> macro mass deposit from the winning source
      const int sd = s.dep_best[l];
      if (sd < INF_ID) {
        const float v_head = s.hs_pos[sd] - geom_len(sd);
        const float v_tail = v_head - k.veh_len;
        const float ha = s.hs_a[sd], hv = s.hs_vel[sd];
        for (int c = 0; c < num_cell; ++c) {
          const float c_tail = (float)c * cell_len;
          const float c_head = ((float)c + 1.0f) * cell_len;
          const bool ov = c_head > v_tail && c_tail < v_head &&
                          cell_len > v_tail;
          if (!ov) continue;
          const float max_head = fmaxf(c_head, v_head);
          const float min_tail = fminf(c_tail, v_tail);
          const float overlap = (cell_len + k.veh_len) - (max_head - min_tail);
          const float add_r = (ha / k.veh_len) * (overlap / cell_len);
          float n_r = s.r[l * C + c] + add_r;
          n_r = n_r - (n_r - fminf(fmaxf(n_r, EPS), k.rho_hi));
          s.r[l * C + c] = n_r;
          s.y[l * C + c] = comp_y(n_r, hv, u_max);
        }
      }
      ev[1] = is_emit;
      ev[2] = exit_none || dep_win;
      ev[3] = has_insert && !is_emit;
      ev[4] = tr_win;
      ev[5] = dep_win;
      ev[6] = remove;

      // ---- queue of this lane
      if (is_macro) {
        for (int c = 0; c < num_cell; ++c) {
          const float r = s.r[l * C + c];
          const float u = comp_u(r, s.y[l * C + c], u_max);
          const float stat = u < k.static_speed ? 1.0f : 0.0f;
          q_lane = q_lane + stat * ((r * cell_len) / k.veh_len);
        }
      } else {
        for (int v = 0; v < n; ++v)
          q_lane = q_lane + (s.vel[l * V + v] < k.static_speed ? 1.0f : 0.0f);
      }
      s.red_q[l] = q_lane * q_lane;
      s.red_wave[l] = lane_wave;
      for (int e = 0; e < NEV; ++e) s.red_ev[e * L + l] = ev[e];
    }
    __syncthreads();

    // ================= D: block reductions in lane order ===============
    if (threadIdx.x == 0) {
      float qs = 0.0f, wave = 0.0f;
      for (int j = 0; j < L; ++j) {
        qs += s.red_q[j];
        wave = fmaxf(wave, s.red_wave[j]);
      }
      const float queue = qs * k.dt;
      qsum += queue;
      out_queues[t] = queue;
      for (int e = 0; e < NEV; ++e) {
        int tot = 0;
        for (int j = 0; j < L; ++j) tot += s.red_ev[e * L + j];
        out_events[t * 8 + e] = (float)tot;
      }
      out_events[t * 8 + 7] = wave;
    }
    // the next step's first writes touch none of the reduced arrays
  }
  if (threadIdx.x == 0) out_reward[0] = -qsum;
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for these sizes (bytes).
size_t itscp_hybrid_episode_fwd_smem(int L, int C, int V, int K) {
  Dims d{};
  d.L = L; d.C = C; d.V = V; d.K = K;
  return smem_bytes(d, nullptr, nullptr);
}

// Launch one episode on `stream`; returns cudaGetLastError() of the launch.
int launch_itscp_hybrid_episode_fwd(
    const float* action, const float* sched, const int* mnext,
    const int* mprev, const float* rand, const int* inj_routes,
    const int* emit_routes, const float* prog, const int* lane_i,
    const float* lane_f, float* out_reward, float* out_queues,
    float* out_events, int T, int L, int C, int V, int R, int P, int P2,
    int K, int W, int nsf, int n_phases, int n_inter, float u_max, float dt,
    float veh_len, float static_speed, float rare_den, float third,
    float amax, float apref, float tgt, float min_space, float time_pref,
    float rho_hi, void* stream) {
  if (L < 1 || L > 1024 || C < 1 || C > MAXC || V < 1 || R < 1 || K < 1)
    return 1;  // cudaErrorInvalidValue
  Dims d{T, L, C, V, R, P, P2, K, W, nsf, n_phases, n_inter};
  Consts k{u_max, dt, veh_len, static_speed, rare_den, third,
           amax, apref, tgt, min_space, time_pref, rho_hi};
  const size_t smem = smem_bytes(d, nullptr, nullptr);
  const int threads = ((L + 31) / 32) * 32;
#ifdef DHTS_CPU_EMULATION
  (void)stream;
  dhts_emu::launch(threads, smem, itscp_hybrid_episode_fwd_kernel, action,
                   sched, mnext, mprev, rand, inj_routes, emit_routes, prog,
                   lane_i, lane_f, out_reward, out_queues, out_events, d, k);
  return 0;
#else
  cudaError_t err = cudaFuncSetAttribute(
      itscp_hybrid_episode_fwd_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  itscp_hybrid_episode_fwd_kernel<<<1, threads, smem,
                                    (cudaStream_t)stream>>>(
      action, sched, mnext, mprev, rand, inj_routes, emit_routes, prog,
      lane_i, lane_f, out_reward, out_queues, out_events, d, k);
  return (int)cudaGetLastError();
#endif
}

}  // extern "C"
