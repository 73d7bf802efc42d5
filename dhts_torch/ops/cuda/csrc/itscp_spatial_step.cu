// One step of the fused spatial ITSCP episode on one lane shard, for Hopper
// (sm_90a): a forward in hard or soft gate mode, and its forward-mode
// derivative.
//
// Replaces, on a one-shard lane axis, the TPU kernels K6 and K5 of
// dhts/ops/pallas/itscp_spatial_step.py: body_STEP (:826, the whole step
// A + B + C + conversion + E with the running-mean sums inlined), wrapped by
// make_dkernel at :930 (dhts/ops/pallas/dkernel.py: forward pallas_call at
// :63, recompute-and-transpose backward at :91). The specification is the
// plain PyTorch step beside the wrapper
// (dhts_torch/ops/cuda/itscp_spatial_step.py::plain_spatial_step): every
// per-lane value is computed with the same IEEE operations in the same order
// (the build passes -fmad=false and no fast math), and the lane sums are
// taken in float64 and rounded once on both sides, so carries, events and
// queues agree bit for bit.
//
// Design. One launch is one simulation step. One thread block per episode
// (forward) and one thread per lane. The carry stays in global memory
// between launches, packed per episode as one float row (r, y [C, L]; pos,
// vel, av and six vehicle parameters [V, L]; cap [K, L]; the signal and
// static running-mean sums) and one int row (count [L]; route id and route
// index [V, L]; waiting-pool and emission-pool cursors [L]); the offsets
// are `layout` here and float_layout/int_layout in the wrapper. A lane's
// thread reads and writes its own lane of the carry; what other lanes read
// (signals, edge cells, tails, heads, wants, arbitration verdicts) goes
// through per-lane summaries in shared memory, the port of the JAX step's
// gathered summary rows. The block syncs where a lane reads another's
// summary: after injection, after the signal running mean, after the
// physics, after the conversion requests, after arbitration, after the
// static running mean and before the block reductions. Reductions (running
// means, queue, events, max wave speed) are taken by one thread in lane
// order, the sums in float64 rounded once. The per-lane phases (signal,
// injection, ghosts, Godunov and IDM updates, conversion requests,
// arbitration, verdicts and deposits, queue) are K1's, from
// itscp_step.cuh; the leader walk, the blend and the reductions follow
// body_STEP.
//
// Derivative: forward-mode tangents. The step is a template on its scalar
// type: `float` in the forward, `Dual` (value, tangent) in the derivative,
// whose launch has one block per (episode b, action entry j) and carries
// d(carry)/d(action_j) beside the values in a tangent row of the same
// layout. Each launch adds w[b, t] * d(queue_t)/d(action_j) to a float64
// accumulator; the value half repeats the forward's float operations, so
// no residuals are saved. Local derivatives follow autograd of the plain
// step (max/min split a tie 0.5/0.5, a `where` takes the selected branch's
// tangent, detached running means and decremented capacitors, the emitted
// vehicle's mass carries the capacitor's tangent, the deposit's clamp is
// straight through, and a speed stopped by the acceleration floor has a
// zero tangent).
//
// Bound. A step is a handful of block-wide barriers and short chains of
// dependent global loads per lane; it must move only the macro cells, the
// vehicles present and the counters of each episode, tens of KB, so it is
// latency-bound, far above the bytes / 3.35 TB/s floor.

#include "itscp_step.cuh"

namespace {

struct Ptrs {
  float* fbuf;  // [N, fsize] values
  float* dbuf;  // [N, fsize] tangents (derivative only)
  int* ibuf;    // [N, isize]
  const float* action;  // [n_phases, n_inter]
  const float* rand;    // [B, T, L]
  const float* sched;   // [T, L]
  const int* mnext;     // [T, L]
  const int* mprev;     // [T, L]
  const int* routes;    // [L * P + L * P2, R]
  const float* prog;    // [nsf]
  const int* lane_i;    // [8 + 2K, L]
  const float* lane_f;  // [2, L]
  float* out_queue;     // forward: [B, T]
  int* out_events;      // forward: [B, T, 3]
  float* out_wave;      // forward: [B, T]
  const float* q_weight;  // derivative: [B, T]
  double* grad;           // derivative: [B * n_act]
};

// offsets of the packed carry (float_layout / int_layout of the wrapper)
struct Layout {
  int r, y, pos, vel, av, amax, apref, vt, ms, tp, len, cap, sg, ss, fsize;
  int count, rid, ridx, inj_left, cursor, isize;
};

__host__ __device__ inline Layout layout(const Dims& d) {
  const int CL = d.C * d.L, VL = d.V * d.L, KL = d.K * d.L;
  Layout o;
  o.r = 0; o.y = CL; o.pos = 2 * CL; o.vel = o.pos + VL; o.av = o.vel + VL;
  o.amax = o.av + VL; o.apref = o.amax + VL; o.vt = o.apref + VL;
  o.ms = o.vt + VL; o.tp = o.ms + VL; o.len = o.tp + VL;
  o.cap = o.len + VL; o.sg = o.cap + KL; o.ss = o.sg + 2;
  o.fsize = o.ss + 2;
  o.count = 0; o.rid = d.L; o.ridx = d.L + VL; o.inj_left = d.L + 2 * VL;
  o.cursor = 2 * d.L + 2 * VL; o.isize = 3 * d.L + 2 * VL;
  return o;
}

template <class S>
__device__ __forceinline__ S from_parts(float v, float d);
template <>
__device__ __forceinline__ float from_parts<float>(float v, float) {
  return v;
}
template <>
__device__ __forceinline__ Dual from_parts<Dual>(float v, float d) {
  return Dual(v, d);
}

// per-lane summaries other lanes read, and the block's reduction scratch
template <class S>
struct Smem {
  S *sig, *r_last, *u_last, *r_first, *u_first, *tpos, *tvel, *cap_val;
  S *hs_pos, *hs_vel, *hs_a, *red_q;
  float *tlen, *hs_len, *hs_par, *red_wave, *ms;  // hs_par: [5 L]
  double* red_sum;  // [2 L]
  int *red_cnt;     // [2 L]
  int *count, *want, *mn, *hn, *hs_rid, *hs_ridx, *best, *dep_best, *ev;
};

template <class S>
__host__ __device__ inline size_t smem_bytes(const Dims& d, Smem<S>* s,
                                             char* base) {
  size_t off = 0;
  Smem<S> dummy;
  Smem<S>* t = s ? s : &dummy;
  char* b = s ? base : nullptr;
  const size_t L = d.L;
  S** sf[] = {&t->sig, &t->r_last, &t->u_last, &t->r_first, &t->u_first,
              &t->tpos, &t->tvel, &t->cap_val, &t->hs_pos, &t->hs_vel,
              &t->hs_a, &t->red_q};
  for (S** p : sf) carve(p, L, b, off);
  carve(&t->tlen, L, b, off); carve(&t->hs_len, L, b, off);
  carve(&t->hs_par, 5 * L, b, off); carve(&t->red_wave, L, b, off);
  carve(&t->ms, 4, b, off);
  carve(&t->red_sum, 2 * L, b, off); carve(&t->red_cnt, 2 * L, b, off);
  int** si[] = {&t->count, &t->want, &t->mn, &t->hn, &t->hs_rid,
                &t->hs_ridx, &t->best, &t->dep_best};
  for (int** p : si) carve(p, L, b, off);
  carve(&t->ev, 3 * L, b, off);
  return off;
}

// One step t of one episode (S = float; block e is episode e) or of one
// dual episode (S = Dual; block e is episode e / n_act seeding action entry
// e % n_act). The per-lane phases are those of itscp_step.cuh on the
// episode's carry in global memory.
template <class S>
__global__ void spatial_step_kernel(Ptrs p, Dims d, Consts k, int t) {
  DHTS_DYNAMIC_SMEM(smem_raw);
  Smem<S> s;
  smem_bytes<S>(d, &s, smem_raw);

  const int L = d.L, C = d.C, V = d.V, K = d.K, R = d.R;
  const bool soft_mode = d.mode != HARD;
  const int l = threadIdx.x;
  const bool lane = l < L;
  const int e = blockIdx.x;
  const bool dual = p.dbuf != nullptr;
  const int n_act = d.n_phases * d.n_inter;
  const int b = dual ? e / n_act : e;
  const int seed = dual ? e % n_act : -1;
  const int tl = t * L + l;

  // this episode's carry
  const Layout o = layout(d);
  float* F = p.fbuf + (size_t)e * o.fsize;
  float* D = dual ? p.dbuf + (size_t)e * o.fsize : nullptr;
  int* I = p.ibuf + (size_t)e * o.isize;
  auto fa = [&](int off) { return FA{F + off, D ? D + off : nullptr}; };
  LaneState<S, FA, true> st{fa(o.r), fa(o.y), fa(o.pos), fa(o.vel), fa(o.av),
                      fa(o.cap),
                      {F + o.amax, F + o.apref, F + o.vt, F + o.ms,
                       F + o.tp, F + o.len},
                      I + o.rid, I + o.ridx, I + o.count, I + o.inj_left,
                      I + o.cursor, 1, L, 1, L, 1, L};
  set_defaults(st, k);
  float* len_ = st.par[5];
  float* sg_ms = F + o.sg;
  float* ss_ms = F + o.ss;

  const Scene sc{p.lane_i, p.lane_f, p.routes, p.routes + L * d.P * R};
  const LaneGeom g = lane ? lane_geom(sc, L, K, l) : LaneGeom();
  auto clampL = [&](int j) { return min(max(j, 0), L - 1); };
  const int last = min(max(g.num_cell - 1, 0), C - 1);

  // ================= A: signal, edge cells, injection ====================
  int ev_inj = 0;
  float incoming = -1.0f;
  if (lane) {
    s.sig[l] = lane_signal<S>(p.action, p.prog, d, k, g, t, seed);
    incoming = g.has_prev ? -1.0f : p.sched[tl];
    publish_edges<S>(st, s, l, last, k.u_max);
    ev_inj = inject<S>(st, g, d, k, l, p.rand[((size_t)b * d.T + t) * L + l],
                       incoming) ? 1 : 0;
    // the tail summary row the leader walks read
    s.count[l] = st.count[l];
    s.tpos[l] = ld<S>(st.pos, l);
    s.tvel[l] = ld<S>(st.vel, l);
    s.tlen[l] = len_[l];
  }
  __syncthreads();

  // ================= B: ghosts, leader walk, the head's signal ===========
  Ghosts<S> gh{0.f, 0.f, 0.f, 0.f};
  S pd_g = 0.f, sd_g = 0.f, red_pd = 0.f, fsig = 0.f;
  bool blend = false;
  if (lane) {
    gh = ghosts<S>(s, sc, g, L, l, p.mprev[tl], p.mnext[tl], incoming,
                   d.mode, k);
    if (!g.is_macro) {
      // virtual leader: walk the head vehicle's route
      const int n = st.count[l];
      const bool exists = n > 0;
      const int h = min(max(n - 1, 0), V - 1);
      const S hpos = ld<S>(st.pos, h * L + l), hvel = ld<S>(st.vel, h * L + l);
      const float hlen = len_[h * L + l];
      const int hrid = st.rid[h * L + l], hridx = st.ridx[h * L + l];
      const S base = (S(g.length) - hpos) - S(hlen * 0.5f);
      bool done = !exists, found = false;
      int wstar = -1;
      S cdel_st = 0.0f, cur = base;
      for (int q = 0; q < d.W && !done; ++q) {
        const int wl = route_at(sc.inj, sc.emit, hrid, hridx + 1 + q, d);
        const bool ex = wl >= 0;
        const int wc = clampL(wl);
        const bool w_macro = ex && sc.macro_at(wc);
        if (ex && !w_macro && s.count[wc] > 0) {
          wstar = wl; cdel_st = detached(cur); found = true; done = true;
        } else if (!ex || w_macro) {
          done = true;
        } else {
          cur = cur + S(sc.length_at(wc));
        }
      }
      if (found) {
        const S cdel = cdel_st + (base - detached(base));
        pd_g = vmax((cdel + s.tpos[wstar]) - S(s.tlen[wstar] * 0.5f),
                    S(0.0f));
        sd_g = hvel - s.tvel[wstar];
      } else {
        pd_g = 1000.0f;
        sd_g = 0.0f;
      }
      // the signal the head sees, blended over its previous, current and
      // next route lane
      red_pd = vmax((S(g.length) - hpos) - S(hlen * 0.5f), S(0.0f));
      const int prev_l = route_at(sc.inj, sc.emit, hrid, hridx - 1, d);
      const int next_l = route_at(sc.inj, sc.emit, hrid, hridx + 1, d);
      const int curr_l = route_at(sc.inj, sc.emit, hrid, hridx, d);
      const bool prev_exist = prev_l >= 0, next_exist = next_l >= 0;
      S p_sc, c_sc, n_sc;
      if (soft_mode) {
        p_sc = prev_exist ? soft(-hpos, 16.0f) : S(0.0f);
        c_sc = soft(hpos, 16.0f) * soft(S(g.length) - hpos, 16.0f);
        n_sc = next_exist ? soft(hpos - S(g.length), 16.0f) : S(0.0f);
      } else {
        p_sc = 0.0f; c_sc = 1.0f; n_sc = 0.0f;
      }
      const S ssum = (p_sc + c_sc) + n_sc;
      p_sc = p_sc / ssum; c_sc = c_sc / ssum; n_sc = n_sc / ssum;
      auto sig_at = [&](int j) { return j >= 0 ? s.sig[clampL(j)] : S(0.0f); };
      fsig = c_sc * sig_at(curr_l);
      fsig = fsig + (prev_exist ? p_sc * sig_at(prev_l) : S(0.0f));
      fsig = fsig + (next_exist ? n_sc * sig_at(next_l) : S(0.0f));
      blend = exists;
    }
    s.red_sum[l] = blend ? (double)val(fsig) : 0.0;
    s.red_cnt[l] = blend ? 1 : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // signal running mean (sum, count); its detached mean sharpens the
    // blend gate
    double tot = 0.0;
    int cnt = 0;
    for (int j = 0; j < L; ++j) { tot += s.red_sum[j]; cnt += s.red_cnt[j]; }
    sg_ms[0] = sg_ms[0] + (float)tot;
    sg_ms[1] = sg_ms[1] + (float)cnt;
    const float mean = sg_ms[0] / fmaxf(sg_ms[1], 1.0f);
    s.ms[0] = k.gate32 / fmaxf(fabsf(mean), 1e-6f);
  }
  __syncthreads();

  // ================= C: physics =========================================
  float lane_wave = 0.0f;
  if (lane) {
    if (g.is_macro) {
      lane_wave = godunov_lane<S>(st, g, l, C, gh, k);
    } else {
      S pd = pd_g, sd = sd_g;
      if (blend) {
        if (soft_mode) {
          const S fs = soft(fsig - S(0.5f), s.ms[0]);
          pd = pd_g * fs + red_pd * (S(1.0f) - fs);
          sd = sd_g * fs;
        } else {
          const bool green = val(fsig) >= 0.5f;
          pd = green ? pd_g : red_pd;
          sd = green ? sd_g : S(0.0f);
        }
      }
      idm_lane<S>(st, l, pd, sd, k);
    }
  }
  __syncthreads();

  // ================= D1: conversion requests ============================
  Request<S> rq;
  if (lane) rq = request<S>(st, s, sc, g, d, k, l, p.mnext[tl], last);
  __syncthreads();

  // ================= D2: arbitration (pull, lowest source id) ===========
  if (lane) arbitrate(s, sc, L, K, l);
  __syncthreads();

  // ================= D3: verdicts, removals, inserts, deposits ==========
  if (lane) {
    const Verdict vd = convert<S>(st, s, sc, g, rq, d, k, l);
    s.ev[l] = ev_inj;
    s.ev[L + l] = vd.is_emit ? 1 : 0;
    s.ev[2 * L + l] = (vd.exit_none || vd.dep_win) ? 1 : 0;
    s.red_wave[l] = lane_wave;
    // static running-mean partial sums of this lane, after the conversion
    static_partials<S>(st, s, g, L, l, vd.n, k);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double cells = 0.0, vehs = 0.0;
    int nc = 0, nv = 0;
    for (int j = 0; j < L; ++j) {
      cells += s.red_sum[j]; vehs += s.red_sum[L + j];
      nc += s.red_cnt[j]; nv += s.red_cnt[L + j];
    }
    ss_ms[0] = ss_ms[0] + ((float)cells + (float)vehs);
    ss_ms[1] = ss_ms[1] + ((float)nc + (float)nv);
    const float mean = ss_ms[0] / fmaxf(ss_ms[1], 1.0f);
    s.ms[1] = 16.0f / fmaxf(fabsf(mean), 1e-6f);
  }
  __syncthreads();

  // ================= E: the queue of this lane ==========================
  if (lane) {
    const S q = lane_queue<S>(st, g, l, st.count[l], d.mode, s.ms[1], k);
    s.red_q[l] = q * q;
  }
  __syncthreads();

  // ================= block reductions in lane order =====================
  if (threadIdx.x == 0) {
    double qv = 0.0, qd = 0.0;
    float wave = 0.0f;
    int ev[3] = {0, 0, 0};
    for (int j = 0; j < L; ++j) {
      qv += (double)val(s.red_q[j]);
      qd += (double)tangent(s.red_q[j]);
      wave = fmaxf(wave, s.red_wave[j]);
      for (int q = 0; q < 3; ++q) ev[q] += s.ev[q * L + j];
    }
    const S queue = from_parts<S>((float)qv, (float)qd) * S(k.dt);
    const size_t bt = (size_t)b * d.T + t;
    if (dual) {
      p.grad[e] += (double)p.q_weight[bt] * (double)tangent(queue);
    } else {
      p.out_queue[bt] = val(queue);
      for (int q = 0; q < 3; ++q) p.out_events[bt * 3 + q] = ev[q];
      p.out_wave[bt] = wave;
    }
  }
}

// n_steps launches from step t0: forward (S = float, B blocks) or
// derivative (S = Dual, B * n_act blocks)
template <class S>
int launch(int blocks, const Ptrs& p, const Dims& d, const Consts& k,
           int t0, int n_steps, void* stream) {
  if (d.L < 1 || d.L > 1024 || d.C < 1 || d.C > MAXC || d.V < 1 ||
      d.R < 1 || d.K < 1 || d.mode < HARD || d.mode > 1 || blocks < 1 ||
      t0 < 0 || n_steps < 0 || t0 + n_steps > d.T)
    return 1;  // cudaErrorInvalidValue
  const size_t smem = smem_bytes<S>(d, nullptr, nullptr);
  const int threads = ((d.L + 31) / 32) * 32;
#ifdef DHTS_CPU_EMULATION
  (void)stream;
  for (int t = t0; t < t0 + n_steps; ++t)
    dhts_emu::launch(blocks, threads, smem, spatial_step_kernel<S>, p, d, k,
                     t);
  return 0;
#else
  cudaError_t err = cudaFuncSetAttribute(
      spatial_step_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int t = t0; t < t0 + n_steps; ++t) {
    spatial_step_kernel<S><<<blocks, threads, smem, (cudaStream_t)stream>>>(
        p, d, k, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
#endif
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of the forward (tangent = 0) or the
// derivative (tangent = 1) at L lanes (bytes).
size_t itscp_spatial_step_smem(int L, int tangent) {
  Dims d{};
  d.L = L;
  return tangent ? smem_bytes<Dual>(d, nullptr, nullptr)
                 : smem_bytes<float>(d, nullptr, nullptr);
}

// Forward: n_steps steps from t0 of the B episodes packed in (fbuf, ibuf),
// in place; writes queues[B, T], events[B, T, 3] (int32) and waves[B, T]
// at each step's column. Returns cudaGetLastError() of the launches.
int launch_itscp_spatial_step_fwd(
    float* fbuf, float* dbuf, int* ibuf, const float* action,
    const float* rand, const float* sched, const int* mnext,
    const int* mprev, const int* routes, const float* prog,
    const int* lane_i, const float* lane_f, void* out0, void* out1,
    void* out2, int B, int t0, int n_steps, int T, int L, int C, int V,
    int R, int P, int P2, int K, int W, int nsf, int n_phases, int n_inter,
    int mode, float u_max, float dt, float veh_len, float static_speed,
    float rare_den, float third, float amax, float apref, float tgt,
    float min_space, float time_pref, float rho_hi, float gate32,
    void* stream) {
  (void)dbuf;
  Dims d{T, L, C, V, R, P, P2, K, W, nsf, n_phases, n_inter, mode};
  Consts k{u_max, dt, veh_len, static_speed, rare_den, third, amax,
           apref, tgt, min_space, time_pref, rho_hi, gate32};
  Ptrs p{fbuf, nullptr, ibuf, action, rand, sched, mnext, mprev, routes,
         prog, lane_i, lane_f, (float*)out0, (int*)out1, (float*)out2,
         nullptr, nullptr};
  if (!out0 || !out1 || !out2) return 1;
  return launch<float>(B, p, d, k, t0, n_steps, stream);
}

// Derivative of the soft forward: n_steps steps from t0 of the B * n_act
// dual episodes packed in (fbuf, dbuf, ibuf), in place; block b * n_act + j
// adds q_weight[b, t] * d(queue_t)/d(action_j) to grad[b * n_act + j]
// (float64) at each step. Returns cudaGetLastError() of the launches.
int launch_itscp_spatial_step_bwd(
    float* fbuf, float* dbuf, int* ibuf, const float* action,
    const float* rand, const float* sched, const int* mnext,
    const int* mprev, const int* routes, const float* prog,
    const int* lane_i, const float* lane_f, void* out0, void* out1,
    void* out2, int B, int t0, int n_steps, int T, int L, int C, int V,
    int R, int P, int P2, int K, int W, int nsf, int n_phases, int n_inter,
    int mode, float u_max, float dt, float veh_len, float static_speed,
    float rare_den, float third, float amax, float apref, float tgt,
    float min_space, float time_pref, float rho_hi, float gate32,
    void* stream) {
  (void)out2;
  if (mode == HARD || n_phases < 1 || n_inter < 1 || !dbuf || !out0 ||
      !out1)
    return 1;
  Dims d{T, L, C, V, R, P, P2, K, W, nsf, n_phases, n_inter, mode};
  Consts k{u_max, dt, veh_len, static_speed, rare_den, third, amax,
           apref, tgt, min_space, time_pref, rho_hi, gate32};
  Ptrs p{fbuf, dbuf, ibuf, action, rand, sched, mnext, mprev, routes,
         prog, lane_i, lane_f, nullptr, nullptr, nullptr,
         (const float*)out0, (double*)out1};
  return launch<Dual>(B * n_phases * n_inter, p, d, k, t0, n_steps,
                      stream);
}

}  // extern "C"
