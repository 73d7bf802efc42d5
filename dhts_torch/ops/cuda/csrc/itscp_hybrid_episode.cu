// Fused ITSCP hybrid episode for Hopper (sm_90a): forward in hard, soft or
// straight-through gate mode, and its backward.
//
// Replaces the TPU kernel K1,
// dhts/ops/pallas/itscp_hybrid_episode.py::make_fused_itscp_episode:
//   * forward (make_fwd_kernel / run_forward, pallas_call at :2130;
//     per-step `step` at :661; soft/st gates `soft`/`stg`/`gate` at
//     :454-470, the micro blend at :1393, the queue gates at :1834);
//   * backward (bwd_kernel / run_backward, pallas_call at :2244), which
//     returns d(loss)/d(action[n_phases, n_inter]).
// The forward runs a whole episode of T steps and returns (-sum(queues),
// queues[T], events[T, 8]). Its specification is the plain PyTorch version
// beside its wrapper (dhts_torch/ops/cuda/itscp_hybrid_episode.py::
// plain_episode, built on the eager boundary_and_step): every per-lane
// value is computed with the same IEEE operations in the same order (the
// build passes -fmad=false and no fast math), so events agree bit for bit
// and queues to the rounding of the lane sums.
//
// Design. One thread block per episode and one thread per lane; the T loop
// runs inside the kernel. A launch runs B independent episodes (the JAX
// kernel's `episodes=B` and its vmapped configurations), block e the
// episode e: each input has an episode stride in elements (0: shared by
// every episode), and each block keeps its own state, running means,
// queue sum and events in its own shared memory, so B episodes in one
// launch give what B launches give, bit for bit. No lane packing, no
// lane-to-episode maps: a block is an episode. A launch of one episode
// runs the kernel's instantiation without the episode axis, with the
// parameters and code the kernel had before it took one: moving the input
// pointers to a block's episode cost a launch of one episode 1.0-2.4 %
// forward on an H100. Cells, vehicles, counters and
// flux capacitors live in shared memory. The [L, V, R] route container of the JAX kernel
// is not materialised: every route in an episode is a row of one of the
// two read-only pools (waiting pool [L, P, R], emission pool [L, P2, R]),
// and vehicles only ever copy routes, so each vehicle slot holds a route
// id (the pool row) and route entries are read from global memory, where
// the pools stay L2-resident. Each step syncs the block where a lane reads
// another lane's values: after injection (signals, boundary cells), after
// the boundary/leader reads (before lanes write their new state), after
// the lanes' forward step, after the conversion requests are published,
// after arbitration, and after the conversion (before the block
// reductions); the soft modes add two syncs around each running-mean
// reduction.
// The per-lane phases are in itscp_step.cuh, shared with the fused spatial
// step (itscp_spatial_step.cu), which addresses the same state in global
// memory.
//   arbitration  pull form: each destination scans its predecessor list
//                and takes the lowest source id that wants in; no atomics.
//   reductions   queue, event counts, max wave speed and the running-mean
//                sums are taken by one thread in lane order: deterministic.
//                The running-mean sums are float64, rounded once, like the
//                plain version's (dhts_torch/utils/rms.py).
//   randomness   rand[T, L] is an input.
//   sigmoid      1 / (1 + exp(-x)) in float64, rounded once to float32,
//                like the plain version's dmath.sigmoid.
//
// Backward: forward-mode tangents, one block per episode and action entry
// (block e * n_act + j). The whole
// episode code is a template on its scalar type: `float` for the forward,
// and `Dual` (value, tangent) for the backward kernel, whose block j seeds
// the tangent of action entry j and carries d(state)/d(action_j) through
// the T steps beside the values. The value half repeats the forward's
// float operations exactly, so the backward follows the forward's discrete
// trajectory (events) by construction and needs no saved residuals: its
// inputs are the forward's inputs. Block (e, j) returns
//     grad[e, j] = sum_t w[e, t] * d(queue_{e,t})/d(action_{e,j}),
// where w[t] = d(loss)/d(queue_t) (with the reward's cotangent folded in,
// reward = -sum(queues)); that is the vector-Jacobian product of the
// backward of the TPU kernel, computed as B * n_phases * n_inter
// independent blocks (45 an episode at the 3x3 preset). Local derivatives follow PyTorch autograd of the plain version:
// max/min/clip split the gradient 0.5/0.5 at a tie (as JAX does), a
// `where` takes only the selected branch's tangent, straight-through
// gates carry the soft gate's tangent under the hard value, the emitted
// vehicle's mass carries the flux capacitor's tangent (grad_carrier), the
// decremented capacitor and the running means are detached, and the
// deposit's density clamp is straight-through (st_clip).
//
// Bound. The episode is a chain of T dependent steps, each a handful of
// block-wide barriers and short dependent global loads (the route walk);
// its inputs and outputs are a few MB, so it is latency-bound, far above
// the bytes / 3.35 TB/s floor.

#include "itscp_step.cuh"

namespace {

constexpr int NEV = 7;  // integer event rows

// the episode axis of a launch: each input's stride between episodes in
// elements (0 when every episode reads the same tensor), and the blocks of
// one episode (1 forward, n_phases * n_inter backward)
struct Episodes {
  long long action, sched, mnext, mprev, rand, inj, emit, q_weight;
  int blocks;
};

// the episode axis of a kernel's parameters: none (one episode) or one
__device__ __forceinline__ Episodes episodes_of() {
  return Episodes{0, 0, 0, 0, 0, 0, 0, 0, 1};
}
__device__ __forceinline__ Episodes episodes_of(const Episodes& ep) {
  return ep;
}

template <class S>
struct Smem {
  S *r, *y, *pos, *vel, *av, *cap;
  S *sig, *r_last, *u_last, *r_first, *u_first;
  S *cap_val, *hs_pos, *hs_vel, *hs_a, *red_q;
  float *red_wave, *ms;  // ms: signal (sum, count, const), static (same)
  double *red_sum;       // [2 L] running-mean partial sums per lane
  int *red_cnt;          // [2 L] running-mean partial counts per lane
  int *rid, *ridx, *count, *inj_left, *cursor;
  int *want, *mn, *hn, *hs_rid, *hs_ridx, *best, *dep_best, *red_ev;
};

template <class S>
__host__ __device__ inline size_t smem_bytes(const Dims& d, Smem<S>* s,
                                             char* base) {
  size_t off = 0;
  Smem<S> dummy;
  Smem<S>* t = s ? s : &dummy;
  char* b = s ? base : nullptr;
  const size_t L = d.L, LC = d.L * d.C, LV = d.L * d.V, LK = d.L * d.K;
  carve(&t->r, LC, b, off); carve(&t->y, LC, b, off);
  carve(&t->pos, LV, b, off); carve(&t->vel, LV, b, off);
  carve(&t->av, LV, b, off); carve(&t->cap, LK, b, off);
  carve(&t->sig, L, b, off); carve(&t->r_last, L, b, off);
  carve(&t->u_last, L, b, off); carve(&t->r_first, L, b, off);
  carve(&t->u_first, L, b, off); carve(&t->cap_val, L, b, off);
  carve(&t->hs_pos, L, b, off); carve(&t->hs_vel, L, b, off);
  carve(&t->hs_a, L, b, off); carve(&t->red_q, L, b, off);
  carve(&t->red_wave, L, b, off); carve(&t->ms, 8, b, off);
  carve(&t->red_sum, 2 * L, b, off); carve(&t->red_cnt, 2 * L, b, off);
  carve(&t->rid, LV, b, off); carve(&t->ridx, LV, b, off);
  carve(&t->count, L, b, off); carve(&t->inj_left, L, b, off);
  carve(&t->cursor, L, b, off); carve(&t->want, L, b, off);
  carve(&t->mn, L, b, off); carve(&t->hn, L, b, off);
  carve(&t->hs_rid, L, b, off); carve(&t->hs_ridx, L, b, off);
  carve(&t->best, L, b, off); carve(&t->dep_best, L, b, off);
  carve(&t->red_ev, NEV * L, b, off);
  return off;
}

// Thread 0 folds the lanes' partial sums red_sum[base .. base + L) into a
// running mean (sum += float(sum64), count += n; rms.update_mean_masked)
// at ms[0..1] and returns its mean (rms.mean_of with default 1).
template <class S>
__device__ __forceinline__ float fold_mean(const Smem<S>& s, int L,
                                           int base, float* ms) {
  double tot = 0.0;
  int cnt = 0;
  for (int j = 0; j < L; ++j) {
    tot += s.red_sum[base + j];
    cnt += s.red_cnt[base + j];
  }
  ms[0] = ms[0] + (float)tot;
  ms[1] = ms[1] + (float)cnt;
  return ms[1] > 0.0f ? ms[0] / fmaxf(ms[1], 1.0f) : 1.0f;
}

// One episode per block. S = float: the forward; block e writes reward[e],
// queues[e, T], events[e, T, 8] (`q_weight`/`out_grad` unused). S = Dual:
// the backward; block e * n_act + j seeds action entry j of episode e and
// writes out_grad[e * n_act + j] = sum_t q_weight[e, t] *
// d(queue_{e,t})/d(action_{e,j}) (the forward outputs are unused). The
// per-lane phases are those of itscp_step.cuh on the state in shared
// memory. A launch of one episode passes no Episodes (Ep empty): that
// instantiation has no episode axis in its parameters or its code.
template <class S, class... Ep>
__global__ void itscp_hybrid_episode_kernel(
    const float* __restrict__ action, const float* __restrict__ sched,
    const int* __restrict__ mnext, const int* __restrict__ mprev,
    const float* __restrict__ rand, const int* __restrict__ inj_routes,
    const int* __restrict__ emit_routes, const float* __restrict__ prog,
    const int* __restrict__ lane_i, const float* __restrict__ lane_f,
    float* __restrict__ out_reward, float* __restrict__ out_queues,
    float* __restrict__ out_events, const float* __restrict__ q_weight,
    float* __restrict__ out_grad, Dims d, Consts k, Ep... eps) {
  constexpr bool kBatch = sizeof...(Ep) > 0;
  const Episodes ep = episodes_of(eps...);
  DHTS_DYNAMIC_SMEM(smem_raw);
  Smem<S> s;
  smem_bytes<S>(d, &s, smem_raw);

  const int L = d.L, C = d.C, V = d.V, K = d.K;
  const int mode = d.mode;
  const int l = threadIdx.x;
  const int seed = kBatch ? blockIdx.x % ep.blocks : blockIdx.x;
  if (kBatch) {
    // this block's episode
    const int e = blockIdx.x / ep.blocks;
    action += e * ep.action; sched += e * ep.sched;
    mnext += e * ep.mnext; mprev += e * ep.mprev; rand += e * ep.rand;
    inj_routes += e * ep.inj; emit_routes += e * ep.emit;
    if (q_weight) q_weight += e * ep.q_weight;
    if (out_reward) {
      out_reward += e;
      out_queues += (size_t)e * d.T;
      out_events += (size_t)e * d.T * 8;
    }
  }
  const bool lane = l < L;
  const float u_max = k.u_max;
  const Scene sc{lane_i, lane_f, inj_routes, emit_routes};
  LaneState<S, S*, false> st{s.r, s.y, s.pos, s.vel, s.av, s.cap,
                      {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr},
                      s.rid, s.ridx, s.count, s.inj_left, s.cursor,
                      C, 1, V, 1, K, 1};
  set_defaults(st, k);

  const LaneGeom g = lane ? lane_geom(sc, L, K, l) : LaneGeom();
  auto clampL = [&](int j) { return min(max(j, 0), L - 1); };
  const int last = min(max(g.num_cell - 1, 0), C - 1);

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
    s.inj_left[l] = (!g.has_prev && !g.is_macro) ? d.P : 0;
    s.cursor[l] = 0;
  }
  if (threadIdx.x == 0)
    for (int i = 0; i < 8; ++i) s.ms[i] = 0.0f;
  float qsum = 0.0f;
  double grad = 0.0;
  __syncthreads();

  for (int t = 0; t < d.T; ++t) {
    const int tl = t * L + l;
    // ================= A: signal, injection, boundary cells ============
    int ev_inj = 0;
    float incoming = -1.0f;
    if (lane) {
      s.sig[l] = lane_signal<S>(action, prog, d, k, g, t, seed);
      incoming = g.has_prev ? -1.0f : sched[tl];
      ev_inj = inject<S>(st, g, d, k, l, rand[tl], incoming) ? 1 : 0;
      publish_edges<S>(st, s, l, last, u_max);
    }
    __syncthreads();

    // ================= B1: ghosts, leader walk (reads only) ============
    Ghosts<S> gh{0.f, 0.f, 0.f, 0.f};
    S hpd = 0.f, hsd = 0.f;
    // soft micro blend: the green leader, the red stop, the blended signal
    S pd_g = 0.f, sd_g = 0.f, red_pd = 0.f, fsig = 0.f;
    bool blend = false;
    if (lane) {
      gh = ghosts<S>(s, sc, g, L, l, mprev[tl], mnext[tl], incoming, mode,
                     k);
      if (!g.is_macro) {
        // virtual leader: walk the head vehicle's route
        const int n = s.count[l];
        const bool exists = n > 0;
        const int h = min(max(n - 1, 0), V - 1);
        const S hpos = s.pos[l * V + h], hvel = s.vel[l * V + h];
        const int hrid = s.rid[l * V + h], hridx = s.ridx[l * V + h];
        bool any_term = false, occupied = false;
        int lead = 0;
        double crossed = 0.0;  // exact for these few lengths
        for (int o = 1; o <= d.W; ++o) {
          const int w = route_at(inj_routes, emit_routes, hrid, hridx + o, d);
          if (w < 0) { any_term = true; break; }
          if (sc.macro_at(w)) { any_term = true; break; }
          if (s.count[w] > 0) {
            any_term = true; occupied = true; lead = w; break;
          }
          crossed += (double)sc.length_at(w);
        }
        const S cur_delta = (S(g.length) - hpos) - S(k.veh_len * 0.5f) +
                            S((float)crossed);
        const bool found = exists && any_term && occupied;
        pd_g = found ? vmax((cur_delta + s.pos[lead * V]) -
                                S(k.veh_len * 0.5f), S(0.0f))
                     : S(1000.0f);
        sd_g = found ? hvel - s.vel[lead * V] : S(0.0f);
        // the signal of the lane the head is on
        red_pd = vmax((S(g.length) - hpos) - S(k.veh_len * 0.5f), S(0.0f));
        const int curr = route_at(inj_routes, emit_routes, hrid,
                                  min(max(hridx, 0), d.R - 1), d);
        if (mode == HARD) {
          const float fs = val(s.sig[clampL(curr)]);
          if (exists) {
            const bool green = fs >= 0.5f;
            hpd = green ? pd_g : red_pd;
            hsd = green ? sd_g : S(0.0f);
          } else {
            hpd = pd_g; hsd = sd_g;
          }
        } else if (exists) {
          // position scores on the previous, current and next lane
          const int prev_l = hridx > 0 ? route_at(inj_routes, emit_routes,
                                                  hrid, hridx - 1, d)
                                       : -1;
          const int next_l = hridx + 1 < d.R
                                 ? route_at(inj_routes, emit_routes, hrid,
                                            hridx + 1, d)
                                 : -1;
          const bool prev_exist = prev_l >= 0, next_exist = next_l >= 0;
          S p_sc = prev_exist ? stg(false, soft(-hpos, 16.0f), mode)
                              : S(0.0f);
          S c_sc = stg(true, soft(hpos, 16.0f) *
                                 soft(S(g.length) - hpos, 16.0f), mode);
          S n_sc = next_exist
                       ? stg(false, soft(hpos - S(g.length), 16.0f), mode)
                       : S(0.0f);
          const S ssum = (p_sc + c_sc) + n_sc;
          p_sc = p_sc / ssum; c_sc = c_sc / ssum; n_sc = n_sc / ssum;
          fsig = c_sc * s.sig[clampL(curr)];
          fsig = fsig + (prev_exist ? p_sc * s.sig[clampL(prev_l)] : S(0.0f));
          fsig = fsig + (next_exist ? n_sc * s.sig[clampL(next_l)] : S(0.0f));
          blend = true;
        } else {
          hpd = pd_g; hsd = sd_g;
        }
      }
    }
    if (mode != HARD) {
      // running mean of the blended signal; its detached mean sharpens
      // the blend gate (env boundary_and_step, signal_ms)
      if (lane) {
        s.red_sum[l] = blend ? (double)val(fsig) : 0.0;
        s.red_cnt[l] = blend ? 1 : 0;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        const float mean = fold_mean(s, L, 0, s.ms);
        s.ms[2] = k.gate32 / fmaxf(fabsf(mean), 1e-6f);
      }
      __syncthreads();
      if (blend) {
        const float c = s.ms[2];
        const S fs = stg(val(fsig) >= 0.5f, soft(fsig - S(0.5f), c), mode);
        hpd = pd_g * fs + red_pd * (S(1.0f) - fs);
        hsd = sd_g * fs;
      }
    }
    __syncthreads();

    // ================= B2: Godunov (macro) and IDM (micro) =============
    float lane_wave = 0.0f;
    if (lane) {
      if (g.is_macro)
        lane_wave = godunov_lane<S>(st, g, l, C, gh, k);
      else
        idm_lane<S>(st, l, hpd, hsd, k);
    }
    __syncthreads();

    // ================= C1: conversion requests ==========================
    Request<S> rq;
    if (lane) rq = request<S>(st, s, sc, g, d, k, l, mnext[tl], last);
    __syncthreads();

    // ================= C2: arbitration (pull, lowest source id) ========
    if (lane) arbitrate(s, sc, L, K, l);
    __syncthreads();

    // ================= C3: verdicts, removals, inserts, deposits =======
    int n_after = 0;
    if (lane) {
      const Verdict vd = convert<S>(st, s, sc, g, rq, d, k, l);
      n_after = vd.n;
      const int ev[NEV] = {ev_inj,
                           vd.is_emit,
                           vd.exit_none || vd.dep_win,
                           vd.has_insert && !vd.is_emit,
                           vd.tr_win,
                           vd.dep_win,
                           vd.remove};
      s.red_wave[l] = lane_wave;
      for (int e = 0; e < NEV; ++e) s.red_ev[e * L + l] = ev[e];
    }

    // ---- queue of this lane
    float c_st = 0.0f;
    if (mode != HARD) {
      // running mean of (static_speed - speed) over macro cells, then over
      // micro vehicles; its detached mean sharpens the queue gates
      if (lane) static_partials<S>(st, s, g, L, l, n_after, k);
      __syncthreads();
      if (threadIdx.x == 0) {
        fold_mean(s, L, 0, s.ms + 3);
        const float mean = fold_mean(s, L, L, s.ms + 3);
        s.ms[5] = 16.0f / fmaxf(fabsf(mean), 1e-6f);
      }
      __syncthreads();
      c_st = s.ms[5];
    }
    if (lane) {
      const S q_lane = lane_queue<S>(st, g, l, n_after, mode, c_st, k);
      s.red_q[l] = q_lane * q_lane;
    }
    __syncthreads();

    // ================= D: block reductions in lane order ===============
    if (threadIdx.x == 0) {
      S qs = 0.0f;
      float wave = 0.0f;
      for (int j = 0; j < L; ++j) {
        qs = qs + s.red_q[j];
        wave = fmaxf(wave, s.red_wave[j]);
      }
      const S queue = qs * S(k.dt);
      qsum += val(queue);
      if (q_weight) grad += (double)q_weight[t] * (double)tangent(queue);
      if (out_queues) {
        out_queues[t] = val(queue);
        for (int e = 0; e < NEV; ++e) {
          int tot = 0;
          for (int j = 0; j < L; ++j) tot += s.red_ev[e * L + j];
          out_events[t * 8 + e] = (float)tot;
        }
        out_events[t * 8 + 7] = wave;
      }
    }
    // the next step's first writes touch none of the reduced arrays
  }
  if (threadIdx.x == 0) {
    if (out_reward) out_reward[0] = -qsum;
    if (out_grad) out_grad[kBatch ? (int)blockIdx.x : seed] = (float)grad;
  }
}

// one launch of `kernel` with `smem` bytes of dynamic shared memory
template <class Kernel, class... Args>
int start(Kernel kernel, int blocks, int threads, size_t smem, void* stream,
          Args... args) {
#ifdef DHTS_CPU_EMULATION
  (void)stream;
  dhts_emu::launch(blocks, threads, smem, kernel, args...);
  return 0;
#else
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
#endif
}

// shared launch path of the forward (S = float, one block per episode)
// and the backward (S = Dual, one block per episode and action entry);
// B = 1 launches the instantiation without the episode axis
template <class S>
int launch(int B, const Episodes& ep, const float* action, const float* sched,
           const int* mnext, const int* mprev, const float* rand,
           const int* inj_routes, const int* emit_routes, const float* prog,
           const int* lane_i, const float* lane_f, float* out_reward,
           float* out_queues, float* out_events, const float* q_weight,
           float* out_grad, const Dims& d, const Consts& k, void* stream) {
  if (d.L < 1 || d.L > 1024 || d.C < 1 || d.C > MAXC || d.V < 1 ||
      d.R < 1 || d.K < 1 || d.mode < HARD || d.mode > ST || B < 1 ||
      ep.blocks < 1 || (long long)B * ep.blocks > 0x7fffffffLL)
    return 1;  // cudaErrorInvalidValue
  const int blocks = B * ep.blocks;
  const size_t smem = smem_bytes<S>(d, nullptr, nullptr);
  const int threads = ((d.L + 31) / 32) * 32;
  if (B == 1)
    return start(itscp_hybrid_episode_kernel<S>, blocks, threads, smem,
                 stream, action, sched, mnext, mprev, rand, inj_routes,
                 emit_routes, prog, lane_i, lane_f, out_reward, out_queues,
                 out_events, q_weight, out_grad, d, k);
  return start(itscp_hybrid_episode_kernel<S, Episodes>, blocks, threads,
               smem, stream, action, sched, mnext, mprev, rand, inj_routes,
               emit_routes, prog, lane_i, lane_f, out_reward, out_queues,
               out_events, q_weight, out_grad, d, k, ep);
}

}  // namespace

extern "C" {

// Dynamic shared memory of the forward (tangent = 0) or the backward
// (tangent = 1) for these sizes (bytes).
size_t itscp_hybrid_episode_smem(int L, int C, int V, int K, int tangent) {
  Dims d{};
  d.L = L; d.C = C; d.V = V; d.K = K;
  return tangent ? smem_bytes<Dual>(d, nullptr, nullptr)
                 : smem_bytes<float>(d, nullptr, nullptr);
}

// Forward: B episodes in gate mode `mode` (0 hard, 1 soft, 2
// straight-through) on `stream`, one block each: out_reward[B],
// out_queues[B, T], out_events[B, T, 8]. s_* is each input's stride
// between episodes in elements (0: shared; s_qw unused here). Returns
// cudaGetLastError() of the launch.
int launch_itscp_hybrid_episode_fwd(
    const float* action, const float* sched, const int* mnext,
    const int* mprev, const float* rand, const int* inj_routes,
    const int* emit_routes, const float* prog, const int* lane_i,
    const float* lane_f, float* out_reward, float* out_queues,
    float* out_events, int B, long long s_action, long long s_sched,
    long long s_mnext, long long s_mprev, long long s_rand, long long s_inj,
    long long s_emit, long long s_qw, int T, int L, int C, int V, int R, int P, int P2,
    int K, int W, int nsf, int n_phases, int n_inter, int mode, float u_max,
    float dt, float veh_len, float static_speed, float rare_den, float third,
    float amax, float apref, float tgt, float min_space, float time_pref,
    float rho_hi, float gate32, void* stream) {
  Dims d{T, L, C, V, R, P, P2, K, W, nsf, n_phases, n_inter, mode};
  Consts k{u_max, dt, veh_len, static_speed, rare_den, third, amax,
           apref, tgt, min_space, time_pref, rho_hi, gate32};
  (void)s_qw;
  const Episodes ep{s_action, s_sched, s_mnext, s_mprev, s_rand, s_inj,
                    s_emit, 0, 1};
  return launch<float>(B, ep, action, sched, mnext, mprev, rand, inj_routes,
                       emit_routes, prog, lane_i, lane_f, out_reward,
                       out_queues, out_events, nullptr, nullptr, d, k,
                       stream);
}

// Backward of the soft (1) or straight-through (2) forward of B episodes:
// out_grad[B, n_phases * n_inter] = sum_t q_weight[e, t] *
// d(queue_{e,t})/d(action_e), one block per episode and action entry
// (episode-major); the strides as the forward's, s_qw q_weight's. Returns
// cudaGetLastError() of the launch.
int launch_itscp_hybrid_episode_bwd(
    const float* action, const float* sched, const int* mnext,
    const int* mprev, const float* rand, const int* inj_routes,
    const int* emit_routes, const float* prog, const int* lane_i,
    const float* lane_f, const float* q_weight, float* out_grad, int B,
    long long s_action, long long s_sched, long long s_mnext,
    long long s_mprev, long long s_rand, long long s_inj, long long s_emit,
    long long s_qw, int T,
    int L, int C, int V, int R, int P, int P2, int K, int W, int nsf,
    int n_phases, int n_inter, int mode, float u_max, float dt,
    float veh_len, float static_speed, float rare_den, float third,
    float amax, float apref, float tgt, float min_space, float time_pref,
    float rho_hi, float gate32, void* stream) {
  if (mode == HARD || n_phases < 1 || n_inter < 1) return 1;
  Dims d{T, L, C, V, R, P, P2, K, W, nsf, n_phases, n_inter, mode};
  Consts k{u_max, dt, veh_len, static_speed, rare_den, third, amax,
           apref, tgt, min_space, time_pref, rho_hi, gate32};
  const Episodes ep{s_action, s_sched, s_mnext, s_mprev, s_rand, s_inj,
                    s_emit, s_qw, n_phases * n_inter};
  return launch<Dual>(B, ep, action, sched, mnext, mprev, rand,
                      inj_routes, emit_routes, prog, lane_i, lane_f, nullptr,
                      nullptr, nullptr, q_weight, out_grad, d, k, stream);
}

}  // extern "C"
