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
// runs inside the kernel. Cells, vehicles, counters and flux capacitors
// live in shared memory. The [L, V, R] route container of the JAX kernel
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
// Backward: forward-mode tangents, one block per action entry. The whole
// episode code is a template on its scalar type: `float` for the forward,
// and `Dual` (value, tangent) for the backward kernel, whose block j seeds
// the tangent of action entry j and carries d(state)/d(action_j) through
// the T steps beside the values. The value half repeats the forward's
// float operations exactly, so the backward follows the forward's discrete
// trajectory (events) by construction and needs no saved residuals: its
// inputs are the forward's inputs. Block j returns
//     grad[j] = sum_t w[t] * d(queue_t)/d(action_j),
// where w[t] = d(loss)/d(queue_t) (with the reward's cotangent folded in,
// reward = -sum(queues)); that is the vector-Jacobian product of the
// backward of the TPU kernel, computed as n_phases * n_inter independent
// blocks (45 at the 3x3 preset, fewer than the card's 132 SMs) that run at
// once. Local derivatives follow PyTorch autograd of the plain version:
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
constexpr int HARD = 0, ST = 2;  // gate modes; 1 is soft

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
// scalars: float (forward) and Dual (value and tangent, backward). Every
// Dual operation computes its value with exactly the float operation the
// forward uses.
// ---------------------------------------------------------------------------

struct Dual {
  float v, d;
  __device__ Dual() {}
  __device__ Dual(float v_) : v(v_), d(0.0f) {}
  __device__ Dual(float v_, float d_) : v(v_), d(d_) {}
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  return Dual(a.v + b.v, a.d + b.d);
}
__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
  return Dual(a.v - b.v, a.d - b.d);
}
__device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return Dual(q, (a.d - q * b.d) / b.v);
}

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(Dual x) { return x.v; }
__device__ __forceinline__ float tangent(float) { return 0.0f; }
__device__ __forceinline__ float tangent(Dual x) { return x.d; }

// max/min with a tie splitting the tangent 0.5/0.5 (jnp.maximum, and
// torch.maximum between tensors)
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ Dual vmax(Dual a, Dual b) {
  return Dual(fmaxf(a.v, b.v),
              a.v > b.v ? a.d : (a.v < b.v ? b.d : 0.5f * (a.d + b.d)));
}
__device__ __forceinline__ Dual vmin(Dual a, Dual b) {
  return Dual(fminf(a.v, b.v),
              a.v < b.v ? a.d : (a.v > b.v ? b.d : 0.5f * (a.d + b.d)));
}
__device__ __forceinline__ float vabs(float a) { return fabsf(a); }
__device__ __forceinline__ Dual vabs(Dual a) {
  return Dual(fabsf(a.v), a.v > 0.0f ? a.d : (a.v < 0.0f ? -a.d : 0.0f));
}
__device__ __forceinline__ float vsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ Dual vsqrt(Dual a) {
  const float r = sqrtf(a.v);
  return Dual(r, a.d == 0.0f ? 0.0f : a.d / (2.0f * r));
}
// float64 sigmoid rounded once (dhts_torch.ops.dmath.sigmoid)
__device__ __forceinline__ float vsigmoid(float z) {
  return (float)(1.0 / (1.0 + exp(-(double)z)));
}
// its tangent is y * (1 - y) of the rounded y (dmath.sigmoid's gradient)
__device__ __forceinline__ Dual vsigmoid(Dual z) {
  const float y = vsigmoid(z.v);
  return Dual(y, z.d * (y * (1.0f - y)));
}
// straight-through value: soft + (hard - soft), the soft gate's tangent
__device__ __forceinline__ float st_value(float soft, float hard) {
  return soft + (hard - soft);
}
__device__ __forceinline__ Dual st_value(Dual soft, float hard) {
  return Dual(soft.v + (hard - soft.v), soft.d);
}
// (value + src) - detach(src): the value, with src's tangent
__device__ __forceinline__ float grad_carrier(float value, float src) {
  return (value + src) - src;
}
__device__ __forceinline__ Dual grad_carrier(float value, Dual src) {
  return Dual((value + src.v) - src.v, src.d);
}
__device__ __forceinline__ float detached(float x) { return x; }
__device__ __forceinline__ Dual detached(Dual x) { return Dual(x.v); }
// x - detach(x - clip(x, lo, hi)): the clipped value, x's tangent
__device__ __forceinline__ float st_clip(float x, float hi) {
  return x - (x - fminf(fmaxf(x, EPS), hi));
}
__device__ __forceinline__ Dual st_clip(Dual x, float hi) {
  return Dual(x.v - (x.v - fminf(fmaxf(x.v, EPS), hi)), x.d);
}
// the action entry as a scalar; block `seed` of the backward differentiates
// with respect to entry `seed`
template <class S>
__device__ __forceinline__ S action_at(float a, bool seeded);
template <>
__device__ __forceinline__ float action_at<float>(float a, bool) {
  return a;
}
template <>
__device__ __forceinline__ Dual action_at<Dual>(float a, bool seeded) {
  return Dual(a, seeded ? 1.0f : 0.0f);
}

// sigmoid(clip(x * c, -16, 16)) (dmath.soft_sigmoid)
template <class S>
__device__ __forceinline__ S soft(S x, float c) {
  return vsigmoid(vmin(vmax(x * S(c), S(-16.0f)), S(16.0f)));
}
// straight-through gate (env `stg`): soft value in soft mode
template <class S>
__device__ __forceinline__ S stg(bool hard, S soft_val, int mode) {
  return mode == ST ? st_value(soft_val, hard ? 1.0f : 0.0f) : soft_val;
}

// ---------------------------------------------------------------------------
// ARZ physics (dhts_torch.ops.arz)
// ---------------------------------------------------------------------------

template <class S>
__device__ __forceinline__ S u_eq(S r, float u_max) {
  r = vmax(r, S(0.0f));
  return S(u_max) * (S(1.0f) - vsqrt(r + S(EPS)));
}

template <class S>
__device__ __forceinline__ S u_eq_prime(S r, float u_max) {
  r = vmax(r, S(EPS));
  return S(-(u_max * 0.5f)) * (S(1.0f) / vsqrt(r));
}

template <class S>
__device__ __forceinline__ S comp_y(S r, S u, float u_max) {
  return r * (u - u_eq(r, u_max));
}

template <class S>
__device__ __forceinline__ S comp_u(S r, S y, float u_max) {
  r = vmax(r, S(EPS));
  return y / r + u_eq(r, u_max);
}

template <class S>
__device__ __forceinline__ S lambda0(S r, S u, float u_max) {
  return u + r * u_eq_prime(r, u_max);
}

// exact ARZ Riemann solver (dhts_torch.ops.arz.riemann_solve): interface
// fluxes, and the interface's largest wave speed (a value, for the events)
template <class S>
__device__ __forceinline__ void riemann(S rl, S yl, S ul, S rr, S ur,
                                        const Consts& k, S& fr, S& fy,
                                        float& wave) {
  const float u_max = k.u_max;
  const S u_eq_l = u_eq(rl, u_max);
  const S lam0_l = lambda0(rl, ul, u_max);
  const S r_l_pow = vsqrt(vmax(rl, S(EPS)));

  const S tm = r_l_pow + (ul - ur) / S(u_max);
  const S r_m = tm * tm;
  const S u_m = ur;
  const S lam0_m = lambda0(r_m, u_m, u_max);
  const S flux_r_m = r_m * u_m;

  const S u_vac = (S(u_max) + ul) - u_eq_l;

  const S inv = ul + S(u_max) * r_l_pow;
  const S tc = inv / S(k.rare_den);
  const S r_c = tc * tc;
  const S u_c = S(k.third) * inv;

  const bool vac_l = val(rl) < EPS;
  const bool vac_r = !vac_l && (val(rr) < EPS);
  bool taken = vac_l || vac_r;
  const bool equal = !taken && (fabsf(val(ul) - val(ur)) < EPS);
  taken = taken || equal;
  const bool shock = !taken && (val(ul) > val(ur));
  taken = taken || shock;
  const bool rare = !taken && (val(u_vac) > val(ur));

  const S shock_speed = (flux_r_m - rl * ul) / vmax(r_m - rl, S(EPS));
  const S half_lam_m = (lam0_l + lam0_m) * S(0.5f);
  const S half_lam_vac = (lam0_l + u_vac) * S(0.5f);

  float speed0, speed1;
  int c;
  const int l_or_c = val(lam0_l) >= 0.0f ? 0 : 2;
  if (vac_l) {
    speed0 = 0.0f; speed1 = val(ul); c = 0;
  } else if (vac_r) {
    speed0 = val(half_lam_vac); speed1 = val(half_lam_vac); c = l_or_c;
  } else if (equal) {
    speed0 = 0.0f; speed1 = val(ur); c = 0;
  } else if (shock) {
    speed0 = val(shock_speed); speed1 = val(ur);
    c = val(shock_speed) >= 0.0f ? 0 : 1;
  } else if (rare) {
    speed0 = val(half_lam_m); speed1 = val(ur);
    c = val(lam0_l) >= 0.0f ? 0 : (val(lam0_m) <= 0.0f ? 1 : 2);
  } else {
    speed0 = val(half_lam_vac); speed1 = val(ur); c = l_or_c;
  }
  S r0, u0, y0;
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

template <class S>
struct Smem {
  S *r, *y, *pos, *vel, *av, *cap;
  S *sig, *r_last, *u_last, *r_first, *u_first;
  S *cap_val, *hs_pos, *hs_vel, *hs_a, *red_q;
  float *red_wave, *ms;  // ms: signal (sum, count, const), static (same)
  double *red_sum;       // [2 L] running-mean partial sums per lane
  int *red_cnt;          // [2 L] running-mean partial counts per lane
  int *rid, *ridx, *count, *inj_left, *cursor;
  int *want, *mn_c, *hn_c, *hs_rid, *hs_ridx, *best, *dep_best, *red_ev;
};

// carve n elements of T out of the shared-memory block at `off`
template <class T>
__host__ __device__ inline void carve(T** p, size_t n, char* base,
                                      size_t& off) {
  if (base) *p = reinterpret_cast<T*>(base + off);
  off += ((n * sizeof(T) + 15) / 16) * 16;
}

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
  carve(&t->mn_c, L, b, off); carve(&t->hn_c, L, b, off);
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

// want bits published for arbitration
constexpr int W_EMIT = 1, W_TRANSFER = 2, W_DEPOSIT = 4;

// One episode per block. S = float: the forward (outputs reward, queues,
// events; `q_weight`/`out_grad` unused). S = Dual: the backward; block j
// seeds action entry j and writes out_grad[j] = sum_t q_weight[t] *
// d(queue_t)/d(action_j) (the forward outputs are unused).
template <class S>
__global__ void itscp_hybrid_episode_kernel(
    const float* __restrict__ action, const float* __restrict__ sched,
    const int* __restrict__ mnext, const int* __restrict__ mprev,
    const float* __restrict__ rand, const int* __restrict__ inj_routes,
    const int* __restrict__ emit_routes, const float* __restrict__ prog,
    const int* __restrict__ lane_i, const float* __restrict__ lane_f,
    float* __restrict__ out_reward, float* __restrict__ out_queues,
    float* __restrict__ out_events, const float* __restrict__ q_weight,
    float* __restrict__ out_grad, Dims d, Consts k) {
  DHTS_DYNAMIC_SMEM(smem_raw);
  Smem<S> s;
  smem_bytes<S>(d, &s, smem_raw);

  const int L = d.L, C = d.C, V = d.V, K = d.K;
  const int mode = d.mode;
  const int l = threadIdx.x;
  const int seed = blockIdx.x;
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
  auto clampL = [&](int j) { return min(max(j, 0), L - 1); };
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
      const int phase = min(t / d.nsf, d.n_phases - 1);
      const int ai = phase * d.n_inter + inter;
      const S a = action_at<S>(action[ai], ai == seed);
      const float progress = prog[t % d.nsf];
      const bool hard_g = is_we ? (val(a) > progress) : (progress > val(a));
      S g;
      if (mode == HARD) {
        g = hard_g ? 1.0f : 0.0f;
      } else {
        g = soft(is_we ? a - S(progress) : S(progress) - a, k.gate32);
        g = stg(hard_g, g, mode);
      }
      s.sig[l] = approaching ? g : S(1.0f);
      incoming = has_prev ? -1.0f : sched[tl];

      if (!is_macro) {
        int n = s.count[l];
        const float free_sp =
            n > 0 ? val(s.pos[l * V]) - 0.5f * k.veh_len : length;
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
      const S rl = s.r[l * C + last], yl = s.y[l * C + last];
      const S rf = s.r[l * C], yf = s.y[l * C];
      s.r_last[l] = rl; s.u_last[l] = comp_u(rl, yl, u_max);
      s.r_first[l] = rf; s.u_first[l] = comp_u(rf, yf, u_max);
    }
    __syncthreads();

    // ================= B1: ghosts, leader walk (reads only) ============
    S bl_r = 0.f, bl_u = 0.f, br_r = 0.f, br_u = 0.f, hpd = 0.f, hsd = 0.f;
    // soft micro blend: the green leader, the red stop, the blended signal
    S pd_g = 0.f, sd_g = 0.f, red_pd = 0.f, fsig = 0.f;
    bool blend = false;
    if (lane) {
      const int mp = mprev[tl], mn = mnext[tl];
      // left ghost: the upstream neighbour's last cell
      const int adjp = num_prev == 1 ? prev0 : mp;
      const int adjp_c = clampL(adjp);
      const bool use_l = (num_prev > 0) && (adjp >= 0) && geom_macro(adjp_c);
      S gl_r = use_l ? s.r_last[adjp_c] : S(0.0f);
      S gl_u = use_l ? s.u_last[adjp_c] : S(u_max);
      if (!has_prev) { gl_r = incoming; gl_u = u_eq(S(incoming), u_max); }
      const S prev_sig = !has_prev ? S(1.0f)
                                   : (mp < 0 ? S(0.0f) : s.sig[clampL(mp)]);
      bl_r = gl_r * prev_sig;
      bl_u = gl_u * prev_sig + S(u_max) * (S(1.0f) - prev_sig);
      // right ghost: the downstream neighbour's first cell, or a red wall
      const int adjn = num_next == 1 ? next0 : mn;
      const int adjn_c = clampL(adjn);
      const bool use_r = (num_next > 0) && (adjn >= 0) && geom_macro(adjn_c);
      const S gr_r = use_r ? s.r_first[adjn_c] : S(0.0f);
      const S gr_u = use_r ? s.u_first[adjn_c] : S(u_max);
      const S sig_l = s.sig[l];
      S sg;
      if (mode == HARD) {
        sg = val(sig_l) > 0.5f ? 1.0f : 0.0f;
      } else {
        sg = stg(val(sig_l) > 0.5f, soft(sig_l - S(0.5f), k.gate32), mode);
      }
      br_r = gr_r * sg + S(1.0f) * (S(1.0f) - sg);
      br_u = gr_u * sg;

      if (!is_macro) {
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
          if (geom_macro(w)) { any_term = true; break; }
          if (s.count[w] > 0) {
            any_term = true; occupied = true; lead = w; break;
          }
          crossed += (double)geom_len(w);
        }
        const S cur_delta = (S(length) - hpos) - S(k.veh_len * 0.5f) +
                            S((float)crossed);
        const bool found = exists && any_term && occupied;
        pd_g = found ? vmax((cur_delta + s.pos[lead * V]) -
                                S(k.veh_len * 0.5f), S(0.0f))
                     : S(1000.0f);
        sd_g = found ? hvel - s.vel[lead * V] : S(0.0f);
        // the signal of the lane the head is on
        red_pd = vmax((S(length) - hpos) - S(k.veh_len * 0.5f), S(0.0f));
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
                                 soft(S(length) - hpos, 16.0f), mode);
          S n_sc = next_exist
                       ? stg(false, soft(hpos - S(length), 16.0f), mode)
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
      if (is_macro) {
        const S right_y = comp_y(br_r, br_u, u_max);
        const S left_y = comp_y(bl_r, bl_u, u_max);
        S rp[MAXC], yp[MAXC], up[MAXC];
        for (int c = 0; c < C; ++c) {
          rp[c] = c < num_cell ? s.r[l * C + c] : br_r;
          yp[c] = c < num_cell ? s.y[l * C + c] : right_y;
          up[c] = comp_u(rp[c], yp[c], u_max);
        }
        S fr_prev = 0.f, fy_prev = 0.f;
        for (int i = 0; i <= C; ++i) {
          S fr, fy;
          float wave;
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
            s.r[l * C + i - 1] = rp[i - 1] + (fr_prev - fr) * S(coeff);
            s.y[l * C + i - 1] = yp[i - 1] + (fy_prev - fy) * S(coeff);
          }
          fr_prev = fr; fy_prev = fy;
        }
      } else {
        const int n = s.count[l];
        for (int v = 0; v < n; ++v) {
          const S p = s.pos[l * V + v], sp = s.vel[l * V + v];
          S pdel, sdel;
          if (v == n - 1) {
            pdel = hpd; sdel = hsd;
          } else {
            pdel = vabs(s.pos[l * V + v + 1] - p) -
                   S((k.veh_len + k.veh_len) * 0.5f);
            sdel = sp - s.vel[l * V + v + 1];
          }
          if (val(pdel) < 0.0f) { pdel = 0.0f; sdel = 0.0f; }
          pdel = vmax(pdel, S(EPS));
          const S os = vmax((S(k.min_space) + sp * S(k.time_pref)) +
                                (sp * sdel) / S(idm_den),
                            S(0.0f));
          const S q = sp / S(k.tgt);
          const S q2 = q * q;
          const S z = os / pdel;
          const S acc_raw = S(k.amax) * ((S(1.0f) - q2 * q2) - z * z);
          const S acc_floor = -sp / S(k.dt);
          const S acc = vmax(acc_raw, acc_floor);
          s.pos[l * V + v] = p + S(k.dt) * sp;
          const S nv = sp + S(k.dt) * acc;
          // stopped by the floor: sp + dt * (-sp / dt) does not depend on
          // sp, so its tangent is 0 (summing the tangents would leave a
          // rounding residue of sp's tangent; dhts_torch/ops/idm.py
          // detaches the same speed)
          s.vel[l * V + v] = val(acc_raw) < val(acc_floor) ? detached(nv) : nv;
        }
      }
    }
    __syncthreads();

    // ================= C1: conversion requests ==========================
    int want = 0, slot = 0, mn_c = 0, hn_c = 0, hnext = -1;
    bool exit_none = false;
    S cap_v = 0.0f;
    if (lane) {
      const int mn = mnext[tl];
      mn_c = clampL(mn);
      const bool next_is_micro = is_macro && mn >= 0 && !geom_macro(mn_c);
      const S rl = s.r[l * C + last];
      const S ul = comp_u(rl, s.y[l * C + last], u_max);
      const S inc = next_is_micro ? rl * ul * S(k.dt) : S(0.0f);
      slot = 0;
      for (int q = 0; q < K; ++q)
        if (lane_i[(8 + K + q) * L + l] == mn) { slot = q; break; }
      cap_v = s.cap[l * K + slot] + inc;
      const int dest_n = s.count[mn_c];
      const float free_sp = dest_n > 0
                                ? val(s.pos[mn_c * V]) - 0.5f * k.veh_len
                                : geom_len(mn_c);
      if (next_is_micro && val(cap_v) >= k.veh_len && free_sp >= k.veh_len &&
          dest_n < V)
        want |= W_EMIT;

      const int n = s.count[l];
      const bool exists = n > 0;
      const int h = min(max(n - 1, 0), V - 1);
      const S hpos = s.pos[l * V + h];
      const int hrid = s.rid[l * V + h], hridx = s.ridx[l * V + h];
      hnext = hridx + 1 < d.R
                  ? route_at(inj_routes, emit_routes, hrid,
                             min(max(hridx + 1, 0), d.R - 1), d)
                  : -1;
      hn_c = clampL(hnext);
      const bool past_end = exists && val(hpos) >= length;
      exit_none = past_end && hnext < 0;
      const bool nxt_micro = hnext >= 0 && !geom_macro(hn_c);
      const bool nxt_macro = hnext >= 0 && geom_macro(hn_c);
      if (past_end && nxt_micro && s.count[hn_c] < V) want |= W_TRANSFER;
      if (exists && nxt_macro && val(hpos) > length + k.veh_len)
        want |= W_DEPOSIT;

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
    int n_after = 0;
    if (lane) {
      const bool emit_win = (want & W_EMIT) && s.best[mn_c] == l;
      const bool tr_win = (want & W_TRANSFER) && s.best[hn_c] == l;
      const bool dep_win = (want & W_DEPOSIT) && s.dep_best[hn_c] == l;
      const bool remove = exit_none || dep_win || tr_win;
      int n = s.count[l] - (remove ? 1 : 0);
      // the decremented capacitor is detached
      s.cap[l * K + slot] = emit_win ? detached(cap_v - S(k.veh_len)) : cap_v;

      const int best = s.best[l];
      const bool has_insert = best < INF_ID;
      bool is_emit = false;
      if (has_insert) {
        const int src = best;
        is_emit = geom_macro(src);
        S npos, nvel, na;
        int nrid, nridx;
        if (is_emit) {
          npos = 0.0f;
          nvel = s.u_last[src];
          na = grad_carrier(k.veh_len, s.cap_val[src]);
          nrid = L * d.P + l * d.P2 + s.cursor[l] % d.P2;
          nridx = 0;
          s.cursor[l] += 1;
        } else {
          npos = s.hs_pos[src] - S(geom_len(src));
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
      n_after = n;

      // micro -> macro mass deposit from the winning source
      const int sd = s.dep_best[l];
      if (sd < INF_ID) {
        const S v_head = s.hs_pos[sd] - S(geom_len(sd));
        const S v_tail = v_head - S(k.veh_len);
        const S ha = s.hs_a[sd], hv = s.hs_vel[sd];
        for (int c = 0; c < num_cell; ++c) {
          const float c_tail = (float)c * cell_len;
          const float c_head = ((float)c + 1.0f) * cell_len;
          const bool ov = c_head > val(v_tail) && c_tail < val(v_head) &&
                          cell_len > val(v_tail);
          if (!ov) continue;
          const S max_head = vmax(S(c_head), v_head);
          const S min_tail = vmin(S(c_tail), v_tail);
          const S overlap =
              S(cell_len + k.veh_len) - (max_head - min_tail);
          const S add_r = (ha / S(k.veh_len)) * (overlap / S(cell_len));
          const S n_r = st_clip(s.r[l * C + c] + add_r, k.rho_hi);
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
      s.red_wave[l] = lane_wave;
      for (int e = 0; e < NEV; ++e) s.red_ev[e * L + l] = ev[e];
    }

    // ---- queue of this lane
    S q_lane = 0.0f;
    if (mode == HARD) {
      if (lane) {
        if (is_macro) {
          for (int c = 0; c < num_cell; ++c) {
            const S r = s.r[l * C + c];
            const S u = comp_u(r, s.y[l * C + c], u_max);
            const float stat = val(u) < k.static_speed ? 1.0f : 0.0f;
            q_lane = q_lane + S(stat) * ((r * S(cell_len)) / S(k.veh_len));
          }
        } else {
          for (int v = 0; v < n_after; ++v)
            q_lane = q_lane +
                     S(val(s.vel[l * V + v]) < k.static_speed ? 1.0f : 0.0f);
        }
      }
    } else {
      // running mean of (static_speed - speed) over macro cells, then over
      // micro vehicles; its detached mean sharpens the queue gates
      if (lane) {
        double cells = 0.0, vehs = 0.0;
        if (is_macro) {
          for (int c = 0; c < num_cell; ++c)
            cells += (double)(k.static_speed -
                              val(comp_u(s.r[l * C + c], s.y[l * C + c],
                                         u_max)));
        } else {
          for (int v = 0; v < n_after; ++v)
            vehs += (double)(k.static_speed - val(s.vel[l * V + v]));
        }
        s.red_sum[l] = cells; s.red_cnt[l] = is_macro ? num_cell : 0;
        s.red_sum[L + l] = vehs; s.red_cnt[L + l] = is_macro ? 0 : n_after;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        fold_mean(s, L, 0, s.ms + 3);
        const float mean = fold_mean(s, L, L, s.ms + 3);
        s.ms[5] = 16.0f / fmaxf(fabsf(mean), 1e-6f);
      }
      __syncthreads();
      if (lane) {
        const float c = s.ms[5];
        if (is_macro) {
          for (int c_i = 0; c_i < num_cell; ++c_i) {
            const S r = s.r[l * C + c_i];
            const S u = comp_u(r, s.y[l * C + c_i], u_max);
            const S stat = stg(val(u) < k.static_speed,
                               soft(S(k.static_speed) - u, c), mode);
            q_lane = q_lane + stat * ((r * S(cell_len)) / S(k.veh_len));
          }
        } else {
          for (int v = 0; v < n_after; ++v) {
            const S sp = s.vel[l * V + v];
            q_lane = q_lane + stg(val(sp) < k.static_speed,
                                  soft(S(k.static_speed) - sp, c), mode);
          }
        }
      }
    }
    if (lane) s.red_q[l] = q_lane * q_lane;
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
    if (out_grad) out_grad[seed] = (float)grad;
  }
}

// shared launch path of the forward (S = float, one block) and the
// backward (S = Dual, one block per action entry)
template <class S>
int launch(int blocks, const float* action, const float* sched,
           const int* mnext, const int* mprev, const float* rand,
           const int* inj_routes, const int* emit_routes, const float* prog,
           const int* lane_i, const float* lane_f, float* out_reward,
           float* out_queues, float* out_events, const float* q_weight,
           float* out_grad, const Dims& d, const Consts& k, void* stream) {
  if (d.L < 1 || d.L > 1024 || d.C < 1 || d.C > MAXC || d.V < 1 ||
      d.R < 1 || d.K < 1 || d.mode < HARD || d.mode > ST)
    return 1;  // cudaErrorInvalidValue
  const size_t smem = smem_bytes<S>(d, nullptr, nullptr);
  const int threads = ((d.L + 31) / 32) * 32;
#ifdef DHTS_CPU_EMULATION
  (void)stream;
  dhts_emu::launch(blocks, threads, smem, itscp_hybrid_episode_kernel<S>,
                   action, sched, mnext, mprev, rand, inj_routes,
                   emit_routes, prog, lane_i, lane_f, out_reward, out_queues,
                   out_events, q_weight, out_grad, d, k);
  return 0;
#else
  cudaError_t err = cudaFuncSetAttribute(
      itscp_hybrid_episode_kernel<S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  itscp_hybrid_episode_kernel<S><<<blocks, threads, smem,
                                   (cudaStream_t)stream>>>(
      action, sched, mnext, mprev, rand, inj_routes, emit_routes, prog,
      lane_i, lane_f, out_reward, out_queues, out_events, q_weight, out_grad,
      d, k);
  return (int)cudaGetLastError();
#endif
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

// Forward: one episode in gate mode `mode` (0 hard, 1 soft, 2
// straight-through) on `stream`; returns cudaGetLastError() of the launch.
int launch_itscp_hybrid_episode_fwd(
    const float* action, const float* sched, const int* mnext,
    const int* mprev, const float* rand, const int* inj_routes,
    const int* emit_routes, const float* prog, const int* lane_i,
    const float* lane_f, float* out_reward, float* out_queues,
    float* out_events, int T, int L, int C, int V, int R, int P, int P2,
    int K, int W, int nsf, int n_phases, int n_inter, int mode, float u_max,
    float dt, float veh_len, float static_speed, float rare_den, float third,
    float amax, float apref, float tgt, float min_space, float time_pref,
    float rho_hi, float gate32, void* stream) {
  Dims d{T, L, C, V, R, P, P2, K, W, nsf, n_phases, n_inter, mode};
  Consts k{u_max, dt, veh_len, static_speed, rare_den, third, amax,
           apref, tgt, min_space, time_pref, rho_hi, gate32};
  return launch<float>(1, action, sched, mnext, mprev, rand, inj_routes,
                       emit_routes, prog, lane_i, lane_f, out_reward,
                       out_queues, out_events, nullptr, nullptr, d, k,
                       stream);
}

// Backward of the soft (1) or straight-through (2) forward:
// out_grad[n_phases * n_inter] = sum_t q_weight[t] * d(queue_t)/d(action),
// one block per action entry; returns cudaGetLastError() of the launch.
int launch_itscp_hybrid_episode_bwd(
    const float* action, const float* sched, const int* mnext,
    const int* mprev, const float* rand, const int* inj_routes,
    const int* emit_routes, const float* prog, const int* lane_i,
    const float* lane_f, const float* q_weight, float* out_grad, int T,
    int L, int C, int V, int R, int P, int P2, int K, int W, int nsf,
    int n_phases, int n_inter, int mode, float u_max, float dt,
    float veh_len, float static_speed, float rare_den, float third,
    float amax, float apref, float tgt, float min_space, float time_pref,
    float rho_hi, float gate32, void* stream) {
  if (mode == HARD || n_phases < 1 || n_inter < 1) return 1;
  Dims d{T, L, C, V, R, P, P2, K, W, nsf, n_phases, n_inter, mode};
  Consts k{u_max, dt, veh_len, static_speed, rare_den, third, amax,
           apref, tgt, min_space, time_pref, rho_hi, gate32};
  return launch<Dual>(n_phases * n_inter, action, sched, mnext, mprev, rand,
                      inj_routes, emit_routes, prog, lane_i, lane_f, nullptr,
                      nullptr, nullptr, q_weight, out_grad, d, k, stream);
}

}  // extern "C"
