// Fused all-macro ITSCP episode for Hopper (sm_90a): forward and its
// gradient with respect to the action and the initial state.
//
// Replaces the TPU kernel K4,
// dhts/ops/pallas/itscp_episode.py::make_fused_itscp_macro_episode:
//   * forward (fwd_kernel :227, pallas_call :256; per-step `step` :148-224,
//     its loop :239-249): the whole episode of T steps of an all-macro
//     scene (every lane ARZ) with soft signal gates from the phase action,
//     signal-blended ghost cells, the Godunov update of every lane and the
//     RMS-sharpened soft queue reward; returns (qsum, queues[T]) and the
//     wrapper makes reward = -qsum;
//   * backward (bwd_kernel :279, pallas_call :307): the vector-Jacobian
//     product of (qsum, queues) with respect to the action [n_phases,
//     n_inter] and the initial state r0, y0 [L, C].
// Its specification is the plain PyTorch version beside its wrapper
// (dhts_torch/ops/cuda/itscp_macro_episode.py::plain_macro_episode): every
// value is computed with the same IEEE float32 operations in the same
// order (-fmad=false, no fast math), sums over lanes in float64 in lane
// order, rounded once, so the forward agrees with it bit for bit.
//
// Design. What K4 computes, not its TPU layout: K4 pads to [8, 128k] and
// does every cross-lane read as a one-hot matrix product; here one block
// runs an episode, one thread a lane, on true sizes. The state r, y [L, C]
// lives in shared memory (2 x 288 floats at the 3x3 preset); a cross-lane
// read is an indexed load of the per-lane edge summaries. A step is the
// per-lane phases of itscp_step.cuh that K4's step shares with K1's macro
// lanes, in soft gate mode (signal, edge cells, ghosts, Godunov update,
// the static running mean's partials and the lane queue), with four
// barriers: after the signals and edges are published, after the lanes'
// update, after the running mean is folded, and before the lane queues are
// summed. Thread 0 folds and sums in lane order: deterministic.
//
// Backward: forward-mode tangents, as K1's and K2's backwards. The episode
// is a template on its scalar type (float, or Dual in dhts_scalar.cuh);
// block b seeds one input entry (an action entry, or a valid cell of r0 or
// y0, in that order; only the groups the caller asks for are launched) and
// writes
//     grad[entry] = sum_t w[t] d(queue_t)/d(entry),
// with w[t] = g_qsum + g_queues[t] (K4's ep_bwd, :284), the TPU kernel's vector-Jacobian product, from the forward's inputs
// alone: no trajectory is stored, no step is transposed. Cells beyond a
// lane's num_cell are never seeded (K4 pins them to the right ghost each
// step, so their gradient is exactly 0). The running mean that sharpens
// the queue gates is detached, as in K4.
//
// Bound. The inputs and outputs are a few hundred KB, and the T steps' ARZ
// float32 operations take under a microsecond at the card's peak: the
// kernel is latency-bound, a chain of T dependent steps, each four block
// barriers, a walk over the lane's cells and two serial reductions over
// the lanes by one thread, in one block of L threads (131 of 132 SMs idle
// in the forward).

#include "itscp_step.cuh"

namespace {

template <class S>
struct Smem {
  S *r, *y, *sig, *r_last, *u_last, *r_first, *u_first, *red_q;
  double* red_sum;  // [2 L] static running-mean partials (static_partials)
  int* red_cnt;     // [2 L]
  float* ms;        // running mean (sum, count) and its gate constant
};

template <class S>
__host__ __device__ inline size_t smem_bytes(int L, int C, Smem<S>* s,
                                             char* base) {
  size_t off = 0;
  Smem<S> dummy;
  Smem<S>* t = s ? s : &dummy;
  char* b = s ? base : nullptr;
  const size_t LC = (size_t)L * C;
  carve(&t->r, LC, b, off); carve(&t->y, LC, b, off);
  carve(&t->sig, L, b, off); carve(&t->r_last, L, b, off);
  carve(&t->u_last, L, b, off); carve(&t->r_first, L, b, off);
  carve(&t->u_first, L, b, off); carve(&t->red_q, L, b, off);
  carve(&t->red_sum, 2 * L, b, off); carve(&t->red_cnt, 2 * L, b, off);
  carve(&t->ms, 3, b, off);
  return off;
}

template <class S>
__device__ __forceinline__ S seeded(float x, bool) {
  return S(x);
}
template <>
__device__ __forceinline__ Dual seeded<Dual>(float x, bool seed) {
  return Dual(x, seed ? 1.0f : 0.0f);
}

// a float64 sum (value, tangent) rounded once to S
template <class S>
__device__ __forceinline__ S rounded(double v, double d);
template <>
__device__ __forceinline__ float rounded<float>(double v, double) {
  return (float)v;
}
template <>
__device__ __forceinline__ Dual rounded<Dual>(double v, double d) {
  return Dual((float)v, (float)d);
}

// The episode's seeds: blocks [0, n_a) seed action entry b, the next n_r
// the r0 cell cells[b - n_a], the next n_y the y0 cell cells[b - n_a -
// n_r]; the forward (one block) seeds nothing.
struct Seeds {
  const int* cells;  // valid cells l * C + c
  int n_a, n_r, n_y;
};

// One episode per block. S = float: the forward (outputs -qsum and
// queues). S = Dual: the backward; block b writes out_grad at its seed's
// entry: [0, NA) the action, [NA, NA + LC) r0, [NA + LC, NA + 2 LC) y0.
template <class S>
__global__ void itscp_macro_episode_kernel(
    const float* __restrict__ action, const float* __restrict__ sched,
    const int* __restrict__ mnext, const int* __restrict__ mprev,
    const float* __restrict__ r0, const float* __restrict__ y0,
    const float* __restrict__ prog, const int* __restrict__ lane_i,
    const float* __restrict__ lane_f, float* __restrict__ out_reward,
    float* __restrict__ out_queues, const float* __restrict__ q_weight,
    float* __restrict__ out_grad, Seeds sd, Dims d, Consts k) {
  DHTS_DYNAMIC_SMEM(smem_raw);
  Smem<S> s;
  smem_bytes<S>(d.L, d.C, &s, smem_raw);

  const int L = d.L, C = d.C, K = d.K;
  const int LC = L * C;
  const int l = threadIdx.x;
  const bool lane = l < L;
  const float u_max = k.u_max;
  const Scene sc{lane_i, lane_f, nullptr, nullptr};
  LaneState<S, S*, false> st{s.r, s.y, nullptr, nullptr, nullptr, nullptr,
                             {nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr},
                             nullptr, nullptr, nullptr, nullptr, nullptr,
                             C, 1, 0, 1, 0, 1};

  // this block's seed
  const int b = blockIdx.x;
  int a_seed = -1, r_seed = -1, y_seed = -1, out_at = -1;
  if (sizeof(S) != sizeof(float)) {
    const int NA = d.n_phases * d.n_inter;
    if (b < sd.n_a) {
      a_seed = b;
      out_at = b;
    } else if (b < sd.n_a + sd.n_r) {
      r_seed = sd.cells[b - sd.n_a];
      out_at = NA + r_seed;
    } else {
      y_seed = sd.cells[b - sd.n_a - sd.n_r];
      out_at = NA + LC + y_seed;
    }
  }

  const LaneGeom g = lane ? lane_geom(sc, L, K, l) : LaneGeom();
  const int last = min(max(g.num_cell - 1, 0), C - 1);
  if (lane) {
    for (int c = 0; c < C; ++c) {
      const int i = l * C + c;
      s.r[i] = seeded<S>(r0[i], i == r_seed);
      s.y[i] = seeded<S>(y0[i], i == y_seed);
    }
  }
  if (threadIdx.x == 0)
    for (int i = 0; i < 3; ++i) s.ms[i] = 0.0f;
  float qsum = 0.0f;
  double grad = 0.0;
  __syncthreads();

  for (int t = 0; t < d.T; ++t) {
    const int tl = t * L + l;
    // ---- signals and edge cells (K4 :150-170)
    float incoming = -1.0f;
    if (lane) {
      s.sig[l] = lane_signal<S>(action, prog, d, k, g, t, a_seed);
      incoming = g.has_prev ? -1.0f : sched[tl];
      publish_edges<S>(st, s, l, last, u_max);
    }
    __syncthreads();

    // ---- ghosts and the Godunov update (:172-210); each lane reads the
    // others' edges and signals and writes only its own cells
    if (lane) {
      const Ghosts<S> gh = ghosts<S>(s, sc, g, L, l, mprev[tl], mnext[tl],
                                     incoming, SOFT, k);
      godunov_lane<S>(st, g, l, C, gh, k);
      static_partials<S>(st, s, g, L, l, 0, k);
    }
    __syncthreads();

    // ---- the static running mean, detached (:212-217)
    if (threadIdx.x == 0) {
      double tot = 0.0;
      int cnt = 0;
      for (int j = 0; j < L; ++j) {
        tot += s.red_sum[j];
        cnt += s.red_cnt[j];
      }
      s.ms[0] = s.ms[0] + (float)tot;
      s.ms[1] = s.ms[1] + (float)cnt;
      s.ms[2] = sharpness(16.0f, s.ms[0] / s.ms[1]);
    }
    __syncthreads();

    // ---- soft queue of each lane (:218-222), summed in lane order
    if (lane) {
      const S q_lane = lane_queue<S>(st, g, l, 0, SOFT, s.ms[2], k);
      s.red_q[l] = q_lane * q_lane;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      double qv = 0.0, qd = 0.0;
      for (int j = 0; j < L; ++j) {
        qv += (double)val(s.red_q[j]);
        qd += (double)tangent(s.red_q[j]);
      }
      const S queue = rounded<S>(qv, qd) * S(k.dt);
      qsum += val(queue);
      if (q_weight) grad += (double)q_weight[t] * (double)tangent(queue);
      if (out_queues) out_queues[t] = val(queue);
    }
    // the next step's first writes touch none of the reduced arrays
  }
  if (threadIdx.x == 0) {
    if (out_reward) out_reward[0] = -qsum;
    if (out_grad) out_grad[out_at] = (float)grad;
  }
}

template <class S>
int launch(int blocks, const float* action, const float* sched,
           const int* mnext, const int* mprev, const float* r0,
           const float* y0, const float* prog, const int* lane_i,
           const float* lane_f, float* out_reward, float* out_queues,
           const float* q_weight, float* out_grad, const Seeds& sd,
           const Dims& d, const Consts& k, void* stream) {
  if (d.L < 1 || d.L > 1024 || d.C < 1 || d.C > MAXC || d.K < 1 ||
      d.T < 0 || d.nsf < 1 || d.n_phases < 1 || d.n_inter < 1 || blocks < 1)
    return 1;  // cudaErrorInvalidValue
  const size_t smem = smem_bytes<S>(d.L, d.C, nullptr, nullptr);
  const int threads = ((d.L + 31) / 32) * 32;
#ifdef DHTS_CPU_EMULATION
  (void)stream;
  dhts_emu::launch(blocks, threads, smem, itscp_macro_episode_kernel<S>,
                   action, sched, mnext, mprev, r0, y0, prog, lane_i,
                   lane_f, out_reward, out_queues, q_weight, out_grad, sd,
                   d, k);
  return 0;
#else
  cudaError_t err = cudaFuncSetAttribute(
      itscp_macro_episode_kernel<S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  itscp_macro_episode_kernel<S><<<blocks, threads, smem,
                                  (cudaStream_t)stream>>>(
      action, sched, mnext, mprev, r0, y0, prog, lane_i, lane_f, out_reward,
      out_queues, q_weight, out_grad, sd, d, k);
  return (int)cudaGetLastError();
#endif
}

Dims dims(int T, int L, int C, int K, int nsf, int n_phases, int n_inter) {
  Dims d{};
  d.T = T; d.L = L; d.C = C; d.K = K; d.nsf = nsf;
  d.n_phases = n_phases; d.n_inter = n_inter; d.mode = SOFT;
  return d;
}

Consts consts(float u_max, float dt, float veh_len, float static_speed,
              float rare_den, float third, float gate32) {
  Consts k{};
  k.u_max = u_max; k.dt = dt; k.veh_len = veh_len;
  k.static_speed = static_speed; k.rare_den = rare_den; k.third = third;
  k.gate32 = gate32;
  return k;
}

}  // namespace

extern "C" {

// Dynamic shared memory of the forward (tangent = 0) or the backward
// (tangent = 1) for these sizes (bytes).
size_t itscp_macro_episode_smem(int L, int C, int tangent) {
  return tangent ? smem_bytes<Dual>(L, C, nullptr, nullptr)
                 : smem_bytes<float>(L, C, nullptr, nullptr);
}

// Forward: one episode; out_reward[0] = -sum(queues), out_queues[T].
// Returns cudaGetLastError() of the launch (1 for invalid sizes).
int launch_itscp_macro_episode_fwd(
    const float* action, const float* sched, const int* mnext,
    const int* mprev, const float* r0, const float* y0, const float* prog,
    const int* lane_i, const float* lane_f, float* out_reward,
    float* out_queues, int T, int L, int C, int K, int nsf, int n_phases,
    int n_inter, float u_max, float dt, float veh_len, float static_speed,
    float rare_den, float third, float gate32, void* stream) {
  return launch<float>(
      1, action, sched, mnext, mprev, r0, y0, prog, lane_i, lane_f,
      out_reward, out_queues, nullptr, nullptr, Seeds{nullptr, 0, 0, 0},
      dims(T, L, C, K, nsf, n_phases, n_inter),
      consts(u_max, dt, veh_len, static_speed, rare_den, third, gate32),
      stream);
}

// Backward: out_grad[n_phases * n_inter + 2 L C] (zeroed by the caller)
// gets sum_t q_weight[t] * d(queue_t)/d(entry) at the n_a action entries,
// the n_r cells of r0 and the n_y cells of y0 named by `cells`, one block
// each; the other entries are not written. Returns cudaGetLastError().
int launch_itscp_macro_episode_bwd(
    const float* action, const float* sched, const int* mnext,
    const int* mprev, const float* r0, const float* y0, const float* prog,
    const int* lane_i, const float* lane_f, const int* cells,
    const float* q_weight, float* out_grad, int T, int L, int C, int K,
    int nsf, int n_phases, int n_inter, int n_a, int n_r, int n_y,
    float u_max, float dt, float veh_len, float static_speed,
    float rare_den, float third, float gate32, void* stream) {
  if (n_a < 0 || n_a > n_phases * n_inter || n_r < 0 || n_y < 0 ||
      n_r > L * C || n_y > L * C)
    return 1;
  const Seeds sd{cells, n_a, n_r, n_y};
  return launch<Dual>(
      n_a + n_r + n_y, action, sched, mnext, mprev, r0, y0, prog, lane_i,
      lane_f, nullptr, nullptr, q_weight, out_grad, sd,
      dims(T, L, C, K, nsf, n_phases, n_inter),
      consts(u_max, dt, veh_len, static_speed, rare_den, third, gate32),
      stream);
}

}  // extern "C"
