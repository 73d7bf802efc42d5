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
// Design. One thread block per episode; the T loop runs inside the kernel.
// A launch runs B independent episodes (the JAX kernel's `episodes=B` and
// its vmapped configurations), block e the episode e: each input has an
// episode stride in elements (0: shared by every episode), and each block
// keeps its own state, running means, queue sum and events, so B episodes
// in one launch give what B launches give, bit for bit. No lane packing,
// no lane-to-episode maps: a block is an episode. A launch of one episode
// of a scene one block holds runs the kernel's instantiation without the
// episode axis: moving the input pointers to a block's episode cost a
// launch of one episode 1.0-2.4 % forward on an H100. The [L, V, R] route
// container of the JAX kernel is not materialised: every route in an
// episode is a row of one of the two read-only pools (waiting pool [L, P,
// R], emission pool [L, P2, R]), and vehicles only ever copy routes, so
// each vehicle slot holds a route id (the pool row) and route entries are
// read from global memory, where the pools stay L2-resident.
//   kernels      itscp_hybrid_episode_kernel runs the scenes one block
//                holds at one lane a thread with every array in shared
//                memory (the 3x3 grid, the 5x5 grid's forward), with code
//                of its own; itscp_hybrid_episode_wide (run_episode) runs
//                the same phases, operation for operation, on the lanes a
//                thread as a template parameter, for the scenes whose
//                state goes to global memory. One templated code for both
//                cost the 3x3 preset 0.36-0.50 % (hard and backward; ten
//                pairs on an H100, tools/k1_timing.py --parent), so the
//                two stay apart; the host tests hold them bit-equal. The
//                launcher takes a layout where the kernel's attributes
//                (the threads its registers allow) and the device's opt-in
//                shared memory allow it, else refuses it;
//                itscp_hybrid_episode_placement reports the choice.
//   placement    in global memory (the wide kernel: the 5x5 grid's
//                backward, the 7x7 and 9x9 grids), the arrays of C,
//                V or K entries a lane, r, y, pos, vel, av, cap, rid and
//                ridx (split_bytes), live in a workspace of the block's own
//                in global memory (about 0.77 MB a block at 9x9 `Dual`,
//                which the caller allocates), lane-major as in shared
//                memory. A lane's thread alone touches its r, y, av, cap,
//                rid and ridx, and its pos and vel but for slot 0, the
//                tail, which the leader walk and the conversion's
//                free-space test read from other lanes after a barrier.
//                What other lanes read besides stays in shared memory: the
//                per-lane summaries (signals, edge cells, counts, heads,
//                wants, winners), the records and the warps' partial sums,
//                229 KB at 9x9 `Dual`.
//   threads      LPT lanes a lane thread (1, or 2 where one lane a thread
//                would pass 1,024 threads: the 9x9 grid's 1,312 lane slots
//                run in 672 lane threads), in whole warps of one lane kind:
//                the wrapper's lane_layout lists the macro lanes and then
//                the micro lanes, each padded to a multiple of 32, and
//                thread i runs the lanes thread_lane[k * lane_threads + i],
//                k < LPT; so no warp runs both the Godunov update and the
//                IDM update, and only the micro warps walk routes. A thread
//                runs each phase for its lanes in list order before the
//                phase's barrier. Every array is indexed by lane id, so the
//                layout changes no value but the running means' fold
//                (below). Behind the lane threads, one reduction warp. The
//                wide kernel is bounded to 1,024 threads, so ptxas keeps it
//                within 64 registers.
//   barriers     the lane threads sync among themselves (named barrier
//                BAR_LANES, the reduction warp not counted) where a lane
//                reads another lane's values: after injection (signals,
//                boundary cells), after the boundary/leader reads (before
//                lanes write their new state), after the forward step,
//                after the conversion requests are published and after
//                arbitration; the soft modes add one for each running
//                mean. The conversion's speed of the last cell goes to its
//                own array (u_emit), so that a lane may publish the next
//                step's edges while a slower one still reads it. A barrier
//                orders the state in global memory as it does shared
//                memory.
//   reductions   each lane writes its step's records (q^2, the wave speed,
//                the event bits) into one of two slots; the reduction warp
//                takes slot t % 2 once the lanes arrive at its FULL
//                barrier and reduces it while they run step t + 1: the
//                queue in lane order (float32, or dual numbers whose two
//                halves each add in lane order) by its first thread, the
//                event counts and the wave's maximum (exact in any order)
//                by a shuffle tree; it frees the slot (EMPTY) for step
//                t + 2, whose first barrier waits for that. The
//                running means (float64 partial sums, rounded once, like
//                the plain version's dhts_torch/utils/rms.py) add each
//                thread's lanes' terms in list order, fold each warp's
//                terms by a fixed shuffle tree and the warps' sums in warp
//                order, one barrier each, every lane thread taking the
//                same mean: deterministic, so a batch equals single
//                launches bit for bit, and a placement changes no bit.
//   inputs       each step's rows of the schedule, the draws and the macro
//                routes are loaded a step ahead.
// The per-lane phases are in itscp_step.cuh, shared with the fused spatial
// step (itscp_spatial_step.cu), which addresses the same state in global
// memory.
//   arbitration  pull form: each destination scans its predecessor list
//                and takes the lowest source id that wants in; no atomics.
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
// barriers between per-lane loops of IEEE divisions and roots (the
// Godunov update's C + 1 Riemann solves, the queue's cells) and short
// dependent global loads (the route walk); its inputs and outputs are a
// few MB, so it is bound by that chain, far above the bytes / 3.35 TB/s
// floor.

#include <cstring>

#include "itscp_step.cuh"

namespace {

constexpr int NEV = 7;  // integer event rows
constexpr int WARP = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
// named barriers (0 is __syncthreads): the lane threads' barrier inside a
// step, and per step parity the records' FULL (the lanes arrive, the
// reduction warp waits) and EMPTY (the reduction warp arrives, the lanes
// wait at their first barrier of the step two steps on)
constexpr int BAR_LANES = 1, BAR_FULL = 2, BAR_EMPTY = 4;
// the warps' partial sums of the running means: the blend's, the static
// mean's cells, its vehicles; at most 1024 / 32 lane warps each
constexpr int PART_BLEND = 0, PART_CELLS = 1, PART_VEHS = 2, PARTS = 3;
constexpr int MAX_WARPS = 32;

// Cycle stamps (a build with -DDHTS_K1_CLOCK; dhts_torch.ops.cuda.k1_clock):
// thread 0 of block 0 reads the clock after each barrier of a step and
// adds the cycles since its last stamp to the phase that ended there
// (K1_A ... K1_QUEUE below), so each phase's count is the time the lanes
// spent in it: the soft blend fold ends the walk's phase, the static fold
// C3's, and the step ends with the lane queue (hard mode: with C3).
// Beside the lanes' path: the first thread of block 0's reduction warp
// adds its cycles from each step's records to their release to K1_RED,
// and thread 0 and the first micro lane's thread their own B2 work
// (before the barrier) to K1_B2_MACRO and K1_B2_MICRO. Without the macro
// the stamps compile to nothing.
enum K1Phase {
  K1_A, K1_WALK, K1_B2, K1_C1, K1_C2, K1_C3, K1_QUEUE, K1_RED, K1_B2_MACRO,
  K1_B2_MICRO, K1_PHASES
};
#ifdef DHTS_K1_CLOCK
__device__ long long k1_cycles[K1_PHASES];
// the SM's clock, read by a volatile asm with a memory clobber: the
// compiler keeps it in order with the barriers' asm (clock64() may move
// across them)
__device__ __forceinline__ long long k1_now() {
#ifdef DHTS_CPU_EMULATION
  return clock64();
#else
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
#endif
}
#define K1_CLOCK_START(who)                             \
  const bool k1_clk = (who) && blockIdx.x == 0;         \
  long long k1_ck[K1_PHASES] = {};                      \
  long long k1_t0 = k1_clk ? k1_now() : 0
#define K1_MARK()                    \
  do {                               \
    if (k1_clk) k1_t0 = k1_now();    \
  } while (0)
#define K1_STAMP(p)                         \
  do {                                      \
    if (k1_clk) {                           \
      const long long k1_t = k1_now();      \
      k1_ck[p] += k1_t - k1_t0;             \
      k1_t0 = k1_t;                         \
    }                                       \
  } while (0)
// the cycles since the last stamp, added to p without a new stamp
#define K1_PEEK(p)                                 \
  do {                                             \
    if (k1_clk) k1_ck[p] += k1_now() - k1_t0;      \
  } while (0)
// each phase k1_i this thread counted and `keep` names
#define K1_CLOCK_END(keep)                                       \
  do {                                                           \
    if (k1_clk)                                                  \
      for (int k1_i = 0; k1_i < K1_PHASES; ++k1_i)               \
        if (k1_ck[k1_i] && (keep)) k1_cycles[k1_i] = k1_ck[k1_i]; \
  } while (0)
#else
#define K1_CLOCK_START(who) (void)0
#define K1_MARK() (void)0
#define K1_STAMP(p) (void)0
#define K1_PEEK(p) (void)0
#define K1_CLOCK_END(keep) (void)0
#endif

// PTX named barriers (the host build has its own, cpu_emulation.h): wait
// at, or only arrive at, barrier `id`, which completes when `count` threads
// have reached it. A warp must reach one converged (bar.sync and bar.arrive
// are .aligned), hence the __syncwarp() after lane-dependent branches.
#ifdef DHTS_CPU_EMULATION
#define CONVERGE() (void)0
#else
#define CONVERGE() __syncwarp()
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}
#endif

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
  S *u_emit;  // the last cell's speed after the physics (request, convert)
  S *cap_val, *hs_pos, *hs_vel, *hs_a;
  S *rec_q;          // [2, L] each lane's q^2, by step parity
  float *rec_wave;   // [2, L] its largest wave speed
  int *rec_ev;       // [2, L] its event bits (bit e: event row e)
  double *red_sum;   // [2 L] the static mean's partial sums per lane
  int *red_cnt;      // [2 L] and counts
  double *part_sum;  // [PARTS, MAX_WARPS] the warps' sums of a mean
  int *part_cnt;     // [PARTS, MAX_WARPS] and counts
  int *rid, *ridx, *count, *inj_left, *cursor;
  int *want, *mn, *hn, *hs_rid, *hs_ridx, *best, *dep_best;
};

template <class S>
__host__ __device__ inline size_t smem_bytes(const Dims& d, Smem<S>* s,
                                             char* base) {
  size_t off = 0;
  Smem<S> dummy;
  Smem<S>* t = s ? s : &dummy;
  char* b = s ? base : nullptr;
  const size_t L = d.L, LC = d.L * d.C, LV = d.L * d.V, LK = d.L * d.K;
  const size_t NP = PARTS * MAX_WARPS;
  carve(&t->r, LC, b, off); carve(&t->y, LC, b, off);
  carve(&t->pos, LV, b, off); carve(&t->vel, LV, b, off);
  carve(&t->av, LV, b, off); carve(&t->cap, LK, b, off);
  carve(&t->sig, L, b, off); carve(&t->r_last, L, b, off);
  carve(&t->u_last, L, b, off); carve(&t->r_first, L, b, off);
  carve(&t->u_first, L, b, off); carve(&t->u_emit, L, b, off);
  carve(&t->cap_val, L, b, off);
  carve(&t->hs_pos, L, b, off); carve(&t->hs_vel, L, b, off);
  carve(&t->hs_a, L, b, off); carve(&t->rec_q, 2 * L, b, off);
  carve(&t->rec_wave, 2 * L, b, off); carve(&t->rec_ev, 2 * L, b, off);
  carve(&t->red_sum, 2 * L, b, off); carve(&t->red_cnt, 2 * L, b, off);
  carve(&t->part_sum, NP, b, off); carve(&t->part_cnt, NP, b, off);
  carve(&t->rid, LV, b, off); carve(&t->ridx, LV, b, off);
  carve(&t->count, L, b, off); carve(&t->inj_left, L, b, off);
  carve(&t->cursor, L, b, off); carve(&t->want, L, b, off);
  carve(&t->mn, L, b, off); carve(&t->hn, L, b, off);
  carve(&t->hs_rid, L, b, off); carve(&t->hs_ridx, L, b, off);
  carve(&t->best, L, b, off); carve(&t->dep_best, L, b, off);
  return off;
}

// The global placement's carving: the state arrays (every array of C, V or
// K entries a lane: r, y, pos, vel, av, cap, rid, ridx) from the block's
// workspace `ws` in global memory, whose bytes go to *ws_bytes, and the
// per-lane summaries, records and partial sums where smem_bytes puts them
// in shared memory (its carving at C = V = K = 0), whose bytes it returns.
template <class S>
__host__ __device__ inline size_t split_bytes(const Dims& d, Smem<S>* s,
                                              char* base, char* ws,
                                              size_t* ws_bytes) {
  Dims summaries = d;
  summaries.C = summaries.V = summaries.K = 0;
  const size_t smem = smem_bytes<S>(summaries, s, base);
  size_t off = 0;
  Smem<S> dummy;
  Smem<S>* t = s ? s : &dummy;
  char* b = s ? ws : nullptr;
  const size_t LC = d.L * d.C, LV = d.L * d.V, LK = d.L * d.K;
  carve(&t->r, LC, b, off); carve(&t->y, LC, b, off);
  carve(&t->pos, LV, b, off); carve(&t->vel, LV, b, off);
  carve(&t->av, LV, b, off); carve(&t->cap, LK, b, off);
  carve(&t->rid, LV, b, off); carve(&t->ridx, LV, b, off);
  *ws_bytes = off;
  return smem;
}

// A shuffle down (by `o` lanes) of every 32-bit word of a plain struct:
// one exchange round in the host build, one SHFL a word on the card.
template <class T>
__device__ __forceinline__ T shfl_down_words(T v, int o) {
#ifdef DHTS_CPU_EMULATION
  return __shfl_down_sync(FULL_MASK, v, o);
#else
  static_assert(sizeof(T) % 4 == 0, "a struct of 32-bit words");
  unsigned w[sizeof(T) / 4];
  memcpy(w, &v, sizeof(T));
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 4); ++i)
    w[i] = __shfl_down_sync(FULL_MASK, w[i], o);
  memcpy(&v, w, sizeof(T));
  return v;
#endif
}

// K running means' terms of one thread: float64 sums and counts
template <int K>
struct Terms {
  double x[K];
  int n[K];
};

// The warp's sums of its threads' terms by a fixed shuffle tree (offsets
// 16, 8, 4, 2, 1), written by its first thread to ps/pc[k * MAX_WARPS +
// w] for each mean k. The order is fixed, so every launch folds the same
// way.
template <int K>
__device__ __forceinline__ void warp_part(Terms<K> v, double* ps, int* pc,
                                          int w) {
  for (int o = WARP / 2; o > 0; o >>= 1) {
    const Terms<K> u = shfl_down_words(v, o);
    for (int k = 0; k < K; ++k) {
      v.x[k] += u.x[k];
      v.n[k] += u.n[k];
    }
  }
  if (threadIdx.x % WARP == 0)
    for (int k = 0; k < K; ++k) {
      ps[k * MAX_WARPS + w] = v.x[k];
      pc[k * MAX_WARPS + w] = v.n[k];
    }
}

// Every lane thread folds the nw warps' partial sums, in warp order, into
// its copy of a running mean (sum += float(sum64), count += n;
// rms.update_mean_masked) and returns its mean (rms.mean_of with default
// 1): the same operations on the same values in every thread.
__device__ __forceinline__ float fold_parts(const double* ps, const int* pc,
                                            int nw, float& sum, float& cnt) {
  double tot = 0.0;
  int n = 0;
  for (int w = 0; w < nw; ++w) {
    tot += ps[w];
    n += pc[w];
  }
  sum = sum + (float)tot;
  cnt = cnt + (float)n;
  return cnt > 0.0f ? sum / fmaxf(cnt, 1.0f) : 1.0f;
}

// a step's event counts and largest wave speed (the reduction warp)
struct Events {
  int cnt[NEV];
  float wave;
};

// The reduction warp: for each step, once the lanes' records of it are in
// (FULL), the queue sum_l q^2 * dt in lane order by its first thread
// (float32, or dual numbers whose value and tangent are each added in lane
// order), the seven event counts and the largest wave speed by the warp,
// then it frees the records' slot for the step two on (EMPTY). The lanes go on
// meanwhile. Writes queues[t] and events[t, 8] (the forward) and, at the
// end, the reward or the gradient sum_t w[t] * d(queue_t)/d(action_j).
template <class S>
__device__ void reduce_steps(const Smem<S>& s, const Dims& d,
                             const Consts& k, int lane_threads,
                             const float* __restrict__ q_weight,
                             float* __restrict__ out_queues,
                             float* __restrict__ out_events,
                             float* __restrict__ out_reward,
                             float* __restrict__ out_grad) {
  const int L = d.L, T = d.T, wl = threadIdx.x % WARP;
  const int n_bar = lane_threads + WARP;
  K1_CLOCK_START(wl == 0);
  for (int p = 0; p < 2 && p < T; ++p) bar_arrive(BAR_EMPTY + p, n_bar);
  float qsum = 0.0f;
  double grad = 0.0;
  for (int t = 0; t < T; ++t) {
    const int slot = t & 1;
    bar_sync(BAR_FULL + slot, n_bar);
    K1_MARK();
    const S* rq = s.rec_q + slot * L;
    const float* rw = s.rec_wave + slot * L;
    const int* re = s.rec_ev + slot * L;
    // the event counts (integer sums) and the largest wave speed, exact in
    // any order: each thread takes every 32nd lane, then a shuffle tree
    Events ev{};
    if (out_queues) {
      for (int j = wl; j < L; j += WARP) {
        const int bits = re[j];
        for (int e = 0; e < NEV; ++e) ev.cnt[e] += (bits >> e) & 1;
        ev.wave = max_of(ev.wave, rw[j]);
      }
      for (int o = WARP / 2; o > 0; o >>= 1) {
        const Events u = shfl_down_words(ev, o);
        for (int e = 0; e < NEV; ++e) ev.cnt[e] += u.cnt[e];
        ev.wave = max_of(ev.wave, u.wave);
      }
    }
    if (wl == 0) {
      S qs = 0.0f;
      for (int j = 0; j < L; ++j) qs = qs + rq[j];
      const S queue = qs * S(k.dt);
      qsum += val(queue);
      if (q_weight) grad += (double)q_weight[t] * (double)tangent(queue);
      if (out_queues) {
        const int* cnt = ev.cnt;
        const float wave = ev.wave;
        out_queues[t] = val(queue);
        for (int e = 0; e < NEV; ++e) out_events[t * 8 + e] = (float)cnt[e];
        out_events[t * 8 + 7] = wave;
      }
    }
    CONVERGE();
    if (t + 2 < T) bar_arrive(BAR_EMPTY + slot, n_bar);
    K1_STAMP(K1_RED);
  }
  K1_CLOCK_END(true);
  if (wl == 0) {
    if (out_reward) out_reward[0] = -qsum;
    if (out_grad) out_grad[0] = (float)grad;
  }
}

// One episode per block. S = float: the forward; block e writes reward[e],
// queues[e, T], events[e, T, 8] (`q_weight`/`out_grad` unused). S = Dual:
// the backward; block e * n_act + j seeds action entry j of episode e and
// writes out_grad[e * n_act + j] = sum_t q_weight[e, t] *
// d(queue_{e,t})/d(action_{e,j}) (the forward outputs are unused). The
// block's first `lane_threads` threads run the lanes, thread i the lane
// thread_lane[i] (-1: an idle thread of a warp's padding), with the
// per-lane phases of itscp_step.cuh on the state in shared memory; its
// last warp reduces the steps (reduce_steps). A launch of one episode
// passes no Episodes (Ep empty): that instantiation has no episode axis in
// its parameters or its code.
template <class S, class... Ep>
__global__ void itscp_hybrid_episode_kernel(
    const float* __restrict__ action, const float* __restrict__ sched,
    const int* __restrict__ mnext, const int* __restrict__ mprev,
    const float* __restrict__ rand, const int* __restrict__ inj_routes,
    const int* __restrict__ emit_routes, const float* __restrict__ prog,
    const int* __restrict__ lane_i, const float* __restrict__ lane_f,
    const int* __restrict__ thread_lane, float* __restrict__ out_reward,
    float* __restrict__ out_queues, float* __restrict__ out_events,
    const float* __restrict__ q_weight, float* __restrict__ out_grad,
    Dims d, Consts k, int lane_threads, Ep... eps) {
  constexpr bool kBatch = sizeof...(Ep) > 0;
  const Episodes ep = episodes_of(eps...);
  DHTS_DYNAMIC_SMEM(smem_raw);
  Smem<S> s;
  smem_bytes<S>(d, &s, smem_raw);

  const int L = d.L, C = d.C, V = d.V, K = d.K;
  const int mode = d.mode;
  const int NT = lane_threads;
  const bool reducer = (int)threadIdx.x >= NT;
  const int l = reducer ? -1 : thread_lane[threadIdx.x];
  const int warp = threadIdx.x / WARP, n_warps = NT / WARP;
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
  const bool lane = l >= 0;
  const float u_max = k.u_max;
  const Scene sc{lane_i, lane_f, inj_routes, emit_routes};
  LaneState<S, S*, false> st{s.r, s.y, s.pos, s.vel, s.av, s.cap,
                      {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr},
                      s.rid, s.ridx, s.count, s.inj_left, s.cursor,
                      C, 1, V, 1, K, 1};
  set_defaults(st, k);
  // the conversion's view: the speed of the last cell after the physics
  // goes to u_emit, so that the next step's edges (u_last) may be written
  // while a slower lane still reads it
  Smem<S> sv = s;
  sv.u_last = s.u_emit;

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
  __syncthreads();
  if (reducer) {
    reduce_steps<S>(s, d, k, NT, q_weight, out_queues, out_events,
                    out_reward,
                    out_grad ? out_grad + (kBatch ? (int)blockIdx.x : seed)
                             : nullptr);
    return;
  }
  // thread 0 stamps the lanes' path, the first micro lane's thread its B2
  K1_CLOCK_START(threadIdx.x == 0 ||
                 (lane && !g.is_macro && threadIdx.x % WARP == 0 &&
                  (thread_lane[threadIdx.x - 1] < 0 ||
                   sc.macro_at(thread_lane[threadIdx.x - 1]))));
  // the running means (sum, count), the same in every lane thread: the
  // micro blend's signal, the queue gates' static speed
  float sig_sum = 0.0f, sig_cnt = 0.0f, st_sum = 0.0f, st_cnt = 0.0f;
  // the step's input rows, loaded a step ahead
  float nx_sched = 0.0f, nx_rand = 0.0f;
  int nx_mprev = -1, nx_mnext = -1;
  if (lane) {
    nx_sched = sched[l]; nx_rand = rand[l];
    nx_mprev = mprev[l]; nx_mnext = mnext[l];
  }

  for (int t = 0; t < d.T; ++t) {
    const int slot = t & 1;
    const float sch = nx_sched, rnd = nx_rand;
    const int mp = nx_mprev, mnx = nx_mnext;
    if (lane && t + 1 < d.T) {
      const int tn = (t + 1) * L + l;
      nx_sched = sched[tn]; nx_rand = rand[tn];
      nx_mprev = mprev[tn]; nx_mnext = mnext[tn];
    }
    // ================= A: signal, injection, boundary cells ============
    int ev_inj = 0;
    float incoming = -1.0f;
    if (lane) {
      s.sig[l] = lane_signal<S>(action, prog, d, k, g, t, seed);
      incoming = g.has_prev ? -1.0f : sch;
      ev_inj = inject<S>(st, g, d, k, l, rnd, incoming) ? 1 : 0;
      publish_edges<S>(st, s, l, last, u_max);
    }
    // the records' slot of step t - 2 is free once this completes
    CONVERGE();
    bar_sync(BAR_EMPTY + slot, NT + WARP);
    K1_STAMP(K1_A);

    // ================= B1: ghosts, leader walk (reads only) ============
    Ghosts<S> gh{0.f, 0.f, 0.f, 0.f};
    S hpd = 0.f, hsd = 0.f;
    // soft micro blend: the green leader, the red stop, the blended signal
    S pd_g = 0.f, sd_g = 0.f, red_pd = 0.f, fsig = 0.f;
    bool blend = false;
    if (lane) {
      gh = ghosts<S>(s, sc, g, L, l, mp, mnx, incoming, mode,
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
      // the blend gate (env boundary_and_step, signal_ms). The walk's
      // reads end at this barrier, before any lane writes its state.
      warp_part(Terms<1>{{blend ? (double)val(fsig) : 0.0}, {blend ? 1 : 0}},
                s.part_sum + PART_BLEND * MAX_WARPS,
                s.part_cnt + PART_BLEND * MAX_WARPS, warp);
      CONVERGE();
      bar_sync(BAR_LANES, NT);
      K1_STAMP(K1_WALK);
      const float mean = fold_parts(s.part_sum + PART_BLEND * MAX_WARPS,
                                    s.part_cnt + PART_BLEND * MAX_WARPS,
                                    n_warps, sig_sum, sig_cnt);
      if (blend) {
        const float c = sharpness(k.gate32, mean);
        const S fs = stg(val(fsig) >= 0.5f, soft(fsig - S(0.5f), c), mode);
        hpd = pd_g * fs + red_pd * (S(1.0f) - fs);
        hsd = sd_g * fs;
      }
    } else {
      CONVERGE();
      bar_sync(BAR_LANES, NT);
      K1_STAMP(K1_WALK);
    }

    // ================= B2: Godunov (macro) and IDM (micro) =============
    float lane_wave = 0.0f;
    if (lane) {
      if (g.is_macro) {
        lane_wave = godunov_lane<S>(st, g, l, C, gh, k);
        K1_PEEK(K1_B2_MACRO);
      } else {
        idm_lane<S>(st, l, hpd, hsd, k);
        K1_PEEK(K1_B2_MICRO);
      }
    }
    CONVERGE();
    bar_sync(BAR_LANES, NT);
    K1_STAMP(K1_B2);

    // ================= C1: conversion requests ==========================
    Request<S> rq;
    if (lane) rq = request<S>(st, sv, sc, g, d, k, l, mnx, last);
    CONVERGE();
    bar_sync(BAR_LANES, NT);
    K1_STAMP(K1_C1);

    // ================= C2: arbitration (pull, lowest source id) ========
    if (lane) arbitrate(s, sc, L, K, l);
    CONVERGE();
    bar_sync(BAR_LANES, NT);
    K1_STAMP(K1_C2);

    // ================= C3: verdicts, removals, inserts, deposits =======
    // (reads only other lanes' C1/C2 summaries, which no lane writes
    // again before the next step's first barrier)
    int n_after = 0, ev_bits = 0;
    if (lane) {
      const Verdict vd = convert<S>(st, sv, sc, g, rq, d, k, l);
      n_after = vd.n;
      const int ev[NEV] = {ev_inj,
                           vd.is_emit,
                           vd.exit_none || vd.dep_win,
                           vd.has_insert && !vd.is_emit,
                           vd.tr_win,
                           vd.dep_win,
                           vd.remove};
      for (int e = 0; e < NEV; ++e) ev_bits |= (ev[e] ? 1 : 0) << e;
    }

    // ---- queue of this lane
    float c_st = 0.0f;
    S u_cells[MAXC];  // soft modes: the cells' speeds, taken once
    if (mode != HARD) {
      // running mean of (static_speed - speed) over macro cells, then over
      // micro vehicles; its detached mean sharpens the queue gates
      Terms<2> terms{{0.0, 0.0}, {0, 0}};  // cells, vehicles
      if (lane) {
        static_partials<S>(st, s, g, L, l, n_after, k, u_cells);
        terms = Terms<2>{{s.red_sum[l], s.red_sum[L + l]},
                         {s.red_cnt[l], s.red_cnt[L + l]}};
      }
      warp_part(terms, s.part_sum + PART_CELLS * MAX_WARPS,
                s.part_cnt + PART_CELLS * MAX_WARPS, warp);
      CONVERGE();
      bar_sync(BAR_LANES, NT);
      K1_STAMP(K1_C3);
      fold_parts(s.part_sum + PART_CELLS * MAX_WARPS,
                 s.part_cnt + PART_CELLS * MAX_WARPS, n_warps, st_sum,
                 st_cnt);
      const float mean = fold_parts(s.part_sum + PART_VEHS * MAX_WARPS,
                                    s.part_cnt + PART_VEHS * MAX_WARPS,
                                    n_warps, st_sum, st_cnt);
      c_st = sharpness(16.0f, mean);
    }
    if (lane) {
      const S q_lane = lane_queue<S>(st, g, l, n_after, mode, c_st, k,
                                     mode != HARD ? u_cells : nullptr);
      s.rec_q[slot * L + l] = q_lane * q_lane;
      s.rec_wave[slot * L + l] = lane_wave;
      s.rec_ev[slot * L + l] = ev_bits;
    }
    // ================= D: the reduction warp takes the records =========
    CONVERGE();
    bar_arrive(BAR_FULL + slot, NT + WARP);
    if (mode == HARD) K1_STAMP(K1_C3); else K1_STAMP(K1_QUEUE);
  }
  K1_CLOCK_END(threadIdx.x == 0 ? k1_i != K1_B2_MICRO
                                : k1_i == K1_B2_MICRO);
}

// The wide kernel's episode: itscp_hybrid_episode_kernel's, phase by
// phase and operation by operation, for LPT lanes a thread and the state
// that `s` points to (shared or global memory), always with the episode
// axis. The block's first `lane_threads` threads run the lanes, thread i
// the LPT lanes thread_lane[k * lane_threads + i], k = 0 .. LPT - 1 (-1:
// none), each phase of a step for each of its lanes in that order before
// the phase's barrier; its last warp reduces the steps (reduce_steps). At
// one lane a thread it computes what itscp_hybrid_episode_kernel computes,
// bit for bit, with the state in either place.
template <class S, int LPT>
__device__ __forceinline__ void run_episode(
    const Smem<S>& s, const float* __restrict__ action,
    const float* __restrict__ sched, const int* __restrict__ mnext,
    const int* __restrict__ mprev, const float* __restrict__ rand,
    const int* __restrict__ inj_routes, const int* __restrict__ emit_routes,
    const float* __restrict__ prog, const int* __restrict__ lane_i,
    const float* __restrict__ lane_f, const int* __restrict__ thread_lane,
    float* __restrict__ out_reward, float* __restrict__ out_queues,
    float* __restrict__ out_events, const float* __restrict__ q_weight,
    float* __restrict__ out_grad, const Dims& d, const Consts& k,
    int lane_threads, const Episodes& ep) {
  const int L = d.L, C = d.C, V = d.V, K = d.K;
  const int mode = d.mode;
  const int NT = lane_threads;
  const bool reducer = (int)threadIdx.x >= NT;
  int ls[LPT];  // the thread's lanes (-1: none)
#pragma unroll
  for (int i = 0; i < LPT; ++i)
    ls[i] = reducer ? -1 : thread_lane[i * NT + threadIdx.x];
  const int warp = threadIdx.x / WARP, n_warps = NT / WARP;
  const int seed = blockIdx.x % ep.blocks;
  {
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
  const float u_max = k.u_max;
  const Scene sc{lane_i, lane_f, inj_routes, emit_routes};
  LaneState<S, S*, false> st{s.r, s.y, s.pos, s.vel, s.av, s.cap,
                      {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr},
                      s.rid, s.ridx, s.count, s.inj_left, s.cursor,
                      C, 1, V, 1, K, 1};
  set_defaults(st, k);
  // the conversion's view: the speed of the last cell after the physics
  // goes to u_emit, so that the next step's edges (u_last) may be written
  // while a slower lane still reads it
  Smem<S> sv = s;
  sv.u_last = s.u_emit;

  LaneGeom g[LPT];
  int last[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    g[i] = ls[i] >= 0 ? lane_geom(sc, L, K, ls[i]) : LaneGeom();
    last[i] = min(max(g[i].num_cell - 1, 0), C - 1);
  }
  auto clampL = [&](int j) { return min(max(j, 0), L - 1); };

  // ---- initial (empty) state
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int l = ls[i];
    if (l < 0) continue;
    for (int c = 0; c < C; ++c) { s.r[l * C + c] = 0.0f; s.y[l * C + c] = 0.0f; }
    for (int v = 0; v < V; ++v) {
      s.pos[l * V + v] = 0.0f; s.vel[l * V + v] = 0.0f;
      s.av[l * V + v] = k.veh_len; s.rid[l * V + v] = -1;
      s.ridx[l * V + v] = 0;
    }
    for (int q = 0; q < K; ++q) s.cap[l * K + q] = 0.0f;
    s.count[l] = 0;
    s.inj_left[l] = (!g[i].has_prev && !g[i].is_macro) ? d.P : 0;
    s.cursor[l] = 0;
  }
  __syncthreads();
  if (reducer) {
    reduce_steps<S>(s, d, k, NT, q_weight, out_queues, out_events,
                    out_reward, out_grad ? out_grad + blockIdx.x : nullptr);
    return;
  }
  // thread 0 stamps the lanes' path, the first micro lane's thread its B2
  K1_CLOCK_START(threadIdx.x == 0 ||
                 (ls[0] >= 0 && !g[0].is_macro && threadIdx.x % WARP == 0 &&
                  (thread_lane[threadIdx.x - 1] < 0 ||
                   sc.macro_at(thread_lane[threadIdx.x - 1]))));
  // the running means (sum, count), the same in every lane thread: the
  // micro blend's signal, the queue gates' static speed
  float sig_sum = 0.0f, sig_cnt = 0.0f, st_sum = 0.0f, st_cnt = 0.0f;
  // the step's input rows, loaded a step ahead
  float nx_sched[LPT], nx_rand[LPT];
  int nx_mprev[LPT], nx_mnext[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int l = ls[i];
    nx_sched[i] = 0.0f; nx_rand[i] = 0.0f; nx_mprev[i] = -1; nx_mnext[i] = -1;
    if (l >= 0) {
      nx_sched[i] = sched[l]; nx_rand[i] = rand[l];
      nx_mprev[i] = mprev[l]; nx_mnext[i] = mnext[l];
    }
  }

  for (int t = 0; t < d.T; ++t) {
    const int slot = t & 1;
    float sch[LPT], rnd[LPT];
    int mp[LPT], mnx[LPT];
    // ================= A: signal, injection, boundary cells ============
    int ev_inj[LPT];
    float incoming[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int l = ls[i];
      sch[i] = nx_sched[i]; rnd[i] = nx_rand[i];
      mp[i] = nx_mprev[i]; mnx[i] = nx_mnext[i];
      if (l >= 0 && t + 1 < d.T) {
        const int tn = (t + 1) * L + l;
        nx_sched[i] = sched[tn]; nx_rand[i] = rand[tn];
        nx_mprev[i] = mprev[tn]; nx_mnext[i] = mnext[tn];
      }
      ev_inj[i] = 0;
      incoming[i] = -1.0f;
      if (l >= 0) {
        s.sig[l] = lane_signal<S>(action, prog, d, k, g[i], t, seed);
        incoming[i] = g[i].has_prev ? -1.0f : sch[i];
        ev_inj[i] = inject<S>(st, g[i], d, k, l, rnd[i], incoming[i]) ? 1 : 0;
        publish_edges<S>(st, s, l, last[i], u_max);
      }
    }
    // the records' slot of step t - 2 is free once this completes
    CONVERGE();
    bar_sync(BAR_EMPTY + slot, NT + WARP);
    K1_STAMP(K1_A);

    // ================= B1: ghosts, leader walk (reads only) ============
    Ghosts<S> gh[LPT];
    S hpd[LPT], hsd[LPT];
    // soft micro blend: the green leader, the red stop, the blended signal
    S pd_g[LPT], sd_g[LPT], red_pd[LPT], fsig[LPT];
    bool blend[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int l = ls[i];
      gh[i] = Ghosts<S>{0.f, 0.f, 0.f, 0.f};
      hpd[i] = 0.f; hsd[i] = 0.f;
      pd_g[i] = 0.f; sd_g[i] = 0.f; red_pd[i] = 0.f; fsig[i] = 0.f;
      blend[i] = false;
      if (l < 0) continue;
      gh[i] = ghosts<S>(s, sc, g[i], L, l, mp[i], mnx[i], incoming[i], mode,
                        k);
      if (!g[i].is_macro) {
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
        const S cur_delta = (S(g[i].length) - hpos) - S(k.veh_len * 0.5f) +
                            S((float)crossed);
        const bool found = exists && any_term && occupied;
        pd_g[i] = found ? vmax((cur_delta + s.pos[lead * V]) -
                                   S(k.veh_len * 0.5f), S(0.0f))
                        : S(1000.0f);
        sd_g[i] = found ? hvel - s.vel[lead * V] : S(0.0f);
        // the signal of the lane the head is on
        red_pd[i] = vmax((S(g[i].length) - hpos) - S(k.veh_len * 0.5f),
                         S(0.0f));
        const int curr = route_at(inj_routes, emit_routes, hrid,
                                  min(max(hridx, 0), d.R - 1), d);
        if (mode == HARD) {
          const float fs = val(s.sig[clampL(curr)]);
          if (exists) {
            const bool green = fs >= 0.5f;
            hpd[i] = green ? pd_g[i] : red_pd[i];
            hsd[i] = green ? sd_g[i] : S(0.0f);
          } else {
            hpd[i] = pd_g[i]; hsd[i] = sd_g[i];
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
                                 soft(S(g[i].length) - hpos, 16.0f), mode);
          S n_sc = next_exist
                       ? stg(false, soft(hpos - S(g[i].length), 16.0f), mode)
                       : S(0.0f);
          const S ssum = (p_sc + c_sc) + n_sc;
          p_sc = p_sc / ssum; c_sc = c_sc / ssum; n_sc = n_sc / ssum;
          S fs = c_sc * s.sig[clampL(curr)];
          fs = fs + (prev_exist ? p_sc * s.sig[clampL(prev_l)] : S(0.0f));
          fs = fs + (next_exist ? n_sc * s.sig[clampL(next_l)] : S(0.0f));
          fsig[i] = fs;
          blend[i] = true;
        } else {
          hpd[i] = pd_g[i]; hsd[i] = sd_g[i];
        }
      }
    }
    if (mode != HARD) {
      // running mean of the blended signal; its detached mean sharpens
      // the blend gate (env boundary_and_step, signal_ms). The walk's
      // reads end at this barrier, before any lane writes its state. A
      // thread adds its lanes' terms in list order.
      Terms<1> terms{{blend[0] ? (double)val(fsig[0]) : 0.0},
                     {blend[0] ? 1 : 0}};
#pragma unroll
      for (int i = 1; i < LPT; ++i)
        if (blend[i]) {
          terms.x[0] += (double)val(fsig[i]);
          terms.n[0] += 1;
        }
      warp_part(terms, s.part_sum + PART_BLEND * MAX_WARPS,
                s.part_cnt + PART_BLEND * MAX_WARPS, warp);
      CONVERGE();
      bar_sync(BAR_LANES, NT);
      K1_STAMP(K1_WALK);
      const float mean = fold_parts(s.part_sum + PART_BLEND * MAX_WARPS,
                                    s.part_cnt + PART_BLEND * MAX_WARPS,
                                    n_warps, sig_sum, sig_cnt);
#pragma unroll
      for (int i = 0; i < LPT; ++i)
        if (blend[i]) {
          const float c = sharpness(k.gate32, mean);
          const S fs = stg(val(fsig[i]) >= 0.5f, soft(fsig[i] - S(0.5f), c),
                           mode);
          hpd[i] = pd_g[i] * fs + red_pd[i] * (S(1.0f) - fs);
          hsd[i] = sd_g[i] * fs;
        }
    } else {
      CONVERGE();
      bar_sync(BAR_LANES, NT);
      K1_STAMP(K1_WALK);
    }

    // ================= B2: Godunov (macro) and IDM (micro) =============
    float lane_wave[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int l = ls[i];
      lane_wave[i] = 0.0f;
      if (l < 0) continue;
      if (g[i].is_macro) {
        lane_wave[i] = godunov_lane<S>(st, g[i], l, C, gh[i], k);
        K1_PEEK(K1_B2_MACRO);
      } else {
        idm_lane<S>(st, l, hpd[i], hsd[i], k);
        K1_PEEK(K1_B2_MICRO);
      }
    }
    CONVERGE();
    bar_sync(BAR_LANES, NT);
    K1_STAMP(K1_B2);

    // ================= C1: conversion requests ==========================
    Request<S> rq[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i)
      if (ls[i] >= 0)
        rq[i] = request<S>(st, sv, sc, g[i], d, k, ls[i], mnx[i], last[i]);
    CONVERGE();
    bar_sync(BAR_LANES, NT);
    K1_STAMP(K1_C1);

    // ================= C2: arbitration (pull, lowest source id) ========
#pragma unroll
    for (int i = 0; i < LPT; ++i)
      if (ls[i] >= 0) arbitrate(s, sc, L, K, ls[i]);
    CONVERGE();
    bar_sync(BAR_LANES, NT);
    K1_STAMP(K1_C2);

    // ================= C3: verdicts, removals, inserts, deposits =======
    // (reads only other lanes' C1/C2 summaries, which no lane writes
    // again before the next step's first barrier)
    int n_after[LPT], ev_bits[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int l = ls[i];
      n_after[i] = 0; ev_bits[i] = 0;
      if (l < 0) continue;
      const Verdict vd = convert<S>(st, sv, sc, g[i], rq[i], d, k, l);
      n_after[i] = vd.n;
      const int ev[NEV] = {ev_inj[i],
                           vd.is_emit,
                           vd.exit_none || vd.dep_win,
                           vd.has_insert && !vd.is_emit,
                           vd.tr_win,
                           vd.dep_win,
                           vd.remove};
      for (int e = 0; e < NEV; ++e) ev_bits[i] |= (ev[e] ? 1 : 0) << e;
    }

    // ---- queue of this lane
    float c_st = 0.0f;
    // soft modes: the cells' speeds, taken once (one lane a thread; with
    // more, lane_queue takes them again from the same state)
    S u_cells[MAXC];
    S* const uc = LPT == 1 ? u_cells : nullptr;
    if (mode != HARD) {
      // running mean of (static_speed - speed) over macro cells, then over
      // micro vehicles; its detached mean sharpens the queue gates
      Terms<2> terms{{0.0, 0.0}, {0, 0}};  // cells, vehicles
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        const int l = ls[i];
        if (l < 0) continue;
        static_partials<S>(st, s, g[i], L, l, n_after[i], k, uc);
        const Terms<2> lt{{s.red_sum[l], s.red_sum[L + l]},
                          {s.red_cnt[l], s.red_cnt[L + l]}};
        if (i == 0) {
          terms = lt;
        } else {
          for (int q = 0; q < 2; ++q) {
            terms.x[q] += lt.x[q];
            terms.n[q] += lt.n[q];
          }
        }
      }
      warp_part(terms, s.part_sum + PART_CELLS * MAX_WARPS,
                s.part_cnt + PART_CELLS * MAX_WARPS, warp);
      CONVERGE();
      bar_sync(BAR_LANES, NT);
      K1_STAMP(K1_C3);
      fold_parts(s.part_sum + PART_CELLS * MAX_WARPS,
                 s.part_cnt + PART_CELLS * MAX_WARPS, n_warps, st_sum,
                 st_cnt);
      const float mean = fold_parts(s.part_sum + PART_VEHS * MAX_WARPS,
                                    s.part_cnt + PART_VEHS * MAX_WARPS,
                                    n_warps, st_sum, st_cnt);
      c_st = sharpness(16.0f, mean);
    }
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int l = ls[i];
      if (l < 0) continue;
      const S q_lane = lane_queue<S>(st, g[i], l, n_after[i], mode, c_st, k,
                                     mode != HARD ? uc : nullptr);
      s.rec_q[slot * L + l] = q_lane * q_lane;
      s.rec_wave[slot * L + l] = lane_wave[i];
      s.rec_ev[slot * L + l] = ev_bits[i];
    }
    // ================= D: the reduction warp takes the records =========
    CONVERGE();
    bar_arrive(BAR_FULL + slot, NT + WARP);
    if (mode == HARD) K1_STAMP(K1_C3); else K1_STAMP(K1_QUEUE);
  }
  K1_CLOCK_END(threadIdx.x == 0 ? k1_i != K1_B2_MICRO
                                : k1_i == K1_B2_MICRO);
}

// A block's workspace in global memory (the global placement): `bytes`
// a block, block b's at base + b * bytes
struct Workspace {
  char* base;
  size_t bytes;
};

// The scenes whose state one block's shared memory does not hold (the 5x5
// grid's backward, the 7x7 and 9x9 grids): the state's per-lane arrays in
// the block's workspace (split_bytes), LPT lanes a thread (two at 9x9),
// always with the episode axis. At most 1,024 threads, so ptxas keeps it
// within 64 registers a thread.
#ifdef DHTS_CPU_EMULATION
#define K1_WIDE_BOUNDS
#else
#define K1_WIDE_BOUNDS __launch_bounds__(1024)
#endif
template <class S, int LPT>
__global__ void K1_WIDE_BOUNDS itscp_hybrid_episode_wide(
    const float* __restrict__ action, const float* __restrict__ sched,
    const int* __restrict__ mnext, const int* __restrict__ mprev,
    const float* __restrict__ rand, const int* __restrict__ inj_routes,
    const int* __restrict__ emit_routes, const float* __restrict__ prog,
    const int* __restrict__ lane_i, const float* __restrict__ lane_f,
    const int* __restrict__ thread_lane, float* __restrict__ out_reward,
    float* __restrict__ out_queues, float* __restrict__ out_events,
    const float* __restrict__ q_weight, float* __restrict__ out_grad,
    Dims d, Consts k, int lane_threads, Episodes ep, Workspace ws) {
  DHTS_DYNAMIC_SMEM(smem_raw);
  Smem<S> s;
  size_t ws_bytes = 0;
  split_bytes<S>(d, &s, smem_raw, ws.base + (size_t)blockIdx.x * ws.bytes,
                 &ws_bytes);
  run_episode<S, LPT>(s, action, sched, mnext, mprev, rand, inj_routes,
                      emit_routes, prog, lane_i, lane_f, thread_lane,
                      out_reward, out_queues, out_events, q_weight, out_grad,
                      d, k, lane_threads, ep);
}

// Whether blocks of `threads` threads and `smem` bytes of dynamic shared
// memory fit `kernel` on this device: at most its maxThreadsPerBlock (what
// its registers allow) and, with its static shared memory, at most the
// device's opt-in shared memory a block. The host build has no limit but
// 1,024 threads.
template <class Kernel>
bool fits(Kernel kernel, int threads, size_t smem) {
#ifdef DHTS_CPU_EMULATION
  (void)kernel;
  (void)smem;
  return threads <= 1024;
#else
  static int optin = 0;
  int dev;
  if (!optin && (cudaGetDevice(&dev) != cudaSuccess ||
                 cudaDeviceGetAttribute(
                     &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
                     cudaSuccess))
    return false;
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, kernel) != cudaSuccess) return false;
  return threads <= a.maxThreadsPerBlock &&
         smem + a.sharedSizeBytes <= (size_t)optin;
#endif
}

// one launch of `kernel` with `smem` bytes of dynamic shared memory;
// cudaErrorInvalidConfiguration (9) where the block does not fit (fits)
template <class Kernel, class... Args>
int start(Kernel kernel, int blocks, int threads, size_t smem, void* stream,
          Args... args) {
  if (!fits(kernel, threads, smem)) return 9;
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

// where a block's state lives (the launchers' `placement`)
constexpr int IN_SHARED = 0, IN_GLOBAL = 1;
constexpr int MAX_LPT = 2;  // lanes a thread at most

// the block's shared and workspace bytes for a placement
template <class S>
size_t bytes_of(const Dims& d, int placement, size_t* ws_bytes) {
  *ws_bytes = 0;
  return placement == IN_GLOBAL
             ? split_bytes<S>(d, nullptr, nullptr, nullptr, ws_bytes)
             : smem_bytes<S>(d, nullptr, nullptr);
}

// The placement that the kernels take at these sizes and `lpt` lanes a
// thread of `lane_threads` lane threads: IN_SHARED where one lane a thread
// and both instantiations of the shared-memory kernel fit (fits), else
// IN_GLOBAL where the wide kernel fits, else -1.
template <class S>
int placement_for(const Dims& d, int lane_threads, int lpt) {
  const int threads = lane_threads + WARP;
  size_t ws_bytes = 0;
  if (lpt == 1) {
    const size_t smem = bytes_of<S>(d, IN_SHARED, &ws_bytes);
    if (fits(itscp_hybrid_episode_kernel<S>, threads, smem) &&
        fits(itscp_hybrid_episode_kernel<S, Episodes>, threads, smem))
      return IN_SHARED;
  }
  const size_t smem = bytes_of<S>(d, IN_GLOBAL, &ws_bytes);
  if (lpt == 1 ? fits(itscp_hybrid_episode_wide<S, 1>, threads, smem)
               : lpt == 2 &&
                     fits(itscp_hybrid_episode_wide<S, 2>, threads, smem))
    return IN_GLOBAL;
  return -1;
}

// shared launch path of the forward (S = float, one block per episode)
// and the backward (S = Dual, one block per episode and action entry):
// lane_threads lane threads (whole warps) of `lpt` lanes each and the
// reduction warp. The state in shared memory (one lane a thread) runs
// itscp_hybrid_episode_kernel (B = 1: its instantiation without the
// episode axis); in global memory the wide kernel, whose blocks take
// `workspace` (bytes_of's workspace bytes a block, B * ep.blocks blocks).
// A layout that does not fit the device is refused (start).
template <class S>
int launch(int B, const Episodes& ep, const float* action, const float* sched,
           const int* mnext, const int* mprev, const float* rand,
           const int* inj_routes, const int* emit_routes, const float* prog,
           const int* lane_i, const float* lane_f, const int* thread_lane,
           int lane_threads, float* out_reward, float* out_queues,
           float* out_events, const float* q_weight, float* out_grad,
           const Dims& d, const Consts& k, void* stream, int lpt,
           int placement, void* workspace) {
  if (d.L < 1 || d.C < 1 || d.C > MAXC || d.V < 1 || d.R < 1 || d.K < 1 ||
      d.mode < HARD || d.mode > ST || B < 1 || lpt < 1 || lpt > MAX_LPT ||
      (placement != IN_SHARED && placement != IN_GLOBAL) ||
      (placement == IN_SHARED && lpt != 1) ||
      (placement == IN_GLOBAL && workspace == nullptr) ||
      (long long)lane_threads * lpt < d.L || lane_threads % WARP != 0 ||
      lane_threads / WARP > MAX_WARPS || lane_threads + WARP > 1024 ||
      ep.blocks < 1 || (long long)B * ep.blocks > 0x7fffffffLL)
    return 1;  // cudaErrorInvalidValue
  const int blocks = B * ep.blocks;
  size_t ws_bytes = 0;
  const size_t smem = bytes_of<S>(d, placement, &ws_bytes);
  const int threads = lane_threads + WARP;
  if (placement == IN_SHARED) {
    if (B == 1)
      return start(itscp_hybrid_episode_kernel<S>, blocks, threads, smem,
                   stream, action, sched, mnext, mprev, rand, inj_routes,
                   emit_routes, prog, lane_i, lane_f, thread_lane,
                   out_reward, out_queues, out_events, q_weight, out_grad, d,
                   k, lane_threads);
    return start(itscp_hybrid_episode_kernel<S, Episodes>, blocks, threads,
                 smem, stream, action, sched, mnext, mprev, rand, inj_routes,
                 emit_routes, prog, lane_i, lane_f, thread_lane, out_reward,
                 out_queues, out_events, q_weight, out_grad, d, k,
                 lane_threads, ep);
  }
  const Workspace ws{static_cast<char*>(workspace), ws_bytes};
  if (lpt == 1)
    return start(itscp_hybrid_episode_wide<S, 1>, blocks, threads, smem,
                 stream, action, sched, mnext, mprev, rand, inj_routes,
                 emit_routes, prog, lane_i, lane_f, thread_lane, out_reward,
                 out_queues, out_events, q_weight, out_grad, d, k,
                 lane_threads, ep, ws);
  return start(itscp_hybrid_episode_wide<S, 2>, blocks, threads, smem, stream,
               action, sched, mnext, mprev, rand, inj_routes, emit_routes,
               prog, lane_i, lane_f, thread_lane, out_reward, out_queues,
               out_events, q_weight, out_grad, d, k, lane_threads, ep, ws);
}

}  // namespace

extern "C" {

// Dynamic shared memory of the forward (tangent = 0) or the backward
// (tangent = 1) for these sizes (bytes), the state in shared memory.
size_t itscp_hybrid_episode_smem(int L, int C, int V, int K, int tangent) {
  Dims d{};
  d.L = L; d.C = C; d.V = V; d.K = K;
  return tangent ? smem_bytes<Dual>(d, nullptr, nullptr)
                 : smem_bytes<float>(d, nullptr, nullptr);
}

// The same for a placement (0: shared memory, 1: the state in global
// memory), with the workspace's bytes a block in *ws_bytes (0 for shared).
size_t itscp_hybrid_episode_smem_at(int L, int C, int V, int K, int tangent,
                                    int placement, size_t* ws_bytes) {
  Dims d{};
  d.L = L; d.C = C; d.V = V; d.K = K;
  return tangent ? bytes_of<Dual>(d, placement, ws_bytes)
                 : bytes_of<float>(d, placement, ws_bytes);
}

// The placement (0: shared memory, 1: global memory, -1: none) that the
// card's kernels take for the forward (tangent = 0) or the backward
// (tangent = 1) at these sizes and `lpt` lanes a thread of `lane_threads`
// lane threads, from the kernels' attributes and the device's opt-in
// shared memory a block (the host build: no limit but 1,024 threads).
int itscp_hybrid_episode_placement(int L, int C, int V, int K, int tangent,
                                   int lane_threads, int lpt) {
  Dims d{};
  d.L = L; d.C = C; d.V = V; d.K = K;
  return tangent ? placement_for<Dual>(d, lane_threads, lpt)
                 : placement_for<float>(d, lane_threads, lpt);
}

// Blocks of the forward (tangent = 0) or the backward (tangent = 1) that
// one SM holds at once for these sizes and lane_threads, or -1 on an
// error (the host build: 0).
int itscp_hybrid_episode_blocks_per_sm(int L, int C, int V, int K,
                                       int tangent, int lane_threads) {
#ifdef DHTS_CPU_EMULATION
  (void)L; (void)C; (void)V; (void)K; (void)tangent; (void)lane_threads;
  return 0;
#else
  const size_t smem = itscp_hybrid_episode_smem(L, C, V, K, tangent);
  int n = -1;
  cudaError_t err;
  if (tangent) {
    auto kernel = itscp_hybrid_episode_kernel<Dual>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, lane_threads + WARP, smem);
  } else {
    auto kernel = itscp_hybrid_episode_kernel<float>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, lane_threads + WARP, smem);
  }
  return err == cudaSuccess ? n : -1;
#endif
}

// Forward: B episodes in gate mode `mode` (0 hard, 1 soft, 2
// straight-through) on `stream`, one block each: out_reward[B],
// out_queues[B, T], out_events[B, T, 8]. thread_lane[lpt, lane_threads]:
// the lanes each lane thread runs (-1: none; whole warps of one lane
// kind). s_* is each input's stride between episodes in elements (0:
// shared; s_qw unused here). After the stream: `lpt` lanes a thread (1 or
// 2), the placement (0: the state in shared memory, one lane a thread; 1:
// in `workspace`, B blocks of itscp_hybrid_episode_smem_at's bytes;
// arguments that a library from before them ignores). Returns
// cudaGetLastError() of the launch, or cudaErrorInvalidConfiguration (9)
// where the layout does not fit the device.
int launch_itscp_hybrid_episode_fwd(
    const float* action, const float* sched, const int* mnext,
    const int* mprev, const float* rand, const int* inj_routes,
    const int* emit_routes, const float* prog, const int* lane_i,
    const float* lane_f, const int* thread_lane, float* out_reward,
    float* out_queues, float* out_events, int B, long long s_action,
    long long s_sched, long long s_mnext, long long s_mprev, long long s_rand,
    long long s_inj, long long s_emit, long long s_qw, int T, int L, int C,
    int V, int R, int P, int P2, int K, int W, int nsf, int n_phases,
    int n_inter, int mode, int lane_threads, float u_max, float dt,
    float veh_len, float static_speed, float rare_den, float third,
    float amax, float apref, float tgt, float min_space, float time_pref,
    float rho_hi, float gate32, void* stream, int lpt, int placement,
    void* workspace) {
  Dims d{T, L, C, V, R, P, P2, K, W, nsf, n_phases, n_inter, mode};
  Consts k{u_max, dt, veh_len, static_speed, rare_den, third, amax,
           apref, tgt, min_space, time_pref, rho_hi, gate32};
  (void)s_qw;
  const Episodes ep{s_action, s_sched, s_mnext, s_mprev, s_rand, s_inj,
                    s_emit, 0, 1};
  return launch<float>(B, ep, action, sched, mnext, mprev, rand, inj_routes,
                       emit_routes, prog, lane_i, lane_f, thread_lane,
                       lane_threads, out_reward, out_queues, out_events,
                       nullptr, nullptr, d, k, stream, lpt, placement,
                       workspace);
}

// Backward of the soft (1) or straight-through (2) forward of B episodes:
// out_grad[B, n_phases * n_inter] = sum_t q_weight[e, t] *
// d(queue_{e,t})/d(action_e), one block per episode and action entry
// (episode-major); thread_lane, the strides, lpt, the placement and the
// workspace (B * n_phases * n_inter blocks) as the forward's, s_qw
// q_weight's. Returns cudaGetLastError() of the launch.
int launch_itscp_hybrid_episode_bwd(
    const float* action, const float* sched, const int* mnext,
    const int* mprev, const float* rand, const int* inj_routes,
    const int* emit_routes, const float* prog, const int* lane_i,
    const float* lane_f, const int* thread_lane, const float* q_weight,
    float* out_grad, int B, long long s_action, long long s_sched,
    long long s_mnext, long long s_mprev, long long s_rand, long long s_inj,
    long long s_emit, long long s_qw, int T, int L, int C, int V, int R,
    int P, int P2, int K, int W, int nsf, int n_phases, int n_inter,
    int mode, int lane_threads, float u_max, float dt, float veh_len,
    float static_speed, float rare_den, float third, float amax,
    float apref, float tgt, float min_space, float time_pref, float rho_hi,
    float gate32, void* stream, int lpt, int placement, void* workspace) {
  if (mode == HARD || n_phases < 1 || n_inter < 1) return 1;
  Dims d{T, L, C, V, R, P, P2, K, W, nsf, n_phases, n_inter, mode};
  Consts k{u_max, dt, veh_len, static_speed, rare_den, third, amax,
           apref, tgt, min_space, time_pref, rho_hi, gate32};
  const Episodes ep{s_action, s_sched, s_mnext, s_mprev, s_rand, s_inj,
                    s_emit, s_qw, n_phases * n_inter};
  return launch<Dual>(B, ep, action, sched, mnext, mprev, rand,
                      inj_routes, emit_routes, prog, lane_i, lane_f,
                      thread_lane, lane_threads, nullptr, nullptr, nullptr,
                      q_weight, out_grad, d, k, stream, lpt, placement,
                      workspace);
}

#ifdef DHTS_K1_CLOCK
// The cycle stamps of the last clocked launch, k1_cycles[K1_PHASES] (see
// K1Phase), into host memory `out`; `reset` zeroes them first instead.
// Returns the CUDA error code (0: success).
int itscp_hybrid_episode_clock(long long* out, int reset) {
#ifdef DHTS_CPU_EMULATION
  for (int i = 0; i < K1_PHASES; ++i) {
    if (reset) k1_cycles[i] = 0;
    out[i] = k1_cycles[i];
  }
  return 0;
#else
  if (reset) {
    const long long zero[K1_PHASES] = {};
    const cudaError_t err = cudaMemcpyToSymbol(k1_cycles, zero, sizeof(zero));
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaMemcpyFromSymbol(out, k1_cycles,
                                   sizeof(long long) * K1_PHASES);
#endif
}
#endif

}  // extern "C"
