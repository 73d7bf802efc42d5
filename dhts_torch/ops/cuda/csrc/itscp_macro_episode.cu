// Fused all-macro ITSCP episode for Hopper (sm_90a): the forward, its
// reverse-mode gradient with respect to the action and the initial state,
// and a forward-mode derivative that the tests hold the reverse one
// against.
//
// Replaces the TPU kernel K4,
// dhts/ops/pallas/itscp_episode.py::make_fused_itscp_macro_episode:
//   * forward (fwd_kernel :227, pallas_call :256; per-step `step` :148-224,
//     its loop :239-249): the whole episode of T steps of an all-macro
//     scene (every lane ARZ) with soft signal gates from the phase action,
//     signal-blended ghost cells, the Godunov update of every lane and the
//     RMS-sharpened soft queue reward; returns (qsum, queues[T]) and the
//     wrapper makes reward = -qsum; given a trajectory buffer it also
//     stores the JAX kernel's residuals (:231-254): the state before each
//     step and the step's detached sharpness;
//   * backward (bwd_kernel :279, pallas_call :307): the vector-Jacobian
//     product of (qsum, queues) with respect to the action [n_phases,
//     n_inter] and the initial state r0, y0 [L, C], by the JAX kernel's
//     reverse sweep over that trajectory (:270-300: the vjp of one step at
//     :293, accumulating the action's).
// Its specification is the plain PyTorch version beside its wrapper
// (dhts_torch/ops/cuda/itscp_macro_episode.py::plain_macro_episode): every
// value is computed with the same IEEE float32 operations in the same
// order (-fmad=false, no fast math), sums over lanes in float64 in lane
// order, rounded once, so the forward agrees with it bit for bit.
//
// The block. One block runs an episode on true sizes (K4 pads to [8,
// 128k] and does every cross-lane read as a one-hot matrix product). G
// threads run a lane: thread r solves the Riemann problems of interfaces
// r, r + G, ... and updates cells r, r + G, ... (G = C + 1 where the
// kernel's registers let the block hold it: one solve a thread); P = 32 /
// G lanes share a warp, so a lane's threads never straddle two warps and
// exchange their fluxes through shared memory behind a __syncwarp. Two
// reduction warps after the lane warps do the lane sums in lane order
// (itscp_step.cuh's static_partials and lane_queue, split: a lane's threads
// write their cells' terms, a warp adds each lane's in cell order and the
// lanes' in lane order): the mean warp folds the static running mean, the
// queue warp sums the queue. The signal gates of CH steps (2 n_inter a
// step, one per intersection and direction) and their right-ghost soft
// gates are one table, filled in one round; a lane reads its own and its
// upstream lane's from it. The state r, y [L, C] lives in shared memory.
// The operations are those of itscp_step.cuh's macro phases in soft mode
// (signal, edges, ghosts, godunov_lane, static_partials, lane_queue), so
// the forward gives the bits of one thread a lane running those phases.
//
// Forward step t, on named barriers: the lanes meet (BAR_LANES, lane warps
// only: every edge of the state before step t is published); each lane
// takes its ghosts, updates its cells, writes their static terms (BAR_TERMS:
// the lanes arrive, the mean warp waits), keeps the new cells and speeds
// and publishes the next step's edges; then it takes step t - 1's queue
// terms once the mean warp has released that step's sharpness (BAR_MEAN)
// and the queue warp the buffer (BAR_QUEUE_EMPTY), and hands them over
// (BAR_QUEUE_FULL). So the mean's fold of step t overlaps the lanes' step
// t + 1, and the queue's sum their step t + 2. Every named barrier is
// reached by a converged warp (__syncwarp first: bar.sync and bar.arrive
// are .aligned).
//
// Reverse sweep (one block, all three gradients, t = T - 1 down to 0):
// each step is recomputed from the saved state with the same float
// operations (so the same Riemann cases and clamps), and the cotangents of
// the state (gr, gy [L, C]) and of the action are pulled back through it.
// Each interface's Riemann partials come from one pass of the solver in
// DualN<4> (the same solver as the forward's: the value and four tangents,
// seeded on left r, y, u and right u; the right density only picks a case)
// and are transposed by the thread that solved it; every other partial
// (speeds, ghost states, the queue term) likewise from DualN<2>, so a tie
// splits as in the Dual derivative. A lane's ghost cotangents go to the
// lanes it read: each reader writes them into its own slots, and each
// publishing lane gathers the slots that name it, its G threads scanning
// G chunks of the lanes, in lane order within a chunk and the chunks in
// order (no float atomics: two launches give the same bits). The signals'
// cotangents reach action[phase, inter] through the first reduction
// warp's lane-order fold, double-buffered by step parity (the second has no
// part in the sweep). The running mean is
// detached, as in K4; cells beyond num_cell are never written and get
// exactly 0. Without a saved trajectory the same launch first runs the
// forward into one (the wrapper's scratch).
//
// The forward-mode derivative: the forward body in Dual (dhts_scalar.cuh),
// one block per seeded input entry (an action entry, or a valid cell of r0
// or y0), writing sum_t w[t] d(queue_t)/d(entry) (K4's ep_bwd, :284).
//
// Scenes. A launch takes up to 832 lanes (one thread a lane in the
// forward's 896 threads). Where a block's shared memory cannot hold the
// state (the forward beyond about 700 lanes at C = 4 and 480 at C = 7, the
// sweep beyond about 400 and 280), the float forward and the sweep keep it
// in global memory that the launcher allocates, so the backward takes every
// scene the forward takes; the forward-mode derivative stays in shared
// memory and refuses the larger scenes.
//
// Bound. The inputs and outputs are a few hundred KB (the trajectory 0.67
// MB at the macro preset, 2.8 MB at 3x3 macro), and the T steps' float32
// operations take under a microsecond at the card's peak: the kernel is
// latency-bound, a chain of T dependent steps in one block (131 of 132 SMs
// idle), each a Riemann solve deep, plus its barriers and the lane sums.

#include "itscp_step.cuh"

namespace {

// Cycle stamps (a build with -DDHTS_K4_CLOCK; python -m
// dhts_torch.ops.cuda.k4_clock), in block 0. The forward: lane 0's first
// thread adds its cycles to its parts (its share of a gate table and the
// trajectory's stores, the wait for the other lanes' edges, its ghosts,
// its Riemann solve, its cells' update with their static terms and the
// next edges, its wait for the last step's sharpness and queue buffer,
// its queue terms), the mean warp's first thread to its own (its wait for
// the static terms, the mean's fold) and the queue warp's (its wait for
// the queue terms, the queue's sum). A clock read right after a named
// barrier can issue before the barrier releases it, so a wait may show up
// in the next part. The reverse sweep: lane 0's first
// thread its loads (the saved cells, the gates, the edges), its wait for
// the edges, its ghosts and Riemann partials, its queue terms, its
// transposes (interfaces, cells, ghosts), its wait for the slots, its
// gather and edge partials, its wait for the action fold's buffer; the
// reduction warp's first thread the fold and its wait. K4_STEPS and
// K4_R_STEPS count the steps stamped. Without the macro the stamps compile
// to nothing.
enum K4Part {
  K4_SIGNALS, K4_WAIT_EDGES, K4_GHOSTS, K4_GODUNOV, K4_STATIC,
  K4_WAIT_UPDATE, K4_MEAN_FOLD, K4_WAIT_MEAN, K4_QUEUE, K4_WAIT_QUEUE,
  K4_QUEUE_SUM, K4_STEPS, K4_R_LOAD, K4_R_WAIT_EDGES, K4_R_RIEMANN,
  K4_R_TERMS, K4_R_TRANSPOSE, K4_R_WAIT_SLOTS, K4_R_GATHER, K4_R_WAIT_EMPTY,
  K4_R_FOLD, K4_R_WAIT_FULL, K4_R_STEPS, K4_PARTS
};
#ifdef DHTS_K4_CLOCK
__device__ long long k4_cycles[K4_PARTS];
// the SM's clock, read by a volatile asm with a memory clobber: the
// compiler keeps it in order with the barriers
__device__ __forceinline__ long long k4_now() {
#ifdef DHTS_CPU_EMULATION
  return clock64();
#else
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
#endif
}
#define K4_CLOCK(...) __VA_ARGS__
// the cycles since `t` into `part`, and `t` moved to now, where `who`
#define K4_ADD(who, part, t)                  \
  do {                                        \
    if (who) {                                \
      const long long k4_t = k4_now();        \
      k4_cycles[part] += k4_t - (t);          \
      (t) = k4_t;                             \
    }                                         \
  } while (0)
#else
#define K4_CLOCK(...)
#define K4_ADD(who, part, t) (void)0
#endif

constexpr int WARP = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
constexpr int RED_WARPS = 2;  // reduction warps after the lane warps
// named barriers (0 is __syncthreads): the lane warps' own; the forward's
// static terms and running mean; its queue terms by step parity, full and
// empty; the sweep's action terms by step parity, full and empty
constexpr int BAR_LANES = 1, BAR_TERMS = 2, BAR_MEAN = 3;
constexpr int BAR_QUEUE_FULL = 4, BAR_QUEUE_EMPTY = 6;
constexpr int BAR_GA_FULL = 8, BAR_GA_EMPTY = 10;

// PTX named barriers (the host build has its own, cpu_emulation.h): wait
// at, or only arrive at, barrier `id`, which completes when `count` threads
// have reached it. A warp must reach one converged (bar.sync and bar.arrive
// are .aligned), hence the __syncwarp() before each.
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

// ---------------------------------------------------------------------------
// dual numbers with N tangents, for a function's partials in one pass
// ---------------------------------------------------------------------------

// Each operation computes its value with the float operation of the
// forward (so a pass follows the forward's Riemann cases and clamps) and
// its tangents by Dual's rules (dhts_scalar.cuh: a tie of a max or min
// splits 0.5 / 0.5, a root of a zero tangent has a zero tangent), a
// tangent's division by a value as a product with its reciprocal.
template <int N>
struct DualN {
  float v, d[N];
  __device__ DualN() {}
  __device__ DualN(float v_) : v(v_) {
#pragma unroll
    for (int k = 0; k < N; ++k) d[k] = 0.0f;
  }
  // the value x with tangent 1 in direction k
  __device__ static DualN seed(float x, int k) {
    DualN o(x);
    o.d[k] = 1.0f;
    return o;
  }
};
using D2 = DualN<2>;
using D4 = DualN<4>;

template <int N>
__device__ __forceinline__ float val(const DualN<N>& x) {
  return x.v;
}
template <int N>
__device__ __forceinline__ DualN<N> operator+(DualN<N> a, DualN<N> b) {
  DualN<N> o;
  o.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = a.d[k] + b.d[k];
  return o;
}
template <int N>
__device__ __forceinline__ DualN<N> operator-(DualN<N> a, DualN<N> b) {
  DualN<N> o;
  o.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = a.d[k] - b.d[k];
  return o;
}
template <int N>
__device__ __forceinline__ DualN<N> operator-(DualN<N> a) {
  DualN<N> o;
  o.v = -a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = -a.d[k];
  return o;
}
template <int N>
__device__ __forceinline__ DualN<N> operator*(DualN<N> a, DualN<N> b) {
  DualN<N> o;
  o.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return o;
}
template <int N>
__device__ __forceinline__ DualN<N> operator/(DualN<N> a, DualN<N> b) {
  DualN<N> o;
  o.v = a.v / b.v;
  const float inv = 1.0f / b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = (a.d[k] - o.v * b.d[k]) * inv;
  return o;
}
template <int N>
__device__ __forceinline__ DualN<N> vmax(DualN<N> a, DualN<N> b) {
  DualN<N> o;
  o.v = max_of(a.v, b.v);
#pragma unroll
  for (int k = 0; k < N; ++k)
    o.d[k] = a.v > b.v ? a.d[k]
                       : (a.v < b.v ? b.d[k] : 0.5f * (a.d[k] + b.d[k]));
  return o;
}
template <int N>
__device__ __forceinline__ DualN<N> vmin(DualN<N> a, DualN<N> b) {
  DualN<N> o;
  o.v = min_of(a.v, b.v);
#pragma unroll
  for (int k = 0; k < N; ++k)
    o.d[k] = a.v < b.v ? a.d[k]
                       : (a.v > b.v ? b.d[k] : 0.5f * (a.d[k] + b.d[k]));
  return o;
}
// the root, reciprocal root and quotient of a clamp's result (as Dual's,
// with DHTS_KEEP_NAN: of `clean`, the NaN put back)
template <int N>
__device__ __forceinline__ DualN<N> vsqrt_of(DualN<N> a, float clean) {
  const float r = sqrtf(clean);
  const float h = 1.0f / (2.0f * r);
  DualN<N> o;
  o.v = with_nan(a.v, r);
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = a.d[k] == 0.0f ? 0.0f : a.d[k] * h;
  return o;
}
template <int N>
__device__ __forceinline__ DualN<N> vrsqrt_of(DualN<N> a, float clean) {
  const float r = sqrtf(clean);
  const float h = 1.0f / (2.0f * r);
  const float q = 1.0f / r;
  DualN<N> o;
  o.v = with_nan(a.v, q);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float rd = a.d[k] == 0.0f ? 0.0f : a.d[k] * h;
    o.d[k] = (0.0f - q * rd) * q;
  }
  return o;
}
template <int N>
__device__ __forceinline__ DualN<N> vdiv_by(DualN<N> y, DualN<N> b,
                                            float clean) {
  const float q = y.v / clean;
  const float inv = 1.0f / clean;
  DualN<N> o;
  o.v = with_nan(b.v, q);
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = (y.d[k] - q * b.d[k]) * inv;
  return o;
}
template <int N>
__device__ __forceinline__ DualN<N> vsigmoid(DualN<N> z) {
  const float y = vsigmoid(z.v);
  DualN<N> o;
  o.v = y;
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = z.d[k] * (y * (1.0f - y));
  return o;
}

// ---------------------------------------------------------------------------
// the block
// ---------------------------------------------------------------------------

// How a launch lays out its block: G threads a lane, P = 32 / G lanes a
// warp, NL threads of lane warps (whole warps), and two reduction warps
// after them (the forward's mean and queue; the sweep's action fold and
// one that waits).
struct Geo {
  int G, P, NL;
};
__host__ __device__ inline Geo geo_of(int L, int G) {
  Geo g;
  g.G = G;
  g.P = WARP / G;
  g.NL = ((L + g.P - 1) / g.P) * WARP;
  return g;
}

// This thread's lane l and its place r in the lane's group; `lane` false
// for the lane warps' spare threads and the reduction warp.
struct Me {
  int l, r;
  bool lane;
};
__device__ __forceinline__ Me me_of(const Geo& geo, int L) {
  const int tid = threadIdx.x, wl = tid % WARP;
  Me m;
  m.l = (tid / WARP) * geo.P + wl / geo.G;
  m.r = wl % geo.G;
  m.lane = tid < geo.NL && wl < geo.P * geo.G && m.l < L;
  if (!m.lane) m.l = 0;
  return m;
}

struct Args {
  const float *action, *sched, *r0, *y0, *prog, *lane_f, *q_weight;
  const int *mnext, *mprev, *lane_i, *cells;
  float *out_reward, *out_queues, *out_grad;
  // [T, 2, L, C] the state before each step (r, then y) and [T] each
  // step's sharpness: written by a saving forward, read by the sweep
  float *traj, *sharp;
  int n_a, n_r, n_y;  // the forward-mode derivative's seeds
  Dims d;
  Consts k;
};

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

// ((0 + x_0) + x_1) + ... in index order, the loads 8 terms ahead of the
// adds
__device__ __forceinline__ double chain(const double* x, int n) {
  double s = 0.0;
  int j = 0;
  for (; j + 8 <= n; j += 8) {
    double v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = x[j + i];
#pragma unroll
    for (int i = 0; i < 8; ++i) s += v[i];
  }
  for (; j < n; ++j) s += x[j];
  return s;
}

// the gate of intersection q / 2 in direction q % 2 (1: west-east) at step
// t: soft(a - progress) or soft(progress - a) (itscp_step.cuh's
// lane_signal in soft mode)
template <class S>
__device__ __forceinline__ S gate_at(S a, float progress, int q,
                                     float gate32) {
  return soft((q & 1) ? a - S(progress) : S(progress) - a, gate32);
}

// the ghost cells of lane l (itscp_step.cuh's ghosts in soft mode; every
// lane of K4 is macro): `edge` [4][L] holds every lane's first cell and
// speed, and its last cell and speed; sig_p is the routed predecessor's
// signal and sg the lane's own soft gate soft(sig_l - 0.5, gate32)
template <class S>
__device__ __forceinline__ Ghosts<S> lane_ghosts(const S* edge, int L,
                                                 const LaneGeom& g, int mp,
                                                 int mn, float incoming,
                                                 S sig_p, S sg,
                                                 const Consts& k) {
  auto clampL = [&](int j) { return min(max(j, 0), L - 1); };
  const float u_max = k.u_max;
  const int adjp = g.num_prev == 1 ? g.prev0 : mp;
  const int adjp_c = clampL(adjp);
  const bool use_l = (g.num_prev > 0) && (adjp >= 0);
  S gl_r = use_l ? edge[2 * L + adjp_c] : S(0.0f);
  S gl_u = use_l ? edge[3 * L + adjp_c] : S(u_max);
  if (!g.has_prev) { gl_r = incoming; gl_u = u_eq(S(incoming), u_max); }
  const S prev_sig = !g.has_prev ? S(1.0f) : (mp < 0 ? S(0.0f) : sig_p);
  Ghosts<S> o;
  o.bl_r = gl_r * prev_sig;
  o.bl_u = gl_u * prev_sig + S(u_max) * (S(1.0f) - prev_sig);
  const int adjn = g.num_next == 1 ? g.next0 : mn;
  const int adjn_c = clampL(adjn);
  const bool use_r = (g.num_next > 0) && (adjn >= 0);
  const S gr_r = use_r ? edge[adjn_c] : S(0.0f);
  const S gr_u = use_r ? edge[L + adjn_c] : S(u_max);
  o.br_r = gr_r * sg + S(1.0f) * (S(1.0f) - sg);
  o.br_u = gr_u * sg;
  return o;
}

// cell q of lane l for its interfaces: the state, or the right ghost
// beyond the lane's cells
template <class S>
__device__ __forceinline__ void cell_of(const S* r, const S* y, int l,
                                        int C, int nc, int q, S br_r,
                                        S right_y, S& rq, S& yq) {
  const bool in = q >= 0 && q < C && q < nc;
  rq = in ? r[l * C + q] : br_r;
  yq = in ? y[l * C + q] : right_y;
}

// ---------------------------------------------------------------------------
// the forward (float; Dual for the forward-mode derivative)
// ---------------------------------------------------------------------------

// steps of a gate table: the gates of CH steps are filled in one round,
// into one of two buffers by chunk parity (a lane may still read the last
// chunk's while another fills the next)
constexpr int CH = 16;

template <class S>
struct FwdSmem {
  S *r, *y;     // [L C] the state
  S *fr, *fy;   // [L (C + 1)] the interfaces' fluxes
  S* edge;      // [2][4 L] by step parity: first cell, its speed, last
                // cell, its speed
  S *gate, *sg;  // [2][CH][2 n_inter] by chunk parity: the gates, and the
                 // right ghost's soft gate of each; sg[2 CH 2 n_inter]:
                 // that of a lane without a signal
  S *qr, *qu;    // [2][L C] by step parity: the new cells and their speeds,
                 // for the queue terms a step later
  S* q_term;     // [2][L C] the cells' queue terms
  double* st_term;  // [2][L C] the cells' static terms
  double *stage_m, *stage_q;  // [L], [2 L] the warps' lane terms
  int *gidx, *ncell;          // [L] the lane's gate (-1: none), its cells
  float* sharp;               // [2] the steps' sharpness, for the lanes
};

template <class S>
__host__ __device__ inline size_t fwd_smem(int L, int C, int n_inter,
                                           FwdSmem<S>* s, char* base) {
  size_t off = 0;
  FwdSmem<S> dummy;
  FwdSmem<S>* t = s ? s : &dummy;
  char* b = s ? base : nullptr;
  const size_t LC = (size_t)L * C, LI = (size_t)L * (C + 1);
  const size_t NG = 2 * (size_t)CH * 2 * n_inter;
  carve(&t->r, LC, b, off); carve(&t->y, LC, b, off);
  carve(&t->fr, LI, b, off); carve(&t->fy, LI, b, off);
  carve(&t->edge, 8 * (size_t)L, b, off);
  carve(&t->gate, NG, b, off); carve(&t->sg, NG + 1, b, off);
  carve(&t->qr, 2 * LC, b, off); carve(&t->qu, 2 * LC, b, off);
  carve(&t->q_term, 2 * LC, b, off);
  carve(&t->st_term, 2 * LC, b, off);
  carve(&t->stage_m, L, b, off); carve(&t->stage_q, 2 * (size_t)L, b, off);
  carve(&t->gidx, L, b, off); carve(&t->ncell, L, b, off);
  carve(&t->sharp, 2, b, off);
  return off;
}

// The lanes' part of an episode. Step t: fill the next CH steps' gates
// (every CH steps) and store the trajectory's row; meet (BAR_LANES: every
// lane's edges of the state before step t are published); take the ghosts,
// solve the group's interfaces, update the group's cells; write their
// static terms (BAR_TERMS), keep the new cells and speeds for the queue and
// publish the new edges; then the queue terms of step t - 1 (after its
// sharpness, BAR_MEAN, and its buffer's last sum, BAR_QUEUE_EMPTY; then
// BAR_QUEUE_FULL), so that the running mean's fold overlaps a step.
template <class S>
__device__ __forceinline__ void forward_lanes(const Args& a, const Geo& geo,
                                              FwdSmem<S>& s, const Me& m,
                                              const LaneGeom& g,
                                              int a_seed) {
  const Dims& d = a.d;
  const Consts& k = a.k;
  const int L = d.L, C = d.C, G = geo.G, NB = geo.NL + WARP;
  const int LC = L * C, NG = 2 * d.n_inter;
  const int l = m.l, r = m.r, nc = g.num_cell;
  const int last = min(max(nc - 1, 0), C - 1);
  const float u_max = k.u_max;
  const float coeff = k.dt / g.cell_len;
  auto clampL = [&](int j) { return min(max(j, 0), L - 1); };
  K4_CLOCK(const bool clk = threadIdx.x == 0 && blockIdx.x == 0;
           long long k4_p = k4_now();)
  // the queue terms of step tq (itscp_step.cuh's lane_queue, :218-222)
  auto queue_terms = [&](int tq) {
    const int p = tq & 1;
    CONVERGE();
    bar_sync(BAR_MEAN, NB);
    if (tq >= 2) {  // the queue warp has summed step tq - 2's
      CONVERGE();
      bar_sync(BAR_QUEUE_EMPTY + p, NB);
    }
    K4_ADD(clk, K4_WAIT_MEAN, k4_p);
    if (m.lane) {
      const float c_st = s.sharp[p];
      for (int c = r; c < C && c < nc; c += G) {
        const int i = p * LC + l * C + c;
        const S stat = soft(S(k.static_speed) - s.qu[i], c_st);
        s.q_term[i] = stat * ((s.qr[i] * S(g.cell_len)) / S(k.veh_len));
      }
    }
    K4_ADD(clk, K4_QUEUE, k4_p);
    CONVERGE();
    bar_arrive(BAR_QUEUE_FULL + p, NB);
  };
  for (int t = 0; t < d.T; ++t) {
    const int tl = t * L + l, par = t & 1;
    // ---- the gates of steps t .. t + CH - 1 (K4 :150-160), the
    // trajectory's row
    const int tc = t % CH, gb = ((t / CH) & 1) * CH * NG;
    if (tc == 0) {
      for (int q = threadIdx.x; q < CH * NG; q += geo.NL) {
        const int tt = t + q / NG, qq = q % NG;
        if (tt >= d.T) break;
        const int phase = min(tt / d.nsf, d.n_phases - 1);
        const int ai = phase * d.n_inter + (qq >> 1);
        const S gv = gate_at<S>(action_at<S>(a.action[ai], ai == a_seed),
                                a.prog[tt % d.nsf], qq, k.gate32);
        s.gate[gb + q] = gv;
        s.sg[gb + q] = soft(gv - S(0.5f), k.gate32);
      }
    }
    if (m.lane && a.traj) {
      float* tr = a.traj + (size_t)2 * t * L * C + (size_t)l * C;
      for (int c = r; c < C; c += G) {
        tr[c] = val(s.r[l * C + c]);
        tr[(size_t)L * C + c] = val(s.y[l * C + c]);
      }
    }
    K4_ADD(clk, K4_SIGNALS, k4_p);
    CONVERGE();
    bar_sync(BAR_LANES, geo.NL);
    K4_ADD(clk, K4_WAIT_EDGES, k4_p);

    // ---- ghosts and the Godunov update (:162-210): thread r solves
    // interfaces r, r + G, ... and updates cells r, r + G, ...
    if (m.lane) {
      const int mp = a.mprev[tl], mn = a.mnext[tl];
      const float incoming = g.has_prev ? -1.0f : a.sched[tl];
      const S* gt = s.gate + gb + tc * NG;
      const int qp = s.gidx[clampL(mp)], ql = s.gidx[l];
      const Ghosts<S> gh = lane_ghosts<S>(
          s.edge + par * 4 * L, L, g, mp, mn, incoming,
          qp < 0 ? S(1.0f) : gt[qp],
          ql < 0 ? s.sg[2 * CH * NG] : s.sg[gb + tc * NG + ql], k);
      K4_ADD(clk, K4_GHOSTS, k4_p);
      const S right_y = comp_y(gh.br_r, gh.br_u, u_max);
      const S left_y = comp_y(gh.bl_r, gh.bl_u, u_max);
      for (int i = r; i <= C; i += G) {
        S rl, yl, rc, yc;
        cell_of(s.r, s.y, l, C, nc, i - 1, gh.br_r, right_y, rl, yl);
        cell_of(s.r, s.y, l, C, nc, i, gh.br_r, right_y, rc, yc);
        const S ul = comp_u(rl, yl, u_max), ur = comp_u(rc, yc, u_max);
        const bool first = i == 0, end = i == C;
        S fr, fy;
        float wave;
        riemann(first ? gh.bl_r : rl, first ? left_y : yl,
                first ? gh.bl_u : ul, end ? gh.br_r : rc, end ? gh.br_u : ur,
                u_max, k.rare_den, k.third, fr, fy, wave);
        s.fr[l * (C + 1) + i] = fr;
        s.fy[l * (C + 1) + i] = fy;
      }
    }
    __syncwarp();  // the group's fluxes, and every read of its cells
    K4_ADD(clk, K4_GODUNOV, k4_p);
    if (m.lane) {
      S* ed = s.edge + (par ^ 1) * 4 * L;
      for (int c = r; c < C && c < nc; c += G) {
        const int i = l * C + c, f = l * (C + 1) + c;
        const S rn = s.r[i] + (s.fr[f] - s.fr[f + 1]) * S(coeff);
        const S yn = s.y[i] + (s.fy[f] - s.fy[f + 1]) * S(coeff);
        s.r[i] = rn;
        s.y[i] = yn;
        // the static running mean's term (:212-217), the queue's cell and
        // speed, the next step's edges
        const S u = comp_u(rn, yn, u_max);
        s.st_term[par * LC + i] = (double)(k.static_speed - val(u));
        s.qr[par * LC + i] = rn;
        s.qu[par * LC + i] = u;
        if (c == 0) { ed[l] = rn; ed[L + l] = u; }
        if (c == last) { ed[2 * L + l] = rn; ed[3 * L + l] = u; }
      }
    }
    CONVERGE();
    bar_arrive(BAR_TERMS, NB);
    K4_ADD(clk, K4_STATIC, k4_p);
    if (t >= 1) queue_terms(t - 1);
    K4_CLOCK(if (clk) k4_cycles[K4_STEPS] += 1;)
  }
  if (d.T >= 1) queue_terms(d.T - 1);
}

// The running mean's warp: each step, the fold of the static terms (each
// lane's in cell order, the lanes in lane order, float64) and its
// sharpness for the lanes.
template <class S>
__device__ __forceinline__ void mean_warp(const Args& a, const Geo& geo,
                                          FwdSmem<S>& s) {
  const Dims& d = a.d;
  const int L = d.L, C = d.C, NB = geo.NL + WARP;
  const int wl = threadIdx.x % WARP;
  float ms_sum = 0.0f, ms_cnt = 0.0f;
  K4_CLOCK(const bool clk = wl == 0 && blockIdx.x == 0;
           long long k4_p = k4_now();)
  for (int t = 0; t < d.T; ++t) {
    const double* terms = s.st_term + (t & 1) * L * C;
    CONVERGE();
    bar_sync(BAR_TERMS, NB);
    K4_ADD(clk, K4_WAIT_UPDATE, k4_p);
    int cnt = 0;
    for (int j = wl; j < L; j += WARP) {
      const int n = s.ncell[j];
      double sj = 0.0;
      for (int c = 0; c < n; ++c) sj += terms[j * C + c];
      s.stage_m[j] = sj;
      cnt += n;
    }
    for (int o = WARP / 2; o > 0; o >>= 1)
      cnt += __shfl_down_sync(FULL_MASK, cnt, o);
    __syncwarp();  // the staged terms, for lane 0's chain
    if (wl == 0) {
      ms_sum = ms_sum + (float)chain(s.stage_m, L);
      ms_cnt = ms_cnt + (float)cnt;
      const float c_st = sharpness(16.0f, ms_sum / ms_cnt);
      s.sharp[t & 1] = c_st;
      if (a.sharp) a.sharp[t] = c_st;
    }
    K4_ADD(clk, K4_MEAN_FOLD, k4_p);
    CONVERGE();
    bar_arrive(BAR_MEAN, NB);
  }
}

// The queue's warp: each step, sum_l (q_l)^2 with q_l the lane's queue
// terms in cell order in S, the lanes in lane order in float64 rounded
// once, times dt; the queues, their sum (the reward) and, in Dual, the
// derivative sum_t w[t] d queue_t.
template <class S>
__device__ __forceinline__ void queue_warp(const Args& a, const Geo& geo,
                                           FwdSmem<S>& s, int out_at) {
  const Dims& d = a.d;
  const int L = d.L, C = d.C, NB = geo.NL + WARP;
  const int wl = threadIdx.x % WARP;
  float qsum = 0.0f;
  double grad = 0.0;
  K4_CLOCK(const bool clk = wl == 0 && blockIdx.x == 0;
           long long k4_p = k4_now();)
  for (int t = 0; t < d.T; ++t) {
    const int p = t & 1;
    const S* terms = s.q_term + p * L * C;
    CONVERGE();
    bar_sync(BAR_QUEUE_FULL + p, NB);
    K4_ADD(clk, K4_WAIT_QUEUE, k4_p);
    for (int j = wl; j < L; j += WARP) {
      const int n = s.ncell[j];
      S q = 0.0f;
      for (int c = 0; c < n; ++c) q = q + terms[j * C + c];
      const S q2 = q * q;
      s.stage_q[j] = (double)val(q2);
      s.stage_q[L + j] = (double)tangent(q2);
    }
    __syncwarp();
    if (wl == 0) {
      const double qv = chain(s.stage_q, L);
      const double qd = sizeof(S) == sizeof(float)
                            ? 0.0 : chain(s.stage_q + L, L);
      const S queue = rounded<S>(qv, qd) * S(a.k.dt);
      qsum += val(queue);
      if (a.q_weight) grad += (double)a.q_weight[t] * (double)tangent(queue);
      if (a.out_queues) a.out_queues[t] = val(queue);
    }
    K4_ADD(clk, K4_QUEUE_SUM, k4_p);
    if (t + 2 < d.T) {  // the lanes write this buffer again for t + 2
      CONVERGE();
      bar_arrive(BAR_QUEUE_EMPTY + p, NB);
    }
  }
  if (wl == 0) {
    if (a.out_reward) a.out_reward[0] = -qsum;
    if (a.out_grad && out_at >= 0) a.out_grad[out_at] = (float)grad;
  }
}

template <class S>
__device__ __forceinline__ void forward_body(const Args& a, const Geo& geo,
                                             char* smem, int a_seed,
                                             int r_seed, int y_seed,
                                             int out_at) {
  FwdSmem<S> s;
  fwd_smem<S>(a.d.L, a.d.C, a.d.n_inter, &s, smem);
  const int L = a.d.L, C = a.d.C, G = geo.G;
  const Me m = me_of(geo, L);
  const Scene sc{a.lane_i, a.lane_f, nullptr, nullptr};
  const LaneGeom g = m.lane ? lane_geom(sc, L, a.d.K, m.l) : LaneGeom();
  if (m.lane) {
    for (int c = m.r; c < C; c += G) {
      const int i = m.l * C + c;
      s.r[i] = seeded<S>(a.r0[i], i == r_seed);
      s.y[i] = seeded<S>(a.y0[i], i == y_seed);
    }
    if (m.r == 0) {
      s.gidx[m.l] = g.approaching ? 2 * g.inter + (g.is_we ? 1 : 0) : -1;
      s.ncell[m.l] = g.num_cell;
    }
  }
  if (threadIdx.x == 0)
    s.sg[2 * CH * 2 * a.d.n_inter] = soft(S(1.0f) - S(0.5f), a.k.gate32);
  __syncthreads();
  if (m.lane) {  // the initial state's edges, in both buffers (the state
                 // of a lane without cells never changes)
    const int last = min(max(g.num_cell - 1, 0), C - 1);
    const S rf = s.r[m.l * C], rl = s.r[m.l * C + last];
    const S uf = comp_u(rf, s.y[m.l * C], a.k.u_max);
    const S ul = comp_u(rl, s.y[m.l * C + last], a.k.u_max);
    for (int b = 0; b < 2 && m.r == 0; ++b) {
      S* ed = s.edge + b * 4 * L;
      ed[m.l] = rf; ed[L + m.l] = uf;
      ed[2 * L + m.l] = rl; ed[3 * L + m.l] = ul;
    }
  }
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid >= geo.NL + WARP)
    queue_warp<S>(a, geo, s, out_at);
  else if (tid >= geo.NL)
    mean_warp<S>(a, geo, s);
  else
    forward_lanes<S>(a, geo, s, m, g, a_seed);
}

// The largest block each kernel is compiled for, which bounds its
// registers: the forward's 72 let the 3x3 preset's 832 threads (5 a lane)
// run as one block, and at one thread a lane 832 lanes; the derivative's
// 96 let 640 (3 a lane there; 576 lanes). The sweep comes in two: the
// narrow one keeps the registers it wants (about 160: 384 threads, 2 a
// lane at the 3x3 preset, 320 lanes at most); the wide one is held to the
// forward's block, spilling, for the scenes the narrow one cannot take.
// The float forward and the wide sweep keep their state in global memory
// where a block's shared memory cannot hold it (the forward in a second
// instantiation, so that the first keeps its shared-memory addressing).
// So both take every scene of up to 832 lanes.
template <class S>
struct MaxThreads {
  static constexpr int value = 896;
};
template <>
struct MaxThreads<Dual> {
  static constexpr int value = 640;
};
constexpr int REV_NARROW = 384, REV_WIDE = MaxThreads<float>::value;

// One episode per block. S = float: the forward (outputs -qsum and
// queues, and the trajectory if a.traj). S = Dual: the forward-mode
// derivative; block b seeds action entry b (b < n_a), the r0 cell
// cells[b - n_a] (next n_r), or the y0 cell cells[b - n_a - n_r], and
// writes out_grad at that entry: [0, NA) the action, [NA, NA + LC) r0,
// [NA + LC, NA + 2 LC) y0. GLOBAL (one block): the state in `scratch`
// (global memory), not in shared memory.
template <class S, bool GLOBAL>
__global__ void
#ifndef DHTS_CPU_EMULATION
__launch_bounds__(MaxThreads<S>::value)
#endif
itscp_macro_episode_kernel(Args a, Geo geo, char* scratch) {
  DHTS_DYNAMIC_SMEM(smem_raw);
  char* const base = GLOBAL ? scratch : smem_raw;
  int a_seed = -1, r_seed = -1, y_seed = -1, out_at = -1;
  if (sizeof(S) != sizeof(float)) {
    const int b = blockIdx.x;
    const int NA = a.d.n_phases * a.d.n_inter, LC = a.d.L * a.d.C;
    if (b < a.n_a) {
      a_seed = b;
      out_at = b;
    } else if (b < a.n_a + a.n_r) {
      r_seed = a.cells[b - a.n_a];
      out_at = NA + r_seed;
    } else {
      y_seed = a.cells[b - a.n_a - a.n_r];
      out_at = NA + LC + y_seed;
    }
  }
  forward_body<S>(a, geo, base, a_seed, r_seed, y_seed, out_at);
}

// ---------------------------------------------------------------------------
// the reverse sweep
// ---------------------------------------------------------------------------

struct RevSmem {
  float *r, *y;    // [L C] the saved state of the step
  float *gr, *gy;  // [L C] the state's cotangents
  float *fr, *fy;  // [L (C + 1)] the interfaces' fluxes
  float* jac;      // [L (C + 1) 8] d(fr, fy) / d(left r, y, u; right u)
  float *tr, *ty;  // [L C] the queue term's partials in the new r, y
  float* qt;       // [L C] the queue terms
  float* il;       // [3 L (C + 1)] an interface's left inputs' cotangents
  float* ir;       // [L (C + 1)] its right speed's cotangent
  float* edge;     // [4 L] first cell, its speed, last cell, its speed
  float *gate, *dgate, *sgv, *dsg;  // [2][CH][2 n_inter] by chunk parity:
                                    // the gates, their derivatives, the
                                    // right ghost's soft gates and theirs
  float* slot;     // [5 L] what a lane hands back: the last edge's r and
                   // u, the first edge's r and u, the upstream signal
  float* gsig;     // [L] the lane's own signal's cotangent
  float* part;     // [5 L G] the group threads' partial sums
  float* ga;       // [2 L] the lanes' action terms by step parity
  int* tgt;        // [2][L] by step parity: the lanes whose last edge,
                   // first edge and signal the lane read, each plus 1 (0:
                   // none) in 10 bits
  int* gidx;       // [L]
  int* members;    // [n_inter + 1 + L] each intersection's gated lanes in
                   // lane order: offsets, then the lanes
  double* acc;        // [n_phases n_inter] the action's gradient
};

__host__ __device__ inline size_t rev_smem(const Dims& d, int G, RevSmem* s,
                                           char* base) {
  size_t off = 0;
  RevSmem dummy;
  RevSmem* t = s ? s : &dummy;
  char* b = s ? base : nullptr;
  const size_t L = d.L, LC = L * d.C, LI = L * (d.C + 1);
  carve(&t->r, LC, b, off); carve(&t->y, LC, b, off);
  carve(&t->gr, LC, b, off); carve(&t->gy, LC, b, off);
  carve(&t->fr, LI, b, off); carve(&t->fy, LI, b, off);
  carve(&t->jac, 8 * LI, b, off);
  carve(&t->tr, LC, b, off); carve(&t->ty, LC, b, off);
  carve(&t->qt, LC, b, off);
  carve(&t->il, 3 * LI, b, off); carve(&t->ir, LI, b, off);
  const size_t NG = 2 * (size_t)CH * 2 * d.n_inter;
  carve(&t->edge, 4 * L, b, off);
  carve(&t->gate, NG, b, off); carve(&t->dgate, NG, b, off);
  carve(&t->sgv, NG, b, off); carve(&t->dsg, NG, b, off);
  carve(&t->slot, 5 * L, b, off); carve(&t->gsig, L, b, off);
  carve(&t->part, 5 * L * G, b, off); carve(&t->ga, 2 * L, b, off);
  carve(&t->tgt, 2 * L, b, off);
  carve(&t->gidx, L, b, off);
  carve(&t->members, (size_t)d.n_inter + 1 + L, b, off);
  carve(&t->acc, (size_t)d.n_phases * d.n_inter, b, off);
  return off;
}

// The lanes' part of the sweep. At step t: (1) each lane loads its saved
// cells, the block fills the step's gates (values and derivatives), the
// lanes publish their edges and the lanes they read; (2) each lane
// recomputes its ghosts and fluxes (the Riemann partials in one DualN<4>
// pass an interface), its new cells and queue terms, and pulls the
// cotangents back: the queue's into the new cells, the cells' into the
// fluxes, the fluxes' into the interfaces' inputs, those into the cells
// before the step and the ghosts, the ghosts' into its slots; (3) each
// lane gathers the slots that name it into its edges and its signal, and
// its signal's cotangent times the gate's derivative goes to the warp.
__device__ __forceinline__ void reverse_lanes(const Args& a, const Geo& geo,
                                              RevSmem& s, const Me& m,
                                              const LaneGeom& g) {
  const Dims& d = a.d;
  const Consts& k = a.k;
  const int L = d.L, C = d.C, G = geo.G, NB = geo.NL + WARP;
  const int CI = C + 1, LC = L * C, LI = L * CI, NG = 2 * d.n_inter;
  // the right ghost's soft gate of a lane without a signal (sig 1)
  const Dual sg1 = soft(Dual(1.0f, 1.0f) - Dual(0.5f), k.gate32);
  const int l = m.l, r = m.r, nc = g.num_cell;
  const int last = min(max(nc - 1, 0), C - 1);
  const float u_max = k.u_max;
  const float coeff = k.dt / g.cell_len;
  auto clampL = [&](int j) { return min(max(j, 0), L - 1); };
  K4_CLOCK(const bool clk = threadIdx.x == 0 && blockIdx.x == 0;
           long long k4_p = k4_now();)
  for (int t = d.T - 1; t >= 0; --t) {
    const int par = t & 1, tl = t * L + l;
    int* tgt = s.tgt + par * L;  // read in (3) while a lane ahead writes
                                 // the next step's
    const int mp = m.lane ? a.mprev[tl] : -1;
    const int mn = m.lane ? a.mnext[tl] : -1;
    // ---- (1) the gates (at the top of a chunk of CH steps: the chunk's),
    // the saved cells, the edges and the targets
    const int tc = t % CH, gb = ((t / CH) & 1) * CH * NG;
    if (tc == CH - 1 || t == d.T - 1) {
      for (int q = threadIdx.x; q < (tc + 1) * NG; q += geo.NL) {
        const int tt = t - tc + q / NG, qq = q % NG;
        const int phase = min(tt / d.nsf, d.n_phases - 1);
        const int ai = phase * d.n_inter + (qq >> 1);
        const Dual gv = gate_at<Dual>(Dual(a.action[ai], 1.0f),
                                      a.prog[tt % d.nsf], qq, k.gate32);
        const Dual sv = soft(Dual(gv.v, 1.0f) - Dual(0.5f), k.gate32);
        s.gate[gb + q] = gv.v;
        s.dgate[gb + q] = gv.d;
        s.sgv[gb + q] = sv.v;
        s.dsg[gb + q] = sv.d;
      }
    }
    const int adjp = g.num_prev == 1 ? g.prev0 : mp;
    const int adjn = g.num_next == 1 ? g.next0 : mn;
    const bool use_l = g.has_prev && g.num_prev > 0 && adjp >= 0;
    const bool use_r = g.num_next > 0 && adjn >= 0;
    if (m.lane) {
      const float* tr = a.traj + (size_t)2 * t * L * C + (size_t)l * C;
      for (int c = r; c < C; c += G) {
        s.r[l * C + c] = tr[c];
        s.y[l * C + c] = tr[(size_t)L * C + c];
      }
      if (r == 0) {
        const float rf = tr[0];
        s.edge[l] = rf;
        s.edge[L + l] = comp_u(rf, tr[(size_t)L * C], u_max);
        tgt[l] = (use_l ? clampL(adjp) + 1 : 0) |
                 (use_r ? clampL(adjn) + 1 : 0) << 10 |
                 (g.has_prev && mp >= 0 ? clampL(mp) + 1 : 0) << 20;
      }
      if (r == last % G) {
        const float rl = tr[last];
        s.edge[2 * L + l] = rl;
        s.edge[3 * L + l] = comp_u(rl, tr[(size_t)L * C + last], u_max);
      }
    }
    K4_ADD(clk, K4_R_LOAD, k4_p);
    CONVERGE();
    bar_sync(BAR_LANES, geo.NL);
    K4_ADD(clk, K4_R_WAIT_EDGES, k4_p);

    // ---- (2) the step again, and its transpose
    // the ghosts (lane_ghosts' values), with what their transpose needs
    const int gl = gb + tc * NG + s.gidx[l], qp = s.gidx[clampL(mp)];
    const bool signal = s.gidx[l] >= 0;
    // d sig_l / d action, read before the barrier like every entry of the
    // table
    const float dsig = signal ? s.dgate[gl] : 0.0f;
    const float sig_p = qp < 0 ? 1.0f : s.gate[gb + tc * NG + qp];
    float gl_r = use_l ? s.edge[2 * L + clampL(adjp)] : 0.0f;
    float gl_u = use_l ? s.edge[3 * L + clampL(adjp)] : u_max;
    if (!g.has_prev) {
      const float incoming = a.sched[tl];
      gl_r = incoming;
      gl_u = u_eq(incoming, u_max);
    }
    const float ps = !g.has_prev ? 1.0f : (mp < 0 ? 0.0f : sig_p);
    const float bl_r = gl_r * ps;
    const float bl_u = gl_u * ps + u_max * (1.0f - ps);
    const float gr_r = use_r ? s.edge[clampL(adjn)] : 0.0f;
    const float gr_u = use_r ? s.edge[L + clampL(adjn)] : u_max;
    const float sg = signal ? s.sgv[gl] : sg1.v;
    const float dsg = signal ? s.dsg[gl] : sg1.d;
    const float br_r = gr_r * sg + 1.0f * (1.0f - sg);
    const float br_u = gr_u * sg;
    const D2 ly = comp_y(D2::seed(bl_r, 0), D2::seed(bl_u, 1), u_max);
    const D2 ry = comp_y(D2::seed(br_r, 0), D2::seed(br_u, 1), u_max);
    if (m.lane) {
      for (int i = r; i <= C; i += G) {
        float rl, yl, rc, yc;
        cell_of(s.r, s.y, l, C, nc, i - 1, br_r, ry.v, rl, yl);
        cell_of(s.r, s.y, l, C, nc, i, br_r, ry.v, rc, yc);
        const bool first = i == 0, end = i == C;
        const float ul = first ? bl_u : comp_u(rl, yl, u_max);
        const float ur = end ? br_u : comp_u(rc, yc, u_max);
        D4 fr, fy;
        float wave;
        riemann(D4::seed(first ? bl_r : rl, 0), D4::seed(first ? ly.v : yl, 1),
                D4::seed(ul, 2), D4(end ? br_r : rc), D4::seed(ur, 3), u_max,
                k.rare_den, k.third, fr, fy, wave);
        const int f = l * CI + i;
        s.fr[f] = fr.v;
        s.fy[f] = fy.v;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          s.jac[f * 8 + q] = fr.d[q];
          s.jac[f * 8 + 4 + q] = fy.d[q];
        }
      }
    }
    K4_ADD(clk, K4_R_RIEMANN, k4_p);
    __syncwarp();  // the group's fluxes
    if (m.lane) {
      // the new cells and their queue terms, with the terms' partials
      const float c_st = a.sharp[t];
      for (int c = r; c < C && c < nc; c += G) {
        const int i = l * C + c, f = l * CI + c;
        const float rn = s.r[i] + (s.fr[f] - s.fr[f + 1]) * coeff;
        const float yn = s.y[i] + (s.fy[f] - s.fy[f + 1]) * coeff;
        const D2 rd = D2::seed(rn, 0);
        const D2 u = comp_u(rd, D2::seed(yn, 1), u_max);
        const D2 term = soft(D2(k.static_speed) - u, c_st) *
                        ((rd * D2(g.cell_len)) / D2(k.veh_len));
        s.qt[i] = term.v;
        s.tr[i] = term.d[0];
        s.ty[i] = term.d[1];
      }
    }
    __syncwarp();  // the group's terms
    if (m.lane) {
      // the queue's cotangent: w dt on q_l^2, 2 w dt q_l on q_l
      float q = 0.0f;
      for (int c = 0; c < nc; ++c) q = q + s.qt[l * C + c];
      const float gq = (a.q_weight[t] * k.dt) * q;
      const float gql = gq + gq;
      for (int c = r; c < C && c < nc; c += G) {
        const int i = l * C + c;
        s.gr[i] = s.gr[i] + gql * s.tr[i];
        s.gy[i] = s.gy[i] + gql * s.ty[i];
      }
    }
    K4_ADD(clk, K4_R_TERMS, k4_p);
    __syncwarp();  // the new cells' cotangents
    if (m.lane) {
      // interface i's fluxes: +coeff on cell i's update, -coeff on cell
      // i - 1's; pulled back to the interface's inputs
      for (int i = r; i <= C; i += G) {
        const bool in_i = i < nc, in_m = i >= 1 && i - 1 < nc;
        const float gcr = (in_i ? s.gr[l * C + i] : 0.0f) * coeff -
                          (in_m ? s.gr[l * C + i - 1] : 0.0f) * coeff;
        const float gcy = (in_i ? s.gy[l * C + i] : 0.0f) * coeff -
                          (in_m ? s.gy[l * C + i - 1] : 0.0f) * coeff;
        const int f = l * CI + i;
        const float* J = s.jac + f * 8;
        s.il[f] = J[0] * gcr + J[4] * gcy;
        s.il[LI + f] = J[1] * gcr + J[5] * gcy;
        s.il[2 * LI + f] = J[2] * gcr + J[6] * gcy;
        s.ir[f] = J[3] * gcr + J[7] * gcy;
      }
    }
    __syncwarp();  // the interfaces' inputs' cotangents
    if (m.lane) {
      // a cell's: its update's own term, its right interface's left input
      // and its left interface's right speed; the speed's into r and y. A
      // cell beyond the lane's is the right ghost.
      float gb[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // bl_r, bl_u, br_r,
                                                     // br_u, right_y
      for (int c = r; c < C; c += G) {
        const int i = l * C + c, f = l * CI + c;
        const bool in = c < nc;
        const float gu = s.il[2 * LI + f + 1] + s.ir[f];
        const D2 u = comp_u(D2::seed(in ? s.r[i] : br_r, 0),
                            D2::seed(in ? s.y[i] : ry.v, 1), u_max);
        const float g_r = ((in ? s.gr[i] : 0.0f) + s.il[f + 1]) + u.d[0] * gu;
        const float g_y =
            ((in ? s.gy[i] : 0.0f) + s.il[LI + f + 1]) + u.d[1] * gu;
        if (in) {
          s.gr[i] = g_r;
          s.gy[i] = g_y;
        } else {
          gb[2] += g_r;
          gb[4] += g_y;
        }
      }
      if (r == 0) {  // interface 0's left input: the left ghost
        const int f = l * CI;
        gb[0] = s.il[f] + ly.d[0] * s.il[LI + f];
        gb[1] = s.il[2 * LI + f] + ly.d[1] * s.il[LI + f];
      }
      if (C % G == r) gb[3] += s.ir[l * CI + C];  // interface C's: br_u
#pragma unroll
      for (int q = 0; q < 5; ++q) s.part[(l * G + r) * 5 + q] = gb[q];
    }
    __syncwarp();  // the group's shares of the ghosts'
    if (m.lane && r == 0) {
      float e[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int q = 0; q < 5; ++q) e[q] += s.part[(l * G + j) * 5 + q];
      const float g_brr = e[2] + ry.d[0] * e[4];
      const float g_bru = e[3] + ry.d[1] * e[4];
      // br_r = gr_r sg + (1 - sg), br_u = gr_u sg
      s.gsig[l] = dsg * (g_brr * (gr_r - 1.0f) + g_bru * gr_u);
      s.slot[2 * L + l] = g_brr * sg;
      s.slot[3 * L + l] = g_bru * sg;
      // bl_r = gl_r ps, bl_u = gl_u ps + u_max (1 - ps)
      s.slot[l] = e[0] * ps;
      s.slot[L + l] = e[1] * ps;
      s.slot[4 * L + l] = e[0] * gl_r + e[1] * (gl_u - u_max);
    }
    K4_ADD(clk, K4_R_TRANSPOSE, k4_p);
    CONVERGE();
    bar_sync(BAR_LANES, geo.NL);
    K4_ADD(clk, K4_R_WAIT_SLOTS, k4_p);

    // ---- (3) the readers' cotangents into the edges and the signal
    float ga = 0.0f;
    if (m.lane) {
      const int ch = (L + G - 1) / G, j0 = r * ch, j1 = min(L, j0 + ch);
      const int me = l + 1;
      float e[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = j0; j < j1; j += 4) {
        int pk[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) pk[u] = j + u < j1 ? tgt[j + u] : 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = j + u;
          if ((pk[u] & 1023) == me) {
            e[0] += s.slot[q];
            e[1] += s.slot[L + q];
          }
          if ((pk[u] >> 10 & 1023) == me) {
            e[2] += s.slot[2 * L + q];
            e[3] += s.slot[3 * L + q];
          }
          if ((pk[u] >> 20 & 1023) == me) e[4] += s.slot[4 * L + q];
        }
      }
#pragma unroll
      for (int q = 0; q < 5; ++q) s.part[(l * G + r) * 5 + q] = e[q];
    }
    __syncwarp();  // the chunks
    if (m.lane) {
      float e[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int q = 0; q < 5; ++q) e[q] += s.part[(l * G + j) * 5 + q];
      if (r == 0 && nc > 0) {  // the first edge: r[l, 0] and its speed
        const int i = l * C;
        const D2 u = comp_u(D2::seed(s.r[i], 0), D2::seed(s.y[i], 1), u_max);
        s.gr[i] = (s.gr[i] + e[2]) + u.d[0] * e[3];
        s.gy[i] = s.gy[i] + u.d[1] * e[3];
      }
      if (r == last % G && nc > 0) {  // the last edge
        const int i = l * C + last;
        const D2 u = comp_u(D2::seed(s.r[i], 0), D2::seed(s.y[i], 1), u_max);
        s.gr[i] = (s.gr[i] + e[0]) + u.d[0] * e[1];
        s.gy[i] = s.gy[i] + u.d[1] * e[1];
      }
      if (r == 0) ga = s.gidx[l] < 0 ? 0.0f : dsig * (s.gsig[l] + e[4]);
    }
    K4_ADD(clk, K4_R_GATHER, k4_p);
    if (t <= d.T - 3) {  // the warp has folded step t + 2's terms
      CONVERGE();
      bar_sync(BAR_GA_EMPTY + par, NB);
    }
    K4_ADD(clk, K4_R_WAIT_EMPTY, k4_p);
    K4_CLOCK(if (clk) k4_cycles[K4_R_STEPS] += 1;)
    if (m.lane && r == 0) s.ga[par * L + l] = ga;
    CONVERGE();
    bar_arrive(BAR_GA_FULL + par, NB);
  }
}

// The reduction warp's part of the sweep: each step's action terms into
// action[phase, inter], each intersection's gated lanes in lane order
// (s.members), in float64.
__device__ __forceinline__ void reverse_warp(const Args& a, const Geo& geo,
                                             RevSmem& s) {
  const Dims& d = a.d;
  const int L = d.L, NB = geo.NL + WARP;
  const int wl = threadIdx.x % WARP;
  K4_CLOCK(const bool clk = wl == 0 && blockIdx.x == 0;
           long long k4_p = k4_now();)
  for (int t = d.T - 1; t >= 0; --t) {
    const int par = t & 1;
    CONVERGE();
    bar_sync(BAR_GA_FULL + par, NB);
    K4_ADD(clk, K4_R_WAIT_FULL, k4_p);
    const int phase = min(t / d.nsf, d.n_phases - 1);
    const float* ga = s.ga + par * L;
    const int* lanes = s.members + d.n_inter + 1;
    for (int ii = wl; ii < d.n_inter; ii += WARP) {
      double acc = s.acc[phase * d.n_inter + ii];
      const int k1 = s.members[ii + 1];
      int k = s.members[ii];
      for (; k + 4 <= k1; k += 4) {
        float x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) x[u] = ga[lanes[k + u]];
#pragma unroll
        for (int u = 0; u < 4; ++u) acc += (double)x[u];
      }
      for (; k < k1; ++k) acc += (double)ga[lanes[k]];
      s.acc[phase * d.n_inter + ii] = acc;
    }
    K4_ADD(clk, K4_R_FOLD, k4_p);
    if (t >= 2) {  // the lanes write this parity's terms again at t - 2
      CONVERGE();
      bar_arrive(BAR_GA_EMPTY + par, NB);
    }
  }
}

// One block: the reverse sweep over a.traj and a.sharp, after filling them
// by the forward first where `replay`; writes out_grad [NA + 2 LC]
// entirely. MAXT: the block it is compiled for (REV_NARROW or REV_WIDE);
// the wide one keeps its state in `scratch` (global memory) where that is
// given, else in shared memory.
template <int MAXT>
__global__ void
#ifndef DHTS_CPU_EMULATION
__launch_bounds__(MAXT)
#endif
itscp_macro_episode_reverse(Args a, Geo geo, int replay, char* scratch) {
  DHTS_DYNAMIC_SMEM(smem_raw);
  char* const base = MAXT == REV_WIDE && scratch ? scratch : smem_raw;
  const Dims& d = a.d;
  const int L = d.L, C = d.C, LC = L * C;
  const int NT = geo.NL + RED_WARPS * WARP;  // the block's threads
  const int NA = d.n_phases * d.n_inter;
  const int tid = threadIdx.x;
  if (replay) {
    Args f = a;
    f.out_reward = f.out_queues = f.out_grad = nullptr;
    f.q_weight = nullptr;
    forward_body<float>(f, geo, base, -1, -1, -1, -1);
    __syncthreads();
  }
  RevSmem s;
  rev_smem(d, geo.G, &s, base);
  const Me m = me_of(geo, L);
  const Scene sc{a.lane_i, a.lane_f, nullptr, nullptr};
  const LaneGeom g = m.lane ? lane_geom(sc, L, d.K, m.l) : LaneGeom();
  for (int i = tid; i < LC; i += NT) {
    s.gr[i] = 0.0f;
    s.gy[i] = 0.0f;
  }
  for (int i = tid; i < NA; i += NT) s.acc[i] = 0.0;
  if (m.lane && m.r == 0)
    s.gidx[m.l] = g.approaching ? 2 * g.inter + (g.is_we ? 1 : 0) : -1;
  __syncthreads();
  if (tid == geo.NL) {  // the reduction warp's first thread: the members
    int* off = s.members;
    int* lanes = s.members + d.n_inter + 1;
    int n = 0;
    for (int ii = 0; ii < d.n_inter; ++ii) {
      off[ii] = n;
      for (int j = 0; j < L; ++j)
        if (s.gidx[j] >= 0 && (s.gidx[j] >> 1) == ii) lanes[n++] = j;
    }
    off[d.n_inter] = n;
  }
  __syncthreads();
  if (tid >= geo.NL + WARP)
    ;  // the second reduction warp has no part in the sweep
  else if (tid >= geo.NL)
    reverse_warp(a, geo, s);
  else
    reverse_lanes(a, geo, s, m, g);
  __syncthreads();
  for (int i = tid; i < LC; i += NT) {
    a.out_grad[NA + i] = s.gr[i];
    a.out_grad[NA + LC + i] = s.gy[i];
  }
  for (int i = tid; i < NA; i += NT) a.out_grad[i] = (float)s.acc[i];
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

bool sizes_ok(const Dims& d) {
  return d.L >= 1 && d.L <= MAX_THREADS - WARP && d.C >= 1 && d.C <= MAXC &&
         d.K >= 1 && d.T >= 0 && d.nsf >= 1 && d.n_phases >= 1 &&
         d.n_inter >= 1 && d.n_inter <= d.L;
}

// The most dynamic shared memory a block may take: the device's opt-in
// limit; on the host an H100's (227 KB).
size_t max_smem() {
#ifdef DHTS_CPU_EMULATION
  return 227 * 1024;
#else
  int dev, optin;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return (size_t)optin;
#endif
}

// Threads a lane: the fewest interfaces a thread (ceil((C + 1) / G)), and
// the fewest threads for that, whose block the kernel can take; 0 if none
// (a build with -DDHTS_K4_LANE_THREADS=n takes min(n, C + 1)).
int lane_threads(int max_threads, int L, int C) {
#ifdef DHTS_K4_LANE_THREADS
  const int G = min(DHTS_K4_LANE_THREADS, C + 1);
  return geo_of(L, G).NL + RED_WARPS * WARP <= max_threads ? G : 0;
#else
  for (int per = 1; per <= C + 1; ++per) {
    const int G = (C + 1 + per - 1) / per;
    if (geo_of(L, G).NL + RED_WARPS * WARP <= max_threads) return G;
  }
  return 0;
#endif
}

template <class Kernel, class... X>
int launch_block(Kernel kernel, int blocks, const Geo& geo, size_t smem,
                 void* stream, X... args) {
  const int threads = geo.NL + RED_WARPS * WARP;
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

// A launch's kernel, threads a lane (0: no block of the kernel fits the
// scene), the bytes of its state and whether they go to global memory (the
// float forward's and the wide sweep's, where shared memory cannot hold
// them) or shared memory.
template <class Kernel>
struct Fit {
  Kernel kernel;
  int G;
  size_t smem;
  bool global;
};

// The forward's (S = float) or the forward-mode derivative's (S = Dual,
// shared memory only).
template <class S>
Fit<void (*)(Args, Geo, char*)> forward_fit(const Dims& d) {
  Fit<void (*)(Args, Geo, char*)> f{
      itscp_macro_episode_kernel<S, false>, 0,
      fwd_smem<S>(d.L, d.C, d.n_inter, nullptr, nullptr), false};
  if (!sizes_ok(d)) return f;
  if (f.smem > max_smem()) {
    if (sizeof(S) != sizeof(float)) return f;
    f.kernel = itscp_macro_episode_kernel<float, true>;
    f.global = true;
  }
  f.G = lane_threads(max_threads_of(f.kernel, MaxThreads<S>::value), d.L,
                     d.C);
  return f;
}

// The sweep's: the narrow kernel where its block and shared memory hold
// the scene, else the wide one, its state in global memory where shared
// memory cannot hold it; `replay` adds the forward's state.
Fit<void (*)(Args, Geo, int, char*)> sweep_fit(const Dims& d, int replay) {
  Fit<void (*)(Args, Geo, int, char*)> f{
      itscp_macro_episode_reverse<REV_NARROW>, 0, 0, false};
  if (!sizes_ok(d)) return f;
  const auto bytes = [&](int G) {
    const size_t rev = rev_smem(d, G, nullptr, nullptr);
    const size_t fwd =
        replay ? fwd_smem<float>(d.L, d.C, d.n_inter, nullptr, nullptr) : 0;
    return rev > fwd ? rev : fwd;
  };
  f.G = lane_threads(max_threads_of(f.kernel, REV_NARROW), d.L, d.C);
  f.smem = bytes(f.G > 0 ? f.G : 1);
  if (f.G > 0 && f.smem <= max_smem()) return f;
  f.kernel = itscp_macro_episode_reverse<REV_WIDE>;
  f.G = lane_threads(max_threads_of(f.kernel, REV_WIDE), d.L, d.C);
  f.smem = bytes(f.G > 0 ? f.G : 1);
  f.global = f.smem > max_smem();
  return f;
}

// One launch of `f` on `blocks` blocks (one where its state goes to global
// memory, allocated and freed in stream order); the kernel's last argument
// is that state, or null.
template <class Kernel, class... X>
int launch_fit(const Fit<Kernel>& f, int blocks, const Geo& geo,
               void* stream, X... args) {
  if (f.G < 1 || blocks < 1 || (f.global && blocks != 1))
    return 1;  // cudaErrorInvalidValue
  if (!f.global)
    return launch_block(f.kernel, blocks, geo, f.smem, stream, args...,
                        (char*)nullptr);
  char* scratch = nullptr;
#ifdef DHTS_CPU_EMULATION
  scratch = (char*)malloc(f.smem);
  if (!scratch) return 2;  // cudaErrorMemoryAllocation
  const int err = launch_block(f.kernel, 1, geo, 0, stream, args..., scratch);
  free(scratch);
  return err;
#else
  cudaError_t err =
      cudaMallocAsync((void**)&scratch, f.smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int launched =
      launch_block(f.kernel, 1, geo, 0, stream, args..., scratch);
  err = cudaFreeAsync(scratch, (cudaStream_t)stream);
  return launched ? launched : (int)err;
#endif
}

template <class S>
int launch_forward(int blocks, const Args& a, void* stream) {
  const auto f = forward_fit<S>(a.d);
  const Geo geo = geo_of(a.d.L, f.G > 0 ? f.G : 1);
  return launch_fit(f, blocks, geo, stream, a, geo);
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

Args args_of(const float* action, const float* sched, const int* mnext,
             const int* mprev, const float* r0, const float* y0,
             const float* prog, const int* lane_i, const float* lane_f,
             const Dims& d, const Consts& k) {
  Args a{};
  a.action = action; a.sched = sched; a.mnext = mnext; a.mprev = mprev;
  a.r0 = r0; a.y0 = y0; a.prog = prog; a.lane_i = lane_i; a.lane_f = lane_f;
  a.d = d;
  a.k = k;
  return a;
}

}  // namespace

extern "C" {

// The bytes of the state of the forward (kernel 0), the forward-mode
// derivative (1) or the reverse sweep (2, replaying) for these sizes: its
// dynamic shared memory, or the global memory that takes its place.
size_t itscp_macro_episode_smem(int L, int C, int kernel) {
  // (the gates' tables sized for n_inter = L, the most a launch takes)
  const Dims d = dims(1, L, C, 1, 1, 1, L);
  return kernel == 0   ? forward_fit<float>(d).smem
         : kernel == 1 ? forward_fit<Dual>(d).smem
                       : sweep_fit(d, 1).smem;
}

// The threads a lane that kernel 0, 1 or 2 (as above) takes for a scene of
// these sizes; 0 where no block of it fits (the forward kernels: by their
// threads or shared memory; the sweep: by its threads), and the launcher
// returns 1.
int itscp_macro_episode_lane_threads(int L, int C, int n_phases, int n_inter,
                                     int kernel) {
  const Dims d = dims(1, L, C, 1, 1, n_phases, n_inter);
  return kernel == 0   ? forward_fit<float>(d).G
         : kernel == 1 ? forward_fit<Dual>(d).G
                       : sweep_fit(d, 0).G;
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
  Args a = args_of(action, sched, mnext, mprev, r0, y0, prog, lane_i, lane_f,
                   dims(T, L, C, K, nsf, n_phases, n_inter),
                   consts(u_max, dt, veh_len, static_speed, rare_den, third,
                          gate32));
  a.out_reward = out_reward;
  a.out_queues = out_queues;
  return launch_forward<float>(1, a, stream);
}

// The forward that also stores the trajectory: traj [T, 2, L, C] (the
// state before each step, r then y) and sharp [T] (each step's detached
// sharpness), which launch_itscp_macro_episode_reverse reads.
int launch_itscp_macro_episode_fwd_traj(
    const float* action, const float* sched, const int* mnext,
    const int* mprev, const float* r0, const float* y0, const float* prog,
    const int* lane_i, const float* lane_f, float* out_reward,
    float* out_queues, float* traj, float* sharp, int T, int L, int C, int K,
    int nsf, int n_phases, int n_inter, float u_max, float dt, float veh_len,
    float static_speed, float rare_den, float third, float gate32,
    void* stream) {
  if (!traj || !sharp) return 1;
  Args a = args_of(action, sched, mnext, mprev, r0, y0, prog, lane_i, lane_f,
                   dims(T, L, C, K, nsf, n_phases, n_inter),
                   consts(u_max, dt, veh_len, static_speed, rare_den, third,
                          gate32));
  a.out_reward = out_reward;
  a.out_queues = out_queues;
  a.traj = traj;
  a.sharp = sharp;
  return launch_forward<float>(1, a, stream);
}

// Forward-mode derivative: out_grad[n_phases * n_inter + 2 L C] (zeroed by
// the caller) gets sum_t q_weight[t] * d(queue_t)/d(entry) at the n_a
// action entries, the n_r cells of r0 and the n_y cells of y0 named by
// `cells`, one block each; the other entries are not written. Returns
// cudaGetLastError().
int launch_itscp_macro_episode_bwd(
    const float* action, const float* sched, const int* mnext,
    const int* mprev, const float* r0, const float* y0, const float* prog,
    const int* lane_i, const float* lane_f, const int* cells,
    const float* q_weight, float* out_grad, int T, int L, int C, int K,
    int nsf, int n_phases, int n_inter, int n_a, int n_r, int n_y,
    float u_max, float dt, float veh_len, float static_speed,
    float rare_den, float third, float gate32, void* stream) {
  if (n_a < 0 || n_a > n_phases * n_inter || n_r < 0 || n_y < 0 ||
      n_r > L * C || n_y > L * C || n_a + n_r + n_y < 1)
    return 1;
  Args a = args_of(action, sched, mnext, mprev, r0, y0, prog, lane_i, lane_f,
                   dims(T, L, C, K, nsf, n_phases, n_inter),
                   consts(u_max, dt, veh_len, static_speed, rare_den, third,
                          gate32));
  a.cells = cells;
  a.q_weight = q_weight;
  a.out_grad = out_grad;
  a.n_a = n_a; a.n_r = n_r; a.n_y = n_y;
  return launch_forward<Dual>(n_a + n_r + n_y, a, stream);
}

// Reverse sweep, one block: out_grad[n_phases * n_inter + 2 L C] gets the
// gradient of sum_t q_weight[t] * queue_t with respect to the action, r0
// and y0 (every entry written; cells beyond a lane's num_cell 0), over the
// trajectory traj, sharp of launch_itscp_macro_episode_fwd_traj on the
// same inputs, or, with `replay`, over one the launch first writes there.
// Returns cudaGetLastError().
int launch_itscp_macro_episode_reverse(
    const float* action, const float* sched, const int* mnext,
    const int* mprev, const float* r0, const float* y0, const float* prog,
    const int* lane_i, const float* lane_f, const float* q_weight,
    float* traj, float* sharp, float* out_grad, int T, int L, int C, int K,
    int nsf, int n_phases, int n_inter, int replay, float u_max, float dt,
    float veh_len, float static_speed, float rare_den, float third,
    float gate32, void* stream) {
  if (!q_weight || !out_grad || (T > 0 && (!traj || !sharp))) return 1;
  Args a = args_of(action, sched, mnext, mprev, r0, y0, prog, lane_i, lane_f,
                   dims(T, L, C, K, nsf, n_phases, n_inter),
                   consts(u_max, dt, veh_len, static_speed, rare_den, third,
                          gate32));
  a.q_weight = q_weight;
  a.out_grad = out_grad;
  a.traj = traj;
  a.sharp = sharp;
  const auto f = sweep_fit(a.d, replay);
  const Geo geo = geo_of(L, f.G > 0 ? f.G : 1);
  return launch_fit(f, 1, geo, stream, a, geo, replay);
}

#ifdef DHTS_K4_CLOCK
// The cycle stamps summed since the last reset, k4_cycles[K4_PARTS] (see
// K4Part), into host memory `out`; `reset` zeroes them first. Returns the
// CUDA error code (0: success).
int itscp_macro_episode_clock(long long* out, int reset) {
#ifdef DHTS_CPU_EMULATION
  for (int i = 0; i < K4_PARTS; ++i) {
    if (reset) k4_cycles[i] = 0;
    out[i] = k4_cycles[i];
  }
  return 0;
#else
  if (reset) {
    const long long zero[K4_PARTS] = {};
    const cudaError_t err = cudaMemcpyToSymbol(k4_cycles, zero, sizeof(zero));
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaMemcpyFromSymbol(out, k4_cycles,
                                   sizeof(long long) * K4_PARTS);
#endif
}
#endif

}  // extern "C"
