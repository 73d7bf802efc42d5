// Steps of the fused spatial ITSCP episode on one lane shard, for Hopper
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
// taken in float64 in lane order and rounded once on both sides, so
// carries, events and queues agree bit for bit.
//
// Design. One launch runs the n_steps steps of a launcher call: one thread
// block per episode (forward), one thread per lane, the block looping over
// the steps (no block reads another's state, so no step needs the grid).
// A block of more threads than the kernel's registers allow (the 5x5 and
// 7x7 grids) runs the same code bounded to 64 registers a thread.
// Between calls the carry is packed per episode as one float row (r, y [C,
// L]; pos, vel, av and six vehicle parameters [V, L]; cap [K, L]; the
// signal and static running-mean sums) and one int row (count [L]; route id
// and route index [V, L]; waiting-pool and emission-pool cursors [L]); the
// offsets are `layout` here and float_layout/int_layout in the wrapper.
// During a launch the block holds the rows in shared memory (loaded at its
// start, stored at its end) where they fit and the grid still runs in one
// wave of blocks, else they stay in global memory: a call of T steps, T
// calls of one step and any split in between give the same bits.
//   lanes       A lane's thread reads and writes its own lane of the carry;
//               what other lanes read (signals, edge cells, tails, heads,
//               wants, arbitration verdicts) goes through per-lane
//               summaries in shared memory, the port of the JAX step's
//               gathered summary rows. The lane threads sync among
//               themselves (named barrier BAR_LANES) where a lane reads
//               another's summary: after injection, after the leader
//               walks, after the physics, after the conversion requests,
//               after arbitration and after the conversion.
//   reductions  Behind the lane warps, one reduction warp takes each
//               step's records (the blend's terms, the static partials,
//               q^2; by step parity, two steps' worth) once the lanes
//               arrive at their named barriers, and frees a parity's
//               records for the step two on. The float64 sums of the
//               running means and of the queue stay in lane order, taken
//               by its first thread with the terms of 8 lanes loaded ahead
//               of their adds. Counts, events and the wave maximum, exact
//               in any order,
//               go through a shuffle tree per lane warp. Only the soft
//               gates wait for a mean: the warps that run a micro lane for
//               the signal mean (the blend), every lane for the static
//               mean (the queue gates); hard mode waits for none. A block
//               of more than 992 lanes has no room for the warp, and
//               thread 0 reduces between barriers instead.
//   speeds      The speeds a macro lane's static partials take of its
//               cells after the conversion serve its queue, the next
//               step's edge summaries and the next Godunov update's first
//               cells, whose states they are.
//   inputs      Each step's rows of the schedule, the draws and the macro
//               routes are loaded a step ahead.
// The per-lane phases (signal, injection, ghosts, Godunov and IDM updates,
// conversion requests, arbitration, verdicts and deposits, queue) are
// K1's, from itscp_step.cuh; the leader walk, the blend and the reductions
// follow body_STEP.
//
// Derivative: forward-mode tangents. The step is a template on its scalar
// type: `float` in the forward, `Dual` (value, tangent) in the derivative,
// whose launch has one block per (episode b, action entry j) and carries
// d(carry)/d(action_j) beside the values in a tangent row of the same
// layout (in shared memory the tangents of r, y, pos, vel, av and cap
// only: no other field has one). Each step adds w[b, t] *
// d(queue_t)/d(action_j) to a float64 accumulator; the value half repeats
// the forward's float operations, so no residuals are saved. Local
// derivatives follow autograd of the plain step (max/min split a tie
// 0.5/0.5, a `where` takes the selected branch's tangent, detached running
// means and decremented capacitors, the emitted vehicle's mass carries the
// capacitor's tangent, the deposit's clamp is straight through, and a
// speed stopped by the acceleration floor has a zero tangent).
//
// Bound. A step is a handful of block-wide barriers between per-lane
// chains of IEEE divisions and roots (the Godunov update, the cells'
// speeds) and thread 0's lane-order sums; it must move only the macro
// cells, the vehicles present and the counters of each episode, tens of
// KB, so it is latency-bound, far above the bytes / 3.35 TB/s floor.

#include <cstring>

#include "itscp_step.cuh"

namespace {

// Cycle stamps (a build with -DDHTS_STEP_CLOCK; python -m
// dhts_torch.ops.cuda.spatial_clock): thread 0 of block 0 reads the clock
// after each barrier of a step and adds the cycles since its last stamp to
// the part that ended there (SP_PROLOGUE ... SP_FINAL), so each part's
// count is the time the lanes spent in it (SP_PROLOGUE: from kernel entry
// to the first step, and the carry's store at the end; with a reduction
// warp, a mean's part is the wait for it and SP_FINAL is 0). Beside the
// lanes' path, the reduction warp's first thread adds its cycles from each
// record's arrival to its release to SP_RED, and each lane thread of block
// 0 its own cycles in C to lane_c_cycles. A launch adds its sums and the
// steps it ran to step_cycles. Without the macro the stamps compile to
// nothing.
enum StepPart {
  SP_PROLOGUE, SP_A, SP_B, SP_SIGNAL_MEAN, SP_C, SP_D1, SP_D2, SP_D3,
  SP_STATIC_MEAN, SP_E, SP_FINAL, SP_RED, SP_PARTS
};
#ifdef DHTS_STEP_CLOCK
__device__ long long step_cycles[SP_PARTS + 1];  // the parts, then steps
__device__ long long lane_c_cycles[1024];
// the SM's clock, read by a volatile asm with a memory clobber: the
// compiler keeps it in order with the barriers
__device__ __forceinline__ long long sp_now() {
#ifdef DHTS_CPU_EMULATION
  return clock64();
#else
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
#endif
}
#define SP_CLOCK_START(who)                         \
  const bool sp_clk = (who) && blockIdx.x == 0;     \
  long long sp_ck[SP_PARTS] = {};                   \
  long long sp_t0 = sp_clk ? sp_now() : 0
#define SP_MARK()                    \
  do {                               \
    if (sp_clk) sp_t0 = sp_now();    \
  } while (0)
#define SP_STAMP(p)                        \
  do {                                     \
    if (sp_clk) {                          \
      const long long sp_t = sp_now();     \
      sp_ck[p] += sp_t - sp_t0;            \
      sp_t0 = sp_t;                        \
    }                                      \
  } while (0)
// each clocking thread adds the parts it counted (thread 0 and the
// reduction warp's count disjoint parts, so neither overwrites the other)
#define SP_CLOCK_END(steps)                                    \
  do {                                                         \
    if (sp_clk) {                                              \
      for (int sp_i = 0; sp_i < SP_PARTS; ++sp_i)              \
        if (sp_ck[sp_i]) step_cycles[sp_i] += sp_ck[sp_i];     \
      if (steps) step_cycles[SP_PARTS] += (steps);             \
    }                                                          \
  } while (0)
#define SP_LANE_BEGIN() const long long sp_c0 = sp_now()
#define SP_LANE_END(l)                                              \
  do {                                                              \
    if (blockIdx.x == 0) lane_c_cycles[l] += sp_now() - sp_c0;      \
  } while (0)
#else
#define SP_CLOCK_START(who) (void)0
#define SP_MARK() (void)0
#define SP_STAMP(p) (void)0
#define SP_CLOCK_END(steps) (void)0
#define SP_LANE_BEGIN() (void)0
#define SP_LANE_END(l) (void)0
#endif

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

constexpr int WARP = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_WARPS = 32;  // MAX_LANES / 32
// named barriers (0 is __syncthreads): the lane threads' own; by step
// parity, the records of B, of D3 and of E (the lanes arrive, the
// reduction warp waits) and the release of a parity's records (the
// reduction warp arrives, the lanes wait two steps on); the soft means'
// release (the reduction warp arrives, the lanes that read the mean wait)
constexpr int BAR_LANES = 1, BAR_B = 2, BAR_D3 = 4, BAR_E = 6,
              BAR_EMPTY = 8, BAR_SIG = 10, BAR_STAT = 11;

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

// a warp's exact partial results, folded by a shuffle tree: integer counts
// and the largest wave speed (order-free), never a float sum
struct WarpPart {
  int n[5];  // static mean's cells and vehicles; injected, emitted, absorbed
  float wave;
};

// per-lane summaries other lanes read, the step's records by step parity
// (what the reductions read) and, where it fits, the episode's carry
template <class S>
struct Smem {
  S *sig, *r_last, *u_last, *r_first, *u_first, *tpos, *tvel, *cap_val;
  S *hs_pos, *hs_vel, *hs_a;
  S* red_q;          // [2][L] each lane's q^2
  float *tlen, *hs_len, *hs_par, *ms;  // hs_par: [5 L]
  double* sig_term;  // [2][L] the blend's terms of the signal running mean
  double* red_sum;   // [2][2 L] the static partials (cells, vehicles)
  int* red_cnt;      // [2][2 L] and their counts
  int* part_blend;   // [2][MAX_WARPS] each warp's blend count
  WarpPart* part;    // [2][MAX_WARPS]
  int* warp_micro;   // [MAX_WARPS] whether a warp runs a micro lane
  int* micro;        // [L] the micro lanes in lane order, then their count
  int *count, *want, *mn, *hn, *hs_rid, *hs_ridx, *best, *dep_best;
  // the carry (`carry`): the float row, the tangents of r, y, pos, vel, av
  // and then cap (Dual), the int row
  float *cf, *cd;
  int* ci;
};

template <class S>
__host__ __device__ inline size_t smem_bytes(const Dims& d, Smem<S>* s,
                                             char* base, bool carry) {
  size_t off = 0;
  Smem<S> dummy;
  Smem<S>* t = s ? s : &dummy;
  char* b = s ? base : nullptr;
  const size_t L = d.L;
  S** sf[] = {&t->sig, &t->r_last, &t->u_last, &t->r_first, &t->u_first,
              &t->tpos, &t->tvel, &t->cap_val, &t->hs_pos, &t->hs_vel,
              &t->hs_a};
  for (S** p : sf) carve(p, L, b, off);
  carve(&t->red_q, 2 * L, b, off);
  carve(&t->tlen, L, b, off); carve(&t->hs_len, L, b, off);
  carve(&t->hs_par, 5 * L, b, off); carve(&t->ms, 4, b, off);
  carve(&t->sig_term, 2 * L, b, off); carve(&t->red_sum, 4 * L, b, off);
  carve(&t->red_cnt, 4 * L, b, off);
  carve(&t->part_blend, 2 * MAX_WARPS, b, off);
  carve(&t->part, 2 * MAX_WARPS, b, off);
  carve(&t->warp_micro, MAX_WARPS, b, off);
  carve(&t->micro, L + 1, b, off);
  int** si[] = {&t->count, &t->want, &t->mn, &t->hn, &t->hs_rid,
                &t->hs_ridx, &t->best, &t->dep_best};
  for (int** p : si) carve(p, L, b, off);
  if (carry) {
    const Layout o = layout(d);
    const bool dual = sizeof(S) != sizeof(float);
    carve(&t->cf, o.fsize, b, off);
    carve(&t->cd, dual ? o.amax + d.K * d.L : 0, b, off);
    carve(&t->ci, o.isize, b, off);
  }
  return off;
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

// K float64 terms of one index
template <int K>
struct Terms {
  double v[K];
};

// K float64 sums over j = 0 .. n - 1 in index order, ((0 + x_0) + x_1) +
// ..., the plain version's sequential sum (lane_sum32, _seq_sum64), by one
// thread: `get(j)` returns term j of each (by value, so that the terms
// stay in registers); the terms of 8 indices are loaded before their adds,
// so only the adds form the chain.
template <int K, class Get>
__device__ __forceinline__ Terms<K> seq_sums(int n, Get get) {
  Terms<K> acc;
#pragma unroll
  for (int k = 0; k < K; ++k) acc.v[k] = 0.0;
  int j = 0;
  for (; j + 8 <= n; j += 8) {
    Terms<K> x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = get(j + i);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < K; ++k) acc.v[k] += x[i].v[k];
  }
  for (; j < n; ++j) {
    const Terms<K> x = get(j);
#pragma unroll
    for (int k = 0; k < K; ++k) acc.v[k] += x.v[k];
  }
  return acc;
}

// The lane's first and last cells, which neighbours read as ghosts
// (itscp_step.cuh's publish_edges); `u_known` (or null) holds the speeds
// of its first `n_known` cells on this state, taken by the last step's
// static partials.
template <class S, class St, class Sm>
__device__ __forceinline__ void publish_edges_known(const St& st, Sm& s,
                                                    int l, int last,
                                                    float u_max,
                                                    const S* u_known,
                                                    int n_known) {
  const S rf = ld<S>(st.r, st.ci(l, 0)), rl = ld<S>(st.r, st.ci(l, last));
  s.r_first[l] = rf;
  s.u_first[l] = n_known > 0 ? u_known[0]
                             : comp_u(rf, ld<S>(st.y, st.ci(l, 0)), u_max);
  s.r_last[l] = rl;
  s.u_last[l] = last < n_known
                    ? u_known[last]
                    : comp_u(rl, ld<S>(st.y, st.ci(l, last)), u_max);
}

// itscp_step.cuh's godunov_lane with the speeds of the first `n_known`
// cells given (`u_known`, taken on this state by the last step's static
// partials) instead of computed again: the same values.
template <class S, class St>
__device__ __forceinline__ float godunov_known(St& st, const LaneGeom& g,
                                               int l, int C,
                                               const Ghosts<S>& gh,
                                               const Consts& k,
                                               const S* u_known,
                                               int n_known) {
  const float u_max = k.u_max;
  const S right_y = comp_y(gh.br_r, gh.br_u, u_max);
  const S left_y = comp_y(gh.bl_r, gh.bl_u, u_max);
  S rp[MAXC], yp[MAXC], up[MAXC];
  for (int c = 0; c < C; ++c) {
    rp[c] = c < g.num_cell ? ld<S>(st.r, st.ci(l, c)) : gh.br_r;
    yp[c] = c < g.num_cell ? ld<S>(st.y, st.ci(l, c)) : right_y;
    up[c] = c < n_known ? u_known[c] : comp_u(rp[c], yp[c], u_max);
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

// Steps t0 .. t0 + n_steps - 1 of one episode (S = float; block e is
// episode e) or of one dual episode (S = Dual; block e is episode e / n_act
// seeding action entry e % n_act). The per-lane phases are those of
// itscp_step.cuh; the carry is in shared memory during the launch
// (`carry`) or in global memory. With `red`, a reduction warp behind the
// lane warps takes each step's records; without it (more than 992 lanes),
// thread 0 reduces them between barriers.
template <class S>
__device__ __forceinline__ void spatial_steps(Ptrs p, Dims d, Consts k,
                                              int t0, int n_steps, int carry,
                                              int red) {
  DHTS_DYNAMIC_SMEM(smem_raw);
  Smem<S> s;
  smem_bytes<S>(d, &s, smem_raw, carry != 0);

  const int L = d.L, C = d.C, V = d.V, K = d.K, R = d.R;
  const bool soft_mode = d.mode != HARD;
  const int n_warps = (L + WARP - 1) / WARP, NT = n_warps * WARP;
  const int NB = NT + WARP;  // the lanes and the reduction warp
  const bool reducer = red && (int)threadIdx.x >= NT;
  const int l = threadIdx.x;
  const bool lane = l < L;
  const int warp = l / WARP, wl = l % WARP;
  SP_CLOCK_START(threadIdx.x == 0 || (reducer && wl == 0));
  const int e = blockIdx.x;
  const bool dual = p.dbuf != nullptr;
  const int n_act = d.n_phases * d.n_inter;
  const int b = dual ? e / n_act : e;
  const int seed = dual ? e % n_act : -1;

  // this episode's carry: in shared memory for the launch, or in place
  const Layout o = layout(d);
  const int KL = K * L, NTH = NT + (red ? WARP : 0);
  float* Fg = p.fbuf + (size_t)e * o.fsize;
  float* Dg = dual ? p.dbuf + (size_t)e * o.fsize : nullptr;
  int* Ig = p.ibuf + (size_t)e * o.isize;
  float *F = Fg, *D = Dg, *Dcap = dual ? Dg + o.cap : nullptr;
  int* I = Ig;
  if (carry) {
    F = s.cf; I = s.ci;
    for (int i = threadIdx.x; i < o.fsize; i += NTH) F[i] = Fg[i];
    for (int i = threadIdx.x; i < o.isize; i += NTH) I[i] = Ig[i];
    if (dual) {
      D = s.cd; Dcap = s.cd + o.amax;
      for (int i = threadIdx.x; i < o.amax; i += NTH) D[i] = Dg[i];
      for (int i = threadIdx.x; i < KL; i += NTH) Dcap[i] = Dg[o.cap + i];
    }
  }
  auto fa = [&](int off) { return FA{F + off, D ? D + off : nullptr}; };
  LaneState<S, FA, true> st{fa(o.r), fa(o.y), fa(o.pos), fa(o.vel), fa(o.av),
                      FA{F + o.cap, Dcap},
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
  {
    // the warps that run a micro lane (they read the soft signal mean)
    int micro = lane && !g.is_macro ? 1 : 0;
    for (int off = WARP / 2; off > 0; off >>= 1)
      micro |= __shfl_down_sync(FULL_MASK, micro, off);
    if (!reducer && wl == 0) s.warp_micro[warp] = micro;
  }
  if (threadIdx.x == 0) {
    // the lanes whose blend can add a signal term (a macro lane's is 0)
    int n = 0;
    for (int j = 0; j < L; ++j)
      if (!sc.macro_at(j)) s.micro[n++] = j;
    s.micro[L] = n;
  }
  __syncthreads();
  int n_sig = 0;
  for (int w = 0; w < n_warps; ++w) n_sig += s.warp_micro[w];
  const bool waits_sig = !reducer && s.warp_micro[warp] != 0;

  // ---- the step's reductions, by one thread (the reduction warp's first,
  // or thread 0), on the records of step parity `slot`
  double grad = 0.0;  // the derivative's accumulator
  // the signal running mean (sum, count) in lane order; its detached mean
  // sharpens the soft blend gate. Only the micro lanes' terms are added:
  // the others are +0.0, which leave a sum that started at +0.0 as it is
  auto signal_mean = [&](int slot) {
    const double* terms = s.sig_term + slot * L;
    const int* micro = s.micro;
    const Terms<1> tot = seq_sums<1>(micro[L], [=](int j) {
      return Terms<1>{{terms[micro[j]]}};
    });
    int cnt = 0;
    for (int w = 0; w < n_warps; ++w)
      cnt += s.part_blend[slot * MAX_WARPS + w];
    sg_ms[0] = sg_ms[0] + (float)tot.v[0];
    sg_ms[1] = sg_ms[1] + (float)cnt;
    const float mean = sg_ms[0] / fmaxf(sg_ms[1], 1.0f);
    s.ms[0] = sharpness(k.gate32, mean);
  };
  // the static running mean over the cells, then the vehicles; its
  // detached mean sharpens the soft queue gates
  auto static_mean = [&](int slot) {
    const double* terms = s.red_sum + slot * 2 * L;
    // cells, vehicles
    const Terms<2> sums = seq_sums<2>(L, [=](int j) {
      return Terms<2>{{terms[j], terms[L + j]}};
    });
    int nc = 0, nv = 0;
    for (int w = 0; w < n_warps; ++w) {
      nc += s.part[slot * MAX_WARPS + w].n[0];
      nv += s.part[slot * MAX_WARPS + w].n[1];
    }
    ss_ms[0] = ss_ms[0] + ((float)sums.v[0] + (float)sums.v[1]);
    ss_ms[1] = ss_ms[1] + ((float)nc + (float)nv);
    const float mean = ss_ms[0] / fmaxf(ss_ms[1], 1.0f);
    s.ms[1] = sharpness(16.0f, mean);
  };
  // step t's queue sum_l q^2 * dt in lane order (a Dual's value and
  // tangent each), events and largest wave speed
  auto step_outputs = [&](int slot, int t) {
    const S* terms = s.red_q + slot * L;
    // values, tangents
    const Terms<2> qs = seq_sums<2>(L, [=](int j) {
      return Terms<2>{{(double)val(terms[j]), (double)tangent(terms[j])}};
    });
    const S queue = from_parts<S>((float)qs.v[0], (float)qs.v[1]) *
                    S(k.dt);
    const size_t bt = (size_t)b * d.T + t;
    if (dual) {
      grad += (double)p.q_weight[bt] * (double)tangent(queue);
    } else {
      int ev[3] = {0, 0, 0};
      float wave = 0.0f;
      for (int w = 0; w < n_warps; ++w) {
        const WarpPart& wp = s.part[slot * MAX_WARPS + w];
        for (int q = 0; q < 3; ++q) ev[q] += wp.n[2 + q];
        wave = max_of(wave, wp.wave);
      }
      p.out_queue[bt] = val(queue);
      for (int q = 0; q < 3; ++q) p.out_events[bt * 3 + q] = ev[q];
      p.out_wave[bt] = wave;
    }
  };
  const bool reduces = red ? reducer && wl == 0 : threadIdx.x == 0;
  if (dual && reduces) grad = p.grad[e];
  if (!reducer) SP_STAMP(SP_PROLOGUE);

  if (reducer) {
    // ================= the reduction warp ==============================
    for (int i = 0; i < 2 && i < n_steps; ++i) bar_arrive(BAR_EMPTY + i, NB);
    for (int i = 0; i < n_steps; ++i) {
      const int slot = i & 1;
      bar_sync(BAR_B + slot, NB);
      SP_MARK();
      if (wl == 0) signal_mean(slot);
      CONVERGE();
      SP_STAMP(SP_RED);
      if (soft_mode && n_sig > 0) bar_arrive(BAR_SIG, WARP * (n_sig + 1));
      bar_sync(BAR_D3 + slot, NB);
      SP_MARK();
      if (wl == 0) static_mean(slot);
      CONVERGE();
      SP_STAMP(SP_RED);
      if (soft_mode) bar_arrive(BAR_STAT, NB);
      bar_sync(BAR_E + slot, NB);
      SP_MARK();
      if (wl == 0) step_outputs(slot, t0 + i);
      CONVERGE();
      SP_STAMP(SP_RED);
      if (i + 2 < n_steps) bar_arrive(BAR_EMPTY + slot, NB);
    }
  }

  // ================= the lanes (the reduction warp skips the loop) ======
  // the cells' speeds the last step's static partials took on the state
  // this step starts from (none at a launch's first step)
  S u_cells[MAXC];
  int n_known = 0;
  // the step's input rows, loaded a step ahead
  auto row = [&](int t, float& sch, float& rnd, int& mp, int& mn) {
    if (!lane || t >= t0 + n_steps) return;
    const int tl = t * L + l;
    sch = p.sched[tl]; rnd = p.rand[((size_t)b * d.T + t) * L + l];
    mp = p.mprev[tl]; mn = p.mnext[tl];
  };
  float nx_sched = 0.0f, nx_rand = 0.0f;
  int nx_mprev = -1, nx_mnext = -1;
  row(t0, nx_sched, nx_rand, nx_mprev, nx_mnext);
  auto lane_sync = [&]() {
    if (red) {
      CONVERGE();
      bar_sync(BAR_LANES, NT);
    } else {
      __syncthreads();
    }
  };

  for (int i = 0; i < (reducer ? 0 : n_steps); ++i) {
    const int t = t0 + i, slot = i & 1;
    const float sch = nx_sched, rnd = nx_rand;
    const int mprev_t = nx_mprev, mnext_t = nx_mnext;
    row(t + 1, nx_sched, nx_rand, nx_mprev, nx_mnext);

    // ================= A: signal, edge cells, injection ==================
    int ev_inj = 0;
    float incoming = -1.0f;
    if (lane) {
      s.sig[l] = lane_signal<S>(p.action, p.prog, d, k, g, t, seed);
      incoming = g.has_prev ? -1.0f : sch;
      publish_edges_known<S>(st, s, l, last, k.u_max, u_cells, n_known);
      ev_inj = inject<S>(st, g, d, k, l, rnd, incoming) ? 1 : 0;
      // the tail summary row the leader walks read
      s.count[l] = st.count[l];
      s.tpos[l] = ld<S>(st.pos, l);
      s.tvel[l] = ld<S>(st.vel, l);
      s.tlen[l] = len_[l];
    }
    if (red) {
      // also: the records of this parity (step t - 2) are free
      CONVERGE();
      bar_sync(BAR_EMPTY + slot, NB);
    } else {
      __syncthreads();
    }
    SP_STAMP(SP_A);

    // ================= B: ghosts, leader walk, the head's signal =========
    Ghosts<S> gh{0.f, 0.f, 0.f, 0.f};
    S pd_g = 0.f, sd_g = 0.f, red_pd = 0.f, fsig = 0.f;
    bool blend = false;
    if (lane) {
      gh = ghosts<S>(s, sc, g, L, l, mprev_t, mnext_t, incoming, d.mode, k);
      if (!g.is_macro) {
        // virtual leader: walk the head vehicle's route
        const int n = st.count[l];
        const bool exists = n > 0;
        const int h = min(max(n - 1, 0), V - 1);
        const S hpos = ld<S>(st.pos, h * L + l);
        const S hvel = ld<S>(st.vel, h * L + l);
        const float hlen = len_[h * L + l];
        const int hrid = st.rid[h * L + l], hridx = st.ridx[h * L + l];
        const S base = (S(g.length) - hpos) - S(hlen * 0.5f);
        bool done = !exists, found = false;
        int wstar = -1;
        S cdel_st = 0.0f, cur = base;
        for (int q = 0; q < d.W && !done; ++q) {
          const int wl2 = route_at(sc.inj, sc.emit, hrid, hridx + 1 + q, d);
          const bool ex = wl2 >= 0;
          const int wc = clampL(wl2);
          const bool w_macro = ex && sc.macro_at(wc);
          if (ex && !w_macro && s.count[wc] > 0) {
            wstar = wl2; cdel_st = detached(cur); found = true; done = true;
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
        auto sig_at = [&](int j) {
          return j >= 0 ? s.sig[clampL(j)] : S(0.0f);
        };
        fsig = c_sc * sig_at(curr_l);
        fsig = fsig + (prev_exist ? p_sc * sig_at(prev_l) : S(0.0f));
        fsig = fsig + (next_exist ? n_sc * sig_at(next_l) : S(0.0f));
        blend = exists;
      }
      s.sig_term[slot * L + l] = blend ? (double)val(fsig) : 0.0;
    }
    {
      // the warp's blend count (exact in any order)
      int nb = blend ? 1 : 0;
      for (int off = WARP / 2; off > 0; off >>= 1)
        nb += __shfl_down_sync(FULL_MASK, nb, off);
      if (wl == 0) s.part_blend[slot * MAX_WARPS + warp] = nb;
    }
    if (red) {
      CONVERGE();
      bar_arrive(BAR_B + slot, NB);
      bar_sync(BAR_LANES, NT);
      SP_STAMP(SP_B);
      // only the soft blend reads the mean within the step
      if (soft_mode && waits_sig) bar_sync(BAR_SIG, WARP * (n_sig + 1));
    } else {
      __syncthreads();
      SP_STAMP(SP_B);
      if (threadIdx.x == 0) signal_mean(slot);
      if (soft_mode) __syncthreads();
    }
    SP_STAMP(SP_SIGNAL_MEAN);

    // ================= C: physics =======================================
    float lane_wave = 0.0f;
    if (lane) {
      SP_LANE_BEGIN();
      if (g.is_macro) {
        lane_wave = godunov_known<S>(st, g, l, C, gh, k, u_cells, n_known);
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
      SP_LANE_END(l);
    }
    lane_sync();
    SP_STAMP(SP_C);

    // ================= D1: conversion requests ==========================
    Request<S> rq;
    if (lane) rq = request<S>(st, s, sc, g, d, k, l, mnext_t, last);
    lane_sync();
    SP_STAMP(SP_D1);

    // ================= D2: arbitration (pull, lowest source id) =========
    if (lane) arbitrate(s, sc, L, K, l);
    lane_sync();
    SP_STAMP(SP_D2);

    // ================= D3: verdicts, removals, inserts, deposits ========
    WarpPart wp{{0, 0, 0, 0, 0}, 0.0f};
    n_known = 0;
    if (lane) {
      const Verdict vd = convert<S>(st, s, sc, g, rq, d, k, l);
      // static running-mean partial sums of this lane, after the
      // conversion; the cells' speeds serve the queue and the next step
      Smem<S> sv = s;
      sv.red_sum = s.red_sum + slot * 2 * L;
      sv.red_cnt = s.red_cnt + slot * 2 * L;
      static_partials<S>(st, sv, g, L, l, vd.n, k, u_cells);
      if (g.is_macro) n_known = min(g.num_cell, C);
      wp = WarpPart{{g.is_macro ? g.num_cell : 0, g.is_macro ? 0 : vd.n,
                     ev_inj, vd.is_emit ? 1 : 0,
                     (vd.exit_none || vd.dep_win) ? 1 : 0},
                    lane_wave};
    }
    for (int off = WARP / 2; off > 0; off >>= 1) {
      const WarpPart u = shfl_down_words(wp, off);
      for (int q = 0; q < 5; ++q) wp.n[q] += u.n[q];
      wp.wave = max_of(wp.wave, u.wave);
    }
    if (wl == 0) s.part[slot * MAX_WARPS + warp] = wp;
    if (red) {
      CONVERGE();
      bar_arrive(BAR_D3 + slot, NB);
      // the soft mean's release also tells that every lane is past D3
      if (soft_mode) {
        SP_STAMP(SP_D3);
        bar_sync(BAR_STAT, NB);
      } else {
        bar_sync(BAR_LANES, NT);
        SP_STAMP(SP_D3);
      }
    } else {
      __syncthreads();
      SP_STAMP(SP_D3);
      if (threadIdx.x == 0) static_mean(slot);
      // only the soft queue gates read the mean
      if (soft_mode) __syncthreads();
    }
    SP_STAMP(SP_STATIC_MEAN);

    // ================= E: the queue of this lane =========================
    if (lane) {
      const S q = lane_queue<S>(st, g, l, st.count[l], d.mode,
                                soft_mode ? s.ms[1] : 0.0f, k, u_cells);
      s.red_q[slot * L + l] = q * q;
    }
    if (red) {
      // the next step's A reads and writes nothing a slower lane's E
      // still reads: no barrier
      CONVERGE();
      bar_arrive(BAR_E + slot, NB);
      SP_STAMP(SP_E);
    } else {
      __syncthreads();
      SP_STAMP(SP_E);
      // the next step's A reads and writes none of what this reads, so the
      // other lanes go on meanwhile
      if (threadIdx.x == 0) step_outputs(slot, t);
    }
    SP_STAMP(SP_FINAL);
  }

  // the carry back to its rows
  __syncthreads();
  if (dual && reduces) p.grad[e] = grad;
  if (carry) {
    for (int i = threadIdx.x; i < o.fsize; i += NTH) Fg[i] = F[i];
    for (int i = threadIdx.x; i < o.isize; i += NTH) Ig[i] = I[i];
    if (dual) {
      for (int i = threadIdx.x; i < o.amax; i += NTH) Dg[i] = D[i];
      for (int i = threadIdx.x; i < KL; i += NTH) Dg[o.cap + i] = Dcap[i];
    }
  }
  if (!reducer) SP_STAMP(SP_PROLOGUE);
  SP_CLOCK_END(threadIdx.x == 0 ? n_steps : 0);
}

// The forward's kernel, and the derivative's with at most DUAL_REGS
// registers a thread: two of its blocks of up to 6 warps (the 3x3 preset's
// 144 lanes and the reduction warp) then share an SM, as its grid of more
// than one wave needs (B = 4: 180 blocks; an SM quarter's 16,384
// registers hold three warps of 168, and at 183 the occupancy call gives
// one block an SM).
constexpr int DUAL_REGS = 168;
__global__ void spatial_step_kernel(Ptrs p, Dims d, Consts k, int t0,
                                    int n_steps, int carry, int red) {
  spatial_steps<float>(p, d, k, t0, n_steps, carry, red);
}
__global__ void
#ifndef DHTS_CPU_EMULATION
__maxnreg__(DUAL_REGS)
#endif
spatial_step_dual_kernel(Ptrs p, Dims d, Consts k, int t0, int n_steps,
                         int carry, int red) {
  spatial_steps<Dual>(p, d, k, t0, n_steps, carry, red);
}
template <class S>
constexpr auto kernel_of() {
  if constexpr (sizeof(S) == sizeof(float))
    return spatial_step_kernel;
  else
    return spatial_step_dual_kernel;
}
// Both bounded to a block of MAX_WARPS warps (at most 64 registers a
// thread), for the scenes with more lane warps than the registers of the
// kernels above let one block hold (the 5x5 grid's 448 threads, the 7x7
// grid's 832); launch() takes them there only.
template <class S>
__global__ void
#ifndef DHTS_CPU_EMULATION
__launch_bounds__(MAX_WARPS * WARP)
#endif
spatial_step_bounded_kernel(Ptrs p, Dims d, Consts k, int t0, int n_steps,
                            int carry, int red) {
  spatial_steps<S>(p, d, k, t0, n_steps, carry, red);
}

// the most dynamic shared memory a block may take (the card's opt-in
// limit), and a smaller cap set for tests (< 0: none); whether a block
// may take a reduction warp (tests turn it off)
long long smem_cap = -1;
int reduction_warp = 1;

// One launch of n_steps steps from step t0: forward (S = float, B blocks)
// or derivative (S = Dual, B * n_act blocks). The carry goes to shared
// memory if it fits and the grid then still runs in one wave of blocks,
// else it stays in global memory.
template <class S>
int launch(int blocks, const Ptrs& p, const Dims& d, const Consts& k,
           int t0, int n_steps, void* stream) {
  if (d.L < 1 || d.L > MAX_WARPS * WARP || d.C < 1 || d.C > MAXC ||
      d.V < 1 || d.R < 1 || d.K < 1 || d.mode < HARD || d.mode > 1 ||
      blocks < 1 || t0 < 0 || n_steps < 0 || t0 + n_steps > d.T)
    return 1;  // cudaErrorInvalidValue
  if (n_steps == 0) return 0;
  const size_t lean = smem_bytes<S>(d, nullptr, nullptr, false);
  const size_t full = smem_bytes<S>(d, nullptr, nullptr, true);
  // the lane warps, and a reduction warp where a block may hold one more
  const int lanes = ((d.L + WARP - 1) / WARP) * WARP;
  const int red = reduction_warp && lanes + WARP <= MAX_WARPS * WARP;
  const int threads = lanes + (red ? WARP : 0);
#ifdef DHTS_CPU_EMULATION
  constexpr auto kernel = kernel_of<S>();
  (void)stream;
  const int carry = smem_cap < 0 || (long long)full <= smem_cap;
  dhts_emu::launch(blocks, threads, carry ? full : lean, kernel, p, d, k,
                   t0, n_steps, carry, red);
  return 0;
#else
  static int sms = 0, optin = 0, max_threads = 0;
  cudaError_t err;
  if (!sms) {
    int dev;
    cudaFuncAttributes attr;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
            cudaSuccess ||
        (err = cudaFuncGetAttributes(&attr, kernel_of<S>())) != cudaSuccess)
      return (int)err;
    max_threads = attr.maxThreadsPerBlock;
  }
  // the block's threads beyond what the unbounded kernel's registers
  // allow: the bounded kernel
  const auto kernel = threads <= max_threads
                          ? kernel_of<S>()
                          : &spatial_step_bounded_kernel<S>;
  const long long cap = smem_cap < 0 ? optin : smem_cap;
  // the last choice, kept for calls of the same shapes
  static long long last_key[4] = {-1, 0, 0, 0};
  static int last_carry = 0;
  const long long key[4] = {(long long)full, threads, blocks, cap};
  bool same = true;
  for (int i = 0; i < 4; ++i) same = same && key[i] == last_key[i];
  int carry = last_carry;
  if (!same) {
    int per_sm = 0;
    if ((long long)full <= cap) {
      if ((err = cudaFuncSetAttribute(
               kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
               (int)full)) != cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, kernel, threads, full)) != cudaSuccess)
        return (int)err;
    }
    carry = per_sm > 0 && per_sm * sms >= blocks;
    for (int i = 0; i < 4; ++i) last_key[i] = key[i];
    last_carry = carry;
  }
  const size_t smem = carry ? full : lean;
  if ((err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(p, d, k, t0,
                                                          n_steps, carry, red);
  return (int)cudaGetLastError();
#endif
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of the forward (tangent = 0) or the
// derivative (tangent = 1) at L lanes without the carry (bytes).
size_t itscp_spatial_step_smem(int L, int tangent) {
  Dims d{};
  d.L = L;
  return tangent ? smem_bytes<Dual>(d, nullptr, nullptr, false)
                 : smem_bytes<float>(d, nullptr, nullptr, false);
}

// The same with the carry of L lanes, C cells, V vehicles and K capacitor
// slots in shared memory (bytes).
size_t itscp_spatial_step_smem_carry(int L, int C, int V, int K,
                                     int tangent) {
  Dims d{};
  d.L = L; d.C = C; d.V = V; d.K = K;
  return tangent ? smem_bytes<Dual>(d, nullptr, nullptr, true)
                 : smem_bytes<float>(d, nullptr, nullptr, true);
}

// Caps the shared memory a launch may take for the carry at `bytes` (< 0:
// the card's limit; 0: the carry stays in global memory). For tests.
void itscp_spatial_step_set_smem_cap(long long bytes) { smem_cap = bytes; }

// Whether a block may take a reduction warp (1, the default) or reduces
// in thread 0 between barriers (0, as beyond 992 lanes). For tests.
void itscp_spatial_step_set_reduction_warp(int on) { reduction_warp = on; }

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

// The kernel's registers a thread, local (stack) bytes a thread, and the
// blocks an SM holds with the carry in shared memory and without, at L
// lanes, C cells, V vehicles and K capacitor slots, into out[0..3]
// (forward: tangent = 0; derivative: 1); zeros in the host build. Returns
// the CUDA error code.
int itscp_spatial_step_kernel_info(int L, int C, int V, int K, int tangent,
                                   int* out) {
  for (int i = 0; i < 4; ++i) out[i] = 0;
#ifdef DHTS_CPU_EMULATION
  (void)L; (void)C; (void)V; (void)K; (void)tangent;
  return 0;
#else
  Dims d{};
  d.L = L; d.C = C; d.V = V; d.K = K;
  const void* fn = tangent ? (const void*)spatial_step_dual_kernel
                           : (const void*)spatial_step_kernel;
  const size_t full = tangent ? smem_bytes<Dual>(d, nullptr, nullptr, true)
                              : smem_bytes<float>(d, nullptr, nullptr, true);
  const size_t lean = tangent
                          ? smem_bytes<Dual>(d, nullptr, nullptr, false)
                          : smem_bytes<float>(d, nullptr, nullptr, false);
  const int lanes = ((L + WARP - 1) / WARP) * WARP;
  const int threads = lanes + (lanes + WARP <= MAX_WARPS * WARP ? WARP : 0);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  const size_t sizes[2] = {full, lean};
  for (int i = 0; i < 2; ++i) {
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizes[i]);
    if (err != cudaSuccess) {
      cudaGetLastError();
      continue;  // does not fit: 0 blocks
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2 + i], fn,
                                                        threads, sizes[i]);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
#endif
}

#ifdef DHTS_STEP_CLOCK
// Each lane's own cycles in C summed since the last reset (block 0),
// lane_c_cycles[0..L), into host memory `out`; `reset` zeroes them first
// instead. Returns the CUDA error code.
int itscp_spatial_step_clock_lanes(long long* out, int L, int reset) {
#ifdef DHTS_CPU_EMULATION
  for (int i = 0; i < L; ++i) {
    if (reset) lane_c_cycles[i] = 0;
    out[i] = lane_c_cycles[i];
  }
  return 0;
#else
  if (reset) {
    long long zero[1024] = {};
    const cudaError_t err = cudaMemcpyToSymbol(lane_c_cycles, zero,
                                               sizeof(long long) * L);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaMemcpyFromSymbol(out, lane_c_cycles,
                                   sizeof(long long) * L);
#endif
}

// The cycle stamps summed since the last reset, step_cycles[SP_PARTS + 1]
// (the parts of StepPart, then the steps stamped), into host memory `out`;
// `reset` zeroes them first instead. Returns the CUDA error code.
int itscp_spatial_step_clock(long long* out, int reset) {
#ifdef DHTS_CPU_EMULATION
  for (int i = 0; i <= SP_PARTS; ++i) {
    if (reset) step_cycles[i] = 0;
    out[i] = step_cycles[i];
  }
  return 0;
#else
  if (reset) {
    const long long zero[SP_PARTS + 1] = {};
    const cudaError_t err =
        cudaMemcpyToSymbol(step_cycles, zero, sizeof(zero));
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaMemcpyFromSymbol(out, step_cycles,
                                   sizeof(long long) * (SP_PARTS + 1));
#endif
}
#endif

}  // extern "C"
