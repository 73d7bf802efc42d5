// The fused spatial ITSCP step with the lanes sharded, for Hopper (sm_90a):
// one kernel per per-shard body, a forward in hard or soft gate mode and a
// forward-mode derivative of the differentiable bodies.
//
// Replaces the TPU kernels K6 and K5 of dhts/ops/pallas/itscp_spatial_step.py
// on a lane axis of more than one shard: body_A (:279), body_B (:302),
// body_C (:440), body_D1 (:544), body_D2 (:592), body_D3 (:621) and body_E
// (:847), wrapped at :883-919 by make_dkernel (A, B, C, D3, E;
// dhts/ops/pallas/dkernel.py: forward pallas_call at :63, backward at :91)
// and make_kernel_sg (D1, D2; :154). D3's launch does the work of D1, D2
// and D3, and of the next step's A (below): A launches once an episode,
// for step 0. A further kernel, Q, does body_E's lane
// sum of q^2 (:861-865) once per episode over the gathered rows, and in a
// derivative the loss weights' sum over the steps. The specification is the plain PyTorch
// bodies beside the wrapper (dhts_torch/ops/cuda/itscp_spatial_shard.py::
// plain_body_A ... plain_body_E; D3's is plain_body_D, the composition of
// plain_body_D1, _D2 and _D3): every per-lane value is computed with the
// same IEEE operations in the same order (-fmad=false, no fast math), so
// carries, summaries and events agree bit for bit.
//
// Design. This is the single-shard STEP kernel (itscp_spatial_step.cu) with
// each barrier at which one lane reads another's summary replaced by a
// kernel boundary and a collective over the lane axis. One launch is one
// body of one simulation step: one block per episode (forward) or per
// (episode, action entry) (derivative, `Dual`), one thread per local lane
// (C: SPLIT where it fits, below).
// A shard holds lanes [off, off + n) of the scene; its carry stays in global
// memory, packed as the STEP kernel packs it at n lanes. What other lanes
// read goes out as the shard's summary rows [rows, n] and comes back
// gathered, [rows, L], indexed directly by the global lane id (no one-hot
// products, no padding). The per-lane phases are those of itscp_step.cuh,
// called with the global lane id: the shard's carry pointers are shifted by
// -off, so `st.count[l]` and `st.vi(l, v)` of a global id l address the
// local lane l - off, while route ids and arbitration compare global ids.
//
// Sums: the signal and static running means and the queue are summed from
// per-lane terms gathered over the lane axis in float64 and rounded once,
// as the STEP kernel sums them in lane order, so the sharded episode equals
// the single-shard one bit for bit at any shard count. C and E fold their
// mean in a reduction warp beside the lane warps (warp_fold: the warp loads
// the terms, one thread adds them in lane order), so a shard holds at most
// MAX_LANES lanes. In hard mode the signal mean sharpens nothing, and a
// split lane axis does not gather its terms (C then leaves it as it is), as
// JAX's sharded step; nothing waits for E's static mean in hard mode.
//
// The conversion needs no collective between C's gathered rows and its
// verdicts: JAX splits it into D1 (each source's wants), a gather, D2 (each
// destination's lowest wanting predecessor), a gather and D3 to keep its
// one-hot gathers at O(L l_loc) a device, but on the card a load is
// indexed. D3's block computes every lane's wants from the gathered rows
// into a table in shared memory, and each lane arbitrates at the three
// lanes it reads a verdict of (its own, its next lane, its head's next).
//
// A reads only its own lane's carry, and D3 is the last body of a step that
// writes a lane's carry (E writes only the static mean), by the lane's own
// thread: so D3 of step t ends with each lane writing step t + 1's A rows
// from the carry its conversion left, with step t + 1's draw and schedule,
// by A's own operations (a_rows), and the wrapper gathers them with D3's
// static-mean terms in one collective. A step from step 1 on is four
// launches (B, C, D3, E).
//
// C spreads a lane over SPLIT threads where it fits (one Riemann solve or
// a few vehicles a thread, the fluxes handed on by shuffles): a macro
// lane's serial Godunov update set its launch before. B and D3 share
// nothing in the block: each lane computes the signals it reads in
// registers (a table of every lane's signal took a third of B), loads
// what it reads ahead of its use, and the forward's counts are a
// barrier's count (thread 0 added them after a barrier before).
//
// Bound. Each launch moves the shard's share of a step's state (the macro
// cells, the vehicles present, the counters) and the gathered rows, a few
// KB per episode, through short chains of dependent loads: latency-bound,
// far above the bytes / 3.35 TB/s floor. Q (below) is bound by its bytes.

#include <vector>

#include "itscp_step.cuh"

namespace {

struct ShardArgs {
  float* fbuf;  // [N, fsize(n)] the shard's carry, values
  float* dbuf;  // [N, fsize(n)] tangents (derivative only)
  int* ibuf;    // [N, isize(n)]
  const float* action;  // [n_phases, n_inter]
  const float* rand;    // [B, T, L]
  const float* sched;   // [T, L]
  const int* mnext;     // [T, L]
  const int* mprev;     // [T, L]
  const int* routes;    // [L * P + L * P2, R]
  const float* prog;    // [nsf]
  const int* lane_i;    // [8 + 2K, L]
  const float* lane_f;  // [2, L]
  float* sumA_v;        // A: [N, 9, n] summary rows (and tangents)
  float* sumA_d;
  const float* gA_v;    // B: [N, 9, L] gathered
  const float* gA_d;
  float* bc_v;          // B -> C: [N, 10, n]
  float* bc_d;
  float* sg;            // B: [N, 2, n] signal-mean terms
  int* events;          // B, D3: [N, T, 3] the shard's partial counts
  const float* gsg;     // C: [N, 2, L]
  float* sumF_v;        // C: [N, 15, n]
  float* sumF_d;
  int* sumI;            // C: [N, 4, n]
  float* waves;         // C: [N, T] the shard's largest wave speed
  const float* gF_v;    // D3: [N, 15, L]
  const float* gF_d;
  const int* gI;        // D3: [N, 4, L]
  double* ss;           // D3: [N, 2, n] static-mean terms
  int* ssn;             // D3: [N, 2, n] their counts
  const double* gss;    // E: [N, 2, L]
  const int* gssn;      // E: [N, 2, L]
  float* q_v;           // E: [N, T, n] the lanes' squared queues
  float* q_d;
  const float* gq;      // Q: [N, T, L] gathered q_v (q_d in a derivative)
  float* queues;        // Q: [N, T] (a derivative: the queues' tangents)
  const float* q_weight;  // Q derivative: [B, T] the loss weights
  double* grad;         // Q derivative: [N]
  int* q_count;         // Q derivative: [N] tiles done, 0 between launches
  int N, t, off, n;
  Dims d;
  Consts k;
};

constexpr int A_ROWS = 9, BC_ROWS = 10, F_ROWS = 15, I_ROWS = 4;
enum { F_RLAST, F_ULAST, F_COUNT, F_TPOS, F_TLEN, F_CAP, F_HPOS, F_HVEL,
       F_HLEN, F_HA, F_AMAX };
enum { I_MN, I_RIDX, I_HNEXT, I_RID };
enum { BODY_A, BODY_B, BODY_C, BODY_D3, BODY_E, BODY_Q };
// Q's block: Q_THREADS threads load a tile of up to Q_TILE steps of a row,
// [steps, L] floats at a row stride of L | 1 floats in shared memory (odd:
// the tile's threads, one per step, read a lane's column from distinct
// banks), within the 48 KB a block takes without opting in.
constexpr int Q_THREADS = 128, Q_TILE = 32, Q_SMEM = 48 * 1024;
__host__ __device__ inline int q_stride(int L) { return L | 1; }
__host__ __device__ inline int q_tile(int L) {
  const int k = Q_SMEM / (4 * q_stride(L));
  return k < 1 ? 1 : (k < Q_TILE ? k : Q_TILE);
}
__host__ __device__ inline int q_tiles(int T, int L) {
  return (T + q_tile(L) - 1) / q_tile(L);
}

// offsets of the packed carry of n lanes (float_layout / int_layout of the
// wrapper at the shard's lanes)
struct Layout {
  int r, y, pos, vel, av, amax, apref, vt, ms, tp, len, cap, sg, ss, fsize;
  int count, rid, ridx, inj_left, cursor, isize;
};

__host__ __device__ inline Layout layout(const Dims& d, int n) {
  const int CL = d.C * n, VL = d.V * n, KL = d.K * n;
  Layout o;
  o.r = 0; o.y = CL; o.pos = 2 * CL; o.vel = o.pos + VL; o.av = o.vel + VL;
  o.amax = o.av + VL; o.apref = o.amax + VL; o.vt = o.apref + VL;
  o.ms = o.vt + VL; o.tp = o.ms + VL; o.len = o.tp + VL;
  o.cap = o.len + VL; o.sg = o.cap + KL; o.ss = o.sg + 2;
  o.fsize = o.ss + 2;
  o.count = 0; o.rid = n; o.ridx = n + VL; o.inj_left = n + 2 * VL;
  o.cursor = 2 * n + 2 * VL; o.isize = 3 * n + 2 * VL;
  return o;
}

template <class S>
__device__ __forceinline__ S from_parts(float v, const float* d, size_t i);
template <>
__device__ __forceinline__ float from_parts<float>(float v, const float*,
                                                   size_t) {
  return v;
}
template <>
__device__ __forceinline__ Dual from_parts<Dual>(float v, const float* d,
                                                 size_t i) {
  return Dual(v, d[i]);
}

// a gathered float row read as S (values, and tangents in a derivative)
template <class S>
struct RowS {
  const float* v;
  const float* d;
  __device__ S operator[](int i) const { return from_parts<S>(v[i], d, i); }
};

__device__ __forceinline__ void put_row(float* v, float*, size_t i,
                                        float x) {
  v[i] = x;
}
__device__ __forceinline__ void put_row(float* v, float* d, size_t i,
                                        Dual x) {
  v[i] = x.v;
  d[i] = x.d;
}

// An arbitration verdict (best or dep_best) at the three lanes convert
// reads it at (the lane's own, its next lane's and its head's next
// lane's), computed before convert's first store
struct Picked {
  int at[3], v[3];
  __device__ int operator[](int i) const {
    return i == at[0] ? v[0] : (i == at[1] ? v[1] : v[2]);
  }
};

// what convert() reads of the gathered rows (the STEP kernel's shared
// summaries)
template <class S>
struct ConvRows {
  Picked best, dep_best;
  RowS<S> u_last, cap_val, hs_pos, hs_vel, hs_a;
  const float *hs_len, *hs_par;  // hs_par: rows F_AMAX.. at stride L
  const int *hs_rid, *hs_ridx;
};

// where static_partials() writes a lane's static-mean terms
struct TermRows {
  double* red_sum;
  int* red_cnt;
};

// One block's view of its episode: the carry of its shard, addressed by
// global lane id.
template <class S>
struct Block {
  int e, b, seed, j, gl;
  bool lane, dual;
  Layout o;
  float *F, *D;
  int* I;
  LaneState<S, FA, true> st;
  Scene sc;
  LaneGeom g;
};

template <class S>
__device__ __forceinline__ Block<S> block_of(const ShardArgs& a) {
  const Dims& d = a.d;
  Block<S> k;
  k.e = blockIdx.x;
  k.j = threadIdx.x;
  k.lane = k.j < a.n;
  k.gl = a.off + k.j;
  k.dual = a.dbuf != nullptr;
  const int n_act = d.n_phases * d.n_inter;
  k.b = k.dual ? k.e / n_act : k.e;
  k.seed = k.dual ? k.e % n_act : -1;
  k.o = layout(d, a.n);
  const Layout& o = k.o;
  k.F = a.fbuf + (size_t)k.e * o.fsize;
  k.D = k.dual ? a.dbuf + (size_t)k.e * o.fsize : nullptr;
  k.I = a.ibuf + (size_t)k.e * o.isize;
  const int off = a.off, n = a.n;
  float* F = k.F;
  float* D = k.D;
  auto fa = [&](int f) {
    return FA{F + f - off, D ? D + f - off : nullptr};
  };
  k.st = LaneState<S, FA, true>{
      fa(o.r), fa(o.y), fa(o.pos), fa(o.vel), fa(o.av), fa(o.cap),
      {F + o.amax - off, F + o.apref - off, F + o.vt - off, F + o.ms - off,
       F + o.tp - off, F + o.len - off},
      k.I + o.rid - off, k.I + o.ridx - off, k.I + o.count - off,
      k.I + o.inj_left - off, k.I + o.cursor - off, 1, n, 1, n, 1, n};
  set_defaults(k.st, a.k);
  k.sc = Scene{a.lane_i, a.lane_f, a.routes, a.routes + d.L * d.P * d.R};
  k.g = k.lane ? lane_geom(k.sc, d.L, d.K, k.gl) : LaneGeom();
  return k;
}

// block_of for lane j of a block of G threads a lane (C's split)
template <class S>
__device__ __forceinline__ Block<S> lane_block_of(const ShardArgs& a,
                                                  int j) {
  Block<S> k = block_of<S>(a);
  k.j = j;
  k.lane = j < a.n;
  k.gl = a.off + j;
  k.g = k.lane ? lane_geom(k.sc, a.d.L, a.d.K, k.gl) : LaneGeom();
  return k;
}

// Cycle stamps (a build with -DDHTS_SHARD_CLOCK; python -m
// dhts_torch.ops.cuda.shard_clock): in block 0, the thread that does a
// part adds the cycles it took to shard_cycles[part]: the fold of a
// running mean (the thread that folds it), and on thread 0's path its
// set-up (and any wait for the fold before its lane starts), its lane's
// update (with any wait between the kinds), the rows out, its wait for the
// other lanes and the wave maximum (C); its way to its gates (set-up,
// first cells, any wait), its lane's queue and the store (E); and each
// kernel's whole launch. In B and D3 the parts are those of the path of
// local lane shard_clock_lane's thread (0 unless the host sets it):
// block set-up, the signals, the injection and the ghosts, the head's
// blend, the leader walk, the rows out and the injection count with any
// wait for the other lanes (B); set-up, its share of the want table, the
// wait at the table's barrier, the arbitration, convert, static_partials,
// the next step's A rows (their loads and arithmetic, which the unstamped
// build issues ahead of static_partials', and their stores after it) and
// the emit and absorb counts with any wait (D3). Each lane's first
// thread in block 0 adds its lane's own cycles to shard_lane_cycles[local
// lane]: its update's in C (Godunov, or the blend and IDM, after any
// wait), its whole path before the count in B and D3. The last four counts
// are the C, E, B and D3 launches stamped. Without the macro the stamps
// compile to nothing.
enum ShardPart {
  SH_C_FOLD, SH_C_WAIT, SH_C_LANE, SH_C_ROWS, SH_C_END_WAIT, SH_C_WAVE,
  SH_C_TOTAL, SH_E_FOLD, SH_E_WAIT, SH_E_QUEUE, SH_E_STORE, SH_E_TOTAL,
  SH_B_SETUP, SH_B_SIGNALS, SH_B_GHOSTS, SH_B_BLEND, SH_B_WALK, SH_B_ROWS,
  SH_B_COUNT, SH_B_TOTAL, SH_D3_SETUP, SH_D3_TABLE, SH_D3_WAIT,
  SH_D3_ARBITRATE, SH_D3_CONVERT, SH_D3_STATIC, SH_D3_NEXT_A, SH_D3_COUNT,
  SH_D3_TOTAL,
  SH_PARTS
};
// the launches stamped, after the parts
enum ShardLaunch { SH_N_C, SH_N_E, SH_N_B, SH_N_D3, SH_LAUNCHES };
#ifdef DHTS_SHARD_CLOCK
__device__ long long shard_cycles[SH_PARTS + SH_LAUNCHES];
__device__ long long shard_lane_cycles[1024];
__device__ int shard_clock_lane;  // B's and D3's stamping lane
// the SM's clock, read by a volatile asm with a memory clobber: the
// compiler keeps it in order with the barriers
__device__ __forceinline__ long long sh_now() {
#ifdef DHTS_CPU_EMULATION
  return clock64();
#else
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
#endif
}
#define SH_CLOCK(...) __VA_ARGS__
// the cycles since `t` into `part`, and `t` moved to now, where `who`
#define SH_ADD(who, part, t)                        \
  do {                                              \
    if ((who) && blockIdx.x == 0) {                 \
      const long long sh_t = sh_now();              \
      shard_cycles[part] += sh_t - (t);             \
      (t) = sh_t;                                   \
    }                                               \
  } while (0)
#else
#define SH_CLOCK(...)
#define SH_ADD(who, part, t) (void)0
#endif

// ---------------------------------------------------------------------------
// C's and E's block: the lane warps and a reduction warp behind them
// ---------------------------------------------------------------------------

constexpr int WARP = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / WARP;
// a shard's lanes: one thread each and the reduction warp in one block
constexpr int MAX_LANES = MAX_THREADS - WARP;
// C's threads a lane where its Godunov interfaces (C + 1) and its vehicles
// (up to SPLIT_VEH each) spread over them
constexpr int SPLIT = 8, SPLIT_VEH = 4;  // SPLIT_VEH even
// named barrier (0 is __syncthreads): the soft running mean's release (the
// reduction warp arrives, the lane warps wait)
constexpr int BAR_MEAN = 1;

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

// How a launch of C or E lays out its block: G threads a lane (C: 1 or
// SPLIT), `lanes` threads for the lanes (n G rounded up to whole warps),
// and with `red` a reduction warp behind them that folds the running mean.
struct Geo {
  int G, lanes, red;
};

__device__ __forceinline__ float shfl_down_w(float x, int o, int w) {
  return __shfl_down_sync(FULL_MASK, x, o, w);
}
__device__ __forceinline__ Dual shfl_down_w(Dual x, int o, int w) {
  return Dual(__shfl_down_sync(FULL_MASK, x.v, o, w),
              __shfl_down_sync(FULL_MASK, x.d, o, w));
}

// K float64 sums and K integer counts of a fold
template <int K>
struct Fold {
  double s[K];
  int n[K];
};

// K float64 sums over the terms j = 0 .. n - 1, each as the plain version
// adds it, ((0 + x_0) + x_1) + ... in index order, rounded once, and K
// integer counts, by one warp; the results in its lane 0. `get(j, x, c)`
// gives term j of each sum and of each count. Each lane loads the terms j
// = lane, lane + 32, ... (four rounds of loads in flight) and stages them
// in `stage` ([K][n]); the counts go by a shuffle tree (exact in any
// order); lane 0 adds the staged terms in index order, the loads of 8
// terms ahead of their adds.
template <int K, class Get>
__device__ __forceinline__ Fold<K> warp_fold(int n, Get get, double* stage,
                                             int wl) {
  constexpr int U = 4;
  int cnt[K];
#pragma unroll
  for (int k = 0; k < K; ++k) cnt[k] = 0;
  for (int j0 = 0; j0 < n; j0 += U * WARP) {
    double x[U][K];
    int c[U][K];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * WARP + wl;
      if (j < n) get(j, x[u], c[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * WARP + wl;
      if (j >= n) continue;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        stage[k * n + j] = x[u][k];
        cnt[k] += c[u][k];
      }
    }
  }
  for (int o = WARP / 2; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < K; ++k)
      cnt[k] += __shfl_down_sync(FULL_MASK, cnt[k], o);
  __syncwarp();  // the staged terms, for lane 0's chain
  Fold<K> f;
  if (wl != 0) return f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    f.n[k] = cnt[k];
    f.s[k] = 0.0;
  }
  int j = 0;
  for (; j + 8 <= n; j += 8) {
    double v[8][K];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < K; ++k) v[i][k] = stage[k * n + j + i];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < K; ++k) f.s[k] += v[i][k];
  }
  for (; j < n; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) f.s[k] += stage[k * n + j];
  return f;
}

// ======================= A: pre-physics summary ==========================
// A lane's 9 rows of body_A for step t from its carry as it stands: its
// first and last cell (density, speed), its vehicle count, its tail's
// position, speed and length, and its injection bit (step t's draw and
// schedule). shard_A writes step 0's; from step 1 on, D3 of step t - 1
// writes step t's (below), from the carry its conversion left: no step
// changes a lane's carry between its D3 and the next step's A.
template <class S>
struct ARows {
  S r[A_ROWS];
};

template <class S>
__device__ __forceinline__ ARows<S> a_rows(const ShardArgs& a,
                                           const Block<S>& k, int t) {
  const Dims& d = a.d;
  const Consts& c = a.k;
  const int L = d.L, gl = k.gl;
  const auto& st = k.st;
  const LaneGeom& g = k.g;
  const int last = min(max(g.num_cell - 1, 0), d.C - 1);
  const float incoming = g.has_prev ? -1.0f : a.sched[t * L + gl];
  const S rf = ld<S>(st.r, st.ci(gl, 0)), rl = ld<S>(st.r, st.ci(gl, last));
  const S uf = comp_u(rf, ld<S>(st.y, st.ci(gl, 0)), c.u_max);
  const S ul = comp_u(rl, ld<S>(st.y, st.ci(gl, last)), c.u_max);
  const int cnt = st.count[gl];
  const int i0 = st.vi(gl, 0);
  const float free_sp =
      cnt > 0 ? val(ld<S>(st.pos, i0)) - 0.5f * st.param(5, i0) : g.length;
  const float draw = a.rand[((size_t)k.b * d.T + t) * L + gl];
  const bool inj = !g.has_prev && !g.is_macro &&
                   (free_sp > 0.5f * c.veh_len) && (draw < incoming) &&
                   (st.inj_left[gl] > 0) && (cnt < d.V);
  return ARows<S>{{rf, uf, rl, ul, S((float)cnt), ld<S>(st.pos, i0),
                   ld<S>(st.vel, i0), S(st.param(5, i0)),
                   S(inj ? 1.0f : 0.0f)}};
}

template <class S>
__device__ __forceinline__ void put_a_rows(const ShardArgs& a,
                                           const Block<S>& k,
                                           const ARows<S>& rows) {
  const size_t base = (size_t)k.e * A_ROWS * a.n + k.j;
  for (int r = 0; r < A_ROWS; ++r)
    put_row(a.sumA_v, a.sumA_d, base + (size_t)r * a.n, rows.r[r]);
}

// Step 0's rows, once an episode
template <class S>
__global__ void shard_A(ShardArgs a) {
  Block<S> k = block_of<S>(a);
  if (!k.lane) return;
  put_a_rows(a, k, a_rows(a, k, a.t));
}

// ============ B: injection, ghosts, leader walk, the head's signal =========
// One thread a lane. The signals B reads take their few distinct values
// from a table of 2 n_inter entries in shared memory, one per intersection
// and direction (lane_signal's gate; 1 for a lane no signal controls), which
// the block fills in one round before a barrier while each lane's first
// loads are in flight (a table of every lane's signal, L entries, took a
// third of B). Loads are issued ahead of what they wait for: the head's
// fields before the injection (which only shifts them, or puts the new
// vehicle at the head of an empty lane), the ghosts' gathered edge cells
// with the neighbour's kind, the leader walk's first lane (the head's
// next) with the blend's route lanes. The forward's injection count is a
// barrier's count (__syncthreads_count); the derivative counts nothing.
template <class S>
__global__ void shard_B(ShardArgs a) {
  DHTS_DYNAMIC_SMEM(smem_raw);
  const Dims& d = a.d;
  const Consts& c = a.k;
  const int L = d.L, V = d.V, n = a.n, t = a.t;
  SH_CLOCK(const bool clk = (int)threadIdx.x == shard_clock_lane;
           long long sh_t0 = sh_now(); long long sh_p = sh_t0;)
  S* sig_tbl = nullptr;
  size_t off_s = 0;
  carve(&sig_tbl, 2 * d.n_inter, smem_raw, off_s);
  Block<S> k = block_of<S>(a);
  SH_ADD(clk, SH_B_SETUP, sh_p);
  const Scene& sc = k.sc;
  auto clampL = [&](int q) { return min(max(q, 0), L - 1); };
  // lane q's signal: its intersection's and direction's gate
  auto signal_of = [&](int q) {
    const int* li = sc.lane_i;
    return li[2 * L + q] ? sig_tbl[2 * li[4 * L + q] + (li[3 * L + q] != 0)]
                         : S(1.0f);
  };
  const float* gv = a.gA_v + (size_t)k.e * A_ROWS * L;
  const float* gd = k.dual ? a.gA_d + (size_t)k.e * A_ROWS * L : nullptr;
  auto gA = [&](int r, int i) {
    return from_parts<S>(gv[r * L + i], gd, (size_t)r * L + i);
  };
  auto g_inj = [&](int i) { return gv[8 * L + i] > 0.5f; };
  auto g_count = [&](int i) {
    return (int)gv[4 * L + i] + (g_inj(i) ? 1 : 0);
  };
  const int gl = k.gl;
  const int mp = k.lane ? a.mprev[t * L + gl] : -1;
  const int mn = k.lane ? a.mnext[t * L + gl] : -1;
  // the head before this step's injection
  auto& st = k.st;
  const int cnt0 = k.lane ? st.count[gl] : 0;
  const int hi0 = st.vi(gl, min(max(cnt0 - 1, 0), V - 1));
  S hpos = 0.0f, hvel = 0.0f;
  float hlen = 0.0f;
  int hrid = -1, hridx = 0;
  if (k.lane) {
    hpos = ld<S>(st.pos, hi0);
    hvel = ld<S>(st.vel, hi0);
    hlen = st.par[5][hi0];
    hrid = st.rid[hi0];
    hridx = st.ridx[hi0];
  }
  const int threads = (n + WARP - 1) / WARP * WARP;  // the block's
  for (int i = threadIdx.x; i < 2 * d.n_inter; i += threads) {
    LaneGeom gi;
    gi.approaching = 1;
    gi.is_we = i & 1;
    gi.inter = i >> 1;
    sig_tbl[i] = lane_signal<S>(a.action, a.prog, d, c, gi, t, k.seed);
  }
  __syncthreads();
  SH_ADD(clk, SH_B_SIGNALS, sh_p);
  int injected = 0;
  if (k.lane) {
    const LaneGeom& g = k.g;
    const float incoming = g.has_prev ? -1.0f : a.sched[t * L + gl];
    // apply the injection of this lane's gathered bit; into an empty lane,
    // the new vehicle is the head
    if (g_inj(gl)) {
      const int pool_idx = min(max(d.P - st.inj_left[gl], 0), d.P - 1);
      st.insert_tail(gl, V, S(0.0f), S(0.0f), S(c.veh_len), nullptr,
                     gl * d.P + pool_idx, 0);
      st.count[gl] = cnt0 + 1;
      st.inj_left[gl] -= 1;
      injected = 1;
      if (cnt0 == 0) {
        hpos = 0.0f; hvel = 0.0f; hlen = st.dflt[5];
        hrid = gl * d.P + pool_idx; hridx = 0;
      }
    }

    // macro ghosts from the neighbours' gathered edge cells, and the
    // signal the left one sees
    const int adjp = g.num_prev == 1 ? g.prev0 : mp;
    const int adjp_c = clampL(adjp);
    const int adjn = g.num_next == 1 ? g.next0 : mn;
    const int adjn_c = clampL(adjn);
    const S l_r = gA(2, adjp_c), l_u = gA(3, adjp_c);
    const S r_r = gA(0, adjn_c), r_u = gA(1, adjn_c);
    const S prev_sig = !g.has_prev ? S(1.0f)
                       : (mp < 0 ? S(0.0f) : signal_of(clampL(mp)));
    const bool use_l =
        (g.num_prev > 0) && (adjp >= 0) && sc.macro_at(adjp_c);
    S gl_r = use_l ? l_r : S(0.0f);
    S gl_u = use_l ? l_u : S(c.u_max);
    if (!g.has_prev) { gl_r = incoming; gl_u = u_eq(S(incoming), c.u_max); }
    const S bl_r = gl_r * prev_sig;
    const S bl_u = gl_u * prev_sig + S(c.u_max) * (S(1.0f) - prev_sig);
    const bool use_r =
        (g.num_next > 0) && (adjn >= 0) && sc.macro_at(adjn_c);
    const S gr_r = use_r ? r_r : S(0.0f);
    const S gr_u = use_r ? r_u : S(c.u_max);
    SH_ADD(clk, SH_B_GHOSTS, sh_p);

    const bool exists = cnt0 + injected > 0;
    // the signal the head sees, blended over its previous, current and next
    // route lane
    const int prev_l = route_at(sc.inj, sc.emit, hrid, hridx - 1, d);
    const int next_l = route_at(sc.inj, sc.emit, hrid, hridx + 1, d);
    const int curr_l = route_at(sc.inj, sc.emit, hrid, hridx, d);
    const bool prev_exist = prev_l >= 0, next_exist = next_l >= 0;
    auto sig_at = [&](int q) {
      return q >= 0 ? signal_of(clampL(q)) : S(0.0f);
    };
    const S sig_c = sig_at(curr_l), sig_p = sig_at(prev_l),
            sig_n = sig_at(next_l);
    // the walk's first lane, the head's next, as the walk reads it
    const int w0 = clampL(next_l);
    const bool w0_macro = sc.macro_at(w0);
    const int w0_count = g_count(w0);
    const S red_pd = vmax((S(g.length) - hpos) - S(hlen * 0.5f), S(0.0f));
    S p_sc, c_sc, n_sc;
    if (d.mode != HARD) {
      p_sc = prev_exist ? soft(-hpos, 16.0f) : S(0.0f);
      c_sc = soft(hpos, 16.0f) * soft(S(g.length) - hpos, 16.0f);
      n_sc = next_exist ? soft(hpos - S(g.length), 16.0f) : S(0.0f);
    } else {
      p_sc = 0.0f; c_sc = 1.0f; n_sc = 0.0f;
    }
    const S ssum = (p_sc + c_sc) + n_sc;
    p_sc = p_sc / ssum; c_sc = c_sc / ssum; n_sc = n_sc / ssum;
    S fsig = c_sc * sig_c;
    fsig = fsig + (prev_exist ? p_sc * sig_p : S(0.0f));
    fsig = fsig + (next_exist ? n_sc * sig_n : S(0.0f));
    const bool blend = exists && !g.is_macro;
    SH_ADD(clk, SH_B_BLEND, sh_p);

    // virtual leader: walk the head vehicle's route over the gathered
    // counts and tails (after this step's injections)
    const S base = (S(g.length) - hpos) - S(hlen * 0.5f);
    bool done = !exists, found = false;
    int wstar = -1;
    S cdel_st = 0.0f, cur = base;
    for (int q = 0; q < d.W && !done; ++q) {
      const int wl = q == 0 ? next_l
                            : route_at(sc.inj, sc.emit, hrid, hridx + 1 + q,
                                       d);
      const bool ex = wl >= 0;
      const int wc = clampL(wl);
      const bool w_macro = ex && (q == 0 ? w0_macro : sc.macro_at(wc));
      if (ex && !w_macro && (q == 0 ? w0_count : g_count(wc)) > 0) {
        wstar = wl; cdel_st = detached(cur); found = true; done = true;
      } else if (!ex || w_macro) {
        done = true;
      } else {
        cur = cur + S(sc.length_at(wc));
      }
    }
    S pd_g, sd_g;
    if (found) {
      const bool wi = g_inj(wstar);
      const S tpos = wi ? S(0.0f) : gA(5, wstar);
      const S tvel = wi ? S(0.0f) : gA(6, wstar);
      const float tlen = wi ? c.veh_len : gv[7 * L + wstar];
      const S cdel = cdel_st + (base - detached(base));
      pd_g = vmax((cdel + tpos) - S(tlen * 0.5f), S(0.0f));
      sd_g = hvel - tvel;
    } else {
      pd_g = 1000.0f;
      sd_g = 0.0f;
    }
    SH_ADD(clk, SH_B_WALK, sh_p);

    const S sig_l = signal_of(gl);
    const size_t base_bc = (size_t)k.e * BC_ROWS * n + k.j;
    const S rows[BC_ROWS] = {bl_r, bl_u, gr_r, gr_u, sig_l, pd_g, sd_g,
                             red_pd, fsig, S(blend ? 1.0f : 0.0f)};
    for (int r = 0; r < BC_ROWS; ++r)
      put_row(a.bc_v, a.bc_d, base_bc + (size_t)r * n, rows[r]);
    const size_t base_sg = (size_t)k.e * 2 * n + k.j;
    a.sg[base_sg] = blend ? val(fsig) : 0.0f;
    a.sg[base_sg + n] = blend ? 1.0f : 0.0f;
    SH_ADD(clk, SH_B_ROWS, sh_p);
    SH_CLOCK(if (blockIdx.x == 0) shard_lane_cycles[k.j] += sh_now() - sh_t0;)
  }
  if (!k.dual) {
    const int tot = __syncthreads_count(injected);
    if (threadIdx.x == 0) a.events[((size_t)k.e * d.T + t) * 3] = tot;
  }
  SH_ADD(clk, SH_B_COUNT, sh_p);
  SH_ADD(clk, SH_B_TOTAL, sh_t0);
  SH_CLOCK(if (clk && blockIdx.x == 0) shard_cycles[SH_PARTS + SH_N_B] += 1;)
}

// ====== C: signal blend, physics, flux capacitors, post-physics rows ======
// The block: the lane threads (G a lane, `geo.lanes` in whole warps) and,
// where the signal mean is folded here (a.gsg: the soft modes, and hard
// mode on an unsplit lane axis), a reduction warp behind them that folds it
// (warp_fold) while the lanes run. The macro lanes' Godunov update reads no
// mean and starts at once; in the soft modes the lane warps then wait on
// BAR_MEAN for it (the micro lanes' blend gate reads it), in hard mode for
// nothing.
// With G = SPLIT threads a lane (where C + 1 and V / SPLIT_VEH fit and the
// block stays within 1,024 threads), thread r of a macro lane's group
// solves interface r's Riemann problem and updates cell r with its own flux
// and interface r + 1's (a shuffle), and a micro lane's group updates
// vehicles r, r + G, ...: each from the state before the update, by the
// operations of itscp_step.cuh's godunov_lane and idm_lane (bit-equal).
// The group's first thread reads what its rows need of the state the
// update leaves alone (counts, route ids, parameters, the capacitor) before
// the update, and writes the rows after it. The wave maximum: a shuffle
// tree per warp, then thread 0 over the warps (exact in any order).
template <class S, int G>
__device__ __forceinline__ void body_C(const ShardArgs& a, const Geo& geo) {
  DHTS_DYNAMIC_SMEM(smem_raw);
  const Dims& d = a.d;
  const Consts& c = a.k;
  const int L = d.L, V = d.V, K = d.K, n = a.n, t = a.t;
  SH_CLOCK(const bool clk = threadIdx.x == 0; long long sh_t0 = 0;
           if (clk) sh_t0 = sh_now(); long long sh_p = sh_t0;)
  float* ms = nullptr;
  float* wave_w = nullptr;
  double* stage = nullptr;
  size_t off_s = 0;
  carve(&ms, 1, smem_raw, off_s);
  carve(&wave_w, MAX_WARPS, smem_raw, off_s);
  carve(&stage, L, smem_raw, off_s);
  const int tid = threadIdx.x, wl = tid % WARP, warp = tid / WARP;
  const int NB = geo.lanes + (geo.red ? WARP : 0);
  const bool soft_mode = d.mode != HARD;
  const bool reducer = geo.red && tid >= geo.lanes;
  const bool dual = a.dbuf != nullptr;
  const int e = blockIdx.x;
  if (reducer) {
    // the signal running mean from the gathered per-lane terms, in lane
    // order; its detached mean sharpens the soft blend gate
    SH_CLOCK(long long sh_f = 0; if (wl == 0) sh_f = sh_now();)
    const float* gs = a.gsg + (size_t)e * 2 * L;
    const Fold<1> f = warp_fold<1>(
        L,
        [&](int j, double* x, int* cn) {
          x[0] = (double)gs[j];
          cn[0] = (int)gs[L + j];
        },
        stage, wl);
    if (wl == 0) {
      float* sg_ms = a.fbuf + (size_t)e * layout(d, n).fsize +
                     layout(d, n).sg;
      sg_ms[0] = sg_ms[0] + (float)f.s[0];
      sg_ms[1] = sg_ms[1] + (float)f.n[0];
      const float mean = sg_ms[0] / fmaxf(sg_ms[1], 1.0f);
      ms[0] = sharpness(c.gate32, mean);
    }
    SH_ADD(wl == 0, SH_C_FOLD, sh_f);
    if (soft_mode) {
      CONVERGE();
      bar_arrive(BAR_MEAN, NB);
    }
  } else {
    const int j = tid / G, r = tid % G;
    Block<S> k = lane_block_of<S>(a, j);
    auto& st = k.st;
    const LaneGeom& g = k.g;
    const Scene& sc = k.sc;
    const int gl = k.gl;
    auto clampL = [&](int q) { return min(max(q, 0), L - 1); };
    const bool lead = k.lane && r == 0;
    SH_ADD(clk, SH_C_WAIT, sh_p);
    S bl_r = 0.0f, bl_u = 0.0f, sg = 0.0f, gr_r = 0.0f, gr_u = 0.0f;
    S pd_g = 0.0f, sd_g = 0.0f, red_pd = 0.0f, fsig = 0.0f;
    bool blend = false;
    if (k.lane) {
      const float* bv = a.bc_v + (size_t)e * BC_ROWS * n + j;
      const float* bdp = dual ? a.bc_d + (size_t)e * BC_ROWS * n + j
                              : nullptr;
      auto bc = [&](int q) { return from_parts<S>(bv[q * n], bdp, q * n); };
      bl_r = bc(0); bl_u = bc(1); gr_r = bc(2); gr_u = bc(3);
      const S sig_l = bc(4);
      pd_g = bc(5); sd_g = bc(6); red_pd = bc(7); fsig = bc(8);
      blend = bv[9 * n] > 0.5f;
      if (d.mode == HARD) {
        sg = val(sig_l) > 0.5f ? 1.0f : 0.0f;
      } else {
        sg = stg(val(sig_l) > 0.5f, soft(sig_l - S(0.5f), c.gate32),
                 d.mode);
      }
    }
    const Ghosts<S> gh{bl_r, bl_u, gr_r * sg + S(1.0f) * (S(1.0f) - sg),
                       gr_u * sg};
    // what the rows read of the state the update leaves alone, loaded
    // before it (the head's route after it: a third dependent load)
    int mn = -1, slot = -1, cnt = 0, i0 = 0, hi = 0, hrid = 0, hridx = 0;
    bool next_macro = false;
    float len0 = 0.0f, hpar[6] = {};
    S cap_old = 0.0f, hav = 0.0f;
    if (lead) {
      mn = a.mnext[t * L + gl];
      cnt = st.count[gl];
      for (int q = 0; q < K; ++q) {
        const int nq = sc.lane_i[(8 + K + q) * L + gl];
        if (slot < 0 && nq >= 0 && nq == mn) slot = q;
      }
      next_macro = sc.macro_at(clampL(mn));
      i0 = st.vi(gl, 0);
      hi = st.vi(gl, min(max(cnt - 1, 0), V - 1));
      hrid = st.rid[hi];
      hridx = st.ridx[hi];
      len0 = st.param(5, i0);
      for (int q = 0; q < 6; ++q) hpar[q] = st.param(q, hi);
      if (slot >= 0) cap_old = ld<S>(st.cap, st.ki(gl, slot));
      hav = ld<S>(st.av, hi);
    }
    SH_CLOCK(long long sh_l = sh_now();)
    // ---- the macro lanes' Godunov update (no wait)
    float lane_wave = 0.0f;
    if constexpr (G == 1) {
      if (k.lane && g.is_macro)
        lane_wave = godunov_lane<S>(st, g, gl, d.C, gh, c);
    } else {
      const float u_max = c.u_max;
      const int C = d.C;
      S fr = 0.0f, fy = 0.0f, rc = 0.0f, yc = 0.0f;
      const bool iface = k.lane && g.is_macro && r <= C;
      if (iface) {
        // interface r between cell r - 1 (or the left ghost) and cell r
        // (or the right ghost); cells past the lane's are the right ghost.
        // Every thread takes every candidate and selects (no divergent
        // solves): the same values as godunov_lane's
        const S right_y = comp_y(gh.br_r, gh.br_u, u_max);
        const S left_y = comp_y(gh.bl_r, gh.bl_u, u_max);
        auto cell = [&](int q, S& rq, S& yq) {
          const bool in = q >= 0 && q < C && q < g.num_cell;
          rq = in ? ld<S>(st.r, st.ci(gl, q)) : gh.br_r;
          yq = in ? ld<S>(st.y, st.ci(gl, q)) : right_y;
        };
        S rl, yl;
        cell(r - 1, rl, yl);
        cell(r, rc, yc);
        const S ul = comp_u(rl, yl, u_max), ur = comp_u(rc, yc, u_max);
        const bool first = r == 0, end = r == C;
        riemann(first ? gh.bl_r : rl, first ? left_y : yl,
                first ? gh.bl_u : ul, end ? gh.br_r : rc,
                end ? gh.br_u : ur, u_max, c.rare_den, c.third, fr, fy,
                lane_wave);
      }
      // interface r + 1's fluxes (every thread of the warp shuffles)
      const S fr1 = shfl_down_w(fr, 1, G), fy1 = shfl_down_w(fy, 1, G);
      __syncwarp();  // every read of the cells before the first write
      if (iface && r < C && r < g.num_cell) {
        const S coeff = S(c.dt / g.cell_len);
        put(st.r, st.ci(gl, r), rc + (fr - fr1) * coeff);
        put(st.y, st.ci(gl, r), yc + (fy - fy1) * coeff);
      }
    }
    SH_CLOCK(if (k.lane && g.is_macro && blockIdx.x == 0 && r == 0)
                 shard_lane_cycles[j] += sh_now() - sh_l;)
    // ---- the soft signal mean (the micro lanes' blend gate)
    if (soft_mode) {
      CONVERGE();
      bar_sync(BAR_MEAN, NB);
    }
    SH_CLOCK(long long sh_m = sh_now();)
    // ---- the micro lanes' IDM update
    S hpd = pd_g, hsd = sd_g;
    if (k.lane && !g.is_macro && blend) {
      if (d.mode != HARD) {
        const S fs = soft(fsig - S(0.5f), ms[0]);
        hpd = pd_g * fs + red_pd * (S(1.0f) - fs);
        hsd = sd_g * fs;
      } else {
        const bool green = val(fsig) >= 0.5f;
        hpd = green ? pd_g : red_pd;
        hsd = green ? sd_g : S(0.0f);
      }
    }
    if constexpr (G == 1) {
      if (k.lane && !g.is_macro) idm_lane<S>(st, gl, hpd, hsd, c);
    } else {
      const bool micro = k.lane && !g.is_macro;
      const int nv = micro ? st.count[gl] : 0;
      S np_[SPLIT_VEH], nv_[SPLIT_VEH];
      // two vehicles a thread at a time: their and their leaders' state
      // loaded, then their updates
#pragma unroll
      for (int q0 = 0; q0 < SPLIT_VEH; q0 += 2) {
        if (q0 * G >= V) break;
        S pv[2], sp[2], pj[2], vj[2];
        float len[2], lenj[2], par[2][4], den[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int v = r + (q0 + u) * G;
          if (v >= nv) continue;
          const int i = st.vi(gl, v), jv = st.vi(gl, min(v + 1, nv - 1));
          pv[u] = ld<S>(st.pos, i); sp[u] = ld<S>(st.vel, i);
          pj[u] = ld<S>(st.pos, jv); vj[u] = ld<S>(st.vel, jv);
          len[u] = st.param(5, i); lenj[u] = st.param(5, jv);
          par[u][0] = st.param(0, i); par[u][1] = st.param(2, i);
          par[u][2] = st.param(3, i); par[u][3] = st.param(4, i);
          den[u] = st.idm_den(i);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int v = r + (q0 + u) * G;
          if (v >= nv) continue;
          S pdel, sdel;
          if (v == nv - 1) {
            pdel = hpd; sdel = hsd;
          } else {
            pdel = vabs(pj[u] - pv[u]) - S((lenj[u] + len[u]) * 0.5f);
            sdel = sp[u] - vj[u];
          }
          idm_step(pv[u], sp[u], pdel, sdel, par[u][0], par[u][1],
                   par[u][2], par[u][3], den[u], c.dt, np_[q0 + u],
                   nv_[q0 + u]);
        }
      }
      __syncwarp();  // every read of the vehicles before the first write
#pragma unroll
      for (int q = 0; q < SPLIT_VEH; ++q) {
        const int v = r + q * G;
        if (v >= nv) continue;
        const int i = st.vi(gl, v);
        put(st.pos, i, np_[q]);
        put(st.vel, i, nv_[q]);
      }
      __syncwarp();  // the group's updates, for its first thread's rows
    }
    SH_CLOCK(if (k.lane && !g.is_macro && blockIdx.x == 0 && r == 0)
                 shard_lane_cycles[j] += sh_now() - sh_m;)
    SH_ADD(clk, SH_C_LANE, sh_p);

    // ---- the flux capacitor toward the next lane, and the rows out
    if (lead) {
      const int last = min(max(g.num_cell - 1, 0), d.C - 1);
      const S rl = ld<S>(st.r, st.ci(gl, last));
      const S ul = comp_u(rl, ld<S>(st.y, st.ci(gl, last)), c.u_max);
      const bool next_is_micro = g.is_macro && mn >= 0 && !next_macro;
      const S inc = next_is_micro ? (rl * ul) * S(c.dt) : S(0.0f);
      S cap_v = 0.0f;
      if (slot >= 0) {
        cap_v = cap_old + inc;
        put(st.cap, st.ki(gl, slot), cap_v);
      }
      const S rows[F_ROWS] = {
          rl, ul, S((float)cnt), ld<S>(st.pos, i0), S(len0), cap_v,
          ld<S>(st.pos, hi), ld<S>(st.vel, hi), S(hpar[5]), hav, S(hpar[0]),
          S(hpar[1]), S(hpar[2]), S(hpar[3]), S(hpar[4])};
      const size_t base_f = (size_t)e * F_ROWS * n + j;
      for (int q = 0; q < F_ROWS; ++q)
        put_row(a.sumF_v, a.sumF_d, base_f + (size_t)q * n, rows[q]);
      int* si = a.sumI + (size_t)e * I_ROWS * n + j;
      si[I_MN * n] = mn;
      si[I_RIDX * n] = hridx;
      si[I_HNEXT * n] = route_at(sc.inj, sc.emit, hrid, hridx + 1, d);
      si[I_RID * n] = hrid;
    }
    SH_ADD(clk, SH_C_ROWS, sh_p);
    // this warp's largest wave speed
    if (!dual) {
      float w = lane_wave;
      for (int o = WARP / 2; o > 0; o >>= 1)
        w = max_of(w, __shfl_down_sync(FULL_MASK, w, o));
      if (wl == 0) wave_w[warp] = w;
    }
  }
  if (!dual) {
    __syncthreads();
    SH_ADD(clk, SH_C_END_WAIT, sh_p);
    if (warp == 0) {
      float w = wl < geo.lanes / WARP ? wave_w[wl] : 0.0f;
      for (int o = WARP / 2; o > 0; o >>= 1)
        w = max_of(w, __shfl_down_sync(FULL_MASK, w, o));
      if (wl == 0) a.waves[(size_t)e * d.T + t] = w;
    }
    SH_ADD(clk, SH_C_WAVE, sh_p);
  }
  SH_ADD(clk, SH_C_TOTAL, sh_t0);
  SH_CLOCK(if (clk && blockIdx.x == 0) shard_cycles[SH_PARTS + SH_N_C] += 1;)
}

// C's kernels: one thread a lane, and SPLIT threads a lane with at most
// SPLIT_REGS registers a thread, so that two blocks of the 3x3 preset's
// shards of 36 lanes (10 warps, the reduction warp's included) share an SM
// (the derivative's grid of 180 blocks at B = 4 runs in one wave) and a
// block of 72 lanes (19 warps) fits one (an SM quarter's 16,384 registers
// hold five warps of 96)
constexpr int SPLIT_REGS = 96;
template <class S>
__global__ void shard_C(ShardArgs a, Geo geo) {
  body_C<S, 1>(a, geo);
}
template <class S>
__global__ void
#ifndef DHTS_CPU_EMULATION
__maxnreg__(SPLIT_REGS)
#endif
shard_C_split(ShardArgs a, Geo geo) {
  body_C<S, SPLIT>(a, geo);
}

// == D3: wants, arbitration, verdicts, inserts, deposits, static terms ==
// E's queue chunks and D3's static terms take QCHUNK vehicles at a time
constexpr int QCHUNK = 8;

// itscp_step.cuh's static_partials (values only) with the state of every
// cell, or of QCHUNK vehicles at a time, loaded before the sums: the same
// operations in the same order. The loads are unconditional (indices
// clamped to the lane's last cell or vehicle), so that none waits behind a
// branch
template <class St>
__device__ __forceinline__ void static_terms(const St& st, const TermRows& s,
                                             const LaneGeom& g, int rows,
                                             int l, int n, const Consts& k) {
  double cells = 0.0, vehs = 0.0;
  if (g.is_macro) {
    const int last = max(g.num_cell - 1, 0);
    float r[MAXC], y[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      r[c] = ld<float>(st.r, st.ci(l, min(c, last)));
      y[c] = ld<float>(st.y, st.ci(l, min(c, last)));
    }
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (c < g.num_cell)
        cells += (double)(k.static_speed - comp_u(r[c], y[c], k.u_max));
  } else {
    for (int v0 = 0; v0 < n; v0 += QCHUNK) {
      float sp[QCHUNK];
#pragma unroll
      for (int i = 0; i < QCHUNK; ++i)
        sp[i] = ld<float>(st.vel, st.vi(l, min(v0 + i, n - 1)));
#pragma unroll
      for (int i = 0; i < QCHUNK; ++i)
        if (v0 + i < n) vehs += (double)(k.static_speed - sp[i]);
    }
  }
  s.red_sum[l] = cells; s.red_cnt[l] = g.is_macro ? g.num_cell : 0;
  s.red_sum[rows + l] = vehs; s.red_cnt[rows + l] = g.is_macro ? 0 : n;
}

// D3's table of every lane's wants in shared memory, 3 L ints: the emit
// target (the lane's next lane where the lane wants to emit a vehicle from
// its capacitor into it, else NO_WANT), the transfer target (its head's
// next lane where it wants to hand its head on; EXITS where its head
// leaves the network; else NO_WANT) and the deposit target (its head's
// next lane where it wants to deposit its head's mass, else NO_WANT)
constexpr int NO_WANT = -2, EXITS = -3;
struct Wants {
  int *emit, *tr, *dep;
};

// a lane's row of the table
struct Want {
  int emit, tr, dep;
};

// Lane i's row of the table: body_D1's wants (plain_body_D1) from the
// gathered post-physics rows (the lane's count is C's row F_COUNT) and the
// scene's lane tables (`li` is lane_i, `lf` lane_f). Every load is issued
// before the first test: the destinations' rows at clamped indices, in
// range whatever the lane wants.
__device__ __forceinline__ Want want_of(const float* __restrict__ fv,
                                       const int* __restrict__ gI,
                                       const int* __restrict__ li,
                                       const float* __restrict__ lf,
                                       const Dims& d, const Consts& c,
                                       int i) {
  const int L = d.L;
  const int mn = gI[I_MN * L + i], hn = gI[I_HNEXT * L + i];
  const int mn_c = min(max(mn, 0), L - 1), hn_c = min(max(hn, 0), L - 1);
  const int cnt = (int)fv[F_COUNT * L + i];
  const float cap = fv[F_CAP * L + i], hpos = fv[F_HPOS * L + i];
  const float hlen = fv[F_HLEN * L + i], len = lf[i];
  const bool macro = li[i] != 0;
  const int mn_n = (int)fv[F_COUNT * L + mn_c];
  const float tpos = fv[F_TPOS * L + mn_c], tlen = fv[F_TLEN * L + mn_c];
  const float mn_len = lf[mn_c];
  const bool mn_macro = li[mn_c] != 0;
  const int hn_n = (int)fv[F_COUNT * L + hn_c];
  const bool hn_macro_at = li[hn_c] != 0;
  const bool next_is_micro = macro && mn >= 0 && !mn_macro;
  const int dest_n = mn >= 0 ? mn_n : 0;
  const float free_n =
      dest_n > 0 ? tpos - 0.5f * tlen : (mn >= 0 ? mn_len : 0.0f);
  const bool want_emit = next_is_micro && cap >= c.veh_len &&
                         free_n >= c.veh_len && dest_n < d.V;
  const bool exists = cnt > 0;
  const bool past_end = exists && hpos >= len;
  const bool hn_macro = hn >= 0 && hn_macro_at;
  const bool hn_micro = hn >= 0 && !hn_macro;
  const bool want_tr = past_end && hn_micro && hn_n < d.V;
  const bool want_dep = exists && hn_macro && hpos > len + hlen;
  return {want_emit ? mn : NO_WANT,
          want_tr ? hn : (past_end && hn < 0 ? EXITS : NO_WANT),
          want_dep ? hn : NO_WANT};
}

// The block's `threads` fill the table, TABLE_U lanes a thread at a time
// (j, j + threads, ...; one where the block has a thread a lane), all
// their loads before the first store: a block of 1,024 threads fills a
// scene of up to 4,096 lanes in one round of loads.
constexpr int TABLE_U = 4;
__device__ __forceinline__ void fill_wants(const Wants& w, const float* fv,
                                           const int* gI, const Scene& sc,
                                           const Dims& d, const Consts& c,
                                           int threads) {
  const int L = d.L;
  for (int i0 = threadIdx.x; i0 < L; i0 += TABLE_U * threads) {
    Want v[TABLE_U];
#pragma unroll
    for (int u = 0; u < TABLE_U; ++u) {
      const int i = i0 + u * threads;
      if (i < L) v[u] = want_of(fv, gI, sc.lane_i, sc.lane_f, d, c, i);
    }
#pragma unroll
    for (int u = 0; u < TABLE_U; ++u) {
      const int i = i0 + u * threads;
      if (i < L) {
        w.emit[i] = v[u].emit;
        w.tr[i] = v[u].tr;
        w.dep[i] = v[u].dep;
      }
    }
  }
}

// A lane's predecessors (lane_i rows 8 .. 8 + K), the first KP loaded
// into registers ahead of the table (-1 past K)
constexpr int KP = 4;
struct Preds {
  int p[KP];
};
__device__ __forceinline__ Preds preds_of(const int* lane_i, int L, int K,
                                          int l) {
  Preds o;
#pragma unroll
  for (int q = 0; q < KP; ++q) o.p[q] = q < K ? lane_i[(8 + q) * L + l] : -1;
  return o;
}

// body_D2's pull arbitration at lane l over the table: the lowest
// predecessor that wants to emit or hand its head into l, and the lowest
// that wants to deposit into it (L for none; plain_body_D2). `pr`: l's
// preloaded predecessors; any past KP are loaded here.
struct Win {
  int best, dep;
};
__device__ __forceinline__ Win arbitrate_at(const Wants& w, const Preds& pr,
                                            const int* lane_i, int L, int K,
                                            int l) {
  Win o{L, L};
  auto take = [&](int pk) {
    if (pk < 0) return;
    if (w.emit[pk] == l || w.tr[pk] == l) o.best = min(o.best, pk);
    if (w.dep[pk] == l) o.dep = min(o.dep, pk);
  };
#pragma unroll
  for (int q = 0; q < KP; ++q) take(pr.p[q]);
  for (int q = KP; q < K; ++q) take(lane_i[(8 + q) * L + l]);
  return o;
}

// The conversion: body_D1, body_D2 and body_D3 of the step (plain_body_D).
// One thread a lane, and where the scene has more lanes than the shard,
// more threads for the table (`threads` in all; d3_threads). Each lane
// first issues the loads of its own set-up (its next lanes, the capacitor
// slot's candidates and value, the predecessors of the three lanes it may
// arbitrate at), then the block fills the want table, every lane of the
// scene strided over its threads (coalesced loads of the gathered rows),
// and waits at one barrier. Then each lane arbitrates in shared memory where it reads a
// verdict: at its own lane (its insert and deposit), at its next lane if
// it wants to emit and at its head's next lane if it wants to hand on or
// deposit its head (Picked); convert() and static_terms() are those of
// the three-launch conversion, the static terms loading their cells or
// vehicles ahead of the sums. Before the last step each lane then writes
// the next step's A rows (a_rows, their loads issued before the static
// terms'; the row D3's one-shard gather hands B as gA is this buffer,
// which B of this step has read before D3 launches, in stream order).
// The forward's emit and absorb counts are two
// barriers' counts (__syncthreads_count); the derivative counts nothing
// and builds its table from the gathered values.
template <class S>
__global__ void shard_D3(ShardArgs a, int threads) {
  DHTS_DYNAMIC_SMEM(smem_raw);
  const Dims& d = a.d;
  const Consts& c = a.k;
  const int L = d.L, K = d.K, n = a.n, t = a.t;
  SH_CLOCK(const bool clk = (int)threadIdx.x == shard_clock_lane;
           long long sh_t0 = sh_now(); long long sh_p = sh_t0;)
  Wants w;
  size_t off_s = 0;
  carve(&w.emit, L, smem_raw, off_s);
  carve(&w.tr, L, smem_raw, off_s);
  carve(&w.dep, L, smem_raw, off_s);
  Block<S> k = block_of<S>(a);
  auto clampL = [&](int q) { return min(max(q, 0), L - 1); };
  const float* fv = a.gF_v + (size_t)k.e * F_ROWS * L;
  const float* fd = k.dual ? a.gF_d + (size_t)k.e * F_ROWS * L : nullptr;
  const int* gI = a.gI + (size_t)k.e * I_ROWS * L;
  const int gl = k.gl;
  Request<S> q;
  q.mn = k.lane ? gI[I_MN * L + gl] : -1;
  q.hnext = k.lane ? gI[I_HNEXT * L + gl] : -1;
  q.slot = -1;
  if (k.lane)
    for (int r = 0; r < K; ++r) {
      const int nq = k.sc.lane_i[(8 + K + r) * L + gl];
      if (q.slot < 0 && nq >= 0 && nq == q.mn) q.slot = r;
    }
  const int mn_c = clampL(q.mn), hn_c = clampL(q.hnext);
  const int* li = k.sc.lane_i;
  auto row = [&](int r) {
    return RowS<S>{fv + r * L, fd ? fd + r * L : nullptr};
  };
  Preds pr_own, pr_mn, pr_hn;
  if (k.lane) {
    q.cap_v = q.slot >= 0 ? row(F_CAP)[gl] : S(0.0f);
    pr_own = preds_of(li, L, K, gl);
    pr_mn = preds_of(li, L, K, mn_c);
    pr_hn = preds_of(li, L, K, hn_c);
  }
  SH_ADD(clk, SH_D3_SETUP, sh_p);
  fill_wants(w, fv, gI, k.sc, d, c, threads);
  SH_ADD(clk, SH_D3_TABLE, sh_p);
  CONVERGE();
  __syncthreads();
  SH_ADD(clk, SH_D3_WAIT, sh_p);
  bool emit = false, absorb = false;
  if (k.lane) {
    const int tr = w.tr[gl];
    q.exit_none = tr == EXITS;
    q.want = (w.emit[gl] != NO_WANT ? W_EMIT : 0) |
             (tr >= 0 ? W_TRANSFER : 0) |
             (w.dep[gl] != NO_WANT ? W_DEPOSIT : 0);
    // the verdicts convert() reads: at the lane itself always, at a next
    // lane only where the lane wants into it (else no lane matches: -1)
    const Win own = arbitrate_at(w, pr_own, li, L, K, gl);
    Win at_mn{L, L}, at_hn{L, L};
    int pm = -1, ph = -1;
    if (q.want & W_EMIT) {
      at_mn = arbitrate_at(w, pr_mn, li, L, K, mn_c);
      pm = mn_c;
    }
    if (q.want & (W_TRANSFER | W_DEPOSIT)) {
      at_hn = arbitrate_at(w, pr_hn, li, L, K, hn_c);
      ph = hn_c;
    }
    const ConvRows<S> s{
        Picked{{gl, pm, ph}, {own.best, at_mn.best, at_hn.best}},
        Picked{{gl, pm, ph}, {own.dep, at_mn.dep, at_hn.dep}},
        row(F_ULAST), row(F_CAP), row(F_HPOS), row(F_HVEL), row(F_HA),
        fv + F_HLEN * L, fv + F_AMAX * L, gI + I_RID * L, gI + I_RIDX * L};
    SH_ADD(clk, SH_D3_ARBITRATE, sh_p);
    const Verdict vd = convert<S>(k.st, s, k.sc, k.g, q, d, c, gl);
    SH_ADD(clk, SH_D3_CONVERT, sh_p);
    emit = vd.is_emit;
    absorb = vd.exit_none || vd.dep_win;
    // the next step's A rows of this lane from the carry the conversion
    // left, their loads issued ahead of the static terms' (the cells and
    // the tail's speed they share, the tail's other fields, the counters,
    // the draw and the schedule)
    const bool next_a = t + 1 < d.T;
    ARows<S> nxt;
    if (next_a) nxt = a_rows(a, k, t + 1);
    SH_ADD(clk, SH_D3_NEXT_A, sh_p);
    // this lane's static running-mean terms, after the conversion (rows of
    // n lanes, addressed by global id)
    const TermRows terms{a.ss + (size_t)k.e * 2 * n - a.off,
                         a.ssn + (size_t)k.e * 2 * n - a.off};
    static_terms(k.st, terms, k.g, n, gl, vd.n, c);
    SH_ADD(clk, SH_D3_STATIC, sh_p);
    if (next_a) put_a_rows(a, k, nxt);
    SH_ADD(clk, SH_D3_NEXT_A, sh_p);
    SH_CLOCK(if (blockIdx.x == 0) shard_lane_cycles[k.j] +=
             sh_now() - sh_t0;)
  }
  if (!k.dual) {
    const int n_emit = __syncthreads_count(emit);
    const int n_absorb = __syncthreads_count(absorb);
    if (threadIdx.x == 0) {
      int* out = a.events + ((size_t)k.e * d.T + t) * 3;
      out[1] = n_emit;
      out[2] = n_absorb;
    }
  }
  SH_ADD(clk, SH_D3_COUNT, sh_p);
  SH_ADD(clk, SH_D3_TOTAL, sh_t0);
  SH_CLOCK(if (clk && blockIdx.x == 0) shard_cycles[SH_PARTS + SH_N_D3] += 1;)
}

// itscp_step.cuh's lane_queue with the loads of each chunk of QCHUNK cells
// or vehicles issued before its arithmetic (the same operations in the same
// order): a chunk's state, and a macro lane's cell speeds
template <class S>
struct QueueChunk {
  S x[QCHUNK], u[QCHUNK];  // the cells' densities and speeds; the speeds
};

template <class S, class St>
__device__ __forceinline__ void queue_chunk(const St& st, const LaneGeom& g,
                                            int l, int n, int c0,
                                            const Consts& k,
                                            QueueChunk<S>& q) {
  if (g.is_macro) {
    S y[QCHUNK];
#pragma unroll
    for (int i = 0; i < QCHUNK; ++i)
      if (c0 + i < g.num_cell) {
        q.x[i] = ld<S>(st.r, st.ci(l, c0 + i));
        y[i] = ld<S>(st.y, st.ci(l, c0 + i));
      }
#pragma unroll
    for (int i = 0; i < QCHUNK; ++i)
      if (c0 + i < g.num_cell) q.u[i] = comp_u(q.x[i], y[i], k.u_max);
  } else {
#pragma unroll
    for (int i = 0; i < QCHUNK; ++i)
      if (c0 + i < n) q.u[i] = ld<S>(st.vel, st.vi(l, c0 + i));
  }
}

// the lane's queue (lane_queue's value) from its first chunk `q0`, the
// later chunks loaded here
template <class S, class St>
__device__ __forceinline__ S queue_of(const St& st, const LaneGeom& g, int l,
                                      int n, int mode, float c_st,
                                      const Consts& k, QueueChunk<S>& q0) {
  const float ss = k.static_speed;
  const int m = g.is_macro ? g.num_cell : n;
  S q = 0.0f;
  for (int c0 = 0; c0 < m; c0 += QCHUNK) {
    if (c0 > 0) queue_chunk<S>(st, g, l, n, c0, k, q0);
#pragma unroll
    for (int i = 0; i < QCHUNK; ++i) {
      if (c0 + i >= m) break;
      const S u = q0.u[i];
      const S stat = mode == HARD ? S(val(u) < ss ? 1.0f : 0.0f)
                                  : stg(val(u) < ss, soft(S(ss) - u, c_st),
                                        mode);
      q = g.is_macro ? q + stat * ((q0.x[i] * S(g.cell_len)) / S(k.veh_len))
                     : q + stat;
    }
  }
  return q;
}

// ====================== E: the lanes' squared queues ======================
// The block: the lane threads (one a lane, in whole warps) and a reduction
// warp behind them that folds the static running mean (warp_fold: the
// gathered terms loaded by the whole warp) into the carry. In hard mode
// nothing waits for it: the lanes' queues do not read it. In the soft modes
// each lane loads its first 8 cells' or vehicles' state and takes the
// cells' speeds, then waits on BAR_MEAN for the mean's constant and
// computes its gates.
template <class S>
__global__ void shard_E(ShardArgs a, Geo geo) {
  DHTS_DYNAMIC_SMEM(smem_raw);
  const Dims& d = a.d;
  const int L = d.L, n = a.n;
  SH_CLOCK(const bool clk = threadIdx.x == 0; long long sh_t0 = 0;
           if (clk) sh_t0 = sh_now(); long long sh_p = sh_t0;)
  float* ms = nullptr;
  double* stage = nullptr;
  size_t off_s = 0;
  carve(&ms, 1, smem_raw, off_s);
  carve(&stage, 2 * L, smem_raw, off_s);
  const int tid = threadIdx.x, wl = tid % WARP;
  const int NB = geo.lanes + WARP;
  const bool soft_mode = d.mode != HARD;
  const int e = blockIdx.x;
  if (tid >= geo.lanes) {
    // the static running mean from the gathered per-lane terms (cells,
    // vehicles), in lane order
    SH_CLOCK(long long sh_f = 0; if (wl == 0) sh_f = sh_now();)
    const double* gs = a.gss + (size_t)e * 2 * L;
    const int* gn = a.gssn + (size_t)e * 2 * L;
    const Fold<2> f = warp_fold<2>(
        L,
        [&](int j, double* x, int* cn) {
          x[0] = gs[j]; x[1] = gs[L + j];
          cn[0] = gn[j]; cn[1] = gn[L + j];
        },
        stage, wl);
    if (wl == 0) {
      float* ss_ms = a.fbuf + (size_t)e * layout(d, n).fsize +
                     layout(d, n).ss;
      ss_ms[0] = ss_ms[0] + ((float)f.s[0] + (float)f.s[1]);
      ss_ms[1] = ss_ms[1] + ((float)f.n[0] + (float)f.n[1]);
      const float mean = ss_ms[0] / fmaxf(ss_ms[1], 1.0f);
      ms[0] = sharpness(16.0f, mean);
    }
    SH_ADD(wl == 0, SH_E_FOLD, sh_f);
    if (soft_mode) {
      CONVERGE();
      bar_arrive(BAR_MEAN, NB);
    }
    return;
  }
  Block<S> k = block_of<S>(a);
  const LaneGeom& g = k.g;
  const Consts& c = a.k;
  const int cnt = k.lane ? k.st.count[k.gl] : 0;
  // the lane's first chunk of cells (state, speeds) or vehicles (speeds)
  QueueChunk<S> q0;
  if (k.lane) queue_chunk<S>(k.st, g, k.gl, cnt, 0, c, q0);
  if (soft_mode) {
    CONVERGE();
    bar_sync(BAR_MEAN, NB);
  }
  SH_ADD(clk, SH_E_WAIT, sh_p);
  if (k.lane) {
    const S q = queue_of<S>(k.st, g, k.gl, cnt, d.mode, ms[0], c, q0);
    SH_ADD(clk, SH_E_QUEUE, sh_p);
    put_row(a.q_v, a.q_d, ((size_t)e * d.T + a.t) * n + k.j, q * q);
    SH_ADD(clk, SH_E_STORE, sh_p);
  }
  SH_ADD(clk, SH_E_TOTAL, sh_t0);
  SH_CLOCK(if (clk && blockIdx.x == 0) shard_cycles[SH_PARTS + SH_N_E] += 1;)
}

// s + x[0] + x[1] + ... + x[n - 1] in float64, one add after another; the
// loads of eight terms are issued before their adds, so that the chain of
// adds, not the loads' latency, sets the time
template <class T>
__device__ __forceinline__ double add_in_order(double s, const T* x, int n) {
  int k = 0;
  for (; k + 8 <= n; k += 8) {
    double v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (double)x[k + j];
#pragma unroll
    for (int j = 0; j < 8; ++j) s += v[j];
  }
  for (; k < n; ++k) s += (double)x[k];
  return s;
}

// ========= Q: the episode's queues from the gathered q^2 rows ==========
// One block per tile of q_tile(L) steps of a row, so that a row's T x L
// floats spread over T / q_tile(L) SMs. The block copies its tile into
// shared memory with coalesced loads (the tile's steps are contiguous in
// gq); then thread j adds step j's L lanes in lane order in float64,
// rounded once, times dt (the STEP kernel's reduction). In a derivative the
// rows are tangents, and the row's last block to finish (counted in
// q_count, which it resets) adds q_weight[b, t] * tangent over all the
// row's steps in float64, in step order, into grad[row]: the terms staged
// in shared memory, one thread adding them one after another, as STEP's
// derivative adds them (a tree would round differently). Q reads each row
// once, so bytes bound it (0.1 us for a 600 x 144 row on an H100); one
// block per row with the steps strided over its threads (uncoalesced loads,
// one SM) took 32.9 us there.
__global__ void shard_Q(ShardArgs a) {
  DHTS_DYNAMIC_SMEM(smem_raw);
  const int L = a.d.L, T = a.d.T, P = q_stride(L), K = q_tile(L);
  const int n_tiles = q_tiles(T, L);
  const int e = blockIdx.x / n_tiles, t0 = blockIdx.x % n_tiles * K;
  const int steps = min(K, T - t0);
  int* last = nullptr;
  float* tile = nullptr;
  size_t off = 0;
  carve(&last, 1, smem_raw, off);
  carve(&tile, (size_t)K * P, smem_raw, off);
  const float* q = a.gq + ((size_t)e * T + t0) * L;
  for (int k = threadIdx.x; k < steps * L; k += Q_THREADS)
    tile[k / L * P + k % L] = q[k];
  __syncthreads();
  float* out = a.queues + (size_t)e * T;
  if ((int)threadIdx.x < steps) {
    const double s = add_in_order(0.0, tile + threadIdx.x * P, L);
    out[t0 + threadIdx.x] = (float)s * a.k.dt;
  }
  if (a.grad == nullptr) return;
  __threadfence();  // this tile's sums reach the device before the count
  __syncthreads();
  if (threadIdx.x == 0)
    last[0] = atomicAdd(a.q_count + e, 1) == n_tiles - 1;
  __syncthreads();
  if (!last[0]) return;
  const int n_act = a.d.n_phases * a.d.n_inter;
  const float* w = a.q_weight + (size_t)(e / n_act) * T;
  double* term = reinterpret_cast<double*>(tile);
  const int cap = K * P / 2;  // the doubles the tile holds
  double g = 0.0;
  for (int c0 = 0; c0 < T; c0 += cap) {
    const int n = min(cap, T - c0);
    // the other tiles' sums are read from L2 (__ldcg), past this SM's L1
    for (int k = threadIdx.x; k < n; k += Q_THREADS)
      term[k] = (double)w[c0 + k] * (double)__ldcg(out + c0 + k);
    __syncthreads();
    if (threadIdx.x == 0) g = add_in_order(g, term, n);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    a.grad[e] = g;
    a.q_count[e] = 0;
  }
}

// dynamic shared memory of a body's block (B, C, D3, E, Q; A takes none)
template <class S>
size_t smem_of(int body, const Dims& d) {
  const int L = d.L;
  size_t off = 0;
  char* none = nullptr;
  if (body == BODY_B) {
    S* s = nullptr;
    carve(&s, 2 * d.n_inter, none, off);
  } else if (body == BODY_C) {
    float* f = nullptr;
    double* x = nullptr;
    carve(&f, 1, none, off);
    carve(&f, MAX_WARPS, none, off);
    carve(&x, L, none, off);
  } else if (body == BODY_D3) {
    int* i = nullptr;
    carve(&i, 3 * (size_t)L, none, off);  // the want table
  } else if (body == BODY_E) {
    float* f = nullptr;
    double* x = nullptr;
    carve(&f, 1, none, off);
    carve(&x, 2 * L, none, off);
  } else if (body == BODY_Q) {
    int* i = nullptr;
    float* f = nullptr;
    carve(&i, 1, none, off);
    carve(&f, (size_t)q_tile(L) * q_stride(L), none, off);
  }
  return off;
}

// C's and E's block (Geo) with G threads a lane: a reduction warp where the
// body folds a mean (E always, C where the signal terms were gathered)
Geo geo_of(int body, const ShardArgs& a, int G) {
  Geo g;
  g.G = G;
  g.lanes = (a.n * G + WARP - 1) / WARP * WARP;
  g.red = body == BODY_E || a.gsg != nullptr;
  return g;
}
int threads_of(const Geo& g) { return g.lanes + (g.red ? WARP : 0); }

// blocks of `threads` of `kernel` an SM holds with `smem` bytes of shared
// memory (its registers and shared memory decide), asked once for each
// kernel, width and shared memory
template <class Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem) {
#ifdef DHTS_CPU_EMULATION
  (void)kernel, (void)smem;
  return threads <= MAX_THREADS;
#else
  struct Asked {
    Kernel kernel;
    int threads;
    size_t smem;
    int n;
  };
  static std::vector<Asked> asked;
  for (const Asked& q : asked)
    if (q.kernel == kernel && q.threads == threads && q.smem == smem)
      return q.n;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) != cudaSuccess)
    n = 0;
  asked.push_back({kernel, threads, smem, n});
  return n;
#endif
}

// D3's block: its lanes' threads and, where the scene has more lanes than
// the shard, more threads for the want table, up to a lane a thread, as
// many as the kernel's registers let a block take (its lanes' at least:
// a launch that cannot hold them fails)
template <class Kernel>
int d3_threads(Kernel kernel, const ShardArgs& a) {
  const int lanes = (a.n + WARP - 1) / WARP * WARP;
  const int table = (max(a.n, a.d.L) + WARP - 1) / WARP * WARP;
  const int cap = max_threads_of(kernel, MAX_THREADS) / WARP * WARP;
  return max(lanes, min(table, min(cap, MAX_THREADS)));
}

// the card's SMs (1 in the host build)
int sm_count() {
#ifdef DHTS_CPU_EMULATION
  return 1;
#else
  static int n = -1;
  if (n < 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 1;
  }
  return n;
#endif
}

// C's threads a lane: SPLIT where a lane's interfaces and vehicles fit,
// the block stays within MAX_THREADS, an SM holds one, and its grid runs
// in no more waves than one thread a lane's does (a derivative's 180
// blocks of 72 lanes: one an SM, two waves, where one thread a lane runs
// them in one); else 1. A build with -DDHTS_SHARD_ONE_THREAD takes 1
// always (tools/shard_timing.py times the split against it; the host tests
// hold both).
template <class S>
int c_threads_a_lane(const ShardArgs& a, size_t smem) {
#ifdef DHTS_SHARD_ONE_THREAD
  (void)a, (void)smem;
  return 1;
#else
  const Geo split = geo_of(BODY_C, a, SPLIT), one = geo_of(BODY_C, a, 1);
  if (a.d.C + 1 > SPLIT || a.d.V > SPLIT * SPLIT_VEH ||
      threads_of(split) > MAX_THREADS)
    return 1;
  const int per_split =
      blocks_per_sm(shard_C_split<S>, threads_of(split), smem);
  const int per_one = blocks_per_sm(shard_C<S>, threads_of(one), smem);
  if (per_split < 1) return 1;
  const auto waves = [&](int per_sm) {
    const int wave = sm_count() * per_sm;
    return (a.N + wave - 1) / wave;
  };
  return per_one < 1 || waves(per_split) <= waves(per_one) ? SPLIT : 1;
#endif
}

// `repeat` launches of `kernel` with the arguments `a`, then `x`; a block
// of `threads` (a lane each unless the body's Geo says otherwise)
template <class S, class Kernel, class... X>
int run(Kernel kernel, int body, const ShardArgs& a, int repeat,
        void* stream, int threads, X... x) {
  // C, D3, E and Q size their shared memory by the scene's L (the folds'
  // staged terms; D3's want table; Q's tile of whole rows): within the 48
  // KB a block takes without opting in up to thousands of lanes (10.5 KB,
  // 15.6 KB, 20.7 KB and 46.7 KB for a Dual C, D3, E and Q at the 9x9
  // scene's 1,296). A larger scene is refused, not run another way.
  const size_t smem = smem_of<S>(body, a.d);
  if (smem > (size_t)Q_SMEM) return 1;  // cudaErrorInvalidValue
  const int blocks = body == BODY_Q ? a.N * q_tiles(a.d.T, a.d.L) : a.N;
  for (int r = 0; r < repeat; ++r) {
#ifdef DHTS_CPU_EMULATION
    (void)stream;
    dhts_emu::launch(blocks, threads, smem, kernel, a, x...);
#else
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(a, x...);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
#endif
  }
  return 0;
}

}  // namespace

extern "C" {

// sizeof(ShardArgs), for the wrapper to check its ctypes mirror
size_t itscp_shard_args_size() { return sizeof(ShardArgs); }

// Launch body `body` (0..4: A, B, C, D3, E; D3 the whole conversion and,
// before the last step, the next step's A rows; A for step 0) of
// step a->t on the a->N rows of one shard, in `Dual` when `dual` (the rows
// are then B * n_act dual episodes), or (5: Q) the episode's queues from the
// gathered rows a->gq, and with `dual` the gradient's terms a->grad from
// their tangents; `repeat` times back to back (1 on the
// main path; a timing asks for more, so that the host's cost of a launch
// is not in the time); `args` points to a ShardArgs (taken as void*: the
// struct's type has internal linkage, and a function with C linkage must
// not name it). Returns cudaGetLastError() of the launches, or 1
// (cudaErrorInvalidValue) for arguments it refuses, such as a shard of more
// than MAX_LANES (992) lanes or a scene whose D3 want table overruns 48 KB
// of shared memory (more than 4,096 lanes).
int launch_itscp_shard(int body, int dual, const void* args, int repeat,
                       void* stream) {
  const ShardArgs* a = static_cast<const ShardArgs*>(args);
  const Dims& d = a->d;
  if (body == BODY_Q &&
      (!a->gq || !a->queues ||
       (dual && (!a->grad || !a->q_weight || !a->q_count)) ||
       (!dual && a->grad)))
    return 1;
  if (body == BODY_C && d.mode != HARD && !a->gsg) return 1;
  if (body == BODY_D3 && (!a->gF_v || !a->gI || (dual && !a->gF_d)))
    return 1;
  if (body < BODY_A || body > BODY_Q || a->N < 1 ||
      a->n < 1 || a->n > MAX_LANES || a->off < 0 || a->off + a->n > d.L ||
      d.C < 1 || d.C > MAXC || d.V < 1 || d.R < 1 ||
      d.K < 1 || d.mode < HARD || d.mode > SOFT || a->t < 0 ||
      a->t >= d.T || (dual && (d.mode == HARD || !a->dbuf)) ||
      (!dual && a->dbuf) || repeat < 1)
    return 1;
  const int r = repeat, nt = (a->n + WARP - 1) / WARP * WARP;
  const size_t smem_c = smem_of<float>(BODY_C, d);
  const int G = body != BODY_C ? 1
                : dual         ? c_threads_a_lane<Dual>(*a, smem_c)
                               : c_threads_a_lane<float>(*a, smem_c);
  const Geo g = geo_of(body, *a, G);
  const int gt = threads_of(g);
  if (dual) {
    switch (body) {
      case BODY_A: return run<Dual>(shard_A<Dual>, body, *a, r, stream, nt);
      case BODY_B: return run<Dual>(shard_B<Dual>, body, *a, r, stream, nt);
      case BODY_C:
        return g.G == SPLIT
                   ? run<Dual>(shard_C_split<Dual>, body, *a, r, stream, gt,
                               g)
                   : run<Dual>(shard_C<Dual>, body, *a, r, stream, gt, g);
      case BODY_D3: {
        const int t3 = d3_threads(shard_D3<Dual>, *a);
        return run<Dual>(shard_D3<Dual>, body, *a, r, stream, t3, t3);
      }
      case BODY_E:
        return run<Dual>(shard_E<Dual>, body, *a, r, stream, gt, g);
      default:
        return run<float>(shard_Q, body, *a, r, stream, Q_THREADS);
    }
  }
  switch (body) {
    case BODY_A: return run<float>(shard_A<float>, body, *a, r, stream, nt);
    case BODY_B: return run<float>(shard_B<float>, body, *a, r, stream, nt);
    case BODY_C:
      return g.G == SPLIT
                 ? run<float>(shard_C_split<float>, body, *a, r, stream, gt,
                              g)
                 : run<float>(shard_C<float>, body, *a, r, stream, gt, g);
    case BODY_D3: {
      const int t3 = d3_threads(shard_D3<float>, *a);
      return run<float>(shard_D3<float>, body, *a, r, stream, t3, t3);
    }
    case BODY_E: return run<float>(shard_E<float>, body, *a, r, stream, gt, g);
    default: return run<float>(shard_Q, body, *a, r, stream, Q_THREADS);
  }
}

#ifdef DHTS_SHARD_CLOCK
// The cycle stamps summed since the last reset, shard_cycles[SH_PARTS +
// SH_LAUNCHES] (the parts of ShardPart, then the C, E, B and D3 launches
// stamped), into host memory `out`; `reset` zeroes them first instead.
// Returns the CUDA error code.
int itscp_shard_clock(long long* out, int reset) {
#ifdef DHTS_CPU_EMULATION
  for (int i = 0; i < SH_PARTS + SH_LAUNCHES; ++i) {
    if (reset) shard_cycles[i] = 0;
    out[i] = shard_cycles[i];
  }
  return 0;
#else
  if (reset) {
    const long long zero[SH_PARTS + SH_LAUNCHES] = {};
    const cudaError_t err =
        cudaMemcpyToSymbol(shard_cycles, zero, sizeof(zero));
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaMemcpyFromSymbol(out, shard_cycles,
                                   sizeof(long long) *
                                       (SH_PARTS + SH_LAUNCHES));
#endif
}

// The local lane whose thread stamps B's and D3's parts. Returns the CUDA
// error code.
int itscp_shard_clock_lane(int lane) {
  if (lane < 0 || lane >= MAX_LANES) return 1;
#ifdef DHTS_CPU_EMULATION
  shard_clock_lane = lane;
  return 0;
#else
  return (int)cudaMemcpyToSymbol(shard_clock_lane, &lane, sizeof(int));
#endif
}

// Each local lane's own cycles summed since the last reset (block 0),
// shard_lane_cycles[0..n), into host memory `out`; `reset` zeroes them
// first instead. Returns the CUDA error code.
int itscp_shard_clock_lanes(long long* out, int n, int reset) {
  if (n < 0 || n > 1024) return 1;
#ifdef DHTS_CPU_EMULATION
  for (int i = 0; i < n; ++i) {
    if (reset) shard_lane_cycles[i] = 0;
    out[i] = shard_lane_cycles[i];
  }
  return 0;
#else
  if (reset) {
    long long zero[1024] = {};
    const cudaError_t err = cudaMemcpyToSymbol(shard_lane_cycles, zero,
                                               sizeof(long long) * n);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaMemcpyFromSymbol(out, shard_lane_cycles,
                                   sizeof(long long) * n);
#endif
}
#endif

}  // extern "C"
