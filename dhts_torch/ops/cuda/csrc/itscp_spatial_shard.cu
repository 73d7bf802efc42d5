// The fused spatial ITSCP step with the lanes sharded, for Hopper (sm_90a):
// one kernel per per-shard body, a forward in hard or soft gate mode and a
// forward-mode derivative of the differentiable bodies.
//
// Replaces the TPU kernels K6 and K5 of dhts/ops/pallas/itscp_spatial_step.py
// on a lane axis of more than one shard: body_A (:279), body_B (:302),
// body_C (:440), body_D1 (:544), body_D2 (:592), body_D3 (:621) and body_E
// (:847), wrapped at :883-919 by make_dkernel (A, B, C, D3, E;
// dhts/ops/pallas/dkernel.py: forward pallas_call at :63, backward at :91)
// and make_kernel_sg (D1, D2; :154). A further kernel, Q, does body_E's lane
// sum of q^2 (:861-865) once per episode over the gathered rows, and in a
// derivative the loss weights' sum over the steps. The specification is the plain PyTorch
// bodies beside the wrapper (dhts_torch/ops/cuda/itscp_spatial_shard.py::
// plain_body_A ... plain_body_E): every per-lane value is computed with the
// same IEEE operations in the same order (-fmad=false, no fast math), so
// carries, summaries and events agree bit for bit.
//
// Design. This is the single-shard STEP kernel (itscp_spatial_step.cu) with
// each barrier at which one lane reads another's summary replaced by a
// kernel boundary and a collective over the lane axis. One launch is one
// body of one simulation step: one block per episode (forward) or per
// (episode, action entry) (derivative, `Dual`), one thread per local lane.
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
// per-lane terms gathered over the lane axis, by one thread in lane order in
// float64 and rounded once, as the STEP kernel sums them, so the sharded
// episode equals the single-shard one bit for bit at any shard count. In
// hard mode the signal mean sharpens nothing, and a split lane axis does not
// gather its terms (C then leaves it as it is), as JAX's sharded step.
//
// Bound. Each launch moves the shard's share of a step's state (the macro
// cells, the vehicles present, the counters) and the gathered rows, a few
// KB per episode, through short chains of dependent loads: latency-bound,
// far above the bytes / 3.35 TB/s floor. Q (below) is bound by its bytes.

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
  const float* gF_v;    // D1, D3: [N, 15, L]
  const float* gF_d;
  const int* gI;        // D1, D2, D3: [N, 4, L]
  int* wrow;            // D1: [N, 3, n]
  int* pred;            // D1: [N, 4, n]
  const int* gW;        // D2: [N, 3, L]
  int* bd;              // D2: [N, 2, n]
  const int* gV;        // D3: [N, 2, L]
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
enum { BODY_A, BODY_B, BODY_C, BODY_D1, BODY_D2, BODY_D3, BODY_E, BODY_Q };
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

// what convert() reads of the gathered rows (the STEP kernel's shared
// summaries)
template <class S>
struct ConvRows {
  const int *best, *dep_best;
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

// ======================= A: pre-physics summary ==========================
template <class S>
__global__ void shard_A(ShardArgs a) {
  Block<S> k = block_of<S>(a);
  if (!k.lane) return;
  const Dims& d = a.d;
  const Consts& c = a.k;
  const int L = d.L, gl = k.gl, t = a.t;
  auto& st = k.st;
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
  const size_t base = (size_t)k.e * A_ROWS * a.n + k.j;
  const S rows[A_ROWS] = {rf, uf, rl, ul, S((float)cnt), ld<S>(st.pos, i0),
                          ld<S>(st.vel, i0), S(st.param(5, i0)),
                          S(inj ? 1.0f : 0.0f)};
  for (int r = 0; r < A_ROWS; ++r)
    put_row(a.sumA_v, a.sumA_d, base + (size_t)r * a.n, rows[r]);
}

// ============ B: injection, ghosts, leader walk, the head's signal =========
template <class S>
__global__ void shard_B(ShardArgs a) {
  DHTS_DYNAMIC_SMEM(smem_raw);
  const Dims& d = a.d;
  const Consts& c = a.k;
  const int L = d.L, V = d.V, n = a.n, t = a.t;
  S* sig = nullptr;
  int* inj_n = nullptr;
  size_t off_s = 0;
  carve(&sig, L, smem_raw, off_s);
  carve(&inj_n, n, smem_raw, off_s);
  Block<S> k = block_of<S>(a);
  auto& st = k.st;
  const LaneGeom& g = k.g;
  const Scene& sc = k.sc;
  const int gl = k.gl;
  auto clampL = [&](int q) { return min(max(q, 0), L - 1); };
  // every lane's signal (the ghosts and the head's blend read others')
  const int threads = ((n + 31) / 32) * 32;  // the launch's block size
  for (int i = threadIdx.x; i < L; i += threads)
    sig[i] = lane_signal<S>(a.action, a.prog, d, c,
                            lane_geom(sc, L, d.K, i), t, k.seed);
  __syncthreads();

  int injected = 0;
  if (k.lane) {
    const float* gv = a.gA_v + (size_t)k.e * A_ROWS * L;
    const float* gd = k.dual ? a.gA_d + (size_t)k.e * A_ROWS * L : nullptr;
    auto gA = [&](int r, int i) {
      return from_parts<S>(gv[r * L + i], gd, (size_t)r * L + i);
    };
    auto g_inj = [&](int i) { return gv[8 * L + i] > 0.5f; };
    auto g_count = [&](int i) {
      return (int)gv[4 * L + i] + (g_inj(i) ? 1 : 0);
    };
    const float incoming = g.has_prev ? -1.0f : a.sched[t * L + gl];

    // apply the injection of this lane's gathered bit
    if (g_inj(gl)) {
      const int pool_idx = min(max(d.P - st.inj_left[gl], 0), d.P - 1);
      st.insert_tail(gl, V, S(0.0f), S(0.0f), S(c.veh_len), nullptr,
                     gl * d.P + pool_idx, 0);
      st.count[gl] += 1;
      st.inj_left[gl] -= 1;
      injected = 1;
    }

    // macro ghosts from the neighbours' gathered edge cells
    const int mp = a.mprev[t * L + gl], mn = a.mnext[t * L + gl];
    const int adjp = g.num_prev == 1 ? g.prev0 : mp;
    const int adjp_c = clampL(adjp);
    const bool use_l =
        (g.num_prev > 0) && (adjp >= 0) && sc.macro_at(adjp_c);
    S gl_r = use_l ? gA(2, adjp_c) : S(0.0f);
    S gl_u = use_l ? gA(3, adjp_c) : S(c.u_max);
    if (!g.has_prev) { gl_r = incoming; gl_u = u_eq(S(incoming), c.u_max); }
    const S prev_sig = !g.has_prev ? S(1.0f)
                                   : (mp < 0 ? S(0.0f) : sig[clampL(mp)]);
    const S bl_r = gl_r * prev_sig;
    const S bl_u = gl_u * prev_sig + S(c.u_max) * (S(1.0f) - prev_sig);
    const int adjn = g.num_next == 1 ? g.next0 : mn;
    const int adjn_c = clampL(adjn);
    const bool use_r =
        (g.num_next > 0) && (adjn >= 0) && sc.macro_at(adjn_c);
    const S gr_r = use_r ? gA(0, adjn_c) : S(0.0f);
    const S gr_u = use_r ? gA(1, adjn_c) : S(c.u_max);

    // virtual leader: walk the head vehicle's route over the gathered
    // counts and tails (after this step's injections)
    float* len_ = st.par[5];
    const int cnt = st.count[gl];
    const bool exists = cnt > 0;
    const int hi = st.vi(gl, min(max(cnt - 1, 0), V - 1));
    const S hpos = ld<S>(st.pos, hi), hvel = ld<S>(st.vel, hi);
    const float hlen = len_[hi];
    const int hrid = st.rid[hi], hridx = st.ridx[hi];
    const S base = (S(g.length) - hpos) - S(hlen * 0.5f);
    bool done = !exists, found = false;
    int wstar = -1;
    S cdel_st = 0.0f, cur = base;
    for (int q = 0; q < d.W && !done; ++q) {
      const int wl = route_at(sc.inj, sc.emit, hrid, hridx + 1 + q, d);
      const bool ex = wl >= 0;
      const int wc = clampL(wl);
      const bool w_macro = ex && sc.macro_at(wc);
      if (ex && !w_macro && g_count(wc) > 0) {
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
    // the signal the head sees, blended over its previous, current and next
    // route lane
    const S red_pd = vmax((S(g.length) - hpos) - S(hlen * 0.5f), S(0.0f));
    const int prev_l = route_at(sc.inj, sc.emit, hrid, hridx - 1, d);
    const int next_l = route_at(sc.inj, sc.emit, hrid, hridx + 1, d);
    const int curr_l = route_at(sc.inj, sc.emit, hrid, hridx, d);
    const bool prev_exist = prev_l >= 0, next_exist = next_l >= 0;
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
    auto sig_at = [&](int q) { return q >= 0 ? sig[clampL(q)] : S(0.0f); };
    S fsig = c_sc * sig_at(curr_l);
    fsig = fsig + (prev_exist ? p_sc * sig_at(prev_l) : S(0.0f));
    fsig = fsig + (next_exist ? n_sc * sig_at(next_l) : S(0.0f));
    const bool blend = exists && !g.is_macro;

    const size_t base_bc = (size_t)k.e * BC_ROWS * n + k.j;
    const S rows[BC_ROWS] = {bl_r, bl_u, gr_r, gr_u, sig[gl], pd_g, sd_g,
                             red_pd, fsig, S(blend ? 1.0f : 0.0f)};
    for (int r = 0; r < BC_ROWS; ++r)
      put_row(a.bc_v, a.bc_d, base_bc + (size_t)r * n, rows[r]);
    const size_t base_sg = (size_t)k.e * 2 * n + k.j;
    a.sg[base_sg] = blend ? val(fsig) : 0.0f;
    a.sg[base_sg + n] = blend ? 1.0f : 0.0f;
    inj_n[k.j] = injected;
  }
  __syncthreads();
  if (threadIdx.x == 0 && !k.dual) {
    int tot = 0;
    for (int q = 0; q < n; ++q) tot += inj_n[q];
    a.events[((size_t)k.e * d.T + t) * 3] = tot;
  }
}

// ====== C: signal blend, physics, flux capacitors, post-physics rows ======
template <class S>
__global__ void shard_C(ShardArgs a) {
  DHTS_DYNAMIC_SMEM(smem_raw);
  const Dims& d = a.d;
  const Consts& c = a.k;
  const int L = d.L, V = d.V, K = d.K, n = a.n, t = a.t;
  float* ms = nullptr;
  float* wave_l = nullptr;
  size_t off_s = 0;
  carve(&ms, 1, smem_raw, off_s);
  carve(&wave_l, n, smem_raw, off_s);
  Block<S> k = block_of<S>(a);
  auto& st = k.st;
  const LaneGeom& g = k.g;
  const Scene& sc = k.sc;
  const int gl = k.gl;
  auto clampL = [&](int q) { return min(max(q, 0), L - 1); };
  if (threadIdx.x == 0 && a.gsg != nullptr) {
    // signal running mean from the gathered per-lane terms, in lane order;
    // its detached mean sharpens the blend gate (soft modes only)
    const float* gs = a.gsg + (size_t)k.e * 2 * L;
    double tot = 0.0;
    int cnt = 0;
    for (int q = 0; q < L; ++q) { tot += (double)gs[q]; cnt += (int)gs[L + q]; }
    float* sg_ms = k.F + k.o.sg;
    sg_ms[0] = sg_ms[0] + (float)tot;
    sg_ms[1] = sg_ms[1] + (float)cnt;
    const float mean = sg_ms[0] / fmaxf(sg_ms[1], 1.0f);
    ms[0] = c.gate32 / fmaxf(fabsf(mean), 1e-6f);
  }
  __syncthreads();

  if (k.lane) {
    const float* bv = a.bc_v + (size_t)k.e * BC_ROWS * n + k.j;
    const float* bdp = k.dual ? a.bc_d + (size_t)k.e * BC_ROWS * n + k.j
                              : nullptr;
    auto bc = [&](int r) { return from_parts<S>(bv[r * n], bdp, r * n); };
    const S bl_r = bc(0), bl_u = bc(1), gr_r = bc(2), gr_u = bc(3);
    const S sig_l = bc(4), pd_g = bc(5), sd_g = bc(6), red_pd = bc(7);
    const S fsig = bc(8);
    const bool blend = bv[9 * n] > 0.5f;
    S sg;
    if (d.mode == HARD) {
      sg = val(sig_l) > 0.5f ? 1.0f : 0.0f;
    } else {
      sg = stg(val(sig_l) > 0.5f, soft(sig_l - S(0.5f), c.gate32), d.mode);
    }
    const Ghosts<S> gh{bl_r, bl_u, gr_r * sg + S(1.0f) * (S(1.0f) - sg),
                       gr_u * sg};
    float lane_wave = 0.0f;
    if (g.is_macro) {
      lane_wave = godunov_lane<S>(st, g, gl, d.C, gh, c);
    } else {
      S pd = pd_g, sd = sd_g;
      if (blend) {
        if (d.mode != HARD) {
          const S fs = soft(fsig - S(0.5f), ms[0]);
          pd = pd_g * fs + red_pd * (S(1.0f) - fs);
          sd = sd_g * fs;
        } else {
          const bool green = val(fsig) >= 0.5f;
          pd = green ? pd_g : red_pd;
          sd = green ? sd_g : S(0.0f);
        }
      }
      idm_lane<S>(st, gl, pd, sd, c);
    }
    wave_l[k.j] = lane_wave;

    // the flux capacitor toward the next lane, and the post-physics rows
    const int last = min(max(g.num_cell - 1, 0), d.C - 1);
    const S rl = ld<S>(st.r, st.ci(gl, last));
    const S ul = comp_u(rl, ld<S>(st.y, st.ci(gl, last)), c.u_max);
    const int mn = a.mnext[t * L + gl];
    const int mn_c = clampL(mn);
    const bool next_is_micro = g.is_macro && mn >= 0 && !sc.macro_at(mn_c);
    const S inc = next_is_micro ? (rl * ul) * S(c.dt) : S(0.0f);
    int slot = -1;
    for (int q = 0; q < K; ++q) {
      const int nq = sc.lane_i[(8 + K + q) * L + gl];
      if (nq >= 0 && nq == mn) { slot = q; break; }
    }
    S cap_v = 0.0f;
    if (slot >= 0) {
      cap_v = ld<S>(st.cap, st.ki(gl, slot)) + inc;
      put(st.cap, st.ki(gl, slot), cap_v);
    }
    const int cnt = st.count[gl];
    const int i0 = st.vi(gl, 0);
    const int hi = st.vi(gl, min(max(cnt - 1, 0), V - 1));
    const S rows[F_ROWS] = {
        rl, ul, S((float)cnt), ld<S>(st.pos, i0), S(st.param(5, i0)), cap_v,
        ld<S>(st.pos, hi), ld<S>(st.vel, hi), S(st.param(5, hi)),
        ld<S>(st.av, hi), S(st.param(0, hi)), S(st.param(1, hi)),
        S(st.param(2, hi)), S(st.param(3, hi)), S(st.param(4, hi))};
    const size_t base_f = (size_t)k.e * F_ROWS * n + k.j;
    for (int r = 0; r < F_ROWS; ++r)
      put_row(a.sumF_v, a.sumF_d, base_f + (size_t)r * n, rows[r]);
    const int hrid = st.rid[hi], hridx = st.ridx[hi];
    int* si = a.sumI + (size_t)k.e * I_ROWS * n + k.j;
    si[I_MN * n] = mn;
    si[I_RIDX * n] = hridx;
    si[I_HNEXT * n] = route_at(sc.inj, sc.emit, hrid, hridx + 1, d);
    si[I_RID * n] = hrid;
  }
  __syncthreads();
  if (threadIdx.x == 0 && !k.dual) {
    float wave = 0.0f;
    for (int q = 0; q < n; ++q) wave = fmaxf(wave, wave_l[q]);
    a.waves[(size_t)k.e * d.T + t] = wave;
  }
}

// ================ D1: wants at the gathered destinations ================
__global__ void shard_D1(ShardArgs a) {
  Block<float> k = block_of<float>(a);
  if (!k.lane) return;
  const Dims& d = a.d;
  const Consts& c = a.k;
  const int L = d.L, n = a.n, j = k.j;
  const LaneGeom& g = k.g;
  const Scene& sc = k.sc;
  auto clampL = [&](int q) { return min(max(q, 0), L - 1); };
  const float* gF = a.gF_v + (size_t)k.e * F_ROWS * L;
  const float* sF = a.sumF_v + (size_t)k.e * F_ROWS * n;
  const int* sI = a.sumI + (size_t)k.e * I_ROWS * n;
  const int mn = sI[I_MN * n + j], hnext = sI[I_HNEXT * n + j];
  const int mn_c = clampL(mn), hn_c = clampL(hnext);
  const bool next_is_micro = g.is_macro && mn >= 0 && !sc.macro_at(mn_c);
  const int dest_n = mn >= 0 ? (int)gF[F_COUNT * L + mn_c] : 0;
  const float free_n =
      dest_n > 0 ? gF[F_TPOS * L + mn_c] - 0.5f * gF[F_TLEN * L + mn_c]
                 : (mn >= 0 ? sc.length_at(mn_c) : 0.0f);
  const bool want_emit = next_is_micro && sF[F_CAP * n + j] >= c.veh_len &&
                         free_n >= c.veh_len && dest_n < d.V;
  const bool exists = k.st.count[k.gl] > 0;
  const float hpos = sF[F_HPOS * n + j], hlen = sF[F_HLEN * n + j];
  const bool past_end = exists && hpos >= g.length;
  const bool hn_macro = hnext >= 0 && sc.macro_at(hn_c);
  const bool hn_micro = hnext >= 0 && !hn_macro;
  const bool exit_none = past_end && hnext < 0;
  const bool want_tr =
      past_end && hn_micro && (int)gF[F_COUNT * L + hn_c] < d.V;
  const bool want_dep = exists && hn_macro && hpos > g.length + hlen;
  int* w = a.wrow + (size_t)k.e * 3 * n + j;
  w[0] = want_emit ? 1 : 0;
  w[n] = want_tr ? hnext : -2;
  w[2 * n] = want_dep ? hnext : -2;
  int* p = a.pred + (size_t)k.e * 4 * n + j;
  p[0] = exit_none; p[n] = want_emit; p[2 * n] = want_tr; p[3 * n] = want_dep;
}

// ===== D2: arbitration (pull: each local destination, lowest source) =====
__global__ void shard_D2(ShardArgs a) {
  const int n = a.n, j = threadIdx.x, e = blockIdx.x;
  if (j >= n) return;
  const int L = a.d.L, K = a.d.K, gl = a.off + j;
  const int* gW = a.gW + (size_t)e * 3 * L;
  const int* gI = a.gI + (size_t)e * I_ROWS * L;
  int best = L, dep_best = L;
  for (int q = 0; q < K; ++q) {
    const int pk = a.lane_i[(8 + q) * L + gl];
    if (pk < 0) continue;
    if ((gW[pk] != 0 && gI[I_MN * L + pk] == gl) || gW[L + pk] == gl)
      best = min(best, pk);
    if (gW[2 * L + pk] == gl) dep_best = min(dep_best, pk);
  }
  a.bd[(size_t)e * 2 * n + j] = best;
  a.bd[(size_t)e * 2 * n + n + j] = dep_best;
}

// ===== D3: verdicts, removals, inserts, deposits, static-mean terms =====
template <class S>
__global__ void shard_D3(ShardArgs a) {
  DHTS_DYNAMIC_SMEM(smem_raw);
  const Dims& d = a.d;
  const Consts& c = a.k;
  const int L = d.L, K = d.K, n = a.n, t = a.t;
  int* ev = nullptr;
  size_t off_s = 0;
  carve(&ev, 2 * n, smem_raw, off_s);
  Block<S> k = block_of<S>(a);
  if (k.lane) {
    const int gl = k.gl, j = k.j;
    const float* fv = a.gF_v + (size_t)k.e * F_ROWS * L;
    const float* fd = k.dual ? a.gF_d + (size_t)k.e * F_ROWS * L : nullptr;
    const int* gI = a.gI + (size_t)k.e * I_ROWS * L;
    const int* gV = a.gV + (size_t)k.e * 2 * L;
    auto row = [&](int r) {
      return RowS<S>{fv + r * L, fd ? fd + r * L : nullptr};
    };
    const ConvRows<S> s{gV, gV + L, row(F_ULAST), row(F_CAP), row(F_HPOS),
                        row(F_HVEL), row(F_HA), fv + F_HLEN * L,
                        fv + F_AMAX * L, gI + I_RID * L, gI + I_RIDX * L};
    const int* pr = a.pred + (size_t)k.e * 4 * n + j;
    Request<S> q;
    q.mn = gI[I_MN * L + gl];
    q.hnext = gI[I_HNEXT * L + gl];
    q.exit_none = pr[0] != 0;
    q.want = (pr[n] ? W_EMIT : 0) | (pr[2 * n] ? W_TRANSFER : 0) |
             (pr[3 * n] ? W_DEPOSIT : 0);
    q.slot = -1;
    for (int r = 0; r < K; ++r) {
      const int nq = k.sc.lane_i[(8 + K + r) * L + gl];
      if (nq >= 0 && nq == q.mn) { q.slot = r; break; }
    }
    q.cap_v = q.slot >= 0 ? s.cap_val[gl] : S(0.0f);
    const Verdict vd = convert<S>(k.st, s, k.sc, k.g, q, d, c, gl);
    ev[j] = vd.is_emit ? 1 : 0;
    ev[n + j] = (vd.exit_none || vd.dep_win) ? 1 : 0;
    // this lane's static running-mean terms, after the conversion (rows of
    // n lanes, addressed by global id)
    TermRows terms{a.ss + (size_t)k.e * 2 * n - a.off,
                   a.ssn + (size_t)k.e * 2 * n - a.off};
    static_partials<S>(k.st, terms, k.g, n, gl, vd.n, c);
  }
  __syncthreads();
  if (threadIdx.x == 0 && !k.dual) {
    int emit = 0, absorb = 0;
    for (int q = 0; q < n; ++q) { emit += ev[q]; absorb += ev[n + q]; }
    int* out = a.events + ((size_t)k.e * d.T + t) * 3;
    out[1] = emit;
    out[2] = absorb;
  }
}

// ====================== E: the lanes' squared queues ======================
template <class S>
__global__ void shard_E(ShardArgs a) {
  DHTS_DYNAMIC_SMEM(smem_raw);
  const Dims& d = a.d;
  const int L = d.L, n = a.n;
  float* ms = nullptr;
  size_t off_s = 0;
  carve(&ms, 1, smem_raw, off_s);
  Block<S> k = block_of<S>(a);
  if (threadIdx.x == 0) {
    // static running mean from the gathered per-lane terms, in lane order
    const double* gs = a.gss + (size_t)k.e * 2 * L;
    const int* gn = a.gssn + (size_t)k.e * 2 * L;
    double cells = 0.0, vehs = 0.0;
    int nc = 0, nv = 0;
    for (int q = 0; q < L; ++q) {
      cells += gs[q]; vehs += gs[L + q];
      nc += gn[q]; nv += gn[L + q];
    }
    float* ss_ms = k.F + k.o.ss;
    ss_ms[0] = ss_ms[0] + ((float)cells + (float)vehs);
    ss_ms[1] = ss_ms[1] + ((float)nc + (float)nv);
    const float mean = ss_ms[0] / fmaxf(ss_ms[1], 1.0f);
    ms[0] = 16.0f / fmaxf(fabsf(mean), 1e-6f);
  }
  __syncthreads();
  if (k.lane) {
    const S q = lane_queue<S>(k.st, k.g, k.gl, k.st.count[k.gl], d.mode,
                              ms[0], a.k);
    put_row(a.q_v, a.q_d, ((size_t)k.e * d.T + a.t) * n + k.j, q * q);
  }
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

// dynamic shared memory of a body's block
template <class S>
size_t smem_of(int body, int L, int n) {
  size_t off = 0;
  char* none = nullptr;
  if (body == BODY_B) {
    S* s = nullptr;
    int* i = nullptr;
    carve(&s, L, none, off);
    carve(&i, n, none, off);
  } else if (body == BODY_C) {
    float* f = nullptr;
    carve(&f, 1, none, off);
    carve(&f, n, none, off);
  } else if (body == BODY_D3) {
    int* i = nullptr;
    carve(&i, 2 * n, none, off);
  } else if (body == BODY_E) {
    float* f = nullptr;
    carve(&f, 1, none, off);
  } else if (body == BODY_Q) {
    int* i = nullptr;
    float* f = nullptr;
    carve(&i, 1, none, off);
    carve(&f, (size_t)q_tile(L) * q_stride(L), none, off);
  }
  return off;
}

template <class S, class Kernel>
int run(Kernel kernel, int body, const ShardArgs& a, int repeat,
        void* stream) {
  // B and Q size their shared memory by the scene's L (a step's gathered
  // signals; Q's tile of whole rows): within the 48 KB a block takes
  // without opting in up to thousands of lanes (10.4 KB and 46.7 KB for a
  // Dual B and Q at the 9x9 scene's 1,296)
  const size_t smem = smem_of<S>(body, a.d.L, a.n);
  if (smem > (size_t)Q_SMEM) return 1;  // cudaErrorInvalidValue
  const int threads = body == BODY_Q ? Q_THREADS : ((a.n + 31) / 32) * 32;
  const int blocks = body == BODY_Q ? a.N * q_tiles(a.d.T, a.d.L) : a.N;
  for (int r = 0; r < repeat; ++r) {
#ifdef DHTS_CPU_EMULATION
    (void)stream;
    dhts_emu::launch(blocks, threads, smem, kernel, a);
#else
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(a);
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

// Launch body `body` (0..6: A, B, C, D1, D2, D3, E) of step a->t on the
// a->N rows of one shard, in `Dual` when `dual` (A, B, C, D3, E; the rows
// are then B * n_act dual episodes), or (7: Q) the episode's queues from the
// gathered rows a->gq, and with `dual` the gradient's terms a->grad from
// their tangents; `repeat` times back to back (1 on the
// main path; a timing asks for more, so that the host's cost of a launch
// is not in the time); `args` points to a ShardArgs (taken as void*: the
// struct's type has internal linkage, and a function with C linkage must
// not name it). Returns cudaGetLastError() of the launches, or 1
// (cudaErrorInvalidValue) for arguments it refuses.
int launch_itscp_shard(int body, int dual, const void* args, int repeat,
                       void* stream) {
  const ShardArgs* a = static_cast<const ShardArgs*>(args);
  const Dims& d = a->d;
  const bool dual_ok = body == BODY_A || body == BODY_B || body == BODY_C ||
                       body == BODY_D3 || body == BODY_E || body == BODY_Q;
  if (body == BODY_Q &&
      (!a->gq || !a->queues ||
       (dual && (!a->grad || !a->q_weight || !a->q_count)) ||
       (!dual && a->grad)))
    return 1;
  if (body == BODY_C && d.mode != HARD && !a->gsg) return 1;
  if (body < BODY_A || body > BODY_Q || (dual && !dual_ok) || a->N < 1 ||
      a->n < 1 || a->n > 1024 || a->off < 0 || a->off + a->n > d.L ||
      d.C < 1 || d.C > MAXC || d.V < 1 || d.R < 1 ||
      d.K < 1 || d.mode < HARD || d.mode > SOFT || a->t < 0 ||
      a->t >= d.T || (dual && (d.mode == HARD || !a->dbuf)) ||
      (!dual && a->dbuf && dual_ok) || repeat < 1)
    return 1;
  const int r = repeat;
  if (dual) {
    switch (body) {
      case BODY_A: return run<Dual>(shard_A<Dual>, body, *a, r, stream);
      case BODY_B: return run<Dual>(shard_B<Dual>, body, *a, r, stream);
      case BODY_C: return run<Dual>(shard_C<Dual>, body, *a, r, stream);
      case BODY_D3: return run<Dual>(shard_D3<Dual>, body, *a, r, stream);
      case BODY_E: return run<Dual>(shard_E<Dual>, body, *a, r, stream);
      default: return run<float>(shard_Q, body, *a, r, stream);
    }
  }
  switch (body) {
    case BODY_A: return run<float>(shard_A<float>, body, *a, r, stream);
    case BODY_B: return run<float>(shard_B<float>, body, *a, r, stream);
    case BODY_C: return run<float>(shard_C<float>, body, *a, r, stream);
    case BODY_D1: return run<float>(shard_D1, body, *a, r, stream);
    case BODY_D2: return run<float>(shard_D2, body, *a, r, stream);
    case BODY_D3: return run<float>(shard_D3<float>, body, *a, r, stream);
    case BODY_E: return run<float>(shard_E<float>, body, *a, r, stream);
    default: return run<float>(shard_Q, body, *a, r, stream);
  }
}

}  // extern "C"
