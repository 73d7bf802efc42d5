// Fused IDM micro-lane rollout for Hopper (sm_90a), forward and backward.
//
// Replaces the TPU kernel K3,
// dhts/ops/pallas/micro_rollout.py::make_fused_micro_rollout:
//   * forward (fwd_kernel :107, pallas_call :123; step `_mstep` :34): T
//     explicit-Euler IDM steps of a platoon of V vehicles (slot v follows
//     slot v + 1; the head, slot V - 1, sees the constant virtual leader
//     deltas), per scenario of a batch of B, returning (posT, velT);
//   * backward (bwd_kernel :134, pallas_call :152): the vector-Jacobian
//     product with respect to pos0 and vel0.
// Its specification is the plain PyTorch version beside its wrapper
// (dhts_torch/ops/cuda/micro_rollout.py::plain_micro_rollout, a loop of
// dhts_torch.ops.idm.micro_lane_step with every slot active): the same IEEE
// float32 operations in the same order (-fmad=false, no fast math), so the
// forward agrees with it bit for bit. The six per-vehicle parameters are
// shared by the batch, as in the JAX kernel.
//
// Design, V <= 32 (the inverse benchmark's V = 10). Forward: one warp per
// scenario; lane v holds vehicle v's position, speed and constants in
// registers and gets its leader's state by __shfl_down_sync. Lanes past
// the platoon repeat its head, so that they take the head's path and no
// other; the head's deltas are a select. The time loop has no shared
// memory and no barrier. Given a trajectory buffer (the wrapper allocates
// one only when autograd will need it) the forward writes every step's
// state into it, [B, T, 2, V]: the JAX kernel's residuals (traj_p, traj_v).
// Backward: the JAX kernel's reverse sweep, one warp per scenario. Lane v
// carries the cotangents of vehicle v's position and speed from t = T back
// to 0; at step t it recomputes the step from the saved state (the same
// float operations, so the same collisions, gap floors, spacing clips and
// acceleration floors), takes the new speed's partial derivatives by hand
// and pulls the cotangents back, its leader's share by __shfl_up_sync. A
// speed the acceleration floor stopped passes no gradient, a tie of a max
// splits it 0.5 / 0.5 and a collision zeroes both deltas' partials, as
// autograd of the plain version does. Only the short cotangent update is
// carried from step to step, so ROUND steps are recomputed together and
// the next round's rows load during this one. Without a saved trajectory
// (micro_rollout_bwd's own calls) the same launch first replays the
// forward into a scratch trajectory the wrapper allocates.
//
// Divisions. An IEEE division is a block of its own behind its slow
// path's branch (BSSY/BSYNC), so nothing overlaps it, and a zero dividend
// (the head's 0 / idm_den at the benchmark, a stopped vehicle's 0 / tgt)
// takes that path, about 100 cycles more: on an H100 the four divisions
// took 58 % of PR 6's stamped forward step, 75 % of its Dual step and
// about 70 % of a warp kernel's (python -m dhts_torch.ops.cuda.k3_clock).
// The warp kernels divide with div_checked: a quotient from a reciprocal
// (of a constant divisor rounded once, of the gap MUFU.RCP) and one
// correction, accepted only where its exact remainder shows it is the
// nearest float, which is the IEEE quotient. The forward checks a chunk of
// CHUNK steps at once and runs a chunk in which any lane's check failed
// again from its first state with IEEE divisions; the reverse sweep
// recomputes a round so when a check fails. So the steps have no division
// branch, and every quotient is the IEEE division's.

// Above one warp (V > 32) the PR 6 kernels stay: one block per scenario,
// one thread per vehicle, the platoon double-buffered in shared memory
// with one barrier a step; and the backward in forward mode, block (b, j)
// running scenario b on dual numbers (dhts_scalar.cuh) whose tangent seeds
// entry j of 2V (pos0[b, 0..V), vel0[b, 0..V)), writing
//     g_in[b, j] = sum_v g_pT[b, v] d posT[b, v]/d in_j
//                        + g_vT[b, v] d velT[b, v]/d in_j.
// The launchers choose by V; launch_micro_rollout_fwd_smem and
// launch_micro_rollout_bwd run those kernels at any V.
//
// Bound. Inputs and outputs are a few floats per vehicle (the trajectory
// 8 T V bytes a scenario), so the floor is the T V B IDM updates' float32
// operations; the kernels are latency-bound instead: T dependent steps,
// each a chain of about 25 operations with two divisions on it, in one
// warp per scenario (the backward's steps overlap; it is bound by the
// warp's issue of a step's recomputation, partials and checks).

#include "dhts_scalar.cuh"

// Cycle stamps: built with -DDHTS_STEP_CLOCK (python -m
// dhts_torch.ops.cuda.k3_clock), every thread adds up the clock64() cycles
// of each part of its steps, and thread 0 of block 0 writes its sums to
// the launch's `cycles`. A part ends when its last value is ready: the mark
// first stores that value to a volatile sink, which waits for it, and then
// reads the clock. Parts 0-9 are a forward step's (PR 6's kernel stamps
// its step through idm_step_marked, a copy of idm_step with the marks),
// 10-13 a reverse step's. Without the macro the stamps compile to nothing
// and PR 6's kernel is its unstamped text.
#ifdef DHTS_STEP_CLOCK
constexpr int CLOCK_PARTS = 14;
__device__ float clock_sink_value;
struct Clock {
  long long t, c[CLOCK_PARTS];
  __device__ void start() {
    for (int k = 0; k < CLOCK_PARTS; ++k) c[k] = 0;
    t = clock64();
  }
  __device__ __forceinline__ void sink(float x) {
    *(volatile float*)&clock_sink_value = x;
  }
  __device__ __forceinline__ void sink(Dual x) {
    sink(x.v);
    sink(x.d);
  }
  __device__ __forceinline__ void mark(int k) {
    const long long now = clock64();
    c[k] += now - t;
    t = now;
  }
  __device__ void save(long long* out) const {
    if (out && blockIdx.x == 0 && threadIdx.x == 0)
      for (int k = 0; k < CLOCK_PARTS; ++k) out[k] = c[k];
  }
};
#else
struct Clock {
  __device__ void start() {}
  template <class S>
  __device__ __forceinline__ void sink(const S&) {}
  __device__ __forceinline__ void mark(int) {}
  __device__ void save(long long*) const {}
};
#endif

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_VEHICLES = 32;  // the most vehicles of the warp kernels

template <class S>
__device__ __forceinline__ S seeded(float x, bool) {
  return S(x);
}
template <>
__device__ __forceinline__ Dual seeded<Dual>(float x, bool seed) {
  return Dual(x, seed ? 1.0f : 0.0f);
}

struct Args {
  const float *pos0, *vel0;
  const float* params;         // [6, V]: amax, apref, tgt, min_space,
                               // time_pref, length
  float *posT, *velT;          // forward outputs
  const float *g_pT, *g_vT;    // backward cotangents
  float* g_in;                 // backward output [B, 2V]
  int T, V;
  float head_pd, head_sd, dt;
#ifdef DHTS_STEP_CLOCK
  long long* cycles;           // [CLOCK_PARTS] of block 0, thread 0
#endif
};

#ifdef DHTS_STEP_CLOCK
// idm_step (dhts_scalar.cuh) op for op, closing parts 2-8 of the step: 2
// the collision, the gap's floor and (sp sdel) / idm_den; 3 the spacing's
// sum and clip; 4 sp / tgt; 5 os / pdel; 6 the acceleration; 7 -sp / dt; 8
// the floor's max and the Euler update
template <class S>
__device__ __forceinline__ void idm_step_marked(
    S p, S sp, S pdel, S sdel, float amax, float tgt, float min_space,
    float time_pref, float idm_den, float dt, S& new_p, S& new_v,
    Clock& clk) {
  if (val(pdel) < 0.0f) { pdel = 0.0f; sdel = 0.0f; }
  pdel = vmax(pdel, S(EPS));
  const S sds = (sp * sdel) / S(idm_den);
  clk.sink(sds);
  clk.mark(2);
  const S os = vmax((S(min_space) + sp * S(time_pref)) + sds, S(0.0f));
  clk.sink(os);
  clk.mark(3);
  const S q = sp / S(tgt);
  clk.sink(q);
  clk.mark(4);
  const S q2 = q * q;
  const S z = os / pdel;
  clk.sink(z);
  clk.mark(5);
  const S acc_raw = S(amax) * ((S(1.0f) - q2 * q2) - z * z);
  clk.sink(acc_raw);
  clk.mark(6);
  const S acc_floor = -sp / S(dt);
  clk.sink(acc_floor);
  clk.mark(7);
  const S acc = vmax(acc_raw, acc_floor);
  new_p = p + S(dt) * sp;
  const S nv = sp + S(dt) * acc;
  new_v = val(acc_raw) < val(acc_floor) ? detached(nv) : nv;
  clk.sink(new_v);
  clk.mark(8);
}
#endif

// Dynamic shared memory: positions and speeds [2][V] as S (two buffers).
template <class S>
__host__ __device__ inline size_t smem_bytes(int V) {
  return sizeof(S) * (size_t)(4 * V);
}

// PR 6's kernel: one block per scenario (forward) or per scenario and
// seeded entry (Dual backward), one thread per vehicle.
template <class S>
__global__ void micro_rollout_kernel(Args a) {
  DHTS_DYNAMIC_SMEM(smem_raw);
  const int V = a.V;
  const int n_in = 2 * V;
  const bool bwd = sizeof(S) != sizeof(float);
  const int b = bwd ? blockIdx.x / n_in : blockIdx.x;
  const int seed = bwd ? blockIdx.x % n_in : -1;
  const int v = threadIdx.x;
  const bool veh = v < V;
  S* pos = reinterpret_cast<S*>(smem_raw);  // pos[buf * V + v]
  S* vel = pos + 2 * V;

  float amax = 1.0f, apref = 1.0f, tgt = 1.0f, min_space = 0.0f;
  float time_pref = 0.0f, len = 0.0f, lead_len = 0.0f;
  if (veh) {
    amax = a.params[0 * V + v];
    apref = a.params[1 * V + v];
    tgt = a.params[2 * V + v];
    min_space = a.params[3 * V + v];
    time_pref = a.params[4 * V + v];
    len = a.params[5 * V + v];
    lead_len = v + 1 < V ? a.params[5 * V + v + 1] : 0.0f;
    pos[v] = seeded<S>(a.pos0[b * V + v], seed == v);
    vel[v] = seeded<S>(a.vel0[b * V + v], seed == V + v);
  }
  const float idm_den = 2.0f * sqrtf(amax * apref);
  const float half_len = (lead_len + len) * 0.5f;
  __syncthreads();

  int cur = 0;
#ifdef DHTS_STEP_CLOCK
  Clock clk;
  clk.start();
  for (int t = 0; t < a.T; ++t) {
    if (veh) {
      const S p = pos[cur * V + v], sp = vel[cur * V + v];
      S pdel, sdel;
      if (v == V - 1) {
        pdel = S(a.head_pd);
        sdel = S(a.head_sd);
      } else {
        const S lp = pos[cur * V + v + 1], ls = vel[cur * V + v + 1];
        clk.sink(p);
        clk.sink(sp);
        clk.sink(lp);
        clk.sink(ls);
        clk.mark(0);  // the neighbour exchange: shared-memory loads
        pdel = vabs(lp - p) - S(half_len);
        sdel = sp - ls;
      }
      clk.sink(pdel);
      clk.sink(sdel);
      clk.mark(1);  // the gap and the speed difference
      S np_, nv_;
      idm_step_marked(p, sp, pdel, sdel, amax, tgt, min_space, time_pref,
                      idm_den, a.dt, np_, nv_, clk);
      pos[(1 - cur) * V + v] = np_;
      vel[(1 - cur) * V + v] = nv_;
    }
    cur = 1 - cur;
    __syncthreads();
    clk.mark(9);  // the stores and the barrier
  }
  clk.save(a.cycles);
#else
  for (int t = 0; t < a.T; ++t) {
    if (veh) {
      const S p = pos[cur * V + v], sp = vel[cur * V + v];
      S pdel, sdel;
      if (v == V - 1) {
        pdel = S(a.head_pd);
        sdel = S(a.head_sd);
      } else {
        pdel = vabs(pos[cur * V + v + 1] - p) - S(half_len);
        sdel = sp - vel[cur * V + v + 1];
      }
      S np_, nv_;
      idm_step(p, sp, pdel, sdel, amax, tgt, min_space, time_pref, idm_den,
               a.dt, np_, nv_);
      pos[(1 - cur) * V + v] = np_;
      vel[(1 - cur) * V + v] = nv_;
    }
    cur = 1 - cur;
    __syncthreads();
  }
#endif

  if (!bwd) {
    if (veh) {
      a.posT[b * V + v] = val(pos[cur * V + v]);
      a.velT[b * V + v] = val(vel[cur * V + v]);
    }
  } else if (v == 0) {
    double acc = 0.0;
    for (int j = 0; j < V; ++j)
      acc += (double)a.g_pT[b * V + j] * (double)tangent(pos[cur * V + j]) +
             (double)a.g_vT[b * V + j] * (double)tangent(vel[cur * V + j]);
    a.g_in[b * n_in + seed] = (float)acc;
  }
}

template <class S>
int launch(int blocks, const Args& a, void* stream) {
  if (a.V < 1 || a.V > 1024 || a.T < 0 || blocks < 1) return 1;
  const int threads = ((a.V + 31) / 32) * 32;
  const size_t smem = smem_bytes<S>(a.V);
#ifdef DHTS_CPU_EMULATION
  (void)stream;
  dhts_emu::launch(blocks, threads, smem, micro_rollout_kernel<S>, a);
  return 0;
#else
  micro_rollout_kernel<S><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
#endif
}

// ---------------------------------------------------------------------------
// the warp kernels (V <= 32)
// ---------------------------------------------------------------------------

struct WarpArgs {
  const float *pos0, *vel0;
  const float* params;         // [6, V], as Args
  float *posT, *velT;          // forward outputs
  const float *g_pT, *g_vT;    // backward cotangents
  float* g_in;                 // backward output [B, 2V]
  float* traj;                 // [B, T, 2, V] or null (forward)
  int T, V;
  float head_pd, head_sd, dt;
  long long* cycles;           // DHTS_STEP_CLOCK: [CLOCK_PARTS]
};

#ifdef DHTS_CPU_EMULATION
inline unsigned float_bits(float x) {
  unsigned u;
  memcpy(&u, &x, sizeof u);
  return u;
}
inline float bits_float(unsigned u) {
  float x;
  memcpy(&x, &u, sizeof x);
  return x;
}
// the host's stand-in for the card's approximate reciprocal: one ulp off
// the rounded one, so that the correction and its check do work here too
inline float rcp_approx(float b) { return nextafterf(1.0f / b, INFINITY); }
#else
__device__ __forceinline__ unsigned float_bits(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ float bits_float(unsigned u) {
  return __uint_as_float(u);
}
// MUFU.RCP: 1 / b within about an ulp, no branch
__device__ __forceinline__ float rcp_approx(float b) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(b));
  return y;
}
#endif

// a / b rounded to nearest, as the IEEE division gives it, from y, an
// approximation of 1 / b within a few ulps, without a branch: q = a y and
// one correction, q += (a - q b) y. A normal q is the nearest float to a /
// b if |a / b - q| < ulp(q) / 2, that is |a - q b| < |b| ulp(q) / 2 (a
// quotient of two floats is never halfway between two floats); a power of
// two, whose lower neighbour is half as far, if |a - q b| < |b| ulp(q) /
// 4. Both sides are computed with one rounding each (the remainder by an
// fma, the bound by a product with a power of two), and rounding is
// monotonic, so the test never accepts a q that is not the nearest; where
// the two are exact it accepts the nearest. A zero a over a normal b gives
// the zero a y, the IEEE quotient's. `ok` turns false where the test does
// not accept: the caller then divides.
__device__ __forceinline__ float div_checked(float a, float b, float y,
                                             bool& ok) {
  const float q0 = a * y;
  const float q = fmaf(fmaf(-q0, b, a), y, q0);
  const float r = fmaf(-q, b, a);
  const unsigned bits = float_bits(q), e = bits & 0x7f800000u;
  const unsigned shift = (bits & 0x7fffffu) ? 24u << 23 : 25u << 23;
  const float bound = bits_float(e - shift);  // a float if e >= 26 << 23
  const bool nearest = e - (26u << 23) <= (228u << 23) &&
                       fabsf(r) < fabsf(b) * bound;
  const bool zero = a == 0.0f &&
                    (float_bits(b) & 0x7f800000u) - (1u << 23) < (254u << 23);
  ok = ok && (nearest || zero);
  return zero ? q0 : q;
}

// vehicle i's constants, and the reciprocals of its constant divisors
struct Vehicle {
  float amax, tgt, min_space, time_pref, idm_den, half_len;
  float inv_tgt, inv_den;
  __device__ Vehicle(const float* params, int V, int i) {
    amax = params[0 * V + i];
    const float apref = params[1 * V + i];
    tgt = params[2 * V + i];
    min_space = params[3 * V + i];
    time_pref = params[4 * V + i];
    const float len = params[5 * V + i];
    const float lead_len = i + 1 < V ? params[5 * V + i + 1] : 0.0f;
    idm_den = 2.0f * sqrtf(amax * apref);
    half_len = (lead_len + len) * 0.5f;
    inv_tgt = 1.0f / tgt;
    inv_den = 1.0f / idm_den;
  }
};

// A step's values: idm_step's operations in its order, with what the
// reverse sweep differentiates.
struct Step {
  float pdel, sdel;  // after the collision's zeroing; pdel after its floor
  bool collided, floored;
  float sds, os, q, z, acc_raw, acc_floor, new_p, new_v;
  float inv_pdel;    // about 1 / pdel
};

// The step's values with the divisions of div_checked (kIeee: the IEEE
// divisions); false if a check failed. The stamps close parts 2-8 as
// idm_step_marked's.
template <bool kIeee>
__device__ __forceinline__ bool step_values(float p, float sp, float pdel,
                                            float sdel, const Vehicle& c,
                                            float dt, float inv_dt, Step& s,
                                            Clock& clk) {
  bool ok = true;
  auto div = [&](float a, float b, float y) {
    return kIeee ? a / b : div_checked(a, b, y, ok);
  };
  s.collided = pdel < 0.0f;
  s.pdel = fmaxf(s.collided ? 0.0f : pdel, EPS);
  s.sdel = s.collided ? 0.0f : sdel;
  s.inv_pdel = rcp_approx(s.pdel);
  s.sds = div(sp * s.sdel, c.idm_den, c.inv_den);
  clk.sink(s.sds);
  clk.mark(2);
  s.os = fmaxf((c.min_space + sp * c.time_pref) + s.sds, 0.0f);
  clk.sink(s.os);
  clk.mark(3);
  s.q = div(sp, c.tgt, c.inv_tgt);
  clk.sink(s.q);
  clk.mark(4);
  const float q2 = s.q * s.q;
  s.z = div(s.os, s.pdel, s.inv_pdel);
  clk.sink(s.z);
  clk.mark(5);
  s.acc_raw = c.amax * ((1.0f - q2 * q2) - s.z * s.z);
  clk.sink(s.acc_raw);
  clk.mark(6);
  s.acc_floor = div(-sp, dt, inv_dt);
  clk.sink(s.acc_floor);
  clk.mark(7);
  const float acc = fmaxf(s.acc_raw, s.acc_floor);
  s.new_p = p + dt * sp;
  s.new_v = sp + dt * acc;
  s.floored = s.acc_raw < s.acc_floor;
  clk.sink(s.new_v);
  clk.mark(8);
  return ok;
}

// Whether any lane of the warp has x
__device__ __forceinline__ bool warp_any(bool x) {
#ifdef DHTS_CPU_EMULATION
  int v = x;
  for (int o = 16; o > 0; o >>= 1) v |= __shfl_down_sync(FULL, v, o);
  return __shfl_sync(FULL, v, 0) != 0;
#else
  return __any_sync(FULL, x);
#endif
}

// The gap and speed difference of lane `head` or of a follower, from the
// leader's state (lp, ls): a select, not a branch
__device__ __forceinline__ void deltas(float p, float sp, float lp, float ls,
                                       bool head, const Vehicle& c,
                                       const WarpArgs& a, float& pdel,
                                       float& sdel) {
  pdel = head ? a.head_pd : fabsf(lp - p) - c.half_len;
  sdel = head ? a.head_sd : sp - ls;
}

// Steps t0 .. t1 - 1 of the warp's platoon from (p, sp) of vehicle i
// (kIeee: with the IEEE divisions); with kSave, each lane writes the state
// before each step to traj[t][0 / 1][i] (lanes past the platoon write the
// head's own values: no branch). False if a check failed.
template <bool kSave, bool kIeee>
__device__ __forceinline__ bool forward_chunk(const WarpArgs& a,
                                              const Vehicle& c, int i,
                                              float inv_dt, int t0, int t1,
                                              float& p, float& sp,
                                              float* traj, Clock& clk) {
  const int V = a.V;
  const bool head = i == V - 1;
  bool ok = true;
  for (int t = t0; t < t1; ++t) {
    if (kSave) {
      traj[(2 * t) * V + i] = p;
      traj[(2 * t + 1) * V + i] = sp;
    }
    clk.mark(9);  // the trajectory's stores
    const float lp = __shfl_down_sync(FULL, p, 1);
    const float ls = __shfl_down_sync(FULL, sp, 1);
    clk.sink(lp);
    clk.sink(ls);
    clk.mark(0);  // the neighbour exchange: two shuffles
    float pdel, sdel;
    deltas(p, sp, lp, ls, head, c, a, pdel, sdel);
    clk.sink(pdel);
    clk.sink(sdel);
    clk.mark(1);  // the gap and the speed difference
    Step s;
    ok &= step_values<kIeee>(p, sp, pdel, sdel, c, a.dt, inv_dt, s, clk);
    p = s.new_p;
    sp = s.new_v;
  }
  return ok;
}

// Steps of one chunk between two checks: a chunk whose checks failed in
// any lane runs again from its first state with the IEEE divisions
constexpr int CHUNK = 16;

// T forward steps of the warp's platoon from (p, sp) of vehicle i, in
// chunks of CHUNK steps; kSave as forward_chunk's
template <bool kSave>
__device__ __forceinline__ void forward_steps(const WarpArgs& a,
                                              const Vehicle& c, int i,
                                              float& p, float& sp,
                                              float* traj, Clock& clk) {
  const float inv_dt = 1.0f / a.dt;
  for (int t0 = 0; t0 < a.T; t0 += CHUNK) {
    const int t1 = min(t0 + CHUNK, a.T);
    const float p0 = p, sp0 = sp;
    const bool ok = forward_chunk<kSave, false>(a, c, i, inv_dt, t0, t1, p,
                                                sp, traj, clk);
    if (warp_any(!ok)) {
      p = p0;
      sp = sp0;
      Clock quiet;
      forward_chunk<kSave, true>(a, c, i, inv_dt, t0, t1, p, sp, traj,
                                 quiet);
    }
  }
}

// One warp per scenario; lane v is vehicle min(v, V - 1).
template <bool kSave>
__global__ void micro_rollout_warp(WarpArgs a) {
  const int V = a.V, b = blockIdx.x, lane = threadIdx.x;
  const int i = min(lane, V - 1);
  const Vehicle c(a.params, V, i);
  float p = a.pos0[b * V + i], sp = a.vel0[b * V + i];
  Clock clk;
  clk.start();
  forward_steps<kSave>(a, c, i, p, sp, a.traj + (size_t)b * a.T * 2 * V,
                       clk);
  clk.save(a.cycles);
  if (lane < V) {
    a.posT[b * V + lane] = p;
    a.velT[b * V + lane] = sp;
  }
}

// d new_v / d (own position, own speed, leader's position, leader's speed)
struct Partials {
  float p, sp, lp, ls;
};

// 1 above, 0 below, 0.5 at a tie: the share of max(x, y)'s gradient x gets
__device__ __forceinline__ float max_share(float x, float y) {
  return x > y ? 1.0f : (x < y ? 0.0f : 0.5f);
}

// The step's partials, from its recomputed values (autograd of the plain
// step: a floored speed passes nothing, ties split, a collision or the
// head's constant deltas pass nothing to the gap and speed difference)
__device__ __forceinline__ Partials partials_of(const Step& s, float sp,
                                                float gap_sign, bool head,
                                                float pdel_raw,
                                                const Vehicle& c, float dt,
                                                float inv_dt) {
  const bool live = !s.floored;
  const float w_raw = max_share(s.acc_raw, s.acc_floor);
  const float c_raw = live ? dt * w_raw : 0.0f;  // d new_v / d acc_raw
  const float c_flr = live ? dt * (1.0f - w_raw) : 0.0f;
  const float os_raw = (c.min_space + sp * c.time_pref) + s.sds;
  const float m_os = max_share(os_raw, 0.0f);
  const bool deltas_live = !head && !s.collided;
  const float m_pd = deltas_live ? max_share(pdel_raw, EPS) : 0.0f;
  const float m_sd = deltas_live ? 1.0f : 0.0f;
  const float inv_pdel = s.inv_pdel;
  const float inv_den = c.inv_den;
  const float k_z = c_raw * (-2.0f * c.amax * s.z);  // d new_v / d z
  const float k_os = k_z * inv_pdel * m_os;           // ... / d os_raw
  const float k_pd = -(k_z * s.z * inv_pdel) * m_pd;  // ... / d pdel_raw
  const float k_sd = k_os * sp * inv_den * m_sd;      // ... / d sdel_raw
  const float q2 = s.q * s.q;
  Partials d;
  d.sp = ((live ? 1.0f : 0.0f) - c_flr * inv_dt) +
         c_raw * (-4.0f * c.amax * q2 * s.q) * c.inv_tgt +
         k_os * (c.time_pref + s.sdel * inv_den) + k_sd;
  d.ls = -k_sd;
  d.p = -gap_sign * k_pd;
  d.lp = gap_sign * k_pd;
  return d;
}

// A reverse step's inputs: the own and the leader's position and speed
// before step t
struct Rows {
  float p, sp, lp, ls;
};

__device__ __forceinline__ Rows rows_at(const float* traj, int t, int V,
                                        int i, int li) {
  const float* row = traj + (size_t)t * 2 * V;
  return Rows{row[i], row[V + i], row[li], row[V + li]};
}

// A step recomputed from its rows: its values (kIeee: with the IEEE
// divisions) and its raw gap; false if a check failed
template <bool kIeee>
__device__ __forceinline__ bool recompute(const Rows& r, bool head,
                                          const Vehicle& c,
                                          const WarpArgs& a, float inv_dt,
                                          float& pdel, Step& s) {
  float sdel;
  deltas(r.p, r.sp, r.lp, r.ls, head, c, a, pdel, sdel);
  Clock quiet;  // a recomputed step's own parts are not stamped
  return step_values<kIeee>(r.p, r.sp, pdel, sdel, c, a.dt, inv_dt, s,
                            quiet);
}

__device__ __forceinline__ Partials partials_at(const Rows& r, const Step& s,
                                                float pdel, bool head,
                                                const Vehicle& c, float dt,
                                                float inv_dt) {
  const float gap = r.lp - r.p;
  const float sign = gap > 0.0f ? 1.0f : (gap < 0.0f ? -1.0f : 0.0f);
  return partials_of(s, r.sp, sign, head, pdel, c, dt, inv_dt);
}

// The cotangents pulled back through a step, the follower's (lane - 1's)
// share of this vehicle's by a shuffle
__device__ __forceinline__ void pull_back(const Partials& d, float dt,
                                          int lane, float& gp, float& gv) {
  float fp = __shfl_up_sync(FULL, gv * d.lp, 1);
  float fv = __shfl_up_sync(FULL, gv * d.ls, 1);
  if (lane == 0) fp = fv = 0.0f;
  const float gp_new = (gp + gv * d.p) + fp;
  gv = (gp * dt + gv * d.sp) + fv;
  gp = gp_new;
}

// Steps a round of the reverse sweep
constexpr int ROUND = 4;

// The reverse sweep, one warp per scenario (lane v is vehicle min(v, V -
// 1)); kReplay: replay the forward into traj first. ROUND steps a round:
// all are recomputed before the one branch to their IEEE fallback, so
// their chains overlap; the next round's rows load during this one.
template <bool kReplay>
__global__ void micro_rollout_reverse(WarpArgs a) {
  const int V = a.V, T = a.T, b = blockIdx.x, lane = threadIdx.x;
  const int i = min(lane, V - 1), li = min(i + 1, V - 1);
  const bool head = i == V - 1;
  const Vehicle c(a.params, V, i);
  const float* traj = a.traj + (size_t)b * T * 2 * V;
  Clock clk;
  clk.start();
  if (kReplay) {
    float p = a.pos0[b * V + i], sp = a.vel0[b * V + i];
    forward_steps<true>(a, c, i, p, sp, a.traj + (size_t)b * T * 2 * V,
                        clk);
    __syncwarp();
  }
  const float dt = a.dt, inv_dt = 1.0f / dt;
  float gp = a.g_pT[b * V + i], gv = a.g_vT[b * V + i];
  int t = T - 1;
  for (; t >= 0 && (t + 1) % ROUND != 0; --t) {  // the last steps alone
    const Rows r = rows_at(traj, t, V, i, li);
    float pdel;
    Step s;
    if (!recompute<false>(r, head, c, a, inv_dt, pdel, s))
      recompute<true>(r, head, c, a, inv_dt, pdel, s);
    pull_back(partials_at(r, s, pdel, head, c, dt, inv_dt), dt, lane, gp,
              gv);
  }
  Rows next[ROUND];  // steps t, t - 1, ...
  if (t >= 0) {
#pragma unroll
    for (int k = 0; k < ROUND; ++k) next[k] = rows_at(traj, t - k, V, i, li);
  }
  for (; t >= 0; t -= ROUND) {
    Rows r[ROUND];
#pragma unroll
    for (int k = 0; k < ROUND; ++k) r[k] = next[k];
    if (t >= ROUND) {
#pragma unroll
      for (int k = 0; k < ROUND; ++k)
        next[k] = rows_at(traj, t - ROUND - k, V, i, li);
    }
    clk.sink(r[0].p + r[0].sp + r[ROUND - 1].lp + r[ROUND - 1].ls);
    clk.mark(10);  // the rows
    float pdel[ROUND];
    Step s[ROUND];
    bool ok = true;
#pragma unroll
    for (int k = 0; k < ROUND; ++k)
      ok &= recompute<false>(r[k], head, c, a, inv_dt, pdel[k], s[k]);
    if (!ok) {
#pragma unroll
      for (int k = 0; k < ROUND; ++k)
        recompute<true>(r[k], head, c, a, inv_dt, pdel[k], s[k]);
    }
    clk.sink(s[0].new_v + s[ROUND - 1].new_v);
    clk.mark(11);  // the steps recomputed
    Partials d[ROUND];
#pragma unroll
    for (int k = 0; k < ROUND; ++k)
      d[k] = partials_at(r[k], s[k], pdel[k], head, c, dt, inv_dt);
    clk.sink(d[0].sp + d[ROUND - 1].sp);
    clk.mark(12);  // the partials
#pragma unroll
    for (int k = 0; k < ROUND; ++k) pull_back(d[k], dt, lane, gp, gv);
    clk.sink(gp + gv);
    clk.mark(13);  // the cotangents' update
  }
  clk.save(a.cycles);
  if (lane < V) {
    a.g_in[b * 2 * V + lane] = gp;
    a.g_in[b * 2 * V + V + lane] = gv;
  }
}

template <class A>
int launch_warp(void (*kernel)(A), int B, const A& a, void* stream) {
#ifdef DHTS_CPU_EMULATION
  (void)stream;
  dhts_emu::launch(B, WARP_VEHICLES, 0, kernel, a);
  return 0;
#else
  kernel<<<B, WARP_VEHICLES, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
#endif
}

bool warp_sizes_ok(int B, int T, int V) {
  return B >= 1 && T >= 0 && V >= 1 && V <= WARP_VEHICLES;
}

// the warp forward; saves the trajectory if traj is not null
int launch_forward_warp(int B, const WarpArgs& a, void* stream) {
  if (!warp_sizes_ok(B, a.T, a.V)) return 1;
  return a.traj ? launch_warp(micro_rollout_warp<true>, B, a, stream)
                : launch_warp(micro_rollout_warp<false>, B, a, stream);
}

// the reverse sweep over a saved trajectory, or (replay) over the
// trajectory it first writes there
int launch_reverse(int B, const WarpArgs& a, void* stream, bool replay) {
  if (!warp_sizes_ok(B, a.T, a.V) || (a.T > 0 && !a.traj)) return 1;
  return replay ? launch_warp(micro_rollout_reverse<true>, B, a, stream)
                : launch_warp(micro_rollout_reverse<false>, B, a, stream);
}

// div_checked on n pairs, its y from MUFU.RCP (rounded: y = 1 / b rounded
// once, as for a constant divisor); ok[k] = 1 where the check accepted
__global__ void div_check_kernel(const float* a, const float* b, float* q,
                                 int* ok, int n, int rounded) {
  const int k = blockIdx.x * 256 + threadIdx.x;  // 256 threads a block
  if (k >= n) return;
  bool good = true;
  const float y = rounded ? 1.0f / b[k] : rcp_approx(b[k]);
  q[k] = div_checked(a[k], b[k], y, good);
  ok[k] = good;
}

}  // namespace

extern "C" {

// The test of div_checked: q[k] and ok[k] for a[k] / b[k], k < n.
int launch_micro_rollout_div_check(const float* a, const float* b, float* q,
                                   int* ok, int n, int rounded,
                                   void* stream) {
  if (n < 1) return 1;
  const int blocks = (n + 255) / 256;
#ifdef DHTS_CPU_EMULATION
  (void)stream;
  dhts_emu::launch(blocks, 256, 0, div_check_kernel, a, b, q, ok, n,
                   rounded);
  return 0;
#else
  div_check_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(a, b, q, ok, n,
                                                            rounded);
  return (int)cudaGetLastError();
#endif
}

// Forward: B platoons of V vehicles, T steps; posT, velT [B, V]; the warp
// kernel for V <= 32, the shared-memory one above. Returns
// cudaGetLastError() of the launch (1 for invalid sizes).
int launch_micro_rollout_fwd(const float* pos0, const float* vel0,
                             const float* params, float* posT, float* velT,
                             int B, int T, int V, float head_pd,
                             float head_sd, float dt, void* stream) {
  if (V <= WARP_VEHICLES) {
    const WarpArgs w{pos0, vel0, params, posT, velT, nullptr, nullptr,
                     nullptr, nullptr, T, V, head_pd, head_sd, dt, nullptr};
    return launch_forward_warp(B, w, stream);
  }
  const Args a{pos0, vel0, params, posT, velT, nullptr, nullptr, nullptr,
               T, V, head_pd, head_sd, dt};
  return launch<float>(B, a, stream);
}

// The warp forward (V <= 32) that also writes each step's state to traj
// [B, T, 2, V] (positions, then speeds), unless traj is null.
int launch_micro_rollout_fwd_save(const float* pos0, const float* vel0,
                                  const float* params, float* posT,
                                  float* velT, float* traj, int B, int T,
                                  int V, float head_pd, float head_sd,
                                  float dt, void* stream) {
  const WarpArgs w{pos0, vel0, params, posT, velT, nullptr, nullptr,
                   nullptr, traj, T, V, head_pd, head_sd, dt, nullptr};
  return launch_forward_warp(B, w, stream);
}

// The forward through the shared-memory kernel at any V.
int launch_micro_rollout_fwd_smem(const float* pos0, const float* vel0,
                                  const float* params, float* posT,
                                  float* velT, int B, int T, int V,
                                  float head_pd, float head_sd, float dt,
                                  void* stream) {
  const Args a{pos0, vel0, params, posT, velT, nullptr, nullptr, nullptr,
               T, V, head_pd, head_sd, dt};
  return launch<float>(B, a, stream);
}

// Backward in forward mode at any V (the launcher above one warp):
// g_in[B, 2V] = the cotangents (g_pT, g_vT [B, V]) pulled back to (pos0,
// vel0), one Dual block per (b, entry).
int launch_micro_rollout_bwd(const float* pos0, const float* vel0,
                             const float* params, const float* g_pT,
                             const float* g_vT, float* g_in, int B, int T,
                             int V, float head_pd, float head_sd, float dt,
                             void* stream) {
  const Args a{pos0, vel0, params, nullptr, nullptr, g_pT, g_vT, g_in,
               T, V, head_pd, head_sd, dt};
  return launch<Dual>(B * 2 * V, a, stream);
}

// Backward by the reverse sweep (V <= 32) over the trajectory
// launch_micro_rollout_fwd_save wrote for the same inputs; g_in as above.
int launch_micro_rollout_bwd_saved(const float* pos0, const float* vel0,
                                   const float* params, const float* g_pT,
                                   const float* g_vT, float* g_in,
                                   float* traj, int B, int T, int V,
                                   float head_pd, float head_sd, float dt,
                                   void* stream) {
  const WarpArgs w{pos0, vel0, params, nullptr, nullptr, g_pT, g_vT, g_in,
                   traj, T, V, head_pd, head_sd, dt, nullptr};
  return launch_reverse(B, w, stream, false);
}

// The same after replaying the forward into `scratch` [B, T, 2, V], in the
// same launch: the backward without a saved trajectory.
int launch_micro_rollout_bwd_replay(const float* pos0, const float* vel0,
                                    const float* params, const float* g_pT,
                                    const float* g_vT, float* g_in,
                                    float* scratch, int B, int T, int V,
                                    float head_pd, float head_sd, float dt,
                                    void* stream) {
  const WarpArgs w{pos0, vel0, params, nullptr, nullptr, g_pT, g_vT, g_in,
                   scratch, T, V, head_pd, head_sd, dt, nullptr};
  return launch_reverse(B, w, stream, true);
}

#ifdef DHTS_STEP_CLOCK
// The forward (kernel 0: the shared-memory kernel; 1: the warp kernel,
// saving into traj unless it is null) and the backward (kernel 0: the Dual
// blocks; 1: the reverse sweep over traj; 2: the same after replaying into
// traj) with the steps' cycle stamps of block 0, thread 0 in
// cycles[CLOCK_PARTS]; 1 for an unknown kernel or invalid sizes.
int launch_micro_rollout_fwd_clock(const float* pos0, const float* vel0,
                                   const float* params, float* posT,
                                   float* velT, float* traj, int B, int T,
                                   int V, float head_pd, float head_sd,
                                   float dt, void* stream, int kernel,
                                   long long* cycles) {
  if (kernel == 1) {
    const WarpArgs w{pos0, vel0, params, posT, velT, nullptr, nullptr,
                     nullptr, traj, T, V, head_pd, head_sd, dt, cycles};
    return launch_forward_warp(B, w, stream);
  }
  Args a{pos0, vel0, params, posT, velT, nullptr, nullptr, nullptr,
         T, V, head_pd, head_sd, dt};
  a.cycles = cycles;
  return kernel == 0 ? launch<float>(B, a, stream) : 1;
}

int launch_micro_rollout_bwd_clock(const float* pos0, const float* vel0,
                                   const float* params, const float* g_pT,
                                   const float* g_vT, float* g_in,
                                   float* traj, int B, int T, int V,
                                   float head_pd, float head_sd, float dt,
                                   void* stream, int kernel,
                                   long long* cycles) {
  if (kernel == 1 || kernel == 2) {
    const WarpArgs w{pos0, vel0, params, nullptr, nullptr, g_pT, g_vT,
                     g_in, traj, T, V, head_pd, head_sd, dt, cycles};
    return launch_reverse(B, w, stream, kernel == 2);
  }
  Args a{pos0, vel0, params, nullptr, nullptr, g_pT, g_vT, g_in,
         T, V, head_pd, head_sd, dt};
  a.cycles = cycles;
  return kernel == 0 ? launch<Dual>(B * 2 * V, a, stream) : 1;
}
#endif

}  // extern "C"
