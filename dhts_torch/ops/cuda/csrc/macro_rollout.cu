// Fused ARZ macro-lane rollout for Hopper (sm_90a), forward and backward.
//
// Replaces the TPU kernel K2,
// dhts/ops/pallas/macro_rollout.py::make_fused_macro_rollout:
//   * forward (fwd_kernel :101, pallas_call :120; step `_step` :48): T
//     Godunov steps of a lane of C cells between constant ghost cells, per
//     scenario of a batch of B, returning (rT, yT, max_wave);
//   * backward (bwd_kernel :134, pallas_call :162): the vector-Jacobian
//     product with respect to all six inputs (r0, y0 and the four ghost
//     values).
// Its specification is the plain PyTorch version beside its wrapper
// (dhts_torch/ops/cuda/macro_rollout.py::plain_macro_rollout, a loop of
// dhts_torch.ops.arz.godunov_step): the same IEEE float32 operations in the
// same order (-fmad=false, no fast math, dt / dx divided in float32 as
// arz.rdiv does), so the forward agrees with it bit for bit.
//
// Design. One warp per scenario (C <= 31): lane i holds cell i's r, y in
// registers, computes its u once per step, solves the Riemann problem at
// interface i (0..C, the ghost cells at lanes 0 and C) from its left
// neighbour's state, which arrives by __shfl_sync, and updates its cell
// with the flux of interface i + 1, which arrives by __shfl_down_sync. The
// time loop has no shared memory and no barrier; the largest wave speed is
// reduced across the warp by shuffles at the end. Above one warp of cells
// (C > 31) the lane stays in shared memory: thread i solves interface i
// and updates cell i, with two barriers per step (after the fluxes are
// published and after the cells are updated). The JAX kernel's layout
// (cells on sublanes padded to 8, the batch on lanes padded to 128,
// right-ghost plateau rows) is not carried over. The forward keeps no
// trajectory.
//
// Backward: forward-mode tangents, as K1's backward. The step is a template
// on its scalar type (dhts_scalar.cuh): block (b, j) runs scenario b on
// dual numbers whose tangent seeds input entry j of 2C + 4 (r0[b, 0..C),
// y0[b, 0..C), bl_r, bl_u, br_r, br_u) and writes
//     g_in[b, j] = sum_c g_rT[b, c] d rT[b, c]/d in_j
//                        + g_yT[b, c] d yT[b, c]/d in_j,
// the TPU kernel's vector-Jacobian product, from the forward's inputs and
// the cotangents alone: no residuals, no transposed Riemann solver. B (2C +
// 4) blocks run side by side (24 per scenario at C = 10).
//
// Bound. Inputs and outputs are (2C + 4) B floats each way, so bytes bound
// the work at nothing; the floor is the T (C + 1) B Riemann solves' float32
// operations. The kernel is latency-bound instead: T dependent steps, each
// a chain of about a hundred dependent operations (correctly rounded
// divisions and square roots among them), one warp per scenario. On an
// H100 (python -m dhts_torch.ops.cuda.step_clock, C = 10, B = 1) a step
// with the cells in shared memory took 1,697 cycles: the neighbours' states
// (two comp_u) 529, the Riemann solve 924, the exchanges, barriers and
// update 244. The register design keeps one comp_u and the solve on the
// chain and two shuffles of the rest (its split: PERF.md, section 5).

#include "dhts_scalar.cuh"

// Built with -DDHTS_STEP_CLOCK (python -m dhts_torch.ops.cuda.step_clock),
// thread 0 of block 0 adds up the clock64() cycles of each part of a step
// into Args::cycles; otherwise the marks compile to nothing.
#ifdef DHTS_STEP_CLOCK
#define CLOCK_INIT long long clk_t = clock64(), clk[4] = {0, 0, 0, 0}
#define CLOCK_MARK(k)                   \
  do {                                  \
    const long long now_ = clock64();   \
    clk[k] += now_ - clk_t;             \
    clk_t = now_;                       \
  } while (0)
#define CLOCK_SAVE(p)                                        \
  if ((p) && blockIdx.x == 0 && threadIdx.x == 0)            \
    for (int k_ = 0; k_ < 4; ++k_) (p)[k_] = clk[k_]
#else
#define CLOCK_INIT
#define CLOCK_MARK(k)
#define CLOCK_SAVE(p)
#endif

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_CELLS = 31;  // the most cells of the warp kernel

template <class S>
__device__ __forceinline__ S seeded(float x, bool) {
  return S(x);
}
template <>
__device__ __forceinline__ Dual seeded<Dual>(float x, bool seed) {
  return Dual(x, seed ? 1.0f : 0.0f);
}

// the value of lane `src` (the left neighbour's state), tangents with
// their values
__device__ __forceinline__ float from_lane(float x, int src) {
  return __shfl_sync(FULL, x, src);
}
__device__ __forceinline__ Dual from_lane(Dual x, int src) {
  return Dual(__shfl_sync(FULL, x.v, src), __shfl_sync(FULL, x.d, src));
}
// the value of lane + 1 (the next interface's flux; lane 31 keeps its own)
__device__ __forceinline__ float from_right(float x) {
  return __shfl_down_sync(FULL, x, 1);
}
__device__ __forceinline__ Dual from_right(Dual x) {
  return Dual(__shfl_down_sync(FULL, x.v, 1),
              __shfl_down_sync(FULL, x.d, 1));
}

struct Args {
  const float *r0, *y0, *blr, *blu, *brr, *bru;
  float *rT, *yT, *max_wave;       // forward outputs
  const float *g_rT, *g_yT;        // backward cotangents
  float* g_in;                     // backward output [B, 2C + 4]
  int T, C;
  float u_max, rare_den, third, dt, dx;
  long long* cycles;               // DHTS_STEP_CLOCK: [4] of block 0
};

// A block's scenario, its seeded input entry (backward) and the ghosts.
template <class S>
struct Scenario {
  int b, seed;
  S bl_r, bl_u, br_r, br_u, left_y;
  __device__ Scenario(const Args& a) {
    const int C = a.C;
    const bool bwd = sizeof(S) != sizeof(float);
    b = bwd ? blockIdx.x / (2 * C + 4) : blockIdx.x;
    seed = bwd ? blockIdx.x % (2 * C + 4) : -1;
    bl_r = seeded<S>(a.blr[b], seed == 2 * C);
    bl_u = seeded<S>(a.blu[b], seed == 2 * C + 1);
    br_r = seeded<S>(a.brr[b], seed == 2 * C + 2);
    br_u = seeded<S>(a.bru[b], seed == 2 * C + 3);
    left_y = comp_y(bl_r, bl_u, a.u_max);
  }
};

// One warp per scenario (C <= 31), lane i owns cell i and interface i.
// Lanes past C solve interface C again and drop the result, so that the
// warp takes no path that a real interface does not: on zeros, their
// divisions and roots took slow paths the others waited for (the solve's
// 1,101 against 827 cycles a step on an H100).
template <class S>
__global__ void macro_rollout_warp(Args a) {
  const int C = a.C, i = threadIdx.x;
  const Scenario<S> sc(a);
  const float u_max = a.u_max;
  const float coef = a.dt / a.dx;
  const bool cell = i < C;
  const int left = i == 0 ? 0 : (cell ? i : C) - 1;  // the left cell's lane
  S r = S(0.0f), y = S(0.0f);
  if (cell) {
    r = seeded<S>(a.r0[sc.b * C + i], sc.seed == i);
    y = seeded<S>(a.y0[sc.b * C + i], sc.seed == C + i);
  }
  float wmax = 0.0f;

  CLOCK_INIT;
  for (int t = 0; t < a.T; ++t) {
    S u = S(0.0f);
    if (cell) u = comp_u(r, y, u_max);
    S rl = from_lane(r, left), yl = from_lane(y, left);
    S ul = from_lane(u, left);
    if (i == 0) {
      rl = sc.bl_r; yl = sc.left_y; ul = sc.bl_u;
    }
    S rr = r, ur = u;
    if (!cell) {
      rr = sc.br_r; ur = sc.br_u;
    }
    CLOCK_MARK(0);  // own u, neighbour states
    S f_r, f_y;
    float wave;
    riemann(rl, yl, ul, rr, ur, u_max, a.rare_den, a.third, f_r, f_y, wave);
    if (i <= C) wmax = fmaxf(wmax, wave);
    CLOCK_MARK(1);  // Riemann solve
    const S f_r1 = from_right(f_r), f_y1 = from_right(f_y);
    CLOCK_MARK(2);  // flux exchange
    if (cell) {
      r = r + (f_r - f_r1) * S(coef);
      y = y + (f_y - f_y1) * S(coef);
    }
    CLOCK_MARK(3);  // cell update
  }
  CLOCK_SAVE(a.cycles);

  if (sizeof(S) == sizeof(float)) {
    if (cell) {
      a.rT[sc.b * C + i] = val(r);
      a.yT[sc.b * C + i] = val(y);
    }
    // max is exact: the order of the reduction does not matter
    for (int o = 16; o > 0; o >>= 1)
      wmax = fmaxf(wmax, __shfl_down_sync(FULL, wmax, o));
    if (i == 0) a.max_wave[sc.b] = wmax;
  } else {
    // the cells' terms added in cell order by lane 0, as the
    // shared-memory kernel adds them
    const double term =
        cell ? (double)a.g_rT[sc.b * C + i] * (double)tangent(r) +
                   (double)a.g_yT[sc.b * C + i] * (double)tangent(y)
             : 0.0;
    double acc = 0.0;
    for (int c = 0; c < C; ++c) acc += __shfl_sync(FULL, term, c);
    if (i == 0) a.g_in[sc.b * (2 * C + 4) + sc.seed] = (float)acc;
  }
}

// Dynamic shared memory of the shared-memory kernel: r, y [C] and the
// interface fluxes [C + 1] as S, and one float per thread for the
// wave-speed reduction.
template <class S>
__host__ __device__ inline size_t smem_bytes(int C, int threads) {
  return sizeof(S) * (size_t)(4 * C + 2) + sizeof(float) * (size_t)threads;
}

// One block per scenario (C > 31), thread i owns cell i and interface i.
template <class S>
__global__ void macro_rollout_smem(Args a) {
  DHTS_DYNAMIC_SMEM(smem_raw);
  const int C = a.C, i = threadIdx.x;
  const Scenario<S> sc(a);
  S* r = reinterpret_cast<S*>(smem_raw);
  S* y = r + C;
  S* fr = y + C;
  S* fy = fr + C + 1;
  float* wv = reinterpret_cast<float*>(fy + C + 1);
  const float u_max = a.u_max;
  const float coef = a.dt / a.dx;
  if (i < C) {
    r[i] = seeded<S>(a.r0[sc.b * C + i], sc.seed == i);
    y[i] = seeded<S>(a.y0[sc.b * C + i], sc.seed == C + i);
  }
  float wmax = 0.0f;
  __syncthreads();

  CLOCK_INIT;
  for (int t = 0; t < a.T; ++t) {
    if (i <= C) {
      S rl, yl, ul, rr, ur;
      if (i == 0) {
        rl = sc.bl_r; yl = sc.left_y; ul = sc.bl_u;
      } else {
        rl = r[i - 1]; yl = y[i - 1]; ul = comp_u(rl, yl, u_max);
      }
      if (i == C) {
        rr = sc.br_r; ur = sc.br_u;
      } else {
        rr = r[i]; ur = comp_u(rr, y[i], u_max);
      }
      CLOCK_MARK(0);  // neighbour states
      S f_r, f_y;
      float wave;
      riemann(rl, yl, ul, rr, ur, u_max, a.rare_den, a.third, f_r, f_y,
              wave);
      CLOCK_MARK(1);  // Riemann solve
      fr[i] = f_r;
      fy[i] = f_y;
      wmax = fmaxf(wmax, wave);
    }
    __syncthreads();
    CLOCK_MARK(2);  // flux exchange
    if (i < C) {
      r[i] = r[i] + (fr[i] - fr[i + 1]) * S(coef);
      y[i] = y[i] + (fy[i] - fy[i + 1]) * S(coef);
    }
    __syncthreads();
    CLOCK_MARK(3);  // cell update
  }
  CLOCK_SAVE(a.cycles);

  if (sizeof(S) == sizeof(float)) {
    if (i < C) {
      a.rT[sc.b * C + i] = val(r[i]);
      a.yT[sc.b * C + i] = val(y[i]);
    }
    wv[i] = wmax;
    __syncthreads();
    if (i == 0) {
      float m = 0.0f;
      for (int j = 0; j <= C; ++j) m = fmaxf(m, wv[j]);
      a.max_wave[sc.b] = m;
    }
  } else if (i == 0) {
    double acc = 0.0;
    for (int c = 0; c < C; ++c)
      acc += (double)a.g_rT[sc.b * C + c] * (double)tangent(r[c]) +
             (double)a.g_yT[sc.b * C + c] * (double)tangent(y[c]);
    a.g_in[sc.b * (2 * C + 4) + sc.seed] = (float)acc;
  }
}

// `warp`: 1 the warp kernel, 0 the shared-memory one, -1 the warp kernel
// when the lane fits one warp
template <class S>
int launch(int blocks, const Args& a, void* stream, int warp = -1) {
  if (a.C < 1 || a.C > 1023 || a.T < 0 || blocks < 1 || warp > 1 ||
      (warp == 1 && a.C > WARP_CELLS))
    return 1;
  if (warp < 0) warp = a.C <= WARP_CELLS;
  const int threads = warp ? 32 : ((a.C + 1 + 31) / 32) * 32;
  const size_t smem = warp ? 0 : smem_bytes<S>(a.C, threads);
#ifdef DHTS_CPU_EMULATION
  (void)stream;
  if (warp)
    dhts_emu::launch(blocks, threads, smem, macro_rollout_warp<S>, a);
  else
    dhts_emu::launch(blocks, threads, smem, macro_rollout_smem<S>, a);
  return 0;
#else
  if (warp)
    macro_rollout_warp<S><<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  else
    macro_rollout_smem<S><<<blocks, threads, smem, (cudaStream_t)stream>>>(
        a);
  return (int)cudaGetLastError();
#endif
}

}  // namespace

extern "C" {

// Forward: B scenarios of C cells, T steps; rT, yT [B, C], max_wave [B].
// Returns cudaGetLastError() of the launch (1 for invalid sizes).
int launch_macro_rollout_fwd(const float* r0, const float* y0,
                             const float* blr, const float* blu,
                             const float* brr, const float* bru, float* rT,
                             float* yT, float* max_wave, int B, int T, int C,
                             float u_max, float rare_den, float third,
                             float dt, float dx, void* stream) {
  const Args a{r0, y0, blr, blu, brr, bru, rT, yT, max_wave, nullptr,
               nullptr, nullptr, T, C, u_max, rare_den, third, dt, dx,
               nullptr};
  return launch<float>(B, a, stream);
}

// Backward: g_in[B, 2C + 4] = the cotangents (g_rT, g_yT [B, C]) pulled
// back to (r0, y0, bl_r, bl_u, br_r, br_u), one block per (b, entry).
int launch_macro_rollout_bwd(const float* r0, const float* y0,
                             const float* blr, const float* blu,
                             const float* brr, const float* bru,
                             const float* g_rT, const float* g_yT,
                             float* g_in, int B, int T, int C, float u_max,
                             float rare_den, float third, float dt, float dx,
                             void* stream) {
  const Args a{r0, y0, blr, blu, brr, bru, nullptr, nullptr, nullptr, g_rT,
               g_yT, g_in, T, C, u_max, rare_den, third, dt, dx, nullptr};
  return launch<Dual>(B * (2 * C + 4), a, stream);
}

#ifdef DHTS_STEP_CLOCK
// The forward through kernel `warp` (1: the warp kernel, 0: the
// shared-memory one) with the step's cycle stamps of block 0 in cycles[4].
int launch_macro_rollout_fwd_clock(const float* r0, const float* y0,
                                   const float* blr, const float* blu,
                                   const float* brr, const float* bru,
                                   float* rT, float* yT, float* max_wave,
                                   int B, int T, int C, float u_max,
                                   float rare_den, float third, float dt,
                                   float dx, void* stream, int warp,
                                   long long* cycles) {
  const Args a{r0, y0, blr, blu, brr, bru, rT, yT, max_wave, nullptr,
               nullptr, nullptr, T, C, u_max, rare_den, third, dt, dx,
               cycles};
  return launch<float>(B, a, stream, warp);
}
#endif

}  // extern "C"
