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
// Design. One thread block per scenario; thread i solves the Riemann
// problem at interface i (0..C, the ghost cells at 0 and C) and updates
// cell i (i < C). The cells live in shared memory; each step has two
// barriers: after the fluxes are published and after the cells are
// updated. The JAX kernel's layout (cells on sublanes padded to 8, the
// batch on lanes padded to 128, right-ghost plateau rows) is not carried
// over: a block holds exactly C cells. The forward keeps no trajectory.
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
// a chain of about a hundred dependent operations (divisions and square
// roots among them) and two barriers, in one block of one warp per
// scenario.

#include "dhts_scalar.cuh"

namespace {

template <class S>
__device__ __forceinline__ S seeded(float x, bool) {
  return S(x);
}
template <>
__device__ __forceinline__ Dual seeded<Dual>(float x, bool seed) {
  return Dual(x, seed ? 1.0f : 0.0f);
}

struct Args {
  const float *r0, *y0, *blr, *blu, *brr, *bru;
  float *rT, *yT, *max_wave;       // forward outputs
  const float *g_rT, *g_yT;        // backward cotangents
  float* g_in;                     // backward output [B, 2C + 4]
  int T, C;
  float u_max, rare_den, third, dt, dx;
};

// Dynamic shared memory: r, y [C] and the interface fluxes [C + 1] as S,
// and one float per thread for the wave-speed reduction.
template <class S>
__host__ __device__ inline size_t smem_bytes(int C, int threads) {
  return sizeof(S) * (size_t)(4 * C + 2) + sizeof(float) * (size_t)threads;
}

template <class S>
__global__ void macro_rollout_kernel(Args a) {
  DHTS_DYNAMIC_SMEM(smem_raw);
  const int C = a.C;
  const int n_in = 2 * C + 4;
  const bool bwd = sizeof(S) != sizeof(float);
  const int b = bwd ? blockIdx.x / n_in : blockIdx.x;
  const int seed = bwd ? blockIdx.x % n_in : -1;
  const int i = threadIdx.x;
  S* r = reinterpret_cast<S*>(smem_raw);
  S* y = r + C;
  S* fr = y + C;
  S* fy = fr + C + 1;
  float* wv = reinterpret_cast<float*>(fy + C + 1);

  const S bl_r = seeded<S>(a.blr[b], seed == 2 * C);
  const S bl_u = seeded<S>(a.blu[b], seed == 2 * C + 1);
  const S br_r = seeded<S>(a.brr[b], seed == 2 * C + 2);
  const S br_u = seeded<S>(a.bru[b], seed == 2 * C + 3);
  const float u_max = a.u_max;
  const S left_y = comp_y(bl_r, bl_u, u_max);
  const float coef = a.dt / a.dx;
  if (i < C) {
    r[i] = seeded<S>(a.r0[b * C + i], seed == i);
    y[i] = seeded<S>(a.y0[b * C + i], seed == C + i);
  }
  float wmax = 0.0f;
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    if (i <= C) {
      S rl, yl, ul, rr, ur;
      if (i == 0) {
        rl = bl_r; yl = left_y; ul = bl_u;
      } else {
        rl = r[i - 1]; yl = y[i - 1]; ul = comp_u(rl, yl, u_max);
      }
      if (i == C) {
        rr = br_r; ur = br_u;
      } else {
        rr = r[i]; ur = comp_u(rr, y[i], u_max);
      }
      S f_r, f_y;
      float wave;
      riemann(rl, yl, ul, rr, ur, u_max, a.rare_den, a.third, f_r, f_y,
              wave);
      fr[i] = f_r;
      fy[i] = f_y;
      wmax = fmaxf(wmax, wave);
    }
    __syncthreads();
    if (i < C) {
      r[i] = r[i] + (fr[i] - fr[i + 1]) * S(coef);
      y[i] = y[i] + (fy[i] - fy[i + 1]) * S(coef);
    }
    __syncthreads();
  }

  if (!bwd) {
    if (i < C) {
      a.rT[b * C + i] = val(r[i]);
      a.yT[b * C + i] = val(y[i]);
    }
    wv[i] = wmax;
    __syncthreads();
    if (i == 0) {
      float m = 0.0f;
      for (int j = 0; j <= C; ++j) m = fmaxf(m, wv[j]);
      a.max_wave[b] = m;
    }
  } else if (i == 0) {
    double acc = 0.0;
    for (int c = 0; c < C; ++c)
      acc += (double)a.g_rT[b * C + c] * (double)tangent(r[c]) +
             (double)a.g_yT[b * C + c] * (double)tangent(y[c]);
    a.g_in[b * n_in + seed] = (float)acc;
  }
}

template <class S>
int launch(int blocks, const Args& a, void* stream) {
  if (a.C < 1 || a.C > 1023 || a.T < 0 || blocks < 1) return 1;
  const int threads = ((a.C + 1 + 31) / 32) * 32;
  const size_t smem = smem_bytes<S>(a.C, threads);
#ifdef DHTS_CPU_EMULATION
  (void)stream;
  dhts_emu::launch(blocks, threads, smem, macro_rollout_kernel<S>, a);
  return 0;
#else
  macro_rollout_kernel<S><<<blocks, threads, smem, (cudaStream_t)stream>>>(
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
               nullptr, nullptr, T, C, u_max, rare_den, third, dt, dx};
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
               g_yT, g_in, T, C, u_max, rare_den, third, dt, dx};
  return launch<Dual>(B * (2 * C + 4), a, stream);
}

}  // extern "C"
