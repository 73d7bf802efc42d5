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
// Design. One thread block per scenario and one thread per vehicle; the
// platoon lives in shared memory, double-buffered, so each step has one
// barrier. The JAX kernel's padding (vehicles to 8 sublanes, the batch to
// 128 lanes, frozen padding rows) is not carried over. The forward keeps no
// trajectory.
//
// Backward: forward-mode tangents, as K1's and K2's. Block (b, j) runs
// scenario b on dual numbers (dhts_scalar.cuh) whose tangent seeds entry j
// of 2V (pos0[b, 0..V), vel0[b, 0..V)) and writes
//     g_in[b, j] = sum_v g_pT[b, v] d posT[b, v]/d in_j
//                        + g_vT[b, v] d velT[b, v]/d in_j.
// A speed stopped by the acceleration floor gets a zero tangent
// (idm_step), as the plain version detaches it.
//
// Bound. Inputs and outputs are a few floats per vehicle, so the floor is
// the T V B IDM updates' float32 operations; the kernel is latency-bound
// instead: T dependent steps, each a chain of about 25 operations with
// three divisions and one barrier, in one warp per scenario.

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
  const float *pos0, *vel0;
  const float* params;         // [6, V]: amax, apref, tgt, min_space,
                               // time_pref, length
  float *posT, *velT;          // forward outputs
  const float *g_pT, *g_vT;    // backward cotangents
  float* g_in;                 // backward output [B, 2V]
  int T, V;
  float head_pd, head_sd, dt;
};

// Dynamic shared memory: positions and speeds [2][V] as S (two buffers).
template <class S>
__host__ __device__ inline size_t smem_bytes(int V) {
  return sizeof(S) * (size_t)(4 * V);
}

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

}  // namespace

extern "C" {

// Forward: B platoons of V vehicles, T steps; posT, velT [B, V]. Returns
// cudaGetLastError() of the launch (1 for invalid sizes).
int launch_micro_rollout_fwd(const float* pos0, const float* vel0,
                             const float* params, float* posT, float* velT,
                             int B, int T, int V, float head_pd,
                             float head_sd, float dt, void* stream) {
  const Args a{pos0, vel0, params, posT, velT, nullptr, nullptr, nullptr,
               T, V, head_pd, head_sd, dt};
  return launch<float>(B, a, stream);
}

// Backward: g_in[B, 2V] = the cotangents (g_pT, g_vT [B, V]) pulled back to
// (pos0, vel0), one block per (b, entry).
int launch_micro_rollout_bwd(const float* pos0, const float* vel0,
                             const float* params, const float* g_pT,
                             const float* g_vT, float* g_in, int B, int T,
                             int V, float head_pd, float head_sd, float dt,
                             void* stream) {
  const Args a{pos0, vel0, params, nullptr, nullptr, g_pT, g_vT, g_in,
               T, V, head_pd, head_sd, dt};
  return launch<Dual>(B * 2 * V, a, stream);
}

}  // extern "C"
