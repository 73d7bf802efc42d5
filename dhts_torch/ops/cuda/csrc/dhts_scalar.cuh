// Scalars and physics shared by the port's CUDA kernels: the dual number
// of the forward-mode backwards, the ARZ Riemann solver of the macro lanes
// (dhts_torch.ops.arz) and the IDM step of a micro vehicle
// (dhts_torch.ops.idm). Every function is a template on its scalar type:
// `float` in a forward kernel, `Dual` (value, tangent) in a backward one.
// Every Dual operation computes its value with exactly the float operation
// the forward uses, so a backward follows its forward's discrete decisions
// (Riemann cases, clamps) by construction. Each function repeats its plain
// PyTorch counterpart op for op; the sources are built with -fmad=false and
// no fast math, so the two agree bit for bit.
#pragma once

#ifdef DHTS_CPU_EMULATION
#include "cpu_emulation.h"
#else
#include <cuda_runtime.h>
#define DHTS_DYNAMIC_SMEM(name) extern __shared__ __align__(16) char name[]
#endif

namespace {

constexpr float EPS = 1e-5f;  // arz.EPSILON and idm.POSITION_DELTA_EPS

// ---------------------------------------------------------------------------
// scalars
// ---------------------------------------------------------------------------

struct Dual {
  float v, d;
  __device__ Dual() {}
  __device__ Dual(float v_) : v(v_), d(0.0f) {}
  __device__ Dual(float v_, float d_) : v(v_), d(d_) {}
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  return Dual(a.v + b.v, a.d + b.d);
}
__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
  return Dual(a.v - b.v, a.d - b.d);
}
__device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return Dual(q, (a.d - q * b.d) / b.v);
}

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(Dual x) { return x.v; }
__device__ __forceinline__ float tangent(float) { return 0.0f; }
__device__ __forceinline__ float tangent(Dual x) { return x.d; }

// max/min with a tie splitting the tangent 0.5/0.5 (jnp.maximum, and
// torch.maximum between tensors)
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ Dual vmax(Dual a, Dual b) {
  return Dual(fmaxf(a.v, b.v),
              a.v > b.v ? a.d : (a.v < b.v ? b.d : 0.5f * (a.d + b.d)));
}
__device__ __forceinline__ Dual vmin(Dual a, Dual b) {
  return Dual(fminf(a.v, b.v),
              a.v < b.v ? a.d : (a.v > b.v ? b.d : 0.5f * (a.d + b.d)));
}
__device__ __forceinline__ float vabs(float a) { return fabsf(a); }
__device__ __forceinline__ Dual vabs(Dual a) {
  return Dual(fabsf(a.v), a.v > 0.0f ? a.d : (a.v < 0.0f ? -a.d : 0.0f));
}
__device__ __forceinline__ float vsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ Dual vsqrt(Dual a) {
  const float r = sqrtf(a.v);
  return Dual(r, a.d == 0.0f ? 0.0f : a.d / (2.0f * r));
}
__device__ __forceinline__ float detached(float x) { return x; }
__device__ __forceinline__ Dual detached(Dual x) { return Dual(x.v); }

// ---------------------------------------------------------------------------
// ARZ physics (dhts_torch.ops.arz)
// ---------------------------------------------------------------------------

template <class S>
__device__ __forceinline__ S u_eq(S r, float u_max) {
  r = vmax(r, S(0.0f));
  return S(u_max) * (S(1.0f) - vsqrt(r + S(EPS)));
}

template <class S>
__device__ __forceinline__ S u_eq_prime(S r, float u_max) {
  r = vmax(r, S(EPS));
  return S(-(u_max * 0.5f)) * (S(1.0f) / vsqrt(r));
}

template <class S>
__device__ __forceinline__ S comp_y(S r, S u, float u_max) {
  return r * (u - u_eq(r, u_max));
}

template <class S>
__device__ __forceinline__ S comp_u(S r, S y, float u_max) {
  r = vmax(r, S(EPS));
  return y / r + u_eq(r, u_max);
}

template <class S>
__device__ __forceinline__ S lambda0(S r, S u, float u_max) {
  return u + r * u_eq_prime(r, u_max);
}

// exact ARZ Riemann solver (dhts_torch.ops.arz.riemann_solve): interface
// fluxes, and the interface's largest wave speed (a value). `rare_den` is
// (GAMMA + 1) * u_max and `third` GAMMA / (GAMMA + 1), each rounded once
// from double, as the plain version's Python constants are.
template <class S>
__device__ __forceinline__ void riemann(S rl, S yl, S ul, S rr, S ur,
                                        float u_max, float rare_den,
                                        float third, S& fr, S& fy,
                                        float& wave) {
  const S u_eq_l = u_eq(rl, u_max);
  const S lam0_l = lambda0(rl, ul, u_max);
  const S r_l_pow = vsqrt(vmax(rl, S(EPS)));

  const S tm = r_l_pow + (ul - ur) / S(u_max);
  const S r_m = tm * tm;
  const S u_m = ur;
  const S lam0_m = lambda0(r_m, u_m, u_max);
  const S flux_r_m = r_m * u_m;

  const S u_vac = (S(u_max) + ul) - u_eq_l;

  const S inv = ul + S(u_max) * r_l_pow;
  const S tc = inv / S(rare_den);
  const S r_c = tc * tc;
  const S u_c = S(third) * inv;

  const bool vac_l = val(rl) < EPS;
  const bool vac_r = !vac_l && (val(rr) < EPS);
  bool taken = vac_l || vac_r;
  const bool equal = !taken && (fabsf(val(ul) - val(ur)) < EPS);
  taken = taken || equal;
  const bool shock = !taken && (val(ul) > val(ur));
  taken = taken || shock;
  const bool rare = !taken && (val(u_vac) > val(ur));

  const S shock_speed = (flux_r_m - rl * ul) / vmax(r_m - rl, S(EPS));
  const S half_lam_m = (lam0_l + lam0_m) * S(0.5f);
  const S half_lam_vac = (lam0_l + u_vac) * S(0.5f);

  float speed0, speed1;
  int c;
  const int l_or_c = val(lam0_l) >= 0.0f ? 0 : 2;
  if (vac_l) {
    speed0 = 0.0f; speed1 = val(ul); c = 0;
  } else if (vac_r) {
    speed0 = val(half_lam_vac); speed1 = val(half_lam_vac); c = l_or_c;
  } else if (equal) {
    speed0 = 0.0f; speed1 = val(ur); c = 0;
  } else if (shock) {
    speed0 = val(shock_speed); speed1 = val(ur);
    c = val(shock_speed) >= 0.0f ? 0 : 1;
  } else if (rare) {
    speed0 = val(half_lam_m); speed1 = val(ur);
    c = val(lam0_l) >= 0.0f ? 0 : (val(lam0_m) <= 0.0f ? 1 : 2);
  } else {
    speed0 = val(half_lam_vac); speed1 = val(ur); c = l_or_c;
  }
  S r0, u0, y0;
  if (c == 1) {
    r0 = r_m; u0 = u_m; y0 = comp_y(r0, u0, u_max);
  } else if (c == 2) {
    r0 = r_c; u0 = u_c; y0 = comp_y(r0, u0, u_max);
  } else {
    r0 = rl; u0 = ul; y0 = yl;
  }
  fr = r0 * u0;
  fy = y0 * u0;
  wave = fmaxf(fabsf(speed0), fabsf(speed1));
}

// ---------------------------------------------------------------------------
// IDM (dhts_torch.ops.idm)
// ---------------------------------------------------------------------------

// One IDM + explicit-Euler update of an active vehicle at position `p`,
// speed `sp`, with gap `pdel` and speed difference `sdel` to its leader
// (micro_lane_step after the leader deltas are known): a negative gap
// (collision) zeroes both deltas, the gap is floored at EPS, the optimal
// spacing at 0 and the acceleration at -sp / dt. `idm_den` is
// 2 * sqrt(amax * apref). A speed stopped by the acceleration floor,
// sp + dt * (-sp / dt), does not depend on sp: its tangent is 0 (summing
// the tangents would leave a rounding residue of sp's; the plain version
// detaches the same speed). Returns whether the floor stopped the vehicle.
template <class S>
__device__ __forceinline__ bool idm_step(S p, S sp, S pdel, S sdel,
                                         float amax, float tgt,
                                         float min_space, float time_pref,
                                         float idm_den, float dt, S& new_p,
                                         S& new_v) {
  if (val(pdel) < 0.0f) { pdel = 0.0f; sdel = 0.0f; }
  pdel = vmax(pdel, S(EPS));
  const S os = vmax((S(min_space) + sp * S(time_pref)) +
                        (sp * sdel) / S(idm_den),
                    S(0.0f));
  const S q = sp / S(tgt);
  const S q2 = q * q;
  const S z = os / pdel;
  const S acc_raw = S(amax) * ((S(1.0f) - q2 * q2) - z * z);
  const S acc_floor = -sp / S(dt);
  const S acc = vmax(acc_raw, acc_floor);
  new_p = p + S(dt) * sp;
  const S nv = sp + S(dt) * acc;
  const bool floored = val(acc_raw) < val(acc_floor);
  new_v = floored ? detached(nv) : nv;
  return floored;
}

}  // namespace
