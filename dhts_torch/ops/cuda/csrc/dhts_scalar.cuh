// Scalars and physics shared by the port's CUDA kernels: the dual number
// of the forward-mode backwards, the soft gates, the ARZ Riemann solver of
// the macro lanes (dhts_torch.ops.arz) and the IDM step of a micro vehicle
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

// The float max and min of every clamp. A source that defines
// DHTS_KEEP_NAN (the ITSCP step's kernels, through itscp_step.cuh) keeps a
// NaN operand, as torch.maximum and jnp.maximum do: PTX max.NaN / min.NaN
// (sm_80 and later, one instruction as fmaxf). The rollouts' kernels (K2,
// K3) take fmaxf / fminf, which return the other operand.
__device__ __forceinline__ float max_of(float a, float b) {
#if !defined(DHTS_KEEP_NAN)
  return fmaxf(a, b);
#elif defined(DHTS_CPU_EMULATION)
  return a != a || b != b ? a + b : fmaxf(a, b);
#else
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#endif
}
__device__ __forceinline__ float min_of(float a, float b) {
#if !defined(DHTS_KEEP_NAN)
  return fminf(a, b);
#elif defined(DHTS_CPU_EMULATION)
  return a != a || b != b ? a + b : fminf(a, b);
#else
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#endif
}

// max/min with a tie splitting the tangent 0.5/0.5 (jnp.maximum, and
// torch.maximum between tensors)
__device__ __forceinline__ float vmax(float a, float b) {
  return max_of(a, b);
}
__device__ __forceinline__ float vmin(float a, float b) {
  return min_of(a, b);
}
__device__ __forceinline__ Dual vmax(Dual a, Dual b) {
  return Dual(max_of(a.v, b.v),
              a.v > b.v ? a.d : (a.v < b.v ? b.d : 0.5f * (a.d + b.d)));
}
__device__ __forceinline__ Dual vmin(Dual a, Dual b) {
  return Dual(min_of(a.v, b.v),
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

// vsqrt(a), 1 / vsqrt(a) and y / b of a clamp's result a or b. With
// DHTS_KEEP_NAN the root or quotient is taken of `clean`, fmaxf's result
// of the clamp's operands (a's or b's value unless that is NaN, and never
// NaN itself), and a NaN a or b given back: the compiler then shares equal
// roots between calls as it did when the clamp was fmaxf. Without it they
// are the plain operations.
#ifdef DHTS_KEEP_NAN
__device__ __forceinline__ float with_nan(float a, float v) {
  return a != a ? a : v;
}
__device__ __forceinline__ float vsqrt_of(float a, float clean) {
  return with_nan(a, sqrtf(clean));
}
__device__ __forceinline__ Dual vsqrt_of(Dual a, float clean) {
  const float r = sqrtf(clean);
  return Dual(with_nan(a.v, r), a.d == 0.0f ? 0.0f : a.d / (2.0f * r));
}
__device__ __forceinline__ float vrsqrt_of(float a, float clean) {
  return with_nan(a, 1.0f / sqrtf(clean));
}
__device__ __forceinline__ Dual vrsqrt_of(Dual a, float clean) {
  const float r = sqrtf(clean);
  const float rd = a.d == 0.0f ? 0.0f : a.d / (2.0f * r);
  const float q = 1.0f / r;
  return Dual(with_nan(a.v, q), (0.0f - q * rd) / r);
}
__device__ __forceinline__ float vdiv_by(float y, float b, float clean) {
  return with_nan(b, y / clean);
}
__device__ __forceinline__ Dual vdiv_by(Dual y, Dual b, float clean) {
  const float q = y.v / clean;
  return Dual(with_nan(b.v, q), (y.d - q * b.d) / clean);
}
#else
template <class S>
__device__ __forceinline__ S vsqrt_of(S a, float) {
  return vsqrt(a);
}
template <class S>
__device__ __forceinline__ S vrsqrt_of(S a, float) {
  return S(1.0f) / vsqrt(a);
}
template <class S>
__device__ __forceinline__ S vdiv_by(S y, S b, float) {
  return y / b;
}
#endif

// ---------------------------------------------------------------------------
// soft gates and gradient plumbing (dhts_torch.ops.dmath)
// ---------------------------------------------------------------------------

// float64 sigmoid rounded once (dhts_torch.ops.dmath.sigmoid)
__device__ __forceinline__ float vsigmoid(float z) {
  return (float)(1.0 / (1.0 + exp(-(double)z)));
}
// its tangent is y * (1 - y) of the rounded y (dmath.sigmoid's gradient)
__device__ __forceinline__ Dual vsigmoid(Dual z) {
  const float y = vsigmoid(z.v);
  return Dual(y, z.d * (y * (1.0f - y)));
}
// sigmoid(clip(x * c, -16, 16)) (dmath.soft_sigmoid)
template <class S>
__device__ __forceinline__ S soft(S x, float c) {
  return vsigmoid(vmin(vmax(x * S(c), S(-16.0f)), S(16.0f)));
}
// (value + src) - detach(src): the value, with src's tangent
__device__ __forceinline__ float grad_carrier(float value, float src) {
  return (value + src) - src;
}
__device__ __forceinline__ Dual grad_carrier(float value, Dual src) {
  return Dual((value + src.v) - src.v, src.d);
}
// x - detach(x - clip(x, lo, hi)): the clipped value, x's tangent
__device__ __forceinline__ float st_clip(float x, float hi) {
  return x - (x - min_of(max_of(x, EPS), hi));
}
__device__ __forceinline__ Dual st_clip(Dual x, float hi) {
  return Dual(x.v - (x.v - min_of(max_of(x.v, EPS), hi)), x.d);
}
// the action entry as a scalar; a backward block differentiates with
// respect to the entry it seeds
template <class S>
__device__ __forceinline__ S action_at(float a, bool seeded);
template <>
__device__ __forceinline__ float action_at<float>(float a, bool) {
  return a;
}
template <>
__device__ __forceinline__ Dual action_at<Dual>(float a, bool seeded) {
  return Dual(a, seeded ? 1.0f : 0.0f);
}

// carve n elements of T out of the shared-memory block at `off`
template <class T>
__host__ __device__ inline void carve(T** p, size_t n, char* base,
                                      size_t& off) {
  if (base) *p = reinterpret_cast<T*>(base + off);
  off += ((n * sizeof(T) + 15) / 16) * 16;
}

// ---------------------------------------------------------------------------
// ARZ physics (dhts_torch.ops.arz)
// ---------------------------------------------------------------------------

template <class S>
__device__ __forceinline__ S u_eq(S r, float u_max) {
  const float clean = fmaxf(val(r), 0.0f) + EPS;
  r = vmax(r, S(0.0f));
  return S(u_max) * (S(1.0f) - vsqrt_of(r + S(EPS), clean));
}

template <class S>
__device__ __forceinline__ S u_eq_prime(S r, float u_max) {
  const float clean = fmaxf(val(r), EPS);
  r = vmax(r, S(EPS));
  return S(-(u_max * 0.5f)) * vrsqrt_of(r, clean);
}

template <class S>
__device__ __forceinline__ S comp_y(S r, S u, float u_max) {
  return r * (u - u_eq(r, u_max));
}

template <class S>
__device__ __forceinline__ S comp_u(S r, S y, float u_max) {
  const float clean = fmaxf(val(r), EPS);
  r = vmax(r, S(EPS));
  return vdiv_by(y, r, clean) + u_eq(r, u_max);
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
  const S r_l_pow = vsqrt_of(vmax(rl, S(EPS)), fmaxf(val(rl), EPS));

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

  const S dr = r_m - rl;
  const S shock_speed = vdiv_by(flux_r_m - rl * ul, vmax(dr, S(EPS)),
                                fmaxf(val(dr), EPS));
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
  // the interface state: (r_m, u_m) if c == 1, (r_c, u_c) if c == 2, the
  // left state otherwise. The inputs are selected first, so that a warp
  // whose lanes need both runs comp_y once, not on two divergent paths (on
  // an H100, K2's Riemann part took 924 against 815 cycles a step); comp_y
  // stays behind a branch, so a warp that needs neither runs it not at all
  // (on every lane, K1's backward took 3 % longer)
  const S r0 = c == 1 ? r_m : (c == 2 ? r_c : rl);
  const S u0 = c == 1 ? u_m : (c == 2 ? u_c : ul);
  S y0 = yl;
  if (c != 0) y0 = comp_y(r0, u0, u_max);
  fr = r0 * u0;
  fy = y0 * u0;
  wave = max_of(fabsf(speed0), fabsf(speed1));
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
  const float pclean = fmaxf(val(pdel), EPS);
  pdel = vmax(pdel, S(EPS));
  const S os = vmax((S(min_space) + sp * S(time_pref)) +
                        (sp * sdel) / S(idm_den),
                    S(0.0f));
  const S q = sp / S(tgt);
  const S q2 = q * q;
  const S z = vdiv_by(os, pdel, pclean);
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
