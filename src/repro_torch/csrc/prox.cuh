// Penalties on the device: prox, subdifferential distance and the
// violation score, for the seven scalar penalties of
// repro_torch/core/penalties.py, selected by the codec's penalty id
// (repro_torch/kernels/common.py: PENALTY_IDS), and the row forms of the two
// block penalties BlockL1 and BlockMCP (ids 7 and 8) on a row of T values.
//
// Every branch, threshold and `where` guard mirrors the torch version op by
// op (same operand order, and the library is built with -fmad=false), so a
// kernel and its plain torch version round alike. L23 keeps the reference's
// fixed 40-step guarded Newton and the exact objective comparison.
#pragma once

#include <math.h>

namespace rt {

enum PenaltyId {
  PEN_L1 = 0,
  PEN_L1L2 = 1,
  PEN_MCP = 2,
  PEN_SCAD = 3,
  PEN_L05 = 4,
  PEN_L23 = 5,
  PEN_BOX = 6,
  PEN_BLOCK_L1 = 7,
  PEN_BLOCK_MCP = 8,
};

// The penalty's hyper-parameters from the codec vector on the card
// (repro_torch/kernels/common.py: penalty_params, exact arity): p0 is lam
// (C for Box); p1 is rho (L1L2) or gamma (MCP, SCAD, BlockMCP) and 0 where
// the penalty has one parameter. A kernel loads them at entry, so a CUDA
// graph that captured the launch reads the values bound at each replay.
__device__ __forceinline__ int penalty_arity(int pen) {
  return (pen == PEN_L1L2 || pen == PEN_MCP || pen == PEN_SCAD || pen == PEN_BLOCK_MCP) ? 2 : 1;
}

template <typename T>
__device__ __forceinline__ T param0(const double* prm) {
  return (T)prm[0];
}

template <typename T>
__device__ __forceinline__ T param1(int pen, const double* prm) {
  return penalty_arity(pen) > 1 ? (T)prm[1] : T(0);
}

// (x > 0) - (x < 0) as a T: +-1, or +0 for zeros and NaN (by selects, with
// no conversion from int on the chain)
template <typename T>
__device__ __forceinline__ T sgn(T x) {
  return (x > T(0)) ? T(1) : ((x < T(0)) ? T(-1) : T(0));
}

// torch.clamp(x, min=lo): NaN passes through
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return (x < lo) ? lo : x;
}

template <typename T>
__device__ __forceinline__ T clamp_max(T x, T hi) {
  return (x > hi) ? hi : x;
}

// torch.maximum(a, b)
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  return (a < b) ? b : a;
}

template <typename T>
__device__ __forceinline__ T soft_threshold(T x, T t) {
  return sgn(x) * clamp_min(fabs(x) - t, T(0));
}

// sign(x) * |x|^(1/3), as repro_torch.core.penalties.cbrt
template <typename T>
__device__ __forceinline__ T cbrt_pow(T x) {
  return sgn(x) * pow(fabs(x), T(1.0 / 3.0));
}

template <typename T>
__device__ T prox_l05(T x, T step, T lam) {
  const T t = step * lam;
  const T a = fabs(x);
  const T thresh = T(1.5) * pow(t, T(2.0 / 3.0));
  const T safe_a = maximum(a, thresh + T(1e-30));
  const T arg = clamp_max(clamp_min((T(0.25) * t) * pow(safe_a / T(3.0), T(-1.5)),
                                    T(-1.0)), T(1.0));
  const T phi = acos(arg);
  const T z = (T(2.0 / 3.0) * safe_a) *
              (T(1.0) + cos(T(2.0 * 3.141592653589793 / 3.0) - (T(2.0) * phi) / T(3.0)));
  return (a <= thresh) ? T(0) : sgn(x) * z;
}

template <typename T>
__device__ T prox_l23(T x, T step, T lam) {
  const T t = step * lam;
  const T a = fabs(x);
  const T a_safe = clamp_min(a, T(1e-30));
  const T ub = cbrt_pow(a_safe);
  const T c = T(2.0 / 3.0) * t;
  T u = ub;
  for (int it = 0; it < 40; ++it) {
    const T u2 = u * u;
    const T h = (u2 * u2 - a_safe * u) + c;
    const T hp = T(4.0) * (u2 * u) - a_safe;
    u = u - h / ((fabs(hp) > T(1e-30)) ? hp : T(1e-30));
    u = clamp_max(clamp_min(u, T(0)), ub);
  }
  const T u2 = u * u;
  const T z = u2 * u;
  const T obj_z = (T(0.5) * (z - a)) * (z - a) + t * pow(z, T(2.0 / 3.0));
  const T obj_0 = (T(0.5) * a) * a;
  const bool stationary =
      fabs((u2 * u2 - a_safe * u) + c) < T(1e-6) * clamp_min(a_safe * a_safe, T(1.0));
  const bool take = stationary && (obj_z < obj_0) && (a > T(0));
  return take ? sgn(x) * z : T(0);
}

// prox_{step * g}(x); p0, p1 are the codec's parameters
template <typename T>
__device__ T prox(int pen, T x, T step, T p0, T p1) {
  switch (pen) {
    case PEN_L1:
      return soft_threshold(x, step * p0);
    case PEN_L1L2:  // lam = p0, rho = p1
      return soft_threshold(x, (step * p0) * p1) /
             (T(1.0) + (step * p0) * (T(1.0) - p1));
    case PEN_MCP: {  // lam = p0, gamma = p1
      const T a = fabs(x);
      const T shrunk = soft_threshold(x, step * p0) / (T(1.0) - step / p1);
      const T out = (a <= p1 * p0) ? shrunk : x;
      return (a <= step * p0) ? T(0) : out;
    }
    case PEN_SCAD: {  // lam = p0, gamma = p1
      const T a = fabs(x);
      const T r1 = soft_threshold(x, step * p0);
      const T r2 = ((p1 - T(1.0)) * x - ((sgn(x) * p1) * p0) * step) /
                   ((p1 - T(1.0)) - step);
      return (a <= p0 * (T(1.0) + step)) ? r1 : ((a <= p1 * p0) ? r2 : x);
    }
    case PEN_L05:
      return prox_l05(x, step, p0);
    case PEN_L23:
      return prox_l23(x, step, p0);
    case PEN_BOX:  // C = p0
      return clamp_max(clamp_min(x, T(0)), p0);
  }
  return x;
}

// dist(-g, d pen(b)), the subdifferential score of Eq. 2
template <typename T>
__device__ T subdiff_dist(int pen, T g, T b, T p0, T p1) {
  const T a = fabs(b);
  switch (pen) {
    case PEN_L1: {
      const T at0 = clamp_min(fabs(g) - p0, T(0));
      return (b == T(0)) ? at0 : fabs(g + p0 * sgn(b));
    }
    case PEN_L1L2: {
      const T at0 = clamp_min(fabs(g) - p0 * p1, T(0));
      const T away = fabs((g + (p0 * p1) * sgn(b)) + (p0 * (T(1.0) - p1)) * b);
      return (b == T(0)) ? at0 : away;
    }
    case PEN_MCP: {
      const T at0 = clamp_min(fabs(g) - p0, T(0));
      const T mid = fabs((g + p0 * sgn(b)) - b / p1);
      return (b == T(0)) ? at0 : ((a < p1 * p0) ? mid : fabs(g));
    }
    case PEN_SCAD: {
      const T at0 = clamp_min(fabs(g) - p0, T(0));
      const T low = fabs(g + p0 * sgn(b));
      const T mid = fabs(g + (sgn(b) * (p1 * p0 - a)) / (p1 - T(1.0)));
      return (b == T(0)) ? at0 : ((a <= p0) ? low : ((a <= p1 * p0) ? mid : fabs(g)));
    }
    case PEN_L05: {
      const T away = fabs(g + (p0 * sgn(b)) / (T(2.0) * sqrt(clamp_min(a, T(1e-30)))));
      return (b == T(0)) ? T(0) : away;
    }
    case PEN_L23: {
      const T away = fabs(g + ((p0 * T(2.0 / 3.0)) * sgn(b)) / cbrt_pow(clamp_min(a, T(1e-30))));
      return (b == T(0)) ? T(0) : away;
    }
    case PEN_BOX: {
      if (b <= T(0)) return clamp_min(-g, T(0));
      if (b >= p0) return clamp_min(g, T(0));
      return fabs(g);
    }
  }
  return T(0);
}

// violation score: fixed point |b - prox(b - g/L, 1/L)| or subdiff distance
template <typename T>
__device__ T violation_score(int pen, int use_fp, T b, T g, T Lj, T p0, T p1) {
  if (use_fp) {
    const T step = T(1.0) / clamp_min(Lj, T(1e-30));
    return fabs(b - prox(pen, b - g * step, step, p0, p1));
  }
  return subdiff_dist(pen, g, b, p0, p1);
}

// one coordinate step of the CD epoch: the prox of the gradient step, or
// beta_j unchanged where L_j = 0
template <typename T>
__device__ __forceinline__ T coord_step(int pen, T bj, T gj, T Lj, T p0, T p1) {
  const T step = T(1.0) / clamp_min(Lj, T(1e-30));
  const T nw = prox(pen, bj - gj * step, step, p0, p1);
  return (Lj > T(0)) ? nw : bj;
}

// ---------------------------------------------------------------- blocks
// The block prox of a row x of norm nrm (Proposition 18), in the plain
// version's order: BlockL1  x * (max(nrm - step lam, 0) / max(nrm, 1e-30)),
//                  BlockMCP (x * prox_mcp(nrm, step)) / max(nrm, 1e-30).
template <typename T>
struct BlockProx {
  int pen;
  T s;
  T den;
  __device__ __forceinline__ T apply(T x) const {
    return (pen == PEN_BLOCK_L1) ? x * s : (x * s) / den;
  }
};

template <typename T>
__device__ __forceinline__ BlockProx<T> block_prox(int pen, T nrm, T step, T p0, T p1) {
  BlockProx<T> b;
  b.pen = pen;
  b.den = clamp_min(nrm, T(1e-30));
  b.s = (pen == PEN_BLOCK_L1) ? clamp_min(nrm - step * p0, T(0)) / b.den
                              : prox(PEN_MCP, nrm, step, p0, p1);
  return b;
}

// the violation score of one row (b: beta_j, g: grad_j, nt values each):
// the row norm of the fixed-point difference b - prox(b - g/L, 1/L), or the
// block subdifferential distance of BlockL1 / BlockMCP (lam = p0,
// gamma = p1). One thread walks the row; the sums run in index order.
template <typename T>
__device__ T block_violation_score(int pen, int use_fp, const T* b, const T* g, int nt, T Lj,
                                   T p0, T p1) {
  if (use_fp) {
    const T step = T(1.0) / clamp_min(Lj, T(1e-30));
    T s2 = T(0);
    for (int t = 0; t < nt; ++t) {
      const T x = b[t] - g[t] * step;
      s2 = s2 + x * x;
    }
    const BlockProx<T> bp = block_prox(pen, sqrt(s2), step, p0, p1);
    T d2 = T(0);
    for (int t = 0; t < nt; ++t) {
      const T d = b[t] - bp.apply(b[t] - g[t] * step);
      d2 = d2 + d * d;
    }
    return sqrt(d2);
  }
  T g2 = T(0), w2 = T(0);
  for (int t = 0; t < nt; ++t) {
    g2 = g2 + g[t] * g[t];
    w2 = w2 + b[t] * b[t];
  }
  const T gn = sqrt(g2), wn = sqrt(w2);
  if (wn == T(0)) return clamp_min(gn - p0, T(0));
  const T wnc = clamp_min(wn, T(1e-30));
  T a2 = T(0);
  if (pen == PEN_BLOCK_L1) {
    for (int t = 0; t < nt; ++t) {
      const T a = g[t] + (p0 * b[t]) / wnc;
      a2 = a2 + a * a;
    }
    return sqrt(a2);
  }
  if (!(wn < p1 * p0)) return gn;  // BlockMCP's flat part
  const T coef = p0 - wn / p1;
  for (int t = 0; t < nt; ++t) {
    const T a = g[t] + coef * (b[t] / wnc);
    a2 = a2 + a * a;
  }
  return sqrt(a2);
}

}  // namespace rt
