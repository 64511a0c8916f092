// QCP RMSD epilogue shared by the kernels of this directory: nine S
// components and the G sum of one frame-center pair -> the minimum RMSD.
//
// Operation for operation the epilogue of enspara_tpu_torch/ops/qcp.py
// (rmsd_from_S_components_unrolled with _poly_coeffs_scaled_components
// and _newton_steps): the scaled quartic, 12 Newton steps, each clipped
// to +-0.5. It differs from the JAX package's epilogue
// (enspara_tpu/ops/qcp.py) in two places:
//   * Newton's start: u0 = min(1, kStartMargin * sqrt(3) |S|_F /
//     lambda0), where JAX starts from u = 1. lambda_max is at most the
//     nuclear norm of S, at most sqrt(3) |S|_F, so u0 lies above the
//     largest root, within a factor 3.03 of it, and Newton falls to the
//     root from above; from u = 1, 12 steps stop short for structures
//     that barely align (msd up to ~0.08 short), the pairs farthest-first
//     k-centers picks. The margin keeps the rounded bound above the root
//     where it is tight (equal singular values).
//   * the step divides p + kTiny: a converged root leaves p = 0, and
//     an exact division of 0 takes the slow path of the division; kTiny
//     is below half an ulp of any p that moves u.
// Where u0 clamps to 1 (well-aligned pairs) the result is that of the start
// from u = 1, bit for bit. Near a double root (|p'(u)| < kNearDouble u^3,
// ~5e-5 of unit-normal pairs) the float32 coefficients hold the root only to
// ~1e-4 in msd, whatever the steps: qcp_rmsd_flagged reports such a pair,
// which the all-pairs kernel (qcp_matrix.cu) returns negated and its second
// kernel computes again in double (qcp_rmsd_double); the k-centers kernels
// do not, nor do their plain versions. Newton divides exactly (the TPU
// k-centers kernels use an approximate reciprocal); build without
// --use_fast_math, which would change the rounding of division and sqrt.

#pragma once

#include <math.h>

constexpr int kNewtonIters = 12;
constexpr float kStartMargin = 1.01f;
constexpr float kTiny = 1e-30f;
constexpr float kNearDouble = 0.03f;
// Newton's steps of the double epilogue (near a double root Newton only
// halves its error a step)
constexpr int kDoubleIters = 24;

// the float and double forms of the math functions the epilogue takes
__device__ __forceinline__ float qcp_min(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double qcp_min(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float qcp_max(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double qcp_max(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float qcp_abs(float a) { return fabsf(a); }
__device__ __forceinline__ double qcp_abs(double a) { return fabs(a); }
__device__ __forceinline__ float qcp_sqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double qcp_sqrt(double a) { return sqrt(a); }

// Newton's root u of the scaled quartic u^4 + c2 u^2 + c1 u + c0 of one
// pair, after kIters steps from the bound (unclamped), in T; lam0, c2
// and c1 for the caller.
template <typename T, int kIters>
__device__ __forceinline__ T qcp_root(const T* S, T gsum, T& lam0, T& c2,
                                      T& c1) {
  const T Sxx = S[0], Sxy = S[1], Sxz = S[2];
  const T Syx = S[3], Syy = S[4], Syz = S[5];
  const T Szx = S[6], Szy = S[7], Szz = S[8];
  const T Sxx2 = Sxx * Sxx, Sxy2 = Sxy * Sxy, Sxz2 = Sxz * Sxz;
  const T Syx2 = Syx * Syx, Syy2 = Syy * Syy, Syz2 = Syz * Syz;
  const T Szx2 = Szx * Szx, Szy2 = Szy * Szy, Szz2 = Szz * Szz;

  const T fnorm2 = Sxx2 + Sxy2 + Sxz2 + Syx2 + Syy2 + Syz2 + Szx2 + Szy2 +
                   Szz2;
  const T det = Sxx * (Syy * Szz - Syz * Szy) -
                Sxy * (Syx * Szz - Syz * Szx) +
                Sxz * (Syx * Szy - Syy * Szx);
  const T C2 = T(-2) * fnorm2;
  const T C1 = T(-8) * det;

  const T SxzpSzx = Sxz + Szx, SxzmSzx = Sxz - Szx;
  const T SyzpSzy = Syz + Szy, SyzmSzy = Syz - Szy;
  const T SxypSyx = Sxy + Syx, SxymSyx = Sxy - Syx;
  const T SxxpSyy = Sxx + Syy, SxxmSyy = Sxx - Syy;

  T D = Sxy2 + Sxz2 - Syx2 - Szx2;
  D = D * D;
  const T e1 = -Sxx2 + Syy2 + Szz2 + Syz2 + Szy2;
  const T e2 = T(2) * (Syy * Szz - Syz * Szy);
  const T E = (e1 - e2) * (e1 + e2);
  const T F = (-(SxzpSzx) * (SyzmSzy) + (SxymSyx) * (SxxmSyy - Szz)) *
              (-(SxzmSzx) * (SyzpSzy) + (SxymSyx) * (SxxmSyy + Szz));
  const T G = (-(SxzpSzx) * (SyzpSzy) - (SxypSyx) * (SxxpSyy - Szz)) *
              (-(SxzmSzx) * (SyzmSzy) - (SxypSyx) * (SxxpSyy + Szz));
  const T H = ((SxypSyx) * (SyzpSzy) + (SxzpSzx) * (SxxmSyy + Szz)) *
              (-(SxymSyx) * (SyzmSzy) + (SxzpSzx) * (SxxpSyy + Szz));
  const T I = ((SxypSyx) * (SyzmSzy) + (SxzmSzx) * (SxxmSyy - Szz)) *
              (-(SxymSyx) * (SyzpSzy) + (SxzmSzx) * (SxxpSyy - Szz));
  const T C0 = D + E + F + G + H + I;

  lam0 = gsum * T(0.5);
  // the clamp keeps inv^4 finite for G = 0 structures (qcp.py)
  const T inv = T(1) / qcp_max(lam0, T(1e-9f));
  const T inv2 = inv * inv;
  c2 = C2 * inv2;
  c1 = C1 * inv2 * inv;
  const T c0 = C0 * inv2 * inv2;

  T u = qcp_min(T(kStartMargin) * qcp_sqrt(T(3) * fnorm2) * inv, T(1));
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const T u2 = u * u;
    const T p = u2 * u2 + c2 * u2 + c1 * u + c0;
    const T dp = u * (T(4) * u2 + T(2) * c2) + c1;
    const T den = qcp_abs(dp) < T(1e-12f) ? T(1e-12f) : dp;
    const T step = qcp_min(qcp_max((p + T(kTiny)) / den, T(-0.5)), T(0.5));
    u = u - step;
  }
  return u;
}

// The float epilogue; near: the root lies near a double one.
__device__ __forceinline__ float qcp_rmsd_flagged(const float* S,
                                                  float gsum, float n_atoms,
                                                  bool& near) {
  float lam0, c2, c1;
  float u = qcp_root<float, kNewtonIters>(S, gsum, lam0, c2, c1);
  const float u2 = u * u;
  near = fabsf(u * (4.0f * u2 + 2.0f * c2) + c1) < kNearDouble * u2 * u;
  u = fminf(fmaxf(u, 0.0f), 1.0f);
  return sqrtf(fmaxf(gsum - 2.0f * u * lam0, 0.0f) / n_atoms);
}

// The float epilogue without the flag: the k-centers kernels (1-4).
__device__ __forceinline__ float qcp_rmsd(const float* S, float gsum,
                                          float n_atoms) {
  bool near;
  return qcp_rmsd_flagged(S, gsum, n_atoms, near);
}

// The epilogue in double, from S in double: a pair near a double root.
__device__ __forceinline__ float qcp_rmsd_double(const double* S,
                                                 double gsum,
                                                 double n_atoms) {
  double lam0, c2, c1;
  double u = qcp_root<double, kDoubleIters>(S, gsum, lam0, c2, c1);
  u = fmin(fmax(u, 0.0), 1.0);
  return static_cast<float>(
      sqrt(fmax(gsum - 2.0 * u * lam0, 0.0) / n_atoms));
}
