// QCP RMSD epilogue shared by the kernels of this directory: nine S
// components and the G sum of one frame-center pair -> the minimum RMSD.
//
// Operation for operation the epilogue of enspara_tpu/ops/qcp.py
// (rmsd_from_S_components_unrolled with _poly_coeffs_scaled_components
// and _newton_max_root_unrolled): the scaled quartic, 12 Newton steps
// from u = 1, each clipped to +-0.5. Newton divides exactly (the TPU
// k-centers kernels use an approximate reciprocal); build without
// --use_fast_math, which would change the rounding of division and sqrt.

#pragma once

#include <math.h>

constexpr int kNewtonIters = 12;

__device__ __forceinline__ float qcp_rmsd(const float* S, float gsum,
                                          float n_atoms) {
  const float Sxx = S[0], Sxy = S[1], Sxz = S[2];
  const float Syx = S[3], Syy = S[4], Syz = S[5];
  const float Szx = S[6], Szy = S[7], Szz = S[8];
  const float Sxx2 = Sxx * Sxx, Sxy2 = Sxy * Sxy, Sxz2 = Sxz * Sxz;
  const float Syx2 = Syx * Syx, Syy2 = Syy * Syy, Syz2 = Syz * Syz;
  const float Szx2 = Szx * Szx, Szy2 = Szy * Szy, Szz2 = Szz * Szz;

  const float fnorm2 = Sxx2 + Sxy2 + Sxz2 + Syx2 + Syy2 + Syz2 + Szx2 +
                       Szy2 + Szz2;
  const float det = Sxx * (Syy * Szz - Syz * Szy) -
                    Sxy * (Syx * Szz - Syz * Szx) +
                    Sxz * (Syx * Szy - Syy * Szx);
  const float C2 = -2.0f * fnorm2;
  const float C1 = -8.0f * det;

  const float SxzpSzx = Sxz + Szx, SxzmSzx = Sxz - Szx;
  const float SyzpSzy = Syz + Szy, SyzmSzy = Syz - Szy;
  const float SxypSyx = Sxy + Syx, SxymSyx = Sxy - Syx;
  const float SxxpSyy = Sxx + Syy, SxxmSyy = Sxx - Syy;

  float D = Sxy2 + Sxz2 - Syx2 - Szx2;
  D = D * D;
  const float e1 = -Sxx2 + Syy2 + Szz2 + Syz2 + Szy2;
  const float e2 = 2.0f * (Syy * Szz - Syz * Szy);
  const float E = (e1 - e2) * (e1 + e2);
  const float F = (-(SxzpSzx) * (SyzmSzy) + (SxymSyx) * (SxxmSyy - Szz)) *
                  (-(SxzmSzx) * (SyzpSzy) + (SxymSyx) * (SxxmSyy + Szz));
  const float G = (-(SxzpSzx) * (SyzpSzy) - (SxypSyx) * (SxxpSyy - Szz)) *
                  (-(SxzmSzx) * (SyzmSzy) - (SxypSyx) * (SxxpSyy + Szz));
  const float H = ((SxypSyx) * (SyzpSzy) + (SxzpSzx) * (SxxmSyy + Szz)) *
                  (-(SxymSyx) * (SyzmSzy) + (SxzpSzx) * (SxxpSyy + Szz));
  const float I = ((SxypSyx) * (SyzmSzy) + (SxzmSzx) * (SxxmSyy - Szz)) *
                  (-(SxymSyx) * (SyzpSzy) + (SxzmSzx) * (SxxpSyy - Szz));
  const float C0 = D + E + F + G + H + I;

  const float lam0 = gsum * 0.5f;
  // the clamp keeps inv^4 finite for G = 0 structures (qcp.py:124-129)
  const float inv = 1.0f / fmaxf(lam0, 1e-9f);
  const float inv2 = inv * inv;
  const float c2 = C2 * inv2, c1 = C1 * inv2 * inv, c0 = C0 * inv2 * inv2;

  float u = 1.0f;
#pragma unroll
  for (int k = 0; k < kNewtonIters; ++k) {
    const float u2 = u * u;
    const float p = u2 * u2 + c2 * u2 + c1 * u + c0;
    const float dp = u * (4.0f * u2 + 2.0f * c2) + c1;
    const float den = fabsf(dp) < 1e-12f ? 1e-12f : dp;
    const float step = fminf(fmaxf(p / den, -0.5f), 0.5f);
    u = u - step;
  }
  u = fminf(fmaxf(u, 0.0f), 1.0f);
  return sqrtf(fmaxf(gsum - 2.0f * u * lam0, 0.0f) / n_atoms);
}
