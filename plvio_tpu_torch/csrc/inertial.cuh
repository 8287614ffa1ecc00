// Inertial device functions shared by csrc/vi_pose_lm.cu (the VI frame's
// pose optimizer), csrc/inertial_chain.cu (the inertial window BA's chain
// edges) and csrc/inertial_gs_lm.cu (IMU initialization and scale
// refinement): 3x3 algebra, SO(3) exp / log / right Jacobians, Gram-Schmidt
// normalization, a dense Cholesky that gives NaN where the matrix is not
// definite, whitening by L^T, and the 9-dim preintegration residual of
// plvio_tpu/solver/residuals.py `make_inertial` (:318) with its analytic
// Jacobian.  Each kernel file is built on its own, so these are compiled
// into each library that includes them.
#pragma once

#include <math.h>

#include "common.cuh"

namespace plv {

constexpr float kPi = 3.14159265358979323846f;

// the stacked preintegration constants of one link (PRE_KEYS order, 67
// floats: dT, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, bg0, ba0)
struct Pre {
  float dT, dR[9], dV[3], dP[3], JRg[9], JVg[9], JVa[9], JPg[9], JPa[9];
  float bg0[3], ba0[3];
};

__device__ __forceinline__ void load_pre(const float* c, Pre& q) {
  q.dT = c[0];
  for (int i = 0; i < 9; ++i) {
    q.dR[i] = c[1 + i];
    q.JRg[i] = c[16 + i];
    q.JVg[i] = c[25 + i];
    q.JVa[i] = c[34 + i];
    q.JPg[i] = c[43 + i];
    q.JPa[i] = c[52 + i];
  }
  for (int i = 0; i < 3; ++i) {
    q.dV[i] = c[10 + i];
    q.dP[i] = c[13 + i];
    q.bg0[i] = c[61 + i];
    q.ba0[i] = c[64 + i];
  }
}

// ------------------------------------------------------------- 3x3 algebra
__device__ __forceinline__ void mul3(const float* A, const float* B,
                                     float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j]
                     + A[3 * i + 2] * B[6 + j];
}
__device__ __forceinline__ void mul3tn(const float* A, const float* B,
                                       float* C) {   // A^T B
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[i] * B[j] + A[3 + i] * B[3 + j] + A[6 + i] * B[6 + j];
}
__device__ __forceinline__ void mv3(const float* A, const float* x,
                                    float* y) {
  for (int i = 0; i < 3; ++i)
    y[i] = A[3 * i] * x[0] + A[3 * i + 1] * x[1] + A[3 * i + 2] * x[2];
}
__device__ __forceinline__ void mtv3(const float* A, const float* x,
                                     float* y) {     // A^T x
  for (int i = 0; i < 3; ++i)
    y[i] = A[i] * x[0] + A[3 + i] * x[1] + A[6 + i] * x[2];
}
__device__ __forceinline__ void hat3(const float* w, float* W) {
  W[0] = 0.f;   W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0.f;   W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0.f;
}

struct Theta {
  float theta2, theta, W[9], W2[9];
  bool small;
};
__device__ void theta_terms(const float* w, Theta& t) {
  t.theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  t.small = t.theta2 < 1e-6f;
  t.theta = sqrtf(fmaxf(t.theta2, 1e-24f));
  hat3(w, t.W);
  mul3(t.W, t.W, t.W2);
}
__device__ void so3_exp(const float* w, float* R) {
  Theta t;
  theta_terms(w, t);
  const float A = t.small ? 1.f - t.theta2 / 6.f : sinf(t.theta) / t.theta;
  const float B = t.small ? 0.5f - t.theta2 / 24.f
                          : (1.f - cosf(t.theta)) / t.theta2;
  for (int i = 0; i < 9; ++i)
    R[i] = ((i % 4 == 0) ? 1.f : 0.f) + A * t.W[i] + B * t.W2[i];
}
__device__ void so3_jr(const float* w, float* J) {
  Theta t;
  theta_terms(w, t);
  const float B = t.small ? 0.5f - t.theta2 / 24.f
                          : (1.f - cosf(t.theta)) / t.theta2;
  const float C = t.small ? 1.f / 6.f - t.theta2 / 120.f
                          : (t.theta - sinf(t.theta)) / (t.theta2 * t.theta);
  for (int i = 0; i < 9; ++i)
    J[i] = ((i % 4 == 0) ? 1.f : 0.f) - B * t.W[i] + C * t.W2[i];
}
__device__ void so3_jr_inv(const float* w, float* J) {
  Theta t;
  theta_terms(w, t);
  const float cot = t.small
      ? 1.f / 12.f + t.theta2 / 720.f
      : 1.f / t.theta2 - (1.f + cosf(t.theta))
            / (2.f * t.theta * fmaxf(sinf(t.theta), 1e-12f));
  for (int i = 0; i < 9; ++i)
    J[i] = ((i % 4 == 0) ? 1.f : 0.f) + 0.5f * t.W[i] + cot * t.W2[i];
}
// lie.so3_log: atan2 form, small-angle surrogate, near-pi axis branch
__device__ void so3_log(const float* R, float* out) {
  const float tr = R[0] + R[4] + R[8];
  const float cos_t = fminf(fmaxf((tr - 1.f) * 0.5f, -1.f), 1.f);
  const float w[3] = {(R[7] - R[5]) * 0.5f, (R[2] - R[6]) * 0.5f,
                      (R[3] - R[1]) * 0.5f};
  const float w2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = w2 < 1e-12f;
  const float sin_t = sqrtf(small ? 1.f : w2);
  const float theta = atan2f(sin_t, cos_t);
  const float scale = small ? 1.f + (1.f - cos_t) / 3.f : theta / sin_t;
  if (theta > kPi - 1e-3f) {
    const float d[3] = {R[0] + 1.f, R[4] + 1.f, R[8] + 1.f};
    int k = 0;
    if (d[1] > d[k]) k = 1;
    if (d[2] > d[k]) k = 2;
    const float col[3] = {R[k] + (k == 0), R[3 + k] + (k == 1),
                          R[6 + k] + (k == 2)};
    const float n = fmaxf(sqrtf(col[0] * col[0] + col[1] * col[1]
                                + col[2] * col[2]), 1e-12f);
    const float ax[3] = {col[0] / n, col[1] / n, col[2] / n};
    const float sg = (ax[0] * w[0] + ax[1] * w[1] + ax[2] * w[2]) < 0.f
                         ? -1.f : 1.f;
    for (int i = 0; i < 3; ++i) out[i] = ax[i] * sg * theta;
  } else {
    for (int i = 0; i < 3; ++i) out[i] = w[i] * scale;
  }
}
__device__ void so3_normalize(const float* R, float* out) {
  float r0[3] = {R[0], R[1], R[2]};
  const float n0 = fmaxf(sqrtf(r0[0] * r0[0] + r0[1] * r0[1]
                               + r0[2] * r0[2]), 1e-12f);
  for (int k = 0; k < 3; ++k) r0[k] = r0[k] / n0;
  const float d = R[3] * r0[0] + R[4] * r0[1] + R[5] * r0[2];
  float r1[3] = {R[3] - d * r0[0], R[4] - d * r0[1], R[5] - d * r0[2]};
  const float n1 = fmaxf(sqrtf(r1[0] * r1[0] + r1[1] * r1[1]
                               + r1[2] * r1[2]), 1e-12f);
  for (int k = 0; k < 3; ++k) r1[k] = r1[k] / n1;
  out[0] = r0[0]; out[1] = r0[1]; out[2] = r0[2];
  out[3] = r1[0]; out[4] = r1[1]; out[5] = r1[2];
  out[6] = r0[1] * r1[2] - r0[2] * r1[1];
  out[7] = r0[2] * r1[0] - r0[0] * r1[2];
  out[8] = r0[0] * r1[1] - r0[1] * r1[0];
}

// lower Cholesky of an n x n SPD matrix; NaN where it is not definite
__device__ void cholesky(const float* A, float* L, int n) {
  bool ok = true;
  for (int i = 0; i < n * n; ++i) L[i] = 0.f;
  for (int j = 0; j < n; ++j) {
    float d = A[j * n + j];
    for (int q = 0; q < j; ++q) d -= L[j * n + q] * L[j * n + q];
    ok = ok && (d > 0.f);
    L[j * n + j] = sqrtf(d);
    for (int i = j + 1; i < n; ++i) {
      float x = A[i * n + j];
      for (int q = 0; q < j; ++q) x -= L[i * n + q] * L[j * n + q];
      L[i * n + j] = x / L[j * n + j];
    }
  }
  if (!ok)
    for (int i = 0; i < n * n; ++i) L[i] = __int_as_float(0x7fc00000);
}

// whiten by L^T (L lower, n x n): y = L^T x, columns of J likewise
__device__ void whiten(const float* L, int n, int nc, float* r, float* J) {
  for (int i = 0; i < n; ++i) {
    float x = 0.f;
    for (int j = i; j < n; ++j) x += L[j * n + i] * r[j];
    r[i] = x;                      // rows below i are read later: ok, j>=i
    if (J)
      for (int c = 0; c < nc; ++c) {
        float y = 0.f;
        for (int j = i; j < n; ++j) y += L[j * n + i] * J[j * nc + c];
        J[i * nc + c] = y;
      }
  }
}

// The 9-dim inertial residual r = (er, ev, ep) between body states 1 and 2
// with the biases (bg, ba) of the link, and (jac) its Jacobian J [9][24]
// with columns dp1 0, dth1 3, v1 6, bg 9, ba 12, dp2 15, dth2 18, v2 21.
__device__ void inertial_edge(const float* R1, const float* p1,
                              const float* v1, const float* bg,
                              const float* ba, const float* R2,
                              const float* p2, const float* v2,
                              const Pre& q, float gravity, bool jac,
                              float* r, float* J) {
  const float g[3] = {0.f, 0.f, -gravity};
  float dbg[3], dba[3];
  for (int i = 0; i < 3; ++i) {
    dbg[i] = bg[i] - q.bg0[i];
    dba[i] = ba[i] - q.ba0[i];
  }
  float phi[3], Ephi[9], dRc[9], R1dRc[9], E[9], er[3];
  mv3(q.JRg, dbg, phi);
  so3_exp(phi, Ephi);
  mul3(q.dR, Ephi, dRc);                  // dR_corr
  mul3(R1, dRc, R1dRc);
  mul3tn(R1dRc, R2, E);                   // dR_corr^T R1^T R2
  so3_log(E, er);
  const float dT = q.dT;
  float av[3], ap[3], ev[3], ep[3], t3[3], u3[3];
  for (int i = 0; i < 3; ++i) {
    av[i] = v2[i] - v1[i] - g[i] * dT;
    ap[i] = p2[i] - p1[i] - v1[i] * dT - 0.5f * g[i] * dT * dT;
  }
  mtv3(R1, av, t3);
  mv3(q.JVg, dbg, u3);
  float u4[3];
  mv3(q.JVa, dba, u4);
  for (int i = 0; i < 3; ++i) ev[i] = t3[i] - (q.dV[i] + u3[i] + u4[i]);
  float Rap[3];
  mtv3(R1, ap, Rap);
  mv3(q.JPg, dbg, u3);
  mv3(q.JPa, dba, u4);
  for (int i = 0; i < 3; ++i) ep[i] = Rap[i] - (q.dP[i] + u3[i] + u4[i]);
  for (int i = 0; i < 3; ++i) {
    r[i] = er[i];
    r[3 + i] = ev[i];
    r[6 + i] = ep[i];
  }
  if (!jac) return;
  for (int i = 0; i < 9 * 24; ++i) J[i] = 0.f;
  float Jri[9], Jr[9], M[9], N[9], R2tR1[9];
  so3_jr_inv(er, Jri);
  so3_jr(phi, Jr);
  mul3tn(R2, R1, R2tR1);                  // R2^T R1
  mul3(Jri, R2tR1, M);                    // d er / d theta1 = -M
  float EtJr[9], EtJrJ[9];
  mul3tn(E, Jr, EtJr);                    // E^T Jr
  mul3(EtJr, q.JRg, EtJrJ);
  mul3(Jri, EtJrJ, N);                    // d er / d bg = -N
  float Hv[9], Hp[9];
  hat3(t3, Hv);                           // hat(R1^T av)
  hat3(Rap, Hp);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float R1t = R1[3 * j + i];
      J[i * 24 + 3 + j] = -M[3 * i + j];
      J[i * 24 + 9 + j] = -N[3 * i + j];
      J[i * 24 + 18 + j] = Jri[3 * i + j];
      J[(3 + i) * 24 + 3 + j] = Hv[3 * i + j];
      J[(3 + i) * 24 + 6 + j] = -R1t;
      J[(3 + i) * 24 + 9 + j] = -q.JVg[3 * i + j];
      J[(3 + i) * 24 + 12 + j] = -q.JVa[3 * i + j];
      J[(3 + i) * 24 + 21 + j] = R1t;
      J[(6 + i) * 24 + 0 + j] = -R1t;
      J[(6 + i) * 24 + 3 + j] = Hp[3 * i + j];
      J[(6 + i) * 24 + 6 + j] = -R1t * dT;
      J[(6 + i) * 24 + 9 + j] = -q.JPg[3 * i + j];
      J[(6 + i) * 24 + 12 + j] = -q.JPa[3 * i + j];
      J[(6 + i) * 24 + 15 + j] = R1t;
    }
}

}  // namespace plv
