// Sim(3) arithmetic of the loop closer's kernels (sim3.cu, pose_graph.cu),
// templated on the scalar: double, or Dual, a double with one forward-mode
// tangent.  The functions follow plvio_tpu/utils/lie.py (`so3_exp` :51,
// `so3_log` :65, `so3_normalize`, `_sim3_W` :260, `sim3_exp`, `sim3_log`,
// `sim3_inv`, `sim3_mul`) and plvio_tpu/solver/residuals.py
// (`retract_sim3_single` :396, `retract_sim3_4dof_single` :414,
// `sim3_edge` :437, `sim3_edge_4dof` :452) operation for operation,
// branches chosen on the values as jnp.where chooses (so a Dual carries the
// tangent that jax.jacfwd takes through the same composition).
// Matrices are row-major double[9] (or T[9]); a Sim(3) state is
// [13] = R (9), t (3), s.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define PLVIO_HD __host__ __device__ inline
#else
#define PLVIO_HD inline
#endif

struct Dual {
  double v, d;
  PLVIO_HD Dual() : v(0.0), d(0.0) {}
  PLVIO_HD Dual(double x) : v(x), d(0.0) {}   // NOLINT: constants
  PLVIO_HD Dual(double x, double dx) : v(x), d(dx) {}
};

PLVIO_HD double val(double x) { return x; }
PLVIO_HD double val(const Dual& x) { return x.v; }

PLVIO_HD Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.d + b.d); }
PLVIO_HD Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.d - b.d); }
PLVIO_HD Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
PLVIO_HD Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
}
PLVIO_HD Dual operator/(Dual a, Dual b) {
  const double q = a.v / b.v;
  return Dual(q, (a.d - q * b.d) / b.v);
}
PLVIO_HD Dual operator+(Dual a, double b) { return Dual(a.v + b, a.d); }
PLVIO_HD Dual operator+(double a, Dual b) { return Dual(a + b.v, b.d); }
PLVIO_HD Dual operator-(Dual a, double b) { return Dual(a.v - b, a.d); }
PLVIO_HD Dual operator-(double a, Dual b) { return Dual(a - b.v, -b.d); }
PLVIO_HD Dual operator*(Dual a, double b) { return Dual(a.v * b, a.d * b); }
PLVIO_HD Dual operator*(double a, Dual b) { return Dual(a * b.v, a * b.d); }
PLVIO_HD Dual operator/(Dual a, double b) { return Dual(a.v / b, a.d / b); }
PLVIO_HD Dual operator/(double a, Dual b) {
  const double q = a / b.v;
  return Dual(q, -q * b.d / b.v);
}

PLVIO_HD double sqrt_(double x) { return sqrt(x); }
PLVIO_HD Dual sqrt_(Dual x) {
  const double r = sqrt(x.v);
  return Dual(r, x.d / (2.0 * r));
}
PLVIO_HD double sin_(double x) { return sin(x); }
PLVIO_HD Dual sin_(Dual x) { return Dual(sin(x.v), cos(x.v) * x.d); }
PLVIO_HD double cos_(double x) { return cos(x); }
PLVIO_HD Dual cos_(Dual x) { return Dual(cos(x.v), -sin(x.v) * x.d); }
PLVIO_HD double exp_(double x) { return exp(x); }
PLVIO_HD Dual exp_(Dual x) {
  const double e = exp(x.v);
  return Dual(e, e * x.d);
}
PLVIO_HD double log_(double x) { return log(x); }
PLVIO_HD Dual log_(Dual x) { return Dual(log(x.v), x.d / x.v); }
PLVIO_HD double atan2_(double y, double x) { return atan2(y, x); }
PLVIO_HD Dual atan2_(Dual y, Dual x) {
  const double r2 = x.v * x.v + y.v * y.v;
  return Dual(atan2(y.v, x.v), (x.v * y.d - y.v * x.d) / r2);
}
// jnp.maximum(x, c) / jnp.minimum away from ties: the chosen operand's
// tangent
template <typename T>
PLVIO_HD T maxc(T x, double c) { return val(x) > c ? x : T(c); }
template <typename T>
PLVIO_HD T clip1(T x) {
  return val(x) > 1.0 ? T(1.0) : (val(x) < -1.0 ? T(-1.0) : x);
}

template <typename T>
PLVIO_HD void matmul3(const T A[9], const T B[9], T C[9]) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      C[3 * r + c] = A[3 * r] * B[c] + A[3 * r + 1] * B[3 + c]
          + A[3 * r + 2] * B[6 + c];
}

template <typename T>
PLVIO_HD void matvec3(const T A[9], const T x[3], T y[3]) {
  for (int r = 0; r < 3; ++r)
    y[r] = A[3 * r] * x[0] + A[3 * r + 1] * x[1] + A[3 * r + 2] * x[2];
}

template <typename T>
PLVIO_HD void hat3(const T w[3], T W[9]) {
  W[0] = T(0.0); W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2]; W[4] = T(0.0); W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0]; W[8] = T(0.0);
}

// I + a W + b W^2
template <typename T>
PLVIO_HD void rodrigues(const T w[3], T a, T b, T R[9]) {
  T W[9], W2[9];
  hat3(w, W);
  matmul3(W, W, W2);
  for (int i = 0; i < 9; ++i)
    R[i] = (i % 4 == 0 ? T(1.0) : T(0.0)) + a * W[i] + b * W2[i];
}

template <typename T>
PLVIO_HD void so3_exp(const T w[3], T R[9]) {
  const T theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = val(theta2) < 1e-6;
  T A, B;
  if (small) {
    A = 1.0 - theta2 / 6.0;
    B = 0.5 - theta2 / 24.0;
  } else {
    const T theta = sqrt_(maxc(theta2, 1e-24));
    A = sin_(theta) / theta;
    B = (1.0 - cos_(theta)) / theta2;
  }
  rodrigues(w, A, B, R);
}

template <typename T>
PLVIO_HD void so3_log(const T R[9], T phi[3]) {
  const T tr = R[0] + R[4] + R[8];
  const T cos_t = clip1((tr - 1.0) * 0.5);
  const T w[3] = {(R[7] - R[5]) * 0.5, (R[2] - R[6]) * 0.5,
                  (R[3] - R[1]) * 0.5};
  const T w2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = val(w2) < 1e-12;
  const T sin_t = small ? T(1.0) : sqrt_(w2);
  const T theta = atan2_(sin_t, cos_t);
  if (val(theta) > 3.141592653589793 - 1e-3) {
    const double dg[3] = {val(R[0]) + 1.0, val(R[4]) + 1.0, val(R[8]) + 1.0};
    int k = 0;
    for (int i = 1; i < 3; ++i)
      if (dg[i] > dg[k]) k = i;
    T col[3];
    for (int i = 0; i < 3; ++i) col[i] = R[3 * i + k] + (i == k ? 1.0 : 0.0);
    const T nrm = maxc(sqrt_(col[0] * col[0] + col[1] * col[1]
                             + col[2] * col[2]), 1e-12);
    const double dot = val(col[0] / nrm * w[0] + col[1] / nrm * w[1]
                           + col[2] / nrm * w[2]);
    const double sg = dot < 0.0 ? -1.0 : 1.0;
    for (int i = 0; i < 3; ++i) phi[i] = col[i] / nrm * sg * theta;
    return;
  }
  const T scale = small ? 1.0 + (1.0 - cos_t) / 3.0 : theta / sin_t;
  for (int i = 0; i < 3; ++i) phi[i] = w[i] * scale;
}

// W = a0 I + a1 phi^ + a2 phi^^2 with the Taylor guards at |sigma| and
// theta below 1e-4 (utils/lie.py:260)
template <typename T>
PLVIO_HD void sim3_W(const T phi[3], T sigma, T Wm[9]) {
  const double eps = 1e-4;
  const T theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const T theta = sqrt_(maxc(theta2, 1e-24));
  const T s = exp_(sigma);
  const bool sig_small = fabs(val(sigma)) < eps;
  const bool th_small = val(theta) < eps;
  T a0;
  if (sig_small)
    a0 = 1.0 + sigma / 2.0 + sigma * sigma / 6.0;
  else
    a0 = (s - 1.0) / sigma;
  T a1, a2;
  if (th_small) {
    if (sig_small) {
      a1 = 0.5 + sigma / 3.0;
      a2 = 1.0 / 6.0 + sigma / 8.0;
    } else {
      a1 = (s * (sigma - 1.0) + 1.0) / (sigma * sigma);
      a2 = (s * (sigma * sigma - 2.0 * sigma + 2.0) - 2.0)
          / (2.0 * (sigma * sigma * sigma));
    }
  } else {
    const T denom = maxc(sigma * sigma + theta2, 1e-24);
    const T sn = sin_(theta), cs = cos_(theta);
    const T int_sin = (s * (sigma * sn - theta * cs) + theta) / denom;
    const T int_cos = (s * (sigma * cs + theta * sn) - sigma) / denom;
    a1 = int_sin / theta;
    a2 = (a0 - int_cos) / maxc(theta2, 1e-24);
  }
  T Wh[9], Wh2[9];
  hat3(phi, Wh);
  matmul3(Wh, Wh, Wh2);
  for (int i = 0; i < 9; ++i)
    Wm[i] = (i % 4 == 0 ? a0 : T(0.0)) + a1 * Wh[i] + a2 * Wh2[i];
}

// x = A^{-1} b by the adjugate over the determinant (Cramer's rule): the
// 3x3 W of sim3_log is near the identity, and a fixed operation order
// (no pivoting) carries the Dual's tangent without data-dependent swaps
template <typename T>
PLVIO_HD void solve3(const T A[9], const T b[3], T x[3]) {
  const T c0 = A[4] * A[8] - A[5] * A[7];
  const T c1 = A[5] * A[6] - A[3] * A[8];
  const T c2 = A[3] * A[7] - A[4] * A[6];
  const T det = A[0] * c0 + A[1] * c1 + A[2] * c2;
  const T adj[9] = {c0, A[2] * A[7] - A[1] * A[8], A[1] * A[5] - A[2] * A[4],
                    c1, A[0] * A[8] - A[2] * A[6], A[2] * A[3] - A[0] * A[5],
                    c2, A[1] * A[6] - A[0] * A[7], A[0] * A[4] - A[1] * A[3]};
  for (int r = 0; r < 3; ++r)
    x[r] = (adj[3 * r] * b[0] + adj[3 * r + 1] * b[1] + adj[3 * r + 2] * b[2])
        / det;
}

template <typename T>
PLVIO_HD void sim3_exp(const T xi[7], T R[9], T t[3], T* s) {
  T Wm[9];
  so3_exp(xi + 3, R);
  sim3_W(xi + 3, xi[6], Wm);
  matvec3(Wm, xi, t);
  *s = exp_(xi[6]);
}

template <typename T>
PLVIO_HD void sim3_log(const T R[9], const T t[3], T s, T xi[7]) {
  const T sigma = log_(maxc(s, 1e-12));
  T Wm[9];
  so3_log(R, xi + 3);
  sim3_W(xi + 3, sigma, Wm);
  solve3(Wm, t, xi);
  xi[6] = sigma;
}

template <typename T>
PLVIO_HD void sim3_inv(const T R[9], const T t[3], T s, T Ri[9], T ti[3],
                       T* si) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) Ri[3 * r + c] = R[3 * c + r];
  const T sinv = 1.0 / s;
  T v[3];
  matvec3(Ri, t, v);
  for (int i = 0; i < 3; ++i) ti[i] = -sinv * v[i];
  *si = sinv;
}

template <typename T>
PLVIO_HD void sim3_mul(const T Ra[9], const T ta[3], T sa, const T Rb[9],
                       const T tb[3], T sb, T R[9], T t[3], T* s) {
  T v[3];
  matmul3(Ra, Rb, R);
  matvec3(Ra, tb, v);
  for (int i = 0; i < 3; ++i) t[i] = sa * v[i] + ta[i];
  *s = sa * sb;
}

// rho, yaw free; roll, pitch, sigma frozen (residuals.py _SIM3_4DOF_MASK)
PLVIO_HD double mask4(int k) { return (k < 3 || k == 5) ? 1.0 : 0.0; }

// S' = Exp(d) S (7-DoF) or S' = S Exp(d mask) (4-DoF)
template <typename T>
PLVIO_HD void retract(const T S[13], const T d[7], bool four_dof, T R[9],
                      T t[3], T* s) {
  T dR[9], dt[3], ds;
  if (!four_dof) {
    sim3_exp(d, dR, dt, &ds);
    T v[3];
    matmul3(dR, S, R);
    matvec3(dR, S + 9, v);
    for (int i = 0; i < 3; ++i) t[i] = ds * v[i] + dt[i];
    *s = ds * S[12];
    return;
  }
  T dm[7];
  for (int k = 0; k < 7; ++k) dm[k] = d[k] * mask4(k);
  sim3_exp(dm, dR, dt, &ds);
  T v[3];
  matmul3(S, dR, R);
  matvec3(S, dt, v);
  for (int i = 0; i < 3; ++i) t[i] = S[12] * v[i] + S[9 + i];
  *s = S[12];
}

// r = log(S_ji S_i S_j^{-1}) with S_i, S_j perturbed by di, dj
template <typename T>
PLVIO_HD void sim3_edge(const T Si[13], const T Sj[13], const T Rji[9],
                        const T tji[3], T sji, const T di[7], const T dj[7],
                        bool four_dof, T r[7]) {
  T Ri[9], ti[3], si, Rj[9], tj[3], sj;
  retract(Si, di, four_dof, Ri, ti, &si);
  retract(Sj, dj, four_dof, Rj, tj, &sj);
  T Rjv[9], tjv[3], sjv, R1[9], t1[3], s1, R2[9], t2[3], s2;
  sim3_inv(Rj, tj, sj, Rjv, tjv, &sjv);
  sim3_mul(Ri, ti, si, Rjv, tjv, sjv, R1, t1, &s1);
  sim3_mul(Rji, tji, sji, R1, t1, s1, R2, t2, &s2);
  sim3_log(R2, t2, s2, r);
}

// Gram-Schmidt on the rows (utils/lie.py so3_normalize), values only
PLVIO_HD void so3_normalize(double R[9]) {
  double r0[3] = {R[0], R[1], R[2]};
  double n0 = fmax(sqrt(r0[0] * r0[0] + r0[1] * r0[1] + r0[2] * r0[2]),
                   1e-12);
  for (int i = 0; i < 3; ++i) r0[i] /= n0;
  const double dp = R[3] * r0[0] + R[4] * r0[1] + R[5] * r0[2];
  double r1[3] = {R[3] - dp * r0[0], R[4] - dp * r0[1], R[5] - dp * r0[2]};
  const double n1 = fmax(sqrt(r1[0] * r1[0] + r1[1] * r1[1]
                              + r1[2] * r1[2]), 1e-12);
  for (int i = 0; i < 3; ++i) r1[i] /= n1;
  R[0] = r0[0]; R[1] = r0[1]; R[2] = r0[2];
  R[3] = r1[0]; R[4] = r1[1]; R[5] = r1[2];
  R[6] = r0[1] * r1[2] - r0[2] * r1[1];
  R[7] = r0[2] * r1[0] - r0[0] * r1[2];
  R[8] = r0[0] * r1[1] - r0[1] * r1[0];
}

// The engine's retract of a state: Exp(d) S (or S Exp(d mask)), the
// rotation re-orthonormalized (residuals.py retract_sim3(_4dof))
PLVIO_HD void retract_state(const double S[13], const double d[7],
                            bool four_dof, double out[13]) {
  double R[9], t[3], s;
  retract(S, d, four_dof, R, t, &s);
  so3_normalize(R);
  for (int i = 0; i < 9; ++i) out[i] = R[i];
  for (int i = 0; i < 3; ++i) out[9 + i] = t[i];
  out[12] = s;
}
