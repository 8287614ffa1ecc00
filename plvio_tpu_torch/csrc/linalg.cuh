// Small dense float64 eigen- and singular-value solvers shared by the
// kernels (per thread, in registers): the 4x4 null vector of the DLT
// triangulation (triangulate.cu, twoview.cu), a symmetric N x N Jacobi
// eigen-solver, one-sided Jacobi (Hestenes) on an M x N matrix and the
// 3x3 SVD built on it (twoview.cu).
#pragma once

#include <cuda_runtime.h>

// Eigenvector of the smallest eigenvalue of the symmetric 4x4 matrix S,
// by cyclic Jacobi sweeps (S is overwritten).
__device__ inline void jacobi_null4(double S[4][4], double v[4]) {
  double V[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) V[i][j] = i == j ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 30; ++sweep) {
    double off = 0.0;
    for (int p = 0; p < 4; ++p)
      for (int q = p + 1; q < 4; ++q) off += S[p][q] * S[p][q];
    if (off < 1e-300) break;
    for (int p = 0; p < 4; ++p) {
      for (int q = p + 1; q < 4; ++q) {
        const double apq = S[p][q];
        if (fabs(apq) < 1e-300) continue;
        const double theta = (S[q][q] - S[p][p]) / (2.0 * apq);
        const double t = (theta >= 0.0 ? 1.0 : -1.0)
            / (fabs(theta) + sqrt(theta * theta + 1.0));
        const double c = 1.0 / sqrt(t * t + 1.0);
        const double s = t * c;
        for (int k = 0; k < 4; ++k) {          // S <- S J
          const double skp = S[k][p], skq = S[k][q];
          S[k][p] = c * skp - s * skq;
          S[k][q] = s * skp + c * skq;
        }
        for (int k = 0; k < 4; ++k) {          // S <- J^T S
          const double spk = S[p][k], sqk = S[q][k];
          S[p][k] = c * spk - s * sqk;
          S[q][k] = s * spk + c * sqk;
        }
        for (int k = 0; k < 4; ++k) {          // V <- V J
          const double vkp = V[k][p], vkq = V[k][q];
          V[k][p] = c * vkp - s * vkq;
          V[k][q] = s * vkp + c * vkq;
        }
      }
    }
  }
  int m = 0;
  for (int i = 1; i < 4; ++i)
    if (S[i][i] < S[m][m]) m = i;
  for (int k = 0; k < 4; ++k) v[k] = V[k][m];
}

// Eigenvector v of the smallest eigenvalue of the symmetric N x N matrix S
// (overwritten) by cyclic Jacobi sweeps.  A pair is rotated until its
// off-diagonal entry is below 1e-16 of the geometric mean of the two
// diagonal entries, the criterion under which Jacobi resolves small
// eigenvalues to high relative accuracy.  Returns the rotations applied.
template <int N>
__device__ int jacobi_min_eigvec(double S[N][N], double v[N]) {
  int rotations = 0;
  double V[N][N];
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) V[i][j] = i == j ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 50; ++sweep) {
    bool rotated = false;
    for (int p = 0; p < N; ++p) {
      for (int q = p + 1; q < N; ++q) {
        const double apq = S[p][q];
        if (fabs(apq) <= 1e-16 * sqrt(fabs(S[p][p] * S[q][q]))
            || fabs(apq) < 1e-300)
          continue;
        rotated = true;
        ++rotations;
        const double theta = (S[q][q] - S[p][p]) / (2.0 * apq);
        const double t = (theta >= 0.0 ? 1.0 : -1.0)
            / (fabs(theta) + sqrt(theta * theta + 1.0));
        const double c = 1.0 / sqrt(t * t + 1.0);
        const double s = t * c;
        for (int k = 0; k < N; ++k) {
          const double skp = S[k][p], skq = S[k][q];
          S[k][p] = c * skp - s * skq;
          S[k][q] = s * skp + c * skq;
        }
        for (int k = 0; k < N; ++k) {
          const double spk = S[p][k], sqk = S[q][k];
          S[p][k] = c * spk - s * sqk;
          S[q][k] = s * spk + c * sqk;
        }
        for (int k = 0; k < N; ++k) {
          const double vkp = V[k][p], vkq = V[k][q];
          V[k][p] = c * vkp - s * vkq;
          V[k][q] = s * vkp + c * vkq;
        }
      }
    }
    if (!rotated) break;
  }
  int m = 0;
  for (int i = 1; i < N; ++i)
    if (S[i][i] < S[m][m]) m = i;
  for (int k = 0; k < N; ++k) v[k] = V[k][m];
  return rotations;
}

// One-sided Jacobi (Hestenes) on the M x N matrix A: rotates pairs of
// columns until every pair is orthogonal to 1e-15 of its norms, so that
// on return A holds A0 V with orthogonal columns (their norms are the
// singular values, unsorted) and V (N x N) is orthogonal.  Pairs whose
// inner product is below 1e-32 of |A0|_F^2 count as orthogonal, so a
// column that a rank-deficient A0 drives to zero stops rotating.
template <int M, int N>
__device__ void onesided_jacobi(double A[M][N], double V[N][N]) {
  double fro = 0.0;
  for (int i = 0; i < M; ++i)
    for (int j = 0; j < N; ++j) fro += A[i][j] * A[i][j];
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) V[i][j] = i == j ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 60; ++sweep) {
    bool rotated = false;
    for (int p = 0; p < N; ++p) {
      for (int q = p + 1; q < N; ++q) {
        double al = 0.0, be = 0.0, ga = 0.0;
        for (int k = 0; k < M; ++k) {
          al += A[k][p] * A[k][p];
          be += A[k][q] * A[k][q];
          ga += A[k][p] * A[k][q];
        }
        if (fabs(ga) <= 1e-15 * sqrt(al * be) || fabs(ga) <= 1e-32 * fro)
          continue;
        rotated = true;
        const double zeta = (be - al) / (2.0 * ga);
        const double t = (zeta >= 0.0 ? 1.0 : -1.0)
            / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
        const double c = 1.0 / sqrt(1.0 + t * t);
        const double s = c * t;
        for (int k = 0; k < M; ++k) {
          const double ap = A[k][p], aq = A[k][q];
          A[k][p] = c * ap - s * aq;
          A[k][q] = s * ap + c * aq;
        }
        for (int k = 0; k < N; ++k) {
          const double vp = V[k][p], vq = V[k][q];
          V[k][p] = c * vp - s * vq;
          V[k][q] = s * vp + c * vq;
        }
      }
    }
    if (!rotated) break;
  }
}

// Right singular vector of the smallest singular value of the M x N
// matrix A (overwritten), by one-sided Jacobi: the column of V whose
// rotated column of A has the least norm.
template <int M, int N>
__device__ void min_right_singular(double A[M][N], double v[N]) {
  double V[N][N];
  onesided_jacobi<M, N>(A, V);
  int m = 0;
  double best = 0.0;
  for (int j = 0; j < N; ++j) {
    double n2 = 0.0;
    for (int k = 0; k < M; ++k) n2 += A[k][j] * A[k][j];
    if (j == 0 || n2 < best) { best = n2; m = j; }
  }
  for (int k = 0; k < N; ++k) v[k] = V[k][m];
}

__device__ inline double det3(const double A[3][3]) {
  return A[0][0] * (A[1][1] * A[2][2] - A[1][2] * A[2][1])
       - A[0][1] * (A[1][0] * A[2][2] - A[1][2] * A[2][0])
       + A[0][2] * (A[1][0] * A[2][1] - A[1][1] * A[2][0]);
}

// SVD A = U diag(S) V^T of a 3x3 matrix, singular values in descending
// order.  U is a proper rotation: u0 and u1 from A v / s, u2 = u0 x u1,
// and v2 takes the sign that keeps A v2 = s2 u2 (for a rank-2 A, whose
// third left vector is free, any sign).
__device__ inline void svd3(const double A0[3][3], double U[3][3], double S[3],
                            double V[3][3]) {
  double B[3][3], W[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) B[i][j] = A0[i][j];
  onesided_jacobi<3, 3>(B, W);
  double n[3];
  for (int j = 0; j < 3; ++j)
    n[j] = sqrt(B[0][j] * B[0][j] + B[1][j] * B[1][j] + B[2][j] * B[2][j]);
  int o[3] = {0, 1, 2};                // columns by descending norm
  for (int a = 0; a < 3; ++a)
    for (int b = a + 1; b < 3; ++b)
      if (n[o[b]] > n[o[a]]) { const int t = o[a]; o[a] = o[b]; o[b] = t; }
  for (int j = 0; j < 3; ++j) {
    S[j] = n[o[j]];
    for (int k = 0; k < 3; ++k) V[k][j] = W[k][o[j]];
  }
  double u0[3], u1[3];
  for (int k = 0; k < 3; ++k) u0[k] = B[k][o[0]] / fmax(S[0], 1e-300);
  double d = 0.0;
  for (int k = 0; k < 3; ++k) { u1[k] = B[k][o[1]]; d += u0[k] * u1[k]; }
  double nn = 0.0;
  for (int k = 0; k < 3; ++k) { u1[k] -= d * u0[k]; nn += u1[k] * u1[k]; }
  nn = fmax(sqrt(nn), 1e-300);
  for (int k = 0; k < 3; ++k) u1[k] /= nn;
  const double u2[3] = {u0[1] * u1[2] - u0[2] * u1[1],
                        u0[2] * u1[0] - u0[0] * u1[2],
                        u0[0] * u1[1] - u0[1] * u1[0]};
  for (int k = 0; k < 3; ++k) {
    U[k][0] = u0[k];
    U[k][1] = u1[k];
    U[k][2] = u2[k];
  }
  double proj = 0.0;                   // (A v2) . u2
  for (int k = 0; k < 3; ++k) proj += B[k][o[2]] * u2[k];
  if (proj < 0.0)
    for (int k = 0; k < 3; ++k) V[k][2] = -V[k][2];
}
