// twoview — the monocular bootstrap's two-view reconstruction in two
// launches: `twoview_hypotheses` solves and scores the RANSAC minimal-set
// models, `twoview_recover` refits the best of each, chooses between H
// and F, and recovers the motion from the chosen model.
//
// Replaces plvio_tpu/ops/twoview.py `reconstruct_two_views` (:278) with
// `_dlt_homography` (:49), `_eight_point_F` (:62), `_dlt_homography_w`
// (:91), `score_F` (:109), `score_H` (:127), `_check_rt` (:166),
// `recover_from_E` (:188) and `recover_from_H` (:219).  The JAX version
// vmaps 200 + 200 float32 SVDs (8x9), scores them as one dense
// [200, N] residual matrix per model, refits by SVDs of 2N x 9 and N x 9
// matrices, and runs both recoveries (4 + 8 motion hypotheses, each a
// batched SVD of N 4x4 systems) before it picks one with `where`.
//
// What bounds it on the H100: latency.  At N = 1000 matches the scoring
// is ~400 x 1000 x ~60 flops (24 Mflop) and the checks ~8 x 1000 Jacobi
// solves of a 4x4 (~20 Mflop), all in float64: well under a millisecond
// of the card's float64 rate, and ~40 KB of inputs.  What costs is the
// serial part: each minimal solve and each refit's eigen-solve runs on one
// thread.
//
// Design:
// - `twoview_hypotheses`: one block per hypothesis (the first `iters` for
//   H, the rest for F).  Thread 0 builds the minimal system in float64
//   and takes its null vector by one-sided Jacobi (H: the 8x9 DLT on
//   pixels; F: Hartley-normalized 8-point with unit weights, rank 2 by a
//   3x3 SVD, then denormalized).  The block then scores every match (H:
//   symmetric transfer with H^-1 by the adjugate and the 1e-9 guards;
//   F: epipolar distances with the 1e-12 guards), each thread summing its
//   rows in order and the block reducing in a fixed tree, so runs repeat.
//   No per-match buffer is written.
// - `twoview_recover`: one block.  The first maximum of each score row
//   (the reference's argmax tie rule), the chosen minimal models' inlier
//   masks, the weighted refits (F: weighted Hartley means; H: 2N
//   weighted rows; each as the least eigenvector of A^T A, 9x9 in
//   float64, accumulated in a fixed order; F cut to rank 2), their
//   scores and masks, the choice SH / (SH + SF) > 0.45, E = K^T F K or
//   Hn = K^-1 H K, and the 4 or 8 motion hypotheses of the chosen model
//   only (the result depends on it alone), each checked over all matches
//   by the DLT triangulation of triangulate.cu (its float64 null vector,
//   linalg.cuh) and the cheirality, parallax and reprojection gates.
//   Counts are integer sums; the winner is the first of the largest
//   counts, and the success gates are the reference's.
#include "common.cuh"
#include "linalg.cuh"

namespace {

constexpr int kHypThreads = 256;
constexpr int kRecThreads = 512;

// Sum over the block (blockDim a multiple of 32), in a fixed order: a
// shuffle tree in each warp, then the warps' partials in order.  Every
// thread gets the sum.
template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = 0;
  const int nw = blockDim.x >> 5;
  for (int w = 0; w < nw; ++w) s += red[w];
  __syncthreads();
  return s;
}

__device__ void inverse3(const double* H, double* Hi) {
  const double A[3][3] = {{H[0], H[1], H[2]}, {H[3], H[4], H[5]},
                          {H[6], H[7], H[8]}};
  const double id = 1.0 / det3(A);
  Hi[0] = (A[1][1] * A[2][2] - A[1][2] * A[2][1]) * id;
  Hi[1] = (A[0][2] * A[2][1] - A[0][1] * A[2][2]) * id;
  Hi[2] = (A[0][1] * A[1][2] - A[0][2] * A[1][1]) * id;
  Hi[3] = (A[1][2] * A[2][0] - A[1][0] * A[2][2]) * id;
  Hi[4] = (A[0][0] * A[2][2] - A[0][2] * A[2][0]) * id;
  Hi[5] = (A[0][2] * A[1][0] - A[0][0] * A[1][2]) * id;
  Hi[6] = (A[1][0] * A[2][1] - A[1][1] * A[2][0]) * id;
  Hi[7] = (A[0][1] * A[2][0] - A[0][0] * A[2][1]) * id;
  Hi[8] = (A[0][0] * A[1][1] - A[0][1] * A[1][0]) * id;
}

// score_H's terms for one match: the robust contribution and the inlier
// flag (symmetric transfer error, threshold 5.991, sigma 1).
__device__ double score_h(const double* H, const double* Hi, double u1,
                          double v1, double u2, double v2, bool valid,
                          bool* ok) {
  const double th = 5.991;
  double w2 = H[6] * u1 + H[7] * v1 + H[8];
  if (fabs(w2) < 1e-9) w2 = 1e-9;
  const double px2 = (H[0] * u1 + H[1] * v1 + H[2]) / w2;
  const double py2 = (H[3] * u1 + H[4] * v1 + H[5]) / w2;
  double w1 = Hi[6] * u2 + Hi[7] * v2 + Hi[8];
  if (fabs(w1) < 1e-9) w1 = 1e-9;
  const double px1 = (Hi[0] * u2 + Hi[1] * v2 + Hi[2]) / w1;
  const double py1 = (Hi[3] * u2 + Hi[4] * v2 + Hi[5]) / w1;
  const double c1 = (px1 - u1) * (px1 - u1) + (py1 - v1) * (py1 - v1);
  const double c2 = (px2 - u2) * (px2 - u2) + (py2 - v2) * (py2 - v2);
  *ok = c1 < th && c2 < th && valid;
  return (valid && c1 < th ? th - c1 : 0.0)
      + (valid && c2 < th ? th - c2 : 0.0);
}

// score_F's terms for one match (epipolar distances in both images,
// threshold 3.841, score 5.991 - chi2).
__device__ double score_f(const double* F, double u1, double v1, double u2,
                          double v2, bool valid, bool* ok) {
  const double th = 3.841, th_score = 5.991;
  const double a2 = F[0] * u1 + F[1] * v1 + F[2];      // l2 = F x1
  const double b2 = F[3] * u1 + F[4] * v1 + F[5];
  const double c2l = F[6] * u1 + F[7] * v1 + F[8];
  const double a1 = F[0] * u2 + F[3] * v2 + F[6];      // l1 = F^T x2
  const double b1 = F[1] * u2 + F[4] * v2 + F[7];
  const double c1l = F[2] * u2 + F[5] * v2 + F[8];
  const double n2 = a2 * u2 + b2 * v2 + c2l;
  const double n1 = a1 * u1 + b1 * v1 + c1l;
  const double d2 = n2 * n2 / fmax(a2 * a2 + b2 * b2, 1e-12);
  const double d1 = n1 * n1 / fmax(a1 * a1 + b1 * b1, 1e-12);
  *ok = d1 < th && d2 < th && valid;
  return (valid && d1 < th ? th_score - d1 : 0.0)
      + (valid && d2 < th ? th_score - d2 : 0.0);
}

// The rank-2 matrix nearest F (3x3, row-major, in place): F minus its
// smallest singular component.
__device__ void rank2(double* F) {
  double B[3][3], W[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) B[r][c] = F[3 * r + c];
  onesided_jacobi<3, 3>(B, W);
  int m = 0;
  double best = 0.0;
  for (int j = 0; j < 3; ++j) {
    const double n2 = B[0][j] * B[0][j] + B[1][j] * B[1][j]
        + B[2][j] * B[2][j];
    if (j == 0 || n2 < best) { best = n2; m = j; }
  }
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      double s = 0.0;
      for (int j = 0; j < 3; ++j)
        if (j != m) s += B[r][j] * W[c][j];
      F[3 * r + c] = s;
    }
}

// F = T2^T F2 T1 with T = [[s, 0, -s mx], [0, s, -s my], [0, 0, 1]].
__device__ void denormalize(double* F, double s1, double mx1, double my1,
                            double s2, double mx2, double my2) {
  const double T1[3][3] = {{s1, 0.0, -s1 * mx1}, {0.0, s1, -s1 * my1},
                           {0.0, 0.0, 1.0}};
  const double T2[3][3] = {{s2, 0.0, -s2 * mx2}, {0.0, s2, -s2 * my2},
                           {0.0, 0.0, 1.0}};
  double M[3][3], O[3][3];
  for (int r = 0; r < 3; ++r)                   // F2 T1
    for (int c = 0; c < 3; ++c)
      M[r][c] = F[3 * r] * T1[0][c] + F[3 * r + 1] * T1[1][c]
          + F[3 * r + 2] * T1[2][c];
  for (int r = 0; r < 3; ++r)                   // T2^T (F2 T1)
    for (int c = 0; c < 3; ++c)
      O[r][c] = T2[0][r] * M[0][c] + T2[1][r] * M[1][c] + T2[2][r] * M[2][c];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) F[3 * r + c] = O[r][c];
}

// ---------------------------------------------------------------------------
// twoview_hypotheses
// ---------------------------------------------------------------------------

struct HypParams {
  const float* uv1;      // [n,2]
  const float* uv2;      // [n,2]
  const uint8_t* valid;  // [n]
  int n;
  const int* idx_h;      // [iters,4]
  const int* idx_f;      // [iters,8]
  int iters;
  double* models;        // [2*iters,9]
  double* scores;        // [2*iters]
};

__device__ void solve_h(const HypParams& p, int b, double* h) {
  double A[8][9];
  for (int i = 0; i < 4; ++i) {
    const int j = p.idx_h[4 * b + i];
    const double x = p.uv1[2 * j], y = p.uv1[2 * j + 1];
    const double u = p.uv2[2 * j], v = p.uv2[2 * j + 1];
    const double r1[9] = {-x, -y, -1.0, 0.0, 0.0, 0.0, u * x, u * y, u};
    const double r2[9] = {0.0, 0.0, 0.0, -x, -y, -1.0, v * x, v * y, v};
    for (int k = 0; k < 9; ++k) {
      A[2 * i][k] = r1[k];
      A[2 * i + 1][k] = r2[k];
    }
  }
  min_right_singular<8, 9>(A, h);
}

__device__ void solve_f(const HypParams& p, int b, double* f) {
  double x1[8][2], x2[8][2];
  for (int i = 0; i < 8; ++i) {
    const int j = p.idx_f[8 * b + i];
    x1[i][0] = p.uv1[2 * j];
    x1[i][1] = p.uv1[2 * j + 1];
    x2[i][0] = p.uv2[2 * j];
    x2[i][1] = p.uv2[2 * j + 1];
  }
  const double wn = 1.0 / 8.0;
  double mu[2][2] = {{0.0, 0.0}, {0.0, 0.0}}, s[2];
  for (int v = 0; v < 2; ++v) {                 // Hartley, unit weights
    double (*x)[2] = v == 0 ? x1 : x2;
    for (int i = 0; i < 8; ++i) {
      mu[v][0] += x[i][0] * wn;
      mu[v][1] += x[i][1] * wn;
    }
    double d = 0.0;
    for (int i = 0; i < 8; ++i) {
      const double dx = x[i][0] - mu[v][0], dy = x[i][1] - mu[v][1];
      d += sqrt(dx * dx + dy * dy) * wn;
    }
    s[v] = sqrt(2.0) / fmax(d, 1e-9);
  }
  double A[8][9];
  for (int i = 0; i < 8; ++i) {
    const double u1 = (x1[i][0] - mu[0][0]) * s[0];
    const double v1 = (x1[i][1] - mu[0][1]) * s[0];
    const double u2 = (x2[i][0] - mu[1][0]) * s[1];
    const double v2 = (x2[i][1] - mu[1][1]) * s[1];
    const double r[9] = {u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                         1.0};
    for (int k = 0; k < 9; ++k) A[i][k] = r[k];
  }
  min_right_singular<8, 9>(A, f);
  rank2(f);
  denormalize(f, s[0], mu[0][0], mu[0][1], s[1], mu[1][0], mu[1][1]);
}

__global__ void __launch_bounds__(kHypThreads) hypotheses_kernel(
    HypParams p) {
  __shared__ double model[9], inv[9], red[32];
  const int b = blockIdx.x;
  const bool is_h = b < p.iters;
  if (threadIdx.x == 0) {
    if (is_h) {
      solve_h(p, b, model);
      inverse3(model, inv);
    } else {
      solve_f(p, b - p.iters, model);
    }
  }
  __syncthreads();
  double acc = 0.0;
  for (int i = threadIdx.x; i < p.n; i += blockDim.x) {
    const double u1 = p.uv1[2 * i], v1 = p.uv1[2 * i + 1];
    const double u2 = p.uv2[2 * i], v2 = p.uv2[2 * i + 1];
    bool ok;
    acc += is_h ? score_h(model, inv, u1, v1, u2, v2, p.valid[i] != 0, &ok)
                : score_f(model, u1, v1, u2, v2, p.valid[i] != 0, &ok);
  }
  const double total = block_sum(acc, red);
  if (threadIdx.x == 0) {
    p.scores[b] = total;
    for (int k = 0; k < 9; ++k) p.models[9 * b + k] = model[k];
  }
}

// ---------------------------------------------------------------------------
// twoview_recover
// ---------------------------------------------------------------------------

struct RecParams {
  const float* uv1;
  const float* uv2;
  const uint8_t* valid;
  int n;
  const double* models;  // [2*iters,9]
  const double* scores;  // [2*iters]
  int iters;
  float fx, fy, cx, cy;
  uint8_t* masks;        // [2,n] scratch: F inliers, H inliers
  float* Rt;             // [12] R (row-major) then t
  float* X;              // [n,3]
  uint8_t* good;         // [n]
  int* info;             // success, used_h, b_h, b_f, n_best, second,
                         // best, n_inliers, counts[8]
};

// _check_rt for one match: triangulate with P1 = [I|0], P2 = [R|t] and
// apply the depth, parallax and reprojection gates.
__device__ bool check_point(const double* R, const double* t, double a0,
                            double a1, double b0, double b1, bool inl,
                            double* X) {
  const double P2[3][4] = {{R[0], R[1], R[2], t[0]}, {R[3], R[4], R[5], t[1]},
                           {R[6], R[7], R[8], t[2]}};
  double A[4][4] = {{-1.0, 0.0, a0, 0.0}, {0.0, -1.0, a1, 0.0}, {}, {}};
  for (int c = 0; c < 4; ++c) {
    A[2][c] = b0 * P2[2][c] - P2[0][c];
    A[3][c] = b1 * P2[2][c] - P2[1][c];
  }
  double S[4][4];
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) {
      double s = 0.0;
      for (int k = 0; k < 4; ++k) s += A[k][r] * A[k][c];
      S[r][c] = s;
    }
  double v[4];
  jacobi_null4(S, v);
  double w = v[3];
  if (fabs(w) < 1e-12) w = 1e-12;
  for (int k = 0; k < 3; ++k) X[k] = v[k] / w;
  double X2[3];
  for (int r = 0; r < 3; ++r)
    X2[r] = R[3 * r] * X[0] + R[3 * r + 1] * X[1] + R[3 * r + 2] * X[2]
        + t[r];
  const double z1 = X[2], z2 = X2[2];
  const double nx = fmax(sqrt(X[0] * X[0] + X[1] * X[1] + X[2] * X[2]),
                         1e-12);
  double d2[3];
  for (int c = 0; c < 3; ++c)             // X - C2, C2 = -R^T t
    d2[c] = X[c] + (R[c] * t[0] + R[3 + c] * t[1] + R[6 + c] * t[2]);
  const double nd = fmax(sqrt(d2[0] * d2[0] + d2[1] * d2[1]
                              + d2[2] * d2[2]), 1e-12);
  const double cosp = (X[0] / nx) * (d2[0] / nd) + (X[1] / nx) * (d2[1] / nd)
      + (X[2] / nx) * (d2[2] / nd);
  const bool finite = isfinite(X[0]) && isfinite(X[1]) && isfinite(X[2]);
  const double zc1 = fmax(z1, 1e-9), zc2 = fmax(z2, 1e-9);
  const double e1 = (X[0] / zc1 - a0) * (X[0] / zc1 - a0)
      + (X[1] / zc1 - a1) * (X[1] / zc1 - a1);
  const double e2 = (X2[0] / zc2 - b0) * (X2[0] / zc2 - b0)
      + (X2[1] / zc2 - b1) * (X2[1] / zc2 - b1);
  return inl && finite && z1 > 0.0 && z2 > 0.0 && cosp < 0.99998
      && e1 < 1e-4 && e2 < 1e-4;
}

// C = A B for 3x3 row-major matrices.
__device__ void mm3(const double A[3][3], const double B[3][3],
                    double C[3][3]) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      C[r][c] = A[r][0] * B[0][c] + A[r][1] * B[1][c] + A[r][2] * B[2][c];
}

// R = s U Rp V^T into a row-major [9].
__device__ void compose(double s, const double U[3][3], const double Rp[3][3],
                        const double V[3][3], double* R) {
  double M[3][3];
  mm3(U, Rp, M);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      R[3 * r + c] = s * (M[r][0] * V[c][0] + M[r][1] * V[c][1]
                          + M[r][2] * V[c][2]);
}

// The 4 motion hypotheses of E (R1 = U W V^T, R2 = U W^T V^T, +-u3) with
// U and V proper rotations; returns their count.
__device__ int candidates_e(const double E[3][3], double cand[8][12]) {
  double U[3][3], S[3], V[3][3];
  svd3(E, U, S, V);
  double V3[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) V3[r][c] = V[r][c];
  if (det3(V3) < 0.0)
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) V[r][c] = -V[r][c];
  const double W[3][3] = {{0.0, -1.0, 0.0}, {1.0, 0.0, 0.0}, {0.0, 0.0, 1.0}};
  const double Wt[3][3] = {{0.0, 1.0, 0.0}, {-1.0, 0.0, 0.0},
                           {0.0, 0.0, 1.0}};
  for (int k = 0; k < 4; ++k) {
    compose(1.0, U, k < 2 ? W : Wt, V, cand[k]);
    const double sg = (k & 1) ? -1.0 : 1.0;
    for (int r = 0; r < 3; ++r) cand[k][9 + r] = sg * U[r][2];
  }
  return 4;
}

// Faugeras' 8 motion hypotheses of a calibrated homography.
__device__ int candidates_h(const double Hn[3][3], double cand[8][12]) {
  double U[3][3], S[3], V[3][3];
  svd3(Hn, U, S, V);
  const double s = det3(U) * det3(V);
  const double d1 = S[0], d2 = S[1], d3 = S[2];
  const double den = fmax(d1 * d1 - d3 * d3, 1e-12);
  const double aux1 = sqrt(fmax((d1 * d1 - d2 * d2) / den, 0.0));
  const double aux3 = sqrt(fmax((d2 * d2 - d3 * d3) / den, 0.0));
  const double x1s[4] = {aux1, aux1, -aux1, -aux1};
  const double x3s[4] = {aux3, -aux3, aux3, -aux3};
  const double root = sqrt(fmax((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                0.0));
  const double sin_t = root / fmax((d1 + d3) * d2, 1e-12);
  const double cos_t = (d2 * d2 + d1 * d3) / fmax((d1 + d3) * d2, 1e-12);
  const double sin_p = root / fmax((d1 - d3) * d2, 1e-12);
  const double cos_p = (d1 * d3 - d2 * d2) / fmax((d1 - d3) * d2, 1e-12);
  for (int k = 0; k < 8; ++k) {
    const int i = k & 3;
    const double sx1 = x1s[i] > 0.0 ? 1.0 : (x1s[i] < 0.0 ? -1.0 : 0.0);
    const double sx3 = x3s[i] > 0.0 ? 1.0 : (x3s[i] < 0.0 ? -1.0 : 0.0);
    const double eps13 = sx1 * sx3;
    double tp[3];
    if (k < 4) {                                  // d' > 0
      const double st = eps13 * sin_t;
      const double Rp[3][3] = {{cos_t, 0.0, -st}, {0.0, 1.0, 0.0},
                               {st, 0.0, cos_t}};
      compose(s, U, Rp, V, cand[k]);
      tp[0] = (d1 - d3) * x1s[i];
      tp[1] = 0.0;
      tp[2] = (d1 - d3) * -x3s[i];
    } else {                                      // d' < 0
      const double sp = eps13 * sin_p;
      const double Rp[3][3] = {{cos_p, 0.0, sp}, {0.0, -1.0, 0.0},
                               {sp, 0.0, -cos_p}};
      compose(s, U, Rp, V, cand[k]);
      tp[0] = (d1 + d3) * x1s[i];
      tp[1] = 0.0;
      tp[2] = (d1 + d3) * x3s[i];
    }
    double t[3], nt = 0.0;
    for (int r = 0; r < 3; ++r) {
      t[r] = U[r][0] * tp[0] + U[r][1] * tp[1] + U[r][2] * tp[2];
      nt += t[r] * t[r];
    }
    nt = fmax(sqrt(nt), 1e-12);
    for (int r = 0; r < 3; ++r) cand[k][9 + r] = t[r] / nt;
  }
  return 8;
}

__global__ void __launch_bounds__(kRecThreads) recover_kernel(RecParams p) {
  __shared__ double sH[9], sHi[9], sF[9], red[32], ata[45];
  __shared__ double cand[8][12];
  __shared__ int counts[8], s_nc;
  __shared__ bool s_use_h;
  __shared__ int ired[32];
  const int tid = threadIdx.x, n = p.n;
  uint8_t* mF = p.masks;
  uint8_t* mH = p.masks + n;

  // 1. the first maximum of each score row
  if (tid == 0) {
    int bh = 0, bf = 0;
    for (int i = 1; i < p.iters; ++i) {
      if (p.scores[i] > p.scores[bh]) bh = i;
      if (p.scores[p.iters + i] > p.scores[p.iters + bf]) bf = i;
    }
    for (int k = 0; k < 9; ++k) {
      sH[k] = p.models[9 * bh + k];
      sF[k] = p.models[9 * (p.iters + bf) + k];
    }
    inverse3(sH, sHi);
    p.info[2] = bh;
    p.info[3] = bf;
  }
  __syncthreads();
  // 2. their inlier masks, the refits' weights
  for (int i = tid; i < n; i += blockDim.x) {
    const double u1 = p.uv1[2 * i], v1 = p.uv1[2 * i + 1];
    const double u2 = p.uv2[2 * i], v2 = p.uv2[2 * i + 1];
    const bool val = p.valid[i] != 0;
    bool okf, okh;
    score_f(sF, u1, v1, u2, v2, val, &okf);
    score_h(sH, sHi, u1, v1, u2, v2, val, &okh);
    mF[i] = okf;
    mH[i] = okh;
  }
  __syncthreads();

  // 3. F refit: weighted Hartley normalization, then A^T A of the rows
  double wsum = 0.0;
  for (int i = tid; i < n; i += blockDim.x) wsum += mF[i];
  wsum = fmax(block_sum(wsum, red), 1e-9);
  double mu[4] = {0.0, 0.0, 0.0, 0.0};
  for (int i = tid; i < n; i += blockDim.x) {
    const double wn = mF[i] / wsum;
    mu[0] += p.uv1[2 * i] * wn;
    mu[1] += p.uv1[2 * i + 1] * wn;
    mu[2] += p.uv2[2 * i] * wn;
    mu[3] += p.uv2[2 * i + 1] * wn;
  }
  for (int k = 0; k < 4; ++k) mu[k] = block_sum(mu[k], red);
  double dd[2] = {0.0, 0.0};
  for (int i = tid; i < n; i += blockDim.x) {
    const double wn = mF[i] / wsum;
    for (int v = 0; v < 2; ++v) {
      const float* uv = v == 0 ? p.uv1 : p.uv2;
      const double dx = uv[2 * i] - mu[2 * v], dy = uv[2 * i + 1] - mu[2 * v + 1];
      dd[v] += sqrt(dx * dx + dy * dy) * wn;
    }
  }
  double sc[2];
  for (int v = 0; v < 2; ++v)
    sc[v] = sqrt(2.0) / fmax(block_sum(dd[v], red), 1e-9);
  double acc[45];
  for (int k = 0; k < 45; ++k) acc[k] = 0.0;
  for (int i = tid; i < n; i += blockDim.x) {
    const double w = mF[i];
    const double u1 = (p.uv1[2 * i] - mu[0]) * sc[0];
    const double v1 = (p.uv1[2 * i + 1] - mu[1]) * sc[0];
    const double u2 = (p.uv2[2 * i] - mu[2]) * sc[1];
    const double v2 = (p.uv2[2 * i + 1] - mu[3]) * sc[1];
    const double r[9] = {u2 * u1 * w, u2 * v1 * w, u2 * w, v2 * u1 * w,
                         v2 * v1 * w, v2 * w, u1 * w, v1 * w, w};
    for (int a = 0, k = 0; a < 9; ++a)
      for (int b = a; b < 9; ++b, ++k) acc[k] += r[a] * r[b];
  }
  for (int k = 0; k < 45; ++k) {
    const double s = block_sum(acc[k], red);
    if (tid == 0) ata[k] = s;
  }
  __syncthreads();
  if (tid == 0) {
    double S[9][9], f[9];
    for (int a = 0, k = 0; a < 9; ++a)
      for (int b = a; b < 9; ++b, ++k) S[a][b] = S[b][a] = ata[k];
    jacobi_min_eigvec<9>(S, f);
    rank2(f);
    denormalize(f, sc[0], mu[0], mu[1], sc[1], mu[2], mu[3]);
    for (int k = 0; k < 9; ++k) sF[k] = f[k];
  }
  __syncthreads();

  // 4. H refit over the 2N weighted DLT rows
  for (int k = 0; k < 45; ++k) acc[k] = 0.0;
  for (int i = tid; i < n; i += blockDim.x) {
    const double w = mH[i];
    const double x = p.uv1[2 * i], y = p.uv1[2 * i + 1];
    const double u = p.uv2[2 * i], v = p.uv2[2 * i + 1];
    const double r1[9] = {-x * w, -y * w, -w, 0.0, 0.0, 0.0, u * x * w,
                          u * y * w, u * w};
    const double r2[9] = {0.0, 0.0, 0.0, -x * w, -y * w, -w, v * x * w,
                          v * y * w, v * w};
    for (int a = 0, k = 0; a < 9; ++a)
      for (int b = a; b < 9; ++b, ++k)
        acc[k] += r1[a] * r1[b] + r2[a] * r2[b];
  }
  for (int k = 0; k < 45; ++k) {
    const double s = block_sum(acc[k], red);
    if (tid == 0) ata[k] = s;
  }
  __syncthreads();
  if (tid == 0) {
    double S[9][9], h[9];
    for (int a = 0, k = 0; a < 9; ++a)
      for (int b = a; b < 9; ++b, ++k) S[a][b] = S[b][a] = ata[k];
    jacobi_min_eigvec<9>(S, h);
    for (int k = 0; k < 9; ++k) sH[k] = h[k];
    inverse3(sH, sHi);
  }
  __syncthreads();

  // 5. re-score both refits; the masks become the recoveries' inliers
  double sf = 0.0, sh = 0.0;
  for (int i = tid; i < n; i += blockDim.x) {
    const double u1 = p.uv1[2 * i], v1 = p.uv1[2 * i + 1];
    const double u2 = p.uv2[2 * i], v2 = p.uv2[2 * i + 1];
    const bool val = p.valid[i] != 0;
    bool okf, okh;
    sf += score_f(sF, u1, v1, u2, v2, val, &okf);
    sh += score_h(sH, sHi, u1, v1, u2, v2, val, &okh);
    mF[i] = okf;
    mH[i] = okh;
  }
  const double SF = block_sum(sf, red);
  const double SH = block_sum(sh, red);
  const bool use_h = SH / fmax(SH + SF, 1e-9) > 0.45;
  const uint8_t* inl = use_h ? mH : mF;
  int ninl = 0;
  for (int i = tid; i < n; i += blockDim.x) ninl += inl[i];
  ninl = block_sum(ninl, ired);

  // 6. the chosen model's motion hypotheses
  if (tid == 0) {
    const double fx = p.fx, fy = p.fy, cx = p.cx, cy = p.cy;
    const double Km[3][3] = {{fx, 0.0, cx}, {0.0, fy, cy}, {0.0, 0.0, 1.0}};
    double M[3][3], T[3][3];
    if (use_h) {                                  // Hn = K^-1 H K
      const double Ki[3][3] = {{1.0 / fx, 0.0, -cx / fx},
                               {0.0, 1.0 / fy, -cy / fy}, {0.0, 0.0, 1.0}};
      const double Hm[3][3] = {{sH[0], sH[1], sH[2]}, {sH[3], sH[4], sH[5]},
                               {sH[6], sH[7], sH[8]}};
      mm3(Ki, Hm, T);
      mm3(T, Km, M);
      s_nc = candidates_h(M, cand);
    } else {                                      // E = K^T F K
      const double Kt[3][3] = {{fx, 0.0, 0.0}, {0.0, fy, 0.0},
                               {cx, cy, 1.0}};
      const double Fm[3][3] = {{sF[0], sF[1], sF[2]}, {sF[3], sF[4], sF[5]},
                               {sF[6], sF[7], sF[8]}};
      mm3(Kt, Fm, T);
      mm3(T, Km, M);
      s_nc = candidates_e(M, cand);
    }
    s_use_h = use_h;
  }
  __syncthreads();
  const int nc = s_nc;
  for (int c = 0; c < nc; ++c) {
    int cnt = 0;
    for (int i = tid; i < n; i += blockDim.x) {
      const double a0 = (p.uv1[2 * i] - p.cx) / (double)p.fx;
      const double a1 = (p.uv1[2 * i + 1] - p.cy) / (double)p.fy;
      const double b0 = (p.uv2[2 * i] - p.cx) / (double)p.fx;
      const double b1 = (p.uv2[2 * i + 1] - p.cy) / (double)p.fy;
      double X[3];
      cnt += check_point(cand[c], cand[c] + 9, a0, a1, b0, b1, inl[i] != 0,
                         X);
    }
    cnt = block_sum(cnt, ired);
    if (tid == 0) counts[c] = cnt;
  }
  __syncthreads();
  // 7. the first of the largest counts, the second largest, the gates
  __shared__ int s_best;
  if (tid == 0) {
    int best = 0;
    for (int c = 1; c < nc; ++c)
      if (counts[c] > counts[best]) best = c;
    int second = -1;                              // sorted(counts)[-2]
    for (int c = 0; c < nc; ++c)
      if (c != best && counts[c] > second) second = counts[c];
    const int nb = counts[best];
    const double frac = s_use_h ? 0.75 : 0.7;
    const bool ok = nb > 0.75 * (double)max(ninl, 1)
        && second < frac * nb && nb >= 8;
    p.info[0] = ok;
    p.info[1] = s_use_h;
    p.info[4] = nb;
    p.info[5] = second;
    p.info[6] = best;
    p.info[7] = ninl;
    for (int c = 0; c < 8; ++c) p.info[8 + c] = c < nc ? counts[c] : -1;
    for (int k = 0; k < 12; ++k) p.Rt[k] = (float)cand[best][k];
    s_best = best;
  }
  __syncthreads();
  // 8. the winner's points and mask
  const double* R = cand[s_best];
  for (int i = tid; i < n; i += blockDim.x) {
    const double a0 = (p.uv1[2 * i] - p.cx) / (double)p.fx;
    const double a1 = (p.uv1[2 * i + 1] - p.cy) / (double)p.fy;
    const double b0 = (p.uv2[2 * i] - p.cx) / (double)p.fx;
    const double b1 = (p.uv2[2 * i + 1] - p.cy) / (double)p.fy;
    double X[3];
    p.good[i] = check_point(R, R + 9, a0, a1, b0, b1, inl[i] != 0, X);
    for (int k = 0; k < 3; ++k) p.X[3 * i + k] = (float)X[k];
  }
}

}  // namespace

PLVIO_API int twoview_hypotheses(const void* uv1, const void* uv2,
                                 const void* valid, int n, const void* idx_h,
                                 const void* idx_f, int iters, void* models,
                                 void* scores, void* stream) {
  HypParams p{static_cast<const float*>(uv1), static_cast<const float*>(uv2),
              static_cast<const uint8_t*>(valid), n,
              static_cast<const int*>(idx_h), static_cast<const int*>(idx_f),
              iters, static_cast<double*>(models),
              static_cast<double*>(scores)};
  if (iters > 0)
    hypotheses_kernel<<<2 * iters, kHypThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

PLVIO_API int twoview_recover(const void* uv1, const void* uv2,
                              const void* valid, int n, const void* models,
                              const void* scores, int iters, float fx,
                              float fy, float cx, float cy, void* masks,
                              void* Rt, void* X, void* good, void* info,
                              void* stream) {
  RecParams p{static_cast<const float*>(uv1), static_cast<const float*>(uv2),
              static_cast<const uint8_t*>(valid), n,
              static_cast<const double*>(models),
              static_cast<const double*>(scores), iters, fx, fy, cx, cy,
              static_cast<uint8_t*>(masks), static_cast<float*>(Rt),
              static_cast<float*>(X), static_cast<uint8_t*>(good),
              static_cast<int*>(info)};
  recover_kernel<<<1, kRecThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
