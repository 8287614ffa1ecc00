// pnp — relocalization's pose from 2D-3D matches: the RANSAC over six-point
// DLT hypotheses with its refits (pnp_ransac: pnp_hypotheses, then
// pnp_refine) and the maximum-likelihood refinement on bearing vectors
// (mlpnp_refine).
//
// Replaces plvio_tpu/ops/pnp.py `pnp_ransac` (:49, with `_dlt_pose` :22)
// and `mlpnp_refine` (:217), which Tracker._relocalize runs on each
// candidate keyframe's matches (models/tracking.py:1304, 1312).  The JAX
// version vmaps a float32 SVD of each hypothesis' 12x12 DLT matrix and
// scores all hypotheses against all matches as one dense residual
// matrix; the refits are SVDs of the full [2N,12] weighted system; the
// refinement is a lax.scan of 8 Gauss-Newton steps with a jacfwd
// Jacobian and a 6x6 solve.
//
// What bounds them on the H100: launch latency and the serial solves.
// 128 hypotheses x 512 matches is 65 536 reprojections (~2 Mflop); the
// 12x12 eigenproblems are cyclic Jacobi sweeps of up to 66 rotations
// each, and pnp_ransac adds the rotations it applied to ints[2].
//
// The DLT solves on raw world coordinates and is ill-conditioned, so
// every solve here is float64: the 12x12 normal matrix A^T A of the
// (weighted) DLT rows, its eigenvector of the least eigenvalue by Jacobi
// (linalg.cuh; the right singular vector of A's least singular value),
// the sign that makes det(M) > 0, and M's polar factor U V^T from the 3x3
// SVD.  Matches are read as float32 and widened.
//
// pnp_hypotheses: one block per hypothesis; thread 0 solves the six-point
// DLT, then the block scores all N matches under the loose gate (4 chi2)
// and sums the count in a fixed order.
// pnp_refine: one block.  The first hypothesis of the most loose inliers;
// the weighted refit on its loose inliers; two Huber-weighted refits,
// each kept when it scores no fewer strict inliers; the strict re-score
// and the fallback to the raw hypothesis.  Each normal matrix is summed
// per thread over its matches, then across the block in a fixed order.
// mlpnp_refine: one block; per step each thread sums its matches' 6x6
// normal equations of the two tangent-plane residuals (Huber-weighted),
// a fixed-order block sum, a float64 Cholesky solve and the update
// R <- exp(w) R, t <- t + dt on thread 0; then the strict re-score.
#include "common.cuh"
#include "linalg.cuh"

namespace {

constexpr int kHypThreads = 128;
constexpr int kThreads = 256;
constexpr int kTri = 78;            // the 12x12 normal matrix's upper triangle

struct Cam {
  double fx, fy, cx, cy, th;
};

__device__ inline int tri(int i, int j) {   // i <= j
  return i * 12 - i * (i - 1) / 2 + (j - i);
}

// The weighted DLT rows of match i, r1 = w [X 1, 0, -x (X 1)] and
// r2 = w [0, X 1, -y (X 1)], added to the upper triangle acc.
__device__ void add_rows(double acc[kTri], double xn, double yn,
                         const double Xw[3], double w) {
  const double Xh[4] = {Xw[0], Xw[1], Xw[2], 1.0};
  double r1[12], r2[12];
  for (int k = 0; k < 4; ++k) {
    r1[k] = w * Xh[k];
    r1[4 + k] = 0.0;
    r1[8 + k] = w * (-xn * Xh[k]);
    r2[k] = 0.0;
    r2[4 + k] = w * Xh[k];
    r2[8 + k] = w * (-yn * Xh[k]);
  }
  for (int i = 0; i < 12; ++i)
    for (int j = i; j < 12; ++j)
      acc[tri(i, j)] += r1[i] * r1[j] + r2[i] * r2[j];
}

// (R, t) of the DLT solution whose normal matrix is acc; returns the
// Jacobi rotations its eigenvector took.
__device__ int pose_from_normal(const double acc[kTri], double R[9],
                                double t[3]) {
  double S[12][12], P[12];
  for (int i = 0; i < 12; ++i)
    for (int j = i; j < 12; ++j) S[i][j] = S[j][i] = acc[tri(i, j)];
  const int rotations = jacobi_min_eigvec<12>(S, P);
  double M[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) M[r][c] = P[4 * r + c];
  const double sg = det3(M) < 0.0 ? -1.0 : 1.0;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) M[r][c] *= sg;
  double U[3][3], Sv[3], V[3][3];
  svd3(M, U, Sv, V);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      R[3 * r + c] = U[r][0] * V[c][0] + U[r][1] * V[c][1]
          + U[r][2] * V[c][2];
  const double scale = fmax((Sv[0] + Sv[1] + Sv[2]) / 3.0, 1e-9);
  for (int r = 0; r < 3; ++r) t[r] = sg * P[4 * r + 3] / scale;
  return rotations;
}

// chi2 (px^2) and depth of match i under (R, t).
__device__ inline void reproject(const Cam& c, const float* uv,
                                 const float* X, int i, const double R[9],
                                 const double t[3], double* chi2,
                                 double* depth) {
  const double x = X[3 * i], y = X[3 * i + 1], z = X[3 * i + 2];
  const double p0 = R[0] * x + R[1] * y + R[2] * z + t[0];
  const double p1 = R[3] * x + R[4] * y + R[5] * z + t[1];
  const double p2 = R[6] * x + R[7] * y + R[8] * z + t[2];
  const double zz = fmax(p2, 1e-6);
  const double du = c.fx * p0 / zz + c.cx - uv[2 * i];
  const double dv = c.fy * p1 / zz + c.cy - uv[2 * i + 1];
  *chi2 = du * du + dv * dv;
  *depth = p2;
}

// Sum of v over the block, in a fixed order (warp trees, then the warps
// in order); red holds 33 doubles.
__device__ double block_sum(double v, double* red) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double tot = 0.0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) tot += red[w];
    red[32] = tot;
  }
  __syncthreads();
  const double tot = red[32];
  __syncthreads();
  return tot;
}

__global__ void pnp_hypotheses_kernel(const float* __restrict__ uv,
                                      const float* __restrict__ X,
                                      const bool* __restrict__ valid, int n,
                                      const int* __restrict__ samples, Cam c,
                                      double* __restrict__ hyp,
                                      int* __restrict__ counts,
                                      int* __restrict__ rotations) {
  __shared__ double pose[12];
  __shared__ double red[33];
  const int h = blockIdx.x;
  if (threadIdx.x == 0) {
    double acc[kTri];
    for (int e = 0; e < kTri; ++e) acc[e] = 0.0;
    for (int k = 0; k < 6; ++k) {
      const int i = samples[6 * h + k];
      const double Xw[3] = {X[3 * i], X[3 * i + 1], X[3 * i + 2]};
      add_rows(acc, (uv[2 * i] - c.cx) / c.fx, (uv[2 * i + 1] - c.cy) / c.fy,
               Xw, 1.0);
    }
    atomicAdd(rotations, pose_from_normal(acc, pose, pose + 9));
    for (int e = 0; e < 12; ++e) hyp[12 * h + e] = pose[e];
  }
  __syncthreads();
  double cnt = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    double chi2, depth;
    reproject(c, uv, X, i, pose, pose + 9, &chi2, &depth);
    cnt += (valid[i] && chi2 < 4.0 * c.th && depth > 0.05) ? 1.0 : 0.0;
  }
  cnt = block_sum(cnt, red);
  if (threadIdx.x == 0) counts[h] = (int)cnt;
}

// The weighted DLT refit on the weights w [n] (global), into pose; its
// Jacobi rotations are added to *rotations (thread 0's).
__device__ void weighted_fit(const Cam& c, const float* uv, const float* X,
                             int n, const double* w, double* pose,
                             double* red, double* sacc, int* rotations) {
  double acc[kTri];
  for (int e = 0; e < kTri; ++e) acc[e] = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const double Xw[3] = {X[3 * i], X[3 * i + 1], X[3 * i + 2]};
    add_rows(acc, (uv[2 * i] - c.cx) / c.fx, (uv[2 * i + 1] - c.cy) / c.fy,
             Xw, w[i]);
  }
  for (int e = 0; e < kTri; ++e) {
    const double s = block_sum(acc[e], red);
    if (threadIdx.x == 0) sacc[e] = s;
  }
  if (threadIdx.x == 0) *rotations += pose_from_normal(sacc, pose, pose + 9);
  __syncthreads();
}

// Strict inliers under pose: the block's count (and the mask when out).
__device__ int strict_count(const Cam& c, const float* uv, const float* X,
                            const bool* valid, int n, const double* pose,
                            double* red, bool* out) {
  double cnt = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    double chi2, depth;
    reproject(c, uv, X, i, pose, pose + 9, &chi2, &depth);
    const bool in = valid[i] && chi2 < c.th && depth > 0.05;
    if (out) out[i] = in;
    cnt += in ? 1.0 : 0.0;
  }
  return (int)block_sum(cnt, red);
}

__global__ void pnp_refine_kernel(const float* __restrict__ uv,
                                  const float* __restrict__ X,
                                  const bool* __restrict__ valid, int n,
                                  int iters, Cam c,
                                  const double* __restrict__ hyp,
                                  const int* __restrict__ counts,
                                  double* __restrict__ w, float* R_out,
                                  float* t_out, bool* inl_out, int* ints) {
  __shared__ double raw[12], ref[12], cand[12];
  __shared__ double red[33], sacc[kTri];
  __shared__ int best;
  int rotations = 0;                      // thread 0's refits
  if (threadIdx.x == 0) {
    int b = 0;
    for (int h = 1; h < iters; ++h)
      if (counts[h] > counts[b]) b = h;
    best = b;
  }
  __syncthreads();
  if (threadIdx.x < 12) raw[threadIdx.x] = hyp[12 * best + threadIdx.x];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    double chi2, depth;
    reproject(c, uv, X, i, raw, raw + 9, &chi2, &depth);
    w[i] = (valid[i] && chi2 < 4.0 * c.th && depth > 0.05) ? 1.0 : 0.0;
  }
  __syncthreads();
  weighted_fit(c, uv, X, n, w, ref, red, sacc, &rotations);
  for (int round = 0; round < 2; ++round) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      double chi2, depth;
      reproject(c, uv, X, i, ref, ref + 9, &chi2, &depth);
      const double wh = fmin(1.0, sqrt(c.th / fmax(chi2, 1e-9)));
      w[i] = (valid[i] ? 1.0 : 0.0) * (depth > 0.05 ? 1.0 : 0.0) * wh
          * (chi2 < 4.0 * c.th ? 1.0 : 0.0);
    }
    __syncthreads();
    weighted_fit(c, uv, X, n, w, cand, red, sacc, &rotations);
    const int n_i = strict_count(c, uv, X, valid, n, cand, red, nullptr);
    const int n_cur = strict_count(c, uv, X, valid, n, ref, red, nullptr);
    if (n_i >= n_cur && threadIdx.x < 12) ref[threadIdx.x] = cand[threadIdx.x];
    __syncthreads();
  }
  const int n_ref = strict_count(c, uv, X, valid, n, ref, red, nullptr);
  const int n_raw = strict_count(c, uv, X, valid, n, raw, red, nullptr);
  const double* out = n_ref >= n_raw ? ref : raw;
  strict_count(c, uv, X, valid, n, out, red, inl_out);
  if (threadIdx.x < 9) R_out[threadIdx.x] = (float)out[threadIdx.x];
  if (threadIdx.x < 3) t_out[threadIdx.x] = (float)out[9 + threadIdx.x];
  if (threadIdx.x == 0) {
    ints[0] = n_ref > n_raw ? n_ref : n_raw;
    ints[1] = best;
    ints[2] += rotations;                 // after the hypotheses' sum
  }
}

__device__ void so3_exp(const double w[3], double R[9]) {
  const double th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  double A, B;
  if (th2 < 1e-6) {
    A = 1.0 - th2 / 6.0;
    B = 0.5 - th2 / 24.0;
  } else {
    const double th = sqrt(th2);
    A = sin(th) / th;
    B = (1.0 - cos(th)) / th2;
  }
  const double W[9] = {0.0, -w[2], w[1], w[2], 0.0, -w[0], -w[1], w[0], 0.0};
  for (int r = 0; r < 3; ++r)
    for (int cc = 0; cc < 3; ++cc) {
      double w2 = 0.0;
      for (int k = 0; k < 3; ++k) w2 += W[3 * r + k] * W[3 * k + cc];
      R[3 * r + cc] = (r == cc ? 1.0 : 0.0) + A * W[3 * r + cc] + B * w2;
    }
}

__device__ inline void cross3(const double a[3], const double b[3],
                              double o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__global__ void mlpnp_refine_kernel(const float* __restrict__ uv,
                                    const float* __restrict__ X,
                                    const bool* __restrict__ inl_in, int n,
                                    const float* R0, const float* t0,
                                    int iters, Cam c, float* R_out,
                                    float* t_out, bool* inl_out, int* cnt) {
  __shared__ double pose[12];
  __shared__ double red[33], sys[27];
  if (threadIdx.x < 9) pose[threadIdx.x] = R0[threadIdx.x];
  if (threadIdx.x < 3) pose[9 + threadIdx.x] = t0[threadIdx.x];
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    double acc[27];                       // H upper triangle (21), g (6)
    for (int e = 0; e < 27; ++e) acc[e] = 0.0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      if (!inl_in[i]) continue;
      double v[3] = {(uv[2 * i] - c.cx) / c.fx, (uv[2 * i + 1] - c.cy) / c.fy,
                     1.0};
      const double vn = sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
      for (int k = 0; k < 3; ++k) v[k] /= vn;
      const double e[3] = {fabs(v[2]) < 0.9 ? 0.0 : 1.0, 0.0,
                           fabs(v[2]) < 0.9 ? 1.0 : 0.0};
      double r[3], s[3];
      cross3(v, e, r);
      const double rn = fmax(sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2]),
                             1e-9);
      for (int k = 0; k < 3; ++k) r[k] /= rn;
      cross3(v, r, s);
      const double x = X[3 * i], y = X[3 * i + 1], z = X[3 * i + 2];
      double RX[3], pc[3];
      for (int k = 0; k < 3; ++k) {
        RX[k] = pose[3 * k] * x + pose[3 * k + 1] * y + pose[3 * k + 2] * z;
        pc[k] = RX[k] + pose[9 + k];
      }
      const double nrm = fmax(sqrt(pc[0] * pc[0] + pc[1] * pc[1]
                                   + pc[2] * pc[2]), 1e-9);
      double mu[3];
      for (int k = 0; k < 3; ++k) mu[k] = pc[k] / nrm;
      const double res[2] = {r[0] * mu[0] + r[1] * mu[1] + r[2] * mu[2],
                             s[0] * mu[0] + s[1] * mu[1] + s[2] * mu[2]};
      // a = (I - mu mu^T) r / |pc|, and the same for s
      const double rm = res[0], sm = res[1];
      double a[3], b[3];
      for (int k = 0; k < 3; ++k) {
        a[k] = (r[k] - mu[k] * rm) / nrm;
        b[k] = (s[k] - mu[k] * sm) / nrm;
      }
      double J[2][6];
      cross3(RX, a, J[0]);                // d/d omega = RX x a
      cross3(RX, b, J[1]);
      for (int k = 0; k < 3; ++k) {
        J[0][3 + k] = a[k];
        J[1][3 + k] = b[k];
      }
      const double rn2 = (res[0] * res[0] + res[1] * res[1]) * (c.fx * c.fx);
      const double hub = rn2 > c.th ? sqrt(c.th / fmax(rn2, 1e-12)) : 1.0;
      int q = 0;
      for (int p = 0; p < 6; ++p)
        for (int o = p; o < 6; ++o, ++q)
          acc[q] += hub * J[0][p] * (hub * J[0][o])
              + hub * J[1][p] * (hub * J[1][o]);
      for (int p = 0; p < 6; ++p)
        acc[21 + p] += hub * J[0][p] * (hub * res[0])
            + hub * J[1][p] * (hub * res[1]);
    }
    for (int e = 0; e < 27; ++e) {
      const double sum = block_sum(acc[e], red);
      if (threadIdx.x == 0) sys[e] = sum;
    }
    if (threadIdx.x == 0) {
      double H[6][6], L[6][6], g[6], y[6], xi[6];
      int q = 0;
      for (int p = 0; p < 6; ++p)
        for (int o = p; o < 6; ++o, ++q) H[p][o] = H[o][p] = sys[q];
      for (int p = 0; p < 6; ++p) {
        H[p][p] += 1e-8;
        g[p] = sys[21 + p];
      }
      for (int j = 0; j < 6; ++j) {       // H = L L^T
        double d = H[j][j];
        for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
        L[j][j] = sqrt(fmax(d, 1e-300));
        for (int i = j + 1; i < 6; ++i) {
          double v = H[i][j];
          for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
          L[i][j] = v / L[j][j];
        }
      }
      for (int i = 0; i < 6; ++i) {
        double v = -g[i];
        for (int k = 0; k < i; ++k) v -= L[i][k] * y[k];
        y[i] = v / L[i][i];
      }
      for (int i = 5; i >= 0; --i) {
        double v = y[i];
        for (int k = i + 1; k < 6; ++k) v -= L[k][i] * xi[k];
        xi[i] = v / L[i][i];
      }
      double dR[9], Rn[9];
      so3_exp(xi, dR);
      for (int r = 0; r < 3; ++r)
        for (int cc = 0; cc < 3; ++cc)
          Rn[3 * r + cc] = dR[3 * r] * pose[cc] + dR[3 * r + 1] * pose[3 + cc]
              + dR[3 * r + 2] * pose[6 + cc];
      for (int e = 0; e < 9; ++e) pose[e] = Rn[e];
      for (int k = 0; k < 3; ++k) pose[9 + k] += xi[3 + k];
    }
    __syncthreads();
  }
  const int m = strict_count(c, uv, X, inl_in, n, pose, red, inl_out);
  if (threadIdx.x < 9) R_out[threadIdx.x] = (float)pose[threadIdx.x];
  if (threadIdx.x < 3) t_out[threadIdx.x] = (float)pose[9 + threadIdx.x];
  if (threadIdx.x == 0) *cnt = m;
}

}  // namespace

PLVIO_API int pnp_ransac(const void* uv, const void* X, const void* valid,
                         int n, const void* samples, int iters, double fx,
                         double fy, double cx, double cy, double th,
                         void* hyp, void* counts, void* work, void* R,
                         void* t, void* inl, void* ints, void* stream) {
  const Cam c{fx, fy, cx, cy, th};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pnp_hypotheses_kernel<<<iters, kHypThreads, 0, s>>>(
      static_cast<const float*>(uv), static_cast<const float*>(X),
      static_cast<const bool*>(valid), n, static_cast<const int*>(samples), c,
      static_cast<double*>(hyp), static_cast<int*>(counts),
      static_cast<int*>(ints) + 2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  pnp_refine_kernel<<<1, kThreads, 0, s>>>(
      static_cast<const float*>(uv), static_cast<const float*>(X),
      static_cast<const bool*>(valid), n, iters, c,
      static_cast<const double*>(hyp), static_cast<const int*>(counts),
      static_cast<double*>(work), static_cast<float*>(R),
      static_cast<float*>(t), static_cast<bool*>(inl),
      static_cast<int*>(ints));
  return cudaGetLastError();
}

PLVIO_API int mlpnp_refine(const void* uv, const void* X, const void* inl,
                           int n, const void* R0, const void* t0, int iters,
                           double fx, double fy, double cx, double cy,
                           double th, void* R, void* t, void* inl_out,
                           void* cnt, void* stream) {
  const Cam c{fx, fy, cx, cy, th};
  mlpnp_refine_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(uv), static_cast<const float*>(X),
      static_cast<const bool*>(inl), n, static_cast<const float*>(R0),
      static_cast<const float*>(t0), iters, c, static_cast<float*>(R),
      static_cast<float*>(t), static_cast<bool*>(inl_out),
      static_cast<int*>(cnt));
  return cudaGetLastError();
}
