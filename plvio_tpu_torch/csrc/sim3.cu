// sim3 — the loop closer's similarity estimation: the Sim3 RANSAC over
// three-point Horn hypotheses with its refit (sim3_ransac) and the 7-DoF
// Sim3 refinement on forward and backward reprojection edges
// (sim3_reproj).
//
// Replaces plvio_tpu/ops/pnp.py `sim3_horn` (:143) + `sim3_ransac` (:165),
// which LoopCloser._verify_sim3 runs on each loop or merge candidate's
// descriptor-matched map points (models/loop_closing.py:264), and
// plvio_tpu/models/kernels.py `make_sim3_reproj_optimizer` (:524), its
// final polish (loop_closing.py:369).  The JAX versions vmap 64 float32
// 3x3 SVDs and score every hypothesis against all N = 256 padded matches
// as one dense [64, N] residual; the refinement is 3 rounds of the dense
// LM engine (8 iterations each, jacfwd Jacobians, a 7x7 Cholesky) with a
// chi2 re-gate between rounds.
//
// What bounds them on the H100: launch latency and serial solves.  64 x
// 256 point transforms is ~1.5 Mflop; the refinement's 24 iterations each
// linearize 2 x 256 edges (~100 flop each) and solve one 7x7 system.
//
// sim3_ransac: one block of 256 threads.  scale_ref (the mean distance of
// the X2 rows from their mean, padding rows included, as the reference
// computes it) by fixed-order block sums; then each warp takes hypotheses
// h = warp, warp + 8, ...: lane 0 solves the three-point Horn alignment in
// float64 (the 3x3 SVD by one-sided Jacobi, linalg.cuh `svd3`, with the
// reference's sign(det U det Vt) fix), the lanes score the N rows (the
// relative gate th * scale_ref and 0.1 < s < 10) and sum the count.  Then
// the first hypothesis of the most inliers (argmax's rule), its inlier
// mask, and the refit on those rows (weighted means, cross-covariance and
// source variance by fixed-order block sums, one SVD).  Out: (R, t, s)
// float32, the mask, [n, best, counts...].
//
// sim3_reproj: one block of 256 threads, the LM of solver/engine.py
// `optimize` (lam0 1e-4, x0.5 on accept, x4 on reject, clipped to
// [1e-8, 1e4]) on the whitened, Huber-weighted (sqrt 9.21) edges in
// float64: each thread sums its edges' 7x7 normal equations with the
// analytic Jacobians of the two projections (forward: X2' = s R X1 + t
// into the candidate keyframe; backward: X1' = R^T (X2 - t) / s into the
// current one, both under the left perturbation S <- Exp(d) S; with
// fix_scale the sigma column is masked), the warps' sums meet in shared
// memory in a fixed order, thread 0 damps (diag * lam + 1e-6), factors
// and retracts (so3_normalize), every thread re-evaluates the cost, and
// the step is accepted on the device when it lowers it.  A failed factor
// gives NaN and the step is rejected, as the reference's cho_factor.
#include "common.cuh"
#include "linalg.cuh"
#include "sim3.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr double kChi2 = 9.21;

// Sum of v over the block in a fixed order (warp trees, then the warps in
// order); red holds 33 doubles.
__device__ double block_sum(double v, double* red) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double tot = 0.0;
    for (int w = 0; w < kWarps; ++w) tot += red[w];
    red[32] = tot;
  }
  __syncthreads();
  const double tot = red[32];
  __syncthreads();
  return tot;
}

// Horn's (s, R) from the cross-covariance and the source variance:
// R = U diag(1, 1, sign(det U det Vt)) Vt, s = tr(D S) / max(var1, 1e-12)
// (1 with fix_scale).
__device__ void horn(const double cov[3][3], double var1, bool fix_scale,
                     double R[9], double* s) {
  double U[3][3], D[3], V[3][3];
  svd3(cov, U, D, V);
  const double dd = det3(U) * det3(V);
  const double sg = dd > 0.0 ? 1.0 : (dd < 0.0 ? -1.0 : 0.0);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      R[3 * r + c] = U[r][0] * V[c][0] + U[r][1] * V[c][1]
          + sg * U[r][2] * V[c][2];
  *s = fix_scale ? 1.0 : (D[0] + D[1] + sg * D[2]) / fmax(var1, 1e-12);
}

// The three-point hypothesis h: (R, t, s) into hyp[13].
__device__ void hypothesis(const float* X1, const float* X2,
                           const int* smp, bool fix_scale, double hyp[13]) {
  double a[3][3], b[3][3], m1[3] = {0, 0, 0}, m2[3] = {0, 0, 0};
  for (int k = 0; k < 3; ++k)
    for (int c = 0; c < 3; ++c) {
      a[k][c] = X1[3 * smp[k] + c];
      b[k][c] = X2[3 * smp[k] + c];
      m1[c] += a[k][c];
      m2[c] += b[k][c];
    }
  for (int c = 0; c < 3; ++c) {
    m1[c] /= 3.0;
    m2[c] /= 3.0;
  }
  double cov[3][3] = {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}}, var1 = 0.0;
  for (int k = 0; k < 3; ++k) {
    double x1[3], x2[3];
    for (int c = 0; c < 3; ++c) {
      x1[c] = a[k][c] - m1[c];
      x2[c] = b[k][c] - m2[c];
    }
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) cov[r][c] += x2[r] * x1[c];
    var1 += x1[0] * x1[0] + x1[1] * x1[1] + x1[2] * x1[2];
  }
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) cov[r][c] /= 3.0;
  double s;
  horn(cov, var1 / 3.0, fix_scale, hyp, &s);
  double Rm[3];
  matvec3(hyp, m1, Rm);
  for (int c = 0; c < 3; ++c) hyp[9 + c] = m2[c] - s * Rm[c];
  hyp[12] = s;
}

__device__ inline bool inlier(const double* hyp, const float* X1,
                              const float* X2, int i, double gate) {
  const double x[3] = {X1[3 * i], X1[3 * i + 1], X1[3 * i + 2]};
  double p[3];
  matvec3(hyp, x, p);
  double d2 = 0.0;
  for (int c = 0; c < 3; ++c) {
    const double e = hyp[12] * p[c] + hyp[9 + c] - X2[3 * i + c];
    d2 += e * e;
  }
  return sqrt(d2) < gate && hyp[12] > 0.1 && hyp[12] < 10.0;
}

__global__ void __launch_bounds__(kThreads)
sim3_ransac_kernel(const float* __restrict__ X1, const float* __restrict__ X2,
                   const bool* __restrict__ valid, int n,
                   const int* __restrict__ samples, int iters, double th,
                   int fix_scale, float* __restrict__ out,
                   bool* __restrict__ inl_out, int* __restrict__ ints) {
  __shared__ double red[33];
  __shared__ double hyp[kWarps][13];
  __shared__ int counts[1024];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // scale_ref over all n rows
  double mu[3];
  for (int c = 0; c < 3; ++c) {
    double a = 0.0;
    for (int i = tid; i < n; i += kThreads) a += X2[3 * i + c];
    mu[c] = block_sum(a, red) / n;
  }
  double acc = 0.0;
  for (int i = tid; i < n; i += kThreads) {
    double d2 = 0.0;
    for (int c = 0; c < 3; ++c) {
      const double e = X2[3 * i + c] - mu[c];
      d2 += e * e;
    }
    acc += sqrt(fmax(d2, 1e-9));
  }
  const double gate = th * (block_sum(acc, red) / n);
  for (int h = warp; h < iters; h += kWarps) {
    if (lane == 0) hypothesis(X1, X2, samples + 3 * h, fix_scale, hyp[warp]);
    __syncwarp();
    int cnt = 0;
    for (int i = lane; i < n; i += 32)
      cnt += valid[i] && inlier(hyp[warp], X1, X2, i, gate);
    for (int s = 16; s > 0; s >>= 1)
      cnt += __shfl_down_sync(0xffffffffu, cnt, s);
    if (lane == 0) counts[h] = cnt;
    __syncwarp();
  }
  __syncthreads();
  if (tid == 0) {
    int b = 0;
    for (int h = 1; h < iters; ++h)
      if (counts[h] > counts[b]) b = h;
    ints[0] = counts[b];
    ints[1] = b;
    hypothesis(X1, X2, samples + 3 * b, fix_scale, hyp[0]);
  }
  for (int h = tid; h < iters; h += kThreads) ints[2 + h] = counts[h];
  __syncthreads();
  // the refit on the best hypothesis' inliers
  double w_acc = 0.0, s1[3] = {0, 0, 0}, s2[3] = {0, 0, 0};
  for (int i = tid; i < n; i += kThreads) {
    const bool in = valid[i] && inlier(hyp[0], X1, X2, i, gate);
    inl_out[i] = in;
    if (in) {
      w_acc += 1.0;
      for (int c = 0; c < 3; ++c) {
        s1[c] += X1[3 * i + c];
        s2[c] += X2[3 * i + c];
      }
    }
  }
  const double nw = fmax(block_sum(w_acc, red), 1.0);
  double m1[3], m2[3];
  for (int c = 0; c < 3; ++c) {
    m1[c] = block_sum(s1[c], red) / nw;
    m2[c] = block_sum(s2[c], red) / nw;
  }
  double pc[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = tid; i < n; i += kThreads) {
    if (!(valid[i] && inlier(hyp[0], X1, X2, i, gate))) continue;
    double x1[3], x2[3];
    for (int c = 0; c < 3; ++c) {
      x1[c] = X1[3 * i + c] - m1[c];
      x2[c] = X2[3 * i + c] - m2[c];
    }
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) pc[3 * r + c] += x2[r] * x1[c];
    pc[9] += x1[0] * x1[0] + x1[1] * x1[1] + x1[2] * x1[2];
  }
  double cov[3][3], var1;
  for (int e = 0; e < 9; ++e) cov[e / 3][e % 3] = block_sum(pc[e], red) / nw;
  var1 = block_sum(pc[9], red) / nw;
  if (tid == 0) {
    double R[9], s, Rm[3];
    horn(cov, var1, fix_scale != 0, R, &s);
    matvec3(R, m1, Rm);
    for (int e = 0; e < 9; ++e) out[e] = float(R[e]);
    for (int c = 0; c < 3; ++c) out[9 + c] = float(m2[c] - s * Rm[c]);
    out[12] = float(s);
  }
}

// ---------------------------------------------------------------------
// sim3_reproj

struct Reproj {
  const float* X1;     // [cap,3] current-side points
  const float* uv2;    // [cap,2] their observations in the candidate KF
  const bool* vf;
  const float* is2f;
  const float* X2;     // [cap,3] candidate-side points
  const float* uv1;    // [cap,2] their observations in the current KF
  const bool* vb;
  const float* is2b;
  const float* Pk;     // [12] T_cw of the current keyframe
  const float* Pc;     // [12] T_cw of the candidate keyframe
  double fx, fy, cx, cy;
  int cap;
  int fix_scale;
};

// Edge e (< cap forward, else backward) under S: whitened residual rw,
// whitened Jacobian Jw [2][7] (when J != nullptr), and its chi2.
__device__ double edge(const Reproj& p, const double S[13], int e,
                       double rw[2], double (*Jw)[7]) {
  const bool fwd = e < p.cap;
  const int i = fwd ? e : e - p.cap;
  const float* Xs = fwd ? p.X1 : p.X2;
  const float* uv = fwd ? p.uv2 : p.uv1;
  const float* P = fwd ? p.Pc : p.Pk;
  const double X[3] = {Xs[3 * i], Xs[3 * i + 1], Xs[3 * i + 2]};
  const double* R = S;
  const double* t = S + 9;
  const double s = S[12];
  double Y[3], dY[3][7];
  if (fwd) {
    double RX[3];
    matvec3(R, X, RX);
    for (int c = 0; c < 3; ++c) Y[c] = s * RX[c] + t[c];
    if (Jw) {
      // d(s R X + t) = drho - [Y]x dphi + Y dsigma
      for (int c = 0; c < 3; ++c)
        for (int k = 0; k < 7; ++k) dY[c][k] = 0.0;
      for (int c = 0; c < 3; ++c) {
        dY[c][c] = 1.0;
        dY[c][6] = Y[c];
      }
      dY[0][4] = Y[2]; dY[0][5] = -Y[1];
      dY[1][3] = -Y[2]; dY[1][5] = Y[0];
      dY[2][3] = Y[1]; dY[2][4] = -Y[0];
    }
  } else {
    const double inv = 1.0 / fmax(s, 1e-9);
    double d[3];
    for (int c = 0; c < 3; ++c) d[c] = X[c] - t[c];
    for (int c = 0; c < 3; ++c)
      Y[c] = (R[c] * d[0] + R[3 + c] * d[1] + R[6 + c] * d[2]) * inv;
    if (Jw) {
      // d(R^T (X - t) / s) = R^T ([X]x dphi - drho - t dsigma) / s
      //                      - Y dsigma (s > 1e-9)
      double M[3][7];
      for (int c = 0; c < 3; ++c)
        for (int k = 0; k < 7; ++k) M[c][k] = 0.0;
      for (int c = 0; c < 3; ++c) {
        M[c][c] = -1.0;
        M[c][6] = -t[c];
      }
      M[0][4] = -X[2]; M[0][5] = X[1];
      M[1][3] = X[2]; M[1][5] = -X[0];
      M[2][3] = -X[1]; M[2][4] = X[0];
      for (int c = 0; c < 3; ++c)
        for (int k = 0; k < 7; ++k)
          dY[c][k] = (R[c] * M[0][k] + R[3 + c] * M[1][k]
                      + R[6 + c] * M[2][k]) * inv;
      if (s > 1e-9)
        for (int c = 0; c < 3; ++c) dY[c][6] -= Y[c];
    }
  }
  double pc[3];
  for (int r = 0; r < 3; ++r)
    pc[r] = P[4 * r] * Y[0] + P[4 * r + 1] * Y[1] + P[4 * r + 2] * Y[2]
        + P[4 * r + 3];
  const bool zc = pc[2] > 1e-4;
  const double z = zc ? pc[2] : 1e-4;
  const double w = sqrt((double)(fwd ? p.is2f[i] : p.is2b[i]));
  rw[0] = (p.fx * pc[0] / z + p.cx - uv[2 * i]) * w;
  rw[1] = (p.fy * pc[1] / z + p.cy - uv[2 * i + 1]) * w;
  if (Jw) {
    const double A[2][3] = {
        {p.fx / z, 0.0, zc ? -p.fx * pc[0] / (z * z) : 0.0},
        {0.0, p.fy / z, zc ? -p.fy * pc[1] / (z * z) : 0.0}};
    for (int k = 0; k < 7; ++k) {
      double dpc[3];
      for (int r = 0; r < 3; ++r)
        dpc[r] = P[4 * r] * dY[0][k] + P[4 * r + 1] * dY[1][k]
            + P[4 * r + 2] * dY[2][k];
      const double m = (k == 6 && p.fix_scale) ? 0.0 : w;
      for (int r = 0; r < 2; ++r)
        Jw[r][k] = (A[r][0] * dpc[0] + A[r][1] * dpc[1] + A[r][2] * dpc[2])
            * m;
    }
  }
  return rw[0] * rw[0] + rw[1] * rw[1];
}

__device__ inline double huber(double chi2) {
  return fmin(1.0, sqrt(kChi2) / sqrt(fmax(chi2, 1e-18)));
}

// sum of the robust costs of the masked edges under S (fixed order)
__device__ double reproj_cost(const Reproj& p, const double* S,
                              const bool* mask, double* red) {
  double acc = 0.0;
  double rw[2];
  for (int e = threadIdx.x; e < 2 * p.cap; e += kThreads) {
    if (!mask[e]) continue;
    const double chi2 = edge(p, S, e, rw, nullptr);
    acc += huber(chi2) * chi2;
  }
  return block_sum(acc, red);
}

// 7x7 Cholesky solve of H x = g in place (x into g); NaN when H is not
// positive definite.
__device__ void chol7(double H[7][7], double g[7]) {
  for (int j = 0; j < 7; ++j) {
    double d = H[j][j];
    for (int k = 0; k < j; ++k) d -= H[j][k] * H[j][k];
    const double l = sqrt(d > 0.0 ? d : nan(""));
    H[j][j] = l;
    for (int i = j + 1; i < 7; ++i) {
      double a = H[i][j];
      for (int k = 0; k < j; ++k) a -= H[i][k] * H[j][k];
      H[i][j] = a / l;
    }
  }
  for (int i = 0; i < 7; ++i) {
    double a = g[i];
    for (int k = 0; k < i; ++k) a -= H[i][k] * g[k];
    g[i] = a / H[i][i];
  }
  for (int i = 6; i >= 0; --i) {
    double a = g[i];
    for (int k = i + 1; k < 7; ++k) a -= H[k][i] * g[k];
    g[i] = a / H[i][i];
  }
}

__global__ void __launch_bounds__(kThreads)
sim3_reproj_kernel(Reproj p, const float* __restrict__ S0, int rounds,
                   int iters, float* __restrict__ S_out,
                   bool* __restrict__ mask_out, int* __restrict__ n_out) {
  extern __shared__ unsigned char smem_raw[];
  bool* mask = reinterpret_cast<bool*>(smem_raw);        // [2 cap]
  __shared__ double red[33];
  __shared__ double part[kWarps][36];
  __shared__ double S[13], cand[13];
  __shared__ double lam, cost_prev;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ne = 2 * p.cap;
  if (tid < 13) S[tid] = S0[tid];
  for (int e = tid; e < ne; e += kThreads)
    mask[e] = e < p.cap ? p.vf[e] : p.vb[e - p.cap];
  __syncthreads();
  for (int round = 0; round < rounds; ++round) {
    const double c0 = reproj_cost(p, S, mask, red);
    if (tid == 0) {
      cost_prev = c0;
      lam = 1e-4;
    }
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
      double acc[36];
      for (int k = 0; k < 36; ++k) acc[k] = 0.0;
      for (int e = tid; e < ne; e += kThreads) {
        if (!mask[e]) continue;
        double rw[2], J[2][7];
        const double chi2 = edge(p, S, e, rw, J);
        const double w = huber(chi2);
        int q = 0;
        for (int a = 0; a < 7; ++a)
          for (int b = a; b < 7; ++b, ++q)
            acc[q] += w * (J[0][a] * J[0][b] + J[1][a] * J[1][b]);
        for (int a = 0; a < 7; ++a)
          acc[28 + a] -= w * (J[0][a] * rw[0] + J[1][a] * rw[1]);
      }
      for (int k = 0; k < 35; ++k) {
        double v = acc[k];
        for (int s = 16; s > 0; s >>= 1)
          v += __shfl_down_sync(0xffffffffu, v, s);
        if (lane == 0) part[warp][k] = v;
      }
      __syncthreads();
      if (tid == 0) {
        double H[7][7], g[7];
        int q = 0;
        for (int a = 0; a < 7; ++a)
          for (int b = a; b < 7; ++b, ++q) {
            double v = 0.0;
            for (int w = 0; w < kWarps; ++w) v += part[w][q];
            H[a][b] = H[b][a] = v;
          }
        for (int a = 0; a < 7; ++a) {
          double v = 0.0;
          for (int w = 0; w < kWarps; ++w) v += part[w][28 + a];
          g[a] = v;
        }
        for (int a = 0; a < 7; ++a) H[a][a] += H[a][a] * lam + 1e-6;
        chol7(H, g);
        if (p.fix_scale) g[6] = 0.0;
        retract_state(S, g, false, cand);
      }
      __syncthreads();
      const double c_new = reproj_cost(p, cand, mask, red);
      if (tid == 0) {
        const bool accept = c_new < cost_prev;
        if (accept) {
          for (int k = 0; k < 13; ++k) S[k] = cand[k];
          cost_prev = c_new;
        }
        lam = fmin(fmax(accept ? lam * 0.5 : lam * 4.0, 1e-8), 1e4);
      }
      __syncthreads();
    }
    // re-gate every valid edge on its chi2 at the round's result
    for (int e = tid; e < ne; e += kThreads) {
      const bool v = e < p.cap ? p.vf[e] : p.vb[e - p.cap];
      double rw[2];
      mask[e] = v && edge(p, S, e, rw, nullptr) < kChi2;
    }
    __syncthreads();
  }
  double cnt = 0.0;
  for (int e = tid; e < ne; e += kThreads) {
    mask_out[e] = mask[e];
    cnt += mask[e];
  }
  cnt = block_sum(cnt, red);
  if (tid < 13) S_out[tid] = float(S[tid]);
  if (tid == 0) *n_out = int(cnt);
}

}  // namespace

PLVIO_API int sim3_ransac(const void* X1, const void* X2, const void* valid,
                          int n, const void* samples, int iters, double th,
                          int fix_scale, void* out, void* inl, void* ints,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sim3_ransac_kernel<<<1, kThreads, 0, s>>>(
      static_cast<const float*>(X1), static_cast<const float*>(X2),
      static_cast<const bool*>(valid), n, static_cast<const int*>(samples),
      iters, th, fix_scale, static_cast<float*>(out),
      static_cast<bool*>(inl), static_cast<int*>(ints));
  return static_cast<int>(cudaGetLastError());
}

PLVIO_API int sim3_reproj(const void* S0, const void* X1, const void* uv2,
                          const void* vf, const void* is2f, const void* X2,
                          const void* uv1, const void* vb, const void* is2b,
                          const void* pose_kf, const void* pose_cand,
                          int cap, double fx, double fy, double cx,
                          double cy, int fix_scale, int rounds, int iters,
                          void* S_out, void* mask_out, void* n_out,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Reproj p{static_cast<const float*>(X1), static_cast<const float*>(uv2),
           static_cast<const bool*>(vf), static_cast<const float*>(is2f),
           static_cast<const float*>(X2), static_cast<const float*>(uv1),
           static_cast<const bool*>(vb), static_cast<const float*>(is2b),
           static_cast<const float*>(pose_kf),
           static_cast<const float*>(pose_cand), fx, fy, cx, cy, cap,
           fix_scale};
  sim3_reproj_kernel<<<1, kThreads, size_t(2 * cap), s>>>(
      p, static_cast<const float*>(S0), rounds, iters,
      static_cast<float*>(S_out), static_cast<bool*>(mask_out),
      static_cast<int*>(n_out));
  return static_cast<int>(cudaGetLastError());
}
