// pose_lm — the pose-only Levenberg-Marquardt of one 6-DoF camera pose
// T_cw against fixed 3D points, in rounds with a chi2 re-gate between them.
//
// Replaces plvio_tpu/models/kernels.py `make_pose_optimizer_stereo` (:687),
// the tracker's local-map pose solve for STEREO / RGB-D without lines
// (models/tracking.py:1096-1113: 4 rounds x 10 iterations, a stereo term
// of (u, v, u_R) rows with Huber delta sqrt(7.815) where u_R > 0, a mono
// term of (u, v) rows with delta sqrt(5.991) elsewhere), and
// `make_pose_optimizer_kb8` (:1493), the same solve on raw fisheye pixels
// through the KB8 theta polynomial (3 rounds x 6, delta sqrt(5.991)).
// Both run the dense LM engine, plvio_tpu/solver/engine.py `optimize`
// (:624-700): jacfwd Jacobians, H + diag(diag(H) lam + 1e-6), a Cholesky
// solve, accept when the robust cost falls (lam x0.5, else x4, clipped to
// [1e-8, 1e4], from 1e-4 each round), then the masks re-gated on each
// row's chi2 at the round's result.
//
// What bounds it on the H100: serial latency.  2048 rows x (4 x 10)
// iterations, each row ~150 flops to linearize and ~60 to re-cost, is
// ~25 Mflop in float64; each iteration ends in a 6x6 factor on one thread
// and two block-wide reductions, so the kernel is a chain of ~80 short
// synchronised steps, not a use of the card's width.
//
// Design: one block of 256 threads, in float64 (the residuals near the
// optimum are a few 1e-3 px: float32 sums would decide accept / reject by
// rounding, so the plain version's float64 run is the reference it is
// held to).  Each thread takes rows tid, tid + 256, ...: it whitens the
// residual by sqrt(info), weighs it by Huber w = min(1, delta / sqrt(max(
// chi2, 1e-18))) times the mask, and adds w J^T J (21 entries) and -w J^T
// r (6) in registers; the warps reduce by shuffles and the eight warp sums
// meet in shared memory in a fixed order, so every launch adds in the same
// order.  Thread 0 damps, factors (6x6 Cholesky, NaN when not positive
// definite: the candidate's cost is then NaN and the step refused, as the
// engine's), and retracts: T <- Exp(dx) T with the SO(3) part
// re-orthonormalised (lie.so3_normalize).  The Jacobians are analytic:
// d pc / d rho = I, d pc / d phi = -hat(pc); the pinhole projection's
// depth clamped at 1e-4 (no depth derivative where clamped), u_R = u -
// bf / z; KB8 as solver/residuals.py `kb8_proj_jac`.  The residual family
// is a template parameter (kStereo, kKb8), so that further families (the
// line-only pose modes) add a case and not a kernel.
//
// The line-only families (slice 13) replace `make_pose_opt_line_only`
// (models/kernels.py:1344), the tracker's pose solve from lines alone
// under SLAM modes 1-3 (models/tracking.py:1040-1066: 3 rounds x 6, cap
// 256): kLineEp the two endpoint-to-line rows of each map line
// (`make_line_reproj_fixed`, solver/residuals.py:173), kLineAng the sine
// of the angle between the projected segment and the observed direction
// (`make_line_angle_fixed`, :188; information 400 x is2), kLineBoth both,
// each term with its own Huber weight (delta sqrt(5.991)) on one mask, the
// rows re-gated on the endpoint term's chi2 (kLineEp, kLineBoth) or the
// angle term's (kLineAng).  The angle row's Jacobian goes through the
// normalised direction: with d = uv_e - uv_s, n = (|d|^2 + 1e-12)^-1/2 and
// g = (dir_1, -dir_0), r = n (d . g) and d r / d d = n g - n^3 (d . g) d
// (solver/residuals.py `line_angle_jac`).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStereo = 0;
constexpr int kKb8 = 1;
constexpr int kLineEp = 2;
constexpr int kLineAng = 3;
constexpr int kLineBoth = 4;
constexpr double kAngInfo = 400.0;
constexpr double kChi2Mono = 5.991;
constexpr double kChi2Stereo = 7.815;

struct Params {
  const float* pose0;   // [12] T_cw, row-major [3,4]
  const float* obs;     // [cap, ostride]: (u, v, u_R) stereo, (u, v) KB8,
                        // the line equation (a, b, c) of the line families
  const float* X;       // [cap,3]; the start points Xs of the line families
  const bool* valid;    // [cap]
  const float* is2;     // [cap]
  int cap, ostride, rounds, iters;
  double fx, fy, cx, cy, bf;     // bf: stereo only
  double k1, k2, k3, k4;         // KB8 only
  float* pose;          // [12]
  bool* inlier;         // [cap]
  int* n_inl;           // [1]
  const float* Xe;      // [cap,3] the end points (line families)
  const float* dir;     // [cap,2] the observed unit directions (line families)
};

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

// Row i under pose T: whitened residual rw (rdim rows), whitened Jacobian
// Jw [rdim][6] when Jw != nullptr, the chi2, and rdim (3 for a stereo
// row, 2 otherwise).  `stereo_row` says which term the row belongs to.
template <int F>
__device__ double row(const Params& p, const double* T, int i, bool& stereo_row,
                      double rw[3], double (*Jw)[6], int& rdim) {
  const double X[3] = {p.X[3 * i], p.X[3 * i + 1], p.X[3 * i + 2]};
  double pc[3];
  for (int r = 0; r < 3; ++r)
    pc[r] = T[4 * r] * X[0] + T[4 * r + 1] * X[1] + T[4 * r + 2] * X[2]
        + T[4 * r + 3];
  const float* o = p.obs + i * p.ostride;
  const double w = sqrt((double)p.is2[i]);
  double J[3][3];
  if (F == kStereo) {
    stereo_row = o[2] > 0.f;
    rdim = stereo_row ? 3 : 2;
    const bool zc = pc[2] > 1e-4;
    const double z = zc ? pc[2] : 1e-4;
    const double u = p.fx * pc[0] / z + p.cx;
    const double v = p.fy * pc[1] / z + p.cy;
    rw[0] = (u - o[0]) * w;
    rw[1] = (v - o[1]) * w;
    rw[2] = stereo_row ? (u - p.bf / z - o[2]) * w : 0.0;
    if (Jw) {
      const double iz = 1.0 / z, dz = zc ? 1.0 : 0.0;
      J[0][0] = p.fx * iz; J[0][1] = 0.0;
      J[0][2] = -p.fx * pc[0] * iz * iz * dz;
      J[1][0] = 0.0; J[1][1] = p.fy * iz;
      J[1][2] = -p.fy * pc[1] * iz * iz * dz;
      J[2][0] = p.fx * iz; J[2][1] = 0.0;
      J[2][2] = (-p.fx * pc[0] + p.bf) * iz * iz * dz;
    }
  } else {
    stereo_row = false;
    rdim = 2;
    const double x = pc[0], y = pc[1];
    const double r2 = x * x + y * y;
    const double r = sqrt(fmax(r2, 1e-18));
    const bool zon = pc[2] > 1e-6;
    const double zc = zon ? pc[2] : 1e-6;
    const double th = atan2(r, zc);
    const double t2 = th * th, q2 = t2 * t2, q3 = t2 * q2, q4 = q2 * q2;
    const double td = th * (1.0 + p.k1 * t2 + p.k2 * q2 + p.k3 * q3
                            + p.k4 * q4);
    const double s = td / r;
    rw[0] = (p.fx * x * s + p.cx - o[0]) * w;
    rw[1] = (p.fy * y * s + p.cy - o[1]) * w;
    rw[2] = 0.0;
    if (Jw) {
      const double dtd = 1.0 + 3.0 * p.k1 * t2 + 5.0 * p.k2 * q2
          + 7.0 * p.k3 * q3 + 9.0 * p.k4 * q4;
      const double den = r * r + zc * zc;
      const double ds_dr = (dtd * zc / den * r - td) / (r * r);
      const double ds_dz = zon ? dtd * (-r / den) / r : 0.0;
      const bool on = r2 > 1e-18;
      const double drx = on ? x / r : 0.0, dry = on ? y / r : 0.0;
      J[0][0] = p.fx * (s + x * ds_dr * drx);
      J[0][1] = p.fx * x * ds_dr * dry;
      J[0][2] = p.fx * x * ds_dz;
      J[1][0] = p.fy * y * ds_dr * drx;
      J[1][1] = p.fy * (s + y * ds_dr * dry);
      J[1][2] = p.fy * y * ds_dz;
    }
  }
  if (Jw) {
    // [j, -j hat(pc)] per row, whitened
    for (int d = 0; d < rdim; ++d) {
      const double* j = J[d];
      Jw[d][0] = j[0] * w;
      Jw[d][1] = j[1] * w;
      Jw[d][2] = j[2] * w;
      Jw[d][3] = -(j[1] * pc[2] - j[2] * pc[1]) * w;
      Jw[d][4] = -(j[2] * pc[0] - j[0] * pc[2]) * w;
      Jw[d][5] = -(j[0] * pc[1] - j[1] * pc[0]) * w;
    }
  }
  double chi2 = 0.0;
  for (int d = 0; d < rdim; ++d) chi2 += rw[d] * rw[d];
  return chi2;
}

// pinhole projection of X under T (depth clamped at 1e-4) and, when J is
// given, [d uv / d pc] and pc
__device__ void pinhole(const Params& p, const double* T, const float* Xf,
                        double uv[2], double J[2][3], double pc[3]) {
  const double X[3] = {Xf[0], Xf[1], Xf[2]};
  for (int r = 0; r < 3; ++r)
    pc[r] = T[4 * r] * X[0] + T[4 * r + 1] * X[1] + T[4 * r + 2] * X[2]
        + T[4 * r + 3];
  const bool zc = pc[2] > 1e-4;
  const double z = zc ? pc[2] : 1e-4;
  uv[0] = p.fx * pc[0] / z + p.cx;
  uv[1] = p.fy * pc[1] / z + p.cy;
  if (J) {
    const double iz = 1.0 / z, dz = zc ? 1.0 : 0.0;
    J[0][0] = p.fx * iz; J[0][1] = 0.0;
    J[0][2] = -p.fx * pc[0] * iz * iz * dz;
    J[1][0] = 0.0; J[1][1] = p.fy * iz;
    J[1][2] = -p.fy * pc[1] * iz * iz * dz;
  }
}

// [j, -j hat(pc)]: d r / d (rho, phi) of a row j = d r / d pc
__device__ inline void pose_row(const double j[3], const double pc[3],
                                double out[6]) {
  out[0] = j[0];
  out[1] = j[1];
  out[2] = j[2];
  out[3] = -(j[1] * pc[2] - j[2] * pc[1]);
  out[4] = -(j[2] * pc[0] - j[0] * pc[2]);
  out[5] = -(j[0] * pc[1] - j[1] * pc[0]);
}

// Line i of a line family under pose T: rows 0-1 the whitened endpoint
// rows (kLineEp, kLineBoth), row 2 the whitened angle row (kLineAng,
// kLineBoth), their Jacobians when Jw != nullptr, and each term's chi2
// (0 for a term the family lacks).
template <int F>
__device__ void line_rows(const Params& p, const double* T, int i,
                          double rw[3], double (*Jw)[6], double& chi_ep,
                          double& chi_ang) {
  double uv[2][2], J[2][2][3], pc[2][3];
  pinhole(p, T, p.X + 3 * i, uv[0], Jw ? J[0] : nullptr, pc[0]);
  pinhole(p, T, p.Xe + 3 * i, uv[1], Jw ? J[1] : nullptr, pc[1]);
  const double is2 = (double)p.is2[i];
  chi_ep = chi_ang = 0.0;
  rw[0] = rw[1] = rw[2] = 0.0;
  if (F != kLineAng) {
    const float* l = p.obs + 3 * i;
    const double w = sqrt(is2);
    for (int e = 0; e < 2; ++e) {
      rw[e] = (l[0] * uv[e][0] + l[1] * uv[e][1] + l[2]) * w;
      if (Jw) {
        double j[3];
        for (int c = 0; c < 3; ++c)
          j[c] = (l[0] * J[e][0][c] + l[1] * J[e][1][c]) * w;
        pose_row(j, pc[e], Jw[e]);
      }
    }
    chi_ep = rw[0] * rw[0] + rw[1] * rw[1];
  }
  if (F != kLineEp) {
    const double w = sqrt(is2 * kAngInfo);
    const double d0 = uv[1][0] - uv[0][0], d1 = uv[1][1] - uv[0][1];
    const double n = 1.0 / sqrt(d0 * d0 + d1 * d1 + 1e-12);
    const double g0 = p.dir[2 * i + 1], g1 = -p.dir[2 * i];
    const double dg = d0 * g0 + d1 * g1;
    rw[2] = n * dg * w;
    chi_ang = rw[2] * rw[2];
    if (Jw) {
      const double n3 = n * n * n * dg;
      const double dd[2] = {n * g0 - n3 * d0, n * g1 - n3 * d1};
      for (int a = 0; a < 6; ++a) Jw[2][a] = 0.0;
      for (int e = 0; e < 2; ++e) {
        const double sg = e ? w : -w;
        double j[3], row[6];
        for (int c = 0; c < 3; ++c)
          j[c] = (dd[0] * J[e][0][c] + dd[1] * J[e][1][c]) * sg;
        pose_row(j, pc[e], row);
        for (int a = 0; a < 6; ++a) Jw[2][a] += row[a];
      }
    }
  }
}

__device__ inline double delta_of(bool stereo_row) {
  return sqrt(stereo_row ? kChi2Stereo : kChi2Mono);
}

__device__ inline double huber(double delta, double chi2) {
  return fmin(1.0, delta / sqrt(fmax(chi2, 1e-18)));
}

template <int F>
__device__ double cost(const Params& p, const double* T, const bool* mask,
                       double* red) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < p.cap; i += kThreads) {
    if (!mask[i]) continue;
    if constexpr (F >= kLineEp) {
      double rw[3], ce, ca;
      line_rows<F>(p, T, i, rw, nullptr, ce, ca);
      const double dm = sqrt(kChi2Mono);
      acc += huber(dm, ce) * ce + huber(dm, ca) * ca;
      continue;
    }
    bool st;
    int rdim;
    double rw[3];
    const double chi2 = row<F>(p, T, i, st, rw, nullptr, rdim);
    acc += huber(delta_of(st), chi2) * chi2;
  }
  return block_sum(acc, red);
}

// 6x6 Cholesky solve of H x = g in place (x into g); NaN when H is not
// positive definite.
__device__ void chol6(double H[6][6], double g[6]) {
  for (int j = 0; j < 6; ++j) {
    double d = H[j][j];
    for (int k = 0; k < j; ++k) d -= H[j][k] * H[j][k];
    const double l = sqrt(d > 0.0 ? d : nan(""));
    H[j][j] = l;
    for (int i = j + 1; i < 6; ++i) {
      double a = H[i][j];
      for (int k = 0; k < j; ++k) a -= H[i][k] * H[j][k];
      H[i][j] = a / l;
    }
  }
  for (int i = 0; i < 6; ++i) {
    double a = g[i];
    for (int k = 0; k < i; ++k) a -= H[i][k] * g[k];
    g[i] = a / H[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    double a = g[i];
    for (int k = i + 1; k < 6; ++k) a -= H[k][i] * g[k];
    g[i] = a / H[i][i];
  }
}

// T <- Exp(xi) T (lie.se3_exp, left perturbation), the rotation
// re-orthonormalised as lie.so3_normalize; Taylor branches below 1e-6.
__device__ void retract(const double T[12], const double xi[6],
                        double out[12]) {
  const double* rho = xi;
  const double* phi = xi + 3;
  const double th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const bool small = th2 < 1e-6;
  const double th = small ? 1.0 : sqrt(th2);
  const double A = small ? 1.0 - th2 / 6.0 : sin(th) / th;
  const double B = small ? 0.5 - th2 / 24.0 : (1.0 - cos(th)) / th2;
  const double C = small ? 1.0 / 6.0 - th2 / 120.0
                         : (th - sin(th)) / (th2 * th);
  const double W[3][3] = {{0.0, -phi[2], phi[1]},
                          {phi[2], 0.0, -phi[0]},
                          {-phi[1], phi[0], 0.0}};
  double W2[3][3], dR[3][3], V[3][3];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      W2[a][b] = W[a][0] * W[0][b] + W[a][1] * W[1][b] + W[a][2] * W[2][b];
    }
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      const double I = a == b ? 1.0 : 0.0;
      dR[a][b] = I + A * W[a][b] + B * W2[a][b];
      V[a][b] = I + B * W[a][b] + C * W2[a][b];
    }
  double R[3][3], t[3];
  for (int a = 0; a < 3; ++a) {
    for (int b = 0; b < 3; ++b)
      R[a][b] = dR[a][0] * T[b] + dR[a][1] * T[4 + b] + dR[a][2] * T[8 + b];
    t[a] = dR[a][0] * T[3] + dR[a][1] * T[7] + dR[a][2] * T[11]
        + (V[a][0] * rho[0] + V[a][1] * rho[1] + V[a][2] * rho[2]);
  }
  double r0[3], r1[3];
  double n0 = sqrt(R[0][0] * R[0][0] + R[0][1] * R[0][1] + R[0][2] * R[0][2]);
  n0 = fmax(n0, 1e-12);
  for (int c = 0; c < 3; ++c) r0[c] = R[0][c] / n0;
  const double d = R[1][0] * r0[0] + R[1][1] * r0[1] + R[1][2] * r0[2];
  for (int c = 0; c < 3; ++c) r1[c] = R[1][c] - d * r0[c];
  double n1 = sqrt(r1[0] * r1[0] + r1[1] * r1[1] + r1[2] * r1[2]);
  n1 = fmax(n1, 1e-12);
  for (int c = 0; c < 3; ++c) r1[c] /= n1;
  const double r2[3] = {r0[1] * r1[2] - r0[2] * r1[1],
                        r0[2] * r1[0] - r0[0] * r1[2],
                        r0[0] * r1[1] - r0[1] * r1[0]};
  for (int c = 0; c < 3; ++c) {
    out[c] = r0[c];
    out[4 + c] = r1[c];
    out[8 + c] = r2[c];
  }
  out[3] = t[0];
  out[7] = t[1];
  out[11] = t[2];
}

template <int F>
__global__ void __launch_bounds__(kThreads) pose_lm_kernel(Params p) {
  extern __shared__ unsigned char smem_raw[];
  bool* mask = reinterpret_cast<bool*>(smem_raw);        // [cap]
  __shared__ double red[33];
  __shared__ double part[kWarps][27];
  __shared__ double T[12], cand[12];
  __shared__ double lam, cost_prev;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 12) T[tid] = p.pose0[tid];
  for (int i = tid; i < p.cap; i += kThreads) mask[i] = p.valid[i];
  __syncthreads();
  for (int round = 0; round < p.rounds; ++round) {
    const double c0 = cost<F>(p, T, mask, red);
    if (tid == 0) {
      cost_prev = c0;
      lam = 1e-4;
    }
    __syncthreads();
    for (int it = 0; it < p.iters; ++it) {
      double acc[27];
      for (int k = 0; k < 27; ++k) acc[k] = 0.0;
      for (int i = tid; i < p.cap; i += kThreads) {
        if (!mask[i]) continue;
        if constexpr (F >= kLineEp) {
          double rw[3], J[3][6], ce, ca;
          line_rows<F>(p, T, i, rw, J, ce, ca);
          const double dm = sqrt(kChi2Mono);
          const double we = huber(dm, ce), wa = huber(dm, ca);
          const int d0 = F == kLineAng ? 2 : 0, d1 = F == kLineEp ? 2 : 3;
          int q = 0;
          for (int a = 0; a < 6; ++a)
            for (int b = a; b < 6; ++b, ++q) {
              double h = 0.0;
              for (int d = d0; d < d1; ++d)
                h += (d == 2 ? wa : we) * (J[d][a] * J[d][b]);
              acc[q] += h;
            }
          for (int a = 0; a < 6; ++a) {
            double gg = 0.0;
            for (int d = d0; d < d1; ++d)
              gg += (d == 2 ? wa : we) * (J[d][a] * rw[d]);
            acc[21 + a] -= gg;
          }
          continue;
        }
        bool st;
        int rdim;
        double rw[3], J[3][6];
        const double chi2 = row<F>(p, T, i, st, rw, J, rdim);
        const double w = huber(delta_of(st), chi2);
        int q = 0;
        for (int a = 0; a < 6; ++a)
          for (int b = a; b < 6; ++b, ++q) {
            double h = 0.0;
            for (int d = 0; d < rdim; ++d) h += J[d][a] * J[d][b];
            acc[q] += w * h;
          }
        for (int a = 0; a < 6; ++a) {
          double gg = 0.0;
          for (int d = 0; d < rdim; ++d) gg += J[d][a] * rw[d];
          acc[21 + a] -= w * gg;
        }
      }
      for (int k = 0; k < 27; ++k) {
        double v = acc[k];
        for (int s = 16; s > 0; s >>= 1)
          v += __shfl_down_sync(0xffffffffu, v, s);
        if (lane == 0) part[warp][k] = v;
      }
      __syncthreads();
      if (tid == 0) {
        double H[6][6], g[6];
        int q = 0;
        for (int a = 0; a < 6; ++a)
          for (int b = a; b < 6; ++b, ++q) {
            double v = 0.0;
            for (int w = 0; w < kWarps; ++w) v += part[w][q];
            H[a][b] = H[b][a] = v;
          }
        for (int a = 0; a < 6; ++a) {
          double v = 0.0;
          for (int w = 0; w < kWarps; ++w) v += part[w][21 + a];
          g[a] = v;
        }
        for (int a = 0; a < 6; ++a) H[a][a] += H[a][a] * lam + 1e-6;
        chol6(H, g);
        retract(T, g, cand);
      }
      __syncthreads();
      const double c_new = cost<F>(p, cand, mask, red);
      if (tid == 0) {
        const bool accept = c_new < cost_prev;
        if (accept) {
          for (int k = 0; k < 12; ++k) T[k] = cand[k];
          cost_prev = c_new;
        }
        lam = fmin(fmax(accept ? lam * 0.5 : lam * 4.0, 1e-8), 1e4);
      }
      __syncthreads();
    }
    // re-gate every valid row on its chi2 at the round's result
    for (int i = tid; i < p.cap; i += kThreads) {
      if constexpr (F >= kLineEp) {
        double rw[3], ce, ca;
        line_rows<F>(p, T, i, rw, nullptr, ce, ca);
        mask[i] = p.valid[i] && (F == kLineAng ? ca : ce) < kChi2Mono;
        continue;
      }
      bool st;
      int rdim;
      double rw[3];
      const double chi2 = row<F>(p, T, i, st, rw, nullptr, rdim);
      mask[i] = p.valid[i] && chi2 < (st ? kChi2Stereo : kChi2Mono);
    }
    __syncthreads();
  }
  double cnt = 0.0;
  for (int i = tid; i < p.cap; i += kThreads) {
    p.inlier[i] = mask[i];
    cnt += mask[i];
  }
  cnt = block_sum(cnt, red);
  if (tid < 12) p.pose[tid] = float(T[tid]);
  if (tid == 0) *p.n_inl = int(cnt);
}

}  // namespace

// family 0: stereo (obs = uvr [cap,3], bf > 0); 1: KB8 (obs = uv [cap,2],
// k1..k4); 2, 3, 4: the line families of SLAM modes 1, 2, 3 (obs = the
// line equations [cap,3], X = Xs, Xe and dir given)
PLVIO_API int pose_lm(int family, const void* pose0, const void* obs,
                      const void* X, const void* valid, const void* is2,
                      int cap, int rounds, int iters, double fx, double fy,
                      double cx, double cy, double bf, double k1, double k2,
                      double k3, double k4, void* pose, void* inlier,
                      void* n_inl, const void* Xe, const void* dir,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool line = family >= kLineEp && family <= kLineBoth;
  if ((family != kStereo && family != kKb8 && !line) ||
      (line && (Xe == nullptr || dir == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(pose0), static_cast<const float*>(obs),
           static_cast<const float*>(X), static_cast<const bool*>(valid),
           static_cast<const float*>(is2), cap,
           family == kKb8 ? 2 : 3,
           rounds, iters, fx, fy, cx, cy, bf, k1, k2, k3, k4,
           static_cast<float*>(pose), static_cast<bool*>(inlier),
           static_cast<int*>(n_inl), static_cast<const float*>(Xe),
           static_cast<const float*>(dir)};
  const size_t smem = size_t(cap);
  if (family == kStereo)
    pose_lm_kernel<kStereo><<<1, kThreads, smem, s>>>(p);
  else if (family == kKb8)
    pose_lm_kernel<kKb8><<<1, kThreads, smem, s>>>(p);
  else if (family == kLineEp)
    pose_lm_kernel<kLineEp><<<1, kThreads, smem, s>>>(p);
  else if (family == kLineAng)
    pose_lm_kernel<kLineAng><<<1, kThreads, smem, s>>>(p);
  else
    pose_lm_kernel<kLineBoth><<<1, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
