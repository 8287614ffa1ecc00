// pose_irls — the fused point+line pose-only IRLS of the tracked frame:
// rounds x iters Gauss-Newton steps with Huber weights, chi2 re-gating at
// round starts, a damped 6x6 solve and an se3 retraction, then the final
// chi2 gating and the inlier count.
//
// Replaces plvio_tpu/models/kernels.py `fast_pose_opt` (:111) and
// `fast_pose_opt_pl` (:179), its stereo / RGB-D `ur` branch (:196-262)
// included: given ur [n] (the right-eye u_R of each observation, <= 0 for
// a mono one) and bf = baseline * fx, a point with ur > 0 gains the third
// residual (u - bf / z - u_R) with the Jacobian row [fx / z, 0,
// (-fx x + bf) / z^2] (then the rotation block as the others), is re-gated
// at chi2 < 7.815 (a mono point at 5.991) and keeps the Huber delta
// sqrt(5.991).  Without ur the kernel runs the mono arithmetic unchanged,
// bit for bit.
// The JAX version is a lax.scan of 12 steps, each a dozen XLA ops over the
// [N,2,6] Jacobians, float gates in the carry (bool carries miscompiled on
// the TPU backend) and a 6-step CG in place of a factorisation.
//
// What bounds it on the H100: the 12 steps are strictly sequential and
// each needs a reduction over all 2048 points and 128 lines before the
// 6x6 solve, so the kernel is bound by synchronisation latency (block
// barriers and the single-thread solve), not by the ~1 MFLOP of work or
// the 60 KB of inputs.
//
// Design: one persistent block of 512 threads runs all steps, so there is
// no launch or device-memory round trip between steps.  The pose lives in
// shared memory and the point and line gates live in shared memory (one
// byte each).  Each thread accumulates the 21 upper-triangle entries of
// J^T W J and the 6 of J^T W r for its rows; warp shuffles and one pass
// over per-warp partials reduce them.  Thread 0 damps the system exactly
// as the reference (H + 1e-3 diag(H) + 1e-6 I, :158 and :290), solves it
// with a 6x6 Cholesky in registers (measured equivalent to the reference's
// CG for this system), retracts with se3_exp and re-orthonormalises the
// rotation by Gram-Schmidt.  Lines are optional: L = 0 is fast_pose_opt.
// A NaN chi2 gives a NaN Huber weight (`nan_max`, `nan_min`), so a gated-
// off row with NaN residuals poisons the step as it does the reference's
// (0 x NaN); the row is not skipped then.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;

// max / min that propagate NaN, as jnp.maximum / jnp.minimum and the plain
// version's clamp_min / clamp_max do (fmaxf / fminf return the other
// operand): a row whose chi2 is NaN (a KB8 frame's padded segments
// undistort to NaN line equations, which the line matcher hands to its
// unmatched rows) gets a NaN Huber weight, and 0 x NaN poisons the normal
// equations as in the reference.  On finite values the same as fmaxf /
// fminf, bit for bit.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
constexpr int kAcc = 27;            // 21 (H upper triangle) + 6 (g)
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;

struct Params {
  const float* pose0;      // [3,4]
  const float* uv;         // [n,2]
  const float* X;          // [n,3]
  const uint8_t* valid;    // [n]
  const float* is2;        // [n]
  const float* l_obs;      // [L,3]
  const float* Xs;         // [L,3]
  const float* Xe;         // [L,3]
  const uint8_t* valid_l;  // [L]
  const float* is2_l;      // [L]
  const float* ur;         // [n] stereo: u_R (<= 0 mono), or null
  float bf;                // stereo: baseline * fx
  int n, L, rounds, iters;
  float fx, fy, cx, cy, w_line, delta;
  float* pose_out;         // [3,4]
  uint8_t* inl_p;          // [n]
  uint8_t* inl_l;          // [L]
  int* n_inl;              // [1]
};

struct Pose {
  float R[9], t[3];
};

__device__ __forceinline__ void transform(const Pose& P, const float* X,
                                          float* pc) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    pc[j] = X[0] * P.R[3 * j] + X[1] * P.R[3 * j + 1] + X[2] * P.R[3 * j + 2]
            + P.t[j];
}

// -(jp @ hat(pc)) for a 3-vector jp (the rotation block of a Jacobian row)
__device__ __forceinline__ void jphi(const float* jp, const float* pc,
                                     float* out) {
  out[0] = -(jp[1] * pc[2] + jp[2] * -pc[1]);
  out[1] = -(jp[0] * -pc[2] + jp[2] * pc[0]);
  out[2] = -(jp[0] * pc[1] + jp[1] * -pc[0]);
}

__device__ __forceinline__ void accumulate(float* acc, const float* J,
                                           float w, float r) {
  float Jw[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) Jw[i] = J[i] * w;
  int q = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) acc[q++] += Jw[i] * J[j];
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += Jw[i] * r;
}

struct PointEval {
  float pc[3], r[3], chi2, thr;
  bool stereo;             // a stereo row: ur given and ur > 0
};

__device__ __forceinline__ PointEval eval_point(const Params& p,
                                                const Pose& P, int k) {
  PointEval e;
  transform(P, p.X + 3 * k, e.pc);
  const float z = fmaxf(e.pc[2], 1e-4f);
  const float u = p.fx * e.pc[0] / z + p.cx;
  const float v = p.fy * e.pc[1] / z + p.cy;
  e.r[0] = u - p.uv[2 * k];
  e.r[1] = v - p.uv[2 * k + 1];
  e.stereo = false;
  e.thr = kChi2Mono;
  if (p.ur == nullptr) {
    e.r[2] = 0.f;
    e.chi2 = (e.r[0] * e.r[0] + e.r[1] * e.r[1]) * p.is2[k];
    return e;
  }
  // the stereo flavour: a third row, zero (and mono gated) where ur <= 0
  e.stereo = p.ur[k] > 0.f;
  e.r[2] = e.stereo ? (u - p.bf / z) - p.ur[k] : 0.f;
  e.thr = e.stereo ? kChi2Stereo : kChi2Mono;
  e.chi2 = (e.r[0] * e.r[0] + e.r[1] * e.r[1] + e.r[2] * e.r[2]) * p.is2[k];
  return e;
}

// residual l . pi(R X + t) and its 6-vector Jacobian; returns depth
__device__ __forceinline__ float line_endpoint(const Params& p, const Pose& P,
                                               const float* l,
                                               const float* Xep, float* r,
                                               float* J) {
  float pc[3];
  transform(P, Xep, pc);
  const float z = fmaxf(pc[2], 1e-4f);
  const float u = p.fx * pc[0] / z + p.cx;
  const float v = p.fy * pc[1] / z + p.cy;
  *r = l[0] * u + l[1] * v + l[2];
  if (J) {
    const float iz = 1.f / z;
    const float iz2 = iz * iz;
    const float ju[3] = {p.fx * iz, 0.f, -p.fx * pc[0] * iz2};
    const float jv[3] = {0.f, p.fy * iz, -p.fy * pc[1] * iz2};
#pragma unroll
    for (int k = 0; k < 3; ++k) J[k] = l[0] * ju[k] + l[1] * jv[k];
    jphi(J, pc, J + 3);
  }
  return pc[2];
}

__device__ __forceinline__ float line_chi2(const Params& p, const Pose& P,
                                           int k, bool* depth_ok) {
  float rs, re;
  const float zs = line_endpoint(p, P, p.l_obs + 3 * k, p.Xs + 3 * k, &rs,
                                 nullptr);
  const float ze = line_endpoint(p, P, p.l_obs + 3 * k, p.Xe + 3 * k, &re,
                                 nullptr);
  *depth_ok = (zs > 0.05f) && (ze > 0.05f);
  return (rs * rs + re * re) * p.is2_l[k];
}

__device__ void so3_exp_terms(const float* phi, float* W, float* W2,
                              float* theta2_out, float* theta_out) {
  const float theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  *theta2_out = theta2;
  *theta_out = sqrtf(fmaxf(theta2, 1e-24f));
  const float w[9] = {0.f, -phi[2], phi[1], phi[2], 0.f, -phi[0],
                      -phi[1], phi[0], 0.f};
#pragma unroll
  for (int i = 0; i < 9; ++i) W[i] = w[i];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      W2[3 * i + j] = w[3 * i] * w[j] + w[3 * i + 1] * w[3 + j]
                      + w[3 * i + 2] * w[6 + j];
}

// damped solve + retraction, one thread
__device__ void solve_and_retract(const float* acc, Pose& P) {
  float H[6][6], g[6];
  int q = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) { H[i][j] = acc[q]; H[j][i] = acc[q]; ++q; }
  for (int i = 0; i < 6; ++i) {
    g[i] = acc[21 + i];
    H[i][i] = (H[i][i] + H[i][i] * 1e-3f) + 1e-6f;
  }
  float Lc[6][6] = {};
  for (int j = 0; j < 6; ++j) {
    float s = H[j][j];
    for (int k = 0; k < j; ++k) s -= Lc[j][k] * Lc[j][k];
    Lc[j][j] = sqrtf(s);
    for (int i = j + 1; i < 6; ++i) {
      float t = H[i][j];
      for (int k = 0; k < j; ++k) t -= Lc[i][k] * Lc[j][k];
      Lc[i][j] = t / Lc[j][j];
    }
  }
  float y[6], x[6];
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
    for (int k = 0; k < i; ++k) s -= Lc[i][k] * y[k];
    y[i] = s / Lc[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= Lc[k][i] * x[k];
    x[i] = s / Lc[i][i];
  }
  float dx[6];
  for (int i = 0; i < 6; ++i) dx[i] = -x[i];

  // se3_exp(dx): R = I + A W + B W^2, V = I + B W + C W^2, t = V rho
  float W[9], W2[9], theta2, theta;
  so3_exp_terms(dx + 3, W, W2, &theta2, &theta);
  const bool small = theta2 < 1e-6f;
  const float A = small ? 1.f - theta2 / 6.f : sinf(theta) / theta;
  const float B = small ? 0.5f - theta2 / 24.f : (1.f - cosf(theta)) / theta2;
  const float C = small ? 1.f / 6.f - theta2 / 120.f
                        : (theta - sinf(theta)) / (theta2 * theta);
  float Rn[9], V[9];
  for (int i = 0; i < 9; ++i) {
    const float id = (i % 4 == 0) ? 1.f : 0.f;
    Rn[i] = id + A * W[i] + B * W2[i];
    V[i] = id + B * W[i] + C * W2[i];
  }
  float tn[3], R[9], t[3];
  for (int i = 0; i < 3; ++i)
    tn[i] = V[3 * i] * dx[0] + V[3 * i + 1] * dx[1] + V[3 * i + 2] * dx[2];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      R[3 * i + j] = Rn[3 * i] * P.R[j] + Rn[3 * i + 1] * P.R[3 + j]
                     + Rn[3 * i + 2] * P.R[6 + j];
    t[i] = Rn[3 * i] * P.t[0] + Rn[3 * i + 1] * P.t[1]
           + Rn[3 * i + 2] * P.t[2] + tn[i];
  }
  // so3_normalize: Gram-Schmidt on the rows
  float r0[3] = {R[0], R[1], R[2]};
  float n0 = fmaxf(sqrtf(r0[0] * r0[0] + r0[1] * r0[1] + r0[2] * r0[2]),
                   1e-12f);
  for (int k = 0; k < 3; ++k) r0[k] = r0[k] / n0;
  const float d = R[3] * r0[0] + R[4] * r0[1] + R[5] * r0[2];
  float r1[3] = {R[3] - d * r0[0], R[4] - d * r0[1], R[5] - d * r0[2]};
  float n1 = fmaxf(sqrtf(r1[0] * r1[0] + r1[1] * r1[1] + r1[2] * r1[2]),
                   1e-12f);
  for (int k = 0; k < 3; ++k) r1[k] = r1[k] / n1;
  const float r2[3] = {r0[1] * r1[2] - r0[2] * r1[1],
                       r0[2] * r1[0] - r0[0] * r1[2],
                       r0[0] * r1[1] - r0[1] * r1[0]};
  for (int k = 0; k < 3; ++k) {
    P.R[k] = r0[k];
    P.R[3 + k] = r1[k];
    P.R[6 + k] = r2[k];
    P.t[k] = t[k];
  }
}

__global__ void __launch_bounds__(kThreads) pose_irls_kernel(Params p) {
  extern __shared__ uint8_t s_gate[];    // [n] points then [L] lines
  __shared__ Pose s_pose;
  __shared__ float s_red[kThreads / 32][kAcc];
  __shared__ float s_acc[kAcc];
  __shared__ int s_cnt[kThreads / 32];
  uint8_t* gate_p = s_gate;
  uint8_t* gate_l = s_gate + p.n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid < 9) s_pose.R[tid] = p.pose0[(tid / 3) * 4 + tid % 3];
  if (tid < 3) s_pose.t[tid] = p.pose0[tid * 4 + 3];
  for (int k = tid; k < p.n; k += kThreads) gate_p[k] = p.valid[k];
  for (int k = tid; k < p.L; k += kThreads) gate_l[k] = p.valid_l[k];
  __syncthreads();

  const int total = p.rounds * p.iters;
  for (int it = 0; it < total; ++it) {
    const Pose P = s_pose;
    const bool regate = (it % p.iters == 0) && it > 0;
    float acc[kAcc];
#pragma unroll
    for (int q = 0; q < kAcc; ++q) acc[q] = 0.f;

    for (int k = tid; k < p.n; k += kThreads) {
      const PointEval e = eval_point(p, P, k);
      if (regate) gate_p[k] = p.valid[k] && (e.chi2 < e.thr);
      const float wh = nan_min(p.delta / sqrtf(nan_max(e.chi2, 1e-12f)),
                               1.f);
      const float w = float(gate_p[k]) * float(e.pc[2] > 0.05f) * wh
                      * p.is2[k];
      if (w == 0.f) continue;
      const float z = fmaxf(e.pc[2], 1e-4f);
      const float iz = 1.f / z;
      const float iz2 = iz * iz;
      float J[6];
      // u row
      J[0] = p.fx * iz; J[1] = 0.f; J[2] = -p.fx * e.pc[0] * iz2;
      jphi(J, e.pc, J + 3);
      accumulate(acc, J, w, e.r[0]);
      // v row
      J[0] = 0.f; J[1] = p.fy * iz; J[2] = -p.fy * e.pc[1] * iz2;
      jphi(J, e.pc, J + 3);
      accumulate(acc, J, w, e.r[1]);
      if (e.stereo) {
        // u_R row: d(u - bf / z) / dpc
        J[0] = p.fx * iz; J[1] = 0.f; J[2] = (-p.fx * e.pc[0] + p.bf) * iz2;
        jphi(J, e.pc, J + 3);
        accumulate(acc, J, w, e.r[2]);
      }
    }
    for (int k = tid; k < p.L; k += kThreads) {
      bool depth_ok;
      const float c2 = line_chi2(p, P, k, &depth_ok);
      if (regate) gate_l[k] = p.valid_l[k] && (c2 < kChi2Mono);
      const float wh = nan_min(p.delta / sqrtf(nan_max(c2, 1e-12f)), 1.f);
      const float w = float(gate_l[k]) * float(depth_ok) * wh * p.is2_l[k]
                      * p.w_line;
      if (w == 0.f) continue;
      float r, J[6];
      line_endpoint(p, P, p.l_obs + 3 * k, p.Xs + 3 * k, &r, J);
      accumulate(acc, J, w, r);
      line_endpoint(p, P, p.l_obs + 3 * k, p.Xe + 3 * k, &r, J);
      accumulate(acc, J, w, r);
    }

#pragma unroll
    for (int q = 0; q < kAcc; ++q) {
      float v = acc[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) s_red[warp][q] = v;
    }
    __syncthreads();
    if (tid < kAcc) {
      float s = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) s += s_red[w][tid];
      s_acc[tid] = s;
    }
    __syncthreads();
    if (tid == 0) {
      Pose Pn = P;
      solve_and_retract(s_acc, Pn);
      s_pose = Pn;
    }
    __syncthreads();
  }

  const Pose P = s_pose;
  int cnt = 0;
  for (int k = tid; k < p.n; k += kThreads) {
    const PointEval e = eval_point(p, P, k);
    const bool in = p.valid[k] && (e.chi2 < e.thr);
    p.inl_p[k] = in;
    cnt += in;
  }
  for (int k = tid; k < p.L; k += kThreads) {
    bool depth_ok;
    const bool in = p.valid_l[k] && (line_chi2(p, P, k, &depth_ok)
                                     < kChi2Mono);
    p.inl_l[k] = in;
    cnt += in;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  if (lane == 0) s_cnt[warp] = cnt;
  __syncthreads();
  if (tid == 0) {
    int s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += s_cnt[w];
    *p.n_inl = s;
  }
  if (tid < 12) p.pose_out[tid] = tid % 4 == 3 ? P.t[tid / 4]
                                               : P.R[(tid / 4) * 3 + tid % 4];
}

}  // namespace

PLVIO_API int pose_irls(const void* pose0, const void* uv, const void* X,
                        const void* valid, const void* is2, int n,
                        const void* l_obs, const void* Xs, const void* Xe,
                        const void* valid_l, const void* is2_l, int L,
                        const void* ur, float bf, float fx, float fy, float cx, float cy, float w_line,
                        float delta, int rounds, int iters, void* pose_out,
                        void* inl_p, void* inl_l, void* n_inl, void* stream) {
  Params p{static_cast<const float*>(pose0), static_cast<const float*>(uv),
           static_cast<const float*>(X), static_cast<const uint8_t*>(valid),
           static_cast<const float*>(is2), static_cast<const float*>(l_obs),
           static_cast<const float*>(Xs), static_cast<const float*>(Xe),
           static_cast<const uint8_t*>(valid_l),
           static_cast<const float*>(is2_l), static_cast<const float*>(ur),
           bf, n, L, rounds, iters,
           fx, fy, cx, cy, w_line, delta, static_cast<float*>(pose_out),
           static_cast<uint8_t*>(inl_p), static_cast<uint8_t*>(inl_l),
           static_cast<int*>(n_inl)};
  const size_t smem = size_t(n) + size_t(L);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pose_irls_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pose_irls_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
