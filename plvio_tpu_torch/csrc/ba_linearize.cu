// ba_linearize — linearization and cost of the window BAs' visual terms.
//
// Replaces, for `make_local_ba_pl` (plvio_tpu/models/kernels.py:641) and
// its two terms, plvio_tpu/solver/engine.py `Problem.build_normal_equations`
// (:355-450) and `_residuals_only`/`cost` (:575-621), with the residuals
// `make_point_reproj` and `make_line_reproj` (solver/residuals.py:107,155);
// and in its body-frame mode (body = 1), for the inertial window BA
// `make_local_inertial_ba` (models/kernels.py:1206), the same for its
// visual terms `make_point_reproj_body_ba` and `make_line_reproj_body_ba`
// (solver/residuals.py:290,226), projected through the extrinsic (Rcb,
// tcb); the lines there have information 1 (the wrapper passes ones).
// The JAX version linearizes every observation by vmapped jacfwd,
// assembles the keyframe blocks by one-hot matmuls and scatters the
// landmark blocks and the dense coupling B [S, P*dof].
//
// What bounds it on the H100: memory traffic and launch latency.  At the
// worst-case window (8192 point + 1024 line observations, 16 KFs, 4096
// points, 512 lines) a linearization reads ~0.3 MB of state and
// observations and writes ~1.3 MB of per-observation blocks, then the
// segment sums read them back: about a microsecond of bandwidth and ~3
// Mflop, so the few launches (~5 us each) dominate.
//
// Design: the Jacobians are analytic (left se3 perturbation of T_cw: d pc /
// d rho = I, d pc / d phi = -hat(pc); d pc / d X = R; the projection's depth
// derivative is 0 where the depth is clamped at 1e-4), checked against
// autodiff in float64 (tests/test_torch_local_ba.py).  Body frame: with Xb
// = R^T (X - p), pc = Rcb Xb + tcb and JR = (d r / d pc) Rcb, d r / d dp =
// -JR R^T, d r / d dtheta = JR hat(Xb), d r / d X = JR R^T
// (tests/test_torch_inertial_ba.py).  One thread per
// observation whitens by sqrt(info), weighs by Huber w = min(1, delta /
// sqrt(chi2)) times the mask, and writes its blocks: w Jc^T Jc, -w Jc^T r,
// w Jl^T Jl, -w Jl^T r and the coupling w Jc^T Jl (kept per observation,
// never as the dense B).  The sums are deterministic: one thread per
// (segment, entry) adds the blocks of its keyframe or landmark in
// observation order, from one stable sort per BA call (no float atomics,
// whose order changes from run to run).  The cost is sum(w chi2), points
// then lines, reduced in a fixed order in one block; that block also takes
// the LM decision (accept if the cost fell, lambda halved or quadrupled
// within [1e-8, 1e4], early exit once the attempted step moved the cost by
// less than early_tol relative), so the loop needs no host sync.  In the
// body mode the cost adds the chain's share (`ccost`, written just before by
// csrc/inertial_chain.cu at the same state) and an accepted step also
// copies the keyframes' (vel, bg, ba).
#include "ba_common.cuh"

namespace {

using namespace ba;

constexpr int kModeLinearize = 0;
constexpr int kModeDecide = 1;   // cost of the candidate, accept/reject
constexpr int kModeInit = 2;     // cost of the state, start of a round
constexpr int kModeRegate = 3;   // cost of the state, new chi2 masks

struct Proj {
  float pc[3];
  float u, v;
  float J[2][3];     // d(u, v) / d pc
};

__device__ __forceinline__ void project(const BA& b, const float* P,
                                        const float* X, bool jac, Proj& q) {
  for (int r = 0; r < 3; ++r)
    q.pc[r] = ((P[r * 4] * X[0] + P[r * 4 + 1] * X[1]) + P[r * 4 + 2] * X[2])
        + P[r * 4 + 3];
  const float z = fmaxf(q.pc[2], 1e-4f);
  q.u = b.fx * q.pc[0] / z + b.cx;
  q.v = b.fy * q.pc[1] / z + b.cy;
  if (jac) {
    const float iz = 1.f / z;
    const float dz = q.pc[2] > 1e-4f ? 1.f : 0.f;
    q.J[0][0] = b.fx * iz;
    q.J[0][1] = 0.f;
    q.J[0][2] = -b.fx * q.pc[0] * iz * iz * dz;
    q.J[1][0] = 0.f;
    q.J[1][1] = b.fy * iz;
    q.J[1][2] = -b.fy * q.pc[1] * iz * iz * dz;
  }
}

// body frame: Xb = R^T (X - p), pc = Rcb Xb + tcb
__device__ __forceinline__ void project_body(const BA& b, const float* P,
                                             const float* X, bool jac,
                                             Proj& q, float Xb[3]) {
  const float d[3] = {X[0] - P[3], X[1] - P[7], X[2] - P[11]};
  for (int c = 0; c < 3; ++c)
    Xb[c] = (P[c] * d[0] + P[4 + c] * d[1]) + P[8 + c] * d[2];
  for (int r = 0; r < 3; ++r)
    q.pc[r] = ((b.Rcb[3 * r] * Xb[0] + b.Rcb[3 * r + 1] * Xb[1])
               + b.Rcb[3 * r + 2] * Xb[2]) + b.tcb[r];
  const float z = fmaxf(q.pc[2], 1e-4f);
  q.u = b.fx * q.pc[0] / z + b.cx;
  q.v = b.fy * q.pc[1] / z + b.cy;
  if (jac) {
    const float iz = 1.f / z;
    const float dz = q.pc[2] > 1e-4f ? 1.f : 0.f;
    q.J[0][0] = b.fx * iz;
    q.J[0][1] = 0.f;
    q.J[0][2] = -b.fx * q.pc[0] * iz * iz * dz;
    q.J[1][0] = 0.f;
    q.J[1][1] = b.fy * iz;
    q.J[1][2] = -b.fy * q.pc[1] * iz * iz * dz;
  }
}

// body frame: row j (d r / d pc) -> d r / d (dp, dtheta) = [-JR R^T,
// JR hat(Xb)] and d r / d X = JR R^T, with JR = j Rcb
__device__ __forceinline__ void body_rows(const BA& b, const float j[3],
                                          const float* P, const float Xb[3],
                                          float out[6], float jx[3]) {
  float JR[3];
  for (int c = 0; c < 3; ++c)
    JR[c] = (j[0] * b.Rcb[c] + j[1] * b.Rcb[3 + c]) + j[2] * b.Rcb[6 + c];
  for (int c = 0; c < 3; ++c) {
    jx[c] = (JR[0] * P[4 * c] + JR[1] * P[4 * c + 1]) + JR[2] * P[4 * c + 2];
    out[c] = -jx[c];
  }
  out[3] = JR[1] * Xb[2] - JR[2] * Xb[1];
  out[4] = JR[2] * Xb[0] - JR[0] * Xb[2];
  out[5] = JR[0] * Xb[1] - JR[1] * Xb[0];
}

// row j (d r / d pc) -> d r / d (rho, phi) = [j, -j hat(pc)]
__device__ __forceinline__ void pose_row(const float j[3], const float pc[3],
                                         float out[6]) {
  out[0] = j[0];
  out[1] = j[1];
  out[2] = j[2];
  out[3] = -(j[1] * pc[2] - j[2] * pc[1]);
  out[4] = -(j[2] * pc[0] - j[0] * pc[2]);
  out[5] = -(j[0] * pc[1] - j[1] * pc[0]);
}

// d r / d X = j R
__device__ __forceinline__ void point_row(const float j[3], const float* P,
                                          float out[3]) {
  for (int c = 0; c < 3; ++c)
    out[c] = (j[0] * P[c] + j[1] * P[4 + c]) + j[2] * P[8 + c];
}

__device__ __forceinline__ float huber(const BA& b, float chi2, bool on) {
  const float w = fminf(b.delta / sqrtf(fmaxf(chi2, 1e-18f)), 1.f);
  return w * (on ? 1.f : 0.f);     // NaN stays NaN, as w * mask
}

// blocks of one observation from its whitened (r, Jc [2x6], Jl [2xdl])
template <int DL>
__device__ void write_blocks(float w, const float r[2], const float Jc[2][6],
                             const float Jl[2][DL], float* oc, float* ol,
                             float* ow) {
  float Jcw[2][6], Jlw[2][DL];
  for (int d = 0; d < 2; ++d) {
    for (int i = 0; i < 6; ++i) Jcw[d][i] = Jc[d][i] * w;
    for (int i = 0; i < DL; ++i) Jlw[d][i] = Jl[d][i] * w;
  }
  for (int i = 0; i < 6; ++i) {
    for (int j = i; j < 6; ++j)
      oc[ut(6, i, j)] = Jcw[0][i] * Jc[0][j] + Jcw[1][i] * Jc[1][j];
    oc[21 + i] = -(Jcw[0][i] * r[0] + Jcw[1][i] * r[1]);
    for (int j = 0; j < DL; ++j)
      ow[i * DL + j] = Jcw[0][i] * Jl[0][j] + Jcw[1][i] * Jl[1][j];
  }
  constexpr int NU = DL * (DL + 1) / 2;
  for (int i = 0; i < DL; ++i) {
    for (int j = i; j < DL; ++j)
      ol[ut(DL, i, j)] = Jlw[0][i] * Jl[0][j] + Jlw[1][i] * Jl[1][j];
    ol[NU + i] = -(Jlw[0][i] * r[0] + Jlw[1][i] * r[1]);
  }
}

__global__ void obs_kernel(BA b, int mode) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  const int N = b.n_obs + b.n_lobs;
  if (o >= N) return;
  if ((mode == kModeLinearize || mode == kModeDecide) && b.done()) return;
  const bool cand = mode == kModeDecide;
  const bool jac = mode == kModeLinearize;
  const float* poses = cand ? b.at<float>(kCPoses) : b.at<float>(kPoses);
  float r[2], Jc[2][6];
  float s, chi2, w;
  if (o < b.n_obs) {
    const float* pts = cand ? b.at<float>(kCPts) : b.at<float>(kPts);
    const float* P = poses + b.at<int>(kObsKf)[o] * 12;
    const float* X = pts + b.at<int>(kObsPt)[o] * 3;
    Proj q;
    float Xb[3];
    if (b.body)
      project_body(b, P, X, jac, q, Xb);
    else
      project(b, P, X, jac, q);
    const float* uv = b.at<float>(kObsUv) + o * 2;
    s = sqrtf(b.at<float>(kObsIs2)[o]);
    r[0] = (q.u - uv[0]) * s;
    r[1] = (q.v - uv[1]) * s;
    chi2 = r[0] * r[0] + r[1] * r[1];
    w = huber(b, chi2, b.at<uint8_t>(kMask)[o] != 0);
    if (jac) {
      float Jl[2][3];
      for (int d = 0; d < 2; ++d) {
        if (b.body) {
          body_rows(b, q.J[d], P, Xb, Jc[d], Jl[d]);
        } else {
          pose_row(q.J[d], q.pc, Jc[d]);
          point_row(q.J[d], P, Jl[d]);
        }
        for (int i = 0; i < 6; ++i) Jc[d][i] *= s;
        for (int i = 0; i < 3; ++i) Jl[d][i] *= s;
      }
      write_blocks<3>(w, r, Jc, Jl, b.at<float>(kObsC) + o * 27,
                      b.at<float>(kPL) + o * 9, b.at<float>(kPW) + o * 18);
    }
  } else {
    const int k = o - b.n_obs;
    const float* lns = cand ? b.at<float>(kCLns) : b.at<float>(kLns);
    const float* P = poses + b.at<int>(kLobsKf)[k] * 12;
    const float* L = lns + b.at<int>(kLobsLn)[k] * 6;
    const float* l = b.at<float>(kLobsEq) + k * 3;
    s = sqrtf(b.at<float>(kLobsIs2)[k]);
    float Jl[2][6];
    for (int e = 0; e < 2; ++e) {
      Proj q;
      float Xb[3];
      if (b.body)
        project_body(b, P, L + 3 * e, jac, q, Xb);
      else
        project(b, P, L + 3 * e, jac, q);
      r[e] = ((l[0] * q.u + l[1] * q.v) + l[2]) * s;
      if (jac) {
        float jr[3], jp[3];
        for (int c = 0; c < 3; ++c) jr[c] = l[0] * q.J[0][c] + l[1] * q.J[1][c];
        if (b.body) {
          body_rows(b, jr, P, Xb, Jc[e], jp);
        } else {
          pose_row(jr, q.pc, Jc[e]);
          point_row(jr, P, jp);
        }
        for (int c = 0; c < 3; ++c) {
          Jl[e][3 * e + c] = jp[c] * s;
          Jl[e][3 * (1 - e) + c] = 0.f;
        }
        for (int i = 0; i < 6; ++i) Jc[e][i] *= s;
      }
    }
    chi2 = r[0] * r[0] + r[1] * r[1];
    w = huber(b, chi2, b.at<uint8_t>(kMaskL)[k] != 0);
    if (jac)
      write_blocks<6>(w, r, Jc, Jl, b.at<float>(kObsC) + o * 27,
                      b.at<float>(kLL) + k * 27, b.at<float>(kLW) + k * 36);
  }
  b.at<float>(kChi2)[o] = chi2;
  b.at<float>(kWChi2)[o] = w * chi2;
}

// one thread per (segment, entry): keyframe blocks (27 = 21 + 6), point
// blocks (9 = 6 + 3), line blocks (27), each summed in observation order
__global__ void reduce_kernel(BA b) {
  if (b.done()) return;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int nk = b.n_kf * 27, np = b.n_pt * 9, nl = b.n_ln * 27;
  const float* src;
  const int *order, *start;
  int seg, e, stride;
  float* dst;
  if (t < nk) {
    seg = t / 27;
    e = t % 27;
    src = b.at<float>(kObsC);
    stride = 27;
    order = b.at<int>(kKfOrder);
    start = b.at<int>(kKfStart);
    dst = b.at<float>(kHcc);
  } else if ((t -= nk) < np) {
    seg = t / 9;
    e = t % 9;
    src = b.at<float>(kPL);
    stride = 9;
    order = b.at<int>(kPtOrder);
    start = b.at<int>(kPtStart);
    dst = b.at<float>(kHpt);
  } else if ((t -= np) < nl) {
    seg = t / 27;
    e = t % 27;
    src = b.at<float>(kLL);
    stride = 27;
    order = b.at<int>(kLnOrder);
    start = b.at<int>(kLnStart);
    dst = b.at<float>(kHln);
  } else {
    return;
  }
  float acc = 0.f;
  for (int i = start[seg]; i < start[seg + 1]; ++i)
    acc += src[order[i] * stride + e];
  dst[seg * stride + e] = acc;
}

constexpr int kRedThreads = 1024;

__device__ float block_sum(const float* x, int n, float* sh) {
  float a = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) a += x[i];
  sh[threadIdx.x] = a;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  const float r = sh[0];
  __syncthreads();
  return r;
}

__global__ void cost_kernel(BA b, int mode) {
  __shared__ float sh[kRedThreads];
  float* ctrl = b.at<float>(kCtrl);
  if (mode == kModeDecide && ctrl[cDone] != 0.f) return;
  const float* wchi2 = b.at<float>(kWChi2);
  const float sp = block_sum(wchi2, b.n_obs, sh);
  const float sl = block_sum(wchi2 + b.n_obs, b.n_lobs, sh);
  if (threadIdx.x != 0) return;
  const float cost = b.body ? (sp + sl) + b.at<float>(kCCost)[0] : sp + sl;
  if (mode == kModeInit) {
    ctrl[cLam] = b.lam0;
    ctrl[cCost] = cost;
    ctrl[cNewCost] = cost;
    ctrl[cDone] = 0.f;
    ctrl[cIters] = 0.f;
    ctrl[cAccept] = 0.f;
    ctrl[cAccepted] = 0.f;
  } else if (mode == kModeDecide) {
    const float prev = ctrl[cCost];
    const bool accept = cost < prev;
    const float rel = fabsf(cost - prev) / fmaxf(prev, 1e-20f);
    const float lam = accept ? ctrl[cLam] * 0.5f : ctrl[cLam] * 4.f;
    ctrl[cLam] = fminf(fmaxf(lam, 1e-8f), 1e4f);
    ctrl[cNewCost] = cost;
    if (accept) ctrl[cCost] = cost;
    ctrl[cAccept] = accept ? 1.f : 0.f;
    ctrl[cAccepted] += accept ? 1.f : 0.f;
    ctrl[cIters] += 1.f;
    if (rel < b.early_tol) ctrl[cDone] = 1.f;
  } else {
    ctrl[cNewCost] = cost;
  }
}

// accepted candidate -> state
__global__ void accept_kernel(BA b) {
  if (b.at<float>(kCtrl)[cAccept] == 0.f) return;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int a = b.n_kf * 12, c = b.n_pt * 3, d = b.n_ln * 6;
  if (t < a) {
    b.at<float>(kPoses)[t] = b.at<float>(kCPoses)[t];
  } else if ((t -= a) < c) {
    b.at<float>(kPts)[t] = b.at<float>(kCPts)[t];
  } else if ((t -= c) < d) {
    b.at<float>(kLns)[t] = b.at<float>(kCLns)[t];
  } else if (b.body && (t -= d) < b.n_kf * 9) {
    b.at<float>(kKfX)[t] = b.at<float>(kCKfX)[t];
  }
}

// new inlier masks from the state's chi2 (between rounds)
__global__ void regate_kernel(BA b) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  const float chi2 = o < b.n_obs + b.n_lobs ? b.at<float>(kChi2)[o] : 0.f;
  if (o < b.n_obs) {
    b.at<uint8_t>(kMask)[o] = b.at<uint8_t>(kObsValid)[o] && chi2 < b.chi2_th;
  } else if (o < b.n_obs + b.n_lobs) {
    const int k = o - b.n_obs;
    b.at<uint8_t>(kMaskL)[k] =
        b.at<uint8_t>(kLobsValid)[k] && chi2 < b.chi2_th;
  }
}

inline int blocks(int n, int t) { return (n + t - 1) / t; }

}  // namespace

PLVIO_API int ba_linearize(void* const* ptrs, const int* ints,
                           const float* flts, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BA b = make_ba(ptrs, ints, flts);
  const int N = b.n_obs + b.n_lobs;
  if (mode < 0 || mode > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (N > 0) obs_kernel<<<blocks(N, 128), 128, 0, s>>>(b, mode);
  if (mode == kModeLinearize) {
    const int n = b.n_kf * 27 + b.n_pt * 9 + b.n_ln * 27;
    reduce_kernel<<<blocks(n, 128), 128, 0, s>>>(b);
  } else {
    cost_kernel<<<1, kRedThreads, 0, s>>>(b, mode);
    if (mode == kModeDecide) {
      const int n = b.n_kf * (b.body ? 21 : 12) + b.n_pt * 3 + b.n_ln * 6;
      accept_kernel<<<blocks(n, 256), 256, 0, s>>>(b);
    } else if (mode == kModeRegate && N > 0) {
      regate_kernel<<<blocks(N, 256), 256, 0, s>>>(b);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
