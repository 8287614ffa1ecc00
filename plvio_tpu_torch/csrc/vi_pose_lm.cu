// vi_pose_lm — the VI frame's 30-DoF pose optimization in one launch:
// the current body state (pose_wb, v, bg, ba) against the previous one
// through the body-frame reprojection edges, one 9-dim inertial edge, the
// two bias random walks and the 15-DoF marginalization prior on the
// previous state; rounds x <= iters Levenberg-Marquardt steps with early
// exit and chi2 re-gating between rounds; then the next frame's prior, the
// previous state marginalized out of the 30x30 information.
//
// Replaces plvio_tpu/models/kernels.py `make_vi_pose_optimizer` (:932,
// mono) running on plvio_tpu/solver/engine.py `Problem` (:355, :452) and
// `optimize` (:624) with the residuals of solver/residuals.py (:248, :318,
// :466, :474).  The JAX version linearizes each edge family by vmapped
// jacfwd, assembles the 30x30 system by one-hot matmuls and scatters, runs
// a while_loop of LM steps and an eigh.
//
// What bounds it on the H100: latency.  The iterations are sequential and
// each needs a reduction over all 2048 point edges (~150 flops each) before
// a 30x30 solve; the work per iteration is ~0.5 MFLOP, the inputs ~60 KB.
//
// Design: one persistent block of 512 threads runs everything; the states,
// the 30x30 system and one gate byte per edge live in shared memory, so no
// step leaves the chip and the host never synchronises.  Each thread
// accumulates the 21 + 6 entries of the 6x6 point block and its cost over
// its edges with the analytic 2x6 Jacobian w.r.t. [dp, dtheta] (whitened
// by sqrt(is2), Huber weight w = min(1, delta/sqrt(chi2)) on the whitened
// chi2, as engine.py:345-351); warp shuffles and one pass over per-warp
// partials reduce them.  Thread 0 adds the inertial edge (analytic 9x24
// Jacobian, whitened by L^T of chol(imu_info)), the random walks and the
// prior (whitened by L^T of chol(prior_info)), damps the diagonal by
// diag * lambda + 1e-6, freezes the previous state's rows when there is no
// prior, solves by a 30x30 Cholesky, retracts, and decides accept/reject,
// lambda and the early exit (|dcost|/cost < 1e-2) exactly as engine.py
// does.  A factorization that fails gives NaN, as the reference's
// Cholesky does, so a non-definite carried prior poisons the cost the same
// way.  The marginalization's pseudo-inverse comes from a cyclic Jacobi
// eigendecomposition of the 15x15 block, run by one warp.
#include "inertial.cuh"

namespace {

using namespace plv;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 28;          // 21 (H6 upper) + 6 (g6) + 1 (cost)
constexpr float kChi2 = 5.991f;

struct St {
  float R[9], p[3], v[3], bg[3], ba[3];
};

struct Prior {
  float R0[9], p0[3], v0[3], bg0[3], ba0[3];
};

struct Shared {
  St S[2], Sn[2];
  Pre pre;
  Prior prior;
  float L_imu[81], L_pri[225], rw_s[6], Rcb[9], tcb[3];
  float H[900], g[30], dense_cost;
  float red[kWarps][kAcc], acc[kAcc];
  float A[225], V[225];            // Jacobi workspace
  float Hd[900], Lc[900], J[225];  // thread 0's solve and Jacobians
  float lam, cost_prev;
  int done;
};

struct Params {
  const float* state;
  const float* uv;
  const float* X;
  const uint8_t* valid;
  const float* is2;
  int cap, have_prior, rounds, iters;
  float fx, fy, cx, cy, gravity, delta;
  float* out;
  uint8_t* inlier;
  int* n_inl;
};

// ------------------------------------------------------------ point edges
struct PtEval {
  float r[2], chi2, pc[3], Xb[3], s;
};

__device__ __forceinline__ void point_eval(const Params& p, const Shared& sh,
                                           const St& S, int k, PtEval& e) {
  const float* X = p.X + 3 * k;
  const float d[3] = {X[0] - S.p[0], X[1] - S.p[1], X[2] - S.p[2]};
  mtv3(S.R, d, e.Xb);
  mv3(sh.Rcb, e.Xb, e.pc);
  for (int i = 0; i < 3; ++i) e.pc[i] = e.pc[i] + sh.tcb[i];
  const float z = fmaxf(e.pc[2], 1e-4f);
  e.r[0] = p.fx * e.pc[0] / z + p.cx - p.uv[2 * k];
  e.r[1] = p.fy * e.pc[1] / z + p.cy - p.uv[2 * k + 1];
  e.s = sqrtf(p.is2[k]);
  const float a = e.r[0] * e.s, b = e.r[1] * e.s;
  e.chi2 = a * a + b * b;
}

__device__ __forceinline__ float huber_w(const Params& p, float chi2,
                                         bool gate) {
  const float w = fminf(1.f, p.delta / sqrtf(fmaxf(chi2, 1e-18f)));
  return gate ? w : 0.f;
}

// block: sum over edges of (H6 upper, g6, cost) (jac) or of cost alone
__device__ void point_pass(const Params& p, Shared& sh, const St& S,
                           const uint8_t* gate, bool jac) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float acc[kAcc];
#pragma unroll
  for (int q = 0; q < kAcc; ++q) acc[q] = 0.f;
  for (int k = tid; k < p.cap; k += kThreads) {
    PtEval e;
    point_eval(p, sh, S, k, e);
    const float w = huber_w(p, e.chi2, gate[k] != 0);
    acc[27] += w * e.chi2;
    if (!jac || w == 0.f) continue;
    const float z = fmaxf(e.pc[2], 1e-4f);
    const float iz = 1.f / z;
    const float dz = e.pc[2] > 1e-4f ? 1.f : 0.f;
    const float Jpi[6] = {p.fx * iz, 0.f, -p.fx * e.pc[0] * iz * iz * dz,
                          0.f, p.fy * iz, -p.fy * e.pc[1] * iz * iz * dz};
    float J[2][6];
    for (int row = 0; row < 2; ++row) {
      float JR[3];                                     // Jpi_row Rcb
      for (int c = 0; c < 3; ++c)
        JR[c] = Jpi[3 * row] * sh.Rcb[c] + Jpi[3 * row + 1] * sh.Rcb[3 + c]
                + Jpi[3 * row + 2] * sh.Rcb[6 + c];
      for (int c = 0; c < 3; ++c)                      // -JR R^T
        J[row][c] = -(JR[0] * S.R[3 * c] + JR[1] * S.R[3 * c + 1]
                      + JR[2] * S.R[3 * c + 2]);
      // JR hat(Xb)
      J[row][3] = JR[1] * e.Xb[2] - JR[2] * e.Xb[1];
      J[row][4] = JR[2] * e.Xb[0] - JR[0] * e.Xb[2];
      J[row][5] = JR[0] * e.Xb[1] - JR[1] * e.Xb[0];
    }
    for (int row = 0; row < 2; ++row) {
      float Jw[6];
      const float rw = e.r[row] * e.s;
      for (int c = 0; c < 6; ++c) Jw[c] = J[row][c] * e.s;
      int q = 0;
      for (int i = 0; i < 6; ++i) {
        const float wi = w * Jw[i];
        for (int j = i; j < 6; ++j) acc[q++] += wi * Jw[j];
        acc[21 + i] -= wi * rw;
      }
    }
  }
  const int n0 = jac ? 0 : 27;
  for (int q = n0; q < kAcc; ++q) {
    float v = acc[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) sh.red[warp][q] = v;
  }
  __syncthreads();
  if (tid >= n0 && tid < kAcc) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += sh.red[w][tid];
    sh.acc[tid] = s;
  }
  __syncthreads();
}

// ------------------------------------------------ dense terms (thread 0)
// add one whitened term: rows r_w [rd], Jacobian J_w [rd][nc] whose column
// c goes to H index col[c]
__device__ void add_term(Shared& sh, int rd, int nc, const int* col,
                         const float* r_w, const float* J_w, float w,
                         bool jac) {
  float chi2 = 0.f;
  for (int d = 0; d < rd; ++d) chi2 += r_w[d] * r_w[d];
  sh.dense_cost += w * chi2;
  if (!jac) return;
  for (int a = 0; a < nc; ++a) {
    float ga = 0.f;
    for (int d = 0; d < rd; ++d) ga += J_w[d * nc + a] * r_w[d];
    sh.g[col[a]] -= w * ga;
    for (int b = 0; b < nc; ++b) {
      float h = 0.f;
      for (int d = 0; d < rd; ++d) h += J_w[d * nc + a] * J_w[d * nc + b];
      sh.H[col[a] * 30 + col[b]] += w * h;
    }
  }
}

__device__ void dense_terms(const Params& p, Shared& sh, const St* S,
                            bool jac) {
  sh.dense_cost = 0.f;
  const Pre& q = sh.pre;
  // ---- inertial: (pose0, v0, bg1, ba1, pose1, v1) --------------------
  {
    const St& A = S[0];
    const St& B = S[1];
    float r[9];
    float* J = sh.J;
    inertial_edge(A.R, A.p, A.v, B.bg, B.ba, B.R, B.p, B.v, q, p.gravity,
                  jac, r, J);
    whiten(sh.L_imu, 9, 24, r, jac ? J : nullptr);
    const int col[24] = {0, 1, 2, 3, 4, 5, 12, 13, 14, 21, 22, 23,
                         27, 28, 29, 6, 7, 8, 9, 10, 11, 15, 16, 17};
    add_term(sh, 9, 24, col, r, J, 1.f, jac);
  }
  // ---- bias random walks ---------------------------------------------
  for (int b = 0; b < 2; ++b) {
    const float* x0 = b == 0 ? S[0].bg : S[0].ba;
    const float* x1 = b == 0 ? S[1].bg : S[1].ba;
    const int o = b == 0 ? 18 : 24;
    float r[3], J[18];
    for (int i = 0; i < 3; ++i) {
      const float s = sqrtf(sh.rw_s[3 * b + i]);
      r[i] = (x1[i] - x0[i]) * s;
      for (int c = 0; c < 6; ++c)
        J[i * 6 + c] = (c == i) ? -s : (c == i + 3 ? s : 0.f);
    }
    const int col[6] = {o, o + 1, o + 2, o + 3, o + 4, o + 5};
    add_term(sh, 3, 6, col, r, J, 1.f, jac);
  }
  // ---- prior on the previous state ------------------------------------
  {
    const St& A = S[0];
    const Prior& pr = sh.prior;
    float E[9], er[3];
    mul3tn(pr.R0, A.R, E);
    so3_log(E, er);
    float r[15];
    for (int i = 0; i < 3; ++i) {
      r[i] = er[i];
      r[3 + i] = A.p[i] - pr.p0[i];
      r[6 + i] = A.v[i] - pr.v0[i];
      r[9 + i] = A.bg[i] - pr.bg0[i];
      r[12 + i] = A.ba[i] - pr.ba0[i];
    }
    float* J = sh.J;
    if (jac) {
      float Jri[9];
      so3_jr_inv(er, Jri);
      for (int i = 0; i < 225; ++i) J[i] = 0.f;
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) J[i * 15 + 3 + j] = Jri[3 * i + j];
        J[(3 + i) * 15 + i] = 1.f;
      }
      for (int i = 6; i < 15; ++i) J[i * 15 + i] = 1.f;
    }
    whiten(sh.L_pri, 15, 15, r, jac ? J : nullptr);
    const int col[15] = {0, 1, 2, 3, 4, 5, 12, 13, 14, 18, 19, 20,
                         24, 25, 26};
    add_term(sh, 15, 15, col, r, J, p.have_prior ? 1.f : 0.f, jac);
  }
}

// H, g (undamped) and the cost at S
__device__ void linearize(const Params& p, Shared& sh, const St* S,
                          const uint8_t* gate) {
  for (int i = threadIdx.x; i < 900; i += kThreads) sh.H[i] = 0.f;
  if (threadIdx.x < 30) sh.g[threadIdx.x] = 0.f;
  __syncthreads();
  point_pass(p, sh, S[1], gate, true);
  if (threadIdx.x == 0) {
    int q = 0;
    for (int i = 0; i < 6; ++i)
      for (int j = i; j < 6; ++j) {
        sh.H[(6 + i) * 30 + 6 + j] += sh.acc[q];
        if (j != i) sh.H[(6 + j) * 30 + 6 + i] += sh.acc[q];
        ++q;
      }
    for (int i = 0; i < 6; ++i) sh.g[6 + i] += sh.acc[21 + i];
    dense_terms(p, sh, S, true);
    sh.dense_cost += sh.acc[27];
  }
  __syncthreads();
}

__device__ float cost(const Params& p, Shared& sh, const St* S,
                      const uint8_t* gate) {
  point_pass(p, sh, S[1], gate, false);
  if (threadIdx.x == 0) {
    dense_terms(p, sh, S, false);
    sh.dense_cost += sh.acc[27];
  }
  __syncthreads();
  const float c = sh.dense_cost;
  __syncthreads();
  return c;
}

// damped, frozen 30x30 solve and the retraction into sh.Sn (thread 0)
__device__ void solve_retract(const Params& p, Shared& sh) {
  float* Hd = sh.Hd;
  float* L = sh.Lc;
  float free_[30];
  for (int i = 0; i < 30; ++i) {
    // previous-state rows: pose 0..5, vel 12..14, bg 18..20, ba 24..26
    const bool prev = i < 6 || (i >= 12 && i < 15) || (i >= 18 && i < 21)
                      || (i >= 24 && i < 27);
    free_[i] = (prev && !p.have_prior) ? 0.f : 1.f;
  }
  for (int i = 0; i < 30; ++i)
    for (int j = 0; j < 30; ++j) {
      float h = sh.H[i * 30 + j];
      if (i == j) h = h + (h * sh.lam + 1e-6f);
      h = h * free_[i] * free_[j];
      if (i == j) h = h + (1.f - free_[i]);
      Hd[i * 30 + j] = h;
    }
  // Cholesky solve (NaN if not definite)
  cholesky(Hd, L, 30);
  float y[30], dx[30];
  for (int i = 0; i < 30; ++i) {
    float s = sh.g[i] * free_[i];
    for (int k = 0; k < i; ++k) s -= L[i * 30 + k] * y[k];
    y[i] = s / L[i * 30 + i];
  }
  for (int i = 29; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 30; ++k) s -= L[k * 30 + i] * dx[k];
    dx[i] = s / L[i * 30 + i];
  }
  for (int i = 0; i < 30; ++i) dx[i] = dx[i] * free_[i];
  for (int s = 0; s < 2; ++s) {
    const St& A = sh.S[s];
    St& B = sh.Sn[s];
    float Ed[9], t9[9];
    so3_exp(dx + 6 * s + 3, Ed);
    mul3(A.R, Ed, t9);
    so3_normalize(t9, B.R);
    for (int i = 0; i < 3; ++i) {
      B.p[i] = A.p[i] + dx[6 * s + i];
      B.v[i] = A.v[i] + dx[12 + 3 * s + i];
      B.bg[i] = A.bg[i] + dx[18 + 3 * s + i];
      B.ba[i] = A.ba[i] + dx[24 + 3 * s + i];
    }
  }
}

// cyclic Jacobi eigendecomposition of the symmetric 15x15 sh.A by one warp:
// A <- V^T A V (diagonal), V <- V P
__device__ void jacobi15(Shared& sh) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < 225; i += 32) sh.V[i] = (i % 16 == 0) ? 1.f : 0.f;
  __syncwarp();
  for (int sweep = 0; sweep < 12; ++sweep) {
    for (int pp = 0; pp < 14; ++pp)
      for (int qq = pp + 1; qq < 15; ++qq) {
        const float apq = sh.A[pp * 15 + qq];
        const float app = sh.A[pp * 15 + pp], aqq = sh.A[qq * 15 + qq];
        __syncwarp();
        if (!(fabsf(apq) > 1e-9f * (fabsf(app) + fabsf(aqq))))
          continue;                          // warp-uniform; NaN skips
        const float th = (aqq - app) / (2.f * apq);
        const float t = (th >= 0.f ? 1.f : -1.f)
                        / (fabsf(th) + sqrtf(th * th + 1.f));
        const float c = 1.f / sqrtf(t * t + 1.f), s = t * c;
        if (lane < 15) {                              // columns p, q
          const float akp = sh.A[lane * 15 + pp], akq = sh.A[lane * 15 + qq];
          sh.A[lane * 15 + pp] = c * akp - s * akq;
          sh.A[lane * 15 + qq] = s * akp + c * akq;
          const float vkp = sh.V[lane * 15 + pp], vkq = sh.V[lane * 15 + qq];
          sh.V[lane * 15 + pp] = c * vkp - s * vkq;
          sh.V[lane * 15 + qq] = s * vkp + c * vkq;
        }
        __syncwarp();
        if (lane < 15) {                              // rows p, q
          const float apk = sh.A[pp * 15 + lane], aqk = sh.A[qq * 15 + lane];
          sh.A[pp * 15 + lane] = c * apk - s * aqk;
          sh.A[qq * 15 + lane] = s * apk + c * aqk;
        }
        __syncwarp();
      }
  }
}

__constant__ int kPrev[15] = {0, 1, 2, 3, 4, 5, 12, 13, 14, 18, 19, 20,
                              24, 25, 26};
__constant__ int kCur[15] = {6, 7, 8, 9, 10, 11, 15, 16, 17, 21, 22, 23,
                             27, 28, 29};

__global__ void __launch_bounds__(kThreads) vi_pose_lm_kernel(Params p) {
  extern __shared__ uint8_t s_gate[];
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const float* st = p.state;

  if (tid == 0) {
    // states: [0] previous, [1] current; both biases start at (bg0, ba0)
    for (int s = 0; s < 2; ++s) {
      const float* P = st + (s == 0 ? 21 : 0);
      const float* v = st + (s == 0 ? 33 : 12);
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) sh.S[s].R[3 * i + j] = P[4 * i + j];
        sh.S[s].p[i] = P[4 * i + 3];
        sh.S[s].v[i] = v[i];
        sh.S[s].bg[i] = st[15 + i];
        sh.S[s].ba[i] = st[18 + i];
      }
    }
    load_pre(st + 36, sh.pre);
    cholesky(st + 103, sh.L_imu, 9);
    for (int i = 0; i < 6; ++i) sh.rw_s[i] = st[184 + i];
    const float* pc = st + 190;
    for (int i = 0; i < 9; ++i) sh.prior.R0[i] = pc[i];
    for (int i = 0; i < 3; ++i) {
      sh.prior.p0[i] = pc[9 + i];
      sh.prior.v0[i] = pc[12 + i];
      sh.prior.bg0[i] = pc[15 + i];
      sh.prior.ba0[i] = pc[18 + i];
    }
    if (p.have_prior) {
      cholesky(st + 211, sh.L_pri, 15);
    } else {                                  // prior_info_safe = I
      for (int i = 0; i < 225; ++i) sh.L_pri[i] = (i % 16 == 0) ? 1.f : 0.f;
    }
    for (int i = 0; i < 9; ++i) sh.Rcb[i] = st[436 + i];
    for (int i = 0; i < 3; ++i) sh.tcb[i] = st[445 + i];
  }
  for (int k = tid; k < p.cap; k += kThreads) s_gate[k] = p.valid[k];
  __syncthreads();

  for (int round = 0; round < p.rounds; ++round) {
    float c0 = cost(p, sh, sh.S, s_gate);
    if (tid == 0) {
      sh.cost_prev = c0;
      sh.lam = 1e-4f;
      sh.done = 0;
    }
    __syncthreads();
    for (int it = 0; it < p.iters; ++it) {
      linearize(p, sh, sh.S, s_gate);
      if (tid == 0) solve_retract(p, sh);
      __syncthreads();
      const float nc = cost(p, sh, sh.Sn, s_gate);
      if (tid == 0) {
        const float prev = sh.cost_prev;
        const bool acc = nc < prev;
        if (acc) { sh.S[0] = sh.Sn[0]; sh.S[1] = sh.Sn[1]; }
        const float lam = acc ? sh.lam * 0.5f : sh.lam * 4.f;
        sh.lam = fminf(fmaxf(lam, 1e-8f), 1e4f);
        // NaN-propagating max(prev, 1e-20), as jnp.maximum
        const float den = (prev != prev) ? prev : fmaxf(prev, 1e-20f);
        const float rel = fabsf(nc - prev) / den;
        sh.cost_prev = acc ? nc : prev;
        sh.done = rel < 1e-2f;
      }
      __syncthreads();
      const int done = sh.done;
      __syncthreads();
      if (done) break;
    }
    // re-gate on the whitened chi2 at the round's solution
    for (int k = tid; k < p.cap; k += kThreads) {
      PtEval e;
      point_eval(p, sh, sh.S[1], k, e);
      s_gate[k] = p.valid[k] && (e.chi2 < kChi2);
    }
    __syncthreads();
  }

  // ---- inliers -----------------------------------------------------------
  int cnt = 0;
  for (int k = tid; k < p.cap; k += kThreads) {
    p.inlier[k] = s_gate[k];
    cnt += s_gate[k];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  if ((tid & 31) == 0) sh.red[tid >> 5][0] = __int_as_float(cnt);
  __syncthreads();
  if (tid == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += __float_as_int(sh.red[w][0]);
    *p.n_inl = s;
  }
  __syncthreads();

  // ---- next prior: one more linearization, then marginalize ------------
  linearize(p, sh, sh.S, s_gate);
  if (tid < 225) {
    const int i = tid / 15, j = tid % 15;
    sh.A[tid] = 0.5f * (sh.H[kPrev[i] * 30 + kPrev[j]]
                        + sh.H[kPrev[j] * 30 + kPrev[i]]);
  }
  __syncthreads();
  if (p.have_prior && tid < 32) jacobi15(sh);
  __syncthreads();
  float h = 0.f;
  if (tid < 225) {
    const int i = tid / 15, j = tid % 15;
    if (p.have_prior) {
      float wmax = 0.f;
      bool fin = true;
      for (int k = 0; k < 15; ++k) {
        const float w = sh.A[k * 16];
        wmax = fmaxf(wmax, fabsf(w));
        fin = fin && (w == w);
      }
      const float thr = 1e-6f * fmaxf(wmax, 1e-12f);
      // (Hpc^T Hpp^+ Hpc)_ij = sum_k (V^T Hpc)_ki w_inv_k (V^T Hpc)_kj
      float m = 0.f;
      for (int k = 0; k < 15; ++k) {
        const float w = sh.A[k * 16];
        const float winv = w > thr ? 1.f / w : 0.f;
        float ui = 0.f, uj = 0.f;
        for (int a = 0; a < 15; ++a) {
          const float vak = sh.V[a * 15 + k];
          ui += vak * sh.H[kPrev[a] * 30 + kCur[i]];
          uj += vak * sh.H[kPrev[a] * 30 + kCur[j]];
        }
        m += ui * winv * uj;
      }
      h = fin ? sh.H[kCur[i] * 30 + kCur[j]] - m
              : __int_as_float(0x7fc00000);
    } else {
      h = sh.H[kCur[i] * 30 + kCur[j]];
    }
  }
  __syncthreads();                 // every read of A and V done
  if (tid < 225) sh.A[tid] = h;    // reuse A for the unsymmetrized H15
  __syncthreads();
  if (tid < 225) {
    const int i = tid / 15, j = tid % 15;
    p.out[21 + tid] = 0.5f * (sh.A[i * 15 + j] + sh.A[j * 15 + i]);
  }
  if (tid < 12)
    p.out[tid] = tid % 4 == 3 ? sh.S[1].p[tid / 4]
                              : sh.S[1].R[(tid / 4) * 3 + tid % 4];
  if (tid < 3) {
    p.out[12 + tid] = sh.S[1].v[tid];
    p.out[15 + tid] = sh.S[1].bg[tid];
    p.out[18 + tid] = sh.S[1].ba[tid];
  }
}

}  // namespace

PLVIO_API int vi_pose_lm(const void* state, const void* uv, const void* X,
                         const void* valid, const void* is2, int cap,
                         int have_prior, int rounds, int iters, float fx,
                         float fy, float cx, float cy, float gravity,
                         float delta, void* out, void* inlier, void* n_inl,
                         void* stream) {
  Params p{static_cast<const float*>(state), static_cast<const float*>(uv),
           static_cast<const float*>(X), static_cast<const uint8_t*>(valid),
           static_cast<const float*>(is2), cap, have_prior, rounds, iters,
           fx, fy, cx, cy, gravity, delta, static_cast<float*>(out),
           static_cast<uint8_t*>(inlier), static_cast<int*>(n_inl)};
  const size_t smem = size_t(cap);
  const size_t static_smem = sizeof(Shared);
  if (smem + static_smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        vi_pose_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  vi_pose_lm_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
