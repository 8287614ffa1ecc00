// vi_pose_lm — the VI frame's 30-DoF pose optimization in one launch:
// the current body state (pose_wb, v, bg, ba) against the previous one
// through the body-frame reprojection edges, one 9-dim inertial edge, the
// two bias random walks and the 15-DoF marginalization prior on the
// previous state; rounds x <= iters Levenberg-Marquardt steps with early
// exit and chi2 re-gating between rounds; then the next frame's prior, the
// previous state marginalized out of the 30x30 information.
//
// Replaces plvio_tpu/models/kernels.py `make_vi_pose_optimizer` (:932,
// mono, and its IMU_STEREO flavour bf > 0: the rows with u_R > 0 form a
// separate 3-row stereo term, residuals.py:266, with the Huber delta
// sqrt(7.815) and re-gated at 7.815, the mono term keeping the others)
// running on plvio_tpu/solver/engine.py `Problem` (:355, :452) and
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
// partials reduce them.  The dense terms are the inertial edge (analytic
// 9x24 Jacobian, whitened by L^T of chol(imu_info)), the random walks and
// the prior (whitened by L^T of chol(prior_info)); the solve damps the
// diagonal by diag * lambda + 1e-6, freezes the previous state's rows when
// there is no prior, factors the 30x30 system by Cholesky, retracts, and
// decides accept/reject, lambda and the early exit (|dcost|/cost < 1e-2)
// exactly as engine.py does.  A factorization that fails gives NaN, as the
// reference's Cholesky does, so a non-definite carried prior poisons the
// cost the same way.  The marginalization's pseudo-inverse comes from a
// cyclic Jacobi eigendecomposition of the 15x15 block, run by one warp.
//
// No serial tail on one thread: every output of the dense work has its own
// thread and keeps the sum order of a serial loop, so with --fmad=false
// the bits are those of the one-thread version.  Two warps beside the
// point passes' 16 evaluate the dense terms (the inertial edge on one, the
// random walks and the prior on the other, each by one lane) and whiten
// them a column a lane while the others run a cost's point pass; the
// terms at the accepted state are the next linearization's, so no
// linearization waits for them.  Each H and g entry is one thread that
// adds its terms in the engine's order (point block, stereo block,
// inertial, random walks, prior), each term's entry a sum over its rows
// in row order.  The 30x30 solve runs on one warp from registers, lane i
// holding row i (the Cholesky, the forward solve in column order, the
// back-substitution with each product on its lane and each sum in the
// one-thread order); the two states' retractions on two lanes.  An
// optional buffer gets the time by stage (%globaltimer stamps of thread
// 0).
//
// The stereo term is a second pass over the edges (the rows with u_R > 0;
// the mono pass then skips them), reduced and added to the system after
// the mono block and before the dense terms, in the engine's term order
// (reproj, stereo, inertial, random walks, prior).  Without u_R (bf = 0)
// the kernel runs the mono arithmetic unchanged, bit for bit.
#include "inertial.cuh"

namespace {

using namespace plv;

constexpr int kThreads = 512;          // the point passes' threads
constexpr int kWarps = kThreads / 32;
// two more warps evaluate the dense terms while the others run a cost's
// point pass: the inertial edge on one, the random walks and the prior on
// the other
constexpr int kWInert = kWarps, kWPrior = kWarps + 1;
constexpr int kBlock = kThreads + 64;
constexpr int kBlockWarps = kBlock / 32;
constexpr int kAcc = 28;          // 21 (H6 upper) + 6 (g6) + 1 (cost)
constexpr float kChi2 = 5.991f;
constexpr float kChi2Stereo = 7.815f;
// profile stages: point passes, dense terms, solve and retraction, the
// final linearization, Jacobi and marginalization, set-up, re-gating; the
// last counter is the number of LM iterations run
constexpr int kStages = 7;
enum { kPts, kDense, kSolve, kFinal, kMarg, kInit, kRegate };
// and, after the iterations, the parts' ns that overlap the stages: the
// inertial and the prior warps' evaluation and whitening, the solve's
// Cholesky, forward solve, back-substitution and retraction
constexpr int kParts = 8;

struct St {
  float R[9], p[3], v[3], bg[3], ba[3];
};

struct Prior {
  float R0[9], p0[3], v0[3], bg0[3], ba0[3];
};

// the dense terms at one state: whitened residuals and Jacobians (rows x
// columns) and each term's chi2
struct Dense {
  float ri[9], Ji[9 * 24];          // inertial
  float rb[2][3], Jb[2][3 * 6];     // random walks (bg, ba)
  float rp[15], Jp[15 * 15];        // prior
  float chi[4];                     // inertial, bg walk, ba walk, prior
};

struct Shared {
  St S[2], Sn[2];
  Pre pre;
  Prior prior;
  float L_imu[81], L_pri[225], rw_s[6], Rcb[9], tcb[3];
  float H[900], g[30];
  float red[kBlockWarps][kAcc], acc[kAcc];
  float A[225], V[225];            // Jacobi workspace
  float dx[30];
  Dense dn[2];                      // at S (dn[cur]) and at a trial
  float Jri[9];                     // the prior's inverse right Jacobian
  float lam, cost_prev, pt_cost, st_cost, cost;
  int done, cur;
  unsigned long long tacc[kStages], tlast;   // profile: ns by stage
  unsigned long long tpart[kParts];          // and by part
};

struct Params {
  const float* state;
  const float* uv;
  const float* X;
  const uint8_t* valid;
  const float* is2;
  const float* ur;        // [cap] stereo: u_R (<= 0 mono), or null
  int cap, have_prior, rounds, iters;
  float fx, fy, cx, cy, gravity, delta, bf, delta_s;
  float* out;
  uint8_t* inlier;
  int* n_inl;
  unsigned long long* prof;   // [kStages + 1 + kParts] or null
};

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// thread 0, with a profile buffer: the time since the last stamp goes to
// stage k
__device__ __forceinline__ void stamp(const Params& p, Shared& sh, int k) {
  if (p.prof != nullptr && threadIdx.x == 0) {
    const unsigned long long t = globaltimer();
    sh.tacc[k] += t - sh.tlast;
    sh.tlast = t;
  }
}

// the calling lane, with a profile buffer: the time since t goes to part
// k, and t moves on
__device__ __forceinline__ void part(const Params& p, Shared& sh, int k,
                                     unsigned long long& t) {
  if (p.prof != nullptr) {
    const unsigned long long now = globaltimer();
    sh.tpart[k] += now - t;
    t = now;
  }
}

// ------------------------------------------------------------ point edges
struct PtEval {
  float r[3], chi2, pc[3], Xb[3], s;
};

// the row's family: 1 for a stereo row (u_R given and > 0), else 0
__device__ __forceinline__ int family(const Params& p, int k) {
  return (p.ur != nullptr && p.ur[k] > 0.f) ? 1 : 0;
}

__device__ __forceinline__ void point_eval(const Params& p, const Shared& sh,
                                           const St& S, int k, PtEval& e,
                                           int fam = 0) {
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
  e.r[2] = 0.f;
  if (fam) {
    e.r[2] = (p.fx * e.pc[0] / z + p.cx - p.bf / z) - p.ur[k];
    const float c = e.r[2] * e.s;
    e.chi2 = e.chi2 + c * c;
  }
}

__device__ __forceinline__ float huber_w(float delta, float chi2,
                                         bool gate) {
  const float w = fminf(1.f, delta / sqrtf(fmaxf(chi2, 1e-18f)));
  return gate ? w : 0.f;
}

// block: sum over the edges of family fam (0 mono, 1 stereo) of (H6
// upper, g6, cost) (jac) or of cost alone
__device__ void point_pass(const Params& p, Shared& sh, const St& S,
                           const uint8_t* gate, bool jac, int fam) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float acc[kAcc];
#pragma unroll
  for (int q = 0; q < kAcc; ++q) acc[q] = 0.f;
  const int nr = fam ? 3 : 2;
  const float delta = fam ? p.delta_s : p.delta;
  // the dense warps (tid >= kThreads) take no edge
  for (int k = tid; k < p.cap && tid < kThreads; k += kThreads) {
    if (p.ur != nullptr && family(p, k) != fam) continue;
    PtEval e;
    point_eval(p, sh, S, k, e, fam);
    const float w = huber_w(delta, e.chi2, gate[k] != 0);
    acc[27] += w * e.chi2;
    if (!jac || w == 0.f) continue;
    const float z = fmaxf(e.pc[2], 1e-4f);
    const float iz = 1.f / z;
    const float dz = e.pc[2] > 1e-4f ? 1.f : 0.f;
    const float Jpi[9] = {p.fx * iz, 0.f, -p.fx * e.pc[0] * iz * iz * dz,
                          0.f, p.fy * iz, -p.fy * e.pc[1] * iz * iz * dz,
                          p.fx * iz, 0.f,
                          (-p.fx * e.pc[0] + p.bf) * iz * iz * dz};
    float J[3][6];
    for (int row = 0; row < nr; ++row) {
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
    for (int row = 0; row < nr; ++row) {
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
    if (lane == 0 && warp < kWarps) sh.red[warp][q] = v;
  }
  __syncthreads();
  if (tid >= n0 && tid < kAcc) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += sh.red[w][tid];
    sh.acc[tid] = s;
  }
  __syncthreads();
}

// ------------------------------------------------------------ dense terms
// H / g positions of each term's Jacobian columns (the engine's layout:
// pose 0..11, vel 12..17, bg 18..23, ba 24..29, the previous state first)
// and their inverse, -1 where the term has no column
__constant__ int kInertPos[30] = {0, 1, 2, 3, 4, 5, 15, 16, 17, 18, 19, 20,
                                  6, 7, 8, 21, 22, 23, -1, -1, -1, 9, 10, 11,
                                  -1, -1, -1, 12, 13, 14};
__constant__ int kPriorPos[30] = {0, 1, 2, 3, 4, 5, -1, -1, -1, -1, -1, -1,
                                  6, 7, 8, -1, -1, -1, 9, 10, 11, -1, -1, -1,
                                  12, 13, 14, -1, -1, -1};

// the inertial edge (pose0, v0, bg1, ba1, pose1, v1): residual and
// Jacobian, unwhitened
__device__ void inertial_term(const Params& p, const Shared& sh,
                              const St* S, Dense& d) {
  const St& A = S[0];
  const St& B = S[1];
  inertial_edge(A.R, A.p, A.v, B.bg, B.ba, B.R, B.p, B.v, sh.pre, p.gravity,
                true, d.ri, d.Ji);
}

// the bias random walks: residuals and Jacobians (whitened by their
// diagonal information)
__device__ void walk_terms(const Shared& sh, const St* S, Dense& d) {
  for (int b = 0; b < 2; ++b) {
    const float* x0 = b == 0 ? S[0].bg : S[0].ba;
    const float* x1 = b == 0 ? S[1].bg : S[1].ba;
    for (int i = 0; i < 3; ++i) {
      const float s = sqrtf(sh.rw_s[3 * b + i]);
      d.rb[b][i] = (x1[i] - x0[i]) * s;
      for (int c = 0; c < 6; ++c)
        d.Jb[b][i * 6 + c] = (c == i) ? -s : (c == i + 3 ? s : 0.f);
    }
  }
}

// the prior on the previous state: residual, unwhitened, and the inverse
// right Jacobian of its rotation (one lane)
__device__ void prior_term(const Shared& sh, const St* S, Dense& d,
                           float* Jri) {
  const St& A = S[0];
  const Prior& pr = sh.prior;
  float E[9], er[3];
  mul3tn(pr.R0, A.R, E);
  so3_log(E, er);
  for (int i = 0; i < 3; ++i) {
    d.rp[i] = er[i];
    d.rp[3 + i] = A.p[i] - pr.p0[i];
    d.rp[6 + i] = A.v[i] - pr.v0[i];
    d.rp[9 + i] = A.bg[i] - pr.bg0[i];
    d.rp[12 + i] = A.ba[i] - pr.ba0[i];
  }
  so3_jr_inv(er, Jri);
}

// entry k of the prior's Jacobian [15][15]: Jri in rows 0-2, columns 3-5,
// the identity from (3, 0) to (5, 2) and on the diagonal from row 6
__device__ __forceinline__ float prior_jac(const float* Jri, int k) {
  const int i = k / 15, c = k % 15;
  if (i < 3) return c >= 3 && c < 6 ? Jri[3 * i + c - 3] : 0.f;
  if (i < 6) return c == i - 3 ? 1.f : 0.f;
  return c == i ? 1.f : 0.f;
}

// J [N][NC] and r [N] whitened in place by L^T (L lower N x N) by one warp:
// each of the N (NC + 1) outputs on a lane, x_i = sum_{j >= i} L_ji x_j
// summed in j order as plv::whiten sums it, from the unwhitened values,
// then stored
template <int N, int NC>
__device__ __forceinline__ void warp_whiten(const float* L, float* J,
                                            float* r) {
  constexpr int kOut = N * (NC + 1), kPer = (kOut + 31) / 32;
  const int lane = threadIdx.x & 31;
  float y[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int o = lane + 32 * m;
    y[m] = 0.f;
    if (o < kOut) {
      const int i = o / (NC + 1), c = o % (NC + 1);
      const float* x = c < NC ? J + c : r;
      const int stride = c < NC ? NC : 1;
      float v = 0.f;
      for (int j = i; j < N; ++j) v += L[j * N + i] * x[j * stride];
      y[m] = v;
    }
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int o = lane + 32 * m;
    if (o < kOut) {
      const int i = o / (NC + 1), c = o % (NC + 1);
      (c < NC ? J[i * NC + c] : r[i]) = y[m];
    }
  }
}

__device__ __forceinline__ float sq_sum(const float* r, int n) {
  float c = 0.f;
  for (int d = 0; d < n; ++d) c += r[d] * r[d];
  return c;
}

// the dense terms at S into d, on the two dense warps while the others
// run a cost's point pass: the inertial edge on warp kWInert, the random
// walks and the prior on warp kWPrior, each evaluated by lane 0 (the
// prior's Jacobian filled by the lanes), whitened an entry a lane, then
// each term's chi2
__device__ void dense_warps(const Params& p, Shared& sh, const St* S,
                            Dense& d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned long long t = p.prof != nullptr ? globaltimer() : 0ull;
  if (warp == kWInert) {
    if (lane == 0) inertial_term(p, sh, S, d);
    __syncwarp();
    if (lane == 0) part(p, sh, 0, t);
    warp_whiten<9, 24>(sh.L_imu, d.Ji, d.ri);
    __syncwarp();
    if (lane == 0) {
      d.chi[0] = sq_sum(d.ri, 9);
      part(p, sh, 1, t);
    }
  } else if (warp == kWPrior) {
    if (lane == 0) {
      walk_terms(sh, S, d);
      prior_term(sh, S, d, sh.Jri);
    }
    __syncwarp();
    for (int k = lane; k < 225; k += 32) d.Jp[k] = prior_jac(sh.Jri, k);
    __syncwarp();
    if (lane == 0) part(p, sh, 2, t);
    warp_whiten<15, 15>(sh.L_pri, d.Jp, d.rp);
    __syncwarp();
    if (lane == 0) {
      d.chi[1] = sq_sum(d.rb[0], 3);
      d.chi[2] = sq_sum(d.rb[1], 3);
      d.chi[3] = sq_sum(d.rp, 15);
      part(p, sh, 3, t);
    }
  }
}

// a term's contribution to H entry (a, b) or, with b < 0, the sum for g:
// rows d in order over the whitened Jacobian J [rd][nc] (and residual r)
__device__ __forceinline__ float term_h(const float* J, int rd, int nc,
                                        int a, int b) {
  float h = 0.f;
  for (int d = 0; d < rd; ++d) h += J[d * nc + a] * J[d * nc + b];
  return h;
}
__device__ __forceinline__ float term_g(const float* J, const float* r,
                                        int rd, int nc, int a) {
  float ga = 0.f;
  for (int d = 0; d < rd; ++d) ga += J[d * nc + a] * r[d];
  return ga;
}

// H entry i (of 900) or, from 900, g entry i - 900: the dense terms added
// in the engine's order (inertial, bg walk, ba walk, prior)
__device__ void dense_entry(const Params& p, Shared& sh, const Dense& d,
                            int i) {
  const float wp = p.have_prior ? 1.f : 0.f;
  if (i < 900) {
    const int r = i / 30, c = i % 30;
    float h = sh.H[i];
    const int ar = kInertPos[r], ac = kInertPos[c];
    if (ar >= 0 && ac >= 0) h += 1.f * term_h(d.Ji, 9, 24, ar, ac);
    for (int b = 0; b < 2; ++b) {
      const int o = b == 0 ? 18 : 24;
      if (r >= o && r < o + 6 && c >= o && c < o + 6)
        h += 1.f * term_h(d.Jb[b], 3, 6, r - o, c - o);
    }
    const int pr = kPriorPos[r], pc = kPriorPos[c];
    if (pr >= 0 && pc >= 0) h += wp * term_h(d.Jp, 15, 15, pr, pc);
    sh.H[i] = h;
  } else {
    const int r = i - 900;
    float g = sh.g[r];
    const int ar = kInertPos[r];
    if (ar >= 0) g -= 1.f * term_g(d.Ji, d.ri, 9, 24, ar);
    for (int b = 0; b < 2; ++b) {
      const int o = b == 0 ? 18 : 24;
      if (r >= o && r < o + 6) g -= 1.f * term_g(d.Jb[b], d.rb[b], 3, 6,
                                                  r - o);
    }
    const int pr = kPriorPos[r];
    if (pr >= 0) g -= wp * term_g(d.Jp, d.rp, 15, 15, pr);
    sh.g[r] = g;
  }
}

// the reduced point block of sh.acc into H and g: entry t of the 6x6
// block (t < 36) or g (36 <= t < 42)
__device__ __forceinline__ void point_block_entry(Shared& sh, int t) {
  if (t < 36) {
    const int i = t / 6, j = t % 6;
    const int lo = min(i, j), hi = max(i, j);
    const int q = lo * 6 - lo * (lo - 1) / 2 + (hi - lo);  // upper index
    sh.H[(6 + i) * 30 + 6 + j] += sh.acc[q];
  } else if (t < 42) {
    sh.g[6 + t - 36] += sh.acc[21 + t - 36];
  }
}

// H, g (undamped) at S; d: the dense terms at S (the cost at S made them)
__device__ void linearize(const Params& p, Shared& sh, const St* S,
                          const uint8_t* gate, const Dense& d, int s_pt,
                          int s_dn) {
  const int tid = threadIdx.x;
  for (int i = tid; i < 900; i += kBlock) sh.H[i] = 0.f;
  if (tid < 30) sh.g[tid] = 0.f;
  point_pass(p, sh, S[1], gate, true, 0);
  stamp(p, sh, s_pt);
  if (tid >= 64 && tid < 64 + 42) point_block_entry(sh, tid - 64);
  if (p.ur != nullptr) {
    __syncthreads();
    stamp(p, sh, s_dn);
    point_pass(p, sh, S[1], gate, true, 1);
    stamp(p, sh, s_pt);
    if (tid >= 64 && tid < 64 + 42) point_block_entry(sh, tid - 64);
  }
  __syncthreads();
  for (int i = tid; i < 930; i += kBlock) dense_entry(p, sh, d, i);
  __syncthreads();
  stamp(p, sh, s_dn);
}

// the cost at S; the dense terms at S into d for the next linearization
__device__ float cost(const Params& p, Shared& sh, const St* S,
                      const uint8_t* gate, Dense& d) {
  dense_warps(p, sh, S, d);
  point_pass(p, sh, S[1], gate, false, 0);
  if (threadIdx.x == 0) sh.pt_cost = sh.acc[27];
  if (p.ur != nullptr) {
    __syncthreads();
    point_pass(p, sh, S[1], gate, false, 1);
    if (threadIdx.x == 0) sh.st_cost = sh.acc[27];
  }
  stamp(p, sh, kPts);
  if (threadIdx.x == 0) {
    // the engine's order: inertial, random walks, prior, the point terms
    float c = 0.f;
    c += 1.f * d.chi[0];
    c += 1.f * d.chi[1];
    c += 1.f * d.chi[2];
    c += (p.have_prior ? 1.f : 0.f) * d.chi[3];
    c += sh.pt_cost;
    if (p.ur != nullptr) c += sh.st_cost;
    sh.cost = c;
  }
  __syncthreads();
  stamp(p, sh, kDense);
  const float c = sh.cost;
  __syncthreads();
  return c;
}

// lower Cholesky of the n x n matrix A (n <= 32) into L by one warp, the
// left-looking order of plv::cholesky: for each column j, lane i >= j
// computes row i's entry with the dot over q < j in q order (lane j the
// diagonal); NaN everywhere where the matrix is not definite
__device__ void warp_cholesky(const float* A, float* L, int n) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < n * n; i += 32) L[i] = 0.f;
  __syncwarp();
  bool ok = true;
  for (int j = 0; j < n; ++j) {
    float x = 0.f;
    if (lane >= j && lane < n) {
      x = A[lane * n + j];
      for (int q = 0; q < j; ++q) x -= L[lane * n + q] * L[j * n + q];
    }
    const float d = __shfl_sync(0xffffffffu, x, j);
    ok = ok && (d > 0.f);
    const float ljj = sqrtf(d);
    if (lane == j) L[j * n + j] = ljj;
    else if (lane > j && lane < n) L[lane * n + j] = x / ljj;
    __syncwarp();
  }
  if (!ok)
    for (int i = lane; i < n * n; i += 32) L[i] = __int_as_float(0x7fc00000);
  __syncwarp();
}

__device__ __forceinline__ float free_row(const Params& p, int i) {
  // previous-state rows: pose 0..5, vel 12..14, bg 18..20, ba 24..26
  const bool prev = i < 6 || (i >= 12 && i < 15) || (i >= 18 && i < 21)
                    || (i >= 24 && i < 27);
  return (prev && !p.have_prior) ? 0.f : 1.f;
}

// damped, frozen 30x30 solve and the retraction into sh.Sn, by warp 0
// from registers: lane i < 30 holds row i of the damped system, which
// becomes row i of the factor L.  The Cholesky subtracts each finished
// column's products from the entries right of it (L_jq broadcast from
// lane j by shuffle), so every entry gets L_iq L_jq subtracted for q = 0,
// 1, ... in order, as plv::cholesky's left-looking dot subtracts them, and
// is divided by the same diagonal; NaN everywhere where the matrix is not
// definite.  The forward solve subtracts L_ik y_k as y_k arrives, k in
// order; the back-substitution subtracts L_ki dx_k, k ascending from i +
// 1, each product on lane k, the sum on every lane.  The same operations
// in the same order as the one-thread version.
__device__ void solve_retract(const Params& p, Shared& sh) {
  const int lane = threadIdx.x & 31;
  constexpr unsigned kAll = 0xffffffffu;
  unsigned long long t = p.prof != nullptr ? globaltimer() : 0ull;
  const float fi = lane < 30 ? free_row(p, lane) : 0.f;
  const float lam = sh.lam;
  float li[30];
#pragma unroll
  for (int j = 0; j < 30; ++j) {
    float x = 0.f;
    if (lane < 30) {                    // the damped, frozen entry
      const float fj = free_row(p, j);
      x = sh.H[lane * 30 + j];
      if (lane == j) x = x + (x * lam + 1e-6f);
      x = x * fi * fj;
      if (lane == j) x = x + (1.f - fi);
    }
    li[j] = x;
  }
  bool ok = true;
#pragma unroll
  for (int q = 0; q < 30; ++q) {
    const float d = __shfl_sync(kAll, li[q], q);
    ok = ok && (d > 0.f);
    const float lqq = sqrtf(d);
    li[q] = lane == q ? lqq : (lane > q && lane < 30 ? li[q] / lqq : 0.f);
#pragma unroll
    for (int j = q + 1; j < 30; ++j) {
      const float ljq = __shfl_sync(kAll, li[q], j);
      if (lane >= j) li[j] -= li[q] * ljq;
    }
  }
  if (!ok) {
#pragma unroll
    for (int j = 0; j < 30; ++j) li[j] = __int_as_float(0x7fc00000);
  }
  if (lane == 0) part(p, sh, 4, t);
  float s = lane < 30 ? sh.g[lane] * fi : 0.f;
  float y = 0.f;
#pragma unroll
  for (int k = 0; k < 30; ++k) {
    if (lane == k) y = s / li[k];
    const float yk = __shfl_sync(kAll, y, k);
    if (lane > k) s -= li[k] * yk;
  }
  if (lane == 0) part(p, sh, 5, t);
  float dx = 0.f;
#pragma unroll
  for (int i = 29; i >= 0; --i) {
    const float prod = li[i] * dx;             // lane k: L_ki dx_k
    float r = __shfl_sync(kAll, y, i);
#pragma unroll
    for (int k = i + 1; k < 30; ++k) r -= __shfl_sync(kAll, prod, k);
    if (lane == i) dx = r / li[i];
  }
  if (lane < 30) sh.dx[lane] = dx * fi;
  __syncwarp();
  if (lane == 0) part(p, sh, 6, t);
  if (lane < 2) {                       // the two states' retractions
    const int st = lane;
    const float* d = sh.dx;
    const St& A = sh.S[st];
    St& B = sh.Sn[st];
    float Ed[9], t9[9];
    so3_exp(d + 6 * st + 3, Ed);
    mul3(A.R, Ed, t9);
    so3_normalize(t9, B.R);
    for (int i = 0; i < 3; ++i) {
      B.p[i] = A.p[i] + d[6 * st + i];
      B.v[i] = A.v[i] + d[12 + 3 * st + i];
      B.bg[i] = A.bg[i] + d[18 + 3 * st + i];
      B.ba[i] = A.ba[i] + d[24 + 3 * st + i];
    }
    if (lane == 0) part(p, sh, 7, t);
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

// 576 threads: 18 warps put 5 on a scheduler's quarter of the register
// file, so at most 96 registers a thread (104 and 112 are refused)
__global__ void __launch_bounds__(kBlock) vi_pose_lm_kernel(Params p) {
  extern __shared__ uint8_t s_gate[];
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const float* st = p.state;
  int n_lin = 0;

  if (tid == 0 && p.prof != nullptr) {
    for (int k = 0; k < kStages; ++k) sh.tacc[k] = 0ull;
    for (int k = 0; k < kParts; ++k) sh.tpart[k] = 0ull;
    sh.tlast = globaltimer();
  }
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
    for (int i = 0; i < 6; ++i) sh.rw_s[i] = st[184 + i];
    const float* pc = st + 190;
    for (int i = 0; i < 9; ++i) sh.prior.R0[i] = pc[i];
    for (int i = 0; i < 3; ++i) {
      sh.prior.p0[i] = pc[9 + i];
      sh.prior.v0[i] = pc[12 + i];
      sh.prior.bg0[i] = pc[15 + i];
      sh.prior.ba0[i] = pc[18 + i];
    }
    for (int i = 0; i < 9; ++i) sh.Rcb[i] = st[436 + i];
    for (int i = 0; i < 3; ++i) sh.tcb[i] = st[445 + i];
    sh.cur = 0;
  }
  if (tid >= 32 && tid < 64) {
    warp_cholesky(st + 103, sh.L_imu, 9);
  } else if (tid >= 64 && tid < 96) {
    if (p.have_prior) {
      warp_cholesky(st + 211, sh.L_pri, 15);
    } else {                                  // prior_info_safe = I
      for (int i = tid - 64; i < 225; i += 32)
        sh.L_pri[i] = (i % 16 == 0) ? 1.f : 0.f;
    }
  }
  for (int k = tid; k < p.cap; k += kBlock) s_gate[k] = p.valid[k];
  __syncthreads();
  stamp(p, sh, kInit);

  // dn[cur] holds the dense terms at S, the other buffer a trial's
  for (int round = 0; round < p.rounds; ++round) {
    const int nb0 = 1 - sh.cur;
    float c0 = cost(p, sh, sh.S, s_gate, sh.dn[nb0]);
    if (tid == 0) {
      sh.cost_prev = c0;
      sh.lam = 1e-4f;
      sh.done = 0;
      sh.cur = nb0;
    }
    __syncthreads();
    for (int it = 0; it < p.iters; ++it) {
      linearize(p, sh, sh.S, s_gate, sh.dn[sh.cur], kPts, kDense);
      ++n_lin;
      if (tid < 32) solve_retract(p, sh);
      __syncthreads();
      stamp(p, sh, kSolve);
      const int nb = 1 - sh.cur;
      const float nc = cost(p, sh, sh.Sn, s_gate, sh.dn[nb]);
      if (tid == 0) {
        const float prev = sh.cost_prev;
        const bool acc = nc < prev;
        if (acc) {
          sh.S[0] = sh.Sn[0];
          sh.S[1] = sh.Sn[1];
          sh.cur = nb;
        }
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
      stamp(p, sh, kSolve);
      if (done) break;
    }
    // re-gate on the whitened chi2 at the round's solution
    for (int k = tid; k < p.cap; k += kBlock) {
      PtEval e;
      const int fam = family(p, k);
      point_eval(p, sh, sh.S[1], k, e, fam);
      s_gate[k] = p.valid[k] && (e.chi2 < (fam ? kChi2Stereo : kChi2));
    }
    __syncthreads();
    stamp(p, sh, kRegate);
  }

  // ---- inliers -----------------------------------------------------------
  int cnt = 0;
  for (int k = tid; k < p.cap; k += kBlock) {
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
    for (int w = 0; w < kBlockWarps; ++w) s += __float_as_int(sh.red[w][0]);
    *p.n_inl = s;
  }
  __syncthreads();
  stamp(p, sh, kRegate);

  // ---- next prior: one more linearization, then marginalize ------------
  linearize(p, sh, sh.S, s_gate, sh.dn[sh.cur], kFinal, kFinal);
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
  __syncthreads();
  stamp(p, sh, kMarg);
  if (tid == 0 && p.prof != nullptr) {
    for (int k = 0; k < kStages; ++k) p.prof[k] = sh.tacc[k];
    p.prof[kStages] = n_lin;
    for (int k = 0; k < kParts; ++k) p.prof[kStages + 1 + k] = sh.tpart[k];
  }
}

}  // namespace

PLVIO_API int vi_pose_lm(const void* state, const void* uv, const void* X,
                         const void* valid, const void* is2, const void* ur,
                         int cap, int have_prior, int rounds, int iters,
                         float fx, float fy, float cx, float cy,
                         float gravity, float delta, float bf, float delta_s,
                         void* out, void* inlier, void* n_inl, void* prof,
                         void* stream) {
  Params p{static_cast<const float*>(state), static_cast<const float*>(uv),
           static_cast<const float*>(X), static_cast<const uint8_t*>(valid),
           static_cast<const float*>(is2), static_cast<const float*>(ur),
           cap, have_prior, rounds, iters, fx, fy, cx, cy, gravity, delta,
           bf, delta_s, static_cast<float*>(out),
           static_cast<uint8_t*>(inlier), static_cast<int*>(n_inl),
           static_cast<unsigned long long*>(prof)};
  const size_t smem = size_t(cap);
  const size_t static_smem = sizeof(Shared);
  if (smem + static_smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        vi_pose_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  vi_pose_lm_kernel<<<1, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
