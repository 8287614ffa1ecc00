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
// Mflop, so launches and chains of dependent loads dominate.
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
// never as the dense B).  The sums are deterministic: each entry of a
// keyframe's or landmark's blocks is added in observation order, from one
// stable sort per BA call (no float atomics, whose order changes from run
// to run).  The cost is sum(w chi2), points then lines, reduced in a fixed
// order (one 1024-thread block's); the block that reduces it also takes
// the LM decision (accept if the cost fell, lambda halved or quadrupled
// within [1e-8, 1e4], early exit once the attempted step moved the cost by
// less than early_tol relative), so the loop needs no host sync.  In the
// body mode the cost adds the chain's share (`ccost`, written just before by
// csrc/inertial_chain.cu at the same state) and an accepted step also
// copies the keyframes' (vel, bg, ba).
//
// Two launches an LM iteration.  The linearization is one cooperative
// launch: the observations' blocks over the grid, a grid barrier, then
// the segment sums, a keyframe a block (its observations' blocks pass
// through shared memory a stage at a time, double-buffered: the first
// warp's threads add one stage's entries in kf_order while the other
// warps load the next) and a landmark entry a thread (its loads issued
// four at a time ahead of the adds, in pt_order / ln_order).  Every
// other mode is one launch of kCostBlocks blocks: each block evaluates
// the observations of its eight of the cost's 1024 chains (chain v: the
// family's w chi2 values v, v + 1024, ..., as thread v of one 1024-thread
// block adds them) and writes the chains' sums; the last block to arrive
// (a ticket in ctrl[cTicket], reset by that block) runs that block's tree
// over them, decides and copies an accepted candidate; the re-gate's new
// masks are written beside their chi2.  Every sum keeps one order, the
// order of one thread a segment entry and of the one-block cost sum, so
// the results do not move with the launch shape
// (tests/test_torch_slice20.py mirrors the orders).
//
// The mesh modes (4-7) serve the landmark-sharded inertial window BA
// (`make_dist_liba`, plvio_tpu/parallel/dist_liba.py:186): each shard's
// launch computes its own observations' cost (its chain share on shard 0)
// into ctrl[cNewCost] without deciding; the mesh sums the shards' costs in
// shard order into `mcost`; then every shard takes the same decision (or
// starts its round) from that sum, as the reference's engine decides on
// the psum of the shards' costs (solver/engine.py:619-620), and accepts
// its own candidate.  Modes 0-3 are unchanged.
//
// The KB8 mode (kb8 = 1, the point-only window BA of a KB8 fisheye and
// the loop closer's global BA on its map) replaces the point edge by
// `make_point_reproj_kb8` (solver/residuals.py:534) on raw pixels: the
// projection through the theta polynomial and its analytic Jacobian
// d(u, v) / d pc (solver/residuals.py `kb8_proj_jac`: no r derivative
// where r = sqrt(max(x^2 + y^2, 1e-18)) is floored, no depth derivative
// where the depth is clamped at 1e-6), then the same pose and point rows.
// The pinhole arithmetic is unchanged.
//
// Slice 13 adds three modes.  The body-frame KB8 mode (body = 1, kb8 = 1)
// replaces `make_point_reproj_body_ba_kb8` (solver/residuals.py:544), the
// inertial window's point edge of a KB8 camera (models/kernels.py:1228):
// Xb = R^T (X - p), pc = Rcb Xb + tcb, r = kb8(pc) - uv, its rows the lens
// Jacobian above through the body rows (JR = (d kb8 / d pc) Rcb), at 16 KF
// and on schur_solve's global path at 64 KF.  The KB8 point family beside
// the line family (`make_local_ba_pl` with a KB8K, models/kernels.py:641):
// the flag reaches the point edges only, the line edges of both frames
// project through the pinhole fx, fy, cx, cy as `make_line_reproj` reads a
// KB8K.  The line-only mode (line_mode 1-3, `make_local_ba_lines_only`,
// models/kernels.py:1394; no point family): mode 1 the line edge, mode 2
// the angle edge `make_line_angle` (solver/residuals.py:208), mode 3 both,
// each observation's blocks summing its edges' rows under their own Huber
// weights.  The angle row: with d = uv_e - uv_s, n = 1 / sqrt(|d|^2 +
// 1e-12) and g = (dir_1, -dir_0), r = n (d . g) and d r / d d = n g - n^3
// (d . g) d, through each endpoint's pinhole rows (solver/residuals.py
// `line_angle_jac`); whitened by sqrt(ang_info x is2).
#include <cooperative_groups.h>

#include "ba_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace ba;

constexpr int kModeLinearize = 0;
constexpr int kModeDecide = 1;   // cost of the candidate, accept/reject
constexpr int kModeInit = 2;     // cost of the state, start of a round
constexpr int kModeRegate = 3;   // cost of the state, new chi2 masks
// the mesh modes of the landmark-sharded window BA (parallel/dist_liba.py):
// a shard's partial cost of the candidate or of the state into
// ctrl[cNewCost]; then, once the mesh has summed the partials into
// `mcost`, the start of a round or the accept/reject of the summed cost
constexpr int kModePartialCand = 4;
constexpr int kModePartialState = 5;
constexpr int kModeMeshInit = 6;
constexpr int kModeMeshDecide = 7;

struct Proj {
  float pc[3];
  float u, v;
  float J[2][3];     // d(u, v) / d pc
};

// KB8 fisheye: raw pixel of q.pc and (jac) its Jacobian
__device__ __forceinline__ void project_kb8(const BA& b, bool jac, Proj& q) {
  const float x = q.pc[0], y = q.pc[1];
  const float r2 = x * x + y * y;
  const float r = sqrtf(fmaxf(r2, 1e-18f));
  const bool zon = q.pc[2] > 1e-6f;
  const float zc = fmaxf(q.pc[2], 1e-6f);
  const float th = atan2f(r, zc);
  const float t2 = th * th;
  const float q2 = t2 * t2, q3 = t2 * q2, q4 = q2 * q2;
  const float td = th * ((((1.0f + b.k[0] * t2) + b.k[1] * q2) + b.k[2] * q3)
                         + b.k[3] * q4);
  const float s = td / r;
  q.u = b.fx * x * s + b.cx;
  q.v = b.fy * y * s + b.cy;
  if (jac) {
    const float dtd = (((1.0f + 3.0f * b.k[0] * t2) + 5.0f * b.k[1] * q2)
                       + 7.0f * b.k[2] * q3) + 9.0f * b.k[3] * q4;
    const float den = r * r + zc * zc;
    const float ds_dr = (dtd * zc / den * r - td) / (r * r);
    const float ds_dz = zon ? dtd * (-r / den) / r : 0.f;
    const bool on = r2 > 1e-18f;
    const float drx = on ? x / r : 0.f, dry = on ? y / r : 0.f;
    q.J[0][0] = b.fx * (s + x * ds_dr * drx);
    q.J[0][1] = b.fx * x * ds_dr * dry;
    q.J[0][2] = b.fx * x * ds_dz;
    q.J[1][0] = b.fy * y * ds_dr * drx;
    q.J[1][1] = b.fy * (s + y * ds_dr * dry);
    q.J[1][2] = b.fy * y * ds_dz;
  }
}

// lens: through the KB8 fisheye (a point edge of a KB8 camera), else the
// pinhole fx, fy, cx, cy
__device__ __forceinline__ void project(const BA& b, const float* P,
                                        const float* X, bool jac, Proj& q,
                                        bool lens) {
  for (int r = 0; r < 3; ++r)
    q.pc[r] = ((P[r * 4] * X[0] + P[r * 4 + 1] * X[1]) + P[r * 4 + 2] * X[2])
        + P[r * 4 + 3];
  if (lens) {
    project_kb8(b, jac, q);
    return;
  }
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
                                             Proj& q, float Xb[3],
                                             bool lens) {
  const float d[3] = {X[0] - P[3], X[1] - P[7], X[2] - P[11]};
  for (int c = 0; c < 3; ++c)
    Xb[c] = (P[c] * d[0] + P[4 + c] * d[1]) + P[8 + c] * d[2];
  for (int r = 0; r < 3; ++r)
    q.pc[r] = ((b.Rcb[3 * r] * Xb[0] + b.Rcb[3 * r + 1] * Xb[1])
               + b.Rcb[3 * r + 2] * Xb[2]) + b.tcb[r];
  if (lens) {
    project_kb8(b, jac, q);
    return;
  }
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

// blocks of one line-only observation from nr whitened rows (r, Jc [6],
// Jl [6]), row d weighted by wr[d]
template <int NR>
__device__ void write_rows(const float wr[NR], const float r[NR],
                           const float Jc[NR][6], const float Jl[NR][6],
                           float* oc, float* ol, float* ow) {
  for (int i = 0; i < 6; ++i) {
    for (int j = i; j < 6; ++j) {
      float a = 0.f;
      for (int d = 0; d < NR; ++d) a += (Jc[d][i] * wr[d]) * Jc[d][j];
      oc[ut(6, i, j)] = a;
    }
    float g = 0.f;
    for (int d = 0; d < NR; ++d) g += (Jc[d][i] * wr[d]) * r[d];
    oc[21 + i] = -g;
    for (int j = 0; j < 6; ++j) {
      float a = 0.f;
      for (int d = 0; d < NR; ++d) a += (Jc[d][i] * wr[d]) * Jl[d][j];
      ow[i * 6 + j] = a;
    }
  }
  for (int i = 0; i < 6; ++i) {
    for (int j = i; j < 6; ++j) {
      float a = 0.f;
      for (int d = 0; d < NR; ++d) a += (Jl[d][i] * wr[d]) * Jl[d][j];
      ol[ut(6, i, j)] = a;
    }
    float g = 0.f;
    for (int d = 0; d < NR; ++d) g += (Jl[d][i] * wr[d]) * r[d];
    ol[21 + i] = -g;
  }
}

// line observation k of the line-only modes 2 and 3: the angle row and
// (mode 3) the two endpoint rows; chi2 the gate's (the line edge's in
// mode 3, the angle's in mode 2), w_chi2 the observation's robust cost
__device__ void line_only_obs(const BA& b, int k, const float* poses,
                              bool cand, bool jac, float& chi2_gate,
                              float& w_chi2) {
  const int o = b.n_obs + k;
  const float* lns = cand ? b.at<float>(kCLns) : b.at<float>(kLns);
  const float* P = poses + b.at<int>(kLobsKf)[k] * 12;
  const float* L = lns + b.at<int>(kLobsLn)[k] * 6;
  const float* l = b.at<float>(kLobsEq) + k * 3;
  const float* dir = b.at<float>(kLobsDir) + k * 2;
  const float is2 = b.at<float>(kLobsIs2)[k];
  const bool on = b.at<uint8_t>(kMaskL)[k] != 0;
  const bool both = b.line_mode == 3;
  const float s = sqrtf(is2), sa = sqrtf(is2 * b.ang_info);
  Proj q[2];
  for (int e = 0; e < 2; ++e) project(b, P, L + 3 * e, jac, q[e], false);
  // rows: [0, 1] the endpoint rows (mode 3), [2] the angle row
  float r[3], Jc[3][6], Jl[3][6], wr[3];
  float ce = 0.f;
  if (both) {
    for (int e = 0; e < 2; ++e) {
      r[e] = ((l[0] * q[e].u + l[1] * q[e].v) + l[2]) * s;
      if (jac) {
        float jr[3], jp[3];
        for (int c = 0; c < 3; ++c)
          jr[c] = l[0] * q[e].J[0][c] + l[1] * q[e].J[1][c];
        pose_row(jr, q[e].pc, Jc[e]);
        point_row(jr, P, jp);
        for (int c = 0; c < 3; ++c) {
          Jl[e][3 * e + c] = jp[c] * s;
          Jl[e][3 * (1 - e) + c] = 0.f;
        }
        for (int i = 0; i < 6; ++i) Jc[e][i] *= s;
      }
    }
    ce = r[0] * r[0] + r[1] * r[1];
  }
  const float d0 = q[1].u - q[0].u, d1 = q[1].v - q[0].v;
  const float n = 1.f / sqrtf((d0 * d0 + d1 * d1) + 1e-12f);
  const float g0 = dir[1], g1 = -dir[0];
  const float dg = d0 * g0 + d1 * g1;
  r[2] = (n * dg) * sa;
  const float ca = r[2] * r[2];
  if (jac) {
    const float n3 = n * n * n * dg;
    const float dd[2] = {n * g0 - n3 * d0, n * g1 - n3 * d1};
    for (int i = 0; i < 6; ++i) Jc[2][i] = 0.f;
    for (int e = 0; e < 2; ++e) {
      const float sg = e ? sa : -sa;
      float jr[3], pr[6], jp[3];
      for (int c = 0; c < 3; ++c)
        jr[c] = (dd[0] * q[e].J[0][c] + dd[1] * q[e].J[1][c]) * sg;
      pose_row(jr, q[e].pc, pr);
      for (int i = 0; i < 6; ++i) Jc[2][i] += pr[i];
      point_row(jr, P, jp);
      for (int c = 0; c < 3; ++c) Jl[2][3 * e + c] = jp[c];
    }
  }
  const float we = both ? huber(b, ce, on) : 0.f;
  const float wa = huber(b, ca, on);
  chi2_gate = both ? ce : ca;
  w_chi2 = both ? we * ce + wa * ca : wa * ca;
  if (!jac) return;
  float* oc = b.at<float>(kObsC) + o * 27;
  float* ol = b.at<float>(kLL) + k * 27;
  float* ow = b.at<float>(kLW) + k * 36;
  if (both) {
    wr[0] = we;
    wr[1] = we;
    wr[2] = wa;
    write_rows<3>(wr, r, Jc, Jl, oc, ol, ow);
  } else {
    write_rows<1>(&wa, &r[2], &Jc[2], &Jl[2], oc, ol, ow);
  }
}

// observation o (the combined index) at the state or, in the candidate
// modes, at the candidate: its chi2 and robust cost into kChi2 / kWChi2
// (and *wc) and, when linearizing, its blocks; returns the chi2 the
// re-gate reads
__device__ __forceinline__ float observe(const BA& b, int o, int mode,
                                         float* wc_out) {
  const bool cand = mode == kModeDecide || mode == kModePartialCand;
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
    const bool lens = b.kb8 != 0;
    if (b.body)
      project_body(b, P, X, jac, q, Xb, lens);
    else
      project(b, P, X, jac, q, lens);
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
  } else if (b.line_mode >= 2) {
    float wc;
    line_only_obs(b, o - b.n_obs, poses, cand, jac, chi2, wc);
    b.at<float>(kChi2)[o] = chi2;
    b.at<float>(kWChi2)[o] = wc;
    *wc_out = wc;
    return chi2;
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
        project_body(b, P, L + 3 * e, jac, q, Xb, false);
      else
        project(b, P, L + 3 * e, jac, q, false);
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
  *wc_out = w * chi2;
  return chi2;
}

constexpr int kThreads = 256;      // the linearization's blocks
constexpr int kStage = 192;        // a keyframe's observations staged at once
constexpr int kRedThreads = 1024;  // the cost sum's order (see cost_chains)
constexpr int kCostThreads = 512;  // the other modes' blocks
constexpr int kCostBlocks = 128;   // ... and their grid
constexpr int kChains = kRedThreads / kCostBlocks;   // cost chains a block
static_assert(kRedThreads % kCostBlocks == 0 && kCostThreads % kChains == 0,
              "a cost launch's chains");

// Stage stamps (ns, %globaltimer) into b's prof buffer when it is given:
// kMin slots take the earliest stamp, the others the latest
enum Prof { pStart, pObs, pBarrier, pKeyframes, pLandmarks, pTicket,
            pDecision, pCopy };
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void stamp(const BA& b, Prof slot) {
  unsigned long long* prof = b.at<unsigned long long>(kProf);
  if (prof == nullptr) return;
  if (slot == pStart || slot == pBarrier)
    atomicMin(prof + slot, now_ns());
  else
    atomicMax(prof + slot, now_ns());
}

// sum of src[order[i] * stride + e] over i in [lo, hi), added in i's
// order; the loads are issued four at a time, ahead of their adds
__device__ __forceinline__ float seg_sum(const float* src, const int* order,
                                         int lo, int hi, int stride, int e) {
  float acc = 0.f;
  for (int i = lo; i < hi; i += 4) {
    int ix[4];
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) ix[k] = i + k < hi ? __ldg(order + i + k) : 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = i + k < hi ? __ldcg(src + ix[k] * stride + e) : 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i + k < hi) acc += v[k];
  }
  return acc;
}

// keyframe kf's 27 block entries, each the sum of its observations' in
// kf_order.  The observations' blocks pass through shared memory kStage at
// a time, double-buffered: while the first warp's threads e < 27 add
// entry e of each block of one stage in order (sixteen shared loads ahead
// of their adds), the other warps load the next stage (sixteen global
// loads in flight a thread).
__device__ void kf_segment(const BA& b, int kf, float* s_blk) {
  const int* order = b.at<int>(kKfOrder);
  const int* start = b.at<int>(kKfStart);
  const float* src = b.at<float>(kObsC);
  const int lo = start[kf], hi = start[kf + 1];
  const int warp = threadIdx.x >> 5;
  // stage [c0, c0 + cnt) of the segment into buffer buf, by the threads
  // [t0, kThreads)
  auto stage = [&](int c0, int buf, int t0) {
    const int total = min(kStage, hi - c0) * 27;
    float* dst = s_blk + buf * kStage * 27;
    const int nt = kThreads - t0;
    for (int base = threadIdx.x - t0; base < total; base += 16 * nt) {
      float v[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int idx = base + k * nt;
        v[k] = idx < total
                   ? __ldcg(src + __ldg(order + c0 + idx / 27) * 27 + idx % 27)
                   : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int idx = base + k * nt;
        if (idx < total) dst[idx] = v[k];
      }
    }
  };
  float acc = 0.f;
  if (lo < hi) stage(lo, 0, 0);
  __syncthreads();
  for (int c0 = lo, buf = 0; c0 < hi; c0 += kStage, buf ^= 1) {
    if (warp == 0) {
      if (threadIdx.x < 27) {
        const float* blk = s_blk + buf * kStage * 27 + threadIdx.x;
        const int cnt = min(kStage, hi - c0);
        int i = 0;
        for (; i + 16 <= cnt; i += 16) {
          float v[16];
#pragma unroll
          for (int k = 0; k < 16; ++k) v[k] = blk[(i + k) * 27];
#pragma unroll
          for (int k = 0; k < 16; ++k) acc += v[k];
        }
        for (; i < cnt; ++i) acc += blk[i * 27];
      }
    } else if (c0 + kStage < hi) {
      stage(c0 + kStage, buf ^ 1, 32);
    }
    __syncthreads();
  }
  if (threadIdx.x < 27) b.at<float>(kHcc)[kf * 27 + threadIdx.x] = acc;
}

// The linearization in one cooperative launch: every observation's blocks
// over the grid, a grid barrier, then the segment sums: keyframe kf on
// block kf (mod the grid), the point (9) and line (27) entries one a
// thread on the blocks past the keyframes' (on all where the grid has no
// more).  Each sum runs in the order of the parent's one-thread loop.
__global__ void __launch_bounds__(kThreads) linearize_kernel(BA b) {
  __shared__ float s_blk[2 * kStage * 27];
  if (b.done()) return;          // nothing in this launch writes ctrl
  if (threadIdx.x == 0) stamp(b, pStart);
  // block k's observations: [k per, (k + 1) per), spread over the grid
  const int N = b.n_obs + b.n_lobs;
  const int per = (N + gridDim.x - 1) / gridDim.x;
  float wc;
  for (int k = threadIdx.x; k < per; k += blockDim.x) {
    const int o = blockIdx.x * per + k;
    if (o < N) observe(b, o, kModeLinearize, &wc);
  }
  if (b.at<unsigned long long>(kProf) != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0) stamp(b, pObs);
  }
  cg::this_grid().sync();
  if (threadIdx.x == 0) stamp(b, pBarrier);
  for (int kf = blockIdx.x; kf < b.n_kf; kf += gridDim.x)
    kf_segment(b, kf, s_blk);
  const int first = static_cast<int>(gridDim.x) > b.n_kf ? b.n_kf : 0;
  if (static_cast<int>(blockIdx.x) < first) {
    if (threadIdx.x == 0) stamp(b, pKeyframes);
    return;
  }
  const int np = b.n_pt * 9, nl = b.n_ln * 27;
  const int step = (gridDim.x - first) * blockDim.x;
  for (int t = (blockIdx.x - first) * blockDim.x + threadIdx.x; t < np + nl;
       t += step) {
    if (t < np) {
      const int* start = b.at<int>(kPtStart);
      b.at<float>(kHpt)[t] = seg_sum(b.at<float>(kPL), b.at<int>(kPtOrder),
                                     start[t / 9], start[t / 9 + 1], 9,
                                     t % 9);
    } else {
      const int u = t - np;
      const int* start = b.at<int>(kLnStart);
      b.at<float>(kHln)[u] = seg_sum(b.at<float>(kLL), b.at<int>(kLnOrder),
                                     start[u / 27], start[u / 27 + 1], 27,
                                     u % 27);
    }
  }
  if (b.at<unsigned long long>(kProf) != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0) stamp(b, first ? pLandmarks : pKeyframes);
  }
}

// The cost's chains of one family (n values of w chi2 from observation
// `first`): chain v < kRedThreads adds the family's values v, v +
// kRedThreads, ... from 0 in that order, as thread v of the one block of
// kRedThreads threads that summed the cost before; this block owns the
// chains [blockIdx.x kChains, (blockIdx.x + 1) kChains).  Its threads
// evaluate the chains' observations (kCostThreads / kChains steps of each
// chain a pass; in mode 3 also their new inlier masks from their chi2, at
// the masks the cost used), then thread c < kChains adds its chain's step
// values in order; the chain's sum goes to part[v].
__device__ void cost_chains(const BA& b, int mode, int first, int n,
                            float* s_w, float* part) {
  constexpr int kRows = kCostThreads / kChains;
  const int c = threadIdx.x % kChains;
  const int v = blockIdx.x * kChains + c;
  const int steps = (n + kRedThreads - 1) / kRedThreads;
  float acc = 0.f;
  for (int j0 = 0; j0 < steps; j0 += kRows) {
    const int j = j0 + threadIdx.x / kChains;
    const int i = v + j * kRedThreads;
    float wc = 0.f;
    if (j < steps && i < n) {
      const int o = first + i;
      const float chi2 = observe(b, o, mode, &wc);
      if (mode == kModeRegate) {
        if (o < b.n_obs) {
          b.at<uint8_t>(kMask)[o] = b.at<uint8_t>(kObsValid)[o] &&
                                    chi2 < b.chi2_th;
        } else {
          const int l = o - b.n_obs;
          b.at<uint8_t>(kMaskL)[l] = b.at<uint8_t>(kLobsValid)[l] &&
                                     chi2 < b.chi2_th;
        }
      }
    }
    s_w[threadIdx.x] = wc;
    __syncthreads();
    if (threadIdx.x < kChains)
      for (int r = 0; r < kRows && j0 + r < steps; ++r)
        if (v + (j0 + r) * kRedThreads < n) acc += s_w[r * kChains + c];
    __syncthreads();
  }
  if (threadIdx.x < kChains) part[v] = acc;
}

// the trees of the one block of kRedThreads threads over its threads'
// sums, the points' part[0, kRedThreads) and the lines' part[kRedThreads,
// 2 kRedThreads) (written by this launch's blocks), both in one pass: each
// level adds the same pairs in both
__device__ void chain_trees(const float* part, float* sh, float* sp,
                            float* sl) {
  for (int v = threadIdx.x; v < 2 * kRedThreads; v += kCostThreads)
    sh[v] = __ldcg(part + v);
  __syncthreads();
  for (int s = kRedThreads / 2; s > 0; s >>= 1) {
    for (int v = threadIdx.x; v < s; v += kCostThreads) {
      sh[v] += sh[v + s];
      sh[kRedThreads + v] += sh[kRedThreads + v + s];
    }
    __syncthreads();
  }
  *sp = sh[0];
  *sl = sh[kRedThreads];
  __syncthreads();
}

// dst[0, n) = src[0, n), eight 16-byte loads in flight a thread where both
// are 16-byte aligned
__device__ void copy_floats(float* dst, const float* src, int n) {
  int head = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src))
       & 15) == 0) {
    const int n4 = n / 4;
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int base = threadIdx.x; base < n4; base += 8 * kCostThreads) {
      float4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = base + k * kCostThreads;
        if (i < n4) v[k] = __ldcg(s4 + i);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = base + k * kCostThreads;
        if (i < n4) d4[i] = v[k];
      }
    }
    head = n4 * 4;
  }
  for (int i = head + threadIdx.x; i < n; i += kCostThreads)
    dst[i] = __ldcg(src + i);
}

// The cost, the LM decision and the accepted copy of one launch's last
// block (every block has written its chains' sums): the cost sum(w chi2),
// points then lines, as the tree over their chains (plus the chain's
// share in the body mode), or the mesh's summed cost; then, as `mode`
// says, the start of a round, the accept/reject (lambda halved or
// quadrupled within [1e-8, 1e4], the early exit once the cost moved by
// less than early_tol relative) or a partial cost into ctrl[cNewCost]; an
// accepted candidate (this launch's, or a decided one when the loop is
// done) is copied to the state.
__device__ void finish(const BA& b, int mode, float* sh, int* s_acc) {
  float* ctrl = b.at<float>(kCtrl);
  const bool mesh = mode == kModeMeshInit || mode == kModeMeshDecide;
  const bool decides = mode == kModeDecide || mode == kModeMeshDecide;
  const bool skip = (mode == kModeDecide || mode == kModePartialCand ||
                     mode == kModeMeshDecide) && ctrl[cDone] != 0.f;
  float cost = 0.f;
  if (!skip && !mesh) {
    float sp, sl;
    chain_trees(b.at<float>(kCostPart), sh, &sp, &sl);
    cost = b.body ? (sp + sl) + b.at<float>(kCCost)[0] : sp + sl;
  }
  if (threadIdx.x == 0) {
    *reinterpret_cast<unsigned*>(ctrl + cTicket) = 0u;
    if (mesh) cost = b.at<float>(kMCost)[0];
    const int m = mesh ? (mode == kModeMeshInit ? kModeInit : kModeDecide)
                       : mode;
    if (skip) {
    } else if (m == kModeInit) {
      ctrl[cLam] = b.lam0;
      ctrl[cCost] = cost;
      ctrl[cNewCost] = cost;
      ctrl[cDone] = 0.f;
      ctrl[cIters] = 0.f;
      ctrl[cAccept] = 0.f;
      ctrl[cAccepted] = 0.f;
    } else if (m == kModeDecide) {
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
    *s_acc = decides && ctrl[cAccept] != 0.f;
    stamp(b, pDecision);
  }
  __syncthreads();
  if (*s_acc) {
    copy_floats(b.at<float>(kPoses), b.at<float>(kCPoses), b.n_kf * 12);
    copy_floats(b.at<float>(kPts), b.at<float>(kCPts), b.n_pt * 3);
    copy_floats(b.at<float>(kLns), b.at<float>(kCLns), b.n_ln * 6);
    if (b.body)
      copy_floats(b.at<float>(kKfX), b.at<float>(kCKfX), b.n_kf * 9);
  }
  if (b.at<unsigned long long>(kProf) != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0) stamp(b, pCopy);
  }
}

// Every mode but the linearization in one launch of kCostBlocks blocks
// (one in the mesh's modes 6 and 7, which have no observation): each
// block evaluates the observations of its cost chains (none once the
// loop is done in modes 1 and 4) and writes the chains' sums; then the
// last block to arrive, by the ticket in ctrl[cTicket] (taken after a
// fence, reset for the next launch), runs `finish`.
__global__ void __launch_bounds__(kCostThreads) cost_pass_kernel(BA b,
                                                                 int mode) {
  __shared__ float sh[2 * kRedThreads];
  __shared__ float s_w[kCostThreads];
  __shared__ int s_last, s_acc;
  const bool mesh = mode == kModeMeshInit || mode == kModeMeshDecide;
  const bool skip = (mode == kModeDecide || mode == kModePartialCand) &&
                    b.done();
  if (threadIdx.x == 0) stamp(b, pStart);
  if (!mesh && !skip) {
    float* part = b.at<float>(kCostPart);
    cost_chains(b, mode, 0, b.n_obs, s_w, part);
    cost_chains(b, mode, b.n_obs, b.n_lobs, s_w, part + kRedThreads);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    stamp(b, pObs);
    unsigned* ticket = reinterpret_cast<unsigned*>(b.at<float>(kCtrl) +
                                                   cTicket);
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (threadIdx.x == 0) stamp(b, pTicket);
  finish(b, mode, sh, &s_acc);
}

inline int blocks(int n, int t) { return (n + t - 1) / t; }

// The co-resident blocks of linearize_kernel on the current device (its
// grid barrier needs every block resident), found once a device.
int linearize_capacity() {
  static int cap[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cap[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, linearize_kernel, kThreads, 0) != cudaSuccess)
      return 0;
    cap[dev] = sms * per_sm;
  }
  return cap[dev];
}

}  // namespace

PLVIO_API int ba_linearize(void* const* ptrs, const int* ints,
                           const float* flts, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BA b = make_ba(ptrs, ints, flts);
  const int N = b.n_obs + b.n_lobs;
  if (mode < 0 || mode > 7) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kModeLinearize) {
    const int cap = linearize_capacity();
    if (cap < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const int want = max(blocks(N, kThreads),
                         b.n_kf + blocks(b.n_pt * 9 + b.n_ln * 27, kThreads));
    const int grid = max(1, min(cap, want));
    void* args[] = {&b};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(linearize_kernel), dim3(grid),
        dim3(kThreads), args, 0, s));
  }
  const bool mesh = mode == kModeMeshInit || mode == kModeMeshDecide;
  cost_pass_kernel<<<mesh ? 1 : kCostBlocks, kCostThreads, 0, s>>>(b, mode);
  return static_cast<int>(cudaGetLastError());
}
