// The window BAs' device state, shared by csrc/ba_linearize.cu,
// csrc/schur_solve.cu and csrc/inertial_chain.cu (each built on its own;
// all take the same pointer table from
// plvio_tpu_torch/models/kernels.py:_BAWork).
//
// Two configurations.  The point+line BA (body = 0): keyframe poses T_cw
// [n_kf,12] (row-major [3,4]), the dense system S = 6 n_kf rows (left se3
// perturbation (rho, phi) per keyframe).  The inertial window BA (body =
// 1): body poses pose_wb = (R_wb | p_wb) [n_kf,12] and kfx = (vel, bg, ba)
// [n_kf,9]; the dense system has S = 15 n_kf rows laid out by family as
// the reference's add_dense order: pose [0, 6n) with (dp, dtheta) per KF
// (R <- R Exp(dtheta), p <- p + dp), vel [6n, 9n), bg [9n, 12n), ba [12n,
// 15n).  Landmarks couple to pose rows only, so the Schur fill-in has 6
// n_kf rows in both (`Sp`).  Points [n_pt,3], lines [n_ln,6] (two
// endpoints).  Observation o < n_obs is point observation o, o >= n_obs
// is line observation o - n_obs ("combined" index).  Packed symmetric
// blocks store the upper triangle row by row (`ut`).
//
// The inertial chain (body = 1): link i joins KF i and i+1; its local
// 30-vector is the two 15-DoF states (pose 6, vel 3, bg 3, ba 3);
// `link` [n_kf-1, 495] holds its packed 30x30 H (465) and g (30),
// `link_cost` [n_kf-1, 3] its three costs (inertial, bg random walk, ba
// random walk), and `ccost` [1] the chain's share of the LM cost.
//
// cgw: the reduced solve's workspace when the system does not fit one
// block's shared memory (csrc/schur_solve.cu, the global path): the full
// S x S system, the CG direction p [S] and two partial-sum rows, one float
// per block each; a one-float stub otherwise.
//
// The line-only window BA of SLAM modes 1-3 (line_mode = 1, 2, 3): no
// point family (n_pt = n_obs = 0); mode 1 the line edge alone, mode 2 the
// angle edge alone (one row an observation: the sine of the angle between
// the projected segment and the observed unit direction lobs_dir [n_lobs,
// 2], information ang_info x is2), mode 3 both edges of each observation,
// each with its own Huber weight; the chi2 re-gate reads the line edge's
// chi2 in modes 1 and 3, the angle edge's in mode 2.  line_mode = 0 is the
// point+line BA.
//
// mcost [1]: the mesh's sum of the shards' partial costs, which the mesh
// modes of csrc/ba_linearize.cu decide on (the landmark-sharded window BA).
//
// ctrl (float[8]) carries the LM loop on the device: [0] lambda, [1] cost
// of the current state, [2] cost of the last candidate, [3] done (early
// exit), [4] iterations run, [5] last candidate accepted, [6] accepted
// steps.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace ba {

enum Ptr {
  kPoses, kPts, kLns, kCPoses, kCPts, kCLns,
  kObsKf, kObsPt, kObsUv, kObsIs2, kObsValid, kMask,
  kLobsKf, kLobsLn, kLobsEq, kLobsIs2, kLobsValid, kMaskL,
  kKfFree, kPtFree, kLnFree,
  kKfOrder, kKfStart, kPtOrder, kPtStart, kLnOrder, kLnStart,
  kObsC, kPL, kPW, kLL, kLW, kChi2, kWChi2,
  kHcc, kHpt, kHln, kFpt, kFln, kOccPt, kOccLn,
  kGm, kGpart, kRr, kFf, kDx, kCtrl,
  kKfX, kCKfX, kKfFreeBias, kPre, kImuInfo, kEdgeValid, kRwG, kRwA, kLink,
  kLinkCost, kCCost, kCgw, kLobsDir, kMCost, kNumPtrs
};
// kCgwFloats: the floats of the cgw workspace; kSolvePath: set by
// schur_solve to the path its reduced solve took (0 one block, 1 global)
// kKb8: the point edge projects through the KB8 fisheye (k1..k4 in kK1..)
// onto raw pixels (the window BAs of a KB8 camera; the line edges keep
// the pinhole fx, fy, cx, cy); kLineMode: the line-only modes above
enum Int { kNKf, kNPt, kNObs, kNLn, kNLobs, kCgIters, kGramSplit, kBody,
           kCgwFloats, kSolvePath, kKb8, kLineMode, kNumInts };
enum Flt { kFx, kFy, kCx, kCy, kDelta, kChi2Th, kLam0, kEarlyTol, kGravity,
           kRcb, kTcb = kRcb + 9, kK1 = kTcb + 3, kAngInfo = kK1 + 4,
           kNumFlts };
constexpr int kLinkFloats = 465 + 30;
enum Ctrl { cLam, cCost, cNewCost, cDone, cIters, cAccept, cAccepted };

struct BA {
  void* p[kNumPtrs];
  int n_kf, n_pt, n_obs, n_ln, n_lobs, cg_iters, gram_split, body, kb8;
  int line_mode;
  float fx, fy, cx, cy, delta, chi2_th, lam0, early_tol, gravity;
  float Rcb[9], tcb[3], k[4], ang_info;

  template <typename T>
  __device__ __forceinline__ T* at(Ptr i) const {
    return static_cast<T*>(p[i]);
  }
  __device__ __forceinline__ bool done() const {
    return at<float>(kCtrl)[cDone] != 0.f;
  }
  // rows of the landmark coupling and the fill-in (keyframe poses)
  __host__ __device__ int Sp() const { return 6 * n_kf; }
  // rows of the dense system
  __host__ __device__ int Sd() const { return (body ? 15 : 6) * n_kf; }
  __host__ __device__ int C() const { return 3 * n_pt + 6 * n_ln; }
};

inline BA make_ba(void* const* ptrs, const int* ints, const float* flts) {
  BA b;
  for (int i = 0; i < kNumPtrs; ++i) b.p[i] = ptrs[i];
  b.n_kf = ints[kNKf];
  b.n_pt = ints[kNPt];
  b.n_obs = ints[kNObs];
  b.n_ln = ints[kNLn];
  b.n_lobs = ints[kNLobs];
  b.cg_iters = ints[kCgIters];
  b.gram_split = ints[kGramSplit];
  b.body = ints[kBody];
  b.kb8 = ints[kKb8];
  b.line_mode = ints[kLineMode];
  b.fx = flts[kFx];
  b.fy = flts[kFy];
  b.cx = flts[kCx];
  b.cy = flts[kCy];
  b.delta = flts[kDelta];
  b.chi2_th = flts[kChi2Th];
  b.lam0 = flts[kLam0];
  b.early_tol = flts[kEarlyTol];
  b.gravity = flts[kGravity];
  for (int i = 0; i < 9; ++i) b.Rcb[i] = flts[kRcb + i];
  for (int i = 0; i < 3; ++i) b.tcb[i] = flts[kTcb + i];
  for (int i = 0; i < 4; ++i) b.k[i] = flts[kK1 + i];
  b.ang_info = flts[kAngInfo];
  return b;
}

// packed upper-triangle index of (i, j) in an n x n symmetric block
__host__ __device__ __forceinline__ int ut(int n, int i, int j) {
  if (i > j) {
    const int t = i;
    i = j;
    j = t;
  }
  return i * n - i * (i - 1) / 2 + (j - i);
}

}  // namespace ba
