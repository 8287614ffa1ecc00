// The windowed point+line BA's device state, shared by csrc/ba_linearize.cu
// and csrc/schur_solve.cu (each built on its own; both take the same
// pointer table from plvio_tpu_torch/models/kernels.py:_BAWork).
//
// Layout: keyframe poses T_cw [n_kf,12] (row-major [3,4]), points
// [n_pt,3], lines [n_ln,6] (two endpoints); the dense system has S = 6
// n_kf rows (left se3 perturbation (rho, phi) per keyframe).  Observation
// o < n_obs is point observation o, o >= n_obs is line observation
// o - n_obs ("combined" index).  Packed symmetric blocks store the upper
// triangle row by row (`ut`).
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
  kGm, kGpart, kRr, kFf, kDx, kCtrl, kNumPtrs
};
enum Int { kNKf, kNPt, kNObs, kNLn, kNLobs, kCgIters, kGramSplit, kNumInts };
enum Flt { kFx, kFy, kCx, kCy, kDelta, kChi2Th, kLam0, kEarlyTol,
           kNumFlts };
enum Ctrl { cLam, cCost, cNewCost, cDone, cIters, cAccept, cAccepted };

struct BA {
  void* p[kNumPtrs];
  int n_kf, n_pt, n_obs, n_ln, n_lobs, cg_iters, gram_split;
  float fx, fy, cx, cy, delta, chi2_th, lam0, early_tol;

  template <typename T>
  __device__ __forceinline__ T* at(Ptr i) const {
    return static_cast<T*>(p[i]);
  }
  __device__ __forceinline__ bool done() const {
    return at<float>(kCtrl)[cDone] != 0.f;
  }
  __host__ __device__ int S() const { return 6 * n_kf; }
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
  b.fx = flts[kFx];
  b.fy = flts[kFy];
  b.cx = flts[kCx];
  b.cy = flts[kCy];
  b.delta = flts[kDelta];
  b.chi2_th = flts[kChi2Th];
  b.lam0 = flts[kLam0];
  b.early_tol = flts[kEarlyTol];
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
