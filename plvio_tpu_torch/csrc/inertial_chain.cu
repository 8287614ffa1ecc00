// inertial_chain — the chain edges of the sliding-window VI BA: for each
// link between consecutive keyframes i and i+1, the 9-dim inertial
// residual over (pose_i, vel_i, bg_i, ba_i, pose_{i+1}, vel_{i+1}) and the
// two bias random walks, whitened, masked by edge_valid, as the link's
// packed 30x30 block of H, its g and its costs; then the chain's share of
// the LM cost.
//
// Replaces, for `make_local_inertial_ba` (plvio_tpu/models/kernels.py:1206,
// its terms "inertial", "bg_rw" and "ba_rw" at :1279-1291),
// plvio_tpu/solver/engine.py `Problem.build_normal_equations`' scatter of
// multi-reference terms (:406-425) with `_whiten`'s Cholesky of the 9x9
// information (:115-128) and `_residuals_only`/`cost` (:575-621), on the
// residuals `make_inertial` and `bias_rw` (solver/residuals.py:318,466).
// The JAX version differentiates the residual by jacfwd and scatter-adds
// each link's 24x24 block into the dense H with `.at[].add`.
//
// What bounds it on the H100: latency.  A 16-KF window has 15 links; each
// is ~3 kflop of residual, Jacobian and whitening and 495 block entries of
// 9 multiply-adds, ~0.2 Mflop and 30 KB written in all: far below a
// microsecond of either bound, so one launch of one block is the cost.
//
// Design: one block, one warp per link.  Lane 0 evaluates the residual and
// its analytic 9x24 Jacobian (csrc/inertial.cuh `inertial_edge`, shared
// with csrc/vi_pose_lm.cu) and the Cholesky factor of the link's
// information; the lanes then whiten one column each by L^T (the 24
// Jacobian columns and the residual), and form the link's 30x30 block and
// g over the local vector (pose_i, vel_i, bg_i, ba_i, pose_{i+1},
// vel_{i+1}, bg_{i+1}, ba_{i+1}) with the random walks' [-s I, s I] rows
// (s = sqrt(rw_info)), each entry times the edge's mask (no robust
// kernel).  Nothing is summed across links here: csrc/schur_solve.cu adds,
// for each keyframe block, links i-1 and i in link order when it assembles
// the reduced system, so the sums are the same on every run.  Thread 0
// adds the links' costs in link order (inertial, then the gyro and the
// accelerometer walks) into `ccost`, which csrc/ba_linearize.cu's cost adds
// to the visual terms'.  Modes: linearize at the state (blocks and cost),
// cost of the candidate (before the accept/reject), cost of the state (the
// start of a round; it runs whatever the early-exit flag says).  The other
// two read the device-side early-exit flag first.
#include "ba_common.cuh"
#include "inertial.cuh"

namespace {

using namespace ba;
using namespace plv;

constexpr int kModeLinearize = 0;
constexpr int kModeCostCand = 1;
constexpr int kModeCostState = 2;
constexpr int kMaxWarps = 32;
constexpr int kScratch = 9 * 24 + 9 + 81;   // J [9][24], r [9], L [9][9]

__global__ void __launch_bounds__(kMaxWarps * 32) chain_kernel(BA b,
                                                               int mode) {
  if (mode != kModeCostState && b.done()) return;
  extern __shared__ float sh[];
  const int n_e = b.n_kf - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const bool cand = mode == kModeCostCand;
  const bool jac = mode == kModeLinearize;
  const float* poses = b.at<float>(cand ? kCPoses : kPoses);
  const float* kfx = b.at<float>(cand ? kCKfX : kKfX);
  float* J = sh + warp * kScratch;         // [9][24]
  float* r = J + 9 * 24;
  float* L = r + 9;
  for (int i = warp; i < n_e; i += n_warps) {
    const float w = b.at<uint8_t>(kEdgeValid)[i] ? 1.f : 0.f;
    const float sg = sqrtf(b.at<float>(kRwG)[i]);
    const float sa = sqrtf(b.at<float>(kRwA)[i]);
    const float* P1 = poses + i * 12;
    const float* P2 = P1 + 12;
    const float* x1 = kfx + i * 9;        // vel, bg, ba
    const float* x2 = x1 + 9;
    if (lane == 0) {
      float R1[9], R2[9];
      for (int u = 0; u < 3; ++u)
        for (int c = 0; c < 3; ++c) {
          R1[3 * u + c] = P1[4 * u + c];
          R2[3 * u + c] = P2[4 * u + c];
        }
      const float p1[3] = {P1[3], P1[7], P1[11]};
      const float p2[3] = {P2[3], P2[7], P2[11]};
      Pre q;
      load_pre(b.at<float>(kPre) + i * 67, q);
      cholesky(b.at<float>(kImuInfo) + i * 81, L, 9);
      inertial_edge(R1, p1, x1, x1 + 3, x1 + 6, R2, p2, x2, q, b.gravity,
                    jac, r, J);
    }
    __syncwarp();
    // whiten by L^T, one column a lane (lane 24: the residual)
    if (lane < 25 && (jac || lane == 24)) {
      float* col = lane < 24 ? J + lane : r;
      const int st = lane < 24 ? 24 : 1;
      for (int d = 0; d < 9; ++d) {
        float x = 0.f;
        for (int e = d; e < 9; ++e) x += L[e * 9 + d] * col[e * st];
        col[d * st] = x;
      }
    }
    __syncwarp();
    if (lane == 0) {
      float ci = 0.f, cg = 0.f, ca = 0.f;
      for (int d = 0; d < 9; ++d) ci += r[d] * r[d];
      for (int k = 0; k < 3; ++k) {
        const float rg = (x2[3 + k] - x1[3 + k]) * sg;
        const float ra = (x2[6 + k] - x1[6 + k]) * sa;
        cg += rg * rg;
        ca += ra * ra;
      }
      float* lc = b.at<float>(kLinkCost) + i * 3;
      lc[0] = w * ci;
      lc[1] = w * cg;
      lc[2] = w * ca;
    }
    if (jac) {
      float* out = b.at<float>(kLink) + size_t(i) * kLinkFloats;
      // the random walks' rows: local bg_i 9..11 / bg_{i+1} 24..26 (scale
      // sg), ba_i 12..14 / ba_{i+1} 27..29 (scale sa)
      for (int e = lane; e < 465 + 30; e += 32) {
        int a, c;
        if (e < 465) {                    // (a, c) of the packed upper entry
          a = 0;
          int rem = e;
          while (rem >= 30 - a) {
            rem -= 30 - a;
            ++a;
          }
          c = a + rem;
        } else {
          a = e - 465;
          c = -1;
        }
        float v = 0.f;
        if (c < 0) {                      // g: -w J^T r
          if (a < 24)
            for (int d = 0; d < 9; ++d) v += J[d * 24 + a] * r[d];
          float rw = 0.f;
          const int k = (a - 9) % 15;     // random-walk component
          if ((a >= 9 && a < 12) || (a >= 24 && a < 27)) {
            const float rr = (x2[3 + k] - x1[3 + k]) * sg;
            rw = (a < 12 ? -sg : sg) * rr;
          } else if ((a >= 12 && a < 15) || (a >= 27 && a < 30)) {
            const int m = (a - 12) % 15;
            const float rr = (x2[6 + m] - x1[6 + m]) * sa;
            rw = (a < 15 ? -sa : sa) * rr;
          }
          out[465 + a] = -(w * (v + rw));
        } else {
          if (c < 24)
            for (int d = 0; d < 9; ++d) v += J[d * 24 + a] * J[d * 24 + c];
          // random walks: the same component of b_i and b_{i+1}
          const bool gi = a >= 9 && a < 12, gj = a >= 24 && a < 27;
          const bool ai = a >= 12 && a < 15, aj = a >= 27 && a < 30;
          float rw = 0.f;
          if ((gi || gj) && (c == a || (gi && c == a + 15))) {
            const float ja = gi ? -sg : sg, jc = c < 24 && c >= 9 && c < 12
                                                    ? -sg : sg;
            rw = ja * jc;
          } else if ((ai || aj) && (c == a || (ai && c == a + 15))) {
            const float ja = ai ? -sa : sa, jc = c >= 12 && c < 15
                                                    ? -sa : sa;
            rw = ja * jc;
          }
          out[e] = w * (v + rw);
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float* lc = b.at<float>(kLinkCost);
    float ci = 0.f, cg = 0.f, ca = 0.f;
    for (int i = 0; i < n_e; ++i) ci += lc[3 * i];
    for (int i = 0; i < n_e; ++i) cg += lc[3 * i + 1];
    for (int i = 0; i < n_e; ++i) ca += lc[3 * i + 2];
    b.at<float>(kCCost)[0] = (ci + cg) + ca;
  }
}

}  // namespace

// one launch: the chain's blocks and cost (mode 0, at the state), or its
// cost at the candidate (1) or at the state (2)
PLVIO_API int inertial_chain(void* const* ptrs, const int* ints,
                             const float* flts, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BA b = make_ba(ptrs, ints, flts);
  const int n_e = b.n_kf - 1;
  if (mode < 0 || mode > 2 || !b.body || n_e < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = n_e < kMaxWarps ? n_e : kMaxWarps;
  const size_t smem = size_t(warps) * kScratch * sizeof(float);
  chain_kernel<<<1, 32 * warps, smem, s>>>(b, mode);
  return static_cast<int>(cudaGetLastError());
}
