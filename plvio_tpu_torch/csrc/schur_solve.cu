// schur_solve — one damped Schur-complement step of the window BAs:
// landmark elimination, the reduced solve by fixed-step CG,
// back-substitution and the retraction of every block.
//
// Replaces, for `make_local_ba_pl` (plvio_tpu/models/kernels.py:641) and
// `make_local_inertial_ba` (:1206), plvio_tpu/solver/engine.py
// `Problem.solve_step` (:452-573) with `chol_invT_blocks` (:221, `_chol3`
// :185, `_tri_inv3` :205) and `_cg_solve` (:256), and the retractions
// `retract_pose_cw` / `retract_pose_wb` / `retract_additive`
// (solver/residuals.py:47,61,68).  The JAX version works on the dense
// coupling B [S, P*dof] with batched einsums, one XLA dot for the Gram
// fill-in and a scanned CG.
//
// What bounds it on the H100: latency.  At the worst-case point+line window
// (S = 96, 4096 3x3 point blocks, 512 6x6 line blocks, 9216 observations)
// the factor stage reads ~2 MB and writes each observation's 6 x 3 or 6 x
// 6 factor (0.7 MB); the fill-in is ~1e7 multiply-adds over the
// landmarks' keyframe pairs; the CG is 48 sequential iterations of a 96 x
// 96 matrix-vector product.  The inertial window (S = 15 x 16 = 240) runs
// the same factor and fill-in stages (landmarks couple to the 96 pose rows
// only) and 120 CG iterations on a system that is dense only in its 96 x
// 96 pose block: its velocity and bias rows couple through the chain's
// keyframe-tridiagonal blocks alone (17 910 of 57 600 entries).
//
// Design (four launches a step, five on the global path).  Every sum
// runs in the order of the dense design this one replaced (a dense Gram
// operand, its tiled product and a one-thread-a-row CG on the packed
// system), so the step keeps its bits (the window BAs' kernel_digest.py
// lines did not move):
// - factor_kernel: one thread per landmark (points, then lines; a warp a
//   block, so the landmarks spread over every SM) takes the reference's
//   steps in order: free mask, the per-landmark damping floor 1e-4
//   mean(diag), lambda damping, the `occupied` gate, F = chol(Hpp)^-T by
//   the same closed forms, the `blk_ok` guard (finite and max|F| < 1e3),
//   then for each of its observations (in observation order) G_o = W_o F
//   into gpt / gln and the rhs share G_o F^T g_p into rr.  No dense
//   operand: the fill-in reads the per-observation factors.
// - fill_kernel: the fill-in Ff = Gm Gm^T (engine.py:530, an XLA dot over
//   the dense coupling there), one block of 256 threads per 6 x 6
//   keyframe block (k1 <= k2), walking k1's observations in column order
//   (the host's kf_col_order): for each landmark that k2 also sees, its
//   columns' factors on both keyframes, then each entry's terms in column
//   order, chunk by chunk (see kSumChunks).  No atomics and no host-built
//   pair list; only the landmarks the two keyframes share cost work.  The
//   diagonal blocks also sum each keyframe's rhs shares in kf_order (the
//   serial loop the dense design's solve ran per row).  Ff [Sp, Sp] keeps
//   the full
//   symmetric layout its readers take (reduced_h, assemble_kernel,
//   solve_global_kernel).
// - solve_kernel: one block of 1024 threads assembles the reduced system in
//   shared memory in full rows: the keyframes' visual pose blocks
//   (csrc/ba_linearize.cu) and, for the inertial window, the chain's link
//   blocks (csrc/inertial_chain.cu), each keyframe's 15 x 15 block summing
//   links i-1 and i in link order and its off-diagonal block taken from
//   link i; damped as H + diag(diag(H) lambda + 1e-6), minus the fill-in
//   on the pose rows, the fixed states freed after the reduction (unit
//   diagonal, zero rhs; pose and velocity rows by kf_free, bias rows by
//   kf_free_bias).  A row stores only its structural non-zeros in column
//   order (`RowSegs`: all columns of a point+line window; the pose block
//   and the keyframe-tridiagonal columns of the 15-DoF one), padded so that
//   the 32 rows a warp walks at once read 32 banks.  Then
//   CG with the reference's iteration count (min(max(S / 2, 16), 128)) and
//   max(., 1e-20) guards on its first 256 threads (the others keep the
//   barriers): a thread owns rows t and t + 256 and walks each
//   row's stored columns in order (the dense row walk without its
//   structural zeros), keeps x, r and p in registers, and forms p.Hp and
//   r.r as the dense design's block sums did (a warp butterfly, the warps
//   in order) in the same passes as the product and the update: three
//   barriers an iteration (the dense design had seven, and its packed
//   column reads met bank conflicts).
// - the global path, the same system and CG beyond one block (see
//   one_block: a point+line window beyond 37 keyframes, S > 222, e.g. S =
//   768 at 128; a 15-DoF window beyond 22, S > 330, e.g. the full-map
//   BA's 64 keyframes, S = 960), two launches.  assemble_rows_kernel
//   writes the system's structural non-zeros in solve_kernel's full-row
//   layout (RowSegs, RowLayout) to the global workspace, a warp a row
//   over enough blocks to fill the card (S / 8 blocks).  cg_cluster_kernel
//   runs the CG on one thread-block cluster of 16 CTAs: CTA c owns a run
//   of 32-row warps, copies their stored rows into its shared memory (at
//   S = 960 the widest CTA holds 64 pose rows of 417 floats, 107 KB; at S
//   = 768, 64 dense rows of 769, 197 KB; a system whose rows do not fit,
//   dense from 145 keyframes, leaves them in the workspace, in L2) and
//   keeps the whole p in shared memory.  Each CG step: a thread
//   walks its row's stored columns in order, as solve_kernel does; p.Hp
//   and r.r are each warp's butterfly, stored by st.async into every
//   CTA's shared memory (each store completing its bytes on that CTA's
//   mbarrier), then summed by every thread in the dense design's tree
//   (per 128 rows the four warps in order, then those groups in order,
//   the tree the earlier one-cooperative-grid design took); the new p is
//   stored into every CTA's copy the same way.  A CTA waits on its own
//   three mbarriers a step; no barrier of the grid or the cluster runs in
//   the loop (with three cluster barriers a step it was 6.1 us a step at
//   S = 960, with the mbarriers 4.0).  The earlier design (8 blocks at S
//   = 960, the dense S x S system in L2, three grid barriers a step) took
//   5.01 ms a solve there, this one 0.52 (H100 80GB HBM3, 700 W).
// - backsub_kernel: back-substitutes each landmark (dx_p = F F^T (g_p -
//   sum_o W_o^T dx_kf)) and retracts each keyframe into the candidate state
//   (T <- Exp(dx) T for T_cw; R <- R Exp(dtheta), p <- p + dp for pose_wb,
//   and velocity and biases additive; rows re-orthonormalized).
// Every kernel reads the device-side early-exit flag first and returns at
// once when it has fired, so an iteration after the exit costs four empty
// launches and no memory traffic.
//
// A lane-parallel variant (each row's product over 4 lanes and a shuffle
// tree, the fill-in summed per observation pair) ran a step in 0.125 /
// 0.317 / 0.101 ms at the point+line / 15-DoF / point-only windows
// against this design's 0.141 / 0.349 / 0.117 (H100 80GB HBM3, 700 W),
// but its other sum order moved the replays' counts, which follow float32
// rounding (SLAM mode 3 at cfg.seed 4 to 58 keyframes, the tracked
// sequence's map to 29 lines), out of their reference bands.
//
// The sharded step (slice 15) splits the same step at the mesh's sum, for
// the landmark-sharded window BAs: `make_dist_liba` (plvio_tpu/parallel/
// dist_liba.py:186, through the engine's psum_axis, solver/engine.py:
// 448,472-568), `make_dist_ba` (parallel/dist_ba.py:107) and the local
// steps of `make_chain_ba` (parallel/chain_ba.py:170).
// - schur_reduce: one shard's factor and fill-in stages as above, then
//   assemble_kernel writes the shard's reduced system to global memory as
//   a full [S, S] matrix and an [S] rhs, one thread an entry: in engine
//   mode the entries of solve_kernel's system (damped by the shard's own
//   diagonal, its fixed rows frozen, as every JAX device does before the
//   psum), in raw mode H_cc - fill-in alone (dist_ba and chain_ba damp
//   after the sum).
// - schur_solve_reduced: stage 0 sums the shards' partials in shard order
//   (sum_kernel, one thread an entry); the caller all-reduces the sum
//   across processes where there are several; stage 1 solves it, the
//   same CG as above (solve_kernel / solve_global_kernel on the summed
//   system, raw mode damping and freezing it as it is read) or, for
//   dist_ba and chain_ba, a lower Cholesky and the two triangular solves
//   in one block (chol_kernel, the full matrix in shared memory, S <=
//   240); stage 2 is backsub_kernel on each shard with the summed step.
#include <cooperative_groups.h>

#include <algorithm>

#include "ba_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ba;

// ---- closed-form 3x3 Cholesky / triangular inverse (engine.py:185-218)

__device__ void chol3(const float A[3][3], float L[3][3]) {
  const float eps = 1e-20f;
  const float l11 = sqrtf(fmaxf(A[0][0], eps));
  const float l21 = A[1][0] / l11;
  const float l31 = A[2][0] / l11;
  const float l22 = sqrtf(fmaxf(A[1][1] - l21 * l21, eps));
  const float l32 = (A[2][1] - l31 * l21) / l22;
  const float l33 = sqrtf(fmaxf(A[2][2] - l31 * l31 - l32 * l32, eps));
  L[0][0] = l11; L[0][1] = 0.f; L[0][2] = 0.f;
  L[1][0] = l21; L[1][1] = l22; L[1][2] = 0.f;
  L[2][0] = l31; L[2][1] = l32; L[2][2] = l33;
}

__device__ void tri_inv3(const float L[3][3], float I[3][3]) {
  const float i11 = 1.f / L[0][0];
  const float i22 = 1.f / L[1][1];
  const float i33 = 1.f / L[2][2];
  I[0][0] = i11; I[0][1] = 0.f; I[0][2] = 0.f;
  I[1][0] = -L[1][0] * i11 * i22; I[1][1] = i22; I[1][2] = 0.f;
  I[2][0] = (L[1][0] * L[2][1] - L[2][0] * L[1][1]) * i11 * i22 * i33;
  I[2][1] = -L[2][1] * i22 * i33; I[2][2] = i33;
}

// F with F F^T = A^-1 (F = chol(A)^-T), A 3x3 or 6x6 (by 3x3 blocks)
template <int D>
__device__ void chol_invT(const float A[D][D], float F[D][D]);

template <>
__device__ void chol_invT<3>(const float A[3][3], float F[3][3]) {
  float L[3][3], Li[3][3];
  chol3(A, L);
  tri_inv3(L, Li);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) F[i][j] = Li[j][i];
}

template <>
__device__ void chol_invT<6>(const float A[6][6], float F[6][6]) {
  float A11[3][3], A21[3][3], L11[3][3], L11i[3][3], L21[3][3], S22[3][3],
      L22[3][3], L22i[3][3], T[3][3], BLi[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      A11[i][j] = A[i][j];
      A21[i][j] = A[3 + i][j];
    }
  chol3(A11, L11);
  tri_inv3(L11, L11i);
  for (int i = 0; i < 3; ++i)          // L21 = A21 L11i^T
    for (int j = 0; j < 3; ++j)
      L21[i][j] = (A21[i][0] * L11i[j][0] + A21[i][1] * L11i[j][1])
          + A21[i][2] * L11i[j][2];
  for (int i = 0; i < 3; ++i)          // S22 = A22 - L21 L21^T
    for (int j = 0; j < 3; ++j)
      S22[i][j] = A[3 + i][3 + j]
          - ((L21[i][0] * L21[j][0] + L21[i][1] * L21[j][1])
             + L21[i][2] * L21[j][2]);
  chol3(S22, L22);
  tri_inv3(L22, L22i);
  for (int i = 0; i < 3; ++i)          // T = -L22i L21
    for (int j = 0; j < 3; ++j)
      T[i][j] = (-L22i[i][0] * L21[0][j] + -L22i[i][1] * L21[1][j])
          + -L22i[i][2] * L21[2][j];
  for (int i = 0; i < 3; ++i)          // BLi = T L11i
    for (int j = 0; j < 3; ++j)
      BLi[i][j] = (T[i][0] * L11i[0][j] + T[i][1] * L11i[1][j])
          + T[i][2] * L11i[2][j];
  // Li = [[L11i, 0], [BLi, L22i]], F = Li^T
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      F[j][i] = L11i[i][j];
      F[3 + j][i] = 0.f;
      F[j][3 + i] = BLi[i][j];
      F[3 + j][3 + i] = L22i[i][j];
    }
}

template <int D>
__device__ void factor_landmark(const BA& b, int p, const float* Hpk,
                                const uint8_t* free_, const float* W,
                                const int* order, const int* start,
                                int comb0, float* Gout, float* Fout,
                                uint8_t* occ_out) {
  constexpr int NU = D * (D + 1) / 2;
  const float lam = b.at<float>(kCtrl)[cLam];
  const float lf = free_[p] ? 1.f : 0.f;
  float H[D][D], g[D], dpp[D];
  for (int i = 0; i < D; ++i) {
    for (int j = 0; j < D; ++j) H[i][j] = Hpk[p * (NU + D) + ut(D, i, j)] * lf;
    g[i] = Hpk[p * (NU + D) + NU + i] * lf;
    dpp[i] = H[i][i];
  }
  float sum = 0.f;
  for (int i = 0; i < D; ++i) sum += dpp[i];
  const float floor_ = 1e-4f * (sum / float(D));
  bool occ = sum > 1e-9f && lf != 0.f;
  for (int i = 0; i < D; ++i)
    H[i][i] = H[i][i] + ((dpp[i] * lam + floor_) + 1e-6f);
  if (!occ)
    for (int i = 0; i < D; ++i)
      for (int j = 0; j < D; ++j) H[i][j] = i == j ? 1.f : 0.f;
  float F[D][D];
  chol_invT<D>(H, F);
  bool ok = true;
  float mx = 0.f;
  for (int i = 0; i < D; ++i)
    for (int j = 0; j < D; ++j) {
      ok = ok && isfinite(F[i][j]);
      mx = fmaxf(mx, fabsf(F[i][j]));
    }
  occ = occ && ok && mx < 1e3f;
  for (int i = 0; i < D; ++i)
    for (int j = 0; j < D; ++j) {
      if (!occ) F[i][j] = 0.f;
      Fout[p * D * D + i * D + j] = F[i][j];
    }
  occ_out[p] = occ;
  float t[D];                              // t = F^T g
  for (int j = 0; j < D; ++j) {
    float a = 0.f;
    for (int i = 0; i < D; ++i) a += F[i][j] * g[i];
    t[j] = a;
  }
  float* rr = b.at<float>(kRr);
  for (int q = start[p]; q < start[p + 1]; ++q) {
    const int o = order[q];
    const float* Wo = W + o * 6 * D;
    float* Go = Gout + o * 6 * D;
    for (int i = 0; i < 6; ++i) {
      float r = 0.f;
      for (int j = 0; j < D; ++j) {
        float a = 0.f;
        for (int m = 0; m < D; ++m) a += (Wo[i * D + m] * lf) * F[m][j];
        Go[i * D + j] = a;
        r += a * t[j];
      }
      rr[(comb0 + o) * 6 + i] = r;
    }
  }
}

__global__ void factor_kernel(BA b) {
  if (b.done()) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < b.n_pt) {
    factor_landmark<3>(b, t, b.at<float>(kHpt), b.at<uint8_t>(kPtFree),
                       b.at<float>(kPW), b.at<int>(kPtOrder),
                       b.at<int>(kPtStart), 0, b.at<float>(kGpt),
                       b.at<float>(kFpt), b.at<uint8_t>(kOccPt));
  } else if (t < b.n_pt + b.n_ln) {
    factor_landmark<6>(b, t - b.n_pt, b.at<float>(kHln),
                       b.at<uint8_t>(kLnFree), b.at<float>(kLW),
                       b.at<int>(kLnOrder), b.at<int>(kLnStart), b.n_obs,
                       b.at<float>(kGln), b.at<float>(kFln),
                       b.at<uint8_t>(kOccLn));
  }
}

// ---- the fill-in Ff = Gm Gm^T (engine.py:530), sparse, in a fixed order
//
// Gm [Sp, C] is the coupling's Gram operand: column col of landmark p's
// block holds, on keyframe k's six rows, the sum of G_o over p's
// observations in k (in observation order).  Each entry of the fill-in is
// summed over the C columns in kSumChunks chunks of ceil(C / kSumChunks)
// columns, a chunk's terms in column order from 0, then the chunks in
// order from 0: the order of the dense design's tiles, so the bits stay.
// Only
// the columns of landmarks that both keyframes see add a non-zero term;
// every other column adds +-0, which moves no sum, so the walk skips them.

constexpr int kSumChunks = 24;
constexpr int kFillThreads = 256;          // also the sorted entries a pass
constexpr int kFillRecs = 6 * kFillThreads;   // records a pass, at most

// the column of combined observation o (points 3 p, lines 3 n_pt + 6 l)
__device__ __forceinline__ int obs_col(const BA& b, int o) {
  return o < b.n_obs ? 3 * b.at<int>(kObsPt)[o]
                     : 3 * b.n_pt + 6 * b.at<int>(kLobsLn)[o - b.n_obs];
}

// column entries of landmark (family D) for the block (k1, k2): g1 the
// sum of G_o over the run of k1's sorted entries from q (its observations
// of the landmark), g2 over the landmark's observations in k2 (landmark
// order); returns whether k2 sees the landmark
template <int D>
__device__ bool fill_columns(const BA& b, const float* __restrict__ G,
                             const int* __restrict__ lm_order,
                             const int* __restrict__ lm_start,
                             const int* __restrict__ obs_kf, int lm,
                             const int* __restrict__ sorted, int q, int q1,
                             const int* wcol, int w0, int col, int off,
                             int k2, float* g1, float* g2) {
#pragma unroll
  for (int e = 0; e < 6 * D; ++e) g1[e] = g2[e] = 0.f;
  for (; q < q1; ++q) {
    const int o = sorted[q];
    const int c = q - w0 < kFillThreads ? wcol[q - w0] : obs_col(b, o);
    if (c != col) break;
    const float* g = G + (o - off) * 6 * D;
#pragma unroll
    for (int e = 0; e < 6 * D; ++e) g1[e] += g[e];
  }
  bool seen = false;
  for (int j = lm_start[lm]; j < lm_start[lm + 1]; ++j) {
    const int o2 = lm_order[j];
    if (obs_kf[o2] != k2) continue;
    seen = true;
    const float* g = G + o2 * 6 * D;
#pragma unroll
    for (int e = 0; e < 6 * D; ++e) g2[e] += g[e];
  }
  return seen;
}

// a landmark's D columns as records from `first`: the column, then its
// factors on k1's six rows and on k2's
template <int D>
__device__ __forceinline__ void put_records(const float* g1, const float* g2,
                                            int col, int first, float* rec,
                                            int* rec_col) {
#pragma unroll
  for (int m = 0; m < D; ++m) {
    rec_col[first + m] = col + m;
    float* r = rec + (first + m) * 12;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      r[i] = g1[i * D + m];
      r[6 + i] = g2[i * D + m];
    }
  }
}

// Block (k1 <= k2) of the fill-in, a block of threads: k1's observations
// in column order (kf_col_order), a pass of kFillThreads at a time; the
// first entry of each landmark's run forms its columns' factors on both
// keyframes and, where k2 sees the landmark, writes them as records (a
// column and its 6 + 6 factors) in column order (a block scan of their
// counts); then thread (entry, chunk) adds its chunk's records' terms in
// order to its running sum.  The diagonal blocks also sum each keyframe's
// observations' rhs shares, in kf_order, into rr's keyframe rows.
__global__ void __launch_bounds__(kFillThreads) fill_kernel(BA b) {
  if (b.done()) return;
  extern __shared__ float rec[];           // [kFillRecs][12]: g1 [6], g2 [6]
  __shared__ int rec_col[kFillRecs];
  __shared__ float part[36][kSumChunks + 1];
  __shared__ int bound[kSumChunks + 1];
  __shared__ int wsum[kFillThreads / 32];
  __shared__ int wcol[kFillThreads + 1];   // the pass's columns; [-1] prev
  const int n = b.n_kf, tid = threadIdx.x;
  int pr = blockIdx.x, k1 = 0;             // blockIdx.x -> (k1 <= k2)
  while (pr >= n - k1) {
    pr -= n - k1;
    ++k1;
  }
  const int k2 = k1 + pr;
  const int C = b.C(), chunk = (C + kSumChunks - 1) / kSumChunks;
  for (int e = tid; e < 36 * kSumChunks; e += kFillThreads)
    part[e / kSumChunks][e % kSumChunks] = 0.f;
  __syncthreads();               // a keyframe without observations: no pass
  const int* start = b.at<int>(kKfStart);
  const int* sorted = b.at<int>(kKfColOrder);
  const int q0 = start[k1], q1 = start[k1 + 1];
  for (int w0 = q0; w0 < q1; w0 += kFillThreads) {
    const int q = w0 + tid;
    int o = 0, col = -1;
    if (q < q1) {
      o = sorted[q];
      col = obs_col(b, o);
    }
    wcol[tid + 1] = col;
    if (tid == 0) wcol[0] = w0 > q0 ? obs_col(b, sorted[w0 - 1]) : -1;
    __syncthreads();
    float g1[36], g2[36];
    int cols = 0;
    if (q < q1 && wcol[tid] != col) {      // the first of its landmark's run
      const bool pt = o < b.n_obs;
      const bool seen = pt
          ? fill_columns<3>(b, b.at<float>(kGpt), b.at<int>(kPtOrder),
                            b.at<int>(kPtStart), b.at<int>(kObsKf),
                            b.at<int>(kObsPt)[o], sorted, q, q1, wcol + 1,
                            w0, col, 0, k2, g1, g2)
          : fill_columns<6>(b, b.at<float>(kGln), b.at<int>(kLnOrder),
                            b.at<int>(kLnStart), b.at<int>(kLobsKf),
                            b.at<int>(kLobsLn)[o - b.n_obs], sorted, q, q1,
                            wcol + 1, w0, col, b.n_obs, k2, g1, g2);
      cols = seen ? (pt ? 3 : 6) : 0;
    }
    // exclusive scan of the record counts (warp shuffles, warps in order)
    const int lane = tid & 31, warp = tid >> 5;
    int incl = cols;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int base = 0, total = 0;
    for (int w = 0; w < kFillThreads / 32; ++w) {
      base += w < warp ? wsum[w] : 0;
      total += wsum[w];
    }
    const int first = base + incl - cols;
    if (cols == 3)
      put_records<3>(g1, g2, col, first, rec, rec_col);
    else if (cols == 6)
      put_records<6>(g1, g2, col, first, rec, rec_col);
    __syncthreads();
    // each chunk's records: [bound[c], bound[c + 1]) (columns ascending)
    if (tid <= kSumChunks) {
      const int lim = tid * chunk;
      int lo = 0, hi = total;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (rec_col[mid] < lim) lo = mid + 1;
        else hi = mid;
      }
      bound[tid] = lo;
    }
    __syncthreads();
    // task (chunk, entry): a warp's threads mostly share a chunk, so they
    // walk the same records in step
    for (int e = tid; e < 36 * kSumChunks; e += kFillThreads) {
      const int c = e / 36, ab = e % 36;
      const float* ra = rec + ab / 6;
      const float* rb = rec + 6 + ab % 6;
      float acc = part[ab][c];
      int r = bound[c];
      const int re = bound[c + 1];
      for (; r + 4 <= re; r += 4) {
        float t[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) t[u] = ra[(r + u) * 12] * rb[(r + u) * 12];
#pragma unroll
        for (int u = 0; u < 4; ++u) acc += t[u];
      }
      for (; r < re; ++r) acc += ra[r * 12] * rb[r * 12];
      part[ab][c] = acc;
    }
    __syncthreads();
  }
  const int Sp = b.Sp();
  if (tid < 36) {
    const int a = tid / 6, bb = tid % 6;
    float v = 0.f;
    for (int c = 0; c < kSumChunks; ++c) v += part[tid][c];
    float* ff = b.at<float>(kFf);
    ff[(6 * k1 + a) * Sp + 6 * k2 + bb] = v;
    if (k1 != k2) ff[(6 * k2 + bb) * Sp + 6 * k1 + a] = v;
  }
  if (k1 != k2) return;
  // keyframe k1's rhs share, its observations in kf_order from 0: the
  // shares gathered into shared memory by the block, a pass at a time,
  // then summed in order by six threads
  const int* order = b.at<int>(kKfOrder);
  float* rr = b.at<float>(kRr);
  float v = 0.f;
  for (int w0 = q0; w0 < q1; w0 += kFillRecs * 2) {
    const int nw = min(q1 - w0, kFillRecs * 2);
    __syncthreads();
    for (int e = tid; e < nw * 6; e += kFillThreads)
      rec[e] = rr[order[w0 + e / 6] * 6 + e % 6];
    __syncthreads();
    if (tid >= 36 && tid < 42) {
      const float* sh6 = rec + tid - 36;
      int q = 0;
      for (; q + 8 <= nw; q += 8) {
        float t[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) t[u] = sh6[(q + u) * 6];
#pragma unroll
        for (int u = 0; u < 8; ++u) v += t[u];
      }
      for (; q < nw; ++q) v += sh6[q * 6];
    }
  }
  if (tid >= 36 && tid < 42) rr[(b.n_obs + b.n_lobs + k1) * 6 + tid - 36] = v;
}

// ---- the reduced system

// dense index -> (keyframe, index in its 15-DoF state: pose 0-5, vel 6-8,
// bg 9-11, ba 12-14)
__host__ __device__ __forceinline__ void dense_to_kf(int d, int n, int& k,
                                                     int& l) {
  if (d < 6 * n) {
    k = d / 6;
    l = d % 6;
  } else {
    d -= 6 * n;                        // family: 0 vel, 1 bg, 2 ba
    const int fam = d < 3 * n ? 0 : d < 6 * n ? 1 : 2;
    d -= fam * 3 * n;
    k = d / 3;
    l = 6 + 3 * fam + d % 3;
  }
}

// the chain's H entry (i, j): links k-1 and k in link order on keyframe
// k's block, link k on the (k, k+1) block
__device__ float chain_h(const BA& b, int i, int j) {
  const int n = b.n_kf;
  int ki, li, kj, lj;
  dense_to_kf(i, n, ki, li);
  dense_to_kf(j, n, kj, lj);
  const float* link = b.at<float>(kLink);
  if (ki == kj) {
    float v = 0.f;
    if (ki > 0) v += link[(ki - 1) * kLinkFloats + ut(30, 15 + li, 15 + lj)];
    if (ki < n - 1) v += link[ki * kLinkFloats + ut(30, li, lj)];
    return v;
  }
  if (kj == ki + 1) return link[ki * kLinkFloats + ut(30, li, 15 + lj)];
  if (ki == kj + 1) return link[kj * kLinkFloats + ut(30, 15 + li, lj)];
  return 0.f;
}

__device__ float chain_g(const BA& b, int i) {
  const int n = b.n_kf;
  int k, l;
  dense_to_kf(i, n, k, l);
  const float* link = b.at<float>(kLink);
  float v = 0.f;
  if (k > 0) v += link[(k - 1) * kLinkFloats + 465 + 15 + l];
  if (k < n - 1) v += link[k * kLinkFloats + 465 + l];
  return v;
}

// 1 where row i's state is free: pose and velocity rows by kf_free, bias
// rows by kf_free_bias
__device__ __forceinline__ float row_free(const BA& b, int i) {
  int k, l;
  dense_to_kf(i, b.n_kf, k, l);
  return (l < 9 ? b.at<uint8_t>(kKfFree)[k]
                : b.at<uint8_t>(kKfFreeBias)[k]) ? 1.f : 0.f;
}

// entry (i, j), i <= j, of the damped reduced system with the fixed rows
// frozen (fi, fj: the rows' free masks)
__device__ __forceinline__ float reduced_h(const BA& b, int i, int j,
                                           float lam, float fi, float fj) {
  const int Sp = b.Sp();
  const float* hcc = b.at<float>(kHcc);
  float v = j < Sp && i / 6 == j / 6
      ? hcc[(i / 6) * 27 + ut(6, i % 6, j % 6)] : 0.f;
  if (b.body) v = v + chain_h(b, i, j);
  if (i == j) v = v + (v * lam + 1e-6f);
  if (j < Sp) v = v - b.at<float>(kFf)[i * Sp + j];
  return v * fi * fj + (i == j ? 1.f - fi : 0.f);
}

// row i of the reduced right-hand side: the keyframe's gradient minus its
// observations' Schur shares (summed by fill_kernel into rr's keyframe
// rows), the chain's gradient
__device__ __forceinline__ float reduced_rhs(const BA& b, int i, float fi) {
  const int Sp = b.Sp();
  float gv = 0.f, a = 0.f;
  if (i < Sp) {
    a = b.at<float>(kRr)[(b.n_obs + b.n_lobs) * 6 + i];
    gv = b.at<float>(kHcc)[(i / 6) * 27 + 21 + i % 6];
  }
  if (b.body) gv = gv + chain_g(b, i);
  return (gv - a) * fi;
}

// the reduced system of the single-device step: assembled from the
// keyframe blocks, the chain's links and the fill-in (reduced_h / _rhs)
struct FromBlocks {
  __device__ __forceinline__ float h(const BA& b, int i, int j, float lam,
                                     float fi, float fj) const {
    return reduced_h(b, i, j, lam, fi, fj);
  }
  __device__ __forceinline__ float r(const BA& b, int i, float fi) const {
    return reduced_rhs(b, i, fi);
  }
};

// the mesh's summed system of the sharded step (schur_solve_reduced): in
// engine mode every shard damped and froze its own partial, so the sum is
// solved as it is; in raw mode (dist_ba, chain_ba) the sum is damped once,
// H + diag(diag(H) lambda + 1e-6), and its fixed rows frozen here
struct FromSum {
  const float* H;
  const float* rhs;
  int raw;
  __device__ __forceinline__ float h(const BA& b, int i, int j, float lam,
                                     float fi, float fj) const {
    float v = H[size_t(i) * b.Sd() + j];
    if (!raw) return v;
    if (i == j) v = v + (v * lam + 1e-6f);
    return v * fi * fj + (i == j ? 1.f - fi : 0.f);
  }
  __device__ __forceinline__ float r(const BA& b, int i, float fi) const {
    return raw ? rhs[i] * fi : rhs[i];
  }
};

// ---- the reduced solve: one block

constexpr int kSolveThreads = 256;       // the CG's threads
constexpr int kSolveBlock = 1024;        // all of them assemble the system
constexpr int kRowsMax = 2;              // rows a thread: S <= 512
constexpr int kSolveWarps = kSolveThreads / 32;
constexpr int kBlockWarps = kSolveBlock / 32;

// the smallest length >= len that is 1 (mod 32): thread t walking row t
// and its warp's neighbours walking theirs read 32 different banks
__host__ __device__ __forceinline__ int pad_row(int len) {
  return (len + 30) / 32 * 32 + 1;
}

// Row i's stored columns in increasing order: [c0, c0 + len) and, in the
// 15-DoF window, each family's keyframe-tridiagonal columns [6n + 3n f +
// c1, + len1) (f = vel, bg, ba).  Pose rows: every pose column (the
// fill-in is dense there); velocity and bias rows: the pose columns of
// keyframes k-1..k+1.  Every other entry of the system is exactly 0: the
// chain couples neighbouring keyframes only, the fill-in and the visual
// blocks the pose rows only (KN.cg_pattern is the same rule).
struct RowSegs {
  int c0, len, c1, len1;
};

__host__ __device__ __forceinline__ RowSegs row_segs(int i, int n,
                                                     int body) {
  if (!body) return {0, 6 * n, 0, 0};
  int k, l;
  dense_to_kf(i, n, k, l);
  const int lo = k > 0 ? k - 1 : 0, hi = k < n - 1 ? k + 1 : n - 1;
  const int m = hi - lo + 1;
  if (i < 6 * n) return {0, 6 * n, 3 * lo, 3 * m};
  return {6 * lo, 6 * m, 3 * lo, 3 * m};
}

// where the rows live in shared memory: the pose rows (the first 6n) at a
// stride of the longest one's padded length, the 15-DoF window's other
// rows after them at theirs
struct RowLayout {
  int S, n, body, sp, sn;
  __host__ __device__ RowLayout(int S_, int n_, int body_)
      : S(S_), n(n_), body(body_) {
    const int m = n < 3 ? n : 3;
    sp = pad_row(6 * n + (body ? 9 * m : 0));
    sn = pad_row(15 * m);
  }
  __host__ __device__ int off(int i) const {
    return i < 6 * n ? i * sp : 6 * n * sp + (i - 6 * n) * sn;
  }
  __host__ __device__ size_t floats() const {
    return size_t(6 * n) * sp + (body ? size_t(S - 6 * n) * sn : 0);
  }
};

// a + sum_e v[e] p[e] for e < len, added in order, the next eight terms'
// loads in flight while eight are added
__device__ __forceinline__ float serial_dot(float a, const float* v,
                                            const float* p, int len) {
  constexpr int U = 8;
  int e = 0;
  float w[U], q[U];
  if (len >= U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      w[u] = v[u];
      q[u] = p[u];
    }
    for (e = U; e + U <= len; e += U) {
      float t[U];
#pragma unroll
      for (int u = 0; u < U; ++u) t[u] = w[u] * q[u];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        w[u] = v[e + u];
        q[u] = p[e + u];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) a += t[u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) a += w[u] * q[u];
  }
  for (; e < len; ++e) a += v[e] * p[e];
  return a;
}

// The system in full rows (RowSegs); a thread walks its row's stored
// columns in order, the order of the dense row walk (its structural
// zeros added +-0, which moves no sum)
struct FullRows {
  RowLayout lay;
  __host__ __device__ size_t floats() const { return lay.floats(); }
  // the damped, frozen entries of src, a warp a row (entry (i, j) from the
  // upper triangle, as every reader of the system takes it), four entries
  // a lane at a time so that their reads are in flight together
  // (rows w0 + this block's warp, then every `ws` rows on)
  template <class Src>
  __device__ void fill(const BA& b, const Src& src, float* H,
                       const float* fr, float lam, int w0, int ws) const {
    const int lane = threadIdx.x & 31;
    for (int i = w0 + (threadIdx.x >> 5); i < lay.S; i += ws) {
      const RowSegs g = row_segs(i, lay.n, lay.body);
      float* row = H + lay.off(i);
      const int cnt = g.len + (lay.body ? 3 * g.len1 : 0);
      for (int t0 = lane; t0 < cnt; t0 += 4 * 32) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = t0 + 32 * u;
          int j = g.c0 + t;
          if (t >= g.len) {
            const int w = t - g.len, f = w / g.len1;
            j = 6 * lay.n + 3 * lay.n * f + g.c1 + w % g.len1;
          }
          const int lo = min(i, j), hi = max(i, j);
          v[u] = t < cnt ? src.h(b, lo, hi, lam, fr[lo], fr[hi]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (t0 + 32 * u < cnt) row[t0 + 32 * u] = v[u];
      }
    }
  }
  __device__ float dot(const float* H, int i, const float* p) const {
    return row_dot(H + lay.off(i), i, p);
  }
  // row i's product with p from its stored entries v
  __device__ float row_dot(const float* v, int i, const float* p) const {
    const RowSegs g = row_segs(i, lay.n, lay.body);
    float a = serial_dot(0.f, v, p + g.c0, g.len);
    if (lay.body) {
      v += g.len;
      for (int f = 0; f < 3; ++f, v += g.len1)
        a = serial_dot(a, v, p + 6 * lay.n + 3 * lay.n * f + g.c1, g.len1);
    }
    return a;
  }
};

// the dense design's block sum of a thread's value v: the warp's
// butterfly, then the
// warps' partials added in warp order (every thread the same bits); the
// partials written to part after the barrier the caller takes
__device__ __forceinline__ void warp_partial(float v, float* part) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
}

__device__ __forceinline__ float warps_total(const float* part) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kSolveWarps; ++w) s += part[w];
  return s;
}

// The damped, frozen reduced system of `src` in shared memory in full
// rows, then the fixed-step CG in the dense design's arithmetic:
// thread t owns
// rows t and t + 256 and keeps their x, r and p in registers (p also in
// shared memory for the products); a row's product walks its columns in
// order; p.Hp and r.r are the dense design's block sums, formed in the
// same pass as the product and the update.  Three barriers an iteration:
// after p.Hp's warp partials, after r.r's, after the new p.
template <class Src>
__global__ void __launch_bounds__(kSolveBlock) solve_kernel(BA b, Src src,
                                                            FullRows lay) {
  if (b.done()) return;
  extern __shared__ float sh[];
  const int S = b.Sd();
  float* H = sh;
  float* p = H + lay.floats();   // [S]
  float* fr = p + S;             // [S] free mask
  float* wa = fr + S;            // [kSolveWarps] p.Hp's warp partials
  float* wb = wa + kSolveWarps;  // [kSolveWarps] r.r's
  const float lam = b.at<float>(kCtrl)[cLam];
  for (int i = threadIdx.x; i < S; i += kSolveBlock) fr[i] = row_free(b, i);
  __syncthreads();
  lay.fill(b, src, H, fr, lam, 0, kBlockWarps);
  // the CG's threads: the block's first kSolveThreads; the others only
  // keep the barriers
  const bool cg = threadIdx.x < kSolveThreads;
  bool own[kRowsMax];
  float x[kRowsMax], r[kRowsMax], pv[kRowsMax];
  float t = 0.f;
#pragma unroll
  for (int m = 0; m < kRowsMax; ++m) {
    const int i = threadIdx.x + m * kSolveThreads;
    own[m] = cg && i < S;
    const float rhs = own[m] ? src.r(b, i, fr[i]) : 0.f;
    x[m] = 0.f;
    r[m] = rhs;
    pv[m] = rhs;
    if (own[m]) {
      p[i] = rhs;
      t += rhs * rhs;
    }
  }
  if (cg) warp_partial(t, wb);
  __syncthreads();               // the system, p and r.r's partials
  float rs = cg ? warps_total(wb) : 0.f;
  for (int it = 0; it < b.cg_iters; ++it) {
    float hp[kRowsMax];
    if (cg) {
      t = 0.f;
#pragma unroll
      for (int m = 0; m < kRowsMax; ++m)
        if (own[m]) {
          hp[m] = lay.dot(H, threadIdx.x + m * kSolveThreads, p);
          t += pv[m] * hp[m];
        }
      warp_partial(t, wa);
    }
    __syncthreads();             // 1: p.Hp
    if (cg) {
      const float alpha = rs / fmaxf(warps_total(wa), 1e-20f);
      t = 0.f;
#pragma unroll
      for (int m = 0; m < kRowsMax; ++m)
        if (own[m]) {
          x[m] = x[m] + alpha * pv[m];
          r[m] = r[m] - alpha * hp[m];
          t += r[m] * r[m];
        }
      warp_partial(t, wb);
    }
    __syncthreads();             // 2: r.r
    if (cg) {
      const float rs_new = warps_total(wb);
      const float beta = rs_new / fmaxf(rs, 1e-20f);
#pragma unroll
      for (int m = 0; m < kRowsMax; ++m)
        if (own[m]) {
          pv[m] = r[m] + beta * pv[m];
          p[threadIdx.x + m * kSolveThreads] = pv[m];
        }
      rs = rs_new;
    }
    __syncthreads();             // 3: the new p
  }
  float* dx = b.at<float>(kDx);
#pragma unroll
  for (int m = 0; m < kRowsMax; ++m) {
    const int i = threadIdx.x + m * kSolveThreads;
    if (own[m]) dx[i] = x[m] * fr[i];
  }
}

// ---- the reduced solve beyond one block: assembly over the card, the CG
//      on a thread-block cluster

constexpr int kAsmThreads = 256;          // assemble_rows_kernel: 8 rows
constexpr int kClusterThreads = 256;      // a CTA's threads, at least
constexpr int kCluster = 16;             // CTAs (H100: non-portable size)
constexpr size_t kBarBytes = 64;          // cg_cluster_kernel's mbarriers

// The damped, frozen system of src in FullRows' layout into the global
// workspace, a warp a row (FullRows::fill), the rows spread over the grid
template <class Src>
__global__ void __launch_bounds__(kAsmThreads)
    assemble_rows_kernel(BA b, Src src, FullRows lay) {
  if (b.done()) return;
  extern __shared__ float fr[];              // [S] free mask
  const int S = b.Sd();
  for (int i = threadIdx.x; i < S; i += blockDim.x) fr[i] = row_free(b, i);
  __syncthreads();
  constexpr int wpb = kAsmThreads / 32;
  lay.fill(b, src, b.at<float>(kCgw), fr, b.at<float>(kCtrl)[cLam],
           blockIdx.x * wpb, gridDim.x * wpb);
}

// a warp's butterfly sum of v (every lane the same bits)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the dense design's tree over the warps' sums g [nw]: per 128 rows the
// four warps in order (a missing warp adds +0), then those groups in
// order, each from +0 (every thread the same bits)
__device__ __forceinline__ float rows_total(const float* g, int nw) {
  float s = 0.f;
  for (int w0 = 0; w0 < nw; w0 += 4) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) t += w0 + k < nw ? g[w0 + k] : 0.f;
    s += t;
  }
  return s;
}

// ---- distributed shared memory: asynchronous stores that complete a
//      transaction count on the receiver's mbarrier

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the address `a` (this CTA's shared memory) in CTA `rank`'s
__device__ __forceinline__ unsigned cluster_addr(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

// this phase's one arrival, expecting `bytes` from the stores
__device__ __forceinline__ void mbar_expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

// v into CTA rank's address a (this CTA's layout), completing 4 bytes on
// that CTA's mbarrier bar
__device__ __forceinline__ void send(unsigned a, float v, unsigned bar,
                                     int rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(cluster_addr(a, rank)), "r"(__float_as_uint(v)),
      "r"(cluster_addr(bar, rank)) : "memory");
}

// wait for the phase of parity `ph` to complete, then flip ph
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned& ph) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0],"
      " %1;\n @!done bra WAIT_%=;\n}" ::"r"(bar), "r"(ph) : "memory");
  ph ^= 1u;
}

// The same fixed-step CG as solve_kernel on the system assemble_rows_kernel
// wrote, on one cluster: CTA c < na owns warps [c wpc, (c + 1) wpc) of 32
// rows each (thread t of its first wpc warps owns row 32 (c wpc) + t),
// their stored rows in its shared memory (InSmem) or read from the
// workspace, and a copy of the whole p.  Nothing waits on the whole
// cluster inside the loop: a warp's p.Hp and r.r sums and each row's new
// p are stored into every active CTA's shared memory by st.async, each
// completing bytes on that CTA's mbarrier for the vector (ga, gb, p),
// and a CTA waits for its own mbarrier's phase: the S or ceil(S / 32)
// values of this step.  A buffer is written again only after every warp
// has read it, since every warp's next contribution follows its reads
// (the new p follows r.r's sums, which follow the product that read p;
// the next p.Hp sums follow the product, which follows the new p), so
// one copy of each suffices.
template <class Src, bool InSmem>
__global__ void cg_cluster_kernel(BA b, Src src, FullRows lay, int wpc) {
  if (b.done()) return;
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ float sh[];
  __shared__ alignas(8) unsigned long long bar[3];    // ga, gb, p
  const int S = b.Sd(), nw = (S + 31) / 32, na = (nw + wpc - 1) / wpc;
  const int c = int(cl.block_rank());
  float* p = sh;                             // [S]
  float* ga = p + S;                         // [nw] p.Hp's warp sums
  float* gb = ga + nw;                       // [nw] r.r's
  float* rows = gb + nw;                     // the CTA's rows (InSmem)
  const int r0 = min(S, 32 * wpc * c), r1 = min(S, 32 * wpc * (c + 1));
  const int base = lay.lay.off(r0);
  const float* H = b.at<float>(kCgw);
  if (InSmem)
    for (int e = threadIdx.x; e < lay.lay.off(r1) - base; e += blockDim.x)
      rows[e] = H[base + e];
  const float* R = InSmem ? rows : H + base;
  const unsigned bA = smem_u32(&bar[0]), bB = smem_u32(&bar[1]),
                 bP = smem_u32(&bar[2]);
  if (threadIdx.x == 0 && c < na) {
    mbar_init(bA);
    mbar_init(bB);
    mbar_init(bP);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(bA, 4 * nw);
    mbar_expect(bB, 4 * nw);
    mbar_expect(bP, 4 * S);
  }
  const int lane = threadIdx.x & 31, w = wpc * c + (threadIdx.x >> 5);
  const bool cgw = int(threadIdx.x >> 5) < wpc && w < nw;
  const int i = 32 * w + lane;
  const bool own = cgw && i < S;
  cl.sync();                         // every CTA runs, its mbarriers set
  if (cgw) {
    const float fi = own ? row_free(b, i) : 0.f;
    float x = 0.f, r = own ? src.r(b, i, fi) : 0.f, pv = r;
    unsigned pa = 0, pb = 0, pp = 0;           // the phases' parities
    const bool arm = threadIdx.x == 0;
    if (own)
      for (int k = 0; k < na; ++k) send(smem_u32(p + i), pv, bP, k);
    float t = warp_sum(r * r);
    if (lane < na) send(smem_u32(gb + w), t, bB, lane);
    mbar_wait(bB, pb);
    if (arm) mbar_expect(bB, 4 * nw);
    float rs = rows_total(gb, nw);
    for (int it = 0; it < b.cg_iters; ++it) {
      const bool more = it + 1 < b.cg_iters;
      mbar_wait(bP, pp);
      if (arm && more) mbar_expect(bP, 4 * S);
      const float hp =
          own ? lay.row_dot(R + (lay.lay.off(i) - base), i, p) : 0.f;
      t = warp_sum(pv * hp);
      if (lane < na) send(smem_u32(ga + w), t, bA, lane);
      mbar_wait(bA, pa);                     // 1: p.Hp
      if (arm && more) mbar_expect(bA, 4 * nw);
      const float alpha = rs / fmaxf(rows_total(ga, nw), 1e-20f);
      x = x + alpha * pv;
      r = r - alpha * hp;
      t = warp_sum(r * r);
      if (lane < na) send(smem_u32(gb + w), t, bB, lane);
      mbar_wait(bB, pb);                     // 2: r.r
      if (arm && more) mbar_expect(bB, 4 * nw);
      const float rs_new = rows_total(gb, nw);
      const float beta = rs_new / fmaxf(rs, 1e-20f);
      pv = r + beta * pv;
      if (own && more)                       // 3: the new p
        for (int k = 0; k < na; ++k) send(smem_u32(p + i), pv, bP, k);
      rs = rs_new;
    }
    if (own) b.at<float>(kDx)[i] = x * fi;
  }
  cl.sync();                         // no CTA leaves while others store
}

// ---- back-substitution and retraction into the candidate state

__device__ void so3_exp_V(const float w[3], float R[3][3], float V[3][3]) {
  const float th2 = (w[0] * w[0] + w[1] * w[1]) + w[2] * w[2];
  const bool small = th2 < 1e-6f;
  const float th = small ? 1.f : sqrtf(fmaxf(th2, 1e-24f));
  const float t2 = small ? 1.f : th2;
  const float A = small ? 1.f - th2 / 6.f : sinf(th) / th;
  const float B = small ? 0.5f - th2 / 24.f : (1.f - cosf(th)) / t2;
  const float Cc = small ? 1.f / 6.f - th2 / 120.f : (th - sinf(th)) / (t2 * th);
  const float W[3][3] = {{0.f, -w[2], w[1]}, {w[2], 0.f, -w[0]},
                         {-w[1], w[0], 0.f}};
  float W2[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[i][j] = (W[i][0] * W[0][j] + W[i][1] * W[1][j]) + W[i][2] * W[2][j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float I = i == j ? 1.f : 0.f;
      R[i][j] = (I + A * W[i][j]) + B * W2[i][j];
      V[i][j] = (I + B * W[i][j]) + Cc * W2[i][j];
    }
}

// so3_normalize (Gram-Schmidt on the rows) of Rn into out's rotation
__device__ void normalize_into(const float Rn[3][3], float* out) {
  float r0[3], r1[3];
  float n0 = fmaxf(sqrtf((Rn[0][0] * Rn[0][0] + Rn[0][1] * Rn[0][1])
                         + Rn[0][2] * Rn[0][2]), 1e-12f);
  for (int j = 0; j < 3; ++j) r0[j] = Rn[0][j] / n0;
  const float dp = (Rn[1][0] * r0[0] + Rn[1][1] * r0[1]) + Rn[1][2] * r0[2];
  for (int j = 0; j < 3; ++j) r1[j] = Rn[1][j] - dp * r0[j];
  const float n1 = fmaxf(sqrtf((r1[0] * r1[0] + r1[1] * r1[1]) + r1[2] * r1[2]),
                         1e-12f);
  for (int j = 0; j < 3; ++j) r1[j] = r1[j] / n1;
  const float r2[3] = {r0[1] * r1[2] - r0[2] * r1[1],
                       r0[2] * r1[0] - r0[0] * r1[2],
                       r0[0] * r1[1] - r0[1] * r1[0]};
  for (int j = 0; j < 3; ++j) {
    out[j] = r0[j];
    out[4 + j] = r1[j];
    out[8 + j] = r2[j];
  }
}

// T_cw <- Exp(d) T_cw
__device__ void retract_pose(const float* P, const float* d, float* out) {
  float Rd[3][3], V[3][3];
  so3_exp_V(d + 3, Rd, V);
  float Rn[3][3], tn[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      Rn[i][j] = (Rd[i][0] * P[j] + Rd[i][1] * P[4 + j]) + Rd[i][2] * P[8 + j];
    tn[i] = ((Rd[i][0] * P[3] + Rd[i][1] * P[7]) + Rd[i][2] * P[11])
        + ((V[i][0] * d[0] + V[i][1] * d[1]) + V[i][2] * d[2]);
  }
  normalize_into(Rn, out);
  out[3] = tn[0];
  out[7] = tn[1];
  out[11] = tn[2];
}

// pose_wb: R <- R Exp(dtheta), p <- p + dp (d = (dp, dtheta))
__device__ void retract_pose_wb(const float* P, const float* d, float* out) {
  float Rd[3][3], V[3][3];
  so3_exp_V(d + 3, Rd, V);
  float Rn[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      Rn[i][j] = (P[4 * i] * Rd[0][j] + P[4 * i + 1] * Rd[1][j])
          + P[4 * i + 2] * Rd[2][j];
  normalize_into(Rn, out);
  for (int i = 0; i < 3; ++i) out[4 * i + 3] = P[4 * i + 3] + d[i];
}

template <int D>
__device__ void backsub_landmark(const BA& b, int p, const float* Hpk,
                                 const uint8_t* free_, const float* W,
                                 const int* order, const int* start,
                                 const int* obs_kf, const float* Fin,
                                 const uint8_t* occ, const float* X,
                                 float* Xc) {
  constexpr int NU = D * (D + 1) / 2;
  const float lf = free_[p] ? 1.f : 0.f;
  const float* dx = b.at<float>(kDx);
  float rhs[D];
  for (int i = 0; i < D; ++i) rhs[i] = Hpk[p * (NU + D) + NU + i] * lf;
  for (int q = start[p]; q < start[p + 1]; ++q) {
    const int o = order[q];
    const float* Wo = W + o * 6 * D;
    const float* d = dx + obs_kf[o] * 6;
    for (int j = 0; j < D; ++j) {
      float a = 0.f;
      for (int i = 0; i < 6; ++i) a += (Wo[i * D + j] * lf) * d[i];
      rhs[j] = rhs[j] - a;
    }
  }
  const float* F = Fin + p * D * D;
  const float on = occ[p] ? 1.f : 0.f;
  for (int i = 0; i < D; ++i) {
    float a = 0.f;
    for (int k = 0; k < D; ++k) {
      float dinv = 0.f;                    // (F F^T)_ik
      for (int j = 0; j < D; ++j) dinv += F[i * D + j] * F[k * D + j];
      a += dinv * rhs[k];
    }
    Xc[p * D + i] = X[p * D + i] + a * on;
  }
}

__global__ void backsub_kernel(BA b) {
  if (b.done()) return;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < b.n_kf) {
    const float* dx = b.at<float>(kDx);
    if (b.body) {
      retract_pose_wb(b.at<float>(kPoses) + t * 12, dx + t * 6,
                      b.at<float>(kCPoses) + t * 12);
      const int n = b.n_kf;
      const float* x = b.at<float>(kKfX) + t * 9;
      float* xc = b.at<float>(kCKfX) + t * 9;
      for (int f = 0; f < 3; ++f)           // vel, bg, ba
        for (int c = 0; c < 3; ++c)
          xc[3 * f + c] = x[3 * f + c] + dx[(6 + 3 * f) * n + 3 * t + c];
    } else {
      retract_pose(b.at<float>(kPoses) + t * 12, dx + t * 6,
                   b.at<float>(kCPoses) + t * 12);
    }
  } else if ((t -= b.n_kf) < b.n_pt) {
    backsub_landmark<3>(b, t, b.at<float>(kHpt), b.at<uint8_t>(kPtFree),
                        b.at<float>(kPW), b.at<int>(kPtOrder),
                        b.at<int>(kPtStart), b.at<int>(kObsKf),
                        b.at<float>(kFpt), b.at<uint8_t>(kOccPt),
                        b.at<float>(kPts), b.at<float>(kCPts));
  } else if ((t -= b.n_pt) < b.n_ln) {
    backsub_landmark<6>(b, t, b.at<float>(kHln), b.at<uint8_t>(kLnFree),
                        b.at<float>(kLW), b.at<int>(kLnOrder),
                        b.at<int>(kLnStart), b.at<int>(kLobsKf),
                        b.at<float>(kFln), b.at<uint8_t>(kOccLn),
                        b.at<float>(kLns), b.at<float>(kCLns));
  }
}

inline int blocks(int n, int t) { return (n + t - 1) / t; }

// the landmark stages' blocks: one warp each, so that the ~4600
// landmarks of a window spread over every SM (a thread each)
constexpr int kLmThreads = 32;

constexpr size_t kSmemMax = 232448;

// the one-block solve's layout of b's reduced system
inline FullRows rows_of(const BA& b) {
  return FullRows{RowLayout(b.Sd(), b.n_kf, b.body)};
}

// the one-block solve's shared memory: the system in full rows, p, the
// free mask and two rows of warp partials
inline size_t cg_smem(const BA& b) {
  return (rows_of(b).floats() + 2 * size_t(b.Sd()) + 2 * kSolveWarps) *
         sizeof(float);
}

// the largest reduced system the one-block solve takes: a 15-DoF window
// of up to 22 keyframes.  Its rows would fit up to 29, but the windows
// from 23 keyframes keep the global path, whose arithmetic the card tests
// hold there.
constexpr int kOneBlockMaxS = 330;

// Whether the reduced system takes the one-block solve: S <= 330 and its
// full rows and vectors fit one block's shared memory (the rule
// KN.solve_fits repeats: up to 37 keyframes in a point+line window, 22
// in a 15-DoF one); beyond it the global path.
inline bool one_block(const BA& b) {
  return b.Sd() <= kOneBlockMaxS && cg_smem(b) <= kSmemMax;
}

// the global path's workspace holds b's system in full rows
// (ints[kCgwFloats])
inline bool cgw_fits(const BA& b, const int* ints) {
  return size_t(ints[kCgwFloats]) >= rows_of(b).floats();
}

// the fill-in's launch: a block a keyframe pair, its records in dynamic
// shared memory
int launch_fill(const BA& b, cudaStream_t s) {
  const int smem = kFillRecs * 12 * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fill_kernel<<<b.n_kf * (b.n_kf + 1) / 2, kFillThreads, smem, s>>>(b);
  return 0;
}

template <class Src>
int launch_cg_block(const BA& b, Src src, cudaStream_t s) {
  const size_t smem = cg_smem(b);
  const cudaError_t e = cudaFuncSetAttribute(
      solve_kernel<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  solve_kernel<Src><<<1, kSolveBlock, smem, s>>>(b, src, rows_of(b));
  return 0;
}

// the global path: assemble_rows_kernel over S / 8 blocks, then
// cg_cluster_kernel on a cluster of 16 CTAs, each CTA's rows in its shared
// memory where they fit
template <class Src>
int launch_solve_global(const BA& b, Src src, cudaStream_t s) {
  const int S = b.Sd(), nw = blocks(S, 32), wpc = blocks(nw, kCluster);
  const FullRows lay = rows_of(b);
  const size_t asm_smem = size_t(S) * sizeof(float);
  // p, the two rows of warp sums and, where they fit, the rows (the
  // mbarriers take kBarBytes of static shared memory)
  size_t region = 0;                         // the widest CTA's rows
  for (int c = 0; c < kCluster; ++c) {
    const int r0 = std::min(S, 32 * wpc * c);
    const int r1 = std::min(S, 32 * wpc * (c + 1));
    region = std::max(region, size_t(lay.lay.off(r1) - lay.lay.off(r0)));
  }
  const size_t vecs = (size_t(S) + 2 * nw) * sizeof(float);
  const bool in_smem = vecs + region * sizeof(float) + kBarBytes <= kSmemMax;
  const size_t smem = in_smem ? vecs + region * sizeof(float) : vecs;
  if (asm_smem > kSmemMax || smem + kBarBytes > kSmemMax || 32 * wpc > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = in_smem ? cg_cluster_kernel<Src, true>
                        : cg_cluster_kernel<Src, false>;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(assemble_rows_kernel<Src>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(asm_smem))) != cudaSuccess ||
      (e = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess ||
      (e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem))) != cudaSuccess)
    return static_cast<int>(e);
  assemble_rows_kernel<Src><<<blocks(S, kAsmThreads / 32), kAsmThreads,
                              asm_smem, s>>>(b, src, lay);
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = kCluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(std::max(kClusterThreads, 32 * wpc));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, kernel, b, src, lay, wpc));
}

// The reduced solve of src's system into dx: one block where its full
// rows fit, else the global path.  ints[kSolvePath] reports the path (0
// one block, 1 global); the caller has checked the global path's
// workspace.
template <class Src>
int launch_cg(const BA& b, Src src, int* ints, cudaStream_t s) {
  if (!one_block(b)) {
    ints[kSolvePath] = 1;
    return launch_solve_global(b, src, s);
  }
  ints[kSolvePath] = 0;
  return launch_cg_block(b, src, s);
}

// ---- the sharded step (schur_reduce / schur_solve_reduced)

// one shard's partial reduced system, full [S, S] and [S]: engine mode
// (raw = 0) the damped, frozen entries of the single-device step; raw mode
// (raw = 1) the undamped, unfrozen H_cc - fill-in and its rhs
__global__ void assemble_kernel(BA b, float* Hout, float* rout, int raw) {
  if (b.done()) return;
  const int S = b.Sd(), Sp = b.Sp();
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= S * S) return;
  int i = e / S, j = e % S;
  if (i > j) {
    const int t = i;
    i = j;
    j = t;
  }
  float v;
  if (raw) {
    v = j < Sp && i / 6 == j / 6
        ? b.at<float>(kHcc)[(i / 6) * 27 + ut(6, i % 6, j % 6)] : 0.f;
    if (b.body) v = v + chain_h(b, i, j);
    if (j < Sp) v = v - b.at<float>(kFf)[i * Sp + j];
  } else {
    v = reduced_h(b, i, j, b.at<float>(kCtrl)[cLam], row_free(b, i),
                  row_free(b, j));
  }
  Hout[e] = v;
  if (e < S) rout[e] = reduced_rhs(b, e, raw ? 1.f : row_free(b, e));
}

constexpr int kMaxParts = 16;

struct Parts {
  const float* h[kMaxParts];
  const float* r[kMaxParts];
  int n;
};

// the partials' sum in shard order
__global__ void sum_kernel(BA b, Parts p, float* H, float* rhs) {
  if (b.done()) return;
  const int S = b.Sd();
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= S * S) return;
  float a = p.h[0][e];
  for (int k = 1; k < p.n; ++k) a = a + p.h[k][e];
  H[e] = a;
  if (e < S) {
    float c = p.r[0][e];
    for (int k = 1; k < p.n; ++k) c = c + p.r[k][e];
    rhs[e] = c;
  }
}

// lower Cholesky of the summed system and the two triangular solves, in
// one block with the full matrix in shared memory (the reference's
// cho_factor(lower=True) / cho_solve); a non-positive pivot gives NaN
__global__ void chol_kernel(BA b, FromSum src) {
  if (b.done()) return;
  extern __shared__ float sh[];
  const int S = b.Sd();
  float* A = sh;                 // [S, S], the lower triangle used
  float* x = A + size_t(S) * S;  // [S]
  float* fr = x + S;             // [S]
  const float lam = b.at<float>(kCtrl)[cLam];
  for (int i = threadIdx.x; i < S; i += blockDim.x) fr[i] = row_free(b, i);
  __syncthreads();
  for (int e = threadIdx.x; e < S * S; e += blockDim.x) {
    const int i = e / S, j = e % S;
    if (j <= i) A[e] = src.h(b, j, i, lam, fr[j], fr[i]);
  }
  for (int i = threadIdx.x; i < S; i += blockDim.x) x[i] = src.r(b, i, fr[i]);
  __syncthreads();
  for (int k = 0; k < S; ++k) {
    if (threadIdx.x == 0) A[k * S + k] = sqrtf(A[k * S + k]);
    __syncthreads();
    const float d = A[k * S + k];
    for (int i = k + 1 + threadIdx.x; i < S; i += blockDim.x)
      A[i * S + k] = A[i * S + k] / d;
    __syncthreads();
    const int m = S - k - 1;                  // trailing rows
    for (int e = threadIdx.x; e < m * m; e += blockDim.x) {
      const int i = k + 1 + e / m, j = k + 1 + e % m;
      if (j <= i) A[i * S + j] = A[i * S + j] - A[i * S + k] * A[j * S + k];
    }
    __syncthreads();
  }
  for (int j = 0; j < S; ++j) {               // L y = rhs
    if (threadIdx.x == 0) x[j] = x[j] / A[j * S + j];
    __syncthreads();
    for (int i = j + 1 + threadIdx.x; i < S; i += blockDim.x)
      x[i] = x[i] - A[i * S + j] * x[j];
    __syncthreads();
  }
  for (int j = S - 1; j >= 0; --j) {          // L^T dx = y
    if (threadIdx.x == 0) x[j] = x[j] / A[j * S + j];
    __syncthreads();
    for (int i = threadIdx.x; i < j; i += blockDim.x)
      x[i] = x[i] - A[j * S + i] * x[j];
    __syncthreads();
  }
  float* dx = b.at<float>(kDx);
  for (int i = threadIdx.x; i < S; i += blockDim.x) dx[i] = x[i] * fr[i];
}

inline size_t chol_smem(int S) {
  return (size_t(S) * S + 2 * size_t(S)) * sizeof(float);
}

}  // namespace

// one damped Schur step: landmark factors and the per-observation G_o, the
// fill-in, the reduced solve (one block, or the global path when its
// full rows do not fit the block's shared memory), back-substitution and
// retraction: four launches (five on the global path).  ints[kSolvePath]
// reports the path the reduced solve took; the global path needs
// ints[kCgwFloats] >= its full rows' floats (RowLayout::floats).
PLVIO_API int schur_solve(void* const* ptrs, int* ints, const float* flts,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BA b = make_ba(ptrs, ints, flts);
  if (!one_block(b) && !cgw_fits(b, ints))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = b.n_pt + b.n_ln;
  if (n > 0) factor_kernel<<<blocks(n, kLmThreads), kLmThreads, 0, s>>>(b);
  const int fe = launch_fill(b, s);
  if (fe != 0) return fe;
  const int rc = launch_cg(b, FromBlocks(), ints, s);
  if (rc != 0) return rc;
  const int m = b.n_kf + b.n_pt + b.n_ln;
  backsub_kernel<<<blocks(m, kLmThreads), kLmThreads, 0, s>>>(b);
  return static_cast<int>(cudaGetLastError());
}

// one shard's partial of the sharded step (the landmark-sharded window
// BAs): the landmark factors and the fill-in (the single-device step's
// stages, unchanged), then the shard's reduced system written to H [S, S]
// and rhs [S]: engine mode (raw = 0) damped by the shard's own diagonal
// and its fixed rows frozen, raw mode (raw = 1) neither.  The shard's
// factors stay in its buffers for the back-substitution.
PLVIO_API int schur_reduce(void* const* ptrs, int* ints, const float* flts,
                           void* H, void* rhs, int raw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BA b = make_ba(ptrs, ints, flts);
  const int n = b.n_pt + b.n_ln;
  if (n > 0) factor_kernel<<<blocks(n, kLmThreads), kLmThreads, 0, s>>>(b);
  const int fe = launch_fill(b, s);
  if (fe != 0) return fe;
  assemble_kernel<<<blocks(b.Sd() * b.Sd(), 256), 256, 0, s>>>(
      b, static_cast<float*>(H), static_cast<float*>(rhs), raw);
  return static_cast<int>(cudaGetLastError());
}

// the sharded step after the shards' reductions, by stage (ptrs / ints /
// flts: the first local shard's table at stages 0 and 1, each shard's at
// stage 2):
//   0: H, rhs = the n_parts partials summed in shard order (all on this
//      device);
//   1: the reduced solve of (H, rhs) into the table's dx: CG (chol = 0,
//      one block, or the global path beyond it) or Cholesky (chol = 1, one
//      block); raw = 1 damps and freezes the sum first;
//   2: the shard's back-substitution and retraction with dx.
// ints[kSolvePath] reports the CG path (0 one block, 1 global).
PLVIO_API int schur_solve_reduced(void* const* ptrs, int* ints,
                                  const float* flts, void* const* hparts,
                                  void* const* rparts, int n_parts, void* H,
                                  void* rhs, int stage, int raw, int chol,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BA b = make_ba(ptrs, ints, flts);
  const int S = b.Sd();
  if (stage == 0) {
    if (n_parts < 1 || n_parts > kMaxParts)
      return static_cast<int>(cudaErrorInvalidValue);
    Parts p;
    for (int k = 0; k < kMaxParts; ++k) {
      p.h[k] = k < n_parts ? static_cast<const float*>(hparts[k]) : nullptr;
      p.r[k] = k < n_parts ? static_cast<const float*>(rparts[k]) : nullptr;
    }
    p.n = n_parts;
    sum_kernel<<<blocks(S * S, 256), 256, 0, s>>>(
        b, p, static_cast<float*>(H), static_cast<float*>(rhs));
  } else if (stage == 1) {
    FromSum src{static_cast<const float*>(H), static_cast<const float*>(rhs),
                raw};
    if (chol) {
      const size_t smem = chol_smem(S);
      if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
      cudaFuncSetAttribute(chol_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
      chol_kernel<<<1, kSolveThreads, smem, s>>>(b, src);
      ints[kSolvePath] = 0;
    } else {
      if (!one_block(b) && !cgw_fits(b, ints))
        return static_cast<int>(cudaErrorInvalidValue);
      const int rc = launch_cg(b, src, ints, s);
      if (rc != 0) return rc;
    }
  } else if (stage == 2) {
    const int m = b.n_kf + b.n_pt + b.n_ln;
    backsub_kernel<<<blocks(m, kLmThreads), kLmThreads, 0, s>>>(b);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
