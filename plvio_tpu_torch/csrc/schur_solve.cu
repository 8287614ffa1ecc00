// schur_solve — one damped Schur-complement step of the windowed
// point+line BA: landmark elimination, the reduced camera solve by
// fixed-step CG, back-substitution and the retraction of every block.
//
// Replaces, for `make_local_ba_pl` (plvio_tpu/models/kernels.py:641),
// plvio_tpu/solver/engine.py `Problem.solve_step` (:452-573) with
// `chol_invT_blocks` (:221, `_chol3` :185, `_tri_inv3` :205) and `_cg_solve`
// (:256), and the retractions `retract_pose_cw` / `retract_additive`
// (solver/residuals.py:47,68).  The JAX version works on the dense coupling
// B [S, P*dof] with batched einsums, one XLA dot for the Gram fill-in and a
// scanned CG.
//
// What bounds it on the H100: latency.  At the worst-case window (S = 96,
// 4096 3x3 point blocks, 512 6x6 line blocks, 9216 observations) the
// factor stage moves ~2 MB and writes the 96 x 15360 Gram operand (5.9
// MB); the Gram product (0.28 Gflop dense) runs as 6 upper-triangle tiles
// x 24 column chunks; the CG is 48 sequential iterations of a 96 x 96
// matrix-vector product, each a few block-wide barriers (~2 us an
// iteration in one block).
//
// Design:
// - factor_kernel: one thread per landmark (points, then lines) zeroes its
//   own columns of the Gram operand Gm [S, C], then takes the reference's
//   steps in order: free mask, the per-landmark damping floor
//   1e-4 mean(diag), lambda damping, the `occupied` gate, F = chol(Hpp)^-T
//   by the same closed forms, the `blk_ok` guard (finite and max|F| < 1e3),
//   then for each of its observations (in observation order) G_o = W_o F
//   added into its columns, and the rhs share G_o F^T g_p kept per
//   observation.  A thread owns its columns, so there are no atomics and
//   the result is the same on every run.
// - gram_kernel / gram_reduce_kernel: the fill-in Ff = Gm Gm^T.  Each block
//   takes one 32 x 32 tile of the upper triangle over one chunk of the C
//   columns (shared-memory tiles, 2 x 2 outputs a thread) and writes its
//   partial tile; the reduction sums the partials in chunk order, so the
//   fill-in too is the same on every run.
// - solve_kernel: one block holds the reduced system (S x S floats in
//   shared memory): the keyframe blocks damped as H + diag(diag(H) lambda +
//   1e-6), minus the fill-in, the fixed keyframes freed after the
//   reduction (unit diagonal, zero rhs), then CG with the reference's
//   iteration count and max(., 1e-20) guards, dot products reduced in a
//   fixed order.
// - backsub_kernel: back-substitutes each landmark (dx_p = F F^T (g_p -
//   sum_o W_o^T dx_kf)) and retracts each keyframe (T <- Exp(dx) T, rows
//   re-orthonormalized) into the candidate state.
// Every kernel reads the device-side early-exit flag first and returns at
// once when it has fired, so an iteration after the exit costs five empty
// launches and no memory traffic.
#include "ba_common.cuh"

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
                                const int* obs_kf, int comb0, int col0,
                                float* Fout, uint8_t* occ_out) {
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
  const int C = b.C();
  const int S = b.S();
  float* gm = b.at<float>(kGm);
  float* rr = b.at<float>(kRr);
  for (int r = 0; r < S; ++r)
    for (int j = 0; j < D; ++j) gm[size_t(r) * C + col0 + p * D + j] = 0.f;
  for (int q = start[p]; q < start[p + 1]; ++q) {
    const int o = order[q];
    const int k = obs_kf[o];
    const float* Wo = W + o * 6 * D;
    for (int i = 0; i < 6; ++i) {
      float gi[D];
      float r = 0.f;
      for (int j = 0; j < D; ++j) {
        float a = 0.f;
        for (int m = 0; m < D; ++m) a += (Wo[i * D + m] * lf) * F[m][j];
        gi[j] = a;
        r += a * t[j];
      }
      float* row = gm + size_t(k * 6 + i) * C + col0 + p * D;
      for (int j = 0; j < D; ++j) row[j] += gi[j];
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
                       b.at<int>(kPtStart), b.at<int>(kObsKf), 0, 0,
                       b.at<float>(kFpt), b.at<uint8_t>(kOccPt));
  } else if (t < b.n_pt + b.n_ln) {
    factor_landmark<6>(b, t - b.n_pt, b.at<float>(kHln),
                       b.at<uint8_t>(kLnFree), b.at<float>(kLW),
                       b.at<int>(kLnOrder), b.at<int>(kLnStart),
                       b.at<int>(kLobsKf), b.n_obs, 3 * b.n_pt,
                       b.at<float>(kFln), b.at<uint8_t>(kOccLn));
  }
}

// ---- the fill-in Ff = Gm Gm^T (engine.py:530, an XLA dot there)

constexpr int kTile = 32;
constexpr int kGramThreads = 256;          // 16 x 16, 2 x 2 outputs each

__global__ void gram_kernel(BA b) {
  if (b.done()) return;
  __shared__ float As[kTile][kTile + 1];
  __shared__ float Bs[kTile][kTile + 1];
  const int S = b.S(), C = b.C();
  const int nT = (S + kTile - 1) / kTile;
  int pr = blockIdx.x, ti = 0;             // blockIdx.x -> (ti <= tj)
  while (pr >= nT - ti) {
    pr -= nT - ti;
    ++ti;
  }
  const int tj = ti + pr;
  const int chunk = (C + b.gram_split - 1) / b.gram_split;
  const int k0 = blockIdx.y * chunk;
  const int k1 = min(C, k0 + chunk);
  const float* gm = b.at<float>(kGm);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int kk = k0; kk < k1; kk += kTile) {
    for (int e = threadIdx.x; e < kTile * kTile; e += kGramThreads) {
      const int r = e / kTile, c = e % kTile, k = kk + c;
      const int ra = ti * kTile + r, rb = tj * kTile + r;
      As[r][c] = ra < S && k < k1 ? gm[size_t(ra) * C + k] : 0.f;
      Bs[r][c] = rb < S && k < k1 ? gm[size_t(rb) * C + k] : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < kTile; ++c)
      for (int u = 0; u < 2; ++u)
        for (int v = 0; v < 2; ++v)
          acc[u][v] += As[ty + 16 * u][c] * Bs[tx + 16 * v][c];
    __syncthreads();
  }
  float* part = b.at<float>(kGpart) + size_t(blockIdx.y) * S * S;
  for (int u = 0; u < 2; ++u)
    for (int v = 0; v < 2; ++v) {
      const int i = ti * kTile + ty + 16 * u, j = tj * kTile + tx + 16 * v;
      if (i < S && j < S) part[i * S + j] = acc[u][v];
    }
}

// Ff[i][j] = sum of the chunks' partials in chunk order (the lower tiles
// read their transposed upper tile)
__global__ void gram_reduce_kernel(BA b) {
  if (b.done()) return;
  const int S = b.S();
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= S * S) return;
  int i = e / S, j = e % S;
  if (i / kTile > j / kTile) {
    const int t = i;
    i = j;
    j = t;
  }
  const float* part = b.at<float>(kGpart);
  float a = 0.f;
  for (int c = 0; c < b.gram_split; ++c) a += part[(size_t(c) * S + i) * S + j];
  b.at<float>(kFf)[e] = a;
}

// ---- the reduced solve: one block

constexpr int kSolveThreads = 256;

// fixed-order block sum of v[0..n) (warp shuffles, then warps in order)
__device__ float block_dot(const float* a, const float* c, int n,
                           float* warp_sh) {
  float v = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) v += a[i] * c[i];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sh[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < int(blockDim.x >> 5); ++w) s += warp_sh[w];
  __syncthreads();
  return s;
}

__global__ void solve_kernel(BA b) {
  if (b.done()) return;
  extern __shared__ float sh[];
  const int S = b.S();
  float* H = sh;                 // [S*S]
  float* x = H + S * S;          // [S]
  float* r = x + S;
  float* p = r + S;
  float* Hp = p + S;
  float* fr = Hp + S;            // free mask
  float* wsh = fr + S;           // [32]
  const float lam = b.at<float>(kCtrl)[cLam];
  const float* hcc = b.at<float>(kHcc);
  const float* ff = b.at<float>(kFf);
  const uint8_t* kf_free = b.at<uint8_t>(kKfFree);
  for (int i = threadIdx.x; i < S; i += blockDim.x)
    fr[i] = kf_free[i / 6] ? 1.f : 0.f;
  __syncthreads();
  for (int e = threadIdx.x; e < S * S; e += blockDim.x) {
    const int i = e / S, j = e % S;
    float v = i / 6 == j / 6 ? hcc[(i / 6) * 27 + ut(6, i % 6, j % 6)] : 0.f;
    if (i == j) v = v + (v * lam + 1e-6f);
    v = v - ff[e];
    H[e] = v * fr[i] * fr[j] + (i == j ? 1.f - fr[i] : 0.f);
  }
  const int* order = b.at<int>(kKfOrder);
  const int* start = b.at<int>(kKfStart);
  const float* rr = b.at<float>(kRr);
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const int k = i / 6, c = i % 6;
    float a = 0.f;
    for (int q = start[k]; q < start[k + 1]; ++q) a += rr[order[q] * 6 + c];
    const float rhs = (hcc[k * 27 + 21 + c] - a) * fr[i];
    x[i] = 0.f;
    r[i] = rhs;
    p[i] = rhs;
  }
  __syncthreads();
  float rs = block_dot(r, r, S, wsh);
  for (int it = 0; it < b.cg_iters; ++it) {
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      float a = 0.f;
      for (int j = 0; j < S; ++j) a += H[i * S + j] * p[j];
      Hp[i] = a;
    }
    __syncthreads();
    const float alpha = rs / fmaxf(block_dot(p, Hp, S, wsh), 1e-20f);
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      x[i] = x[i] + alpha * p[i];
      r[i] = r[i] - alpha * Hp[i];
    }
    __syncthreads();
    const float rs_new = block_dot(r, r, S, wsh);
    const float beta = rs_new / fmaxf(rs, 1e-20f);
    for (int i = threadIdx.x; i < S; i += blockDim.x)
      p[i] = r[i] + beta * p[i];
    __syncthreads();
    rs = rs_new;
  }
  float* dx = b.at<float>(kDx);
  for (int i = threadIdx.x; i < S; i += blockDim.x) dx[i] = x[i] * fr[i];
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
  // so3_normalize: Gram-Schmidt on the rows
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
  out[3] = tn[0];
  out[7] = tn[1];
  out[11] = tn[2];
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
    retract_pose(b.at<float>(kPoses) + t * 12, b.at<float>(kDx) + t * 6,
                 b.at<float>(kCPoses) + t * 12);
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

inline size_t solve_smem(int S) {
  return (size_t(S) * S + 5 * size_t(S) + 32) * sizeof(float);
}

}  // namespace

// one damped Schur step: landmark factors and the Gram operand, the
// fill-in, the reduced solve, back-substitution and retraction
PLVIO_API int schur_solve(void* const* ptrs, const int* ints,
                          const float* flts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BA b = make_ba(ptrs, ints, flts);
  const size_t smem = solve_smem(b.S());
  if (smem > 232448 || b.gram_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = b.n_pt + b.n_ln;
  if (n > 0) factor_kernel<<<blocks(n, 128), 128, 0, s>>>(b);
  const int nT = blocks(b.S(), kTile);
  gram_kernel<<<dim3(nT * (nT + 1) / 2, b.gram_split), kGramThreads, 0, s>>>(
      b);
  gram_reduce_kernel<<<blocks(b.S() * b.S(), 256), 256, 0, s>>>(b);
  cudaFuncSetAttribute(solve_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  solve_kernel<<<1, kSolveThreads, smem, s>>>(b);
  const int m = b.n_kf + b.n_pt + b.n_ln;
  backsub_kernel<<<blocks(m, 128), 128, 0, s>>>(b);
  return static_cast<int>(cudaGetLastError());
}
