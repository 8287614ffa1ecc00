// pose_graph — the loop closer's essential-graph optimization over Sim(3)
// keyframe states, 7-DoF or 4-DoF (world translation and yaw).
//
// Replaces plvio_tpu/models/kernels.py `make_pose_graph_optimizer` (:488)
// as LoopCloser._essential_graph runs it (models/loop_closing.py:697):
// 15 iterations of the dense LM engine (solver/engine.py `optimize`: lam0
// 1e-4, x0.5 on accept and x4 on reject, clipped to [1e-8, 1e4]) over
// `sim3_edge` / `sim3_edge_4dof` residuals (7 each, information-weighted,
// no robust kernel), the normal matrix damped as diag * lam + 1e-6, the
// fixed keyframes' rows and columns zeroed with a unit diagonal, a dense
// Cholesky solve (`Problem()`'s default linear solver) and the retraction
// with so3_normalize.  The JAX version linearizes with jacfwd, scatters
// the 7x7 blocks into a dense [7 n_kf]^2 matrix and factors it with
// cho_factor: at pg_kf_cap = 512 that is S = 3584.
//
// The caller compacts the graph to its n active keyframes (S = 7n) and its
// valid edges: the padding slots of the reference are fixed, so their rows
// decouple with a unit diagonal and dx = 0, and masked edges add nothing.
//
// What bounds it on the H100: the factorization.  n^3 / 3 flops in float64
// per iteration (15 Gflop at S = 3584), and at small S the serial chain of
// launches and barriers.
//
// Design, every iteration's decisions on the device (no host sync):
// (a) pg_linearize: one thread per (edge, tangent direction), the residual
//     evaluated with a forward-mode Dual through the same composition as
//     the reference's (sim3.cuh), so each thread writes one column of the
//     edge's 7 x 14 Jacobian (masked 4-DoF directions are zero);
// (b) pg_diag / pg_pairs: the 7x7 blocks of the normal matrix, one block a
//     keyframe (its incident edges, in edge order) and one a keyframe pair
//     (the edges between them, in edge order), summed in float64 in a
//     fixed order (no atomics), damped and frozen as the engine does;
//     only the lower triangle is written;
// (c) the Cholesky solve in float64.  While S <= 168 (the lower matrix in
//     227 KB of shared memory) one block factors and solves it; beyond
//     that one cooperative launch runs a blocked right-looking
//     factorization in global memory (32-column panels: the diagonal
//     block by one block, the panel below by one thread a row against the
//     diagonal block staged in shared memory, the trailing lower tiles by
//     the grid, a grid barrier after each) and the two blocked triangular
//     solves (each diagonal block by one block from shared memory, the
//     rest of the rows by the grid).  A non-positive pivot gives NaN, as
//     the reference's cho_factor, and the step is rejected;
// (d) pg_update: one thread a keyframe retracts its state (so3_normalize);
// (e) pg_cost_accept: one block evaluates the edges at the candidate, sums
//     the cost in a fixed order and accepts it when it is lower.
// The entry point reports the path it took (0 one block, 1 global).
#include <cooperative_groups.h>

#include "common.cuh"
#include "sim3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kNB = 32;             // panel width of the global path
constexpr int kOneBlockMaxS = 168;  // 168^2 doubles = 220.5 KB
constexpr int kCostThreads = 1024;
constexpr int kCoopThreads = 256;
constexpr size_t kSmemMax = 232448;

struct Graph {
  int n, S, E, P, four_dof;
  const uint8_t* free;   // [n]
  const int* ei;         // [E]
  const int* ej;
  const float* meas;     // [E,13] Rji, tji, sji
  const float* info;     // [E]
  const int* inc_ptr;    // [n+1] incident edges of each keyframe
  const int* inc;        // [2E] 2 e + side (0: i, 1: j)
  const int* pair_ab;    // [P,2] a < b
  const int* pair_ptr;   // [P+1]
  const int* pair_list;  // 2 e + flip (1: edge i = b, j = a)
  double* st;            // [n,13]
  double* cand;          // [n,13]
  double* J;             // [E,7,14]
  double* r;             // [E,7]
  double* A;             // [S,S] lower triangle
  double* x;             // [S]
  double* sc;            // [0] lam, [1] cost_prev
};

template <typename T>
__device__ void edge_residual(const Graph& g, const double* st, int e,
                              int dir, T r[7]) {
  T Si[13], Sj[13], R[9], t[3], di[7], dj[7];
  const double* a = st + 13 * g.ei[e];
  const double* b = st + 13 * g.ej[e];
  for (int k = 0; k < 13; ++k) {
    Si[k] = T(a[k]);
    Sj[k] = T(b[k]);
  }
  const float* m = g.meas + 13 * e;
  for (int k = 0; k < 9; ++k) R[k] = T(double(m[k]));
  for (int k = 0; k < 3; ++k) t[k] = T(double(m[9 + k]));
  for (int k = 0; k < 7; ++k) {
    di[k] = T(0.0);
    dj[k] = T(0.0);
  }
  if constexpr (sizeof(T) == sizeof(Dual)) {
    if (dir < 7)
      di[dir] = T(0.0, 1.0);
    else
      dj[dir - 7] = T(0.0, 1.0);
  }
  sim3_edge(Si, Sj, R, t, T(double(m[12])), di, dj, g.four_dof != 0, r);
}

__global__ void pg_init(Graph g, const float* __restrict__ in, int* path,
                        int which) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 13 * g.n) g.st[i] = in[i];
  if (i == 0) {
    g.sc[0] = 1e-4;
    *path = which;
  }
}

__global__ void pg_linearize(Graph g) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= 14 * g.E) return;
  const int e = tid / 14, dir = tid % 14;
  double* Je = g.J + size_t(98) * e;
  if (g.four_dof && mask4(dir % 7) == 0.0) {
    for (int k = 0; k < 7; ++k) Je[14 * k + dir] = 0.0;
    return;
  }
  Dual r[7];
  edge_residual<Dual>(g, g.st, e, dir, r);
  for (int k = 0; k < 7; ++k) Je[14 * k + dir] = r[k].d;
  if (dir == 0)
    for (int k = 0; k < 7; ++k) g.r[7 * e + k] = r[k].v;
}

// diagonal block and gradient of keyframe a = blockIdx.x
__global__ void pg_diag(Graph g) {
  const int a = blockIdx.x, t = threadIdx.x;
  const bool fr = g.free[a] != 0;
  const double lam = g.sc[0];
  const int S = g.S;
  if (t < 49) {
    const int p = t / 7, q = t % 7;
    double h = 0.0;
    for (int c = g.inc_ptr[a]; c < g.inc_ptr[a + 1]; ++c) {
      const int e = g.inc[c] >> 1, side = g.inc[c] & 1;
      const double* Je = g.J + size_t(98) * e + 7 * side;
      double v = 0.0;
      for (int k = 0; k < 7; ++k) v += Je[14 * k + p] * Je[14 * k + q];
      h += v * double(g.info[e]);
    }
    if (p == q) h += h * lam + 1e-6;
    g.A[size_t(7 * a + p) * S + 7 * a + q] = fr ? h : (p == q ? 1.0 : 0.0);
  } else if (t < 56) {
    const int p = t - 49;
    double v = 0.0;
    for (int c = g.inc_ptr[a]; c < g.inc_ptr[a + 1]; ++c) {
      const int e = g.inc[c] >> 1, side = g.inc[c] & 1;
      const double* Je = g.J + size_t(98) * e + 7 * side;
      double u = 0.0;
      for (int k = 0; k < 7; ++k) u += Je[14 * k + p] * g.r[7 * e + k];
      v -= u * double(g.info[e]);
    }
    g.x[7 * a + p] = fr ? v : 0.0;
  }
}

// the block of keyframes a < b = pair blockIdx.x, written at (b, a)
__global__ void pg_pairs(Graph g) {
  const int pr = blockIdx.x, t = threadIdx.x;
  const int a = g.pair_ab[2 * pr], b = g.pair_ab[2 * pr + 1];
  if (t >= 49 || !g.free[a] || !g.free[b]) return;
  const int p = t / 7, q = t % 7;     // row of a's side, row of b's side
  double h = 0.0;
  for (int c = g.pair_ptr[pr]; c < g.pair_ptr[pr + 1]; ++c) {
    const int e = g.pair_list[c] >> 1, flip = g.pair_list[c] & 1;
    const double* Je = g.J + size_t(98) * e;
    const int ca = flip ? 7 : 0, cb = flip ? 0 : 7;
    double v = 0.0;
    for (int k = 0; k < 7; ++k)
      v += Je[14 * k + ca + p] * Je[14 * k + cb + q];
    h += v * double(g.info[e]);
  }
  g.A[size_t(7 * b + q) * g.S + 7 * a + p] = h;
}

// ---- the one-block Cholesky solve (S <= kOneBlockMaxS)

__global__ void pg_solve_block(Graph g) {
  extern __shared__ double L[];         // [S,S] then [S] rhs
  const int S = g.S, t = threadIdx.x, nt = blockDim.x;
  double* y = L + size_t(S) * S;
  for (int e = t; e < S * S; e += nt) {
    const int i = e / S, j = e % S;
    L[e] = j <= i ? g.A[e] : 0.0;
  }
  for (int i = t; i < S; i += nt) y[i] = g.x[i];
  __syncthreads();
  for (int j = 0; j < S; ++j) {
    if (t == 0) {
      const double d = L[j * S + j];
      L[j * S + j] = sqrt(d > 0.0 ? d : nan(""));
    }
    __syncthreads();
    const double ljj = L[j * S + j];
    for (int i = j + 1 + t; i < S; i += nt) L[i * S + j] /= ljj;
    __syncthreads();
    // trailing lower update, each entry in j order
    const int m = S - j - 1;
    for (int e = t; e < m * m; e += nt) {
      const int i = j + 1 + e / m, k = j + 1 + e % m;
      if (k <= i) L[i * S + k] -= L[i * S + j] * L[k * S + j];
    }
    __syncthreads();
  }
  // L y = b, then L^T x = y, column-oriented
  for (int j = 0; j < S; ++j) {
    if (t == 0) y[j] /= L[j * S + j];
    __syncthreads();
    for (int i = j + 1 + t; i < S; i += nt) y[i] -= L[i * S + j] * y[j];
    __syncthreads();
  }
  for (int j = S - 1; j >= 0; --j) {
    if (t == 0) y[j] /= L[j * S + j];
    __syncthreads();
    for (int i = t; i < j; i += nt) y[i] -= L[j * S + i] * y[j];
    __syncthreads();
  }
  for (int i = t; i < S; i += nt) g.x[i] = y[i];
}

// ---- the global path: one cooperative launch

__global__ void __launch_bounds__(kCoopThreads) pg_solve_global(Graph g) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double ta[kNB][kNB + 1], tb[kNB][kNB + 1];
  const int S = g.S, t = threadIdx.x;
  double* A = g.A;
  double* x = g.x;
  const int gt = blockIdx.x * blockDim.x + t;
  const int gn = gridDim.x * blockDim.x;
  for (int k0 = 0; k0 < S; k0 += kNB) {
    const int nb = min(kNB, S - k0);
    // (1) the diagonal block, right-looking, by block 0
    if (blockIdx.x == 0) {
      for (int e = t; e < nb * nb; e += blockDim.x)
        ta[e / nb][e % nb] = A[size_t(k0 + e / nb) * S + k0 + e % nb];
      __syncthreads();
      for (int j = 0; j < nb; ++j) {
        if (t == 0) {
          const double d = ta[j][j];
          ta[j][j] = sqrt(d > 0.0 ? d : nan(""));
        }
        __syncthreads();
        for (int i = j + 1 + t; i < nb; i += blockDim.x) ta[i][j] /= ta[j][j];
        __syncthreads();
        const int m = nb - j - 1;
        for (int e = t; e < m * m; e += blockDim.x) {
          const int i = j + 1 + e / m, k = j + 1 + e % m;
          if (k <= i) ta[i][k] -= ta[i][j] * ta[k][j];
        }
        __syncthreads();
      }
      for (int e = t; e < nb * nb; e += blockDim.x)
        if (e % nb <= e / nb)
          A[size_t(k0 + e / nb) * S + k0 + e % nb] = ta[e / nb][e % nb];
    }
    grid.sync();
    // (2) the panel below: L21 = A21 L11^{-T}, one thread a row, L11
    // staged in each block's shared memory
    if (k0 + nb < S) {
      for (int e = t; e < nb * nb; e += blockDim.x)
        ta[e / nb][e % nb] = A[size_t(k0 + e / nb) * S + k0 + e % nb];
      __syncthreads();
      for (int i = k0 + nb + gt; i < S; i += gn) {
        double* row = A + size_t(i) * S + k0;
        double r[kNB];
        for (int c = 0; c < nb; ++c) {
          double v = row[c];
          for (int q = 0; q < c; ++q) v -= r[q] * ta[c][q];
          r[c] = v / ta[c][c];
        }
        for (int c = 0; c < nb; ++c) row[c] = r[c];
      }
    }
    grid.sync();
    // (3) the trailing lower tiles: A22 -= L21 L21^T
    const int r0 = k0 + nb;
    const int T = (S - r0 + kNB - 1) / kNB;
    const int ntiles = T * (T + 1) / 2;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      int ti = 0;
      while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
      const int tj = tile - ti * (ti + 1) / 2;
      const int i0 = r0 + ti * kNB, j0 = r0 + tj * kNB;
      for (int e = t; e < kNB * kNB; e += blockDim.x) {
        const int rr = e / kNB, q = e % kNB;
        ta[rr][q] = (i0 + rr < S && q < nb) ? A[size_t(i0 + rr) * S + k0 + q]
                                            : 0.0;
        tb[rr][q] = (j0 + rr < S && q < nb) ? A[size_t(j0 + rr) * S + k0 + q]
                                            : 0.0;
      }
      __syncthreads();
      for (int e = t; e < kNB * kNB; e += blockDim.x) {
        const int rr = e / kNB, cc = e % kNB;
        const int i = i0 + rr, j = j0 + cc;
        if (i < S && j < S && j <= i) {
          double v = A[size_t(i) * S + j];
          for (int q = 0; q < nb; ++q) v -= ta[rr][q] * tb[cc][q];
          A[size_t(i) * S + j] = v;
        }
      }
      __syncthreads();
    }
    grid.sync();
  }
  // L y = b; each diagonal block solved by block 0 from shared memory
  double* xs = &tb[0][0];
  for (int k0 = 0; k0 < S; k0 += kNB) {
    const int nb = min(kNB, S - k0);
    if (blockIdx.x == 0) {
      for (int e = t; e < nb * nb; e += blockDim.x)
        ta[e / nb][e % nb] = A[size_t(k0 + e / nb) * S + k0 + e % nb];
      for (int c = t; c < nb; c += blockDim.x) xs[c] = x[k0 + c];
      __syncthreads();
      if (t == 0)
        for (int c = 0; c < nb; ++c) {
          double v = xs[c];
          for (int q = 0; q < c; ++q) v -= ta[c][q] * xs[q];
          xs[c] = v / ta[c][c];
        }
      __syncthreads();
      for (int c = t; c < nb; c += blockDim.x) x[k0 + c] = xs[c];
    }
    grid.sync();
    for (int i = k0 + nb + gt; i < S; i += gn) {
      double v = x[i];
      for (int q = 0; q < nb; ++q) v -= A[size_t(i) * S + k0 + q] * x[k0 + q];
      x[i] = v;
    }
    grid.sync();
  }
  // L^T x = y
  for (int k0 = ((S - 1) / kNB) * kNB; k0 >= 0; k0 -= kNB) {
    const int nb = min(kNB, S - k0);
    if (blockIdx.x == 0) {
      for (int e = t; e < nb * nb; e += blockDim.x)
        ta[e / nb][e % nb] = A[size_t(k0 + e / nb) * S + k0 + e % nb];
      for (int c = t; c < nb; c += blockDim.x) xs[c] = x[k0 + c];
      __syncthreads();
      if (t == 0)
        for (int c = nb - 1; c >= 0; --c) {
          double v = xs[c];
          for (int q = c + 1; q < nb; ++q) v -= ta[q][c] * xs[q];
          xs[c] = v / ta[c][c];
        }
      __syncthreads();
      for (int c = t; c < nb; c += blockDim.x) x[k0 + c] = xs[c];
    }
    grid.sync();
    for (int i = gt; i < k0; i += gn) {
      double v = x[i];
      for (int q = 0; q < nb; ++q) v -= A[size_t(k0 + q) * S + i] * x[k0 + q];
      x[i] = v;
    }
    grid.sync();
  }
}

__global__ void pg_update(Graph g) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= g.n) return;
  double d[7];
  const double f = g.free[a] ? 1.0 : 0.0;
  for (int k = 0; k < 7; ++k) d[k] = g.x[7 * a + k] * f;
  retract_state(g.st + 13 * a, d, g.four_dof != 0, g.cand + 13 * a);
}

// mode 0: cost_prev = cost(st); mode 1: cost(cand), accepted when lower;
// then st into out where given
__global__ void __launch_bounds__(kCostThreads)
pg_cost_accept(Graph g, int mode, float* __restrict__ out) {
  __shared__ double red[32];
  __shared__ int accept;
  const int t = threadIdx.x;
  const double* st = mode ? g.cand : g.st;
  double acc = 0.0;
  for (int e = t; e < g.E; e += kCostThreads) {
    double r[7];
    edge_residual<double>(g, st, e, 0, r);
    double c2 = 0.0;
    for (int k = 0; k < 7; ++k) c2 += r[k] * r[k];
    acc += c2 * double(g.info[e]);
  }
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, s);
  if ((t & 31) == 0) red[t >> 5] = acc;
  __syncthreads();
  if (t == 0) {
    double c = 0.0;
    for (int w = 0; w < kCostThreads / 32; ++w) c += red[w];
    if (mode == 0) {
      g.sc[1] = c;
      accept = 0;
    } else {
      accept = c < g.sc[1];
      if (accept) g.sc[1] = c;
      const double lam = accept ? g.sc[0] * 0.5 : g.sc[0] * 4.0;
      g.sc[0] = fmin(fmax(lam, 1e-8), 1e4);
    }
  }
  __syncthreads();
  // each thread copies and then writes out the same entries
  if (accept)
    for (int i = t; i < 13 * g.n; i += kCostThreads) g.st[i] = g.cand[i];
  if (out)
    for (int i = t; i < 13 * g.n; i += kCostThreads) out[i] = float(g.st[i]);
}

int launch_global(const Graph& g, cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, pg_solve_global, kCoopThreads, 0)) != cudaSuccess)
    return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Graph arg = g;
  void* args[] = {&arg};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(pg_solve_global), dim3(sms * min(per_sm, 2)),
      dim3(kCoopThreads), args, 0, s));
}

}  // namespace

// Workspace: doubles, 26 n + 105 E + S^2 + S + 2 (see Graph).
PLVIO_API int pose_graph(const void* states, const void* free, int n,
                         const void* ei, const void* ej, const void* meas,
                         const void* info, int E, const void* inc_ptr,
                         const void* inc, const void* pair_ab,
                         const void* pair_ptr, const void* pair_list, int P,
                         int four_dof, int iters, void* work, void* out,
                         void* path, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = 7 * n;
  double* w = static_cast<double*>(work);
  Graph g{n, S, E, P, four_dof,
          static_cast<const uint8_t*>(free), static_cast<const int*>(ei),
          static_cast<const int*>(ej), static_cast<const float*>(meas),
          static_cast<const float*>(info), static_cast<const int*>(inc_ptr),
          static_cast<const int*>(inc), static_cast<const int*>(pair_ab),
          static_cast<const int*>(pair_ptr),
          static_cast<const int*>(pair_list), w, w + 13 * n, w + 26 * n,
          w + 26 * n + 98 * size_t(E), w + 26 * n + 105 * size_t(E),
          w + 26 * n + 105 * size_t(E) + size_t(S) * S,
          w + 26 * n + 105 * size_t(E) + size_t(S) * S + S};
  const bool one_block = S <= kOneBlockMaxS;
  cudaError_t e;
  const size_t smem1 = (size_t(S) * S + S) * sizeof(double);
  if (one_block) {
    if (smem1 > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
    e = cudaFuncSetAttribute(pg_solve_block,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem1));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pg_init<<<(13 * n + 255) / 256, 256, 0, s>>>(
      g, static_cast<const float*>(states), static_cast<int*>(path),
      one_block ? 0 : 1);
  pg_cost_accept<<<1, kCostThreads, 0, s>>>(
      g, 0, iters <= 0 ? static_cast<float*>(out) : nullptr);
  for (int it = 0; it < iters; ++it) {
    if (E > 0)
      pg_linearize<<<(14 * E + 255) / 256, 256, 0, s>>>(g);
    cudaMemsetAsync(g.A, 0, size_t(S) * S * sizeof(double), s);
    pg_diag<<<n, 64, 0, s>>>(g);
    if (P > 0) pg_pairs<<<P, 64, 0, s>>>(g);
    if (one_block) {
      pg_solve_block<<<1, 1024, smem1, s>>>(g);
    } else {
      const int rc = launch_global(g, s);
      if (rc != 0) return rc;
    }
    pg_update<<<(n + 127) / 128, 128, 0, s>>>(g);
    pg_cost_accept<<<1, kCostThreads, 0, s>>>(
        g, 1, it == iters - 1 ? static_cast<float*>(out) : nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
