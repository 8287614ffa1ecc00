// pose_graph — the loop closer's essential-graph optimization over Sim(3)
// keyframe states, 7-DoF or 4-DoF (world translation and yaw).
//
// Replaces plvio_tpu/models/kernels.py `make_pose_graph_optimizer` (:488)
// as LoopCloser._essential_graph runs it (models/loop_closing.py:697):
// 15 iterations of the dense LM engine (solver/engine.py `optimize`: lam0
// 1e-4, x0.5 on accept and x4 on reject, clipped to [1e-8, 1e4]) over
// `sim3_edge` / `sim3_edge_4dof` residuals (7 each, information-weighted,
// no robust kernel), the normal matrix damped as diag * lam + 1e-6, the
// fixed keyframes' rows and columns zeroed with a unit diagonal, a
// Cholesky solve (`Problem()`'s default linear solver) and the retraction
// with so3_normalize.  The JAX version linearizes with jacfwd, scatters
// the 7x7 blocks into a dense [7 n_kf]^2 matrix and factors it with
// cho_factor: at pg_kf_cap = 512 that is S = 3584.
//
// The caller compacts the graph to its n active keyframes (S = 7n) and its
// valid edges: the padding slots of the reference are fixed, so their rows
// decouple with a unit diagonal and dx = 0, and masked edges add nothing.
//
// What bounds it on the H100: the chain of dependent steps, not the
// arithmetic.  The closer numbers keyframes in chain order and its edges
// join near neighbours (chain, covisibility, loops), so the normal matrix
// is a narrow band of 7x7 blocks and its Cholesky factor fills only inside
// that envelope: a few thousand 7x7 block products an iteration at S =
// 3584, against S^3 / 3 = 15 Gflop for a dense factor.  What is left is
// serial: the elimination tree of a chain is a path, so each block column
// waits for the one before it.  The time is the number of block columns
// times the latency of one: seven dependent float64 pivots (a reciprocal
// square root each) and the inverse, then the updates and two barriers
// (chip_smoke.py prints the launch's time by phase).  A revisited map is
// another graph: its long-range edges (covisibility anywhere in the chain)
// fill the factor between the two passes, and each level then sends
// hundreds to thousands of block updates, more than one block can apply
// at the chain's pace; those graphs factor on the whole grid (path 2).
//
// Design: one cooperative launch runs all `iters` LM iterations; every
// decision (cost, accept, lambda) is taken on the device, identically in
// every block, so no host round trip and no second launch.  Per iteration,
// separated by grid barriers:
// (a) the grid linearizes: one thread per (edge, tangent direction), the
//     residual evaluated with a forward-mode Dual through the same
//     composition as the reference's (sim3.cuh), one column of the edge's
//     7 x 14 Jacobian each (masked 4-DoF directions are zero); items are
//     dealt round-robin to the blocks, so each multiprocessor's L1 holds
//     the few Dual stacks (local memory) it runs;
// (b) the grid assembles only the factor's pattern blocks (`pg_pattern`
//     in models/kernels.py: the symbolic block Cholesky on the host, fill
//     and elimination tree included): a keyframe's diagonal block from its
//     incident edges and a pair's block from the edges between them, in
//     edge order, in float64 (no atomics), damped and frozen as the engine
//     does; fill blocks zero; the right-hand side -J^T r in a border block
//     row under each column;
// (c) block 0 factors on the pattern, the 7x7 block as the unit, level by
//     level of the elimination tree (the columns of one level side by
//     side): a warp factors each diagonal block and inverts its factor in
//     registers (every lane the whole block, so no shuffle waits), its
//     lanes multiply the blocks below by that inverse, and the updates
//     L_ij -= L_ik L_jk^T are applied by target in a fixed order (the
//     host's schedule): those into the next level first, the rest by the
//     other warps while the next level is factored.  The border row makes
//     the forward solve part of the same walk; the backward solve walks
//     the levels down.  The pattern's tables are copied into shared memory
//     once a launch.  The factor stays in shared memory when it fits (path
//     0: the circle's graph); beyond that (path 1) a window of blocks moves
//     through shared memory, the next blocks brought in by cp.async a few
//     levels ahead of their use in both walks.  Where the fill gives a
//     level many updates (models/kernels.py pg_path), the whole grid
//     factors on the factor in global memory (path 2): per level, warps
//     across the grid take the level's rows below the diagonal blocks in
//     items of 32, every thread of the grid takes update targets, and two
//     grid barriers separate the phases (chol_solve_grid).  Every target
//     entry is summed by one thread in the schedule's order, so the bits
//     do not depend on the grid.  A non-positive pivot gives NaN, as the
//     reference's cho_factor, and the step is rejected;
// (d) the grid retracts each keyframe (so3_normalize) and sums the
//     candidate's cost: a fixed-order partial a block, then every block
//     sums the partials in the same order and takes the same decision.
// The entry point takes the path the host chose and reports it (0
// resident, 1 streamed, 2 the grid).
#include <cooperative_groups.h>

#include "common.cuh"
#include "sim3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;       // doubles the streamed window gains a level
constexpr int kDist = 3;          // levels between a block's copy and its use
constexpr int kNBuf = kDist + 2;  // staging buffers of kChunk doubles
constexpr int kBlk = 49;          // a 7x7 block, row-major
constexpr int kMinCap = 96;       // least window (blocks) streamed
constexpr size_t kSmemMax = 232448;  // a block's shared memory, opted in
constexpr size_t kStaticSmem = 256;  // what pg_kernel declares statically
constexpr unsigned kFull = 0xffffffffu;

// int tables of the graph and its pattern (models/kernels.py pose_graph)
enum {
  kEi, kEj, kSel, kIncPtr, kInc, kPairPtr, kPairList, kColptr, kRowidx,
  kBcol, kBsrc, kColKf, kKfCol, kLvlCol, kLvlTgt, kLvlMid, kTgt, kTgtPtr,
  kSrc, kTables
};

struct Graph {
  int n, E, four_dof, nb, n_lvl, n_tgt, n_upd;
  int cap, path, meta_resident, meta_d;
  const uint8_t* free;   // [n]
  const int* ei;         // [E]
  const int* ej;
  const float* Rji;      // [cap,9] the edges' measurements in their padded
  const float* tji;      // [cap,3] slots (sel)
  const float* sji;      // [cap]
  const float* info;     // [cap]
  const int* sel;        // [E] the valid edges' slots
  const int* inc_ptr;    // [n+1] incident edges of each keyframe
  const int* inc;        // [2E] 2 e + side (0: i, 1: j)
  const int* pair_ptr;   // [P+1] edges of each keyframe pair a < b
  const int* pair_list;  // 2 e + flip (1: edge i = b, j = a)
  const int* colptr;     // [n+1] blocks of each kernel column
  const int* rowidx;     // [nb] block row; n: the border (right-hand side)
  const int* bcol;       // [nb] block column
  const int* bsrc;       // [nb] -1 diagonal, -2 border, -3 fill, 2 pair + t
  const int* col_kf;     // [n] keyframe of each kernel column
  const int* kf_col;     // [n]
  const int* lvl_col;    // [n_lvl+1] columns of each level
  const int* lvl_tgt;    // [n_lvl+1] update targets of each level
  const int* lvl_mid;    // [n_lvl] its first target beyond the next level
  const int* tgt;        // [T] target block
  const int* tgt_ptr;    // [T+1] its updates
  const int* src;        // [2U] blocks (i,k), (j,k), ascending k
  double* st0;           // [n,13] states, two buffers
  double* st1;
  double* J;             // [E,7,14]
  double* r;             // [E,7]
  double* L;             // [nb,49] the factor's blocks
  double* x;             // [7n] the step, kernel column order
  double* part;          // [grid] cost partials
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
  const int o = g.sel[e];
  for (int k = 0; k < 9; ++k) R[k] = T(double(g.Rji[9 * o + k]));
  for (int k = 0; k < 3; ++k) t[k] = T(double(g.tji[3 * o + k]));
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
  sim3_edge(Si, Sj, R, t, T(double(g.sji[o])), di, dj, g.four_dof != 0, r);
}

__device__ void linearize(const Graph& g, const double* st, int tid) {
  const int e = tid / 14, dir = tid % 14;
  double* Je = g.J + size_t(98) * e;
  if (g.four_dof && mask4(dir % 7) == 0.0) {
    for (int k = 0; k < 7; ++k) Je[14 * k + dir] = 0.0;
    return;
  }
  Dual r[7];
  edge_residual<Dual>(g, st, e, dir, r);
  for (int k = 0; k < 7; ++k) Je[14 * k + dir] = r[k].d;
  if (dir == 0)
    for (int k = 0; k < 7; ++k) g.r[7 * e + k] = r[k].v;
}

// entry e of pattern block b of the damped normal matrix (or border row)
__device__ double assemble(const Graph& g, int b, int e, double lam) {
  const int p = e / 7, q = e % 7;
  const int s = g.bsrc[b];
  const int a = g.col_kf[g.bcol[b]];
  if (s == -1) {  // diagonal: H_aa, or the unit block of a fixed keyframe
    if (!g.free[a]) return p == q ? 1.0 : 0.0;
    double h = 0.0;
    for (int c = g.inc_ptr[a]; c < g.inc_ptr[a + 1]; ++c) {
      const int ed = g.inc[c] >> 1, side = g.inc[c] & 1;
      const double* Je = g.J + size_t(98) * ed + 7 * side;
      double v = 0.0;
      for (int k = 0; k < 7; ++k) v += Je[14 * k + p] * Je[14 * k + q];
      h += v * double(g.info[g.sel[ed]]);
    }
    if (p == q) h += h * lam + 1e-6;
    return h;
  }
  if (s == -2) {  // border: its first row is -J^T r of keyframe a
    if (p != 0 || !g.free[a]) return 0.0;
    double v = 0.0;
    for (int c = g.inc_ptr[a]; c < g.inc_ptr[a + 1]; ++c) {
      const int ed = g.inc[c] >> 1, side = g.inc[c] & 1;
      const double* Je = g.J + size_t(98) * ed + 7 * side;
      double u = 0.0;
      for (int k = 0; k < 7; ++k) u += Je[14 * k + q] * g.r[7 * ed + k];
      v -= u * double(g.info[g.sel[ed]]);
    }
    return v;
  }
  if (s == -3) return 0.0;
  // the pair's sum h(u, w) = sum_e J_small[:, u] . J_large[:, w]; the
  // block stores H_(large, small) (entry [p][q] = h(q, p)) or, with t = 1,
  // H_(small, large)
  const int pr = s >> 1;
  const int u = (s & 1) ? p : q, w = (s & 1) ? q : p;
  double h = 0.0;
  for (int c = g.pair_ptr[pr]; c < g.pair_ptr[pr + 1]; ++c) {
    const int ed = g.pair_list[c] >> 1, flip = g.pair_list[c] & 1;
    const double* Je = g.J + size_t(98) * ed;
    const int ca = flip ? 7 : 0, cb = flip ? 0 : 7;
    double v = 0.0;
    for (int k = 0; k < 7; ++k) v += Je[14 * k + ca + u] * Je[14 * k + cb + w];
    h += v * double(g.info[g.sel[ed]]);
  }
  return h;
}

// ---- the factorization and both solves, by block 0

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// an asynchronous 8-byte copy from global to shared memory, its group
// commit, and the wait until at most N of this thread's groups are pending
__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The window of blocks [lo, hi) in the ring of cap slots: block b in slot
// b - base (mod cap), base a multiple of cap at most lo; others in global
struct Window {
  double* ring;
  double* L;
  int lo, hi, base, cap;
  __device__ double* slot(int b) const {
    int s = b - base;
    if (s >= cap) s -= cap;
    return ring + size_t(s) * kBlk;
  }
  __device__ double* at(int b) const {
    return (b < lo || b >= hi) ? L + size_t(b) * kBlk : slot(b);
  }
  __device__ void set_lo(int l) {  // the window moves a little at a time
    lo = l;
    while (l < base) base -= cap;
    while (l >= base + cap) base += cap;
  }
};

// The inverse X = L^{-1} of the Cholesky factor L of the 7x7 block at D
// (its lower triangle read), in one thread's registers: the chain is 7
// pivots deep, the rest independent multiply-adds.  A non-positive pivot
// gives NaN.
__device__ __forceinline__ void diag_inverse(const double* D,
                                             double X[7][7]) {
  const double qnan = __longlong_as_double(0x7ff8000000000000LL);
  double a[7][7];
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int k = 0; k <= i; ++k) a[i][k] = D[7 * i + k];
  double di[7];
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    const double piv = a[j][j];
    const double inv = piv > 0.0 ? rsqrt(piv) : qnan;
    di[j] = inv;
#pragma unroll
    for (int i = j + 1; i < 7; ++i) a[i][j] *= inv;
#pragma unroll
    for (int i = j + 1; i < 7; ++i)
#pragma unroll
      for (int k = j + 1; k <= i; ++k)
        a[i][k] = fma(-a[i][j], a[k][j], a[i][k]);
  }
  // X = L^{-1}, column by column (independent chains)
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    X[j][j] = di[j];
#pragma unroll
    for (int i = j + 1; i < 7; ++i) {
      double s = 0.0;
#pragma unroll
      for (int k = j; k < i; ++k) s = fma(-a[i][k], X[k][j], s);
      X[i][j] = s * di[i];
    }
  }
}

// row r of the blocks below diagonal block d (block d + 1 + r / 7, row
// r % 7) times X^T: A_ik L_kk^{-T}; the border block has one row
__device__ __forceinline__ void row_below(const Window& w, const double X[7][7],
                                          int d, int r, int n,
                                          const int* rowidx,
                                          bool write_back) {
  const int b = d + 1 + r / 7, p = r % 7;
  if (rowidx[b] == n && p > 0) return;
  double* A = w.at(b);
  double x[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) x[k] = A[7 * p + k];
  double* Ag = w.L + size_t(b) * kBlk;
  const bool wb = write_back && A != Ag;
#pragma unroll
  for (int q = 0; q < 7; ++q) {
    double v = 0.0;
#pragma unroll
    for (int k = 0; k <= q; ++k) v = fma(x[k], X[q][k], v);
    A[7 * p + q] = v;
    if (wb) Ag[7 * p + q] = v;
  }
}

// lane i < 7 writes row i of X over the diagonal block's lower triangle,
// after every lane has read the block
__device__ __forceinline__ void write_inverse(double* D, double* Dg,
                                              const double X[7][7],
                                              int lane) {
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 7; ++i)
    if (lane == i) {
#pragma unroll
      for (int k = 0; k <= i; ++k) {
        D[7 * i + k] = X[i][k];
        if (Dg) Dg[7 * i + k] = X[i][k];
      }
    }
}

// One warp: the column's 7x7 diagonal block d factored and inverted (every
// lane the whole block in its registers, so no shuffle waits), written over
// its lower triangle, then the column's blocks below, one lane a row (each
// final block also into global memory with write_back)
__device__ void factor_column(const Window& w, int d, int de, int n,
                              const int* rowidx, bool write_back, int lane) {
  double* D = w.at(d);
  double X[7][7];
  diag_inverse(D, X);
  double* Dg = w.L + size_t(d) * kBlk;
  write_inverse(D, write_back && D != Dg ? Dg : nullptr, X, lane);
  for (int r = lane; r < (de - d - 1) * 7; r += 32)
    row_below(w, X, d, r, n, rowidx, write_back);
}

// the pattern's tables as block 0 reads them: copied into its shared
// memory once a launch where they fit (every graph of the closer's paths),
// else read from global memory
struct Meta {
  const int* colptr;
  const int* rowidx;
  const int* bcol;
  const int* lvl_col;
  const int* lvl_tgt;
  const int* lvl_mid;
  const int* tgt;
  const int* tgt_ptr;
  const int* src;
};

__device__ Meta load_meta(const Graph& g, int* sm) {
  const int n = g.n, nb = g.nb, L = g.n_lvl, T = g.n_tgt, U = g.n_upd;
  const int* from[9] = {g.colptr, g.rowidx, g.bcol,    g.lvl_col, g.lvl_tgt,
                        g.lvl_mid, g.tgt,    g.tgt_ptr, g.src};
  const int len[9] = {n + 1, nb, nb, L + 1, L + 1, L, T, T + 1, 2 * U};
  const int* to[9];
  int off = 0;
  for (int k = 0; k < 9; ++k) {
    if (g.meta_resident) {
      for (int i = threadIdx.x; i < len[k]; i += kThreads)
        sm[off + i] = from[k][i];
      to[k] = sm + off;
      off += len[k];
    } else {
      to[k] = from[k];
    }
  }
  __syncthreads();
  return Meta{to[0], to[1], to[2], to[3], to[4],
              to[5], to[6], to[7], to[8]};
}

// targets [T0, T1) by threads tid, tid + nthr, ...: each entry's updates
// L_ij -= L_ik L_jk^T in ascending column order (the host's schedule), so
// an entry's sum does not depend on which thread runs it
__device__ void apply_updates(const Window& w, const Meta& m, int n, int T0,
                              int T1, int tid, int nthr) {
  for (int i = tid; i < (T1 - T0) * kBlk; i += nthr) {
    const int k = T0 + i / kBlk, e = i % kBlk, p = e / 7, q = e % 7;
    const int bt = m.tgt[k];
    const int row = m.rowidx[bt];
    if ((row == n && p > 0) || (row == m.bcol[bt] && q > p)) continue;
    double* Tg = w.at(bt);
    double v = Tg[e];
    for (int s = m.tgt_ptr[k]; s < m.tgt_ptr[k + 1]; ++s) {
      const double* X = w.at(m.src[2 * s]) + 7 * p;
      const double* Y = w.at(m.src[2 * s + 1]) + 7 * q;
      // two chains of multiply-adds, even and odd terms
      double d0 = X[0] * Y[0], d1 = X[1] * Y[1];
#pragma unroll
      for (int r = 2; r < 7; r += 2) d0 = fma(X[r], Y[r], d0);
#pragma unroll
      for (int r = 3; r < 7; r += 2) d1 = fma(X[r], Y[r], d1);
      v -= d0 + d1;
    }
    Tg[e] = v;
  }
}

__device__ void chol_solve(const Graph& g, const Meta& m, double* smem,
                          unsigned long long* tm) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n = g.n, nb = g.nb, cap = g.cap;
  double* xs = smem;                      // [7n] the solution
  double* rt = xs + 7 * n;                // [7n] the backward partials
  double* stg = rt + 7 * n + g.meta_d;    // [kNBuf, kChunk] (streamed)
  const bool streamed = g.path == 1;
  Window w{streamed ? stg + kNBuf * kChunk : stg, g.L, 0, min(nb, cap), 0,
           cap};
  for (int i = t; i < w.hi * kBlk; i += kThreads) w.ring[i] = g.L[i];
  __syncthreads();
  // forward: factor each level, the border rows giving y = L^{-1} b.
  // Per level, between two barriers: (1) a warp a column factors it, its
  // inverse and the blocks below, while the other warps apply the
  // previous level's updates to the columns beyond this one; (2) every
  // thread applies this level's updates to the next level's columns.
  // Streamed, the window gains up to kChunk doubles of blocks a level in
  // (2): their slots are zeroed and collect the updates while the blocks'
  // values come in by cp.async into a staging buffer, added kDist + 1
  // levels later (or before a level that reaches them).  The pending
  // ranges, oldest first (first block, doubles, buffer), are a FIFO of
  // registers
  int qs[kDist + 1], qn[kDist + 1], qb[kDist + 1];
#pragma unroll
  for (int k = 0; k <= kDist; ++k) qs[k] = qn[k] = qb[k] = 0;
  int buf = 0;        // the staging buffer of this level's copies
  bool clean = true;  // the window never restarted
  auto add_pending = [&](int first, int nd, int b) {
    for (int i = t; i < nd; i += kThreads)
      w.slot(first + i / kBlk)[i % kBlk] += stg[b * kChunk + i];
  };
  auto update = [&](int T0, int T1, int tid, int nthr) {
    apply_updates(w, m, n, T0, T1, tid, nthr);
  };
  for (int l = 0; l < g.n_lvl; ++l) {
    const int c0 = m.lvl_col[l], c1 = m.lvl_col[l + 1];
    // the end of the next level's blocks
    const int N1 = l + 1 < g.n_lvl ? m.colptr[m.lvl_col[l + 2]] : nb;
    if (streamed) {
      bool need = false;
#pragma unroll
      for (int k = 0; k <= kDist; ++k) need |= qn[k] > 0 && qs[k] < N1;
      if (need) {  // a pending range reaches this level or the next
        cp_wait<0>();
        __syncthreads();
#pragma unroll
        for (int k = 0; k <= kDist; ++k) {
          add_pending(qs[k], qn[k], qb[k]);
          qn[k] = 0;
        }
        __syncthreads();
      }
      // the blocks below the previous level's are done (the previous
      // level's are still read in (1))
      const int P0 = l > 0 ? m.colptr[m.lvl_col[l - 1]] : 0;
      w.set_lo(min(max(w.lo, P0), w.hi));
    }
    // (1) this level's columns || the previous level's remaining updates
    const int ncol = c1 - c0;
    for (int c = c0 + warp; c < c1; c += kWarps)
      factor_column(w, m.colptr[c], m.colptr[c + 1], n, m.rowidx, streamed,
                    lane);
    if (l > 0) {
      const int busy = ncol < kWarps ? 32 * ncol : 0;
      if (t >= busy)
        update(m.lvl_mid[l - 1], m.lvl_tgt[l], t - busy, kThreads - busy);
    }
    // the copies of level l - kDist - 1, added in (2), have landed
    if (streamed) cp_wait<kDist>();
    __syncthreads();
    // (2) this level's updates to the next level's columns, the copies of
    // level l - kDist - 1 added, the window extended
    update(m.lvl_tgt[l], m.lvl_mid[l], t, kThreads);
    if (streamed) {
      if (qn[0] > 0) add_pending(qs[0], qn[0], qb[0]);
      if (w.lo >= w.hi) {  // an empty window restarts past the next level
        w.hi = max(w.hi, N1);
        w.set_lo(w.hi);
        clean = false;
      }
      const int hi2 = w.hi >= N1
                          ? min(min(nb, w.lo + cap), w.hi + kChunk / kBlk)
                          : w.hi;
      const int nd = (hi2 - w.hi) * kBlk;
      for (int i = t; i < nd; i += kThreads) {
        w.slot(w.hi + i / kBlk)[i % kBlk] = 0.0;
        cp_async8(stg + buf * kChunk + i, g.L + size_t(w.hi) * kBlk + i);
      }
      cp_commit();
#pragma unroll
      for (int k = 0; k < kDist; ++k) {
        qs[k] = qs[k + 1];
        qn[k] = qn[k + 1];
        qb[k] = qb[k + 1];
      }
      qs[kDist] = w.hi;
      qn[kDist] = nd;
      qb[kDist] = buf;
      buf = buf + 1 == kNBuf ? 0 : buf + 1;
      w.hi = hi2;
    }
    __syncthreads();
  }
  if (streamed) {
    cp_wait<0>();
    __syncthreads();
#pragma unroll
    for (int k = 0; k <= kDist; ++k) add_pending(qs[k], qn[k], qb[k]);
  }
  __syncthreads();
  if (tm && t == 0) tm[0] = globaltimer();
  // backward: x_k = L_kk^{-T} (y_k - sum_i L_ik^T x_i), level by level
  // down.  Streamed, the ring keeps what the forward walk left there and
  // gains up to kChunk doubles of lower blocks a level by cp.async, kDist
  // levels ahead of their use
  int ready = 0;  // the window's blocks >= ready have landed
  if (streamed) {
    // without a restart the ring holds the last cap blocks, final
    const bool kept = clean && w.hi == nb;
    w.hi = nb;
    w.set_lo(kept ? max(0, nb - cap) : nb);
    ready = w.lo;
  }
  int gs[kDist + 1];  // the first block of each level's copies, oldest first
#pragma unroll
  for (int k = 0; k <= kDist; ++k) gs[k] = nb;
  for (int l = g.n_lvl - 1; l >= 0; --l) {
    const int c0 = m.lvl_col[l], c1 = m.lvl_col[l + 1];
    const int B0 = m.colptr[c0], B1 = m.colptr[c1];
    if (streamed) {
      if (max(B0, w.lo) < ready) {  // this level's copies still in flight
        cp_wait<0>();
        __syncthreads();
        ready = w.lo;
      }
      // blocks below the window into the slots of blocks already done
      const int nlo = max(max(0, B1 - cap), w.lo - kChunk / kBlk);
      if (nlo < w.lo) {
        const int nd = (w.lo - nlo) * kBlk;
        w.set_lo(nlo);
        for (int i = t; i < nd; i += kThreads)
          cp_async8(w.slot(nlo + i / kBlk) + i % kBlk,
                    g.L + size_t(nlo) * kBlk + i);
      }
      cp_commit();
#pragma unroll
      for (int k = 0; k < kDist; ++k) gs[k] = gs[k + 1];
      gs[kDist] = w.lo;
    }
    // a level's blocks that have not landed come from global memory
    auto blk = [&](int b) -> const double* {
      return b < ready ? g.L + size_t(b) * kBlk : w.at(b);
    };
    for (int i = t; i < (c1 - c0) * 7; i += kThreads) {
      const int c = c0 + i / 7, q = i % 7;
      const int bs = m.colptr[c], be = m.colptr[c + 1];
      double v = blk(be - 1)[q];
      for (int b = bs + 1; b < be - 1; ++b) {
        const double* Lb = blk(b) + q;
        const double* xr = xs + 7 * m.rowidx[b];
        double d0 = Lb[0] * xr[0], d1 = Lb[7] * xr[1];
#pragma unroll
        for (int s = 2; s < 7; s += 2) d0 = fma(Lb[7 * s], xr[s], d0);
#pragma unroll
        for (int s = 3; s < 7; s += 2) d1 = fma(Lb[7 * s], xr[s], d1);
        v -= d0 + d1;
      }
      rt[7 * c + q] = v;
    }
    __syncthreads();
    for (int i = t; i < (c1 - c0) * 7; i += kThreads) {
      const int c = c0 + i / 7, p = i % 7;
      const double* D = blk(m.colptr[c]);
      double v = 0.0;
      for (int q = p; q < 7; ++q) v = fma(D[7 * q + p], rt[7 * c + q], v);
      xs[7 * c + p] = v;
    }
    if (streamed) {
      cp_wait<kDist>();
      ready = min(ready, gs[0]);  // the copies of kDist levels ago landed
    }
    __syncthreads();
  }
  if (streamed) cp_wait<0>();
  for (int i = t; i < 7 * n; i += kThreads) g.x[i] = xs[i];
}

// Path 2, the whole grid on the factor in global memory (where the fill
// gives each level many updates): per level, (1) the level's columns, a
// warp an item of 32 rows below a diagonal block (each such warp inverts
// the block in its registers), beside the previous level's remaining
// updates; (2) the inverses written over the diagonal blocks (no update
// reads them) and this level's updates to the next level's columns, every
// target entry by one thread in the schedule's order; a grid barrier after
// each.  Then block 0 solves backward, a warp a row of a level's columns,
// its lanes over the blocks below.
__device__ void chol_solve_grid(const Graph& g, const Meta& m, double* smem,
                                cg::grid_group& grid,
                                unsigned long long* tm) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gt = blockIdx.x * kThreads + t, gn = gridDim.x * kThreads;
  const int gw = gt >> 5, nw = gn >> 5;
  const int n = g.n;
  const Window w{nullptr, g.L, 0, 0, 0, 1};  // empty: every block global
  for (int l = 0; l < g.n_lvl; ++l) {
    const int c0 = m.lvl_col[l], c1 = m.lvl_col[l + 1];
    int item = 0;  // (column, 32 rows) items dealt to the warps in turn
    for (int c = c0; c < c1; ++c) {
      const int d = m.colptr[c], rows = (m.colptr[c + 1] - d - 1) * 7;
      const int nch = (rows + 31) >> 5;
      int ch = gw - item % nw;
      if (ch < 0) ch += nw;
      if (ch < nch) {
        double X[7][7];
        diag_inverse(g.L + size_t(d) * kBlk, X);
        for (; ch < nch; ch += nw) {
          const int r = 32 * ch + lane;
          if (r < rows) row_below(w, X, d, r, n, m.rowidx, false);
        }
      }
      item += nch;
    }
    if (l > 0) apply_updates(w, m, n, m.lvl_mid[l - 1], m.lvl_tgt[l], gt, gn);
    grid.sync();
    for (int c = c0 + gw; c < c1; c += nw) {
      double* D = g.L + size_t(m.colptr[c]) * kBlk;
      double X[7][7];
      diag_inverse(D, X);
      write_inverse(D, nullptr, X, lane);
    }
    apply_updates(w, m, n, m.lvl_tgt[l], m.lvl_mid[l], gt, gn);
    grid.sync();
  }
  if (blockIdx.x != 0) return;
  if (tm && t == 0) tm[0] = globaltimer();
  double* xs = smem;          // [7n] the solution
  double* rt = xs + 7 * n;    // [7n] the backward partials
  for (int l = g.n_lvl - 1; l >= 0; --l) {
    const int c0 = m.lvl_col[l], c1 = m.lvl_col[l + 1];
    for (int i = warp; i < (c1 - c0) * 7; i += kWarps) {
      const int c = c0 + i / 7, q = i % 7;
      const int bs = m.colptr[c], be = m.colptr[c + 1];
      double v = 0.0;
      for (int b = bs + 1 + lane; b < be - 1; b += 32) {
        const double* Lb = g.L + size_t(b) * kBlk + q;
        const double* xr = xs + 7 * m.rowidx[b];
        double d0 = Lb[0] * xr[0], d1 = Lb[7] * xr[1];
#pragma unroll
        for (int s = 2; s < 7; s += 2) d0 = fma(Lb[7 * s], xr[s], d0);
#pragma unroll
        for (int s = 3; s < 7; s += 2) d1 = fma(Lb[7 * s], xr[s], d1);
        v += d0 + d1;
      }
      for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(kFull, v, s);
      if (lane == 0) rt[7 * c + q] = g.L[size_t(be - 1) * kBlk + q] - v;
    }
    __syncthreads();
    for (int i = t; i < (c1 - c0) * 7; i += kThreads) {
      const int c = c0 + i / 7, p = i % 7;
      const double* D = g.L + size_t(m.colptr[c]) * kBlk;
      double v = 0.0;
      for (int q = p; q < 7; ++q) v = fma(D[7 * q + p], rt[7 * c + q], v);
      xs[7 * c + p] = v;
    }
    __syncthreads();
  }
  for (int i = t; i < 7 * n; i += kThreads) g.x[i] = xs[i];
}

// the cost of states st, summed in a fixed order for the grid's size:
// a partial a block, then the partials in block order, in every block
__device__ double total_cost(const Graph& g, const double* st,
                             cg::grid_group& grid, double* red,
                             double* bcast) {
  const int t = threadIdx.x;
  double acc = 0.0;
  for (int e = t * gridDim.x + blockIdx.x; e < g.E;
       e += gridDim.x * kThreads) {
    double r[7];
    edge_residual<double>(g, st, e, 0, r);
    double c2 = 0.0;
    for (int k = 0; k < 7; ++k) c2 += r[k] * r[k];
    acc += c2 * double(g.info[g.sel[e]]);
  }
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_down_sync(kFull, acc, s);
  if ((t & 31) == 0) red[t >> 5] = acc;
  __syncthreads();
  if (t == 0) {
    double c = 0.0;
    for (int w = 0; w < kWarps; ++w) c += red[w];
    g.part[blockIdx.x] = c;
  }
  grid.sync();
  if (t == 0) {
    double c = 0.0;
    for (int b = 0; b < int(gridDim.x); ++b) c += g.part[b];
    *bcast = c;
  }
  __syncthreads();
  const double c = *bcast;
  __syncthreads();
  return c;
}

// prof, where given: nanoseconds by phase, summed over the iterations
// (block 0's view: linearize, assemble, forward, backward, update and
// cost)
__global__ void __launch_bounds__(kThreads)
pg_kernel(Graph g, const float* __restrict__ in, float* __restrict__ out,
          int* path, int iters, unsigned long long* prof) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ double smem[];
  __shared__ double red[kWarps], bcast;
  const int gt = blockIdx.x * kThreads + threadIdx.x;
  const int gn = gridDim.x * kThreads;
  const bool timer = prof && gt == 0;
  unsigned long long tm[2], acc[5] = {0, 0, 0, 0, 0}, t0 = 0;
  double* cur = g.st0;
  double* nxt = g.st1;
  for (int i = gt; i < 13 * g.n; i += gn) cur[i] = in[i];
  if (gt == 0) *path = g.path;
  Meta m{};
  if (blockIdx.x == 0 || g.path == 2)
    m = load_meta(g, reinterpret_cast<int*>(smem + 14 * size_t(g.n)));
  grid.sync();
  double lam = 1e-4;
  double cost = total_cost(g, cur, grid, red, &bcast);
  for (int it = 0; it < iters; ++it) {
    if (timer) t0 = globaltimer();
    // item i to block i % grid: few items a block, whose Dual stacks
    // (local memory) then stay in its multiprocessor's L1
    for (int i = threadIdx.x * gridDim.x + blockIdx.x; i < 14 * g.E; i += gn)
      linearize(g, cur, i);
    grid.sync();
    if (timer) tm[1] = globaltimer(), acc[0] += tm[1] - t0, t0 = tm[1];
    for (int i = gt; i < g.nb * kBlk; i += gn)
      g.L[i] = assemble(g, i / kBlk, i % kBlk, lam);
    grid.sync();
    if (timer) tm[1] = globaltimer(), acc[1] += tm[1] - t0, t0 = tm[1];
    if (g.path == 2)
      chol_solve_grid(g, m, smem, grid, timer ? tm : nullptr);
    else if (blockIdx.x == 0)
      chol_solve(g, m, smem, timer ? tm : nullptr);
    grid.sync();
    if (timer) {
      tm[1] = globaltimer();
      acc[2] += tm[0] - t0;
      acc[3] += tm[1] - tm[0];
      t0 = tm[1];
    }
    for (int a = gt; a < g.n; a += gn) {
      double d[7];
      const double f = g.free[a] ? 1.0 : 0.0;
      const double* xa = g.x + 7 * g.kf_col[a];
      for (int k = 0; k < 7; ++k) d[k] = xa[k] * f;
      retract_state(cur + 13 * a, d, g.four_dof != 0, nxt + 13 * a);
    }
    grid.sync();
    const double c = total_cost(g, nxt, grid, red, &bcast);
    const bool accept = c < cost;
    if (accept) {
      cost = c;
      double* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    lam = fmin(fmax(accept ? lam * 0.5 : lam * 4.0, 1e-8), 1e4);
    if (timer) acc[4] += globaltimer() - t0;
  }
  for (int i = gt; i < 13 * g.n; i += gn) out[i] = float(cur[i]);
  if (timer)
    for (int k = 0; k < 5; ++k) prof[k] = acc[k];
}

}  // namespace

// ints: the int tables of models/kernels.py pose_graph, one after another
// at the host offsets offs[0..kTables]; nb pattern blocks in n_lvl levels,
// n_tgt update targets, n_upd updates.  path: the one the host chose
// (models/kernels.py pg_path): 0 the factor resident in shared memory
// (an error where it does not fit), 1 streamed through a window there, 2
// the whole grid on the factor in global memory.  Workspace: doubles, 26
// n + 105 E + 49 nb + 7 n + 1024.  prof: null, or 5 counters (pg_kernel).
PLVIO_API int pose_graph(const void* states, const void* free, int n,
                         const void* Rji, const void* tji, const void* sji,
                         const void* info, const void* ints, int E,
                         const void* offs, int nb, int n_lvl,
                         int n_tgt, int n_upd, int four_dof, int iters,
                         int path_req, void* work, void* out, void* path,
                         void* prof, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* I = static_cast<const int*>(ints);
  const int* o = static_cast<const int*>(offs);
  double* w = static_cast<double*>(work);
  Graph g{};
  g.n = n;
  g.E = E;
  g.four_dof = four_dof;
  g.nb = nb;
  g.n_lvl = n_lvl;
  g.n_tgt = n_tgt;
  g.n_upd = n_upd;
  g.free = static_cast<const uint8_t*>(free);
  g.Rji = static_cast<const float*>(Rji);
  g.tji = static_cast<const float*>(tji);
  g.sji = static_cast<const float*>(sji);
  g.info = static_cast<const float*>(info);
  const int** tabs[kTables] = {
      &g.ei, &g.ej, &g.sel, &g.inc_ptr, &g.inc, &g.pair_ptr, &g.pair_list,
      &g.colptr, &g.rowidx, &g.bcol, &g.bsrc, &g.col_kf, &g.kf_col,
      &g.lvl_col, &g.lvl_tgt, &g.lvl_mid, &g.tgt, &g.tgt_ptr, &g.src};
  for (int k = 0; k < kTables; ++k) *tabs[k] = I + o[k];
  g.st0 = w;
  g.st1 = w + 13 * size_t(n);
  g.J = w + 26 * size_t(n);
  g.r = g.J + 98 * size_t(E);
  g.L = g.r + 7 * size_t(E);
  g.x = g.L + size_t(kBlk) * nb;
  g.part = g.x + 7 * size_t(n);
  // shared memory (doubles): the solution and the backward partials (14
  // n); on the paths of block 0 alone, the pattern's tables where they
  // leave room for the staging buffers and kMinCap blocks, then the whole
  // factor (path 0) or the staging buffers and as many blocks as fit (path
  // 1); the same sums as models/kernels.py pg_resident
  const size_t fixed = 14 * size_t(n);
  const size_t avail = (kSmemMax - kStaticSmem) / sizeof(double);
  const size_t stage = size_t(kNBuf) * kChunk;
  const size_t meta_ints = size_t(n + 1) + 2 * size_t(nb) +
                           3 * size_t(n_lvl) + 2 + 2 * size_t(n_tgt) + 1 +
                           2 * size_t(n_upd);
  const size_t meta_d = (meta_ints + 1) / 2;
  if (fixed + stage + size_t(kBlk) * kMinCap > avail || path_req < 0 ||
      path_req > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  g.path = path_req;
  g.meta_resident = path_req != 2 &&
                    fixed + meta_d + stage + size_t(kBlk) * kMinCap <= avail;
  g.meta_d = g.meta_resident ? static_cast<int>(meta_d) : 0;
  const size_t rest = avail - fixed - g.meta_d;
  if (path_req == 0 && size_t(kBlk) * nb > rest)
    return static_cast<int>(cudaErrorInvalidValue);
  g.cap = path_req == 0 ? nb
          : path_req == 1 ? static_cast<int>((rest - stage) / kBlk)
                          : 1;
  const size_t smem = (fixed + g.meta_d +
                       (path_req == 0   ? size_t(kBlk) * nb
                        : path_req == 1 ? stage + size_t(kBlk) * g.cap
                                        : 0)) *
                      sizeof(double);
  cudaError_t e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaFuncSetAttribute(pg_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem))) != cudaSuccess ||
      (e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, pg_kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // enough blocks for the widest grid phase, at most one a multiprocessor
  // (every one on path 2)
  const int want = path_req == 2 ? sms * kThreads
                                 : max(max(14 * E, kBlk * nb), 1);
  const int grid = max(1, min(sms, (want + kThreads - 1) / kThreads));
  const float* in = static_cast<const float*>(states);
  float* outp = static_cast<float*>(out);
  int* pathp = static_cast<int*>(path);
  unsigned long long* profp = static_cast<unsigned long long*>(prof);
  void* args[] = {&g, &in, &outp, &pathp, &iters, &profp};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(pg_kernel), dim3(grid), dim3(kThreads), args,
      smem, s));
}
