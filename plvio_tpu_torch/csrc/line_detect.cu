// line_detect — the line detector of one pyramid level: bf16 Scharr
// gradients, 4x4-cell structure tensors and line atoms, the 8-neighbour
// links, pointer-jumping connected components, the per-component fit and
// endpoints, and the top-K segments by length.
//
// Replaces plvio_tpu/ops/lines.py `_gradients` (:47) and `detect_lines`
// (:63).  The JAX version rolls whole [Hc,Wc] grids eight times per link
// predicate and per pointer-jumping sweep, and aggregates components by
// scatter-adds; its eager torch counterpart issues ~1500 small launches per
// level.
//
// What bounds it on the H100: launches and latency, not bytes.  A level is
// 0.36 M pixels (1.4 MB of float32 image) and 22,560 cells; the work is a
// few hundred operations per cell.  The sweeps are sequential, each needs
// the previous one's labels everywhere, and the aggregation needs the
// sweeps' result.
//
// Design: one host call detects every level of a frame (the pyramid's two)
// in two launches, into a workspace the caller allocates once.
//  1. cells: one grid for all levels, one block per 16x16-cell tile (96 +
//     24 tiles at 480x752); the tile's image plus a one-cell and one-pixel
//     halo (74x74 px) sits in shared memory, rounded to bf16 as the
//     reference's bf16 convolution input.  Each thread computes its 16
//     pixels' Scharr gradients (one float32 sum of exact products, rounded
//     once to bf16), the magnitude in bf16 arithmetic (every product, sum
//     and sqrt rounded to bf16 with __float2bfloat16_rn, as torch's bf16
//     ops round each step), the edge weights, the cell moments in float32
//     and the structure tensor, then the atom test; halo cells are
//     recomputed so that each thread can write the 8-bit link mask of its
//     cell.  bf16 gx, gy go to device memory for the refit and the
//     descriptor.
//  2. components and top-K: one block of 1024 threads a level holds two
//     label buffers of the level's cell grid and its links in shared
//     memory (2 x 4 x 22,560 + 22,560 B at level 0) and runs the
//     jump_iters synchronous sweeps with __syncthreads in place of the
//     rolls: the neighbour minimum and the first hop read the previous
//     sweep's labels, the second hop the first hop's (double-buffered, as
//     the reference's pointer jumping is synchronous).  Only the labels in
//     use get a row: a block-wide scan numbers them in index order, so
//     the atom cells' sums, each label's fit and its endpoint min/max
//     touch those rows alone, in shared memory over the second label
//     buffer (as many rows at a time as fit: ~1600 at level 0; no global
//     atomics), and the sweeps and sums visit the atoms alone.  The sums
//     are 64-bit fixed-point integer atomics (pairs of 32-bit ones with a
//     carry): float atomics add in a different order on every run, and a
//     last-bit change of two nearly equal segment lengths (the two edges
//     of a bar) reorders the top-K, which changes what the order-dependent
//     collinear merge joins; integer sums are the same on every run.  The
//     endpoints' min / max are integer atomics on keys of the floats'
//     order (exact, one instruction, no compare-and-swap loop).  The
//     roots with a score above 0 are bitonic-sorted in shared memory on
//     (score descending, row ascending: the index order), the network's
//     every exchange putting the larger key lower so that the padding to a
//     power of two is never stored; the rest of the top-K are the
//     lowest-index cells with score 0, in order, as the reference's stable
//     descending sort (lax.top_k) gives them.  Endpoints, angle, length
//     and valid go straight to the outputs.
// Sums are taken in another order (cell moments sequentially) or exactly
// (components) where the plain version rounds each float addition, so
// segments near a threshold or a near-tie of lengths may differ; the two
// are compared as segment sets.  An optional buffer gets the level-0
// block's time by stage (%globaltimer stamps).
#include "lines.cuh"

namespace {

constexpr int kTile = 16;                   // cells per tile side
constexpr int kCell = 4;                    // pixels per cell side
constexpr int kHalo = kTile + 2;            // cells with the halo ring
constexpr int kImg = kHalo * kCell + 2;     // 74 px
constexpr int kCompThreads = 1024;
constexpr int kMaxLevels = 2;
constexpr int kSmemMax = 232448;            // bytes a block may use
constexpr float kBig = 1e9f;
// profile stages of the level-0 block: init, sweeps, rows (the labels in
// use numbered), sums (moments, fits, endpoints, scores), tail, sort,
// write; then the level-1 block's whole time, the level-0 rows and good
// roots
constexpr int kStages = 7;

// one level: image, workspace (rows: one per label in use, at most
// cells + 1) and outputs; the host's ops/lines.py `_Level`
struct Level {
  const float* img;
  int H, W, n;                  // n: top-K rows, at most the cells
  float* cell;                  // [C][3] wsum, cx, cy
  uint8_t* atom;                // [C]
  uint8_t* links;               // [C]
  int* rowmap;                  // [C] the row of label i, or -1
  float* comp;                  // [rows][6] mx, my, vx, vy, pmin, pmax
  float* score;                 // [rows]
  int* label;                   // [rows] the row's label l, -l - 1 unless
                                // l is a root (its own label)
  __nv_bfloat16* gx;
  __nv_bfloat16* gy;
  float* ep;                    // [n][4]
  float* ang;                   // [n]
  float* length;                // [n]
  uint8_t* valid;               // [n]
};

struct Frame {
  Level lv[kMaxLevels];
  int nlev, tiles0, tiles_x[kMaxLevels], links_smem, smem;
  float grad_th, aniso_th, angle_tol, dist_tol, min_length;
  int min_cells, jump_iters;
  unsigned long long* prof;     // [kStages + 3] or null
};

struct DetectParams {
  int H, W, Hc, Wc;
  float grad_th, aniso_th, angle_tol, dist_tol, min_length;
  int min_cells, jump_iters;
};

__device__ __forceinline__ DetectParams level_params(const Frame& f,
                                                     int l) {
  const Level& L = f.lv[l];
  return DetectParams{L.H, L.W, L.H / kCell, L.W / kCell, f.grad_th,
                      f.aniso_th, f.angle_tol, f.dist_tol, f.min_length,
                      f.min_cells, f.jump_iters};
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct CellStat {
  float wsum, cx, cy, dx, dy, theta;
  int atom;
};

__device__ CellStat cell_stat(const DetectParams& p, const float (*img)[kImg],
                              int crow, int ccol, int ty0, int tx0) {
  // (crow, ccol) global cell; tile pixel origin (ty0, tx0) = global pixel
  // of tile position (0, 0)
  float wsum = 0.f, sx = 0.f, sy = 0.f, sxx = 0.f, sxy = 0.f, syy = 0.f;
  int cnt = 0;
  for (int sub = 0; sub < 16; ++sub) {
    const int y = crow * kCell + sub / kCell;
    const int x = ccol * kCell + sub % kCell;
    float gx, gy;
    scharr(img, y - ty0, x - tx0, &gx, &gy);
    float mag = bf_mag(gx, gy);
    const bool interior = y >= 3 && y < p.H - 3 && x >= 3 && x < p.W - 3;
    if (!interior) mag = 0.f;
    const float w = mag > p.grad_th ? mag : 0.f;
    wsum += w;
    cnt += w > 0.f;
    sx += w * float(x);
    sy += w * float(y);
    sxx += w * gx * gx;
    sxy += w * gx * gy;
    syy += w * gy * gy;
  }
  CellStat s;
  s.wsum = wsum;
  s.cx = sx / fmaxf(wsum, 1e-6f);
  s.cy = sy / fmaxf(wsum, 1e-6f);
  const float tr = sxx + syy;
  const float det = sxx * syy - sxy * sxy;
  const float disc = sqrtf(fmaxf(tr * tr / 4.f - det, 0.f));
  const float l1 = tr / 2.f + disc;
  const float l2 = tr / 2.f - disc;
  const float aniso = l1 / fmaxf(l2, 1e-6f);
  float nx = sxy, ny = l1 - sxx;
  const float nn = sqrtf(nx * nx + ny * ny);
  nx = nn > 1e-6f ? nx / nn : 1.f;
  ny = nn > 1e-6f ? ny / nn : 0.f;
  s.dx = -ny;
  s.dy = nx;
  s.theta = mod_pi(atan2f(s.dy, s.dx));
  s.atom = cnt >= p.min_cells && aniso > p.aniso_th
           && wsum > p.grad_th * float(p.min_cells);
  return s;
}

// one block per 16x16-cell tile of any level: blocks [0, tiles0) tile
// level 0, the rest level 1
__global__ void __launch_bounds__(kTile * kTile) cells_kernel(Frame f) {
  __shared__ float s_img[kImg][kImg];
  __shared__ CellStat s_cell[kHalo * kHalo];
  const int lvl = blockIdx.x < f.tiles0 ? 0 : 1;
  const int t = blockIdx.x - (lvl ? f.tiles0 : 0);
  const Level& L = f.lv[lvl];
  const DetectParams p = level_params(f, lvl);
  const float* img = L.img;
  const int tid = threadIdx.x;
  const int c0r = (t / f.tiles_x[lvl]) * kTile;
  const int c0c = (t % f.tiles_x[lvl]) * kTile;
  // tile pixel (0,0) = global pixel of halo cell (-1,-1) minus one pixel
  const int ty0 = (c0r - 1) * kCell - 1, tx0 = (c0c - 1) * kCell - 1;
  for (int i = tid; i < kImg * kImg; i += blockDim.x) {
    const int y = ty0 + i / kImg, x = tx0 + i % kImg;
    s_img[i / kImg][i % kImg] =
        (y >= 0 && y < p.H && x >= 0 && x < p.W) ? bf(img[y * p.W + x])
                                                 : 0.f;
  }
  __syncthreads();
  // gradients of the block's own pixel tile (64x64), including pixels that
  // lie beyond the last whole cell
  for (int i = tid; i < kTile * kCell * kTile * kCell; i += blockDim.x) {
    const int y = c0r * kCell + i / (kTile * kCell);
    const int x = c0c * kCell + i % (kTile * kCell);
    if (y >= p.H || x >= p.W) continue;
    float gx, gy;
    scharr(s_img, y - ty0, x - tx0, &gx, &gy);
    L.gx[y * p.W + x] = __float2bfloat16_rn(gx);
    L.gy[y * p.W + x] = __float2bfloat16_rn(gy);
  }
  for (int i = tid; i < kHalo * kHalo; i += blockDim.x) {
    const int cr = c0r - 1 + i / kHalo, cc = c0c - 1 + i % kHalo;
    if (cr < 0 || cr >= p.Hc || cc < 0 || cc >= p.Wc) {
      s_cell[i].atom = 0;
      continue;
    }
    s_cell[i] = cell_stat(p, s_img, cr, cc, ty0, tx0);
  }
  __syncthreads();
  const int lr = tid / kTile, lc = tid % kTile;
  const int cr = c0r + lr, cc = c0c + lc;
  if (cr >= p.Hc || cc >= p.Wc) return;
  const int id = cr * p.Wc + cc;
  const CellStat& me = s_cell[(lr + 1) * kHalo + lc + 1];
  L.cell[3 * id] = me.wsum;
  L.cell[3 * id + 1] = me.cx;
  L.cell[3 * id + 2] = me.cy;
  L.atom[id] = me.atom;
  const int off[8][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1},
                         {0, 1},   {1, -1}, {1, 0},  {1, 1}};
  uint8_t links = 0;
  for (int o = 0; o < 8; ++o) {
    const int nr = cr + off[o][0], nc = cc + off[o][1];
    if (nr < 0 || nr >= p.Hc || nc < 0 || nc >= p.Wc) continue;
    const CellStat& nb = s_cell[(lr + 1 + off[o][0]) * kHalo + lc + 1
                                + off[o][1]];
    if (!me.atom || !nb.atom) continue;
    const float dth = mod_pi(fabsf(me.theta - nb.theta));
    if (!(fminf(dth, PLVIO_PI_F - dth) < p.angle_tol)) continue;
    const float ddx = nb.cx - me.cx, ddy = nb.cy - me.cy;
    const float perp_ij = fabsf(-me.dy * ddx + me.dx * ddy);
    const float perp_ji = fabsf(-nb.dy * ddx + nb.dx * ddy);
    if (perp_ij < p.dist_tol && perp_ji < p.dist_tol) links |= 1u << o;
  }
  L.links[id] = links;
}

// a float as an int of the same order (the negative floats' magnitude
// bits flipped), so that the endpoints' min / max are single integer
// atomics, exact and in any order; and back
__device__ __forceinline__ int ord_key(float v) {
  const int i = __float_as_int(v);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float ord_float(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// principal direction of a 2x2 scatter, (1, 0) if degenerate
__device__ __forceinline__ void eig_dir(float sxx, float sxy, float syy,
                                        float* vx, float* vy) {
  const float tr = sxx + syy;
  const float disc = sqrtf(fmaxf(tr * tr / 4.f - (sxx * syy - sxy * sxy),
                                 0.f));
  const float lam1 = tr / 2.f + disc;
  const float x = sxy, y = lam1 - sxx;
  const float n = sqrtf(x * x + y * y);
  *vx = n > 1e-6f ? x / n : 1.f;
  *vy = n > 1e-6f ? y / n : 0.f;
}

// component sums in fixed point: first moments in units of 2^-24, central
// second moments in units of 2^-16 (for a whole 752x480 grid of maximal
// gradients |s_x| < 2^37 and s_xx < 2^47, so both stay below 2^63)
constexpr double kFx1 = 16777216.0;
constexpr double kFx2 = 65536.0;

// v added to the 64-bit integer at a, exactly, by two 32-bit atomics (a
// 64-bit add on shared memory is a compare-and-swap loop): the low word's
// carries go to the high word, as many as the low words' sum has, in any
// order
__device__ __forceinline__ void add64(unsigned long long* a,
                                      unsigned long long v) {
  unsigned* w = reinterpret_cast<unsigned*>(a);
  const unsigned lo = static_cast<unsigned>(v);
  const unsigned hi = static_cast<unsigned>(v >> 32);
  const unsigned old = atomicAdd(w, lo);
  const unsigned up = hi + (old + lo < old ? 1u : 0u);
  if (up) atomicAdd(w + 1, up);
}

__device__ __forceinline__ void fx_add(unsigned long long* a, float v,
                                       double scale) {
  add64(a, static_cast<unsigned long long>(
               __double2ll_rn(double(v) * scale)));
}

__device__ __forceinline__ float fx_get(unsigned long long a, double scale) {
  return float(double(static_cast<long long>(a)) / scale);
}

// a label's fit from its row of sums (all zero for a label without
// cells): centroid and principal direction into c[0..3]
__device__ __forceinline__ void fit_row(const unsigned long long* a,
                                        float* c) {
  float vx, vy;
  eig_dir(fx_get(a[4], kFx2), fx_get(a[5], kFx2), fx_get(a[6], kFx2), &vx,
          &vy);
  const float sw = fmaxf(fx_get(a[0], kFx1), 1e-6f);
  c[0] = fx_get(a[1], kFx1) / sw;
  c[1] = fx_get(a[2], kFx1) / sw;
  c[2] = vx;
  c[3] = vy;
}

// one row's sums in shared memory: s as a label's row of sums (w, x, y,
// cells, xx, xy, yy, unused), then its fit and the endpoints' keys
struct RowAcc {
  unsigned long long s[8];
  float mx, my, vx, vy;
  int kmin, kmax;
};

// output row k from a label's fit c (mx, my, vx, vy, pmin, pmax) and its
// score s
__device__ __forceinline__ void write_row(const Level& L, int k,
                                          const float* c, float s) {
  const float x1 = c[0] + c[4] * c[2], y1 = c[1] + c[4] * c[3];
  const float x2 = c[0] + c[5] * c[2], y2 = c[1] + c[5] * c[3];
  L.ep[4 * k] = x1;
  L.ep[4 * k + 1] = y1;
  L.ep[4 * k + 2] = x2;
  L.ep[4 * k + 3] = y2;
  L.ang[k] = mod_pi(atan2f(y2 - y1, x2 - x1));
  L.length[k] = s;
  L.valid[k] = s > 0.f;
}

// output row k for cell i (row r of its label's sums, or -1: a label
// without cells) with score s
__device__ __forceinline__ void write_cell(const Level& L, int k, int r,
                                           float s) {
  if (r >= 0) {
    write_row(L, k, L.comp + 6 * r, s);
  } else {
    const unsigned long long zero[8] = {0ull, 0ull, 0ull, 0ull,
                                        0ull, 0ull, 0ull, 0ull};
    float c[6];
    fit_row(zero, c);
    c[4] = kBig;
    c[5] = -kBig;
    write_row(L, k, c, s);
  }
}

// the exclusive prefix of v over the block in thread order, and the
// total; s_warp: a shared int a warp
__device__ int block_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  *total = s_warp[kCompThreads / 32 - 1];
  const int ex = (warp ? s_warp[warp - 1] : 0) + incl - v;
  __syncthreads();
  return ex;
}

// one block a level: components, sums, scores and the top-K
__global__ void __launch_bounds__(kCompThreads) components_kernel(Frame f) {
  extern __shared__ int s_lab[];          // two buffers of C labels, links
  __shared__ int s_warp[kCompThreads / 32];
  __shared__ int s_good, s_keys;
  const int lvl = blockIdx.x;
  const Level& L = f.lv[lvl];
  const int Wc = L.W / kCell, C = (L.H / kCell) * Wc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* lab = s_lab;
  int* nxt = s_lab + C;
  uint8_t* lks = f.links_smem ? reinterpret_cast<uint8_t*>(s_lab + 2 * C)
                              : nullptr;
  const uint8_t* lk = lks ? lks : L.links;
  const bool timer = f.prof != nullptr && tid == 0;
  unsigned long long t0 = timer ? globaltimer() : 0ull, tb = t0;
  unsigned long long st[kStages] = {};
  auto stamp = [&](int k) {
    if (timer) {
      const unsigned long long t = globaltimer();
      st[k] += t - tb;
      tb = t;
    }
  };
  for (int i = tid; i < C; i += kCompThreads) {
    lab[i] = L.atom[i] ? i : C;
    if (lks) lks[i] = L.links[i];
  }
  if (tid == 0) s_good = s_keys = 0;
  __syncthreads();
  // the atoms (label below C), listed in index order at the top of shared
  // memory where they fit: the sweeps and the sums visit them alone (a
  // non-atom keeps its label C, and no atom's label or link leads to
  // one); otherwise every cell
  const int chunk = (C + kCompThreads - 1) / kCompThreads;
  const int b0 = min(tid * chunk, C), b1 = min(b0 + chunk, C);
  int cnt = 0;
  for (int i = b0; i < b1; ++i) cnt += lab[i] < C;
  int n_atoms;
  int pos = block_scan(cnt, s_warp, &n_atoms);
  const bool listed = 4 * n_atoms <= f.smem - (lks ? 9 : 8) * C;
  int* atoms = reinterpret_cast<int*>(reinterpret_cast<uint8_t*>(s_lab)
                                      + f.smem) - n_atoms;
  if (listed)
    for (int i = b0; i < b1; ++i)
      if (lab[i] < C) atoms[pos++] = i;
  const int n_vis = listed ? n_atoms : C;
  __syncthreads();
  stamp(0);
  // a link's neighbour is always inside the grid: its offset in the cells
  const int nb[8] = {-Wc - 1, -Wc, -Wc + 1, -1, 1, Wc - 1, Wc, Wc + 1};
  for (int it = 0; it < f.jump_iters; ++it) {
#pragma unroll 4
    for (int k = tid; k < n_vis; k += kCompThreads) {
      const int i = listed ? atoms[k] : k;
      int best = lab[i];
      const int lk_i = lk[i];
      if (lk_i) {
        for (int o = 0; o < 8; ++o)
          if (lk_i & (1 << o)) best = min(best, lab[i + nb[o]]);
      }
      nxt[i] = min(best, best < C ? lab[best] : C);
    }
    __syncthreads();
#pragma unroll 4
    for (int k = tid; k < n_vis; k += kCompThreads) {
      const int i = listed ? atoms[k] : k;
      const int b = nxt[i];
      lab[i] = min(b, b < C ? nxt[b] : C);
    }
    __syncthreads();
  }
  stamp(1);
  // ---- a row for each label in use (an atom's label), numbered in index
  // order by a block-wide scan
  for (int i = tid; i < C; i += kCompThreads) nxt[i] = 0;
  __syncthreads();
  for (int k = tid; k < n_vis; k += kCompThreads) {
    const int i = listed ? atoms[k] : k;
    if (lab[i] < C) nxt[lab[i]] = 1;
  }
  __syncthreads();
  cnt = 0;
  for (int i = b0; i < b1; ++i) cnt += nxt[i];
  int rows;
  int row = block_scan(cnt, s_warp, &rows);
  for (int i = b0; i < b1; ++i) {
    if (nxt[i]) {
      L.label[row] = lab[i] == i ? i : -i - 1;
      nxt[i] = row++;
    } else {
      nxt[i] = -1;
    }
  }
  __syncthreads();
  for (int i = tid; i < C; i += kCompThreads) {      // each cell's row
    const int l = lab[i];
    lab[i] = l < C ? nxt[l] : -1;
    L.rowmap[i] = nxt[i];
  }
  __syncthreads();
  stamp(2);
  // ---- sums in 64-bit fixed point: integer atomics add in any order to
  // the same sum, so the components, and with them the top-K order, are
  // the same on every run.  The rows' sums live in shared memory over the
  // second label buffer and the links, as many rows at a time as fit
  const int acc_off = (4 * C + 15) & ~15;
  RowAcc* acc = reinterpret_cast<RowAcc*>(reinterpret_cast<uint8_t*>(s_lab)
                                          + acc_off);
  const int cap = (f.smem - (listed ? 4 * n_atoms : 0) - acc_off)
                  / int(sizeof(RowAcc));
  for (int r0 = 0; r0 < rows; r0 += cap) {
    const int r1 = min(rows, r0 + cap);
    for (int r = r0 + tid; r < r1; r += kCompThreads) {
      RowAcc& a = acc[r - r0];
      for (int k = 0; k < 8; ++k) a.s[k] = 0ull;
      a.kmin = ord_key(kBig);
      a.kmax = ord_key(-kBig);
    }
    __syncthreads();
#pragma unroll 4
    for (int k = tid; k < n_vis; k += kCompThreads) {
      const int i = listed ? atoms[k] : k;
      const int r = lab[i];
      const float wgt = r >= r0 && r < r1 ? L.cell[3 * i] : 0.f;
      if (wgt > 0.f) {
        unsigned long long* a = acc[r - r0].s;
        fx_add(a, wgt, kFx1);
        fx_add(a + 1, wgt * L.cell[3 * i + 1], kFx1);
        fx_add(a + 2, wgt * L.cell[3 * i + 2], kFx1);
        add64(a + 3, 1ull);
      }
    }
    __syncthreads();
    // each row's centroid, then the central second moments
    for (int r = r0 + tid; r < r1; r += kCompThreads) {
      RowAcc& a = acc[r - r0];
      const float sw = fmaxf(fx_get(a.s[0], kFx1), 1e-6f);
      a.mx = fx_get(a.s[1], kFx1) / sw;
      a.my = fx_get(a.s[2], kFx1) / sw;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = tid; k < n_vis; k += kCompThreads) {
      const int i = listed ? atoms[k] : k;
      const int r = lab[i];
      const float wgt = r >= r0 && r < r1 ? L.cell[3 * i] : 0.f;
      if (wgt > 0.f) {
        RowAcc& a = acc[r - r0];
        const float ex = L.cell[3 * i + 1] - a.mx;
        const float ey = L.cell[3 * i + 2] - a.my;
        fx_add(a.s + 4, wgt * ex * ex, kFx2);
        fx_add(a.s + 5, wgt * ex * ey, kFx2);
        fx_add(a.s + 6, wgt * ey * ey, kFx2);
      }
    }
    __syncthreads();
    // each row's fit, then the endpoints
    for (int r = r0 + tid; r < r1; r += kCompThreads) {
      RowAcc& a = acc[r - r0];
      float c[4];
      fit_row(a.s, c);
      a.mx = c[0];
      a.my = c[1];
      a.vx = c[2];
      a.vy = c[3];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = tid; k < n_vis; k += kCompThreads) {
      const int i = listed ? atoms[k] : k;
      const int r = lab[i];
      const float wgt = r >= r0 && r < r1 ? L.cell[3 * i] : 0.f;
      if (wgt > 0.f) {
        RowAcc& a = acc[r - r0];
        const float proj = (L.cell[3 * i + 1] - a.mx) * a.vx
                           + (L.cell[3 * i + 2] - a.my) * a.vy;
        if (proj == proj) {
          atomicMin(&a.kmin, ord_key(proj));
          atomicMax(&a.kmax, ord_key(proj));
        }
      }
    }
    __syncthreads();
    // each row's fit to the workspace, and its score: a root (its own
    // label) with enough cells and length
    for (int r = r0 + tid; r < r1; r += kCompThreads) {
      const RowAcc& a = acc[r - r0];
      const float pmin = ord_float(a.kmin), pmax = ord_float(a.kmax);
      float* c = L.comp + 6 * r;
      c[0] = a.mx;
      c[1] = a.my;
      c[2] = a.vx;
      c[3] = a.vy;
      c[4] = pmin;
      c[5] = pmax;
      const float length = pmax - pmin;
      const bool good = L.label[r] >= 0
                        && a.s[3] >= (unsigned long long)f.min_cells
                        && length >= f.min_length;
      L.score[r] = good ? length : 0.f;
      if (good) atomicAdd(&s_good, 1);
    }
    __syncthreads();
  }
  stamp(3);
  const int n = min(L.n, C);
  const int n_good = s_good;
  const int n_top = min(n, n_good);
  // ---- the tail: the lowest-index cells with score 0, in order
  if (warp == 0 && n_top < n) {
    int found = 0;
    for (int base = 0; base < C && found < n - n_top; base += 32) {
      const int i = base + lane;
      int r = -1;
      bool zero = false;
      if (i < C) {
        r = L.rowmap[i];
        zero = !(r >= 0 && L.label[r] >= 0 && L.score[r] > 0.f);
      }
      const unsigned m = __ballot_sync(0xffffffffu, zero);
      const int pos = found + __popc(m & ((1u << lane) - 1u));
      if (zero && pos < n - n_top) write_cell(L, n_top + pos, r, 0.f);
      found += __popc(m);
    }
  }
  __syncthreads();
  stamp(4);
  // ---- the good roots' keys (score bits, then the complement of the
  // row: descending keys give descending scores, ascending rows, i.e.
  // ascending cell index) over the shared memory, bitonic-sorted
  // descending; every exchange puts the larger key at the lower index, so
  // the virtual padding (smallest keys) beyond n_good never moves
  unsigned long long* key = reinterpret_cast<unsigned long long*>(s_lab);
  for (int r = tid; r < rows; r += kCompThreads) {
    const float sc = L.score[r];
    if (sc > 0.f)
      key[atomicAdd(&s_keys, 1)] =
          (static_cast<unsigned long long>(__float_as_uint(sc)) << 32)
          | (0xffffffffu - static_cast<unsigned>(r));
  }
  __syncthreads();
  int P = 1;
  while (P < n_good) P <<= 1;
  for (int k = 2; k <= P; k <<= 1) {
    for (int d = k >> 1; d >= 1; d >>= 1) {
      for (int t = tid; t < P / 2; t += kCompThreads) {
        const int blk = t / d, off = t % d;
        // the first stage of a merge pairs i with its mirror in the block
        // of k, the later ones with i + d
        const int i = d == (k >> 1) ? blk * k + off : blk * 2 * d + off;
        const int j = d == (k >> 1) ? blk * k + k - 1 - off : i + d;
        if (j < n_good) {
          const unsigned long long a = key[i], b = key[j];
          if (b > a) {
            key[i] = b;
            key[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  stamp(5);
  for (int k = tid; k < n_top; k += kCompThreads) {
    const unsigned long long kk = key[k];
    const int r = static_cast<int>(0xffffffffu - static_cast<unsigned>(kk));
    write_row(L, k, L.comp + 6 * r, __uint_as_float(
                                         static_cast<unsigned>(kk >> 32)));
  }
  stamp(6);
  if (timer) {
    if (lvl == 0) {
      for (int k = 0; k < kStages; ++k) f.prof[k] = st[k];
      f.prof[kStages + 1] = rows;
      f.prof[kStages + 2] = n_good;
    } else {
      f.prof[kStages] = globaltimer() - t0;
    }
  }
}

}  // namespace

// both kernels for nlev (1 or 2) levels in `levels` (host memory); the
// shared-memory attribute is set once per device
PLVIO_API int line_detect(const void* levels, int nlev, float grad_th,
                          int min_cells, float aniso_th, float angle_tol,
                          float dist_tol, float min_length, int jump_iters,
                          void* prof, void* stream) {
  if (nlev < 1 || nlev > kMaxLevels) return static_cast<int>(
      cudaErrorInvalidValue);
  Frame f{};
  const Level* lv = static_cast<const Level*>(levels);
  int cmax = 0, tiles = 0;
  for (int l = 0; l < nlev; ++l) {
    f.lv[l] = lv[l];
    const int C = (lv[l].H / kCell) * (lv[l].W / kCell);
    cmax = C > cmax ? C : cmax;
    // tiles cover every cell and every pixel (also pixels past the last
    // whole cell, whose gradients the refit and the descriptor read)
    f.tiles_x[l] = (lv[l].W + kTile * kCell - 1) / (kTile * kCell);
    const int ty = (lv[l].H + kTile * kCell - 1) / (kTile * kCell);
    if (l == 0) f.tiles0 = f.tiles_x[l] * ty;
    tiles += f.tiles_x[l] * ty;
  }
  f.nlev = nlev;
  // every level's block gets the most dynamic shared memory a block may
  // use beside its 136 B of static: the label buffers, the links where
  // they fit, and the rows' sums over them after the sweeps
  f.smem = kSmemMax - 1024;
  if (8 * cmax > f.smem) return static_cast<int>(cudaErrorInvalidValue);
  f.links_smem = 9 * cmax <= f.smem;
  f.grad_th = grad_th;
  f.aniso_th = aniso_th;
  f.angle_tol = angle_tol;
  f.dist_tol = dist_tol;
  f.min_length = min_length;
  f.min_cells = min_cells;
  f.jump_iters = jump_iters;
  f.prof = static_cast<unsigned long long*>(prof);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cells_kernel<<<tiles, kTile * kTile, 0, st>>>(f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  static bool set_on[64] = {};
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !set_on[dev]) {
    e = cudaFuncSetAttribute(components_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             f.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) set_on[dev] = true;
  }
  components_kernel<<<nlev, kCompThreads, f.smem, st>>>(f);
  return static_cast<int>(cudaGetLastError());
}
