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
// Design: three kernels.
//  1. cells: one thread per 4x4 cell in 16x16-cell tiles; the tile's image
//     plus a one-cell and one-pixel halo (74x74 px) sits in shared memory,
//     rounded to bf16 as the reference's bf16 convolution input.  Each
//     thread computes its 16 pixels' Scharr gradients (one float32 sum of
//     exact products, rounded once to bf16), the magnitude in bf16
//     arithmetic (every product, sum and sqrt rounded to bf16 with
//     __float2bfloat16_rn, as torch's bf16 ops round each step), the edge
//     weights, the cell moments in float32 and the structure tensor, then
//     the atom test; halo cells are recomputed so that each thread can
//     write the 8-bit link mask of its cell.  bf16 gx, gy go to device
//     memory for the refit and the descriptor.
//  2. components: one block of 1024 threads holds two label buffers of the
//     whole cell grid in shared memory (2 x 4 x 22,560 B at level 0) and
//     runs the jump_iters synchronous sweeps with __syncthreads in place of
//     the rolls: the neighbour minimum and the first hop read the previous
//     sweep's labels, the second hop the first hop's (double-buffered, as
//     the reference's pointer jumping is synchronous).  The same block then
//     aggregates components in three barrier-separated passes (first
//     moments, central second moments, endpoint min/max) and scores the
//     roots.  The sums are 64-bit fixed-point integer atomics: float
//     atomics add in a different order on every run, and a last-bit change
//     of two nearly equal segment lengths (the two edges of a bar) reorders
//     the top-K, which changes what the order-dependent collinear merge
//     joins; integer sums are the same on every run.
//  3. gather: after a stable descending torch.sort of the scores (top-K,
//     lower index first on ties, as lax.top_k), one thread per output line
//     reads its root's fit and writes the endpoints, angle, length, valid.
// Sums are taken in another order (cell moments sequentially) or exactly
// (components) where the plain version rounds each float addition, so
// segments near a threshold or a near-tie of lengths may differ; the two
// are compared as segment sets.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kTile = 16;                   // cells per tile side
constexpr int kCell = 4;                    // pixels per cell side
constexpr int kHalo = kTile + 2;            // cells with the halo ring
constexpr int kImg = kHalo * kCell + 2;     // 74 px
constexpr int kCompThreads = 1024;
constexpr float kBig = 1e9f;

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float mod_pi(float a) {   // torch.remainder(a, pi)
  float m = fmodf(a, PLVIO_PI_F);
  if (m != 0.f && m < 0.f) m += PLVIO_PI_F;
  return m;
}

struct DetectParams {
  int H, W, Hc, Wc;
  float grad_th, aniso_th, angle_tol, dist_tol, min_length;
  int min_cells, jump_iters;
};

struct CellStat {
  float wsum, cx, cy, dx, dy, theta;
  int atom;
};

// gradients of pixel (ly, lx) of the shared tile (tile coordinates of the
// pixel itself; its 3x3 neighbourhood is in the tile)
__device__ __forceinline__ void scharr(const float (*img)[kImg], int ly,
                                       int lx, float* gx, float* gy) {
  const float a = img[ly - 1][lx - 1], b = img[ly - 1][lx],
              c = img[ly - 1][lx + 1];
  const float d = img[ly][lx - 1], f = img[ly][lx + 1];
  const float g = img[ly + 1][lx - 1], h = img[ly + 1][lx],
              i = img[ly + 1][lx + 1];
  const float k3 = 3.f / 32.f, k10 = 10.f / 32.f;
  // row-major taps of kx = [[-3,0,3],[-10,0,10],[-3,0,3]]/32 and ky = kx^T
  *gx = bf(-k3 * a + k3 * c + -k10 * d + k10 * f + -k3 * g + k3 * i);
  *gy = bf(-k3 * a + -k10 * b + -k3 * c + k3 * g + k10 * h + k3 * i);
}

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
    float mag = bf(sqrtf(bf(bf(gx * gx) + bf(gy * gy))));
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

__global__ void __launch_bounds__(kTile * kTile) cells_kernel(
    DetectParams p, const float* __restrict__ img,
    __nv_bfloat16* __restrict__ gx_out, __nv_bfloat16* __restrict__ gy_out,
    float* __restrict__ cell_out, uint8_t* __restrict__ atom_out,
    uint8_t* __restrict__ link_out) {
  __shared__ float s_img[kImg][kImg];
  __shared__ CellStat s_cell[kHalo * kHalo];
  const int tid = threadIdx.x;
  const int c0r = blockIdx.y * kTile, c0c = blockIdx.x * kTile;
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
    gx_out[y * p.W + x] = __float2bfloat16_rn(gx);
    gy_out[y * p.W + x] = __float2bfloat16_rn(gy);
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
  cell_out[3 * id] = me.wsum;
  cell_out[3 * id + 1] = me.cx;
  cell_out[3 * id + 2] = me.cy;
  atom_out[id] = me.atom;
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
  link_out[id] = links;
}

__device__ void atomic_min_f(float* a, float v) {
  int* ai = reinterpret_cast<int*>(a);
  int old = *ai;
  while (v < __int_as_float(old)) {
    const int assumed = old;
    old = atomicCAS(ai, assumed, __float_as_int(v));
    if (old == assumed) break;
  }
}

__device__ void atomic_max_f(float* a, float v) {
  int* ai = reinterpret_cast<int*>(a);
  int old = *ai;
  while (v > __int_as_float(old)) {
    const int assumed = old;
    old = atomicCAS(ai, assumed, __float_as_int(v));
    if (old == assumed) break;
  }
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

__device__ __forceinline__ void fx_add(unsigned long long* a, float v,
                                       double scale) {
  atomicAdd(a, static_cast<unsigned long long>(
                   __double2ll_rn(double(v) * scale)));
}

__device__ __forceinline__ float fx_get(unsigned long long a, double scale) {
  return float(double(static_cast<long long>(a)) / scale);
}

// agg: [C+1][8] = s_w, s_x, s_y, s_n (count), s_xx, s_xy, s_yy, (unused)
// comp: [C+1][6] = mx, my, vx, vy, pmin, pmax
__global__ void __launch_bounds__(kCompThreads) components_kernel(
    DetectParams p, const float* __restrict__ cell,
    const uint8_t* __restrict__ atom, const uint8_t* __restrict__ links,
    unsigned long long* __restrict__ agg, float* __restrict__ comp,
    float* __restrict__ score) {
  extern __shared__ int s_lab[];          // two buffers of C labels
  const int C = p.Hc * p.Wc;
  int* lab = s_lab;
  int* nxt = s_lab + C;
  const int tid = threadIdx.x;
  for (int i = tid; i < C; i += kCompThreads) lab[i] = atom[i] ? i : C;
  for (int i = tid; i < (C + 1) * 8; i += kCompThreads) agg[i] = 0ull;
  for (int i = tid; i <= C; i += kCompThreads) {
    comp[6 * i + 4] = kBig;
    comp[6 * i + 5] = -kBig;
  }
  __syncthreads();
  const int dr[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
  const int dc[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
  for (int it = 0; it < p.jump_iters; ++it) {
    for (int i = tid; i < C; i += kCompThreads) {
      int best = lab[i];
      const int lk = links[i];
      if (lk) {
        const int r = i / p.Wc, c = i % p.Wc;
        for (int o = 0; o < 8; ++o)
          if (lk & (1 << o))
            best = min(best, lab[(r + dr[o]) * p.Wc + c + dc[o]]);
      }
      nxt[i] = min(best, best < C ? lab[best] : C);
    }
    __syncthreads();
    for (int i = tid; i < C; i += kCompThreads) {
      const int b = nxt[i];
      lab[i] = min(b, b < C ? nxt[b] : C);
    }
    __syncthreads();
  }
  // ---- aggregation in 64-bit fixed point: integer atomics add in any
  // order to the same sum, so the components, and with them the top-K
  // order, are the same on every run
  for (int i = tid; i < C; i += kCompThreads) {
    const int l = lab[i];
    const float wgt = (atom[i] && l < C) ? cell[3 * i] : 0.f;
    if (wgt > 0.f) {
      fx_add(agg + 8 * l, wgt, kFx1);
      fx_add(agg + 8 * l + 1, wgt * cell[3 * i + 1], kFx1);
      fx_add(agg + 8 * l + 2, wgt * cell[3 * i + 2], kFx1);
      atomicAdd(agg + 8 * l + 3, 1ull);
    }
  }
  __syncthreads();
  // ---- central second moments
  for (int i = tid; i < C; i += kCompThreads) {
    const int l = lab[i];
    const float wgt = (atom[i] && l < C) ? cell[3 * i] : 0.f;
    if (wgt > 0.f) {
      const float sw = fmaxf(fx_get(agg[8 * l], kFx1), 1e-6f);
      const float mx = fx_get(agg[8 * l + 1], kFx1) / sw;
      const float my = fx_get(agg[8 * l + 2], kFx1) / sw;
      const float ex = cell[3 * i + 1] - mx, ey = cell[3 * i + 2] - my;
      fx_add(agg + 8 * l + 4, wgt * ex * ex, kFx2);
      fx_add(agg + 8 * l + 5, wgt * ex * ey, kFx2);
      fx_add(agg + 8 * l + 6, wgt * ey * ey, kFx2);
    }
  }
  __syncthreads();
  // ---- per-label fit (all labels), then the endpoints
  for (int l = tid; l <= C; l += kCompThreads) {
    const unsigned long long* a = agg + 8 * l;
    float vx, vy;
    eig_dir(fx_get(a[4], kFx2), fx_get(a[5], kFx2), fx_get(a[6], kFx2), &vx,
            &vy);
    const float sw = fmaxf(fx_get(a[0], kFx1), 1e-6f);
    comp[6 * l] = fx_get(a[1], kFx1) / sw;
    comp[6 * l + 1] = fx_get(a[2], kFx1) / sw;
    comp[6 * l + 2] = vx;
    comp[6 * l + 3] = vy;
  }
  __syncthreads();
  for (int i = tid; i < C; i += kCompThreads) {
    const int l = lab[i];
    const float wgt = (atom[i] && l < C) ? cell[3 * i] : 0.f;
    if (wgt > 0.f) {
      const float* c = comp + 6 * l;
      const float proj = (cell[3 * i + 1] - c[0]) * c[2]
                         + (cell[3 * i + 2] - c[1]) * c[3];
      atomic_min_f(comp + 6 * l + 4, proj);
      atomic_max_f(comp + 6 * l + 5, proj);
    }
  }
  __syncthreads();
  for (int i = tid; i < C; i += kCompThreads) {
    const bool root = lab[i] == i && atom[i];
    const float length = comp[6 * i + 5] - comp[6 * i + 4];
    const bool good = root && agg[8 * i + 3] >= (unsigned long long)
                                                p.min_cells
                      && length >= p.min_length;
    score[i] = good ? length : 0.f;
  }
}

__global__ void gather_kernel(const int64_t* __restrict__ order, int n,
                              const float* __restrict__ comp,
                              const float* __restrict__ score,
                              float* __restrict__ ep, float* __restrict__ ang,
                              float* __restrict__ length,
                              uint8_t* __restrict__ valid) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int64_t r = order[k];
  const float* c = comp + 6 * r;
  const float s = score[r];
  const float x1 = c[0] + c[4] * c[2], y1 = c[1] + c[4] * c[3];
  const float x2 = c[0] + c[5] * c[2], y2 = c[1] + c[5] * c[3];
  ep[4 * k] = x1;
  ep[4 * k + 1] = y1;
  ep[4 * k + 2] = x2;
  ep[4 * k + 3] = y2;
  ang[k] = mod_pi(atan2f(y2 - y1, x2 - x1));
  length[k] = s;
  valid[k] = s > 0.f;
}

}  // namespace

// Launches 1 and 2: gradients, cells, links, components and scores.
PLVIO_API int line_detect(const void* img, int H, int W, float grad_th,
                          int min_cells, float aniso_th, float angle_tol,
                          float dist_tol, float min_length, int jump_iters,
                          void* gx, void* gy, void* cell, void* atom,
                          void* links, void* agg, void* comp, void* score,
                          void* stream) {
  DetectParams p{H, W, H / kCell, W / kCell, grad_th, aniso_th, angle_tol,
                 dist_tol, min_length, min_cells, jump_iters};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // tiles cover every cell and every pixel (also pixels past the last
  // whole cell, whose gradients the refit and the descriptor read)
  const int gxn = (W + kTile * kCell - 1) / (kTile * kCell);
  const int gyn = (H + kTile * kCell - 1) / (kTile * kCell);
  cells_kernel<<<dim3(gxn, gyn), kTile * kTile, 0, st>>>(
      p, static_cast<const float*>(img), static_cast<__nv_bfloat16*>(gx),
      static_cast<__nv_bfloat16*>(gy), static_cast<float*>(cell),
      static_cast<uint8_t*>(atom), static_cast<uint8_t*>(links));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = 2 * p.Hc * p.Wc * int(sizeof(int));
  e = cudaFuncSetAttribute(components_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  components_kernel<<<1, kCompThreads, smem, st>>>(
      p, static_cast<const float*>(cell), static_cast<const uint8_t*>(atom),
      static_cast<const uint8_t*>(links),
      static_cast<unsigned long long*>(agg),
      static_cast<float*>(comp), static_cast<float*>(score));
  return static_cast<int>(cudaGetLastError());
}

// Launch 3: the top-K segments in `order` (a stable descending sort of the
// scores) -> endpoints, angle, length, valid.
PLVIO_API int line_detect_gather(const void* order, int n, const void* comp,
                                 const void* score, void* ep, void* ang,
                                 void* length, void* valid, void* stream) {
  if (n == 0) return 0;
  gather_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(order), n, static_cast<const float*>(comp),
      static_cast<const float*>(score), static_cast<float*>(ep),
      static_cast<float*>(ang), static_cast<float*>(length),
      static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}
