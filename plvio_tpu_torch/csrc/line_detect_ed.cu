// line_detect_ed — the EDLines-analog line detector of one pyramid level:
// bf16 Scharr gradients and magnitude, anchors at magnitude maxima across
// the edge normal, one per 8x8 cell, the top anchors by score, walks along
// the edges from each, a weighted total-least-squares fit with an RMS
// gate, overlap suppression and the top segments by length.
//
// Replaces plvio_tpu/ops/lines.py `detect_lines_ed` (:276) with
// `_bilinear` (:259), after `_gradients` (:47).  The JAX version is a
// vmapped lax.scan over the walk steps, rolls for the neighbours and two
// lax.top_k; its eager torch counterpart issues ~2000 small launches a
// level.
//
// What bounds it on the H100: latency.  A level reads 1.4 MB of image and
// writes 2.2 MB of bf16 fields; the walks are 48 dependent steps of five
// bilinear samples (20 gathers) in each of 1024 threads.
//
// Design: two kernels a level.
//  1. field: one block per 32x32-pixel tile (4x4 cells); the tile's image
//     with a two-pixel halo sits in shared memory rounded to bf16, each
//     thread computes the gradients (lines.cuh `scharr`) and the bf16
//     magnitude of its pixels and of the one-pixel halo, zeroes the 4-px
//     border, writes gx, gy and the magnitude, takes the maximum across
//     the normal (`>` on the left / upper side, `>=` on the other, the
//     neighbours zero outside the image; `horiz` from the bf16 values) and
//     the anchor score; then one thread per cell takes the cell's first
//     maximum in row-major order.
//  2. walks: one block of 1024 threads.  The cells' (score, index) keys
//     are sorted descending in shared memory (a bitonic sort: the higher
//     score first, the lower cell on ties, as lax.top_k); the first A are
//     the anchors.  Thread a < A walks anchor a forward, thread A + a
//     backward: each step probes straight and +-~25 deg, takes the best
//     magnitude (the first on ties), realigns to the local edge direction
//     and stops for good on a weak gradient or a sharp turn; the points go
//     to a global scratch [A, 97] (backward walk reversed, the anchor,
//     the forward walk).  Thread a then fits its anchor's points with sums
//     over the points in order, the overlap test runs over every pair
//     from shared memory, and the final scores are sorted as the cells'
//     were; the first max_lines give the outputs.
// Every operation is the plain version's in its order (the plain fit sums
// its columns in order too), with no contraction (--fmad=false), so the
// kernel gives the plain version's bits on the card.
#include "lines.cuh"

namespace {

constexpr int kTilePx = 32;                 // pixels per tile side
constexpr int kEdCell = 8;                  // pixels per cell side
constexpr int kTileCells = kTilePx / kEdCell;
constexpr int kImgT = kTilePx + 4;          // image with a 2-px halo
constexpr int kMagT = kTilePx + 2;          // magnitude with a 1-px halo
constexpr int kFieldThreads = 256;
constexpr int kWalkThreads = 1024;
constexpr int kMaxAnchors = 512;
constexpr int kPts = 97;                    // 2 x 48 steps + the anchor
constexpr float kBig = 1e9f;

struct EdParams {
  int H, W, Hc, Wc, n_anchors, walk_steps, max_lines, n_pad_cells, n_pad_a;
  float grad_th, anchor_th_bf, cos_th, fit_tol, min_length;
};

__global__ void __launch_bounds__(kFieldThreads) ed_field_kernel(
    EdParams p, const float* __restrict__ img,
    __nv_bfloat16* __restrict__ gx_out, __nv_bfloat16* __restrict__ gy_out,
    __nv_bfloat16* __restrict__ mag_out, float* __restrict__ cell_score,
    int* __restrict__ cell_best) {
  __shared__ float s_img[kImgT][kImgT];
  __shared__ float s_mag[kMagT][kMagT];
  __shared__ float s_gx[kTilePx][kTilePx];
  __shared__ float s_gy[kTilePx][kTilePx];
  __shared__ float s_score[kTilePx][kTilePx];
  const int tid = threadIdx.x;
  const int py0 = blockIdx.y * kTilePx, px0 = blockIdx.x * kTilePx;
  // tile position (0, 0) of s_img is global pixel (py0 - 2, px0 - 2)
  for (int i = tid; i < kImgT * kImgT; i += blockDim.x) {
    const int y = py0 - 2 + i / kImgT, x = px0 - 2 + i % kImgT;
    s_img[i / kImgT][i % kImgT] =
        (y >= 0 && y < p.H && x >= 0 && x < p.W) ? bf(img[y * p.W + x])
                                                 : 0.f;
  }
  __syncthreads();
  // magnitude of the tile and its 1-px halo; s_mag (0, 0) is global pixel
  // (py0 - 1, px0 - 1), zero outside the image and on the 4-px border
  for (int i = tid; i < kMagT * kMagT; i += blockDim.x) {
    const int ly = i / kMagT, lx = i % kMagT;
    const int y = py0 - 1 + ly, x = px0 - 1 + lx;
    float m = 0.f;
    if (y >= 0 && y < p.H && x >= 0 && x < p.W) {
      float gx, gy;
      scharr(s_img, ly + 1, lx + 1, &gx, &gy);
      m = bf_mag(gx, gy);
      const bool own = ly >= 1 && ly <= kTilePx && lx >= 1 && lx <= kTilePx;
      if (own) {
        s_gx[ly - 1][lx - 1] = gx;
        s_gy[ly - 1][lx - 1] = gy;
        gx_out[y * p.W + x] = __float2bfloat16_rn(gx);
        gy_out[y * p.W + x] = __float2bfloat16_rn(gy);
      }
      if (!(y >= 4 && y < p.H - 4 && x >= 4 && x < p.W - 4)) m = 0.f;
      if (own) mag_out[y * p.W + x] = __float2bfloat16_rn(m);
    }
    s_mag[ly][lx] = m;
  }
  __syncthreads();
  // anchor score: the magnitude where it is a maximum across the normal
  for (int i = tid; i < kTilePx * kTilePx; i += blockDim.x) {
    const int ly = i / kTilePx, lx = i % kTilePx;
    const float m = s_mag[ly + 1][lx + 1];
    const bool horiz = fabsf(s_gx[ly][lx]) >= fabsf(s_gy[ly][lx]);
    const bool nms =
        horiz ? (m > s_mag[ly + 1][lx] && m >= s_mag[ly + 1][lx + 2])
              : (m > s_mag[ly][lx + 1] && m >= s_mag[ly + 2][lx + 1]);
    s_score[ly][lx] = (nms && m > p.anchor_th_bf) ? m : 0.f;
  }
  __syncthreads();
  // each whole cell's first maximum in row-major order
  if (tid < kTileCells * kTileCells) {
    const int cr = blockIdx.y * kTileCells + tid / kTileCells;
    const int cc = blockIdx.x * kTileCells + tid % kTileCells;
    if (cr < p.Hc && cc < p.Wc) {
      const int ly0 = (tid / kTileCells) * kEdCell;
      const int lx0 = (tid % kTileCells) * kEdCell;
      float best = s_score[ly0][lx0];
      int bi = 0;
      for (int k = 1; k < kEdCell * kEdCell; ++k) {
        const float v = s_score[ly0 + k / kEdCell][lx0 + k % kEdCell];
        if (v > best) {
          best = v;
          bi = k;
        }
      }
      cell_score[cr * p.Wc + cc] = best;
      cell_best[cr * p.Wc + cc] = bi;
    }
  }
}

// bilinear sample of a bf16 field at (x, y), clipped to
// [0, W - 1.001] x [0, H - 1.001], in the plain version's order
__device__ __forceinline__ float bilinear(const __nv_bfloat16* __restrict__ a,
                                          int W, float xmax, float ymax,
                                          float x, float y) {
  x = fminf(fmaxf(x, 0.f), xmax);
  y = fminf(fmaxf(y, 0.f), ymax);
  const int x0 = int(floorf(x)), y0 = int(floorf(y));
  const float fx = x - float(x0), fy = y - float(y0);
  const __nv_bfloat16* r = a + y0 * W + x0;
  const float v00 = __bfloat162float(r[0]), v01 = __bfloat162float(r[1]);
  const float v10 = __bfloat162float(r[W]), v11 = __bfloat162float(r[W + 1]);
  return v00 * (1.f - fx) * (1.f - fy) + v01 * fx * (1.f - fy)
         + v10 * (1.f - fx) * fy + v11 * fx * fy;
}

struct Field {
  const __nv_bfloat16 *gx, *gy, *mag;
  int W;
  float xmax, ymax;
};

__device__ __forceinline__ void edge_dir(const Field& f, float x, float y,
                                         float* ex, float* ey) {
  const float gxx = bilinear(f.gx, f.W, f.xmax, f.ymax, x, y);
  const float gyy = bilinear(f.gy, f.W, f.xmax, f.ymax, x, y);
  const float n = sqrtf(gxx * gxx + gyy * gyy);
  const bool big = n > 1e-6f;
  const float nc = fmaxf(n, 1e-6f);
  *ex = big ? -gyy / nc : 1.f;
  *ey = big ? gxx / nc : 0.f;
}

// descending bitonic sort of n (a power of two) keys by the whole block
__device__ void sort_desc(unsigned long long* s, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = s[i], b = s[ixj];
          const bool down = (i & k) == 0;
          if (down ? (a < b) : (a > b)) {
            s[i] = b;
            s[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// a non-negative float score and an index as one key: the higher score
// first, the lower index first among equal scores
__device__ __forceinline__ unsigned long long score_key(float s, int i) {
  return (static_cast<unsigned long long>(__float_as_uint(s)) << 32)
         | static_cast<unsigned long long>(0xffffffffu - unsigned(i));
}

__device__ __forceinline__ int key_index(unsigned long long k) {
  return int(0xffffffffu - unsigned(k & 0xffffffffull));
}

__global__ void __launch_bounds__(kWalkThreads) ed_walk_kernel(
    EdParams p, const __nv_bfloat16* __restrict__ gx,
    const __nv_bfloat16* __restrict__ gy,
    const __nv_bfloat16* __restrict__ mag,
    const float* __restrict__ cell_score, const int* __restrict__ cell_best,
    float* __restrict__ px, float* __restrict__ py, float* __restrict__ pw,
    float* __restrict__ ep, float* __restrict__ ang_out,
    float* __restrict__ len_out, uint8_t* __restrict__ valid_out) {
  extern __shared__ unsigned long long s_key[];
  __shared__ float s_ax[kMaxAnchors], s_ay[kMaxAnchors];
  __shared__ float s_x1[kMaxAnchors], s_y1[kMaxAnchors];
  __shared__ float s_x2[kMaxAnchors], s_y2[kMaxAnchors];
  __shared__ float s_ang[kMaxAnchors], s_len[kMaxAnchors];
  __shared__ float s_vx[kMaxAnchors], s_vy[kMaxAnchors];
  __shared__ float s_mx[kMaxAnchors], s_my[kMaxAnchors];
  __shared__ unsigned char s_alive[kMaxAnchors], s_ok[kMaxAnchors];
  const int tid = threadIdx.x;
  const int C = p.Hc * p.Wc, A = p.n_anchors;
  // ---- the top A cells by score (lax.top_k order)
  for (int i = tid; i < p.n_pad_cells; i += blockDim.x)
    s_key[i] = i < C ? score_key(cell_score[i], i) : 0ull;
  __syncthreads();
  sort_desc(s_key, p.n_pad_cells);
  if (tid < A) {
    const int c = key_index(s_key[tid]);
    const int b = cell_best[c];
    s_ax[tid] = float((c % p.Wc) * kEdCell + b % kEdCell);
    s_ay[tid] = float((c / p.Wc) * kEdCell + b / kEdCell);
    s_alive[tid] = cell_score[c] > 0.f;
  }
  __syncthreads();
  // ---- the walks: thread a forward, A + a backward
  const Field f{gx, gy, mag, p.W, float(double(p.W) - 1.001),
                float(double(p.H) - 1.001)};
  const int half = p.walk_steps;
  if (tid < 2 * A) {
    const bool fwd = tid < A;
    const int a = fwd ? tid : tid - A;
    float x = s_ax[a], y = s_ay[a], dx, dy;
    edge_dir(f, x, y, &dx, &dy);
    if (!fwd) {
      dx = -dx;
      dy = -dy;
    }
    bool live = s_alive[a];
    const float c = 0.906f, s = 0.423f;
    float* qx = px + a * kPts;
    float* qy = py + a * kPts;
    float* qw = pw + a * kPts;
    for (int st = 0; st < half; ++st) {
      if (live) {
        const float cdx[3] = {dx, c * dx - s * dy, c * dx + s * dy};
        const float cdy[3] = {dy, s * dx + c * dy, -s * dx + c * dy};
        float best = 0.f;
        int bi = 0;
        for (int k = 0; k < 3; ++k) {
          const float m = bilinear(f.mag, f.W, f.xmax, f.ymax, x + cdx[k],
                                   y + cdy[k]);
          if (k == 0 || m > best) {
            best = m;
            bi = k;
          }
        }
        const float bdx = cdx[bi], bdy = cdy[bi];
        const float nx = x + bdx, ny = y + bdy;
        float ex, ey;
        edge_dir(f, nx, ny, &ex, &ey);
        if (ex * bdx + ey * bdy < 0.f) {
          ex = -ex;
          ey = -ey;
        }
        const float turn = ex * dx + ey * dy;
        live = best > p.grad_th && turn > p.cos_th;
        if (live) {
          x = nx;
          y = ny;
          dx = ex;
          dy = ey;
        }
      }
      const int slot = fwd ? half + 1 + st : half - 1 - st;
      qx[slot] = x;
      qy[slot] = y;
      qw[slot] = live ? 1.f : 0.f;
    }
    if (fwd) {
      qx[half] = s_ax[a];
      qy[half] = s_ay[a];
      qw[half] = s_alive[a] ? 1.f : 0.f;
    }
  }
  __syncthreads();
  // ---- each anchor's fit, its sums over the points in order
  const int P = 2 * half + 1;
  if (tid < A) {
    const float* qx = px + tid * kPts;
    const float* qy = py + tid * kPts;
    const float* qw = pw + tid * kPts;
    float sw = qw[0], sx = qw[0] * qx[0], sy = qw[0] * qy[0];
    for (int k = 1; k < P; ++k) {
      sw = sw + qw[k];
      sx = sx + qw[k] * qx[k];
      sy = sy + qw[k] * qy[k];
    }
    const float wsum = fmaxf(sw, 1e-6f);
    const float mx = sx / wsum, my = sy / wsum;
    float sxx = 0.f, sxy = 0.f, syy = 0.f;
    for (int k = 0; k < P; ++k) {
      const float ux = qx[k] - mx, uy = qy[k] - my;
      const float a = qw[k] * ux * ux, b = qw[k] * ux * uy,
                  d = qw[k] * uy * uy;
      sxx = k == 0 ? a : sxx + a;
      sxy = k == 0 ? b : sxy + b;
      syy = k == 0 ? d : syy + d;
    }
    const float tr = sxx + syy;
    const float disc = sqrtf(fmaxf(tr * tr / 4.f - (sxx * syy - sxy * sxy),
                                   0.f));
    const float lam1 = tr / 2.f + disc;
    float vx = sxy, vy = lam1 - sxx;
    const float vn = sqrtf(vx * vx + vy * vy);
    const bool big = vn > 1e-6f;
    const float vnc = fmaxf(vn, 1e-6f);
    vx = big ? vx / vnc : 1.f;
    vy = big ? vy / vnc : 0.f;
    float spp = 0.f, pmin = kBig, pmax = -kBig;
    for (int k = 0; k < P; ++k) {
      const float ux = qx[k] - mx, uy = qy[k] - my;
      const float proj = ux * vx + uy * vy;
      const float perp = -ux * vy + uy * vx;
      const float e = qw[k] * perp * perp;
      spp = k == 0 ? e : spp + e;
      if (qw[k] > 0.f) {
        pmin = fminf(pmin, proj);
        pmax = fmaxf(pmax, proj);
      }
    }
    const float rms = sqrtf(spp / wsum);
    const float length = pmax - pmin;
    const bool ok = s_alive[tid] && rms < p.fit_tol
                    && length >= p.min_length && wsum >= 8.f;
    const float x1 = mx + pmin * vx, y1 = my + pmin * vy;
    const float x2 = mx + pmax * vx, y2 = my + pmax * vy;
    s_x1[tid] = x1;
    s_y1[tid] = y1;
    s_x2[tid] = x2;
    s_y2[tid] = y2;
    s_ang[tid] = mod_pi(atan2f(y2 - y1, x2 - x1));
    s_len[tid] = length;
    s_vx[tid] = vx;
    s_vy[tid] = vy;
    s_mx[tid] = (x1 + x2) / 2.f;
    s_my[tid] = (y1 + y2) / 2.f;
    s_ok[tid] = ok;
  }
  __syncthreads();
  // ---- overlap suppression: a shorter near-duplicate goes
  bool keep = false;
  if (tid < A && s_ok[tid]) {
    keep = true;
    const float ai = s_ang[tid], li = s_len[tid];
    for (int j = 0; j < A && keep; ++j) {
      if (!s_ok[j]) continue;
      float dang = mod_pi(fabsf(ai - s_ang[j]));
      dang = fminf(dang, PLVIO_PI_F - dang);
      const float rx = s_mx[tid] - s_mx[j], ry = s_my[tid] - s_my[j];
      const float perp = fabsf(-rx * s_vy[j] + ry * s_vx[j]);
      const float along = fabsf(rx * s_vx[j] + ry * s_vy[j]);
      const bool dup = dang < 0.1f && perp < 2.5f
                       && along < (s_len[j] + li) / 2.f;
      const bool better = s_len[j] > li || (s_len[j] == li && j < tid);
      if (dup && better) keep = false;
    }
  }
  __syncthreads();
  // ---- the top max_lines by length (lax.top_k order)
  if (tid < p.n_pad_a)
    s_key[tid] = tid < A ? score_key(keep ? s_len[tid] : 0.f, tid) : 0ull;
  __syncthreads();
  sort_desc(s_key, p.n_pad_a);
  if (tid < p.max_lines) {
    const unsigned long long k = s_key[tid];
    const int r = key_index(k);
    const float sc = __uint_as_float(unsigned(k >> 32));
    ep[4 * tid] = s_x1[r];
    ep[4 * tid + 1] = s_y1[r];
    ep[4 * tid + 2] = s_x2[r];
    ep[4 * tid + 3] = s_y2[r];
    ang_out[tid] = s_ang[r];
    len_out[tid] = sc;
    valid_out[tid] = sc > 0.f;
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

// Both kernels of one level.  The caller checks the shapes: at least
// n_anchors cells, n_anchors <= 512, max_lines <= n_anchors, walk_steps
// <= 48, the cells' keys within shared memory.
PLVIO_API int line_detect_ed(const void* img, int H, int W, int max_lines,
                             float grad_th, float anchor_th_bf,
                             int n_anchors, int walk_steps, float cos_th,
                             float fit_tol, float min_length, void* gx,
                             void* gy, void* mag, void* cell_score,
                             void* cell_best, void* px, void* py, void* pw,
                             void* ep, void* ang, void* length, void* valid,
                             void* stream) {
  EdParams p{H, W, H / kEdCell, W / kEdCell, n_anchors, walk_steps,
             max_lines, 0, 0, grad_th, anchor_th_bf, cos_th, fit_tol,
             min_length};
  p.n_pad_cells = pow2_at_least(p.Hc * p.Wc);
  p.n_pad_a = pow2_at_least(n_anchors);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kTilePx - 1) / kTilePx, (H + kTilePx - 1) / kTilePx);
  ed_field_kernel<<<grid, kFieldThreads, 0, st>>>(
      p, static_cast<const float*>(img), static_cast<__nv_bfloat16*>(gx),
      static_cast<__nv_bfloat16*>(gy), static_cast<__nv_bfloat16*>(mag),
      static_cast<float*>(cell_score), static_cast<int*>(cell_best));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = int(sizeof(unsigned long long))
                   * (p.n_pad_cells > p.n_pad_a ? p.n_pad_cells : p.n_pad_a);
  e = cudaFuncSetAttribute(ed_walk_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ed_walk_kernel<<<1, kWalkThreads, smem, st>>>(
      p, static_cast<const __nv_bfloat16*>(gx),
      static_cast<const __nv_bfloat16*>(gy),
      static_cast<const __nv_bfloat16*>(mag),
      static_cast<const float*>(cell_score),
      static_cast<const int*>(cell_best), static_cast<float*>(px),
      static_cast<float*>(py), static_cast<float*>(pw),
      static_cast<float*>(ep), static_cast<float*>(ang),
      static_cast<float*>(length), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}
