// line_refine_lbd — what follows the detector on one pyramid level: the
// collinear merge, the sub-pixel refit, the angle, the banded 256-bit LBD
// descriptor and the line equation, and for pyramid level 1 the mapping to
// level-0 pixels and the dedupe against level 0.
//
// Replaces plvio_tpu/ops/lines.py `merge_collinear` (:514),
// `refine_segments` (:619), `lbd_descriptors` (:445), `line_equation`
// (:504) and the level-1 dedupe of `extract_lines_pyramid` (:723).  The
// JAX version builds [L,L] link matrices, [L,32,7] snap samples and
// [L,27,16,4] band samples as whole-array XLA ops; its eager torch
// counterpart issues ~200 small launches per level.
//
// What bounds it on the H100: latency.  L = 192 + 64 segments; each needs
// 224 snap samples and 432 band samples gathered from the bf16 gradients
// (~1.5 MB at level 0, L2-resident) and a few thousand operations.
//
// Design: two kernels per level.
//  1. merge: one block; the L x L link bits live in shared memory (one
//     uint32 word per 32 pairs), the 8 synchronous min-label iterations run
//     on two label buffers, and the group fit (endpoint means, scatter,
//     principal direction, projection extent) has each label's thread sum
//     its members in index order: the plain version's order, and no atomics
//     whose order would change the merged segments from run to run.
//  2. refit + descriptor: one warp per segment.  Lane t takes snap sample t
//     (32 along the segment) and its 7 offsets across it; the bf16 flow of
//     the reference is kept (gradient norm rounded at each bf16 op, the
//     snap weights and their sums rounded to bf16 where the reference sums
//     bf16 tensors), and the two-pass weighted TLS reduces over the warp by
//     shuffles.  The 27x16 band samples are taken band by band, 48 to a
//     band, two per lane; the 4 band means and standard deviations of 9
//     bands stay in shared memory, and the 256 comparisons of the seed-11
//     pattern become 8 words by __ballot_sync.  The same warp writes the
//     angle and the line equation, and at level 1 the scaled endpoints and
//     the dedupe against level 0's lines.
// Warp sums add in another order than the plain version, so the two are
// compared as segment sets and by descriptor-bit agreement.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kMaxL = 256;
constexpr int kWords = kMaxL / 32;
constexpr int kWarpsB = 4;
constexpr float kBig = 1e9f;

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float mod_pi(float a) {   // torch.remainder(a, pi)
  float m = fmodf(a, PLVIO_PI_F);
  if (m != 0.f && m < 0.f) m += PLVIO_PI_F;
  return m;
}

// np.linspace(a, b, n) in float64, rounded to float32
__device__ __forceinline__ float linspace(double a, double b, int n, int i) {
  if (i == n - 1) return float(b);
  return float(double(i) * ((b - a) / double(n - 1)) + a);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void eig_dir(float sxx, float sxy, float syy,
                                        float* vx, float* vy, float* vn) {
  const float tr = sxx + syy;
  const float disc = sqrtf(fmaxf(tr * tr / 4.f - (sxx * syy - sxy * sxy),
                                 0.f));
  const float lam1 = tr / 2.f + disc;
  *vx = sxy;
  *vy = lam1 - sxx;
  *vn = sqrtf(*vx * *vx + *vy * *vy);
}

// ------------------------------------------------------------------ merge
__global__ void __launch_bounds__(kMaxL) merge_kernel(
    const float* __restrict__ ep, const uint8_t* __restrict__ valid, int L,
    float* __restrict__ ep_out, float* __restrict__ len_out,
    uint8_t* __restrict__ valid_out) {
  __shared__ float s_ep[kMaxL][4], s_dn[kMaxL][2], s_len[kMaxL];
  __shared__ float s_mid[kMaxL][2], s_th[kMaxL];
  __shared__ uint32_t s_link[kMaxL][kWords];
  __shared__ int s_lab[2][kMaxL], s_lbl[kMaxL];
  // per segment: weight; per label: mean (x, y), direction (x, y) and
  // projection extent
  __shared__ float s_wt[kMaxL], s_x[kMaxL], s_y[kMaxL];
  __shared__ float s_xx[kMaxL], s_xy[kMaxL], s_min[kMaxL], s_max[kMaxL];
  const int i = threadIdx.x;
  const bool me = i < L;
  bool vi = false;
  if (me) {
    for (int k = 0; k < 4; ++k) s_ep[i][k] = ep[4 * i + k];
    vi = valid[i] != 0;
    const float dx = s_ep[i][2] - s_ep[i][0], dy = s_ep[i][3] - s_ep[i][1];
    const float len = sqrtf(dx * dx + dy * dy);
    s_len[i] = len;
    s_dn[i][0] = dx / fmaxf(len, 1e-6f);
    s_dn[i][1] = dy / fmaxf(len, 1e-6f);
    s_mid[i][0] = (s_ep[i][0] + s_ep[i][2]) / 2.f;
    s_mid[i][1] = (s_ep[i][1] + s_ep[i][3]) / 2.f;
    s_th[i] = mod_pi(atan2f(s_dn[i][1], s_dn[i][0]));
    s_lab[0][i] = vi ? i : L;
  }
  __syncthreads();
  // ---- link bits of row i (angle 0.20, perp 2.5 + 0.09 along <= 6, gap 30)
  if (me) {
    for (int w = 0; w < kWords; ++w) {
      uint32_t bits = 0;
      for (int b = 0; b < 32; ++b) {
        const int j = 32 * w + b;
        if (j >= L) break;
        float dth = mod_pi(fabsf(s_th[i] - s_th[j]));
        dth = fminf(dth, PLVIO_PI_F - dth);
        const float dmx = s_mid[j][0] - s_mid[i][0];
        const float dmy = s_mid[j][1] - s_mid[i][1];
        const float perp_ij = fabsf(-s_dn[i][1] * dmx + s_dn[i][0] * dmy);
        const float perp_ji = fabsf(-s_dn[j][1] * dmx + s_dn[j][0] * dmy);
        const float along = fabsf(s_dn[i][0] * dmx + s_dn[i][1] * dmy);
        const float gap = along - (s_len[i] + s_len[j]) / 2.f;
        const float ptol = fminf(2.5f + 0.09f * along, 6.f);
        const bool link = dth < 0.20f && perp_ij < ptol && perp_ji < ptol
                          && gap < 30.f && vi && valid[j] != 0;
        bits |= uint32_t(link) << b;
      }
      s_link[i][w] = bits;
    }
  }
  __syncthreads();
  // ---- 8 synchronous min-label iterations
  int cur = 0;
  for (int it = 0; it < 8; ++it) {
    if (me) {
      int best = s_lab[cur][i];
      for (int w = 0; w < kWords; ++w) {
        uint32_t bits = s_link[i][w];
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          best = min(best, s_lab[cur][32 * w + b]);
        }
      }
      s_lab[cur ^ 1][i] = min(best, best < L ? s_lab[cur][best] : L);
    }
    __syncthreads();
    cur ^= 1;
  }
  // ---- group fit: each label sums its members in index order, the order
  // of the plain version's index_add (and the same on every run)
  const int lbl = me ? s_lab[cur][i] : L;
  if (me) {
    s_lbl[i] = lbl;
    s_wt[i] = (vi && lbl < L) ? s_len[i] : 0.f;
  }
  __syncthreads();
  if (me) {
    float sw = 0.f, sx = 0.f, sy = 0.f;
    for (int j = 0; j < L; ++j) {
      if (s_lbl[j] != i) continue;
      const float we = s_wt[j] / 2.f;
      sw += s_wt[j];
      sx += we * s_ep[j][0] + we * s_ep[j][2];
      sy += we * s_ep[j][1] + we * s_ep[j][3];
    }
    s_x[i] = sx / fmaxf(sw, 1e-6f);             // mx of label i
    s_y[i] = sy / fmaxf(sw, 1e-6f);
  }
  __syncthreads();
  if (me) {
    const float mx = s_x[i], my = s_y[i];
    float sxx = 0.f, sxy = 0.f, syy = 0.f;
    for (int j = 0; j < L; ++j) {
      if (s_lbl[j] != i) continue;
      const float we = s_wt[j] / 2.f;
      const float dx1 = s_ep[j][0] - mx, dx2 = s_ep[j][2] - mx;
      const float dy1 = s_ep[j][1] - my, dy2 = s_ep[j][3] - my;
      sxx += we * dx1 * dx1 + we * dx2 * dx2;
      sxy += we * dx1 * dy1 + we * dx2 * dy2;
      syy += we * dy1 * dy1 + we * dy2 * dy2;
    }
    float vx, vy, n;
    eig_dir(sxx, sxy, syy, &vx, &vy, &n);
    s_xx[i] = n > 1e-6f ? vx / fmaxf(n, 1e-9f) : s_dn[i][0];   // vx of i
    s_xy[i] = n > 1e-6f ? vy / fmaxf(n, 1e-9f) : s_dn[i][1];   // vy of i
    float pmin = kBig, pmax = -kBig;
    for (int j = 0; j < L; ++j) {
      if (s_lbl[j] != i || !(s_wt[j] > 0.f)) continue;
      const float ps = (s_ep[j][0] - mx) * s_xx[i]
                       + (s_ep[j][1] - my) * s_xy[i];
      const float pe = (s_ep[j][2] - mx) * s_xx[i]
                       + (s_ep[j][3] - my) * s_xy[i];
      pmin = fminf(pmin, fminf(ps, pe));
      pmax = fmaxf(pmax, fmaxf(ps, pe));
    }
    s_min[i] = pmin;
    s_max[i] = pmax;
  }
  __syncthreads();
  if (!me) return;
  const bool root = vi && lbl == i;
  if (root) {                      // a root's label is its own index
    const float mx = s_x[i], my = s_y[i], vx = s_xx[i], vy = s_xy[i];
    ep_out[4 * i] = mx + s_min[i] * vx;
    ep_out[4 * i + 1] = my + s_min[i] * vy;
    ep_out[4 * i + 2] = mx + s_max[i] * vx;
    ep_out[4 * i + 3] = my + s_max[i] * vy;
    len_out[i] = s_max[i] - s_min[i];
  } else {
    for (int k = 0; k < 4; ++k) ep_out[4 * i + k] = s_ep[i][k];
    len_out[i] = 0.f;
  }
  valid_out[i] = root;
}

// ------------------------------------------- refit + descriptor (one warp)
struct Tls {
  float mx, my, vx, vy;
};

__device__ Tls tls(float ws, float px, float py, float dnx, float dny) {
  const float W = bf(warp_sum(ws));                 // bf16 sum
  const float Wc = fmaxf(W, bf(1e-6f));
  Tls t;
  t.mx = warp_sum(ws * px) / Wc;
  t.my = warp_sum(ws * py) / Wc;
  const float ux = px - t.mx, uy = py - t.my;
  float vn;
  eig_dir(warp_sum(ws * ux * ux), warp_sum(ws * ux * uy),
          warp_sum(ws * uy * uy), &t.vx, &t.vy, &vn);
  t.vx = vn > 1e-6f ? t.vx / fmaxf(vn, 1e-9f) : dnx;
  t.vy = vn > 1e-6f ? t.vy / fmaxf(vn, 1e-9f) : dny;
  return t;
}

struct RefineParams {
  const __nv_bfloat16* gx;
  const __nv_bfloat16* gy;
  int H, W, L;
  const float* ep_m;         // merged [L,4]
  const float* len_m;        // [L]
  const uint8_t* valid_m;    // [L]
  const int* pairs;          // [256,2,2]
  float* ep;                 // outputs [L,4], [L], [L], [L,3], [L,8], [L]
  float* ang;
  float* len;
  float* lineq;
  int* desc;
  uint8_t* valid;
  int level1;                // map to level-0 pixels and dedupe
  const float* lineq0;       // level 0's outputs [L0,3], [L0], [L0]
  const float* ang0;
  const uint8_t* valid0;
  int L0;
};

__device__ __forceinline__ void grad_at(const RefineParams& p, float x,
                                        float y, float* gx, float* gy) {
  const int xi = int(fminf(fmaxf(rintf(x), 0.f), float(p.W - 1)));
  const int yi = int(fminf(fmaxf(rintf(y), 0.f), float(p.H - 1)));
  *gx = __bfloat162float(p.gx[yi * p.W + xi]);
  *gy = __bfloat162float(p.gy[yi * p.W + xi]);
}

__global__ void __launch_bounds__(32 * kWarpsB) refine_lbd_kernel(
    RefineParams p) {
  __shared__ float s_stats[kWarpsB][9 * 8];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsB + warp;
  if (i >= p.L) return;
  float e[4];
  for (int k = 0; k < 4; ++k) e[k] = p.ep_m[4 * i + k];
  const bool valid = p.valid_m[i] != 0;

  // ---- refit (lines.py refine_segments: 32 samples x 7 offsets)
  {
    const float dx = e[2] - e[0], dy = e[3] - e[1];
    const float len = sqrtf(dx * dx + dy * dy);
    const float dnx = dx / fmaxf(len, 1e-6f), dny = dy / fmaxf(len, 1e-6f);
    const float nrx = -dny, nry = dnx;
    const float t = linspace(0.05, 0.95, 32, lane);
    const float bx = e[0] + t * dx, by = e[1] + t * dy;
    float wsum_f = 0.f, snap_num = 0.f;
    for (int o = 0; o < 7; ++o) {
      const float off = linspace(-2.5, 2.5, 7, o);
      float gx, gy;
      grad_at(p, bx + off * nrx, by + off * nry, &gx, &gy);
      const float gn = bf(sqrtf(bf(bf(gx * gx) + bf(gy * gy))));
      const float gdot = fabsf(gx * nrx + gy * nry);
      const float align = gdot / fmaxf(gn, bf(1e-6f));
      const float w = align > 0.85f ? gn : 0.f;
      wsum_f += w;
      snap_num += w * off;
    }
    const float wsum = bf(wsum_f);
    const float snap = snap_num / fmaxf(wsum, bf(1e-6f));
    const bool good = wsum > 1.f;
    const float prx = bx + snap * nrx, pry = by + snap * nry;
    const float ws0 = good ? wsum : 0.f;
    Tls t0 = tls(ws0, prx, pry, dnx, dny);
    const float resid = fabsf(-t0.vy * (prx - t0.mx) + t0.vx * (pry - t0.my));
    const float ws1 = resid < 1.f ? ws0 : 0.f;
    const float s1 = bf(warp_sum(ws1));
    const float s0 = bf(warp_sum(ws0));
    const bool enough = s1 > bf(0.5f * fmaxf(s0, bf(1e-6f)));
    Tls t1 = tls(enough ? ws1 : ws0, prx, pry, dnx, dny);
    const int n_good = __popc(__ballot_sync(0xffffffffu, good));
    if (valid && n_good >= 16) {
      const float ps = (e[0] - t1.mx) * t1.vx + (e[1] - t1.my) * t1.vy;
      const float pe = (e[2] - t1.mx) * t1.vx + (e[3] - t1.my) * t1.vy;
      e[0] = t1.mx + ps * t1.vx;
      e[1] = t1.my + ps * t1.vy;
      e[2] = t1.mx + pe * t1.vx;
      e[3] = t1.my + pe * t1.vy;
    }
  }

  // ---- LBD (lines.py lbd_descriptors: 9 bands x 3 rows x 16 samples)
  {
    const float mxm = (e[0] + e[2]) / 2.f, mym = (e[1] + e[3]) / 2.f;
    const float dx = e[2] - e[0], dy = e[3] - e[1];
    const float len = sqrtf(dx * dx + dy * dy);
    const float ux = dx / fmaxf(len, 1e-6f), uy = dy / fmaxf(len, 1e-6f);
    const float nx = -uy, ny = ux;
    for (int b = 0; b < 9; ++b) {
      float f[2][4];
      for (int q = 0; q < 2; ++q) {
        const int s = lane + 32 * q;
        for (int c = 0; c < 4; ++c) f[q][c] = 0.f;
        if (s >= 48) continue;
        const float tp = float(3 * b + s / 16) - 13.f;
        const float ta = linspace(-0.5, 0.5, 16, s % 16);
        const float sx = mxm + ux * (ta * len) + nx * tp;
        const float sy = mym + uy * (ta * len) + ny * tp;
        float gx, gy;
        grad_at(p, sx, sy, &gx, &gy);
        const float gpar = gx * ux + gy * uy;
        const float gperp = gx * nx + gy * ny;
        f[q][0] = fmaxf(gperp, 0.f);
        f[q][1] = fmaxf(-gperp, 0.f);
        f[q][2] = fmaxf(gpar, 0.f);
        f[q][3] = fmaxf(-gpar, 0.f);
      }
      for (int c = 0; c < 4; ++c) {
        const float mean = warp_sum(f[0][c] + f[1][c]) / 48.f;
        float d0 = f[0][c] - mean, d1 = f[1][c] - mean;
        d0 = d0 * d0;
        d1 = lane + 32 < 48 ? d1 * d1 : 0.f;
        const float var = warp_sum(d0 + d1) / 48.f;
        if (lane == 0) {
          s_stats[warp][b * 8 + c] = mean;
          s_stats[warp][b * 8 + 4 + c] = sqrtf(var);
        }
      }
    }
    __syncwarp();
    for (int w = 0; w < 8; ++w) {
      const int* pr = p.pairs + 4 * (32 * w + lane);
      const bool bit = s_stats[warp][pr[0] * 8 + pr[1]]
                       > s_stats[warp][pr[2] * 8 + pr[3]];
      const unsigned word = __ballot_sync(0xffffffffu, bit);
      if (lane == 0) p.desc[8 * i + w] = int(word);
    }
  }

  // ---- angle, line equation, level-1 mapping and dedupe
  bool v_out = valid;
  float len_out = p.len_m[i];
  if (p.level1) {
    for (int k = 0; k < 4; ++k) e[k] = e[k] * 2.f + 0.5f;
    len_out = len_out * 2.f;
  }
  const float ang = mod_pi(atan2f(e[3] - e[1], e[2] - e[0]));
  // cross((x1, y1, 1), (x2, y2, 1)), normalized by |(a, b)|
  const float l0 = e[1] * 1.f - 1.f * e[3];
  const float l1 = 1.f * e[2] - e[0] * 1.f;
  const float l2 = e[0] * e[3] - e[1] * e[2];
  const float ln = fmaxf(sqrtf(l0 * l0 + l1 * l1), 1e-9f);
  if (p.level1) {
    bool dup = false;
    for (int j = lane; j < p.L0; j += 32) {
      float dang = mod_pi(fabsf(ang - p.ang0[j]));
      dang = fminf(dang, PLVIO_PI_F - dang);
      const float* q = p.lineq0 + 3 * j;
      const float ds = fabsf(e[0] * q[0] + e[1] * q[1] + q[2]);
      const float de = fabsf(e[2] * q[0] + e[3] * q[1] + q[2]);
      dup = dup || (dang < 0.1f && ds < 4.f && de < 4.f
                    && p.valid0[j] != 0);
    }
    dup = __any_sync(0xffffffffu, dup);
    v_out = v_out && !dup;
  }
  if (lane == 0) {
    for (int k = 0; k < 4; ++k) p.ep[4 * i + k] = e[k];
    p.ang[i] = ang;
    p.len[i] = len_out;
    p.lineq[3 * i] = l0 / ln;
    p.lineq[3 * i + 1] = l1 / ln;
    p.lineq[3 * i + 2] = l2 / ln;
    p.valid[i] = v_out;
  }
}

}  // namespace

// Merge (scratch ep_m, len_m, valid_m), then refit + descriptor into the
// outputs (row pointers of this level).  level1 != 0 maps the segments to
// level-0 pixels (x2 + 0.5) and drops those that a valid level-0 line
// (lineq0, ang0, valid0 of L0 rows) already covers.
PLVIO_API int line_refine_lbd(const void* gx, const void* gy, int H, int W,
                              const void* ep_in, const void* valid_in, int L,
                              const void* pairs, void* ep_m, void* len_m,
                              void* valid_m, void* ep, void* ang, void* len,
                              void* lineq, void* desc, void* valid,
                              int level1, const void* lineq0,
                              const void* ang0, const void* valid0, int L0,
                              void* stream) {
  if (L == 0) return 0;
  if (L > kMaxL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  merge_kernel<<<1, kMaxL, 0, st>>>(
      static_cast<const float*>(ep_in), static_cast<const uint8_t*>(valid_in),
      L, static_cast<float*>(ep_m), static_cast<float*>(len_m),
      static_cast<uint8_t*>(valid_m));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  RefineParams p{static_cast<const __nv_bfloat16*>(gx),
                 static_cast<const __nv_bfloat16*>(gy), H, W, L,
                 static_cast<const float*>(ep_m),
                 static_cast<const float*>(len_m),
                 static_cast<const uint8_t*>(valid_m),
                 static_cast<const int*>(pairs), static_cast<float*>(ep),
                 static_cast<float*>(ang), static_cast<float*>(len),
                 static_cast<float*>(lineq), static_cast<int*>(desc),
                 static_cast<uint8_t*>(valid), level1,
                 static_cast<const float*>(lineq0),
                 static_cast<const float*>(ang0),
                 static_cast<const uint8_t*>(valid0), L0};
  refine_lbd_kernel<<<(L + kWarpsB - 1) / kWarpsB, 32 * kWarpsB, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
