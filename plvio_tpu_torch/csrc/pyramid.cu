// pyramid — the ORB image pyramid's levels and the line front end's level 1.
//
// Replaces plvio_tpu/ops/frontend.py `build_pyramid` (:98-106), whose
// every level is jax.image.resize(prev, (h, w), "linear") of the level
// above (antialiased: the triangle is widened by 1 / scale when
// downsampling), which System.track_monocular runs on every frame
// (models/system.py:163) for the 7 levels below the frame, and the
// 2x2 box mean of the frame's even crop that the 2-level line front end
// detects its level 1 on (plvio_tpu/ops/lines.py:737-739).  XLA computes
// the resize as an einsum of the image with two dense [in, out] weight
// matrices; this kernel computes the same function from each output
// sample's few taps.
//
// What bounds it on the H100: memory.  The 7 levels of a 480x752 float32
// frame read ~4.4 MB and write ~3.0 MB (each input once, each output
// once): ~2.2 us at 3.35 TB/s; the arithmetic (<= 9 multiply-adds an
// output sample, ~6 Mflop a frame) is far below the card's rate.  At
// these sizes one launch's latency (~2-4 us) is of the same order.
//
// Design (`pyramid_levels`: one launch a level, all levels from one host
// call): one block per 32x8 output tile.  The block computes the tile's row and column taps on the device
// in float32 as jax._src.image.scale.compute_weight_mat does under jit
// (sample (o + 0.5) inv - 0.5, triangle max(0, 1 - |sample - i| / ks), the
// weights divided by their total unless |total| <= 1000 eps, zero where
// the sample lies outside [-0.5, n_in - 0.5]; see make_taps for XLA's
// fused multiply-add), stages the input rows and columns the tile needs in
// shared memory, contracts over the rows (into a shared [8, columns]
// tile) and then over the columns, each sum over its taps in increasing
// input index.  That is XLA's and the plain version's order of
// contraction (rows, then columns); built with --fmad=false every other
// product and sum is rounded on its own.  The tap window covers at most
// 2 ks + 4 input samples, so ks <= 1.5 and inv <= 1.5 (the wrapper checks;
// ORB's 1.2 factor needs <= 1.21).
//
// `pyramid_line_level`: one thread per output pixel,
// ((a + b) + c) + d over the 2x2 block in memory order, times 0.25.
#include "common.cuh"

namespace {

constexpr int TW = 32;          // output tile: columns
constexpr int TH = 8;           // output tile: rows
constexpr int MAXT = 8;         // taps an output sample (2 ks + 4, ks <= 1.5)
constexpr int ROWS = 20;        // staged input rows: (TH - 1) 1.5 + 7
constexpr int COLS = 56;        // staged input columns: (TW - 1) 1.5 + 7

struct Taps {
  int j0;                       // first input index of the window
  int n;                        // window length (<= MAXT)
  float w[MAXT];
};

// The weights of output sample o along an axis of n_in inputs, over the
// window [floor(s - ks), ceil(s + ks)] clipped to the axis (s - i is exact,
// so every input outside it has x >= 1 and weight exactly 0 in the
// reference too).
// As XLA computes them on the CPU: the sample of a weight is one fused
// multiply-add, the sample of the total that normalizes them is not (the
// reduction recomputes it unfused; --fmad=false keeps it so here).
__device__ float triangle(float s, int i, float ks) {
  const float x = fabsf(s - (float)i) / ks;
  return fmaxf(0.0f, 1.0f - x);
}

__device__ Taps make_taps(int o, int n_in, float inv, float ks) {
  Taps t;
  const float oh = (float)o + 0.5f;
  const float s = __fmaf_rn(oh, inv, -0.5f);
  const float s_total = oh * inv - 0.5f;
  int lo = (int)floorf(fminf(s, s_total) - ks);
  int hi = (int)ceilf(fmaxf(s, s_total) + ks);
  lo = max(lo, 0);
  hi = min(hi, n_in - 1);
  t.j0 = lo;
  t.n = max(0, min(hi - lo + 1, MAXT));
  float total = 0.0f;
  for (int k = 0; k < MAXT; ++k) {
    t.w[k] = k < t.n ? triangle(s, lo + k, ks) : 0.0f;
    total += k < t.n ? triangle(s_total, lo + k, ks) : 0.0f;
  }
  const bool inside = s >= -0.5f && s <= (float)n_in - 0.5f;
  const bool norm = fabsf(total) > 1000.0f * 1.1920928955078125e-07f;
  const float denom = total != 0.0f ? total : 1.0f;
  for (int k = 0; k < MAXT; ++k)
    t.w[k] = (inside && norm) ? t.w[k] / denom : 0.0f;
  return t;
}

__global__ void __launch_bounds__(TW * TH)
pyramid_level_kernel(const float* __restrict__ src, int H, int W,
                     float* __restrict__ dst, int h, int w, float inv_y,
                     float ks_y, float inv_x, float ks_x) {
  __shared__ float s_in[ROWS][COLS];
  __shared__ float s_mid[TH][COLS];
  __shared__ Taps s_ty[TH];
  __shared__ Taps s_tx[TW];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = blockIdx.x * TW, r0 = blockIdx.y * TH;
  const int tid = ty * TW + tx;
  // the tile's taps: columns by the first warp, rows by the second
  if (tid < TW) {
    const int c = min(c0 + tid, w - 1);
    s_tx[tid] = make_taps(c, W, inv_x, ks_x);
  } else if (tid < TW + TH) {
    const int r = min(r0 + tid - TW, h - 1);
    s_ty[tid - TW] = make_taps(r, H, inv_y, ks_y);
  }
  __syncthreads();
  const int i0 = s_ty[0].j0;
  const int j0 = s_tx[0].j0;
  const int n_rows = min(s_ty[TH - 1].j0 + s_ty[TH - 1].n - i0, ROWS);
  const int n_cols = min(s_tx[TW - 1].j0 + s_tx[TW - 1].n - j0, COLS);
  for (int k = tid; k < ROWS * COLS; k += TW * TH) {
    const int rr = k / COLS, cc = k % COLS;
    float v = 0.0f;
    if (rr < n_rows && cc < n_cols) v = src[(size_t)(i0 + rr) * W + j0 + cc];
    s_in[rr][cc] = v;
  }
  __syncthreads();
  // contraction over the rows: the tile's rows at every staged column
  {
    const Taps& t = s_ty[ty];
    const int off = t.j0 - i0;
    for (int cc = tx; cc < n_cols; cc += TW) {
      float acc = 0.0f;
      for (int k = 0; k < t.n; ++k) {
        const int rr = off + k;
        if (rr >= 0 && rr < ROWS) acc = acc + t.w[k] * s_in[rr][cc];
      }
      s_mid[ty][cc] = acc;
    }
  }
  __syncthreads();
  // contraction over the columns
  const int r = r0 + ty, c = c0 + tx;
  if (r >= h || c >= w) return;
  const Taps& t = s_tx[tx];
  const int off = t.j0 - j0;
  float acc = 0.0f;
  for (int k = 0; k < t.n; ++k) {
    const int cc = off + k;
    if (cc >= 0 && cc < COLS) acc = acc + t.w[k] * s_mid[ty][cc];
  }
  dst[(size_t)r * w + c] = acc;
}

__global__ void pyramid_line_kernel(const float* __restrict__ src, int H,
                                    int W, float* __restrict__ dst, int h,
                                    int w) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= w || r >= h) return;
  const float* a = src + (size_t)(2 * r) * W + 2 * c;
  const float* b = a + W;
  const float sum = ((a[0] + a[1]) + b[0]) + b[1];
  dst[(size_t)r * w + c] = sum * 0.25f;
}

}  // namespace

// n pyramid levels in a row from src [H,W], one launch each, level l
// from level l - 1: level l's [hw[2l], hw[2l+1]] floats at dst + off[l],
// its per-axis (inv_y, ks_y, inv_x, ks_x) at par[4l..4l+3] as the
// reference computes them (the wrapper passes them in float32).  One
// host call for all of them: the levels are small, and a call from the
// wrapper costs more than a level's work.
PLVIO_API int pyramid_levels(const float* src, int H, int W, int n,
                             float* dst, const int* hw, const long long* off,
                             const float* par, void* stream) {
  const float* in = src;
  int h_in = H, w_in = W;
  for (int l = 0; l < n; ++l) {
    const int h = hw[2 * l], w = hw[2 * l + 1];
    float* out = dst + off[l];
    const dim3 block(TW, TH);
    const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
    const float* p = par + 4 * l;
    pyramid_level_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        in, h_in, w_in, out, h, w, p[0], p[1], p[2], p[3]);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    in = out;
    h_in = h;
    w_in = w;
  }
  return (int)cudaSuccess;
}

// The line level: src [H,W] -> dst [H/2, W/2], the 2x2 mean of the even
// crop.
PLVIO_API int pyramid_line_level(const float* src, int H, int W, float* dst,
                                 void* stream) {
  const int h = H / 2, w = W / 2;
  const dim3 block(128);
  const dim3 grid((w + 127) / 128, h);
  pyramid_line_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      src, H, W, dst, h, w);
  return (int)cudaGetLastError();
}
