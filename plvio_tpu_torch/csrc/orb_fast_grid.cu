// orb_fast_grid — the ORB detector of a frame: dense FAST-16/9 at two
// thresholds, 3x3 non-max suppression, the high/low blend, the border mask
// and the per-cell argmax of every pyramid level, then each level's
// top-k cells and the keypoints' outputs, in two launches a frame.
//
// Replaces plvio_tpu/ops/frontend.py `fast_response2` (:151), `nms3x3`
// (:159), `select_grid_topk` (:165: the border mask, per-cell max/argmax
// and lax.top_k over the cells) and `extract_orb`'s per-level loop
// (:346-360: the blend, the response, valid, octave and the level-0
// coordinates).  The JAX version stacks 16 shifted copies of the level
// ([16,H,W]) and reduces over them, then runs a window reduction, a
// reshape/transpose into cells and a top-k, level by level: each stage a
// full pass over level-sized tensors in device memory.
//
// What bounds it on the H100: launches.  The work is ~150 flops per pixel
// on 0.36 Mpixel at level 0 and ~1.2 Mpixel over the eight levels; the
// input is read once (4.8 MB), 8 bytes per 16x16 cell are written, then
// read back by the selection.  A launch a level, with its selection and
// the per-level glue as PyTorch operations, was ~205 launches a frame
// (2.76 ms a frame by CUDA events against 0.46 on the card, H100 80GB
// HBM3, 700 W): the host's enqueue.
//
// Design: the levels come by a pointer table (the image, then the
// pyramid's levels), the outputs are written straight into the buffers
// that orb_describe reads.
// - fast_grid: one block of 256 threads per 16x16 cell of every level
//   (the blocks of level l after those of levels < l).  The block loads
//   the cell plus a 4 px halo (3 px for the FAST circle, 1 px for the NMS
//   window) into shared memory, with 0 outside the image as `_shift2d`'s
//   zero padding.  It computes both FAST responses on the 18x18 region
//   that the NMS needs (pixels outside the image count as -inf there, as
//   reduce_window's init value), suppresses with '>=' against the 3x3
//   max, blends (hi + 1e4 where the high-threshold response survives,
//   else lo), masks the border, and reduces (value, in-cell index
//   row*16+col) to the cell's maximum with the smallest index on ties,
//   which is jnp.argmax's rule (:183).  Scores sum the 16 circle terms in
//   circle order, as the plain version does.
// - select_cells (with the selection asked for): one block of 1024
//   threads a level sorts its cells by the key (score descending, cell
//   index ascending), a bitonic sort of 64-bit keys held in registers
//   (pairs up to 32 apart exchanged by warp shuffles, farther ones
//   through shared memory; up to 16384 cells a level): the stable
//   descending sort's and lax.top_k's order exactly.  Its first k =
//   min(n_keep, cells) write the keypoint (level coordinates), the
//   response (score - 1e4 above 1e4), valid (score > 0), the octave and
//   uv = xy * scale (the one float32 product the plain path takes).
//   Every output is a compare, an integer operation or that product, so
//   the kernel is bit-equal to the plain path.
// At 480x752: fast_grid 0.045 ms and select_cells 0.022 ms on the card,
// the detector 0.058 ms a frame by CUDA events (H100 80GB HBM3, 700 W).
#include "common.cuh"

namespace {

constexpr int kCell = 16;
constexpr int kHalo = 4;
constexpr int kTile = kCell + 2 * kHalo;   // 24
constexpr int kReg = kCell + 2;            // 18: cell + NMS ring

__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                  0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                  3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ bool has_arc9(uint32_t bits) {
  uint32_t bb = bits | (bits << 16);
  uint32_t acc = bb;
#pragma unroll
  for (int k = 1; k <= 8; ++k) acc &= bb >> k;
  return (acc & 0xffffu) != 0u;
}

__device__ __forceinline__ float fast_score(const float* d, float t) {
  uint32_t br = 0, dk = 0;
  float sb = 0.f, sd = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    br |= uint32_t(d[k] > t) << k;
    dk |= uint32_t(d[k] < -t) << k;
    sb = sb + fmaxf(d[k] - t, 0.f);
    sd = sd + fmaxf(-d[k] - t, 0.f);
  }
  return (has_arc9(br) || has_arc9(dk)) ? fmaxf(sb, sd) : 0.f;
}

constexpr int kMaxLevels = 8;

// the levels of one call: images, sizes, the first cell and the first
// output row of each level (cell0 / out0 [n]: the totals), the scales
struct Levels {
  const float* img[kMaxLevels];
  int h[kMaxLevels], w[kMaxLevels];
  int cell0[kMaxLevels + 1], out0[kMaxLevels + 1];
  float scale[kMaxLevels];
  int n;
};

__global__ void fast_grid(Levels L, float th_hi, float th_lo, int border,
                          float* cell_best, int* cell_arg) {
  __shared__ float tile[kTile][kTile];
  __shared__ float rhi[kReg][kReg];
  __shared__ float rlo[kReg][kReg];
  __shared__ float red_v[8];
  __shared__ int red_i[8];

  const int tid = threadIdx.x;
  int lv = 0;
  while (blockIdx.x >= L.cell0[lv + 1]) ++lv;
  const float* __restrict__ img = L.img[lv];
  const int H = L.h[lv], W = L.w[lv], Wc = W / kCell;
  const int cell = blockIdx.x - L.cell0[lv];
  const int cy = cell / Wc, cx = cell % Wc;
  const int y0 = cy * kCell - kHalo, x0 = cx * kCell - kHalo;
  for (int i = tid; i < kTile * kTile; i += blockDim.x) {
    const int yy = y0 + i / kTile, xx = x0 + i % kTile;
    tile[i / kTile][i % kTile] =
        (yy >= 0 && yy < H && xx >= 0 && xx < W) ? img[yy * W + xx] : 0.f;
  }
  __syncthreads();

  for (int i = tid; i < kReg * kReg; i += blockDim.x) {
    const int ry = i / kReg, rx = i % kReg;
    const int yy = cy * kCell - 1 + ry, xx = cx * kCell - 1 + rx;
    float hi = -INFINITY, lo = -INFINITY;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const int ty = ry + kHalo - 1, tx = rx + kHalo - 1;
      const float c = tile[ty][tx];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k)
        d[k] = tile[ty + kCircleDy[k]][tx + kCircleDx[k]] - c;
      hi = fast_score(d, th_hi);
      lo = fast_score(d, th_lo);
    }
    rhi[ry][rx] = hi;
    rlo[ry][rx] = lo;
  }
  __syncthreads();

  const int py = tid / kCell, px = tid % kCell;
  float mh = -INFINITY, ml = -INFINITY;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      mh = fmaxf(mh, rhi[py + dy][px + dx]);
      ml = fmaxf(ml, rlo[py + dy][px + dx]);
    }
  const float h = rhi[py + 1][px + 1], l = rlo[py + 1][px + 1];
  const float nh = h >= mh ? h : 0.f;
  const float nl = l >= ml ? l : 0.f;
  float v = nh > 0.f ? nh + 1e4f : nl;
  const int y = cy * kCell + py, x = cx * kCell + px;
  if (!(y >= border && y < H - border && x >= border && x < W - border))
    v = 0.f;
  int idx = tid;

  // argmax over the cell: larger value wins, equal values keep the
  // smaller in-cell index
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    if (ov > v || (ov == v && oi < idx)) { v = ov; idx = oi; }
  }
  if ((tid & 31) == 0) { red_v[tid >> 5] = v; red_i[tid >> 5] = idx; }
  __syncthreads();
  if (tid == 0) {
    float bv = red_v[0];
    int bi = red_i[0];
    for (int w = 1; w < 8; ++w)
      if (red_v[w] > bv || (red_v[w] == bv && red_i[w] < bi)) {
        bv = red_v[w]; bi = red_i[w];
      }
    cell_best[blockIdx.x] = bv;
    cell_arg[blockIdx.x] = bi;
  }
}

constexpr int kSelectThreads = 1024;
constexpr int kSortV = 8;          // key pairs a thread holds: 16384 cells

// the bitonic network's choice for element e against its partner b: the
// smaller where e's half of the pair and its run's direction agree
__device__ __forceinline__ unsigned long long pick(unsigned long long a,
                                                   unsigned long long b,
                                                   int e, int stride,
                                                   int size) {
  const bool keep_min = ((e & stride) == 0) == ((e & size) == 0);
  return keep_min ? (a < b ? a : b) : (a < b ? b : a);
}

// Level blockIdx.x's first k cells in (score descending, index ascending)
// order and their outputs at rows out0[l]..: xy [N,2] (level
// coordinates), response, valid, octave, uv [N,2] = xy * scale.  The sort:
// thread t holds elements 2t + s + 2 T v (s < 2, v < V) in registers;
// pairs one apart are exchanged in the thread, up to 32 apart by warp
// shuffles, farther through shared memory.
__global__ void __launch_bounds__(kSelectThreads)
    select_cells(Levels L, const float* cell_best, const int* cell_arg,
                 float* xy, float* response, bool* valid, int* octave,
                 float* uv) {
  extern __shared__ unsigned long long key[];   // [the largest level's P]
  const int lv = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int c0 = L.cell0[lv], C = L.cell0[lv + 1] - c0;
  const int k = L.out0[lv + 1] - L.out0[lv];
  int P = 2;                                    // the level's sort size
  while (P < C) P <<= 1;
  const int V = P > 2 * T ? P / (2 * T) : 1;
  // scores are >= 0, so their bits order them (+0 for -0); the
  // complement sorts them descending, the index breaks ties ascending
  unsigned long long r[kSortV][2];
#pragma unroll
  for (int v = 0; v < kSortV; ++v)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int e = 2 * tid + s + 2 * T * v;
      r[v][s] = v < V && e < C
          ? (static_cast<unsigned long long>(
                 ~__float_as_uint(cell_best[c0 + e] + 0.f)) << 32)
                | unsigned(e)
          : ~0ull;
    }
  for (int size = 2; size <= P; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      // V is the block's: a v past it is skipped by every thread
      if (stride >= 64) {
#pragma unroll
        for (int v = 0; v < kSortV; ++v) {
          if (v >= V) break;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int e = 2 * tid + s + 2 * T * v;
            if (e < P) key[e] = r[v][s];
          }
        }
        __syncthreads();
#pragma unroll
        for (int v = 0; v < kSortV; ++v) {
          if (v >= V) break;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int e = 2 * tid + s + 2 * T * v;
            if (e < P)
              r[v][s] = pick(r[v][s], key[e ^ stride], e, stride, size);
          }
        }
        __syncthreads();
      } else if (stride > 1) {
#pragma unroll
        for (int v = 0; v < kSortV; ++v) {
          if (v >= V) break;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int e = 2 * tid + s + 2 * T * v;
            r[v][s] = pick(r[v][s],
                           __shfl_xor_sync(0xffffffffu, r[v][s], stride >> 1),
                           e, stride, size);
          }
        }
      } else {
#pragma unroll
        for (int v = 0; v < kSortV; ++v) {
          if (v >= V) break;
          const int e = 2 * tid + 2 * T * v;
          const unsigned long long a = r[v][0], b = r[v][1];
          r[v][0] = pick(a, b, e, 1, size);
          r[v][1] = pick(b, a, e + 1, 1, size);
        }
      }
    }
  const int Wc = L.w[lv] / kCell;
  const float sc = L.scale[lv];
#pragma unroll
  for (int v = 0; v < kSortV; ++v)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int j = 2 * tid + s + 2 * T * v;       // the rank
      if (v >= V || j >= k) continue;
      const int cell = static_cast<int>(r[v][s] & 0xffffffffu);
      const float score = cell_best[c0 + cell];
      const int within = cell_arg[c0 + cell];
      const float x = float((cell % Wc) * kCell + within % kCell);
      const float y = float((cell / Wc) * kCell + within / kCell);
      const int o = L.out0[lv] + j;
      xy[2 * o] = x;
      xy[2 * o + 1] = y;
      response[o] = score > 1e4f ? score - 1e4f : score;
      valid[o] = score > 0.f;
      octave[o] = lv;
      uv[2 * o] = x * sc;
      uv[2 * o + 1] = y * sc;
    }
}

}  // namespace

// The detector over n_levels levels (imgs [n] device pointers, hs, ws):
// the cell winners of every level into cell_best / cell_arg (level l's
// cells after those of levels < l, each level's row by row) and, where
// n_keep is given, each level's min(n_keep[l], cells) best cells into the
// outputs (xy, response, valid, octave, uv; level l's after the rows of
// levels < l), scales [n] the levels' float32 scales: one launch, or two
// with the selection.
PLVIO_API int orb_fast_grid(const void* const* imgs, const int* hs,
                            const int* ws, int n_levels, float th_hi,
                            float th_lo, int border, void* cell_best,
                            void* cell_arg, const int* n_keep,
                            const float* scales, void* xy, void* response,
                            void* valid, void* octave, void* uv,
                            void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Levels L = {};
  L.n = n_levels;
  int max_cells = 0;
  for (int l = 0; l < n_levels; ++l) {
    L.img[l] = static_cast<const float*>(imgs[l]);
    L.h[l] = hs[l];
    L.w[l] = ws[l];
    const int cells = (hs[l] / kCell) * (ws[l] / kCell);
    max_cells = cells > max_cells ? cells : max_cells;
    L.cell0[l + 1] = L.cell0[l] + cells;
    const int k = n_keep ? (n_keep[l] < cells ? n_keep[l] : cells) : 0;
    L.out0[l + 1] = L.out0[l] + (k > 0 ? k : 0);
    L.scale[l] = scales ? scales[l] : 1.f;
  }
  if (L.cell0[n_levels] == 0) return 0;
  fast_grid<<<L.cell0[n_levels], kCell * kCell, 0, s>>>(
      L, th_hi, th_lo, border, static_cast<float*>(cell_best),
      static_cast<int*>(cell_arg));
  if (n_keep) {
    int P = 2;
    while (P < max_cells) P <<= 1;
    if (P > 2 * kSelectThreads * kSortV)
      return static_cast<int>(cudaErrorInvalidValue);
    const int smem = P * static_cast<int>(sizeof(unsigned long long));
    const cudaError_t e = cudaFuncSetAttribute(
        select_cells, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    select_cells<<<n_levels, kSelectThreads, smem, s>>>(
        L, static_cast<const float*>(cell_best),
        static_cast<const int*>(cell_arg), static_cast<float*>(xy),
        static_cast<float*>(response), static_cast<bool*>(valid),
        static_cast<int*>(octave), static_cast<float*>(uv));
  }
  return static_cast<int>(cudaGetLastError());
}
