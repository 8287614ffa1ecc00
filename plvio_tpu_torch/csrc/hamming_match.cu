// hamming_match — gated nearest-neighbour matching of packed binary
// descriptors, with ratio test and mutual check.
//
// Replaces plvio_tpu/ops/matching.py `hamming_matrix` (:49), `window_gate`
// (:95) and `match_nn_ratio` (:59) as the point projection match runs them
// (__graft_entry__.py:92-96), and the gate + matcher of
// `line_proj_match_core` (plvio_tpu/models/kernels.py:377-384).  The JAX
// version unpacks descriptors to +-1 bf16 and forms the whole N x M
// distance matrix as a matmul, then masks it.
//
// What bounds it on the H100: very little work.  At the slice's shapes
// (2048 map points x 1000 features, 128 map lines x 256 segments) the
// geometric gate leaves a few candidates per row, so the kernel is bound by
// launch latency and by one pass over the gate inputs (~20 KB), not by the
// 2048*1000*8 XOR+popc of the full matrix.
//
// Design: one warp per map row.  A block stages the column positions,
// angles and validity in shared memory; each lane walks its columns, tests
// the gate, and only then XORs the 8 packed words and counts bits with
// __popc, so the N x M matrix is never formed.  Each lane keeps (best1,
// idx1, best2) with strict '<', so ties keep the first column; lanes merge
// by shuffles into the second minimum of the multiset (a second column at
// best1's distance makes best2 == best1, as ops/matching.py:81-85).  The
// column-wise argmin of the mutual check is a minimum of (dist<<16)|row,
// which gives the first row among equal distances, as argmin(axis=0) does
// (:90): a block takes its rows' minima in shared memory, then issues one
// global atomicMin a column it touched (one a gated pair would be n x m
// atomics on m addresses in the ungated mode).  The last block to arrive
// (a ticket kept before the columns in a workspace the wrapper keeps per
// device and stream) applies the mutual check, or the stereo epilogue, to
// every row once all rows are done, then resets the columns' minima and
// the ticket for the next call: one launch a call, no memset.  A row with
// no admissible column returns idx 0 and ok false, as the JAX does.
//
// A third gate mode (mode 2) is the epipolar gate of the keyframe mapping
// step, `make_epipolar_matcher` (plvio_tpu/models/kernels.py:845-870): the
// fundamental matrix F (9 floats, read from device memory, so no host
// sync) gives each row's epipolar line l = F (u, v, 1) in registers; a
// column passes when |l . (u', v', 1)| / max(|l_xy|, 1e-9) is below its
// own threshold (th_epi * 1.2^octave, passed in b_ang).  The gate runs
// before any popc, in the same operation order as
// `ops/matching.epipolar_gate`, so both agree bit for bit (--fmad=false).
// At 1024 x 1024 features the gate leaves a band of a few percent of the
// columns per row: the kernel is bound by the 1M gate evaluations (~10
// flops each) and launch latency, not by memory (~100 KB in).
//
// A fourth gate mode (mode 3) is the keyframe line pair matcher,
// `make_line_pair_matcher` (plvio_tpu/models/kernels.py:605-636): a_xy /
// b_xy then hold the segments' endpoints (xs, ys, xe, ye) and the kernel
// forms each segment's midpoint and length itself, in the reference's
// order (the columns' once, into shared memory beside their angles); a
// pair passes when the squared midpoint distance < r2, the wrapped angle
// difference < ang_tol, len_a / max(len_b, 1e-6) lies in (0.5, 2) and both
// lengths exceed 40 px.  At 256 x 256 segments it is launch-bound like the
// other modes.
//
// Two stereo gate modes (entry point stereo_match) replace the rectified
// pair's matchers of plvio_tpu/ops/stereo.py, `match_stereo` (:16) and
// `match_stereo_lines` (:38), each with an epilogue after the mutual
// check that writes the per-feature result, so the N x M matrix, the
// match indices and the gate never reach the host.  Mode 4 (points): a
// pair passes when |v_L - v_R| <= the row's tolerance (2 x 1.2^octave,
// from the float32 table OCTAVE_SCALE at the row's octave) and the disparity
// u_L - u_R lies in (0.1, bf / min_z]; the epilogue writes u_R, the depth
// bf / max(d, 1e-6) and has = ok & (d > 0.1), -1 where not has.  Mode 5
// (line segments, endpoints (x0, y0, x1, y1)): the wrapped direction
// difference < 0.1 pi, the share of the left segment's y-span that the
// right one covers > 0.75 and mid_R <= mid_L (the columns' endpoints and
// angles staged in shared memory); the epilogue intersects the matched
// right line with the rows of both left endpoints (x0 + (y - y0) * slope,
// slope = dx / dy, dy of magnitude < 1e-6 taken as infinite) and writes
// both endpoint depths when both disparities are >= 1 px and neither
// segment is horizontal (|dy| <= 0.1).  Every gate and epilogue runs in
// the reference's operation order (--fmad=false, true divisions), so the
// kernel and its plain version agree bit for bit.  At 1000 x 1000
// features (or 256 x 256 segments) each mode is bound by the 1M gate
// evaluations and launch latency, not by the ~80 KB it reads.
//
// The matrix mode (entry point hamming_matrix) writes the whole N x M
// distance matrix as float32, for the loop closer's host-side matching
// (`_refine_sim3_guided` at 1024 x 1024, `_refine_sim3_reproj` and
// `_fuse_duplicates`, plvio_tpu/models/loop_closing.py:322, 443, 1064,
// which read `hamming_matrix` whole).  One thread an entry: the row's 8
// words from the L1-cached row, the column's from shared memory (a
// block's 32 columns), XOR and __popc.  Bound by writing 4 N M bytes.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kNone = 1 << 20;      // larger than any 256-bit distance
constexpr uint32_t kNoBest = 0xffffffffu;   // a column no row reached

struct Params {
  const uint32_t* map_desc;   // [n,8]
  const uint32_t* obs_desc;   // [m,8]
  const uint8_t* row_ok;      // [n]
  const uint8_t* col_ok;      // [m]
  const float2* a_xy;         // [n] predicted positions (mode 3: [n,4])
  const float2* b_xy;         // [m] observed positions (mode 3: [m,4])
  const float* a_ang;         // [n] line mode only
  const float* b_ang;         // [m] line mode; epipolar mode: thresholds
  const float* F;             // [9] epipolar mode only, row-major
  int n, m, line_mode;        // 0 window, 1 line, 2 epipolar, 3 pair,
                              // 4 stereo points, 5 stereo lines
  float r2, ang_tol, max_dist, ratio;
  int* idx;                   // [n]
  uint8_t* ok;                // [n]
  uint32_t* col_best;         // [m] (dist<<16)|row, 0xffffffff = none; the
                              // ticket just before it (see match_kernel)
  // stereo modes: bf, the largest disparity (mode 4) and the outputs
  // (mode 4: u_R, depth; mode 5: both endpoint depths) and has
  float bf, max_disp;
  float* out0;
  float* out1;
  uint8_t* has;
  // mode 4: the rows' octaves [n] and the octave scale table; a row's
  // tolerance is row_tol * scale[octave], rounded to float32
  const int* a_oct;
  const float* oct_scale;
  float row_tol;
};

// Midpoint and length of segment i of ep [*,4] (reference order:
// (ep[:2] + ep[2:]) / 2 and sqrt(dx^2 + dy^2)).
__device__ __forceinline__ float2 seg_mid_len(const float2* ep, int i,
                                              float* len) {
  const float* e = reinterpret_cast<const float*>(ep) + 4 * i;
  const float dx = e[2] - e[0], dy = e[3] - e[1];
  *len = sqrtf(dx * dx + dy * dy);
  return make_float2((e[0] + e[2]) / 2.f, (e[1] + e[3]) / 2.f);
}

constexpr int kBatch = 8;           // rows of the epilogue a thread at once

// The epilogue of every row, once every row's (idx, ok) and every
// column's best row are in: the mutual check (the column's best row must
// be this row) and, in the stereo modes, the per-feature result.  A
// thread takes kBatch rows at once: their (ok, idx), then their columns'
// best rows and the stereo modes' positions, all loaded before any store.
__device__ void epilogue(const Params& p) {
  const bool stereo = p.line_mode >= 4;
  const float4* er4 = reinterpret_cast<const float4*>(p.b_xy);
  const float4* el4 = reinterpret_cast<const float4*>(p.a_xy);
  for (int r0 = threadIdx.x; r0 < p.n; r0 += kBatch * blockDim.x) {
    int j[kBatch];
    bool ok[kBatch];
    uint32_t best[kBatch];
    float4 er[kBatch], el[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int row = r0 + k * blockDim.x;
      ok[k] = row < p.n && __ldcg(p.ok + row) != 0;
      j[k] = row < p.n ? __ldcg(p.idx + row) : 0;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int row = r0 + k * blockDim.x;
      best[k] = ok[k] ? __ldcg(p.col_best + j[k]) : kNoBest;
      if (ok[k] && p.line_mode == 4) {
        er[k].x = p.b_xy[j[k]].x;
        el[k].x = p.a_xy[row].x;
      } else if (ok[k] && p.line_mode == 5) {
        er[k] = er4[j[k]];
        el[k] = el4[row];
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int row = r0 + k * blockDim.x;
      if (row >= p.n) continue;
      // the mutual check
      const bool mutual = ok[k] && (best[k] & 0xffffu) == uint32_t(row);
      if (!stereo) {
        if (ok[k]) p.ok[row] = mutual;
        continue;
      }
      p.ok[row] = mutual;
      if (!mutual) {             // no match: idx may name no column at all
        p.out0[row] = -1.f;
        p.out1[row] = -1.f;
        p.has[row] = 0;
        continue;
      }
      if (p.line_mode == 4) {
        const float u_r = er[k].x;
        const float d = el[k].x - u_r;
        const bool has = d > 0.1f;
        p.out0[row] = has ? u_r : -1.f;
        p.out1[row] = has ? p.bf / fmaxf(d, 1e-6f) : -1.f;
        p.has[row] = has;
        continue;
      }
      // er / el: the right / left segment (x0, y0, x1, y1)
      const float dy_r = er[k].w - er[k].y;
      const float slope = (er[k].z - er[k].x)
          / (fabsf(dy_r) < 1e-6f ? __int_as_float(0x7f800000) : dy_r);
      const float disp_s = el[k].x - (er[k].x + (el[k].y - er[k].y) * slope);
      const float disp_e = el[k].z - (er[k].x + (el[k].w - er[k].y) * slope);
      const bool horiz_l = fabsf(el[k].y - el[k].w) <= 0.1f;
      const bool horiz_r = fabsf(dy_r) <= 0.1f;
      const bool has = (disp_s >= 1.f) && (disp_e >= 1.f) && !horiz_l
                       && !horiz_r;
      p.out0[row] = has ? p.bf / fmaxf(disp_s, 1e-6f) : -1.f;
      p.out1[row] = has ? p.bf / fmaxf(disp_e, 1e-6f) : -1.f;
      p.has[row] = has;
    }
  }
}

// One launch a call.  A warp a row; the block's column minima in shared
// memory, then one global atomicMin for each column its rows touched;
// the last block to arrive (a ticket in ws[0], taken after a fence)
// applies the epilogue to every row, then resets the columns' minima and
// the ticket for the next call on this workspace.
__global__ void match_kernel(Params p) {
  extern __shared__ float4 smem_f4[];
  __shared__ int s_last;
  const bool pair = p.line_mode == 3;
  const bool slines = p.line_mode == 5;
  uint32_t* ticket = p.col_best - 1;
  // mode 5 keeps both endpoints of a column: two float2 a column
  float2* s_xy = reinterpret_cast<float2*>(smem_f4);
  uint32_t* s_best = reinterpret_cast<uint32_t*>(s_xy + (slines ? 2 * p.m
                                                                : p.m));
  float* s_ang = reinterpret_cast<float*>(s_best + p.m);
  float* s_len = s_ang + p.m;                      // mode 3 only
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(s_len + (pair ? p.m : 0));
  for (int j = threadIdx.x; j < p.m; j += blockDim.x) {
    if (pair) {
      s_xy[j] = seg_mid_len(p.b_xy, j, s_len + j);
    } else if (slines) {
      s_xy[2 * j] = p.b_xy[2 * j];
      s_xy[2 * j + 1] = p.b_xy[2 * j + 1];
    } else {
      s_xy[j] = p.b_xy[j];
    }
    s_ang[j] = (p.line_mode && p.line_mode != 4) ? p.b_ang[j] : 0.f;
    s_ok[j] = p.col_ok[j];
    s_best[j] = kNoBest;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  int b1 = kNone, i1 = 0, b2 = kNone;
  if (row < p.n && p.row_ok[row]) {
    uint32_t a[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) a[w] = p.map_desc[row * 8 + w];
    float alen = 0.f;
    const float2 axy = pair ? seg_mid_len(p.a_xy, row, &alen)
                            : p.a_xy[slines ? 2 * row : row];
    // the row's angle (modes 1, 3, 5) or its row tolerance (mode 4)
    const float aang = p.line_mode == 4
                           ? p.row_tol * p.oct_scale[p.a_oct[row]]
                           : (p.line_mode == 1 || p.line_mode == 3 ||
                              p.line_mode == 5) ? p.a_ang[row] : 0.f;
    // mode 5: the left segment's y-span and midpoint x
    float ylo_l = 0.f, yhi_l = 0.f, mid_l = 0.f, span_l = 1.f;
    if (slines) {
      const float2 e1 = p.a_xy[2 * row + 1];
      ylo_l = fminf(axy.y, e1.y);
      yhi_l = fmaxf(axy.y, e1.y);
      span_l = fmaxf(yhi_l - ylo_l, 1e-6f);
      mid_l = (axy.x + e1.x) * 0.5f;
    }
    float l0 = 0.f, l1 = 0.f, l2 = 0.f, den = 1.f;
    if (p.line_mode == 2) {
      l0 = (p.F[0] * axy.x + p.F[1] * axy.y) + p.F[2];
      l1 = (p.F[3] * axy.x + p.F[4] * axy.y) + p.F[5];
      l2 = (p.F[6] * axy.x + p.F[7] * axy.y) + p.F[8];
      den = fmaxf(sqrtf(l0 * l0 + l1 * l1), 1e-9f);
    }
    for (int j = lane; j < p.m; j += 32) {
      if (!s_ok[j]) continue;
      const float dx = axy.x - s_xy[j].x;
      const float dy = axy.y - s_xy[j].y;
      const float d2 = dx * dx + dy * dy;
      bool gate;
      if (p.line_mode == 2) {
        const float num = fabsf((l0 * s_xy[j].x + l1 * s_xy[j].y) + l2);
        gate = num / den < s_ang[j];
      } else if (pair) {
        float da = fmodf(fabsf(aang - s_ang[j]), PLVIO_PI_F);
        da = fminf(da, PLVIO_PI_F - da);
        const float lr = alen / fmaxf(s_len[j], 1e-6f);
        gate = (d2 < p.r2) && (da < p.ang_tol) && (lr > 0.5f) && (lr < 2.0f)
            && (alen > 40.f) && (s_len[j] > 40.f);
      } else if (p.line_mode == 4) {
        // dx is the disparity u_L - u_R, |dy| the row difference
        gate = (fabsf(dy) <= aang) && (dx > 0.1f) && (dx <= p.max_disp);
      } else if (slines) {
        const float2 r0 = s_xy[2 * j], r1 = s_xy[2 * j + 1];
        float da = fmodf(fabsf(aang - s_ang[j]), PLVIO_PI_F);
        da = fminf(da, PLVIO_PI_F - da);
        const float ylo_r = fminf(r0.y, r1.y), yhi_r = fmaxf(r0.y, r1.y);
        const float inter = fmaxf(0.f, fminf(yhi_l, yhi_r)
                                           - fmaxf(ylo_l, ylo_r));
        const float mid_r = (r0.x + r1.x) * 0.5f;
        gate = (da < p.ang_tol) && (inter / span_l > 0.75f)
            && (mid_r <= mid_l);
      } else if (p.line_mode) {
        // |a - b| % pi for a non-negative operand is fmod (jnp.remainder)
        float da = fmodf(fabsf(aang - s_ang[j]), PLVIO_PI_F);
        da = fminf(da, PLVIO_PI_F - da);
        gate = (d2 < p.r2) && (da < p.ang_tol);
      } else {
        gate = d2 <= p.r2;
      }
      if (!gate) continue;
      const uint32_t* b = p.obs_desc + j * 8;
      int d = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w) d += __popc(a[w] ^ b[w]);
      if (d < b1) {
        b2 = b1; b1 = d; i1 = j;
      } else if (d < b2) {
        b2 = d;
      }
      atomicMin(s_best + j, (uint32_t(d) << 16) | uint32_t(row));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob1 = __shfl_xor_sync(0xffffffffu, b1, off);
    const int oi1 = __shfl_xor_sync(0xffffffffu, i1, off);
    const int ob2 = __shfl_xor_sync(0xffffffffu, b2, off);
    const int hi = max(b1, ob1);
    b2 = min(min(b2, ob2), hi);
    if (ob1 < b1 || (ob1 == b1 && oi1 < i1)) { b1 = ob1; i1 = oi1; }
  }
  if (lane == 0 && row < p.n) {
    const float f1 = b1 >= kNone ? 1e9f : float(b1);
    const float f2 = b2 >= kNone ? 1e9f : float(b2);
    p.idx[row] = i1;
    p.ok[row] = (f1 <= p.max_dist) && (f1 < p.ratio * f2);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < p.m; j += blockDim.x)
    if (s_best[j] != kNoBest) atomicMin(p.col_best + j, s_best[j]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  epilogue(p);
  __syncthreads();
  for (int j = threadIdx.x; j < p.m; j += blockDim.x) p.col_best[j] = kNoBest;
  if (threadIdx.x == 0) *ticket = 0u;
}

// dist[i, j] = popcount(a_i ^ b_j): blocks of 32 x 8 threads over 32
// columns x 8 rows.
__global__ void hamming_matrix_kernel(const uint32_t* __restrict__ a,
                                      const uint32_t* __restrict__ b, int n,
                                      int m, float* __restrict__ dist) {
  __shared__ uint32_t cols[32][9];
  const int j0 = blockIdx.x * 32;
  for (int e = threadIdx.y * 32 + threadIdx.x; e < 32 * 8; e += 256) {
    const int jj = e >> 3, w = e & 7;
    cols[jj][w] = j0 + jj < m ? b[size_t(j0 + jj) * 8 + w] : 0u;
  }
  __syncthreads();
  const int i = blockIdx.y * 8 + threadIdx.y;
  const int j = j0 + threadIdx.x;
  if (i >= n || j >= m) return;
  int d = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w)
    d += __popc(a[size_t(i) * 8 + w] ^ cols[threadIdx.x][w]);
  dist[size_t(i) * m + j] = float(d);
}

// The launch of match_kernel; ws is the workspace [1 + capacity] uint32
// kept between calls on one stream: ws[0] the ticket (0), ws[1 + j] column
// j's best (0xffffffff); every call leaves it so.
int launch_match(const Params& p, void* ws, cudaStream_t s) {
  const size_t cols = size_t(p.m);
  const size_t smem = cols * ((p.line_mode == 5 ? 2 : 1) * sizeof(float2)
                              + 2 * sizeof(float) + 1
                              + (p.line_mode == 3 ? sizeof(float) : 0))
      + 16;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Params q = p;
  q.col_best = static_cast<uint32_t*>(ws) + 1;
  match_kernel<<<(p.n + kWarps - 1) / kWarps, kWarps * 32, smem, s>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

PLVIO_API int hamming_matrix(const void* a, const void* b, int n, int m,
                             void* dist, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((m + 31) / 32, (n + 7) / 8);
  hamming_matrix_kernel<<<grid, dim3(32, 8), 0, s>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b), n, m,
      static_cast<float*>(dist));
  return static_cast<int>(cudaGetLastError());
}

// ws: the workspace of launch_match (n > 0).
PLVIO_API int hamming_match(const void* map_desc, const void* obs_desc,
                            const void* row_ok, const void* col_ok,
                            const void* a_xy, const void* b_xy,
                            const void* a_ang, const void* b_ang,
                            const void* F, int n, int m, int line_mode,
                            float r2,
                            float ang_tol, float max_dist, float ratio,
                            void* idx, void* ok, void* ws,
                            void* stream) {
  Params p{static_cast<const uint32_t*>(map_desc),
           static_cast<const uint32_t*>(obs_desc),
           static_cast<const uint8_t*>(row_ok),
           static_cast<const uint8_t*>(col_ok),
           static_cast<const float2*>(a_xy), static_cast<const float2*>(b_xy),
           static_cast<const float*>(a_ang), static_cast<const float*>(b_ang),
           static_cast<const float*>(F), n, m, line_mode, r2, ang_tol, max_dist, ratio,
           static_cast<int*>(idx), static_cast<uint8_t*>(ok),
           nullptr, 0.f, 0.f, nullptr, nullptr, nullptr, nullptr, nullptr,
           0.f};
  return launch_match(p, ws, static_cast<cudaStream_t>(stream));
}

// The rectified pair's matchers: mode 4 (points: a_xy / b_xy [n] / [m]
// pixels, a_ang the left octaves int32 [n], b_ang the octave scale table
// float32, a row's tolerance row_tol * scale[octave], lim the largest
// disparity; out0 u_R, out1 depth) or mode 5 (segments: a_xy / b_xy [n,4]
// / [m,4] endpoints, a_ang / b_ang their angles, lim the angle tolerance;
// out0 / out1 the endpoint depths).  idx and ok are scratch, ws the
// workspace of launch_match.
PLVIO_API int stereo_match(const void* desc_l, const void* desc_r,
                           const void* valid_l, const void* valid_r,
                           const void* a_xy, const void* b_xy,
                           const void* a_ang, const void* b_ang, int n, int m,
                           int mode, float lim, float bf, float max_dist,
                           float ratio, float row_tol, void* idx, void* ok,
                           void* ws, void* out0, void* out1, void* has,
                           void* stream) {
  if (mode != 4 && mode != 5) return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const uint32_t*>(desc_l),
           static_cast<const uint32_t*>(desc_r),
           static_cast<const uint8_t*>(valid_l),
           static_cast<const uint8_t*>(valid_r),
           static_cast<const float2*>(a_xy), static_cast<const float2*>(b_xy),
           mode == 5 ? static_cast<const float*>(a_ang) : nullptr,
           mode == 5 ? static_cast<const float*>(b_ang) : nullptr,
           nullptr, n, m, mode, 0.f, mode == 5 ? lim : 0.f, max_dist, ratio,
           static_cast<int*>(idx), static_cast<uint8_t*>(ok),
           nullptr, bf, mode == 4 ? lim : 0.f,
           static_cast<float*>(out0), static_cast<float*>(out1),
           static_cast<uint8_t*>(has),
           mode == 4 ? static_cast<const int*>(a_ang) : nullptr,
           mode == 4 ? static_cast<const float*>(b_ang) : nullptr, row_tol};
  return launch_match(p, ws, static_cast<cudaStream_t>(stream));
}
