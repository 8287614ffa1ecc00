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
// column-wise argmin of the mutual check is an atomicMin on (dist<<16)|row,
// which gives the first row among equal distances, as argmin(axis=0) does
// (:90); a second small kernel applies it once every row is done.  A row
// with no admissible column returns idx 0 and ok false, as the JAX does.
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
  int n, m, line_mode;        // 0 window, 1 line, 2 epipolar, 3 pair
  float r2, ang_tol, max_dist, ratio;
  int* idx;                   // [n]
  uint8_t* ok;                // [n]
  uint32_t* col_best;         // [m] (dist<<16)|row, 0xffffffff = none
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

__global__ void match_rows(Params p) {
  extern __shared__ float4 smem_f4[];
  const bool pair = p.line_mode == 3;
  float2* s_xy = reinterpret_cast<float2*>(smem_f4);
  float* s_ang = reinterpret_cast<float*>(s_xy + p.m);
  float* s_len = s_ang + p.m;                      // mode 3 only
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(s_len + (pair ? p.m : 0));
  for (int j = threadIdx.x; j < p.m; j += blockDim.x) {
    if (pair)
      s_xy[j] = seg_mid_len(p.b_xy, j, s_len + j);
    else
      s_xy[j] = p.b_xy[j];
    s_ang[j] = p.line_mode ? p.b_ang[j] : 0.f;
    s_ok[j] = p.col_ok[j];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= p.n) return;

  int b1 = kNone, i1 = 0, b2 = kNone;
  if (p.row_ok[row]) {
    uint32_t a[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) a[w] = p.map_desc[row * 8 + w];
    float alen = 0.f;
    const float2 axy = pair ? seg_mid_len(p.a_xy, row, &alen) : p.a_xy[row];
    const float aang = (p.line_mode == 1 || pair) ? p.a_ang[row] : 0.f;
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
      atomicMin(p.col_best + j, (uint32_t(d) << 16) | uint32_t(row));
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
  if (lane == 0) {
    const float f1 = b1 >= kNone ? 1e9f : float(b1);
    const float f2 = b2 >= kNone ? 1e9f : float(b2);
    p.idx[row] = i1;
    p.ok[row] = (f1 <= p.max_dist) && (f1 < p.ratio * f2);
  }
}

__global__ void mutual_check(Params p) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= p.n || !p.ok[row]) return;
  p.ok[row] = (p.col_best[p.idx[row]] & 0xffffu) == uint32_t(row);
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

PLVIO_API int hamming_match(const void* map_desc, const void* obs_desc,
                            const void* row_ok, const void* col_ok,
                            const void* a_xy, const void* b_xy,
                            const void* a_ang, const void* b_ang,
                            const void* F, int n, int m, int line_mode,
                            float r2,
                            float ang_tol, float max_dist, float ratio,
                            void* idx, void* ok, void* col_best,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p{static_cast<const uint32_t*>(map_desc),
           static_cast<const uint32_t*>(obs_desc),
           static_cast<const uint8_t*>(row_ok),
           static_cast<const uint8_t*>(col_ok),
           static_cast<const float2*>(a_xy), static_cast<const float2*>(b_xy),
           static_cast<const float*>(a_ang), static_cast<const float*>(b_ang),
           static_cast<const float*>(F), n, m, line_mode, r2, ang_tol, max_dist, ratio,
           static_cast<int*>(idx), static_cast<uint8_t*>(ok),
           static_cast<uint32_t*>(col_best)};
  cudaMemsetAsync(col_best, 0xff, size_t(m > 0 ? m : 1) * 4, s);
  const size_t smem = size_t(m) * (sizeof(float2) + sizeof(float) + 1
                                    + (line_mode == 3 ? sizeof(float) : 0))
      + 16;
  match_rows<<<(n + kWarps - 1) / kWarps, kWarps * 32, smem, s>>>(p);
  mutual_check<<<(n + 255) / 256, 256, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
