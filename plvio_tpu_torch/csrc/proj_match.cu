// proj_match — map points projected into a frame and matched to its
// features: the image gate, the tracker's optional frustum gates, an
// octave-scaled window, Hamming NN with ratio test and mutual check, and
// each feature's back map to its point.
//
// Replaces plvio_tpu/models/kernels.py `make_projection_matcher` (:767),
// as the keyframe fuse (`LocalMapper._fuse_into`, radius 2, max 50) and
// the production tracker (`models/tracking.py:919-933`, frustum gates,
// radius 6, max 80) call it.  The JAX version unpacks descriptors to +-1
// and forms the P x F Hamming matrix as a matmul, the P x F window gate,
// then the dense match_nn_ratio and a scatter for the back map.
//
// What bounds it on the H100: very little work.  At the path's shapes
// (2048 points x 1000 features) it reads ~150 KB; the window (2 px * 1.2^oct)
// leaves a few columns per row, so the 2M gate tests (~8 flops each) and
// launch latency bound it, not the 2048*1000*8 XOR + popc of the full
// matrix, which the gate skips.
//
// Design: one warp per map point.  Thread 0 of each block computes the
// camera centre C = -R^T t once (the frustum gates); the block stages the
// columns' positions, validity and squared windows (r * 1.2^oct)^2 in
// shared memory, with 1.2^oct from an 8-entry table passed by the caller
// (models/kernels.py OCTAVE_SCALE: the reference's float32 power, which
// powf might miss by an ulp).  Every lane computes the row's projection and
// gates in registers, in the order of `project_gates` (each 3-vector
// product summed as (x0 y0 + x1 y1) + x2 y2), then walks its columns: the
// window first, then XOR and __popc of the 8 packed words, keeping
// (best1, idx1, best2) with strict '<' (the first column on ties) and
// merging lanes by shuffles, as csrc/hamming_match.cu does.  The column
// argmin of the mutual check is an atomicMin on (dist << 16) | row (the
// first row on ties, as argmin(axis=0)).  A second kernel, one block,
// applies the mutual check, writes uv_m and pt_feat, and the back map
// feat_pt under the reference's last-write-wins rule for duplicate scatter
// indices: each feature's writer is the highest row whose index (idx where
// matched, 0 otherwise) points at it, found by an integer atomicMax in
// shared memory, so the result does not depend on the order the threads
// run in.
//
// The KB8 mode (kb8 = 1) replaces `make_projection_matcher_kb8` (:1443),
// the fisheye tracker's and fuse's matcher: the projection goes through
// the equidistant model onto raw pixels, r = sqrt(max(x^2 + y^2, 1e-18)),
// theta = atan2(r, max(z, 1e-6)), theta_d = theta (1 + k1 t2 + k2 t2^2 +
// k3 t2^3 + k4 t2^4) with jnp's powers (t2^3 = t2 (t2 t2), t2^4 = (t2 t2)
// (t2 t2)), u = fx x theta_d / r + cx; the same image gate [0, 2 cx) x
// [0, 2 cy); the range gate only (the reference's fisheye matcher has no
// viewing-angle gate).  The pinhole mode's arithmetic is unchanged.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kNone = 1 << 20;      // larger than any 256-bit distance
constexpr int kFinishThreads = 1024;

struct Params {
  const float* pose;          // [12] T_cw, row-major [3,4]
  const float* pt_xyz;        // [P,3]
  const uint32_t* pt_desc;    // [P,8]
  const uint8_t* pt_valid;    // [P]
  const float* pt_normal;     // [P,3] (frustum mode 2)
  const float* pt_min_dist;   // [P]   (frustum modes 1, 2)
  const float* pt_max_dist;   // [P]
  const float2* feat_uv;      // [F]
  const uint32_t* feat_desc;  // [F,8]
  const int* feat_octave;     // [F]
  const uint8_t* feat_valid;  // [F]
  int P, F, frustum;          // frustum: 0 none, 1 range, 2 range + angle
  float fx, fy, cx, cy, w_lim, h_lim, radius, max_dist, ratio;
  float scale[8];             // 1.2^octave
  int kb8;                    // 1: the KB8 projection with k1..k4
  float k1, k2, k3, k4;
  float2* uv_m;               // [P]
  int* pt_feat;               // [P]
  uint8_t* matched;           // [P]
  int* feat_pt;               // [F]
  uint32_t* col_best;         // [F] (dist<<16)|row, 0xffffffff = none
};

__global__ void match_points(Params p) {
  extern __shared__ float4 smem_f4[];
  float2* s_uv = reinterpret_cast<float2*>(smem_f4);
  float* s_thr = reinterpret_cast<float*>(s_uv + p.F);
  float* s_C = s_thr + p.F;                               // [3]
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(s_C + 4);
  const float* R = p.pose;
  if (threadIdx.x == 0) {                                 // C = -R^T t
    for (int c = 0; c < 3; ++c)
      s_C[c] = -((R[c] * R[3] + R[4 + c] * R[7]) + R[8 + c] * R[11]);
  }
  for (int j = threadIdx.x; j < p.F; j += blockDim.x) {
    s_uv[j] = p.feat_uv[j];
    const int o = min(max(p.feat_octave[j], 0), 7);
    const float r = p.radius * p.scale[o];
    s_thr[j] = r * r;
    s_ok[j] = p.feat_valid[j];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= p.P) return;

  const float x = p.pt_xyz[3 * row], y = p.pt_xyz[3 * row + 1],
              zw = p.pt_xyz[3 * row + 2];
  float pc[3];
  for (int i = 0; i < 3; ++i)
    pc[i] = ((R[4 * i] * x + R[4 * i + 1] * y) + R[4 * i + 2] * zw)
        + R[4 * i + 3];
  const float z = pc[2];
  float u, v;
  if (p.kb8) {
    const float r = sqrtf(fmaxf(pc[0] * pc[0] + pc[1] * pc[1], 1e-18f));
    const float th = atan2f(r, fmaxf(z, 1e-6f));
    const float t2 = th * th;
    const float q2 = t2 * t2;
    const float td = th * ((((1.0f + p.k1 * t2) + p.k2 * q2)
                            + p.k3 * (t2 * q2)) + p.k4 * (q2 * q2));
    const float s = td / r;
    u = p.fx * pc[0] * s + p.cx;
    v = p.fy * pc[1] * s + p.cy;
  } else {
    const float zc = fmaxf(z, 1e-6f);
    u = p.fx * pc[0] / zc + p.cx;
    v = p.fy * pc[1] / zc + p.cy;
  }
  bool ok = p.pt_valid[row] && z > 0.05f && u >= 0.f && u < p.w_lim
      && v >= 0.f && v < p.h_lim;
  if (p.frustum) {
    const float vx = x - s_C[0], vy = y - s_C[1], vz = zw - s_C[2];
    const float d_cam = sqrtf((vx * vx + vy * vy) + vz * vz);
    const float mn = p.pt_min_dist[row], mx = p.pt_max_dist[row];
    ok = ok && (!(mx > 1e-6f) || (d_cam > 0.8f * mn && d_cam < 1.2f * mx));
    if (p.frustum == 2) {
      const float nx = p.pt_normal[3 * row], ny = p.pt_normal[3 * row + 1],
                  nz = p.pt_normal[3 * row + 2];
      const float nn = sqrtf((nx * nx + ny * ny) + nz * nz);
      const float cos_v = ((vx * nx + vy * ny) + vz * nz)
          / fmaxf(d_cam * nn, 1e-9f);
      ok = ok && (!(nn > 1e-6f) || cos_v > 0.5f);
    }
  }

  int b1 = kNone, i1 = 0, b2 = kNone;
  if (ok) {
    uint32_t a[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) a[w] = p.pt_desc[row * 8 + w];
    for (int j = lane; j < p.F; j += 32) {
      if (!s_ok[j]) continue;
      const float dx = u - s_uv[j].x;
      const float dy = v - s_uv[j].y;
      if (!(dx * dx + dy * dy <= s_thr[j])) continue;
      const uint32_t* b = p.feat_desc + j * 8;
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
    p.pt_feat[row] = i1;
    p.matched[row] = (f1 <= p.max_dist) && (f1 < p.ratio * f2);
  }
}

// One block: the mutual check, uv_m, and the back map feat_pt.
__global__ void finish(Params p) {
  extern __shared__ int s_last[];                 // [F] highest writer row
  for (int f = threadIdx.x; f < p.F; f += blockDim.x) s_last[f] = -1;
  __syncthreads();
  for (int r = threadIdx.x; r < p.P; r += blockDim.x) {
    const int j = p.pt_feat[r];
    const bool ok = p.matched[r]
        && (p.col_best[j] & 0xffffu) == uint32_t(r);
    p.matched[r] = ok;
    p.uv_m[r] = p.feat_uv[j];
    atomicMax(s_last + (ok ? j : 0), r);
  }
  __syncthreads();
  for (int f = threadIdx.x; f < p.F; f += blockDim.x) {
    const int r = s_last[f];
    p.feat_pt[f] = (r >= 0 && p.matched[r]) ? r : -1;
  }
}

}  // namespace

PLVIO_API int proj_match(const void* pose, const void* pt_xyz,
                         const void* pt_desc, const void* pt_valid,
                         const void* pt_normal, const void* pt_min_dist,
                         const void* pt_max_dist, const void* feat_uv,
                         const void* feat_desc, const void* feat_octave,
                         const void* feat_valid, int P, int F, int frustum,
                         float fx, float fy, float cx, float cy, float w_lim,
                         float h_lim, float radius, float max_dist,
                         float ratio, float s0, float s1, float s2, float s3,
                         float s4, float s5, float s6, float s7, int kb8,
                         float k1, float k2, float k3, float k4, void* uv_m,
                         void* pt_feat, void* matched, void* feat_pt,
                         void* col_best, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p{static_cast<const float*>(pose), static_cast<const float*>(pt_xyz),
           static_cast<const uint32_t*>(pt_desc),
           static_cast<const uint8_t*>(pt_valid),
           static_cast<const float*>(pt_normal),
           static_cast<const float*>(pt_min_dist),
           static_cast<const float*>(pt_max_dist),
           static_cast<const float2*>(feat_uv),
           static_cast<const uint32_t*>(feat_desc),
           static_cast<const int*>(feat_octave),
           static_cast<const uint8_t*>(feat_valid), P, F, frustum, fx, fy, cx,
           cy, w_lim, h_lim, radius, max_dist, ratio,
           {s0, s1, s2, s3, s4, s5, s6, s7}, kb8, k1, k2, k3, k4,
           static_cast<float2*>(uv_m),
           static_cast<int*>(pt_feat), static_cast<uint8_t*>(matched),
           static_cast<int*>(feat_pt), static_cast<uint32_t*>(col_best)};
  if (P <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  cudaMemsetAsync(col_best, 0xff, size_t(F) * 4, s);
  const size_t smem = size_t(F) * (sizeof(float2) + sizeof(float) + 1)
      + 4 * sizeof(float) + 16;
  match_points<<<(P + kWarps - 1) / kWarps, kWarps * 32, smem, s>>>(p);
  finish<<<1, kFinishThreads, size_t(F) * sizeof(int), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
