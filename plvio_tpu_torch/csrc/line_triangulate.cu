// line_triangulate — map lines from segment pairs matched between two
// keyframes, by interpretation-plane intersection, with the depth,
// finiteness, plane-angle, agreement, perpendicular-distance and length
// gates.
//
// Replaces plvio_tpu/models/kernels.py `make_line_triangulator` (:389).
// The JAX version evaluates the four ray-plane intersections and every gate
// as [N, 3] array expressions with small matmuls against the rotations.
//
// What bounds it on the H100: launch latency.  At the keyframe step's 256
// pairs it reads ~9 KB and writes ~7 KB, and the arithmetic (~400 flops a
// pair) is ~0.1 Mflop: well under a microsecond at the card's rates.
//
// Design: one thread per pair, everything in registers; the two camera
// centres are recomputed per thread from the poses (a few flops).  Every
// expression follows `line_triangulate_plain` (models/kernels.py) in order:
// each 3-vector product is summed as (x0 y0 + x1 y1) + x2 y2, the norms as
// sqrt((x0^2 + x1^2) + x2^2), and the reference's guard that replaces a
// denominator below 1e-9 in magnitude by +1e-9 (so a tiny negative one
// becomes positive) is kept as it is.  With --fmad=false the kernel and
// the plain version agree bit for bit where their operations agree.
#include "common.cuh"

namespace {

struct Params {
  const float* pose1;     // [12] T_cw of KF 1 (the neighbour), row-major
  const float* pose2;     // [12] T_cw of KF 2 (the new keyframe)
  const float* ep1;       // [n,4] (xs, ys, xe, ye)
  const float* ep2;       // [n,4]
  const uint8_t* valid;   // [n]
  int n;
  float fx, fy, cx, cy, max_depth;
  float* Xs;              // [n,3]
  float* Xe;              // [n,3]
  uint8_t* good;          // [n]
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}

__device__ __forceinline__ float norm3(V3 a) {
  return sqrtf((a.x * a.x + a.y * a.y) + a.z * a.z);
}

__device__ __forceinline__ V3 sub3(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

// Row vector x times R ([3][3] of a row-major [3,4] pose).
__device__ __forceinline__ V3 times_R(V3 x, const float* P) {
  return {(x.x * P[0] + x.y * P[4]) + x.z * P[8],
          (x.x * P[1] + x.y * P[5]) + x.z * P[9],
          (x.x * P[2] + x.y * P[6]) + x.z * P[10]};
}

// -R^T t
__device__ __forceinline__ V3 centre(const float* P) {
  return {-((P[0] * P[3] + P[4] * P[7]) + P[8] * P[11]),
          -((P[1] * P[3] + P[5] * P[7]) + P[9] * P[11]),
          -((P[2] * P[3] + P[6] * P[7]) + P[10] * P[11])};
}

__device__ __forceinline__ V3 normalized(const Params& p, float u, float v) {
  return {(u - p.cx) / p.fx, (v - p.cy) / p.fy, 1.f};
}

// Normal (world) of the plane through the camera and the segment e.
__device__ __forceinline__ V3 plane_n(const Params& p, const float* P,
                                      const float* e) {
  const V3 rs = normalized(p, e[0], e[1]), re = normalized(p, e[2], e[3]);
  return times_R({rs.y * re.z - rs.z * re.y, rs.z * re.x - rs.x * re.z,
                  rs.x * re.y - rs.y * re.x}, P);
}

__device__ __forceinline__ V3 intersect(V3 Cf, V3 d, V3 n, V3 Con) {
  const float denom = dot3(n, d);
  const float tt = dot3(n, sub3(Con, Cf))
      / (fabsf(denom) < 1e-9f ? 1e-9f : denom);
  return {Cf.x + tt * d.x, Cf.y + tt * d.y, Cf.z + tt * d.z};
}

// Depth of X in the camera of pose P.
__device__ __forceinline__ float depth(const float* P, V3 X) {
  return ((X.x * P[8] + X.y * P[9]) + X.z * P[10]) + P[11];
}

__device__ __forceinline__ V3 unit(V3 a) {
  const float nrm = fmaxf(norm3(a), 1e-9f);
  return {a.x / nrm, a.y / nrm, a.z / nrm};
}

__device__ __forceinline__ bool finite3(V3 a) {
  return isfinite(a.x) && isfinite(a.y) && isfinite(a.z);
}

__global__ void line_triangulate_kernel(Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  float P1[12], P2[12];
  for (int k = 0; k < 12; ++k) {
    P1[k] = p.pose1[k];
    P2[k] = p.pose2[k];
  }
  const V3 C1 = centre(P1), C2 = centre(P2);
  const float* e1 = p.ep1 + 4 * i;
  const float* e2 = p.ep2 + 4 * i;
  const V3 n2 = plane_n(p, P2, e2);
  const V3 XsA = intersect(C1, times_R(normalized(p, e1[0], e1[1]), P1), n2,
                           C2);
  const V3 XeA = intersect(C1, times_R(normalized(p, e1[2], e1[3]), P1), n2,
                           C2);
  const V3 n1 = plane_n(p, P1, e1);
  const V3 XsB = intersect(C2, times_R(normalized(p, e2[0], e2[1]), P2), n1,
                           C1);
  const V3 XeB = intersect(C2, times_R(normalized(p, e2[2], e2[3]), P2), n1,
                           C1);

  bool good = p.valid[i];
  const V3 X4[4] = {XsA, XeA, XsB, XeB};
  for (int k = 0; k < 4; ++k) {
    const float za = depth(P1, X4[k]), zb = depth(P2, X4[k]);
    good = good && za > 0.05f && zb > 0.05f && za < p.max_depth
        && zb < p.max_depth;
  }
  for (int k = 0; k < 4; ++k) good = good && finite3(X4[k]);
  good = good && fabsf(dot3(unit(n1), unit(n2))) < 0.99995f;
  const V3 uA = unit(sub3(XeA, XsA)), uB = unit(sub3(XeB, XsB));
  good = good && fabsf(dot3(uA, uB)) > 0.996f;
  const float scale = fmaxf(depth(P1, {(XsA.x + XeA.x) / 2.f,
                                       (XsA.y + XeA.y) / 2.f,
                                       (XsA.z + XeA.z) / 2.f}), 0.1f);
  const float tol = 0.02f * scale;
  for (int k = 2; k < 4; ++k) {
    const V3 v = sub3(X4[k], XsA);
    const float s = dot3(v, uA);
    good = good && norm3({v.x - s * uA.x, v.y - s * uA.y, v.z - s * uA.z})
        < tol;
  }
  const float seg = norm3(sub3(XeA, XsA));
  good = good && seg > 0.05f && seg < 20.f;
  p.Xs[3 * i] = XsA.x;
  p.Xs[3 * i + 1] = XsA.y;
  p.Xs[3 * i + 2] = XsA.z;
  p.Xe[3 * i] = XeA.x;
  p.Xe[3 * i + 1] = XeA.y;
  p.Xe[3 * i + 2] = XeA.z;
  p.good[i] = good;
}

}  // namespace

PLVIO_API int line_triangulate(const void* pose1, const void* pose2,
                               const void* ep1, const void* ep2,
                               const void* valid, int n, float fx, float fy,
                               float cx, float cy, float max_depth, void* Xs,
                               void* Xe, void* good, void* stream) {
  Params p{static_cast<const float*>(pose1), static_cast<const float*>(pose2),
           static_cast<const float*>(ep1), static_cast<const float*>(ep2),
           static_cast<const uint8_t*>(valid), n, fx, fy, cx, cy, max_depth,
           static_cast<float*>(Xs), static_cast<float*>(Xe),
           static_cast<uint8_t*>(good)};
  if (n > 0)
    line_triangulate_kernel<<<(n + 127) / 128, 128, 0,
                              static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
