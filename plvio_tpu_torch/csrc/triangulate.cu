// triangulate — DLT triangulation of matched feature pairs between two
// keyframes, with the depth, parallax and reprojection gates.
//
// Replaces plvio_tpu/models/kernels.py `make_triangulator` (:878) and the
// batched DLT it calls, plvio_tpu/ops/twoview.py `triangulate_dlt` (:146).
// The JAX version builds one 4x4 system per pair and takes the last right
// singular vector from a batched jnp.linalg.svd, then evaluates the gates
// as [N] array expressions.
//
// What bounds it on the H100: launch latency.  At the mapping step's 1024
// pairs it reads ~25 KB and writes ~17 KB, and the arithmetic (~3k flops a
// pair, in float64 for the eigen-solve) is ~3 Mflop: microseconds at the
// card's rates either way.
//
// Design: one thread per pair, everything in registers.  The null vector
// of A (4x4) is the eigenvector of the smallest eigenvalue of A^T A, found
// by cyclic Jacobi rotations in float64: the normal equations square the
// condition number, so float32 would lose the null vector of a
// low-parallax pair, and float64 keeps ~16 digits for the ~7 it needs.  The
// sign of the vector cancels in the dehomogenization (with the reference's
// 1e-12 guard).  The gates follow the reference's float32 expressions in
// order.
#include "common.cuh"
#include "linalg.cuh"

namespace {

struct Params {
  const float* pose1;     // [12] T_cw of KF 1, row-major [3,4]
  const float* pose2;     // [12]
  const float2* uv1;      // [n]
  const float2* uv2;      // [n]
  const uint8_t* valid;   // [n]
  const float* th1;       // [n] reprojection gates (chi2 px^2)
  const float* th2;       // [n]
  int n;
  float fx, fy, cx, cy, min_parallax_cos;
  float* Xw;              // [n,3]
  uint8_t* good;          // [n]
};

__global__ void triangulate_kernel(Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  float R1[3][3], t1[3], R2[3][3], t2[3], R21[3][3], t21[3];
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) {
      R1[r][c] = p.pose1[r * 4 + c];
      R2[r][c] = p.pose2[r * 4 + c];
    }
    t1[r] = p.pose1[r * 4 + 3];
    t2[r] = p.pose2[r * 4 + 3];
  }
  for (int r = 0; r < 3; ++r)       // R21 = R2 R1^T, t21 = t2 - R21 t1
    for (int c = 0; c < 3; ++c)
      R21[r][c] = (R2[r][0] * R1[c][0] + R2[r][1] * R1[c][1])
          + R2[r][2] * R1[c][2];
  for (int r = 0; r < 3; ++r)
    t21[r] = t2[r] - ((R21[r][0] * t1[0] + R21[r][1] * t1[1])
                      + R21[r][2] * t1[2]);
  const float2 a = p.uv1[i], b = p.uv2[i];
  const float x1 = (a.x - p.cx) / p.fx, y1 = (a.y - p.cy) / p.fy;
  const float x2 = (b.x - p.cx) / p.fx, y2 = (b.y - p.cy) / p.fy;
  double A[4][4] = {
      {-1.0, 0.0, double(x1), 0.0},
      {0.0, -1.0, double(y1), 0.0},
      {double(x2 * R21[2][0] - R21[0][0]), double(x2 * R21[2][1] - R21[0][1]),
       double(x2 * R21[2][2] - R21[0][2]), double(x2 * t21[2] - t21[0])},
      {double(y2 * R21[2][0] - R21[1][0]), double(y2 * R21[2][1] - R21[1][1]),
       double(y2 * R21[2][2] - R21[1][2]), double(y2 * t21[2] - t21[1])}};
  double S[4][4];
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) {
      double s = 0.0;
      for (int k = 0; k < 4; ++k) s += A[k][r] * A[k][c];
      S[r][c] = s;
    }
  double v[4];
  jacobi_null4(S, v);
  float w = float(v[3]);
  if (fabsf(w) < 1e-12f) w = 1e-12f;
  const float X1[3] = {float(v[0]) / w, float(v[1]) / w, float(v[2]) / w};
  float X2[3];
  for (int r = 0; r < 3; ++r)
    X2[r] = ((R21[r][0] * X1[0] + R21[r][1] * X1[1]) + R21[r][2] * X1[2])
        + t21[r];
  const float z1 = X1[2], z2 = X2[2];
  float C2[3];                      // -R21^T t21
  for (int c = 0; c < 3; ++c)
    C2[c] = -((R21[0][c] * t21[0] + R21[1][c] * t21[1]) + R21[2][c] * t21[2]);
  const float n1 = fmaxf(sqrtf(X1[0] * X1[0] + X1[1] * X1[1] + X1[2] * X1[2]),
                         1e-9f);
  const float d2[3] = {X1[0] - C2[0], X1[1] - C2[1], X1[2] - C2[2]};
  const float n2 = fmaxf(sqrtf(d2[0] * d2[0] + d2[1] * d2[1] + d2[2] * d2[2]),
                         1e-9f);
  const float cosp = X1[0] / n1 * (d2[0] / n2) + X1[1] / n1 * (d2[1] / n2)
      + X1[2] / n1 * (d2[2] / n2);
  const float zc1 = fmaxf(z1, 1e-9f), zc2 = fmaxf(z2, 1e-9f);
  const float e1u = p.fx * X1[0] / zc1 + p.cx - a.x;
  const float e1v = p.fy * X1[1] / zc1 + p.cy - a.y;
  const float e2u = p.fx * X2[0] / zc2 + p.cx - b.x;
  const float e2v = p.fy * X2[1] / zc2 + p.cy - b.y;
  const float e1 = e1u * e1u + e1v * e1v, e2 = e2u * e2u + e2v * e2v;
  const bool finite = isfinite(X1[0]) && isfinite(X1[1]) && isfinite(X1[2]);
  p.good[i] = p.valid[i] && z1 > 0.02f && z2 > 0.02f
      && cosp < p.min_parallax_cos && e1 < p.th1[i] && e2 < p.th2[i]
      && finite;
  const float d[3] = {X1[0] - t1[0], X1[1] - t1[1], X1[2] - t1[2]};
  for (int c = 0; c < 3; ++c)       // R1^T (X1 - t1)
    p.Xw[i * 3 + c] = (R1[0][c] * d[0] + R1[1][c] * d[1]) + R1[2][c] * d[2];
}

}  // namespace

PLVIO_API int triangulate(const void* pose1, const void* pose2,
                          const void* uv1, const void* uv2, const void* valid,
                          const void* th1, const void* th2, int n, float fx,
                          float fy, float cx, float cy,
                          float min_parallax_cos, void* Xw, void* good,
                          void* stream) {
  Params p{static_cast<const float*>(pose1), static_cast<const float*>(pose2),
           static_cast<const float2*>(uv1), static_cast<const float2*>(uv2),
           static_cast<const uint8_t*>(valid), static_cast<const float*>(th1),
           static_cast<const float*>(th2), n, fx, fy, cx, cy,
           min_parallax_cos, static_cast<float*>(Xw),
           static_cast<uint8_t*>(good)};
  if (n > 0)
    triangulate_kernel<<<(n + 127) / 128, 128, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
