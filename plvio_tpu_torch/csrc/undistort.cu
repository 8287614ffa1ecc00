// undistort — the pinhole camera's rad-tan inverse on a frame's keypoints
// and both endpoints of its line segments, with the segments' new line
// equations, in one launch.
//
// Replaces plvio_tpu/ops/cameras.py `undistort_radtan` (:86) through
// `undistort_pixels` (:117), which System.track_monocular runs on every
// frame's keypoints and line endpoints (models/system.py:165, 320-321),
// and the `line_equation` of the undistorted segments that follows it
// (:322, plvio_tpu/ops/lines.py:504).
// The JAX version is a lax.scan of 8 Newton steps over [N,2] arrays; XLA
// gives each step a handful of fused elementwise ops.
//
// What bounds it on the H100: launch latency.  A frame has 1000 keypoints
// and 2 x 256 endpoints: ~12 KB read, ~12 KB written and ~80 flops a
// point per Newton step (~1 Mflop in all), microseconds at the card's
// rates.
//
// The KB8 mode (kb8 = 1) replaces `kb8_unproject` (:170) through
// `kb8_undistort_pixels` (:192), which the fisheye System runs on every
// frame's keypoints and, with lines (slice 13, models/system.py:318-321),
// on both endpoints of its segments before their new line equations: 10
// Newton steps of theta_d(theta) = |m| from
// theta = |m|, each divided by max(df, 1e-6), then m tan(theta) / |m|
// back to pixels; the polynomial's powers and sums in the reference's
// order (t2^3 = t2 (t2 t2), t2^4 = (t2 t2)(t2 t2)).
//
// Design: one thread per keypoint and one per segment (both endpoints,
// then the normalized cross product of the two), the 8 Newton steps in
// registers.  Each step keeps the reference's float32 operation order
// (:94-108), including the |det| < 1e-9 guard; built with --fmad=false,
// it rounds as the plain PyTorch version does.
#include "common.cuh"

namespace {

struct Params {
  const float* kp;   // [n,2] raw pixels
  const float* ep;   // [l,4] raw segment endpoints (x0, y0, x1, y1)
  int n, l;
  float fx, fy, cx, cy, k1, k2, p1, p2;   // kb8: k1..k4 in these four
  int kb8;
  float* kp_out;     // [n,2] undistorted pixels
  float* ep_out;     // [l,4]
  float* lineq;      // [l,3] (a, b, c) of the undistorted segment, |(a,b)| = 1
};

__device__ void undistort_one(const Params& p, float u, float v, float* uo,
                              float* vo) {
  const float xd = (u - p.cx) / p.fx;
  const float yd = (v - p.cy) / p.fy;
  const float k1 = p.k1, k2 = p.k2, p1 = p.p1, p2 = p.p2;
  float x = xd, y = yd;
  for (int it = 0; it < 8; ++it) {
    const float r2 = x * x + y * y;
    const float radial = 1.0f + k1 * r2 + k2 * r2 * r2;
    const float fx_ = x * radial + 2.0f * p1 * x * y
        + p2 * (r2 + 2.0f * x * x) - xd;
    const float fy_ = y * radial + p1 * (r2 + 2.0f * y * y)
        + 2.0f * p2 * x * y - yd;
    const float dr_dr2 = k1 + 2.0f * k2 * r2;
    const float j00 = radial + x * dr_dr2 * 2.0f * x + 2.0f * p1 * y
        + 6.0f * p2 * x;
    const float j01 = x * dr_dr2 * 2.0f * y + 2.0f * p1 * x + 2.0f * p2 * y;
    const float j10 = y * dr_dr2 * 2.0f * x + 2.0f * p1 * x + 2.0f * p2 * y;
    const float j11 = radial + y * dr_dr2 * 2.0f * y + 6.0f * p1 * y
        + 2.0f * p2 * x;
    float det = j00 * j11 - j01 * j10;
    if (fabsf(det) < 1e-9f) det = 1e-9f;
    const float dx = (j11 * fx_ - j01 * fy_) / det;
    const float dy = (-j10 * fx_ + j00 * fy_) / det;
    x = x - dx;
    y = y - dy;
  }
  *uo = p.fx * x + p.cx;
  *vo = p.fy * y + p.cy;
}

// KB8: raw pixel -> undistorted pixel through the unit-depth ray
__device__ void undistort_kb8(const Params& p, float u, float v, float* uo,
                              float* vo) {
  const float mx = (u - p.cx) / p.fx;
  const float my = (v - p.cy) / p.fy;
  const float theta_d = sqrtf(fmaxf(mx * mx + my * my, 1e-18f));
  const float c1 = 3.0f * p.k1, c2 = 5.0f * p.k2, c3 = 7.0f * p.p1,
              c4 = 9.0f * p.p2;
  float theta = theta_d;
  for (int it = 0; it < 10; ++it) {
    const float t2 = theta * theta;
    const float q2 = t2 * t2;
    const float q3 = t2 * q2;
    const float q4 = q2 * q2;
    const float f = theta * ((((1.0f + p.k1 * t2) + p.k2 * q2) + p.p1 * q3)
                             + p.p2 * q4) - theta_d;
    const float df = (((1.0f + c1 * t2) + c2 * q2) + c3 * q3) + c4 * q4;
    theta = theta - f / fmaxf(df, 1e-6f);
  }
  const float scale = tanf(theta) / theta_d;
  *uo = p.fx * (mx * scale) + p.cx;
  *vo = p.fy * (my * scale) + p.cy;
}

__device__ void undistort_px(const Params& p, float u, float v, float* uo,
                             float* vo) {
  if (p.kb8)
    undistort_kb8(p, u, v, uo, vo);
  else
    undistort_one(p, u, v, uo, vo);
}

__global__ void undistort_kernel(Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.n) {
    undistort_px(p, p.kp[2 * i], p.kp[2 * i + 1], &p.kp_out[2 * i],
                 &p.kp_out[2 * i + 1]);
  } else if (i < p.n + p.l) {
    const int j = i - p.n;
    const float* e = p.ep + 4 * j;
    float* o = p.ep_out + 4 * j;
    undistort_px(p, e[0], e[1], &o[0], &o[1]);
    undistort_px(p, e[2], e[3], &o[2], &o[3]);
    // (x0, y0, 1) x (x1, y1, 1), normalized by |(a, b)|
    const float a = o[1] - o[3], b = o[2] - o[0];
    const float c = o[0] * o[3] - o[1] * o[2];
    const float nrm = fmaxf(sqrtf(a * a + b * b), 1e-9f);
    p.lineq[3 * j] = a / nrm;
    p.lineq[3 * j + 1] = b / nrm;
    p.lineq[3 * j + 2] = c / nrm;
  }
}

}  // namespace

PLVIO_API int undistort(const void* kp, int n, const void* ep, int l,
                        float fx, float fy, float cx, float cy, float k1,
                        float k2, float p1, float p2, int kb8, void* kp_out,
                        void* ep_out, void* lineq, void* stream) {
  Params p{static_cast<const float*>(kp), static_cast<const float*>(ep), n, l,
           fx, fy, cx, cy, k1, k2, p1, p2, kb8, static_cast<float*>(kp_out),
           static_cast<float*>(ep_out), static_cast<float*>(lineq)};
  const int total = n + l;
  if (total > 0)
    undistort_kernel<<<(total + 127) / 128, 128, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
