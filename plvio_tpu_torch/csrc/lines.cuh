// Shared pieces of the line detectors (line_detect.cu, line_detect_ed.cu):
// bf16 rounding, the floor modulo by pi, and the bf16 Scharr gradients of
// plvio_tpu/ops/lines.py `_gradients` (:47) on a shared-memory tile.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float mod_pi(float a) {   // torch.remainder(a, pi)
  float m = fmodf(a, PLVIO_PI_F);
  if (m != 0.f && m < 0.f) m += PLVIO_PI_F;
  return m;
}

// gradients of pixel (ly, lx) of a shared tile of bf16-rounded pixels (zero
// outside the image; tile coordinates of the pixel itself, its 3x3
// neighbourhood in the tile): one float32 sum of exact products, rounded
// once to bf16, the reference's bf16 convolution
template <int N>
__device__ __forceinline__ void scharr(const float (*img)[N], int ly, int lx,
                                       float* gx, float* gy) {
  const float a = img[ly - 1][lx - 1], b = img[ly - 1][lx],
              c = img[ly - 1][lx + 1];
  const float d = img[ly][lx - 1], f = img[ly][lx + 1];
  const float g = img[ly + 1][lx - 1], h = img[ly + 1][lx],
              i = img[ly + 1][lx + 1];
  const float k3 = 3.f / 32.f, k10 = 10.f / 32.f;
  // row-major taps of kx = [[-3,0,3],[-10,0,10],[-3,0,3]]/32 and ky = kx^T
  *gx = bf(-k3 * a + k3 * c + -k10 * d + k10 * f + -k3 * g + k3 * i);
  *gy = bf(-k3 * a + -k10 * b + -k3 * c + k3 * g + k10 * h + k3 * i);
}

// the bf16 gradient magnitude, every op rounded to bf16 as torch's bf16 ops
__device__ __forceinline__ float bf_mag(float gx, float gy) {
  return bf(sqrtf(bf(bf(gx * gx) + bf(gy * gy))));
}
