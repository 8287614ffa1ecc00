// imu_preint — the VI frame's IMU stage in one launch: on-manifold
// preintegration of the frame's sample window at the carried biases, the
// forward state prediction, and the information matrix of the inertial
// edge, inv(C[:9,:9] + 1e-8 I).
//
// Replaces plvio_tpu/ops/imu.py `preintegrate` (:87) and `predict_state`
// (:215), plus the `jnp.linalg.inv(C9)` of __graft_entry__.py:202-203.
// The JAX version is a lax.scan over the samples whose carry holds the 15x15
// covariance, then an LU inverse; each is a handful of tiny XLA ops.
//
// What bounds it on the H100: nothing but latency.  A frame's window has
// <= 10 samples (a keyframe's, padded, 64 or more: the kernel streams any
// count) and each step depends on the previous one; the work is ~3000
// flops per sample.  A chain of eager torch ops costs ~40 launches per
// sample (~400 per frame) and the host time to issue them.
//
// Design: one block of 128 threads, one launch per frame, everything in
// shared memory.  Thread 0 advances the small state (dR, dV, dP, the five
// bias Jacobians, the noise blocks A and B) one sample at a time with the
// reference's operation order; the 81 entries of the 9x9 covariance
// products A C A^T + B N B^T are shared among 81 threads.  Masked samples
// leave the state as it was.  Thread 0 then predicts (R2, v2, p2) and
// inverts C9 by an in-register Cholesky (L L^T, then L^-T L^-1): the
// reference inverts by LU, so the two agree to float32 rounding, not bit
// for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ void mat3_mul(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j]
                     + A[3 * i + 2] * B[6 + j];
}

__device__ void mat3_vec(const float* A, const float* v, float* o) {
  for (int i = 0; i < 3; ++i)
    o[i] = A[3 * i] * v[0] + A[3 * i + 1] * v[1] + A[3 * i + 2] * v[2];
}

__device__ void hat3(const float* w, float* W) {
  W[0] = 0.f;   W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0.f;   W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0.f;
}

// so3_exp and the right Jacobian with the reference's Taylor guards
__device__ void so3_exp_jr(const float* phi, float* R, float* Jr) {
  const float theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const bool small = theta2 < 1e-6f;
  const float theta = sqrtf(fmaxf(theta2, 1e-24f));
  float W[9], W2[9];
  hat3(phi, W);
  mat3_mul(W, W, W2);
  const float A = small ? 1.f - theta2 / 6.f : sinf(theta) / theta;
  const float B = small ? 0.5f - theta2 / 24.f
                        : (1.f - cosf(theta)) / theta2;
  const float C = small ? 1.f / 6.f - theta2 / 120.f
                        : (theta - sinf(theta)) / (theta2 * theta);
  for (int i = 0; i < 9; ++i) {
    const float id = (i % 4 == 0) ? 1.f : 0.f;
    R[i] = id + A * W[i] + B * W2[i];
    Jr[i] = id - B * W[i] + C * W2[i];
  }
}

__device__ void so3_normalize(const float* R, float* out) {
  float r0[3] = {R[0], R[1], R[2]};
  const float n0 = fmaxf(sqrtf(r0[0] * r0[0] + r0[1] * r0[1]
                               + r0[2] * r0[2]), 1e-12f);
  for (int k = 0; k < 3; ++k) r0[k] = r0[k] / n0;
  const float d = R[3] * r0[0] + R[4] * r0[1] + R[5] * r0[2];
  float r1[3] = {R[3] - d * r0[0], R[4] - d * r0[1], R[5] - d * r0[2]};
  const float n1 = fmaxf(sqrtf(r1[0] * r1[0] + r1[1] * r1[1]
                               + r1[2] * r1[2]), 1e-12f);
  for (int k = 0; k < 3; ++k) r1[k] = r1[k] / n1;
  out[0] = r0[0]; out[1] = r0[1]; out[2] = r0[2];
  out[3] = r1[0]; out[4] = r1[1]; out[5] = r1[2];
  out[6] = r0[1] * r1[2] - r0[2] * r1[1];
  out[7] = r0[2] * r1[0] - r0[0] * r1[2];
  out[8] = r0[0] * r1[1] - r0[1] * r1[0];
}

struct State {
  float dR[9], dV[3], dP[3], JRg[9], JVg[9], JVa[9], JPg[9], JPa[9];
  float C9[81], Cb[6];
  float T, sum_a[3], sum_w[3], n;
};

__global__ void __launch_bounds__(kThreads) imu_preint_kernel(
    const float* __restrict__ gyro, const float* __restrict__ acc,
    const float* __restrict__ dt, const uint8_t* __restrict__ mask, int K,
    const float* __restrict__ bg, const float* __restrict__ ba,
    const float* __restrict__ pose_wb, const float* __restrict__ vel,
    float sg, float sa, float wg, float wa, float gravity,
    float* __restrict__ out) {
  __shared__ State s;
  __shared__ float sA[81], sB[54], sAC[81], sC9n[81], sN[6];
  __shared__ int s_m;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < 9; ++i) {
      s.dR[i] = (i % 4 == 0) ? 1.f : 0.f;
      s.JRg[i] = s.JVg[i] = s.JVa[i] = s.JPg[i] = s.JPa[i] = 0.f;
    }
    for (int i = 0; i < 3; ++i)
      s.dV[i] = s.dP[i] = s.sum_a[i] = s.sum_w[i] = 0.f;
    for (int i = 0; i < 6; ++i) s.Cb[i] = 0.f;
    s.T = 0.f;
    s.n = 0.f;
    // float32 squares, as the reference's diag(sigma^2) of float32 sigmas
    for (int i = 0; i < 3; ++i) { sN[i] = sg * sg; sN[3 + i] = sa * sa; }
  }
  for (int i = tid; i < 81; i += kThreads) s.C9[i] = 0.f;
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    if (tid == 0) {
      const bool m = mask[k] != 0;
      const float dti = m ? dt[k] : 0.f;
      float a_hat[3], w_hat[3];
      for (int i = 0; i < 3; ++i) {
        a_hat[i] = acc[3 * k + i] - ba[i];
        w_hat[i] = gyro[3 * k + i] - bg[i];
      }
      const float dt2 = dti * dti;
      float dRa[3], Wa[9], dRWa[9];
      mat3_vec(s.dR, a_hat, dRa);
      hat3(a_hat, Wa);
      mat3_mul(s.dR, Wa, dRWa);
      // A (9x9) and B (9x6), reference :120-126 and :138-139
      for (int i = 0; i < 81; ++i) sA[i] = (i % 10 == 0) ? 1.f : 0.f;
      for (int i = 0; i < 54; ++i) sB[i] = 0.f;
      const float c1 = -dti, c2 = -0.5f * dt2, c3 = 0.5f * dt2;
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          sA[(3 + i) * 9 + j] = c1 * dRWa[3 * i + j];
          sA[(6 + i) * 9 + j] = c2 * dRWa[3 * i + j];
          sA[(6 + i) * 9 + 3 + j] = (i == j) ? dti : 0.f;
          sB[(3 + i) * 6 + 3 + j] = dti * s.dR[3 * i + j];
          sB[(6 + i) * 6 + 3 + j] = c3 * s.dR[3 * i + j];
        }
      float phi[3], dRi[9], Jr[9];
      for (int i = 0; i < 3; ++i) phi[i] = w_hat[i] * dti;
      so3_exp_jr(phi, dRi, Jr);
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          sA[i * 9 + j] = dRi[3 * j + i];              // dRi^T
          sB[i * 6 + j] = Jr[3 * i + j] * dti;
        }
      s_m = m;
      if (m) {
        // bias Jacobians with the OLD dR, JRg, JVa, JVg (reference
        // :129-132): JP* first, from the old JV*
        float cW[9], dW[9], cWJ[9], dWJ[9], dRi_t[9], t9[9];
        for (int i = 0; i < 9; ++i) {
          cW[i] = c3 * dRWa[i];
          dW[i] = dti * dRWa[i];
          dRi_t[i] = dRi[3 * (i % 3) + i / 3];
        }
        mat3_mul(cW, s.JRg, cWJ);
        mat3_mul(dW, s.JRg, dWJ);
        for (int i = 0; i < 9; ++i) {
          s.JPa[i] = (s.JPa[i] + s.JVa[i] * dti) - c3 * s.dR[i];
          s.JPg[i] = (s.JPg[i] + s.JVg[i] * dti) - cWJ[i];
          s.JVa[i] = s.JVa[i] - dti * s.dR[i];
          s.JVg[i] = s.JVg[i] - dWJ[i];
        }
        // position and velocity with the OLD dR (reference :115-116)
        for (int i = 0; i < 3; ++i) {
          s.dP[i] = s.dP[i] + s.dV[i] * dti + 0.5f * dRa[i] * dt2;
          s.dV[i] = s.dV[i] + dRa[i] * dti;
        }
        // rotation (reference :140-141)
        float dRn[9];
        mat3_mul(s.dR, dRi, t9);
        so3_normalize(t9, dRn);
        mat3_mul(dRi_t, s.JRg, t9);
        for (int i = 0; i < 9; ++i) {
          s.JRg[i] = t9[i] - Jr[i] * dti;
          s.dR[i] = dRn[i];
        }
        for (int i = 0; i < 6; ++i)
          s.Cb[i] = s.Cb[i] + ((i < 3) ? wg * wg : wa * wa);
        for (int i = 0; i < 3; ++i) {
          s.sum_a[i] += acc[3 * k + i];
          s.sum_w[i] += gyro[3 * k + i];
        }
        s.n += 1.f;
      }
      s.T = s.T + dti;
    }
    __syncthreads();
    const bool m_blk = s_m;
    __syncthreads();                        // s_m read before rewritten
    if (!m_blk) continue;                   // block-uniform
    // A C9 (81 threads), then (A C9) A^T + (B N) B^T
    if (tid < 81) {
      const int i = tid / 9, j = tid % 9;
      float acc_ = 0.f;
      for (int q = 0; q < 9; ++q) acc_ += sA[i * 9 + q] * s.C9[q * 9 + j];
      sAC[tid] = acc_;
    }
    __syncthreads();
    if (tid < 81) {
      const int i = tid / 9, j = tid % 9;
      float x = 0.f, y = 0.f;
      for (int q = 0; q < 9; ++q) x += sAC[i * 9 + q] * sA[j * 9 + q];
      for (int q = 0; q < 6; ++q) y += sB[i * 6 + q] * sN[q] * sB[j * 6 + q];
      sC9n[tid] = x + y;
    }
    __syncthreads();
    if (tid < 81) s.C9[tid] = sC9n[tid];
    __syncthreads();
  }

  // ---- outputs: dT, deltas, Jacobians, C [15,15], averages ------------
  float* o = out;
  if (tid == 0) {
    o[0] = s.T;
    for (int i = 0; i < 9; ++i) {
      o[1 + i] = s.dR[i];
      o[16 + i] = s.JRg[i];
      o[25 + i] = s.JVg[i];
      o[34 + i] = s.JVa[i];
      o[43 + i] = s.JPg[i];
      o[52 + i] = s.JPa[i];
    }
    for (int i = 0; i < 3; ++i) {
      o[10 + i] = s.dV[i];
      o[13 + i] = s.dP[i];
    }
    const float n = fmaxf(s.n, 1.f);
    for (int i = 0; i < 3; ++i) {
      o[286 + i] = s.sum_a[i] / n;
      o[289 + i] = s.sum_w[i] / n;
    }
  }
  for (int e = tid; e < 225; e += kThreads) {
    const int i = e / 15, j = e % 15;
    float v = 0.f;
    if (i < 9 && j < 9) v = s.C9[i * 9 + j];
    else if (i >= 9 && i == j) v = s.Cb[i - 9];
    o[61 + e] = v;
  }
  if (tid != 0) return;

  // ---- prediction (reference predict_state, at the window's own bias)
  float R1[9], v1[3], p1[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) R1[3 * i + j] = pose_wb[4 * i + j];
    p1[i] = pose_wb[4 * i + 3];
    v1[i] = vel[i];
  }
  const float g[3] = {0.f, 0.f, -gravity};
  float dRn[9], t9[9], R2[9], Rv[3], Rp[3];
  so3_normalize(s.dR, dRn);
  mat3_mul(R1, dRn, t9);
  so3_normalize(t9, R2);
  mat3_vec(R1, s.dV, Rv);
  mat3_vec(R1, s.dP, Rp);
  const float dT = s.T;
  for (int i = 0; i < 9; ++i) o[292 + i] = R2[i];
  for (int i = 0; i < 3; ++i) {
    o[301 + i] = v1[i] + g[i] * dT + Rv[i];
    o[304 + i] = p1[i] + v1[i] * dT + 0.5f * g[i] * dT * dT + Rp[i];
  }

  // ---- imu_info = inv(C9 + 1e-8 I) by Cholesky -------------------------
  float L[9][9] = {};
  for (int j = 0; j < 9; ++j) {
    float d = s.C9[j * 9 + j] + 1e-8f;
    for (int q = 0; q < j; ++q) d -= L[j][q] * L[j][q];
    L[j][j] = sqrtf(d);
    for (int i = j + 1; i < 9; ++i) {
      float x = s.C9[i * 9 + j];
      for (int q = 0; q < j; ++q) x -= L[i][q] * L[j][q];
      L[i][j] = x / L[j][j];
    }
  }
  float Li[9][9] = {};                     // L^-1, lower triangular
  for (int j = 0; j < 9; ++j) {
    Li[j][j] = 1.f / L[j][j];
    for (int i = j + 1; i < 9; ++i) {
      float x = 0.f;
      for (int q = j; q < i; ++q) x += L[i][q] * Li[q][j];
      Li[i][j] = -x / L[i][i];
    }
  }
  for (int i = 0; i < 9; ++i)              // (L^-1)^T L^-1
    for (int j = 0; j < 9; ++j) {
      float x = 0.f;
      for (int q = (i > j ? i : j); q < 9; ++q) x += Li[q][i] * Li[q][j];
      o[307 + i * 9 + j] = x;
    }
}

}  // namespace

PLVIO_API int imu_preint(const void* gyro, const void* acc, const void* dt,
                         const void* mask, int K, const void* bg,
                         const void* ba, const void* pose_wb, const void* vel,
                         float sigma_gyro, float sigma_acc, float walk_gyro,
                         float walk_acc, float gravity, void* out,
                         void* stream) {
  imu_preint_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gyro), static_cast<const float*>(acc),
      static_cast<const float*>(dt), static_cast<const uint8_t*>(mask), K,
      static_cast<const float*>(bg), static_cast<const float*>(ba),
      static_cast<const float*>(pose_wb), static_cast<const float*>(vel),
      sigma_gyro, sigma_acc, walk_gyro, walk_acc, gravity,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
