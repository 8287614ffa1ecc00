// rot_hist — the rotation-histogram filter of the epipolar matcher.
//
// Replaces plvio_tpu/ops/matching.py `rotation_histogram_filter` (:115) as
// `make_epipolar_matcher` (plvio_tpu/models/kernels.py:871-872) runs it on
// the matches of the keyframe mapping step: the orientation difference of
// each match falls in one of 30 bins; the 3 fullest bins (ties to the
// lower bin, as lax.top_k orders them) that hold at least 10% of the
// fullest one keep their matches.  The JAX version is a scatter-add, a
// top_k and a gather over [N] arrays.
//
// What bounds it on the H100: launch latency.  At 1024 matches it reads
// ~13 KB and writes 1 KB; the histogram is 30 integer counters.
//
// Design: one block.  Each thread bins its matches and adds them to the
// shared histogram with integer atomics (an integer sum is the same in any
// order, so the result does not depend on the schedule); thread 0 picks
// the top bins by scanning with strict '>' (the lower bin wins a tie);
// every thread then filters its matches.  The binning is the reference's
// float32 arithmetic: rot = a - b[idx], + 360 where negative, truncation of
// rot / binw to an integer, clipped to the bins.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxBins = 256;

__global__ void rot_hist_kernel(const float* ang_a, const float* ang_b,
                                const int* idx, const uint8_t* ok, int n,
                                int n_bins, int keep_top, float binw,
                                uint8_t* out, int* bins) {
  __shared__ int hist[kMaxBins];
  __shared__ uint8_t keep[kMaxBins];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    hist[b] = 0;
    keep[b] = 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float rot = ang_a[i] - ang_b[idx[i]];
    if (rot < 0.f) rot = rot + 360.f;
    // float -> int32 conversion truncates toward zero (astype(int32));
    // clamp in float first so that huge values do not overflow the int
    const float q = fminf(fmaxf(rot / binw, -1.f), float(n_bins));
    int b = static_cast<int>(q);
    b = min(max(b, 0), n_bins - 1);
    bins[i] = b;
    if (ok[i]) atomicAdd(&hist[b], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int top_val[8];
    int top_idx[8];
    for (int k = 0; k < keep_top && k < 8; ++k) {
      int best = -1, bi = 0;
      for (int b = 0; b < n_bins; ++b) {
        bool taken = false;
        for (int q = 0; q < k; ++q) taken |= (top_idx[q] == b);
        if (!taken && hist[b] > best) {
          best = hist[b];
          bi = b;
        }
      }
      top_val[k] = best;
      top_idx[k] = bi;
    }
    const float thresh = 0.1f * static_cast<float>(top_val[0]);
    for (int k = 0; k < keep_top && k < 8; ++k)
      keep[top_idx[k]] = static_cast<float>(top_val[k]) >= thresh;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[i] = ok[i] && keep[bins[i]];
}

}  // namespace

PLVIO_API int rot_hist(const void* ang_a, const void* ang_b, const void* idx,
                       const void* ok, int n, int n_bins, int keep_top,
                       float binw, void* out, void* bins, void* stream) {
  if (n_bins > kMaxBins || keep_top > 8 || keep_top > n_bins)
    return static_cast<int>(cudaErrorInvalidValue);
  rot_hist_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ang_a), static_cast<const float*>(ang_b),
      static_cast<const int*>(idx), static_cast<const uint8_t*>(ok), n,
      n_bins, keep_top, binw, static_cast<uint8_t*>(out),
      static_cast<int*>(bins));
  return static_cast<int>(cudaGetLastError());
}
