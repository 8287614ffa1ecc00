// bow — the bag-of-words pipeline of the keyframe database: the
// vocabulary descent with the frame's L1-normalized bag of words
// (bow_transform), and the masked L1 score of a query bag against a bank
// of keyframe bags (bow_score).
//
// Replaces plvio_tpu/models/vocabulary.py `transform` (:88) and
// `bow_vector` (:107) through `make_bow_pipeline` (:122), which the
// keyframe database runs on every keyframe and every relocalization
// query (models/kfdb.py:51-58, 75-76), and `l1_score` (:116) under
// `KeyFrameDatabase._score` (kfdb.py:38-39).  The JAX version unpacks the
// descriptors to +-1 and takes, level by level, the argmax of the dot
// products with the node's k children as a batched matmul; the bag is a
// scatter-add and a division; the score a dense |v - w| reduction.
//
// What bounds them on the H100: launch latency.  A keyframe has ~1000 ORB
// descriptors (32 B each) and 4 levels of 10 children: 40 000 32-byte
// popcount comparisons, ~1.3 MB of centroid reads from L2; the bag is 40
// KB.  A query against a bank of 512 keyframes x 10 000 words reads 20 MB
// (6 us at 3.35 TB/s).
//
// bow_transform: one block of 1024 threads, one warp per descriptor at a
// time.  The levels whose rows fit 48 KB (0-2 of both shipped
// vocabularies: 1110 rows, 35 KB) are staged in shared memory; deeper
// levels are read from global memory (L2).  Lane j < k takes the Hamming
// distance popc(d ^ c) to child j; a warp reduction of (distance, index)
// pairs keeps the least distance and on ties the first child (the
// reference's argmax of the exact integer dot 256 - 2 d).  The histogram
// is counted with integer atomics in shared memory (deterministic), and
// each bin is divided by the count total with a true division, so that
// the bag equals h / max(sum h, 1e-9) bit for bit.  The ids and the bag
// are written straight into the rows the caller gives (the database's
// bank rows).
//
// bow_score: one block of 256 threads per bank row; each thread sums
// |v - w| over its strided words in order, then a fixed tree reduction;
// 1 - 0.5 s, or -1 where the row is masked.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kStageBytes = 48 * 1024;
constexpr int kScoreThreads = 256;

__global__ void bow_transform_kernel(const uint32_t* __restrict__ table,
                                     int k, int depth, int staged_rows,
                                     const uint32_t* __restrict__ desc,
                                     const bool* __restrict__ valid, int n,
                                     int* __restrict__ ids,
                                     float* __restrict__ bow, int n_words) {
  extern __shared__ uint32_t smem[];
  uint32_t* cents = smem;                                  // [staged, 8]
  int* hist = reinterpret_cast<int*>(smem + 8 * staged_rows);
  __shared__ int total;
  for (int i = threadIdx.x; i < 8 * staged_rows; i += blockDim.x)
    cents[i] = table[i];
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) hist[i] = 0;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int i = warp; i < n; i += n_warps) {
    uint32_t d[8];
    for (int w = 0; w < 8; ++w) d[w] = desc[8 * i + w];
    int node = 0, off = 0, cells = 1;
    for (int l = 0; l < depth; ++l) {
      cells *= k;
      int dist = 0x7fffffff;
      if (lane < k) {
        const int row = off + node * k + lane;
        const uint32_t* c = row < staged_rows ? cents + 8 * row
                                              : table + 8 * row;
        dist = 0;
        for (int w = 0; w < 8; ++w) dist += __popc(d[w] ^ c[w]);
      }
      int idx = lane;
      for (int s = 16; s > 0; s >>= 1) {
        const int od = __shfl_down_sync(0xffffffffu, dist, s);
        const int oi = __shfl_down_sync(0xffffffffu, idx, s);
        if (od < dist || (od == dist && oi < idx)) { dist = od; idx = oi; }
      }
      idx = __shfl_sync(0xffffffffu, idx, 0);
      node = node * k + idx;
      off += cells;
    }
    if (lane == 0) {
      const bool ok = valid[i];
      ids[i] = ok ? node : -1;
      if (ok) {
        atomicAdd(&hist[node], 1);
        atomicAdd(&total, 1);
      }
    }
  }
  __syncthreads();
  const float den = fmaxf(static_cast<float>(total), 1e-9f);
  for (int i = threadIdx.x; i < n_words; i += blockDim.x)
    bow[i] = static_cast<float>(hist[i]) / den;
}

__global__ void bow_score_kernel(const float* __restrict__ v,
                                 const float* __restrict__ bank,
                                 const bool* __restrict__ mask, int W,
                                 float* __restrict__ out) {
  __shared__ float part[kScoreThreads];
  const int r = blockIdx.x;
  if (!mask[r]) {
    if (threadIdx.x == 0) out[r] = -1.0f;
    return;
  }
  const float* w = bank + static_cast<size_t>(r) * W;
  float s = 0.0f;
  for (int i = threadIdx.x; i < W; i += kScoreThreads)
    s += fabsf(v[i] - w[i]);
  part[threadIdx.x] = s;
  __syncthreads();
  for (int h = kScoreThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) part[threadIdx.x] += part[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[r] = 1.0f - 0.5f * part[0];
}

}  // namespace

PLVIO_API int bow_transform(const void* table, int k, int depth,
                            const void* desc, const void* valid, int n,
                            void* ids, void* bow, void* stream) {
  int n_words = 1, rows = 0, staged = 0, cells = 1;
  for (int l = 0; l < depth; ++l) {
    cells *= k;
    rows += cells;
    if (8 * 4 * rows <= kStageBytes) staged = rows;
  }
  n_words = cells;
  const size_t smem = static_cast<size_t>(8 * staged) * 4
      + static_cast<size_t>(n_words) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      bow_transform_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  bow_transform_kernel<<<1, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), k, depth, staged,
      static_cast<const uint32_t*>(desc), static_cast<const bool*>(valid),
      n, static_cast<int*>(ids), static_cast<float*>(bow), n_words);
  return cudaGetLastError();
}

PLVIO_API int bow_score(const void* v, const void* bank, const void* mask,
                        int rows, int W, void* out, void* stream) {
  bow_score_kernel<<<rows, kScoreThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(bank),
      static_cast<const bool*>(mask), W, static_cast<float*>(out));
  return cudaGetLastError();
}
