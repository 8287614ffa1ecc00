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
// What bounds them on the H100: launch latency and, for bow_score, the
// latency of its reads.  A keyframe has ~1000 ORB descriptors (32 B each)
// and 4 levels of 10 children: 40 000 32-byte popcount comparisons, ~1.3
// MB of centroid reads from L2; the bag is 40 KB.  A query against a bank
// of 512 keyframes x 10 000 words touches only the rows its mask lets in
// (the keyframes present and not excluded: ~42 rows of 40 KB, 1.7 MB, 0.5
// us at 3.35 TB/s), so the score is a few dependent round trips to memory
// and a reduction, not bandwidth.
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
// bow_score: one launch a query, for the point bank and, where given, the
// line bank (rows [0, K) and [K, 2K) of one list).  A fixed grid of
// 256-thread blocks reads the masks, ranks the rows they let in with warp
// ballots, and deals the live rows round-robin to the blocks, so a
// masked-out row costs no block (its -1 is written by the block the row
// falls to).  A live row is summed in one fixed order, bit for bit the
// order this kernel has always used: thread t adds |v - w| over words t,
// t + 256, ... in turn, then a halving tree over the 256 partials.  The
// loop detector keeps the rows whose score is above 0, and two disjoint
// bags score 0 up to the last bit of that sum, so its decisions follow
// the order (a faster order, 16-byte loads with four partial sums a
// thread, turned candidates around on SLAM mode 3's replay).  A thread's
// loads, 32 at a time, are issued before its adds.  1 - 0.5 s, and
// exactly 0 for a row that shares no word with the query (no word with v
// > 0 and w > 0: DBoW2 sums over the shared words only, so its score is
// exactly 0 there): each thread flags a shared word in the same pass as
// its sum and the block ORs the flags in the tree's first barrier.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kStageBytes = 48 * 1024;
constexpr int kScoreThreads = 256;
constexpr int kScoreUnroll = 32;    // loads a thread issues before its adds
constexpr int kScoreBlocks = 128;

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

// |v - w|_1 of one row by the whole block, in the fixed order above;
// `shared` whether some word has v > 0 and w > 0
__device__ float l1_row(const float* __restrict__ v,
                        const float* __restrict__ w, int W, float* part,
                        bool& shared) {
  const int t = threadIdx.x;
  float s = 0.0f;
  bool any = false;
  for (int i0 = t; i0 < W; i0 += kScoreUnroll * kScoreThreads) {
    float a[kScoreUnroll], b[kScoreUnroll];
#pragma unroll
    for (int k = 0; k < kScoreUnroll; ++k) {
      const int i = i0 + k * kScoreThreads;
      a[k] = i < W ? v[i] : 0.0f;
      b[k] = i < W ? w[i] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kScoreUnroll; ++k)
      if (i0 + k * kScoreThreads < W) {
        s += fabsf(a[k] - b[k]);
        any = any || (a[k] > 0.0f && b[k] > 0.0f);
      }
  }
  part[t] = s;
  shared = __syncthreads_or(any) != 0;
  for (int h = kScoreThreads / 2; h > 0; h >>= 1) {
    if (t < h) part[t] += part[t + h];
    __syncthreads();
  }
  const float tot = part[0];
  __syncthreads();
  return tot;
}

struct Bank {
  const float* v;
  const float* rows;
  const bool* mask;
  int W;
};

__global__ void __launch_bounds__(kScoreThreads)
bow_score_kernel(Bank b0, Bank b1, int K, int n_rows,
                 float* __restrict__ out) {
  __shared__ int wcnt[kScoreThreads / 32];
  __shared__ int mine[kScoreThreads];
  __shared__ float part[kScoreThreads];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int G = gridDim.x, me = blockIdx.x;
  int base = 0;  // live rows ranked before this chunk
  for (int c0 = 0; c0 < n_rows; c0 += kScoreThreads) {
    const int row = c0 + t;
    const bool live = row < n_rows &&
                      (row < K ? b0.mask[row] : b1.mask[row - K]);
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < kScoreThreads / 32; ++w) {
      off += w < warp ? wcnt[w] : 0;
      total += wcnt[w];
    }
    const int rank = base + off + __popc(bal & ((1u << lane) - 1u));
    // this block's live rows of the chunk: ranks r0, r0 + G, ...
    const int r0 = base + ((me - base % G) % G + G) % G;
    const int count = base + total > r0 ? (base + total - 1 - r0) / G + 1 : 0;
    if (live && rank % G == me) mine[(rank - r0) / G] = row;
    if (row < n_rows && !live && row % G == me) out[row] = -1.0f;
    __syncthreads();
    for (int m = 0; m < count; ++m) {
      const int r = mine[m];
      const Bank& bk = r < K ? b0 : b1;
      const int rr = r < K ? r : r - K;
      bool shared;
      const float s = l1_row(bk.v, bk.rows + size_t(rr) * bk.W, bk.W, part,
                             shared);
      if (t == 0) out[r] = shared ? 1.0f - 0.5f * s : 0.0f;
    }
    base += total;
    __syncthreads();
  }
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

// Scores of v against bank rows [K, W] (out[0, K)) and, where v1 is given,
// of v1 against bank1 [K, W1] (out[K, 2K)), -1 where the mask is off.
PLVIO_API int bow_score(const void* v, const void* bank, const void* mask,
                        int K, int W, const void* v1, const void* bank1,
                        const void* mask1, int W1, void* out, void* stream) {
  const Bank b0{static_cast<const float*>(v), static_cast<const float*>(bank),
                static_cast<const bool*>(mask), W};
  const Bank b1{static_cast<const float*>(v1),
                static_cast<const float*>(bank1),
                static_cast<const bool*>(mask1), W1};
  const int n_rows = v1 ? 2 * K : K;
  const int grid = n_rows < kScoreBlocks ? n_rows : kScoreBlocks;
  bow_score_kernel<<<grid, kScoreThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      b0, b1, K, n_rows, static_cast<float*>(out));
  return cudaGetLastError();
}
