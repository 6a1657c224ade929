// Greedy rotated-NMS sweep over score-sorted candidates, batched: the
// (B, K, K) f32 IoU (K1's upper_only output), labels (B, K) int64, valid
// (B, K) bool and each image's live prefix vcount (B,) int32 -> keep (B, K)
// bool.
//
// Replaces no TPU kernel: the JAX package sweeps in XLA
// (r3det_tpu/ops/nms.py:68, _greedy_keep_blocked), and the port's plain
// route (ops/nms.py::greedy_keep_gated_reference) is that sweep in
// PyTorch: the label gate and the threshold over the whole matrix, then
// 256-candidate blocks resolved by fixpoint rounds, each round a few
// launches and a host sync. This kernel keeps the same set: row i (in score
// order) is kept iff valid[i] and no kept j < i has labels[j] == labels[i]
// and iou[j, i] > thr, thr being iou_thr rounded to f32 (what the plain
// route's `iou > iou_thr` compares against). Invalid rows neither keep nor
// suppress; rows at or past vcount are never kept (the caller guarantees
// that every valid row lies below vcount).
//
// What bounds it. The suppression relation is one bit a pair, and the
// greedy chain over it is serial. So one launch of the C entry runs two
// kernels:
//   1. nms_mask_kernel: a block per (image, 64-row chunk, 4 words of 64
//      columns), a warp per row, two ballots a word. Bit j of word (i, w)
//      is set when c = 64 w + j > i, c < vcount, labels[i] == labels[c]
//      and iou[i, c] > thr. Only rows below vcount and words from the
//      row's own chunk up to vcount are written (the only ones pass 2
//      reads), and a pair's IoU is read only where the labels agree. Its
//      bound is that read of the upper triangle below vcount.
//   2. nms_sweep_kernel: a block per image walks the 64-row chunks in
//      order, with the suppressed columns as a vector of words in shared
//      memory. Every warp resolves the chunk's own 64 x 64 diagonal word
//      the same way, one find-first-set step a kept row; then each thread
//      ORs its 8 rows' word (one word a thread, 8 row groups) into the
//      vector where those rows were kept. The next chunk's words and
//      valid flags are loaded while this chunk resolves. Its bound is the
//      chain of chunks: ceil(vcount / 64) steps of two barriers and the
//      serial resolve.
// No host sync, no float or bool (B, K, K) intermediate: the mask is
// (B, K, ceil(K / 64)) u64 words of scratch, 16 MB at (8, 4000).
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWords = 64;                  // K <= 4096
constexpr int kMaskThreads = 256;              // 8 warps, a row each
constexpr int kMaskWords = 4;                  // column words a mask block
constexpr int kSweepThreads = 512;             // 64 words x 8 row groups
constexpr int kGroups = kSweepThreads / 64;
constexpr int kRowsPerThread = 64 / kGroups;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kMaskThreads)
    nms_mask_kernel(const float* __restrict__ iou,
                    const long long* __restrict__ labels,
                    const int* __restrict__ vcount, float thr,
                    unsigned long long* __restrict__ mask, int K, int W) {
  const int b = blockIdx.z;
  const int chunk = blockIdx.y;
  const int v = min(max(vcount[b], 0), K);
  const int live_words = (v + 63) / 64;
  const int r0 = chunk * 64;
  const int w_lo = max(static_cast<int>(blockIdx.x) * kMaskWords, chunk);
  const int w_hi =
      min(static_cast<int>(blockIdx.x) * kMaskWords + kMaskWords, live_words);
  if (r0 >= v || w_lo >= w_hi) return;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* iou_b = iou + static_cast<size_t>(b) * K * K;
  const long long* lab = labels + static_cast<size_t>(b) * K;
  unsigned long long* mask_b = mask + static_cast<size_t>(b) * K * W;

  long long col_label[kMaskWords][2];
#pragma unroll
  for (int k = 0; k < kMaskWords; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = (w_lo + k) * 64 + h * 32 + lane;
      col_label[k][h] = (w_lo + k < w_hi && c < v) ? lab[c] : 0;
    }
  }
  const int r_end = min(r0 + 64, v);
  for (int r = r0 + warp; r < r_end; r += kMaskThreads / 32) {
    const long long row_label = lab[r];
    const float* row = iou_b + static_cast<size_t>(r) * K;
    // all of the row's loads first, then the ballots
    bool bit[kMaskWords][2];
#pragma unroll
    for (int k = 0; k < kMaskWords; ++k) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = (w_lo + k) * 64 + h * 32 + lane;
        bit[k][h] = w_lo + k < w_hi && c > r && c < v &&
                    col_label[k][h] == row_label;
        const float x = bit[k][h] ? row[c] : 0.0f;
        bit[k][h] = bit[k][h] && x > thr;
      }
    }
#pragma unroll
    for (int k = 0; k < kMaskWords; ++k) {
      const unsigned lo = __ballot_sync(kFull, bit[k][0]);
      const unsigned hi = __ballot_sync(kFull, bit[k][1]);
      if (lane == 0 && w_lo + k < w_hi)
        mask_b[static_cast<size_t>(r) * W + w_lo + k] =
            lo | (static_cast<unsigned long long>(hi) << 32);
    }
  }
}

__global__ void __launch_bounds__(kSweepThreads)
    nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                     const unsigned char* __restrict__ valid,
                     const int* __restrict__ vcount,
                     unsigned char* __restrict__ keep, int K, int W) {
  __shared__ unsigned long long suppressed[kMaxWords];
  __shared__ unsigned long long diag[64];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int w = tid % 64;                        // the word a thread ORs
  const int g = tid / 64;                        // its rows: 8 g .. 8 g + 7
  const int lane = tid % 32;
  const int v = min(max(vcount[b], 0), K);
  const int chunks = (v + 63) / 64;
  const unsigned long long* mask_b = mask + static_cast<size_t>(b) * K * W;
  const unsigned char* valid_b = valid + static_cast<size_t>(b) * K;
  unsigned char* keep_b = keep + static_cast<size_t>(b) * K;

  if (tid < kMaxWords) suppressed[tid] = 0;
  for (int r = chunks * 64 + tid; r < K; r += kSweepThreads) keep_b[r] = 0;

  // chunk c's words of this thread's rows, and its rows' valid flags (each
  // warp holds all 64: lanes take rows lane and 32 + lane)
  unsigned long long next[kRowsPerThread];
  bool next_valid[2];
  auto load = [&](int c) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = c * 64 + g * kRowsPerThread + i;
      next[i] = (w >= c && w < chunks && r < v)
                    ? mask_b[static_cast<size_t>(r) * W + w]
                    : 0ull;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = c * 64 + h * 32 + lane;
      next_valid[h] = r < v && valid_b[r] != 0;
    }
  };
  if (chunks > 0) load(0);
  __syncthreads();

  for (int c = 0; c < chunks; ++c) {
    unsigned long long words[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) words[i] = next[i];
    const unsigned long long live =
        __ballot_sync(kFull, next_valid[0]) |
        (static_cast<unsigned long long>(__ballot_sync(kFull, next_valid[1]))
         << 32);
    if (c + 1 < chunks) load(c + 1);
    if (w == c) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        diag[g * kRowsPerThread + i] = words[i];
    }
    __syncthreads();

    // the chunk's own greedy chain, the same in every warp
    unsigned long long cand = live & ~suppressed[c];
    unsigned long long kept = 0;
    while (cand) {
      const int i = __ffsll(static_cast<long long>(cand)) - 1;
      kept |= 1ull << i;
      cand &= ~(diag[i] | (1ull << i));
    }
    const int r0 = c * 64;
    if (tid < 64 && r0 + tid < K) keep_b[r0 + tid] = (kept >> tid) & 1ull;

    if (w > c && w < chunks) {
      unsigned long long acc = 0;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        if ((kept >> (g * kRowsPerThread + i)) & 1ull) acc |= words[i];
      if (acc) atomicOr(&suppressed[w], acc);
    }
    __syncthreads();
  }
}

}  // namespace

// The C entry point: both kernels on `stream`. mask is the caller's
// (B, K, ceil(K / 64)) u64 scratch. Returns the cudaError_t of the
// launches.
extern "C" int r3det_nms_sweep(const void* iou, const void* labels,
                               const void* valid, const void* vcount,
                               float thr, void* mask, void* keep, int B,
                               int K, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const int W = (K + 63) / 64;
  if (W > kMaxWords || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kMaskWords - 1) / kMaskWords, W, B);
  nms_mask_kernel<<<grid, kMaskThreads, 0, s>>>(
      static_cast<const float*>(iou), static_cast<const long long*>(labels),
      static_cast<const int*>(vcount), thr,
      static_cast<unsigned long long*>(mask), K, W);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_sweep_kernel<<<B, kSweepThreads, 0, s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const unsigned char*>(valid),
      static_cast<const int*>(vcount), static_cast<unsigned char*>(keep), K,
      W);
  return static_cast<int>(cudaGetLastError());
}
