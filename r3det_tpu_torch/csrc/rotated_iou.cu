// Dense rotated-box IoU / IoF, batched: (B, N, 5) x (B, M, 5) -> (B, N, M).
//
// Replaces the TPU kernel r3det_tpu/ops/pallas_iou.py::rotated_iou_pallas
// (_iou_tile_kernel, _iou_tile_kernel_vcount, body _iou_tile_body and
// _integral_area). Same function: each pair is shifted to a local frame at
// the mean of its two centres, both boxes get 4 corners, and the
// intersection area is the Gauss-Green boundary integral of each quad's
// edges clipped Liang-Barsky style to the other quad (the second pass uses
// the strict rule, so a shared boundary counts once). The result is
// inter / max(denom, 1e-14), denom = a1 + a2 - inter (iou) or a1 (iof).
//
// The zero-fill rules match the TPU kernel at its tile granularity
// (tile_r x tile_c pair tiles): with upper_only, a tile whose first row is
// at or past the end of its column range is zero; with valid_count, a tile
// whose first row or first column is at or past the image's live count is
// zero. valid_count is read from device memory, one int32 per image, so
// the caller never syncs with the host.
//
// What bounds it on the H100: arithmetic. A pair costs ~400 f32 operations
// (16 half-plane clips per pass, each with a division) against 4 bytes
// written, far above the card's ~20 operations per byte in f32. The design
// gives one thread per pair column and a strip of rows, keeps the strip's
// row boxes in shared memory, writes the output row-coalesced, and skips
// all arithmetic for zero-filled pairs, so NMS pays for the live upper
// triangle only. No tensor cores: the work is divisions and selects.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // columns per block
constexpr int kRows = 16;       // rows per block

struct Quad {
  float x[4];
  float y[4];
};

// Corners (tl, tr, br, bl) of (cx, cy, w, h, t) rotated by
// R(t) = [[c, -s], [s, c]]; evaluated in the order of the plain version.
__device__ __forceinline__ Quad corners(float cx, float cy, float w, float h,
                                        float c, float s) {
  const float sx[4] = {-0.5f, 0.5f, 0.5f, -0.5f};
  const float sy[4] = {-0.5f, -0.5f, 0.5f, 0.5f};
  Quad q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float dx = sx[i] * w;
    const float dy = sy[i] * h;
    q.x[i] = c * dx - s * dy + cx;
    q.y[i] = s * dx + c * dy + cy;
  }
  return q;
}

// Sum over A's edges of (t_hi - t_lo) * cross(P, D), [t_lo, t_hi] being the
// part of the edge inside quad B.
__device__ __forceinline__ float edges_integral(const Quad& a, const Quad& b,
                                                bool strict) {
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float px = a.x[i];
    const float py = a.y[i];
    const float dx = a.x[(i + 1) & 3] - px;
    const float dy = a.y[(i + 1) & 3] - py;
    float t_lo = 0.0f;
    float t_hi = 1.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float qx = b.x[j];
      const float qy = b.y[j];
      const float ex = b.x[(j + 1) & 3] - qx;
      const float ey = b.y[(j + 1) & 3] - qy;
      const float c0 = ex * (py - qy) - ey * (px - qx);
      const float dc = ex * dy - ey * dx;
      const bool par = fabsf(dc) < 1e-12f;
      const float t_x = -c0 / (par ? 1.0f : dc);
      if (!par && dc > 0.0f) t_lo = fmaxf(t_lo, t_x);
      if (!par && dc < 0.0f) t_hi = fminf(t_hi, t_x);
      const bool reject = strict ? (c0 <= 0.0f) : (c0 < 0.0f);
      if (par && reject) t_hi = -1.0f;
    }
    const float span = fmaxf(t_hi - t_lo, 0.0f);
    total += span * (px * dy - py * dx);
  }
  return total;
}

__global__ void __launch_bounds__(kThreads)
rotated_iou_kernel(const float* __restrict__ boxes1,
                   const float* __restrict__ boxes2,
                   const int* __restrict__ valid_count,
                   float* __restrict__ out, int N, int M, int iof,
                   int upper_only, int tile_r, int tile_c) {
  __shared__ float rows[kRows][5];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kRows;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const float* b1 = boxes1 + static_cast<size_t>(b) * N * 5;
  for (int t = threadIdx.x; t < kRows * 5; t += kThreads) {
    const int r = i0 + t / 5;
    rows[t / 5][t % 5] = r < N ? b1[static_cast<size_t>(r) * 5 + t % 5] : 0.f;
  }
  __syncthreads();
  if (j >= M) return;

  const int v = valid_count ? valid_count[b] : 0x7fffffff;
  const float* q = boxes2 + (static_cast<size_t>(b) * M + j) * 5;
  const float cx2 = q[0], cy2 = q[1], w2 = q[2], h2 = q[3];
  const float c2 = cosf(q[4]), s2 = sinf(q[4]);
  const float area2 = w2 * h2;
  const int col_tile0 = (j / tile_c) * tile_c;
  float* o = out + (static_cast<size_t>(b) * N) * M + j;

  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
    if (i >= N) break;
    const int row_tile0 = (i / tile_r) * tile_r;
    bool skip = row_tile0 >= v || col_tile0 >= v;
    if (upper_only) skip = skip || row_tile0 >= col_tile0 + tile_c;
    float res = 0.0f;
    if (!skip) {
      const float cx1 = rows[r][0], cy1 = rows[r][1];
      const float w1 = rows[r][2], h1 = rows[r][3];
      const float mx = (cx1 + cx2) * 0.5f;
      const float my = (cy1 + cy2) * 0.5f;
      const Quad qa = corners(cx1 - mx, cy1 - my, w1, h1, cosf(rows[r][4]),
                              sinf(rows[r][4]));
      const Quad qb = corners(cx2 - mx, cy2 - my, w2, h2, c2, s2);
      const float s1 = edges_integral(qa, qb, false);
      const float s2i = edges_integral(qb, qa, true);
      const float inter = fabsf(s1 + s2i) * 0.5f;
      const float area1 = w1 * h1;
      const float denom = iof ? area1 : area1 + area2 - inter;
      res = inter / fmaxf(denom, 1e-14f);
    }
    o[static_cast<size_t>(i) * M] = res;
  }
}

}  // namespace

extern "C" int r3det_rotated_iou(const void* boxes1, const void* boxes2,
                                 const void* valid_count, void* out, int B,
                                 int N, int M, int mode, int upper_only,
                                 int tile_r, int tile_c, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0) return 0;
  const dim3 grid((M + kThreads - 1) / kThreads, (N + kRows - 1) / kRows, B);
  rotated_iou_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes1), static_cast<const float*>(boxes2),
      static_cast<const int*>(valid_count), static_cast<float*>(out), N, M,
      mode, upper_only, tile_r, tile_c);
  return static_cast<int>(cudaGetLastError());
}
