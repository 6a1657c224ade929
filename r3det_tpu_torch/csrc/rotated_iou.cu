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
// (tile_r x 128 pair tiles): with upper_only, a tile whose first row is at
// or past the end of its column range is zero; with valid_count, a tile
// whose first row or first column is at or past the image's live count is
// zero. valid_count is read from device memory, one int32 per image, so
// the caller never syncs with the host.
//
// What bounds it on the H100. A pair that overlaps costs ~500 f32
// operations (16 half-plane clips per pass, each with a division), but in
// NMS-sized scenes only a few percent of pairs can overlap at all: two
// boxes whose circumcircles are disjoint have IoU exactly 0. So the design
// is one block per pair tile, in three passes:
//   1. each box of the tile's rows and columns is read once, and its
//      cos/sin, area and circumradius go to shared memory;
//   2. every pair is tested for the cull: far if d^2 > (r1 + r2)^2 *
//      (1 + 2^-10) on the raw centres. A far pair stores +0 (what the
//      integral gives for disjoint quads) at once, a warp's stores
//      coalesced; a near pair is appended to a shared list of (row,
//      column) tile indices, one shared atomicAdd per warp;
//   3. all threads walk the near list densely and run the integral.
// A tile the zero-fill rules skip only stores zeros, 16 bytes a thread
// where rows allow. What is left to move is the (B, N, M) f32 output,
// written once: that write is the kernel's bound. Measured, the zero path
// runs at fill speed, the integral and the trig cost little, and the rest
// is pass 2's serial chain of a ballot, a shared atomicAdd and a shuffle
// per 32-pair row (perf/k1_iou.py, PERF.md). The cull test fails on NaN
// and inf (a non-finite box gets a NaN radius, and d^2 must be finite),
// so such pairs take the integral and give the plain version's NaN. The
// pair arithmetic is the plain version's operation for operation, built
// with --fmad=false: the result is bit-equal to it. No tensor cores: the
// work is divisions and selects.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileC = 128;      // pair-tile columns
constexpr int kMaxTileR = 64;    // pair-tile rows, at most
constexpr float kMargin = 1.0f + 1.0f / 1024.0f;   // cull margin on d^2

// per-box values in shared memory, one plane each
enum { kCx, kCy, kW, kH, kCos, kSin, kArea, kRad, kPlanes };

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

// One box's values into plane slot k (stride: the planes' length).
__device__ __forceinline__ void stage_box(const float* __restrict__ p,
                                          float* planes, int stride, int k) {
  const float cx = p[0], cy = p[1], w = p[2], h = p[3], t = p[4];
  const bool finite = isfinite(cx) && isfinite(cy) && isfinite(w) &&
                      isfinite(h) && isfinite(t);
  planes[kCx * stride + k] = cx;
  planes[kCy * stride + k] = cy;
  planes[kW * stride + k] = w;
  planes[kH * stride + k] = h;
  planes[kCos * stride + k] = cosf(t);
  planes[kSin * stride + k] = sinf(t);
  planes[kArea * stride + k] = w * h;
  planes[kRad * stride + k] =
      finite ? 0.5f * sqrtf(w * w + h * h) : CUDART_NAN_F;
}

// Zeros over rows [i0, i0 + rows) x columns [j0, j0 + cols) of o.
__device__ __forceinline__ void zero_tile(float* __restrict__ o, int i0,
                                          int j0, int rows, int cols, int M) {
  if ((M & 3) == 0) {
    // rows are 16-byte aligned and cols is a multiple of 4
    const int q = cols >> 2;
    for (int t = threadIdx.x; t < rows * q; t += kThreads) {
      const int r = t / q;
      float4* row =
          reinterpret_cast<float4*>(o + static_cast<size_t>(i0 + r) * M + j0);
      row[t - r * q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int t = threadIdx.x; t < rows * cols; t += kThreads) {
      const int r = t / cols;
      o[static_cast<size_t>(i0 + r) * M + j0 + t - r * cols] = 0.0f;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
rotated_iou_kernel(const float* __restrict__ boxes1,
                   const float* __restrict__ boxes2,
                   const int* __restrict__ valid_count,
                   float* __restrict__ out, int N, int M, int iof,
                   int upper_only, int tile_r) {
  __shared__ float rb[kPlanes * kMaxTileR];
  __shared__ float cb[kPlanes * kTileC];
  __shared__ uint16_t near_list[kMaxTileR * kTileC];
  __shared__ int near_count;

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * tile_r;
  const int j0 = blockIdx.x * kTileC;
  const int rows = min(tile_r, N - i0);
  const int cols = min(kTileC, M - j0);
  float* o = out + static_cast<size_t>(b) * N * M;

  const int v = valid_count ? valid_count[b] : 0x7fffffff;
  bool skip = i0 >= v || j0 >= v;
  if (upper_only) skip = skip || i0 >= j0 + kTileC;
  if (skip) {
    zero_tile(o, i0, j0, rows, cols, M);
    return;
  }

  // pass 1: per-box values, once per block
  for (int t = threadIdx.x; t < rows + cols; t += kThreads) {
    if (t < rows) {
      stage_box(boxes1 + (static_cast<size_t>(b) * N + i0 + t) * 5, rb,
                kMaxTileR, t);
    } else {
      stage_box(boxes2 + (static_cast<size_t>(b) * M + j0 + t - rows) * 5, cb,
                kTileC, t - rows);
    }
  }
  if (threadIdx.x == 0) near_count = 0;
  __syncthreads();

  // pass 2: a warp takes 32 columns of one row at a time; far pairs store
  // zero, near pairs join the list
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int jc = (warp & 3) * 32 + lane;
  const bool col_ok = jc < cols;
  const float cx2 = cb[kCx * kTileC + jc], cy2 = cb[kCy * kTileC + jc];
  const float r2 = cb[kRad * kTileC + jc];
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int r = warp >> 2; r < rows; r += kThreads / kTileC) {
    const float dx = cx2 - rb[kCx * kMaxTileR + r];
    const float dy = cy2 - rb[kCy * kMaxTileR + r];
    const float d2 = dx * dx + dy * dy;
    const float sr = rb[kRad * kMaxTileR + r] + r2;
    const bool far = d2 > sr * sr * kMargin && d2 < CUDART_INF_F;
    if (col_ok && far) o[static_cast<size_t>(i0 + r) * M + j0 + jc] = 0.0f;
    const bool near = col_ok && !far;
    const unsigned mask = __ballot_sync(0xffffffffu, near);
    if (mask) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&near_count, __popc(mask));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (near) {
        near_list[base + __popc(mask & lanes_below)] =
            static_cast<uint16_t>(r * kTileC + jc);
      }
    }
  }
  __syncthreads();

  // pass 3: the integral, near pairs only
  const int n_near = near_count;
  for (int e = threadIdx.x; e < n_near; e += kThreads) {
    const int r = near_list[e] / kTileC;
    const int c = near_list[e] % kTileC;
    const float cx1 = rb[kCx * kMaxTileR + r], cy1 = rb[kCy * kMaxTileR + r];
    const float w1 = rb[kW * kMaxTileR + r], h1 = rb[kH * kMaxTileR + r];
    const float ccx = cb[kCx * kTileC + c], ccy = cb[kCy * kTileC + c];
    const float mx = (cx1 + ccx) * 0.5f;
    const float my = (cy1 + ccy) * 0.5f;
    const Quad qa =
        corners(cx1 - mx, cy1 - my, w1, h1, rb[kCos * kMaxTileR + r],
                rb[kSin * kMaxTileR + r]);
    const Quad qb = corners(ccx - mx, ccy - my, cb[kW * kTileC + c],
                            cb[kH * kTileC + c], cb[kCos * kTileC + c],
                            cb[kSin * kTileC + c]);
    const float s1 = edges_integral(qa, qb, false);
    const float s2 = edges_integral(qb, qa, true);
    const float inter = fabsf(s1 + s2) * 0.5f;
    const float area1 = rb[kArea * kMaxTileR + r];
    const float denom = iof ? area1 : area1 + cb[kArea * kTileC + c] - inter;
    o[static_cast<size_t>(i0 + r) * M + j0 + c] =
        inter / fmaxf(denom, 1e-14f);
  }
}

}  // namespace

extern "C" int r3det_rotated_iou(const void* boxes1, const void* boxes2,
                                 const void* valid_count, void* out, int B,
                                 int N, int M, int mode, int upper_only,
                                 int tile_r, int tile_c, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0) return 0;
  if (tile_c != kTileC || tile_r < 1 || tile_r > kMaxTileR)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kTileC - 1) / kTileC, (N + tile_r - 1) / tile_r, B);
  if (grid.y > 65535 || grid.z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  rotated_iou_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes1), static_cast<const float*>(boxes2),
      static_cast<const int*>(valid_count), static_cast<float*>(out), N, M,
      mode, upper_only, tile_r);
  return static_cast<int>(cudaGetLastError());
}
