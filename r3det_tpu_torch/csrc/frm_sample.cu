// FRM feature refinement of up to eight pyramid levels in one launch:
//   out_l = x_l + (feat_l + acc_l),
//   acc_l[b, cell, :] = the bilinear sample of feat_l at the cell's
//                       best-box centre (points=1), or that sample followed
//                       by the samples at the box's four corners p1..p4
//                       (points=5), each rounded to bf16 and added to the
//                       running sum in bf16; a point outside
//                       (-1, H) x (-1, W) samples 0.
// x, feat and out are (B, H, W, C) bf16 NHWC (a channels_last NCHW tensor
// seen through permute), rois (B, H*W, 5) f32 image-coordinate boxes.
//
// Replaces the TPU kernel r3det_tpu/ops/frm_sample.py::bilinear_sample_band
// (_sample_kernel, _corner_window_setup, _outlier_correction) and the XLA
// gather it stood beside, r3det_tpu/models/frm.py::bilinear_sample, for
// points=1, and the XLA gathers of feature_refine_sample's points=5 form
// (:125-142). The arithmetic is the plain form's (ops/frm_sample.py:
// bilinear_sample, feature_refine_sample), with the reference's
// transposed-coordinate quirk (row <- cx * scale, col <- cy * scale) and
// corner weights in f32; built with --fmad=false it is bit-equal to it.
// The cos and sin of each box angle come from the caller (PyTorch's own
// cosf/sinf), so the corner points are the plain form's to the bit.
//
// What bounds it on the H100: memory for points=1. A cell moves x, feat
// and out (three C-wide rows) and reads 4 corner rows a point that lie
// within a few pixels of the cell's transpose, so they hit in L1/L2; ~2
// flops a byte. points=1 runs at the speed of the x, feat and out streams
// alone; points=5 is held by its 20 corner loads and sums a cell, which
// cap it at 2 blocks an SM (perf/k2_frm.py times both against cut-down
// copies). The design:
// - one launch for all levels: a persistent grid, sized by the SM count,
//   walks the flat range of 8 x 8-cell tiles of every level and image,
//   largest level first, so the small levels fill the tail of the large
//   one and each image's feature map is reused from L2 while it is hot;
// - a tile's rois (and cos/sin) are read once, coalesced, by the whole
//   block, one tile ahead; the block then computes every point's four
//   corner offsets and f32 weights once into shared memory;
// - one warp a cell: a lane holds 8 channels as one 16-byte vector, so a
//   256-channel row is one warp-wide load; every load of a cell (x, feat,
//   4 corners a point) is issued before the first is used; read-only
//   loads for feat, evict-first loads and stores for the x and out
//   streams.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kTile = 8;                       // a tile: kTile x kTile cells
constexpr int kTileCells = kTile * kTile;
constexpr int kWarps = kTile;                  // a warp per row of the tile
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 8;                        // bf16 channels in 16 bytes
constexpr int kWarpChannels = 32 * kVec;
constexpr int kRoiFloats = kTileCells * 5;
static_assert(kRoiFloats <= 2 * kThreads, "a tile's rois: two a thread");

struct Level {
  const __nv_bfloat16* x;
  const __nv_bfloat16* feat;
  const float* rois;
  __nv_bfloat16* out;
  int H, W;
  float scale;
  int tiles_w;       // tiles across the map
  int tiles_img;     // tiles of one image
  int tile_begin;    // the level's first tile in the flat tile range
  int cell_begin;    // its first cell in the flat cell range (trig)
};

struct Params {
  Level lv[kMaxLevels];
  const float* trig;  // points=5: (2, cells) cos, then sin, of each angle
  int L, C, tiles, cells, quirk;
};

// one sample point: its 4 corners' pixel indices in the image (x < 0:
// outside, the sample is 0) and their f32 weights
struct Geo {
  int4 idx;
  float4 w;
};

struct Tile {
  int l, b, i0, j0;
};

__device__ __forceinline__ Tile tile_of(const Params& p, int t) {
  int l = 0;
  while (l + 1 < p.L && t >= p.lv[l + 1].tile_begin) ++l;
  const Level& v = p.lv[l];
  const int local = t - v.tile_begin;
  const int b = local / v.tiles_img;
  const int r = local - b * v.tiles_img;
  const int ti = r / v.tiles_w;
  return Tile{l, b, ti * kTile, (r - ti * v.tiles_w) * kTile};
}

// a tile's rois (thread t holds floats t and t + kThreads of the tile's
// [row][col][5] block) and, for points=5, threads < 2 * kTileCells the cos
// (then sin) of one cell's angle
template <int P>
__device__ __forceinline__ void load_tile(const Params& p, const Tile& tl,
                                          int tid, float (&roi)[2],
                                          float& trig) {
  const Level& v = p.lv[tl.l];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int e = tid + k * kThreads;
    roi[k] = 0.0f;
    if (e < kRoiFloats) {
      const int ti = e / (kTile * 5);
      const int rem = e - ti * (kTile * 5);
      const int i = tl.i0 + ti, j = tl.j0 + rem / 5;
      if (i < v.H && j < v.W)
        roi[k] = __ldg(v.rois +
                       (static_cast<size_t>(tl.b * v.H + i) * v.W + tl.j0) *
                           5 +
                       rem);
    }
  }
  if (P == 5 && tid < 2 * kTileCells) {
    const int cell = tid % kTileCells;
    const int i = tl.i0 + cell / kTile, j = tl.j0 + cell % kTile;
    trig = 0.0f;
    if (i < v.H && j < v.W)
      trig = __ldg(p.trig + static_cast<size_t>(tid / kTileCells) * p.cells +
                   v.cell_begin + static_cast<size_t>(tl.b * v.H + i) * v.W +
                   j);
  }
}

// the plain form's bilinear_sample setup for one point, in its operation
// order: inside test, clamp, floor, f32 weights
__device__ __forceinline__ Geo corner_setup(float row, float col, int H,
                                            int W) {
  Geo g;
  const bool inside = row > -1.0f && row < static_cast<float>(H) &&
                      col > -1.0f && col < static_cast<float>(W);
  if (!inside) {
    g.idx = make_int4(-1, -1, -1, -1);
    g.w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return g;
  }
  const float py = fminf(fmaxf(row, 0.0f), static_cast<float>(H - 1));
  const float px = fminf(fmaxf(col, 0.0f), static_cast<float>(W - 1));
  const int y0 = static_cast<int>(floorf(py));
  const int x0 = static_cast<int>(floorf(px));
  const int y1 = min(y0 + 1, H - 1);
  const int x1 = min(x0 + 1, W - 1);
  const float ly = py - static_cast<float>(y0);
  const float lx = px - static_cast<float>(x0);
  const float hy = 1.0f - ly;
  const float hx = 1.0f - lx;
  g.idx = make_int4(y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1);
  g.w = make_float4(hy * hx, hy * lx, ly * hx, ly * lx);
  return g;
}

// sample point k of a cell (0: the centre; 1..4: the corners p1..p4), in
// feature_refine_sample's operation order
__device__ __forceinline__ Geo point_setup(const float* roi, int k,
                                           float cosa, float sina,
                                           float scale, int quirk, int H,
                                           int W) {
  const float cx = roi[0] * scale;
  const float cy = roi[1] * scale;
  float dx = 0.0f, dy = 0.0f;
  if (k > 0) {
    const float bw = roi[2] * scale;
    const float bh = roi[3] * scale;
    const float wx = cosa * bw / 2.0f, wy = sina * bw / 2.0f;
    const float hx = -sina * bh / 2.0f, hy = cosa * bh / 2.0f;
    // corner sign pairs on the (w, h) axis vectors: (1, 1), (-1, 1),
    // (-1, -1), (1, -1)
    const float sw = (k == 1 || k == 4) ? 1.0f : -1.0f;
    const float sh = k <= 2 ? 1.0f : -1.0f;
    dx = sw * wx + sh * hx;
    dy = sw * wy + sh * hy;
  }
  const float r0 = quirk ? cx : cy;
  const float c0 = quirk ? cy : cx;
  return k > 0 ? corner_setup(r0 + dy, c0 + dx, H, W)
               : corner_setup(r0, c0, H, W);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[kVec]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[k];
    const float2 t = __bfloat1622float2(h);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[kVec]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 load_keep(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// the 4 corner rows of one point, C channels from c (none when the point
// is outside)
__device__ __forceinline__ void load_corners(const __nv_bfloat16* f, int C,
                                             const int4& id,
                                             uint4 (&cv)[4]) {
  if (id.x < 0) return;
  cv[0] = load_keep(f + static_cast<size_t>(id.x) * C);
  cv[1] = load_keep(f + static_cast<size_t>(id.y) * C);
  cv[2] = load_keep(f + static_cast<size_t>(id.z) * C);
  cv[3] = load_keep(f + static_cast<size_t>(id.w) * C);
}

// one point's sample rounded to bf16 and added into the bf16 sum acc (the
// first point starts it)
__device__ __forceinline__ void add_point(const Geo& g, const uint4 (&cv)[4],
                                          bool first, float (&acc)[kVec]) {
  float s[kVec];
  if (g.idx.x < 0) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) s[e] = 0.0f;
  } else {
    float a[kVec], b[kVec], d[kVec], u[kVec];
    unpack(cv[0], a);
    unpack(cv[1], b);
    unpack(cv[2], d);
    unpack(cv[3], u);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      s[e] = g.w.x * a[e] + g.w.y * b[e] + g.w.z * d[e] + g.w.w * u[e];
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    acc[e] = first ? round_bf16(s[e]) : round_bf16(acc[e] + round_bf16(s[e]));
}

// K cells of one tile row, cells [j, j + K) of row i, one warp; geo holds
// the tile's points as [point][cell]. x, feat and the corner rows of the
// first kAhead + 1 points (all of them) are loaded before the first point
// is summed; the rows of point q + kAhead + 1 before point q is summed.
template <int P, int K>
__device__ __forceinline__ void run_cells(const Level& v, int C, size_t img,
                                          int i, int j, int cell,
                                          const Geo* geo, int lane) {
  constexpr int kAhead = P - 1;
  bool ok[K];
  size_t row[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ok[k] = j + k < v.W;
    row[k] = (img + static_cast<size_t>(i) * v.W + j + k) * C;
  }
  for (int c = lane * kVec; c < C; c += kWarpChannels) {
    const __nv_bfloat16* f = v.feat + img * C + c;
    uint4 xv[K], fv[K], cv[K][P][4];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!ok[k]) continue;
      xv[k] = __ldcs(reinterpret_cast<const uint4*>(v.x + row[k] + c));
      fv[k] = load_keep(v.feat + row[k] + c);
#pragma unroll
      for (int q = 0; q <= kAhead; ++q)
        load_corners(f, C, geo[q * kTileCells + cell + k].idx, cv[k][q]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!ok[k]) continue;
      float acc[kVec];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (q + kAhead + 1 < P) {
          const int n = q + kAhead + 1;
          load_corners(f, C, geo[n * kTileCells + cell + k].idx, cv[k][n]);
        }
        add_point(geo[q * kTileCells + cell + k], cv[k][q], q == 0, acc);
      }
      float xf[kVec], ff[kVec], o[kVec];
      unpack(xv[k], xf);
      unpack(fv[k], ff);
#pragma unroll
      for (int e = 0; e < kVec; ++e) o[e] = xf[e] + round_bf16(ff[e] + acc[e]);
      __stcs(reinterpret_cast<uint4*>(v.out + row[k] + c), pack(o));
    }
  }
}

// P points a cell; K cells in flight a warp. points=1 fits 4 blocks an SM
// (64 registers), points=5, with 20 corner vectors a lane, 2 (128).
template <int P, int K>
__global__ void __launch_bounds__(kThreads, P == 1 ? 4 : 2)
    frm_sample_kernel(const __grid_constant__ Params p) {
  __shared__ float s_roi[kRoiFloats];
  __shared__ float s_trig[2 * kTileCells];
  __shared__ Geo s_geo[P * kTileCells];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // tiles first, first + step, ... below last
  const int first = blockIdx.x, step = gridDim.x, last = p.tiles;
  float roi[2] = {0.0f, 0.0f};
  float trig = 0.0f;
  if (first < last) load_tile<P>(p, tile_of(p, first), tid, roi, trig);
  for (int t = first; t < last; t += step) {
    const Tile tl = tile_of(p, t);
    const Level& v = p.lv[tl.l];
    s_roi[tid] = roi[0];
    if (tid + kThreads < kRoiFloats) s_roi[tid + kThreads] = roi[1];
    if (P == 5 && tid < 2 * kTileCells) s_trig[tid] = trig;
    __syncthreads();
    // every point's corners and weights, once a tile
    for (int q = tid; q < P * kTileCells; q += kThreads) {
      const int cell = q % kTileCells;
      const int i = tl.i0 + cell / kTile, j = tl.j0 + cell % kTile;
      if (i < v.H && j < v.W)
        s_geo[q] = point_setup(
            s_roi + cell * 5, q / kTileCells, P == 5 ? s_trig[cell] : 0.0f,
            P == 5 ? s_trig[kTileCells + cell] : 0.0f, v.scale, p.quirk, v.H,
            v.W);
    }
    // the next tile's rois, in flight while this tile's cells run
    if (t < last - step)
      load_tile<P>(p, tile_of(p, t + step), tid, roi, trig);
    __syncthreads();
    const int i = tl.i0 + warp;
    if (i < v.H) {
      const size_t img = static_cast<size_t>(tl.b) * v.H * v.W;
      for (int jj = 0; jj < kTile; jj += K)
        run_cells<P, K>(v, p.C, img, i, tl.j0 + jj, warp * kTile + jj, s_geo,
                        lane);
    }
  }
}

template <int P, int K>
int launch(const Params& p, cudaStream_t stream) {
  // blocks a SM and SMs, found once per device
  static int occupancy[64] = {};
  static int sm_count[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (occupancy[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, frm_sample_kernel<P, K>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    occupancy[dev] = blocks;
  }
  const long resident = static_cast<long>(occupancy[dev]) * sm_count[dev];
  const int grid = static_cast<int>(p.tiles < resident ? p.tiles : resident);
  frm_sample_kernel<P, K><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

int frm_levels(int L, const void* const* x, const void* const* feat,
               const void* const* rois, void* const* out, const int* H,
               const int* W, const float* scale, const void* trig, int B,
               int C, int points, int quirk, void* stream) {
  if (L < 1 || L > kMaxLevels || B < 0 || C <= 0 || C % kVec != 0 ||
      (points != 1 && points != 5) || (points == 5 && trig == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  long long tiles = 0, cells = 0;
  for (int l = 0; l < L; ++l) {
    if (H[l] < 0 || W[l] < 0 || !aligned16(x[l]) || !aligned16(feat[l]) ||
        !aligned16(out[l]))
      return static_cast<int>(cudaErrorInvalidValue);
    Level& v = p.lv[l];
    v.x = static_cast<const __nv_bfloat16*>(x[l]);
    v.feat = static_cast<const __nv_bfloat16*>(feat[l]);
    v.rois = static_cast<const float*>(rois[l]);
    v.out = static_cast<__nv_bfloat16*>(out[l]);
    v.H = H[l];
    v.W = W[l];
    v.scale = scale[l];
    v.tiles_w = (W[l] + kTile - 1) / kTile;
    v.tiles_img = v.tiles_w * ((H[l] + kTile - 1) / kTile);
    v.tile_begin = static_cast<int>(tiles);
    v.cell_begin = static_cast<int>(cells);
    tiles += static_cast<long long>(v.tiles_img) * B;
    cells += static_cast<long long>(H[l]) * W[l] * B;
    if (tiles > 0x7fffffffLL || cells > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles == 0) return 0;
  p.trig = static_cast<const float*>(trig);
  p.L = L;
  p.C = C;
  p.tiles = static_cast<int>(tiles);
  p.cells = static_cast<int>(cells);
  p.quirk = quirk;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return points == 1 ? launch<1, 1>(p, s) : launch<5, 1>(p, s);
}

}  // namespace

// all levels of one FRM stage in one launch: host arrays of the L levels'
// pointers, sizes and scales; trig (2, sum of B*H*W) f32 for points=5, or
// NULL
extern "C" int r3det_frm_sample_levels(int L, const void* const* x,
                                       const void* const* feat,
                                       const void* const* rois,
                                       void* const* out, const int* H,
                                       const int* W, const float* scale,
                                       const void* trig, int B, int C,
                                       int points, int quirk, void* stream) {
  return frm_levels(L, x, feat, rois, out, H, W, scale, trig, B, C, points,
                    quirk, stream);
}

// one level, points=1 (the same kernel)
extern "C" int r3det_frm_sample(const void* x, const void* feat,
                                const void* rois, void* out, int B, int H,
                                int W, int C, float scale, int quirk,
                                void* stream) {
  return frm_levels(1, &x, &feat, &rois, &out, &H, &W, &scale, nullptr, B, C,
                    1, quirk, stream);
}
