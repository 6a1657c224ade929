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

#include <climits>
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

// the backward reads x as the output gradient g and writes out as dfeat
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

// the launch parameters of L levels (x, feat, out: 16-byte aligned bf16);
// false on an argument the kernels do not take
bool make_params(Params& p, int L, const void* const* x,
                 const void* const* feat, const void* const* rois,
                 void* const* out, const int* H,
                 const int* W, const float* scale, const void* trig, int B,
                 int C, int points, int quirk) {
  if (L < 1 || L > kMaxLevels || B < 0 || C <= 0 || C % kVec != 0 ||
      (points != 1 && points != 5) || (points == 5 && trig == nullptr))
    return false;
  p = Params{};
  long long tiles = 0, cells = 0;
  for (int l = 0; l < L; ++l) {
    if (H[l] < 0 || W[l] < 0 || !aligned16(x[l]) ||
        (feat != nullptr && !aligned16(feat[l])) || !aligned16(out[l]))
      return false;
    Level& v = p.lv[l];
    v.x = static_cast<const __nv_bfloat16*>(x[l]);
    v.feat = feat ? static_cast<const __nv_bfloat16*>(feat[l]) : nullptr;
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
    if (tiles > 0x7fffffffLL || cells > 0x7fffffffLL) return false;
  }
  p.trig = static_cast<const float*>(trig);
  p.L = L;
  p.C = C;
  p.tiles = static_cast<int>(tiles);
  p.cells = static_cast<int>(cells);
  p.quirk = quirk;
  return true;
}

int frm_levels(int L, const void* const* x, const void* const* feat,
               const void* const* rois, void* const* out, const int* H,
               const int* W, const float* scale, const void* trig, int B,
               int C, int points, int quirk, void* stream) {
  Params p;
  if (feat == nullptr ||
      !make_params(p, L, x, feat, rois, out, H, W, scale, trig, B, C, points,
                   quirk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.tiles == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return points == 1 ? launch<1, 1>(p, s) : launch<5, 1>(p, s);
}

// ---------------------------------------------------------------------------
// The backward: dfeat_l = bf16(g_l + acc_l), acc_l = S_l^T g_l in f32
// (dx_l = g_l needs no kernel).
//
// No TPU kernel stands behind it: on the TPU the gradient is XLA's
// scatter-add from autodiff of r3det_tpu/models/frm.py::bilinear_sample.
// S_l^T sends each cell's gradient row, times the f32 weight of each corner
// its points read in the forward (the same inside test, clamp and weights,
// point_setup), onto those corner rows.
//
// The sum is a gather in a fixed order, so the result is deterministic and
// equal bit for bit to ops/frm_sample.py::frm_sample_levels_bwd_ordered.
// The contributions of a level and image are numbered e = ((cell * P) + q)
// * 4 + k (cell row-major, k the corner in bilinear_sample's order y0x0,
// y0x1, y1x0, y1x1); each corner row sums its contributions' f32 products
// w * g_cell in ascending e from +0.0f, each product rounded and then added.
// A row with more than kChunk contributions sums consecutive chunks of
// kChunk ids (in ascending e) from +0.0f each, then adds the chunk sums in
// order from +0.0f. A row that no point reads gets g + 0.0f.
//
// One cooperative launch for all levels of a stage, five phases split by
// grid barriers (the contribution id e runs over all levels and images):
// 1. setup: a thread a point runs point_setup and writes its 4 (corner row,
//    weight) slots at e, counting each row's contributions with int
//    atomics (the counts do not depend on the order);
// 2. each block sums the counts of its range of rows;
// 3. each block scans its range on top of the sums before it: the row
//    offsets of a CSR map, a cursor a row, and the list of long rows;
// 4. fill: each e goes into its row's segment through the row's cursor
//    (an int atomic: the order within a segment is not yet fixed);
// 5. sort and gather: a warp a row of at most kChunk ids ranks its ids
//    (unique, so the ranks are) into shared memory and walks them in
//    order, a lane 8 channels (one 16-byte bf16 vector of a 256-channel g
//    row), four rows of g in flight, then writes bf16(g + acc) once; a
//    block a long row sorts its ids through a bitmap in shared memory and
//    sums a kChunk-id chunk a warp, adding the chunk sums in order.
// No float atomics and no f32 buffer: the workspace is the (row, weight)
// slots and the CSR ids, 12 bytes a contribution, and per-row ints.
// What bounds it on the H100: g is read once a contribution (4P times a
// row, mostly from the 50 MB L2) and once more for its own row, dfeat
// written once; the four grid barriers and the atomics of phases 1 and 4
// come on top (perf/k2_bwd.py times the phases).
// ---------------------------------------------------------------------------

constexpr int kChunk = 256;          // ids a chunk of a long row
constexpr int kMaxGrid = 1024;       // blocks of the backward at most
constexpr int kBitmapWords = 2048;   // a long row's sort window: 65536 ids
constexpr int kRankSlots = kChunk / 32;
// debug switches for perf/k2_bwd.py (the outputs are then wrong): stop
// after phase kStopAfter (0..5), walk the ids unsorted, sort but skip the
// gather, stamp the phases' ends (block 0, %globaltimer) into the stamps
constexpr int kStopAfter = 5;
constexpr bool kCutSort = false;
constexpr bool kCutGather = false;
constexpr bool kPhaseClock = false;

// the workspace of R rows and N contribution slots (N a multiple of 4):
// zeroed: count (R, then each row's cursor), the barrier, the long-row
// count, 8 stamps; ws: offs (R + 1), block sums, long rows (R), slot rows
// (N; phase 5 reuses them for a long row's sorted ids), slot weights (N),
// CSR ids (N)
struct Work {
  int* count;
  unsigned int* barrier;
  int* nlong;
  unsigned long long* stamps;
  int* offs;
  int* bsum;
  int* longs;
  int* key;
  float* w;
  int* csr;
};

inline size_t round4(size_t n) { return (n + 3) & ~size_t{3}; }

inline size_t zeroed_ints(size_t R) { return round4(R) + 4 + 16; }
inline size_t ws_ints(size_t R, size_t N) {
  return round4(R + 1) + kMaxGrid + round4(R) + 3 * N;
}

Work make_work(int* zeroed, int* ws, size_t R, size_t N) {
  Work k;
  k.count = zeroed;
  k.barrier = reinterpret_cast<unsigned int*>(zeroed + round4(R));
  k.nlong = zeroed + round4(R) + 1;
  k.stamps = reinterpret_cast<unsigned long long*>(zeroed + round4(R) + 4);
  k.offs = ws;
  k.bsum = k.offs + round4(R + 1);
  k.longs = k.bsum + kMaxGrid;
  k.key = k.longs + round4(R);
  k.w = reinterpret_cast<float*>(k.key + N);
  k.csr = k.key + 2 * N;
  return k;
}

// a grid-wide barrier for a cooperative launch (every block resident):
// the n-th barrier of a launch waits until *count reaches n * gridDim.x
__device__ __forceinline__ void grid_barrier(unsigned int* count,
                                             unsigned int& target) {
  target += gridDim.x;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(count, 1u);
    while (*reinterpret_cast<volatile unsigned int*>(count) < target)
      __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void stamp(const Work& k, int i) {
  if (kPhaseClock && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    k.stamps[i] = t;
  }
}

__device__ __forceinline__ int level_of(const Params& p, int cell) {
  int l = 0;
  while (l + 1 < p.L && cell >= p.lv[l + 1].cell_begin) ++l;
  return l;
}

// the block's sum of v (every thread gets it); s holds kWarps ints
__device__ __forceinline__ int block_sum(int v, int* s) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) s[warp] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) t += s[i];
  return t;
}

// the block's exclusive scan of v; total gets the block's sum; s holds
// kWarps ints
__device__ __forceinline__ int block_scan(int v, int* s, int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const int u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  __syncthreads();
  if (lane == 31) s[warp] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    before += i < warp ? s[i] : 0;
    total += s[i];
  }
  return before + inc - v;
}

// phase 1: the 4 slots of point q of every cell, a thread a point
template <int P>
__device__ __forceinline__ void setup_slots(const Params& p, const Work& k) {
  const int points = p.cells * P;
  for (int t = blockIdx.x * kThreads + threadIdx.x; t < points;
       t += gridDim.x * kThreads) {
    const int gcell = t / P, q = t - gcell * P;
    const Level& v = p.lv[level_of(p, gcell)];
    const int local = gcell - v.cell_begin;
    const int img = local - local % (v.H * v.W) + v.cell_begin;
    float roi[5];
#pragma unroll
    for (int i = 0; i < 5; ++i)
      roi[i] = __ldg(v.rois + static_cast<size_t>(local) * 5 + i);
    const Geo g = point_setup(
        roi, q, P == 5 ? __ldg(p.trig + gcell) : 0.0f,
        P == 5 ? __ldg(p.trig + p.cells + gcell) : 0.0f, v.scale, p.quirk,
        v.H, v.W);
    int4 key = make_int4(-1, -1, -1, -1);
    if (g.idx.x >= 0) {
      key = make_int4(img + g.idx.x, img + g.idx.y, img + g.idx.z,
                      img + g.idx.w);
      atomicAdd(k.count + key.x, 1);
      atomicAdd(k.count + key.y, 1);
      atomicAdd(k.count + key.z, 1);
      atomicAdd(k.count + key.w, 1);
    }
    reinterpret_cast<int4*>(k.key)[t] = key;
    reinterpret_cast<float4*>(k.w)[t] = g.w;
  }
}

// the rows [r0, r1) of this block
__device__ __forceinline__ void block_rows(const Params& p, int& r0,
                                           int& r1) {
  const int per = (p.cells + gridDim.x - 1) / gridDim.x;
  r0 = min(static_cast<int>(blockIdx.x) * per, p.cells);
  r1 = min(r0 + per, p.cells);
}

// phase 3: offs and cursors of the block's rows, and its long rows
__device__ __forceinline__ void scan_rows(const Params& p, const Work& k,
                                          int* s) {
  int r0, r1;
  block_rows(p, r0, r1);
  const int before = blockIdx.x;
  int carry = 0;
  for (int i = threadIdx.x; i < before; i += kThreads)
    carry += __ldcg(k.bsum + i);
  carry = block_sum(carry, s);
  for (int base = r0; base < r1; base += kThreads) {
    const int r = base + threadIdx.x;
    const int n = r < r1 ? __ldcg(k.count + r) : 0;
    int total;
    const int off = carry + block_scan(n, s, total);
    if (r < r1) {
      k.offs[r] = off;
      k.count[r] = off;
      if (n > kChunk) k.longs[atomicAdd(k.nlong, 1)] = r;
    }
    carry += total;
  }
  if (r1 == p.cells && r0 < r1 && threadIdx.x == 0) k.offs[p.cells] = carry;
}

// g's row of cell gcell (a cell of level v), channels from c
__device__ __forceinline__ const __nv_bfloat16* g_row(const Level& v, int C,
                                                      int gcell, int c) {
  return v.x + static_cast<size_t>(gcell - v.cell_begin) * C + c;
}

// acc += w[id] * g[cell of id] over ids[0..n) in order, channels c..c+8;
// four rows in flight
template <int P>
__device__ __forceinline__ void gather(const Level& v, int C, int c,
                                       const int* ids, int n,
                                       const float* w, float (&acc)[kVec]) {
  for (int t = 0; t < n; t += 4) {
    float wt[4];
    uint4 gv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (t + u < n) {
        const int id = ids[t + u];
        wt[u] = __ldcg(w + id);
        gv[u] = load_keep(g_row(v, C, id / (4 * P), c));
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (t + u < n) {
        float f[kVec];
        unpack(gv[u], f);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(wt[u], f[e]));
      }
    }
  }
}

// dfeat's row r (of level v) = bf16(g + acc), channels c..c+8
__device__ __forceinline__ void finish(const Level& v, int C, int r, int c,
                                       const float (&acc)[kVec]) {
  float f[kVec];
  unpack(load_keep(g_row(v, C, r, c)), f);
#pragma unroll
  for (int e = 0; e < kVec; ++e) f[e] = __fadd_rn(f[e], acc[e]);
  *reinterpret_cast<uint4*>(v.out + static_cast<size_t>(r - v.cell_begin) *
                                        C + c) = pack(f);
}

// phase 5, a row of n <= kChunk ids at csr[beg..], one warp: rank the ids
// into sorted (shared, kChunk ints; tmp the same), then gather in order
template <int P>
__device__ __forceinline__ void short_row(const Params& p, const Work& k,
                                          int r, int beg, int n, int* tmp,
                                          int* sorted, int lane) {
  if (kCutSort) {
    for (int i = lane; i < n; i += 32) sorted[i] = __ldcg(k.csr + beg + i);
  } else if (n <= 32) {
    const int id = lane < n ? __ldcg(k.csr + beg + lane) : INT_MAX;
    int rank = 0;
    for (int t = 0; t < 32; ++t)
      rank += __shfl_sync(0xffffffffu, id, t) < id;
    if (lane < n) sorted[rank] = id;
  } else {
    for (int i = lane; i < n; i += 32) tmp[i] = __ldcg(k.csr + beg + i);
    __syncwarp();
    int mine[kRankSlots], rank[kRankSlots];
#pragma unroll
    for (int j = 0; j < kRankSlots; ++j) {
      mine[j] = lane + 32 * j < n ? tmp[lane + 32 * j] : INT_MAX;
      rank[j] = 0;
    }
    for (int t = 0; t < n; ++t) {
      const int u = tmp[t];
#pragma unroll
      for (int j = 0; j < kRankSlots; ++j) rank[j] += u < mine[j];
    }
#pragma unroll
    for (int j = 0; j < kRankSlots; ++j)
      if (lane + 32 * j < n) sorted[rank[j]] = mine[j];
  }
  __syncwarp();
  if (kCutGather) return;
  const Level& v = p.lv[level_of(p, r)];
  for (int c = lane * kVec; c < p.C; c += kWarpChannels) {
    float acc[kVec] = {};
    gather<P>(v, p.C, c, sorted, n, k.w, acc);
    finish(v, p.C, r, c, acc);
  }
  __syncwarp();
}

// phase 5, a row of n > kChunk ids at csr[beg..], the whole block: sort
// the ids into key[beg..] through a bitmap window of the id range, then a
// warp a kChunk-id chunk, the chunk sums added in order by warp 0
template <int P>
__device__ __forceinline__ void long_row(const Params& p, const Work& k,
                                         int r, unsigned int* bitmap,
                                         float* part, int* s) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int beg = __ldcg(k.offs + r), n = __ldcg(k.offs + r + 1) - beg;
  int* sorted = k.key + beg;
  int lo = INT_MAX, hi = -1;
  for (int i = tid; i < n; i += kThreads) {
    const int id = __ldcg(k.csr + beg + i);
    lo = min(lo, id);
    hi = max(hi, id);
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  __syncthreads();
  if (lane == 0) {
    s[warp] = lo;
    s[kWarps + warp] = hi;
  }
  __syncthreads();
  for (int i = 0; i < kWarps; ++i) {
    lo = min(lo, s[i]);
    hi = max(hi, s[kWarps + i]);
  }
  constexpr int kBits = kBitmapWords * 32;
  constexpr int kWordsEach = kBitmapWords / kThreads;
  int done = 0;
  for (long long w0 = lo; w0 <= hi; w0 += kBits) {
    if (kCutSort) {
      for (int i = tid; i < n; i += kThreads)
        sorted[i] = __ldcg(k.csr + beg + i);
      break;
    }
    for (int i = tid; i < kBitmapWords; i += kThreads) bitmap[i] = 0u;
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      const long long d = __ldcg(k.csr + beg + i) - w0;
      if (d >= 0 && d < kBits)
        atomicOr(bitmap + (d >> 5), 1u << (d & 31));
    }
    __syncthreads();
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kWordsEach; ++j)
      cnt += __popc(bitmap[tid * kWordsEach + j]);
    int total;
    int pos = done + block_scan(cnt, s + 2 * kWarps, total);
#pragma unroll
    for (int j = 0; j < kWordsEach; ++j) {
      unsigned int bits = bitmap[tid * kWordsEach + j];
      while (bits) {
        const int b = __ffs(bits) - 1;
        sorted[pos++] = static_cast<int>(w0 + (tid * kWordsEach + j) * 32 +
                                         b);
        bits &= bits - 1;
      }
    }
    done += total;
    __syncthreads();
  }
  __syncthreads();
  if (kCutGather) return;
  const Level& v = p.lv[level_of(p, r)];
  const int chunks = (n + kChunk - 1) / kChunk;
  for (int c0 = 0; c0 < p.C; c0 += kWarpChannels) {
    const int c = c0 + lane * kVec;
    float total[kVec] = {};
    for (int j0 = 0; j0 < chunks; j0 += kWarps) {
      const int j = j0 + warp;
      if (j < chunks && c < p.C) {
        float acc[kVec] = {};
        gather<P>(v, p.C, c, sorted + j * kChunk, min(kChunk, n - j * kChunk),
                  k.w, acc);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          part[warp * kWarpChannels + lane * kVec + e] = acc[e];
      }
      __syncthreads();
      if (warp == 0 && c < p.C) {
        for (int i = 0; i < kWarps && j0 + i < chunks; ++i)
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            total[e] = __fadd_rn(total[e],
                                 part[i * kWarpChannels + lane * kVec + e]);
      }
      __syncthreads();
    }
    if (warp == 0 && c < p.C) finish(v, p.C, r, c, total);
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads, 4)
    frm_sample_bwd_kernel(const __grid_constant__ Params p, const Work k) {
  __shared__ int s_ids[kWarps][2][kChunk];
  __shared__ unsigned int s_bitmap[kBitmapWords];
  __shared__ float s_part[kWarps * kWarpChannels];
  __shared__ int s_red[3 * kWarps];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  unsigned int target = 0;
  stamp(k, 0);
  if (kStopAfter < 1) return;
  setup_slots<P>(p, k);
  grid_barrier(k.barrier, target);
  stamp(k, 1);
  if (kStopAfter < 2) return;
  {
    int r0, r1, n = 0;
    block_rows(p, r0, r1);
    for (int r = r0 + tid; r < r1; r += kThreads) n += __ldcg(k.count + r);
    n = block_sum(n, s_red);
    if (tid == 0) k.bsum[blockIdx.x] = n;
  }
  grid_barrier(k.barrier, target);
  stamp(k, 2);
  if (kStopAfter < 3) return;
  scan_rows(p, k, s_red);
  grid_barrier(k.barrier, target);
  stamp(k, 3);
  if (kStopAfter < 4) return;
  const int slots = p.cells * P;            // int4 groups of 4 slots
  for (int t = blockIdx.x * kThreads + tid; t < slots;
       t += gridDim.x * kThreads) {
    const int4 key = __ldcg(reinterpret_cast<const int4*>(k.key) + t);
    if (key.x < 0) continue;
    const int e = 4 * t;
    k.csr[atomicAdd(k.count + key.x, 1)] = e;
    k.csr[atomicAdd(k.count + key.y, 1)] = e + 1;
    k.csr[atomicAdd(k.count + key.z, 1)] = e + 2;
    k.csr[atomicAdd(k.count + key.w, 1)] = e + 3;
  }
  grid_barrier(k.barrier, target);
  stamp(k, 4);
  if (kStopAfter < 5) return;
  const int nlong = *reinterpret_cast<volatile int*>(k.nlong);
  for (int i = blockIdx.x; i < nlong; i += gridDim.x)
    long_row<P>(p, k, __ldcg(k.longs + i), s_bitmap, s_part, s_red);
  for (int r = blockIdx.x * kWarps + warp; r < p.cells;
       r += gridDim.x * kWarps) {
    const int beg = __ldcg(k.offs + r), n = __ldcg(k.offs + r + 1) - beg;
    if (n <= kChunk)
      short_row<P>(p, k, r, beg, n, s_ids[warp][0], s_ids[warp][1], lane);
  }
  if (kPhaseClock) {
    grid_barrier(k.barrier, target);
    stamp(k, 5);
  }
}

template <int P>
int launch_bwd(const Params& p, const Work& k, cudaStream_t stream) {
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
        &blocks, frm_sample_bwd_kernel<P>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    occupancy[dev] = blocks;
  }
  // a cooperative launch: at most every block resident at once, so the
  // grid barrier cannot wait on a block that has not started
  long grid = static_cast<long>(occupancy[dev]) * sm_count[dev];
  if (grid > kMaxGrid) grid = kMaxGrid;
  const long rows_of = (static_cast<long>(p.cells) + kWarps - 1) / kWarps;
  if (grid > rows_of) grid = rows_of;
  Params params = p;
  Work work = k;
  void* args[] = {&params, &work};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(frm_sample_bwd_kernel<P>),
      dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int frm_levels_bwd(int L, const void* const* g, const void* const* rois,
                   void* const* dfeat, const int* H, const int* W,
                   const float* scale, const void* trig, void* zeroed,
                   long long zeroed_n, void* ws, long long ws_n, int B,
                   int C, int points, int quirk, void* stream) {
  Params p;
  if (zeroed == nullptr || ws == nullptr ||
      !make_params(p, L, g, nullptr, rois, dfeat, H, W, scale, trig, B, C,
                   points, quirk) ||
      p.cells > 0x7fffffff / (4 * points))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t R = p.cells, N = static_cast<size_t>(p.cells) * points * 4;
  if (zeroed_n < static_cast<long long>(zeroed_ints(R)) ||
      ws_n < static_cast<long long>(ws_ints(R, N)) ||
      !aligned16(zeroed) || !aligned16(ws))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.cells == 0) return 0;
  const Work k = make_work(static_cast<int*>(zeroed), static_cast<int*>(ws),
                           R, N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return points == 1 ? launch_bwd<1>(p, k, s) : launch_bwd<5>(p, k, s);
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

// the backward of r3det_frm_sample_levels for dfeat, one launch: host
// arrays of the L levels' gradient g (bf16, the forward's out layout),
// rois and dfeat (bf16) pointers, H, W and scales; trig as the forward's;
// zeroed: an int32 workspace of zeroed_n ints, all 0 (at least
// round4(R) + 20 for R = B * sum(H * W) rows); ws: an int32 workspace of
// ws_n ints (at least round4(R + 1) + 1024 + round4(R) + 3 * N, N = 4 *
// points * R); both 16-byte aligned
extern "C" int r3det_frm_sample_bwd(
    int L, const void* const* g, const void* const* rois, void* const* dfeat,
    const int* H, const int* W, const float* scale, const void* trig,
    void* zeroed, long long zeroed_n, void* ws, long long ws_n, int B, int C,
    int points, int quirk, void* stream) {
  return frm_levels_bwd(L, g, rois, dfeat, H, W, scale, trig, zeroed,
                        zeroed_n, ws, ws_n, B, C, points, quirk, stream);
}

// one level, points=1 (the same kernel)
extern "C" int r3det_frm_sample(const void* x, const void* feat,
                                const void* rois, void* out, int B, int H,
                                int W, int C, float scale, int quirk,
                                void* stream) {
  return frm_levels(1, &x, &feat, &rois, &out, &H, &W, &scale, nullptr, B, C,
                    1, quirk, stream);
}
