// LSKNet's attention and MLP sub-blocks on the bf16 serving path
// (models/lsknet.py, Block.forward; ops/lsk_attn.py::attention,
// ops/lsk_mlp.py::mlp), as seven kernels around six products (cuBLAS on
// the NHWC view, no bias, outside any kernel). Every map is (B, H, W,
// channels) bf16, contiguous. The attention:
//
// lsk_bias_gelu: P, proj_1's product of x (norm1 folded into its weight),
//   -> v = GELU(P + b1), in place in P.
// lsk_taps: v (C channels) -> A (2C channels), a1 = conv0(v) + b0 (5x5
//   depthwise, pad 2) in channels [0, C) and a2 = conv_spatial(a1) + bs
//   (7x7 depthwise, dilation 3, pad 9) in [C, 2C): what conv1 and conv2
//   read, as one product with a block-diagonal weight.
// lsk_select: B, that product ([b1 | b2] before their biases) -> m (C/2):
//   the biases added on load, each position's channel mean and max of
//   both, conv_squeeze (2 -> 2, 7x7, pad 3) and the sigmoid in float32,
//   s rounded to bf16, then m = b1 * s0 + b2 * s1.
// lsk_bias_gate: the product of m by conv -> v * (it + b), in place.
// lsk_bias_residual: the product of that by proj_2 -> x + ls * (it + b2 +
//   u), in place, with the shortcut u = norm1(x) = x * inv + shift
//   recomputed from x.
//
// The MLP:
//
// lsk_dw_gelu: h, fc1's product of x (norm2 folded into its weight; hidden
//   channels) -> GELU(dwconv(h + b1) + bd), a new map: h + b1 zero outside
//   the map (dwconv pads fc1's output), the 3x3 depthwise taps, their bias
//   and exact GELU in float32, rounded once.
// lsk_bias_scale: fc2's product of that -> x + ls * (it + b2), in place.
//
// Numerics (ops/lsk_attn.py and ops/lsk_mlp.py have each plain form): the
// eager route's roundings, each op computed in float32 on bf16 operands
// and rounded to bf16 as PyTorch's bf16 kernels round: a bias add rounds,
// GELU is erf's, the gate's and the layer scale's products are exact in
// float32 (bf16 times bf16) and round once with their sums (addcmul), u is
// BN's addcmul.
// The taps sum in float32 and round a1 and a2 once each, bias included
// (the eager route rounds the conv, then the bias add); a1 is rounded to
// bf16 before the dilated taps read it, as the eager route stores it, and
// is zero outside the map, since conv_spatial pads its input with zeros
// (not conv0 of the padding). The selection sums each half's channels in
// float32 and adds the halves, divides by C, and takes conv_squeeze in
// float32 with no TF32 rounding; sums run in other orders than PyTorch's,
// so a value may land on the neighbouring bf16. The build's --fmad=false
// keeps each product and sum apart, so the taps and conv_squeeze spell
// their multiply-adds fmaf, or they would run at half rate.
//
// lsk_dw_gelu rounds only its result: fc1's bias, the taps, their bias
// and GELU stay in float32 between, where the eager route rounds fc1's
// output, the conv, its bias add and GELU. Its taps sum in another order
// than the plain form's conv, with fc1's bias split off (b1 times the
// taps' sum), so a value may land on the neighbouring bf16.
//
// No TPU kernel stands behind them: the JAX package has no LSKNet.
//
// What bounds them (NVIDIA H100 SXM: 3.35 TB/s, 67 TFLOP/s float32 on the
// CUDA cores). A stage-1 block at batch 8 of 1024^2 (256^2 positions of 64
// channels, 524,288 a batch): the taps do 74 multiply-adds a channel and
// position, 4.96 GFLOP (0.074 ms), and move 201 MB (0.060 ms): the CUDA
// cores bound them at stages 1-3. The others are bound by their bytes:
// the selection reads 64 MB and writes 32 MB (0.029 ms), each epilogue
// reads and writes 64 MB, the gate and the residual read 64 MB more
// (0.038 / 0.057 ms). Design:
// - lsk_taps: a block a 32 x 32 tile and 8 channels (a 16-byte vector a
//   position; the channel slice varies fastest over the grid, so the
//   blocks that share a tile's lines run together). v over the tile and
//   a halo of 11 goes to shared memory by cp.async (zeros outside the
//   map); a1 over the tile and a halo of 9 is computed there and kept as
//   bf16 (zeros outside the map); a2 over the tile from it. A thread owns
//   a channel pair (bf16x2 words, conflict-free: 8 positions x 4 pairs a
//   warp) and a strip of outputs down a column, so each word it loads
//   feeds several outputs: 10 consecutive rows of a1 (70 loads for 500
//   fmaf), 6 rows 3 apart of a2 (84 loads for 588 fmaf), the taps'
//   weights in registers. Both outputs leave as 16-byte stores from
//   shared memory.
// - lsk_select: a block a tile (32, 16 or 8 a side, the largest that
//   gives two blocks an SM) of one image, two blocks an SM. Its channel
//   sums and maxes over the tile and a halo of 3, 8 lanes a position and
//   four positions a lane in flight; conv_squeeze and the sigmoid a
//   position a thread from shared memory; then m in 16-byte vectors, four
//   a thread in flight, B read a second time (from L2, mostly). The loads
//   are what it waits on: one position at a time, 241 registers and one
//   block an SM, it took 0.197 ms at stage 1.
// - the epilogues (as csrc/conv_epilogue.cu): a thread owns one 8-channel
//   slice for the launch, its per-channel vectors in registers, and
//   strides over the map two 16-byte vectors at a time, as many blocks as
//   the SMs hold. lsk_bias_scale is the residual's template without the
//   shortcut (a template parameter: the residual's code is unchanged).
// - lsk_dw_gelu: bound by its bytes at every stage. At stage 1 (256^2
//   positions of 512 hidden channels, batch 8) it reads and writes 537 MB
//   each (0.320 ms) and does 28 float32 operations an element, 7.5 GFLOP
//   (0.112 ms); but the erf takes some 27 instructions an element on this
//   card, the taps 9 and their operands' unpacking 3, so the SMs'
//   instruction rate is what it meets first: 0.59 ms at stage 1 (H100
//   80GB HBM3, 700 W), 0.45 with the erf left out. Tiles of 16 columns
//   and 16, 8 or 4 rows (the most that gives each resident block two
//   tiles or more) and a slice of 64 channels, so that a position's slice
//   is one 128-byte line and every 32-byte sector moved is used whole
//   (lsk_taps' 8-channel vectors use half of each). A persistent block keeps one slice, its taps in
//   registers, and walks tiles with two buffers in shared memory: the
//   next tile and its halo of 1 go in by cp.async, 16 bytes a copy, while
//   it computes the current one. fc1's bias is not added to the map:
//   outside the map the buffer holds -b1 (exact, b1 being bf16), and each
//   output adds b1 times the sum of its channel's taps, which reads fc1's
//   output h + b1 inside the map and zero outside, as dwconv pads it. A
//   thread owns four channels (8-byte words: a warp reads two positions'
//   256 contiguous bytes, conflict-free) and a column of the tile;
//   walking down the column, each word it reads feeds up to three rows of
//   outputs, each written (8 bytes, a warp's two whole lines) as soon as
//   its last row has arrived.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the two bf16 of a 32-bit word as floats (exact)
__device__ __forceinline__ float lo_of(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_of(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float lane(const uint4& u, int k) {
  return __bfloat162float(reinterpret_cast<const bf16*>(&u)[k]);
}

__device__ __forceinline__ uint4 load16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// max as torch.amax takes it: NaN wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

int device_index(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return *dev >= 64 ? static_cast<int>(cudaErrorInvalidDevice) : 0;
}

// ---------------------------------------------------------------------------
// lsk_taps
// ---------------------------------------------------------------------------

constexpr int kTapThreads = 256;
constexpr int kTile = 32;                  // output tile side
constexpr int kHalo1 = 9;                  // conv_spatial's reach: 3 * 3
constexpr int kHalo0 = kHalo1 + 2;         // and conv0's
constexpr int kA1 = kTile + 2 * kHalo1;    // 50: a1's side in shared memory
constexpr int kV = kTile + 2 * kHalo0;     // 54: v's
constexpr int kSlice = 8;                  // channels a block
constexpr int kTaps0 = 25, kTaps1 = 49;
constexpr int kRows0 = 10;                 // a1 rows of a strip
constexpr int kRows1 = 6;                  // a2 rows of a strip, 3 apart
constexpr int kPairThreads = kTapThreads / 4;   // threads of a channel pair
constexpr size_t kTapSmem =
    (kV * kV + kA1 * kA1) * sizeof(uint4) +
    ((kTaps0 + kTaps1) * kSlice + 2 * kSlice) * sizeof(float);

static_assert(kA1 % kRows0 == 0, "a1 strips tile its rows");
static_assert(kTile * kTile * sizeof(uint4) <= kV * kV * sizeof(uint4),
              "a2 is staged where v was");

__global__ void __launch_bounds__(kTapThreads, 2)
lsk_taps_kernel(const bf16* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ b0, const float* __restrict__ bs,
                bf16* __restrict__ out, int H, int W, int C, int tiles_x,
                int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* sv = reinterpret_cast<uint4*>(smem);            // kV x kV
  uint4* sa = sv + kV * kV;                              // kA1 x kA1
  float* sw = reinterpret_cast<float*>(sa + kA1 * kA1);  // (74, 8)
  float* sb = sw + (kTaps0 + kTaps1) * kSlice;           // b0, bs (8 each)

  const int tid = threadIdx.x;
  const int slices = C / kSlice;
  const int slice = blockIdx.x % slices;
  const int rest = blockIdx.x / slices;
  const int tile = rest % tiles;
  const long long img = rest / tiles;
  const int ty0 = (tile / tiles_x) * kTile, tx0 = (tile % tiles_x) * kTile;
  const int c0 = slice * kSlice;

  for (int i = tid; i < (kTaps0 + kTaps1) * kSlice; i += kTapThreads)
    sw[i] = w[(i / kSlice) * C + c0 + i % kSlice];
  if (tid < kSlice) {
    sb[tid] = b0[c0 + tid];
    sb[kSlice + tid] = bs[c0 + tid];
  }
  // v over the tile and a halo of 11, zeros outside the map
  const bf16* vimg = v + img * H * W * C + c0;
  for (int i = tid; i < kV * kV; i += kTapThreads) {
    const int y = ty0 - kHalo0 + i / kV, x = tx0 - kHalo0 + i % kV;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    cp_async16(smem_addr(sv + i),
               in ? vimg + (static_cast<long long>(y) * W + x) * C : vimg,
               in ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  const int p = tid & 3;                     // channels c0 + 2p, c0 + 2p + 1
  const uint32_t* svw = reinterpret_cast<const uint32_t*>(sv);
  uint32_t* saw = reinterpret_cast<uint32_t*>(sa);

  // a1 = conv0(v) + b0 over the tile and a halo of 9: an item is a column
  // and 10 rows of it
  {
    float k0[kTaps0][2];
#pragma unroll
    for (int t = 0; t < kTaps0; ++t) {
      k0[t][0] = sw[t * kSlice + 2 * p];
      k0[t][1] = sw[t * kSlice + 2 * p + 1];
    }
    const float bias0 = sb[2 * p], bias1 = sb[2 * p + 1];
    for (int item = tid >> 2; item < kA1 * (kA1 / kRows0);
         item += kPairThreads) {
      const int col = item % kA1, r0 = (item / kA1) * kRows0;
      float acc[kRows0][2];
#pragma unroll
      for (int o = 0; o < kRows0; ++o) acc[o][0] = acc[o][1] = 0.0f;
#pragma unroll
      for (int j = 0; j < kRows0 + 4; ++j) {
        const uint32_t* row = svw + ((r0 + j) * kV + col) * 4 + p;
#pragma unroll
        for (int kx = 0; kx < 5; ++kx) {
          const uint32_t word = row[4 * kx];
          const float lo = lo_of(word), hi = hi_of(word);
#pragma unroll
          for (int o = 0; o < kRows0; ++o) {
            const int ky = j - o;
            if (ky < 0 || ky > 4) continue;
            acc[o][0] = fmaf(k0[ky * 5 + kx][0], lo, acc[o][0]);
            acc[o][1] = fmaf(k0[ky * 5 + kx][1], hi, acc[o][1]);
          }
        }
      }
      const int x = tx0 - kHalo1 + col;
      const bool x_in = x >= 0 && x < W;
#pragma unroll
      for (int o = 0; o < kRows0; ++o) {
        const int y = ty0 - kHalo1 + r0 + o;
        // zero outside the map: conv_spatial pads a1 with zeros
        saw[((r0 + o) * kA1 + col) * 4 + p] =
            x_in && y >= 0 && y < H
                ? pack_bf16(acc[o][0] + bias0, acc[o][1] + bias1)
                : 0u;
      }
    }
  }
  __syncthreads();

  // a2 = conv_spatial(a1) + bs over the tile: an item is a column and 6
  // rows 3 apart (rows r0 + 3o, r0 = class + 18 * half), staged where v was
  uint32_t* stage = reinterpret_cast<uint32_t*>(sv);
  {
    float k1[kTaps1][2];
#pragma unroll
    for (int t = 0; t < kTaps1; ++t) {
      k1[t][0] = sw[(kTaps0 + t) * kSlice + 2 * p];
      k1[t][1] = sw[(kTaps0 + t) * kSlice + 2 * p + 1];
    }
    const float bias0 = sb[kSlice + 2 * p], bias1 = sb[kSlice + 2 * p + 1];
    for (int item = tid >> 2; item < kTile * 6; item += kPairThreads) {
      const int col = item % kTile, strip = item / kTile;
      const int r0 = strip % 3 + 18 * (strip / 3);
      float acc[kRows1][2];
#pragma unroll
      for (int o = 0; o < kRows1; ++o) acc[o][0] = acc[o][1] = 0.0f;
#pragma unroll
      for (int j = 0; j < kRows1 + 6; ++j) {
        const int ar = r0 + 3 * j;          // feeds only rows past the tile
        if (ar >= kA1) break;
        const uint32_t* row = saw + (ar * kA1 + col) * 4 + p;
#pragma unroll
        for (int kx = 0; kx < 7; ++kx) {
          const uint32_t word = row[12 * kx];
          const float lo = lo_of(word), hi = hi_of(word);
#pragma unroll
          for (int o = 0; o < kRows1; ++o) {
            const int ky = j - o;
            if (ky < 0 || ky > 6) continue;
            acc[o][0] = fmaf(k1[ky * 7 + kx][0], lo, acc[o][0]);
            acc[o][1] = fmaf(k1[ky * 7 + kx][1], hi, acc[o][1]);
          }
        }
      }
#pragma unroll
      for (int o = 0; o < kRows1; ++o) {
        const int r = r0 + 3 * o;
        if (r < kTile)
          stage[(r * kTile + col) * 4 + p] =
              pack_bf16(acc[o][0] + bias0, acc[o][1] + bias1);
      }
    }
  }
  __syncthreads();

  // a1 and a2 of the tile, 16 bytes a position each
  bf16* oimg = out + img * H * W * 2 * C + c0;
  for (int i = tid; i < kTile * kTile; i += kTapThreads) {
    const int r = i / kTile, col = i % kTile;
    const int y = ty0 + r, x = tx0 + col;
    if (y >= H || x >= W) continue;
    bf16* o = oimg + (static_cast<long long>(y) * W + x) * 2 * C;
    *reinterpret_cast<uint4*>(o) = sa[(r + kHalo1) * kA1 + col + kHalo1];
    *reinterpret_cast<uint4*>(o + C) = sv[i];
  }
}

// ---------------------------------------------------------------------------
// lsk_select
// ---------------------------------------------------------------------------

constexpr int kSelThreads = 256;
constexpr int kSelMax = 32;                // largest tile side
constexpr int kSq = 3;                     // conv_squeeze's reach
constexpr int kSqSide = kSelMax + 2 * kSq;
constexpr int kGroup = 8;                  // lanes a position's sums
constexpr int kSelAhead = 4;               // positions a lane has in flight

// one position's bias-added channels, 8 at a time from this lane's vectors
// (every kGroup-th): the sum of each half and the max
__device__ __forceinline__ void position_stats(const bf16* row,
                                               const float* cb, int l, int c8,
                                               int half8, float& s1,
                                               float& s2, float& m) {
  for (int k = l; k < c8; k += kGroup) {
    const uint4 val = load16(row + k * 8);
    const float4 lo = *reinterpret_cast<const float4*>(cb + k * 8);
    const float4 hi = *reinterpret_cast<const float4*>(cb + k * 8 + 4);
    const float bias[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    float s = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float f = round_bf16(lane(val, e) + bias[e]);
      s += f;
      m = nan_max(m, f);
    }
    if (k < half8) s1 += s; else s2 += s;
  }
}

__global__ void __launch_bounds__(kSelThreads, 2)
lsk_select_kernel(const bf16* __restrict__ b, const float* __restrict__ cb,
                  const float* __restrict__ wq, const float* __restrict__ bq,
                  bf16* __restrict__ out, int H, int W, int C, int tile,
                  int tiles_x, int tiles) {
  __shared__ float2 sstat[kSqSide * kSqSide];       // (mean, max)
  __shared__ float2 ss[kSelMax * kSelMax];           // (s0, s1)
  __shared__ float4 sq[49];   // a tap's (w00, w01, w10, w11), w[out][in]

  const int tid = threadIdx.x;
  const int t = blockIdx.x % tiles;
  const long long img = blockIdx.x / tiles;
  const int ty0 = (t / tiles_x) * tile, tx0 = (t % tiles_x) * tile;
  const int c8 = C / 8, half8 = c8 / 2;
  const bf16* bimg = b + img * H * W * C;
  if (tid < 49)
    sq[tid] = make_float4(wq[tid], wq[49 + tid], wq[98 + tid], wq[147 + tid]);

  // each position's channel mean and max over the tile and a halo of 3
  // (zeros outside the map: conv_squeeze pads them so), kSelAhead
  // positions a lane at a time so their loads overlap; every lane runs
  // every round, so the group's shuffles see all 32 lanes
  const int side = tile + 2 * kSq, n = side * side;
  const int l = tid & (kGroup - 1);
  constexpr int kPer = kSelThreads / kGroup;           // positions a pass
  for (int base = 0; base < n; base += kSelAhead * kPer) {
    float s1[kSelAhead], s2[kSelAhead], m[kSelAhead];
    bool in[kSelAhead];
#pragma unroll
    for (int q = 0; q < kSelAhead; ++q) {
      const int pos = base + q * kPer + tid / kGroup;
      const int y = ty0 - kSq + pos / side, x = tx0 - kSq + pos % side;
      in[q] = pos < n && y >= 0 && y < H && x >= 0 && x < W;
      s1[q] = s2[q] = 0.0f;
      m[q] = -CUDART_INF_F;
      if (in[q])
        position_stats(bimg + (static_cast<long long>(y) * W + x) * C, cb, l,
                       c8, half8, s1[q], s2[q], m[q]);
    }
#pragma unroll
    for (int q = 0; q < kSelAhead; ++q) {
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1) {
        s1[q] += __shfl_xor_sync(0xffffffffu, s1[q], off);
        s2[q] += __shfl_xor_sync(0xffffffffu, s2[q], off);
        m[q] = nan_max(m[q], __shfl_xor_sync(0xffffffffu, m[q], off));
      }
      const int pos = base + q * kPer + tid / kGroup;
      if (l == 0 && pos < n) {
        sstat[pos] = in[q] ? make_float2(
                                 (s1[q] + s2[q]) / static_cast<float>(C), m[q])
                           : make_float2(0.0f, 0.0f);
      }
    }
  }
  __syncthreads();

  // s = sigmoid(conv_squeeze([mean, max])), rounded to bf16
  for (int i = tid; i < tile * tile; i += kSelThreads) {
    const int r = i / tile, col = i % tile;
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 1
    for (int ky = 0; ky < 7; ++ky)
#pragma unroll
      for (int kx = 0; kx < 7; ++kx) {
        const float2 st = sstat[(r + ky) * side + col + kx];
        const float4 k = sq[ky * 7 + kx];
        a0 = fmaf(k.x, st.x, a0);
        a0 = fmaf(k.y, st.y, a0);
        a1 = fmaf(k.z, st.x, a1);
        a1 = fmaf(k.w, st.y, a1);
      }
    a0 = a0 + bq[0];
    a1 = a1 + bq[1];
    ss[i] = make_float2(round_bf16(1.0f / (1.0f + expf(-a0))),
                        round_bf16(1.0f / (1.0f + expf(-a1))));
  }
  __syncthreads();

  // m = bf16(b1 * s0) + b2 * s1, 16 bytes at a time, kSelAhead vectors a
  // thread in flight
  bf16* oimg = out + img * H * W * (C / 2);
  const int items = tile * tile * half8;
  for (int base = tid; base < items; base += kSelAhead * kSelThreads) {
    uint4 v1[kSelAhead], v2[kSelAhead];
    long long place[kSelAhead];
#pragma unroll
    for (int q = 0; q < kSelAhead; ++q) {
      const int i = base + q * kSelThreads;
      const int at = i / half8, k = i % half8;
      const int y = ty0 + at / tile, x = tx0 + at % tile;
      place[q] = i < items && y < H && x < W
                     ? static_cast<long long>(y) * W + x : -1;
      if (place[q] >= 0) {
        v1[q] = load16(bimg + place[q] * C + k * 8);
        v2[q] = load16(bimg + place[q] * C + C / 2 + k * 8);
      }
    }
#pragma unroll
    for (int q = 0; q < kSelAhead; ++q) {
      if (place[q] < 0) continue;
      const int i = base + q * kSelThreads;
      const int at = i / half8, k = i % half8;
      const float2 sw = ss[at];
      const float4* c1 = reinterpret_cast<const float4*>(cb + k * 8);
      const float4* c2 = reinterpret_cast<const float4*>(cb + C / 2 + k * 8);
      const float4 p0 = c1[0], p1 = c1[1], r0 = c2[0], r1 = c2[1];
      const float bias1[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float bias2[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
      uint4 o;
      bf16* h = reinterpret_cast<bf16*>(&o);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float f1 = round_bf16(lane(v1[q], e) + bias1[e]);
        const float f2 = round_bf16(lane(v2[q], e) + bias2[e]);
        h[e] = __float2bfloat16_rn(round_bf16(f1 * sw.x) + f2 * sw.y);
      }
      *reinterpret_cast<uint4*>(oimg + place[q] * (C / 2) + k * 8) = o;
    }
  }
}

// ---------------------------------------------------------------------------
// The epilogues
// ---------------------------------------------------------------------------

constexpr int kEpiThreads = 256;
constexpr int kUnroll = 2;                 // vectors a thread has in flight

enum Epilogue { kGelu = 0, kGate = 1, kResidual = 2, kScale = 3 };

template <int kMode>
__global__ void __launch_bounds__(kEpiThreads)
lsk_epilogue_kernel(bf16* a, const bf16* __restrict__ bias,
                    const bf16* __restrict__ r,
                    const bf16* __restrict__ inv,
                    const bf16* __restrict__ shift,
                    const bf16* __restrict__ ls, long long n_vec, int c8,
                    long long stride) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kEpiThreads + threadIdx.x;
  if (t >= stride) return;  // threads past the largest multiple of c8 idle
  const int c = static_cast<int>(t % c8) * 8;
  const uint4 bv = load16(bias + c);
  uint4 iv = bv, sv = bv, lv = bv;
  if (kMode == kResidual) {
    iv = load16(inv + c);
    sv = load16(shift + c);
  }
  if (kMode == kResidual || kMode == kScale) lv = load16(ls + c);
  constexpr float kAlpha = 0.70710678118654752440f;  // M_SQRT1_2
  for (long long base = t; base < n_vec; base += kUnroll * stride) {
    uint4 va[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i < n_vec) {
        va[u] = load16(a + i * 8);
        if (kMode != kGelu) vr[u] = load16(r + i * 8);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i >= n_vec) break;
      uint4 o;
      bf16* h = reinterpret_cast<bf16*>(&o);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float y = round_bf16(lane(va[u], k) + lane(bv, k));
        float z;
        if (kMode == kGelu) {
          z = y * 0.5f * (1.0f + erff(y * kAlpha));
        } else if (kMode == kGate) {
          z = lane(vr[u], k) * y;
        } else if (kMode == kScale) {
          z = lane(vr[u], k) + lane(lv, k) * y;
        } else {
          const float x = lane(vr[u], k);
          const float sc = round_bf16(x * lane(iv, k) + lane(sv, k));
          z = x + lane(lv, k) * round_bf16(y + sc);
        }
        h[k] = __float2bfloat16_rn(z);
      }
      *reinterpret_cast<uint4*>(a + i * 8) = o;
    }
  }
}

template <int kMode>
int launch_epilogue(void* a, const void* bias, const void* r,
                    const void* inv, const void* shift, const void* ls,
                    long long n_pix, int C, int sms, cudaStream_t stream) {
  static int occupancy[64] = {};
  int dev = 0;
  int err = device_index(&dev);
  if (err) return err;
  int& per_sm = occupancy[dev];
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lsk_epilogue_kernel<kMode>, kEpiThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int c8 = C / 8;
  const long long n_vec = n_pix * c8;
  const long long need = (n_vec + kEpiThreads - 1) / kEpiThreads;
  const long long full = static_cast<long long>(per_sm) * sms;
  const int grid = static_cast<int>(need < full ? need : full);
  // the largest multiple of c8 the grid's threads cover (n_vec >= c8)
  const long long stride =
      static_cast<long long>(grid) * kEpiThreads / c8 * c8;
  lsk_epilogue_kernel<kMode><<<grid, kEpiThreads, 0, stream>>>(
      static_cast<bf16*>(a), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(r), static_cast<const bf16*>(inv),
      static_cast<const bf16*>(shift), static_cast<const bf16*>(ls), n_vec,
      c8, stride);
  return static_cast<int>(cudaGetLastError());
}

bool bad_epilogue(long long n_pix, int C, int sms) {
  return C <= 0 || C % 8 || sms <= 0 || n_pix < 0;
}

// ---------------------------------------------------------------------------
// lsk_dw_gelu (the MLP sub-block)
// ---------------------------------------------------------------------------

constexpr int kDwThreads = 256;
constexpr int kDwCols = 16;                // tile columns: one a thread
constexpr int kDwSlice = 64;               // channels a block: 128 bytes a position
constexpr int kDwVecs = kDwSlice / 8;      // its 16-byte vectors
constexpr int kDwQuads = kDwSlice / 4;     // its 4-channel quads: threads a column
constexpr int kDwTaps = 9;
constexpr int kDwSide = kDwCols + 2;       // staged columns
static_assert(kDwQuads * kDwCols == kDwThreads, "a thread a quad and column");
static_assert(kDwSide * kDwVecs <= kDwThreads, "a thread stages a column");

template <int kRows>
__host__ __device__ constexpr int dw_buffer_vecs() {
  return (kRows + 2) * kDwSide * kDwVecs;
}

// h over one tile of one image and a halo of 1 into a buffer: cp.async
// inside the map; outside it, -b1 (exact: b1 is bf16), so that the sum of
// the taps plus b1 times the sum of the taps' weights reads fc1's output
// as zero there, as dwconv pads it. A thread stages one vector slot down
// one staged column (the block's first kDwSide * kDwVecs threads), so its
// source and destination only step by a row.
template <int kRows>
__device__ __forceinline__ void dw_stage(uint4* buf, const bf16* himg,
                                         uint4 pad, int ty0, int tx0, int vc,
                                         bool c_in, int H, int W, int C) {
  const int s = threadIdx.x / kDwVecs;
  if (s < kDwSide) {
    const int x = tx0 - 1 + s;
    const bool col_in = c_in && x >= 0 && x < W;
    const long long row = static_cast<long long>(W) * C;
    long long off = (ty0 - 1) * row + static_cast<long long>(x) * C + vc;
    uint4* dst = buf + s * kDwVecs + threadIdx.x % kDwVecs;
#pragma unroll
    for (int r = 0; r < kRows + 2; ++r, off += row, dst += kDwSide * kDwVecs) {
      const int y = ty0 - 1 + r;
      if (col_in && y >= 0 && y < H)
        cp_async16(smem_addr(dst), himg + off, 16);
      else
        *dst = pad;
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// A persistent block takes one 64-channel slice and walks tiles of it
// (tile t of every image, then t + per, ...), the next tile's copies in
// flight while it computes the current one from the other buffer.
template <int kRows>
__global__ void __launch_bounds__(kDwThreads, 2)
lsk_dw_gelu_kernel(const bf16* __restrict__ h, const bf16* __restrict__ b1,
                   const float* __restrict__ w, const float* __restrict__ bd,
                   bf16* __restrict__ out, int B, int H, int W, int C,
                   int tiles_x, int tiles) {
  // two buffers, addressed from dw_smem itself so that the compiler keeps
  // the shared window (an array of the two pointers made generic loads)
  extern __shared__ __align__(16) uint4 dw_smem[];
  constexpr int kBuffer = dw_buffer_vecs<kRows>();

  const int tid = threadIdx.x;
  const int slices = (C + kDwSlice - 1) / kDwSlice;
  const int slice = blockIdx.x % slices;     // the grid is slices x per
  const int per = gridDim.x / slices;
  const int items = B * tiles;              // the launcher keeps it < 2^30
  int item = blockIdx.x / slices;
  if (item >= items) return;
  const int c0 = slice * kDwSlice;

  // the vector slot this thread stages, and -b1 over it
  const int vc = c0 + (tid % kDwVecs) * 8;
  const bool c_in = vc < C;
  uint4 pad = make_uint4(0u, 0u, 0u, 0u);
  if (c_in) {
    pad = load16(b1 + vc);
    pad.x ^= 0x80008000u;
    pad.y ^= 0x80008000u;
    pad.z ^= 0x80008000u;
    pad.w ^= 0x80008000u;
  }

  // the quad and column this thread computes, its taps, and the constant
  // b1 * sum(taps) + bd that undoes the -b1 read inside the map
  const int q = tid % kDwQuads, col = tid / kDwQuads;
  const int c = c0 + 4 * q;
  const bool computes = c < C;
  float k[kDwTaps][4];
  float cb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (computes) {
#pragma unroll
    for (int t = 0; t < kDwTaps; ++t) {
      const float4 v = *reinterpret_cast<const float4*>(w + t * C + c);
      k[t][0] = v.x;
      k[t][1] = v.y;
      k[t][2] = v.z;
      k[t][3] = v.w;
    }
    const uint2 bb = *reinterpret_cast<const uint2*>(b1 + c);
    const float bias1[4] = {lo_of(bb.x), hi_of(bb.x), lo_of(bb.y),
                            hi_of(bb.y)};
    const float4 bv = *reinterpret_cast<const float4*>(bd + c);
    const float bias2[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float sum = 0.0f;
#pragma unroll
      for (int t = 0; t < kDwTaps; ++t) sum = sum + k[t][e];
      cb[e] = bias1[e] * sum + bias2[e];
    }
  }
  constexpr float kAlpha = 0.70710678118654752440f;  // M_SQRT1_2

  auto origin = [&](int it, int& ty0, int& tx0) {
    const int img = it / tiles, tile = it - img * tiles;
    ty0 = (tile / tiles_x) * kRows;
    tx0 = (tile % tiles_x) * kDwCols;
    return h + static_cast<long long>(img) * H * W * C;
  };
  {
    int ty0, tx0;
    const bf16* himg = origin(item, ty0, tx0);
    dw_stage<kRows>(dw_smem, himg, pad, ty0, tx0, vc, c_in, H, W, C);
  }
  for (int round = 0; item < items; ++round, item += per) {
    const int next = item + per;
    if (next < items) {
      int ny0, nx0;
      const bf16* nimg = origin(next, ny0, nx0);
      dw_stage<kRows>(dw_smem + ((round + 1) & 1) * kBuffer, nimg, pad, ny0,
                      nx0, vc, c_in, H, W, C);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();

    int ty0, tx0;
    const bf16* himg = origin(item, ty0, tx0);
    const int x = tx0 + col;
    if (computes) {
      // down the column: each staged word feeds up to three rows of
      // outputs, each written as soon as its last row has arrived
      const uint2* s2 =
          reinterpret_cast<const uint2*>(dw_smem + (round & 1) * kBuffer);
      bf16* orow = out + (himg - h) + static_cast<long long>(x) * C + c;
      float acc[kRows][4];
#pragma unroll
      for (int o = 0; o < kRows; ++o)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[o][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < kRows + 2; ++j) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const uint2 u = s2[(j * kDwSide + col + dx) * kDwQuads + q];
          const float f[4] = {lo_of(u.x), hi_of(u.x), lo_of(u.y),
                              hi_of(u.y)};
#pragma unroll
          for (int o = 0; o < kRows; ++o) {
            const int ky = j - o;
            if (ky < 0 || ky > 2) continue;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[o][e] = fmaf(k[ky * 3 + dx][e], f[e], acc[o][e]);
          }
        }
        const int o = j - 2;                 // its last row arrived
        if (o < 0) continue;
        const int y = ty0 + o;
        if (y >= H || x >= W) continue;
        float g[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float z = acc[o][e] + cb[e];
          g[e] = z * 0.5f * (1.0f + erff(z * kAlpha));
        }
        *reinterpret_cast<uint2*>(orow + static_cast<long long>(y) * W * C) =
            make_uint2(pack_bf16(g[0], g[1]), pack_bf16(g[2], g[3]));
      }
    }
    __syncthreads();                         // the buffer is staged again
  }
}

template <int kRows>
int launch_dw_gelu(const void* h, const void* b1, const void* w,
                   const void* bd, void* out, int B, int H, int W, int C,
                   int sms, cudaStream_t stream) {
  static int occupancy[64] = {};
  int dev = 0;
  int err = device_index(&dev);
  if (err) return err;
  constexpr size_t smem = 2 * dw_buffer_vecs<kRows>() * sizeof(uint4);
  int& per_sm = occupancy[dev];
  if (per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        lsk_dw_gelu_kernel<kRows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lsk_dw_gelu_kernel<kRows>, kDwThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int tiles_x = (W + kDwCols - 1) / kDwCols;
  const int tiles = ((H + kRows - 1) / kRows) * tiles_x;
  const long long items = static_cast<long long>(B) * tiles;
  if (items > 0x3fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int slices = (C + kDwSlice - 1) / kDwSlice;
  // blocks a slice: as many as the SMs hold in all, at most one an item
  long long per = static_cast<long long>(per_sm) * sms / slices;
  if (per < 1) per = 1;
  if (per > items) per = items;
  const long long blocks = per * slices;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  lsk_dw_gelu_kernel<kRows><<<static_cast<unsigned>(blocks), kDwThreads,
                              smem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(b1),
      static_cast<const float*>(w), static_cast<const float*>(bd),
      static_cast<bf16*>(out), B, H, W, C, tiles_x, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int r3det_lsk_taps(const void* v, const void* w, const void* b0,
                              const void* bs, void* out, int B, int H, int W,
                              int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (C <= 0 || C % kSlice) return static_cast<int>(cudaErrorInvalidValue);
  static bool sized[64] = {};
  int dev = 0;
  int err = device_index(&dev);
  if (err) return err;
  if (!sized[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        lsk_taps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kTapSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    sized[dev] = true;
  }
  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles = ((H + kTile - 1) / kTile) * tiles_x;
  const long long blocks = static_cast<long long>(B) * tiles * (C / kSlice);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  lsk_taps_kernel<<<static_cast<unsigned>(blocks), kTapThreads, kTapSmem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(v), static_cast<const float*>(w),
      static_cast<const float*>(b0), static_cast<const float*>(bs),
      static_cast<bf16*>(out), H, W, C, tiles_x, tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int r3det_lsk_select(const void* b, const void* cb, const void* wq,
                                const void* bq, void* out, int B, int H,
                                int W, int C, int tile, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (C <= 0 || C % 16 || tile <= 0 || tile > kSelMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (W + tile - 1) / tile;
  const int tiles = ((H + tile - 1) / tile) * tiles_x;
  const long long blocks = static_cast<long long>(B) * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  lsk_select_kernel<<<static_cast<unsigned>(blocks), kSelThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(b), static_cast<const float*>(cb),
      static_cast<const float*>(wq), static_cast<const float*>(bq),
      static_cast<bf16*>(out), H, W, C, tile, tiles_x, tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int r3det_lsk_bias_gelu(void* a, const void* bias, long long n_pix,
                                   int C, int sms, void* stream) {
  if (n_pix == 0) return 0;
  if (bad_epilogue(n_pix, C, sms))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_epilogue<kGelu>(a, bias, nullptr, nullptr, nullptr, nullptr,
                                n_pix, C, sms,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int r3det_lsk_bias_gate(void* a, const void* bias, const void* v,
                                   long long n_pix, int C, int sms,
                                   void* stream) {
  if (n_pix == 0) return 0;
  if (bad_epilogue(n_pix, C, sms) || v == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_epilogue<kGate>(a, bias, v, nullptr, nullptr, nullptr, n_pix,
                                C, sms, static_cast<cudaStream_t>(stream));
}

extern "C" int r3det_lsk_bias_residual(void* a, const void* bias,
                                       const void* x, const void* inv,
                                       const void* shift, const void* ls,
                                       long long n_pix, int C, int sms,
                                       void* stream) {
  if (n_pix == 0) return 0;
  if (bad_epilogue(n_pix, C, sms) || x == nullptr || inv == nullptr ||
      shift == nullptr || ls == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_epilogue<kResidual>(a, bias, x, inv, shift, ls, n_pix, C, sms,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" int r3det_lsk_bias_scale(void* a, const void* bias, const void* x,
                                    const void* ls, long long n_pix, int C,
                                    int sms, void* stream) {
  if (n_pix == 0) return 0;
  if (bad_epilogue(n_pix, C, sms) || x == nullptr || ls == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_epilogue<kScale>(a, bias, x, nullptr, nullptr, ls, n_pix, C,
                                 sms, static_cast<cudaStream_t>(stream));
}

extern "C" int r3det_lsk_dw_gelu(const void* h, const void* b1, const void* w,
                                 const void* bd, void* out, int B, int H,
                                 int W, int C, int rows, int sms,
                                 void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (C <= 0 || C % 8 || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 16: return launch_dw_gelu<16>(h, b1, w, bd, out, B, H, W, C, sms, s);
    case 8: return launch_dw_gelu<8>(h, b1, w, bd, out, B, H, W, C, sms, s);
    case 4: return launch_dw_gelu<4>(h, b1, w, bd, out, B, H, W, C, sms, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
