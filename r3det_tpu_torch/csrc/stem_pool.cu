// ResNet stem kernels (K3, K3 int8, K4).
//
// K3: the fused stem in one pass: the folded 7x7/s2 stem conv on the
// space-to-depth(2) image (4x4 kernel, 12 -> 64 channels, zero padding
// top/left 2, bottom/right 1), the folded FrozenBN affine, ReLU, and the
// 3x3/s2 max-pool with -inf padding.
//   x12 (B, H, W, 12) bf16, 16-byte aligned, H and W even,
//   weights (4, 64, 56) bf16: [ky][co][kx * 12 + ci], zero past 48
//     (ops/stem_pool.py::pack_stem, made once per weight version),
//   scale, bias (64,) f32  ->  out (B, H/2, W/2, 64) bf16.
// K3 int8: the same pass with int8 codes: per-output-channel int8 weights
//   (4, 64, 80): [ky][co][kx * 16 + ci], zero for ci >= 12 and past 64,
//   and the input quantized on load with ascale = max(amax, 1e-8) / 127,
//   where amax = max|x| over the whole batch, read from device memory;
//   int32 sums on mma.sync m16n8k32 (s8), then one combined factor
//   acc * (scale * (ascale * kscale)) + bias, ReLU, the pool, bf16 out.
// K4: the 3x3/s2 -inf-padded max-pool alone, on the (B, H, W, 64) bf16
//   conv output of the unfused stem.
//
// Replaces the TPU kernels r3det_tpu/ops/stem_pool.py::
// stem_conv_pool_s2d4_pallas (_stem_s2d4_kernel), both variants, and
// pool_s2d4_pallas (_pool_s2d4_kernel); K3 also serves the bf16 function
// of stem_conv_pool_pallas and stem_conv_pool_pallas_grouped. The
// function is stem_conv_pool_reference (:453-477). The TPU kernel refolded
// the input to 48 channels (s2d4) because 12 channels fill 12 of 128
// lanes; here the conv is an implicit GEMM on the tensor cores instead.
// In bf16 one kernel row ky of a conv pixel is K = 48 contiguous values
// (4 input pixels x 12 channels of one NHWC row), three m16n8k16 steps
// with no padded channels; in int8 the input is quantized into 16-byte
// pixels (12 codes used) and one kernel row is two m16n8k32 steps. The
// s2d4 fold quantized its kernel per output channel, and each of its
// sub-pixel groups holds all 192 taps, so its scales are the per-channel
// scales of the unfolded kernel.
//
// Numerics: bf16 x bf16 products are exact in f32, so the f32 sums differ
// from any other f32 accumulation only by order; int8 sums are exact. The
// affine is a multiply then an add (no contraction, as in the plain
// version); the post-ReLU value is rounded to bf16 before pooling, as the
// reference does (the rounding is monotone, so the max commutes with it).
//
// What bounds it on the H100: per batch of 8 at 1024^2 it reads 50 MB and
// writes 67 MB (0.035 ms at 3.35 TB/s) and does 51.5 G useful operations
// (0.052 ms at the bf16 tensor-core peak, 0.026 in int8). Design: a
// persistent grid (as many blocks as fit on the SMs, two a SM) whose
// blocks each stage the weight pack (28 KB bf16, 20 KB int8) and the
// affine in shared memory once, then walk their share of the 4 x 16
// pooled-output tiles. A tile's input halo (12 rows x 36 pixels) is copied
// raw with 16-byte cp.async into one of two buffers while the previous
// tile runs its MMAs and its pool (the halo rows are contiguous NHWC runs;
// the rows' 8-byte misalignment is absorbed by copying from 8 bytes
// earlier). A tile computes the 9 x 33 conv pixels its pool windows read,
// as a flat list of 19 16-pixel fragments (4.6 conv pixels a pooled
// output); each warp takes two fragments at a time, so every weight
// fragment it loads feeds two MMAs. Affine + ReLU run on the accumulator
// registers and write the bf16 conv tile to shared memory, and the pool
// reads it there and stores 16 bytes a thread, so the full-size conv
// output never touches device memory. Packed rows and the conv tile are
// padded so that every fragment load and store is free of bank conflicts
// within an image row. K4 is one 16-byte load per window tap and thread
// (8 channels), bound by the read of the conv output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kCin = 12;
constexpr int kCout = 64;
constexpr int kK = 4;                      // conv kernel height and width
constexpr int kTP = 4;                     // pooled rows per tile
constexpr int kTQ = 16;                    // pooled cols per tile
constexpr int kCR = 2 * kTP + 1;           // conv rows per tile (9)
constexpr int kCC = 2 * kTQ + 1;           // conv cols per tile (33)
constexpr int kPix = kCR * kCC;            // conv pixels per tile (297)
constexpr int kFrags = (kPix + 15) / 16;   // 16-pixel fragments (19)
constexpr int kItems = (kFrags + 1) / 2;   // fragment pairs (10)
constexpr int kIR = kCR + kK - 1;          // halo rows (12)
constexpr int kIC = kCC + kK - 1;          // halo pixels a row (36)
// a raw halo row: from 8 bytes before its first pixel, in 16-byte chunks
constexpr int kRawRow = ((8 + kIC * kCin * 2) + 15) / 16 * 16;   // 880
constexpr int kChunks = kRawRow / 16;                            // 55
constexpr int kRawRowW = kRawRow / 4;      // in 32-bit words (220)
constexpr int kConvP = kCout + 8;          // conv tile pixel stride (bf16)
constexpr int kWRowBf = 56;                // packed bf16 (ky, co) row
constexpr int kWRowQ8 = 80;                // packed int8 (ky, co) row
constexpr int kWarps = 10;                 // one fragment pair a warp
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSM = 2;

// shared memory layout, in bytes
template <bool kQ8>
struct Smem {
  static constexpr int kW = kK * kCout * (kQ8 ? kWRowQ8 : kWRowBf * 2);
  static constexpr int kRaw = kIR * kRawRow;                // one buffer
  static constexpr int kQ = kQ8 ? kIR * kIC * 16 : 0;       // int8 halo
  static constexpr int kAff = 4 * 2 * kCout;
  static constexpr int kConv = 2 * kPix * kConvP;
  static constexpr int kOffRaw = kW;
  static constexpr int kOffQ = kOffRaw + 2 * kRaw;
  static constexpr int kOffAff = kOffQ + kQ;
  static constexpr int kOffConv = kOffAff + kAff;
  static constexpr int kTotal = kOffConv + kConv;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// all but the newest group of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// symmetric int8 code of v / ascale: round half to even, clip to +-127
__device__ __forceinline__ uint32_t q8_div(float v, float ascale) {
  const float q = fminf(fmaxf(rintf(v / ascale), -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

__device__ __forceinline__ uint32_t pack4(const __nv_bfloat16* v,
                                          float ascale) {
  return q8_div(__bfloat162float(v[0]), ascale) |
         (q8_div(__bfloat162float(v[1]), ascale) << 8) |
         (q8_div(__bfloat162float(v[2]), ascale) << 16) |
         (q8_div(__bfloat162float(v[3]), ascale) << 24);
}

// a pooled-output tile: image b, pooled rows i0.., cols j0..
struct Tile {
  int b, i0, j0;
};

__device__ __forceinline__ Tile tile_of(int t, int tiles_q, int tiles_p) {
  Tile tl;
  tl.j0 = (t % tiles_q) * kTQ;
  tl.i0 = ((t / tiles_q) % tiles_p) * kTP;
  tl.b = t / (tiles_q * tiles_p);
  return tl;
}

// Start the copy of a tile's raw input halo: input rows 2*i0 - 3 ..
// (12 rows), bytes from 8 before pixel 2*j0 - 3 (55 chunks a row). A chunk
// lies wholly inside or outside an image row (W * 24 and the chunk starts
// are multiples of 16), and chunks outside are zero-filled: the conv's
// zero padding.
__device__ __forceinline__ void load_halo(unsigned char* dst,
                                          const unsigned char* x, Tile tl,
                                          int H, int W) {
  const int row_bytes = W * kCin * 2;
  const int in_r0 = 2 * tl.i0 - 3;
  const int byte0 = (2 * tl.j0 - 3) * kCin * 2 - 8;
  const uint32_t base = smem_addr(dst);
  for (int i = threadIdx.x; i < kIR * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i - r * kChunks;
    const int gy = in_r0 + r, off = byte0 + 16 * ch;
    const bool in = gy >= 0 && gy < H && off >= 0 && off + 16 <= row_bytes;
    const unsigned char* src =
        in ? x + (static_cast<size_t>(tl.b) * H + gy) * row_bytes + off : x;
    cp_async16(base + r * kRawRow + 16 * ch, src, in ? 16 : 0);
  }
}

template <bool kQ8>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
stem_conv_pool_kernel(const __nv_bfloat16* __restrict__ x,
                      const void* __restrict__ wpack,
                      const float* __restrict__ amax,
                      const float* __restrict__ kscale,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int B, int H, int W) {
  using S = Smem<kQ8>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t* s_w = reinterpret_cast<const uint32_t*>(smem);
  unsigned char* s_raw = smem + S::kOffRaw;
  uint32_t* s_q = reinterpret_cast<uint32_t*>(smem + S::kOffQ);
  float* s_scale = reinterpret_cast<float*>(smem + S::kOffAff);
  float* s_bias = s_scale + kCout;
  __nv_bfloat16* s_conv =
      reinterpret_cast<__nv_bfloat16*>(smem + S::kOffConv);

  const int Hp = H / 2, Wp = W / 2;
  const int tiles_q = (Wp + kTQ - 1) / kTQ, tiles_p = (Hp + kTP - 1) / kTP;
  const int tiles = tiles_q * tiles_p * B;
  const int tid = threadIdx.x;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  const float ascale = kQ8 ? fmaxf(amax[0], 1e-8f) / 127.0f : 1.0f;

  // once per block: the weight pack (with the first halo, group 0) and
  // the affine (the int8 one combined dequant x BN factor)
  {
    const unsigned char* w = static_cast<const unsigned char*>(wpack);
    const uint32_t dst = smem_addr(smem);
    for (int i = tid; i < S::kW / 16; i += kThreads)
      cp_async16(dst + 16 * i, w + 16 * i, 16);
  }
  if (tid < kCout) {
    s_scale[tid] = kQ8 ? scale[tid] * (ascale * kscale[tid]) : scale[tid];
    s_bias[tid] = bias[tid];
  }
  int t = blockIdx.x;
  if (t < tiles) load_halo(s_raw, xb, tile_of(t, tiles_q, tiles_p), H, W);
  cp_async_commit();

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q4 = lane & 3;
  const __nv_bfloat16 neg_inf = __float2bfloat16_rn(-INFINITY);
  for (int k = 0; t < tiles; ++k, t += static_cast<int>(gridDim.x)) {
    const Tile tl = tile_of(t, tiles_q, tiles_p);
    // the next tile's halo streams in while this one computes
    const int next = t + static_cast<int>(gridDim.x);
    if (next < tiles)
      load_halo(s_raw + ((k + 1) & 1) * S::kRaw, xb,
                tile_of(next, tiles_q, tiles_p), H, W);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const unsigned char* raw = s_raw + (k & 1) * S::kRaw;
    if (kQ8) {
      // quantize the halo into 16-byte pixels (12 codes, 4 zero bytes)
      for (int p = tid; p < kIR * kIC; p += kThreads) {
        const int r = p / kIC, c = p - r * kIC;
        const uint2* src =
            reinterpret_cast<const uint2*>(raw + r * kRawRow + 8 + c * 24);
        const uint2 a = src[0], b = src[1], d = src[2];
        reinterpret_cast<uint4*>(s_q)[p] = make_uint4(
            pack4(reinterpret_cast<const __nv_bfloat16*>(&a), ascale),
            pack4(reinterpret_cast<const __nv_bfloat16*>(&b), ascale),
            pack4(reinterpret_cast<const __nv_bfloat16*>(&d), ascale), 0u);
      }
      __syncthreads();
    }
    const uint32_t* raw32 = reinterpret_cast<const uint32_t*>(raw);
    const int conv_r0 = 2 * tl.i0 - 1, conv_c0 = 2 * tl.j0 - 1;

    // conv: a warp takes two 16-pixel fragments of the flat 9 x 33 list;
    // lane (g, q4) feeds pixels g and g + 8 of each and holds their
    // channels 8j + 2q4, +1 for each of the 8 n-tiles
    for (int item = warp; item < kItems; item += kWarps) {
      int pix[4], a_off[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        pix[m] = (2 * item + (m >> 1)) * 16 + g + 8 * (m & 1);
        const int pc = min(pix[m], kPix - 1);   // padded slots: any pixel
        const int r = pc / kCC, c = pc - r * kCC;
        a_off[m] = kQ8 ? (r * kIC + c) * 4 : r * kRawRowW + 2 + c * 6;
      }
      float acc[2][kCout / 8][4];
      int iacc[2][kCout / 8][4];
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int j = 0; j < kCout / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[f][j][e] = 0.0f;
            iacc[f][j][e] = 0;
          }
#pragma unroll
      for (int ky = 0; ky < kK; ++ky) {
        if (kQ8) {
          // k = 32: input pixels c + 2s and c + 2s + 1, 16 codes each
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            uint32_t a[2][4];
#pragma unroll
            for (int f = 0; f < 2; ++f) {
              const uint32_t* lo = s_q + a_off[2 * f] + (ky * kIC + 2 * s) * 4;
              const uint32_t* hi =
                  s_q + a_off[2 * f + 1] + (ky * kIC + 2 * s) * 4;
              a[f][0] = lo[q4];
              a[f][1] = hi[q4];
              a[f][2] = lo[4 + q4];
              a[f][3] = hi[4 + q4];
            }
#pragma unroll
            for (int j = 0; j < kCout / 8; ++j) {
              const uint32_t* wn =
                  s_w + (ky * kCout + j * 8 + g) * (kWRowQ8 / 4) + s * 8;
              const uint32_t b0 = wn[q4], b1 = wn[4 + q4];
#pragma unroll
              for (int f = 0; f < 2; ++f)
                mma_s8(iacc[f][j], a[f][0], a[f][1], a[f][2], a[f][3], b0,
                       b1);
            }
          }
        } else {
          // k = 16: values 16s .. 16s + 15 of the row's 48 (kx * 12 + ci)
#pragma unroll
          for (int s = 0; s < 3; ++s) {
            uint32_t a[2][4];
#pragma unroll
            for (int f = 0; f < 2; ++f) {
              const uint32_t* lo = raw32 + a_off[2 * f] + ky * kRawRowW + s * 8;
              const uint32_t* hi =
                  raw32 + a_off[2 * f + 1] + ky * kRawRowW + s * 8;
              a[f][0] = lo[q4];
              a[f][1] = hi[q4];
              a[f][2] = lo[4 + q4];
              a[f][3] = hi[4 + q4];
            }
#pragma unroll
            for (int j = 0; j < kCout / 8; ++j) {
              const uint32_t* wn =
                  s_w + (ky * kCout + j * 8 + g) * (kWRowBf / 2) + s * 8;
              const uint32_t b0 = wn[q4], b1 = wn[4 + q4];
#pragma unroll
              for (int f = 0; f < 2; ++f)
                mma_bf16(acc[f][j], a[f][0], a[f][1], a[f][2], a[f][3], b0,
                         b1);
            }
          }
        }
      }
      // affine + ReLU on the accumulators, -inf outside the image, bf16
      // into the conv tile
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int p = pix[m];
        if (p >= kPix) continue;
        const int r = p / kCC, c = p - r * kCC;
        const int gr = conv_r0 + r, gc = conv_c0 + c;
        const bool outside = gr < 0 || gr >= H || gc < 0 || gc >= W;
        __nv_bfloat16* dst = s_conv + p * kConvP;
        const int f = m >> 1, h = m & 1;
#pragma unroll
        for (int j = 0; j < kCout / 8; ++j) {
          const int co = j * 8 + 2 * q4;
          const float v0 = kQ8 ? static_cast<float>(iacc[f][j][2 * h])
                               : acc[f][j][2 * h];
          const float v1 = kQ8 ? static_cast<float>(iacc[f][j][2 * h + 1])
                               : acc[f][j][2 * h + 1];
          const float y0 = v0 * s_scale[co] + s_bias[co];
          const float y1 = v1 * s_scale[co + 1] + s_bias[co + 1];
          __nv_bfloat162 v;
          v.x = outside ? neg_inf : __float2bfloat16_rn(fmaxf(y0, 0.0f));
          v.y = outside ? neg_inf : __float2bfloat16_rn(fmaxf(y1, 0.0f));
          *reinterpret_cast<__nv_bfloat162*>(dst + co) = v;
        }
      }
    }
    __syncthreads();

    // 3x3/s2 max-pool: pooled (p, q) reads tile conv rows 2p..2p+2, cols
    // 2q..2q+2 (tile row 0 is conv row 2*i0 - 1); 8 channels a thread,
    // one 16-byte store
    __nv_bfloat16* ob = out + static_cast<size_t>(tl.b) * Hp * Wp * kCout;
    for (int item = tid; item < kTP * kTQ * (kCout / 8); item += kThreads) {
      const int c8 = item % (kCout / 8);
      const int q = (item / (kCout / 8)) % kTQ;
      const int p = item / ((kCout / 8) * kTQ);
      const int i = tl.i0 + p, j = tl.j0 + q;
      if (i >= Hp || j >= Wp) continue;
      __nv_bfloat162 m[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e].x = m[e].y = neg_inf;
#pragma unroll
      for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              s_conv + ((2 * p + dr) * kCC + 2 * q + dc) * kConvP + 8 * c8);
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) m[e] = __hmax2(m[e], h[e]);
        }
      }
      *reinterpret_cast<uint4*>(
          ob + (static_cast<size_t>(i) * Wp + j) * kCout + 8 * c8) =
          *reinterpret_cast<const uint4*>(m);
    }
  }
}

// K4: out[b, i, j, c] = max over conv rows 2i-1..2i+1 and cols 2j-1..2j+1
// (-inf outside); a thread takes 8 channels of one output pixel
__global__ void stem_pool_kernel(const __nv_bfloat16* __restrict__ y,
                                 __nv_bfloat16* __restrict__ out, int B,
                                 int H, int W) {
  const int Ho = H / 2, Wo = W / 2;
  const size_t n = static_cast<size_t>(B) * Ho * Wo * (kCout / 8);
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) +
                    threadIdx.x;
       idx < n; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int c8 = static_cast<int>(idx % (kCout / 8));
    const size_t pix = idx / (kCout / 8);
    const int j = static_cast<int>(pix % Wo);
    const int i = static_cast<int>((pix / Wo) % Ho);
    const size_t b = pix / (static_cast<size_t>(Wo) * Ho);
    __nv_bfloat162 m[4];
    const __nv_bfloat16 neg_inf = __float2bfloat16_rn(-INFINITY);
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k].x = m[k].y = neg_inf;
#pragma unroll
    for (int dr = -1; dr <= 1; ++dr) {
      const int r = 2 * i + dr;
      if (r < 0 || r >= H) continue;
#pragma unroll
      for (int dc = -1; dc <= 1; ++dc) {
        const int c = 2 * j + dc;
        if (c < 0 || c >= W) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(
            y + ((b * H + r) * W + c) * kCout + c8 * 8);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int k = 0; k < 4; ++k) m[k] = __hmax2(m[k], h[k]);
      }
    }
    *reinterpret_cast<uint4*>(out + pix * kCout + c8 * 8) =
        *reinterpret_cast<const uint4*>(m);
  }
}

template <bool kQ8>
int launch_stem(const void* x12, const void* wpack, const void* amax,
                const void* kscale, const void* scale, const void* bias,
                void* out, int B, int H, int W, int sms, void* stream) {
  if (B <= 0 || H < 2 || W < 2) return 0;
  constexpr int kSmem = Smem<kQ8>::kTotal;
  // blocks a SM, found once per device and variant
  static int occupancy[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  int& blocks_per_sm = occupancy[dev];
  if (blocks_per_sm == 0) {
    err = cudaFuncSetAttribute(stem_conv_pool_kernel<kQ8>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, stem_conv_pool_kernel<kQ8>, kThreads, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks_per_sm < 1)
      return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int Hp = H / 2, Wp = W / 2;
  const long tiles = static_cast<long>((Wp + kTQ - 1) / kTQ) *
                     ((Hp + kTP - 1) / kTP) * B;
  const int grid = static_cast<int>(
      tiles < static_cast<long>(blocks_per_sm) * sms ? tiles
                                                     : blocks_per_sm * sms);
  stem_conv_pool_kernel<kQ8><<<grid, kThreads, kSmem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x12), wpack,
      static_cast<const float*>(amax), static_cast<const float*>(kscale),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), B, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int r3det_stem_conv_pool(const void* x12, const void* wpack,
                                    const void* scale, const void* bias,
                                    void* out, int B, int H, int W, int sms,
                                    void* stream) {
  return launch_stem<false>(x12, wpack, nullptr, nullptr, scale, bias, out,
                            B, H, W, sms, stream);
}

extern "C" int r3det_stem_conv_pool_q8(const void* x12, const void* wpack,
                                       const void* amax, const void* kscale,
                                       const void* scale, const void* bias,
                                       void* out, int B, int H, int W,
                                       int sms, void* stream) {
  return launch_stem<true>(x12, wpack, amax, kscale, scale, bias, out, B, H,
                           W, sms, stream);
}

extern "C" int r3det_stem_pool(const void* y, void* out, int B, int H, int W,
                               void* stream) {
  const size_t n = static_cast<size_t>(B) * (H / 2) * (W / 2) * (kCout / 8);
  if (n == 0) return 0;
  const int threads = 256;
  const int blocks = static_cast<int>((n + threads - 1) / threads);
  stem_pool_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(out),
      B, H, W);
  return static_cast<int>(cudaGetLastError());
}
