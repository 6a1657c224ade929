// Fused ResNet stem in one pass: the folded 7x7/s2 stem conv on the
// space-to-depth(2) image (4x4 kernel, 12 -> 64 channels, zero padding
// top/left 2, bottom/right 1), the folded FrozenBN affine, ReLU, and the
// 3x3/s2 max-pool with -inf padding.
//   x12 (B, H, W, 12) bf16,
//   weights (16, 64, 16) bf16: [tap = ky*4 + kx][co][ci, zero past 12]
//     (the wrapper packs the (4, 4, 12, 64) HWIO kernel),
//   scale, bias (64,) f32  ->  out (B, H/2, W/2, 64) bf16.
//
// Replaces the TPU kernel r3det_tpu/ops/stem_pool.py::
// stem_conv_pool_s2d4_pallas (_stem_s2d4_kernel), bf16 variant; the
// function is stem_conv_pool_reference (:453-477). The TPU kernel refolded
// the input to 48 channels (s2d4) because 12 channels fill 12 of 128
// lanes; here the conv is an implicit GEMM on the tensor cores instead:
// per tap, 16 conv pixels x 16 input channels (12 padded to 16) times
// 16 x 64 weights, with mma.sync m16n8k16 (bf16 in, f32 accumulate).
//
// Numerics: bf16 x bf16 products are exact in f32, so the f32 sums differ
// from any other f32 accumulation only by order. The affine is a multiply
// then an add (no contraction, as in the plain version); the post-ReLU
// value is rounded to bf16 before pooling, as the reference does (the
// rounding is monotone, so the max commutes with it).
//
// What bounds it on the H100: per batch of 8 at 1024^2 it reads 50 MB and
// writes 67 MB, and does 25.8 G useful multiply-adds (34 G as padded),
// far below the tensor cores' rate, so memory and on-chip traffic bound
// it. The design keeps the packed weights (32 KB), the input halo tile
// and the bf16 conv tile in shared memory (~94 KB, two blocks per SM),
// loads every mma fragment conflict-free from shared memory, applies
// affine + ReLU on the accumulator registers, and pools from shared
// memory, so the full-size conv output never touches device memory. A
// block computes 9 conv rows x 48 conv cols for 4 x 16 pooled outputs
// (9 x 33 are needed: the pool windows overlap, and 16-pixel fragments
// round 33 up to 48).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kCin = 12;
constexpr int kCinP = 16;                  // input channels padded to k=16
constexpr int kCout = 64;
constexpr int kK = 4;                      // conv kernel height and width
constexpr int kTaps = kK * kK;
constexpr int kTP = 4;                     // pooled rows per block
constexpr int kTQ = 16;                    // pooled cols per block
constexpr int kCR = 2 * kTP + 1;           // conv rows per block (9)
constexpr int kCC = 2 * kTQ + 1;           // conv cols the pool reads (33)
constexpr int kMF = (kCC + 15) / 16;       // 16-pixel fragments a row (3)
constexpr int kIR = kCR + kK - 1;          // input rows incl. halo (12)
constexpr int kIC = kMF * 16 + kK - 1;     // input cols incl. halo (51)
constexpr int kConvP = kCout + 8;          // conv tile pixel stride (banks)
constexpr int kWarps = kCR * kMF / 3;      // 9: three fragments a warp
constexpr int kThreads = kWarps * 32;

constexpr size_t kSmemW = 2 * kTaps * kCout * kCinP;          // 32768
constexpr size_t kSmemIn = 2 * kIR * kIC * kCinP;             // 19584
constexpr size_t kSmemAff = 4 * 2 * kCout;                    // 512
constexpr size_t kSmemConv = 2 * kCR * kCC * kConvP;          // 42768
constexpr size_t kSmem = kSmemW + kSmemIn + kSmemAff + kSmemConv;

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

__global__ void __launch_bounds__(kThreads, 2)
stem_conv_pool_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ wpack,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(smem + kSmemW);
  float* s_scale = reinterpret_cast<float*>(smem + kSmemW + kSmemIn);
  float* s_bias = s_scale + kCout;
  __nv_bfloat16* s_conv =
      reinterpret_cast<__nv_bfloat16*>(smem + kSmemW + kSmemIn + kSmemAff);

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTP;        // first pooled row
  const int j0 = blockIdx.x * kTQ;        // first pooled col
  const int Hp = H / 2, Wp = W / 2;
  const int conv_r0 = 2 * i0 - 1;         // conv row of local row 0
  const int conv_c0 = 2 * j0 - 1;
  const int in_r0 = conv_r0 - 2;          // input row of local row 0
  const int in_c0 = conv_c0 - 2;
  const int tid = threadIdx.x;

  const uint4* wsrc = reinterpret_cast<const uint4*>(wpack);
  uint4* wdst = reinterpret_cast<uint4*>(s_w);
  for (int t = tid; t < static_cast<int>(kSmemW / 16); t += kThreads)
    wdst[t] = wsrc[t];
  if (tid < kCout) {
    s_scale[tid] = scale[tid];
    s_bias[tid] = bias[tid];
  }
  // input halo tile, 12 channels (24 bytes) per pixel padded to 16
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * H * W * kCin;
  uint4* in4 = reinterpret_cast<uint4*>(s_in);
  for (int p = tid; p < kIR * kIC; p += kThreads) {
    const int gy = in_r0 + p / kIC, gx = in_c0 + p % kIC;
    uint4 lo = make_uint4(0, 0, 0, 0), hi = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const uint2* src = reinterpret_cast<const uint2*>(
          xb + (static_cast<size_t>(gy) * W + gx) * kCin);
      const uint2 a = src[0], c = src[1], d = src[2];
      lo = make_uint4(a.x, a.y, c.x, c.y);
      hi = make_uint4(d.x, d.y, 0, 0);
    }
    in4[2 * p] = lo;
    in4[2 * p + 1] = hi;
  }
  __syncthreads();

  // conv: each warp takes (conv row, 16-pixel fragment) items and sums the
  // 16 taps; lane (g, t) holds pixels g and g+8, channels 2t, 2t+1
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* in32 = reinterpret_cast<const uint32_t*>(s_in);
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(s_w);
  const __nv_bfloat16 neg_inf = __float2bfloat16_rn(-INFINITY);
  for (int item = warp; item < kCR * kMF; item += kWarps) {
    const int r = item / kMF, mf = item % kMF;
    float acc[kCout / 8][4];
#pragma unroll
    for (int j = 0; j < kCout / 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll 1
    for (int ky = 0; ky < kK; ++ky) {
#pragma unroll
      for (int kx = 0; kx < kK; ++kx) {
        const uint32_t* a_row =
            in32 + ((r + ky) * kIC + mf * 16 + g + kx) * (kCinP / 2);
        const uint32_t a0 = a_row[t];
        const uint32_t a1 = a_row[8 * (kCinP / 2) + t];
        const uint32_t a2 = a_row[t + 4];
        const uint32_t a3 = a_row[8 * (kCinP / 2) + t + 4];
        const uint32_t* w_tap = w32 + (ky * kK + kx) * kCout * (kCinP / 2);
#pragma unroll
        for (int j = 0; j < kCout / 8; ++j) {
          const uint32_t* w_n = w_tap + (j * 8 + g) * (kCinP / 2);
          mma_bf16(acc[j], a0, a1, a2, a3, w_n[t], w_n[t + 4]);
        }
      }
    }
    // affine + ReLU on the accumulators; -inf outside the image
    const int gr = conv_r0 + r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = mf * 16 + g + 8 * h;
      if (px >= kCC) continue;
      const int gc = conv_c0 + px;
      const bool outside = gr < 0 || gr >= H || gc < 0 || gc >= W;
      __nv_bfloat16* dst = s_conv + (r * kCC + px) * kConvP;
#pragma unroll
      for (int j = 0; j < kCout / 8; ++j) {
        const int co = j * 8 + 2 * t;
        const float y0 = acc[j][2 * h] * s_scale[co] + s_bias[co];
        const float y1 = acc[j][2 * h + 1] * s_scale[co + 1] + s_bias[co + 1];
        __nv_bfloat162 v;
        v.x = outside ? neg_inf : __float2bfloat16_rn(fmaxf(y0, 0.0f));
        v.y = outside ? neg_inf : __float2bfloat16_rn(fmaxf(y1, 0.0f));
        *reinterpret_cast<__nv_bfloat162*>(dst + co) = v;
      }
    }
  }
  __syncthreads();

  // 3x3/s2 max-pool: pooled (p, q) reads local conv rows 2p..2p+2, cols
  // 2q..2q+2 (local row 0 is conv row 2*i0 - 1); two channels a thread
  __nv_bfloat16* ob = out + static_cast<size_t>(b) * Hp * Wp * kCout;
  for (int item = tid; item < kTP * kTQ * (kCout / 2); item += kThreads) {
    const int c2 = item % (kCout / 2);
    const int q = (item / (kCout / 2)) % kTQ;
    const int p = item / ((kCout / 2) * kTQ);
    const int i = i0 + p, j = j0 + q;
    if (i >= Hp || j >= Wp) continue;
    __nv_bfloat162 m;
    m.x = m.y = neg_inf;
#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
      for (int dc = 0; dc < 3; ++dc) {
        const int pix = (2 * p + dr) * kCC + 2 * q + dc;
        m = __hmax2(m, *reinterpret_cast<const __nv_bfloat162*>(
                           s_conv + pix * kConvP + 2 * c2));
      }
    }
    *reinterpret_cast<__nv_bfloat162*>(
        ob + (static_cast<size_t>(i) * Wp + j) * kCout + 2 * c2) = m;
  }
}

}  // namespace

extern "C" int r3det_stem_conv_pool(const void* x12, const void* wpack,
                                    const void* scale, const void* bias,
                                    void* out, int B, int H, int W,
                                    void* stream) {
  if (B <= 0 || H < 2 || W < 2) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      stem_conv_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Hp = H / 2, Wp = W / 2;
  const dim3 grid((Wp + kTQ - 1) / kTQ, (Hp + kTP - 1) / kTP, B);
  stem_conv_pool_kernel<<<grid, kThreads, kSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x12),
      static_cast<const __nv_bfloat16*>(wpack),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}
