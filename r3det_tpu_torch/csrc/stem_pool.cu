// ResNet stem kernels (K3, K3 int8, K4).
//
// K3: the fused stem in one pass: the folded 7x7/s2 stem conv on the
// space-to-depth(2) image (4x4 kernel, 12 -> 64 channels, zero padding
// top/left 2, bottom/right 1), the folded FrozenBN affine, ReLU, and the
// 3x3/s2 max-pool with -inf padding.
//   x12 (B, H, W, 12) bf16,
//   weights (16, 64, 16) bf16: [tap = ky*4 + kx][co][ci, zero past 12]
//     (the wrapper packs the (4, 4, 12, 64) HWIO kernel),
//   scale, bias (64,) f32  ->  out (B, H/2, W/2, 64) bf16.
// K3 int8: the same pass with int8 codes: per-output-channel int8 weights
//   (4, 2, 64, 32): [ky][kx pair][co][2 taps x 16 channels, 12 used], and
//   the input quantized on load with ascale = max(amax, 1e-8) / 127, where
//   amax = max|x| over the whole batch, read from device memory;
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
// lanes; here the conv is an implicit GEMM on the tensor cores instead:
// per tap, 16 conv pixels x 16 input channels (12 padded to 16) times
// 16 x 64 weights, with mma.sync m16n8k16 (bf16 in, f32 accumulate); in
// int8 two taps fill one k=32 step. The s2d4 fold quantized its kernel per
// output channel, and each of its sub-pixel groups holds all 192 taps, so
// its scales are the per-channel scales of the unfolded kernel.
//
// Numerics: bf16 x bf16 products are exact in f32, so the f32 sums differ
// from any other f32 accumulation only by order; int8 sums are exact. The
// affine is a multiply then an add (no contraction, as in the plain
// version); the post-ReLU value is rounded to bf16 before pooling, as the
// reference does (the rounding is monotone, so the max commutes with it).
//
// What bounds it on the H100: per batch of 8 at 1024^2 it reads 50 MB and
// writes 67 MB, and does 25.8 G useful multiply-adds (34 G as padded),
// far below the tensor cores' rate, so memory and on-chip traffic bound
// it. The design keeps the packed weights (32 KB, 16 KB in int8), the
// input halo tile and the bf16 conv tile in shared memory (~94 KB, two
// blocks per SM), loads every mma fragment conflict-free from shared
// memory, applies affine + ReLU on the accumulator registers, and pools
// from shared memory, so the full-size conv output never touches device
// memory. A block computes 9 conv rows x 48 conv cols for 4 x 16 pooled
// outputs (9 x 33 are needed: the pool windows overlap, and 16-pixel
// fragments round 33 up to 48). K4 is one 16-byte load per window tap and
// thread (8 channels), bound by the read of the conv output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kCin = 12;
constexpr int kCinP = 16;                  // input channels padded to 16
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

// shared memory: element size 2 (bf16) or 1 (int8) for weights and input
template <bool kQ8>
struct Smem {
  static constexpr size_t kE = kQ8 ? 1 : 2;
  static constexpr size_t kW = kE * kTaps * kCout * kCinP;    // 32768|16384
  static constexpr size_t kIn = kE * kIR * kIC * kCinP;       // 19584|9792
  static constexpr size_t kAff = 4 * 2 * kCout;               // 512
  static constexpr size_t kConv = 2 * kCR * kCC * kConvP;     // 42768
  static constexpr size_t kTotal = kW + kIn + kAff + kConv;
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

template <bool kQ8>
__global__ void __launch_bounds__(kThreads, 2)
stem_conv_pool_kernel(const __nv_bfloat16* __restrict__ x,
                      const void* __restrict__ wpack,
                      const float* __restrict__ amax,
                      const float* __restrict__ kscale,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int H, int W) {
  using S = Smem<kQ8>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_w = smem;
  unsigned char* s_in = smem + S::kW;
  float* s_scale = reinterpret_cast<float*>(smem + S::kW + S::kIn);
  float* s_bias = s_scale + kCout;
  __nv_bfloat16* s_conv =
      reinterpret_cast<__nv_bfloat16*>(smem + S::kW + S::kIn + S::kAff);

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTP;        // first pooled row
  const int j0 = blockIdx.x * kTQ;        // first pooled col
  const int Hp = H / 2, Wp = W / 2;
  const int conv_r0 = 2 * i0 - 1;         // conv row of local row 0
  const int conv_c0 = 2 * j0 - 1;
  const int in_r0 = conv_r0 - 2;          // input row of local row 0
  const int in_c0 = conv_c0 - 2;
  const int tid = threadIdx.x;
  const float ascale = kQ8 ? fmaxf(amax[0], 1e-8f) / 127.0f : 1.0f;

  const uint4* wsrc = reinterpret_cast<const uint4*>(wpack);
  uint4* wdst = reinterpret_cast<uint4*>(s_w);
  for (int t = tid; t < static_cast<int>(S::kW / 16); t += kThreads)
    wdst[t] = wsrc[t];
  if (tid < kCout) {
    // int8: the one combined dequant x BN factor
    s_scale[tid] = kQ8 ? scale[tid] * (ascale * kscale[tid]) : scale[tid];
    s_bias[tid] = bias[tid];
  }
  // input halo tile, 12 channels (24 bytes) per pixel padded to 16
  // channels: 32 bytes as bf16, 16 bytes as int8 codes
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * H * W * kCin;
  uint4* in4 = reinterpret_cast<uint4*>(s_in);
  for (int p = tid; p < kIR * kIC; p += kThreads) {
    const int gy = in_r0 + p / kIC, gx = in_c0 + p % kIC;
    uint4 lo = make_uint4(0, 0, 0, 0), hi = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const uint2* src = reinterpret_cast<const uint2*>(
          xb + (static_cast<size_t>(gy) * W + gx) * kCin);
      const uint2 a = src[0], c = src[1], d = src[2];
      if (kQ8) {
        const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&a);
        const __nv_bfloat16* u = reinterpret_cast<const __nv_bfloat16*>(&c);
        const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(&d);
        lo = make_uint4(pack4(v, ascale), pack4(u, ascale),
                        pack4(w, ascale), 0);
      } else {
        lo = make_uint4(a.x, a.y, c.x, c.y);
        hi = make_uint4(d.x, d.y, 0, 0);
      }
    }
    if (kQ8) {
      in4[p] = lo;
    } else {
      in4[2 * p] = lo;
      in4[2 * p + 1] = hi;
    }
  }
  __syncthreads();

  // conv: each warp takes (conv row, 16-pixel fragment) items and sums the
  // taps; lane (g, t) holds pixels g and g+8. A pixel is kPW words.
  constexpr int kPW = kQ8 ? kCinP / 4 : kCinP / 2;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* in32 = reinterpret_cast<const uint32_t*>(s_in);
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(s_w);
  const __nv_bfloat16 neg_inf = __float2bfloat16_rn(-INFINITY);
  for (int item = warp; item < kCR * kMF; item += kWarps) {
    const int r = item / kMF, mf = item % kMF;
    float acc[kCout / 8][4];
    int iacc[kCout / 8][4];
#pragma unroll
    for (int j = 0; j < kCout / 8; ++j) {
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
      iacc[j][0] = iacc[j][1] = iacc[j][2] = iacc[j][3] = 0;
    }
#pragma unroll 1
    for (int ky = 0; ky < kK; ++ky) {
      if (kQ8) {
        // k = 32: taps (ky, kx0) and (ky, kx0 + 1), 16 channels each
#pragma unroll
        for (int pair = 0; pair < 2; ++pair) {
          const uint32_t* a_row =
              in32 + ((r + ky) * kIC + mf * 16 + g + 2 * pair) * kPW;
          const uint32_t a0 = a_row[t];
          const uint32_t a1 = a_row[8 * kPW + t];
          const uint32_t a2 = a_row[kPW + t];
          const uint32_t a3 = a_row[9 * kPW + t];
          const uint32_t* w_p = w32 + (ky * 2 + pair) * kCout * 8;
#pragma unroll
          for (int j = 0; j < kCout / 8; ++j) {
            const uint32_t* w_n = w_p + (j * 8 + g) * 8;
            mma_s8(iacc[j], a0, a1, a2, a3, w_n[t], w_n[t + 4]);
          }
        }
      } else {
#pragma unroll
        for (int kx = 0; kx < kK; ++kx) {
          const uint32_t* a_row =
              in32 + ((r + ky) * kIC + mf * 16 + g + kx) * kPW;
          const uint32_t a0 = a_row[t];
          const uint32_t a1 = a_row[8 * kPW + t];
          const uint32_t a2 = a_row[t + 4];
          const uint32_t a3 = a_row[8 * kPW + t + 4];
          const uint32_t* w_tap = w32 + (ky * kK + kx) * kCout * kPW;
#pragma unroll
          for (int j = 0; j < kCout / 8; ++j) {
            const uint32_t* w_n = w_tap + (j * 8 + g) * kPW;
            mma_bf16(acc[j], a0, a1, a2, a3, w_n[t], w_n[t + 4]);
          }
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
        const float v0 = kQ8 ? static_cast<float>(iacc[j][2 * h])
                             : acc[j][2 * h];
        const float v1 = kQ8 ? static_cast<float>(iacc[j][2 * h + 1])
                             : acc[j][2 * h + 1];
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
                void* out, int B, int H, int W, void* stream) {
  if (B <= 0 || H < 2 || W < 2) return 0;
  constexpr size_t kSmem = Smem<kQ8>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(
      stem_conv_pool_kernel<kQ8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Hp = H / 2, Wp = W / 2;
  const dim3 grid((Wp + kTQ - 1) / kTQ, (Hp + kTP - 1) / kTP, B);
  stem_conv_pool_kernel<kQ8><<<grid, kThreads, kSmem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x12), wpack,
      static_cast<const float*>(amax), static_cast<const float*>(kscale),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int r3det_stem_conv_pool(const void* x12, const void* wpack,
                                    const void* scale, const void* bias,
                                    void* out, int B, int H, int W,
                                    void* stream) {
  return launch_stem<false>(x12, wpack, nullptr, nullptr, scale, bias, out,
                            B, H, W, stream);
}

extern "C" int r3det_stem_conv_pool_q8(const void* x12, const void* wpack,
                                       const void* amax, const void* kscale,
                                       const void* scale, const void* bias,
                                       void* out, int B, int H, int W,
                                       void* stream) {
  return launch_stem<true>(x12, wpack, amax, kscale, scale, bias, out, B, H,
                           W, stream);
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
