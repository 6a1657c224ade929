// int8 convolution of QConv (models/quant.py) as one implicit GEMM, with
// the quantization of its input and the dequant of its output fused:
//   out[b, oy, ox, n] = dq(sum_{ky, kx, c} xi[b, oy*sh - ph + ky,
//                                              ox*sw - pw + kx, c]
//                                   * w[n, ky, kx, c])
//   xi: the input's int8 codes, clip(rint(x / ascale), +-127) of a bf16
//       NHWC input, quantized as it is loaded (q_in = 1), or int8 NHWC
//       codes as they are (q_in = 0: the block-level int8 activation
//       storage of Bottleneck.int8_act);
//   w:  (Co, kh, kw, Ci) int8 codes, K contiguous;
//   dq(acc) = bf16(float(bf16(acc)) * (ascale * kscale[n]) [+ bias[n]]):
//       the int32 sums round to bf16 before the dequant, as the bf16
//       model of the JAX package's QConv does.
//   ascale is a device scalar (f32), so calibrated and dynamic scales
//   need no host sync.
// There is no TPU kernel behind this function: the JAX package leaves the
// int8 conv to XLA (lax.conv_general_dilated(..., preferred_element_type=
// bf16), r3det_tpu/models/quant.py:111-115). Its plain version here is an
// int8 im2col feeding torch._int_mm (cuBLASLt) plus elementwise passes for
// the quantize and dequant; this kernel replaces those passes and the
// im2col's round trip through device memory.
//
// Design: a block computes a 64-pixel x NT-channel output tile (NT = 128,
// or 64 where Co is not a multiple of 128) with 8 warps (2 x 4), each
// 32 x NT/4 on mma.sync m16n8k32 (s8, int32 sums). K runs over the taps
// and over 128-channel slices of Ci; each slice of the A tile (64 pixels,
// gathered with zero padding) and of the weights is loaded synchronously
// into shared memory rows 16 bytes past a multiple of 32 bytes, so
// fragment loads are conflict-free. The block is small (48-64 registers a
// thread, 20-29 KB of shared memory), so many blocks share an SM and hide
// each other's load latency: a 128-pixel tile with a register prefetch of
// the next slice measured slower (163 registers, one block an SM). What
// bounds it: at the R50 C2 3x3 conv (8, 256, 256, 64) it does 19.3 G
// multiply-adds and gathers each input pixel once per tap (from L1/L2),
// quantizing it each time (a divide per value); with k = 64 slices the MMA
// work per barrier is small, so instruction throughput and the gather,
// not the tensor cores, bound it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMT = 64;                    // output pixels a block
constexpr int kThreads = 256;              // 8 warps: 2 (M) x 4 (N)
constexpr int kKC = 128;                   // bytes (= channels) a slice
constexpr int kRowB = kKC + 16;

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t q8_div(float v, float ascale) {
  const float q = fminf(fmaxf(rintf(v / ascale), -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

// 16 bf16 values -> 16 int8 codes of v / ascale
__device__ __forceinline__ uint4 quantize16(uint4 lo, uint4 hi,
                                            float ascale) {
  const __nv_bfloat16* a = reinterpret_cast<const __nv_bfloat16*>(&lo);
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&hi);
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * k + i;
      v |= q8_div(__bfloat162float(e < 8 ? a[e] : b[e - 8]), ascale)
           << (8 * i);
    }
    w[k] = v;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const void* __restrict__ x, int q_in,
                 const float* __restrict__ ascale_p,
                 const int8_t* __restrict__ w,
                 const float* __restrict__ kscale,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int B, int H, int W,
                 int Ci, int Ho, int Wo, int Co, int kh, int kw, int sh,
                 int sw, int ph, int pw) {
  constexpr int kNF = NT / 4 / 8;            // 8-column fragments a warp
  __shared__ __align__(16) unsigned char s_a[kMT * kRowB];
  __shared__ __align__(16) unsigned char s_b[NT * kRowB];
  __shared__ int s_pb[kMT], s_py[kMT], s_px[kMT];
  __shared__ float s_f[NT], s_bias[NT];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / 4, wn = warp % 4;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * kMT;
  const int n0 = blockIdx.y * NT;
  const float ascale = ascale_p[0];

  if (tid < kMT) {
    const long long m = m0 + tid;
    if (m < M) {
      const int ox = static_cast<int>(m % Wo);
      const int oy = static_cast<int>((m / Wo) % Ho);
      s_pb[tid] = static_cast<int>(m / (static_cast<long long>(Wo) * Ho));
      s_py[tid] = oy * sh - ph;
      s_px[tid] = ox * sw - pw;
    } else {
      s_pb[tid] = -1;
      s_py[tid] = s_px[tid] = 0;
    }
  }
  if (tid < NT) {
    s_f[tid] = ascale * kscale[n0 + tid];
    s_bias[tid] = bias ? bias[n0 + tid] : 0.0f;
  }

  int acc[2][kNF][4];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mf][nf][e] = 0;

  const int kcb = Ci < kKC ? Ci : kKC;       // bytes of K a slice
  const int per_row = kcb / 16;
  const size_t wrow = static_cast<size_t>(kh) * kw * Ci;
  for (int tap = 0; tap < kh * kw; ++tap) {
    const int ky = tap / kw, kx = tap % kw;
    for (int c0 = 0; c0 < Ci; c0 += kcb) {
      __syncthreads();
      // A: 64 gathered input pixels, zero outside the image
      for (int i = tid; i < kMT * per_row; i += kThreads) {
        const int r = i / per_row, c = i % per_row;
        const int pb = s_pb[r];
        const int iy = s_py[r] + ky, ix = s_px[r] + kx;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (pb >= 0 && iy >= 0 && iy < H && ix >= 0 && ix < W) {
          const size_t pix = (static_cast<size_t>(pb) * H + iy) * W + ix;
          const int ch = c0 + 16 * c;
          if (q_in) {
            const uint4* src = reinterpret_cast<const uint4*>(
                static_cast<const __nv_bfloat16*>(x) + pix * Ci + ch);
            v = quantize16(src[0], src[1], ascale);
          } else {
            v = *reinterpret_cast<const uint4*>(
                static_cast<const int8_t*>(x) + pix * Ci + ch);
          }
        }
        *reinterpret_cast<uint4*>(s_a + r * kRowB + c * 16) = v;
      }
      // B: NT weight rows of this tap's slice
      for (int i = tid; i < NT * per_row; i += kThreads) {
        const int r = i / per_row, c = i % per_row;
        *reinterpret_cast<uint4*>(s_b + r * kRowB + c * 16) =
            *reinterpret_cast<const uint4*>(
                w + (n0 + r) * wrow + static_cast<size_t>(tap) * Ci + c0 +
                c * 16);
      }
      __syncthreads();
      const uint32_t* aw = reinterpret_cast<const uint32_t*>(s_a);
      const uint32_t* bw = reinterpret_cast<const uint32_t*>(s_b);
      constexpr int kRW = kRowB / 4;
      for (int s = 0; s < kcb / 32; ++s) {
        const int o = 8 * s + t;
        uint32_t bf[kNF][2];
#pragma unroll
        for (int nf = 0; nf < kNF; ++nf) {
          const uint32_t* br = bw + (wn * (NT / 4) + nf * 8 + g) * kRW;
          bf[nf][0] = br[o];
          bf[nf][1] = br[o + 4];
        }
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          const uint32_t* a0 = aw + (wm * 32 + mf * 16 + g) * kRW;
          const uint32_t* a1 = a0 + 8 * kRW;
          const uint32_t x0 = a0[o], x1 = a1[o], x2 = a0[o + 4],
                         x3 = a1[o + 4];
#pragma unroll
          for (int nf = 0; nf < kNF; ++nf)
            mma_s8(acc[mf][nf], x0, x1, x2, x3, bf[nf][0], bf[nf][1]);
        }
      }
    }
  }

  // dequant: bf16(acc) -> f32, times ascale * kscale, plus bias, bf16
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm * 32 + mf * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int nf = 0; nf < kNF; ++nf) {
        const int nl = wn * (NT / 4) + nf * 8 + 2 * t;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = __bfloat162float(__float2bfloat16_rn(
              static_cast<float>(acc[mf][nf][2 * h + e])));
          const float y = a * s_f[nl + e];
          v[e] = bias ? y + s_bias[nl + e] : y;
        }
        __nv_bfloat162 o;
        o.x = __float2bfloat16_rn(v[0]);
        o.y = __float2bfloat16_rn(v[1]);
        *reinterpret_cast<__nv_bfloat162*>(
            out + m * Co + n0 + nl) = o;
      }
    }
  }
}

}  // namespace

extern "C" int r3det_int8_conv(const void* x, int q_in, const void* ascale,
                               const void* w, const void* kscale,
                               const void* bias, void* out, int B, int H,
                               int W, int Ci, int Ho, int Wo, int Co, int kh,
                               int kw, int sh, int sw, int ph, int pw,
                               void* stream) {
  const long long M = static_cast<long long>(B) * Ho * Wo;
  if (M <= 0) return 0;
  if (Ci % 32 || Co % 64 || (Ci > kKC && Ci % kKC))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned mblocks = static_cast<unsigned>((M + kMT - 1) / kMT);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Co % 128 == 0) {
    int8_conv_kernel<128><<<dim3(mblocks, Co / 128), kThreads, 0, s>>>(
        x, q_in, static_cast<const float*>(ascale),
        static_cast<const int8_t*>(w), static_cast<const float*>(kscale),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), B,
        H, W, Ci, Ho, Wo, Co, kh, kw, sh, sw, ph, pw);
  } else {
    int8_conv_kernel<64><<<dim3(mblocks, Co / 64), kThreads, 0, s>>>(
        x, q_in, static_cast<const float*>(ascale),
        static_cast<const int8_t*>(w), static_cast<const float*>(kscale),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), B,
        H, W, Ci, Ho, Wo, Co, kh, kw, sh, sw, ph, pw);
  }
  return static_cast<int>(cudaGetLastError());
}
