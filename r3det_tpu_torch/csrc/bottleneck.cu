// Fused stride-1 identity ResNet bottleneck (K5), bf16 and int8:
//   out = relu(conv3(a2) + b3 + x),  a2 = relu(conv2(a1) + b2),
//   a1 = relu(conv1(x) + b1), zero outside the image (conv2's padding),
// with FrozenBN folded into the weights by the wrapper.
//   x, out (B, H, W, 4F) bf16 NHWC; F in {64, 128, 256}; H % 8 == 0.
//   Weights [n][k] (K contiguous): w1 (F, 4F), w2 (9, F, F) per tap
//   ky*3 + kx, w3 (4F, F); bf16, or int8 codes. Biases f32.
// int8 (q8): each conv input is quantized in registers with its calibrated
// static scale by the reciprocal multiply, clip(rint(v * inv_n), +-127)
// (inv = (1/a1, 1/a2, 1/a3), read from device memory); the sums are exact
// int32 on mma.sync m16n8k32 (s8), dequantized by s_n = a_n * ks_n
// (per output channel, multiplied out by the wrapper) before the bias.
// bf16: mma.sync m16n8k16, f32 sums; a1 and a2 are rounded to bf16 after
// bias and ReLU, as the plain version does. In q8 they stay f32 until
// quantized.
//
// Replaces the TPU kernels r3det_tpu/ops/bottleneck_fuse.py::
// fused_bottleneck (_btl_kernel) and fused_bottleneck_q8 (_btl_kernel_q8).
// The TPU design kept an 8-row full-width band of x resident in VMEM. An
// H100 block has 227 KB of shared memory, and at C4 the 3x3 weights alone
// are 1.2 MB (bf16), so here a block owns an 8x8 output tile: it
// recomputes conv1 on the 10x10 halo tile (1.56x conv1's work), keeps a1
// and a2 in shared memory, and streams x and every weight matrix through
// shared memory in 128-byte K slices (the weights come from L2: every
// block reads all of them). Only x (once, plus the halo and the residual
// re-read) and out touch device memory.
//
// What bounds it: at R50 C2 (8, 256, 256, 256) F=64 the block does ~41 G
// multiply-adds and moves 0.27 GB of x/out, and every block re-reads
// 136 KB of weights from L2 (1.1 GB in all; 2.2 MB a block at F=256). This
// simple form loads each slice synchronously (no copy/compute overlap) and
// runs mma.sync from shared memory, so it is bound by shared-memory
// traffic and load latency, well below the tensor cores' rate.
// Fragments are loaded conflict-free: every shared row's stride is 16
// bytes past a multiple of 32 bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTH = 8, kTW = 8;            // output tile
constexpr int kHR = kTH + 2, kHC = kTW + 2;
constexpr int kNP1 = kHR * kHC;            // 100 halo pixels
constexpr int kM1 = 112;                   // halo rows padded to 7 x 16
constexpr int kM2 = kTH * kTW;             // 64 output pixels
constexpr int kThreads = 256;              // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 128;                   // bytes of K per slice
constexpr int kRowB = kKC + 16;            // 144-byte slice rows

template <int F, bool Q8>
struct Cfg {
  static constexpr int kE = Q8 ? 1 : 2;          // bytes per element
  static constexpr int kC4 = 4 * F;
  static constexpr int kN1 = F < 128 ? F : 128;  // conv1 N per pass
  static constexpr int kN3 = 256;                // conv3 N per pass
  static constexpr int kKF = F * kE;             // bytes of K in conv2/3
  static constexpr int kKC2 = kKF < kKC ? kKF : kKC;
  static constexpr int kARowB = kKF + 16;        // a1/a2 row bytes
  static constexpr int kWRows = F > kN3 ? F : kN3;
  static constexpr size_t kXs = size_t(kM1) * kRowB;
  static constexpr size_t kWb = size_t(kWRows) * kRowB;
  static constexpr size_t kA1 = size_t(kM1) * kARowB;
  static constexpr size_t kA2 = size_t(kM2) * kARowB;
  static constexpr size_t kVec = size_t(4) * F * sizeof(float);
  static constexpr size_t kTotal = kXs + kWb + kA1 + kA2 + kVec;
  using Acc = std::conditional_t<Q8, int, float>;
};

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int q8(float v, float inv) {
  return static_cast<int>(fminf(fmaxf(rintf(v * inv), -127.0f), 127.0f));
}

// 16 bf16 values -> 16 int8 codes
__device__ __forceinline__ uint4 quantize16(uint4 lo, uint4 hi, float inv) {
  const __nv_bfloat16* a = reinterpret_cast<const __nv_bfloat16*>(&lo);
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&hi);
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * k + i;
      const float f = __bfloat162float(e < 8 ? a[e] : b[e - 8]);
      v |= (static_cast<uint32_t>(q8(f, inv)) & 0xffu) << (8 * i);
    }
    w[k] = v;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// rows x bytes (multiple of 16) from global (row stride src_b bytes) into
// shared rows of kRowB bytes
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          const unsigned char* src,
                                          size_t src_b, int rows, int bytes) {
  const int per_row = bytes / 16;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = i % per_row;
    *reinterpret_cast<uint4*>(dst + r * kRowB + c * 16) =
        *reinterpret_cast<const uint4*>(src + r * src_b + c * 16);
  }
}

// one K slice of a warp's product: MF 16-row fragments (rows a0[mf] for
// lanes g and a1[mf] for g + 8, word pointers) by NF 8-column fragments
// (word pointers per column), ks 32-byte k-steps
template <typename Acc, int MF, int NF>
__device__ __forceinline__ void mma_slice(Acc (&acc)[MF][NF][4],
                                          const uint32_t* const* a0,
                                          const uint32_t* const* a1,
                                          const uint32_t* const* b, int ks,
                                          int t) {
  for (int s = 0; s < ks; ++s) {
    const int o = 8 * s + t;
    uint32_t bf[NF][2];
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) {
      bf[nf][0] = b[nf][o];
      bf[nf][1] = b[nf][o + 4];
    }
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
      const uint32_t x0 = a0[mf][o], x1 = a1[mf][o];
      const uint32_t x2 = a0[mf][o + 4], x3 = a1[mf][o + 4];
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
        mma(acc[mf][nf], x0, x1, x2, x3, bf[nf][0], bf[nf][1]);
    }
  }
}

template <typename Acc, int MF, int NF>
__device__ __forceinline__ void zero(Acc (&acc)[MF][NF][4]) {
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mf][nf][e] = Acc(0);
}

// store a1/a2 value v (post bias + ReLU, f32) at row r, channel n
template <bool Q8>
__device__ __forceinline__ void store_act(unsigned char* buf, int row_b,
                                          int r, int n, float v0, float v1,
                                          float inv) {
  if (Q8) {
    unsigned char* p = buf + r * row_b + n;
    p[0] = static_cast<unsigned char>(q8(v0, inv) & 0xff);
    p[1] = static_cast<unsigned char>(q8(v1, inv) & 0xff);
  } else {
    __nv_bfloat162 h;
    h.x = __float2bfloat16_rn(v0);
    h.y = __float2bfloat16_rn(v1);
    *reinterpret_cast<__nv_bfloat162*>(buf + r * row_b + 2 * n) = h;
  }
}

template <int F, bool Q8>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_kernel(const __nv_bfloat16* __restrict__ x,
                  const float* __restrict__ inv,
                  const void* __restrict__ w1, const float* __restrict__ s1,
                  const float* __restrict__ b1,
                  const void* __restrict__ w2, const float* __restrict__ s2,
                  const float* __restrict__ b2,
                  const void* __restrict__ w3, const float* __restrict__ s3,
                  const float* __restrict__ b3,
                  __nv_bfloat16* __restrict__ out, int H, int W) {
  using C = Cfg<F, Q8>;
  using Acc = typename C::Acc;
  constexpr int kC4 = C::kC4, kE = C::kE;
  constexpr int kAW = C::kARowB / 4;             // a1/a2 row words
  constexpr int kRW = kRowB / 4;                 // slice row words
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_x = smem;
  unsigned char* s_w = s_x + C::kXs;
  unsigned char* s_a1 = s_w + C::kWb;
  unsigned char* s_a2 = s_a1 + C::kA1;
  float* s_b1 = reinterpret_cast<float*>(s_a2 + C::kA2);
  float* s_b2 = s_b1 + F;
  float* s_s1 = s_b2 + F;
  float* s_s2 = s_s1 + F;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * kTH, ox0 = blockIdx.x * kTW;
  const float inv1 = Q8 ? inv[0] : 1.0f, inv2 = Q8 ? inv[1] : 1.0f;
  const float inv3 = Q8 ? inv[2] : 1.0f;
  for (int i = tid; i < F; i += kThreads) {
    s_b1[i] = b1[i];
    s_b2[i] = b2[i];
    s_s1[i] = Q8 ? s1[i] : 1.0f;
    s_s2[i] = Q8 ? s2[i] : 1.0f;
  }
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * H * W * kC4;
  const unsigned char* w1b = static_cast<const unsigned char*>(w1);
  const unsigned char* w2b = static_cast<const unsigned char*>(w2);
  const unsigned char* w3b = static_cast<const unsigned char*>(w3);

  // ---- conv1 over the 10x10 halo tile: (112 x 4F) . (4F x F) ----
  {
    constexpr int kNW = C::kN1 / kWarps;         // columns a warp
    constexpr int NF = kNW / 8;
    for (int nc = 0; nc < F; nc += C::kN1) {
      Acc acc[7][NF][4];
      zero(acc);
      for (int kc = 0; kc < kC4 * kE; kc += kKC) {
        __syncthreads();
        // x slice: 128 bytes of channels of each halo pixel (zero outside)
        for (int i = tid; i < kM1 * 8; i += kThreads) {
          const int p = i / 8, c = i % 8;
          const int gy = oy0 - 1 + p / kHC, gx = ox0 - 1 + p % kHC;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (p < kNP1 && gy >= 0 && gy < H && gx >= 0 && gx < W) {
            const __nv_bfloat16* src =
                xb + (static_cast<size_t>(gy) * W + gx) * kC4;
            if (Q8) {
              const uint4* s16 =
                  reinterpret_cast<const uint4*>(src + kc + 16 * c);
              v = quantize16(s16[0], s16[1], inv1);
            } else {
              v = *reinterpret_cast<const uint4*>(src + kc / 2 + 8 * c);
            }
          }
          *reinterpret_cast<uint4*>(s_x + p * kRowB + c * 16) = v;
        }
        load_rows(s_w, w1b + static_cast<size_t>(nc) * kC4 * kE + kc,
                  size_t(kC4) * kE, C::kN1, kKC);
        __syncthreads();
        const uint32_t* xw = reinterpret_cast<const uint32_t*>(s_x);
        const uint32_t* ww = reinterpret_cast<const uint32_t*>(s_w);
        const uint32_t* ap0[7];
        const uint32_t* ap1[7];
        const uint32_t* bp[NF];
#pragma unroll
        for (int mf = 0; mf < 7; ++mf) {
          ap0[mf] = xw + (mf * 16 + g) * kRW;
          ap1[mf] = xw + (mf * 16 + g + 8) * kRW;
        }
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
          bp[nf] = ww + (warp * kNW + nf * 8 + g) * kRW;
        mma_slice(acc, ap0, ap1, bp, kKC / 32, t);
      }
      // bias + ReLU, zero outside the image, then round (bf16) or
      // quantize for conv2 (q8)
#pragma unroll
      for (int mf = 0; mf < 7; ++mf) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = mf * 16 + g + 8 * h;
          const int gy = oy0 - 1 + p / kHC, gx = ox0 - 1 + p % kHC;
          const bool valid =
              p < kNP1 && gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int nf = 0; nf < NF; ++nf) {
            const int n = nc + warp * kNW + nf * 8 + 2 * t;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float a = static_cast<float>(acc[mf][nf][2 * h + e]);
              const float y = (Q8 ? a * s_s1[n + e] : a) + s_b1[n + e];
              v[e] = valid ? fmaxf(y, 0.0f) : 0.0f;
            }
            store_act<Q8>(s_a1, C::kARowB, p, n, v[0], v[1], inv2);
          }
        }
      }
    }
  }

  // ---- conv2 (3x3) on the 8x8 output pixels: 9 taps of (64 x F).(F x F)
  {
    constexpr int kNW = F / kWarps;
    constexpr int NF = kNW / 8;
    Acc acc[4][NF][4];
    zero(acc);
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      for (int kc = 0; kc < C::kKF; kc += C::kKC2) {
        __syncthreads();
        load_rows(s_w, w2b + (static_cast<size_t>(tap) * F) * C::kKF + kc,
                  C::kKF, F, C::kKC2);
        __syncthreads();
        const uint32_t* aw = reinterpret_cast<const uint32_t*>(s_a1);
        const uint32_t* ww = reinterpret_cast<const uint32_t*>(s_w);
        const uint32_t* ap0[4];
        const uint32_t* ap1[4];
        const uint32_t* bp[NF];
#pragma unroll
        for (int mf = 0; mf < 4; ++mf) {
          // output pixel m = 16 mf + g is (2 mf, g); m + 8 is (2 mf + 1, g)
          const int r0 = (2 * mf + ky) * kHC + g + kx;
          ap0[mf] = aw + r0 * kAW + kc / 4;
          ap1[mf] = aw + (r0 + kHC) * kAW + kc / 4;
        }
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
          bp[nf] = ww + (warp * kNW + nf * 8 + g) * kRW;
        mma_slice(acc, ap0, ap1, bp, C::kKC2 / 32, t);
      }
    }
#pragma unroll
    for (int mf = 0; mf < 4; ++mf) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mf * 16 + g + 8 * h;
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          const int n = warp * kNW + nf * 8 + 2 * t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a = static_cast<float>(acc[mf][nf][2 * h + e]);
            v[e] = fmaxf((Q8 ? a * s_s2[n + e] : a) + s_b2[n + e], 0.0f);
          }
          store_act<Q8>(s_a2, C::kARowB, m, n, v[0], v[1], inv3);
        }
      }
    }
  }

  // ---- conv3 (64 x F).(F x 4F) + b3 + residual, ReLU, bf16 out ----
  {
    constexpr int kNW = C::kN3 / kWarps;         // 32 columns a warp
    constexpr int NF = kNW / 8;
    for (int nc = 0; nc < kC4; nc += C::kN3) {
      Acc acc[4][NF][4];
      zero(acc);
      for (int kc = 0; kc < C::kKF; kc += C::kKC2) {
        __syncthreads();
        load_rows(s_w, w3b + static_cast<size_t>(nc) * C::kKF + kc, C::kKF,
                  C::kN3, C::kKC2);
        __syncthreads();
        const uint32_t* aw = reinterpret_cast<const uint32_t*>(s_a2);
        const uint32_t* ww = reinterpret_cast<const uint32_t*>(s_w);
        const uint32_t* ap0[4];
        const uint32_t* ap1[4];
        const uint32_t* bp[NF];
#pragma unroll
        for (int mf = 0; mf < 4; ++mf) {
          ap0[mf] = aw + (mf * 16 + g) * kAW + kc / 4;
          ap1[mf] = aw + (mf * 16 + g + 8) * kAW + kc / 4;
        }
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
          bp[nf] = ww + (warp * kNW + nf * 8 + g) * kRW;
        mma_slice(acc, ap0, ap1, bp, C::kKC2 / 32, t);
      }
#pragma unroll
      for (int mf = 0; mf < 4; ++mf) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mf * 16 + g + 8 * h;
          const int oy = oy0 + m / kTW, ox = ox0 + m % kTW;
          if (ox >= W) continue;
          const size_t pix = (static_cast<size_t>(b) * H + oy) * W + ox;
#pragma unroll
          for (int nf = 0; nf < NF; ++nf) {
            const int n = nc + warp * kNW + nf * 8 + 2 * t;
            const __nv_bfloat162 r =
                *reinterpret_cast<const __nv_bfloat162*>(x + pix * kC4 + n);
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float a = static_cast<float>(acc[mf][nf][2 * h + e]);
              const float y = (Q8 ? a * s3[n + e] : a) + b3[n + e];
              const float res = __bfloat162float(e ? r.y : r.x);
              v[e] = fmaxf(y + res, 0.0f);
            }
            __nv_bfloat162 o;
            o.x = __float2bfloat16_rn(v[0]);
            o.y = __float2bfloat16_rn(v[1]);
            *reinterpret_cast<__nv_bfloat162*>(out + pix * kC4 + n) = o;
          }
        }
      }
    }
  }
}

template <int F, bool Q8>
int launch(const void* x, const void* inv, const void* w1, const void* s1,
           const void* b1, const void* w2, const void* s2, const void* b2,
           const void* w3, const void* s3, const void* b3, void* out, int B,
           int H, int W, void* stream) {
  constexpr size_t kSmem = Cfg<F, Q8>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel<F, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kTW - 1) / kTW, H / kTH, B);
  bottleneck_kernel<F, Q8><<<grid, kThreads, kSmem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(inv),
      w1, static_cast<const float*>(s1), static_cast<const float*>(b1), w2,
      static_cast<const float*>(s2), static_cast<const float*>(b2), w3,
      static_cast<const float*>(s3), static_cast<const float*>(b3),
      static_cast<__nv_bfloat16*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}

template <bool Q8>
int dispatch(const void* x, const void* inv, const void* w1, const void* s1,
             const void* b1, const void* w2, const void* s2, const void* b2,
             const void* w3, const void* s3, const void* b3, void* out,
             int B, int H, int W, int F, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (H % kTH) return static_cast<int>(cudaErrorInvalidValue);
  switch (F) {
    case 64:
      return launch<64, Q8>(x, inv, w1, s1, b1, w2, s2, b2, w3, s3, b3, out,
                            B, H, W, stream);
    case 128:
      return launch<128, Q8>(x, inv, w1, s1, b1, w2, s2, b2, w3, s3, b3, out,
                             B, H, W, stream);
    case 256:
      return launch<256, Q8>(x, inv, w1, s1, b1, w2, s2, b2, w3, s3, b3, out,
                             B, H, W, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int r3det_bottleneck(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2,
                                const void* w3, const void* b3, void* out,
                                int B, int H, int W, int F, void* stream) {
  return dispatch<false>(x, nullptr, w1, nullptr, b1, w2, nullptr, b2, w3,
                         nullptr, b3, out, B, H, W, F, stream);
}

extern "C" int r3det_bottleneck_q8(const void* x, const void* inv,
                                   const void* w1, const void* s1,
                                   const void* b1, const void* w2,
                                   const void* s2, const void* b2,
                                   const void* w3, const void* s3,
                                   const void* b3, void* out, int B, int H,
                                   int W, int F, void* stream) {
  return dispatch<true>(x, inv, w1, s1, b1, w2, s2, b2, w3, s3, b3, out, B,
                        H, W, F, stream);
}
