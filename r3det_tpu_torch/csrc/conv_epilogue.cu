// The bf16 conv epilogue: what follows a bottleneck conv, in one pass over
// its output.
//   a (B, H, W, C) bf16 NHWC, the raw conv output; inv, b (C,) bf16, the
//   conv's FrozenBN affine (models/resnet.py::FrozenBN.affine);
//   residual: none, r (B, H, W, C) bf16 as it is (identity), or a raw
//   downsample-conv output d with its own affine inv_d, b_d (C,) bf16;
//   an optional ReLU  ->  out (B, H, W, C) bf16, which may be a itself.
// C % 8 == 0 (the wrapper, ops/conv_epilogue.py, asks C % 64 == 0); every
// pointer 16-byte aligned.
//
// Numerics: the unfused route's ops (FrozenBN.forward's multiply, then its
// add; the downsample's FrozenBN the same way; the residual add; F.relu),
// each computed in f32 on bf16 operands and rounded to bf16 as PyTorch's
// bf16 elementwise kernels round (__float2bfloat16_rn), so the result is
// bit-equal to that route on the same conv outputs:
//   y = bf16(a * inv);  y = bf16(y + b)
//   r' = r  |  bf16(bf16(d * inv_d) + b_d)
//   y = bf16(y + r')                              (residual)
//   y = isnan(y) ? y : fmaxf(y, 0)                (ReLU, as clamp_min(0))
// BN is not folded into the weights, which would compute another bf16
// function. The build's --fmad=false keeps each product and sum apart.
//
// No TPU kernel stands behind it: in the JAX package XLA fuses FrozenBN,
// ReLU and the residual add into the convolution it emits
// (r3det_tpu/models/resnet.py, Bottleneck.__call__).
//
// Design: memory-bound (no reuse: each byte is read or written once), so
// the whole game is to keep enough 16-byte loads in flight. A thread owns
// 8 channels (one 16-byte vector) of a fixed channel slice for the whole
// launch: the grid stride is a multiple of C / 8, so the slice's inv and b
// (and inv_d, b_d) are loaded once into registers, kept as packed bf16. A
// grid-stride loop over the vectors takes kUnroll vectors at a time, all
// of whose loads (of a, and of r or d) are issued before any is used. The
// grid is as many blocks as fit on the SMs at once. (Measured at the R50
// shapes: 2, 4 or 8 vectors in flight, 128–512 threads a block and
// streaming stores are within 3% of each other; 2 is the best by a hair.)
//
// What bounds it (NVIDIA H100 SXM, 3.35 TB/s): the bytes, 2 * numel(a) *
// 2 (read a, write out) plus 2 * numel(r) with a residual. At R50 C2's
// conv3 (8, 256, 256, 256) with the identity residual: 0.81 GB, 0.240 ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // vectors a thread has in flight per operand

enum Residual { kNone = 0, kIdentity = 1, kAffine = 2 };

// f32 -> bf16 -> f32, rounded to nearest even (PyTorch's bf16 store)
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float lane(const uint4& u, int k) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
  return __bfloat162float(h[k]);
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <int kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads)
conv_epilogue_kernel(const __nv_bfloat16* a,
                     const __nv_bfloat16* __restrict__ inv,
                     const __nv_bfloat16* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ r,
                     const __nv_bfloat16* __restrict__ inv_d,
                     const __nv_bfloat16* __restrict__ bias_d,
                     __nv_bfloat16* out, long long n_vec, int c8,
                     long long stride) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= stride) return;  // threads past the largest multiple of c8 idle
  const int c = static_cast<int>(t % c8) * 8;
  const uint4 s = load16(inv + c), b = load16(bias + c);
  uint4 sd = s, bd = b;
  if (kRes == kAffine) {
    sd = load16(inv_d + c);
    bd = load16(bias_d + c);
  }
  for (long long base = t; base < n_vec; base += kUnroll * stride) {
    uint4 va[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i < n_vec) {
        va[u] = load16(a + i * 8);
        if (kRes != kNone) vr[u] = load16(r + i * 8);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i >= n_vec) break;
      uint4 o;
      __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float y = round_bf16(lane(va[u], k) * lane(s, k));
        y = round_bf16(y + lane(b, k));
        if (kRes == kAffine) {
          float d = round_bf16(lane(vr[u], k) * lane(sd, k));
          d = round_bf16(d + lane(bd, k));
          y = round_bf16(y + d);
        } else if (kRes == kIdentity) {
          y = round_bf16(y + lane(vr[u], k));
        }
        if (kRelu && !isnan(y)) y = fmaxf(y, 0.0f);
        h[k] = __float2bfloat16_rn(y);
      }
      *reinterpret_cast<uint4*>(out + i * 8) = o;
    }
  }
}

template <int kRes, bool kRelu>
int launch(const void* a, const void* inv, const void* bias, const void* r,
           const void* inv_d, const void* bias_d, void* out, long long n_pix,
           int C, int sms, cudaStream_t stream) {
  // blocks a SM, found once per device and variant
  static int occupancy[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  int& per_sm = occupancy[dev];
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, conv_epilogue_kernel<kRes, kRelu>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int c8 = C / 8;
  const long long n_vec = n_pix * c8;
  const long long need = (n_vec + kThreads - 1) / kThreads;
  const long long full = static_cast<long long>(per_sm) * sms;
  const int grid = static_cast<int>(need < full ? need : full);
  // the largest multiple of c8 the grid's threads cover (n_vec >= c8)
  const long long threads = static_cast<long long>(grid) * kThreads;
  const long long stride = threads / c8 * c8;
  conv_epilogue_kernel<kRes, kRelu><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(inv),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(r),
      static_cast<const __nv_bfloat16*>(inv_d),
      static_cast<const __nv_bfloat16*>(bias_d),
      static_cast<__nv_bfloat16*>(out), n_vec, c8, stride);
  return static_cast<int>(cudaGetLastError());
}

template <int kRes>
int launch_relu(bool relu, const void* a, const void* inv, const void* bias,
                const void* r, const void* inv_d, const void* bias_d,
                void* out, long long n_pix, int C, int sms,
                cudaStream_t stream) {
  return relu ? launch<kRes, true>(a, inv, bias, r, inv_d, bias_d, out,
                                   n_pix, C, sms, stream)
              : launch<kRes, false>(a, inv, bias, r, inv_d, bias_d, out,
                                    n_pix, C, sms, stream);
}

}  // namespace

// res_kind: 0 none, 1 identity (r), 2 affine (r is d, with inv_d, bias_d)
extern "C" int r3det_conv_epilogue(const void* a, const void* inv,
                                   const void* bias, const void* r,
                                   const void* inv_d, const void* bias_d,
                                   void* out, long long n_pix, int C,
                                   int res_kind, int relu, int sms,
                                   void* stream) {
  if (n_pix <= 0) return 0;
  if (C <= 0 || C % 8 || sms <= 0 || res_kind < kNone ||
      res_kind > kAffine || (res_kind != kNone && r == nullptr) ||
      (res_kind == kAffine && (inv_d == nullptr || bias_d == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (res_kind) {
    case kIdentity:
      return launch_relu<kIdentity>(relu, a, inv, bias, r, inv_d, bias_d,
                                    out, n_pix, C, sms, s);
    case kAffine:
      return launch_relu<kAffine>(relu, a, inv, bias, r, inv_d, bias_d,
                                  out, n_pix, C, sms, s);
    default:
      return launch_relu<kNone>(relu, a, inv, bias, r, inv_d, bias_d, out,
                                n_pix, C, sms, s);
  }
}
