// FRM points=1 feature refinement of one pyramid level, fused:
//   out = x + (feat + sample),
//   sample[b, cell, :] = bilinear sample of feat at the cell's best-box
//                        centre (zero outside (-1, H) x (-1, W)).
// x, feat and out are (B, H, W, C) bf16 NHWC (a channels_last NCHW tensor
// seen through permute), rois (B, H*W, 5) f32 image-coordinate boxes.
//
// Replaces the TPU kernel r3det_tpu/ops/frm_sample.py::bilinear_sample_band
// (_sample_kernel, _corner_window_setup, _outlier_correction) and the XLA
// gather it stood beside, r3det_tpu/models/frm.py::bilinear_sample; the
// arithmetic follows models/frm.py::feature_refine_sample (:80-87, with the
// reference's transposed-coordinate quirk: row <- cx * scale,
// col <- cy * scale) and bilinear_sample (:41-51). The TPU kernel needed a
// +-2 stencil window, an outlier budget and a flat-gather fallback because
// a TPU cannot gather rows cheaply; here every cell reads its 4 corner rows
// directly, so the kernel is exact for every box with no window at all.
// Corner weights stay in f32 (the band kernel's rule; the XLA gather
// rounded them to feat's dtype), and the sample is rounded to the output
// type before each of the two residual adds, as the plain version does.
//
// What bounds it on the H100: memory. Per cell it moves x, feat and out
// (3 rows of C values) plus 4 corner rows that, for real rois, lie within a
// pixel or two of the cell and so hit in L1/L2; ~2 flops per byte. The
// design is one block per grid cell, one thread per channel, so every
// global access is a contiguous C-wide row, and the fused residual adds
// save the two extra passes over the level that separate adds would cost.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__global__ void frm_sample_kernel(const __nv_bfloat16* __restrict__ x,
                                  const __nv_bfloat16* __restrict__ feat,
                                  const float* __restrict__ rois,
                                  __nv_bfloat16* __restrict__ out, int H,
                                  int W, int C, float scale, int quirk) {
  const int cell = blockIdx.x;            // b * H * W + h * W + w
  const int b = cell / (H * W);
  const float* roi = rois + static_cast<size_t>(cell) * 5;
  const float cx = roi[0] * scale;
  const float cy = roi[1] * scale;
  const float row = quirk ? cx : cy;
  const float col = quirk ? cy : cx;
  const bool inside = row > -1.0f && row < static_cast<float>(H) &&
                      col > -1.0f && col < static_cast<float>(W);
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
  const float w00 = hy * hx, w01 = hy * lx, w10 = ly * hx, w11 = ly * lx;

  const size_t img = static_cast<size_t>(b) * H * W;
  const size_t r0 = img + static_cast<size_t>(y0) * W;
  const size_t r1 = img + static_cast<size_t>(y1) * W;
  const __nv_bfloat16* f00 = feat + (r0 + x0) * C;
  const __nv_bfloat16* f01 = feat + (r0 + x1) * C;
  const __nv_bfloat16* f10 = feat + (r1 + x0) * C;
  const __nv_bfloat16* f11 = feat + (r1 + x1) * C;
  const size_t base = static_cast<size_t>(cell) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.0f;
    if (inside) {
      s = w00 * __bfloat162float(f00[c]) + w01 * __bfloat162float(f01[c]) +
          w10 * __bfloat162float(f10[c]) + w11 * __bfloat162float(f11[c]);
    }
    // round the sample, then each residual add, to bf16 (the plain form)
    const float sample = __bfloat162float(__float2bfloat16_rn(s));
    const float refined = __bfloat162float(
        __float2bfloat16_rn(__bfloat162float(feat[base + c]) + sample));
    out[base + c] =
        __float2bfloat16_rn(__bfloat162float(x[base + c]) + refined);
  }
}

}  // namespace

extern "C" int r3det_frm_sample(const void* x, const void* feat,
                                const void* rois, void* out, int B, int H,
                                int W, int C, float scale, int quirk,
                                void* stream) {
  const long long cells = static_cast<long long>(B) * H * W;
  if (cells <= 0 || C <= 0) return 0;
  if (cells > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = C < 256 ? ((C + 31) / 32) * 32 : 256;
  frm_sample_kernel<<<static_cast<int>(cells), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(feat),
      static_cast<const float*>(rois), static_cast<__nv_bfloat16*>(out), H, W,
      C, scale, quirk);
  return static_cast<int>(cudaGetLastError());
}
