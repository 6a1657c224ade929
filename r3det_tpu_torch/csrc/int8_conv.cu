// QConv's int8 convolution (models/quant.py) with its whole epilogue, as
// one implicit GEMM on Hopper's warpgroup MMA:
//   acc[b, oy, ox, n] = sum_{ky, kx, c} xi[b, oy*sh - ph + ky,
//                                          ox*sw - pw + kx, c]
//                                       * w[n, ky, kx, c]
//   xi: clip(rint(x / ascale), +-127) of a bf16 NHWC input (q_in = 1), or
//       int8 NHWC codes as they are (q_in = 0);
//   w:  the int8 weight codes, packed by ops/int8_conv.py::pack_weights.
// The epilogue reproduces every rounding of the unfused PyTorch ops, in
// their order, each step optional:
//   a = bf16(acc)
//   y = bf16(float(a) * (ascale * kscale[n]) [+ bias[n]])
//   y = bf16(y * inv[n]); y = bf16(y + b[n])        (FrozenBN, bf16 inv, b)
//   y = bf16(y + r)      r: bf16 residual, or bf16(float(code) * rscale)
//   y = max(y, 0)                                   (ReLU)
//   out = y (bf16 NHWC) or clip(rint(y / oscale), +-127) (int8 codes for
//   the next static QConv).
// The scales are f32 device scalars, so calibrated scales need no host
// sync. There is no TPU kernel behind this function: the JAX package
// leaves the int8 conv to XLA (lax.conv_general_dilated(...,
// preferred_element_type=bf16), r3det_tpu/models/quant.py:111-115); its
// plain version is ops/int8_conv.py::qconv_fused_reference.
//
// Design. A tile is 16 x 8 output pixels (16 rows, 8 columns of one
// image) x BN output channels (BN = 256, or 128 / 64 where Co is not a
// multiple of 256 / 128); one block per SM walks over the tiles
// (persistent). 12 warps:
// - warps 0-2 stage the tile's input halo once per 64-channel chunk of Ci
//   into a ring of 2-4 shared-memory stages: int8 codes with cp.async, a
//   bf16 input copied with cp.async into a staging buffer and quantized
//   from there (or, where the staging buffer does not fit, through
//   registers), so each input value is quantized once per block, not once
//   per tap;
// - warp 3 streams the weights with bulk copies (the TMA engine)
//   completing on mbarriers, into a ring of 4-6 stages of up to 24 KB,
//   each holding as many taps of one chunk as fit; pack_weights lays the
//   weights out in device memory exactly as the MMA reads them (rows of
//   64 bytes of K, Hopper's 64-byte swizzle), so a stage is one copy;
// - warps 4-11 are two consumer warpgroups, 8 output rows each: for every
//   stage they issue wgmma.mma_async m64nBNk32 s8.s8.s32 from shared
//   memory, keep one MMA group in flight, release each weight stage when
//   its group completes and each halo stage when its chunk's last group
//   completes.
// The halo is stored as [c16][row phase][row][column phase][column][16 B]
// (phases split stride-2 rows and columns). One tap's A operand is then a
// strided view of it: a core matrix (8 rows x 16 B) is 8 consecutive
// output columns of one output row, the leading byte offset steps 16
// channels and the stride byte offset one output row, so a no-swizzle
// descriptor reads every tap from the same stage and no tap is gathered
// again. The epilogue stages bf16(acc) in shared memory; each thread then
// finishes 16 channels of one pixel with 16-byte residual loads and
// 16-byte stores. The quantizes take the reciprocal product and fall back
// to the IEEE divide only within 4 ulp of a .5 boundary, so they round as
// PyTorch's x / scale does.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py prints the
// times and PERF.md keeps them): at the R50 C2 3x3 conv (8, 256, 256,
// 64) -> 64 with int8 input and codes out, the function moves 67 MB for
// 39 GOP, so memory bounds it (0.020 ms); the kernel stays well above
// that, because the 64-channel tile gives each weight stage only 2 x 6
// small MMAs against the fixed cost of its barriers, and because the
// epilogue runs beside no MMA (both MMA warpgroups reach it together; a
// separate epilogue warpgroup would leave too few registers for the
// 256-channel tile). At the head's P3 3x3 conv (8, 128, 128, 256) -> 256
// it does 155 GOP, bound by the int8 tensor rate (0.078 ms); from int8
// input the MMAs and the epilogue take the time, from bf16 input the
// three halo warps' quantize does, and the MMA warpgroups wait for it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 16;                     // output rows of a tile
constexpr int kTW = 8;                      // output columns of a tile
constexpr int kHStagesMax = 4;              // halo ring (2 to 4 stages)
constexpr int kHaloMax = 40 * 1024;         // bytes of one halo stage (max)
constexpr int kMaxTaps = 32;
constexpr int kHaloThreads = 96;            // warps 0-2
constexpr int kThreads = 384;               // + weight warp 3, 2 MMA WGs

struct Params {
  const void* x;
  const float* ascale;
  const int8_t* w;
  const float* kscale;
  const float* bias;
  const __nv_bfloat16* inv;
  const __nv_bfloat16* bnb;
  const void* res;
  const float* rscale;
  void* out;
  const float* oscale;
  int q_in, res_kind, relu, out_q;
  int B, H, W, Ci, Ho, Wo, Co, kh, kw, sh, sw, ph, pw;
  int nchunks, taps, tps, py, px, hhp, hwp, npx;
  int tiles_x, tiles_img, n_tiles, num_tiles, halo_stride, hstages;
  int raw_stride;             // bytes of a bf16 staging buffer, 0 for none
};

// shared memory of one block, in bytes
template <int BN, int CK>
struct Smem {
  // weight ring: kWS stages of up to kW bytes, each tps taps of one chunk
  static constexpr int kWS = BN == 64 ? 6 : 4;
  static constexpr size_t kW = (BN == 128 ? 24 : BN == 64 ? 12 : 16) * 1024;
  static constexpr int kRow = 2 * BN + 16;                    // staged row
  static constexpr size_t kStage = size_t(64) * kRow;         // per WG
  static constexpr size_t kPar = size_t(4) * BN * sizeof(float);
  __host__ __device__ static size_t halo(const Params&) { return kWS * kW; }
  __host__ __device__ static size_t raw(const Params& p) {
    return halo(p) + size_t(p.hstages) * p.halo_stride;
  }
  __host__ __device__ static size_t stage(const Params& p) {
    return raw(p) + size_t(2) * p.raw_stride;
  }
  __host__ __device__ static size_t par(const Params& p) {
    return stage(p) + 2 * kStage;
  }
  __host__ __device__ static size_t pix(const Params& p) {
    return par(p) + 2 * kPar;
  }
  __host__ __device__ static size_t taps(const Params& p) {
    return pix(p) + (size_t(p.npx) * 4 + 15) / 16 * 16;
  }
  __host__ __device__ static size_t bars(const Params& p) {
    return taps(p) + 2 * kMaxTaps * sizeof(int);
  }
  __host__ __device__ static size_t total(const Params& p) {
    return bars(p) + (2 * kWS + 2 * kHStagesMax) * 8;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes global -> shared, asynchronously; zeros where src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// the fields of a K-major operand descriptor but its start address: the
// byte offsets of the K-adjacent core matrix (lbo, no swizzle only) and of
// the next 8 rows (sbo), and the layout (0 none, 2 64-byte swizzle, 3
// 32-byte swizzle)
__device__ __forceinline__ uint64_t desc_strides(uint32_t lbo, uint32_t sbo,
                                                 uint32_t layout = 0) {
  return (static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ uint64_t desc_at(uint64_t strides, uint32_t addr) {
  return strides | ((addr >> 4) & 0x3fff);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define R8(d, i)                                                        \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),         \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

__device__ __forceinline__ void wgmma(int (&d)[32], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p;\n}\n"
      : R8(d, 0), R8(d, 8), R8(d, 16), R8(d, 24)
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : R8(d, 0), R8(d, 8), R8(d, 16), R8(d, 24), R8(d, 32), R8(d, 40),
        R8(d, 48), R8(d, 56)
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(int (&d)[128], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : R8(d, 0), R8(d, 8), R8(d, 16), R8(d, 24), R8(d, 32), R8(d, 40),
        R8(d, 48), R8(d, 56), R8(d, 64), R8(d, 72), R8(d, 80), R8(d, 88),
        R8(d, 96), R8(d, 104), R8(d, 112), R8(d, 120)
      : "l"(a), "l"(b), "r"(scale_d));
}

// 16 int8 codes clip(rint(v / scale), +-127), exactly as PyTorch's
// quantize_act: the product with the reciprocal is within 2.5 ulp of the
// rounded quotient, so it picks the same integer unless it lies within 4
// ulp of a .5 boundary; only such values take the IEEE divide, on a branch
// taken once for the 16 (so the common path has no branch to serialize)
__device__ __forceinline__ uint4 codes16(const float* v, float scale,
                                         float rcp) {
  float y[16];
  uint32_t near = 0;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    y[e] = v[e] * rcp;
    const float fr = y[e] - floorf(y[e]);
    near |= static_cast<uint32_t>(fabsf(fr - 0.5f) <=
                                  fabsf(y[e]) * 6e-7f + 3e-7f)
            << e;
  }
  if (near) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if ((near >> e) & 1u) y[e] = v[e] / scale;
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int q = static_cast<int>(fminf(fmaxf(rintf(y[e]), -127.0f), 127.0f));
    w[e / 4] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * (e % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 bf16 values -> 16 int8 codes
__device__ __forceinline__ uint4 quantize16(uint4 lo, uint4 hi, float scale,
                                            float rcp) {
  float f[16];
  const __nv_bfloat16* a = reinterpret_cast<const __nv_bfloat16*>(&lo);
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&hi);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    f[e] = __bfloat162float(a[e]);
    f[e + 8] = __bfloat162float(b[e]);
  }
  return codes16(f, scale, rcp);
}

__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Tile {
  int b, oy0, ox0, n0;
};

__device__ __forceinline__ Tile tile_of(const Params& p, int t, int bn) {
  Tile r;
  const int m = t / p.n_tiles;
  r.n0 = (t - m * p.n_tiles) * bn;
  r.b = m / p.tiles_img;
  const int rem = m - r.b * p.tiles_img;
  const int ty = rem / p.tiles_x;
  r.oy0 = ty * kTH;
  r.ox0 = (rem - ty * p.tiles_x) * kTW;
  return r;
}

// warps 0-2: one CK-channel chunk of the tile's halo into a halo stage,
// quantized. pix[i] is halo pixel i's (row, column) offset from the
// tile's top-left input pixel; the stage holds [c16][pixel][16 B].
template <int CK>
__device__ __forceinline__ void stage_halo(const Params& p, const Tile& tl,
                                           int c0, const short2* pix,
                                           unsigned char* dst, float ascale,
                                           float rcp, int tid) {
  constexpr int kV = CK / 16;               // 16-byte code vectors a pixel
  constexpr int kU = 2;                     // pixels a thread in flight
  const int iy0 = tl.oy0 * p.sh - p.ph, ix0 = tl.ox0 * p.sw - p.pw;
  for (int p0 = tid; p0 < p.npx; p0 += kU * kHaloThreads) {
    uint4 v[kU][2 * kV];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = p0 + u * kHaloThreads;
#pragma unroll
      for (int k = 0; k < 2 * kV; ++k) v[u][k] = make_uint4(0, 0, 0, 0);
      if (i < p.npx) {
        const short2 d = pix[i];
        const int iy = iy0 + d.x, ix = ix0 + d.y;
        if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W) {
          const size_t e =
              ((static_cast<size_t>(tl.b) * p.H + iy) * p.W + ix) * p.Ci + c0;
          if (p.q_in) {
            const uint4* s = reinterpret_cast<const uint4*>(
                static_cast<const __nv_bfloat16*>(p.x) + e);
#pragma unroll
            for (int k = 0; k < 2 * kV; ++k) v[u][k] = s[k];
          } else {
            const uint4* s = reinterpret_cast<const uint4*>(
                static_cast<const int8_t*>(p.x) + e);
#pragma unroll
            for (int k = 0; k < kV; ++k) v[u][k] = s[k];
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = p0 + u * kHaloThreads;
      if (i >= p.npx) continue;
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        const uint4 q = p.q_in ? quantize16(v[u][2 * k], v[u][2 * k + 1],
                                            ascale, rcp)
                               : v[u][k];
        *reinterpret_cast<uint4*>(dst + (static_cast<size_t>(k) * p.npx + i) *
                                            16) = q;
      }
    }
  }
}

// warps 0-2, int8 input: the same chunk copied as it is, asynchronously
template <int CK>
__device__ __forceinline__ void issue_halo_codes(const Params& p,
                                                 const Tile& tl, int c0,
                                                 const short2* pix,
                                                 uint32_t dst, int tid) {
  const int8_t* x = static_cast<const int8_t*>(p.x);
  const int iy0 = tl.oy0 * p.sh - p.ph, ix0 = tl.ox0 * p.sw - p.pw;
  for (int i = tid; i < p.npx; i += kHaloThreads) {
    const short2 d = pix[i];
    const int iy = iy0 + d.x, ix = ix0 + d.y;
    const bool in = iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
    const int8_t* src =
        in ? x + ((static_cast<size_t>(tl.b) * p.H + iy) * p.W + ix) * p.Ci +
                 c0
           : x;
#pragma unroll
    for (int k = 0; k < CK / 16; ++k)
      cp_async16(dst + (k * p.npx + i) * 16, src + 16 * k, in ? 16 : 0);
  }
}

// warps 0-2, bf16 input with a staging buffer: the same chunk's bf16
// values copied as they are, asynchronously, [pixel][CK values + 16 B]
template <int CK>
__device__ __forceinline__ void issue_halo_raw(const Params& p,
                                               const Tile& tl, int c0,
                                               const short2* pix,
                                               uint32_t dst, int tid) {
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const int iy0 = tl.oy0 * p.sh - p.ph, ix0 = tl.ox0 * p.sw - p.pw;
  for (int i = tid; i < p.npx; i += kHaloThreads) {
    const short2 d = pix[i];
    const int iy = iy0 + d.x, ix = ix0 + d.y;
    const bool in = iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
    const __nv_bfloat16* src =
        in ? x + ((static_cast<size_t>(tl.b) * p.H + iy) * p.W + ix) * p.Ci +
                 c0
           : x;
#pragma unroll
    for (int k = 0; k < CK / 8; ++k)
      cp_async16(dst + i * (2 * CK + 16) + 16 * k, src + 8 * k, in ? 16 : 0);
  }
}

// ... then quantized from the staging buffer into a halo stage; each
// thread reads back the pixels it copied
template <int CK>
__device__ __forceinline__ void quantize_halo(const Params& p,
                                              const unsigned char* raw,
                                              unsigned char* dst,
                                              float ascale, float rcp,
                                              int tid) {
  for (int i = tid; i < p.npx; i += kHaloThreads) {
    const uint4* s = reinterpret_cast<const uint4*>(raw + i * (2 * CK + 16));
#pragma unroll
    for (int k = 0; k < CK / 16; ++k)
      *reinterpret_cast<uint4*>(dst + (static_cast<size_t>(k) * p.npx + i) *
                                          16) =
          quantize16(s[2 * k], s[2 * k + 1], ascale, rcp);
  }
}

// a consumer warpgroup's per-channel epilogue factors for output channels
// n0.., stored [channel % 16][channel / 16], so that the threads of a
// warp, on consecutive 16-channel groups, read consecutive words
template <int BN>
__device__ __forceinline__ void load_factors(const Params& p, int n0,
                                             float* par, float ascale,
                                             int ct) {
  constexpr int kG = BN / 16;
  for (int i = ct; i < BN; i += 128) {
    const int n = n0 + i, k = (i % 16) * kG + i / 16;
    par[k] = ascale * p.kscale[n];
    par[BN + k] = p.bias ? p.bias[n] : 0.0f;
    par[2 * BN + k] = p.inv ? __bfloat162float(p.inv[n]) : 1.0f;
    par[3 * BN + k] = p.bnb ? __bfloat162float(p.bnb[n]) : 0.0f;
  }
}

// one consumer warpgroup's epilogue on its 64 x BN accumulator tile, with
// the factors of load_factors and the residual and output scales
template <int BN, int CK>
__device__ __forceinline__ void epilogue(const Params& p, const Tile& tl,
                                         int cw, int ct, int (&acc)[BN / 2],
                                         unsigned char* stage,
                                         const float* par, float rscale,
                                         float oscale) {
  constexpr int kRow = Smem<BN, CK>::kRow;
  constexpr int kG = BN / 16;              // 16-channel groups a row
  const float* f = par;
  const float* fb = par + BN;
  const float* fi = par + 2 * BN;
  const float* fo = par + 3 * BN;
  // a = bf16(acc), in the accumulator's layout
  const int w4 = ct / 32, lane = ct % 32, g = lane / 4, q = lane % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __nv_bfloat162 v;
      v.x = __float2bfloat16_rn(static_cast<float>(acc[4 * j + 2 * h]));
      v.y = __float2bfloat16_rn(static_cast<float>(acc[4 * j + 2 * h + 1]));
      *reinterpret_cast<__nv_bfloat162*>(
          stage + (16 * w4 + g + 8 * h) * kRow + (8 * j + 2 * q) * 2) = v;
    }
  }
  named_sync(1 + cw);
  const float orcp = 1.0f / oscale;
  // an item is 16 channels of one pixel, a warp's items consecutive
  // channel groups (contiguous stores); the residuals of kU items are
  // loaded before any is used
  constexpr int kU = 4;
  for (int it0 = ct; it0 < 64 * kG; it0 += kU * 128) {
    uint4 res[kU][2];
    size_t off[kU];
    bool ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int it = it0 + u * 128;
      const int r = it / kG, nl = (it % kG) * 16;
      const int oy = tl.oy0 + cw * 8 + r / 8, ox = tl.ox0 + r % 8;
      ok[u] = it < 64 * kG && oy < p.Ho && ox < p.Wo;
      off[u] = ((static_cast<size_t>(tl.b) * p.Ho + oy) * p.Wo + ox) * p.Co +
               tl.n0 + nl;
      res[u][0] = res[u][1] = make_uint4(0, 0, 0, 0);
      if (ok[u] && p.res_kind == 1) {
        const uint4* s = reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(p.res) + off[u]);
        res[u][0] = s[0];
        res[u][1] = s[1];
      } else if (ok[u] && p.res_kind == 2) {
        res[u][0] = *reinterpret_cast<const uint4*>(
            static_cast<const int8_t*>(p.res) + off[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (!ok[u]) continue;
      const int it = it0 + u * 128;
      const int r = it / kG, gi = it % kG, nl = gi * 16;
      uint4 a2[2];
      a2[0] = *reinterpret_cast<const uint4*>(stage + r * kRow + nl * 2);
      a2[1] = *reinterpret_cast<const uint4*>(stage + r * kRow + nl * 2 + 16);
      const __nv_bfloat16* av = reinterpret_cast<const __nv_bfloat16*>(a2);
      const __nv_bfloat16* rb = reinterpret_cast<const __nv_bfloat16*>(res[u]);
      const int8_t* rq = reinterpret_cast<const int8_t*>(res[u]);
      // each optional step over all 16 values, one branch a step
      float y[16];
#pragma unroll
      for (int e = 0; e < 16; ++e)
        y[e] = __bfloat162float(av[e]) * f[e * kG + gi];
      if (p.bias) {
#pragma unroll
        for (int e = 0; e < 16; ++e) y[e] = y[e] + fb[e * kG + gi];
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) y[e] = rbf(y[e]);
      if (p.inv) {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          y[e] = rbf(y[e] * fi[e * kG + gi]);
          y[e] = rbf(y[e] + fo[e * kG + gi]);
        }
      }
      if (p.res_kind == 1) {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          y[e] = rbf(y[e] + __bfloat162float(rb[e]));
      } else if (p.res_kind == 2) {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          y[e] = rbf(y[e] + rbf(static_cast<float>(rq[e]) * rscale));
      }
      if (p.relu) {
#pragma unroll
        for (int e = 0; e < 16; ++e) y[e] = fmaxf(y[e], 0.0f);
      }
      if (p.out_q) {
        *reinterpret_cast<uint4*>(static_cast<int8_t*>(p.out) + off[u]) =
            codes16(y, oscale, orcp);
      } else {
        uint4 sv[2];
        __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(sv);
#pragma unroll
        for (int e = 0; e < 16; ++e) sb[e] = __float2bfloat16_rn(y[e]);
        uint4* d = reinterpret_cast<uint4*>(
            static_cast<__nv_bfloat16*>(p.out) + off[u]);
        d[0] = sv[0];
        d[1] = sv[1];
      }
    }
  }
  named_sync(1 + cw);
}

template <int BN, int CK>
__global__ void __launch_bounds__(kThreads, 1)
int8_conv_kernel(const __grid_constant__ Params p) {
  using S = Smem<BN, CK>;
  constexpr int kWS = S::kWS;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* wbuf = smem;
  unsigned char* halo = smem + S::halo(p);
  short2* pix = reinterpret_cast<short2*>(smem + S::pix(p));
  int* tapoff = reinterpret_cast<int*>(smem + S::taps(p));
  const uint32_t bar0 = smem_u32(smem + S::bars(p));
  // mbarriers: weight full and empty (kWS each), halo full and empty
  // (hstages each)
  const uint32_t wfull = bar0, wempty = bar0 + 8 * kWS;
  const uint32_t hfull = bar0 + 16 * kWS, hempty = hfull + 8 * kHStagesMax;

  const int tid = threadIdx.x, warp = tid / 32;
  if (tid == 0) {
    for (int s = 0; s < kWS; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, 2);
    }
    for (int s = 0; s < p.hstages; ++s) {
      mbar_init(hfull + 8 * s, kHaloThreads);
      mbar_init(hempty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // halo pixel i = ((py * hhp + hy) * px + qx) * hwp + hx sits at input
  // offset (hy * sh + py, hx * sw + qx) from the tile's first input pixel
  for (int i = tid; i < p.npx; i += kThreads) {
    const int hx = i % p.hwp;
    int r = i / p.hwp;
    const int qx = r % p.px;
    r /= p.px;
    const int hy = r % p.hhp, py = r / p.hhp;
    pix[i] = make_short2(static_cast<short>(hy * p.sh + py),
                         static_cast<short>(hx * p.sw + qx));
  }
  // byte offset of tap (ky, kx)'s A operand for warpgroup cw in a stage:
  // its 8 output rows start at halo row cw * 8 + ky / sh of phase ky % sh
  for (int i = tid; i < 2 * p.taps; i += kThreads) {
    const int cw = i / p.taps, tap = i % p.taps;
    const int ky = tap / p.kw, kx = tap % p.kw;
    const int row = (ky % p.sh) * p.hhp + cw * 8 + ky / p.sh;
    const int col = (kx % p.sw) * p.hwp + kx / p.sw;
    tapoff[i] = (row * p.px * p.hwp + col) * 16;
  }
  __syncthreads();
  const float ascale = p.ascale[0];

  if (warp < 3 && p.raw_stride) {
    // halo producer, bf16 input: chunk k + 1's values are copied into one
    // staging buffer while chunk k's are quantized from the other
    const float rcp = 1.0f / ascale;
    const uint32_t raw0 = smem_u32(smem + S::raw(p));
    const int chunks =
        (p.num_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * p.nchunks;
    auto issue = [&](int k) {
      const Tile tl =
          tile_of(p, blockIdx.x + (k / p.nchunks) * gridDim.x, BN);
      issue_halo_raw<CK>(p, tl, (k % p.nchunks) * CK, pix,
                         raw0 + (k & 1) * p.raw_stride, tid);
      asm volatile("cp.async.commit_group;" ::: "memory");
    };
    int hs = 0, hph = 0;
    issue(0);
    for (int k = 0; k < chunks; ++k) {
      if (k + 1 < chunks) {
        issue(k + 1);
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
      }
      mbar_wait(hempty + 8 * hs, hph ^ 1);
      quantize_halo<CK>(p, smem + S::raw(p) + (k & 1) * p.raw_stride,
                        halo + size_t(hs) * p.halo_stride, ascale, rcp, tid);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(hfull + 8 * hs);
      if (++hs == p.hstages) hs = 0, hph ^= 1;
    }
  } else if (warp < 3) {
    // halo producer: a bf16 input without a staging buffer is quantized
    // through registers; int8 codes are copied asynchronously, one
    // chunk's copies in flight while the previous chunk's land
    const float rcp = 1.0f / ascale;
    int hs = 0, hph = 0, landing = -1;
    for (int t = blockIdx.x; t < p.num_tiles; t += gridDim.x) {
      const Tile tl = tile_of(p, t, BN);
      for (int c = 0; c < p.nchunks; ++c) {
        mbar_wait(hempty + 8 * hs, hph ^ 1);
        if (p.q_in) {
          stage_halo<CK>(p, tl, c * CK, pix,
                         halo + size_t(hs) * p.halo_stride, ascale, rcp, tid);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          mbar_arrive(hfull + 8 * hs);
        } else {
          issue_halo_codes<CK>(p, tl, c * CK, pix,
                               smem_u32(halo) + hs * p.halo_stride, tid);
          asm volatile("cp.async.commit_group;" ::: "memory");
          if (landing >= 0) {
            asm volatile("cp.async.wait_group 1;" ::: "memory");
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            mbar_arrive(hfull + 8 * landing);
          }
          landing = hs;
        }
        if (++hs == p.hstages) hs = 0, hph ^= 1;
      }
    }
    if (landing >= 0) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(hfull + 8 * landing);
    }
  } else if (warp == 3) {
    // weight producer: tps consecutive (chunk, tap) slices a stage
    if (tid % 32 == 0) {
      const uint32_t bytes = static_cast<uint32_t>(p.tps * BN * CK);
      const int stages = p.nchunks * (p.taps / p.tps);
      int ws = 0, wph = 0;
      for (int t = blockIdx.x; t < p.num_tiles; t += gridDim.x) {
        const int nt = t % p.n_tiles;
        const int8_t* src = p.w + static_cast<size_t>(nt) * stages * bytes;
        for (int k = 0; k < stages; ++k, src += bytes) {
          mbar_wait(wempty + 8 * ws, wph ^ 1);
          mbar_expect_tx(wfull + 8 * ws, bytes);
          bulk_load(smem_u32(wbuf + ws * S::kW), src, bytes, wfull + 8 * ws);
          if (++ws == kWS) ws = 0, wph ^= 1;
        }
      }
    }
  } else {
    // two MMA warpgroups, output rows 0-7 and 8-15 of the tile
    const int cw = warp / 4 - 1, ct = tid - 128 * (cw + 1);
    unsigned char* stage = smem + S::stage(p) + cw * S::kStage;
    float* par = reinterpret_cast<float*>(smem + S::par(p) + cw * S::kPar);
    const int* toff = tapoff + cw * p.taps;
    const uint32_t halo0 = smem_u32(halo), w0 = smem_u32(wbuf);
    const uint64_t a_str = desc_strides(p.npx * 16, p.px * p.hwp * 16);
    // B: rows of CK bytes, their 16-byte chunks swizzled (pack_weights)
    const uint64_t b_str = desc_strides(16, 8 * CK, CK == 64 ? 2 : 3);
    const uint32_t a_k32 = 32 * p.npx;      // bytes between 32-channel steps
    const float rscale = p.res_kind == 2 ? p.rscale[0] : 0.0f;
    const float oscale = p.out_q ? p.oscale[0] : 1.0f;
    int acc[BN / 2];
    int ws = 0, wph = 0, hs = 0, hph = 0, n0 = -1;
    for (int t = blockIdx.x; t < p.num_tiles; t += gridDim.x) {
      const Tile tl = tile_of(p, t, BN);
      // this tile's epilogue factors, if they differ from the last tile's
      // (the last epilogue has read them), loaded while the MMAs run
      if (tl.n0 != n0) {
        load_factors<BN>(p, tl.n0, par, ascale, ct);
        n0 = tl.n0;
      }
      // (the first MMA of a tile overwrites acc; zeroing it here only
      // tells the compiler that the last tile's sums are dead)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int prev_ws = -1;
      for (int c = 0; c < p.nchunks; ++c) {
        mbar_wait(hfull + 8 * hs, hph);
        const uint32_t hbase = halo0 + hs * p.halo_stride;
        for (int tap0 = 0; tap0 < p.taps; tap0 += p.tps) {
          mbar_wait(wfull + 8 * ws, wph);
          fence_acc(acc);
          wgmma_fence();
          for (int i = 0; i < p.tps; ++i) {
            const uint32_t a0 = hbase + toff[tap0 + i];
            const uint32_t b0 = w0 + ws * static_cast<uint32_t>(S::kW) +
                                i * (BN * CK);
#pragma unroll
            for (int j = 0; j < CK / 32; ++j)
              wgmma(acc, desc_at(a_str, a0 + j * a_k32),
                    desc_at(b_str, b0 + j * 32),
                    j > 0 || c > 0 || tap0 + i > 0);
          }
          wgmma_commit();
          fence_acc(acc);
          // one MMA group in flight: the previous stage has been read
          wgmma_wait<1>();
          fence_acc(acc);
          if (ct == 0 && prev_ws >= 0) mbar_arrive(wempty + 8 * prev_ws);
          prev_ws = ws;
          if (++ws == kWS) ws = 0, wph ^= 1;
        }
        // the chunk's halo is free once its MMAs are done (releasing it
        // later would make the producer's next chunk wait on this
        // warpgroup's next one)
        wgmma_wait<0>();
        fence_acc(acc);
        if (ct == 0) {
          mbar_arrive(wempty + 8 * prev_ws);
          mbar_arrive(hempty + 8 * hs);
        }
        prev_ws = -1;
        if (++hs == p.hstages) hs = 0, hph ^= 1;
      }
      epilogue<BN, CK>(p, tl, cw, ct, acc, stage, par, rscale, oscale);
    }
  }
}

template <int BN, int CK>
int launch(Params& p, cudaStream_t s) {
  using S = Smem<BN, CK>;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, n = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(int8_conv_kernel<BN, CK>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 232448);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms = n;
  }
  p.n_tiles = p.Co / BN;
  p.num_tiles = p.B * p.tiles_img * p.n_tiles;
  // a bf16 staging pair where it fits beside a 2-stage halo ring, then as
  // deep a halo ring as shared memory holds
  p.hstages = 2;
  p.raw_stride = p.q_in ? (p.npx * (2 * CK + 16) + 127) / 128 * 128 : 0;
  if (S::total(p) > 232448) p.raw_stride = 0;
  for (p.hstages = kHStagesMax; p.hstages > 2 && S::total(p) > 232448;)
    --p.hstages;
  if (S::total(p) > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = p.num_tiles < sms ? p.num_tiles : sms;
  int8_conv_kernel<BN, CK><<<grid, kThreads, S::total(p), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch; cudaErrorInvalidValue for shapes
// the kernel does not take. w: pack_weights' (Co/bn, Ci/ck, kh, kw, ck/16,
// bn, 16) int8 tensor; res_kind 0 none, 1 bf16 NHWC, 2 int8 NHWC codes
// (times rscale); out_q 1 writes int8 codes at oscale, 0 bf16.
extern "C" int r3det_int8_conv(
    const void* x, int q_in, const void* ascale, const void* w, int bn,
    int ck, const void* kscale, const void* bias, const void* inv,
    const void* bnb, const void* res, int res_kind, const void* rscale,
    int relu, void* out, int out_q, const void* oscale, int B, int H, int W,
    int Ci, int Ho, int Wo, int Co, int kh, int kw, int sh, int sw, int ph,
    int pw, void* stream) {
  if (B * Ho * Wo <= 0) return 0;
  if ((bn != 64 && bn != 128 && bn != 256) || Co % bn ||
      (ck != 32 && ck != 64) || Ci % ck || kh < 1 || kw < 1 || sh < 1 ||
      sw < 1 || kh * kw > kMaxTaps || res_kind < 0 || res_kind > 2 ||
      (inv == nullptr) != (bnb == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.ascale = static_cast<const float*>(ascale);
  p.w = static_cast<const int8_t*>(w);
  p.kscale = static_cast<const float*>(kscale);
  p.bias = static_cast<const float*>(bias);
  p.inv = static_cast<const __nv_bfloat16*>(inv);
  p.bnb = static_cast<const __nv_bfloat16*>(bnb);
  p.res = res;
  p.rscale = static_cast<const float*>(rscale);
  p.out = out;
  p.oscale = static_cast<const float*>(oscale);
  p.q_in = q_in;
  p.res_kind = res_kind;
  p.relu = relu;
  p.out_q = out_q;
  p.B = B; p.H = H; p.W = W; p.Ci = Ci; p.Ho = Ho; p.Wo = Wo; p.Co = Co;
  p.kh = kh; p.kw = kw; p.sh = sh; p.sw = sw; p.ph = ph; p.pw = pw;
  p.nchunks = Ci / ck;
  p.taps = kh * kw;
  // as many taps a weight stage as divide the taps and fit its bytes
  const int stage_max = bn == 128 ? 24 * 1024 : bn == 64 ? 12 * 1024
                                                          : 16 * 1024;
  p.tps = 1;
  for (int d = p.taps; d > 1; --d)
    if (p.taps % d == 0 && d * bn * ck <= stage_max) {
      p.tps = d;
      break;
    }
  p.py = sh < kh ? sh : kh;
  p.px = sw < kw ? sw : kw;
  p.hhp = kTH + (kh - 1) / sh;
  p.hwp = kTW + (kw - 1) / sw;
  p.npx = p.py * p.hhp * p.px * p.hwp;
  p.halo_stride = (p.npx * ck + 127) / 128 * 128;
  if (p.npx * ck > kHaloMax) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles_x = (Wo + kTW - 1) / kTW;
  p.tiles_img = ((Ho + kTH - 1) / kTH) * p.tiles_x;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ck == 32) {
    if (bn == 64) return launch<64, 32>(p, s);
    if (bn == 128) return launch<128, 32>(p, s);
    return launch<256, 32>(p, s);
  }
  if (bn == 64) return launch<64, 64>(p, s);
  if (bn == 128) return launch<128, 64>(p, s);
  return launch<256, 64>(p, s);
}
