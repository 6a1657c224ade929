// Fused stride-1 identity ResNet bottleneck (K5), bf16 and int8:
//   out = relu(conv3(a2) + b3 + x),  a2 = relu(conv2(a1) + b2),
//   a1 = relu(conv1(x) + b1), zero outside the image (conv2's padding),
// with FrozenBN folded into the weights (ops/bottleneck_fuse.py::
// pack_bottleneck, once per weight version).
//   x, out (B, H, W, 4F) bf16 NHWC; F in {64, 128, 256}; H % 8 == 0, any W.
// bf16: wgmma m64nNk16 f32.bf16.bf16, f32 sums; a1 and a2 are rounded to
// bf16 after bias and ReLU, as the plain version does.
// int8 (q8): each conv input is quantized with its calibrated static scale
// by the reciprocal multiply, clip(rint(v * inv_n), +-127) (inv = (1/a1,
// 1/a2, 1/a3) from device memory); wgmma m64nNk32 s32.s8.s8 sums exactly,
// and s_n = a_n * ks_n dequantizes before the bias, so the kernel is
// bit-equal to its plain version. The epilogues keep the plain version's
// operation order (the build's --fmad=false rounds a*b + c twice).
//
// Replaces the TPU kernels r3det_tpu/ops/bottleneck_fuse.py::
// fused_bottleneck (_btl_kernel) and fused_bottleneck_q8 (_btl_kernel_q8),
// which kept an 8-row full-width band of x resident in VMEM. An H100 block
// has 227 KB of shared memory, and at C4 the weights alone are 2.2 MB
// (bf16), so here the weights stream and the activations stay.
//
// Design. A tile is 16 x 8 output pixels of one image; one block per SM
// walks over the tiles, image-major (persistent). 12 warps:
// - warps 0-2 stage x's 18 x 10 halo of the tile, 64 bytes of channels a
//   pixel at a time (a chunk), into a ring of halo stages. One thread
//   issues a tensor copy (TMA) a chunk, which fills zeros outside the
//   image: bf16 straight into the stage in the 64-byte swizzle conv1's
//   MMAs read; q8 as bf16 into a staging pair two chunks ahead, from
//   which the 96 threads quantize it into the stage.
// - warp 3 streams the weights by bulk copy through an mbarrier ring of
//   16 KB stages, in the order the MMAs use them, pass by pass: conv1's K
//   chunks, conv2's nine taps, conv3's K chunks. pack_bottleneck lays them
//   out in that order, rows of 64 bytes of K in Hopper's 64-byte swizzle,
//   so a stage is one copy and the ring runs ahead across tiles.
// - warps 4-11 are two consumer warpgroups. conv1 runs on the 180 halo
//   pixels (three m64 blocks; each warpgroup takes half of a pass's
//   columns; x is streamed once a pass) and its epilogue writes a1 into
//   shared memory as [c16][halo row][halo column][16 B], zero outside the
//   image. conv2's 3 x 3 taps are then strided no-swizzle descriptors into
//   that one resident a1 (a core matrix is 8 output columns of one row:
//   the leading byte offset steps 16 channels, the stride byte offset one
//   halo row), so no tap is gathered; each warpgroup owns 8 output rows.
//   conv2's epilogue writes a2 as [c16][pixel][16 B] for conv3, whose
//   epilogue adds b3 and the bf16 residual from x (loaded before the
//   pass's MMAs) and stores 16 bytes a thread, gathered by quad shuffles.
// Passes are at most 128 columns (bf16 conv1: 64), so no accumulator holds
// more than 64 registers a thread (96 in q8's conv1): with more, ptxas
// spills and serializes the wgmmas. Each MMA group (a halo chunk in
// conv1, a weight stage in conv2 and conv3) keeps one group in flight and
// releases its stages when it completes; there is no block-wide barrier
// per K slice.
//
// What bounds it (NVIDIA H100 SXM): at R50 C2 (8, 256, 256, 256) F=64 the
// function moves 0.54 GB of x and out for 36.5 G multiply-adds: bytes bound
// it (0.160 ms); at C4 (8, 64, 64, 1024) F=256 the same multiply-adds on a
// quarter of the bytes: the bf16 tensor rate bounds it (0.074 ms). The
// kernel reads x about 1.4 times a pass (the halo) plus once for the
// residual, recomputes conv1 on the halo (1.41x conv1's work), and every
// tile streams all the weights from L2: 139 KB a tile at F=64, 2.2 MB at
// F=256 in bf16 (half in q8): 0.57 GB a stage in bf16, about the stage's
// HBM stream at C2 and 4x it at C4. What holds it above its bound is that
// a warpgroup's epilogues run beside no MMA (PERF.md, with the times of
// perf/k5_bottleneck.py's cut copies).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// perf/k5_bottleneck.py flips these to time the kernel with one phase cut
// out (the results are then wrong); they are false in every real build
constexpr bool kCutMma = false;        // no MMA is issued
constexpr bool kCutWeights = false;    // the weight stages are not copied
constexpr bool kCutRecompute = false;  // conv1 on 128 pixels, not the halo
constexpr bool kSyncCopies = false;    // rings one stage deep

constexpr int kTH = 16, kTW = 8;           // output tile
constexpr int kHC = kTW + 2;               // halo columns
constexpr int kNPX = (kTH + 2) * kHC;      // 180 halo pixels
constexpr int kM1 = 192;                   // conv1 rows: 3 x m64
constexpr int kMB1 = kCutRecompute ? 2 : 3;
constexpr int kPix = kTH * kTW;            // 128 output pixels
constexpr int kThreads = 384;              // 3 halo warps, 1 weight warp
constexpr int kHaloThreads = 96;           // and 2 MMA warpgroups
constexpr int kChunk = 64;                 // bytes of K a weight row holds
constexpr int kN3 = 128;                   // conv3 columns a pass
constexpr int kOutWG = 64 * kN3 * 2;       // a warpgroup's output, bytes
constexpr int kStage = 16 * 1024;          // bytes of a weight stage
constexpr int kHalo = kM1 * kChunk;        // one x chunk: 64 B a pixel
constexpr int kHaloTx = kNPX * kChunk;     // bytes a bf16 chunk's copy writes
constexpr int kSmemMax = 232448;

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

template <int F, bool Q8>
struct Cfg {
  static constexpr int kE = Q8 ? 1 : 2;            // bytes per element
  static constexpr int kC4 = 4 * F;
  // conv1 columns a pass (x's halo is streamed once a pass): bf16 64, so
  // that a warpgroup's three m64 blocks hold 48 accumulator registers (at
  // 96 ptxas spills and serializes the MMAs); q8 up to 128: its 96 serialize
  // too, but quantizing the halo twice as often costs more
  // (perf/k5_bottleneck.py)
  static constexpr int kN1 = Q8 && F >= 128 ? 128 : 64;
  static constexpr int kNW1 = kN1 / 2;             // ... a warpgroup's
  static constexpr int kP1 = F / kN1;              // conv1 passes
  static constexpr int kK1 = kC4 * kE / kChunk;    // conv1 K chunks
  static constexpr int kK2 = F * kE / kChunk;      // conv2 (a tap), conv3
  static constexpr int kN2 = F < 128 ? F : 128;    // conv2 columns a pass
  static constexpr int kP2 = F / kN2;              // conv2 passes
  static constexpr int kP3 = kC4 / kN3;            // conv3 passes
  // weight units (one K chunk of one pass or tap), per phase: bytes,
  // units a stage, units a tile
  static constexpr int kU1 = kN1 * kChunk, kU2 = kN2 * kChunk;
  static constexpr int kU3 = kN3 * kChunk;
  static constexpr int kG1 = kStage / kU1, kG2 = kStage / kU2;
  static constexpr int kG3 = cmin(kStage / kU3, kK2);  // within a pass
  static constexpr int kN1u = kP1 * kK1, kN2u = kP2 * 9 * kK2;
  static constexpr int kN3u = kP3 * kK2;
  static constexpr int kGroups = F * kE / 16;      // 16-byte channel groups
  static constexpr int kA1 = kGroups * kNPX * 16;
  static constexpr int kA2 = kGroups * kPix * 16;
  // q8: one chunk's bf16 values, [pixel][128 B], 128-byte swizzle
  static constexpr int kRawTx = kNPX * 2 * kChunk;
  static constexpr int kRaw = Q8 ? (kRawTx + 1023) / 1024 * 1024 : 0;
  // conv3's residual and output tile, [half][64 px][128 B] a warpgroup
  // (128-byte swizzle): a buffer of its own, so that a tile's first
  // residual loads while its convs run, or at F=256, where that does not
  // fit, in a1 (dead once conv2 is done)
  static constexpr int kOut = 2 * kOutWG;
  static constexpr int kOutOwn = F == 256 ? 0 : kOut;
  static_assert(kOutOwn || kA1 >= kOut, "conv3's tile in a1");
  static constexpr int kBars = 256;
  static constexpr int kAvail =
      kSmemMax - (kA1 + kA2 + 2 * kRaw + kOutOwn + kBars);
  // as deep a halo ring as leaves two weight stages (up to 4), then as
  // deep a weight ring as fits (up to 6), then the halo ring again
  static constexpr int kHS0 = cmin(4, (kAvail - 2 * kStage) / kHalo);
  static constexpr int kWS =
      kSyncCopies ? 1 : cmin(6, (kAvail - kHS0 * kHalo) / kStage);
  static constexpr int kHS =
      kSyncCopies ? 1 : cmin(4, (kAvail - kWS * kStage) / kHalo);
  // swizzled buffers first: they need 512- (64-byte swizzle) and 1024-byte
  // (128-byte swizzle) alignment
  static constexpr int kOffHalo = kWS * kStage;
  static constexpr int kOffRaw = kOffHalo + kHS * kHalo;
  static constexpr int kOffOut = kOffRaw + 2 * kRaw;
  static constexpr int kOffA1 = kOffOut + kOutOwn;
  static constexpr int kOffA2 = kOffA1 + kA1;
  static constexpr int kOffBars = kOffA2 + kA2;
  static constexpr int kTotal = kOffBars + kBars;
  static_assert(kWS >= 1 && kHS >= 1 && kTotal <= kSmemMax, "shared memory");
  static_assert(kG1 >= 1 && kG2 >= 1 && kK2 >= 1, "weight stages");
  using Acc = std::conditional_t<Q8, int, float>;
};

struct Params {
  // x as (C, W, H, B) for the halo's tensor copies: 64-byte boxes of
  // channels (bf16, 64-byte swizzle), or 128-byte ones (q8, 128-byte
  // swizzle), 10 columns, 18 rows; zeros outside the image
  CUtensorMap xmap;
  // x and out as (C, W, H, B) for conv3's residual loads and output
  // stores: 64 channels (128 bytes, 128-byte swizzle), 8 columns, 8 rows
  CUtensorMap rmap, omap;
  const __nv_bfloat16* x;
  const float* inv;             // q8: (1/a1, 1/a2, 1/a3)
  const unsigned char* w;       // pack_bottleneck's weight stream
  const float *s1, *b1, *s2, *b2, *s3, *b3;   // s*: q8 only
  __nv_bfloat16* out;
  int H, W, tiles_x, tiles_img, num_tiles;
};

struct Tile {
  int b, oy0, ox0;
};

__device__ __forceinline__ Tile tile_of(const Params& p, int t) {
  Tile r;
  r.b = t / p.tiles_img;
  const int rem = t - r.b * p.tiles_img;
  const int ty = rem / p.tiles_x;
  r.oy0 = ty * kTH;
  r.ox0 = (rem - ty * p.tiles_x) * kTW;
  return r;
}

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

// a (c, x, y, b) box of the tensor map into shared memory, completing on
// an mbarrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c, int x, int y, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(b),
      "r"(bar)
      : "memory");
}

// shared-memory writes of this thread -> visible to wgmma and bulk copies
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// the fields of a K-major operand descriptor but its start address: the
// byte offsets of the K-adjacent core matrix (lbo, no swizzle only) and of
// the next 8 rows (sbo), and the layout (0 none, 2 64-byte swizzle)
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
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define R8(d, i)                                                        \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),         \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define F8(d, i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// wgmma.mma_async m64nN, N = 2 x the accumulator's length: bf16 (k16, f32
// sums) on float accumulators, int8 (k32, s32 sums) on int ones; A and B
// K-major from shared memory; scale_d 0 overwrites the accumulator
__device__ __forceinline__ void wgmma(float (&d)[16], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : F8(d, 0), F8(d, 8)
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40),
        F8(d, 48), F8(d, 56)
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(int (&d)[16], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, %16, %17, p;\n}\n"
      : R8(d, 0), R8(d, 8)
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(int (&d)[32], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : R8(d, 0), R8(d, 8), R8(d, 16), R8(d, 24)
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p;\n}\n"
      : R8(d, 0), R8(d, 8), R8(d, 16), R8(d, 24), R8(d, 32), R8(d, 40),
        R8(d, 48), R8(d, 56)
      : "l"(a), "l"(b), "r"(scale_d));
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

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// a1 / a2 values v0, v1 (post bias + ReLU, f32) of channels n, n + 1 at
// pixel m of a [c16][npx pixels][16 B] buffer: bf16, or (q8) int8 codes of
// the next conv's input
template <bool Q8>
__device__ __forceinline__ void store_act(unsigned char* buf, int npx, int m,
                                          int n, float v0, float v1,
                                          float inv) {
  constexpr int kE = Q8 ? 1 : 2;
  unsigned char* d =
      buf + ((n * kE) / 16 * npx + m) * 16 + (n * kE) % 16;
  if (Q8) {
    const uint32_t c = (static_cast<uint32_t>(q8(v0, inv)) & 0xffu) |
                       (static_cast<uint32_t>(q8(v1, inv)) & 0xffu) << 8;
    *reinterpret_cast<uint16_t*>(d) = static_cast<uint16_t>(c);
  } else {
    __nv_bfloat162 h;
    h.x = __float2bfloat16_rn(v0);
    h.y = __float2bfloat16_rn(v1);
    *reinterpret_cast<__nv_bfloat162*>(d) = h;
  }
}

struct Ring {
  int s = 0, ph = 0;
  __device__ __forceinline__ void next(int n) {
    if (++s == n) s = 0, ph ^= 1;
  }
};

// warps 0-2: x's halo, chunk by chunk, in the order conv1 reads it (each
// pass of conv1 reads every chunk once): one tensor copy a chunk, issued by
// one thread, zeros outside the image. bf16: straight into the halo stage,
// in the 64-byte swizzle the MMAs read. q8: into one of two staging
// buffers, two chunks ahead, then quantized by the 96 threads into the
// halo stage.
template <int F, bool Q8>
__device__ __forceinline__ void stage_x(const Params& p, unsigned char* smem,
                                        uint32_t hfull, uint32_t hempty,
                                        uint32_t rfull, int tid) {
  using C = Cfg<F, Q8>;
  const uint32_t halo0 = smem_u32(smem + C::kOffHalo);
  const int per_tile = C::kP1 * C::kK1;
  const int chunks =
      (p.num_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * per_tile;
  // chunk k's box: its tile's halo, its channels
  auto load = [&](int k, uint32_t dst, uint32_t bar, uint32_t bytes) {
    const Tile tl = tile_of(p, blockIdx.x + (k / per_tile) * gridDim.x);
    mbar_expect_tx(bar, bytes);
    tma_load(dst, &p.xmap, (k % C::kK1) * (kChunk / C::kE), tl.ox0 - 1,
             tl.oy0 - 1, tl.b, bar);
  };
  Ring r;
  if constexpr (!Q8) {
    if (tid != 0) return;
    for (int k = 0; k < chunks; ++k) {
      mbar_wait(hempty + 8 * r.s, r.ph ^ 1);
      load(k, halo0 + r.s * kHalo, hfull + 8 * r.s, kHaloTx);
      r.next(C::kHS);
    }
  } else {
    const float inv1 = p.inv[0];
    const unsigned char* raw = smem + C::kOffRaw;
    const uint32_t raw0 = smem_u32(raw);
    if (tid == 0)
      for (int k = 0; k < 2 && k < chunks; ++k)
        load(k, raw0 + k * C::kRaw, rfull + 8 * k, C::kRawTx);
    for (int k = 0; k < chunks; ++k) {
      mbar_wait(rfull + 8 * (k & 1), (k >> 1) & 1);
      mbar_wait(hempty + 8 * r.s, r.ph ^ 1);
      unsigned char* dst = smem + C::kOffHalo + r.s * kHalo;
      const unsigned char* src = raw + (k & 1) * C::kRaw;
      for (int px = tid; px < kNPX; px += kHaloThreads) {
        // 16-byte piece c of a staging row at c ^ (px % 8) (128-byte
        // swizzle); code group k of a halo row at k ^ ((px / 2) % 4)
        const uint4* s = reinterpret_cast<const uint4*>(src + px * 128);
#pragma unroll
        for (int grp = 0; grp < 4; ++grp)
          *reinterpret_cast<uint4*>(dst + px * kChunk +
                                    ((grp ^ (px >> 1)) & 3) * 16) =
              quantize16(s[(2 * grp) ^ (px & 7)], s[(2 * grp + 1) ^ (px & 7)],
                         inv1);
      }
      fence_async();
      mbar_arrive(hfull + 8 * r.s);
      r.next(C::kHS);
      // every thread is done with this staging buffer: refill it
      bar_sync(8, kHaloThreads);
      if (tid == 0 && k + 2 < chunks) {
        fence_async();
        load(k + 2, raw0 + (k & 1) * C::kRaw, rfull + 8 * (k & 1), C::kRawTx);
      }
    }
  }
}

// warp 3, one thread: the weight stream, n units of the given bytes a
// phase, up to g units a stage, for every tile of the block
template <int F, bool Q8>
__device__ __forceinline__ void stream_weights(const Params& p, uint32_t wbuf,
                                               uint32_t wfull,
                                               uint32_t wempty) {
  using C = Cfg<F, Q8>;
  const int n[3] = {C::kN1u, C::kN2u, C::kN3u};
  const int g[3] = {C::kG1, C::kG2, C::kG3};
  const int ub[3] = {C::kU1, C::kU2, C::kU3};
  Ring r;
  for (int t = blockIdx.x; t < p.num_tiles; t += gridDim.x) {
    const unsigned char* src = p.w;
    for (int ph = 0; ph < 3; ++ph) {
      for (int u = 0; u < n[ph]; u += g[ph]) {
        const uint32_t bytes = cmin(g[ph], n[ph] - u) * ub[ph];
        mbar_wait(wempty + 8 * r.s, r.ph ^ 1);
        if (kCutWeights) {
          mbar_arrive(wfull + 8 * r.s);
        } else {
          mbar_expect_tx(wfull + 8 * r.s, bytes);
          bulk_load(wbuf + r.s * kStage, src, bytes, wfull + 8 * r.s);
        }
        src += bytes;
        r.next(C::kWS);
      }
    }
  }
}

// after a commit: wait until one MMA group is left in flight (none for the
// synchronous cut)
__device__ __forceinline__ void wait_group_in_flight() {
  if constexpr (kSyncCopies)
    wgmma_wait<0>();
  else
    wgmma_wait<1>();
}

// a (c, x, y, b) box of shared memory into the tensor map's tensor (the
// parts outside it are not written); one bulk group a call
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c, int x, int y, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, "
      "%3, %4}], [%5];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c), "r"(x), "r"(y), "r"(b), "r"(src)
      : "memory");
}

// a consumer warpgroup's place in the weight and halo rings, and the stages
// of the MMA group in flight, released when it completes
template <int WS>
struct Consumer {
  Ring w, h;
  int pend_w = -1, pend_h = -1;
  uint32_t wfull, wempty, hempty;
  bool leader;
  // before unit u of a phase of n units, g a stage: its stage has landed
  __device__ __forceinline__ void wait_w(int u, int g) {
    if (u % g == 0) mbar_wait(wfull + 8 * w.s, w.ph);
  }
  // after unit u's group is committed and the one before it completed:
  // free that one's stages, hold this one's (halo stage hs, or -1)
  __device__ __forceinline__ void done(int u, int n, int g, int hs) {
    release();
    const bool last = u % g == g - 1 || u == n - 1;
    pend_w = last ? w.s : -1;
    pend_h = hs;
    if (last) w.next(WS);
    if (kSyncCopies) release();      // this group has completed too
  }
  __device__ __forceinline__ void release() {
    if (leader) {
      if (pend_w >= 0) mbar_arrive(wempty + 8 * pend_w);
      if (pend_h >= 0) mbar_arrive(hempty + 8 * pend_h);
    }
    pend_w = pend_h = -1;
  }
};

template <int F, bool Q8>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem,
                                        uint32_t wfull, uint32_t wempty,
                                        uint32_t hfull, uint32_t hempty,
                                        uint32_t rbar, int tid) {
  using C = Cfg<F, Q8>;
  using Acc = typename C::Acc;
  const int cw = tid / 128 - 1, ct = tid % 128;
  const int w4 = ct / 32, g = (ct % 32) / 4, q = ct % 4;
  unsigned char* a1 = smem + C::kOffA1;
  unsigned char* a2 = smem + C::kOffA2;
  const uint32_t w0 = smem_u32(smem), a1s = smem_u32(a1), a2s = smem_u32(a2);
  const uint32_t halo0 = smem_u32(smem + C::kOffHalo);
  // A: x chunks [192 px][64 B], 64-byte swizzle; a1 [c16][18][10][16 B]
  // read as 8 output rows x 8 columns; a2 [c16][128 px][16 B]. B: 64-byte
  // rows of K, 64-byte swizzle.
  const uint64_t x_str = desc_strides(16, 8 * kChunk, 2);
  const uint64_t a1_str = desc_strides(kNPX * 16, kHC * 16);
  const uint64_t a2_str = desc_strides(kPix * 16, 128);
  const uint64_t b_str = desc_strides(16, 8 * kChunk, 2);
  const float inv2 = Q8 ? p.inv[1] : 1.0f, inv3 = Q8 ? p.inv[2] : 1.0f;
  // this warpgroup's conv3 tile and its residual barrier
  unsigned char* obuf = smem + C::kOffOut + cw * kOutWG;
  const uint32_t obuf_s = smem_u32(obuf), rb = rbar + 8 * cw;
  int rph = 0;
  Consumer<C::kWS> st;
  st.wfull = wfull;
  st.wempty = wempty;
  st.hempty = hempty;
  st.leader = ct == 0;

  for (int t = blockIdx.x; t < p.num_tiles; t += gridDim.x) {
    const Tile tl = tile_of(p, t);
    // pass p3's residual into this warpgroup's conv3 tile (its leader
    // has seen the last store read it)
    auto load_res = [&](int p3) {
      if (ct == 0) {
        mbar_expect_tx(rb, kOutWG);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          tma_load(obuf_s + half * (kOutWG / 2), &p.rmap,
                   p3 * kN3 + half * 64, tl.ox0, tl.oy0 + cw * 8, tl.b, rb);
      }
    };
    if (C::kOutOwn) load_res(0);

    // ---- conv1 on the halo: (192 x 4F) . (4F x F), kP1 passes ----
    for (int p1 = 0; p1 < C::kP1; ++p1) {
      Acc acc[3][C::kNW1 / 2];
      for (int c = 0; c < C::kK1; ++c) {
        const int u = p1 * C::kK1 + c;
        st.wait_w(u, C::kG1);
        mbar_wait(hfull + 8 * st.h.s, st.h.ph);
        const uint32_t hb = halo0 + st.h.s * kHalo;
        const uint32_t wb = w0 + st.w.s * kStage + (u % C::kG1) * C::kU1 +
                            cw * C::kNW1 * kChunk;
#pragma unroll
        for (int mb = 0; mb < 3; ++mb) fence_acc(acc[mb]);
        wgmma_fence();
        if (!kCutMma) {
#pragma unroll
          for (int mb = 0; mb < kMB1; ++mb)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wgmma(acc[mb], desc_at(x_str, hb + mb * 64 * kChunk + j * 32),
                    desc_at(b_str, wb + j * 32), c > 0 || j > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int mb = 0; mb < 3; ++mb) fence_acc(acc[mb]);
        wait_group_in_flight();
#pragma unroll
        for (int mb = 0; mb < 3; ++mb) fence_acc(acc[mb]);
        st.done(u, C::kN1u, C::kG1, st.h.s);
        st.h.next(C::kHS);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mb = 0; mb < 3; ++mb) fence_acc(acc[mb]);
      st.release();
      // both warpgroups are past the last tile's conv2: a1 is free
      if (p1 == 0) bar_sync(1, 256);
      // bias + ReLU, zero outside the image; bf16 rounding or the codes
      // of conv2's input
#pragma unroll
      for (int mb = 0; mb < 3; ++mb) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mb * 64 + 16 * w4 + g + 8 * h;
          if (m >= kNPX) continue;
          const int gy = tl.oy0 - 1 + m / kHC, gx = tl.ox0 - 1 + m % kHC;
          const bool in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
#pragma unroll
          for (int j = 0; j < C::kNW1 / 8; ++j) {
            const int n = p1 * C::kN1 + cw * C::kNW1 + 8 * j + 2 * q;
            const float2 bb = ldg2(p.b1 + n);
            const float2 ss = Q8 ? ldg2(p.s1 + n) : make_float2(1.0f, 1.0f);
            const float c0 = static_cast<float>(acc[mb][4 * j + 2 * h]);
            const float c1 = static_cast<float>(acc[mb][4 * j + 2 * h + 1]);
            const float y0 = (Q8 ? c0 * ss.x : c0) + bb.x;
            const float y1 = (Q8 ? c1 * ss.y : c1) + bb.y;
            store_act<Q8>(a1, kNPX, m, n, in ? fmaxf(y0, 0.0f) : 0.0f,
                          in ? fmaxf(y1, 0.0f) : 0.0f, inv2);
          }
        }
      }
    }
    fence_async();
    bar_sync(2, 256);

    // ---- conv2, 3 x 3 on this warpgroup's 8 output rows: 9 taps of
    // (64 x F) . (F x kN2) a pass, each a strided view of a1 ----
    for (int p2 = 0; p2 < C::kP2; ++p2) {
      Acc acc[C::kN2 / 2];
      // one MMA group a weight stage (a pass's units fill whole stages)
      const int u_end = (p2 + 1) * 9 * C::kK2;
      for (int u0 = p2 * 9 * C::kK2; u0 < u_end; u0 += C::kG2) {
        const int nu = cmin(C::kG2, u_end - u0);
        st.wait_w(u0, C::kG2);
        fence_acc(acc);
        wgmma_fence();
        for (int k = 0; k < nu; ++k) {
          const int i = u0 + k - p2 * 9 * C::kK2;
          const int tap = i / C::kK2, c = i % C::kK2;
          const uint32_t wb = w0 + st.w.s * kStage + k * C::kU2;
          const uint32_t ab = a1s + ((cw * 8 + tap / 3) * kHC + tap % 3) * 16 +
                              c * 4 * kNPX * 16;
          if (!kCutMma) {
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wgmma(acc, desc_at(a1_str, ab + 2 * j * kNPX * 16),
                    desc_at(b_str, wb + j * 32), i > 0 || j > 0);
          }
        }
        wgmma_commit();
        fence_acc(acc);
        wait_group_in_flight();
        fence_acc(acc);
        st.done(u0 + nu - 1, C::kN2u, C::kG2, -1);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      st.release();
#pragma unroll
      for (int j = 0; j < C::kN2 / 8; ++j) {
        const int n = p2 * C::kN2 + 8 * j + 2 * q;
        const float2 bb = ldg2(p.b2 + n);
        const float2 ss = Q8 ? ldg2(p.s2 + n) : make_float2(1.0f, 1.0f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = cw * 64 + 16 * w4 + g + 8 * h;
          const float c0 = static_cast<float>(acc[4 * j + 2 * h]);
          const float c1 = static_cast<float>(acc[4 * j + 2 * h + 1]);
          store_act<Q8>(a2, kPix, m, n,
                        fmaxf((Q8 ? c0 * ss.x : c0) + bb.x, 0.0f),
                        fmaxf((Q8 ? c1 * ss.y : c1) + bb.y, 0.0f), inv3);
        }
      }
    }
    fence_async();
    // both warpgroups are done with a1 (conv3's tile may lie in it) and
    // with a2's writes
    bar_sync(3, 256);
    if (!C::kOutOwn) load_res(0);

    // ---- conv3: (64 x F) . (F x 4F) in passes of kN3 columns, + b3 +
    // residual, ReLU, bf16 out. The pass's residual comes by tensor copy
    // into the warpgroup's tile, each thread replaces its values there by
    // the outputs, and one tensor copy stores the tile (clipped at the
    // image's edges) ----
    for (int p3 = 0; p3 < C::kP3; ++p3) {
      Acc acc[kN3 / 2];
      for (int c0 = 0; c0 < C::kK2; c0 += C::kG3) {
        const int u0 = p3 * C::kK2 + c0;
        st.wait_w(u0, C::kG3);
        fence_acc(acc);
        wgmma_fence();
        for (int k = 0; k < C::kG3; ++k) {
          const int c = c0 + k;
          const uint32_t wb = w0 + st.w.s * kStage + k * C::kU3;
          const uint32_t ab = a2s + cw * 64 * 16 + c * 4 * kPix * 16;
          if (!kCutMma) {
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wgmma(acc, desc_at(a2_str, ab + 2 * j * kPix * 16),
                    desc_at(b_str, wb + j * 32), c > 0 || j > 0);
          }
        }
        wgmma_commit();
        fence_acc(acc);
        wait_group_in_flight();
        fence_acc(acc);
        st.done(u0 + C::kG3 - 1, C::kN3u, C::kG3, -1);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      st.release();
      mbar_wait(rb, rph);
      rph ^= 1;
#pragma unroll
      for (int j = 0; j < kN3 / 8; ++j) {
        const int n = p3 * kN3 + 8 * j + 2 * q;
        const float2 bb = ldg2(p.b3 + n);
        const float2 ss = Q8 ? ldg2(p.s3 + n) : make_float2(1.0f, 1.0f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // pixel m's 128-byte row of the half, 16-byte piece at
          // piece ^ (m % 8)
          const int m = 16 * w4 + g + 8 * h;
          __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(
              obuf + (j / 8) * (kOutWG / 2) + m * 128 +
              (((j % 8) ^ (m & 7)) * 16) + 4 * q);
          const __nv_bfloat162 r = *d;
          const float c0 = static_cast<float>(acc[4 * j + 2 * h]);
          const float c1 = static_cast<float>(acc[4 * j + 2 * h + 1]);
          const float y0 = (Q8 ? c0 * ss.x : c0) + bb.x;
          const float y1 = (Q8 ? c1 * ss.y : c1) + bb.y;
          __nv_bfloat162 o;
          o.x = __float2bfloat16_rn(fmaxf(y0 + __bfloat162float(r.x), 0.0f));
          o.y = __float2bfloat16_rn(fmaxf(y1 + __bfloat162float(r.y), 0.0f));
          *d = o;
        }
      }
      fence_async();
      bar_sync(4 + cw, 128);
      if (ct == 0) {
#pragma unroll
        for (int half = 0; half < 2; ++half)
          tma_store(&p.omap, obuf_s + half * (kOutWG / 2),
                    p3 * kN3 + half * 64, tl.ox0, tl.oy0 + cw * 8, tl.b);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        // the tile is read before the next residual lands in it (and
        // before the next tile's conv1 epilogue writes a1)
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
      if (p3 + 1 < C::kP3) load_res(p3 + 1);
    }
  }
  if (ct == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int F, bool Q8>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_kernel(const __grid_constant__ Params p) {
  using C = Cfg<F, Q8>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t bar0 = smem_u32(smem + C::kOffBars);
  // mbarriers: weight full and empty, halo full and empty, q8 staging full
  const uint32_t wfull = bar0, wempty = bar0 + 8 * C::kWS;
  const uint32_t hfull = bar0 + 16 * C::kWS, hempty = hfull + 8 * C::kHS;
  const uint32_t rfull = hempty + 8 * C::kHS, rbar = rfull + 16;
  const int tid = threadIdx.x, warp = tid / 32;
  if (tid == 0) {
    for (int s = 0; s < C::kWS; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, 2);
    }
    for (int s = 0; s < C::kHS; ++s) {
      mbar_init(hfull + 8 * s, Q8 ? kHaloThreads : 1);
      mbar_init(hempty + 8 * s, 2);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(rfull + 8 * s, 1);
      mbar_init(rbar + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the producer warpgroup gives registers to the two MMA warpgroups
  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 48;" ::: "memory");
    if (warp < 3)
      stage_x<F, Q8>(p, smem, hfull, hempty, rfull, tid);
    else if (tid == 96)
      stream_weights<F, Q8>(p, smem_u32(smem), wfull, wempty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;" ::: "memory");
    consume<F, Q8>(p, smem, wfull, wempty, hfull, hempty, rbar, tid);
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// t (B, H, W, C4) bf16 as a tensor map of boxes of c_box channels (64 or
// 128 bytes), w_box columns and h_box rows, in the given swizzle
int make_map(CUtensorMap* map, const void* t, int B, int H, int W, int C4,
             int c_box, int w_box, int h_box, CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[4] = {cuuint64_t(C4), cuuint64_t(W), cuuint64_t(H),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(C4) * 2,
                                 cuuint64_t(W) * C4 * 2,
                                 cuuint64_t(H) * W * C4 * 2};
  const cuuint32_t box[4] = {cuuint32_t(c_box), cuuint32_t(w_box),
                             cuuint32_t(h_box), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(t), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int F, bool Q8>
int launch(Params& p, int B, int sms, cudaStream_t stream) {
  constexpr int kSmem = Cfg<F, Q8>::kTotal;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        bottleneck_kernel<F, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  int err = make_map(&p.xmap, p.x, B, p.H, p.W, 4 * F,
                     Q8 ? kChunk : kChunk / 2, kHC, kTH + 2,
                     Q8 ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_64B);
  if (!err)
    err = make_map(&p.rmap, p.x, B, p.H, p.W, 4 * F, 64, kTW, 8,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = make_map(&p.omap, p.out, B, p.H, p.W, 4 * F, 64, kTW, 8,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  p.tiles_x = (p.W + kTW - 1) / kTW;
  p.tiles_img = (p.H + kTH - 1) / kTH * p.tiles_x;
  p.num_tiles = B * p.tiles_img;
  const int grid = p.num_tiles < sms ? p.num_tiles : sms;
  bottleneck_kernel<F, Q8><<<grid, kThreads, kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool Q8>
int dispatch(Params& p, int B, int F, int sms, void* stream) {
  if (B <= 0 || p.H <= 0 || p.W <= 0) return 0;
  if (p.H % 8 || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 64:
      return launch<64, Q8>(p, B, sms, s);
    case 128:
      return launch<128, Q8>(p, B, sms, s);
    case 256:
      return launch<256, Q8>(p, B, sms, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns the cudaError_t of the launch; cudaErrorInvalidValue for shapes
// the kernel does not take. w: pack_bottleneck's weight stream; sms: the
// card's SM count (one block an SM).
extern "C" int r3det_bottleneck(const void* x, const void* w, const void* b1,
                                const void* b2, const void* b3, void* out,
                                int B, int H, int W, int F, int sms,
                                void* stream) {
  Params p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const unsigned char*>(w);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.b3 = static_cast<const float*>(b3);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.H = H;
  p.W = W;
  return dispatch<false>(p, B, F, sms, stream);
}

extern "C" int r3det_bottleneck_q8(const void* x, const void* inv,
                                   const void* w, const void* s1,
                                   const void* b1, const void* s2,
                                   const void* b2, const void* s3,
                                   const void* b3, void* out, int B, int H,
                                   int W, int F, int sms, void* stream) {
  Params p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.inv = static_cast<const float*>(inv);
  p.w = static_cast<const unsigned char*>(w);
  p.s1 = static_cast<const float*>(s1);
  p.b1 = static_cast<const float*>(b1);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = static_cast<const float*>(b2);
  p.s3 = static_cast<const float*>(s3);
  p.b3 = static_cast<const float*>(b3);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.H = H;
  p.W = W;
  return dispatch<true>(p, B, F, sms, stream);
}
