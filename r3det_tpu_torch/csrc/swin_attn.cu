// Swin's window-attention sub-block on the bf16 serving path
// (models/swin.py, ShiftWindowMSA.kernel_forward), as two kernels around
// the qkv and proj products (cuBLAS, outside any kernel):
//
// swin_norm_pad: x (B, H, W, C) bf16 -> LayerNorm (norm1; f32 gain and
//   shift, rounded to bf16 as the eager route's cast rounds them;
//   statistics in f32) -> out (B, Hp, Wp, C) bf16, the map zero-padded at
//   its bottom and right to a multiple of the window, in map order. Padded
//   tokens are zeros, not LN(0): mmdet pads after the norm.
//   C % 8 == 0 and C / 8 <= 96.
// swin_window_attn: qkv (B, Hp, Wp, 3C) bf16, the qkv product of that
//   map (columns q | k | v, each head's 32 channels contiguous), the
//   relative-position bias table (nb, heads) f32  ->  out (B, H, W, C)
//   bf16, the attention of every shifted window written back to its
//   token's original place, before proj. window**2 <= 64, head_dim 32.
//   The cyclic shift, the window partition and its inverse, the crop, the
//   q scale, the bias and the nine-region mask are address arithmetic:
//   the token at local (i, j) of window (wy, wx) is the padded map's
//   ((w*wy + i + s) mod Hp, (w*wx + j + s) mod Wp), which is where its
//   output goes too (rows in the pad are not written: the crop drops
//   them); its mask region is the rolled map's (w*wy + i, w*wx + j)
//   against the cuts Hp - w and Hp - s of each axis, as mmdet slices it.
//
// Numerics (ops/swin_attn.py has both plain forms): S = q.k on the tensor
// cores (mma.sync m16n8k16, bf16 products exact in f32, f32 sums), then
// in f32: fma(S, scale, bias + mask), softmax over the real columns (the
// pad columns are left out, padded tokens are not: they attend and are
// attended to, as in mmdet) with P = exp(S - max) * (1 / sum), P rounded
// to bf16, P.V on the tensor cores in f32, rounded to bf16. The eager bf16
// route rounds q * scale, S, the bias and S + bias to bf16 before the
// softmax; this one does not, so it computes the same function at no lower
// precision (the fma and the reciprocal move S and P by an f32 ulp, far
// below P's bf16 rounding).
//
// No TPU kernel stands behind them: the JAX package has no Swin.
//
// What bounds them (NVIDIA H100 SXM, 3.35 TB/s): the bytes. A stage-1
// block of Swin-T at batch 8 of 1024^2 (256^2 tokens of 96 channels, 259^2
// padded): the norm reads 101 MB and writes 103 MB (0.061 ms), the
// attention reads the 309 MB qkv and writes 101 MB (0.122 ms); its QK^T
// and PV, 2 * 49^2 * 32 multiply-adds a window and head, take 0.010 ms on
// the tensor cores and its softmax 0.006 ms in f32. Design:
// - swin_norm_pad: a group of C / 24 lanes a row (4 at C = 96, 32 at 768),
//   each lane holding three 16-byte vectors of the row in registers, so
//   the row is read once and the two sums (mean, then the squared
//   deviations) are shuffles within the group; a grid-stride loop over
//   the padded map's rows, as many blocks as the SMs hold.
// - swin_window_attn: one block of four warps a (image, window, head),
//   each warp 16 of the 64 (49 real) query rows. q, k and v (64 bytes a
//   token) are gathered with 16-byte cp.async into shared memory rows of
//   80 bytes (ldmatrix without bank conflicts), rows past window**2 zero.
//   The scores stay in registers; the accumulator layout of S is the
//   A-fragment layout of P, so P never leaves the registers. The bias
//   table's column of the head is staged in shared memory, beside each
//   token's place, bias offsets and region, worked out once a block (no
//   division a score). The output goes through the warp's own q rows in
//   shared memory, so each token's 64 bytes leave as four 16-byte stores.
//   Measured (H100 SXM, batch 8 of 1024^2): 0.28 ms at stage 1, 43% of
//   its bytes bound; the norm 0.091 ms, 67%.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kNormThreads = 256;
constexpr int kNormVec = 3;      // 16-byte vectors a lane holds
constexpr int kAttnThreads = 128;
constexpr int kRows = 64;        // tokens a window holds, padded
constexpr int kD = 32;           // head_dim
constexpr int kStride = 40;      // shared row, bf16: 80 bytes
constexpr int kMaxWindow = 8;
constexpr int kMaxTable = (2 * kMaxWindow - 1) * (2 * kMaxWindow - 1);
constexpr float kMask = -100.0f;  // mmdet's shifted-window mask

__device__ __forceinline__ uint4 load16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ float lane_of(const uint4& u, int k) {
  return __bfloat162float(reinterpret_cast<const bf16*>(&u)[k]);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// swin_norm_pad
// ---------------------------------------------------------------------------

// sum over the `group` lanes of this lane's group (mask: the group's lanes)
__device__ __forceinline__ float group_sum(float v, int group,
                                           unsigned mask) {
  for (int off = group >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

__global__ void __launch_bounds__(kNormThreads)
swin_norm_pad_kernel(const bf16* __restrict__ x,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, bf16* __restrict__ out,
                     int H, int W, int Hp, int Wp, int C, int group_log2,
                     long long rows, float eps) {
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  const int first = (threadIdx.x & 31) & ~(group - 1);
  const unsigned mask =
      group == 32 ? 0xffffffffu : ((1u << group) - 1u) << first;
  const int c8 = C / 8;
  const long long step =
      static_cast<long long>(gridDim.x) * (kNormThreads >> group_log2);
  // the lane's gain and shift, rounded to bf16 as the eager route's cast
  float g[kNormVec][8], b[kNormVec][8];
#pragma unroll
  for (int k = 0; k < kNormVec; ++k) {
    const int v = lane + k * group;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      g[k][e] = v < c8 ? round_bf16(gamma[v * 8 + e]) : 0.0f;
      b[k][e] = v < c8 ? round_bf16(beta[v * 8 + e]) : 0.0f;
    }
  }
  const float inv_c = 1.0f / static_cast<float>(C);
  for (long long row = (static_cast<long long>(blockIdx.x) * kNormThreads +
                        threadIdx.x) >> group_log2;
       row < rows; row += step) {
    const int xw = static_cast<int>(row % Wp);
    const long long t = row / Wp;
    const int y = static_cast<int>(t % Hp);
    const long long img = t / Hp;
    bf16* o = out + row * C;
    if (y >= H || xw >= W) {                    // the pad: zeros
#pragma unroll
      for (int k = 0; k < kNormVec; ++k) {
        const int v = lane + k * group;
        if (v < c8)
          *reinterpret_cast<uint4*>(o + v * 8) = make_uint4(0, 0, 0, 0);
      }
      continue;
    }
    const bf16* in = x + ((img * H + y) * W + xw) * C;
    uint4 val[kNormVec];
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kNormVec; ++k) {
      const int v = lane + k * group;
      val[k] = v < c8 ? load16(in + v * 8) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kNormVec; ++k)
#pragma unroll
      for (int e = 0; e < 8; ++e) s += lane_of(val[k], e);
    const float mean = group_sum(s, group, mask) * inv_c;
    float q = 0.0f;
#pragma unroll
    for (int k = 0; k < kNormVec; ++k) {
      if (lane + k * group >= c8) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = lane_of(val[k], e) - mean;
        q += d * d;
      }
    }
    const float rstd = rsqrtf(group_sum(q, group, mask) * inv_c + eps);
#pragma unroll
    for (int k = 0; k < kNormVec; ++k) {
      const int v = lane + k * group;
      if (v >= c8) continue;
      uint4 r;
      bf16* h = reinterpret_cast<bf16*>(&r);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        h[e] = __float2bfloat16_rn(
            g[k][e] * (rstd * (lane_of(val[k], e) - mean)) + b[k][e]);
      *reinterpret_cast<uint4*>(o + v * 8) = r;
    }
  }
}

// ---------------------------------------------------------------------------
// swin_window_attn
// ---------------------------------------------------------------------------

struct AttnShape {
  int H, W, Hp, Wp, C, heads, window, shift, nwx, nw;
  float scale;
};

__global__ void __launch_bounds__(kAttnThreads)
swin_window_attn_kernel(const bf16* __restrict__ qkv,
                        const float* __restrict__ table,
                        bf16* __restrict__ out, const AttnShape p) {
  __shared__ __align__(16) bf16 sq[kRows * kStride];
  __shared__ __align__(16) bf16 sk[kRows * kStride];
  __shared__ __align__(16) bf16 sv[kRows * kStride];
  __shared__ float sbias[kMaxTable];
  // each token's padded-map place (y << 16 | x), and its offset into the
  // bias table as a query row, (i + w - 1) * (2w - 1) + j + w - 1, and as
  // a key column, i * (2w - 1) + j, each with its mask region from bit 16
  __shared__ int splace[kRows], srow[kRows], scol[kRows];

  const int tid = threadIdx.x;
  const int h = blockIdx.x % p.heads;
  const int rest = blockIdx.x / p.heads;
  const int win = rest % p.nw;
  const long long img = rest / p.nw;
  const int wy = win / p.nwx, wx = win % p.nwx;
  const int w = p.window, n = w * w, c3 = 3 * p.C;
  const int span = 2 * w - 1;

  if (tid < n) {
    const int i = tid / w, j = tid % w;
    const int ry = wy * w + i, rx = wx * w + j;         // the rolled map
    int sy = ry + p.shift, sx = rx + p.shift;            // the padded map
    if (sy >= p.Hp) sy -= p.Hp;
    if (sx >= p.Wp) sx -= p.Wp;
    int region = 0;
    if (p.shift) {
      const int gy = (ry >= p.Hp - w) + (ry >= p.Hp - p.shift);
      const int gx = (rx >= p.Wp - w) + (rx >= p.Wp - p.shift);
      region = (3 * gy + gx) << 16;
    }
    splace[tid] = sy << 16 | sx;
    srow[tid] = region | ((i + w - 1) * span + j + w - 1);
    scol[tid] = region | (i * span + j);
  }
  for (int i = tid; i < span * span; i += kAttnThreads)
    sbias[i] = table[i * p.heads + h];
  __syncthreads();

  // gather q, k and v: 3 x 64 rows x four 16-byte pieces
  const bf16* base = qkv + img * p.Hp * p.Wp * c3 + h * kD;
  for (int c = tid; c < 3 * kRows * 4; c += kAttnThreads) {
    const int which = c / (kRows * 4);
    const int r = (c >> 2) & (kRows - 1);
    const int part = c & 3;
    bf16* dst = (which == 0 ? sq : which == 1 ? sk : sv) + r * kStride +
                part * 8;
    const bf16* src = base;
    int bytes = 0;
    if (r < n) {
      const int place = splace[r];
      src = base + (static_cast<long long>(place >> 16) * p.Wp +
                    (place & 0xffff)) * c3 + which * p.C + part * 8;
      bytes = 16;
    }
    cp_async16(smem_addr(dst), src, bytes);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16;
  const int g = lane >> 2, t4 = lane & 3;
  if (r0 >= n) return;                 // no real query row (small windows)

  // S = q k^T, 16 rows x 64 columns a warp
  uint32_t qa[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
    ldmatrix_x4(qa[ks], sq + (r0 + (lane & 15)) * kStride + ks * 16 +
                            (lane >> 4) * 8);
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    if (j * 8 >= n) continue;
    uint32_t kb[4];
    ldmatrix_x4(kb, sk + (j * 8 + (lane & 7)) * kStride + (lane >> 3) * 8);
    mma_bf16(s[j], qa[0], kb[0], kb[1]);
    mma_bf16(s[j], qa[1], kb[2], kb[3]);
  }

  // scale, bias and mask, softmax over the real columns, in f32; the
  // thread's rows are r0 + g (s[.][0..1]) and r0 + g + 8 (s[.][2..3])
  int rows[2];
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  rows[0] = srow[min(r0 + g, n - 1)];                // pad rows: any row
  rows[1] = srow[min(r0 + g + 8, n - 1)];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = j * 8 + 2 * t4 + e;
      if (col >= n) {
        s[j][e] = s[j][2 + e] = -CUDART_INF_F;
        continue;
      }
      const int key = scol[col];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = rows[half];
        float bm = sbias[(row & 0xffff) - (key & 0xffff)];
        if ((row ^ key) >> 16) bm = bm + kMask;
        float& v = s[j][2 * half + e];
        v = __fmaf_rn(v, p.scale, bm);
        m[half] = fmaxf(m[half], v);
      }
    }
  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    m[half] = fmaxf(m[half], __shfl_xor_sync(0xffffffffu, m[half], 1));
    m[half] = fmaxf(m[half], __shfl_xor_sync(0xffffffffu, m[half], 2));
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = s[j][2 * half + e];
        v = expf(v - m[half]);                    // 0 for the pad columns
        sum += v;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[half] = 1.0f / sum;
  }

  // P (bf16, normalised) in A-fragment order: P.V, 16 rows x 32 a warp
  float o[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (ks * 16 >= n) break;
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * ks][0] * inv[0], s[2 * ks][1] * inv[0]);
    pa[1] = pack_bf16(s[2 * ks][2] * inv[1], s[2 * ks][3] * inv[1]);
    pa[2] = pack_bf16(s[2 * ks + 1][0] * inv[0], s[2 * ks + 1][1] * inv[0]);
    pa[3] = pack_bf16(s[2 * ks + 1][2] * inv[1], s[2 * ks + 1][3] * inv[1]);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t vb[4];
      const int row = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4_trans(vb, sv + row * kStride + np * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * np], pa, vb[0], vb[1]);
      mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
    }
  }

  // through the warp's own q rows to 16-byte stores at the original places
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = nt * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(sq + (r0 + g) * kStride + col) =
        pack_bf16(o[nt][0], o[nt][1]);
    *reinterpret_cast<uint32_t*>(sq + (r0 + g + 8) * kStride + col) =
        pack_bf16(o[nt][2], o[nt][3]);
  }
  __syncwarp();
  bf16* out_img = out + img * p.H * p.W * p.C + h * kD;
#pragma unroll
  for (int c = lane; c < 64; c += 32) {
    const int r = r0 + (c >> 2), part = c & 3;
    if (r >= n) continue;
    const int place = splace[r];
    const int y = place >> 16, x = place & 0xffff;
    if (y >= p.H || x >= p.W) continue;          // the crop
    *reinterpret_cast<uint4*>(out_img +
                              (static_cast<long long>(y) * p.W + x) * p.C +
                              part * 8) =
        *reinterpret_cast<const uint4*>(sq + r * kStride + part * 8);
  }
}

}  // namespace

extern "C" int r3det_swin_norm_pad(const void* x, const void* gamma,
                                   const void* beta, void* out, int B, int H,
                                   int W, int Hp, int Wp, int C, float eps,
                                   int sms, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const int c8 = C / 8;
  if (C <= 0 || C % 8 || c8 > kNormVec * 32 || Hp < H || Wp < W || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int group_log2 = 0;
  while ((1 << group_log2) * kNormVec < c8) ++group_log2;
  static int occupancy[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  int& per_sm = occupancy[dev];
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, swin_norm_pad_kernel, kNormThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const long long rows = static_cast<long long>(B) * Hp * Wp;
  const long long per_block = kNormThreads >> group_log2;
  const long long need = (rows + per_block - 1) / per_block;
  const long long full = static_cast<long long>(per_sm) * sms;
  const int grid = static_cast<int>(need < full ? need : full);
  swin_norm_pad_kernel<<<grid, kNormThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(out), H, W, Hp, Wp,
      C, group_log2, rows, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int r3det_swin_window_attn(const void* qkv, const void* table,
                                      void* out, int B, int H, int W, int Hp,
                                      int Wp, int C, int heads, int window,
                                      int shift, float scale, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (heads <= 0 || C != heads * kD || window <= 0 ||
      window > kMaxWindow || shift < 0 || shift >= window || Hp % window ||
      Wp % window || Hp < H || Wp < W || Hp >= (1 << 15) || Wp >= (1 << 15))
    return static_cast<int>(cudaErrorInvalidValue);
  AttnShape p;
  p.H = H;
  p.W = W;
  p.Hp = Hp;
  p.Wp = Wp;
  p.C = C;
  p.heads = heads;
  p.window = window;
  p.shift = shift;
  p.nwx = Wp / window;
  p.nw = (Hp / window) * p.nwx;
  p.scale = scale;
  const long long blocks = static_cast<long long>(B) * p.nw * heads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  swin_window_attn_kernel<<<static_cast<unsigned>(blocks), kAttnThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(table),
      static_cast<bf16*>(out), p);
  return static_cast<int>(cudaGetLastError());
}
