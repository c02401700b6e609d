// Fused MBConv segment: expand 1x1 -> affine -> swish -> depthwise KxK
// (stride S, TF-SAME) -> affine -> swish, plus the f32 spatial mean of the
// result for the squeeze-excite. One kernel per activation type serves both
// TPU contracts.
//
// Replaces: efficientdet_tpu/kernels/mbconv_kernel.py::fused_expand_dw_flat
// (pallas_call body _kernel_flat) and ::fused_expand_dw (body _kernel). The
// two compute the same function and differ only in where BN0 rounds:
//   y = swish(acc * scale + bias), acc = sum_c x_c * W[c]   (f32)
// flat: W = T(W_e * s0), scale = 1, bias = f32(T(b0)); v1: W = T(W_e),
// scale = s0, bias = b0 (T is the activation type). The f32 kernel takes W,
// scale and bias so prepared by the wrappers (kernels/mbconv_kernel.py); the
// bf16 kernel takes W packed by them and folds scale and bias itself.
//
// Bound on the H100: device-memory bytes. At D0@512, B = 32, block 1's
// expanded tensor is 32 x 256 x 256 x 96 bf16 = 403 MB, which the unfused
// path writes and reads back. Here it never leaves the SM: each thread
// block owns an output tile by 48 expanded channels, computes the expand for
// the tile's input patch (the halo is recomputed by the neighbours), keeps
// the bf16-rounded y of the whole patch in shared memory and runs the
// depthwise window from there. What is left is x read once per channel tile
// (from L2 for all but the first) and z written once: 646 MB over D0's 15
// blocks at B = 32, 0.193 ms at 3.35 TB/s, against 40 GFLOP of expand and
// depthwise, 0.041 ms at the bf16 tensor-core peak.
//
// bfloat16 (the serving path), mbconv_tc_kernel, 8 warps:
// - The expand runs on the tensor cores as a small GEMM per block: patch
//   pixels x Cin (padded to a multiple of 16) times Cin x 48 channels, with
//   mma.sync.m16n8k16 (bf16 in, f32 out) fed by ldmatrix from shared memory.
//   mma.sync, not wgmma: even at a third of the peak the 40 GFLOP take less
//   than the bytes, and its 16-row tiles fit the 81..665-pixel patches,
//   which wgmma's 64-row tiles and warpgroup-wide operands would pad.
// - W of the block's channel tile stays resident in shared memory (rows
//   cin_pad * 2 + 16 bytes apart, so ldmatrix's eight rows fall in distinct
//   banks). Each warp streams its own m16 tiles of the patch through a ring
//   of three cp.async stages of 16 rows x 32 input channels (80-byte rows),
//   two steps in flight while one multiplies; pixels outside the image and
//   the padded Cin lanes are zero-filled by the copy, and a deep block's
//   patch never has to fit whole.
// - Each k16 step's product starts from zero and is added to the running
//   f32 sum on the CUDA cores, in k order: the tensor cores truncate their
//   sums, and this keeps that to one truncation of each 16-term partial.
// - y and z are computed with a fast swish (ex2 and rcp on the special
//   function unit). The plain version sums the expand in k order with fused
//   multiply-adds, uses the exact swish, and rounds y and z to bf16; so
//   wherever a bf16 rounding boundary lies within the two results' bounded
//   difference (6 u ||x|| ||w|| for the sum, u = 2^-24, with the norms
//   taken from the staged chunks and the resident W; (|v| + 8) 1.2e-7 of y
//   for the swish), the kernel recomputes: a z with the exact swish, inline
//   and rare; a y, queued by channel pair (under 3 % of the elements in
//   the model of tests/test_torch_port_mbconv.py), with the sum in k order
//   from x in L2 after the expand.
//   Everywhere else the rounding is the same, so y and z are the plain
//   version's.
// - y lives in shared memory in bf16, one patch row every `row_stride`
//   bytes, chosen (in the host's tile plan) so that S * row_stride = 32 mod
//   128 bytes. The depthwise gives each warp four consecutive output rows
//   (one per 8 lanes) of 16 channels (2 per lane): its 32 lanes read 4 x 32
//   bytes that fall in all 32 banks once. Each lane computes 4
//   neighbouring outputs of a row and keeps the (3S + K) y values of their
//   windows in registers, so a tap row is read once for 4 outputs.
// - Tiles (host plan): 16 x 16 outputs at stride 1, 16 x 8 at stride 2
//   (patches 324, 400, 561 and 665 pixels; the stride-2 halo costs 1.10x
//   and 1.30x of the expand); 64..113 KB of shared memory at D0's shapes
//   and B6's widest, so at least two blocks per SM.
//
// float32, mbconv_fused_kernel: the expand is an f32 FMA loop on CUDA cores
// in k order (8 pixels x 4 channels per thread, 8 input channels staged at
// a time). TF32 products would break the f32 checks (1e-5); this type
// serves the f32 parity, not the serving path.
//
// Semantics equal the plain version (kernels/mbconv_kernel.py) up to the
// order of f32 sums: y is rounded to T before the depthwise, y is 0 in the
// padding ring (never swish(bias)), the two affines are separately rounded
// multiply and add (__fmul_rn/__fadd_rn, no contraction), the depthwise sums
// its taps in (di, dj) order, the SE sum is over f32 z before its cast, over
// Ho x Wo. That sum is made deterministic: each block writes its tile's
// per-channel sum to `partial` and a second small kernel adds the tiles of
// an image in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChanTile = 48;  // expanded channels per block (both types)

__device__ __forceinline__ float swish(float v) {
  return v / (1.0f + expf(-v));
}

// Separately rounded v * scale + bias, as two tensor ops round it.
__device__ __forceinline__ float affine(float v, float scale, float bias) {
  return __fadd_rn(__fmul_rn(v, scale), bias);
}

// ------------------------------------------------------------------ float32
constexpr int kThreads = 192;
constexpr int kChanGroups = kChanTile / 4;      // 4 channels per thread
constexpr int kPixGroups = kThreads / kChanGroups;  // 16
constexpr int kPassPix = kPixGroups * 8;        // patch pixels per expand pass
constexpr int kChunk = 8;                       // Cin per staged chunk
constexpr int kXStride = kPassPix + 4;          // padded row, 16-byte aligned
constexpr int kOutBatch = 4;                    // depthwise outputs per step
static_assert(kChunk * kChanTile == 2 * kThreads, "2 weights per thread");

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Shared memory, in floats: staged x chunk, staged W chunk, depthwise
// weights, the four affine vectors, the SE reduction rows; then y.
__host__ __device__ constexpr size_t float_smem(int k) {
  return static_cast<size_t>(kChunk) * kXStride + kChunk * kChanTile +
         k * k * kChanTile + 4 * kChanTile + kPixGroups * kChanTile;
}

template <int K, int S>
__global__ void __launch_bounds__(kThreads, 2) mbconv_fused_kernel(
    const float* __restrict__ x, const float* __restrict__ w_expand,
    const float* __restrict__ scale0, const float* __restrict__ bias0,
    const float* __restrict__ w_dw, const float* __restrict__ scale1,
    const float* __restrict__ bias1, float* __restrict__ z,
    float* __restrict__ partial, int h, int w, int cin, int ce, int out_h,
    int out_w, int pad_top, int pad_left, int tile_h, int tile_w,
    int tiles_w, int num_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                              // [kChunk][kXStride]
  float* ws = xs + kChunk * kXStride;            // [kChunk][kChanTile]
  float* wds = ws + kChunk * kChanTile;          // [K*K][kChanTile]
  float* aff = wds + K * K * kChanTile;          // s0, b0, s1, b1
  float* red = aff + 4 * kChanTile;              // [kPixGroups][kChanTile]
  float* ys = red + kPixGroups * kChanTile;

  const int tid = threadIdx.x;
  const int cg = tid % kChanGroups;
  const int pg = tid / kChanGroups;
  const int num_ct = ce / kChanTile;
  const int ct = blockIdx.x % num_ct;   // channel tile varies fastest, so
  const int tile = blockIdx.x / num_ct; // neighbours share the x patch in L2
  const int b = blockIdx.y;
  const int c0 = ct * kChanTile;
  const int oh0 = (tile / tiles_w) * tile_h;
  const int ow0 = (tile % tiles_w) * tile_w;
  const int row0 = oh0 * S - pad_top;   // patch origin in input pixels
  const int col0 = ow0 * S - pad_left;
  const int ph = (tile_h - 1) * S + K;
  const int pw = (tile_w - 1) * S + K;
  const int patch = ph * pw;
  const float* xb = x + static_cast<size_t>(b) * h * w * cin;

  for (int i = tid; i < K * K * kChanTile; i += kThreads)
    wds[i] = w_dw[(i / kChanTile) * ce + c0 + i % kChanTile];
  if (tid < kChanTile) {
    aff[tid] = scale0[c0 + tid];
    aff[kChanTile + tid] = bias0[c0 + tid];
    aff[2 * kChanTile + tid] = scale1[c0 + tid];
    aff[3 * kChanTile + tid] = bias1[c0 + tid];
  }

  // ---- expand: y for every patch pixel, in passes of kPassPix pixels.
  for (int pass0 = 0; pass0 < patch; pass0 += kPassPix) {
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    // Staging: thread tid < kPassPix brings pixel pass0 + tid's 8 inputs
    // of a chunk; every thread brings 2 of the chunk's 8 x 48 weights. The
    // next chunk's loads are issued before the current chunk's products, so
    // their latency hides behind them.
    const float* xsrc = nullptr;
    if (tid < kPassPix && pass0 + tid < patch) {
      const int r = row0 + (pass0 + tid) / pw;
      const int c = col0 + (pass0 + tid) % pw;
      if (r >= 0 && r < h && c >= 0 && c < w)
        xsrc = xb + (static_cast<size_t>(r) * w + c) * cin;
    }
    float4 xn_lo, xn_hi;
    float wn[2];
    auto fetch = [&](int kc) {
      if (xsrc != nullptr) {
        xn_lo = reinterpret_cast<const float4*>(xsrc + kc)[0];
        xn_hi = reinterpret_cast<const float4*>(xsrc + kc)[1];
      } else {
        xn_lo = xn_hi = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = tid + u * kThreads;
        wn[u] = w_expand[static_cast<size_t>(kc + i / kChanTile) * ce + c0 +
                         i % kChanTile];
      }
    };
    fetch(0);
    for (int kc = 0; kc < cin; kc += kChunk) {
      __syncthreads();  // the previous chunk's reads are done
      if (tid < kPassPix) {
        const float v[kChunk] = {xn_lo.x, xn_lo.y, xn_lo.z, xn_lo.w,
                                 xn_hi.x, xn_hi.y, xn_hi.z, xn_hi.w};
#pragma unroll
        for (int j = 0; j < kChunk; ++j) xs[j * kXStride + tid] = v[j];
      }
      ws[tid] = wn[0];
      ws[tid + kThreads] = wn[1];
      __syncthreads();
      if (kc + kChunk < cin) fetch(kc + kChunk);
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        float xv[8], wv[4];
        const float* xr = xs + k * kXStride + pg * 8;
        load4(xr, xv);
        load4(xr + 4, xv + 4);
        load4(ws + k * kChanTile + cg * 4, wv);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = pass0 + pg * 8 + i;
      if (p >= patch) break;
      const int r = row0 + p / pw;
      const int c = col0 + p % pw;
      const bool inside = r >= 0 && r < h && c >= 0 && c < w;
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = cg * 4 + j;
        y[j] = inside
            ? swish(affine(acc[i][j], aff[cc], aff[kChanTile + cc]))
            : 0.0f;
      }
      store4(ys + static_cast<size_t>(p) * kChanTile + cg * 4, y);
    }
  }
  __syncthreads();

  // ---- depthwise + affine + swish from the resident y; SE partial sums.
  float se[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int tile_out = tile_h * tile_w;
  for (int o0 = pg; o0 < tile_out; o0 += kPixGroups * kOutBatch) {
    float acc[kOutBatch][4];
    int base[kOutBatch];
#pragma unroll
    for (int u = 0; u < kOutBatch; ++u) {
      const int o = min(o0 + u * kPixGroups, tile_out - 1);
      base[u] = ((o / tile_w) * S * pw + (o % tile_w) * S) * kChanTile +
                cg * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[u][j] = 0.0f;
    }
#pragma unroll
    for (int di = 0; di < K; ++di) {
#pragma unroll
      for (int dj = 0; dj < K; ++dj) {
        float wv[4];
        load4(wds + (di * K + dj) * kChanTile + cg * 4, wv);
        const int off = (di * pw + dj) * kChanTile;
#pragma unroll
        for (int u = 0; u < kOutBatch; ++u) {
          float yv[4];
          load4(ys + base[u] + off, yv);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[u][j] = fmaf(yv[j], wv[j], acc[u][j]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kOutBatch; ++u) {
      const int o = o0 + u * kPixGroups;
      const int oh = oh0 + o / tile_w;
      const int ow = ow0 + o % tile_w;
      if (o >= tile_out || oh >= out_h || ow >= out_w) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = cg * 4 + j;
        v[j] = swish(affine(acc[u][j], aff[2 * kChanTile + cc],
                            aff[3 * kChanTile + cc]));
        se[j] += v[j];
      }
      store4(z + ((static_cast<size_t>(b) * out_h + oh) * out_w + ow) * ce +
                 c0 + cg * 4,
             v);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[pg * kChanTile + cg * 4 + j] = se[j];
  __syncthreads();
  if (tid < kChanTile) {
    float s = 0.0f;
    for (int i = 0; i < kPixGroups; ++i) s += red[i * kChanTile + tid];
    partial[(static_cast<size_t>(b) * num_tiles + tile) * ce + c0 + tid] = s;
  }
}

// ----------------------------------------------------------------- bfloat16
namespace tc {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNTiles = kChanTile / 8;          // n8 tiles of the MMA
constexpr int kChunk = 32;                      // Cin lanes per staged step
constexpr int kRowBytes = kChunk * 2 + 16;      // padded staged x row
constexpr int kRing = 3;                        // x stages per warp
constexpr int kWarpStage = 16 * kRowBytes;      // one m16 tile's chunk
constexpr int kPixBytes = kChanTile * 2;        // one pixel's y
constexpr int kSlices = kChanTile / 16;         // 16 channels a warp
constexpr int kStrip = 4;                       // depthwise outputs a lane
constexpr int kFixCap = 768;    // y pairs queued for the sequential sum
// y and z are rounded to bf16 from a fast swish (ex2 and rcp on the special
// function unit): within (|v| + 8) 1.2e-7 of the exact one's relative value
// for v >= -80. Where that leaves the bf16 rounding in doubt, the exact
// swish decides.
constexpr float kFastRel = 1.2e-7f;
// Bound on |sequential sum - tensor-core sum| in units of ||x|| ||w||:
// 6 u (u = 2^-24), about three times the largest difference of the two
// orders in the model of tests/test_torch_port_mbconv.py (the card's bf16
// checks in chip_smoke.py then find every element equal); times 1.1, the
// steepest slope of swish.
constexpr float kOrderSlack = 1.1f * 6.0f * 5.9604645e-8f;

// Bytes between W's resident rows: cin_pad bf16 and 16 bytes, an odd
// number of 16-byte units, so ldmatrix's eight rows fall in distinct banks.
__host__ __device__ constexpr int w_stride(int cin_pad) {
  return cin_pad * 2 + 16;
}

// Shared memory besides y: W resident, each warp's ring of x stages,
// depthwise weights and the four affine vectors, the SE rows, the
// per-channel slack, the queue of y pairs to recompute and its length. The
// host plan (kernels/mbconv_kernel.py::tile_plan) adds ph * row_stride for y.
__host__ __device__ constexpr int fixed_smem(int k, int cin_pad) {
  return kChanTile * w_stride(cin_pad) + kWarps * kRing * kWarpStage +
         (k * k + 4) * kChanTile * 4 + kWarps * kChanTile * 4 +
         kChanTile * 4 + (kFixCap + 4) * 4;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// 16 bytes global -> shared; zero-filled where !valid (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(const void* p, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d = a (16x16, row) * b (16x8, col), bf16 in, f32 out, from zero.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// Sum of squares of n bf16 values at p (16-byte aligned, n % 8 == 0).
__device__ __forceinline__ float sumsq_bf16(const unsigned char* p, int n) {
  float s = 0.0f;
  for (int q = 0; q < n / 8; ++q) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + q * 16);
    const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(hv[i]);
      s = fmaf(f.x, f.x, s);
      s = fmaf(f.y, f.y, s);
    }
  }
  return s;
}

// p / d and p % d for 0 <= p < 1024 and 0 < d < 64, with m = ceil(2^16 / d):
// exact in that range, and three integer operations.
struct DivMod {
  int d, m;
  __device__ explicit DivMod(int d_) : d(d_), m((65536 + d_ - 1) / d_) {}
  __device__ __forceinline__ int div(int p) const { return (p * m) >> 16; }
};

// sum_k x[k] * w[k] in k order with fused multiply-adds: the order of the
// plain version's f32 GEMM. x (global) and w (shared) 16-byte aligned,
// n % 8 == 0.
__device__ __noinline__ float sequential_dot(const __nv_bfloat16* x,
                                             const unsigned char* w, int n) {
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < n; k += 8) {
    const uint4 xa = __ldg(reinterpret_cast<const uint4*>(x + k));
    const uint4 wa = *reinterpret_cast<const uint4*>(w + 2 * k);
    const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xa);
    const __nv_bfloat162* wh = reinterpret_cast<const __nv_bfloat162*>(&wa);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 xf = __bfloat1622float2(xh[i]);
      const float2 wf = __bfloat1622float2(wh[i]);
      acc = fmaf(xf.x, wf.x, acc);
      acc = fmaf(xf.y, wf.y, acc);
    }
  }
  return acc;
}

__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// swish on the special function unit: 2^(-v log2 e), one reciprocal.
__device__ __forceinline__ float swish_fast(float v) {
  return v * rcp_approx(1.0f + ex2_approx(v * -1.44269504f));
}

// Bound on |fast swish - exact swish| at v, plus dv, the bound on the error
// v itself may carry (through swish's slope, at most 1.1, folded into dv).
__device__ __forceinline__ float swish_slack(float v, float y, float dv) {
  return fmaf(fabsf(y), fmaf(fabsf(v), kFastRel, 8.0f * kFastRel), dv);
}

// Whether a pair (y0, y1), each known within dy0, dy1, might round to other
// bf16 values than computed: the low and high ends round apart. v0, v1
// below -80 always count (the fast swish flushes there).
__device__ __forceinline__ bool pair_unsure(float v0, float y0, float dy0,
                                            float v1, float y1, float dy1) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(y0 - dy0, y1 - dy1);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(y0 + dy0, y1 + dy1);
  return (*reinterpret_cast<const unsigned*>(&lo) !=
          *reinterpret_cast<const unsigned*>(&hi)) |
         (fminf(v0, v1) < -80.0f);
}

// The depthwise weights' strides in elements, w_dw[i][j][c] (the wrappers
// pass a view of the conv weight), and the contract: flat rounds b0 to bf16
// and has scale 1 (W_e s0 is folded into the packed W on the host); v1
// takes s0 and b0 as they are.
struct Depthwise {
  int si, sj, sc;
  int flat;
};

template <int K, int S>
__global__ void __launch_bounds__(kThreads, 2) mbconv_tc_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
    const float* __restrict__ scale0, const float* __restrict__ bias0,
    const float* __restrict__ w_dw, const float* __restrict__ scale1,
    const float* __restrict__ bias1, Depthwise dw,
    __nv_bfloat16* __restrict__ z,
    float* __restrict__ partial, int h, int w, int cin, int cin_pad, int ce,
    int out_h, int out_w, int pad_top, int pad_left, int tile_h, int tile_w,
    int tiles_w, int num_tiles, int row_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wstride = w_stride(cin_pad);
  unsigned char* wres = smem;                        // [kChanTile][wstride]
  unsigned char* ring = wres + kChanTile * wstride;  // [warp][kRing][16 rows]
  float* wds = reinterpret_cast<float*>(ring + kWarps * kRing * kWarpStage);
  float* aff = wds + K * K * kChanTile;              // s0, b0, s1, b1
  float* red = aff + 4 * kChanTile;                  // [kWarps][kChanTile]
  float* slack = red + kWarps * kChanTile;           // [kChanTile]
  unsigned* fix = reinterpret_cast<unsigned*>(slack + kChanTile);
  int* fix_count = reinterpret_cast<int*>(fix + kFixCap);
  unsigned char* ys = reinterpret_cast<unsigned char*>(fix_count + 4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int num_ct = ce / kChanTile;
  const int ct = blockIdx.x % num_ct;   // channel tile varies fastest, so
  const int tile = blockIdx.x / num_ct; // neighbours share the x patch in L2
  const int b = blockIdx.y;
  const int c0 = ct * kChanTile;
  const int oh0 = (tile / tiles_w) * tile_h;
  const int ow0 = (tile % tiles_w) * tile_w;
  const int row0 = oh0 * S - pad_top;   // patch origin in input pixels
  const int col0 = ow0 * S - pad_left;
  const int pw = (tile_w - 1) * S + K;
  const DivMod by_pw(pw);
  const int patch = ((tile_h - 1) * S + K) * pw;
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * h * w * cin;
  const __nv_bfloat16* wt = wp + static_cast<size_t>(c0) * cin_pad;

  // W of the channel tile (resident), the depthwise weights and the affine
  // vectors: one cp.async group per thread.
  const int wunits = cin_pad / 8;
  for (int i = tid; i < kChanTile * wunits; i += kThreads) {
    const int n = i / wunits, q = i % wunits;
    cp_async16(wres + n * wstride + q * 16,
               wt + static_cast<size_t>(n) * cin_pad + q * 8, true);
  }
  for (int i = tid; i < (K * K + 4) * kChanTile; i += kThreads) {
    const int row = i / kChanTile, c = c0 + i % kChanTile;
    const float* src = row < K * K
                           ? w_dw + (row / K) * dw.si + (row % K) * dw.sj +
                                 c * dw.sc
                     : row == K * K ? scale0 + c
                     : row == K * K + 1 ? bias0 + c
                     : row == K * K + 2 ? scale1 + c : bias1 + c;
    cp_async4(wds + i, src);
  }
  cp_async_commit();

  // ---- each warp streams its own m16 tiles of the patch (tiles warp,
  // warp + 8, ...) through its ring: step s is chunk s % chunks of the
  // warp's tile s / chunks. Steps s + 1 and s + 2 are in flight while s
  // multiplies.
  const int chunks = (cin_pad + kChunk - 1) / kChunk;
  const int mtiles = (patch + 15) / 16;
  const int my_tiles =
      mtiles > warp ? (mtiles - warp + kWarps - 1) / kWarps : 0;
  const int steps = my_tiles * chunks;
  unsigned char* wring = ring + warp * kRing * kWarpStage;

  // x of step s into the warp's ring (an empty group past the last step,
  // so that the group count stays the same).
  auto issue = [&](int step) {
    if (step < steps) {
      const int p0 = (warp + (step / chunks) * kWarps) * 16;
      const int kc = (step % chunks) * kChunk;
      unsigned char* dst = wring + (step % kRing) * kWarpStage;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = lane + 32 * u;
        const int r = i >> 2, q = i & 3;
        const int p = p0 + r;
        const int pr = by_pw.div(p);
        const int gr = row0 + pr;
        const int gc = col0 + p - pr * pw;
        const bool ok = p < patch && gr >= 0 && gr < h && gc >= 0 &&
                        gc < w && kc + 8 * q < cin;
        const __nv_bfloat16* src =
            ok ? xb + (static_cast<size_t>(gr) * w + gc) * cin + kc + 8 * q
               : x;
        cp_async16(dst + r * kRowBytes + q * 16, src, ok);
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  if (tid == 0) *fix_count = 0;
  cp_async_wait<2>();  // W and the vectors have landed
  __syncthreads();
  if (dw.flat && tid < kChanTile) {  // the flat contract's BN0 affine
    aff[tid] = 1.0f;
    aff[kChanTile + tid] =
        __bfloat162float(__float2bfloat16_rn(aff[kChanTile + tid]));
  }
  if (tid < 4 * kChanTile) {  // |scale| ||w|| 6.6 u, four threads a channel
    const int c = tid >> 2, part = cin_pad / 4 / 8 * 8;
    float ss = sumsq_bf16(wres + c * wstride + (tid & 3) * part * 2, part);
    if ((tid & 3) == 3)
      ss += sumsq_bf16(wres + c * wstride + 4 * part * 2, cin_pad - 4 * part);
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    if ((tid & 3) == 0)
      slack[c] = kOrderSlack * (dw.flat ? 1.0f : fabsf(aff[c])) * sqrtf(ss);
  }
  __syncthreads();

  const int g = lane >> 2, t4 = lane & 3;
  float acc[kNTiles][4];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
  float sumsq = 0.0f;  // row lane & 15 of the tile, half lane >> 4

  for (int step = 0; step < steps; ++step) {
    issue(step + 2);
    cp_async_wait<2>();
    __syncwarp();  // the warp's copies of this step are visible to it
    const unsigned char* xst = wring + (step % kRing) * kWarpStage;
    const int kc = (step % chunks) * kChunk;
    const int ksteps = min(2, (cin_pad - kc) / 16);
    sumsq += sumsq_bf16(xst + (lane & 15) * kRowBytes + (lane >> 4) * 32, 16);
    for (int ks = 0; ks < ksteps; ++ks) {
      unsigned a[4];
      ldmatrix_x4(xst + (lane & 15) * kRowBytes + ks * 32 + (lane >> 4) * 16,
                  a);
#pragma unroll
      for (int jj = 0; jj < kNTiles / 2; ++jj) {
        unsigned bf[4];
        ldmatrix_x4(wres + (jj * 16 + ((lane >> 4) << 3) + (lane & 7)) *
                               wstride +
                        (kc + ks * 16) * 2 + ((lane >> 3) & 1) * 16,
                    bf);
        float t[4];
        mma_bf16(t, a, bf[0], bf[1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[2 * jj][i] += t[i];
        mma_bf16(t, a, bf[2], bf[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[2 * jj + 1][i] += t[i];
      }
    }
    __syncwarp();  // every lane is done with this stage

    if (step % chunks == chunks - 1) {
      // ---- the tile's last chunk: y = swish(affine(acc)) to y's rows, a
      // pair of channels (c, c + 1) at a time.
      const float norm2 = sumsq + __shfl_xor_sync(0xffffffffu, sumsq, 16);
      sumsq = 0.0f;
      const int p0 = (warp + (step / chunks) * kWarps) * 16;
      unsigned flags = 0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float xn =
            sqrtf(__shfl_sync(0xffffffffu, norm2, g + half * 8));
        const int p = p0 + g + half * 8;
        const int pr = by_pw.div(p), pc = p - pr * pw;
        const int gr = row0 + pr, gc = col0 + pc;
        const bool inside = p < patch && gr >= 0 && gr < h && gc >= 0 &&
                            gc < w;
        unsigned char* yrow = ys + pr * row_stride + pc * kPixBytes;
        unsigned half_flags = 0;
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
          const int c = j * 8 + t4 * 2;
          const float v0 = affine(acc[j][half * 2], aff[c],
                                  aff[kChanTile + c]);
          const float v1 = affine(acc[j][half * 2 + 1], aff[c + 1],
                                  aff[kChanTile + c + 1]);
          const float y0 = swish_fast(v0), y1 = swish_fast(v1);
          // The sum's order or the fast swish might decide the rounding.
          half_flags |= static_cast<unsigned>(pair_unsure(
                            v0, y0, swish_slack(v0, y0, xn * slack[c]), v1,
                            y1, swish_slack(v1, y1, xn * slack[c + 1])))
                        << j;
          if (p < patch)
            *reinterpret_cast<__nv_bfloat162*>(yrow + c * 2) =
                __floats2bfloat162_rn(inside ? y0 : 0.0f, inside ? y1 : 0.0f);
        }
        flags |= (inside ? half_flags : 0u) << (half * kNTiles);
      }
      if (flags != 0) {  // queue them for the sequential sum
        int slot = atomicAdd(fix_count, __popc(flags));
        for (; flags != 0 && slot < kFixCap; flags &= flags - 1, ++slot) {
          const int bit = __ffs(flags) - 1;
          const int r = g + (bit / kNTiles) * 8;
          fix[slot] = ((p0 + r) << 6) | ((bit % kNTiles) * 8 + t4 * 2);
        }
      }
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp's y is written, the queue complete

  // ---- the queued y pairs, summed in k order and rounded exactly, one
  // channel a thread. If the queue overflowed, every y of the patch is
  // redone so.
  const bool all = *fix_count > kFixCap;
  const int todo = all ? patch * kChanTile : 2 * *fix_count;
  for (int i = tid; i < todo; i += kThreads) {
    const int p = all ? i / kChanTile : static_cast<int>(fix[i >> 1] >> 6);
    const int c = all ? i % kChanTile
                      : static_cast<int>(fix[i >> 1] & 63) + (i & 1);
    const int pr = by_pw.div(p), pc = p - pr * pw;
    const int gr = row0 + pr, gc = col0 + pc;
    if (gr < 0 || gr >= h || gc < 0 || gc >= w) continue;
    const float v = affine(
        sequential_dot(xb + (static_cast<size_t>(gr) * w + gc) * cin,
                       wres + c * wstride, cin),
        aff[c], aff[kChanTile + c]);
    *reinterpret_cast<__nv_bfloat16*>(ys + pr * row_stride + pc * kPixBytes +
                                      c * 2) = __float2bfloat16_rn(swish(v));
  }
  __syncthreads();

  // ---- depthwise + affine + swish from the resident y; SE partial sums.
  // Work unit: 4 output rows (8 lanes each) x kStrip columns x 16 channels
  // (2 per lane). Units of all slices are dealt round-robin to the warps.
  constexpr int kWin = (kStrip - 1) * S + K;
  const int strip = lane >> 3, pair = lane & 7;
  const int col_groups = (tile_w + kStrip - 1) / kStrip;
  const int units = ((tile_h + 3) / 4) * col_groups;
#pragma unroll 1
  for (int slice = 0; slice < kSlices; ++slice) {
    const int ch = slice * 16 + pair * 2;
    const float s1a = aff[2 * kChanTile + ch];
    const float s1b = aff[2 * kChanTile + ch + 1];
    const float b1a = aff[3 * kChanTile + ch];
    const float b1b = aff[3 * kChanTile + ch + 1];
    float se0 = 0.0f, se1 = 0.0f;
    const int u0 = ((warp - slice * units) % kWarps + kWarps) % kWarps;
    for (int u = u0; u < units; u += kWarps) {
      const int orow = min((u / col_groups) * 4 + strip, tile_h - 1);
      const int ocol0 = (u % col_groups) * kStrip;
      float dacc[kStrip][2];
#pragma unroll
      for (int r = 0; r < kStrip; ++r) dacc[r][0] = dacc[r][1] = 0.0f;
#pragma unroll
      for (int di = 0; di < K; ++di) {
        const unsigned char* prow = ys + (orow * S + di) * row_stride + ch * 2;
        float2 v[kWin];
#pragma unroll
        for (int t = 0; t < kWin; ++t) {
          const int pc = min(ocol0 * S + t, pw - 1);
          v[t] = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(prow + pc * kPixBytes));
        }
#pragma unroll
        for (int dj = 0; dj < K; ++dj) {
          const float2 wv = *reinterpret_cast<const float2*>(
              wds + (di * K + dj) * kChanTile + ch);
#pragma unroll
          for (int r = 0; r < kStrip; ++r) {
            dacc[r][0] = fmaf(v[r * S + dj].x, wv.x, dacc[r][0]);
            dacc[r][1] = fmaf(v[r * S + dj].y, wv.y, dacc[r][1]);
          }
        }
      }
      const int oh = oh0 + orow;
      const bool row_ok = (u / col_groups) * 4 + strip < tile_h && oh < out_h;
      float zv[kStrip][2];
      unsigned unsure = 0;
#pragma unroll
      for (int r = 0; r < kStrip; ++r) {
        const float va = affine(dacc[r][0], s1a, b1a);
        const float vb = affine(dacc[r][1], s1b, b1b);
        zv[r][0] = swish_fast(va);
        zv[r][1] = swish_fast(vb);
        unsure |= static_cast<unsigned>(pair_unsure(
                      va, zv[r][0], swish_slack(va, zv[r][0], 0.0f), vb,
                      zv[r][1], swish_slack(vb, zv[r][1], 0.0f)))
                  << r;
      }
      if (unsure != 0) {  // rare: the exact swish decides the rounding
#pragma unroll
        for (int r = 0; r < kStrip; ++r) {
          if (unsure & (1u << r)) {
            zv[r][0] = swish(affine(dacc[r][0], s1a, b1a));
            zv[r][1] = swish(affine(dacc[r][1], s1b, b1b));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kStrip; ++r) {
        const int ow = ow0 + ocol0 + r;
        const bool ok = row_ok && ocol0 + r < tile_w && ow < out_w;
        se0 += ok ? zv[r][0] : 0.0f;
        se1 += ok ? zv[r][1] : 0.0f;
        if (ok)
          *reinterpret_cast<__nv_bfloat162*>(
              z + ((static_cast<size_t>(b) * out_h + oh) * out_w + ow) * ce +
              c0 + ch) = __floats2bfloat162_rn(zv[r][0], zv[r][1]);
      }
    }
    // The four rows' sums of each channel, then one row per warp and slice.
    se0 += __shfl_xor_sync(0xffffffffu, se0, 8);
    se1 += __shfl_xor_sync(0xffffffffu, se1, 8);
    se0 += __shfl_xor_sync(0xffffffffu, se0, 16);
    se1 += __shfl_xor_sync(0xffffffffu, se1, 16);
    if (strip == 0) {
      red[warp * kChanTile + ch] = se0;
      red[warp * kChanTile + ch + 1] = se1;
    }
  }
  __syncthreads();
  if (tid < kChanTile) {
    float s = 0.0f;
    for (int i = 0; i < kWarps; ++i) s += red[i * kChanTile + tid];
    partial[(static_cast<size_t>(b) * num_tiles + tile) * ce + c0 + tid] = s;
  }
}

}  // namespace tc

// se[b, c] = sum over tiles (in order) of partial[b, tile, c] / (Ho * Wo).
__global__ void se_mean_kernel(const float* __restrict__ partial,
                               float* __restrict__ se, int num_tiles, int ce,
                               float count) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= ce) return;
  const float* p = partial + static_cast<size_t>(b) * num_tiles * ce + c;
  float s = 0.0f;
  for (int t = 0; t < num_tiles; ++t) s += p[static_cast<size_t>(t) * ce];
  se[static_cast<size_t>(b) * ce + c] = __fdiv_rn(s, count);
}

cudaError_t launch_se(const float* partial, void* se, int batch,
                      int num_tiles, int ce, int count, cudaStream_t stream) {
  const dim3 grid((ce + 255) / 256, batch);
  se_mean_kernel<<<grid, 256, 0, stream>>>(
      partial, static_cast<float*>(se), num_tiles, ce,
      static_cast<float>(count));
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int K, int S>
cudaError_t launch_f32(const float* x, const float* w_expand,
                       const float* s0, const float* b0, const float* w_dw,
                       const float* s1, const float* b1, float* z,
                       float* partial, int batch, int h, int w, int cin,
                       int ce, int out_h, int out_w, int pad_top,
                       int pad_left, int tile_h, int tile_w,
                       cudaStream_t stream) {
  const int tiles_w = (out_w + tile_w - 1) / tile_w;
  const int num_tiles = ((out_h + tile_h - 1) / tile_h) * tiles_w;
  const int patch = ((tile_h - 1) * S + K) * ((tile_w - 1) * S + K);
  const size_t smem = (float_smem(K) + static_cast<size_t>(patch) * kChanTile)
                      * sizeof(float);
  auto kernel = mbconv_fused_kernel<K, S>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((ce / kChanTile) * num_tiles, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      x, w_expand, s0, b0, w_dw, s1, b1, z, partial, h, w, cin, ce, out_h,
      out_w, pad_top, pad_left, tile_h, tile_w, tiles_w, num_tiles);
  return cudaGetLastError();
}

template <int K, int S>
cudaError_t launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* wp,
                        const float* s0, const float* b0, const float* w_dw,
                        const float* s1, const float* b1, tc::Depthwise dw,
                        __nv_bfloat16* z,
                        float* partial, int batch, int h, int w, int cin,
                        int cin_pad, int ce, int out_h, int out_w,
                        int pad_top, int pad_left, int tile_h, int tile_w,
                        int row_stride, int smem, cudaStream_t stream) {
  const int tiles_w = (out_w + tile_w - 1) / tile_w;
  const int num_tiles = ((out_h + tile_h - 1) / tile_h) * tiles_w;
  const int ph = (tile_h - 1) * S + K;
  const int pw = (tile_w - 1) * S + K;
  // The host's plan and this layout must agree to the byte.
  if (smem != tc::fixed_smem(K, cin_pad) + ph * row_stride ||
      row_stride < pw * tc::kPixBytes || row_stride % 16 != 0 ||
      cin_pad % 16 != 0 || cin_pad < cin)
    return cudaErrorInvalidValue;
  auto kernel = tc::mbconv_tc_kernel<K, S>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((ce / kChanTile) * num_tiles, batch);
  kernel<<<grid, tc::kThreads, smem, stream>>>(
      x, wp, s0, b0, w_dw, s1, b1, dw, z, partial, h, w, cin, cin_pad, ce,
      out_h, out_w, pad_top, pad_left, tile_h, tile_w, tiles_w, num_tiles,
      row_stride);
  return cudaGetLastError();
}

int num_tiles_of(int out_h, int out_w, int tile_h, int tile_w) {
  return ((out_h + tile_h - 1) / tile_h) * ((out_w + tile_w - 1) / tile_w);
}

}  // namespace

#define EDT_MBCONV_DISPATCH(LAUNCH, ...)                                  \
  (k == 3 && stride == 1)   ? LAUNCH<3, 1>(__VA_ARGS__)                   \
  : (k == 3 && stride == 2) ? LAUNCH<3, 2>(__VA_ARGS__)                   \
  : (k == 5 && stride == 1) ? LAUNCH<5, 1>(__VA_ARGS__)                   \
  : (k == 5 && stride == 2) ? LAUNCH<5, 2>(__VA_ARGS__)                   \
                            : cudaErrorInvalidValue

// float32: x (batch, h, w, cin), w_expand (cin, ce), scale0, bias0, scale1,
// bias1 (ce), w_dw (k*k, ce), z (batch, out_h, out_w, ce), all f32 and
// contiguous, x 16-byte aligned; partial (batch, tiles, ce) f32 scratch; se
// (batch, ce) f32. cin % 8 == 0, ce % 48 == 0, k in {3, 5}, stride in
// {1, 2}; the wrapper checks all of it. Launches the fused kernel and the
// SE reduction on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int edt_mbconv_fused_f32(
    const void* x, const void* w_expand, const void* scale0,
    const void* bias0, const void* w_dw, const void* scale1,
    const void* bias1, void* z, void* partial, void* se, int batch, int h,
    int w, int cin, int ce, int k, int stride, int out_h, int out_w,
    int pad_top, int pad_left, int tile_h, int tile_w, void* stream) {
  if (batch == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  const cudaError_t err = EDT_MBCONV_DISPATCH(
      launch_f32, static_cast<const float*>(x),
      static_cast<const float*>(w_expand), static_cast<const float*>(scale0),
      static_cast<const float*>(bias0), static_cast<const float*>(w_dw),
      static_cast<const float*>(scale1), static_cast<const float*>(bias1),
      static_cast<float*>(z), part, batch, h, w, cin, ce, out_h, out_w,
      pad_top, pad_left, tile_h, tile_w, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_se(part, se, batch, num_tiles_of(out_h, out_w, tile_h, tile_w),
                ce, out_h * out_w, st));
}

// bfloat16: x (batch, h, w, cin) and z bf16, contiguous; the expand weights
// packed (ce, cin_pad) bf16, each channel's cin weights (flat != 0: W_e s0,
// else W_e, rounded to bf16) then zeros up to cin_pad, cin rounded up to
// 16; scale0, bias0, scale1, bias1 (ce) f32 contiguous, BN0 and BN1 as the
// contract gives them (flat: the kernel takes scale 1 and bf16(bias0));
// w_dw (k, k, ce) f32 at strides dw_si, dw_sj, dw_sc in elements. tile_h,
// tile_w, row_stride (bytes between y's patch rows in shared memory) and
// smem (dynamic shared memory bytes) come from the host's tile plan, which
// this checks against its own layout.
extern "C" int edt_mbconv_fused_bf16(
    const void* x, const void* w_packed, const void* scale0,
    const void* bias0, const void* w_dw, const void* scale1,
    const void* bias1, void* z, void* partial, void* se, int flat,
    int dw_si, int dw_sj, int dw_sc, int batch, int h, int w, int cin,
    int cin_pad, int ce, int k, int stride, int out_h, int out_w,
    int pad_top, int pad_left, int tile_h, int tile_w, int row_stride,
    int smem, void* stream) {
  if (batch == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  const tc::Depthwise dw{dw_si, dw_sj, dw_sc, flat};
  const cudaError_t err = EDT_MBCONV_DISPATCH(
      launch_bf16, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w_packed),
      static_cast<const float*>(scale0), static_cast<const float*>(bias0),
      static_cast<const float*>(w_dw), static_cast<const float*>(scale1),
      static_cast<const float*>(bias1), dw, static_cast<__nv_bfloat16*>(z),
      part, batch, h, w, cin, cin_pad, ce, out_h, out_w, pad_top, pad_left,
      tile_h, tile_w, row_stride, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_se(part, se, batch, num_tiles_of(out_h, out_w, tile_h, tile_w),
                ce, out_h * out_w, st));
}
