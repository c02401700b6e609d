// Fused MBConv segment: expand 1x1 -> affine -> swish -> depthwise KxK
// (stride S, TF-SAME) -> affine -> swish, plus the f32 spatial mean of the
// result for the squeeze-excite. One kernel serves both TPU contracts.
//
// Replaces: efficientdet_tpu/kernels/mbconv_kernel.py::fused_expand_dw_flat
// (pallas_call body _kernel_flat) and ::fused_expand_dw (body _kernel). The
// two compute the same function and differ only in where BN0 rounds; the
// wrappers (kernels/mbconv_kernel.py) fold that into what they pass here:
//   y = swish(acc * scale + bias), acc = sum_c x_c * W[c]   (f32)
// flat: W = T(W_e * s0), scale = 1, bias = f32(T(b0)); v1: W = T(W_e),
// scale = s0, bias = b0 (T is the activation type).
//
// Bound on the H100: device-memory bytes on the unfused path. At D0@512,
// B = 32, block 1's expanded tensor is 32 x 256 x 256 x 96 bf16 = 403 MB;
// the unfused path writes it and reads it back (and more for the separate
// BN and swish passes). Here it never leaves the SM: each thread block owns
// a TOH x TOW output tile by 48 expanded channels, computes the expand for
// the tile's input patch (the halo is recomputed by the neighbours), keeps
// the bf16-rounded y of the whole patch in shared memory, and runs the
// depthwise window from there. What is left is x read once per channel
// tile (from L2 for all but the first) and z written once. The expand is an
// f32 FMA loop on CUDA cores (8 pixels x 4 channels per thread from shared
// memory), fed 8 input channels at a time; the next 8 are loaded into
// registers, still packed, while the current ones are multiplied, and the
// bf16 kernels are held to 4 blocks of 192 threads per SM (<= 85 registers)
// so that other blocks fill the waits. At the wide deep blocks (8 x 8 and
// 16 x 16 maps) the expand is compute-bound on CUDA cores and the kernel is
// slower than cuDNN's tensor-core 1x1 conv; tensor cores are a later step.
//
// Semantics equal the plain version (kernels/mbconv_kernel.py) up to the
// order of f32 sums: y is rounded to T before the depthwise, y is 0 in the
// padding ring (never swish(bias)), the two affines are separately rounded
// multiply and add (__fmul_rn/__fadd_rn, no contraction), the SE sum is over
// f32 z before its cast, over Ho x Wo. That sum is made deterministic: each
// block writes its tile's per-channel sum to `partial` and a second small
// kernel adds the tiles of an image in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 192;
constexpr int kChanTile = 48;                   // expanded channels per block
constexpr int kChanGroups = kChanTile / 4;      // 4 channels per thread
constexpr int kPixGroups = kThreads / kChanGroups;  // 16
constexpr int kPassPix = kPixGroups * 8;        // patch pixels per expand pass
constexpr int kChunk = 8;                       // Cin per staged chunk
constexpr int kXStride = kPassPix + 4;          // padded row, 16-byte aligned
constexpr int kOutBatch = 4;                    // depthwise outputs per step
static_assert(kChunk * kChanTile == 2 * kThreads, "2 weights per thread");
static_assert(kChunk == 8, "one 8-wide load per pixel and chunk");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 8 consecutive values, as loaded from a 16-byte aligned address and kept
// packed (4 registers for bf16) until they are unpacked to float.
template <typename T> struct Pack8 { float4 lo, hi; };
template <> struct Pack8<__nv_bfloat16> { uint4 v; };

__device__ __forceinline__ void fetch8(const float* p, Pack8<float>& r) {
  r.lo = reinterpret_cast<const float4*>(p)[0];
  r.hi = reinterpret_cast<const float4*>(p)[1];
}
__device__ __forceinline__ void fetch8(const __nv_bfloat16* p,
                                       Pack8<__nv_bfloat16>& r) {
  r.v = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void unpack8(const Pack8<float>& r, float* v) {
  v[0] = r.lo.x; v[1] = r.lo.y; v[2] = r.lo.z; v[3] = r.lo.w;
  v[4] = r.hi.x; v[5] = r.hi.y; v[6] = r.hi.z; v[7] = r.hi.w;
}
__device__ __forceinline__ void unpack8(const Pack8<__nv_bfloat16>& r,
                                        float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 4 consecutive values: 16 bytes (f32) or 8 bytes (bf16), aligned.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float swish(float v) {
  return v / (1.0f + expf(-v));
}

// Separately rounded v * scale + bias, as two tensor ops round it.
__device__ __forceinline__ float affine(float v, float scale, float bias) {
  return __fadd_rn(__fmul_rn(v, scale), bias);
}

// Shared memory, in floats: staged x chunk, staged W chunk, depthwise
// weights, the four affine vectors, the SE reduction rows; then y (T).
__host__ __device__ constexpr size_t float_smem(int k) {
  return static_cast<size_t>(kChunk) * kXStride + kChunk * kChanTile +
         k * k * kChanTile + 4 * kChanTile + kPixGroups * kChanTile;
}

// Blocks per SM the registers must allow: 4 for bf16 (the serving path),
// 2 for f32, whose 8-wide loads need more registers.
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 2 ? 4 : 2;

template <typename T, int K, int S>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>) mbconv_fused_kernel(
    const T* __restrict__ x, const T* __restrict__ w_expand,
    const float* __restrict__ scale0, const float* __restrict__ bias0,
    const float* __restrict__ w_dw, const float* __restrict__ scale1,
    const float* __restrict__ bias1, T* __restrict__ z,
    float* __restrict__ partial, int h, int w, int cin, int ce, int out_h,
    int out_w, int pad_top, int pad_left, int tile_h, int tile_w,
    int tiles_w, int num_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                              // [kChunk][kXStride]
  float* ws = xs + kChunk * kXStride;            // [kChunk][kChanTile]
  float* wds = ws + kChunk * kChanTile;          // [K*K][kChanTile]
  float* aff = wds + K * K * kChanTile;          // s0, b0, s1, b1
  float* red = aff + 4 * kChanTile;              // [kPixGroups][kChanTile]
  T* ys = reinterpret_cast<T*>(red + kPixGroups * kChanTile);

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
  const T* xb = x + static_cast<size_t>(b) * h * w * cin;

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
    const T* xsrc = nullptr;
    if (tid < kPassPix && pass0 + tid < patch) {
      const int r = row0 + (pass0 + tid) / pw;
      const int c = col0 + (pass0 + tid) % pw;
      if (r >= 0 && r < h && c >= 0 && c < w)
        xsrc = xb + (static_cast<size_t>(r) * w + c) * cin;
    }
    Pack8<T> xn;
    T wn[2];
    auto fetch = [&](int kc) {
      if (xsrc != nullptr) {
        fetch8(xsrc + kc, xn);
      } else {
        xn = Pack8<T>{};
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
        float v[kChunk];
        unpack8(xn, v);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) xs[j * kXStride + tid] = v[j];
      }
      ws[tid] = to_float(wn[0]);
      ws[tid + kThreads] = to_float(wn[1]);
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

template <typename T, int K, int S>
cudaError_t launch(const void* x, const void* w_expand, const float* scale0,
                   const float* bias0, const float* w_dw, const float* scale1,
                   const float* bias1, void* z, float* partial, int batch,
                   int h, int w, int cin, int ce, int out_h, int out_w,
                   int pad_top, int pad_left, int tile_h, int tile_w,
                   cudaStream_t stream) {
  const int tiles_h = (out_h + tile_h - 1) / tile_h;
  const int tiles_w = (out_w + tile_w - 1) / tile_w;
  const int num_tiles = tiles_h * tiles_w;
  const int num_ct = ce / kChanTile;
  const int patch = ((tile_h - 1) * S + K) * ((tile_w - 1) * S + K);
  const size_t smem =
      float_smem(K) * sizeof(float) +
      static_cast<size_t>(patch) * kChanTile * sizeof(T);
  auto kernel = mbconv_fused_kernel<T, K, S>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(num_ct * num_tiles, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_expand), scale0, bias0,
      w_dw, scale1, bias1, static_cast<T*>(z), partial, h, w, cin, ce, out_h,
      out_w, pad_top, pad_left, tile_h, tile_w, tiles_w, num_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int k, int stride, const void* x, const void* w_expand,
                     const float* s0, const float* b0, const float* w_dw,
                     const float* s1, const float* b1, void* z,
                     float* partial, int batch, int h, int w, int cin, int ce,
                     int out_h, int out_w, int pad_top, int pad_left,
                     int tile_h, int tile_w, cudaStream_t stream) {
#define EDT_MBCONV_CASE(KK, SS)                                              \
  if (k == KK && stride == SS)                                               \
    return launch<T, KK, SS>(x, w_expand, s0, b0, w_dw, s1, b1, z, partial, \
                             batch, h, w, cin, ce, out_h, out_w, pad_top,   \
                             pad_left, tile_h, tile_w, stream);
  EDT_MBCONV_CASE(3, 1)
  EDT_MBCONV_CASE(3, 2)
  EDT_MBCONV_CASE(5, 1)
  EDT_MBCONV_CASE(5, 2)
#undef EDT_MBCONV_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x (batch, h, w, cin) and w_expand (cin, ce) of one type (is_bf16 ? bf16 :
// f32), both contiguous and 16-byte aligned; scale0, bias0, scale1, bias1
// (ce) f32; w_dw (k*k, ce) f32; z (batch, out_h, out_w, ce) of x's type;
// partial (batch, tiles, ce) f32 scratch; se (batch, ce) f32. cin % 8 == 0,
// ce % kChanTile (48) == 0, k in {3, 5}, stride in {1, 2}; the wrapper
// checks all of it.
// Launches the fused kernel and the SE reduction on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int edt_mbconv_fused(const void* x, const void* w_expand,
                                const void* scale0, const void* bias0,
                                const void* w_dw, const void* scale1,
                                const void* bias1, void* z, void* partial,
                                void* se, int is_bf16, int batch, int h, int w,
                                int cin, int ce, int k, int stride, int out_h,
                                int out_w, int pad_top, int pad_left,
                                int tile_h, int tile_w, void* stream) {
  if (batch == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s0 = static_cast<const float*>(scale0);
  const float* b0 = static_cast<const float*>(bias0);
  const float* wd = static_cast<const float*>(w_dw);
  const float* s1 = static_cast<const float*>(scale1);
  const float* b1 = static_cast<const float*>(bias1);
  float* part = static_cast<float*>(partial);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(k, stride, x, w_expand, s0, b0, wd, s1,
                                        b1, z, part, batch, h, w, cin, ce,
                                        out_h, out_w, pad_top, pad_left,
                                        tile_h, tile_w, st)
              : dispatch<float>(k, stride, x, w_expand, s0, b0, wd, s1, b1, z,
                                part, batch, h, w, cin, ce, out_h, out_w,
                                pad_top, pad_left, tile_h, tile_w, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_tiles =
      ((out_h + tile_h - 1) / tile_h) * ((out_w + tile_w - 1) / tile_w);
  const dim3 grid((ce + 255) / 256, batch);
  se_mean_kernel<<<grid, 256, 0, st>>>(part, static_cast<float*>(se),
                                       num_tiles, ce,
                                       static_cast<float>(out_h * out_w));
  return static_cast<int>(cudaGetLastError());
}
