// Kernel G: the epilogue of a ResNet conv on the serving path, in one pass:
//   out = T(relu(f32(y) s + b  [+ f32(skip) s_skip + b_skip | + f32(skip)]))
// over the conv's output y, a channels_last map read as rows of C channels,
// one a pixel; s and b (and s_skip, b_skip) are frozen BatchNorms folded to a
// float32 affine, one value a channel. The skip is the block's identity
// input, or the downsample conv's raw output with its own BN's affine.
// T is bfloat16 (serving) or float32.
//
// Replaces no TPU kernel: the JAX package leaves these ops to XLA, which
// fuses them into the conv on the TPU. The port ran them as up to five
// eager passes a conv (BN, ReLU, the downsample's BN, the add, the ReLU),
// each reading and writing the whole map in T.
//
// Bound on the H100: device-memory bytes. At RetinaNet's 800 x 1344 canvas,
// B = 8, the 49 passes of a ResNet-50 read y once, the skip once where there
// is one, and write the output once: 8.5 GB, 2.5 ms at 3.35 TB/s; the
// arithmetic is a few operations a byte.
//
// Layout of the work: a thread moves 16 bytes (8 bf16 or 4 f32 values of
// one pixel) a load and a store, so its channels are c0 .. c0 + 7 (or 3) of
// some pixel. The block has a multiple of C / VEC threads, and the grid
// strides by a multiple of it too, so a thread's channels never change: it
// reads its 8 (or 16) affine values into registers once, and the map is
// the only traffic. The host's plan (kernels/conv_epilogue.py::
// epilogue_plan) gives each thread 2 vectors on a map of 6 or more for
// each thread the SMs hold, unless the skip has an affine of its own; else
// the grid is twice the threads the SMs hold, or fewer blocks where a
// thread would get under 8 vectors. Over the cell's 49 passes that plan
// without its first rule read 0.835 of the bound, one vector a thread in a
// grid the SMs hold 0.815, two vectors a thread an iteration 0.795-0.809;
// the first rule read 0.835-0.842 at C2's 64-channel pass where the rest
// of the plan read 0.787-0.804, and in a downsample pass 0.78 against 0.87
// (measured on the H100).
//
// Semantics: every multiply and add is rounded on its own (__fmul_rn,
// __fadd_rn: never contracted into a fused multiply-add), in the order the
// plain version (kernels/conv_epilogue.py::conv_epilogue_plain) writes its
// PyTorch ops, and the result is rounded to T once, to nearest even. The
// two agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace epilogue {

// At most 512 threads a block, so a thread may hold up to 128 registers.
constexpr int kMaxThreads = 512;

// 16 bytes of T as float32 values, and back.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float (&v)[kN]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ static void store(float* p, const float (&v)[kN]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&v)[kN]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[kN]) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// kSkip: 0 none, 1 the identity (added as it is), 2 with its own affine.
template <typename T, int kSkip>
__global__ void __launch_bounds__(kMaxThreads) conv_epilogue_kernel(
    const T* __restrict__ y, const T* __restrict__ skip,
    const float* __restrict__ s, const float* __restrict__ b,
    const float* __restrict__ s2, const float* __restrict__ b2,
    T* __restrict__ out, int64_t vectors, int row_vectors) {
  using V = Vec16<T>;
  constexpr int N = V::kN;
  const int c0 = static_cast<int>(threadIdx.x) % row_vectors * N;
  float sc[N], bi[N], sc2[N], bi2[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    sc[i] = s[c0 + i];
    bi[i] = b[c0 + i];
    if (kSkip == 2) {
      sc2[i] = s2[c0 + i];
      bi2[i] = b2[c0 + i];
    }
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       v < vectors; v += stride) {
    float a[N], k[N];
    V::load(y + v * N, a);
    if (kSkip) V::load(skip + v * N, k);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float t = __fadd_rn(__fmul_rn(a[i], sc[i]), bi[i]);
      if (kSkip == 1) t = __fadd_rn(t, k[i]);
      if (kSkip == 2)
        t = __fadd_rn(t, __fadd_rn(__fmul_rn(k[i], sc2[i]), bi2[i]));
      a[i] = t < 0.f ? 0.f : t;  // NaN passes, as torch.relu's
    }
    V::store(out + v * N, a);
  }
}

template <typename T>
int launch(const void* y, const void* skip, const void* s, const void* b,
           const void* s2, const void* b2, void* out, int64_t numel,
           int channels, int threads, int blocks, cudaStream_t st) {
  constexpr int N = Vec16<T>::kN;
  if (numel == 0) return 0;
  const int row_vectors = channels / N;
  if (channels < N || channels % N != 0 || numel % channels != 0 ||
      threads < 1 || threads > kMaxThreads || threads % row_vectors != 0 ||
      blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* yt = static_cast<const T*>(y);
  const T* kt = static_cast<const T*>(skip);
  const float* sf = static_cast<const float*>(s);
  const float* bf = static_cast<const float*>(b);
  const float* s2f = static_cast<const float*>(s2);
  const float* b2f = static_cast<const float*>(b2);
  T* o = static_cast<T*>(out);
  const int64_t vectors = numel / N;
  if (skip == nullptr)
    conv_epilogue_kernel<T, 0><<<blocks, threads, 0, st>>>(
        yt, kt, sf, bf, s2f, b2f, o, vectors, row_vectors);
  else if (s2 == nullptr)
    conv_epilogue_kernel<T, 1><<<blocks, threads, 0, st>>>(
        yt, kt, sf, bf, s2f, b2f, o, vectors, row_vectors);
  else
    conv_epilogue_kernel<T, 2><<<blocks, threads, 0, st>>>(
        yt, kt, sf, bf, s2f, b2f, o, vectors, row_vectors);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace epilogue

// y, skip and out: numel values of the type (bf16 when is_bf16, else f32),
// rows of `channels`; skip may be null, and s2, b2 are null unless the
// skip has an affine of its own.
extern "C" int edt_conv_epilogue(const void* y, const void* skip,
                                 const void* s, const void* b, const void* s2,
                                 const void* b2, void* out, int64_t numel,
                                 int channels, int is_bf16, int threads,
                                 int blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return epilogue::launch<__nv_bfloat16>(y, skip, s, b, s2, b2, out, numel,
                                           channels, threads, blocks, st);
  return epilogue::launch<float>(y, skip, s, b, s2, b2, out, numel, channels,
                                 threads, blocks, st);
}
