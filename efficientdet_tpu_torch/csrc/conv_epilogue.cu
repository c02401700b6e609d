// Kernel G: the epilogue of a conv on the serving path, in one pass:
//   out = T(act(f32(y) s + b  [+ f32(skip) s_skip + b_skip | + f32(skip)]))
// over the conv's output y, a channels_last map read as rows of C channels,
// one a pixel; s and b (and s_skip, b_skip) are frozen BatchNorms folded to a
// float32 affine, one value a channel. act is ReLU (the ResNet's), swish
// (x / (1 + exp(-x)), the EfficientNet's) or none (the EfficientNet's
// project conv). The skip is the block's identity input, or the downsample
// conv's raw output with its own BN's affine. T is bfloat16 (serving) or
// float32.
//
// Replaces no TPU kernel: the JAX package leaves these ops to XLA, which
// fuses them into the conv on the TPU. The port ran them as up to five
// eager passes a conv (BN, ReLU, the downsample's BN, the add, the ReLU;
// in the EfficientNet BN, swish, the add), each reading and writing the
// whole map in T.
//
// Bound on the H100: device-memory bytes. At RetinaNet's 800 x 1344 canvas,
// B = 8, the 49 passes of a ResNet-50 read y once, the skip once where there
// is one, and write the output once: 8.5 GB, 2.5 ms at 3.35 TB/s; the
// arithmetic is a few operations a byte. At EfficientDet-D7's 1636 px, B =
// 4, the 133 passes of its B6 backbone (the stem, 42 expanded blocks x 3,
// 3 unexpanded x 2) move 21.5 GB, 6.4 ms; swish adds an exp and a division
// an element, about 20 operations, still under the bytes' time.
//
// Layout of the work: a thread moves 16 bytes (8 bf16 or 4 f32 values of
// one pixel) a load and a store, so its channels are c0 .. c0 + 7 (or 3) of
// some pixel. The grid's threads are a multiple of the row's C / VEC
// vectors, and the grid strides by all of them, so a thread's channels
// never change: it reads its 8 (or 16) affine values into registers once,
// and the map is the only traffic. A block is a multiple of the row where
// the row has at most 512 vectors, else part of one (float32 above 2048
// channels: B5's and B6's widest blocks). The host's plan
// (kernels/conv_epilogue.py::epilogue_plan) for ReLU gives each thread 2
// vectors on a map of 6 or more for each thread the SMs hold, unless the
// skip has an affine of its own; else the grid is twice the threads the SMs
// hold, or fewer blocks where a thread would get under 8 vectors. Over
// RetinaNet's 49 passes that plan without its first rule read 0.835 of the
// bound, one vector a thread in a grid the SMs hold 0.815, two vectors a
// thread an iteration 0.795-0.809; the first rule read 0.835-0.842 at C2's
// 64-channel pass where the rest of the plan read 0.787-0.804, and in a
// downsample pass 0.78 against 0.87. Over D7's 133 passes (swish and none)
// that plan read 0.715; a swish thread loading two vectors an iteration,
// 8 in all, and a none thread 2, at every size, read 0.758 in a test
// kernel, the best of the grids tried (1 to 16 vectors a thread, one, two
// or four an iteration, a grid the SMs hold), and 0.765 as built here
// (measured on the H100).
//
// Semantics: every multiply and add is rounded on its own (__fmul_rn,
// __fadd_rn: never contracted into a fused multiply-add), in the order the
// plain version (kernels/conv_epilogue.py::conv_epilogue_plain) writes its
// PyTorch ops, and the result is rounded to T once, to nearest even. Swish
// is ATen's CUDA silu in float32, t / (1 + expf(-t)) with the precise expf
// and a rounded division (no fast-math, no __expf), so the two agree bit
// for bit.

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
// kAct: the activation. A swish thread loads two vectors (kIlp) before it
// computes either, so that its exp and division do not hold back the next
// load; the other activations load one at a time.
enum Act { kRelu = 0, kSwish = 1, kNone = 2 };

template <typename T, int kSkip, int kAct>
__global__ void __launch_bounds__(kMaxThreads) conv_epilogue_kernel(
    const T* __restrict__ y, const T* __restrict__ skip,
    const float* __restrict__ s, const float* __restrict__ b,
    const float* __restrict__ s2, const float* __restrict__ b2,
    T* __restrict__ out, int64_t vectors, int row_vectors) {
  using V = Vec16<T>;
  constexpr int N = V::kN;
  constexpr int kIlp = kAct == kSwish ? 2 : 1;
  const int c0 =
      static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) %
                       static_cast<unsigned>(row_vectors)) * N;
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
       v < vectors; v += kIlp * stride) {
    float a[kIlp][N], k[kIlp][N];
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      if (v + j * stride >= vectors) continue;
      V::load(y + (v + j * stride) * N, a[j]);
      if (kSkip) V::load(skip + (v + j * stride) * N, k[j]);
    }
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      if (v + j * stride >= vectors) continue;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float t = __fadd_rn(__fmul_rn(a[j][i], sc[i]), bi[i]);
        if (kSkip == 1) t = __fadd_rn(t, k[j][i]);
        if (kSkip == 2)
          t = __fadd_rn(t, __fadd_rn(__fmul_rn(k[j][i], sc2[i]), bi2[i]));
        if (kAct == kRelu)
          a[j][i] = t < 0.f ? 0.f : t;  // NaN passes, as torch.relu's
        else if (kAct == kSwish)
          a[j][i] = __fdiv_rn(t, __fadd_rn(1.f, expf(-t)));
        else
          a[j][i] = t;
      }
      V::store(out + (v + j * stride) * N, a[j]);
    }
  }
}

template <typename T, int kAct>
int launch_act(const T* y, const T* skip, const float* s, const float* b,
               const float* s2, const float* b2, T* out, int64_t vectors,
               int row_vectors, int threads, int blocks, cudaStream_t st) {
  if (skip == nullptr)
    conv_epilogue_kernel<T, 0, kAct><<<blocks, threads, 0, st>>>(
        y, skip, s, b, s2, b2, out, vectors, row_vectors);
  else if (s2 == nullptr)
    conv_epilogue_kernel<T, 1, kAct><<<blocks, threads, 0, st>>>(
        y, skip, s, b, s2, b2, out, vectors, row_vectors);
  else
    conv_epilogue_kernel<T, 2, kAct><<<blocks, threads, 0, st>>>(
        y, skip, s, b, s2, b2, out, vectors, row_vectors);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* y, const void* skip, const void* s, const void* b,
           const void* s2, const void* b2, void* out, int64_t numel,
           int channels, int act, int threads, int blocks, cudaStream_t st) {
  constexpr int N = Vec16<T>::kN;
  if (numel == 0) return 0;
  const int row_vectors = channels / N;
  if (channels < N || channels % N != 0 || numel % channels != 0 ||
      threads < 1 || threads > kMaxThreads || blocks < 1 ||
      static_cast<int64_t>(blocks) * threads % row_vectors != 0 ||
      act < kRelu || act > kNone)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* yt = static_cast<const T*>(y);
  const T* kt = static_cast<const T*>(skip);
  const float* sf = static_cast<const float*>(s);
  const float* bf = static_cast<const float*>(b);
  const float* s2f = static_cast<const float*>(s2);
  const float* b2f = static_cast<const float*>(b2);
  T* o = static_cast<T*>(out);
  const int64_t vectors = numel / N;
  if (act == kRelu)
    return launch_act<T, kRelu>(yt, kt, sf, bf, s2f, b2f, o, vectors,
                                row_vectors, threads, blocks, st);
  if (act == kSwish)
    return launch_act<T, kSwish>(yt, kt, sf, bf, s2f, b2f, o, vectors,
                                 row_vectors, threads, blocks, st);
  return launch_act<T, kNone>(yt, kt, sf, bf, s2f, b2f, o, vectors,
                              row_vectors, threads, blocks, st);
}

}  // namespace epilogue

// y, skip and out: numel values of the type (bf16 when is_bf16, else f32),
// rows of `channels`; skip may be null, and s2, b2 are null unless the
// skip has an affine of its own; act is epilogue::Act (0 ReLU, 1 swish, 2
// none).
extern "C" int edt_conv_epilogue(const void* y, const void* skip,
                                 const void* s, const void* b, const void* s2,
                                 const void* b2, void* out, int64_t numel,
                                 int channels, int is_bf16, int act,
                                 int threads, int blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return epilogue::launch<__nv_bfloat16>(y, skip, s, b, s2, b2, out, numel,
                                           channels, act, threads, blocks,
                                           st);
  return epilogue::launch<float>(y, skip, s, b, s2, b2, out, numel, channels,
                                 act, threads, blocks, st);
}
