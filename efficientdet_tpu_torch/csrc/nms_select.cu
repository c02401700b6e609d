// Greedy select-and-suppress NMS, one thread block per image.
//
// Replaces: efficientdet_tpu/kernels/nms_kernel.py::nms_select_pallas
// (pallas_call body _nms_kernel), the TPU kernel that keeps 8 images as the
// 8 sublanes of (8, K) vector tiles in VMEM.
//
// Bound on the H100: latency, not bytes or FLOPs. An image reads K = 1000
// scores and boxes (20 KB) once and runs D = 100 dependent steps, each a
// max over K values followed by one IoU pass over K boxes; the batch gives
// only B-way parallelism (B <= a few hundred blocks on 132 SMs).
//
// Design: the K scores, the 4 box planes and the K areas stay resident in
// shared memory for all D steps (6 * 4 * K bytes, 24 KB at K = 1000), so no
// step touches device memory except the two output words. Each step is one
// block-wide (max, lowest index) reduction, warp shuffles then one warp
// over the warp results, and one suppression pass. When the best remaining
// score is <= 0 nothing can change any more, so the block writes (0, 0) to
// the remaining slots and exits.
//
// Semantics equal the JAX kernel and ops/nms.py::select_and_suppress bit for
// bit: remaining = max(scores, 0); ties go to the lowest index; a step whose
// best score is <= 0 emits (0, 0) and suppresses nothing; the selected box
// always suppresses itself; the IoU denominator is clamped at 1e-8. The IoU
// arithmetic uses the _rn intrinsics so that nvcc cannot contract it into
// fused multiply-adds, which would round differently from the reference.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void keep_better(float& s, int& i, float s2,
                                            int i2) {
  if (s2 > s || (s2 == s && i2 < i)) {
    s = s2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_argmax(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float s2 = __shfl_down_sync(kFullMask, s, off);
    const int i2 = __shfl_down_sync(kFullMask, i, off);
    keep_better(s, i, s2, i2);
  }
}

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f),
                   fmaxf(__fsub_rn(y2, y1), 0.0f));
}

__global__ void __launch_bounds__(kThreads)
    nms_select_kernel(const float* __restrict__ scores,
                      const float4* __restrict__ boxes,
                      float* __restrict__ out_scores,
                      int* __restrict__ out_idx, int k, int max_det,
                      float iou_threshold) {
  extern __shared__ float smem[];
  float* remaining = smem;
  float* x1 = remaining + k;
  float* y1 = x1 + k;
  float* x2 = y1 + k;
  float* y2 = x2 + k;
  float* area = y2 + k;
  __shared__ float warp_score[kWarps];
  __shared__ int warp_index[kWarps];
  __shared__ float best_score;
  __shared__ int best_index;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t image = blockIdx.x;
  scores += image * k;
  boxes += image * k;
  out_scores += image * max_det;
  out_idx += image * max_det;

  for (int j = tid; j < k; j += kThreads) {
    remaining[j] = fmaxf(scores[j], 0.0f);
    const float4 b = boxes[j];
    x1[j] = b.x;
    y1[j] = b.y;
    x2[j] = b.z;
    y2[j] = b.w;
    area[j] = box_area(b.x, b.y, b.z, b.w);
  }
  __syncthreads();

  for (int d = 0; d < max_det; ++d) {
    // Each thread walks its indices in increasing order, so the strict '>'
    // keeps the lowest index among its equal maxima.
    float s = -1.0f;
    int i = k;
    for (int j = tid; j < k; j += kThreads) {
      const float v = remaining[j];
      if (v > s) {
        s = v;
        i = j;
      }
    }
    warp_argmax(s, i);
    if (lane == 0) {
      warp_score[warp] = s;
      warp_index[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      s = lane < kWarps ? warp_score[lane] : -1.0f;
      i = lane < kWarps ? warp_index[lane] : k;
      warp_argmax(s, i);
      if (lane == 0) {
        best_score = s;
        best_index = i;
      }
    }
    __syncthreads();
    const float bs = best_score;
    const int bi = best_index;
    if (!(bs > 0.0f)) {
      for (int t = d + tid; t < max_det; t += kThreads) {
        out_scores[t] = 0.0f;
        out_idx[t] = 0;
      }
      return;
    }
    if (tid == 0) {
      out_scores[d] = bs;
      out_idx[d] = bi;
    }
    const float bx1 = x1[bi], by1 = y1[bi], bx2 = x2[bi], by2 = y2[bi];
    const float b_area = area[bi];
    for (int j = tid; j < k; j += kThreads) {
      const float iw = __fsub_rn(fminf(bx2, x2[j]), fmaxf(bx1, x1[j]));
      const float ih = __fsub_rn(fminf(by2, y2[j]), fmaxf(by1, y1[j]));
      const float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
      const float denom =
          fmaxf(__fsub_rn(__fadd_rn(area[j], b_area), inter), 1e-8f);
      if (__fdiv_rn(inter, denom) > iou_threshold || j == bi) {
        remaining[j] = 0.0f;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// scores (batch, k) f32, boxes (batch, k, 4) f32 x1y1x2y2, both contiguous;
// out_scores (batch, max_det) f32, out_idx (batch, max_det) i32. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int edt_nms_select(const void* scores, const void* boxes,
                              void* out_scores, void* out_idx, int batch,
                              int k, int max_det, float iou_threshold,
                              void* stream) {
  if (batch == 0) return 0;
  const size_t smem = 6 * sizeof(float) * static_cast<size_t>(k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_select_kernel<<<batch, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const float4*>(boxes),
      static_cast<float*>(out_scores), static_cast<int*>(out_idx), k, max_det,
      iou_threshold);
  return static_cast<int>(cudaGetLastError());
}
