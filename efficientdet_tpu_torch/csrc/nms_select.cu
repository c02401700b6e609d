// Greedy select-and-suppress NMS: one block per image orders the candidates,
// then walks them in windows of 512 sorted positions, building each window's
// IoU bit-mask in shared memory a word at a time ahead of a one-warp scan.
//
// Replaces: efficientdet_tpu/kernels/nms_kernel.py::nms_select_pallas
// (pallas_call body _nms_kernel), the TPU kernel that keeps 8 images as the
// 8 sublanes of (8, K) vector tiles in VMEM and runs D select-and-suppress
// steps over them.
//
// Bound on the H100: neither bytes nor FLOPs. An image reads K = 1000
// scores and boxes (20 KB) once; greedy NMS is a chain of up to D dependent
// decisions, and the IoU tests it needs depend on how deep into the sorted
// candidates the D keeps reach (on the serving path's inputs, a fraction of
// K). A block that runs the D steps directly (an argmax over K, barriers
// and an IoU pass with a divide per step) spends ~2 us per step on latency;
// a full K x K bit-mask built across the card does ~0.5 M IoU tests per
// image, while only the pairs among the candidates up to the D-th keep can
// change the result. This kernel keeps the chain short and does few tests
// off it: beyond each word's own and neighbouring blocks, only the kept rows
// are tested against later candidates.
//
// 1. Order. The P positive candidates are sorted by (score descending,
//    index ascending) as packed 64-bit keys in shared memory: the canonical
//    score bits in the high word (every score <= 0, -0.0 among them, maps to
//    0; -0.0's own bits would sort above every positive score) and K-1-j in
//    the low word. A bitonic sort whose stages with strides below 64 run in
//    registers with warp shuffles, so only the wider strides need a block
//    barrier (15 barriers at K = 1000 instead of 55). Input already in that
//    order, as the serving path's top-K hands it over, is detected with one
//    block-wide vote and not sorted. The sorted scores and original indices
//    stay in shared memory; each window gathers its boxes through them.
// 2. Masks, per window of 512 sorted positions, built by 15 "mask" warps
//    while the scan runs, word by word a few words ahead of it: each word's
//    32 x 32 diagonal block (bit j of row i: IoU(i, j) > threshold) and the
//    block above it (the previous word's rows) in full; from earlier words,
//    once the scan has decided them, only their kept rows' bits, OR-ed into
//    the word's removed bits (acc). The rows kept in earlier windows are
//    OR-ed in before the window starts (pre). The IoU
//    arithmetic is the reference's: clamped areas, _rn intrinsics (no FMA
//    contraction), the 1e-8 clamp and the strict '>'. The divide is
//    replaced by the signs of two fused multiply-adds, which decide the same
//    bit whenever they are finite and nonzero (iou_sure); the rest divide.
// 3. Scan, one warp, word by word: the word's removed bits are pre | acc
//    and the bits of the previous word's keeps (lane j tests column j
//    against each, then one ballot); its open positions are resolved in
//    rounds of two ballots over the symmetric diagonal block (a position is
//    kept once no kept or open earlier one suppresses it), and each keep
//    writes its (score, original index). The walk stops after D keeps or at
//    P; the block writes (0, 0) to the remaining slots.
//
// Semantics equal nms_select_plain and the JAX kernel bit for bit for
// unsorted input: the greedy argmax over the remaining scores visits the
// positive candidates in exactly the sorted order above, and a selected
// candidate suppresses only candidates after it in that order that are
// still live.
//
// Device memory: the inputs are read once (the boxes through the order,
// window by window) and the outputs written once; the only other is the
// caller's 64 bytes per image of cycle counters. Nothing is allocated here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCandidates = 8192;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kKeptChunk = 256;  // kept boxes staged per pass of the OR
// Sorted positions per window: the serving path's D = 100 keeps lie within
// the first window on its inputs (the counters count the windows walked);
// a window of 512 costs nothing where the scan stops early, as the masks
// are built only a few words ahead of it.
constexpr int kWindow = 512;
constexpr int kWords = kWindow / 32;
// Words of the window that the mask warps may run ahead of the scan.
constexpr int kLookahead = 8;
constexpr int kMaskWarps = kWarps - 1;  // warps beside the scan
typedef unsigned long long u64;

// Each image's SM cycles (order; window loads with the OR of the rows kept
// in earlier windows; masks with scan, which overlap; whole kernel), windows
// walked, and the scan's cycles spent waiting for the mask warps, 8 int64
// apiece.
constexpr int kCounters = 8;

// Keys sorted: a power of two, at least one warp's segment of 64.
__host__ __device__ inline int sort_size(int k) {
  int n = 64;
  while (n < k) n <<= 1;
  return n;
}

// Bytes of the shared memory that the sort's keys and, after them, the
// window arrays share.
__host__ __device__ inline size_t front_smem(int k) {
  const size_t keys = 8 * static_cast<size_t>(sort_size(k));
  // wbox, warea, diag, above1, above2, keep; kbox, karea; kstart, pre, acc.
  const size_t win =
      kWindow * 36 + kKeptChunk * 20 + 4 * (3 * kWords + 1);
  return keys > win ? keys : win;
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

// The sort key's high word: the bits of a positive score (which order as the
// scores do), 0 for every score <= 0.
__device__ __forceinline__ uint32_t score_bits(float s) {
  return s > 0.0f ? __float_as_uint(s) : 0u;
}

// The IoU's numerator and clamped denominator for boxes a and b, with the
// reference's arithmetic; symmetric in a and b bit for bit.
__device__ __forceinline__ void iou_terms(float4 a, float a_area, float4 b,
                                          float b_area, float& inter,
                                          float& denom) {
  const float iw = __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x));
  const float ih = __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y));
  inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
  denom = fmaxf(__fsub_rn(__fadd_rn(b_area, a_area), inter), 1e-8f);
}

// Whether __fdiv_rn(inter, denom) > t is decided without the divide, and
// if so its value; t_next is the float after t. Here denom >= 1e-8 > 0 and
// inter >= 0 (or NaN). lo = RN(inter - t denom): if lo < 0 then
// inter < t denom (RN keeps the sign), so inter / denom < t and its rounding
// is <= t (t is a float): false. hi = RN(inter - t_next denom): if hi > 0
// then inter / denom > t_next and its rounding is >= t_next > t: true. An
// infinite or NaN lo or hi (infinite inputs or threshold) and a quotient
// within [t, t_next] are left to the divide. tests/test_torch_port_nms.py
// holds the rule against the divide.
__device__ __forceinline__ bool iou_sure(float inter, float denom, float t,
                                         float t_next, bool& above) {
  const float lo = __fmaf_rn(-t, denom, inter);
  const float hi = __fmaf_rn(-t_next, denom, inter);
  above = hi > 0.0f && hi < INFINITY;
  return above || (lo < 0.0f && lo > -INFINITY);
}

// IoU(a, b) > t exactly, with the divide only where iou_sure leaves it.
__device__ __forceinline__ bool iou_above(float4 a, float a_area, float4 b,
                                          float b_area, float t,
                                          float t_next) {
  float inter, denom;
  iou_terms(a, a_area, b, b_area, inter, denom);
  bool above;
  if (iou_sure(inter, denom, t, t_next, above)) return above;
  return __fdiv_rn(inter, denom) > t;
}

// Row r's bits over the 32 columns from col: bit j is IoU(r, col + j) >
// threshold. Branch-free over the columns, which are shared-memory
// broadcasts; the rare columns the signs leave undecided are divided
// afterwards.
__device__ __forceinline__ uint32_t iou_word(const float4* box,
                                             const float* area, int r,
                                             int col, float t, float t_next) {
  const float4 a = box[r];
  const float a_area = area[r];
  uint32_t bits = 0, unsure = 0;
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {
    float inter, denom;
    iou_terms(a, a_area, box[col + j], area[col + j], inter, denom);
    bool above;
    const bool sure = iou_sure(inter, denom, t, t_next, above);
    bits |= static_cast<uint32_t>(above) << j;
    unsure |= static_cast<uint32_t>(!sure) << j;
  }
  while (unsure) {
    const int j = __ffs(unsure) - 1;
    unsure &= unsure - 1;
    float inter, denom;
    iou_terms(a, a_area, box[col + j], area[col + j], inter, denom);
    if (__fdiv_rn(inter, denom) > t) bits |= 1u << j;
  }
  return bits;
}

// Compare-exchanges of the descending bitonic sort. Each warp holds a
// 64-key segment in registers, key i of the segment in lane i % 32, element
// i / 32; `desc` is whether the pair's lower index keeps the larger key.
__device__ __forceinline__ void bitonic_swap(u64& x0, u64& x1, bool desc) {
  if ((x0 < x1) == desc) {  // the pair (i, i + 32), within a lane
    const u64 t = x0;
    x0 = x1;
    x1 = t;
  }
}

__device__ __forceinline__ u64 bitonic_lanes(u64 x, int stride, int lane,
                                             bool desc) {
  const u64 y = __shfl_xor_sync(kFull, x, stride);
  const bool keep_big = ((lane & stride) == 0) == desc;
  return (x < y) == keep_big ? y : x;
}

// Stages 2 .. 64 of the sort on every warp's 64-key segments.
__device__ void bitonic_sort_segments(u64* keys, int n, int warp, int lane) {
  for (int seg = warp; seg < n / 64; seg += kWarps) {
    const int i0 = seg * 64 + lane;
    u64 x0 = keys[i0], x1 = keys[i0 + 32];
#pragma unroll
    for (int ls = 1; ls <= 6; ++ls) {
      const int size = 1 << ls;
      const bool desc0 = (i0 & size) == 0, desc1 = ((i0 + 32) & size) == 0;
#pragma unroll
      for (int lt = ls - 1; lt >= 0; --lt) {
        if (lt == 5) {
          bitonic_swap(x0, x1, desc0);  // size 64: desc0 == desc1
        } else {
          x0 = bitonic_lanes(x0, 1 << lt, lane, desc0);
          x1 = bitonic_lanes(x1, 1 << lt, lane, desc1);
        }
      }
    }
    keys[i0] = x0;
    keys[i0 + 32] = x1;
  }
}

// Strides 32 .. 1 of stage `size` >= 128 on every warp's segments.
__device__ void bitonic_merge_segments(u64* keys, int n, int size, int warp,
                                       int lane) {
  for (int seg = warp; seg < n / 64; seg += kWarps) {
    const int i0 = seg * 64 + lane;
    const bool desc = ((seg * 64) & size) == 0;
    u64 x0 = keys[i0], x1 = keys[i0 + 32];
    bitonic_swap(x0, x1, desc);
#pragma unroll
    for (int lt = 4; lt >= 0; --lt) {
      x0 = bitonic_lanes(x0, 1 << lt, lane, desc);
      x1 = bitonic_lanes(x1, 1 << lt, lane, desc);
    }
    keys[i0] = x0;
    keys[i0 + 32] = x1;
  }
}

__global__ void __launch_bounds__(kThreads)
    nms_kernel(const float* __restrict__ scores,
               const float4* __restrict__ boxes,
               long long* __restrict__ cycles,
               float* __restrict__ out_scores, int* __restrict__ out_idx,
               int k, int max_det, float iou_threshold, float iou_next) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_npos;
  __shared__ int s_kept;
  __shared__ int s_stop;
  __shared__ int s_scanned;  // the last word the scan has decided
  __shared__ int s_ready[kWords];  // per word: its finished items
  __shared__ int s_item;              // the mask warps' next item
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t image = blockIdx.x;
  const size_t base = image * k;
  scores += base;
  boxes += base;
  out_scores += image * max_det;
  out_idx += image * max_det;
  const long long t_start = clock64();

  // ---- 1. order
  u64* keys = reinterpret_cast<u64*>(smem);
  const int n = sort_size(k);
  // The sorted scores and original indices, after the keys or the window
  // arrays, whichever is larger.
  float* s_score = reinterpret_cast<float*>(smem + front_smem(k));
  int* s_order = reinterpret_cast<int*>(s_score + k);
  if (tid == 0) {
    s_npos = 0;
    s_kept = 0;
  }
  __syncthreads();
  int positives = 0;
  for (int j = tid; j < n; j += kThreads) {
    const uint32_t bits = j < k ? score_bits(scores[j]) : 0u;
    positives += bits != 0u;
    keys[j] = j < k ? (static_cast<u64>(bits) << 32) |
                          static_cast<uint32_t>(k - 1 - j)
                    : 0ull;
  }
  if (positives) atomicAdd(&s_npos, positives);
  __syncthreads();
  bool in_order = true;
  for (int j = tid; j + 1 < k; j += kThreads) {
    if (keys[j] < keys[j + 1]) in_order = false;
  }
  // Padding keys (0) sort below every positive key, and only the first P
  // positions are read.
  if (!__syncthreads_and(in_order)) {
    bitonic_sort_segments(keys, n, warp, lane);
    __syncthreads();
    for (int size = 128; size <= n; size <<= 1) {
      for (int stride = size >> 1; stride >= 64; stride >>= 1) {
        for (int t = tid; t < n / 2; t += kThreads) {
          const int lo = 2 * t - (t & (stride - 1));
          const u64 a = keys[lo], b = keys[lo + stride];
          if ((a < b) == ((lo & size) == 0)) {
            keys[lo] = b;
            keys[lo + stride] = a;
          }
        }
        __syncthreads();
      }
      bitonic_merge_segments(keys, n, size, warp, lane);
      __syncthreads();
    }
  }
  const int npos = s_npos;
  for (int j = tid; j < npos; j += kThreads) {
    const u64 key = keys[j];
    s_order[j] = k - 1 - static_cast<int>(static_cast<uint32_t>(key));
    s_score[j] = __uint_as_float(static_cast<uint32_t>(key >> 32));
  }
  __syncthreads();  // the keys are dead; the window arrays take their place
  const long long t_order = clock64();

  // ---- 2 and 3, window by window
  float4* wbox = reinterpret_cast<float4*>(smem);
  float4* kbox = wbox + kWindow;
  float* warea = reinterpret_cast<float*>(kbox + kKeptChunk);
  float* karea = warea + kWindow;
  uint32_t* diag = reinterpret_cast<uint32_t*>(karea + kKeptChunk);
  uint32_t* above1 = diag + kWindow;    // row r's bits over the next word
  uint32_t* above2 = above1 + kWindow;  // and over the word after that
  int* keep = reinterpret_cast<int*>(above2 + kWindow);  // window's keeps
  int* kstart = keep + kWindow;  // per word: its first entry in keep
  uint32_t* pre = reinterpret_cast<uint32_t*>(kstart + kWords + 1);
  uint32_t* acc = pre + kWords;  // per word w: keeps of words <= w - 3
  long long load_cycles = 0, scan_cycles = 0, wait_cycles = 0;
  int windows = 0;
  int kept = 0;  // the scan warp's count; s_kept for the block
  for (int c0 = 0; c0 < npos; c0 += kWindow) {
    const int done = s_kept;
    if (done >= max_det) break;
    const long long t0 = clock64();
    const int nw = min(kWindow, npos - c0);
    for (int t = tid; t < kWindow; t += kThreads) {
      const bool in = t < nw;  // zero boxes past P: cheap, and never read
      const float4 b =
          in ? boxes[s_order[c0 + t]] : make_float4(0.f, 0.f, 0.f, 0.f);
      wbox[t] = b;
      warea[t] = box_area(b);
      if (t < kWords) {
        pre[t] = acc[t] = 0u;
        s_ready[t] = 0;
      }
      if (t == 0) kstart[0] = 0;
    }
    if (tid == 0) {
      s_stop = 0;
      s_scanned = -1;
      s_item = 0;
    }
    __syncthreads();
    // The rows kept in earlier windows: their bits over this window, OR-ed
    // per word into pre.
    for (int kc = 0; kc < done; kc += kKeptChunk) {
      const int nk = min(kKeptChunk, done - kc);
      for (int t = tid; t < nk; t += kThreads) {
        const float4 b = boxes[out_idx[kc + t]];  // an original index
        kbox[t] = b;
        karea[t] = box_area(b);
      }
      __syncthreads();
      // A word per warp, the lanes on its columns.
      for (int wd = warp; wd < kWords; wd += kWarps) {
        const float4 b = wbox[32 * wd + lane];
        const float b_area = warea[32 * wd + lane];
        bool hit = false;
        for (int q = 0; q < nk; ++q) {
          hit |= iou_above(kbox[q], karea[q], b, b_area, iou_threshold,
                           iou_next);
        }
        const unsigned word = __ballot_sync(kFull, hit);
        if (lane == 0) pre[wd] |= word;
      }
      __syncthreads();
    }
    const long long t1 = clock64();
    if (warp > 0) {
      // The mask warps, 15, over the items of each word wd in turn
      // (item c is (row word rw, wd), rw <= wd, handed out in that order to
      // whichever mask warp is free), at most kLookahead words ahead of the
      // scan: the diagonal block (rw = wd; lane r: row r's bits over its own
      // word) and the two blocks above it (rw = wd - 1, wd - 2) in full; for
      // rw <= wd - 3, once the scan has decided rw, only the bits of rw's
      // kept rows over wd, OR-ed into acc[wd]. s_ready[wd] counts the
      // finished items of wd.
      const int items = kWords * (kWords + 1) / 2;
      while (true) {
        int c = 0;  // the next item, to whichever mask warp is free first
        if (lane == 0) c = atomicAdd(&s_item, 1);
        c = __shfl_sync(kFull, c, 0);
        if (c >= items) break;
        int wd = 0;
        while ((wd + 1) * (wd + 2) / 2 <= c) ++wd;
        const int rw = c - wd * (wd + 1) / 2;
        const int col = 32 * wd;
        if (col >= nw) break;  // past P, never scanned
        bool stop;  // read by lane 0 for the whole warp
        while (true) {
          const int scanned = __shfl_sync(
              kFull, *reinterpret_cast<volatile int*>(&s_scanned), 0);
          stop = __shfl_sync(kFull, *reinterpret_cast<volatile int*>(&s_stop),
                             0);
          if (stop ||
              (wd <= scanned + kLookahead &&
               (rw + 3 > wd || rw <= scanned)))
            break;
          __nanosleep(128);
        }
        if (stop) break;
        if (rw == wd) {
          diag[col + lane] = iou_word(wbox, warea, col + lane, col,
                                      iou_threshold, iou_next);
        } else if (rw == wd - 1) {
          above1[col - 32 + lane] = iou_word(
              wbox, warea, col - 32 + lane, col, iou_threshold, iou_next);
        } else if (rw == wd - 2) {
          above2[col - 64 + lane] = iou_word(
              wbox, warea, col - 64 + lane, col, iou_threshold, iou_next);
        } else {
          // rw's keeps against wd's columns, four at a time and branch-free;
          // in the rare spread with an undecided pair, all again, exactly.
          __threadfence_block();
          const int q0 = kstart[rw], q1 = kstart[rw + 1];
          const float4 b = wbox[col + lane];
          const float b_area = warea[col + lane];
          bool hit = false, unsure = false;
          for (int q = q0; q < q1; q += 4) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = keep[min(q + i, q1 - 1)];
              float inter, denom;
              iou_terms(wbox[r], warea[r], b, b_area, inter, denom);
              bool above;
              const bool sure =
                  iou_sure(inter, denom, iou_threshold, iou_next, above);
              hit |= above;
              unsure |= !sure;
            }
          }
          if (unsure) {
            hit = false;
            for (int q = q0; q < q1; ++q)
              hit |= iou_above(wbox[keep[q]], warea[keep[q]], b, b_area,
                               iou_threshold, iou_next);
          }
          const unsigned word = __ballot_sync(kFull, hit);
          if (lane == 0 && word) atomicOr(&acc[wd], word);
        }
        __syncwarp();
        if (lane == 0) {
          __threadfence_block();
          atomicAdd(&s_ready[wd], 1);
        }
      }
    } else {
      // The scan, word by word.
      uint32_t prev1 = 0, prev2 = 0;  // the keeps of the two words before
      int kept_here = 0;              // keeps in this window
      for (int w = 0; w < kWords && 32 * w < nw && kept < max_det; ++w) {
        const long long tw = clock64();
        while (*reinterpret_cast<volatile int*>(&s_ready[w]) < w + 1) {
        }
        wait_cycles += clock64() - tw;
        __threadfence_block();
        // Removed: positions past P, the bits of the rows kept in earlier
        // windows (pre), in this window's words <= w - 3 (acc) and in words
        // w - 1 and w - 2 (the blocks above, one warp reduction).
        const int first = 32 * w;
        uint32_t removed = nw - first >= 32 ? 0u : kFull << (nw - first);
        removed |= pre[w] | acc[w];
        removed |= __reduce_or_sync(
            kFull, (prev1 >> lane & 1u ? above1[first - 32 + lane] : 0u) |
                       (prev2 >> lane & 1u ? above2[first - 64 + lane] : 0u));
        // Resolve the word's open positions in rounds. The diagonal block is
        // symmetric, so lane i's row d is also its column: bit j of d says
        // whether position j suppresses i. Position i is kept once no kept
        // or open j < i suppresses it and removed once a kept one does; the
        // lowest open position is decided in every round.
        const uint32_t d = diag[first + lane];
        const uint32_t below = (1u << lane) - 1u;
        uint32_t open = ~removed, kw = 0;
        while (open) {
          const bool mine = open >> lane & 1u;
          const uint32_t kept_now =
              __ballot_sync(kFull, mine && !(d & (kw | open) & below));
          const uint32_t dropped =
              __ballot_sync(kFull, mine && (d & kw & below));
          kw |= kept_now;
          open &= ~(kept_now | dropped);
        }
        while (__popc(kw) > max_det - kept) kw &= ~(0x80000000u >> __clz(kw));
        if (kw >> lane & 1u) {
          const int slot = __popc(kw & below);
          out_scores[kept + slot] = s_score[c0 + first + lane];
          out_idx[kept + slot] = s_order[c0 + first + lane];
          keep[kept_here + slot] = first + lane;
        }
        kept += __popc(kw);
        kept_here += __popc(kw);
        prev2 = prev1;
        prev1 = kw;
        __syncwarp();
        if (lane == 0) {
          kstart[w + 1] = kept_here;
          __threadfence_block();
          *reinterpret_cast<volatile int*>(&s_scanned) = w;
        }
        __syncwarp();
      }
      if (lane == 0) {
        s_kept = kept;
        *reinterpret_cast<volatile int*>(&s_stop) = 1;
      }
    }
    __syncthreads();
    const long long t2 = clock64();
    load_cycles += t1 - t0;
    scan_cycles += t2 - t1;
    ++windows;
  }

  for (int t = s_kept + tid; t < max_det; t += kThreads) {
    out_scores[t] = 0.0f;
    out_idx[t] = 0;
  }
  if (tid == 0) {
    long long* c = cycles + kCounters * image;
    c[0] = t_order - t_start;
    c[1] = load_cycles;
    c[2] = scan_cycles;
    c[3] = clock64() - t_start;
    c[4] = windows;
    c[5] = wait_cycles;
  }
}

}  // namespace

// scores (batch, k) f32, boxes (batch, k, 4) f32 x1y1x2y2, both contiguous,
// boxes 16-byte aligned; out_scores (batch, max_det) f32, out_idx (batch,
// max_det) i32; cycles (batch, 8) int64 receives each image's counters
// (kCounters). Returns cudaGetLastError() after the launch (0 on success),
// or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int edt_nms_select(const void* scores, const void* boxes,
                              void* out_scores, void* out_idx, void* cycles,
                              int batch, int k, int max_det,
                              float iou_threshold, void* stream) {
  if (batch < 0 || batch > 65535 || k < 1 || k > kMaxCandidates ||
      max_det < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  // The keys or the window arrays, then the sorted scores and indices.
  const size_t smem = front_smem(k) + 8 * static_cast<size_t>(k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const float4*>(boxes),
      static_cast<long long*>(cycles), static_cast<float*>(out_scores),
      static_cast<int*>(out_idx), k, max_det, iou_threshold,
      nextafterf(iou_threshold, INFINITY));
  return static_cast<int>(cudaGetLastError());
}
