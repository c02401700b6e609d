// The MBConv block's tail after the fused expand + depthwise (kernel E):
// squeeze-excite gate, project 1x1 conv, its frozen BatchNorm and the skip,
// for one block of efficientnet-b0..b6 in bfloat16:
//   s    = bf16(se_mean)                                   (B, Ce)
//   r    = bf16(swish(bf16(bf16(W_r s) + b_r)))            (B, Cse)
//   gate = bf16(sigmoid(bf16(bf16(W_e r) + b_e)))          (B, Ce)
//   o    = bf16(sum_k bf16(gate_k z_k) W_p[n, k])          (B, Ho, Wo, Cout)
//   out  = bf16(bf16(o scale2 + bias2) + skip)             (skip where given)
// with every weight and bias rounded to bf16 as the module path's casts
// round them (`.to(x.dtype)`), here, inside the step, from the f32
// parameters: nothing is prepared outside it.
//
// Replaces no TPU kernel: the JAX package leaves these ops to XLA, which
// fuses them on the TPU. The port ran them as ~13 eager launches a block
// (casts, two SE convs, swish, sigmoid, the gate multiply over the whole
// expanded tensor, cuDNN's project conv, BN and the skip's add).
//
// Bound on the H100: device-memory bytes. At D0@512, B = 32, the 16 tails
// read z once (612 MB), write their outputs (163 MB), read the skips (52 MB)
// and the weights (3 MB): 0.83 GB, 0.25 ms at 3.35 TB/s; the project GEMMs
// are 26.8 GFLOP, 0.027 ms at the bf16 tensor-core peak. The gate multiply
// therefore never writes z back: it is applied to the A operand's fragments
// in registers, as they leave shared memory for the tensor cores.
//
// Two launches a block:
// - tail_gate_kernel: the gate, one cluster of 8 blocks an image. The SE
//   convs over the image's mean are 2 Ce Cse multiply-adds (1 M at b6's
//   widest), a chain of dependent reads rather than work, so the 8 blocks
//   share r's rows and the gate's channels (r passes between them through
//   distributed shared memory). Its sums (lanes over float4s of a row, then
//   a butterfly; the expand's Cse terms in order) round as the module
//   path's cuDNN convs do at all but a few gates in 10^4. The grid also
//   writes W_p in bf16 for the GEMM, inside the step. A launch of its own, and not a prologue of the GEMM's blocks,
//   because each of those would need the whole gate.
// - mbconv_tail_kernel<KC, MI, NJ>: the project GEMM, M = pixels, K = Ce,
//   N = Cout. 4 warps; a block owns one tile of 64 MI rows by 8 NJ output
//   channels and streams K through a ring of 4 cp.async stages of KC (32 up
//   to Ce 256, 64 above) channels of z and of W_p, in rows of 2 KC + 16
//   bytes (ldmatrix's and the B fragments' rows fall in distinct banks).
//   Rows are one image's pixels, or, for images of under 128 pixels, run
//   over the batch so that W_p is read once a tile and not once an image
//   (each m16 tile lies in one image, whose gate its fragments take).
//   mma.sync.m16n8k16 (bf16 in, f32 sum in the accumulator, k in order):
//   the work is nine times under the bytes, and 16-row tiles fit the
//   16-pixel images of the last block at B = 1, which wgmma's 64-row tiles
//   would pad fourfold. The epilogue rounds o, applies BN2 in f32 (one fused
//   multiply-add, as the module path's addcmul computes it) and rounds,
//   stages the tile in shared memory and writes it 16 bytes a lane, adding
//   the skip (read 16 bytes a lane) and rounding again. K is never split:
//   where there are too few blocks to fill the card (small images, B = 1),
//   the host's plan (kernels/mbconv_tail.py::tail_plan) splits N instead,
//   so every launch sums each output in one fixed order and gives the same
//   bits.
//
// Semantics: the plain version (kernels/mbconv_tail.py) runs the module
// path's ops. The kernel rounds where they round, and its GEMM sums as
// cuDNN's does: given the same gate, the two agree bit for bit (every D0
// tail at B = 1, 3 and 32 on the H100). The SE sums take another order than
// cuDNN's, so a gate may round to the other bf16 neighbour (a few in 10^4
// at b0's widest tail), and then that image's outputs may move by an ulp
// or two.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {
namespace tail {

namespace cg = cooperative_groups;

constexpr int kGateThreads = 256;
constexpr int kCluster = 8;            // gate blocks an image, one cluster
constexpr int kThreads = 128;          // the GEMM's 4 warps
constexpr int kStages = 4;

// A staged row of z or W_p: KC (32 or 64) expanded channels in bf16 and 16
// bytes, an odd number of 16-byte units, so that ldmatrix's eight rows and
// the B fragments' eight rows fall in distinct banks.
__host__ __device__ constexpr int row_bytes(int kc) { return kc * 2 + 16; }

// The GEMM's dynamic shared memory: the ring (per stage, 64 MI rows of z
// and 8 NJ rows of W_p), the gates of the n_img images a tile spans
// (chunks * kc bf16 each, zeros past Ce), the N tile's BN2 scale and bias,
// and the output tile staged for 16-byte stores (rows of 16 NJ + 16 bytes).
__host__ __device__ constexpr int smem_bytes(int mi, int nj, int kc,
                                             int chunks, int n_img) {
  return kStages * (64 * mi + 8 * nj) * row_bytes(kc) +
         n_img * chunks * kc * 2 + 2 * 8 * nj * 4 +
         64 * mi * (16 * nj + 16);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// swish and sigmoid in f32, as PyTorch's CUDA kernels compute them.
__device__ __forceinline__ float swish(float v) {
  return v / (1.0f + expf(-v));
}
__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Butterfly sum over the warp: the same order, and so the same bits, in
// every lane and on every launch.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One cluster of kCluster blocks an image. Block `rank` forms the rows j
// = rank (mod kCluster) of r (one warp a row, its lanes reading float4s of
// W_r over all of Ce, then a butterfly), the cluster's blocks read each
// other's r through distributed shared memory, and each block writes the
// gate of its slice of Ce (one channel a thread, summed over j in order,
// from W_e's rows of the slice, staged in shared memory with coalesced
// reads while r is formed, where they fit). Every block of the grid also
// converts its share of W_p to bf16 for the GEMM. s is kernel E's f32 SE
// mean, or (s_bf16) the bf16 mean of the unexpanded block's map. Each SE
// conv rounds its sum, then the add of its bias, as the module path's cuDNN
// conv and its separate bias add do.
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kGateThreads) tail_gate_kernel(
        const void* __restrict__ s, int s_bf16, const float* __restrict__ w_r,
        const float* __restrict__ b_r, const float* __restrict__ w_e,
        const float* __restrict__ b_e, const float* __restrict__ w_p,
        __nv_bfloat16* __restrict__ gate, __nv_bfloat16* __restrict__ wb,
        int batch, int ce, int cse, int cout, int stage_we) {
  extern __shared__ __align__(16) float gate_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kGateWarps = kGateThreads / 32;
  const int slice = (ce + kCluster - 1) / kCluster;
  const int c0 = min(ce, rank * slice), c1 = min(ce, c0 + slice);
  float* sv = gate_smem;   // [ce] bf16(s)
  float* rv = sv + ce;     // [cse] this block's rows of r
  float* ra = rv + cse;    // [cse] all of r
  float* we_s = ra + cse;  // [slice][cse + 1] W_e's rows of the slice

  // First what depends on nothing: W_p in bf16 (as `.to(x.dtype)` rounds
  // it, four weights a thread a step, all the grid's blocks sharing it out:
  // the clusters past the batch's do only this, so that at a small batch
  // it is not left to a few), the slice's rows of W_e, s.
  const size_t n4 = static_cast<size_t>(cout) * ce / 4;
  const size_t stride =
      static_cast<size_t>(gridDim.y) * kCluster * kGateThreads;
#pragma unroll 4
  for (size_t i =
           (static_cast<size_t>(b) * kCluster + rank) * kGateThreads + tid;
       i < n4; i += stride) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(w_p) + i);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(wb + 4 * i);
    dst[0] = __floats2bfloat162_rn(w.x, w.y);
    dst[1] = __floats2bfloat162_rn(w.z, w.w);
  }
  if (b >= batch) return;  // the whole cluster: no cluster.sync waits on it
  if (stage_we) {
    const float* src = w_e + static_cast<size_t>(c0) * cse;
#pragma unroll 8
    for (int i = tid; i < (c1 - c0) * cse; i += kGateThreads)
      we_s[i / cse * (cse + 1) + i % cse] = __ldg(src + i);
  }
  if (s_bf16) {
    const __nv_bfloat16* sb =
        static_cast<const __nv_bfloat16*>(s) + static_cast<size_t>(b) * ce;
#pragma unroll 4
    for (int k = tid; k < ce; k += kGateThreads)
      sv[k] = __bfloat162float(sb[k]);
  } else {
    const float* sf =
        static_cast<const float*>(s) + static_cast<size_t>(b) * ce;
#pragma unroll 4
    for (int k = tid; k < ce; k += kGateThreads) sv[k] = bf16_round(sf[k]);
  }
  __syncthreads();

  const float4* s4 = reinterpret_cast<const float4*>(sv);
  for (int j = rank + warp * kCluster; j < cse;
       j += kCluster * kGateWarps) {
    const float4* row =
        reinterpret_cast<const float4*>(w_r + static_cast<size_t>(j) * ce);
    const float bias_j = __ldg(b_r + j);
    float acc = 0.0f;
#pragma unroll 8
    for (int q = lane; q < ce / 4; q += 32) {
      const float4 w = __ldg(row + q), v = s4[q];
      acc = fmaf(bf16_round(w.x), v.x, acc);
      acc = fmaf(bf16_round(w.y), v.y, acc);
      acc = fmaf(bf16_round(w.z), v.z, acc);
      acc = fmaf(bf16_round(w.w), v.w, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0)
      rv[j] = bf16_round(
          swish(bf16_round(bf16_round(acc) + bf16_round(bias_j))));
  }
  cluster.sync();  // every block's rows of r are visible to the cluster
  for (int j = tid; j < cse; j += kGateThreads)
    ra[j] = cluster.map_shared_rank(rv, j % kCluster)[j];
  __syncthreads();

  for (int c = c0 + tid; c < c1; c += kGateThreads) {
    const float bias_c = __ldg(b_e + c);
    float acc = 0.0f;
    if (stage_we) {
      const float* row = we_s + (c - c0) * (cse + 1);
      for (int j = 0; j < cse; ++j)
        acc = fmaf(bf16_round(row[j]), ra[j], acc);
    } else {
      const float* row = w_e + static_cast<size_t>(c) * cse;
#pragma unroll 16
      for (int j = 0; j < cse; ++j)
        acc = fmaf(bf16_round(__ldg(row + j)), ra[j], acc);
    }
    gate[static_cast<size_t>(b) * ce + c] = __float2bfloat16_rn(
        sigmoid(bf16_round(bf16_round(acc) + bf16_round(bias_c))));
  }
  cluster.sync();  // no block leaves while another reads its rows of r
}

// Stage W_e's slice in the gate kernel's shared memory up to this size.
constexpr int kWeStageBytes = 32 * 1024;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 sum.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16(a * g) for a pair: the product rounded once, as a bf16 tensor
// multiply rounds it (the f32 product of two bf16 values is exact).
__device__ __forceinline__ unsigned mul_bf16x2(unsigned a, unsigned g) {
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(g),
      "r"(0x80008000u));
  return d;
}

__device__ __forceinline__ unsigned lds32(const void* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Rows are those of z flattened to (batch * pixels, Ce). Per image (packed
// == 0), a block's tiles are rows of image blockIdx.y; packed, the tiles
// run over the whole batch and a tile of small images holds several of
// them, whose gates the block keeps (each m16 tile lies within one image,
// as pixels % 16 == 0).
template <int KC, int MI, int NJ>
__global__ void __launch_bounds__(kThreads) mbconv_tail_kernel(
    const __nv_bfloat16* __restrict__ z,
    const __nv_bfloat16* __restrict__ gate,
    const __nv_bfloat16* __restrict__ wb, const float* __restrict__ scale,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ skip,
    __nv_bfloat16* __restrict__ out, int batch, int pixels, int ce, int cout,
    int m_tiles, int n_tiles, int packed, int n_img) {
  constexpr int BM = 64 * MI, BN = 8 * NJ, kRow = row_bytes(KC);
  constexpr int kOutRow = BN * 2 + 16;  // a staged output row, bytes
  constexpr int kUnits = KC / 8;  // 16-byte units of a staged row
  constexpr int kStageA = BM * kRow, kStage = (BM + BN) * kRow;
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunks = (ce + KC - 1) / KC;
  const int kpad = chunks * KC;
  __nv_bfloat16* gsm =
      reinterpret_cast<__nv_bfloat16*>(smem + kStages * kStage);
  float* vec = reinterpret_cast<float*>(gsm + n_img * kpad);  // s2, b2
  unsigned char* ostage =  // this warp's 16 MI output rows
      reinterpret_cast<unsigned char*>(vec + 2 * BN) +
      (threadIdx.x >> 5) * 16 * MI * kOutRow;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockIdx.x % n_tiles;  // the N tiles of an M tile are
  const int n0 = nt * BN;                // neighbours, sharing z in L2
  const int base = packed ? 0 : blockIdx.y * pixels;  // the image's first row
  const int row_end = packed ? batch * pixels : base + pixels;
  const int r0 = base + blockIdx.x / n_tiles * BM;    // the tile's first row
  const int img0 = r0 / pixels;

  // Step s: chunk s of K into stage s % kStages (an empty group past the
  // last, so that the group count stays fixed).
  auto issue = [&](int step) {
    if (step < chunks) {
      const int kc = step * KC;
      unsigned char* sa = smem + (step % kStages) * kStage;
#pragma unroll
      for (int u = 0; u < BM * kUnits / kThreads; ++u) {
        const int i = tid + kThreads * u, r = i / kUnits, q = i % kUnits;
        const int k = kc + 8 * q;
        const bool ok = r0 + r < row_end && k < ce;
        cp_async16(sa + r * kRow + q * 16,
                   ok ? z + static_cast<size_t>(r0 + r) * ce + k : z, ok);
      }
      unsigned char* sb = sa + kStageA;
      for (int i = tid; i < BN * kUnits; i += kThreads) {
        const int r = i / kUnits, q = i % kUnits;
        const int k = kc + 8 * q;
        const bool ok = n0 + r < cout && k < ce;
        cp_async16(sb + r * kRow + q * 16,
                   ok ? wb + static_cast<size_t>(n0 + r) * ce + k : wb, ok);
      }
    }
    cp_async_commit();
  };
  // The gates, 8 channels a copy, in the first stage's group.
  for (int i = tid; i < n_img * kpad / 8; i += kThreads) {
    const int img = img0 + i / (kpad / 8), k = i % (kpad / 8) * 8;
    const bool ok = img < batch && k < ce;
    cp_async16(gsm + 8 * i,
               ok ? gate + static_cast<size_t>(img) * ce + k : gate, ok);
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  for (int i = tid; i < BN; i += kThreads) {
    const bool ok = n0 + i < cout;
    vec[i] = ok ? scale[n0 + i] : 0.0f;
    vec[BN + i] = ok ? bias[n0 + i] : 0.0f;
  }

  const int g = lane >> 2, t4 = lane & 3;
  const int wr0 = r0 + warp * 16 * MI;  // this warp's first row
  float acc[MI][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][j][i] = 0.0f;

  for (int step = 0; step < chunks; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `step` landed for all; stage step - 1 is free
    issue(step + kStages - 1);
    const unsigned char* sa = smem + (step % kStages) * kStage;
    const unsigned char* sb = sa + kStageA;
    const int kc = step * KC;
    const __nv_bfloat16* gm[MI];  // the gate of each m16 tile's image
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      gm[mi] = gsm + min((wr0 + mi * 16) / pixels - img0, n_img - 1) * kpad;
    auto k16 = [&](int ks) {
      const int k = kc + ks * 16 + t4 * 2;
      unsigned bfr[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const unsigned char* brow = sb + (j * 8 + g) * kRow + (k - kc) * 2;
        bfr[j][0] = lds32(brow);
        bfr[j][1] = lds32(brow + 16);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const unsigned g0 = lds32(gm[mi] + k), g8 = lds32(gm[mi] + k + 8);
        unsigned a[4];
        ldmatrix_x4(sa + (warp * 16 * MI + mi * 16 + (lane & 15)) * kRow +
                        ks * 32 + (lane >> 4) * 16,
                    a);
        a[0] = mul_bf16x2(a[0], g0);  // rows g, g + 8 at k
        a[1] = mul_bf16x2(a[1], g0);
        a[2] = mul_bf16x2(a[2], g8);  // at k + 8
        a[3] = mul_bf16x2(a[3], g8);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_bf16(acc[mi][j], a, bfr[j][0],
                                              bfr[j][1]);
      }
    };
    if (kc + KC <= ce) {  // a whole chunk: its k16 steps unrolled
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) k16(ks);
    } else {
      for (int ks = 0; ks < (ce - kc + 15) / 16; ++ks) k16(ks);
    }

  }
  cp_async_wait<0>();

  // ---- the epilogue: o = bf16(acc) and BN2 into the warp's staged rows,
  // then 16 bytes a lane: the skip's add, the store.
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      unsigned char* orow = ostage + (mi * 16 + half * 8 + g) * kOutRow;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = j * 8 + t4 * 2;
        *reinterpret_cast<__nv_bfloat162*>(orow + c * 2) =
            __floats2bfloat162_rn(
                fmaf(bf16_round(acc[mi][j][half * 2]), vec[c],
                     vec[BN + c]),
                fmaf(bf16_round(acc[mi][j][half * 2 + 1]), vec[c + 1],
                     vec[BN + c + 1]));
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < (16 * MI * NJ + 31) / 32; ++u) {
    const int i = lane + 32 * u, rl = i / NJ, j = i % NJ;
    if (i >= 16 * MI * NJ || wr0 + rl >= row_end || n0 + j * 8 >= cout)
      continue;
    uint4 v = *reinterpret_cast<const uint4*>(ostage + rl * kOutRow +
                                              j * 16);
    const size_t off = static_cast<size_t>(wr0 + rl) * cout + n0 + j * 8;
    if (skip != nullptr) {
      const uint4 sk = __ldg(reinterpret_cast<const uint4*>(skip + off));
      __nv_bfloat162* vh = reinterpret_cast<__nv_bfloat162*>(&v);
      const __nv_bfloat162* sh =
          reinterpret_cast<const __nv_bfloat162*>(&sk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(vh[e]);
        const float2 b = __bfloat1622float2(sh[e]);
        vh[e] = __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
      }
    }
    *reinterpret_cast<uint4*>(out + off) = v;
  }
}

struct Args {
  const __nv_bfloat16* z;
  const __nv_bfloat16* gate;
  const __nv_bfloat16* wb;
  const float* scale;
  const float* bias;
  const __nv_bfloat16* skip;
  __nv_bfloat16* out;
  int batch, pixels, ce, cout, m_tiles, n_tiles, packed, n_img, smem;
};

template <int KC, int MI, int NJ>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = mbconv_tail_kernel<KC, MI, NJ>;
  if (a.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.m_tiles * a.n_tiles, a.packed ? 1 : a.batch);
  kernel<<<grid, kThreads, a.smem, stream>>>(
      a.z, a.gate, a.wb, a.scale, a.bias, a.skip, a.out, a.batch, a.pixels,
      a.ce, a.cout, a.m_tiles, a.n_tiles, a.packed, a.n_img);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const Args&, cudaStream_t);
#define EDT_TAIL_NJ(KC, MI)                                               \
  {launch<KC, MI, 1>, launch<KC, MI, 2>, launch<KC, MI, 3>,               \
   launch<KC, MI, 4>, launch<KC, MI, 5>, launch<KC, MI, 6>,               \
   launch<KC, MI, 7>, launch<KC, MI, 8>}
constexpr Launch kLaunch[2][2][8] = {
    {EDT_TAIL_NJ(32, 1), EDT_TAIL_NJ(32, 2)},
    {EDT_TAIL_NJ(64, 1), EDT_TAIL_NJ(64, 2)}};
#undef EDT_TAIL_NJ

}  // namespace tail
}  // namespace

// z (batch, pixels, ce) bf16 contiguous, 16-byte aligned; s (batch, ce) f32,
// or bf16 where s_bf16 != 0; w_r (cse, ce), b_r (cse), w_e (ce, cse), b_e
// (ce), w_p (cout, ce), scale and bias (cout), all f32 contiguous, w_r and w_p
// 16-byte aligned; skip (batch, pixels, cout) bf16 or null; scratch: gate
// (batch, ce) bf16 and wb (cout, ce) bf16, 16-byte aligned; out (batch,
// pixels, cout) bf16. ce % 8 == 0, cout % 8 == 0. kc, mi, nj, m_tiles,
// n_tiles, packed, n_img and smem come from the host's plan
// (kernels/mbconv_tail.py::tail_plan), which this checks against its own
// layout. Launches the gate kernel and the GEMM on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int edt_mbconv_tail_bf16(
    const void* z, const void* s, const void* w_r, const void* b_r,
    const void* w_e, const void* b_e, const void* w_p, const void* scale,
    const void* bias, const void* skip, void* gate, void* wb, void* out,
    int s_bf16, int batch, int pixels, int ce, int cse, int cout, int kc,
    int mi, int nj, int m_tiles, int n_tiles, int packed,
    int n_img, int smem, void* stream) {
  using namespace tail;
  if (batch == 0) return 0;
  if (kc != 32 && kc != 64) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (ce + kc - 1) / kc;
  const int bm = 64 * mi;
  const int rows = packed ? batch * pixels : pixels;
  if (mi < 1 || mi > 2 || nj < 1 || nj > 8 || ce % 8 != 0 || cout % 8 != 0 ||
      cse < 1 || m_tiles != (rows + bm - 1) / bm ||
      n_tiles * 8 * nj < cout || (n_tiles - 1) * 8 * nj >= cout ||
      (packed && pixels % 16 != 0) ||
      n_img != (packed ? min(batch, (bm - 1) / pixels + 2) : 1) ||
      smem != smem_bytes(mi, nj, kc, chunks, n_img))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* g = static_cast<__nv_bfloat16*>(gate);
  __nv_bfloat16* w = static_cast<__nv_bfloat16*>(wb);
  const int stage = (ce + kCluster - 1) / kCluster * (cse + 1) * 4;
  const int stage_we = stage <= kWeStageBytes;
  // Clusters enough that W_p's bf16 copy takes about 4 float4 a thread.
  const int copy = (cout * ce / 4 + 4 * kCluster * kGateThreads - 1) /
                   (4 * kCluster * kGateThreads);
  tail_gate_kernel<<<dim3(kCluster, max(batch, copy)), kGateThreads,
                     (ce + 2 * cse) * 4 + (stage_we ? stage : 0), st>>>(
      s, s_bf16, static_cast<const float*>(w_r),
      static_cast<const float*>(b_r), static_cast<const float*>(w_e),
      static_cast<const float*>(b_e), static_cast<const float*>(w_p), g, w,
      batch, ce, cse, cout, stage_we);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args args{static_cast<const __nv_bfloat16*>(z),
                  g,
                  w,
                  static_cast<const float*>(scale),
                  static_cast<const float*>(bias),
                  static_cast<const __nv_bfloat16*>(skip),
                  static_cast<__nv_bfloat16*>(out),
                  batch, pixels, ce, cout, m_tiles, n_tiles, packed, n_img,
                  smem};
  err = kLaunch[kc == 64][mi - 1][nj - 1](args, st);
  return static_cast<int>(err);
}
