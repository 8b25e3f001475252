// K3/K4/K5 in float32: the generator's residual-block chain at 64
// channels, NHWC, on Hopper's tensor cores at float32 accuracy (3xTF32).
// (In bfloat16: resblock_chain_mma.cu.)
//
// Per block:  x <- x + conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2,
// SAME (zero) padding, the conv1 output zeroed outside the image, float32
// accumulation.
//
// Replaces tecogan_tpu/kernels/resblocks.py::_chain_kernel (K3, launched by
// _fused_chain_single) and its pair-packed forms _paired_kernel (K4) and
// _paired_kernel_v2 (K5). All three compute the same function; the pair
// packing and shifted copies of K4/K5 exist to fill the TPU's 128-lane
// matrix unit and to align Mosaic loads, and have no counterpart here.
//
// Bound on the card: arithmetic. A block is 2 x 9 x 64 x 64 MACs per pixel
// (75 kFLOP) against 512 bytes in and out per pixel, so it is compute-bound
// at any shape; at the training shape, (4,32,32,64), a launch is only 0.60
// GFLOP, so it is bound by how much of the card its tiles keep busy. TF32
// alone keeps about three decimal digits, too few for training's 1e-3
// GPU-vs-CPU gradient gate, so every product is taken as three TF32
// products: with hi = tf32(a) and lo = tf32(a - hi) (cvt.rna's rounding),
// a b ~ a_hi b_hi + (a_hi b_lo + a_lo b_hi), the dropped a_lo b_lo being
// ~2^-22 of a b.
//
// Design. A cluster of kCluster = 4 CTAs owns one 8x16-pixel output
// tile, each CTA a quarter of the 64 channels. A CTA loads the x tile with
// its 2-px halo by cp.async (zero-fill outside the image), computes conv1
// for its 16 y channels over the haloed region and keeps them in
// registers; after a cluster barrier (every CTA is running and done with
// its x tile) it zeroes y outside the image (SAME padding of conv2 sees
// zeros there, not relu(b1)) and stores its quarter into the y tile of
// every CTA of the cluster through distributed shared memory, the y tile
// taking the x tile's place. One more cluster barrier and each CTA holds
// all 64 y channels; it computes conv2 for its 16 output channels, adds the
// skip (read again from x, in L2 by then) and b2, and stores. The
// training shape's 32 tiles of 8x16 px so run as 128 CTAs on 132 SMs (one
// CTA a tile would leave 100 idle).
//
// Each conv is an implicit GEMM in warp-level mma.sync.m16n8k8 (tf32 in,
// f32 accumulate): the A fragment of tap (dy, dx) is the tile shifted by
// (dy, dx), one ldmatrix row address per lane (an 8x4 float32 block is an
// 8x8 b16 block); B comes by ldmatrix from (c_out, c_in) weight rows. The
// weights go through a ring of 3 taps (conv1's 9, then conv2's): each tap
// loads the weights of the tap two ahead from global memory before its
// MMAs and stores them, already split into hi and lo rows, after them, so
// conv2's weights arrive while conv1 runs and no inner loop splits B.
// The A fragments are split as they load (shared memory holds one float32
// copy of the tiles), in integer ops that round as cvt.rna does, once per
// tap for both n8 tiles of the CTA's 16 channels: a warp computes all 16
// channels of its m16 tiles over one half of the input channels, and the
// two warps of an m16 tile then swap halves through shared memory the conv
// no longer reads, each finishing one n8 tile. A warp issues all the
// ldmatrix loads of a 16-channel k step before it splits and multiplies
// them, and the big product and the two small ones accumulate apart and
// meet once at the end. Rows are padded to 68 floats, so 8 consecutive
// rows fall on 8 distinct 16-byte bank groups. 91 KB of shared memory:
// two CTAs fit on an SM, 62 clusters on an H100.
// tests/test_torch_chain_f32_plan.py emulates this plan in numpy and reads
// the constexpr lines below.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int C = 64;                     // channels (the kernel is specialised)
constexpr int TH = 8, TW = 16;            // output tile; one m16 tile per tile row
constexpr int XH = TH + 4, XW = TW + 4;   // x tile with a 2-px halo
constexpr int YH = TH + 2, YW = TW + 2;   // conv1 region with a 1-px halo
constexpr int PS = C + 4;                 // floats per pixel / weight row in shared memory
constexpr int kCluster = 4;               // CTAs per output tile
constexpr int CQ = C / kCluster;          // output channels of a CTA (16)
constexpr int KG = 2;                     // input-channel halves; a warp sums over one
constexpr int M_STEP = 4;                 // a warp's m16 tiles are M_STEP apart
constexpr int kWarps = M_STEP * KG;
constexpr int kThreads = 32 * kWarps;
constexpr int Y_PX = YH * YW;             // 180
constexpr int M1 = (Y_PX + 15) / 16;      // conv1 m16 tiles (12; tail rows clamped)
constexpr int M2 = TH;                    // conv2 m16 tiles (8; one per tile row)
constexpr int M1_W = M1 / M_STEP;         // conv1 m16 tiles per warp (3)
constexpr int M2_W = M2 / M_STEP;         // conv2 m16 tiles per warp (2)
constexpr int NT = CQ / 8;                // n8 tiles of a CTA; every warp computes all (2)
constexpr int KC_W = C / 16 / KG;         // 16-channel k steps of a warp per tap (2)
constexpr int STAGES = 3;                 // weight taps in the ring
constexpr int TAPS = 18;                  // 9 of conv1, then 9 of conv2
constexpr int XS = XH * XW * PS, YS = Y_PX * PS;  // floats
constexpr int WSLOT = 2 * CQ * PS;        // a ring slot: one tap's hi rows, then its lo rows
constexpr int WS = STAGES * WSLOT;
constexpr size_t SMEM_BYTES = (XS + WS) * sizeof(float);
static_assert(M1 % M_STEP == 0 && M2 % M_STEP == 0, "m16 tiles split evenly");
static_assert(YS <= XS, "the y tile fits where the x tile was");
static_assert(NT == 2 && KG == 2, "after the exchange, k half g finishes n8 tile g");
static_assert(kThreads * 4 == C * CQ, "a thread stages 4 weights of a tap");
static_assert((PS * sizeof(float)) % 128 == 16, "rows step one 16-byte bank group");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// cvt.rna.tf32.f32 in two integer ops: half a TF32 ulp added to the
// magnitude's bits, the 13 bits below TF32 cleared (to nearest, ties away
// from zero; the sign bit is untouched).
__device__ __forceinline__ uint32_t tf32_rna(uint32_t u) { return (u + 0x1000u) & 0xffffe000u; }

// hi = tf32(v), lo = tf32(v - hi).
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__float_as_uint(__uint_as_float(v) - __uint_as_float(hi)));
}

// d += a (16x8, row) * b (8x8, col), tf32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 4 weights of ring tap t (conv1's 9, then conv2's) that this thread
// stages: input channel threadIdx.x / 4, this CTA's output channels
// c0 + 4 (threadIdx.x % 4) ... + 3; w is (9, C_in, C_out).
__device__ __forceinline__ float4 load_tap(const float* __restrict__ w1,
                                           const float* __restrict__ w2, int t, int c0) {
  const float* w = t < 9 ? w1 + t * C * C : w2 + (t - 9) * C * C;
  return *reinterpret_cast<const float4*>(w + (threadIdx.x / 4) * C + c0 +
                                          (threadIdx.x % 4) * 4);
}

// Those 4 weights, split, into a ring slot as (c_out - c0, c_in) rows: hi
// rows first, lo rows CQ * PS floats after.
__device__ __forceinline__ void store_tap(float* slot, float4 v) {
  const int ci = threadIdx.x / 4, n = (threadIdx.x % 4) * 4;
  const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t hi, lo;
    split_tf32(__float_as_uint(w[k]), hi, lo);
    slot[(n + k) * PS + ci] = __uint_as_float(hi);
    slot[(CQ + n + k) * PS + ci] = __uint_as_float(lo);
  }
}

// One conv's 9 taps (ring taps t0 .. t0 + 8) over input channels 16 kc0 ..
// 16 (kc0 + KC_W) - 1: acc[i][j] = the m16 tile whose lane-row addresses
// are a_row[i] (tap (0, 0)) times n8 tile j of the CTA's weights. ROW is
// the source tile's width in pixels. On entry the ring holds taps t0 and
// t0 + 1, visible to all; each tap loads tap t + 2's weights from global
// memory before its MMAs and stores them, split, into the slot of tap
// t - 1 after them, then meets the CTA at a barrier.
template <int NM, int ROW>
__device__ __forceinline__ void conv_taps(float (&acc)[NM][NT][4], const uint32_t (&a_row)[NM],
                                          float* ring, uint32_t b_lane, int t0, int kc0,
                                          const float* __restrict__ w1,
                                          const float* __restrict__ w2, int c0) {
  float small[NM][NT][4];
#pragma unroll
  for (int i = 0; i < NM; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = small[i][j][e] = 0.0f;
    }
  }
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int t = t0 + tap;
    const float4 ahead = t + 2 < TAPS ? load_tap(w1, w2, t + 2, c0) : make_float4(0, 0, 0, 0);
    const uint32_t shift = ((tap / 3) * ROW + tap % 3) * PS * sizeof(float);
    const uint32_t wb = smem_addr(ring + (t % STAGES) * WSLOT) + b_lane;
#pragma unroll
    for (int kk = 0; kk < KC_W; ++kk) {
      const int kc = kc0 + kk;
      // All loads of the k step first. B of n8 tile j (hi, lo): registers
      // 0, 1 for k 16kc..16kc+7, 2, 3 after; A: k8 step ks of m16 tile i.
      uint32_t bh[NT][4], bl[NT][4], a[2][NM][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        ldsm_x4(bh[j], wb + (j * 8 * PS + kc * 16) * sizeof(float));
        ldsm_x4(bl[j], wb + ((CQ + j * 8) * PS + kc * 16) * sizeof(float));
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
        for (int i = 0; i < NM; ++i) {
          ldsm_x4(a[ks][i], a_row[i] + shift + (kc * 16 + ks * 8) * sizeof(float));
        }
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
        for (int i = 0; i < NM; ++i) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(a[ks][i][e], ah[e], al[e]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            mma_tf32(small[i][j], al, bh[j][2 * ks], bh[j][2 * ks + 1]);
            mma_tf32(acc[i][j], ah, bh[j][2 * ks], bh[j][2 * ks + 1]);
            mma_tf32(small[i][j], ah, bl[j][2 * ks], bl[j][2 * ks + 1]);
          }
        }
      }
    }
    if (t + 2 < TAPS) store_tap(ring + ((t + 2) % STAGES) * WSLOT, ahead);
    __syncthreads();  // tap t + 2 is in place; everyone is done with tap t
  }
#pragma unroll
  for (int i = 0; i < NM; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += small[i][j][e];
    }
  }
}

// The two k halves of an m16 tile's sums meet: the warp of k half kg
// hands its other n8 tile to its partner through `scratch` (free shared
// memory, lanes contiguous) and adds the partner's n8 tile kg to its own.
// Afterwards acc[i][0] holds the whole sum of n8 tile kg (registers are
// indexed by compile-time constants only, so kg picks by comparison).
// conv_taps' last barrier has freed the conv's source tile for `scratch`;
// the caller's next barrier frees it again.
template <int NM>
__device__ __forceinline__ void exchange_halves(float (&acc)[NM][NT][4], float* scratch,
                                                int kg) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int partner = warp ^ M_STEP;  // same m16 tiles, the other k half
#pragma unroll
  for (int i = 0; i < NM; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      scratch[((warp * NM + i) * 4 + e) * 32 + lane] = kg == 0 ? acc[i][1][e] : acc[i][0][e];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NM; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[i][0][e] = (kg == 0 ? acc[i][0][e] : acc[i][1][e]) +
                     scratch[((partner * NM + i) * 4 + e) * 32 + lane];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
resblock_kernel_tf32x3(const float* __restrict__ src, float* __restrict__ dst,
                       const float* __restrict__ w1, const float* __restrict__ b1,
                       const float* __restrict__ w2, const float* __restrict__ b2, int H,
                       int W) {
  extern __shared__ __align__(16) float smem[];
  float* ys = smem;  // (Y_PX, PS): all 64 y channels, from the 4 CTAs, once
                     // conv1 is done with the x tile (XH, XW, PS) here
  float* ring = smem + XS;  // STAGES slots of WSLOT floats
  const uint32_t xs_a = smem_addr(smem), ys_a = xs_a;

  cg::cluster_group cluster = cg::this_cluster();
  const int c0 = static_cast<int>(cluster.block_rank()) * CQ;  // this CTA's channels
  const int tx0 = (blockIdx.x / kCluster) * TW, ty0 = blockIdx.y * TH;
  const int64_t plane = static_cast<int64_t>(blockIdx.z) * H * W * C;
  const float* img = src + plane;
  float* out = dst + plane;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mw = warp % M_STEP;              // first m16 tile of the warp
  const int kg = warp / M_STEP;              // its input-channel half; it finishes n8 tile kg
  const int n = c0 + kg * 8 + 2 * (lane % 4);  // its accumulator column pair, after the exchange
  const int g = lane / 4;                    // its accumulator row
  // ldmatrix lane addresses. A: row lane % 16 of the m16 tile, k offset
  // (lane / 16) * 4. B: weight row lane % 8 of an n8 tile, k offset
  // (lane / 8) * 4, within a ring slot.
  const int a_k = (lane / 16) * 4;
  const uint32_t b_lane = ((lane % 8) * PS + (lane / 8) * 4) * sizeof(float);

  // Ring taps 0 and 1, then the x tile (zeros outside the image).
  store_tap(ring, load_tap(w1, w2, 0, c0));
  store_tap(ring + WSLOT, load_tap(w1, w2, 1, c0));
  for (int i = threadIdx.x; i < XH * XW * (C / 4); i += kThreads) {
    const int px = i / (C / 4), chunk = i % (C / 4);
    const int gy = ty0 - 2 + px / XW, gx = tx0 - 2 + px % XW;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const float* from = inside ? img + (static_cast<int64_t>(gy) * W + gx) * C + chunk * 4 : img;
    cp_async16(xs_a + (px * PS + chunk * 4) * sizeof(float), from, inside ? 16 : 0);
  }
  cp_async_wait_all();
  __syncthreads();

  // conv1 over the haloed region: y pixel p at (p / YW, p % YW) reads x tile
  // pixel (p / YW + dy, p % YW + dx). Rows past Y_PX repeat the last pixel.
  float acc1[M1_W][NT][4];
  {
    uint32_t a_row[M1_W];
#pragma unroll
    for (int i = 0; i < M1_W; ++i) {
      const int p = min((mw + M_STEP * i) * 16 + lane % 16, Y_PX - 1);
      a_row[i] = xs_a + (((p / YW) * XW + p % YW) * PS + a_k) * sizeof(float);
    }
    conv_taps<M1_W, XW>(acc1, a_row, ring, b_lane, 0, kg * KC_W, w1, w2, c0);
  }
  exchange_halves<M1_W>(acc1, smem, kg);
  // Every CTA of the cluster is running and done with its x tile: y may
  // go to the peers.
  cluster.sync();
  {
    // y = relu(acc + b1), zero outside the image, into the y tile of every
    // CTA of the cluster (this one's included).
    float* peer[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) peer[r] = cluster.map_shared_rank(ys, r);
    const float2 bias = *reinterpret_cast<const float2*>(b1 + n);
#pragma unroll
    for (int i = 0; i < M1_W; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (mw + M_STEP * i) * 16 + g + 8 * h;
        if (p >= Y_PX) continue;
        const int gy = ty0 - 1 + p / YW, gx = tx0 - 1 + p % YW;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const float2 y = inside ? make_float2(fmaxf(acc1[i][0][2 * h] + bias.x, 0.0f),
                                              fmaxf(acc1[i][0][2 * h + 1] + bias.y, 0.0f))
                                : make_float2(0.0f, 0.0f);
#pragma unroll
        for (int r = 0; r < kCluster; ++r) {
          *reinterpret_cast<float2*>(peer[r] + p * PS + n) = y;
        }
      }
    }
  }
  cluster.sync();  // all y quarters are in place

  // conv2: output pixel (r, c) of the tile reads y pixel (r + dy, c + dx);
  // m16 tile r is tile row r.
  {
    uint32_t a_row[M2_W];
#pragma unroll
    for (int i = 0; i < M2_W; ++i) {
      a_row[i] = ys_a + (((mw + M_STEP * i) * YW + lane % 16) * PS + a_k) * sizeof(float);
    }
    float acc[M2_W][NT][4];
    conv_taps<M2_W, YW>(acc, a_row, ring, b_lane, 9, kg * KC_W, w1, w2, c0);
    exchange_halves<M2_W>(acc, smem, kg);
    // out = skip + acc + b2, the skip read again from x.
    const float2 bias = *reinterpret_cast<const float2*>(b2 + n);
#pragma unroll
    for (int i = 0; i < M2_W; ++i) {
      const int gy = ty0 + mw + M_STEP * i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gx = tx0 + g + 8 * h;
        if (gy >= H || gx >= W) continue;
        const int64_t at = (static_cast<int64_t>(gy) * W + gx) * C + n;
        const float2 skip = *reinterpret_cast<const float2*>(img + at);
        *reinterpret_cast<float2*>(out + at) = make_float2(
            skip.x + acc[i][0][2 * h] + bias.x, skip.y + acc[i][0][2 * h + 1] + bias.y);
      }
    }
  }
}

// > 48 KB of dynamic shared memory needs an opt-in.
cudaError_t opt_in() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      resblock_kernel_tf32x3, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  done = e == cudaSuccess;
  return e;
}

// A launch of `grid` (a multiple of kCluster along x) in clusters of
// kCluster CTAs along x.
struct ClusterLaunch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config;
  ClusterLaunch(dim3 grid, cudaStream_t s) : attr{}, config{} {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kCluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    config.gridDim = grid;
    config.blockDim = dim3(kThreads, 1, 1);
    config.dynamicSmemBytes = SMEM_BYTES;
    config.stream = s;
    config.attrs = &attr;
    config.numAttrs = 1;
  }
};

}  // namespace

// x, buf_a, buf_b: (B, H, W, 64) float32; w1, w2: (N, 9, 64, 64) as (tap,
// in, out); b1, b2: (N, 64). Block i writes buf_a when i is even and buf_b
// when odd, so the result is in buf_a for odd N and in buf_b for even N. x
// is only read. Every pointer 16-byte aligned.
extern "C" int tt_resblock_chain_f32(const void* x, void* buf_a, void* buf_b,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, int B, int H, int W, int N,
                                     void* stream) {
  const cudaError_t e = opt_in();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B == 0 || H == 0 || W == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(kCluster * ((W + TW - 1) / TW), (H + TH - 1) / TH, B);
  const ClusterLaunch launch(grid, static_cast<cudaStream_t>(stream));
  const float* cur = static_cast<const float*>(x);
  const float* w1p = static_cast<const float*>(w1);
  const float* b1p = static_cast<const float*>(b1);
  const float* w2p = static_cast<const float*>(w2);
  const float* b2p = static_cast<const float*>(b2);
  for (int i = 0; i < N; ++i) {
    float* out = static_cast<float*>(i % 2 == 0 ? buf_a : buf_b);
    cudaError_t err = cudaLaunchKernelEx(
        &launch.config, resblock_kernel_tf32x3, cur, out,
        w1p + static_cast<int64_t>(i) * 9 * C * C, b1p + i * C,
        w2p + static_cast<int64_t>(i) * 9 * C * C, b2p + i * C, H, W);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cur = out;
  }
  return static_cast<int>(cudaSuccess);
}

// The kernel's cluster size and how many of its clusters can be resident
// on the card at once at its shared memory and registers.
extern "C" int tt_resblock_chain_f32_clusters(int* cluster_size, int* clusters) {
  const cudaError_t e = opt_in();
  if (e != cudaSuccess) return static_cast<int>(e);
  *cluster_size = kCluster;
  const ClusterLaunch launch(dim3(kCluster * 132, 1, 1), nullptr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, resblock_kernel_tf32x3, &launch.config));
}
