// K3/K4/K5 in bfloat16: the generator's residual-block chain on Hopper's
// tensor cores, one launch per block, NHWC at 64 channels.
//
// Per block:  x <- x + conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2, SAME
// (zero) padding; the conv1 output is zeroed outside the image and rounded
// to bfloat16; float32 accumulation and one rounding to bfloat16 per block
// output. These are the rounding points of
// tecogan_tpu/kernels/resblocks.py::_chain_kernel (:127-144), which this
// kernel replaces in bfloat16 together with its pair-packed forms
// _paired_kernel (K4) and _paired_kernel_v2 (K5); the float32 chain stays
// on the CUDA cores (resblock_chain.cu).
//
// Bound on the card: at batch 1 and 144x180 a launch is 3.82 GFLOP of
// useful work on 216 output tiles of 8x16 px, so it is bound by latency and
// by how many tiles run at once, not by the tensor cores' rate. A kernel on
// the CUDA cores tops out near the 67 TFLOP/s float32 rate; bfloat16 x
// bfloat16 products are exact in float32, so tensor cores with float32
// accumulation change only the order of the sums.
//
// Design. Each conv is an implicit GEMM: M = the pixels of the tile, N = 64
// output channels, K = 9 taps x 64 input channels, in warp-level
// mma.sync.m16n8k16 (bf16 in, f32 accumulate). The A fragment of tap
// (dy, dx) is the tile shifted by (dy, dx): ldmatrix takes one row (pixel)
// address per lane, so the nine shifted views cost no copy. Shared memory
// holds bfloat16 with pixels (and weight rows) padded to 72 channels, 144 B,
// so 8 consecutive rows fall on 8 distinct 16-byte bank groups. The x tile
// with its 2-px halo arrives by cp.async (zero-fill outside the image: SAME
// padding without a branch). Weights stay in their HWIO (c_in, c_out) rows
// and go to the B fragments through ldmatrix.trans, through a 3-tap cp.async
// ring that runs on through both convs: tap t+2 loads while tap t's MMAs
// run, one barrier per tap. conv1 covers the 10x18 haloed region as 12 m16
// tiles (tail rows clamped to the last pixel, never stored), conv2 the 8x16
// outputs as 8 (one per tile row); each warp owns one half of the output
// channels and 3 (conv1) or 2 (conv2) m16 tiles. 88 KB of shared memory and
// at most 128 registers give 2 blocks per SM: the 216 tiles of a 144x180
// frame run in one wave on 132 SMs.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int C = 64;                     // channels (the kernel is specialised)
constexpr int TH = 8, TW = 16;            // output tile; one m16 tile per tile row
constexpr int XH = TH + 4, XW = TW + 4;   // x tile with a 2-px halo
constexpr int YH = TH + 2, YW = TW + 2;   // conv1 region with a 1-px halo
constexpr int PS = C + 8;                 // bf16 per pixel / weight row in shared memory
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int Y_PX = YH * YW;             // 180
constexpr int M1 = (Y_PX + 15) / 16;      // conv1 m16 tiles (12; tail rows clamped)
constexpr int M2 = TH;                    // conv2 m16 tiles (8; one per tile row)
constexpr int NH = 2;                     // output-channel halves; a warp owns one
constexpr int M_STEP = kWarps / NH;       // a warp's m16 tiles are M_STEP apart
constexpr int M1_W = M1 / M_STEP;         // conv1 m16 tiles per warp (3)
constexpr int M2_W = M2 / M_STEP;         // conv2 m16 tiles per warp (2)
constexpr int NT = C / NH / 8;            // n8 tiles per warp (4)
constexpr int STAGES = 3;                 // weight taps in the ring
constexpr int TAPS = 18;                  // 9 of conv1, then 9 of conv2
constexpr int XS = XH * XW * PS, YS = Y_PX * PS, WS = C * PS;  // elements
constexpr size_t SMEM_BYTES = (XS + YS + STAGES * WS) * sizeof(bf16);
static_assert(M1 % M_STEP == 0 && M2 % M_STEP == 0, "m16 tiles split evenly");
static_assert(TW == 16, "conv2 maps one tile row to one m16 tile");
static_assert((PS * sizeof(bf16)) % 128 == 16, "rows step one 16-byte bank group");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Tap t of the 18 (conv1's 9, then conv2's), (C_in, C_out) rows -> a ring
// slot with rows PS apart; two 16-byte copies per thread.
__device__ __forceinline__ void stage_tap(uint32_t slot, const bf16* __restrict__ w1,
                                          const bf16* __restrict__ w2, int t) {
  const bf16* w = t < 9 ? w1 + t * C * C : w2 + (t - 9) * C * C;
#pragma unroll
  for (int i = threadIdx.x; i < C * C / 8; i += kThreads) {
    const int row = i / 8, chunk = i % 8;
    cp_async16(slot + (row * PS + chunk * 8) * sizeof(bf16), w + row * C + chunk * 8, 16);
  }
}

// One conv's 9 taps (ring taps t0..t0+8): acc[i][j] += the m16 tile whose
// lane-row addresses are a_row[i] (tap (0, 0)) times the n8 tile j of this
// warp. ROW is the source tile's width in pixels. On entry the ring holds
// (or is loading) taps t0 and t0+1; each tap waits for its own copies,
// meets the block at a barrier (after which the slot of tap t-1 is free),
// starts tap t+2 into it and runs its MMAs.
template <int NM, int ROW>
__device__ __forceinline__ void conv_taps(float (&acc)[NM][NT][4], const uint32_t (&a_row)[NM],
                                          uint32_t ring, uint32_t b_lane, int t0,
                                          const bf16* __restrict__ w1,
                                          const bf16* __restrict__ w2) {
#pragma unroll
  for (int i = 0; i < NM; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
  }
  constexpr uint32_t kSlot = WS * sizeof(bf16);
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int t = t0 + tap;
    cp_async_wait_1();  // this thread's copies of tap t (and the x tile) have landed
    __syncthreads();    // everyone's have, and everyone is done with tap t - 1
    if (t + 2 < TAPS) stage_tap(ring + ((t + 2) % STAGES) * kSlot, w1, w2, t + 2);
    cp_async_commit();  // one group per tap, empty at the end: the count stays uniform
    const uint32_t ws = ring + (t % STAGES) * kSlot + b_lane;
    const uint32_t shift = ((tap / 3) * ROW + tap % 3) * PS * sizeof(bf16);
#pragma unroll
    for (int kc = 0; kc < C / 16; ++kc) {
      uint32_t b[NT][2];
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        ldsm_x4_trans(r, ws + (kc * 16 * PS + j * 8) * sizeof(bf16));
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < NM; ++i) {
        uint32_t a[4];
        ldsm_x4(a, a_row[i] + shift + kc * 16 * sizeof(bf16));
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
resblock_kernel_mma(const bf16* __restrict__ src, bf16* __restrict__ dst,
                    const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                    const bf16* __restrict__ w2, const bf16* __restrict__ b2, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // (XH, XW, PS)
  bf16* ys = xs + XS;                         // (Y_PX, PS)
  const uint32_t xs_a = smem_addr(xs), ys_a = smem_addr(ys), ring = smem_addr(ys + YS);

  const int tx0 = blockIdx.x * TW, ty0 = blockIdx.y * TH;
  const int64_t plane = static_cast<int64_t>(blockIdx.z) * H * W * C;
  const bf16* img = src + plane;
  bf16* out = dst + plane;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mw = warp / NH;                  // first m16 tile of this warp
  const int n0 = (warp % NH) * (C / NH);     // first output channel of this warp
  const int g = lane / 4, c2 = 2 * (lane % 4);  // accumulator row, column pair
  // ldmatrix lane addresses. A: row lane % 16 of the m16 tile, k half lane / 16.
  // B (trans): k row 8 * ((lane / 8) % 2) + lane % 8, n8 tile lane / 16.
  const int a_k = (lane / 16) * 8;
  const uint32_t b_lane =
      ((((lane / 8) % 2) * 8 + lane % 8) * PS + n0 + (lane / 16) * 8) * sizeof(bf16);

  // Group 0: the x tile (zeros outside the image) and tap 0; group 1: tap 1.
  for (int i = threadIdx.x; i < XH * XW * (C / 8); i += kThreads) {
    const int px = i / (C / 8), chunk = i % (C / 8);
    const int gy = ty0 - 2 + px / XW, gx = tx0 - 2 + px % XW;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const bf16* from = inside ? img + (static_cast<int64_t>(gy) * W + gx) * C + chunk * 8 : img;
    cp_async16(xs_a + (px * PS + chunk * 8) * sizeof(bf16), from, inside ? 16 : 0);
  }
  stage_tap(ring, w1, w2, 0);
  cp_async_commit();
  stage_tap(ring + WS * sizeof(bf16), w1, w2, 1);
  cp_async_commit();

  // conv1 over the haloed region: y pixel p at (p / YW, p % YW) reads x tile
  // pixel (p / YW + dy, p % YW + dx). Rows past Y_PX repeat the last pixel.
  {
    uint32_t a_row[M1_W];
#pragma unroll
    for (int i = 0; i < M1_W; ++i) {
      const int p = min((mw + M_STEP * i) * 16 + lane % 16, Y_PX - 1);
      a_row[i] = xs_a + (((p / YW) * XW + p % YW) * PS + a_k) * sizeof(bf16);
    }
    float acc[M1_W][NT][4];
    conv_taps<M1_W, XW>(acc, a_row, ring, b_lane, 0, w1, w2);
    // y = relu(acc + b1), zero outside the image (conv2's SAME padding sees
    // zeros there, not relu(b1)), rounded to bf16. conv2's first barrier
    // orders these stores before its loads.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + j * 8 + c2;
      const float2 bias = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + n));
#pragma unroll
      for (int i = 0; i < M1_W; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = (mw + M_STEP * i) * 16 + g + 8 * h;
          if (p >= Y_PX) continue;
          const int gy = ty0 - 1 + p / YW, gx = tx0 - 1 + p % YW;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
          const float v0 = inside ? fmaxf(acc[i][j][2 * h] + bias.x, 0.0f) : 0.0f;
          const float v1 = inside ? fmaxf(acc[i][j][2 * h + 1] + bias.y, 0.0f) : 0.0f;
          *reinterpret_cast<__nv_bfloat162*>(ys + p * PS + n) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }

  // conv2: output pixel (r, c) of the tile reads y pixel (r + dy, c + dx);
  // m16 tile r is tile row r.
  {
    uint32_t a_row[M2_W];
#pragma unroll
    for (int i = 0; i < M2_W; ++i) {
      a_row[i] = ys_a + (((mw + M_STEP * i) * YW + lane % 16) * PS + a_k) * sizeof(bf16);
    }
    float acc[M2_W][NT][4];
    conv_taps<M2_W, YW>(acc, a_row, ring, b_lane, 9, w1, w2);
    // out = skip + acc + b2, the skip read from the bf16 x tile; rounded once.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + j * 8 + c2;
      const float2 bias = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + n));
#pragma unroll
      for (int i = 0; i < M2_W; ++i) {
        const int r = mw + M_STEP * i, gy = ty0 + r;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = g + 8 * h, gx = tx0 + c;
          if (gy >= H || gx >= W) continue;
          const float2 skip = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xs + ((r + 2) * XW + c + 2) * PS + n));
          *reinterpret_cast<__nv_bfloat162*>(out + (static_cast<int64_t>(gy) * W + gx) * C + n) =
              __floats2bfloat162_rn(skip.x + acc[i][j][2 * h] + bias.x,
                                    skip.y + acc[i][j][2 * h + 1] + bias.y);
        }
      }
    }
  }
}

// > 48 KB of dynamic shared memory needs an opt-in; the carveout preference
// asks for the whole 228 KB so that 2 blocks fit on an SM.
cudaError_t opt_in() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(resblock_kernel_mma,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(SMEM_BYTES));
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(resblock_kernel_mma, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  done = e == cudaSuccess;
  return e;
}

}  // namespace

// x, buf_a, buf_b: (B, H, W, 64) bfloat16; w1, w2: (N, 9, 64, 64) as
// (tap, in, out); b1, b2: (N, 64). Block i writes buf_a when i is even and
// buf_b when odd. x is only read. Every pointer 16-byte aligned.
extern "C" int tt_resblock_chain_bf16(const void* x, void* buf_a, void* buf_b,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* b2, int B, int H, int W, int N,
                                      void* stream) {
  const cudaError_t e = opt_in();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B == 0 || H == 0 || W == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* cur = static_cast<const bf16*>(x);
  const bf16* w1p = static_cast<const bf16*>(w1);
  const bf16* b1p = static_cast<const bf16*>(b1);
  const bf16* w2p = static_cast<const bf16*>(w2);
  const bf16* b2p = static_cast<const bf16*>(b2);
  for (int i = 0; i < N; ++i) {
    bf16* next = static_cast<bf16*>(i % 2 == 0 ? buf_a : buf_b);
    resblock_kernel_mma<<<grid, kThreads, SMEM_BYTES, s>>>(
        cur, next, w1p + static_cast<int64_t>(i) * 9 * C * C, b1p + i * C,
        w2p + static_cast<int64_t>(i) * 9 * C * C, b2p + i * C, H, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cur = next;
  }
  return static_cast<int>(cudaSuccess);
}

// Resident blocks of the kernel per SM at its shared memory and registers.
extern "C" int tt_resblock_chain_bf16_blocks_per_sm(int* blocks) {
  const cudaError_t e = opt_in();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, resblock_kernel_mma, kThreads, SMEM_BYTES));
}
