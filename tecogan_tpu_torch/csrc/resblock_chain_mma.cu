// K3/K4/K5 in bfloat16: the generator's residual-block chain on Hopper's
// warpgroup MMA, one launch per block, NHWC at 64 channels.
//
// Per block:  x <- x + conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2, SAME
// (zero) padding; the conv1 output is zeroed outside the image and rounded
// to bfloat16; float32 accumulation and one rounding to bfloat16 per block
// output, the skip read from the bfloat16 input. These are the rounding
// points of tecogan_tpu/kernels/resblocks.py::_chain_kernel (:127-144),
// which this kernel replaces in bfloat16 together with its pair-packed
// forms _paired_kernel (K4) and _paired_kernel_v2 (K5); the float32 chain
// stays in resblock_chain.cu.
//
// Bound on the card: 2 convs x 2·9·64·64 FLOP a pixel at 989 TFLOP/s
// (bf16 tensor cores): 77 us a block at 540x960. Its bytes (x read and the
// output written once, 133 MB there) take 40 us at 3.35 TB/s, so the
// tensor cores bound it. What held the mma.sync design to ~23% of that was
// shared memory: an SM reads 128 B of it a cycle and its tensor cores do
// 4,096 bf16 FLOP a cycle, so an operand path must bring 32 FLOP a byte;
// mma.sync fed by ldmatrix brought 16-20.
//
// Design. Each conv is an implicit GEMM, M = 64 pixels of one image row,
// N = 64 output channels, K = 9 taps x 64 input channels, as
// wgmma.m64n64k16 with both operands in shared memory (2 KB + 2 KB per
// 131 KFLOP: 32 FLOP a byte, no ldmatrix, no per-tap barrier).
//  - Flat rows. An x row is 64 pixels of 128 B (64 channels), the 128-byte
//    swizzle's row, so tap (dy, dx) of an m64 tile is row dy of the ring
//    with its start moved by dx pixels: a descriptor offset, not a copy
//    (the hardware swizzles on the address bits, so any pixel start
//    works). Of the 64 columns 60 are outputs (a strip); conv1's last two
//    and conv2's last four read past the row and are junk, never read by
//    conv2 nor stored.
//  - The x rows arrive by TMA from a 4-D (B, H, W, C) tensor map whose
//    out-of-bounds zero fill is SAME padding; the weights (MN-major B,
//    c_out contiguous, as HWIO stores them) by TMA from a 2-D map, both
//    convs' 18 taps (144 KB) once a launch, resident for every tile.
//  - Persistent CTAs, one per SM. A CTA walks units: a 60-column strip over
//    a segment of rows, top to bottom, so conv1 recomputes only two y rows
//    a segment. Warp 8 is the producer: one lane loads conv1's weights,
//    the first x rows, conv2's weights, then keeps a 6-row x ring loaded.
//    Warpgroup 0 runs conv1 row by row into a 4-row y ring (bias, ReLU,
//    the mask outside the image, bf16), warpgroup 1 runs conv2 behind it
//    and writes x + conv2 + b2 to global memory. Full and empty mbarriers
//    hand the rows along; nothing else waits.
//  - A warpgroup waits for a row's MMAs before that row's epilogue, and the
//    other warpgroup's MMAs keep the tensor cores busy meanwhile. Keeping a
//    second row in flight across the epilogue (its branches and barrier
//    waits) made ptxas serialize every wgmma (C7520) and cost 40%.
// The tile walk (segment height, units, CTAs) is chosen on the host from
// (B, H, W) and the SM count (kernels/resblocks.py:chain_plan).
#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int C = 64;                  // channels (the kernel is specialised)
constexpr int XW = 64;                 // pixels a flat row: one wgmma M
constexpr int TW = XW - 4;             // output columns a strip
constexpr int PX = C * 2;              // bytes a pixel: one 128-byte swizzle row
constexpr int ROW = XW * PX;           // bytes a flat row
constexpr int TAP = C * C * 2;         // bytes of one tap's (c_in, c_out) weights
constexpr int X_SLOTS = 6;             // x rows: conv1's 3, conv2's skip row, 2 loading
constexpr int Y_SLOTS = 4;             // y rows: conv2's 3, the one conv1 writes
constexpr int W_TAPS = 18;             // conv1's 9 taps, then conv2's 9
constexpr int W_BOX = 3;               // taps a weight copy (a 192-row box)
constexpr int kWarps = 9;              // warpgroups 0 (conv1), 1 (conv2); warp 8 loads
constexpr int kThreads = 32 * kWarps;
constexpr int Y_OFF = X_SLOTS * ROW;   // byte offsets from the 1024-aligned base
constexpr int W_OFF = Y_OFF + Y_SLOTS * ROW;
constexpr int BAR_OFF = W_OFF + W_TAPS * TAP;
constexpr int N_BARS = 2 * X_SLOTS + 2 * Y_SLOTS + 2;
constexpr int SMEM_BYTES = 1024 + BAR_OFF + 8 * N_BARS;  // 1024: room to align the base
static_assert(PX == 128, "a pixel is one row of the 128-byte swizzle");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers -------------------------------------------------------------
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Wait for the completion of the phase of parity `parity`.
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// One warp's part of an arrival counted per warp: lane 0 arrives after the
// warp's lanes are done.
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) bar_arrive(bar);
}

// --- TMA -------------------------------------------------------------------
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// --- wgmma -----------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle: 8-row groups 1024 B
// apart (SBO), the leading offset unused at these widths. Both operands use
// it: A K-major (pixel rows), B MN-major (c_in rows of c_out). A byte offset
// o moves the start by o / 16 (addresses stay below 2^18).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (+)= A (64x16, K-major) x B (16x64, MN-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous MMAs.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One output row of a conv: acc = sum over taps (dy, dx) and 16-channel
// steps of rows[dy] shifted by dx pixels times tap dy*3+dx of w (36 MMAs),
// then wait for them.
__device__ __forceinline__ void conv_row(float (&acc)[32], const uint64_t (&rows)[3], uint64_t w) {
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc) {
        wgmma_64x64(acc, rows[dy] + (dx * PX + kc * 32) / 16,
                    w + ((dy * 3 + dx) * TAP + kc * 16 * PX) / 16, dy + dx + kc > 0);
      }
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
}

// Byte offset of channel pair n of pixel p in a swizzled flat row.
__device__ __forceinline__ int px_off(int p, int n) {
  return p * PX + (((n >> 3) ^ (p & 7)) << 4) + (n & 7) * 2;
}

struct Unit {
  int b, r0, r1, tx0;  // batch, output rows [r0, r1), first output column
};

__device__ __forceinline__ Unit unit_of(int u, int H, int strips, int segs, int seg_rows) {
  const int per_b = strips * segs, r = u % per_b;
  const int r0 = (r / strips) * seg_rows;
  return {u / per_b, r0, min(r0 + seg_rows, H), (r % strips) * TW};
}

__global__ void __launch_bounds__(kThreads, 1)
resblock_kernel_wgmma(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap w1map,
                      const __grid_constant__ CUtensorMap w2map, int w_row0,
                      const bf16* __restrict__ b1, const bf16* __restrict__ b2,
                      bf16* __restrict__ out, int H, int W, int strips, int segs, int seg_rows,
                      int units) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* const smem = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t xs = base, ys = base + Y_OFF, ws = base + W_OFF, bars = base + BAR_OFF;
  // Barriers, 8 B each: x full, x empty, y full, y empty, weights (conv1, conv2).
  const auto x_full = [&](int s) { return bars + 8 * s; };
  const auto x_empty = [&](int s) { return bars + 8 * (X_SLOTS + s); };
  const auto y_full = [&](int s) { return bars + 8 * (2 * X_SLOTS + s); };
  const auto y_empty = [&](int s) { return bars + 8 * (2 * X_SLOTS + Y_SLOTS + s); };
  const uint32_t w_full = bars + 8 * (2 * X_SLOTS + 2 * Y_SLOTS);

  if (threadIdx.x == 0) {
    for (int s = 0; s < X_SLOTS; ++s) {
      bar_init(x_full(s), 1);
      bar_init(x_empty(s), 8);  // the 4 warps of each conv
    }
    for (int s = 0; s < Y_SLOTS; ++s) {
      bar_init(y_full(s), 4);
      bar_init(y_empty(s), 4);
    }
    bar_init(w_full, 1);
    bar_init(w_full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {
    // Producer: conv1's weights, the first unit's first x rows, conv2's
    // weights, then every x row of every unit in order into the ring.
    if (lane != 0) return;
    bar_expect(w_full, 9 * TAP);
    for (int k = 0; k < 9 / W_BOX; ++k) {
      tma_2d(ws + k * W_BOX * TAP, &w1map, w_full, 0, w_row0 + k * W_BOX * C);
    }
    int seq = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit t = unit_of(u, H, strips, segs, seg_rows);
      for (int l = 0; l < t.r1 - t.r0 + 4; ++l, ++seq) {
        if (seq == 3) {
          bar_expect(w_full + 8, 9 * TAP);
          for (int k = 0; k < 9 / W_BOX; ++k) {
            tma_2d(ws + (9 + k * W_BOX) * TAP, &w2map, w_full + 8, 0, w_row0 + k * W_BOX * C);
          }
        }
        const int slot = seq % X_SLOTS;
        bar_wait(x_empty(slot), ((seq / X_SLOTS) & 1) ^ 1);
        bar_expect(x_full(slot), ROW);
        tma_4d(xs + slot * ROW, &xmap, x_full(slot), 0, t.tx0 - 2, t.r0 - 2 + l, t.b);
      }
    }
    return;
  }

  // Consumers. Accumulator element i of thread (warp w, lane): pixel
  // 16 w + lane / 4 + 8 ((i / 2) % 2), channel 8 (i / 4) + 2 (lane % 4) + i % 2.
  const int wg = warp / 4, wq = warp % 4;
  const int p_lo = 16 * wq + lane / 4, n_lo = 2 * (lane % 4);
  float2 bias[8];
  const bf16* bp = wg == 0 ? b1 : b2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bias[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bp + 8 * j + n_lo));
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  const auto x_row = [&](int seq) { return xs + (seq % X_SLOTS) * ROW; };
  const auto y_row = [&](int seq) { return ys + (seq % Y_SLOTS) * ROW; };
  const auto x_wait = [&](int seq) { bar_wait(x_full(seq % X_SLOTS), (seq / X_SLOTS) & 1); };
  const auto x_free = [&](int seq) { warp_arrive(x_empty(seq % X_SLOTS)); };
  int xq = 0, yq = 0;  // sequence numbers of the unit's first x and y rows

  if (wg == 0) {
    // conv1: y row j = r0 - 1 + m from x rows m, m + 1, m + 2 of the unit.
    bar_wait(w_full, 0);
    const uint64_t w = sw128_desc(ws);
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit t = unit_of(u, H, strips, segs, seg_rows);
      const int ny = t.r1 - t.r0 + 2;
      for (int m = 0; m < ny; ++m) {
        for (int l = m == 0 ? 0 : m + 2; l <= m + 2; ++l) x_wait(xq + l);
        const int j = t.r0 - 1 + m;
        const bool row_in = j >= 0 && j < H;
        if (row_in) {  // rows outside the image are zeros: no MMAs
          const uint64_t rows[3] = {sw128_desc(x_row(xq + m)), sw128_desc(x_row(xq + m + 1)),
                                    sw128_desc(x_row(xq + m + 2))};
          conv_row(acc, rows, w);
        }
        x_free(xq + m);
        const int yseq = yq + m;
        bar_wait(y_empty(yseq % Y_SLOTS), ((yseq / Y_SLOTS) & 1) ^ 1);
        // y = relu(acc + b1), zero outside the image (conv2's SAME padding
        // sees zeros there, not relu(b1)), rounded to bf16.
        unsigned char* const dst = smem + (y_row(yseq) - base);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p_lo + 8 * h, gx = t.tx0 - 1 + p;
          const bool inside = row_in && gx >= 0 && gx < W;
#pragma unroll
          for (int j8 = 0; j8 < 8; ++j8) {
            const int i = 4 * j8 + 2 * h, n = 8 * j8 + n_lo;
            const float v0 = inside ? fmaxf(acc[i] + bias[j8].x, 0.0f) : 0.0f;
            const float v1 = inside ? fmaxf(acc[i + 1] + bias[j8].y, 0.0f) : 0.0f;
            *reinterpret_cast<__nv_bfloat162*>(dst + px_off(p, n)) = __floats2bfloat162_rn(v0, v1);
          }
        }
        // The generic-proxy stores must be visible to conv2's wgmma reads.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        warp_arrive(y_full(yseq % Y_SLOTS));
      }
      x_free(xq + ny);
      x_free(xq + ny + 1);
      xq += ny + 2;
      yq += ny;
    }
  } else {
    // conv2: output row r0 + o from y rows o, o + 1, o + 2 of the unit, and
    // the skip from x row o + 2.
    bar_wait(w_full + 8, 0);
    const uint64_t w = sw128_desc(ws + 9 * TAP);
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit t = unit_of(u, H, strips, segs, seg_rows);
      const int rows_out = t.r1 - t.r0;
      for (int o = 0; o < rows_out; ++o) {
        for (int k = o == 0 ? 0 : o + 2; k <= o + 2; ++k) {
          bar_wait(y_full((yq + k) % Y_SLOTS), ((yq + k) / Y_SLOTS) & 1);
        }
        const uint64_t rows[3] = {sw128_desc(y_row(yq + o)), sw128_desc(y_row(yq + o + 1)),
                                  sw128_desc(y_row(yq + o + 2))};
        conv_row(acc, rows, w);
        warp_arrive(y_empty((yq + o) % Y_SLOTS));
        // out = skip + acc + b2, the skip read from the bf16 x row; rounded once.
        x_wait(xq + o + 2);
        const unsigned char* const src = smem + (x_row(xq + o + 2) - base);
        bf16* const row = out + (static_cast<int64_t>(t.b) * H + t.r0 + o) * W * C;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p_lo + 8 * h, gx = t.tx0 + p;
          if (p >= TW || gx >= W) continue;
#pragma unroll
          for (int j8 = 0; j8 < 8; ++j8) {
            const int i = 4 * j8 + 2 * h, n = 8 * j8 + n_lo;
            const float2 skip = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(src + px_off(p + 2, n)));
            *reinterpret_cast<__nv_bfloat162*>(row + static_cast<int64_t>(gx) * C + n) =
                __floats2bfloat162_rn(skip.x + acc[i] + bias[j8].x, skip.y + acc[i + 1] + bias[j8].y);
          }
        }
        if (o == 0) {
          x_free(xq);
          x_free(xq + 1);
        }
        x_free(xq + o + 2);
      }
      warp_arrive(y_empty((yq + rows_out) % Y_SLOTS));
      warp_arrive(y_empty((yq + rows_out + 1) % Y_SLOTS));
      x_free(xq + rows_out + 2);
      x_free(xq + rows_out + 3);
      xq += rows_out + 4;
      yq += rows_out + 2;
    }
  }
}

// > 48 KB of dynamic shared memory needs an opt-in.
cudaError_t opt_in() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      resblock_kernel_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  done = e == cudaSuccess;
  return e;
}

PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A (B, H, W, 64) bf16 activation as rows of 64 pixels; coordinates outside
// the tensor read zeros.
bool activation_map(CUtensorMap* map, const void* p, int B, int H, int W) {
  const cuuint64_t dims[4] = {C, static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(PX), static_cast<cuuint64_t>(W) * PX,
                                 static_cast<cuuint64_t>(H) * W * PX};
  const cuuint32_t box[4] = {C, XW, 1, 1}, unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (N, 9, 64, 64) bf16 weights as N * 576 c_in rows of 64 c_out, 3 taps a box.
bool weight_map(CUtensorMap* map, const void* p, int N) {
  const cuuint64_t dims[2] = {C, static_cast<cuuint64_t>(N) * 9 * C};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(PX)};
  const cuuint32_t box[2] = {C, W_BOX * C}, unit[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x, buf_a, buf_b: (B, H, W, 64) bfloat16; w1, w2: (N, 9, 64, 64) as
// (tap, in, out); b1, b2: (N, 64). Block i writes buf_a when i is even and
// buf_b when odd. x is only read. Every pointer 16-byte aligned. The tile
// walk: segments of seg_rows rows (the last may be shorter) of 60-column
// strips, walked by `grid` persistent CTAs (kernels/resblocks.py:chain_plan).
extern "C" int tt_resblock_chain_bf16(const void* x, void* buf_a, void* buf_b, const void* w1,
                                      const void* b1, const void* w2, const void* b2, int B,
                                      int H, int W, int N, int seg_rows, int grid, void* stream) {
  cudaError_t e = opt_in();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B == 0 || H == 0 || W == 0 || N == 0) return static_cast<int>(cudaSuccess);
  if (seg_rows < 1 || grid < 1 || encode_tiled() == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[3], w1map, w2map;  // x, buf_a, buf_b
  const void* acts[3] = {x, buf_a, buf_b};
  for (int k = 0; k < 3; ++k) {
    if (!activation_map(&maps[k], acts[k], B, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!weight_map(&w1map, w1, N) || !weight_map(&w2map, w2, N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int strips = (W + TW - 1) / TW, segs = (H + seg_rows - 1) / seg_rows;
  const int units = B * strips * segs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* b1p = static_cast<const bf16*>(b1);
  const bf16* b2p = static_cast<const bf16*>(b2);
  for (int i = 0; i < N; ++i) {
    // Block i reads x (i = 0), then buf_a (odd i) or buf_b (even i > 0).
    const CUtensorMap& src = maps[i == 0 ? 0 : (i % 2 == 1 ? 1 : 2)];
    bf16* next = static_cast<bf16*>(i % 2 == 0 ? buf_a : buf_b);
    resblock_kernel_wgmma<<<grid < units ? grid : units, kThreads, SMEM_BYTES, s>>>(
        src, w1map, w2map, i * 9 * C, b1p + i * C, b2p + i * C, next, H, W, strips, segs,
        seg_rows, units);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaSuccess);
}

// Resident blocks of the kernel per SM at its shared memory and registers.
extern "C" int tt_resblock_chain_bf16_blocks_per_sm(int* blocks) {
  const cudaError_t e = opt_in();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, resblock_kernel_wgmma, kThreads, SMEM_BYTES));
}
