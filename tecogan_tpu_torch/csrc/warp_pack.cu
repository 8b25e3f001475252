// The recurrent step's input in one pass: the backward warp of the previous
// HR frame, its 4x space-to-depth and the concat with the LR frame.
//
// Replaces no TPU kernel. The JAX package gathers the four corners with XLA
// (tecogan_tpu/ops/warp.py:dense_image_warp, :693 warp_space_to_depth) and
// XLA fuses the lerp, the pack and the concat around the gather. The port's
// plain route (ops/warp.py) runs them as ATen ops over the HR grid: float32
// coordinates, int64 indices, four index_selects of 3-element rows, nine
// lerp passes, a permuting copy and a concat, some 36 launches that move
// about 4.2 GB a 2160p frame. This kernel reads the flow, the corners it
// needs of the previous frame and the LR frame, and writes the generator's
// (B, H/4, W/4, 3 + 48) input once:
//
//   out[b, i, j, c]                      = lr[b, i, j, c]
//   out[b, i, j, 3 + (4r + s) * 3 + c]   = warp(image, flow)[b, 4i + r, 4j + s, c]
//
// at the plain route's rounding points, so that on the card it is bit-equal
// to torch.cat([lr, space_to_depth(dense_image_warp(image, flow), 4)], -1)
// in float32 and bfloat16: float32 coordinates q = y - flow; floor(q)
// clamped to [0, size - 2]; the fraction q - floor clamped to [0, 1] and
// rounded to T; every lerp op rounded to T as its ATen op is (tr - tl,
// * ax, tl + ., the bottom row, bot - top, * ay, top + .). The _rn
// intrinsics keep nvcc from contracting a product and a sum into an FMA
// that ATen's separate kernels never form.
//
// Bound on the card: memory. At 2160p the flow (33.2 MB), the previous frame
// (49.8 MB), the LR frame (3.1 MB) and the output (52.9 MB) are 139 MB,
// 0.041 ms at 3.35 TB/s. The design:
// - a block owns a tile of kRows x kCols LR pixels (4 kRows x 128 HR
//   pixels); a warp takes 32-pixel runs of an HR row, a thread one HR
//   pixel of each, so a warp reads 32 consecutive flow vectors (coalesced)
//   and, flows being smooth, gathers its corners from a few cache lines
//   through the read-only path. FNet bounds the flow at 96 HR pixels: a
//   shared-memory tile of the source would be mostly halo;
// - in bfloat16 a pixel's corner pair (12 bytes) comes in three aligned
//   4-byte words (and 2 bytes) rather than six 2-byte loads, and the lerps
//   run on bf16x2 pairs (ld_pair, Corners);
// - the tile's output (kCols x 51 values an LR row) is staged in shared
//   memory at the byte offset it has modulo 16 in device memory, then each
//   LR row's contiguous span is written with 16-byte stores, element stores
//   only at its unaligned head and tail (an LR pixel is 102 or 204 bytes);
// - indices are 32-bit: the wrapper (kernels/warp_pack.py) refuses frames
//   with B * H * W * 3 above 2^31 - 1, and an image or flow whose data is
//   not aligned for these loads.
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 4;                   // the space-to-depth block
constexpr int kC = 3;                       // image channels
constexpr int kOutC = kC + kBlock * kBlock * kC;  // 51
constexpr int kCols = 32;                   // LR columns a tile (128 HR columns)
constexpr int kRuns = kCols * kBlock / 32;  // 32-pixel runs an HR row of the tile
// A tile of one LR row (4 HR rows): each warp takes 2 runs, each thread 2
// HR pixels, in 40 registers or fewer so that at least 6 blocks of 256
// threads are resident on an SM (8 blocks, 32 registers, were slower on the
// card). Taller tiles and more runs in flight a warp were slower too: the
// gather's latency is hidden by resident warps, not by loads in flight a
// thread.
constexpr int kRows = 1;                    // LR rows a tile
constexpr int kUnroll = 2;                  // runs a warp gathers at once
constexpr int kMinBlocks = 6;               // resident blocks an SM, at least

// One float32 value through the read-only cache.
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

// A pixel's (dy, dx), read once.
__device__ __forceinline__ float2 ld_flow(const float* flow, int pix) {
  return __ldcs(reinterpret_cast<const float2*>(flow) + pix);
}
__device__ __forceinline__ float2 ld_flow(const __nv_bfloat16* flow, int pix) {
  const uint32_t raw = __ldcs(reinterpret_cast<const unsigned int*>(flow) + pix);
  return make_float2(__uint_as_float(raw << 16), __uint_as_float(raw & 0xffff0000u));
}

// ATen's clamp: max(v, lo), then min(., hi).
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return hi < v ? hi : v;
}

// a + (b - a) * t in float32, each op rounded to T.
template <typename T>
__device__ __forceinline__ float lerp(float a, float b, float t) {
  using tt::round_to;
  return round_to<T>(__fadd_rn(a, round_to<T>(__fmul_rn(round_to<T>(__fsub_rn(b, a)), t))));
}

// bfloat16 pairs. Each bf16x2 op rounds its exact result to bfloat16 once;
// ATen rounds the float32 result of the same op on bfloat16 inputs, and
// float32 carries more than 2 x 8 + 2 bits, so the double rounding gives
// the same bits (Figueroa's bound). The _rn forms keep ptxas from fusing a
// product and a sum into one rounding. The lerp of pairs is then ATen's
// lerp channel by channel, at a third of the instructions.
__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t v) {
  __nv_bfloat162 r;
  memcpy(&r, &v, 4);
  return r;
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t r;
  memcpy(&r, &v, 4);
  return r;
}
__device__ __forceinline__ __nv_bfloat162 lerp2(__nv_bfloat162 a, __nv_bfloat162 b,
                                                __nv_bfloat162 t) {
  return __hadd2_rn(a, __hmul2_rn(__hsub2_rn(b, a), t));
}

// Pixels p and p + 1 of a bfloat16 RGB image: (channel 0, channel 1) of
// each as one word, channel 2 of each in a word's low half. Pixels are 6
// bytes: an even p starts on a 4-byte boundary, an odd one 2 bytes past
// it. Three aligned words hold the 12 bytes, or all but the last 2 (read
// alone, so nothing past the image is read).
struct Pair {
  uint32_t l01, r01, l2, r2;
};
__device__ __forceinline__ Pair ld_pair(const __nv_bfloat16* image, int p) {
  const int odd = p & 1;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(image) + ((3 * p - odd) >> 1);
  const uint32_t w0 = __ldg(w), w1 = __ldg(w + 1), w2 = __ldg(w + 2);
  Pair q;
  if (odd) {  // w0 = (-, l0), w1 = (l1, l2), w2 = (r0, r1), then r2
    q.l01 = __byte_perm(w0, w1, 0x5432);
    q.l2 = w1 >> 16;
    q.r01 = w2;
    q.r2 = __ldg(reinterpret_cast<const unsigned short*>(w + 3));
  } else {  // w0 = (l0, l1), w1 = (l2, r0), w2 = (r1, r2)
    q.l01 = w0;
    q.l2 = w1 & 0xffffu;
    q.r01 = __byte_perm(w1, w2, 0x5432);
    q.r2 = w2 >> 16;
  }
  return q;
}

// The 2 x 2 corners of one HR pixel's query, and its 3 warped values.
template <typename T>
struct Corners;
template <>
struct Corners<__nv_bfloat16> {
  Pair top, bot;
  __device__ __forceinline__ void load(const __nv_bfloat16* image, int p, int W) {
    top = ld_pair(image, p);
    bot = ld_pair(image, p + W);
  }
  __device__ __forceinline__ void blend(float ay, float ax, float (&v)[kC]) const {
    const __nv_bfloat162 ty = __float2bfloat162_rn(ay), tx = __float2bfloat162_rn(ax);
    const __nv_bfloat162 t01 = lerp2(bf2(top.l01), bf2(top.r01), tx);
    const __nv_bfloat162 b01 = lerp2(bf2(bot.l01), bf2(bot.r01), tx);
    // Channel 2 of the top and bottom rows as one pair: (top, bottom).
    const __nv_bfloat162 tb2 = lerp2(bf2(top.l2 | bot.l2 << 16), bf2(top.r2 | bot.r2 << 16), tx);
    const __nv_bfloat162 v01 = lerp2(t01, b01, ty);
    const __nv_bfloat162 v2 = lerp2(tb2, __lowhigh2highlow(tb2), ty);  // low: top + (bot - top) ty
    const uint32_t lo = bits(v01);
    v[0] = __uint_as_float(lo << 16);
    v[1] = __uint_as_float(lo & 0xffff0000u);
    v[2] = __uint_as_float(bits(v2) << 16);
  }
};
template <>
struct Corners<float> {
  float tl[kC], tr[kC], bl[kC], br[kC];
  __device__ __forceinline__ void load(const float* image, int p, int W) {
    const float* q = image + p * kC;
#pragma unroll
    for (int c = 0; c < kC; c++) {
      tl[c] = ld(q + c);
      tr[c] = ld(q + kC + c);
      bl[c] = ld(q + W * kC + c);
      br[c] = ld(q + (W + 1) * kC + c);
    }
  }
  __device__ __forceinline__ void blend(float ay, float ax, float (&v)[kC]) const {
#pragma unroll
    for (int c = 0; c < kC; c++)
      v[c] = lerp<float>(lerp<float>(tl[c], tr[c], ax), lerp<float>(bl[c], br[c], ax), ay);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    warp_pack_kernel(const T* __restrict__ lr, const T* __restrict__ image,
                     const T* __restrict__ flow, T* __restrict__ out, int H, int W) {
  constexpr int kSize = sizeof(T);
  // An LR row's span and up to 15 bytes of offset before it, in 16-byte units.
  constexpr int kRowBytes = ((kCols * kOutC * kSize + 15) / 16 + 1) * 16;
  __shared__ __align__(16) unsigned char stage[kRows * kRowBytes];
  __shared__ int row_offset[kRows];  // each LR row span's first byte modulo 16

  const int h = H / kBlock, w = W / kBlock;
  const int b = blockIdx.z, i0 = blockIdx.y * kRows, j0 = blockIdx.x * kCols;
  const int rows = min(kRows, h - i0), cols = min(kCols, w - j0);
  if (static_cast<int>(threadIdx.x) < rows) {
    const T* first = out + (static_cast<size_t>(b * h + i0 + threadIdx.x) * w + j0) * kOutC;
    row_offset[threadIdx.x] = static_cast<int>(reinterpret_cast<uintptr_t>(first) & 15);
  }
  __syncthreads();

  // The LR frame's channels.
  for (int k = threadIdx.x; k < rows * kCols * kC; k += kThreads) {
    const int li = k / (kCols * kC), lj = (k / kC) % kCols, c = k % kC;
    if (lj < cols) {
      const T v = lr[(static_cast<size_t>(b * h + i0 + li) * w + j0 + lj) * kC + c];
      reinterpret_cast<T*>(stage + li * kRowBytes + row_offset[li])[lj * kOutC + c] = v;
    }
  }

  // The warped channels: a warp takes kUnroll runs of 32 HR pixels at once.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float hmax = static_cast<float>(H - 2), wmax = static_cast<float>(W - 2);
  constexpr int kTileRuns = kBlock * kRows * kRuns;
  for (int r0 = warp * kUnroll; r0 < kTileRuns; r0 += kWarps * kUnroll) {
    Corners<T> corners[kUnroll];
    float ay[kUnroll], ax[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; u++) {
      const int run = r0 + u;
      const int ly = run / kRuns, lx = (run % kRuns) * 32 + lane;
      ok[u] = run < kTileRuns && ly < kBlock * rows && lx < kBlock * cols;
      const int y = kBlock * i0 + ly, x = kBlock * j0 + lx;
      float2 f = make_float2(0.0f, 0.0f);
      if (ok[u]) f = ld_flow(flow, (b * H + y) * W + x);
      const float qy = __fsub_rn(static_cast<float>(y), f.x);
      const float qx = __fsub_rn(static_cast<float>(x), f.y);
      const float fy = clamp(floorf(qy), 0.0f, hmax), fx = clamp(floorf(qx), 0.0f, wmax);
      ay[u] = tt::round_to<T>(clamp(__fsub_rn(qy, fy), 0.0f, 1.0f));
      ax[u] = tt::round_to<T>(clamp(__fsub_rn(qx, fx), 0.0f, 1.0f));
      // A NaN flow converts to corner 0: always inside the frame.
      const int corner = (b * H + static_cast<int>(fy)) * W + static_cast<int>(fx);
      if (ok[u]) corners[u].load(image, corner, W);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; u++) {
      if (!ok[u]) continue;
      const int run = r0 + u;
      const int ly = run / kRuns, lx = (run % kRuns) * 32 + lane;
      const int li = ly / kBlock, lj = lx / kBlock;
      T* dst = reinterpret_cast<T*>(stage + li * kRowBytes + row_offset[li]) + lj * kOutC + kC +
               ((ly % kBlock) * kBlock + lx % kBlock) * kC;
      float v[kC];
      corners[u].blend(ay[u], ax[u], v);
#pragma unroll
      for (int c = 0; c < kC; c++) dst[c] = tt::from_f32<T>(v[c]);
    }
  }
  __syncthreads();

  // Each LR row's span: element stores up to the first 16-byte boundary,
  // 16-byte stores, element stores after the last one.
  for (int li = 0; li < rows; li++) {
    T* first = out + (static_cast<size_t>(b * h + i0 + li) * w + j0) * kOutC;
    unsigned char* g = reinterpret_cast<unsigned char*>(first);
    const unsigned char* s = stage + li * kRowBytes + row_offset[li];
    const int bytes = cols * kOutC * kSize;
    const int head = min(row_offset[li] ? 16 - row_offset[li] : 0, bytes);
    const int body = (bytes - head) & ~15;
    const int n_head = head / kSize, n_body = body / 16;
    const int items = n_head + n_body + (bytes - head - body) / kSize;
    for (int k = threadIdx.x; k < items; k += kThreads) {
      if (k >= n_head && k < n_head + n_body) {
        const int off = head + (k - n_head) * 16;
        *reinterpret_cast<uint4*>(g + off) = *reinterpret_cast<const uint4*>(s + off);
      } else {
        const int off = k < n_head ? k * kSize : head + body + (k - n_head - n_body) * kSize;
        *reinterpret_cast<T*>(g + off) = *reinterpret_cast<const T*>(s + off);
      }
    }
  }
}

template <typename T>
int launch(const void* lr, const void* image, const void* flow, void* out, int B, int H, int W,
           void* stream) {
  if (B <= 0 || H < kBlock || W < kBlock || H % kBlock || W % kBlock ||
      static_cast<long long>(B) * H * W * kC > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int h = H / kBlock, w = W / kBlock;
  const dim3 grid((w + kCols - 1) / kCols, (h + kRows - 1) / kRows, B);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  const auto* l = static_cast<const T*>(lr);
  const auto* im = static_cast<const T*>(image);
  const auto* f = static_cast<const T*>(flow);
  auto* o = static_cast<T*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  warp_pack_kernel<T><<<grid, kThreads, 0, s>>>(l, im, f, o, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lr (B, H/4, W/4, 3), image (B, H, W, 3), flow (B, H, W, 2) as (dy, dx),
// out (B, H/4, W/4, 51): contiguous, all of one dtype. Returns
// cudaGetLastError() after the launch.
extern "C" int tt_warp_pack_f32(const void* lr, const void* image, const void* flow, void* out,
                                int B, int H, int W, void* stream) {
  return launch<float>(lr, image, flow, out, B, H, W, stream);
}

extern "C" int tt_warp_pack_bf16(const void* lr, const void* image, const void* flow, void* out,
                                 int B, int H, int W, void* stream) {
  return launch<__nv_bfloat16>(lr, image, flow, out, B, H, W, stream);
}
