// K3/K4/K5 in float32: the generator's residual-block chain at 64
// channels, NHWC. (In bfloat16: resblock_chain_mma.cu, on tensor cores.)
//
// Per block:  x <- x + conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2,
// SAME (zero) padding, float32 accumulation, one rounding to T per conv.
//
// Replaces tecogan_tpu/kernels/resblocks.py::_chain_kernel (K3, launched by
// _fused_chain_single) and its pair-packed forms _paired_kernel (K4) and
// _paired_kernel_v2 (K5). All three compute the same function; the pair
// packing and shifted copies of K4/K5 exist to fill the TPU's 128-lane
// matrix unit and to align Mosaic loads, and have no counterpart here.
//
// Bound on the card: arithmetic. A block is 2 x 9 x 64 x 64 MACs per pixel
// (75 kFLOP) against 256 bytes in and out per pixel at float32, so the
// chain is compute-bound; in float32 it stays on the CUDA cores (training's
// 1e-3 GPU-vs-CPU step gate leaves no room for TF32). Design: one launch
// per residual block, ping-ponging between two buffers. Each thread block
// owns an 8x16-pixel output tile: it loads the input tile with a 2-pixel
// halo into shared memory (zeros outside the image), computes y = relu(
// conv1 + b1) on the 10x18 haloed region, ZEROES y outside the image (SAME
// padding of conv2 sees zeros there, not relu(b1); resblocks.py:100-106,130),
// rounds y to T, then computes x + conv2(y) + b2 and rounds once. Weights are
// staged into shared memory one 64x64 tap at a time. Each thread holds
// 4 output channels x 12 (conv1) or 8 (conv2) pixels in registers and reads
// 4 input channels per float4, so a shared-memory load feeds 16 FMAs.
#include "common.cuh"

namespace {

constexpr int C = 64;                     // channels (the kernel is specialised)
constexpr int TH = 8, TW = 16;            // output tile
constexpr int XH = TH + 4, XW = TW + 4;   // input tile with a 2-px halo
constexpr int YH = TH + 2, YW = TW + 2;   // conv1 region with a 1-px halo
constexpr int PS = C + 4;                 // floats per pixel in shared memory
                                          // (+4 staggers banks across pixels)
constexpr int kThreads = 256;
constexpr int CO_T = 4;                             // out channels per thread
constexpr int CO_GROUPS = C / CO_T;                 // 16
constexpr int PX_GROUPS = kThreads / CO_GROUPS;     // 16
constexpr int Y_PX = YH * YW;                       // 180
constexpr int Y_T = (Y_PX + PX_GROUPS - 1) / PX_GROUPS;  // 12 y pixels / thread
constexpr int O_T = TH * TW / PX_GROUPS;            // 8 out pixels / thread
constexpr int XS_FLOATS = XH * XW * PS;
constexpr int YS_FLOATS = YH * YW * PS;
constexpr size_t SMEM_BYTES = (XS_FLOATS + YS_FLOATS + C * C) * sizeof(float);
static_assert(TW == PX_GROUPS, "conv2 maps pixel group g to tile column g");

__device__ __forceinline__ void fma4(float (&a)[CO_T], float x, float4 w) {
  a[0] = fmaf(x, w.x, a[0]);
  a[1] = fmaf(x, w.y, a[1]);
  a[2] = fmaf(x, w.z, a[2]);
  a[3] = fmaf(x, w.w, a[3]);
}

// One tap's (C_in, C_out) weights -> shared memory as float32.
template <typename T>
__device__ __forceinline__ void stage_tap(float* ws, const T* __restrict__ w) {
  for (int i = threadIdx.x * 4; i < C * C; i += kThreads * 4) {
    *reinterpret_cast<float4*>(ws + i) = tt::load4(w + i);
  }
}

// acc[k] += sum over taps and input channels of src[pix_off[k] + tap] * w.
// src rows are `row` pixels wide; w is (9, C_in, C_out).
template <typename T, int NPIX, int ROW>
__device__ __forceinline__ void conv3x3(float (&acc)[NPIX][CO_T],
                                        const float* src, const int (&pix_off)[NPIX],
                                        float* ws, const T* __restrict__ w, int co0) {
#pragma unroll
  for (int k = 0; k < NPIX; ++k) {
#pragma unroll
    for (int j = 0; j < CO_T; ++j) acc[k][j] = 0.0f;
  }
  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // everyone is done with the previous tap's weights
    stage_tap(ws, w + tap * C * C);
    __syncthreads();
    const int toff = ((tap / 3) * ROW + tap % 3) * PS;
#pragma unroll 2
    for (int ci = 0; ci < C; ci += 4) {
      const float4 w0 = *reinterpret_cast<const float4*>(ws + (ci + 0) * C + co0);
      const float4 w1 = *reinterpret_cast<const float4*>(ws + (ci + 1) * C + co0);
      const float4 w2 = *reinterpret_cast<const float4*>(ws + (ci + 2) * C + co0);
      const float4 w3 = *reinterpret_cast<const float4*>(ws + (ci + 3) * C + co0);
#pragma unroll
      for (int k = 0; k < NPIX; ++k) {
        const float4 xv = *reinterpret_cast<const float4*>(src + pix_off[k] + toff + ci);
        fma4(acc[k], xv.x, w0);
        fma4(acc[k], xv.y, w1);
        fma4(acc[k], xv.z, w2);
        fma4(acc[k], xv.w, w3);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
resblock_kernel(const T* __restrict__ src, T* __restrict__ dst,
                const T* __restrict__ w1, const T* __restrict__ b1,
                const T* __restrict__ w2, const T* __restrict__ b2, int H, int W) {
  extern __shared__ float4 smem[];
  float* xs = reinterpret_cast<float*>(smem);  // (XH, XW, PS)
  float* ys = xs + XS_FLOATS;                   // (YH, YW, PS)
  float* ws = ys + YS_FLOATS;                   // (C, C) one tap

  const int tx0 = blockIdx.x * TW, ty0 = blockIdx.y * TH;
  const int64_t plane = static_cast<int64_t>(blockIdx.z) * H * W * C;
  const T* img = src + plane;
  T* out = dst + plane;
  const int co0 = (threadIdx.x % CO_GROUPS) * CO_T;
  const int pg = threadIdx.x / CO_GROUPS;

  // Input tile with a 2-px halo; zeros outside the image (SAME padding).
  for (int i = threadIdx.x; i < XH * XW * (C / 4); i += kThreads) {
    const int ch = (i % (C / 4)) * 4, px = i / (C / 4);
    const int gy = ty0 - 2 + px / XW, gx = tx0 - 2 + px % XW;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = tt::load4(img + (static_cast<int64_t>(gy) * W + gx) * C + ch);
    }
    *reinterpret_cast<float4*>(xs + px * PS + ch) = v;
  }

  // conv1 over the haloed region: y pixel p = pg + 16k at (p / YW, p % YW)
  // reads x tile pixels (py + dy, px + dx).
  {
    int off[Y_T];
#pragma unroll
    for (int k = 0; k < Y_T; ++k) {
      const int p = min(pg + PX_GROUPS * k, Y_PX - 1);  // tail lanes recompute
      off[k] = ((p / YW) * XW + p % YW) * PS;
    }
    float acc[Y_T][CO_T];
    conv3x3<T, Y_T, XW>(acc, xs, off, ws, w1, co0);
    const float4 bias = tt::load4(b1 + co0);
#pragma unroll
    for (int k = 0; k < Y_T; ++k) {
      const int p = pg + PX_GROUPS * k;
      if (p >= Y_PX) continue;
      const int gy = ty0 - 1 + p / YW, gx = tx0 - 1 + p % YW;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      float4 y = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (inside) {
        y.x = tt::round_to<T>(fmaxf(acc[k][0] + bias.x, 0.0f));
        y.y = tt::round_to<T>(fmaxf(acc[k][1] + bias.y, 0.0f));
        y.z = tt::round_to<T>(fmaxf(acc[k][2] + bias.z, 0.0f));
        y.w = tt::round_to<T>(fmaxf(acc[k][3] + bias.w, 0.0f));
      }
      *reinterpret_cast<float4*>(ys + p * PS + co0) = y;
    }
  }

  // conv2: output pixel (k, pg) of the tile reads y pixels (k + dy, pg + dx);
  // conv3x3's first barrier orders the y stores before these loads.
  {
    int off[O_T];
#pragma unroll
    for (int k = 0; k < O_T; ++k) off[k] = (k * YW + pg) * PS;
    float acc[O_T][CO_T];
    conv3x3<T, O_T, YW>(acc, ys, off, ws, w2, co0);
    const float4 bias = tt::load4(b2 + co0);
    const int gx = tx0 + pg;
#pragma unroll
    for (int k = 0; k < O_T; ++k) {
      const int gy = ty0 + k;
      if (gy >= H || gx >= W) continue;
      const float4 skip =
          *reinterpret_cast<const float4*>(xs + ((k + 2) * XW + pg + 2) * PS + co0);
      float4 o;
      o.x = skip.x + acc[k][0] + bias.x;
      o.y = skip.y + acc[k][1] + bias.y;
      o.z = skip.z + acc[k][2] + bias.z;
      o.w = skip.w + acc[k][3] + bias.w;
      tt::store4(out + (static_cast<int64_t>(gy) * W + gx) * C + co0, o);
    }
  }
}

template <typename T>
int launch(const void* x, void* buf_a, void* buf_b, const void* w1, const void* b1,
           const void* w2, const void* b2, int B, int H, int W, int N, void* stream) {
  static bool smem_opt_in = false;  // > 48 KB of dynamic shared memory
  if (!smem_opt_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        resblock_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_BYTES));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_opt_in = true;
  }
  if (B == 0 || H == 0 || W == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* cur = static_cast<const T*>(x);
  const T* w1p = static_cast<const T*>(w1);
  const T* b1p = static_cast<const T*>(b1);
  const T* w2p = static_cast<const T*>(w2);
  const T* b2p = static_cast<const T*>(b2);
  for (int i = 0; i < N; ++i) {
    T* next = static_cast<T*>(i % 2 == 0 ? buf_a : buf_b);
    resblock_kernel<T><<<grid, kThreads, SMEM_BYTES, s>>>(
        cur, next, w1p + static_cast<int64_t>(i) * 9 * C * C, b1p + i * C,
        w2p + static_cast<int64_t>(i) * 9 * C * C, b2p + i * C, H, W);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    cur = next;
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// x, buf_a, buf_b: (B, H, W, 64); w1, w2: (N, 9, 64, 64) as (tap, in, out);
// b1, b2: (N, 64). Block i writes buf_a when i is even and buf_b when odd, so
// the result is in buf_a for odd N and in buf_b for even N. x is only read.
extern "C" int tt_resblock_chain_f32(const void* x, void* buf_a, void* buf_b,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, int B, int H, int W, int N,
                                     void* stream) {
  return launch<float>(x, buf_a, buf_b, w1, b1, w2, b2, B, H, W, N, stream);
}
