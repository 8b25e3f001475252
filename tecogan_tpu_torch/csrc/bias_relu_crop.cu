// The generator's transposed convs' epilogue: bias, ReLU and TF's SAME crop
// in one pass over cuDNN's output.
//
// Replaces no TPU kernel. The JAX package computes relu(conv2_tran(x) + b)
// (tecogan_tpu/models/generator.py:59-62, 185-186) and XLA fuses the bias
// and the ReLU into the convolution's output. On the card the port runs
// the transposed conv through cuDNN at padding 0 with no bias: its output
// y is dense NHWC of (B, H + 1, W + 1, C), and SAME keeps the first H rows
// and W columns (models/layers.py:Conv2Tran). With the bias handed to the
// conv, ATen adds it in a separate add_ over all of y and F.relu reads the
// cropped view, which is not dense: two passes of ATen's non-vectorised
// elementwise kernel. This kernel reads y once and writes the dense
// (B, H, W, C) result once:
//
//   out = relu(round_T(float(y) + float(b)))
//
// at ATen's rounding points: add_ sums in float32 and rounds to T, then
// clamp_min(0) passes NaN through and takes fmaxf otherwise. So the output
// is bit-equal to relu(y[..., :-1, :-1] + b) on the card.
//
// Bound on the card: memory. Two bytes a bfloat16 element read and two
// written, one add and one max between. The design moves 16-byte vectors:
// - C / V vectors of V = 16 / sizeof(T) channels make a pixel; a block's
//   kThreads / (C / V) "pixels" x (C / V) threads each keep one vector's
//   channels, and with them its V bias values in registers, for the whole
//   block;
// - a grid row is one output row; a thread takes kPerThread pixels,
//   "pixels" apart, and issues all their loads before any store;
// - consecutive threads read and write consecutive 16 bytes of a row; an
//   output pixel (n, r, c) reads input pixel (n, r, c), at row pitch
//   (W + 1) C, so only the skipped last column breaks a row's run;
// - the input is read with evict-first loads: nothing reads it again.
// The wrapper (kernels/epilogue.py) checks that C is a multiple of V and
// that both pointers are 16-byte aligned.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // threads a block, at most
constexpr int kPerThread = 4;   // output pixels a thread
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float relu_keep_nan(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }

// The V values of a 16-byte vector as float32, and back (bfloat16 rounded
// to nearest even). A bfloat16 value is the top half of its float32.
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; i++) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x), v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z), v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bias_relu_crop_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                          T* __restrict__ out, int rows, int H, int W, int C) {
  constexpr int V = 16 / sizeof(T);
  const int groups = C / V;                 // vectors a pixel
  const int pixels = blockDim.x / groups;   // pixels a block covers in one step
  const int g = threadIdx.x % groups;
  const int p = threadIdx.x / groups;
  float b[V];
  unpack(*reinterpret_cast<const uint4*>(bias + g * V), b);
  const int x0 = blockIdx.x * pixels * kPerThread + p;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const int n = r / H, row = r - n * H;
    const T* src = y + (static_cast<size_t>(n) * (H + 1) + row) * (W + 1) * C + g * V;
    T* dst = out + static_cast<size_t>(r) * W * C + g * V;
    uint4 raw[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; k++) {
      const int x = x0 + k * pixels;
      if (x < W) raw[k] = __ldcs(reinterpret_cast<const uint4*>(src + static_cast<size_t>(x) * C));
    }
#pragma unroll
    for (int k = 0; k < kPerThread; k++) {
      const int x = x0 + k * pixels;
      if (x >= W) break;
      float v[V];
      unpack(raw[k], v);
#pragma unroll
      for (int i = 0; i < V; i++) v[i] = relu_keep_nan(tt::round_to<T>(v[i] + b[i]));
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(x) * C) = pack(v);
    }
  }
}

template <typename T>
int launch(const void* y, const void* bias, void* out, int B, int H, int W, int C,
           void* stream) {
  constexpr int V = 16 / sizeof(T);
  if (B <= 0 || H <= 0 || W <= 0) return cudaSuccess;
  if (C <= 0 || C % V != 0 || C / V > kThreads) return cudaErrorInvalidValue;
  const int groups = C / V, pixels = kThreads / groups;
  const int rows = B * H;
  const dim3 grid((W + pixels * kPerThread - 1) / (pixels * kPerThread),
                  rows < kMaxGridY ? rows : kMaxGridY);
  bias_relu_crop_kernel<T><<<grid, groups * pixels, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(bias), static_cast<T*>(out), rows, H, W,
      C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y: (B, H + 1, W + 1, C) dense NHWC, bias: (C,), out: (B, H, W, C) dense
// NHWC, all of one dtype. Returns cudaGetLastError() after the launch.
extern "C" int tt_bias_relu_crop_f32(const void* y, const void* bias, void* out, int B, int H,
                                     int W, int C, void* stream) {
  return launch<float>(y, bias, out, B, H, W, C, stream);
}

extern "C" int tt_bias_relu_crop_bf16(const void* y, const void* bias, void* out, int B, int H,
                                      int W, int C, void* stream) {
  return launch<__nv_bfloat16>(y, bias, out, B, H, W, C, stream);
}
