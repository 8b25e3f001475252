// K1: fixed-stencil 4x upsample of an NHWC tensor, legacy-TF bilinear or
// Catmull-Rom (r = 0.75) bicubic, edge replicated.
//
// Replaces tecogan_tpu/kernels/upsample4.py::_matmul_kernel (launched by
// _plane_call), which computes out = Sh @ x @ Sw per channel plane with
// banded stencil matrices on the TPU's matrix unit. Here the stencil is
// applied directly: output (4i+p, 4j+q) = sum_tx Ww[q][tx] * round_T(
// sum_ty Wh[p][ty] * x[clamp(i+off+ty), clamp(j+off+tx)]), summed in float32
// and rounded to T after the H pass and again at the end -- the rounding of
// the Pallas kernel (upsample4.py:72-73) and of the plain version
// (tecogan_tpu_torch/ops/resize.py).
//
// Bound on the card: memory. Each input element feeds 16 outputs and the
// output is 16x the input, so the stores dominate; there are 2-4 FMAs per
// tap. Design: one thread per output element with the channel fastest, so
// a warp's stores are consecutive addresses (coalesced) and its loads fall on
// a few input pixels that the L1 cache serves. No shared memory and no
// matrix form: on this card a banded matmul would only add wasted MACs.
// `alpha` scales the input (the flow path's x4, exact in any float type).
#include "common.cuh"

namespace {

// Phase weights; all values are dyadic, hence exact in float32 and bfloat16.
__constant__ float kBilinear[4][2] = {
    {1.0f, 0.0f}, {0.75f, 0.25f}, {0.5f, 0.5f}, {0.25f, 0.75f}};
__constant__ float kCatmullRom[4][4] = {
    {0.0f, 1.0f, 0.0f, 0.0f},
    {-0.10546875f, 0.87890625f, 0.26171875f, -0.03515625f},
    {-0.09375f, 0.59375f, 0.59375f, -0.09375f},
    {-0.03515625f, 0.26171875f, 0.87890625f, -0.10546875f}};

// NT taps per axis: 2 (bilinear, offsets 0..1) or 4 (bicubic, offsets -1..2).
template <typename T, int NT>
__global__ void upsample4_kernel(const T* __restrict__ x, T* __restrict__ out,
                                 int B, int H, int W, int C, float alpha) {
  // 32-bit index math (64-bit division is emulated and would dominate);
  // the wrapper keeps B * 16 * H * W * C below 2^31.
  constexpr int OFF = NT == 2 ? 0 : -1;
  const int total = B * 16 * H * W * C;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = idx % C;
  int t = idx / C;
  const int ox = t % (4 * W);
  t /= 4 * W;
  const int oy = t % (4 * H);
  const int b = t / (4 * H);
  const int iy = oy >> 2, p = oy & 3, ix = ox >> 2, q = ox & 3;
  const float* wh = NT == 2 ? kBilinear[p] : kCatmullRom[p];
  const float* ww = NT == 2 ? kBilinear[q] : kCatmullRom[q];
  const T* plane = x + b * H * W * C + c;

  float acc = 0.0f;
#pragma unroll
  for (int tx = 0; tx < NT; ++tx) {
    const int xx = min(max(ix + OFF + tx, 0), W - 1);
    float col = 0.0f;
#pragma unroll
    for (int ty = 0; ty < NT; ++ty) {
      const int yy = min(max(iy + OFF + ty, 0), H - 1);
      const float v = tt::round_to<T>(
          alpha * tt::to_f32(plane[(yy * W + xx) * C]));
      col = ty == 0 ? wh[0] * v : col + wh[ty] * v;
    }
    col = tt::round_to<T>(col);  // the H pass is rounded to T
    acc = tx == 0 ? ww[0] * col : acc + ww[tx] * col;
  }
  out[idx] = tt::from_f32<T>(acc);
}

template <typename T>
int launch(const void* x, void* out, int B, int H, int W, int C, int filter,
           float alpha, void* stream) {
  const int64_t total = static_cast<int64_t>(B) * 16 * H * W * C;
  if (total >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (filter == 0) {
    upsample4_kernel<T, 2><<<blocks, kThreads, 0, s>>>(xp, op, B, H, W, C, alpha);
  } else {
    upsample4_kernel<T, 4><<<blocks, kThreads, 0, s>>>(xp, op, B, H, W, C, alpha);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// filter: 0 = bilinear, 1 = bicubic. x: (B, H, W, C), out: (B, 4H, 4W, C).
extern "C" int tt_upsample4_f32(const void* x, void* out, int B, int H, int W,
                                int C, int filter, float alpha, void* stream) {
  return launch<float>(x, out, B, H, W, C, filter, alpha, stream);
}

extern "C" int tt_upsample4_bf16(const void* x, void* out, int B, int H, int W,
                                 int C, int filter, float alpha, void* stream) {
  return launch<__nv_bfloat16>(x, out, B, H, W, C, filter, alpha, stream);
}
