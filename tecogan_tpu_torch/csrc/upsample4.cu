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
//
// K2, the adjoint of K1 (its gradient), follows K1 in this file.
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

// Entry (4*src + phase, dst) of the (4n, n) stencil matrix: the phase's
// weights summed over the taps whose clamped source index is dst (edge rows
// and columns collect several taps). Dyadic sums, exact in float32.
template <int NT>
__device__ __forceinline__ float stencil_weight(int src, int phase, int dst, int n) {
  constexpr int OFF = NT == 2 ? 0 : -1;
  const float* w = NT == 2 ? kBilinear[phase] : kCatmullRom[phase];
  float s = 0.0f;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (min(max(src + OFF + t, 0), n - 1) == dst) s += w[t];
  }
  return s;
}

// K2: the adjoint of upsample4_kernel, dx = alpha * Sh^T g Sw^T per (b, c)
// plane, g (B, 4H, 4W, C) -> dx (B, H, W, C).
//
// Replaces tecogan_tpu/kernels/upsample4.py::_down_kernel (launched by
// _plane_call_down from the custom VJP _upsample4_bwd), two transposed
// banded matmuls on the TPU's matrix unit. Same rounding point: the H-adjoint
// sum hi[iy, ox] = sum_oy Sh[oy, iy] g[oy, ox] is taken in float32 and
// rounded to T, then dx[iy, ix] = sum_ox hi[iy, ox] Sw[ox, ix] in float32,
// times alpha, rounded once more.
//
// Gather form: one thread per dx element, no atomics. Source row i feeds
// dx row iy iff clamp(i + OFF + t) == iy for a tap t; all such i lie in
// [iy - OFF - NT + 1, iy - OFF] clipped to the image (the clamped edge taps
// included), so each thread walks at most NT source rows x 4 phases per
// axis: 4NT x 4NT g elements. Bound: like K1 by index math and loads that
// the L1 serves (each g element is read by NT^2 threads, more at the edges);
// dx is 1/16 of g. hi is recomputed per thread rather than staged in shared
// memory: a simple kernel first.
template <typename T, int NT>
__global__ void upsample4_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx,
                                     int B, int H, int W, int C, float alpha) {
  constexpr int OFF = NT == 2 ? 0 : -1;
  const int total = B * H * W * C;  // the wrapper keeps 16 * total < 2^31
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = idx % C;
  int t = idx / C;
  const int ix = t % W;
  t /= W;
  const int iy = t % H;
  const int b = t / H;
  const int i_lo = max(iy - OFF - NT + 1, 0), i_hi = min(iy - OFF, H - 1);
  const int j_lo = max(ix - OFF - NT + 1, 0), j_hi = min(ix - OFF, W - 1);
  const int row = 4 * W * C;  // elements per g row
  const T* plane = g + b * 16 * H * W * C + c;

  float acc = 0.0f;
  for (int j = j_lo; j <= j_hi; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float wq = stencil_weight<NT>(j, q, ix, W);
      if (wq == 0.0f) continue;
      const T* col_ptr = plane + (4 * j + q) * C;
      float hi = 0.0f;
      for (int i = i_lo; i <= i_hi; ++i) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float wp = stencil_weight<NT>(i, p, iy, H);
          hi += wp * tt::to_f32(col_ptr[(4 * i + p) * row]);
        }
      }
      acc += wq * tt::round_to<T>(hi);  // the H-adjoint pass is rounded to T
    }
  }
  dx[idx] = tt::from_f32<T>(alpha * acc);
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

// H, W are dx's (the low-resolution) sizes, as for the forward launch.
template <typename T>
int launch_bwd(const void* g, void* dx, int B, int H, int W, int C, int filter,
               float alpha, void* stream) {
  const int64_t total = static_cast<int64_t>(B) * H * W * C;
  if (16 * total >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* gp = static_cast<const T*>(g);
  T* dp = static_cast<T*>(dx);
  if (filter == 0) {
    upsample4_bwd_kernel<T, 2><<<blocks, kThreads, 0, s>>>(gp, dp, B, H, W, C, alpha);
  } else {
    upsample4_bwd_kernel<T, 4><<<blocks, kThreads, 0, s>>>(gp, dp, B, H, W, C, alpha);
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

// K2. g: (B, 4H, 4W, C), dx: (B, H, W, C).
extern "C" int tt_upsample4_bwd_f32(const void* g, void* dx, int B, int H, int W,
                                    int C, int filter, float alpha, void* stream) {
  return launch_bwd<float>(g, dx, B, H, W, C, filter, alpha, stream);
}

extern "C" int tt_upsample4_bwd_bf16(const void* g, void* dx, int B, int H, int W,
                                     int C, int filter, float alpha, void* stream) {
  return launch_bwd<__nv_bfloat16>(g, dx, B, H, W, C, filter, alpha, stream);
}
