// K1: fixed-stencil 4x upsample of an NHWC tensor, legacy-TF bilinear or
// Catmull-Rom (r = 0.75) bicubic, edge replicated.
//
// Replaces tecogan_tpu/kernels/upsample4.py::_matmul_kernel (launched by
// _plane_call), which computes out = Sh @ x @ Sw per channel plane with
// banded stencil matrices on the TPU's matrix unit. Here the stencil is
// applied directly: output (4i+p, 4j+q) = round_T(sum_tx Ww[q][tx] *
// round_T(sum_ty Wh[p][ty] * round_T(alpha x)[clamp(i+off+ty),
// clamp(j+off+tx)])), summed in float32 in tap order: the rounding of the
// Pallas kernel (upsample4.py:71-74) and of the plain version
// (tecogan_tpu_torch/ops/resize.py).
//
// Bound on the card: memory. x is read once and the 16x larger output
// written once; there are 2-4 FMAs per tap pass. So the design issues
// full 16-byte stores and does little work per byte:
// - a block owns a kTileH x kTileW input tile of one image, all C channels,
//   and writes its 4 kTileH x 4 kTileW x C output tile;
// - it stages the tile and its (NT-1)-pixel halo once, clamped at the
//   image border, as round_T(alpha x) in float32 in shared memory;
// - it computes the H pass once per (output row, staged column, channel),
//   the 4 phases of a staged row from the same NT loads, rounded to T;
// - it computes the W pass the same way into the tile's output rows in
//   shared memory, each row shifted by its global misalignment modulo 16
//   bytes, so that the store phase copies every output row with aligned
//   16-byte vectors, one row per warp, and scalar stores at a misaligned
//   head and a short tail (rows of 4 W C elements need not be a multiple
//   of 16 bytes, e.g. bfloat16 with C = 3 and W odd);
// - C = 2 (the flow) and C = 3 (the skip) are template constants, so the
//   index math has no runtime division; other C take a runtime path;
// - a grid of fewer than kMinBlocks big tiles (the skip: 108 tiles of a
//   144 x 180 frame) takes kTileHSmall rows a tile instead, to fill the SMs.
// tests/test_torch_upsample_plan.py emulates this plan in numpy and reads
// the constexpr lines below.
//
// K2, the adjoint of K1 (its gradient), follows K1 in this file.
#include "common.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kTileW = 32, kTileH = 8, kTileHSmall = 2;
constexpr int kMinBlocks = 264;
constexpr int kVecBytes = 16;
constexpr int kMaxSmem = 232448;

// Phase weights; all values are dyadic, hence exact in float32 and
// bfloat16. NT taps per axis: 2 (bilinear, offsets 0..1) or 4 (bicubic,
// offsets -1..2). K1 and K2 take them from this constexpr table: with p
// and t unrolled they fold to FMA immediates (read from constant memory
// instead, the bfloat16 K1 instantiations spilled and ran 2-4% slower on
// an H100).
template <int NT>
__host__ __device__ constexpr float tap_weight(int p, int t) {
  constexpr float w4[4][4] = {
      {0.0f, 1.0f, 0.0f, 0.0f},
      {-0.10546875f, 0.87890625f, 0.26171875f, -0.03515625f},
      {-0.09375f, 0.59375f, 0.59375f, -0.09375f},
      {-0.03515625f, 0.26171875f, 0.87890625f, -0.10546875f}};
  return NT == 2 ? (t == 0 ? 1.0f - 0.25f * p : 0.25f * p) : w4[p][t];
}

// Shared memory of a K1 block, in bytes, and its parts' offsets in floats:
// xs (th + NT - 1) x (kTileW + NT - 1) x C floats, hs 4 th x (kTileW + NT
// - 1) x C floats, then os, 4 th rows of k1_row_stride T elements,
// 16-byte aligned.
template <typename T>
__host__ __device__ constexpr int k1_row_stride(int C) {
  constexpr int vec = kVecBytes / static_cast<int>(sizeof(T));
  return (4 * kTileW * C + 2 * vec - 1) / vec * vec;
}

template <int NT>
__host__ __device__ constexpr int k1_os_offset(int th, int C) {
  return ((th + NT - 1) * (kTileW + NT - 1) * C + 4 * th * (kTileW + NT - 1) * C + 3) / 4 * 4;
}

template <typename T, int NT>
constexpr size_t k1_smem_bytes(int th, int C) {
  return 4 * static_cast<size_t>(k1_os_offset<NT>(th, C)) +
         sizeof(T) * 4 * th * static_cast<size_t>(k1_row_stride<T>(C));
}

// K1. CT: C as a template constant (2 or 3), or 0 for a runtime C. TH: the
// tile's input rows (kTileH or kTileHSmall). Grid (tiles across W, tiles
// across H, B).
template <typename T, int NT, int CT, int TH>
__global__ void __launch_bounds__(kThreads)
upsample4_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W,
                 int C_rt, float alpha) {
  // 32-bit index math: the wrapper keeps B * 16 * H * W * C below 2^31.
  constexpr int OFF = NT == 2 ? 0 : -1;
  constexpr int SW = kTileW + NT - 1, SH = TH + NT - 1;  // staged columns, rows
  constexpr int VEC = kVecBytes / static_cast<int>(sizeof(T));
  const int C = CT > 0 ? CT : C_rt;
  const int b = blockIdx.z, iy0 = blockIdx.y * TH, ix0 = blockIdx.x * kTileW;
  const int th = min(TH, H - iy0), tw = min(kTileW, W - ix0);
  const int RS = k1_row_stride<T>(C);
  const int row_elems = 4 * W * C;  // T elements of an output row

  extern __shared__ float4 smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* hs = xs + SH * SW * C;
  T* os = reinterpret_cast<T*>(reinterpret_cast<float*>(smem) + k1_os_offset<NT>(TH, C));

  // 1. Stage round_T(alpha x) of the tile and its halo, clamped.
  const T* xb = x + b * H * W * C;
  for (int i = threadIdx.x; i < SH * SW * C; i += kThreads) {
    const int c = i % C, t = i / C, sx = t % SW, sy = t / SW;
    const int gy = min(max(iy0 + OFF + sy, 0), H - 1);
    const int gx = min(max(ix0 + OFF + sx, 0), W - 1);
    xs[i] = tt::round_to<T>(alpha * tt::to_f32(xb[(gy * W + gx) * C + c]));
  }
  __syncthreads();

  // 2. The H pass: item (ry, sx, c) gives rows 4 ry + p of hs, p = 0..3.
  for (int i = threadIdx.x; i < TH * SW * C; i += kThreads) {
    float v[NT];
#pragma unroll
    for (int ty = 0; ty < NT; ++ty) v[ty] = xs[i + ty * SW * C];
    const int ry = i / (SW * C), rest = i - ry * SW * C;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float acc = tap_weight<NT>(p, 0) * v[0];
#pragma unroll
      for (int ty = 1; ty < NT; ++ty) acc = acc + tap_weight<NT>(p, ty) * v[ty];
      hs[(4 * ry + p) * SW * C + rest] = tt::round_to<T>(acc);
    }
  }
  __syncthreads();

  // 3. The W pass: item (r, ix, c) gives output pixels 4 ix + q of row r,
  // written to os at the row's misalignment a (global offset mod VEC).
  for (int i = threadIdx.x; i < 4 * TH * kTileW * C; i += kThreads) {
    const int c = i % C, t = i / C, ix = t % kTileW, r = t / kTileW;
    const unsigned g0 = static_cast<unsigned>(b * 4 * H + 4 * iy0 + r) *
                            static_cast<unsigned>(row_elems) +
                        static_cast<unsigned>(4 * ix0 * C);
    const int a = static_cast<int>(g0 % VEC);
    const float* h = hs + r * SW * C + ix * C + c;
    float v[NT];
#pragma unroll
    for (int tx = 0; tx < NT; ++tx) v[tx] = h[tx * C];
    T* o = os + r * RS + a + 4 * ix * C + c;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float acc = tap_weight<NT>(q, 0) * v[0];
#pragma unroll
      for (int tx = 1; tx < NT; ++tx) acc = acc + tap_weight<NT>(q, tx) * v[tx];
      o[q * C] = tt::from_f32<T>(acc);
    }
  }
  __syncthreads();

  // 4. Store: one output row per warp; its 4 tw C elements go out as a
  // scalar head up to the first 16-byte boundary, 16-byte vectors, and a
  // scalar tail.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int L = 4 * tw * C;
  for (int r = warp; r < 4 * th; r += kWarps) {
    const int g0 = (b * 4 * H + 4 * iy0 + r) * row_elems + 4 * ix0 * C;
    const int a = g0 % VEC;
    const int head = min((VEC - a) % VEC, L);
    const int nvec = (L - head) / VEC, tail = head + nvec * VEC;
    const T* src = os + r * RS + a;
    T* dst = out + g0;
    if (lane < head) dst[lane] = src[lane];
    for (int v = lane; v < nvec; v += 32) {
      const int e = head + v * VEC;
      *reinterpret_cast<uint4*>(dst + e) = *reinterpret_cast<const uint4*>(src + e);
    }
    if (tail + lane < L) dst[tail + lane] = src[tail + lane];
  }
}

template <typename T, int NT, int CT, int TH>
int launch_k1(const T* x, T* out, int B, int H, int W, int C, float alpha,
              cudaStream_t s) {
  const size_t smem = k1_smem_bytes<T, NT>(TH, C);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = upsample4_kernel<T, NT, CT, TH>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((W + kTileW - 1) / kTileW, (H + TH - 1) / TH, B);
  kernel<<<grid, kThreads, smem, s>>>(x, out, H, W, C, alpha);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NT, int CT>
int launch_k1_tile(const T* x, T* out, int B, int H, int W, int C, float alpha,
                   cudaStream_t s) {
  const long long big = static_cast<long long>((W + kTileW - 1) / kTileW) *
                        ((H + kTileH - 1) / kTileH) * B;
  if (big >= kMinBlocks && k1_smem_bytes<T, NT>(kTileH, C) <= kMaxSmem) {
    return launch_k1<T, NT, CT, kTileH>(x, out, B, H, W, C, alpha, s);
  }
  return launch_k1<T, NT, CT, kTileHSmall>(x, out, B, H, W, C, alpha, s);
}

template <typename T, int NT>
int launch_k1_channels(const T* x, T* out, int B, int H, int W, int C, float alpha,
                       cudaStream_t s) {
  if (C == 2) return launch_k1_tile<T, NT, 2>(x, out, B, H, W, C, alpha, s);
  if (C == 3) return launch_k1_tile<T, NT, 3>(x, out, B, H, W, C, alpha, s);
  return launch_k1_tile<T, NT, 0>(x, out, B, H, W, C, alpha, s);
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
// Bound on the card: memory, like K1 (g is 16x dx, a few FMAs a g element).
// Source row i feeds dx row iy with tap t where i + OFF + t = iy, and with
// the taps that the edge clamp sends onto iy when iy is 0 or n - 1 (edge
// rows and columns collect several taps). Design:
// - a block owns a kBwdTileH x kBwdTileW dx tile of one image, all C
//   channels, and reads the g rows that feed it once, each as one
//   contiguous segment of 4 (kBwdTileW + NT - 1) C elements: a thread owns
//   one element of that segment and walks the 4 (kBwdTileH + NT - 1) rows,
//   coalesced, keeping the tile's kBwdTileH H-adjoint sums in registers;
// - interior weights are tap_weight's constexpr table (source row s of
//   the staged rows feeds tile row s - k with tap NT - 1 - k); the clamped
//   taps go to two more sums, added onto row 0 and row H - 1 only where the
//   tile holds them;
// - the H-adjoint, rounded to T, goes to shared memory once per (dx row,
//   staged g column, channel); the W-adjoint reads it there the same way,
//   one thread per dx element, and stores contiguous dx rows;
// - C = 2 (the flow) and C = 3 (the skip) are template constants;
// - 4-row tiles: the training path's flow gradient, (36,128,128,2), takes
//   288 blocks (8-row tiles gave 144 and ran ~25% slower on an H100; at
//   the streaming geometry, which no path runs, they are ~4% faster).
// tests/test_torch_upsample_plan.py emulates this plan in numpy.
constexpr int kBwdTileH = 4, kBwdTileW = 32;
constexpr int kBwdMaxThreads = 512;

// Shared memory of a K2 block: hs, kBwdTileH x 4 (kBwdTileW + NT - 1) x C
// floats.
template <int NT>
constexpr size_t k2_smem_bytes(int C) {
  return sizeof(float) * kBwdTileH * 4 * (kBwdTileW + NT - 1) * static_cast<size_t>(C);
}

// Threads of a K2 block: one per staged g column element, in whole warps,
// at most kBwdMaxThreads.
template <int NT>
constexpr int k2_threads(int C) {
  const int cols = 4 * (kBwdTileW + NT - 1) * C;
  return cols >= kBwdMaxThreads ? kBwdMaxThreads : (cols + 31) / 32 * 32;
}

// Weight of source index i (phase p's tap t) on the clamped edge: sums into
// `low` when i + OFF + t < 0 (clamped onto 0) and into `high` when it is
// past n - 1 (clamped onto n - 1).
template <int NT>
__device__ __forceinline__ void clamped_taps(int i, int p, int n, float v, float& low,
                                             float& high) {
  constexpr int OFF = NT == 2 ? 0 : -1;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int u = i + OFF + t;
    if (u < 0) low += tap_weight<NT>(p, t) * v;
    if (u > n - 1) high += tap_weight<NT>(p, t) * v;
  }
}

// K2. CT: C as a template constant (2 or 3), or 0 for a runtime C. Grid
// (tiles across W, tiles across H, B); block k2_threads<NT>(C).
template <typename T, int NT, int CT>
__global__ void __launch_bounds__(kBwdMaxThreads)
upsample4_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx, int H, int W, int C_rt,
                     float alpha) {
  // 32-bit index math: the wrapper keeps B * 16 * H * W * C below 2^31.
  constexpr int OFF = NT == 2 ? 0 : -1;
  constexpr int TH = kBwdTileH, TW = kBwdTileW, SR = TH + NT - 1;  // staged LR rows
  const int C = CT > 0 ? CT : C_rt;
  const int b = blockIdx.z, iy0 = blockIdx.y * TH, ix0 = blockIdx.x * TW;
  const int i0 = iy0 - OFF - NT + 1, j0 = ix0 - OFF - NT + 1;  // first staged LR row, column
  const int SC = 4 * (TW + NT - 1) * C;  // staged g elements of a row
  extern __shared__ float4 smem[];
  float* hs = reinterpret_cast<float*>(smem);  // (TH, SC)

  // 1. The H-adjoint: thread e of the staged row segment, all staged rows.
  const bool edge_h = iy0 == 0 || iy0 + TH >= H;  // the tile holds row 0 or row H - 1
  const int row = 4 * W * C;                      // elements of a g row
  for (int e = threadIdx.x; e < SC; e += blockDim.x) {
    const int ox = 4 * j0 + e / C;
    const bool col_ok = ox >= 0 && ox < 4 * W;
    const T* col = g + (b * 16 * H * W + (col_ok ? ox : 0)) * C + e % C;
    float hi[TH], low = 0.0f, high = 0.0f;
#pragma unroll
    for (int r = 0; r < TH; ++r) hi[r] = 0.0f;
#pragma unroll
    for (int s = 0; s < SR; ++s) {
      const int i = i0 + s;
      if (i < 0 || i >= H || !col_ok) continue;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float v = tt::to_f32(col[(4 * i + p) * row]);
#pragma unroll
        for (int k = 0; k < NT; ++k) {
          if (s - k >= 0 && s - k < TH) hi[s - k] += tap_weight<NT>(p, NT - 1 - k) * v;
        }
        if (edge_h) clamped_taps<NT>(i, p, H, v, low, high);
      }
    }
#pragma unroll
    for (int r = 0; r < TH; ++r) {
      if (iy0 + r == 0) hi[r] += low;
      if (iy0 + r == H - 1) hi[r] += high;
      hs[r * SC + e] = tt::round_to<T>(hi[r]);
    }
  }
  __syncthreads();

  // 2. The W-adjoint: one thread per dx element (r, tx, c) of the tile.
  const bool edge_w = ix0 == 0 || ix0 + TW >= W;
  const int th = min(TH, H - iy0), tw = min(TW, W - ix0);
  for (int idx = threadIdx.x; idx < th * tw * C; idx += blockDim.x) {
    const int c = idx % C, t = idx / C, tx = t % tw, r = t / tw;
    const int ix = ix0 + tx;
    const float* h = hs + r * SC + c;
    float acc = 0.0f, low = 0.0f, high = 0.0f;
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const int j = ix - OFF - NT + 1 + k;  // staged column tx + k
      if (j < 0 || j >= W) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = h[(4 * (tx + k) + q) * C];
        acc += tap_weight<NT>(q, NT - 1 - k) * v;
        if (edge_w) clamped_taps<NT>(j, q, W, v, low, high);
      }
    }
    if (ix == 0) acc += low;
    if (ix == W - 1) acc += high;
    dx[((b * H + iy0 + r) * W + ix) * C + c] = tt::from_f32<T>(alpha * acc);
  }
}

template <typename T, int NT, int CT>
int launch_k2(const T* g, T* dx, int B, int H, int W, int C, float alpha, cudaStream_t s) {
  const size_t smem = k2_smem_bytes<NT>(C);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = upsample4_bwd_kernel<T, NT, CT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((W + kBwdTileW - 1) / kBwdTileW, (H + kBwdTileH - 1) / kBwdTileH, B);
  kernel<<<grid, k2_threads<NT>(C), smem, s>>>(g, dx, H, W, C, alpha);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NT>
int launch_k2_channels(const T* g, T* dx, int B, int H, int W, int C, float alpha,
                       cudaStream_t s) {
  if (C == 2) return launch_k2<T, NT, 2>(g, dx, B, H, W, C, alpha, s);
  if (C == 3) return launch_k2<T, NT, 3>(g, dx, B, H, W, C, alpha, s);
  return launch_k2<T, NT, 0>(g, dx, B, H, W, C, alpha, s);
}

// K1 (or K2, its adjoint); H, W are x's (dx's) sizes, the low-resolution
// ones, in both directions.
template <typename T, bool kAdjoint>
int launch(const void* in, void* out, int B, int H, int W, int C, int filter,
           float alpha, void* stream) {
  const int64_t total = static_cast<int64_t>(B) * 16 * H * W * C;
  if (total >= (int64_t{1} << 31) || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* ip = static_cast<const T*>(in);
  T* op = static_cast<T*>(out);
  if (kAdjoint) {
    return filter == 0 ? launch_k2_channels<T, 2>(ip, op, B, H, W, C, alpha, s)
                       : launch_k2_channels<T, 4>(ip, op, B, H, W, C, alpha, s);
  }
  return filter == 0 ? launch_k1_channels<T, 2>(ip, op, B, H, W, C, alpha, s)
                     : launch_k1_channels<T, 4>(ip, op, B, H, W, C, alpha, s);
}

}  // namespace

// filter: 0 = bilinear, 1 = bicubic. x: (B, H, W, C), out: (B, 4H, 4W, C).
extern "C" int tt_upsample4_f32(const void* x, void* out, int B, int H, int W,
                                int C, int filter, float alpha, void* stream) {
  return launch<float, false>(x, out, B, H, W, C, filter, alpha, stream);
}

extern "C" int tt_upsample4_bf16(const void* x, void* out, int B, int H, int W,
                                 int C, int filter, float alpha, void* stream) {
  return launch<__nv_bfloat16, false>(x, out, B, H, W, C, filter, alpha, stream);
}

// K2. g: (B, 4H, 4W, C), dx: (B, H, W, C).
extern "C" int tt_upsample4_bwd_f32(const void* g, void* dx, int B, int H, int W,
                                    int C, int filter, float alpha, void* stream) {
  return launch<float, true>(g, dx, B, H, W, C, filter, alpha, stream);
}

extern "C" int tt_upsample4_bwd_bf16(const void* g, void* dx, int B, int H, int W,
                                     int C, int filter, float alpha, void* stream) {
  return launch<__nv_bfloat16, true>(g, dx, B, H, W, C, filter, alpha, stream);
}
