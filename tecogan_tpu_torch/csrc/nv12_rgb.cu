// NV12 -> packed RGB24: the colour conversion of a frame that the card's
// NVDEC decoded (H.264, VP9), as cv2.VideoCapture gives it.
//
// Replaces no TPU kernel: the JAX package reads video through OpenCV on the
// host (tecogan_tpu/data/video_io.py:read_video_frames), whose FFmpeg
// backend converts with swscale's unscaled yuv2rgb path. The port decodes
// H.264 and VP9 on the card, where the decoded picture already lies, so it
// converts there too; the arithmetic is csrc/tecovideo_dsp.cpp's
// picture_to_rgb (the host conversion of the port's own codecs), bit for
// bit: each chroma sample serves the luma samples it covers (nearest), and
// every product is mulhi(a, b) = (a * b) >> 16 of a sample shifted left by
// 3 with coefficients in 1/8192. The wrapper (kernels/nv12.py) derives the
// coefficients from the stream's matrix coefficients and range as swscale
// does (cv2 applies both); BT.601 gives picture_to_rgb's kLimited and kFull.
//
// Input: a pitch-linear NV12 surface (the mapped frame: luma_rows rows of
// luma, then the interleaved U/V rows, both `pitch` bytes apart) and the
// display area (left, top, width, height) inside it. Chroma is addressed in
// surface coordinates, (x >> 1, y >> 1), so an odd crop offset takes the
// chroma sample its pixel lies on.
//
// Bound on the card: memory. 1.5 bytes a pixel read (luma and half a
// chroma pair), 3 written, a dozen integer operations a pixel. A simple
// kernel is enough: one thread per output pixel pair (the pair shares its
// chroma row), a block row per output row, byte stores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct Coeffs {
  int y_coeff, y_offset, v2r, u2b, u2g, v2g;
};

__device__ __forceinline__ int mulhi(int a, int b) { return (a * b) >> 16; }
__device__ __forceinline__ uint8_t clip_u8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

__global__ void __launch_bounds__(kThreads)
    nv12_rgb_kernel(const uint8_t* __restrict__ luma, const uint8_t* __restrict__ chroma,
                    int pitch, int left, int top, int width, int height, Coeffs k,
                    uint8_t* __restrict__ out) {
  const int y = blockIdx.y;
  const int x0 = 2 * (blockIdx.x * kThreads + threadIdx.x);
  if (x0 >= width || y >= height) return;
  const int sy = top + y;
  const uint8_t* lrow = luma + static_cast<size_t>(sy) * pitch;
  const uint8_t* crow = chroma + static_cast<size_t>(sy >> 1) * pitch;
  uint8_t* o = out + (static_cast<size_t>(y) * width + x0) * 3;
#pragma unroll
  for (int j = 0; j < 2; j++) {
    const int x = x0 + j;
    if (x >= width) break;
    const int sx = left + x;
    const int u = (crow[2 * (sx >> 1)] << 3) - 1024;
    const int v = (crow[2 * (sx >> 1) + 1] << 3) - 1024;
    const int yy = mulhi((lrow[sx] << 3) - k.y_offset, k.y_coeff);
    o[3 * j + 0] = clip_u8(yy + mulhi(v, k.v2r));
    o[3 * j + 1] = clip_u8(yy + mulhi(u, k.u2g) + mulhi(v, k.v2g));
    o[3 * j + 2] = clip_u8(yy + mulhi(u, k.u2b));
  }
}

}  // namespace

// surface: luma_rows rows of luma then the U/V rows, `pitch` bytes apart;
// out: (height, width, 3) uint8. Returns cudaGetLastError() after the launch.
extern "C" int tt_nv12_rgb(const void* surface, int pitch, int luma_rows, int left, int top,
                           int width, int height, int y_coeff, int y_offset, int v2r, int u2b,
                           int u2g, int v2g, void* out, void* stream) {
  if (width <= 0 || height <= 0) return cudaSuccess;
  const uint8_t* luma = static_cast<const uint8_t*>(surface);
  const uint8_t* chroma = luma + static_cast<size_t>(pitch) * luma_rows;
  const dim3 grid((width + 2 * kThreads - 1) / (2 * kThreads), height);
  nv12_rgb_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      luma, chroma, pitch, left, top, width, height,
      Coeffs{y_coeff, y_offset, v2r, u2b, u2g, v2g}, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
