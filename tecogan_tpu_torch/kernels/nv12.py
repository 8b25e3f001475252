"""NV12 -> RGB, the colour conversion of frames that the card's NVDEC
decodes (``data/video_nvdec.py``), and its plain PyTorch version.

Replaces no TPU kernel (the JAX package converts on the host, inside
``cv2.VideoCapture.read``): it is the port's own, because an H.264 or VP9
frame decoded by NVDEC lies on the card as an NV12 surface. The CUDA
kernel (``csrc/nv12_rgb.cu``) computes ``csrc/tecovideo_dsp.cpp:
picture_to_rgb``'s arithmetic, which gives cv2's frames bit for bit:
nearest chroma in surface coordinates, products ``(a * b) >> 16`` of
samples shifted left by 3 with coefficients in 1/8192. cv2 (its FFmpeg
backend and swscale) takes the coefficients from the stream's matrix
coefficients and range, so :func:`yuv_coefficients` derives them as
swscale does; BT.601 gives ``picture_to_rgb``'s ``kLimited`` and
``kFull``. It is bound by memory (1.5 bytes read and 3 written a pixel).

The surface is a (rows, pitch) uint8 tensor: ``luma_rows`` rows of luma,
then the interleaved U/V rows. :func:`nv12_to_rgb` is a registered operator,
``torch.ops.tecogan_torch.nv12_rgb`` (``kernels/ops.py``): on a CPU tensor
it runs :func:`nv12_to_rgb_plain`, on a CUDA tensor it launches the kernel
and counts the launch in ``nv12_to_rgb.launches``.
"""

from __future__ import annotations

import torch

from tecogan_tpu_torch.kernels import _build, ops

#: swscale's ff_yuv2rgb_coeffs (crv, cbu, cgu, cgv in 1/65536) by matrix
#: coefficients (the H.264 VUI's numbering, FFmpeg's AVColorSpace); None:
#: YCgCo, which swscale converts as BT.601.
_SWS_TABLE = ((117489, 138438, 13975, 34925), (117489, 138438, 13975, 34925),
              (104597, 132201, 25675, 53279), (104597, 132201, 25675, 53279),
              (104448, 132798, 24759, 53109), (104597, 132201, 25675, 53279),
              (104597, 132201, 25675, 53279), (117579, 136230, 16907, 35559), None,
              (110013, 140363, 12277, 42626), (110013, 140363, 12277, 42626))
#: Matrix coefficients 2: unspecified (BT.601 in swscale).
UNSPECIFIED = 2


def _round16(f: int) -> int:  # swscale's roundToInt16
    return max(-32768, min(32767, (f + (1 << 15)) >> 16))


def _cdiv(a: int, b: int) -> int:  # C's integer division, toward zero
    q = abs(a) // b
    return q if a >= 0 else -q


def yuv_coefficients(matrix: int = UNSPECIFIED, full_range: bool = False) -> tuple:
    """(y_coeff, y_offset, v2r, u2b, u2g, v2g) in 1/8192 as swscale's
    ``sws_setColorspaceDetails`` derives them for its SIMD path, from the
    matrix coefficients (out of range, or YCgCo: BT.601) and the range."""
    row = _SWS_TABLE[matrix] if 0 <= matrix < len(_SWS_TABLE) else None
    crv, cbu, cgu, cgv = row or _SWS_TABLE[5]
    cgu, cgv = -cgu, -cgv
    cy, oy = 1 << 16, 0
    if full_range:
        crv, cbu, cgu, cgv = (_cdiv(c * 224, 255) for c in (crv, cbu, cgu, cgv))
    else:
        cy, oy = _cdiv(cy * 255, 219), 16 << 16
    return (_round16(cy << 13), _round16(oy << 3),
            *(_round16(c << 13) for c in (crv, cbu, cgu, cgv)))


def _mulhi(a: torch.Tensor, b: int) -> torch.Tensor:
    return (a * b) >> 16


def nv12_to_rgb_plain(surface: torch.Tensor, luma_rows: int, left: int, top: int,
                      width: int, height: int, coeffs=None) -> torch.Tensor:
    """Plain version in int32 tensor ops: (height, width, 3) uint8 RGB of the
    display area of an NV12 ``surface`` (rows, pitch), with
    :func:`yuv_coefficients`' ``coeffs`` (default: BT.601, limited range)."""
    y_coeff, y_offset, v2r, u2b, u2g, v2g = coeffs or yuv_coefficients()
    dev = surface.device
    rows = torch.arange(top, top + height, device=dev)
    cols = torch.arange(left, left + width, device=dev)
    luma = surface[top:top + height, left:left + width].to(torch.int32)
    chroma = surface[luma_rows + (rows >> 1)].to(torch.int32)  # (height, pitch)
    u = (chroma[:, 2 * (cols >> 1)] << 3) - 1024
    v = (chroma[:, 2 * (cols >> 1) + 1] << 3) - 1024
    yy = _mulhi((luma << 3) - y_offset, y_coeff)
    rgb = torch.stack([yy + _mulhi(v, v2r),
                       yy + _mulhi(u, u2g) + _mulhi(v, v2g),
                       yy + _mulhi(u, u2b)], dim=-1)
    return rgb.clamp_(0, 255).to(torch.uint8)


def _check(surface: torch.Tensor, luma_rows: int, left: int, top: int, width: int,
           height: int, coeffs) -> None:
    if len(coeffs) != 6:
        raise ValueError(f"coeffs holds {len(coeffs)} values, not 6")
    if surface.dtype != torch.uint8 or surface.dim() != 2:
        raise TypeError(f"an NV12 surface is a (rows, pitch) uint8 tensor, not "
                        f"{surface.dtype} {tuple(surface.shape)}")
    rows, pitch = surface.shape
    if min(left, top) < 0 or width <= 0 or height <= 0 or left + width > pitch \
            or top + height > luma_rows or luma_rows + (top + height + 1) // 2 > rows:
        raise ValueError(f"display area ({left}, {top}, {width}x{height}) does not fit an "
                         f"NV12 surface of {rows} rows ({luma_rows} of luma) x {pitch} bytes")


def _body(surface: torch.Tensor, luma_rows: int, left: int, top: int, width: int,
          height: int, coeffs) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU one: the body
    of ``tecogan_torch::nv12_rgb``."""
    _check(surface, luma_rows, left, top, width, height, coeffs)
    if surface.device.type == "cpu":
        return nv12_to_rgb_plain(surface, luma_rows, left, top, width, height, coeffs)
    if surface.device.type != "cuda":
        raise ValueError(f"nv12_to_rgb runs on cpu or cuda, not {surface.device}")
    if surface.stride() != (surface.shape[1], 1):
        raise ValueError("nv12_to_rgb needs a contiguous surface")
    if surface.device.index != torch.cuda.current_device():
        raise ValueError(f"{surface.device} is not the current CUDA device")
    out = torch.empty((height, width, 3), dtype=torch.uint8, device=surface.device)
    err = _build.library().tt_nv12_rgb(
        surface.data_ptr(), surface.shape[1], luma_rows, left, top, width, height, *coeffs,
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "nv12_to_rgb")
    ops.count(nv12_to_rgb)
    return out


def _fake(surface, luma_rows, left, top, width, height, coeffs):
    return surface.new_empty((height, width, 3))


ops.register("nv12_rgb(Tensor surface, int luma_rows, int left, int top, int width, "
             "int height, int[] coeffs) -> Tensor", _body, _fake)


def nv12_to_rgb(surface: torch.Tensor, luma_rows: int, left: int, top: int, width: int,
                height: int, coeffs=None) -> torch.Tensor:
    """(height, width, 3) uint8 RGB of the display area (left, top, width,
    height) of an NV12 ``surface`` whose luma has ``luma_rows`` rows, with
    :func:`yuv_coefficients`' ``coeffs`` (default: BT.601, limited range)."""
    coeffs = [int(c) for c in (coeffs or yuv_coefficients())]
    return torch.ops.tecogan_torch.nv12_rgb(surface, int(luma_rows), int(left), int(top),
                                            int(width), int(height), coeffs)


nv12_to_rgb.launches = 0  # kernel launches (CUDA tensors only)
