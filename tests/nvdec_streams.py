"""Test streams of the port's H.264 and VP9 input (``data/video_nvdec.py``,
the NV12 kernel ``kernels/nv12.py``), shared by the CPU tests
(``tests/test_torch_nvdec.py``), the card tests (``tests/test_torch_cuda.py``)
and ``chip_smoke.py`` phase 15, which loads this file by path.

- :class:`H264Stream`: hand-written H.264 streams (no encoder is at hand):
  I_PCM pictures, P slices of P_L0_16x16 with integer motion vectors and
  P_Skip, Main-profile B slices (bi-prediction) with POC type 0, a cropped
  144x180 size, and VUI full range with BT.709 matrix coefficients; each
  muxed into MP4 (avc1 + avcC, stss, ctts) and MKV, with a numpy model of
  the decode whose frames the CPU tests hold to OpenCV's on every run;
- the VP9 fixture written by libvpx and the SHA-256 of each frame the JAX
  package reads from it (``tests/test_torch_nvdec.py:make_vp9_fixture``);
- :class:`ModelNvdec`: the streams' model in place of the NVDEC binding,
  for the reader, the NV12 kernel and the CLIs where no NVDEC decodes.

It imports numpy alone; torch and the port's plain NV12 version are
imported when frames are converted.
"""

import hashlib
import json
import re
import struct
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
VP9_FIXTURE = HERE / "data" / "vp9_scene_144x180.webm"
VP9_SHA256 = HERE / "data" / "vp9_scene_144x180.sha256.json"
FPS = 25


# ---------------------------------------------------------------- bits
class BitWriter:
    """MSB-first bits; ``raw`` appends whole bytes at a byte boundary."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def u(self, value: int, bits: int) -> None:
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.n += bits
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.acc >> self.n) & 0xFF)
        self.acc &= (1 << self.n) - 1

    def ue(self, value: int) -> None:
        v = value + 1
        k = v.bit_length()
        self.u(0, k - 1)
        self.u(v, k)

    def se(self, value: int) -> None:
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def align(self) -> None:
        if self.n:
            self.u(0, 8 - self.n)

    def raw(self, data: bytes) -> None:
        assert self.n == 0
        self.out += data

    def rbsp(self) -> bytes:
        """The bytes with rbsp_trailing_bits."""
        self.u(1, 1)
        self.align()
        return bytes(self.out)


def nal(ref_idc: int, kind: int, rbsp: bytes) -> bytes:
    """A NAL unit: the header byte, then the payload with emulation
    prevention (0x03 after two zero bytes that a byte <= 3 follows)."""
    return bytes([(ref_idc << 5) | kind]) + re.sub(b"\x00\x00(?=[\x00-\x03])",
                                                   b"\x00\x00\x03", rbsp)


# ---------------------------------------------------------------- streams
# A stream: its SPS fields and, per frame in decode order, its slice type,
# display index, and (for P and B) each macroblock's prediction.
STREAMS = {
    # (i) IDR I_PCM pictures, Baseline, POC type 2.
    "i_pcm": dict(h=48, w=64, frames="IIII", profile=66, seed=1),
    # (ii) I_PCM, then P slices: P_L0_16x16 with integer motion vectors
    # (odd ones: half-sample chroma) and P_Skip; a cropped bottom edge.
    "p_mv": dict(h=100, w=80, frames="IPPPPPP", profile=66, seed=2),
    # (iii) Main with B slices (bi-prediction, L0, L1), POC type 0: the
    # display order differs from the decode order; two GOPs of 9.
    "b_main": dict(h=64, w=96, frames="b", profile=77, seed=3),
    # (iv) 144x180, cropped from 144x192.
    "crop": dict(h=144, w=180, frames="IPPPP", profile=66, seed=4),
    # (v) VUI video_full_range_flag = 1 and matrix_coefficients = 1 (BT.709).
    "full709": dict(h=64, w=64, frames="IPP", profile=66, seed=5, full_range=1, matrix=1),
}
# The B-stream's GOP: display indices in decode order, and their types.
B_GOP = ((0, "I"), (3, "P"), (1, "B"), (2, "B"), (6, "P"), (4, "B"), (5, "B"), (8, "P"),
         (7, "B"))


def _sps(p: dict, mbw: int, mbh: int) -> bytes:
    b = BitWriter()
    b.u(p["profile"], 8)
    b.u(0xC0 if p["profile"] == 66 else 0x40, 8)  # constraint flags
    b.u(40, 8)  # level 4.0
    b.ue(0)  # seq_parameter_set_id
    b.ue(0)  # log2_max_frame_num_minus4: 4-bit frame_num
    b.ue(p["poc_type"])
    if p["poc_type"] == 0:
        b.ue(4)  # log2_max_pic_order_cnt_lsb_minus4: 8 bits
    b.ue(p["refs"])  # max_num_ref_frames
    b.u(0, 1)  # gaps_in_frame_num_value_allowed_flag
    b.ue(mbw - 1)
    b.ue(mbh - 1)
    b.u(1, 1)  # frame_mbs_only_flag
    b.u(1, 1)  # direct_8x8_inference_flag
    crop_r, crop_b = (16 * mbw - p["w"]) // 2, (16 * mbh - p["h"]) // 2
    b.u(int(bool(crop_r or crop_b)), 1)
    if crop_r or crop_b:
        for v in (0, crop_r, 0, crop_b):
            b.ue(v)
    signal = "full_range" in p
    reorder = p["poc_type"] == 0
    b.u(int(signal or reorder), 1)  # vui_parameters_present_flag
    if signal or reorder:
        b.u(0, 1)  # aspect_ratio_info_present_flag
        b.u(0, 1)  # overscan_info_present_flag
        b.u(int(signal), 1)  # video_signal_type_present_flag
        if signal:
            b.u(5, 3)  # video_format: unspecified
            b.u(p["full_range"], 1)
            b.u(1, 1)  # colour_description_present_flag
            b.u(p["matrix"], 8)  # colour_primaries
            b.u(p["matrix"], 8)  # transfer_characteristics
            b.u(p["matrix"], 8)  # matrix_coefficients
        b.u(0, 1)  # chroma_loc_info_present_flag
        b.u(0, 1)  # timing_info_present_flag
        b.u(0, 1)  # nal_hrd_parameters_present_flag
        b.u(0, 1)  # vcl_hrd_parameters_present_flag
        b.u(0, 1)  # pic_struct_present_flag
        b.u(int(reorder), 1)  # bitstream_restriction_flag
        if reorder:
            b.u(1, 1)  # motion_vectors_over_pic_boundaries_flag
            b.ue(0)  # max_bytes_per_pic_denom
            b.ue(0)  # max_bits_per_mb_denom
            b.ue(16)  # log2_max_mv_length_horizontal
            b.ue(16)  # log2_max_mv_length_vertical
            b.ue(1)  # max_num_reorder_frames
            b.ue(2)  # max_dec_frame_buffering
    return nal(3, 7, b.rbsp())


def _pps() -> bytes:
    b = BitWriter()
    b.ue(0)  # pic_parameter_set_id
    b.ue(0)  # seq_parameter_set_id
    b.u(0, 1)  # entropy_coding_mode_flag: CAVLC
    b.u(0, 1)  # bottom_field_pic_order_in_frame_present_flag
    b.ue(0)  # num_slice_groups_minus1
    b.ue(0)  # num_ref_idx_l0_default_active_minus1
    b.ue(0)  # num_ref_idx_l1_default_active_minus1
    b.u(0, 1)  # weighted_pred_flag
    b.u(0, 2)  # weighted_bipred_idc
    b.se(0)  # pic_init_qp_minus26
    b.se(0)  # pic_init_qs_minus26
    b.se(0)  # chroma_qp_index_offset
    b.u(1, 1)  # deblocking_filter_control_present_flag
    b.u(0, 1)  # constrained_intra_pred_flag
    b.u(0, 1)  # redundant_pic_cnt_present_flag
    return nal(3, 8, b.rbsp())


class Picture:
    """Decoded 4:2:0 planes at the coded (macroblock) size."""

    def __init__(self, y, u, v):
        self.y, self.u, self.v = y, u, v


def _median(a, b, c):
    return tuple(int(sorted(t)[1]) for t in zip(a, b, c))


def _mv_pred(ref, mv, lst, mx, my, mbw):
    """8.4.1.3: the motion vector predictor of a 16x16 partition in list
    ``lst`` (reference index 0) from neighbours A (left), B (above) and C
    (above right, else D above left); ``ref[lst][y][x]`` is -1 where a
    macroblock does not use the list."""
    def at(x, y):
        return (int(ref[lst][y][x]), tuple(int(c) for c in mv[lst][y][x]))

    a = at(mx - 1, my) if mx > 0 else None
    b = at(mx, my - 1) if my > 0 else None
    c = at(mx + 1, my - 1) if my > 0 and mx + 1 < mbw else None
    if c is None:
        c = at(mx - 1, my - 1) if mx > 0 and my > 0 else None
    if b is None and c is None and a is not None:
        b = c = a
    a, b, c = (n if n is not None else (-1, (0, 0)) for n in (a, b, c))
    match = [n[1] for n in (a, b, c) if n[0] == 0]
    if len(match) == 1:
        return match[0]
    return _median(a[1], b[1], c[1])


def _skip_mv(ref, mv, mx, my, mbw):
    """8.4.1.1: P_Skip's motion vector."""
    if mx == 0 or my == 0:
        return (0, 0)
    for x, y in ((mx - 1, my), (mx, my - 1)):
        if ref[0][y][x] == 0 and tuple(mv[0][y][x]) == (0, 0):
            return (0, 0)
    return _mv_pred(ref, mv, 0, mx, my, mbw)


def _predict(pic: Picture, mx: int, my: int, mv):
    """A 16x16 luma and two 8x8 chroma predictions at an integer luma motion
    vector (quarter samples, a multiple of 4), the reference's edges
    replicated; chroma (1/8 samples) bilinear (8.4.2.2.2)."""
    dx, dy = mv
    hh, ww = pic.y.shape
    rows = np.clip(16 * my + (dy >> 2) + np.arange(16), 0, hh - 1)
    cols = np.clip(16 * mx + (dx >> 2) + np.arange(16), 0, ww - 1)
    luma = pic.y[rows][:, cols].astype(np.int32)
    ch, cw = pic.u.shape
    xi, xf = 8 * mx + (dx >> 3) + np.arange(8), dx & 7
    yi, yf = 8 * my + (dy >> 3) + np.arange(8), dy & 7
    x0, x1 = np.clip(xi, 0, cw - 1), np.clip(xi + 1, 0, cw - 1)
    y0, y1 = np.clip(yi, 0, ch - 1), np.clip(yi + 1, 0, ch - 1)
    chroma = []
    for plane in (pic.u, pic.v):
        p = plane.astype(np.int32)
        chroma.append(((8 - xf) * (8 - yf) * p[y0][:, x0] + xf * (8 - yf) * p[y0][:, x1]
                       + (8 - xf) * yf * p[y1][:, x0] + xf * yf * p[y1][:, x1] + 32) >> 6)
    return luma, chroma[0], chroma[1]


class H264Stream:
    """One hand-written stream: its NAL units per packet (decode order), the
    pictures a decoder reconstructs, and the display order."""

    def __init__(self, name: str, h: int = None, w: int = None, frames: int = None):
        p = dict(STREAMS[name])
        if h is not None:
            p["h"], p["w"] = h, w
        self.name, self.p = name, p
        self.h, self.w = p["h"], p["w"]
        self.mbw, self.mbh = -(-self.w // 16), -(-self.h // 16)
        rng = np.random.default_rng(p["seed"])
        if p["frames"] == "b":
            gops = 2 if frames is None else -(-frames // len(B_GOP))
            plan = [(9 * g + d, t) for g in range(gops) for d, t in B_GOP]
            p["poc_type"], p["refs"] = 0, 2
        else:
            kinds = p["frames"] if frames is None else ("I" + "P" * (frames - 1))
            plan = [(i, t) for i, t in enumerate(kinds)]
            p["poc_type"], p["refs"] = 2, 1
        self.sps, self.pps = _sps(p, self.mbw, self.mbh), _pps()
        self.packets, self.keys, self.display, self.pictures = [], [], [], []
        refs = []  # reference pictures in decode order: (display index, Picture)
        frame_num = 0
        idr_id = 0
        for i, (disp, kind) in enumerate(plan):
            idr = kind == "I"
            if idr:
                refs, frame_num, gop_start = [], 0, disp
            is_ref = kind != "B"
            b = BitWriter()
            b.ue(0)  # first_mb_in_slice
            b.ue({"I": 7, "P": 5, "B": 6}[kind])  # slice_type (all slices alike)
            b.ue(0)  # pic_parameter_set_id
            b.u(frame_num, 4)
            if idr:
                b.ue(idr_id)
                idr_id ^= 1
            if p["poc_type"] == 0:
                b.u((2 * (disp - gop_start)) & 0xFF, 8)
            if kind == "B":
                b.u(1, 1)  # direct_spatial_mv_pred_flag (no direct macroblocks)
            if kind != "I":
                b.u(0, 1)  # num_ref_idx_active_override_flag
                b.u(0, 1)  # ref_pic_list_modification_flag_l0
                if kind == "B":
                    b.u(0, 1)  # ref_pic_list_modification_flag_l1
            if is_ref:
                if idr:
                    b.u(0, 1)  # no_output_of_prior_pics_flag
                    b.u(0, 1)  # long_term_reference_flag
                else:
                    b.u(0, 1)  # adaptive_ref_pic_marking_mode_flag
            b.se(0)  # slice_qp_delta
            b.ue(1)  # disable_deblocking_filter_idc
            if kind == "I":
                pic = self._intra(b, rng)
            elif kind == "P":
                pic = self._inter_p(b, rng, refs[-1][1])
            else:
                past = max((r for r in refs if r[0] < disp), key=lambda r: r[0])
                future = min((r for r in refs if r[0] > disp), key=lambda r: r[0])
                pic = self._inter_b(b, rng, past[1], future[1])
            packet = [self.sps, self.pps] if i == 0 else []
            packet.append(nal(2 if is_ref else 0, 5 if idr else 1, b.rbsp()))
            self.packets.append(packet)
            self.keys.append(idr)
            self.display.append(disp)
            self.pictures.append(pic)
            if is_ref:
                refs = (refs + [(disp, pic)])[-p["refs"]:]
                frame_num = (frame_num + 1) % 16
        self.count = len(plan)

    def _intra(self, b: BitWriter, rng) -> Picture:
        """Every macroblock I_PCM: mb_type 25, zero bits to the byte, then
        256 luma and 2 x 64 chroma samples as bytes."""
        hh, ww = 16 * self.mbh, 16 * self.mbw
        yy, xx = np.mgrid[0:hh, 0:ww]
        phase = rng.uniform(0, 6.28, 3)
        y = np.clip(128 + 90 * np.sin(xx / 9.0 + phase[0]) * np.cos(yy / 7.0)
                    + rng.normal(0, 12, (hh, ww)), 0, 255).astype(np.uint8)
        cy, cx = np.mgrid[0:hh // 2, 0:ww // 2]
        u = np.clip(128 + 70 * np.sin(cx / 5.0 + phase[1]) + rng.normal(0, 8, cy.shape), 0,
                    255).astype(np.uint8)
        v = np.clip(128 + 70 * np.cos(cy / 4.0 + phase[2]) + rng.normal(0, 8, cy.shape), 0,
                    255).astype(np.uint8)
        for my in range(self.mbh):
            for mx in range(self.mbw):
                b.ue(25)  # I_PCM
                b.align()  # pcm_alignment_zero_bit
                b.raw(y[16 * my:16 * my + 16, 16 * mx:16 * mx + 16].tobytes()
                      + u[8 * my:8 * my + 8, 8 * mx:8 * mx + 8].tobytes()
                      + v[8 * my:8 * my + 8, 8 * mx:8 * mx + 8].tobytes())
        return Picture(y, u, v)

    def _mb_fields(self):
        shape = (2, self.mbh, self.mbw)
        return np.full(shape, -1, np.int32), np.zeros(shape + (2,), np.int32)

    def _random_mv(self, rng):
        return tuple(int(4 * rng.integers(-9, 10)) for _ in range(2))

    def _inter_p(self, b: BitWriter, rng, refpic: Picture) -> Picture:
        """P_L0_16x16 with integer vectors (no residual: coded_block_pattern
        0), and P_Skip runs."""
        ref, mv = self._mb_fields()
        out = Picture(*(np.empty_like(a) for a in (refpic.y, refpic.u, refpic.v)))
        skip_run = 0
        for my in range(self.mbh):
            for mx in range(self.mbw):
                if rng.random() < 0.3:
                    vec = _skip_mv(ref, mv, mx, my, self.mbw)
                    skip_run += 1
                else:
                    vec = self._random_mv(rng)
                    pred = _mv_pred(ref, mv, 0, mx, my, self.mbw)
                    b.ue(skip_run)
                    skip_run = 0
                    b.ue(0)  # P_L0_16x16
                    b.se(vec[0] - pred[0])
                    b.se(vec[1] - pred[1])
                    b.ue(0)  # coded_block_pattern 0
                ref[0][my][mx], mv[0][my][mx] = 0, vec
                self._put(out, mx, my, _predict(refpic, mx, my, vec))
        if skip_run:
            b.ue(skip_run)
        return out

    def _inter_b(self, b: BitWriter, rng, past: Picture, future: Picture) -> Picture:
        """B_L0_16x16, B_L1_16x16 and B_Bi_16x16 with integer vectors, no
        skipped or direct macroblocks; bi-prediction (a + b + 1) >> 1."""
        ref, mv = self._mb_fields()
        out = Picture(*(np.empty_like(a) for a in (past.y, past.u, past.v)))
        for my in range(self.mbh):
            for mx in range(self.mbw):
                mb_type = int(rng.integers(1, 4))  # 1 L0, 2 L1, 3 Bi
                lists = [0] if mb_type == 1 else [1] if mb_type == 2 else [0, 1]
                b.ue(0)  # mb_skip_run
                b.ue(mb_type)
                vecs = {}
                for lst in lists:
                    vecs[lst] = self._random_mv(rng)
                    pred = _mv_pred(ref, mv, lst, mx, my, self.mbw)
                    b.se(vecs[lst][0] - pred[0])
                    b.se(vecs[lst][1] - pred[1])
                    ref[lst][my][mx], mv[lst][my][mx] = 0, vecs[lst]
                b.ue(0)  # coded_block_pattern 0
                preds = [_predict(past if lst == 0 else future, mx, my, vecs[lst])
                         for lst in lists]
                if len(preds) == 2:
                    preds = [tuple((a + c + 1) >> 1 for a, c in zip(*preds))]
                self._put(out, mx, my, preds[0])
        return out

    @staticmethod
    def _put(pic: Picture, mx: int, my: int, pred) -> None:
        pic.y[16 * my:16 * my + 16, 16 * mx:16 * mx + 16] = pred[0]
        pic.u[8 * my:8 * my + 8, 8 * mx:8 * mx + 8] = pred[1]
        pic.v[8 * my:8 * my + 8, 8 * mx:8 * mx + 8] = pred[2]

    # -- what a decoder gives
    def display_pictures(self):
        order = np.argsort(self.display, kind="stable")
        return [self.pictures[i] for i in order]

    def nv12(self, pic: Picture) -> np.ndarray:
        """The picture as an NV12 surface (rows, pitch): luma, then U/V."""
        uv = np.stack([pic.u, pic.v], -1).reshape(pic.u.shape[0], -1)
        return np.concatenate([pic.y, uv], 0)

    def colour(self):
        """(matrix coefficients, full range) as the SPS's VUI states them."""
        return self.p.get("matrix", 2), bool(self.p.get("full_range", 0))

    def expected_rgb(self, convert=None) -> np.ndarray:
        """(T, h, w, 3) RGB in display order: the display area of each
        picture through ``convert(surface, luma_rows, h, w, coeffs)``
        (default: the NV12 kernel's plain version) with the coefficients
        swscale takes for the stream's colour."""
        import torch

        from tecogan_tpu_torch.kernels.nv12 import nv12_to_rgb_plain, yuv_coefficients

        if convert is None:
            def convert(surface, luma_rows, h, w, coeffs):
                return nv12_to_rgb_plain(torch.from_numpy(surface), luma_rows, 0, 0, w, h,
                                         coeffs).numpy()
        coeffs = yuv_coefficients(*self.colour())
        return np.stack([convert(self.nv12(pic), 16 * self.mbh, self.h, self.w, coeffs)
                         for pic in self.display_pictures()])

    # -- files
    def annexb(self) -> bytes:
        return b"".join(b"\x00\x00\x00\x01" + n for packet in self.packets for n in packet)

    def _samples(self):
        """Each packet as MP4/MKV stores it: length-prefixed NAL units
        without the parameter sets (those go to the avcC)."""
        return [b"".join(struct.pack(">I", len(n)) + n for n in packet
                         if n[0] & 0x1F not in (7, 8)) for packet in self.packets]

    def avcc(self) -> bytes:
        return (bytes([1, self.sps[1], self.sps[2], self.sps[3], 0xFF, 0xE1])
                + struct.pack(">H", len(self.sps)) + self.sps + b"\x01"
                + struct.pack(">H", len(self.pps)) + self.pps)

    def write(self, path) -> str:
        path = str(path)
        if path.endswith(".mp4"):
            data = mp4_file(self._samples(), self.keys, self.display, self.w, self.h,
                            b"avc1", _box(b"avcC", self.avcc()))
        elif path.endswith((".mkv", ".webm")):
            data = mkv_file(self._samples(), self.keys, self.display, self.w, self.h,
                            b"V_MPEG4/ISO/AVC", self.avcc())
        else:
            data = self.annexb()
        with open(path, "wb") as f:
            f.write(data)
        return path


# ---------------------------------------------------------------- MP4
def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def _full(kind: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags) + payload)


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def mp4_file(samples, keys, display, w, h, entry: bytes, config: bytes,
             timescale: int = 12800) -> bytes:
    """ftyp, mdat and moov of one video track: ``samples`` in decode order,
    ``stss`` from ``keys``, and a ``ctts`` where the display order differs
    (offsets made non-negative by a one-frame delay, as muxers do)."""
    delta = timescale // FPS
    n = len(samples)
    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2avc1mp41")
    mdat_off = len(ftyp) + 8
    mdat = _box(b"mdat", b"".join(samples))
    dur = n * delta
    sample_entry = (b"\0" * 6 + struct.pack(">H", 1) + b"\0" * 16 + struct.pack(">HH", w, h)
                    + struct.pack(">II", 0x480000, 0x480000) + b"\0" * 4
                    + struct.pack(">H", 1) + b"\0" * 32 + struct.pack(">Hh", 0x18, -1) + config)
    stbl = [_full(b"stsd", 0, 0, struct.pack(">I", 1) + _box(entry, sample_entry)),
            _full(b"stts", 0, 0, struct.pack(">III", 1, n, delta))]
    if list(display) != sorted(display):
        offs = [(d - i + 1) * delta for i, d in enumerate(display)]
        assert min(offs) >= 0
        stbl.append(_full(b"ctts", 0, 0, struct.pack(">I", n) + b"".join(
            struct.pack(">II", 1, o) for o in offs)))
    stbl += [_full(b"stss", 0, 0, struct.pack(">I", sum(keys)) + b"".join(
                 struct.pack(">I", i + 1) for i, k in enumerate(keys) if k)),
             _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1)),
             _full(b"stsz", 0, 0, struct.pack(">II", 0, n) + b"".join(
                 struct.pack(">I", len(s)) for s in samples)),
             _full(b"stco", 0, 0, struct.pack(">II", 1, mdat_off))]
    minf = _box(b"minf", _full(b"vmhd", 0, 1, b"\0" * 8)
                + _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1)
                                      + _full(b"url ", 0, 1, b"")))
                + _box(b"stbl", b"".join(stbl)))
    mdia = _box(b"mdia", _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale, dur,
                                                          0x55C4, 0))
                + _full(b"hdlr", 0, 0, b"\0" * 4 + b"vide" + b"\0" * 12 + b"VideoHandler\0")
                + minf)
    tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, dur * 1000 // timescale)
                 + b"\0" * 8 + struct.pack(">hhhH", 0, 0, 0, 0) + _MATRIX
                 + struct.pack(">II", w << 16, h << 16))
    mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIIIIH", 0, 0, 1000, dur * 1000 // timescale,
                                            0x10000, 0x100) + b"\0" * 10 + _MATRIX
                 + b"\0" * 24 + struct.pack(">I", 2))
    return ftyp + mdat + _box(b"moov", mvhd + _box(b"trak", tkhd + mdia))


# ---------------------------------------------------------------- Matroska
def _ebml(eid: int, payload: bytes) -> bytes:
    ident = eid.to_bytes((eid.bit_length() + 7) // 8, "big")
    return ident + bytes([0x01]) + len(payload).to_bytes(7, "big") + payload


def _uint(eid: int, value: int) -> bytes:
    return _ebml(eid, value.to_bytes(max(1, (value.bit_length() + 7) // 8), "big"))


def mkv_file(samples, keys, display, w, h, codec_id: bytes, private: bytes) -> bytes:
    """EBML header, Info, Tracks and one Cluster of SimpleBlocks (in decode
    order, timecodes in display order, milliseconds)."""
    head = _ebml(0x1A45DFA3, _uint(0x4286, 1) + _uint(0x42F7, 1) + _uint(0x42F2, 4)
                 + _uint(0x42F3, 8) + _ebml(0x4282, b"matroska") + _uint(0x4287, 4)
                 + _uint(0x4285, 2))
    info = _ebml(0x1549A966, _uint(0x2AD7B1, 1000000) + _ebml(0x4D80, b"tecogan tests")
                 + _ebml(0x5741, b"tecogan tests"))
    track = _ebml(0xAE, _uint(0xD7, 1) + _uint(0x73C5, 1) + _uint(0x83, 1)
                  + _ebml(0x86, codec_id) + _ebml(0x63A2, private)
                  + _uint(0x23E383, 1000000000 // FPS)
                  + _ebml(0xE0, _uint(0xB0, w) + _uint(0xBA, h)))
    blocks = b"".join(_ebml(0xA3, b"\x81" + struct.pack(">hB", d * 1000 // FPS,
                                                          0x80 if k else 0) + s)
                      for s, k, d in zip(samples, keys, display))
    cluster = _ebml(0x1F43B675, _uint(0xE7, 0) + blocks)
    return head + _ebml(0x18538067, info + _ebml(0x1654AE6B, track) + cluster)


# ---------------------------------------------------------------- stand-in
class ModelNvdec:
    """A stand-in for the NVDEC binding (``data/video_nvdec.py``'s library,
    the same calls) where no NVDEC decodes: on a card whose container
    withholds NVIDIA's ``video`` capability (``chip_smoke.py`` phase 15
    takes it there alone), and in the tests of the reader. It decodes
    nothing: it looks each slice NAL unit of the hand-written H.264 streams
    up in their numpy model (which ``tests/test_torch_nvdec.py`` holds to
    OpenCV's decode of the same bytes), bumps the pictures into display
    order with the stream's reorder depth (1 with B-frames, else 0; an IDR
    or the end of the stream flushes) and maps each as a pitched NV12
    surface on ``device`` (``surfaces`` keeps them by pointer). The rest is
    the port's: the demuxer, the Annex B packets, the reader's loop and
    seek, the NV12 kernel and the CLIs."""

    def __init__(self, streams, device: str = "cuda"):
        self.table = {}  # slice NAL unit -> (stream, display index, picture)
        for st in streams:
            for packet, disp, pic in zip(st.packets, st.display, st.pictures):
                self.table[packet[-1]] = (st, disp, pic)
        self.device = device
        self.readers = {}
        self.surfaces = {}  # data pointer -> the mapped surface
        self.status = 2  # cuvidGetDecodeStatus of every picture: decoded without an error

    def tvn_load(self):
        return 0

    def tvn_last_error(self):
        return b"a packet the stand-in's streams do not hold"

    def tvn_last_error_kind(self):
        return 1

    def tvn_open(self, codec, ordinal):
        if codec != 4:  # H.264 only: VP9 has no model
            return None
        handle = len(self.readers) + 1
        self.readers[handle] = {"held": [], "shown": [], "stream": None, "mapped": None}
        return handle

    def tvn_close(self, handle):
        self.readers.pop(handle, None)

    def tvn_feed(self, handle, data, size, timestamp, flags):
        r = self.readers[handle]
        if flags & 1:
            r["shown"] += sorted(r["held"], key=lambda e: e[0])
            r["held"] = []
            return len(r["shown"])
        units = [u for u in data.split(b"\x00\x00\x00\x01") if u and u[0] & 0x1F in (1, 5)]
        if len(units) != 1 or units[0] not in self.table:
            return -1
        st, disp, pic = self.table[units[0]]
        if units[0][0] & 0x1F == 5:  # an IDR outputs every picture before it
            r["shown"] += sorted(r["held"], key=lambda e: e[0])
            r["held"] = []
        r["stream"] = st
        r["held"].append((disp, timestamp, pic))
        while len(r["held"]) > (1 if st.p["poc_type"] == 0 else 0):
            first = min(r["held"], key=lambda e: e[0])
            r["held"].remove(first)
            r["shown"].append(first)
        return len(r["shown"])

    def tvn_format(self, handle, out):
        st = self.readers[handle]["stream"]
        if st is None:
            return 0
        out[:] = [16 * st.mbw, 16 * st.mbh, 0, 0, st.w, st.h, int(st.colour()[1]),
                  st.colour()[0]]
        return 1

    def tvn_map(self, handle, stream, ptr, pitch, timestamp, status):
        import torch

        r = self.readers[handle]
        if not r["shown"]:
            return 0
        _, ts, pic = r["shown"].pop(0)
        nv12 = r["stream"].nv12(pic)
        surface = torch.zeros((nv12.shape[0], -(-nv12.shape[1] // 256) * 256),
                              dtype=torch.uint8, device=self.device)
        surface[:, :nv12.shape[1]].copy_(torch.from_numpy(nv12))
        r["mapped"] = surface
        self.surfaces = {surface.data_ptr(): surface}
        ptr.value, pitch.value, timestamp.value = surface.data_ptr(), surface.shape[1], ts
        status.value = self.status
        return 1

    def tvn_unmap(self, handle, stream):
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.current_stream().synchronize()
        self.readers[handle]["mapped"] = None
        return 0

    def tvn_reset(self, handle):
        self.readers[handle].update(held=[], shown=[], mapped=None)
        return 0


# ---------------------------------------------------------------- VP9
def vp9_expected() -> dict:
    """The fixture's recorded frames: {"fps", "shape", "frames": [sha256]}."""
    return json.loads(VP9_SHA256.read_text())


def frame_sha256(frames) -> list:
    return [hashlib.sha256(np.ascontiguousarray(f).tobytes()).hexdigest() for f in frames]
