"""The tile plans of the 4x upsample kernels (``tecogan_tpu_torch/csrc/
upsample4.cu``), emulated in numpy: K1, the upsample, and K2, its adjoint.

The kernels run only on the card. These tests hold their plans to the JAX
package's Pallas kernel ``_upsample4_pallas``, run in interpret mode, and
to its VJP, in float32 (where every rounding to the storage type is the
identity): K1's tile origins and tile height, the clamped halo staging,
the H pass kept per staged column, the W pass into output rows shifted by
their misalignment, and the 16-byte row chunking with its scalar head and
tail; K2's dx tiles, the g row segments each block reads once, the
H-adjoint kept per (dx row, staged column) and the interior taps with the
clamped edge taps summed apart and added onto the edge rows and columns.
The tile constants
are read from the ``.cu`` file's ``constexpr`` lines, so the emulation and
the kernel cannot drift apart. The kernels' bfloat16 rounding is checked
on the card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import functools
import re
from collections import Counter
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tecogan_tpu.kernels.upsample4 as jax_up
from tecogan_tpu_torch.kernels.upsample4 import MAX_CHANNELS
from tecogan_tpu_torch.ops import resize

torch.set_num_threads(1)

SOURCE = (Path(__file__).resolve().parent.parent / "tecogan_tpu_torch" / "csrc"
          / "upsample4.cu")
# The plan this file emulates; must equal the kernel's namespace constants.
PLAN = dict(kThreads=256, kWarps=8, kTileW=32, kTileH=8, kTileHSmall=2,
            kMinBlocks=264, kVecBytes=16, kMaxSmem=232448, kBwdTileH=4, kBwdTileW=32,
            kBwdMaxThreads=512)
TW, VEC_BYTES = PLAN["kTileW"], PLAN["kVecBytes"]
# The Pallas kernel's two float32 matmuls against the plan's tap sums in
# another order, values up to ~16 (as tests/test_torch_kernels.py).
ATOL = 1e-5
# H or W below the bicubic taps (1x1, 2x3, h3w40: every K2 tile holds both
# H edges), partial tiles on both axes, W over two tiles.
SHAPES = [(1, 1, 1, 2), (1, 2, 3, 3), (2, 37, 53, 3), (3, 9, 70, 2), (2, 3, 40, 2)]
SHAPE_IDS = ["1x1", "2x3", "ragged", "w70", "h3w40"]


def _source_constants() -> dict:
    """``constexpr int A = expr, B = expr;`` lines at namespace scope of the
    kernel source, evaluated in order (C++ integer division)."""
    values = {}
    for line in SOURCE.read_text().splitlines():
        m = re.match(r"constexpr int (.*);", line.split("//")[0])
        if not m:
            continue
        for part in m.group(1).split(","):
            name, expr = (s.strip() for s in part.split("=", 1))
            values[name] = eval(expr.replace("/", "//"), {}, dict(values))
    return values


def _filter(filt):
    """(4 phases x NT taps) weights and the first tap's offset."""
    if filt == "bilinear":
        return np.array(resize._bilinear_phase_weights(4), np.float32), 0
    return np.array(resize._catmull_rom_weights(), np.float32), -1


# --- K1 -------------------------------------------------------------------
def _row_stride(c, vec):
    return (4 * TW * c + 2 * vec - 1) // vec * vec


def _smem_bytes(th, nt, c, itemsize):
    floats = ((th + nt - 1) * (TW + nt - 1) * c + 4 * th * (TW + nt - 1) * c + 3) // 4 * 4
    return 4 * floats + itemsize * 4 * th * _row_stride(c, VEC_BYTES // itemsize)


def _tile_rows(b, h, w, c, nt, itemsize):
    """launch_k1_tile: big tiles unless they give fewer than kMinBlocks
    blocks (or do not fit), then small ones."""
    big = -(-w // TW) * -(-h // PLAN["kTileH"]) * b
    if big >= PLAN["kMinBlocks"] and _smem_bytes(PLAN["kTileH"], nt, c, itemsize) \
            <= PLAN["kMaxSmem"]:
        return PLAN["kTileH"]
    return PLAN["kTileHSmall"]


def _store_plan(g0, n, vec):
    """The store of one output row segment of n elements at global element
    offset g0: (misalignment a, scalar head, 16-byte vectors, scalar tail)."""
    a = g0 % vec
    head = min((vec - a) % vec, n)
    nvec = (n - head) // vec
    return a, head, nvec, n - head - nvec * vec


def _k1_plan(x, filt, alpha, itemsize=4, clamp=True):
    """upsample4_kernel's grid, block by block, in float32. ``itemsize``
    sets the 16-byte vector width of the store plan (4 or 2 bytes);
    ``clamp=False`` zeroes the halo outside the image instead. Returns the
    output and the count of stored elements by kind."""
    wts, off = _filter(filt)
    nt = wts.shape[1]
    b, h, w, c = x.shape
    vec = VEC_BYTES // itemsize
    th_tile = _tile_rows(b, h, w, c, nt, itemsize)
    sh, sw = th_tile + nt - 1, TW + nt - 1
    rs, row_elems = _row_stride(c, vec), 4 * w * c
    flat = np.full(b * 16 * h * w * c, np.nan, np.float32)
    writes = np.zeros(flat.shape, int)
    kinds = Counter()
    for bz in range(b):
        for iy0 in range(0, h, th_tile):
            for ix0 in range(0, w, TW):
                th, tw = min(th_tile, h - iy0), min(TW, w - ix0)
                # 1. stage the tile and its halo, clamped (never masked).
                sy, sx = iy0 + off + np.arange(sh), ix0 + off + np.arange(sw)
                gy, gx = np.clip(sy, 0, h - 1), np.clip(sx, 0, w - 1)
                xs = (np.float32(alpha) * x[bz][gy][:, gx]).astype(np.float32)
                if not clamp:
                    inside = ((sy >= 0) & (sy < h))[:, None] & ((sx >= 0) & (sx < w))[None]
                    xs = np.where(inside[..., None], xs, 0).astype(np.float32)
                # 2. the H pass once per (output row, staged column, channel).
                hs = np.empty((4 * th_tile, sw, c), np.float32)
                for ry in range(th_tile):
                    for p in range(4):
                        acc = wts[p, 0] * xs[ry]
                        for ty in range(1, nt):
                            acc = acc + wts[p, ty] * xs[ry + ty]
                        hs[4 * ry + p] = acc
                # 3. the W pass into rows shifted by their misalignment.
                os_ = np.full((4 * th_tile, rs), np.nan, np.float32)
                for r in range(4 * th_tile):
                    g0 = (bz * 4 * h + 4 * iy0 + r) * row_elems + 4 * ix0 * c
                    a = g0 % vec
                    for q in range(4):
                        acc = wts[q, 0] * hs[r, 0:TW]
                        for tx in range(1, nt):
                            acc = acc + wts[q, tx] * hs[r, tx:tx + TW]
                        cols = a + (4 * np.arange(TW)[:, None] + q) * c + np.arange(c)
                        os_[r, cols] = acc
                # 4. one row per warp: scalar head, 16-byte vectors, tail.
                n = 4 * tw * c
                for r in range(4 * th):
                    g0 = (bz * 4 * h + 4 * iy0 + r) * row_elems + 4 * ix0 * c
                    a, head, nvec, tail = _store_plan(g0, n, vec)
                    if nvec:  # both ends of every vector are 16-byte aligned
                        assert (g0 + head) % vec == 0 and (r * rs + a + head) % vec == 0
                    flat[g0:g0 + n] = os_[r, a:a + n]
                    writes[g0:g0 + n] += 1
                    kinds.update(head=head, vector=nvec * vec, tail=tail)
    assert (writes == 1).all()
    return flat.reshape(b, 4 * h, 4 * w, c), kinds


def _interpret():
    return mock.patch.object(jax_up.pl, "pallas_call",
                             functools.partial(pl.pallas_call, interpret=True))


def test_plan_matches_the_kernel_source():
    assert _source_constants() == PLAN


def test_tile_choice_and_shared_memory():
    """The flow gets big tiles, the skip (108 big tiles) small ones; at
    both main-path shapes a block fits 5 or more times in an SM's shared
    memory (228 KB, 1 KB reserved per block), and 32 channels
    (``MAX_CHANNELS`` of the wrapper) fit at the small tile height."""
    assert PLAN["kWarps"] * 32 == PLAN["kThreads"]
    assert _tile_rows(23, 144, 180, 2, 2, 2) == PLAN["kTileH"]
    assert _tile_rows(1, 144, 180, 3, 4, 2) == PLAN["kTileHSmall"]
    assert -(-180 // TW) * -(-144 // PLAN["kTileHSmall"]) >= PLAN["kMinBlocks"]
    for th, nt, c in ((PLAN["kTileH"], 2, 2), (PLAN["kTileHSmall"], 4, 3)):
        assert 228 * 1024 // (_smem_bytes(th, nt, c, 2) + 1024) >= 5
    for itemsize in (2, 4):
        assert _smem_bytes(PLAN["kTileHSmall"], 4, MAX_CHANNELS, itemsize) <= PLAN["kMaxSmem"]


@pytest.mark.parametrize("shape,c,itemsize", [((23, 144, 180), 2, 2), ((1, 144, 180), 3, 2),
                                              ((23, 144, 180), 2, 4)],
                         ids=["flow-bf16", "skip-bf16", "flow-f32"])
def test_main_path_rows_store_as_whole_vectors(shape, c, itemsize):
    """At the streaming shapes every output row segment starts and ends on
    a 16-byte boundary: no scalar stores."""
    b, h, w = shape
    vec = VEC_BYTES // itemsize
    for bz in range(b):
        for oy in range(4 * h):
            for ix0 in range(0, w, TW):
                n = 4 * min(TW, w - ix0) * c
                g0 = (bz * 4 * h + oy) * 4 * w * c + 4 * ix0 * c
                _, head, _, tail = _store_plan(g0, n, vec)
                assert head == tail == 0


@pytest.mark.parametrize("filt", ["bilinear", "bicubic"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_k1_plan_matches_pallas(shape, filt):
    """The plan, alpha = 4 (the flow's scale, exact), against
    ``_upsample4_pallas(4 x)`` in interpret mode, float32."""
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    got, _ = _k1_plan(x, filt, 4.0)
    with _interpret():
        want = np.asarray(jax_up._upsample4_pallas(jnp.asarray(4 * x), filt))
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * ATOL)


def test_k1_plan_ragged_rows_take_scalar_heads_and_tails():
    """bfloat16 rows of 4 x 53 x 3 elements are 1,272 bytes, not a
    multiple of 16: the plan stores them with scalar heads and tails
    around the vectors and still writes every element once."""
    x = np.random.RandomState(3).rand(2, 37, 53, 3).astype(np.float32)
    got, kinds = _k1_plan(x, "bicubic", 1.0, itemsize=2)
    assert kinds["head"] > 0 and kinds["tail"] > 0 and kinds["vector"] > 0
    assert sum(kinds.values()) == got.size
    np.testing.assert_allclose(got, resize.bicubic_four(torch.from_numpy(x)).numpy(),
                               rtol=0, atol=ATOL)


def test_k1_plan_sees_an_unclamped_halo():
    """Masking the halo to zero instead of clamping it moves the border
    pixels by far more than the tolerance."""
    x = np.random.RandomState(4).rand(1, 5, 9, 2).astype(np.float32) + 1
    want = resize.bicubic_four(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(_k1_plan(x, "bicubic", 1.0)[0], want, rtol=0, atol=ATOL)
    assert np.abs(_k1_plan(x, "bicubic", 1.0, clamp=False)[0] - want).max() > 100 * ATOL


# --- K2 -------------------------------------------------------------------
BH, BW = PLAN["kBwdTileH"], PLAN["kBwdTileW"]


def _clamped_taps(i, p, n, wts, off):
    """upsample4.cu's clamped_taps as weights: phase p's taps of source
    index i that the clamp sends onto 0 (low) and onto n - 1 (high)."""
    low = high = np.float32(0)
    for t in range(wts.shape[1]):
        u = i + off + t
        low = low + (wts[p, t] if u < 0 else 0)
        high = high + (wts[p, t] if u > n - 1 else 0)
    return low, high


def _k2_threads(nt, c):
    cols = 4 * (BW + nt - 1) * c
    return PLAN["kBwdMaxThreads"] if cols >= PLAN["kBwdMaxThreads"] else -(-cols // 32) * 32


def test_k2_edge_weights_are_the_stencil_matrix():
    """Every entry (4 src + phase, dst) of the stencil matrix, the clamped
    edge sums included, is the interior tap (src feeds dst = src + off + t
    with tap t) plus the clamped taps onto dst = 0 and dst = n - 1; all of
    them come from sources in the staged range [dst - off - NT + 1,
    dst - off]."""
    for filt in ("bilinear", "bicubic"):
        wts, off = _filter(filt)
        nt = wts.shape[1]
        for n in (1, 2, 3, 5, 9):
            s = resize.stencil_matrix(n, filt).numpy().reshape(n, 4, n)
            for src in range(n):
                for p in range(4):
                    low, high = _clamped_taps(src, p, n, wts, off)
                    for dst in range(n):
                        t = dst - src - off
                        want = (wts[p, t] if 0 <= t < nt else 0) + \
                            (low if dst == 0 else 0) + (high if dst == n - 1 else 0)
                        assert s[src, p, dst] == want
                        if want:
                            assert dst - off - nt + 1 <= src <= dst - off


def test_k2_blocks_threads_and_shared_memory():
    """The training path's flow gradient (36 x 32 x 32 LR) gives 288
    blocks on 132 SMs; a block is one thread per staged g column element,
    in whole warps (the flow's 264 take 288 threads); MAX_CHANNELS
    channels fit in shared memory with bicubic taps."""
    assert -(-32 // BW) * -(-32 // BH) * 36 == 288
    assert _k2_threads(2, 2) == 288 and _k2_threads(4, 3) == 448
    assert _k2_threads(4, MAX_CHANNELS) == PLAN["kBwdMaxThreads"]
    assert 4 * BH * 4 * (BW + 3) * MAX_CHANNELS <= PLAN["kMaxSmem"]


def _k2_plan(g, filt, alpha, clamp_edges=True):
    """upsample4_bwd_kernel's grid, block by block, in float32: the g row
    segments of a dx tile read once each, the H-adjoint per (tile row,
    staged column) with the clamped taps summed apart, then the W-adjoint
    the same way, times alpha. ``clamp_edges=False`` drops the clamped
    taps. Returns dx and how many times each g element was read."""
    wts, off = _filter(filt)
    nt = wts.shape[1]
    b, h4, w4, c = g.shape
    h, w = h4 // 4, w4 // 4
    sc = 4 * (BW + nt - 1) * c
    dx = np.full((b, h, w, c), np.nan, np.float32)
    writes = np.zeros(dx.shape, int)
    reads = np.zeros(g.shape, int)
    for bz in range(b):
        for iy0 in range(0, h, BH):
            for ix0 in range(0, w, BW):
                i0, j0 = iy0 - off - nt + 1, ix0 - off - nt + 1
                # 1. the H-adjoint: element e of the staged row segment.
                e = np.arange(sc)
                ox, ch = 4 * j0 + e // c, e % c
                col_ok = (ox >= 0) & (ox < w4)
                hi = np.zeros((BH, sc), np.float32)
                low = np.zeros(sc, np.float32)
                high = np.zeros(sc, np.float32)
                edge_h = clamp_edges and (iy0 == 0 or iy0 + BH >= h)
                for s_ in range(BH + nt - 1):
                    i = i0 + s_
                    if not 0 <= i < h:
                        continue
                    for p in range(4):
                        v = np.where(col_ok, g[bz, 4 * i + p, np.clip(ox, 0, w4 - 1), ch], 0)
                        reads[bz, 4 * i + p, ox[col_ok], ch[col_ok]] += 1
                        for k in range(nt):
                            if 0 <= s_ - k < BH:
                                hi[s_ - k] += wts[p, nt - 1 - k] * v
                        if edge_h:
                            lo_w, hi_w = _clamped_taps(i, p, h, wts, off)
                            low, high = low + lo_w * v, high + hi_w * v
                for r in range(BH):
                    hi[r] += (low if iy0 + r == 0 else 0) + (high if iy0 + r == h - 1 else 0)
                # 2. the W-adjoint: dx element (r, tx, c) of the tile.
                th, tw = min(BH, h - iy0), min(BW, w - ix0)
                edge_w = clamp_edges and (ix0 == 0 or ix0 + BW >= w)
                hs = hi.reshape(BH, BW + nt - 1, 4, c)
                for tx in range(tw):
                    ix = ix0 + tx
                    acc = np.zeros((th, c), np.float32)
                    lo_acc, hi_acc = np.zeros_like(acc), np.zeros_like(acc)
                    for k in range(nt):
                        j = ix - off - nt + 1 + k
                        if not 0 <= j < w:
                            continue
                        for q in range(4):
                            v = hs[:th, tx + k, q]
                            acc += wts[q, nt - 1 - k] * v
                            if edge_w:
                                lo_w, hi_w = _clamped_taps(j, q, w, wts, off)
                                lo_acc, hi_acc = lo_acc + lo_w * v, hi_acc + hi_w * v
                    acc += (lo_acc if ix == 0 else 0) + (hi_acc if ix == w - 1 else 0)
                    dx[bz, iy0:iy0 + th, ix] = np.float32(alpha) * acc
                    writes[bz, iy0:iy0 + th, ix] += 1
    assert (writes == 1).all()
    return dx, reads


def _pallas_vjp(g, shape, filt):
    x = np.random.RandomState(sum(shape) + 2).randn(*shape).astype(np.float32)
    with _interpret():
        _, vjp = jax.vjp(lambda t: jax_up._upsample4_pallas(4 * t, filt), jnp.asarray(x))
        (want,) = vjp(jnp.asarray(g))
    return np.asarray(want)


@pytest.mark.parametrize("filt", ["bilinear", "bicubic"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_k2_plan_matches_pallas_vjp(shape, filt):
    """The staged plan, alpha = 4, against ``jax.vjp`` of
    ``_upsample4_pallas(4 x)`` (its custom VJP, ``_down_kernel``) in
    interpret mode, float32; every g element is read, by one block or, in
    the halos the tiles share, by up to four."""
    b, h, w, c = shape
    g = np.random.RandomState(sum(shape) + 1).randn(b, 4 * h, 4 * w, c).astype(np.float32)
    got, reads = _k2_plan(g, filt, 4.0)
    np.testing.assert_allclose(got, _pallas_vjp(g, shape, filt), rtol=0, atol=16 * ATOL)
    assert reads.min() >= 1 and reads.max() <= 4


def test_k2_plan_sees_missing_edge_taps():
    """Dropping the clamped edge taps moves the border of dx by far more
    than the tolerance (the interior taps alone are not the adjoint)."""
    shape = (1, 5, 9, 2)
    g = np.random.RandomState(7).randn(1, 20, 36, 2).astype(np.float32) + 1
    want = _pallas_vjp(g, shape, "bicubic")
    np.testing.assert_allclose(_k2_plan(g, "bicubic", 4.0)[0], want, rtol=0, atol=16 * ATOL)
    assert np.abs(_k2_plan(g, "bicubic", 4.0, clamp_edges=False)[0] - want).max() > 100 * ATOL
