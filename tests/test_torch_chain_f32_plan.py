"""The plan of the float32 chain kernel (``tecogan_tpu_torch/csrc/
resblock_chain.cu``), emulated in numpy.

The kernel runs only on the card. These tests hold its plan to the JAX
package's ``_fused_chain_single`` (run in interpret mode) and to the plain
chain on the CPU: a cluster of 4 CTAs per 8x16 tile, each computing conv1
for its quarter of the y channels over the haloed region (m16 tiles, the
tail rows clamped and never stored), the y mask outside the image, the
exchange that leaves every CTA of the cluster with all 64 y channels (in
the place of its x tile), each CTA's conv2 for its quarter of the outputs
with the skip read again from x, the warps' split of rows and input
channels with the exchange of their partial sums, and every product as three TF32 products (``cvt.rna.tf32.f32``
emulated on float32 bit patterns), the big one and the two small ones
summed apart (the weights split once, as a ring of taps is staged). The
tile and cluster constants are read from the ``.cu``
file's ``constexpr`` lines, so the emulation and the kernel cannot drift
apart. The ldmatrix / ``mma.sync.m16n8k8`` fragment maps are held to the
PTX manual's layouts.
"""

import functools
import re
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tecogan_tpu.kernels.resblocks as jax_chain
from tecogan_tpu_torch.kernels import resblock_chain_plain

torch.set_num_threads(1)

SOURCE = (Path(__file__).resolve().parent.parent / "tecogan_tpu_torch" / "csrc"
          / "resblock_chain.cu")
# The plan this file emulates; must equal the kernel's constexpr ints.
PLAN = dict(C=64, TH=8, TW=16, XH=12, XW=20, YH=10, YW=18, PS=68, kCluster=4, CQ=16,
            KG=2, M_STEP=4, kWarps=8, kThreads=256, Y_PX=180, M1=12, M2=8, M1_W=3, M2_W=2,
            NT=2, KC_W=2, STAGES=3, TAPS=18, XS=16320, YS=12240, WSLOT=2176, WS=6528)
TH, TW, XH, XW, YW = (PLAN[k] for k in ("TH", "TW", "XH", "XW", "YW"))
C, Y_PX, M_STEP, CQ = PLAN["C"], PLAN["Y_PX"], PLAN["M_STEP"], PLAN["CQ"]
# 3xTF32 drops only the a_lo b_lo product (~2^-22 of a b); the rest is
# float32 sums in another order than the CPU's convolutions. Relative to
# max(1, the output's scale).
TOL = 1e-5


def _source_constants() -> dict:
    """``constexpr int A = expr, B = expr;`` lines of the kernel source,
    evaluated in order (C++ integer division)."""
    values = {}
    for line in SOURCE.read_text().splitlines():
        m = re.match(r"constexpr int (.*);", line.split("//")[0])
        if not m:
            continue
        for part in m.group(1).split(","):
            name, expr = (s.strip() for s in part.split("=", 1))
            values[name] = eval(expr.replace("/", "//"), {}, dict(values))
    return values


def test_plan_matches_the_kernel_source():
    assert _source_constants() == PLAN


def test_plan_fills_the_card_and_fits_shared_memory():
    """At the training shape the clusters give 128 CTAs (132 SMs); two
    CTAs fit on an SM (228 KB, 1 KB reserved per CTA), each with the x tile
    or, in its place, the y tile, and a ring of 3 taps of its weight
    quarter, hi and lo rows; a thread stages 4 weights of a tap; rows PS
    floats apart fall on 8 distinct 16-byte bank groups (ldmatrix reads 8
    rows a phase); every warp gets the same number of m16 tiles."""
    assert PLAN["kCluster"] * -(-32 // TW) * -(-32 // TH) * 4 == 128
    assert PLAN["WSLOT"] == 2 * CQ * PLAN["PS"] and CQ * PLAN["kCluster"] == C
    assert PLAN["WS"] == PLAN["STAGES"] * PLAN["WSLOT"] and PLAN["kThreads"] * 4 == C * CQ
    assert PLAN["YS"] <= PLAN["XS"]
    assert 2 * (4 * (PLAN["XS"] + PLAN["WS"]) + 1024) <= 228 * 1024
    assert sorted((r * 4 * PLAN["PS"]) % 128 // 16 for r in range(8)) == list(range(8))
    assert PLAN["NT"] * 8 == CQ and M_STEP * PLAN["KG"] == PLAN["kWarps"]
    assert PLAN["KC_W"] * 16 * PLAN["KG"] == C and PLAN["NT"] == PLAN["KG"]
    assert PLAN["M1"] == PLAN["M1_W"] * M_STEP and PLAN["M2"] == PLAN["M2_W"] * M_STEP
    assert PLAN["M1"] * 16 >= Y_PX and PLAN["M2"] == TH and TW == 16


def tf32(a):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, to nearest, ties away
    from zero (add half an ulp to the magnitude's bits, then truncate)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a):
    hi = tf32(a)
    return hi, tf32(a - hi)


def test_tf32_rounding_on_bit_patterns():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # a TF32 ulp at 1
    assert tf32(one + ulp / 2)[()] == one + ulp          # a tie rounds away from zero
    assert tf32(-(one + ulp / 2))[()] == -(one + ulp)
    assert tf32(one + ulp / 2 - np.float32(2.0 ** -23))[()] == one
    a = np.random.RandomState(0).randn(1000).astype(np.float32)
    hi, lo = _split(a)
    assert (hi.view(np.uint32) & 0x1FFF == 0).all() and (lo.view(np.uint32) & 0x1FFF == 0).all()
    assert np.abs(hi + lo - a).max() <= 2.0 ** -21 * np.abs(a).max()


def _products(a, b, mode):
    """(big, small) of a @ b as the kernel's MMAs form them."""
    if mode == "float32":
        return a @ b, 0
    (ah, al), (bh, bl) = _split(a), _split(b)
    if mode == "1xtf32":
        return ah @ bh, 0
    return ah @ bh, al @ bh + ah @ bl


def _warps():
    """(first m16 tile, input-channel half) of each warp of a CTA."""
    for warp in range(PLAN["kWarps"]):
        yield warp % M_STEP, warp // M_STEP


def _block(x, w1, b1, w2, b2, mode="3xtf32", mask_y=True):
    """One residual block as the kernel's grid of clusters computes it."""
    b, h, w, _ = x.shape
    bz, by, bx = np.meshgrid(np.arange(b), np.arange(-(-h // TH)),
                             np.arange(-(-w // TW)), indexing="ij")
    bz, ty0, tx0 = bz.ravel(), by.ravel() * TH, bx.ravel() * TW   # one per cluster
    n_tiles = bz.size
    half = 16 * PLAN["KC_W"]

    def inside(gy, gx):
        return (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)

    # Each CTA's x tile with its 2-px halo, zero-filled outside the image.
    px = np.arange(XH * XW)
    gy, gx = ty0[:, None] - 2 + px // XW, tx0[:, None] - 2 + px % XW
    xs = x[bz[:, None], np.clip(gy, 0, h - 1), np.clip(gx, 0, w - 1)]
    xs = np.where(inside(gy, gx)[..., None], xs, 0).astype(np.float32)

    def conv(src, rows, wk, cols, ks):
        """sum over taps and the input channels ks of src[:, rows(tap)] @
        w[tap][ks, cols], as three TF32 products whose big and small parts
        sum apart."""
        big = small = 0
        for (dy, dx), shift in rows.items():
            a = src[:, shift][..., ks].reshape(-1, half)
            bb, ss = _products(a, wk[dy, dx][ks, cols], mode)
            big, small = big + bb, small + ss
        return (big + small).reshape(n_tiles, -1, cols.stop - cols.start)

    def conv_warps(rank, src, rows_of, wk, n_m):
        """CTA `rank`'s conv as its warps compute it: each warp's partial
        sum over its input-channel half for all the CTA's channels, then
        the exchange, after which the warp of half kg finishes n8 tile kg.
        Yields (m16 tile, the n8 tile's channels, its sums)."""
        cta = slice(rank * CQ, (rank + 1) * CQ)
        part = {(mw, i, kg): conv(src, rows_of(mw + M_STEP * i), wk, cta,
                                  slice(kg * half, (kg + 1) * half))
                for mw, kg in _warps() for i in range(n_m)}
        assert len(part) == PLAN["kWarps"] * n_m
        for (mw, i, kg), own in part.items():
            j = slice(8 * kg, 8 * kg + 8)
            yield (mw + M_STEP * i, slice(cta.start + j.start, cta.start + j.stop),
                   own[..., j] + part[mw, i, PLAN["KG"] - 1 - kg][..., j])

    # conv1, CTA `rank` computing y channels rank*CQ.. into the y tile of
    # every CTA of the cluster.
    ys = np.full((PLAN["kCluster"], n_tiles, Y_PX, C), np.nan, np.float32)
    y_writes = np.zeros((PLAN["kCluster"], Y_PX, C), int)

    def rows1(mt):  # m16 tile mt: y pixels mt*16.., the tail clamped
        p = np.minimum(mt * 16 + np.arange(16), Y_PX - 1)
        return {(dy, dx): (p // YW + dy) * XW + p % YW + dx
                for dy in range(3) for dx in range(3)}

    for rank in range(PLAN["kCluster"]):
        for mt, cols, acc in conv_warps(rank, xs, rows1, w1, PLAN["M1_W"]):
            r = mt * 16 + np.arange(16)
            p = np.minimum(r, Y_PX - 1)
            y = np.maximum(acc + b1[cols], 0)
            gy, gx = ty0[:, None] - 1 + p // YW, tx0[:, None] - 1 + p % YW
            if mask_y:
                y = np.where(inside(gy, gx)[..., None], y, 0)
            keep = r < Y_PX
            for peer in range(PLAN["kCluster"]):
                ys[peer][:, r[keep], cols] = y[:, keep]
                y_writes[peer][r[keep], cols] += 1
    # After the cluster barrier every CTA holds every y channel once.
    assert (y_writes == 1).all()
    assert all(np.array_equal(ys[0], ys[k]) for k in range(1, PLAN["kCluster"]))

    # conv2, CTA `rank` from its own y tile: m16 tile r is tile row r;
    # out = skip (x, read again) + conv2 + b2 for its output channels.
    out = np.full_like(x, np.nan)
    writes = np.zeros(x.shape, int)
    col = np.arange(16)

    def rows2(r):
        return {(dy, dx): (r + dy) * YW + col + dx for dy in range(3) for dx in range(3)}

    for rank in range(PLAN["kCluster"]):
        for r, cols, acc in conv_warps(rank, ys[rank], rows2, w2, PLAN["M2_W"]):
            o = acc + b2[cols]
            gy, gx = np.broadcast_to(ty0[:, None] + r, (n_tiles, 16)), tx0[:, None] + col
            ok = (gy < h) & (gx < w)
            zz = np.broadcast_to(bz[:, None], ok.shape)
            out[zz[ok], gy[ok], gx[ok], cols] = x[zz[ok], gy[ok], gx[ok], cols] + o[ok]
            writes[zz[ok], gy[ok], gx[ok], cols] += 1
    assert (writes == 1).all()
    return out


def _emulate(x, w1, b1, w2, b2, **kw):
    for i in range(w1.shape[0]):
        x = _block(x, w1[i], b1[i], w2[i], b2[i], **kw)
    return x


def _inputs(b, h, w, n, seed):
    rng = np.random.RandomState(seed)
    lim = 0.5 * (6.0 / (2 * 9 * C)) ** 0.5
    return (np.maximum(rng.randn(b, h, w, C), 0).astype(np.float32),
            (rng.randn(n, 3, 3, C, C) * lim).astype(np.float32),
            (rng.randn(n, C) * 0.1).astype(np.float32),
            (rng.randn(n, 3, 3, C, C) * lim).astype(np.float32),
            (rng.randn(n, C) * 0.1).astype(np.float32))


def _rel_err(got, want):
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _plain(arrays):
    return resblock_chain_plain(*map(torch.from_numpy, arrays)).numpy()


@pytest.mark.parametrize("shape,n", [((1, 5, 7), 2), ((2, 37, 53), 2), ((4, 32, 32), 1),
                                     ((1, 144, 180), 1)],
                         ids=["tiny", "ragged-b2", "training", "calendar"])
def test_emulated_plan_matches_plain_chain(shape, n):
    arrays = _inputs(*shape, n, seed=sum(shape))
    assert _rel_err(_emulate(*arrays), _plain(arrays)) <= TOL


def test_emulated_plan_matches_pallas_chain():
    """Against the Pallas K3 (``_fused_chain_single``) in interpret mode,
    float32, two blocks on a 16x12 frame."""
    arrays = _inputs(1, 16, 12, 2, seed=11)
    x, w1, b1, w2, b2 = map(jnp.asarray, arrays)
    with mock.patch.object(jax_chain.pl, "pallas_call",
                           functools.partial(pl.pallas_call, interpret=True)):
        taps = jax_chain._taps(w1, b1, w2, b2)
        want = np.asarray(jax_chain._fused_chain_single(x[0], *taps, tile_rows=4))
    assert _rel_err(_emulate(*arrays)[0], want) <= TOL


def test_emulation_sees_a_missing_y_mask():
    """conv2's SAME padding must see zeros outside the image, not relu(b1):
    without the mask the edge pixels move by far more than the tolerance."""
    arrays = _inputs(1, 9, 21, 1, seed=5)
    assert _rel_err(_emulate(*arrays, mask_y=False), _plain(arrays)) > 100 * TOL


def test_one_tf32_product_misses_the_tolerance():
    """TF32 alone (three decimal digits) misses the tolerance that 3xTF32
    meets on the same inputs, and float32 products meet it too."""
    arrays = _inputs(1, 9, 21, 2, seed=6)
    want = _plain(arrays)
    assert _rel_err(_emulate(*arrays, mode="1xtf32"), want) > 10 * TOL
    assert _rel_err(_emulate(*arrays), want) <= TOL
    assert _rel_err(_emulate(*arrays, mode="float32"), want) <= TOL


# --- fragment maps -------------------------------------------------------
# PTX ISA, mma.m16n8k8 with .tf32: lane t, group g = t // 4, q = t % 4.
def _a_ptx(t, i):   # a_i, i in 0..3 -> (row, k)
    return t // 4 + 8 * (i % 2), t % 4 + 4 * (i // 2)


def _b_ptx(t, i):   # b_i, i in 0..1 -> (k, n)
    return t % 4 + 4 * i, t // 4


def _c_ptx(t, i):   # c_i, i in 0..3 -> (row, n)
    return t // 4 + 8 * (i // 2), 2 * (t % 4) + i % 2


def _ldmatrix_f32(lane_addr):
    """ldmatrix.x4 (b16, not transposed) read as 32-bit words: register j of
    lane t holds word t % 4 of the 16-byte row that lane 8j + t // 4
    addresses; ``lane_addr(l)`` is (row, first word) of lane l."""
    regs = np.empty((32, 4), object)
    for t in range(32):
        for j in range(4):
            row, word = lane_addr(8 * j + t // 4)
            regs[t, j] = (row, word + t % 4)
    return regs


def test_fragment_maps_match_the_ptx_layouts():
    """The kernel's lane addresses give ldmatrix fragments that are exactly
    the PTX tf32 A and B operands, and its epilogue's (row, channel) of
    each accumulator is the PTX C layout."""
    # A: rows are pixels; lane l addresses row l % 16 at k offset (l / 16) * 4.
    a = _ldmatrix_f32(lambda l: (l % 16, (l // 16) * 4))
    for t in range(32):
        for i in range(4):
            assert a[t, i] == _a_ptx(t, i)
    # B: rows are output channels n, words input channels k (the weights
    # staged as (c_out, c_in)); lane l addresses row l % 8 at k offset
    # (l / 8) * 4; registers 0, 1 are b0, b1 of the first k8 step, 2, 3 of
    # the second.
    b = _ldmatrix_f32(lambda l: (l % 8, (l // 8) * 4))
    for t in range(32):
        for ks in range(2):
            for i in range(2):
                n, k = b[t, 2 * ks + i]
                assert (k - 8 * ks, n) == _b_ptx(t, i)
    # C: the epilogue reads acc[i][2h + e] as row g + 8h, channel 2 (t % 4) + e.
    for t in range(32):
        for h in range(2):
            for e in range(2):
                assert _c_ptx(t, 2 * h + e) == (t // 4 + 8 * h, 2 * (t % 4) + e)
