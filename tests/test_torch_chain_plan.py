"""The tile plan of the bfloat16 tensor-core chain kernel
(``tecogan_tpu_torch/csrc/resblock_chain_mma.cu``), emulated in numpy.

The kernel runs only on the card. These tests hold its plan to the plain
chain on the CPU: the tiles and their 2-px halo, the m16-row -> pixel map
of each conv (conv1's tail rows clamped to the last pixel and never
stored), the tap offsets, the y mask outside the image, the ragged edge
tiles, the warps' split of rows and channels, and the fragment maps of
``ldmatrix`` / ``mma.sync.m16n8k16`` as the PTX manual defines them. The
tile constants are read from the ``.cu`` file's ``constexpr`` lines, so
the emulation and the kernel cannot drift apart. float32 throughout: the
kernel's bfloat16 rounding is checked on the card (``test_torch_cuda.py``,
``chip_smoke.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tecogan_tpu_torch.kernels import resblock_chain_plain

torch.set_num_threads(1)

SOURCE = (Path(__file__).resolve().parent.parent / "tecogan_tpu_torch" / "csrc"
          / "resblock_chain_mma.cu")
# The plan this file emulates; must equal the kernel's constexpr ints.
PLAN = dict(C=64, TH=8, TW=16, XH=12, XW=20, YH=10, YW=18, PS=72, kWarps=8,
            kThreads=256, Y_PX=180, M1=12, M2=8, NH=2, M_STEP=4, M1_W=3, M2_W=2,
            NT=4, STAGES=3, TAPS=18, XS=17280, YS=12960, WS=4608)
TH, TW, XH, XW, YW = (PLAN[k] for k in ("TH", "TW", "XH", "XW", "YW"))
Y_PX, NH, M_STEP = PLAN["Y_PX"], PLAN["NH"], PLAN["M_STEP"]
# Against the plain chain (float32 convs in another summation order over
# 576-term sums of O(1) values, 1-2 blocks).
ATOL = 1e-4


def _source_constants() -> dict:
    """``constexpr int A = expr, B = expr;`` lines of the kernel source,
    evaluated in order (C++ integer division)."""
    values = {}
    for line in SOURCE.read_text().splitlines():
        m = re.match(r"\s*constexpr int (.*);", line.split("//")[0])
        if not m:
            continue
        for part in m.group(1).split(","):
            name, expr = (s.strip() for s in part.split("=", 1))
            values[name] = eval(expr.replace("/", "//"), {}, dict(values))
    return values


def test_plan_matches_the_kernel_source():
    assert _source_constants() == PLAN


def test_plan_fits_two_blocks_per_sm_without_bank_conflicts():
    smem = 2 * (PLAN["XS"] + PLAN["YS"] + PLAN["STAGES"] * PLAN["WS"])
    # 228 KB of shared memory per SM, 1 KB of it reserved per block.
    assert 2 * (smem + 1024) <= 228 * 1024
    # ldmatrix reads 8 rows of 16 bytes per phase: rows PS apart must fall
    # on 8 distinct 16-byte groups of the 128-byte bank window.
    assert sorted((r * 2 * PLAN["PS"]) % 128 // 16 for r in range(8)) == list(range(8))
    # Every warp gets the same number of m16 tiles in both convs.
    assert PLAN["M1"] == PLAN["M1_W"] * M_STEP and PLAN["M2"] == PLAN["M2_W"] * M_STEP
    assert PLAN["M1"] * 16 >= Y_PX and PLAN["M2"] == TH and TW == 16


def _warps():
    """(first m16 tile, output-channel slice) of each warp."""
    c = PLAN["C"] // NH
    for warp in range(PLAN["kWarps"]):
        n0 = (warp % NH) * c
        yield warp // NH, slice(n0, n0 + c)


def _block(x, w1, b1, w2, b2, mask_y=True):
    """One residual block as the kernel's grid computes it."""
    b, h, w, c = x.shape
    bz, by, bx = np.meshgrid(np.arange(b), np.arange(-(-h // TH)),
                             np.arange(-(-w // TW)), indexing="ij")
    bz, ty0, tx0 = bz.ravel(), by.ravel() * TH, bx.ravel() * TW   # one per tile
    n_tiles = bz.size

    def inside(gy, gx):
        return (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)

    # x tile with its 2-px halo, zero-filled outside the image.
    px = np.arange(XH * XW)
    gy, gx = ty0[:, None] - 2 + px // XW, tx0[:, None] - 2 + px % XW
    xs = x[bz[:, None], np.clip(gy, 0, h - 1), np.clip(gx, 0, w - 1)]
    xs = np.where(inside(gy, gx)[..., None], xs, 0).astype(np.float32)

    def conv(src, rows, wk, cols):
        """sum over taps of src[:, rows + (dy * row, dx)] @ w[dy, dx][:, cols]."""
        acc = 0
        for (dy, dx), shift in rows.items():
            a = src[:, shift].reshape(-1, c)
            acc = acc + (a @ wk[dy, dx][:, cols]).reshape(n_tiles, -1, cols.stop - cols.start)
        return acc

    # conv1: m16 tile mt covers y pixels mt*16 .. mt*16+15, clamped.
    ys = np.full((n_tiles, Y_PX, c), np.nan, np.float32)
    y_writes = np.zeros((Y_PX, c), int)
    for mw, cols in _warps():
        for i in range(PLAN["M1_W"]):
            r = (mw + M_STEP * i) * 16 + np.arange(16)
            p = np.minimum(r, Y_PX - 1)
            rows = {(dy, dx): (p // YW + dy) * XW + p % YW + dx
                    for dy in range(3) for dx in range(3)}
            y = np.maximum(conv(xs, rows, w1, cols) + b1[cols], 0)
            gy, gx = ty0[:, None] - 1 + p // YW, tx0[:, None] - 1 + p % YW
            if mask_y:
                y = np.where(inside(gy, gx)[..., None], y, 0)
            keep = r < Y_PX
            ys[:, r[keep], cols] = y[:, keep]
            y_writes[r[keep], cols] += 1
    assert (y_writes == 1).all()

    # conv2: m16 tile r is tile row r; out = skip (x tile) + conv2 + b2.
    out = np.full_like(x, np.nan)
    writes = np.zeros(x.shape, int)
    col = np.arange(16)
    for mw, cols in _warps():
        for i in range(PLAN["M2_W"]):
            r = mw + M_STEP * i
            rows = {(dy, dx): (r + dy) * YW + col + dx
                    for dy in range(3) for dx in range(3)}
            skip = xs[:, (r + 2) * XW + col + 2, cols]
            o = skip + conv(ys, rows, w2, cols) + b2[cols]
            gy, gx = np.broadcast_to(ty0[:, None] + r, (n_tiles, 16)), tx0[:, None] + col
            ok = (gy < h) & (gx < w)
            zz = np.broadcast_to(bz[:, None], ok.shape)
            out[zz[ok], gy[ok], gx[ok], cols] = o[ok]
            writes[zz[ok], gy[ok], gx[ok], cols] += 1
    assert (writes == 1).all()
    return out


def _emulate(x, w1, b1, w2, b2, **kw):
    for i in range(w1.shape[0]):
        x = _block(x, w1[i], b1[i], w2[i], b2[i], **kw)
    return x


def _inputs(b, h, w, n, seed):
    rng = np.random.RandomState(seed)
    c = PLAN["C"]
    lim = 0.5 * (6.0 / (2 * 9 * c)) ** 0.5
    return (np.maximum(rng.randn(b, h, w, c), 0).astype(np.float32),
            (rng.randn(n, 3, 3, c, c) * lim).astype(np.float32),
            (rng.randn(n, c) * 0.1).astype(np.float32),
            (rng.randn(n, 3, 3, c, c) * lim).astype(np.float32),
            (rng.randn(n, c) * 0.1).astype(np.float32))


@pytest.mark.parametrize("shape,n", [((1, 5, 7), 2), ((2, 37, 53), 2), ((1, 144, 180), 1)],
                         ids=["tiny", "ragged-b2", "calendar"])
def test_emulated_plan_matches_plain_chain(shape, n):
    arrays = _inputs(*shape, n, seed=sum(shape))
    want = resblock_chain_plain(*map(torch.from_numpy, arrays)).numpy()
    got = _emulate(*arrays)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_emulation_sees_a_missing_y_mask():
    """conv2's SAME padding must see zeros outside the image, not relu(b1):
    without the mask the edge pixels move by far more than ATOL."""
    arrays = _inputs(1, 9, 21, 1, seed=5)
    want = resblock_chain_plain(*map(torch.from_numpy, arrays)).numpy()
    assert np.abs(_emulate(*arrays, mask_y=False) - want).max() > 100 * ATOL


# --- fragment maps -------------------------------------------------------
# PTX ISA, mma.m16n8k16 with .bf16: lane t, group g = t // 4, q = t % 4.
def _a_ptx(t, i):   # a_i, i in 0..7 -> (row, k)
    return t // 4 + 8 * ((i // 2) % 2), 2 * (t % 4) + i % 2 + 8 * (i // 4)


def _b_ptx(t, i):   # b_i, i in 0..3 -> (k, n)
    return 2 * (t % 4) + i % 2 + 8 * (i // 2), t // 4


def _c_ptx(t, i):   # c_i, i in 0..3 -> (row, n)
    return t // 4 + 8 * (i // 2), 2 * (t % 4) + i % 2


def _ldmatrix(read, lane_addr, trans):
    """ldmatrix.x4: register j of lane t holds two elements of the 8x8
    matrix whose rows lanes 8j..8j+7 address; ``read(addr, col)``."""
    regs = np.empty((32, 4, 2), object)
    for t in range(32):
        for j in range(4):
            for e in range(2):
                if trans:   # element (row 2*(t%4)+e, col t//4)
                    regs[t, j, e] = read(lane_addr(8 * j + 2 * (t % 4) + e), t // 4)
                else:       # element (row t//4, col 2*(t%4)+e)
                    regs[t, j, e] = read(lane_addr(8 * j + t // 4), 2 * (t % 4) + e)
    return regs


def test_fragment_maps_match_the_ptx_layouts():
    """The kernel's lane addresses give ldmatrix fragments that are exactly
    the PTX A/B operands, and its epilogue's (row, channel) of each
    accumulator is the PTX C layout."""
    # A: rows are pixels; lane l addresses row l % 16 at k offset (l / 16) * 8.
    a = _ldmatrix(lambda addr, col: (addr[0], addr[1] + col),
                  lambda l: (l % 16, (l // 16) * 8), trans=False)
    for t in range(32):
        for i in range(8):
            assert a[t, i // 2, i % 2] == _a_ptx(t, i)
    # B: rows are input channels k (weights stay (c_in, c_out)); lane l
    # addresses k row 8 * ((l / 8) % 2) + l % 8 at n offset (l / 16) * 8;
    # registers 0, 1 -> n8 tile j, 2, 3 -> tile j + 1.
    b = _ldmatrix(lambda addr, col: (addr[0], addr[1] + col),
                  lambda l: (8 * ((l // 8) % 2) + l % 8, (l // 16) * 8), trans=True)
    for t in range(32):
        for tile in range(2):
            for i in range(4):
                k, n = b[t, 2 * tile + i // 2, i % 2]
                assert (k, n - 8 * tile) == _b_ptx(t, i)
    # C: the epilogue reads acc[i][j][2h + e] as row g + 8h, channel
    # j * 8 + 2 * (t % 4) + e of the n8 tile.
    for t in range(32):
        for h in range(2):
            for e in range(2):
                assert _c_ptx(t, 2 * h + e) == (t // 4 + 8 * h, 2 * (t % 4) + e)
