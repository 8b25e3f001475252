"""The tile walk of the bfloat16 warpgroup-MMA chain kernel
(``tecogan_tpu_torch/csrc/resblock_chain_mma.cu``), emulated in numpy.

The kernel runs only on the card. These tests hold its plan to the plain
chain on the CPU: the units of :func:`chain_plan` walked by persistent
CTAs, the flat rows (tap (dy, dx) of an m64 tile is ring row dy with its
start moved dx pixels), the rings of x and y rows with their full and
empty mbarriers driven by the three roles in a random interleaving (TMA
copies landing late; a row's operands must not change between the issue
of its MMAs and the wait for them),
the conv1 y mask outside the image, the junk
columns (read past a row into whatever follows it, here NaN, and never
stored), the edge strips and segments, the wgmma accumulator layout and the
128-byte swizzle of the epilogue's addresses. The constants are read from
the ``.cu`` file's ``constexpr int`` lines, so the emulation and the kernel
cannot drift apart. float32 throughout: the kernel's bfloat16 rounding is
checked on the card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tecogan_tpu_torch.kernels import resblock_chain_plain
from tecogan_tpu_torch.kernels.resblocks import STRIP_COLS, chain_plan

torch.set_num_threads(1)

SOURCE = (Path(__file__).resolve().parent.parent / "tecogan_tpu_torch" / "csrc"
          / "resblock_chain_mma.cu")
# The plan this file emulates; must equal the kernel's constexpr ints.
PLAN = dict(C=64, XW=64, TW=60, PX=128, ROW=8192, TAP=8192, X_SLOTS=6, Y_SLOTS=4,
            W_TAPS=18, W_BOX=3, kWarps=9, kThreads=288, Y_OFF=49152, W_OFF=81920,
            BAR_OFF=229376, N_BARS=22, SMEM_BYTES=230576)
C, XW, TW, PX = (PLAN[k] for k in ("C", "XW", "TW", "PX"))
X_SLOTS, Y_SLOTS = PLAN["X_SLOTS"], PLAN["Y_SLOTS"]
SMEM_PER_BLOCK = 232448  # the most an H100 block may opt in to
SMS = 132                # H100 SXM
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
    assert STRIP_COLS == TW


def test_plan_fits_the_shared_memory_budget():
    """One CTA per SM: both convs' 18 taps, 6 x rows and 4 y rows of 64
    pixels, the mbarriers and 1 KB to align the base to the 128-byte
    swizzle's 1024-byte pattern, within the 232,448 B a block may use."""
    p = PLAN
    assert p["ROW"] == p["XW"] * p["PX"] and p["PX"] == 2 * C == 128
    assert p["W_OFF"] + p["W_TAPS"] * p["TAP"] == p["BAR_OFF"]
    assert p["Y_OFF"] % 1024 == p["W_OFF"] % 1024 == p["BAR_OFF"] % 8 == 0
    assert p["N_BARS"] == 2 * X_SLOTS + 2 * Y_SLOTS + 2
    assert p["SMEM_BYTES"] == 1024 + p["BAR_OFF"] + 8 * p["N_BARS"] <= SMEM_PER_BLOCK
    assert 2 * p["SMEM_BYTES"] > 228 * 1024  # one CTA an SM, as launch_bounds says
    assert 9 % p["W_BOX"] == 0 and p["W_BOX"] * C <= 256  # a TMA box has at most 256 rows
    # The wgmma descriptor's start field holds addresses below 2^18.
    assert p["SMEM_BYTES"] < 2 ** 18


# --- 128-byte swizzle ------------------------------------------------------

def _swizzle(addr):
    """The 128-byte swizzle of TMA and wgmma on a shared-memory address:
    the 16-byte chunk bits [4:7) XORed with the 128-byte row bits [7:10)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _px_off(p, n):
    """The kernel's ``px_off``: channel n of pixel p in a swizzled flat row."""
    return p * PX + (((n >> 3) ^ (p & 7)) << 4) + (n & 7) * 2


def test_flat_row_taps_are_descriptor_offsets():
    """A TMA row written at a 1024-aligned slot puts channel n of pixel p at
    ``px_off``; the wgmma of tap dx and 16-channel step kc starts at
    slot + (dx * PX + kc * 32) and reads row r's 16-byte chunks where that
    pixel's channels are, for every start (the hardware swizzles on the
    address bits); the epilogue's 4-byte stores and loads of one
    accumulator register hit 32 banks."""
    rng = np.random.RandomState(0)
    for slot in rng.randint(0, 200, size=20) * 1024:
        for p in range(XW + 2):
            for n in range(0, C, 2):
                assert _swizzle(slot + p * PX + 2 * n) == slot + _px_off(p, n)
        for dx in range(3):
            for kc in range(C // 16):
                start = slot + dx * PX + kc * 32
                for r in range(64):
                    for k in range(2):
                        want = slot + _px_off(dx + r, 16 * kc + 8 * k)
                        assert _swizzle(start + r * PX + k * 16) == want
    for wq in range(4):
        for i in range(0, 32, 2):
            for skip in (0, 2):
                banks = {(_px_off(16 * wq + lane // 4 + 8 * ((i // 2) % 2) + skip,
                                  8 * (i // 4) + 2 * (lane % 4)) // 4) % 32
                         for lane in range(32)}
                assert len(banks) == 32


def _acc_map():
    """(pixel, channel) of accumulator element i of each thread of a
    warpgroup, as the kernel's epilogues read it: the PTX layout of the
    wgmma m64nNk16 f32 D fragment (warp w owns rows 16w..16w+15; per n8
    block, row lane/4 (+8), columns 2 (lane % 4) + 0, 1)."""
    rows, cols = np.empty((128, 32), int), np.empty((128, 32), int)
    for t in range(128):
        wq, lane = t // 32, t % 32
        for i in range(32):
            rows[t, i] = 16 * wq + lane // 4 + 8 * ((i // 2) % 2)
            cols[t, i] = 8 * (i // 4) + 2 * (lane % 4) + i % 2
    assert len(set(zip(rows.ravel(), cols.ravel()))) == 64 * 64
    return rows, cols


ACC_ROWS, ACC_COLS = _acc_map()


# --- the walk ----------------------------------------------------------------

class _Barrier:
    """An mbarrier: ``count`` arrivals and the expected transaction bytes
    complete a phase; ``done(parity)`` is ``try_wait.parity``."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def _maybe_complete(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def arrive(self, n=1, tx=0):
        self.pending -= n
        self.tx += tx
        assert self.pending >= 0
        self._maybe_complete()

    def land(self, tx):
        self.tx -= tx
        self._maybe_complete()

    def done(self, parity):
        return (self.phase & 1) != parity


def _wait(bar, parity):
    while not bar.done(parity):
        yield


def _cta(cta, grid, plan, x, w1, b1, w2, b2, out, writes, mask_y, rnd):
    """One persistent CTA: the producer, conv1 and conv2 roles as the
    kernel runs them, interleaved at random, over shared memory as pixel
    rows (x ring, y ring, then what follows: NaN)."""
    _, h, w, _ = x.shape
    units = list(range(cta, plan.units, grid))
    smem = np.full(((X_SLOTS + Y_SLOTS) * XW + 2, C), np.nan, np.float32)
    x_full = [_Barrier(1) for _ in range(X_SLOTS)]
    x_empty = [_Barrier(8) for _ in range(X_SLOTS)]
    y_full = [_Barrier(4) for _ in range(Y_SLOTS)]
    y_empty = [_Barrier(4) for _ in range(Y_SLOTS)]
    w_full = [_Barrier(1), _Barrier(1)]
    copies = []  # TMA copies in flight: (barrier, rows, data)

    def unit_of(u):
        per_b = plan.strips * plan.segs
        r = u % per_b
        r0 = (r // plan.strips) * plan.seg_rows
        return u // per_b, r0, min(r0 + plan.seg_rows, h), (r % plan.strips) * TW

    def x_row(b, gy, gx0):
        """A TMA box: 64 pixels from column gx0, zeros outside the tensor."""
        gx = gx0 + np.arange(XW)
        ok = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
        return np.where(ok[:, None], x[b, min(max(gy, 0), h - 1), np.clip(gx, 0, w - 1)], 0)

    def producer():
        w_full[0].arrive(tx=1)
        copies.append((w_full[0], None, None))
        seq = 0
        for u in units:
            b, r0, r1, tx0 = unit_of(u)
            for lo in range(r1 - r0 + 4):
                if seq == 3:
                    w_full[1].arrive(tx=1)
                    copies.append((w_full[1], None, None))
                slot = seq % X_SLOTS
                yield from _wait(x_empty[slot], ((seq // X_SLOTS) & 1) ^ 1)
                x_full[slot].arrive(tx=1)
                copies.append((x_full[slot], slice(slot * XW, (slot + 1) * XW),
                               x_row(b, r0 - 2 + lo, tx0 - 2)))
                seq += 1

    def conv(rows, wk):
        """acc over the 9 taps: ring row dy from its start + dx pixels."""
        acc = np.zeros((XW, C), np.float32)
        for dy in range(3):
            for dx in range(3):
                acc += smem[rows[dy] + dx:rows[dy] + dx + XW] @ wk[dy, dx]
        return acc[ACC_ROWS, ACC_COLS]  # per thread, as the epilogue holds it

    def issued(rows, wk, used):
        """The MMAs run between their issue and their wait: the operands of
        the ``used`` leading rows read at the issue must still be there at
        the wait (the junk rows read past the ring row, where the next row
        may be landing)."""
        acc = conv(rows, wk)

        def result():
            keep = ACC_ROWS < used
            np.testing.assert_array_equal(conv(rows, wk)[keep], acc[keep])
            return acc
        return result

    def conv_rows(n, start, finish):
        """Each row's MMAs are issued, run while the other roles go on, and
        are waited for before the row's epilogue."""
        for r in range(n):
            acc = yield from start(r)
            yield
            yield from finish(r, acc())

    def conv1():
        yield from _wait(w_full[0], 0)
        xq = yq = 0
        for u in units:
            b, r0, r1, tx0 = unit_of(u)
            ny = r1 - r0 + 2

            def start(m):
                for lo in range(0 if m == 0 else m + 2, m + 3):
                    yield from _wait(x_full[(xq + lo) % X_SLOTS], ((xq + lo) // X_SLOTS) & 1)
                if 0 <= r0 - 1 + m < h:
                    return issued([((xq + m + dy) % X_SLOTS) * XW for dy in range(3)], w1,
                                  XW - 2)
                return lambda: np.zeros((128, 32), np.float32)  # no MMAs

            def finish(m, acc):
                row_in = 0 <= r0 - 1 + m < h
                x_empty[(xq + m) % X_SLOTS].arrive(4)
                yseq = yq + m
                yield from _wait(y_empty[yseq % Y_SLOTS], ((yseq // Y_SLOTS) & 1) ^ 1)
                gx = tx0 - 1 + ACC_ROWS
                inside = row_in & (gx >= 0) & (gx < w)
                y = np.maximum(acc + b1[ACC_COLS], 0)
                if mask_y:
                    y = np.where(inside, y, 0)
                smem[X_SLOTS * XW + (yseq % Y_SLOTS) * XW + ACC_ROWS, ACC_COLS] = y
                y_full[yseq % Y_SLOTS].arrive(4)

            yield from conv_rows(ny, start, finish)
            x_empty[(xq + ny) % X_SLOTS].arrive(4)
            x_empty[(xq + ny + 1) % X_SLOTS].arrive(4)
            xq, yq = xq + ny + 2, yq + ny

    def conv2():
        yield from _wait(w_full[1], 0)
        xq = yq = 0
        for u in units:
            b, r0, r1, tx0 = unit_of(u)
            rows_out = r1 - r0

            def start(o):
                for k in range(0 if o == 0 else o + 2, o + 3):
                    yield from _wait(y_full[(yq + k) % Y_SLOTS], ((yq + k) // Y_SLOTS) & 1)
                return issued([X_SLOTS * XW + ((yq + o + dy) % Y_SLOTS) * XW
                               for dy in range(3)], w2, TW)

            def finish(o, acc):
                y_empty[(yq + o) % Y_SLOTS].arrive(4)
                xs = (xq + o + 2) % X_SLOTS
                yield from _wait(x_full[xs], ((xq + o + 2) // X_SLOTS) & 1)
                skip = smem[xs * XW + ACC_ROWS + 2, ACC_COLS]
                gx = tx0 + ACC_ROWS
                ok = (ACC_ROWS < TW) & (gx < w)
                out[b, r0 + o, gx[ok], ACC_COLS[ok]] = (skip + acc + b2[ACC_COLS])[ok]
                writes[b, r0 + o, gx[ok], ACC_COLS[ok]] += 1
                if o == 0:
                    x_empty[xq % X_SLOTS].arrive(4)
                    x_empty[(xq + 1) % X_SLOTS].arrive(4)
                x_empty[xs].arrive(4)

            yield from conv_rows(rows_out, start, finish)
            for k in (rows_out, rows_out + 1):
                y_empty[(yq + k) % Y_SLOTS].arrive(4)
            for k in (rows_out + 2, rows_out + 3):
                x_empty[(xq + k) % X_SLOTS].arrive(4)
            xq, yq = xq + rows_out + 4, yq + rows_out + 2

    roles = [producer(), conv1(), conv2()]
    idle = 0
    while roles or copies:
        if copies and (not roles or rnd.random() < 0.3):  # a copy lands, maybe late
            bar, rows, data = copies.pop(rnd.randrange(len(copies)) if rnd.random() < 0.2 else 0)
            if rows is not None:
                smem[rows] = data
            bar.land(1)
            idle = 0
            continue
        role = rnd.choice(roles)
        try:
            next(role)
        except StopIteration:
            roles.remove(role)
        idle += 1
        assert idle < 10000, "the roles wait on each other: deadlock"
    for bars in (x_full, x_empty, y_full, y_empty, w_full):
        assert all(bar.pending == bar.count and bar.tx == 0 for bar in bars)


def _emulate(x, w1, b1, w2, b2, sms=SMS, mask_y=True, seed=0):
    rnd = random.Random(seed)
    for i in range(w1.shape[0]):
        b, h, w, _ = x.shape
        plan = chain_plan(b, h, w, sms)
        out = np.full_like(x, np.nan)
        writes = np.zeros(x.shape, int)
        for cta in range(plan.grid):
            _cta(cta, plan.grid, plan, x, w1[i], b1[i], w2[i], b2[i], out, writes, mask_y, rnd)
        assert (writes == 1).all()
        x = out
    return x


def _inputs(b, h, w, n, seed):
    rng = np.random.RandomState(seed)
    lim = 0.5 * (6.0 / (2 * 9 * C)) ** 0.5
    return (np.maximum(rng.randn(b, h, w, C), 0).astype(np.float32),
            (rng.randn(n, 3, 3, C, C) * lim).astype(np.float32),
            (rng.randn(n, C) * 0.1).astype(np.float32),
            (rng.randn(n, 3, 3, C, C) * lim).astype(np.float32),
            (rng.randn(n, C) * 0.1).astype(np.float32))


@pytest.mark.parametrize("shape,n,sms", [
    ((1, 5, 7), 2, SMS), ((2, 37, 53), 2, SMS), ((1, 144, 180), 1, SMS),
    ((1, 80, 180), 1, SMS), ((2, 37, 130), 1, 7), ((4, 32, 32), 1, SMS)],
    ids=["tiny", "ragged-b2", "vid4", "shard", "ragged-7-sms", "training"])
def test_emulated_walk_matches_plain_chain(shape, n, sms):
    """``shard``: a Vid4 frame's first of 2 row shards with its 8-row halo
    (``parallel/spatial.py``: 4 blocks a chain call); ``ragged-7-sms``: 3
    strips (the last 10 columns) and several units a CTA."""
    arrays = _inputs(*shape, n, seed=sum(shape))
    want = resblock_chain_plain(*map(torch.from_numpy, arrays)).numpy()
    got = _emulate(*arrays, sms=sms, seed=n)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed", range(4))
def test_walk_over_many_units_a_cta_in_random_interleavings(seed):
    """One CTA walks all 4 units (2 frames x 2 strips) of a 70-column frame,
    the rings running on across units: no interleaving of the roles (nor
    any order of the copies landing) deadlocks, reuses a slot early or
    changes a row's operands between its issue and its wait."""
    arrays = _inputs(2, 11, 70, 1, seed=11)
    want = resblock_chain_plain(*map(torch.from_numpy, arrays)).numpy()
    np.testing.assert_allclose(_emulate(*arrays, sms=1, seed=100 + seed), want,
                               rtol=0, atol=ATOL)


def test_emulation_sees_a_missing_y_mask():
    """conv2's SAME padding must see zeros outside the image, not relu(b1):
    without the mask the edge pixels move by far more than ATOL."""
    arrays = _inputs(1, 9, 21, 1, seed=5)
    want = resblock_chain_plain(*map(torch.from_numpy, arrays)).numpy()
    assert np.abs(_emulate(*arrays, mask_y=False) - want).max() > 100 * ATOL


@pytest.mark.parametrize("shape,want", [
    ((1, 540, 960), (16, 68, 8, 128, 128)), ((1, 144, 180), (3, 4, 36, 108, 108)),
    ((4, 32, 32), (1, 1, 32, 128, 128)), ((1, 5, 7), (1, 1, 5, 5, 5))],
    ids=["2160p", "vid4", "training", "tiny"])
def test_chain_plan_at_the_path_shapes(shape, want):
    """One wave of whole-strip units where the card has room: at 2160p's
    LR frame 16 strips x 8 segments of 68 rows on 128 of 132 SMs."""
    plan = chain_plan(*shape, SMS)
    assert tuple(plan) == want
    b, h, w = shape
    assert plan.strips * TW >= w > (plan.strips - 1) * TW
    assert plan.segs * plan.seg_rows >= h > (plan.segs - 1) * plan.seg_rows
    assert plan.units == b * plan.strips * plan.segs and plan.grid == min(plan.units, SMS)
