"""The benchmark's FLOP and byte counters against hand counts, and the
readers' arithmetic on a made-up trace."""

import math

import pytest
import torch
import torch.nn.functional as F

from portbench.harness import flops as FL
from portbench.harness import readers
from portbench.harness.trace import GLUE, group_of, union_s
from portbench.reference import model as R


def test_conv_and_chain_by_hand():
    assert FL.conv_macs(2, 3, 4, 5) == 2 * 3 * 9 * 4 * 5
    # 16 blocks of two 64 -> 64 convs on 144 x 180: 61.15 GFLOP (PERF.md's 61.2).
    assert 2 * FL.chain_macs(144, 180, 16) == 2 * 16 * 2 * 144 * 180 * 9 * 64 * 64
    assert round(2 * FL.chain_macs(144, 180, 16) / 1e9, 2) == 61.15


def test_fnet_by_hand():
    h, w = 540, 960
    want = (h * w * 9 * (6 * 32 + 32 * 32)
            + 270 * 480 * 9 * (32 * 64 + 64 * 64)
            + 135 * 240 * 9 * (64 * 128 + 128 * 128)
            + 67 * 120 * 9 * (128 * 256 + 256 * 256)
            + 134 * 240 * 9 * (256 * 128 + 128 * 128)
            + 268 * 480 * 9 * (128 * 64 + 64 * 64)
            + 536 * 960 * 9 * (64 * 32 + 32 * 2))
    assert FL.fnet_macs(h, w) == want


def test_generator_by_hand():
    h, w, n = 144, 180, 16
    want = (h * w * 9 * 51 * 64 + n * 2 * h * w * 9 * 64 * 64 + h * w * 9 * 64 * 64
            + 4 * h * w * 9 * 64 * 64 + 16 * h * w * 9 * 64 * 3)
    assert FL.generator_macs(h, w, n) == want
    # A calendar frame: PERF.md's "~81 GFLOP (trunk ~61)".
    assert 78e9 < FL.frame_flops(h, w, n) < 84e9


def _count_macs(module_fn, *args):
    """Multiply-adds of the convolutions a function runs, counted by
    wrapping conv2d / conv_transpose2d."""
    total = [0]
    conv2d, tconv = F.conv2d, F.conv_transpose2d

    def c2(x, w, b=None, stride=1, padding=0, *a, **k):
        out = conv2d(x, w, b, stride, padding, *a, **k)
        total[0] += out.numel() // out.shape[1] * w.shape[0] * w[0].numel()
        return out

    def ct(x, w, b=None, stride=1, *a, **k):
        total[0] += x.numel() // x.shape[1] * w.numel()
        return tconv(x, w, b, stride, *a, **k)

    F.conv2d, F.conv_transpose2d = c2, ct
    try:
        module_fn(*args)
    finally:
        F.conv2d, F.conv_transpose2d = conv2d, tconv
    return total[0]


@pytest.mark.parametrize("h,w", [(16, 24), (20, 36)])
def test_frame_flops_match_the_reference_convs(h, w):
    weights = R.make_weights(2, 1, "cpu")
    x = torch.rand(1, h, w, 3)
    macs = _count_macs(lambda: R.frame_step(weights, x, torch.rand(1, 4 * h, 4 * w, 3), x))
    assert 2 * macs == FL.frame_flops(h, w, 2)


def test_train_step_flops():
    fwd = 4 * (9 * FL.fnet_macs(32, 32) + 10 * FL.generator_macs(32, 32, 10))
    assert FL.train_step_flops(4, 10, 32, 10) == 6 * fwd


def test_chain_bound_by_hand():
    s, terms = FL.chain_launch_bound((1, 144, 180), 2, "bfloat16")
    px = 144 * 180
    assert terms["flops"] == 2 * 2 * 9 * 64 * 64 * px
    assert terms["bytes"] == (2 * px * 64 + 2 * 9 * 64 * 64 + 2 * 64) * 2
    assert s == max(terms["flops"] / 989e12, terms["bytes"] / 3.35e12)
    # PERF.md's 16-block bound at this shape: 0.0618 ms.
    assert abs(16 * s * 1e3 - 0.0618) < 5e-4
    s32, t32 = FL.chain_launch_bound((4, 32, 32), 4, "float32")
    assert s32 == max(t32["flops"] / 495e12, t32["bytes"] / 3.35e12)


def test_union_and_groups():
    assert union_s([(0, 10), (5, 20), (30, 40)]) == pytest.approx(30e-6)
    assert group_of("void resblock_kernel_mma<...>") == "chain"
    assert group_of("upsample4_bwd_kernel") == "k2"
    assert group_of("sm90_xmma_fprop_implicit_gemm") == "library"
    assert group_of("Memcpy HtoD (Pinned -> Device)") == "copies"
    assert group_of("elementwise_kernel<add>") == GLUE


def test_readers_on_a_made_up_trace():
    trace = {"window_s": 2.0, "busy_s": 1.5,
             "groups_s": {"glue": 0.3, "chain": 0.6}, "chain_s": [0.001] * 100}
    counters = {"frames_processed": 10, "model_flops": 1e15, "compute_dtype": "bfloat16",
                "chain_shape": (1, 144, 180), "chain_itemsize": 2, "capture_s": 0.5}
    ctx = {"trace": trace, "counters": counters}
    assert readers.idle_pct(ctx) == pytest.approx(25.0)
    assert readers.glue_pct(ctx) == pytest.approx(20.0)
    assert readers.device_ms_per(ctx, "frames_processed") == pytest.approx(150.0)
    assert readers.mfu_pct(ctx) == pytest.approx(1e15 / 2.0 / 989e12 * 100)
    bound, _ = FL.chain_launch_bound((1, 144, 180), 2, "bfloat16")
    assert readers.chain_roofline_pct(ctx) == pytest.approx(bound / 0.001 * 100)
    assert readers.counter(ctx, "capture_s") == 0.5
    # Nothing to read: no trace, no launches.
    assert readers.mfu_pct({"trace": None, "counters": counters}) is None
    assert readers.chain_roofline_pct({"trace": dict(trace, chain_s=[]),
                                       "counters": counters}) is None
    assert not math.isnan(readers.idle_pct(ctx))
