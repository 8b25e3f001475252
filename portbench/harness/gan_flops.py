"""The model's operations in a TecoGAN adversarial training step (case 3),
counted from layer shapes as ``harness/flops.py`` counts FRVSR's: the work
the published model needs, whatever implements it. A multiply-add is 2
FLOP; convolutions are counted, element-wise work, warps, resizes and
losses are not.

A step at batch B, N frames extended by ping-pong to T = 2N - 1, and crop c:

- FNet on the T - 1 pairs and the generator on the T frames, forward plus
  twice that for the backward (``flops.train_step_flops``'s rule; a
  recompute of the backward, as the chain's replay or the unroll's remat,
  is the implementation's and not counted);
- VGG19 up to ``conv5_4`` forward on the T generated and the T target
  frames of 4c x 4c, and its input gradient (dgrad) on the generated ones:
  its weights are frozen, so it has no weight gradient;
- Dst on B (T // 3) triplets of 4c x 4c, as the plain reference
  (``reference/gan.py``) runs it: four forwards (real and fake for the
  generator's losses, again for the discriminator's step); the input
  gradient through the fake one for the generator; the weight gradients on
  real and fake and the input gradients below the input conv (its input
  is a constant) for the discriminator.
"""

from __future__ import annotations

from typing import Tuple

from portbench.harness.flops import conv_macs, fnet_macs, generator_macs

VGG19 = ((1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512), (5, 4, 512))
DST_BLOCKS = (64, 64, 128, 256)


def vgg19_macs(h: int, w: int) -> int:
    """VGG19's 16 3x3 convs on one (h, w) image, a 2x2 pool (floor) before
    each block after the first."""
    macs, cin = 0, 3
    for block, n, c in VGG19:
        if block > 1:
            h, w = h // 2, w // 2
        for _ in range(n):
            macs += conv_macs(h, w, cin, c)
            cin = c
    return macs


def dst_macs(h: int, w: int, in_channels: int = 27) -> Tuple[int, int]:
    """Dst on one (h, w) input: (all its multiply-adds, the input conv's).
    The blocks are 4x4 stride-2 convs with SAME padding (outputs of
    ceil(size / 2)); the head is a 1x1 conv to one channel."""
    first = conv_macs(h, w, in_channels, 64)
    macs, cin = first, 64
    for c in DST_BLOCKS:
        h, w = (h + 1) // 2, (w + 1) // 2
        macs += h * w * 16 * cin * c
        cin = c
    return macs + h * w * cin, first


def gan_step_flops(batch: int, rnn_n: int, crop: int, blocks: int) -> int:
    """One TecoGAN step's FLOPs (the module docstring's count)."""
    t = 2 * rnn_n - 1
    hr = 4 * crop
    g = batch * ((t - 1) * fnet_macs(crop, crop) + t * generator_macs(crop, crop, blocks))
    vgg = 3 * batch * t * vgg19_macs(hr, hr)
    triplets = batch * (t // 3)
    d, d_first = dst_macs(hr, hr)
    dst = triplets * (4 * d + d + 2 * d + 2 * (d - d_first))
    return 2 * (3 * g + vgg + dst)
