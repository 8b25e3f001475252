"""Spatial sharding of streaming inference (counterpart of
``tecogan_tpu/parallel/spatial.py``).

Each LR frame, its recurrent state and every activation of the frame step
are split by rows over the devices of one mesh axis. In the JAX package
GSPMD inserts a halo exchange before every convolution; here the exchange
is written per layer: a shard is extended by the rows the layer needs from
each neighbour (copied to its device), the layer runs unchanged on the
extended shard, and the rows that the extension made wrong are cropped. At
the frame's top and bottom nothing is added, so a layer's own SAME padding
or edge clamp is the frame's. The layers and their halos, in rows at the
layer's input:

- a 3x3 convolution: 1;
- :data:`CHAIN_HALO_BLOCKS` residual blocks in one chain-kernel call: 2 per
  block (each block's two convolutions), cropped likewise;
- K1's 4x upsample: 1 for the bilinear flow upsample, 2 for the
  Catmull-Rom skip;
- a stride-2 transposed convolution: 1;
- FNet's 2x bilinear upsample: 1;
- FNet's 2x2 max-pools: none, since shard boundaries fall on multiples of
  8 LR rows;
- the warp: ``int(max_displacement) + 1`` HR rows
  (``ops/warp.py:warp_space_to_depth_halo_shards``). Where a shard is not
  taller than that, each shard gathers the whole previous frame and warps
  its rows from it, as the JAX package falls back to its unsharded warp:
  the same result.

So the chain kernel and K1 run on every shard. Where every shard sits on
one device, ``StreamingSR`` captures the whole sharded chunk (exchanges,
crops, kernels and all) as one CUDA graph, the counterpart of the JAX
package's ``jax.jit`` over the sharded chunk; across devices the exchange
would make the graph span cards, which :func:`sharded_capture` leaves to
ROADMAP item 11c. A frame of h LR rows over n
shards gives the first n-1 shards ``8 * (h // (8n))`` rows each and the last
the rest, so any height of at least 8n rows runs; FNet's symmetric bottom
pad (``models/fnet.py:pad_flow_to``) is the last shard's. A layer whose
halo is taller than a neighbour's shard raises ``ValueError``.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tecogan_tpu_torch.kernels.resblocks import resblock_chain
from tecogan_tpu_torch.kernels.upsample4 import bicubic_four, upscale_bilinear4
from tecogan_tpu_torch.models.fnet import FNet, pad_flow_to
from tecogan_tpu_torch.models.generator import Generator
from tecogan_tpu_torch.models.layers import lrelu, maxpool_2x2
from tecogan_tpu_torch.ops.image import deprocess, preprocess
from tecogan_tpu_torch.ops.resize import upscale_bilinear
from tecogan_tpu_torch.ops.space_to_depth import space_to_depth
from tecogan_tpu_torch.ops.warp import (
    DEFAULT_MAX_DISPLACEMENT,
    dense_image_warp_box,
    warp_space_to_depth_halo_shards,
)
from tecogan_tpu_torch.parallel.mesh import canonical_device
from tecogan_tpu_torch.utils.cuda_graphs import capture_route, resolve_capture

#: Residual blocks per chain-kernel call between two halo exchanges (the
#: halo depth k): a 2k = 8-row halo, the height of the chain kernel's pixel
#: tiles, which the thinnest shard FNet's pools allow (8 LR rows) can still
#: give. Each exchange recomputes 8 rows a side (11% of a 72-row shard of a
#: 144-row frame over 2 shards); k = 1 would recompute 2 rows but make 16
#: exchanges, each a copy of the shard, for TecoGAN's 16 blocks, and
#: k = 16 a 32-row halo that no 8-row shard can give.
CHAIN_HALO_BLOCKS = 4

Shards = List[torch.Tensor]


def shard_rows(h: int, n: int) -> List[int]:
    """LR rows of each of ``n`` shards of an ``h``-row frame: multiples of 8
    (FNet's pools), the remainder on the last shard."""
    base = 8 * (h // (8 * n))
    if base < 8:
        raise ValueError(f"{h}-row LR frames give no {n} shards of at least 8 rows "
                         f"(FNet's pools need shard boundaries on multiples of 8); "
                         f"use at most {max(h // 8, 1)} shards")
    return [base] * (n - 1) + [h - base * (n - 1)]


def sharded_capture(capture: Optional[bool], devices: Sequence[torch.device]
                    ) -> Tuple[bool, str]:
    """The ``capture=`` argument of ``StreamingSR`` on a spatial mesh whose
    shards sit on ``devices``: whether its chunk runs as one captured CUDA
    graph, and the route with its reason. Every shard on one device: as
    :func:`resolve_capture` (None captures on the card, True on the CPU
    raises). Shards on distinct devices: the halo exchanges would make one
    graph span cards (ROADMAP item 11c), so None runs eagerly and True
    raises. Decided from the devices alone, before anything runs."""
    distinct = list(dict.fromkeys(devices))
    names = ", ".join(str(d) for d in devices)
    if len(distinct) > 1:
        if capture:
            raise ValueError(f"capture=True with row shards on distinct devices ({names}): "
                             "capturing a chunk across cards is ROADMAP item 11c; pass "
                             "capture=None or False")
        return False, (f"eager: {len(devices)} row shards on {len(distinct)} distinct "
                       f"devices ({names}), and capturing a chunk across cards is ROADMAP "
                       "item 11c")
    captured = resolve_capture(capture, distinct[0])
    return captured, f"{capture_route(captured, distinct[0])}, {len(devices)} row shards"


def on_device(device: torch.device):
    """``device`` made current for the kernels' launches (they take the
    current device's stream); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def split_rows(x: torch.Tensor, rows: Sequence[int], devices: Sequence[torch.device]
               ) -> Shards:
    """(B, H, ...) ``x`` cut into row blocks of ``rows``, each on its device."""
    return [part.to(d) for part, d in zip(torch.split(x, list(rows), dim=1), devices)]


def gather_rows(shards: Shards, device) -> torch.Tensor:
    """The row shards joined on ``device``."""
    return torch.cat([s.to(device) for s in shards], dim=1)


def exchange(shards: Shards, halo: int, what: str) -> List[Tuple[torch.Tensor, int, int]]:
    """Each shard extended by ``halo`` rows of each neighbour (dim 1), none
    at the frame's edges: ``(extended, rows added on top, rows added at the
    bottom)`` per shard."""
    out = []
    for i, x in enumerate(shards):
        parts, top, bottom = [x], 0, 0
        for j, at_top in ((i - 1, True), (i + 1, False)):
            if halo == 0 or not 0 <= j < len(shards):
                continue
            rows = shards[j].shape[1]
            if rows < halo:
                raise ValueError(
                    f"{what}: shard {j} has {rows} rows, fewer than the {halo}-row halo "
                    f"shard {i} needs from it; use fewer shards or taller frames")
            if at_top:
                parts.insert(0, shards[j][:, rows - halo:].to(x.device))
                top = halo
            else:
                parts.append(shards[j][:, :halo].to(x.device))
                bottom = halo
        out.append((torch.cat(parts, dim=1) if len(parts) > 1 else x, top, bottom))
    return out


def halo_map(fn: Callable[[int, torch.Tensor], torch.Tensor], shards: Shards, halo: int,
             scale: int = 1, what: str = "layer") -> Shards:
    """``fn(i, extended shard i)`` on every shard after a ``halo``-row
    exchange, each on its device, with the ``scale * halo`` output rows of
    each added side cropped (the layer's output has ``scale`` x its rows)."""
    out = []
    for i, (ext, top, bottom) in enumerate(exchange(shards, halo, what)):
        with on_device(ext.device):
            y = fn(i, ext)
        out.append(y[:, top * scale:y.shape[1] - bottom * scale])
    return out


def replicate(module: torch.nn.Module, devices: Sequence[torch.device]) -> List[torch.nn.Module]:
    """One copy of ``module`` per device (shared where a device repeats;
    the module itself on its own device), in its dtype, eval mode, and on
    the card in ``channels_last``."""
    home = next(module.parameters()).device
    copies = {}
    for d in devices:
        if d not in copies:
            m = module if d == home else copy.deepcopy(module)
            fmt = torch.channels_last if d.type == "cuda" else torch.preserve_format
            copies[d] = m.to(device=d, memory_format=fmt).eval()
    return [copies[d] for d in devices]


class ShardedState(NamedTuple):
    prev_lr: Shards  # per shard (B, h_i, w, 3)
    prev_hr: Shards  # per shard (B, 4h_i, 4w, 3)


class ShardedStep:
    """The frame step over the row shards of one mesh axis: FNet and the
    flow upsample (:meth:`flows`), the warp and the generator
    (:meth:`generator_step`), each layer behind its halo exchange.

    Args:
      generator / fnet: the models, replicated to every shard's device.
      devices: one per shard, top to bottom (a device may repeat).
      max_displacement: the warp's flow bound in HR pixels.
    """

    def __init__(self, generator: Generator, fnet: FNet, devices: Sequence[torch.device],
                 max_displacement: float = DEFAULT_MAX_DISPLACEMENT):
        self.devices = [canonical_device(d) for d in devices]
        self.generators = replicate(generator, self.devices)
        self.fnets = replicate(fnet, self.devices)
        self.max_displacement = max_displacement
        # Residual blocks per chain call: the halo depth k.
        self.chain_blocks = max(1, min(CHAIN_HALO_BLOCKS, len(generator.resblocks)))
        self.warp_halo = int(max_displacement) + 1
        self.halo_warps = self.gather_warps = 0  # warps by route

    def rows(self, h: int) -> List[int]:
        return shard_rows(h, len(self.devices))

    def split(self, x: torch.Tensor, scale: int = 1) -> Shards:
        """(B, H, ...) ``x`` cut into the shards' rows: LR rows, or
        ``scale`` x as many (4 for an HR tensor)."""
        rows = [scale * r for r in self.rows(x.shape[1] // scale)]
        return split_rows(x, rows, self.devices)

    # ------------------------------------------------------------ FNet
    def _conv(self, net: Shards, pick: Callable, act=None, what: str = "conv") -> Shards:
        def fn(i, e):
            y = pick(i)(_nchw(e))
            return _nhwc(act(y) if act is not None else y)
        return halo_map(fn, net, 1, what=what)

    def fnet(self, xs: Shards) -> Shards:
        """FNet over row shards of (N, h, w, 6) pairs -> per shard (N, rows,
        w//8*8, 2) flows in LR pixels (``models/fnet.py:FNet.forward``)."""
        f0 = self.fnets[0]
        net = [x.to(f0.output_conv2.weight.dtype) for x in xs]
        for j in range(len(f0.encoders)):
            net = self._conv(net, lambda i: self.fnets[i].encoders[j].conv_1, lrelu, "fnet")
            net = self._conv(net, lambda i: self.fnets[i].encoders[j].conv_2, lrelu, "fnet")
            net = [_nhwc(maxpool_2x2(_nchw(e))) for e in net]
        for j in range(len(f0.decoders)):
            net = self._conv(net, lambda i: self.fnets[i].decoders[j].conv_1, lrelu, "fnet")
            net = self._conv(net, lambda i: self.fnets[i].decoders[j].conv_2, lrelu, "fnet")
            net = halo_map(lambda i, e: upscale_bilinear(e, 2), net, 1, 2, "fnet upsample")
        net = self._conv(net, lambda i: self.fnets[i].output_conv1, lrelu, "fnet")
        net = self._conv(net, lambda i: self.fnets[i].output_conv2, None, "fnet")
        return [torch.tanh(e) * f0.max_velocity for e in net]

    def flows(self, pairs: Shards, h: int, w: int) -> Shards:
        """FNet, the last shard's symmetric pad to the frame's ``h`` rows and
        ``w`` columns, and K1's x4 bilinear upsample with the x4 scale
        (``recurrent/step.py:upscale_flow``): per shard (N, 4 rows, 4w, 2)."""
        flows = self.fnet(pairs)
        last = len(flows) - 1
        rows = self.rows(h)
        flows = [pad_flow_to(f, rows[i] if i == last else f.shape[1], w)
                 for i, f in enumerate(flows)]
        return halo_map(lambda i, e: upscale_bilinear4(e.contiguous(), alpha=4.0),
                        flows, 1, 4, "flow upsample")

    # ------------------------------------------------------------ generator
    def generator(self, xs: Shards) -> Shards:
        """The generator over row shards of (B, h, w, 51) inputs, as
        ``models/generator.py:Generator.forward``: per shard (B, 4 rows,
        4w, 3) in [-1, 1]."""
        g0 = self.generators[0]
        dtype = g0.input_stage_conv.weight.dtype
        xs = [x.to(dtype) for x in xs]
        lrs = [x[..., :g0.out_channels].contiguous() for x in xs]
        net = self._conv(xs, lambda i: self.generators[i].input_stage_conv, F.relu, "generator")
        n = len(g0.resblocks)
        if n:
            weights = {}
            for g, d in zip(self.generators, self.devices):
                if d not in weights:
                    weights[d] = g.trunk_weights()
            k = self.chain_blocks
            for j in range(0, n, k):
                kk = min(k, n - j)

                def chain(i, e, j=j, kk=kk):
                    w = weights[self.devices[i]]
                    return resblock_chain(e.contiguous(), *(t[j:j + kk] for t in w))

                net = halo_map(chain, net, 2 * kk, what=f"chain of {kk} blocks")
        for name in ("conv_tran1", "conv_tran2"):
            net = halo_map(lambda i, e: _nhwc(getattr(self.generators[i], name).forward_relu(
                _nchw(e))), net, 1, 2, "transposed conv")
        net = self._conv(net, lambda i: self.generators[i].output_stage_conv, None, "generator")
        skip = halo_map(lambda i, e: bicubic_four(e.contiguous()), lrs, 2, 4, "bicubic skip")
        return [preprocess(a + b) for a, b in zip(net, skip)]

    def warp(self, prev_hr: Shards, flows: Shards) -> Shards:
        """``warp_space_to_depth(prev_hr, flow, 4)`` by shards: the halo
        warp, or, on shards not taller than its halo, each shard's rows
        warped from the whole gathered frame."""
        if min(x.shape[1] for x in prev_hr) > self.warp_halo:
            self.halo_warps += 1
            return warp_space_to_depth_halo_shards(
                prev_hr, flows, 4, max_displacement=self.max_displacement)
        self.gather_warps += 1
        out, r0 = [], 0
        for x, f in zip(prev_hr, flows):
            whole = gather_rows(prev_hr, x.device)
            out.append(space_to_depth(dense_image_warp_box(whole, f, (r0, 0)), 4))
            r0 += x.shape[1]
        return out

    def generator_step(self, state: ShardedState, lrs: Shards, flows: Shards
                       ) -> Tuple[ShardedState, Shards]:
        """``recurrent/step.py:generator_step`` by shards."""
        packed = self.warp(state.prev_hr, flows)
        out = self.generator([torch.cat([lr, p], dim=-1) for lr, p in zip(lrs, packed)])
        hr = [deprocess(o) for o in out]
        return ShardedState(prev_lr=list(lrs), prev_hr=hr), hr

    def frame_step(self, state: ShardedState, lrs: Shards) -> Tuple[ShardedState, Shards]:
        """``recurrent/step.py:frame_step`` by shards."""
        h = sum(x.shape[1] for x in lrs)
        w = lrs[0].shape[2]
        pairs = [torch.cat([p, c], dim=-1) for p, c in zip(state.prev_lr, lrs)]
        return self.generator_step(state, lrs, self.flows(pairs, h, w))


def spatial_streaming_fn(generator: Generator, fnet: FNet, mesh, axis: str = "space",
                         max_displacement: float = DEFAULT_MAX_DISPLACEMENT):
    """Build a frame-by-frame streaming function with H sharded over the
    devices of ``mesh``'s ``axis``.

    Returns ``run(state, lr_chunk) -> (state, hr)``: ``state`` a
    :class:`~tecogan_tpu_torch.recurrent.step.RecurrentState`, ``lr_chunk``
    (T, B, h, w, 3) in [0, 1]; each frame is split by rows over the shards
    and goes through :meth:`ShardedStep.frame_step`; the new state and the
    (T, B, 4h, 4w, 3) HR frames are gathered on the first shard's device.
    The models stay in their dtype; the parameters are replicated, and the
    JAX version's per-call parameters are the modules'.
    """
    from tecogan_tpu_torch.recurrent.step import RecurrentState

    step = ShardedStep(generator, fnet, mesh.axis_devices(axis), max_displacement)
    home = step.devices[0]

    @torch.inference_mode()
    def run(state, lr_chunk: torch.Tensor):
        st = ShardedState(step.split(state.prev_lr), step.split(state.prev_hr, 4))
        outs = []
        for lr in lr_chunk:
            st, hr = step.frame_step(st, step.split(lr))
            outs.append(gather_rows(hr, home))
        new = RecurrentState(gather_rows(st.prev_lr, home), gather_rows(st.prev_hr, home))
        return new, torch.stack(outs)

    run.step = step
    return run
