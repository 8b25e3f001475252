"""Weights from the JAX package into the port's modules.

- :func:`from_jax_params` takes the generator and FNet parameter trees as
  flax produces them (nested dicts of arrays, e.g. after ``jax.device_get``)
  and returns a :class:`Generator` and an :class:`FNet` holding them, with
  depth and widths read from the shapes.
- :func:`to_jax_params` is its inverse: modules -> flax-layout trees of
  numpy arrays.
- :func:`read_params_npz` reads the flat ``<tree>/<layer>/<param>`` npz files
  written by ``tecogan_tpu/train/checkpoint.py:params_to_npz`` back into
  nested dicts, e.g. ``{"generator": {...}, "fnet": {...}}``;
  :func:`params_to_npz` writes them, so the JAX package reads a model the
  port trained (``npz_to_params``).
- :func:`convert_tf_npz` maps the variable names of a TF TecoGAN/FRVSR
  checkpoint dumped to npz onto those trees.

Layouts: a flax ``Conv`` kernel is HWIO, a torch ``Conv2d`` weight OIHW; a
flax ``ConvTranspose(transpose_kernel=True)`` kernel is (kh, kw, out, in), a
torch ``ConvTranspose2d`` weight (in, out, kh, kw). ``permute(3, 2, 0, 1)``
maps both, with no spatial flip.

Deviation from the JAX package: :func:`detect_num_resblock` raises on a tree
with no residual blocks, where ``checkpoint.py:detect_num_resblock`` returns
0 and the model would silently run without its trunk.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from tecogan_tpu_torch.models.fnet import FNet
from tecogan_tpu_torch.models.generator import Generator

Tree = Mapping[str, Any]
_RESBLOCK = re.compile(r"resblock_(\d+)_conv_1$")


def detect_num_resblock(gen_tree: Tree) -> int:
    """Number of residual blocks in a generator tree (its
    ``resblock_{i}_conv_1`` keys); raises if there are none."""
    n = sum(1 for k in gen_tree if _RESBLOCK.match(k))
    if n == 0:
        raise ValueError("generator tree has no resblock_{i}_conv_1 entries; "
                         "refusing to build a generator without its trunk")
    return n


def _generator_layers(gen: Generator) -> Iterator[Tuple[str, nn.Module]]:
    yield "input_stage_conv", gen.input_stage_conv
    for i, block in enumerate(gen.resblocks, 1):
        yield f"resblock_{i}_conv_1", block.conv_1
        yield f"resblock_{i}_conv_2", block.conv_2
    yield "conv_tran1", gen.conv_tran1
    yield "conv_tran2", gen.conv_tran2
    yield "output_stage_conv", gen.output_stage_conv


def _fnet_layers(fnet: FNet) -> Iterator[Tuple[str, nn.Module]]:
    for prefix, blocks in (("encoder", fnet.encoders), ("decoder", fnet.decoders)):
        for i, block in enumerate(blocks, 1):
            yield f"{prefix}_{i}_conv_1", block.conv_1
            yield f"{prefix}_{i}_conv_2", block.conv_2
    yield "output_conv1", fnet.output_conv1
    yield "output_conv2", fnet.output_conv2


@torch.no_grad()
def _fill(layers: Iterator[Tuple[str, nn.Module]], tree: Tree) -> None:
    for name, module in layers:
        if name not in tree:
            raise KeyError(f"parameter tree has no {name!r}")
        kernel = torch.from_numpy(np.asarray(tree[name]["kernel"], np.float32))
        kernel = kernel.permute(3, 2, 0, 1)
        if kernel.shape != module.weight.shape:
            raise ValueError(f"{name}: kernel maps to {tuple(kernel.shape)}, "
                             f"module wants {tuple(module.weight.shape)}")
        module.weight.copy_(kernel)
        module.bias.copy_(torch.from_numpy(np.asarray(tree[name]["bias"], np.float32)))


def _out_channels(tree: Tree, name: str) -> int:
    return int(np.shape(tree[name]["kernel"])[-1])


def from_jax_params(gen_tree: Tree, fnet_tree: Tree,
                    max_velocity: float = 24.0) -> Tuple[Generator, FNet]:
    """Build float32 CPU modules from flax parameter trees."""
    gen = Generator(num_resblock=detect_num_resblock(gen_tree),
                    channels=_out_channels(gen_tree, "input_stage_conv"),
                    out_channels=_out_channels(gen_tree, "output_stage_conv"))
    _fill(_generator_layers(gen), gen_tree)

    def widths(prefix):
        n = sum(1 for k in fnet_tree if re.fullmatch(rf"{prefix}_\d+_conv_1", k))
        return tuple(_out_channels(fnet_tree, f"{prefix}_{i}_conv_1")
                     for i in range(1, n + 1))

    fnet = FNet(channels=widths("encoder"), up_channels=widths("decoder"),
                max_velocity=max_velocity)
    _fill(_fnet_layers(fnet), fnet_tree)
    return gen, fnet


def _tree(layers: Iterator[Tuple[str, nn.Module]]) -> Dict[str, Dict[str, np.ndarray]]:
    return {name: {"kernel": module.weight.detach().cpu().float().permute(2, 3, 1, 0).numpy(),
                   "bias": module.bias.detach().cpu().float().numpy()}
            for name, module in layers}


def to_jax_params(gen: Generator, fnet: FNet
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The generator and FNet as flax parameter trees of float32 numpy
    arrays (HWIO kernels); the inverse of :func:`from_jax_params`."""
    return _tree(_generator_layers(gen)), _tree(_fnet_layers(fnet))


def params_to_npz(path: str, **trees: Tree) -> None:
    """Write nested parameter trees (e.g. ``generator=..., fnet=...``) to one
    npz with flat ``<tree>/<layer>/<param>`` keys, the format of
    ``tecogan_tpu/train/checkpoint.py:params_to_npz``."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(f"{prefix}/{key}", child)
        else:
            flat[prefix] = np.asarray(node)

    for name, tree in trees.items():
        walk(name, tree)
    np.savez(path, **flat)


_TF_RESBLOCK = re.compile(
    r"generator/generator_unit/resblock_(\d+)/conv_1/(Conv/)?weights$")


def convert_tf_npz(npz_path: str, num_resblock: Optional[int] = 16) -> Dict[str, Any]:
    """A TF TecoGAN/FRVSR checkpoint dumped to npz (TF variable name ->
    array) as flax-layout trees of numpy arrays: ``{"generator": ...,
    "fnet": ...}`` (plus ``"global_step"`` when present), which
    :func:`from_jax_params` takes. Counterpart of
    ``tecogan_tpu/train/checkpoint.py:convert_tf_npz`` (``:262-331``) for
    the generator and FNet; the discriminator's trees wait for TecoGAN
    training.

    Both spellings of a conv are read: ``.../conv_1/Conv/weights`` (slim
    scopes) and flat ``.../conv_1/weights``. Adam slots, EMA shadows and
    the discriminator are ignored. ``num_resblock=None`` takes the depth
    from the npz's own names; unlike the JAX package it raises when there
    are none rather than build a generator without its trunk."""
    with np.load(npz_path) as z:
        data = {k: z[k] for k in z.files}
    if num_resblock is None:
        num_resblock = max((int(m.group(1)) for m in map(_TF_RESBLOCK.match, data) if m),
                           default=0)
        if num_resblock == 0:
            raise ValueError(f"{npz_path}: no generator resblock_<i>/conv_1 weights; "
                             "refusing to build a generator without its trunk")

    def get(*names):
        for name in names:
            if name in data:
                return data[name]
        raise KeyError(f"none of {names} in checkpoint npz")

    def conv(scope, inner="Conv"):
        # A TF conv2d_transpose kernel, [k, k, out, in], is already the
        # layout of a flax ConvTranspose(transpose_kernel=True).
        return {"kernel": get(f"{scope}/{inner}/weights", f"{scope}/weights"),
                "bias": get(f"{scope}/{inner}/biases", f"{scope}/biases")}

    g = "generator/generator_unit"
    gen = {"input_stage_conv": conv(f"{g}/input_stage/conv")}
    for i in range(1, num_resblock + 1):
        gen[f"resblock_{i}_conv_1"] = conv(f"{g}/resblock_{i}/conv_1")
        gen[f"resblock_{i}_conv_2"] = conv(f"{g}/resblock_{i}/conv_2")
    for j in (1, 2):
        gen[f"conv_tran{j}"] = conv(f"{g}/conv_tran2highres/conv_tran{j}", "Conv2d_transpose")
    gen["output_stage_conv"] = conv(f"{g}/output_stage/conv")

    f = "fnet/autoencode_unit"
    fnet = {}
    for i in (1, 2, 3):
        for j in (1, 2):
            fnet[f"encoder_{i}_conv_{j}"] = conv(f"{f}/encoder_{i}/conv_{j}")
            fnet[f"decoder_{i}_conv_{j}"] = conv(f"{f}/decoder_{i}/conv_{j}")
    fnet["output_conv1"] = conv(f"{f}/output_stage/conv1")
    fnet["output_conv2"] = conv(f"{f}/output_stage/conv2")
    out: Dict[str, Any] = {"generator": gen, "fnet": fnet}
    if "global_step" in data:
        out["global_step"] = int(data["global_step"])
    return out


def read_params_npz(path: str) -> Dict[str, Dict[str, Any]]:
    """``params_to_npz`` file -> {tree name: nested dict of numpy arrays}."""
    out: Dict[str, Dict[str, Any]] = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = out
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return out
