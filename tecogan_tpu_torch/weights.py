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
- :func:`discriminator_from_jax` / :func:`discriminator_to_jax` carry the
  discriminator's parameters and batch statistics (flax ``params`` and
  ``batch_stats`` trees) across; :func:`vgg19_from_jax` VGG19's.
- :func:`train_state_from_jax` / :func:`train_state_to_jax` carry a whole
  training state, the JAX package's ``TrainState`` tree (as
  ``train/orbax_io.py`` reads and writes its orbax checkpoints) against the
  port's ``TrainState``: parameters, optax Adam moments and counts, D's
  statistics, the loss EMAs, the gate's EMA and counters and the step.

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
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from tecogan_tpu_torch.models.discriminator import BLOCKS, Discriminator
from tecogan_tpu_torch.models.fnet import FNet
from tecogan_tpu_torch.models.generator import Generator
from tecogan_tpu_torch.models.vgg19 import VGG19Features

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


def _out_channels(tree: Tree, name: str) -> int:
    return int(np.shape(tree[name]["kernel"])[-1])


def from_jax_params(gen_tree: Tree, fnet_tree: Tree,
                    max_velocity: float = 24.0) -> Tuple[Generator, FNet]:
    """Build float32 CPU modules from flax parameter trees."""
    gen = Generator(num_resblock=detect_num_resblock(gen_tree),
                    channels=_out_channels(gen_tree, "input_stage_conv"),
                    out_channels=_out_channels(gen_tree, "output_stage_conv"))
    _copy_in(_layer_leaves(_generator_layers(gen)), gen_tree, "generator")

    def widths(prefix):
        n = sum(1 for k in fnet_tree if re.fullmatch(rf"{prefix}_\d+_conv_1", k))
        return tuple(_out_channels(fnet_tree, f"{prefix}_{i}_conv_1")
                     for i in range(1, n + 1))

    fnet = FNet(channels=widths("encoder"), up_channels=widths("decoder"),
                max_velocity=max_velocity)
    _copy_in(_layer_leaves(_fnet_layers(fnet)), fnet_tree, "fnet")
    return gen, fnet


def _tree(layers: Iterator[Tuple[str, nn.Module]]) -> Dict[str, Dict[str, np.ndarray]]:
    """``{layer: {"kernel": HWIO, "bias": ...}}`` of float32 numpy arrays."""
    return _to_tree(_layer_leaves(layers))


def to_jax_params(gen: Generator, fnet: FNet
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The generator and FNet as flax parameter trees of float32 numpy
    arrays (HWIO kernels); the inverse of :func:`from_jax_params`."""
    return _tree(_generator_layers(gen)), _tree(_fnet_layers(fnet))


def _get(tree: Tree, path: Tuple[str, ...]) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def _tensor(a: Any) -> torch.Tensor:
    """A tree leaf (numpy array, or a torch tensor for bfloat16) as float32."""
    if isinstance(a, torch.Tensor):
        return a.float()
    return torch.from_numpy(np.array(a, np.float32))


# A flax leaf's layout against its torch tensor's: "conv" kernels are HWIO
# (or (kh, kw, out, in) for a transposed conv) against OIHW (or (in, out,
# kh, kw)); the "dense" kernel (256, 1) is a 1x1 conv's (1, 256, 1, 1);
# "same" leaves (biases, statistics) keep their shape.
_TO_TORCH = {"conv": lambda t: t.permute(3, 2, 0, 1),
             "dense": lambda t: t.t()[:, :, None, None],
             "same": lambda t: t}
_TO_JAX = {"conv": lambda t: t.permute(2, 3, 1, 0),
           "dense": lambda t: t[:, :, 0, 0].t(),
           "same": lambda t: t}

_Leaf = Tuple[Tuple[str, ...], torch.Tensor, str]  # (flax path, tensor, layout)


def _layer_leaves(layers: Iterator[Tuple[str, nn.Module]]) -> List[_Leaf]:
    return [leaf for name, m in layers
            for leaf in (((name, "kernel"), m.weight, "conv"), ((name, "bias"), m.bias, "same"))]


def _discriminator_leaves(disc: Discriminator) -> Tuple[List[_Leaf], List[_Leaf]]:
    """The discriminator's parameters and running statistics against the
    flax ``params`` and ``batch_stats`` trees of
    ``tecogan_tpu/models/discriminator.py``."""
    params = _layer_leaves([("input_stage_conv", disc.input_stage_conv)])
    stats: List[_Leaf] = []
    for (idx, _), block in zip(BLOCKS, disc.blocks):
        bn = f"disblock_{idx}_bn"
        params += [((f"disblock_{idx}_conv", "kernel"), block.conv.weight, "conv"),
                   ((bn, "bn", "bias"), block.bn.bias, "same")]
        stats += [((bn, "bn", "mean"), block.bn.running_mean, "same"),
                  ((bn, "bn", "var"), block.bn.running_var, "same")]
    params += [(("dense", "kernel"), disc.dense.weight, "dense"),
               (("dense", "bias"), disc.dense.bias, "same")]
    return params, stats


@torch.no_grad()
def _copy_in(leaves: List[_Leaf], tree: Tree, what: str) -> None:
    """Each flax leaf of ``tree`` into its tensor, in place."""
    for path, t, layout in leaves:
        src = _TO_TORCH[layout](_tensor(_get(tree, path)))
        if src.shape != t.shape:
            raise ValueError(f"{what}/{'/'.join(path)} maps to {tuple(src.shape)}, "
                             f"the model holds {tuple(t.shape)}")
        t.copy_(src)


def _to_tree(leaves: List[_Leaf], tensors: Optional[List[torch.Tensor]] = None) -> Dict[str, Any]:
    """The flax tree of ``leaves`` (or of ``tensors`` in their place), as
    float32 numpy arrays."""
    out: Dict[str, Any] = {}
    for i, (path, t, layout) in enumerate(leaves):
        t = t if tensors is None else tensors[i]
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _TO_JAX[layout](t.detach().cpu().float()).contiguous().numpy()
    return out


def discriminator_from_jax(d_params: Tree, d_batch_stats: Optional[Tree] = None
                           ) -> Discriminator:
    """A float32 CPU :class:`Discriminator` from the flax trees of
    ``tecogan_tpu/models/discriminator.py`` (input channels read from the
    shapes); without ``d_batch_stats`` the running statistics keep their
    fresh values (mean 0, variance 1)."""
    stem = d_params["input_stage_conv"]
    disc = Discriminator(in_channels=int(np.shape(stem["kernel"])[2]))
    params, stats = _discriminator_leaves(disc)
    _copy_in(params, d_params, "d_params")
    if d_batch_stats is not None:
        _copy_in(stats, d_batch_stats, "d_batch_stats")
    return disc


def discriminator_to_jax(disc: Discriminator) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse of :func:`discriminator_from_jax`: (params, batch_stats)
    as flax trees of float32 numpy arrays."""
    params, stats = _discriminator_leaves(disc)
    return _to_tree(params), _to_tree(stats)


def vgg19_from_jax(params: Tree) -> VGG19Features:
    """A float32 CPU :class:`VGG19Features` from the flax tree of
    ``tecogan_tpu/models/vgg19.py`` (``conv{b}_{i}`` -> kernel, bias)."""
    vgg = VGG19Features()
    _copy_in(_layer_leaves(vgg.convs.items()), params, "vgg19")
    return vgg


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
    :func:`from_jax_params` takes, plus ``"discriminator"`` and
    ``"discriminator_batch_stats"`` (:func:`discriminator_from_jax`) when the
    npz holds ``tdiscriminator/...`` variables. Counterpart of
    ``tecogan_tpu/train/checkpoint.py:convert_tf_npz`` (``:262-370``).

    Both spellings of a conv are read: ``.../conv_1/Conv/weights`` (slim
    scopes) and flat ``.../conv_1/weights``. Adam slots and EMA shadows are
    ignored. ``num_resblock=None`` takes the depth
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
    d = "tdiscriminator/discriminator_unit"
    if any(k.startswith("tdiscriminator") for k in data):
        disc: Dict[str, Any] = {"input_stage_conv": conv(f"{d}/input_stage/conv")}
        stats: Dict[str, Any] = {}
        for idx, _ in BLOCKS:
            bn = f"{d}/disblock_{idx}/BatchNorm"
            disc[f"disblock_{idx}_conv"] = {"kernel": get(f"{d}/disblock_{idx}/conv1/Conv/weights")}
            disc[f"disblock_{idx}_bn"] = {"bn": {"bias": get(f"{bn}/beta")}}
            stats[f"disblock_{idx}_bn"] = {"bn": {"mean": get(f"{bn}/moving_mean"),
                                                  "var": get(f"{bn}/moving_variance")}}
        disc["dense"] = {"kernel": get(f"{d}/dense_layer_2/dense/kernel").reshape(-1, 1),
                         "bias": get(f"{d}/dense_layer_2/dense/bias")}
        out["discriminator"] = disc
        out["discriminator_batch_stats"] = stats
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


# --------------------------------------------------------------- TrainState
def _state_leaves(state) -> List[Tuple[str, str, List[_Leaf], Any]]:
    """(params key, optimizer key, leaves, optimizer) of each model of a
    port ``TrainState``, in the JAX TrainState's field names."""
    out = [("gen_params", "gen_opt", _layer_leaves(_generator_layers(state.generator)),
            state.gen_opt),
           ("fnet_params", "fnet_opt", _layer_leaves(_fnet_layers(state.fnet)), state.fnet_opt)]
    if state.discriminator is not None:
        out.append(("d_params", "d_opt", _discriminator_leaves(state.discriminator)[0],
                    state.d_opt))
    return out


def _check_keys(got, want, what: str) -> None:
    if set(got) != set(want):
        raise ValueError(f"{what}: the checkpoint has {sorted(set(got) - set(want))} "
                         f"beyond the model and lacks {sorted(set(want) - set(got))}")


def _moments(opt, params: List[torch.Tensor]) -> Tuple[List, List, List]:
    """(first moments, second moments, update counts) of the port's Adam
    (a count a parameter) or MaskedAdam (one count) over ``params``; a
    torch Adam's state is made where it has none yet (Adam makes it
    lazily), as its first step would."""
    if hasattr(opt, "mu"):  # MaskedAdam, over the discriminator's parameters
        index = {id(p): i for i, p in enumerate(opt.params)}
        order = [index[id(p)] for p in params]
        return [opt.mu[i] for i in order], [opt.nu[i] for i in order], [opt.count]
    from tecogan_tpu_torch.train.trainer import _init_adam_state

    _init_adam_state(opt)
    states = [opt.state[p] for p in params]
    return ([s["exp_avg"] for s in states], [s["exp_avg_sq"] for s in states],
            [s["step"] for s in states])


def _as_torch(a: Any) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


@torch.no_grad()
def train_state_from_jax(tree: Tree, state) -> Any:
    """Copy the JAX package's TrainState (a tree as
    ``train/orbax_io.read_jax_checkpoint`` returns it) into the port's
    ``TrainState`` in place, so a captured step over ``state`` stays valid;
    returns ``state``. The models must have the checkpoint's structure.

    Each optax ``scale_by_adam`` moment (``<opt>/0/mu``, ``/0/nu``) takes
    its parameter's layout into ``exp_avg`` / ``exp_avg_sq`` (MaskedAdam's
    ``mu`` / ``nu``), ``<opt>/0/count`` becomes Adam's ``step`` (MaskedAdam's
    ``count``); the schedule's ``<opt>/1/count`` equals it and is not read.
    The loss EMAs match key by key; ``step``, ``ema_tbalance`` and the
    gate's counters carry across. An FRVSR checkpoint holds ``None`` in the
    discriminator's fields (orbax's ``value_type: "None"``)."""
    if (tree.get("d_params") is None) != (state.discriminator is None):
        raise ValueError("the checkpoint's mode (FRVSR / TecoGAN) is not the model's: "
                         "one has a discriminator, the other has none")
    models = _state_leaves(state)
    for params_key, _, leaves, _ in models:
        _check_keys(tree[params_key], {path[0] for path, _, _ in leaves}, params_key)
    _check_keys(tree["ema_losses"], state.ema_losses, "ema_losses")
    for params_key, opt_key, leaves, opt in models:
        _copy_in(leaves, tree[params_key], params_key)
        adam = tree[opt_key][0]
        mu, nu, counts = _moments(opt, [t for _, t, _ in leaves])
        for key, moments in (("mu", mu), ("nu", nu)):
            _copy_in([(p, m, layout) for (p, _, layout), m in zip(leaves, moments)],
                     adam[key], f"{opt_key}/0/{key}")
        for count in counts:
            count.fill_(int(adam["count"]))
    if state.discriminator is not None:
        _copy_in(_discriminator_leaves(state.discriminator)[1], tree["d_batch_stats"],
                 "d_batch_stats")
        for k in ("ema_tbalance", "counter_with_d", "counter_wo_d"):
            getattr(state, k).copy_(_as_torch(tree[k]))
    for k, v in state.ema_losses.items():
        v.copy_(_as_torch(tree["ema_losses"][k]))
    state.step = int(tree["step"])
    state.device_step.fill_(state.step)
    return state


def train_state_to_jax(state) -> Dict[str, Any]:
    """The port's ``TrainState`` as the JAX package's TrainState tree
    (field order, optax ``(ScaleByAdamState, ScaleByScheduleState)``
    optimizer states, None in an FRVSR state's discriminator fields), of
    numpy arrays: the inverse of :func:`train_state_from_jax`, which
    ``train/orbax_io.write_jax_checkpoint`` writes."""
    def scalar(v, dtype):
        return np.asarray(v.item() if isinstance(v, torch.Tensor) else v, dtype)

    tree: Dict[str, Any] = {"step": scalar(state.step, np.int32)}
    opts: Dict[str, Any] = {}
    for params_key, opt_key, leaves, opt in _state_leaves(state):
        tensors = [t for _, t, _ in leaves]
        if hasattr(opt, "mu") or opt.state.get(tensors[0]):
            mu, nu, counts = _moments(opt, tensors)
        else:  # before the first update: optax's init
            mu = nu = [torch.zeros_like(t) for t in tensors]
            counts = [0]
        tree[params_key] = _to_tree(leaves)
        count = scalar(counts[0], np.int32)
        opts[opt_key] = [{"count": count, "mu": _to_tree(leaves, mu), "nu": _to_tree(leaves, nu)},
                         {"count": count.copy()}]
    tree["gen_opt"], tree["fnet_opt"] = opts["gen_opt"], opts["fnet_opt"]
    gan = state.discriminator is not None
    tree["d_params"] = tree.pop("d_params", None)
    tree["d_batch_stats"] = (_to_tree(_discriminator_leaves(state.discriminator)[1])
                             if gan else None)
    tree["d_opt"] = opts.get("d_opt")
    tree["ema_tbalance"] = scalar(state.ema_tbalance, np.float32) if gan else None
    tree["counter_with_d"] = scalar(state.counter_with_d, np.int32) if gan else None
    tree["counter_wo_d"] = scalar(state.counter_wo_d, np.int32) if gan else None
    tree["ema_losses"] = {k: scalar(v, np.float32) for k, v in state.ema_losses.items()}
    return tree
