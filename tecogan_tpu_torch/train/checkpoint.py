"""Checkpoints of the port's trainer (counterpart of
``tecogan_tpu/train/checkpoint.py:38-212``; reference Saver workflows,
main.py:307-352).

- full resume: step, weights, the Adam states and the loss EMAs; in
  TecoGAN mode also the discriminator (parameters and running statistics),
  its Adam state, ``ema_tbalance`` and the gate's two counters; all copied
  into the state's tensors in place, so a captured step stays valid;
- warm start: model weights only, from another run of the port or from a
  TF checkpoint dumped to npz (:func:`warm_start_tf_npz`), everything else
  fresh (reference ``pre_trained_model``, main.py:312-320), with the JAX
  package's partial restore for a grown or shrunk model
  (:func:`merge_partial_restore`): the canonical case-3 chain grows a
  10-block FRVSR run into a 16-block TecoGAN one, and a source without a
  discriminator leaves the fresh one;
- the last ``keep`` (50) checkpoints are kept (reference main.py:307).

Two layouts of a step directory ``<ckpt_dir>/<step>/``, read by every
entry point (:func:`latest_step` takes the newest step of either):

- the port's: ``<step>/state.pt``, one ``torch.save`` of a dict of tensors
  and plain values (read back with ``weights_only=True``), written by
  :func:`save_checkpoint` (the trainer and the loop) to a temporary
  directory and renamed into place;
- the JAX package's: an orbax checkpoint, ``<step>/default/_METADATA`` and
  its arrays (OCDBT store or one zarr directory a leaf), read through
  ``train/orbax_io.py`` (no JAX, orbax or tensorstore) and mapped by
  ``weights.train_state_from_jax``; :func:`save_jax_checkpoint` writes
  one, which the JAX package's ``restore_checkpoint`` reads.

:func:`load_models` reads a checkpoint's generator and FNet for the
inference CLI.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from tecogan_tpu_torch.train import orbax_io
from tecogan_tpu_torch.train.trainer import TrainState

_GAN_FIELDS = ("ema_tbalance", "counter_with_d", "counter_wo_d")

_STATE_FILE = "state.pt"
_GROWN_CONV_1 = re.compile(r"resblocks\.\d+\.conv_1\.")


def _steps(ckpt_dir: str) -> List[int]:
    """The steps under ``ckpt_dir`` in either layout."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit() and (os.path.isfile(os.path.join(ckpt_dir, d, _STATE_FILE))
                                      or orbax_io.is_jax_step(os.path.join(ckpt_dir, d))))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest checkpoint's step under ``ckpt_dir`` (either layout), or
    None."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _step_dir(ckpt_dir: str, step: Optional[int]) -> str:
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"No checkpoint under {ckpt_dir}")
    return os.path.join(ckpt_dir, str(step))


def _prune(ckpt_dir: str, keep: int) -> None:
    for old in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))


def save_checkpoint(ckpt_dir: str, state: TrainState, keep: int = 50) -> str:
    """Save ``state`` at its step; drop all but the newest ``keep``. Raises
    FileExistsError if that step is already saved."""
    final = os.path.join(ckpt_dir, str(state.step))
    if os.path.exists(final):
        raise FileExistsError(f"checkpoint {final} exists")
    tmp = f"{final}.tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    payload = {
        "step": state.step,
        "generator": state.generator.state_dict(),
        "fnet": state.fnet.state_dict(),
        "gen_opt": state.gen_opt.state_dict(),
        "fnet_opt": state.fnet_opt.state_dict(),
        "ema_losses": dict(state.ema_losses),
    }
    if state.discriminator is not None:
        payload["discriminator"] = state.discriminator.state_dict()
        payload["d_opt"] = state.d_opt.state_dict()
        payload.update({k: getattr(state, k) for k in _GAN_FIELDS})
    torch.save(payload, os.path.join(tmp, _STATE_FILE))
    os.replace(tmp, final)
    _prune(ckpt_dir, keep)
    return final


def save_jax_checkpoint(ckpt_dir: str, state: TrainState, keep: int = 50) -> str:
    """Save ``state`` at its step in the JAX package's orbax layout
    (``orbax_io.write_jax_checkpoint`` of ``weights.train_state_to_jax``),
    which its ``restore_checkpoint`` reads and every entry point here
    too; drop all but the newest ``keep`` steps of either layout."""
    from tecogan_tpu_torch.weights import train_state_to_jax

    final = orbax_io.write_jax_checkpoint(ckpt_dir, state.step, train_state_to_jax(state),
                                          keep=keep)
    _prune(ckpt_dir, keep)
    return final


def _load(step_dir: str) -> Dict:
    """A step in the port's layout, or a JAX one as the port's state dicts
    of the models (``generator``, ``fnet``, ``discriminator`` or None)
    with its ``step``."""
    if not orbax_io.is_jax_step(step_dir):
        return torch.load(os.path.join(step_dir, _STATE_FILE), map_location="cpu",
                          weights_only=True)
    from tecogan_tpu_torch import weights

    tree = orbax_io.read_jax_checkpoint(step_dir)
    gen, fnet = weights.from_jax_params(tree["gen_params"], tree["fnet_params"])
    payload = {"step": int(tree["step"]), "generator": gen.state_dict(),
               "fnet": fnet.state_dict(), "discriminator": None}
    if tree.get("d_params") is not None:
        payload["discriminator"] = weights.discriminator_from_jax(
            tree["d_params"], tree["d_batch_stats"]).state_dict()
    return payload


@torch.no_grad()
def _load_adam_(opt: torch.optim.Adam, saved: Dict) -> None:
    """Adam's saved moments and step counts copied into ``opt``'s state in
    place (made where the optimizer has none yet: Adam makes it lazily).
    Unlike ``Optimizer.load_state_dict``, which puts new tensors in place
    and the saved run's ``param_groups`` (its ``capturable``, its learning
    rate tensor), this keeps every tensor a captured step reads where it
    was, and the optimizer as this run built it; the learning rate is
    written from the device step before each update anyway."""
    params = [p for group in opt.param_groups for p in group["params"]]
    capturable = {id(p): group["capturable"] for group in opt.param_groups
                  for p in group["params"]}
    for i, p in enumerate(params):
        src = saved["state"].get(i)
        if not src:  # saved before its first update: a fresh state
            for t in opt.state.get(p, {}).values():
                t.zero_()
            continue
        dst = opt.state[p]
        for k, v in src.items():
            if k in dst:
                dst[k].copy_(v)
            elif k == "step":  # where Adam keeps it
                dst[k] = v.to(torch.float32, copy=True).to(
                    p.device if capturable[id(p)] else "cpu")
            else:
                dst[k] = v.to(p.device, p.dtype, copy=True)


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, state: TrainState,
                       step: Optional[int] = None) -> TrainState:
    """Full resume into ``state`` (modules and optimizers built as for the
    saved run) from ``step`` or the newest checkpoint, of either layout;
    returns it. Every tensor is restored in place, so the trainer's
    captured steps over ``state`` go on replaying over it."""
    step_dir = _step_dir(ckpt_dir, step)
    if orbax_io.is_jax_step(step_dir):
        from tecogan_tpu_torch.weights import train_state_from_jax

        return train_state_from_jax(orbax_io.read_jax_checkpoint(step_dir), state)
    payload = _load(step_dir)
    state.generator.load_state_dict(payload["generator"])
    state.fnet.load_state_dict(payload["fnet"])
    _load_adam_(state.gen_opt, payload["gen_opt"])
    _load_adam_(state.fnet_opt, payload["fnet_opt"])
    for k, v in payload["ema_losses"].items():
        state.ema_losses[k].copy_(v)
    if state.discriminator is not None:
        state.discriminator.load_state_dict(payload["discriminator"])
        state.d_opt.load_state_dict(payload["d_opt"])
        for k in _GAN_FIELDS:
            getattr(state, k).copy_(payload[k])
    state.step = int(payload["step"])
    state.device_step.fill_(state.step)
    return state


def load_models(ckpt_dir: str, config):
    """The generator and FNet of the newest checkpoint (either layout), for
    inference: ``(step, generator, fnet)`` as float32 CPU modules. Depth
    and widths are the checkpoint's (read from its shapes), the flow's
    velocity ``config``'s."""
    from tecogan_tpu_torch.models import FNet, Generator

    payload = _load(_step_dir(ckpt_dir, None))
    gen_sd, fnet_sd = payload["generator"], payload["fnet"]
    depth = sum(1 for k in gen_sd if re.fullmatch(r"resblocks\.\d+\.conv_1\.weight", k))
    if depth == 0:
        raise ValueError(f"{ckpt_dir}: the generator has no residual blocks")

    def widths(prefix):
        return tuple(v.shape[0] for k, v in fnet_sd.items()
                     if re.fullmatch(rf"{prefix}\.\d+\.conv_1\.weight", k))

    gen = Generator(num_resblock=depth, channels=gen_sd["input_stage_conv.weight"].shape[0])
    fnet = FNet(widths("encoders"), widths("decoders"), config.flow_max_velocity)
    gen.load_state_dict(gen_sd)
    fnet.load_state_dict(fnet_sd)
    return int(payload["step"]), gen, fnet


def merge_partial_restore(current: Dict[str, torch.Tensor],
                          loaded: Dict[str, torch.Tensor], name: str, src: str,
                          zero_missing: bool) -> Dict[str, torch.Tensor]:
    """The JAX package's partial restore of a structure-mismatched model
    (reference ``get_existing_from_ckpt``, lib/ops.py:370-391, with
    ``rest_zero``), over state dicts:

    - the names in both are loaded; a same-named shape mismatch, or no name
      in common, is a hard error (a wrong checkpoint);
    - with ``zero_missing``, names the checkpoint lacks are zero-filled,
      except a grown block's ``resblocks.<i>.conv_1``, which keeps its fresh
      init. A grown block whose conv_2 is zero is an exact identity at step
      0, and unlike the reference's all-zero block it still trains (the JAX
      package's deliberate deviation, ``checkpoint.py:104-112``, 3dab0c4).
      Without ``zero_missing`` they keep their fresh init.

    The log line counts the zero-filled and the fresh names apart, where
    the JAX package counts both as zero-filled.
    """
    hits = [k for k in current if k in loaded]
    if not hits:
        raise ValueError(
            f"warm_start: no overlapping {name} weights between {src} and the "
            "model being trained -- wrong checkpoint? (pass matching "
            "--num_resblock/channels)")
    for k in hits:
        if loaded[k].shape != current[k].shape:
            raise ValueError(
                f"warm_start: shape mismatch for {name}/{k} in {src}: checkpoint "
                f"{tuple(loaded[k].shape)} vs model {tuple(current[k].shape)} "
                "(reference ops.py:382-384 raises here too)")
    merged, zeroed, fresh = {}, 0, 0
    for k, cur in current.items():
        if k in loaded:
            merged[k] = loaded[k].to(cur.dtype)
        elif zero_missing and not _GROWN_CONV_1.match(k):
            merged[k] = torch.zeros_like(cur)
            zeroed += 1
        else:
            merged[k] = cur
            fresh += 1
    unused = [k for k in loaded if k not in current]
    print(f"warm_start: partial {name} restore from {src}: {len(hits)} loaded, "
          f"{zeroed} zero-filled, {fresh} fresh init"
          + (f", {len(unused)} checkpoint entries unused" if unused else ""))
    return merged


def _warm_load(module: nn.Module, loaded: Dict[str, torch.Tensor], name: str,
               src: str, zero_missing: bool) -> None:
    """Load ``loaded`` into ``module`` whole when the names and shapes
    match, else through :func:`merge_partial_restore`."""
    current = module.state_dict()
    same = current.keys() == loaded.keys() and all(
        current[k].shape == loaded[k].shape for k in current)
    module.load_state_dict(loaded if same else merge_partial_restore(
        current, loaded, name, src, zero_missing=zero_missing))


def _warm_start_modules(state: TrainState, loaded: Dict[str, Optional[Dict]], src: str,
                        include_discriminator: bool) -> TrainState:
    """The JAX package's warm start over state dicts: the generator and FNet
    with zero fill (``rest_zero``), the discriminator (when asked and the
    state has one) with fresh init for what the source lacks; a source
    without a discriminator keeps the fresh one."""
    modules = [("generator", state.generator, True), ("fnet", state.fnet, True)]
    if include_discriminator and state.discriminator is not None:
        modules.append(("discriminator", state.discriminator, False))
    for name, module, zero_missing in modules:
        if loaded.get(name) is None:
            print(f"warm_start: {name} not in {src}; keeping fresh init")
            continue
        _warm_load(module, loaded[name], name, src, zero_missing)
    return state


def warm_start(state: TrainState, ckpt_dir: str, step: Optional[int] = None,
               include_discriminator: bool = True) -> TrainState:
    """Load only the model weights of another run's checkpoint into
    ``state``; optimizers, EMAs, the gate's counters and the step stay
    fresh (reference main.py:312-320,351-352; the JAX package's
    ``checkpoint.py:151-212``). A model of another depth takes
    :func:`merge_partial_restore` with zero fill; the discriminator, with
    its running statistics, is taken when ``include_discriminator`` and
    the checkpoint has one. ``ckpt_dir`` holds steps of either layout, or
    is a TF checkpoint dumped to ``.npz`` (:func:`warm_start_tf_npz`)."""
    if os.path.isfile(ckpt_dir) and ckpt_dir.endswith(".npz"):
        return warm_start_tf_npz(state, ckpt_dir, include_discriminator)
    payload = _load(_step_dir(ckpt_dir, step))
    return _warm_start_modules(state, payload, ckpt_dir, include_discriminator)


def warm_start_tf_npz(state: TrainState, npz_path: str,
                      include_discriminator: bool = True) -> TrainState:
    """Warm-start the model weights from a TF checkpoint dumped to npz
    (``weights.convert_tf_npz``), as reference case 3 seeds TecoGAN from the
    published FRVSR model (runGan.py:200-203; the JAX package's
    ``checkpoint.py:215-248``). The npz's depth comes from its names; a
    depth other than the model's takes the partial restore."""
    from tecogan_tpu_torch import weights

    trees = weights.convert_tf_npz(npz_path, num_resblock=None)
    gen, fnet = weights.from_jax_params(trees["generator"], trees["fnet"])
    loaded = {"generator": gen.state_dict(), "fnet": fnet.state_dict()}
    if "discriminator" in trees:
        loaded["discriminator"] = weights.discriminator_from_jax(
            trees["discriminator"], trees["discriminator_batch_stats"]).state_dict()
    return _warm_start_modules(state, loaded, npz_path, include_discriminator)
