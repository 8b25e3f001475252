"""Checkpoints of the port's trainer (counterpart of
``tecogan_tpu/train/checkpoint.py:38-212``; reference Saver workflows,
main.py:307-352).

- full resume: step, weights, both Adam states and the loss EMAs;
- warm start: generator and FNet weights only, from another run of the
  port, everything else fresh (reference ``pre_trained_model``,
  main.py:312-320), with the JAX package's partial restore for a grown or
  shrunk model (:func:`merge_partial_restore`);
- the last ``keep`` (50) checkpoints are kept (reference main.py:307).

Layout: ``<ckpt_dir>/<step>/state.pt``, one ``torch.save`` of a dict of
tensors and plain values (read back with ``weights_only=True``), written to
a temporary directory and renamed into place. The JAX package's orbax
checkpoints are not read; weights cross between the packages through
``weights.params_to_npz`` / ``read_params_npz``. :func:`load_models`
reads a checkpoint's generator and FNet for the inference CLI. Warm starts
from a TF npz (``warm_start_tf_npz``) are not ported yet.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict, List, Optional

import torch

from tecogan_tpu_torch.train.trainer import TrainState

_STATE_FILE = "state.pt"
_GROWN_CONV_1 = re.compile(r"resblocks\.\d+\.conv_1\.")


def _steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit() and os.path.isfile(os.path.join(ckpt_dir, d, _STATE_FILE)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest checkpoint's step under ``ckpt_dir``, or None."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _path(ckpt_dir: str, step: Optional[int]) -> str:
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"No checkpoint under {ckpt_dir}")
    return os.path.join(ckpt_dir, str(step), _STATE_FILE)


def save_checkpoint(ckpt_dir: str, state: TrainState, keep: int = 50) -> str:
    """Save ``state`` at its step; drop all but the newest ``keep``. Raises
    FileExistsError if that step is already saved."""
    final = os.path.join(ckpt_dir, str(state.step))
    if os.path.exists(final):
        raise FileExistsError(f"checkpoint {final} exists")
    tmp = f"{final}.tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    torch.save({
        "step": state.step,
        "generator": state.generator.state_dict(),
        "fnet": state.fnet.state_dict(),
        "gen_opt": state.gen_opt.state_dict(),
        "fnet_opt": state.fnet_opt.state_dict(),
        "ema_losses": dict(state.ema_losses),
    }, os.path.join(tmp, _STATE_FILE))
    os.replace(tmp, final)
    for old in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))
    return final


def _load(ckpt_dir: str, step: Optional[int]) -> Dict:
    # CPU first: Optimizer.load_state_dict moves the moments to each
    # parameter's device and keeps Adam's step counts on the host.
    return torch.load(_path(ckpt_dir, step), map_location="cpu", weights_only=True)


def restore_checkpoint(ckpt_dir: str, state: TrainState,
                       step: Optional[int] = None) -> TrainState:
    """Full resume into ``state`` (modules and optimizers built as for the
    saved run) from ``step`` or the newest checkpoint; returns it."""
    payload = _load(ckpt_dir, step)
    device = next(state.generator.parameters()).device
    state.generator.load_state_dict(payload["generator"])
    state.fnet.load_state_dict(payload["fnet"])
    state.gen_opt.load_state_dict(payload["gen_opt"])
    state.fnet_opt.load_state_dict(payload["fnet_opt"])
    state.ema_losses = {k: v.to(device) for k, v in payload["ema_losses"].items()}
    state.step = int(payload["step"])
    return state


def load_models(ckpt_dir: str, config):
    """The generator and FNet of the newest checkpoint, for inference: ``(step,
    generator, fnet)`` as float32 CPU modules. Depth and widths are the
    checkpoint's (read from its shapes), the flow's velocity ``config``'s."""
    from tecogan_tpu_torch.models import FNet, Generator

    payload = _load(ckpt_dir, None)
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


def warm_start(state: TrainState, ckpt_dir: str,
               step: Optional[int] = None) -> TrainState:
    """Load only the generator and FNet weights of another run's checkpoint
    into ``state``; optimizers, EMAs and step stay fresh (reference
    main.py:312-320,351-352). A model of another depth takes
    :func:`merge_partial_restore` with zero fill."""
    payload = _load(ckpt_dir, step)
    for name, module in (("generator", state.generator), ("fnet", state.fnet)):
        current, loaded = module.state_dict(), payload[name]
        same = current.keys() == loaded.keys() and all(
            current[k].shape == loaded[k].shape for k in current)
        module.load_state_dict(loaded if same else merge_partial_restore(
            current, loaded, name, ckpt_dir, zero_missing=True))
    return state
