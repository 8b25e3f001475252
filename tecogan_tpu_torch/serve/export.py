"""The serving frame step as a ``torch.export`` artifact (counterpart of
``tecogan_tpu/serve/export.py``, which lowers it to StableHLO).

The reference deploys a TF1 checkpoint plus the Python that rebuilds its
graph (reference main.py:187-245). Here the deployment artifact is an
``ExportedProgram`` of the single-frame serving step
(serve/engine.py:build_frame_fn) with the parameters inside, saved as a
``.pt2`` file. A serving host loads and calls it with no model code: it
needs ``torch`` and :mod:`tecogan_tpu_torch.kernels`, whose import
registers the operators the program calls for K1 and the chain
(``torch.ops.tecogan_torch.*``, kernels/ops.py).

Round trip:

    ep = export_frame_step(cfg, generator, fnet, batch=4, height=144,
                           width=180)
    save_frame_step(ep, "step.pt2")
    ...
    step = load_frame_step("step.pt2")    # -> callable
    state, hr = step(state, lr_batch)     # (prev_lr, prev_hr), lr -> ...

The program's own signature is flat, ``(prev_lr, prev_hr, lr) -> (prev_lr,
prev_hr, hr)``, so loading it needs no registered state type. The state
layout is recurrent/step.py's RecurrentState (prev_lr in [0, 1], prev_hr
deprocessed in [0, 1], in the compute dtype); a fresh stream starts from
zeros (reference main.py:197-199). Shapes, dtypes and the device are fixed
at export: one program per (batch, height, width), as the JAX package's.
"""

from __future__ import annotations

import copy
from typing import Union

import torch

import tecogan_tpu_torch.kernels  # noqa: F401  (registers the kernels' operators)


class _FrameStep(torch.nn.Module):
    """The serving frame function over flat tensors, for export."""

    def __init__(self, config, generator, fnet, output: str):
        super().__init__()
        from tecogan_tpu_torch.serve.engine import build_frame_fn

        self.generator, self.fnet = generator, fnet
        self.frame_fn = build_frame_fn(config, output=output)

    def forward(self, prev_lr, prev_hr, lr):
        from tecogan_tpu_torch.recurrent.step import RecurrentState

        state, out = self.frame_fn(self.generator, self.fnet,
                                   RecurrentState(prev_lr, prev_hr), lr)
        return state.prev_lr, state.prev_hr, out


def export_frame_step(config, generator, fnet, batch: int, height: int, width: int,
                      output: str = "uint8", input_dtype=torch.uint8,
                      device="cuda") -> torch.export.ExportedProgram:
    """Trace the serving frame step into an ``ExportedProgram`` with the
    models' parameters inside.

    Args:
      config: ``compute_dtype`` and the model widths.
      generator / fnet: the models; copies are placed on ``device`` in the
        compute dtype (the caller's modules are not moved).
      batch / height / width: the static serving geometry.
      output: "uint8" (quantised on the device) or "float32".
      input_dtype: the LR frames' dtype, torch.uint8 or torch.float32.
      device: the device the program runs on; the card unless the caller
        asks for the CPU.
    """
    from tecogan_tpu_torch.recurrent.inference import place_models
    from tecogan_tpu_torch.recurrent.step import init_state

    device = torch.device(device)
    dtype = config.torch_dtype
    gen, fn = place_models(copy.deepcopy(generator), copy.deepcopy(fnet), device, dtype)
    module = _FrameStep(config, gen.requires_grad_(False), fn.requires_grad_(False),
                        output).eval()
    state = init_state(batch, height, width, dtype, device)
    lr = torch.zeros((batch, height, width, 3), dtype=input_dtype, device=device)
    return torch.export.export(module, (state.prev_lr, state.prev_hr, lr))


def save_frame_step(exported: torch.export.ExportedProgram, path: str) -> None:
    """Write the program and its parameters to one ``.pt2`` file."""
    torch.export.save(exported, path)


def load_frame_step(path: Union[str, bytes]):
    """Load a saved step as a callable ``(state, lr) -> (state, hr)``; the
    state is any (prev_lr, prev_hr) pair, returned as the same type when it
    is a named tuple and as a tuple otherwise."""
    if isinstance(path, (bytes, bytearray)):
        import io

        path = io.BytesIO(bytes(path))
    program = torch.export.load(path).module()

    def step(state, lr):
        prev_lr, prev_hr, hr = program(state[0], state[1], lr)
        make = getattr(type(state), "_make", tuple)
        return make((prev_lr, prev_hr)), hr

    return step
