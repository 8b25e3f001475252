"""Multi-stream serving of the port (counterpart of ``tecogan_tpu/serve``):
the slot-pool servers, the incremental frame sources and the exported
frame step."""

from tecogan_tpu_torch.serve.engine import (
    MultiGeometryServer,
    VSRServer,
    build_frame_fn,
)
from tecogan_tpu_torch.serve.export import (
    export_frame_step,
    load_frame_step,
    save_frame_step,
)
from tecogan_tpu_torch.serve.sources import EOS, PENDING, FrameSource

__all__ = [
    "MultiGeometryServer",
    "VSRServer",
    "build_frame_fn",
    "FrameSource",
    "PENDING",
    "EOS",
    "export_frame_step",
    "save_frame_step",
    "load_frame_step",
]
