from tecogan_tpu_torch.recurrent.inference import (
    WARMUP_FRAMES,
    StreamingSR,
    prepend_warmup,
)
from tecogan_tpu_torch.recurrent.step import (
    RecurrentState,
    frame_step,
    init_state,
    upscale_flow,
)

__all__ = [
    "RecurrentState",
    "StreamingSR",
    "WARMUP_FRAMES",
    "frame_step",
    "init_state",
    "prepend_warmup",
    "upscale_flow",
]
