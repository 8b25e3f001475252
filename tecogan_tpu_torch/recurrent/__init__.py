from tecogan_tpu_torch.recurrent.inference import (
    WARMUP_FRAMES,
    StreamingSR,
    prepend_warmup,
)
from tecogan_tpu_torch.recurrent.step import (
    RecurrentState,
    extend_pingpong,
    flows_for_sequence,
    frame_step,
    init_state,
    unroll_generator,
    upscale_flow,
)

__all__ = [
    "RecurrentState",
    "StreamingSR",
    "WARMUP_FRAMES",
    "extend_pingpong",
    "flows_for_sequence",
    "frame_step",
    "init_state",
    "prepend_warmup",
    "unroll_generator",
    "upscale_flow",
]
