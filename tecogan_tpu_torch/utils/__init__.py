"""Host-side helpers of the port: console logging, scalar / image / GIF
summaries and their TensorBoard event file, profiling, and the captured
CUDA graphs of the inference and training paths (``cuda_graphs.py``)."""

from tecogan_tpu_torch.utils.logging import Tee, param_summary
from tecogan_tpu_torch.utils.summaries import SummaryLogger, encode_gif

__all__ = ["Tee", "param_summary", "SummaryLogger", "encode_gif"]
