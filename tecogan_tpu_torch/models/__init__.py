from tecogan_tpu_torch.models.fnet import FNet, pad_flow_to
from tecogan_tpu_torch.models.generator import Generator

__all__ = ["FNet", "Generator", "pad_flow_to"]
