from tecogan_tpu_torch.models.discriminator import Discriminator
from tecogan_tpu_torch.models.fnet import FNet, pad_flow_to
from tecogan_tpu_torch.models.generator import Generator
from tecogan_tpu_torch.models.vgg19 import VGG19Features

__all__ = ["Discriminator", "FNet", "Generator", "VGG19Features", "pad_flow_to"]
