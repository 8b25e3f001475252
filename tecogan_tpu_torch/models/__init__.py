from tecogan_tpu_torch.models.discriminator import Discriminator
from tecogan_tpu_torch.models.fnet import FNet, pad_flow_to
from tecogan_tpu_torch.models.generator import Generator
from tecogan_tpu_torch.models.vgg19 import VGG19Features, vgg19_normalized_features

# The JAX package's names (``tecogan_tpu/models/__init__.py``); pad_flow_to
# is the port's own.
__all__ = [
    "FNet",
    "Generator",
    "Discriminator",
    "VGG19Features",
    "vgg19_normalized_features",
]
