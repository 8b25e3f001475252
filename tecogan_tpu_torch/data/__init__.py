"""Data of the port: the PNG codec, synthetic and procedural scenes, the
scene loader, the inference CLI's frame I/O and the dataset preparation
(``data.prepare``). Imports no JAX and no OpenCV."""

from tecogan_tpu_torch.data.inference import load_inference_frames
from tecogan_tpu_torch.data.loader import BatchLoader, SceneDataset
from tecogan_tpu_torch.data.synthetic import synthetic_clip, write_synthetic_scenes

__all__ = [
    "SceneDataset",
    "BatchLoader",
    "load_inference_frames",
    "synthetic_clip",
    "write_synthetic_scenes",
]
