"""Parallelism across GPUs (counterpart of ``tecogan_tpu/parallel``; the
reference is single-GPU).

- **data parallel** training (``dp.py``): one process per GPU over a
  ``torch.distributed`` process group, the global batch split over the
  ranks, gradients, the discriminator's batch statistics and the metrics
  averaged over them, so a step equals one step on the global batch;
- **spatial sharding** of streaming inference (``spatial.py``): frame rows
  split over a mesh axis, every layer behind a halo exchange written per
  layer, the kernels run on every shard;
- **pipeline parallel** streaming (``pipeline.py``): the flow stage (FNet
  + the flow upsample) on one device and stream, the recurrent warp +
  generator on another;
- meshes and shardings (``mesh.py``); a slot pool across devices is
  ``serve/engine.py``'s ``mesh=``.
"""

from tecogan_tpu_torch.parallel.mesh import (
    init_distributed,
    make_mesh,
    batch_sharding,
    replicated,
    shard_batch,
)
from tecogan_tpu_torch.parallel.dp import DataParallelTrainer
from tecogan_tpu_torch.parallel.pipeline import PipelinedStreamingSR
from tecogan_tpu_torch.parallel.spatial import spatial_streaming_fn

__all__ = [
    "init_distributed",
    "make_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "DataParallelTrainer",
    "PipelinedStreamingSR",
    "spatial_streaming_fn",
]
