"""The system under test, built from a configuration file and the
benchmark's weights: the port's ``TecoConfig``, ``Generator`` and
``FNet`` with the weights copied in. Nothing else of the port is
imported here."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

CONFIG_KEYS = ("num_resblock", "gen_channels", "fnet_channels", "fnet_up_channels",
               "flow_max_velocity", "compute_dtype", "batch_size", "crop_size", "rnn_n",
               "pingpong", "learning_rate", "decay_step", "decay_rate", "stair", "beta1",
               "adam_eps", "max_iter", "ratio", "vgg_scaling", "warp_scaling", "str_dir",
               "end_dir", "end_dir_val", "max_frm", "queue_thread", "prefetch_depth",
               "display_freq", "summary_freq", "save_freq", "moving_first_frame",
               "moving_first_frame_prob", "flip", "random_crop", "gaussian_sigma",
               "loader_cache_mb", "train_upload_uint8", "remat_generator")


def teco_config(config: Dict, **extra):
    """The port's ``TecoConfig`` with the configuration file's keys."""
    from tecogan_tpu_torch.config import TecoConfig

    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in config.items()
          if k in CONFIG_KEYS}
    kw.update(extra)
    return TecoConfig(**kw)


def models(config: Dict, weights: Dict[str, torch.Tensor]) -> Tuple:
    """The port's generator and FNet holding copies of ``weights``."""
    from tecogan_tpu_torch.models import FNet, Generator

    gen = Generator(config["num_resblock"], config["gen_channels"])
    fnet = FNet(tuple(config["fnet_channels"]), tuple(config["fnet_up_channels"]),
                config["flow_max_velocity"])
    device = next(iter(weights.values())).device
    gen, fnet = gen.to(device), fnet.to(device)
    for prefix, module in (("generator.", gen), ("fnet.", fnet)):
        module.load_state_dict({k[len(prefix):]: v for k, v in weights.items()
                                if k.startswith(prefix)})
    return gen, fnet
