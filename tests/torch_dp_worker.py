"""One rank of the port's two-process data-parallel test
(tests/test_torch_parallel.py; the port's counterpart of tests/mp_worker.py).

    python tests/torch_dp_worker.py PORT RANK WORLD PRESETS DEVICE \
        [--backend gloo] [--init PARAMS_NPZ]

Joins the group at ``localhost:PORT`` and, for each of the comma-separated
PRESETS (``frvsr``, ``tecogan``; :func:`config`), builds a
``DataParallelTrainer`` on DEVICE, takes two eager steps on this rank's
piece of the global batches (:func:`global_batch`) and prints one JSON
line: each step's metrics, the discriminator's running statistics after
the first step and the L2 norm of each network's gradient after it; FRVSR
starts from ``--init``'s weights where given. This file imports no JAX.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 2


def config(preset: str):
    """The parity configurations: FRVSR, and TecoGAN with VGG and the
    ping-pong extension but its L1 term's weight 0 (tests/test_torch_gan.py
    STEP, whose reasons hold here too: the L1 kinks flip gradients under
    float32 summation-order noise)."""
    from tecogan_tpu_torch.config import TecoConfig

    base = dict(num_resblock=2, crop_size=8, batch_size=2, rnn_n=4, learning_rate=1e-3,
                adam_eps=1e-12, remat_generator=False, vgg_scaling=-0.002)
    if preset == "tecogan":
        base.update(ratio=0.01, pingpong=True, pp_scaling=0.0, d_layerloss=True,
                    vgg_scaling=0.2)
    else:
        base.update(ratio=-0.01)
    return TecoConfig(**base)


def global_batch(cfg, step: int) -> np.ndarray:
    tar = cfg.hr_load_size
    return np.random.RandomState(100 + step).rand(
        cfg.batch_size, cfg.rnn_n, tar, tar, 3).astype(np.float32)


def vgg_for(cfg):
    if cfg.vgg_scaling <= 0:
        return None
    from tecogan_tpu_torch.models.vgg19 import random_vgg19

    return random_vgg19(seed=3)


def record(trainer, state, steps=STEPS, batch_of=None):
    """Run ``steps`` steps; the metrics of each, D's running statistics and
    the gradient norms after the first."""
    out = {"metrics": [], "d_stats": None, "grad_norms": None}
    for step in range(steps):
        batch = global_batch(trainer.config, step)
        state, metrics = trainer.train_step(state, batch_of(batch) if batch_of else batch)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        if step == 0:
            norms = {}
            for name in ("generator", "fnet", "discriminator"):
                module = getattr(state, name)
                if module is not None:
                    norms[name] = float(torch.sqrt(sum(
                        (p.grad.double() ** 2).sum() for p in module.parameters()
                        if p.grad is not None)))
            out["grad_norms"] = norms
            if state.discriminator is not None:
                out["d_stats"] = [float(x) for name, b in state.discriminator.named_buffers()
                                  for x in b.reshape(-1).tolist()]
    return out


def main() -> None:
    import argparse

    p = argparse.ArgumentParser()
    for name in ("port", "rank", "world", "presets", "device"):
        p.add_argument(name)
    p.add_argument("--backend", default="gloo")
    p.add_argument("--init", default=None,
                   help="params npz (weights.read_params_npz) of the FRVSR preset's G and FNet")
    args = p.parse_args()
    torch.set_num_threads(1)
    from tecogan_tpu_torch.parallel import DataParallelTrainer, init_distributed

    address, world = f"localhost:{args.port}", int(args.world)
    count = init_distributed(address, world, int(args.rank), backend=args.backend)
    assert count == world, count
    assert init_distributed(address, world, int(args.rank)) == count  # joined once
    for preset in args.presets.split(","):
        cfg = config(preset)
        trainer = DataParallelTrainer(cfg, args.device, vgg=vgg_for(cfg), capture=False)
        if preset == "frvsr" and args.init:
            from tecogan_tpu_torch.weights import from_jax_params, read_params_npz

            trees = read_params_npz(args.init)
            state = trainer.state_from_modules(*from_jax_params(trees["generator"],
                                                                trees["fnet"]))
        else:
            state = trainer.init_state(0)
        out = record(trainer, trainer.broadcast_state(state), batch_of=trainer.put_batch)
        print(f"RESULT {preset} " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
