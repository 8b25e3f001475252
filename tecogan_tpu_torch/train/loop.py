"""The training loop (counterpart of ``tecogan_tpu/train/loop.py``;
reference main.py:273-430).

In reference order:

- config dump into the output and summary dirs (main.py:274-277);
- restore: full resume from this run's checkpoints, else a warm start of
  the weights from ``pre_trained_dir`` (main.py:312-324,345-352); either
  may be the port's or the JAX package's orbax checkpoints (a JAX run
  resumed here goes on saving the port's ``state.pt`` beside its steps);
- the step loop with display / summary / save frequencies
  (main.py:377-421), printing ``image/sec*frames`` like the reference
  (main.py:404-411); validation losses every ``summary_freq`` on the
  held-out scene split (main.py:394-402); in TecoGAN mode also the gate's
  ``t_balance_EMA``, ``withD_counter`` and ``w_o_D_counter`` scalars
  (reference Teco.py:451-452,495-496);
- after each save, the animated sequence summaries of the batch just
  stepped (reference gif_summary of LR/HR/Generated/WarpPreGen,
  Teco.py:498-503): ``Trainer.generate`` (a captured program on the card)
  and one GIF per tag with its first frame as a TensorBoard image; the
  scalars go to the TensorBoard event file and ``scalars.jsonl``;
- after each save, test-while-train: a detached inference run of the
  port's CLI on the fresh checkpoint (main.py:151-174), over the first 10
  frames of ``<input_video_dir>/../LR/calendar`` when that folder exists;
- Ctrl-C saves a final checkpoint (main.py:423-429); so does SIGTERM
  (preemption), after the step in flight.

Where the JAX loop lets any exception of the summaries pass with a print,
here only a failed write of their files (``OSError``) does: a capture,
replay or kernel launch that fails inside ``generate`` raises.

Training runs on the one device it is given, with no fallback; on the card
each step and each validation runs as a captured CUDA graph by default
(``Trainer``'s ``capture``), and the loop reads device values on the host
only at ``display_freq`` and ``summary_freq``.

Data parallelism (:func:`build_trainer`): in a process group of world size
> 1 (``torchrun --nproc_per_node N -m tecogan_tpu_torch.cli.main --mode
train ...``, one process per GPU) each rank trains a
``DataParallelTrainer`` on its piece of the global ``batch_size``, its
loaders reading the disjoint stride ``shard_id=rank, num_shards=world_size``
of the example index space. The JAX loop instead runs one process over
every local device of a mesh (a deviation of the port). The state is the
same on every rank, so rank 0 alone writes the config dumps, checkpoints,
summaries and GIFs and starts test-while-train, where every JAX process
takes part in its collective orbax save; every rank runs the validation
step, which averages over the group. The train and validation
loaders run the native C++ executor where it builds (``executor="auto"``,
as the JAX loop's), else the python one.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Optional, Union

import torch
import torch.distributed as dist
import torch.nn as nn

from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.data.loader import BatchLoader, SceneDataset
from tecogan_tpu_torch.train.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    warm_start,
)
from tecogan_tpu_torch.train.trainer import Trainer, TrainState
from tecogan_tpu_torch.utils.logging import param_summary
from tecogan_tpu_torch.utils.summaries import SummaryLogger


# Live test-while-train children, reaped on each new spawn and at train()'s
# end so long runs do not accumulate zombies.
_twt_procs: list = []
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _reap_test_while_train(final: bool = False) -> None:
    for proc, log_path in list(_twt_procs):
        rc = proc.poll()
        if rc is None:
            if final:  # exiting: orphans reparent to init, which reaps them
                print(f"test-while-train child pid={proc.pid} still running; "
                      f"log: {log_path}")
                _twt_procs.remove((proc, log_path))
            continue
        _twt_procs.remove((proc, log_path))
        if rc != 0:  # their output is in the log
            print(f"test-while-train child exited rc={rc}; log: {log_path}")


def _spawn_test_while_train(config: TecoConfig, output_dir: str, ckpt_dir: str,
                            device: torch.device) -> Optional[subprocess.Popen]:
    """Start a detached ``cli.main --mode inference`` on the newest
    checkpoint, on the training device, writing ``train_out_*.png`` and its
    log to ``<output_dir>/train`` (reference testWhileTrain main.py:151-174);
    None when there is no ``LR/calendar`` folder beside the scenes."""
    _reap_test_while_train()
    test_dir = config.input_video_dir and os.path.join(
        os.path.dirname(config.input_video_dir), "LR", "calendar")
    if not test_dir or not os.path.isdir(test_dir):
        return None
    twt_dir = os.path.join(output_dir, "train")
    os.makedirs(twt_dir, exist_ok=True)
    cmd = [sys.executable, "-m", "tecogan_tpu_torch.cli.main",
           "--mode", "inference", "--input_dir_LR", test_dir,
           "--output_dir", twt_dir, "--checkpoint", ckpt_dir,
           "--device", str(device), "--max_frames", "10",
           "--output_name", "train_out"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
    log_path = os.path.join(twt_dir, "test_while_train.log")
    with open(log_path, "ab") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                env=env, start_new_session=True)
    _twt_procs.append((proc, log_path))
    return proc


class _PreemptionGuard:
    """Sets a flag on SIGTERM, so the loop finishes the step in flight,
    saves and returns. No-op outside the main thread."""

    def __init__(self):
        self.fired = False
        self._prev = None
        self._installed = False

    def __enter__(self):
        def handler(signum, frame):
            self.fired = True
            print("SIGTERM: finishing current step, saving final checkpoint")

        try:
            self._prev = signal.signal(signal.SIGTERM, handler)
            self._installed = True
        except ValueError:  # not the main thread
            pass
        return self

    def __exit__(self, *exc):
        if self._installed:
            signal.signal(signal.SIGTERM,
                          self._prev if self._prev is not None else signal.SIG_DFL)
        return False


SUMMARY_TAGS = ("InputLR", "TargetHR", "GeneratedHR", "WarpPreGen")  # reference Teco.py:498-503


def _write_sequence_summaries(trainer: Trainer, state: TrainState, batch,
                              logger: SummaryLogger, step: int) -> None:
    """One GIF per tag of ``Trainer.generate`` on ``batch`` (its first
    sequence). The device's work raises; a failed file write is printed."""
    sequences = [seq[:1].float().cpu().numpy() for seq in trainer.generate(state, batch)]
    try:
        for tag, seq in zip(SUMMARY_TAGS, sequences):
            logger.gif(step, tag, seq, max_outputs=1)
    except OSError as e:  # summaries must never kill training
        print(f"gif summary failed: {e}")


def _save_once(ckpt_dir: str, state: TrainState) -> None:
    """Save unless this step is on disk already (a save_freq save, or a
    resume with no step since)."""
    if latest_step(ckpt_dir) != state.step:
        save_checkpoint(ckpt_dir, state)


def build_trainer(config: TecoConfig, device: Union[str, torch.device],
                  vgg: Optional[nn.Module] = None, capture: Optional[bool] = None,
                  use_mesh: bool = True) -> Trainer:
    """A ``Trainer`` on ``device``, or, with ``use_mesh`` in a process group
    of world size > 1, a ``DataParallelTrainer`` over it (the JAX package's
    ``build_trainer`` takes every local device of one process)."""
    if use_mesh and dist.is_initialized() and dist.get_world_size() > 1:
        from tecogan_tpu_torch.parallel import DataParallelTrainer

        return DataParallelTrainer(config, device, vgg=vgg, capture=capture)
    return Trainer(config, device, vgg=vgg, capture=capture)


def train(config: TecoConfig, output_dir: str, device: Union[str, torch.device],
          summary_dir: Optional[str] = None,
          vgg: Optional[nn.Module] = None,
          pre_trained_dir: Optional[str] = None,
          max_steps: Optional[int] = None,
          test_while_train: bool = True,
          capture: Optional[bool] = None,
          use_mesh: bool = True) -> TrainState:
    """Train on ``device`` to ``config.max_iter`` (or ``max_steps``) steps;
    returns the final state. ``vgg``: VGG19 weights for ``vgg_scaling >
    0``. ``pre_trained_dir``: a run's checkpoint dir (the port's or the
    JAX package's) or a TF npz to warm-start from. Checkpoints go to ``<output_dir>/checkpoints``, scalars
    to ``<summary_dir>/scalars.jsonl`` and its TensorBoard event file, the
    sequence GIFs to ``<summary_dir>`` (default ``<output_dir>/log``).
    ``capture``: as :class:`Trainer`'s (None captures on the card).
    ``use_mesh``: data parallelism over the process group, if one of world
    size > 1 is up (:func:`build_trainer`)."""
    trainer = build_trainer(config, device, vgg=vgg, capture=capture, use_mesh=use_mesh)
    rank, world = getattr(trainer, "rank", 0), getattr(trainer, "world_size", 1)
    writes = rank == 0  # the state is the same on every rank
    summary_dir = summary_dir or os.path.join(output_dir, "log")
    ckpt_dir = os.path.join(output_dir, "checkpoints")
    if writes:
        os.makedirs(output_dir, exist_ok=True)
        os.makedirs(summary_dir, exist_ok=True)
        for d in (summary_dir, output_dir):
            with open(os.path.join(d, "config.json"), "w") as f:
                f.write(config.to_json())

    state = trainer.init_state(config.rand_seed)
    print(f"Training {'TecoGAN' if config.gan else 'FRVSR'} on {trainer.device}: compute "
          f"dtype {config.compute_dtype}, float32 master weights, "
          f"{'captured CUDA graphs' if trainer.capture else 'eager steps'}")
    param_summary("generator", state.generator)
    param_summary("fnet", state.fnet)
    if config.gan:
        param_summary("tdiscriminator", state.discriminator)

    # Full resume beats warm start (reference main.py:345-352); both load in
    # place, before the first step captures.
    resumed = latest_step(ckpt_dir)
    if resumed is not None:
        state = restore_checkpoint(ckpt_dir, state)
        print(f"Resumed from step {resumed}")
    elif pre_trained_dir:
        state = warm_start(state, pre_trained_dir)
        print(f"Warm-started weights from {pre_trained_dir}")
    if world > 1:
        state = trainer.broadcast_state(state)
        print(f"Data parallel: rank {rank} of {world}, {config.batch_size // world} of "
              f"the global batch of {config.batch_size} a rank")

    # Each rank loads its piece of the global batch from a disjoint stride
    # of the example index space (the JAX loop's per-host sharding).
    shard_kw = dict(batch_size=config.batch_size // world, shard_id=rank, num_shards=world)
    dataset = SceneDataset(config, validation=False)
    loader = BatchLoader(dataset, executor="auto", **shard_kw)
    try:
        val_loader = BatchLoader(SceneDataset(config, validation=True),
                                 seed=config.rand_seed + 1, executor="auto", **shard_kw)
    except FileNotFoundError:
        val_loader = None
    print(f"Dataset: {len(dataset.scenes)} scenes, {len(dataset)} windows, "
          f"steps/epoch {len(dataset) // config.batch_size}")

    logger = SummaryLogger(summary_dir) if writes else None
    total = max_steps if max_steps is not None else config.max_iter
    t_window, frames_window = time.perf_counter(), 0
    try:
        with _PreemptionGuard() as preempt, loader:
            for _ in range(state.step, total):
                if preempt.fired:
                    if writes:
                        _save_once(ckpt_dir, state)
                        print(f"Preempted: saved final checkpoint at step {state.step}")
                    break
                batch = loader.next_batch()
                state, metrics = trainer.train_step(state, batch)
                frames_window += config.batch_size * config.unroll_frames
                step = state.step
                if step % config.display_freq == 0:
                    m = {k: float(v) for k, v in metrics.items()}  # syncs
                    dt = time.perf_counter() - t_window
                    ips = frames_window / dt if dt > 0 else 0.0
                    t_window, frames_window = time.perf_counter(), 0
                    msg = ", ".join(f"{k} {v:.4f}" for k, v in sorted(m.items()))
                    print(f"step {step}: image/sec*frames {ips:.1f} | {msg}")
                if step % config.summary_freq == 0:
                    # Every rank validates: the step averages over the group.
                    val = (trainer.eval_step(state, val_loader.next_batch())
                           if val_loader is not None else None)
                    if writes:
                        logger.scalars(step, state.ema_losses)
                        logger.scalars(step, {"learning_rate": metrics["learning_rate"]})
                        if config.gan:
                            logger.scalars(step, {"t_balance_EMA": state.ema_tbalance,
                                                  "withD_counter": state.counter_with_d,
                                                  "w_o_D_counter": state.counter_wo_d})
                        if val is not None:
                            logger.scalars(step, val, prefix="val_")
                if writes and (step % config.save_freq == 0 or step == total):
                    save_checkpoint(ckpt_dir, state)
                    print(f"Saved checkpoint at step {step}")
                    _write_sequence_summaries(trainer, state, batch, logger, step)
                    if test_while_train:
                        _spawn_test_while_train(config, output_dir, ckpt_dir,
                                                trainer.device)
    except KeyboardInterrupt:
        if writes:
            _save_once(ckpt_dir, state)
            print(f"KeyboardInterrupt: saved final checkpoint at step {state.step}")
    finally:
        if val_loader is not None:
            val_loader.stop()
        if logger is not None:
            logger.close()
        _reap_test_while_train(final=True)
    return state
