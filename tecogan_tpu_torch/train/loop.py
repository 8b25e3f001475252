"""The training loop (counterpart of ``tecogan_tpu/train/loop.py``;
reference main.py:273-430).

In reference order:

- config dump into the output and summary dirs (main.py:274-277);
- restore: full resume from this run's checkpoints, else a warm start of
  the weights from ``pre_trained_dir`` (main.py:312-324,345-352);
- the step loop with display / summary / save frequencies
  (main.py:377-421), printing ``image/sec*frames`` like the reference
  (main.py:404-411); validation losses every ``summary_freq`` on the
  held-out scene split (main.py:394-402); in TecoGAN mode also the gate's
  ``t_balance_EMA``, ``withD_counter`` and ``w_o_D_counter`` scalars
  (reference Teco.py:451-452,495-496);
- after each save, test-while-train: a detached inference run of the
  port's CLI on the fresh checkpoint (main.py:151-174), over the first 10
  frames of ``<input_video_dir>/../LR/calendar`` when that folder exists;
- Ctrl-C saves a final checkpoint (main.py:423-429); so does SIGTERM
  (preemption), after the step in flight.

Not ported yet: the GIF sequence summaries (PIL, ROADMAP queue 1 item 10).
Training runs on the one device it is given, with no fallback; on the card
each step and each validation runs as a captured CUDA graph by default
(``Trainer``'s ``capture``), and the loop reads device values on the host
only at ``display_freq`` and ``summary_freq``. The train and validation
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


def _save_once(ckpt_dir: str, state: TrainState) -> None:
    """Save unless this step is on disk already (a save_freq save, or a
    resume with no step since)."""
    if latest_step(ckpt_dir) != state.step:
        save_checkpoint(ckpt_dir, state)


def train(config: TecoConfig, output_dir: str, device: Union[str, torch.device],
          summary_dir: Optional[str] = None,
          vgg: Optional[nn.Module] = None,
          pre_trained_dir: Optional[str] = None,
          max_steps: Optional[int] = None,
          test_while_train: bool = True,
          capture: Optional[bool] = None) -> TrainState:
    """Train on ``device`` to ``config.max_iter`` (or ``max_steps``) steps;
    returns the final state. ``vgg``: VGG19 weights for ``vgg_scaling >
    0``. ``pre_trained_dir``: a run's checkpoint dir or a TF npz to
    warm-start from. Checkpoints go to ``<output_dir>/checkpoints``, scalars
    to ``<summary_dir>/scalars.jsonl`` (default ``<output_dir>/log``).
    ``capture``: as :class:`Trainer`'s (None captures on the card)."""
    trainer = Trainer(config, device, vgg=vgg, capture=capture)
    summary_dir = summary_dir or os.path.join(output_dir, "log")
    ckpt_dir = os.path.join(output_dir, "checkpoints")
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

    dataset = SceneDataset(config, validation=False)
    loader = BatchLoader(dataset, executor="auto")
    try:
        val_loader = BatchLoader(SceneDataset(config, validation=True),
                                 seed=config.rand_seed + 1, executor="auto")
    except FileNotFoundError:
        val_loader = None
    print(f"Dataset: {len(dataset.scenes)} scenes, {len(dataset)} windows, "
          f"steps/epoch {len(dataset) // config.batch_size}")

    logger = SummaryLogger(summary_dir)
    total = max_steps if max_steps is not None else config.max_iter
    t_window, frames_window = time.perf_counter(), 0
    try:
        with _PreemptionGuard() as preempt, loader:
            for _ in range(state.step, total):
                if preempt.fired:
                    _save_once(ckpt_dir, state)
                    print(f"Preempted: saved final checkpoint at step {state.step}")
                    break
                state, metrics = trainer.train_step(state, loader.next_batch())
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
                    logger.scalars(step, state.ema_losses)
                    logger.scalars(step, {"learning_rate": metrics["learning_rate"]})
                    if config.gan:
                        logger.scalars(step, {"t_balance_EMA": state.ema_tbalance,
                                              "withD_counter": state.counter_with_d,
                                              "w_o_D_counter": state.counter_wo_d})
                    if val_loader is not None:
                        logger.scalars(step, trainer.eval_step(state, val_loader.next_batch()),
                                       prefix="val_")
                if step % config.save_freq == 0 or step == total:
                    save_checkpoint(ckpt_dir, state)
                    print(f"Saved checkpoint at step {step}")
                    if test_while_train:
                        _spawn_test_while_train(config, output_dir, ckpt_dir,
                                                trainer.device)
    except KeyboardInterrupt:
        _save_once(ckpt_dir, state)
        print(f"KeyboardInterrupt: saved final checkpoint at step {state.step}")
    finally:
        if val_loader is not None:
            val_loader.stop()
        logger.close()
        _reap_test_while_train(final=True)
    return state
