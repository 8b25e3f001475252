"""FRVSR training: the captured ``Trainer.train_step`` fed by the port's
``BatchLoader`` (native executor) from PNG scenes written at set-up.

Traffic parameters (``"kind": "train"``): ``scenes``, ``scene_frames``,
``height``, ``width`` (the scenes written into ``$TMPDIR`` from the seed,
as ``scene_%04d/col_high_%04d.png`` from ``str_dir`` on), ``max_speed`` /
``sway`` (their motion), ``cache_batches`` (optional: batches set-up
draws from the loader after its first three steps, so that every decoded
frame sits in the loader's frame cache before the window, as it does for
a trainer past its first epoch whose scenes fit the cache),
``trace_items`` (steps the traced run profiles) and ``limits``.

Set-up builds one trainer and state from the benchmark's weights and
drives it through its first three steps with the loader's first three
batches, through the same ``train_step`` call the window makes; it keeps
each step's losses, the first step's gradient (read from Adam's first
moment after it: ``(1 - beta1) g``) and the parameters after the third.
The window then runs steps until ``--seconds`` have passed, reading the
step's metrics to the host every ``display_freq`` steps as ``train()``
does; ``step_ms`` is the window over its steps, after the device is done.

The check follows the first three steps in the plain reference, which
works the loader's batches out again from its seed and the scenes' frames:
the largest relative gap of a step's content or warp loss; of the first
gradient's norm, by the worst leaf; and of the parameters' change after
three steps, by the worst leaf whose reference gradient is not nought to
rounding (at least a thousandth of the median leaf's); and the first
gradient's difference from the reference's, leaf by leaf over the same
norm, the median leaf (the number the bfloat16 control fails: norms and
losses move only to second order under rounding, or average it out, and
FNet's leaves swing with the warp's floor flips).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import frames as FR
from portbench.harness import png, program
from portbench.harness.flops import train_step_flops
from portbench.harness.runner import Check
from portbench.harness.seeds import derive
from portbench.harness.trace import span
from portbench.reference import model as R
from portbench.reference import train as RT
from portbench.reference.compare import worst_leaf_gap

SETUP_STEPS = 3


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device: torch.device,
                 chips: int):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.loader_seed = derive(seed, "loader")
        self.end_to_end: Dict[str, float] = {}
        self.attempted = self.failed = 0
        self.root = None
        self.loader = None

    def _write_scenes(self) -> None:
        t, cfg = self.traffic, self.config
        self.root = tempfile.mkdtemp(prefix="portbench_scenes_", dir=os.environ.get("TMPDIR"))
        g = torch.Generator(self.device).manual_seed(derive(self.seed, "scenes"))
        self.scenes: List[np.ndarray] = []
        items = []
        for i in range(t["scenes"]):
            clip = FR.make_clip(g, t["scene_frames"], t["height"], t["width"], self.device,
                                t["max_speed"], t["sway"]).cpu().numpy()
            self.scenes.append(clip)
            d = os.path.join(self.root, f"scene_{cfg['str_dir'] + i:04d}")
            os.makedirs(d)
            items += [(os.path.join(d, f"col_high_{f:04d}.png"), clip[f])
                      for f in range(len(clip))]
        png.write_all(items)

    def setup(self) -> None:
        from tecogan_tpu_torch.data.loader import BatchLoader, SceneDataset
        from tecogan_tpu_torch.train.trainer import Trainer

        cfg = self.config
        self._write_scenes()
        tc = program.teco_config(cfg, input_video_dir=self.root)
        self.weights = R.make_weights(cfg["num_resblock"], derive(self.seed, "weights"),
                                      self.device, cfg["weights"]["resblock_conv2_gain"])
        gen, fnet = program.models(cfg, self.weights)
        self.trainer = Trainer(tc, self.device)
        self.state = self.trainer.state_from_modules(gen, fnet)
        self.loader = BatchLoader(SceneDataset(tc), seed=self.loader_seed,
                                  executor="native").start()
        self.losses: List[torch.Tensor] = []
        for step in range(1, SETUP_STEPS + 1):
            self.state, metrics = self.trainer.train_step(self.state, self.loader.next_batch())
            self.losses.append(torch.stack([metrics["l2_content_loss"],
                                            metrics["l2_warp_loss"]]).float().cpu())
            if step == 1:
                self.grads = self._adam_first_moments(1.0 / (1.0 - cfg["beta1"]))
        self.params = {k: p.detach().clone() for k, p in self._leaves()}
        for _ in range(self.traffic.get("cache_batches", 0)):
            self.loader.next_batch()
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _leaves(self):
        for prefix, module in (("generator.", self.state.generator), ("fnet.", self.state.fnet)):
            for name, p in module.named_parameters():
                yield prefix + name, p

    def _adam_first_moments(self, scale: float) -> Dict[str, torch.Tensor]:
        out = {}
        for opt, prefix, module in ((self.state.gen_opt, "generator.", self.state.generator),
                                    (self.state.fnet_opt, "fnet.", self.state.fnet)):
            for name, p in module.named_parameters():
                out[prefix + name] = opt.state[p]["exp_avg"].detach().float() * scale
        return out

    def window(self, seconds: float, tracer) -> None:
        cfg = self.config
        steps = 0
        self.waits: List[float] = []
        total = []
        t0 = time.perf_counter()
        tracer.start()
        while True:
            tw = time.perf_counter()
            with span("loader_wait"):
                batch = self.loader.next_batch()
            self.waits.append(time.perf_counter() - tw)
            with span("train_step"):
                self.state, metrics = self.trainer.train_step(self.state, batch)
            total.append(metrics["All_loss_Gen"])
            steps += 1
            if self.state.step % cfg["display_freq"] == 0:
                float(metrics["All_loss_Gen"])  # the display's read, as train() makes it
            if steps == self.traffic["trace_items"]:
                tracer.stop()
            if time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        tracer.stop()
        self.steps = steps
        self.attempted = steps
        self.failed = int((~torch.isfinite(torch.stack(total))).sum())
        self.end_to_end = {"step_ms": elapsed / steps * 1e3}

    def counters(self) -> Dict:
        cfg = self.config
        traced = min(self.steps, self.traffic["trace_items"])
        return {
            "capture_s": self.trainer.capture_s,
            "loader_wait_ms": float(np.mean(self.waits[:traced])) * 1e3,
            "steps": traced,
            "model_flops": traced * train_step_flops(cfg["batch_size"], cfg["rnn_n"],
                                                     cfg["crop_size"], cfg["num_resblock"]),
            "compute_dtype": cfg["compute_dtype"],
            "chain_shape": (cfg["batch_size"], cfg["crop_size"], cfg["crop_size"]),
            "chain_itemsize": 2 if cfg["compute_dtype"] == "bfloat16" else 4,
        }

    def release(self) -> None:
        if self.loader is not None:
            self.loader.stop()
            self.loader = None
        self.trainer = self.state = None
        if self.root is not None:
            shutil.rmtree(self.root, ignore_errors=True)
            self.root = None

    def numbers(self, ref: Dict) -> Dict[str, float]:
        """The compared numbers of the program's readings against the
        reference's."""
        got = torch.stack(self.losses).double().numpy()
        want = np.array(ref["losses"], dtype=np.float64)
        g_ref = RT.norms(ref["grads"])
        leaves = sorted(g_ref)
        median = float(np.median([g_ref[k] for k in leaves]))
        g_diff = RT.norms({k: self.grads[k] - ref["grads"][k] for k in leaves})
        d_ref = RT.norms(RT.delta(ref["params"], self.weights))
        d_got = RT.norms(RT.delta(self.params, self.weights))
        return {
            "loss_rel": float(np.max(np.abs(got - want) / np.abs(want))),
            "grad_rel": worst_leaf_gap(RT.norms(self.grads), g_ref, leaves),
            "change_rel": worst_leaf_gap(d_got, d_ref, RT.moved_leaves(g_ref)),
            "grad_diff_med": float(np.median([g_diff[k] / max(g_ref[k], median)
                                              for k in leaves])),
        }

    def reference(self) -> Dict:
        hb = RT.batches(self.config, self.scenes, self.loader_seed, SETUP_STEPS)
        return RT.run_steps(self.weights, hb, self.config)

    def check(self) -> List[Check]:
        nums = self.numbers(self.reference())
        return [Check(k, v, self.traffic["limits"][k]) for k, v in nums.items()]
