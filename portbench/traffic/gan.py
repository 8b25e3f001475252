"""TecoGAN adversarial training (case 3): the captured ``Trainer.train_step``
with VGG19 and the discriminator Dst, fed by the port's ``BatchLoader``
(native executor) from PNG scenes written at set-up.

Traffic parameters (``"kind": "gan"``): as ``"kind": "train"``'s
(``scenes``, ``scene_frames``, ``height``, ``width``, ``max_speed``,
``sway``, ``cache_batches``, ``trace_items``, ``limits``), whose cell this
one extends: the scenes, the window and the release are its.

Set-up builds one trainer, ``Trainer(config, device, vgg=...)``, and its
state, ``state_from_modules(generator, fnet, discriminator)``, from the
benchmark's weights (``reference/gan.py``'s makers), and drives it through
its first three steps with the loader's first three batches, through the
same ``train_step`` call the window makes; it keeps each step's losses and
gate, the first step's gradient of every leaf of G, FNet and Dst (read
from the Adams' first moments after it: ``(1 - beta1) g``; the gate is
open at the first step, whose EMA is 0), and the parameters and Dst's
running statistics after the third. The window then runs steps until
``--seconds`` have passed, reading the step's metrics to the host every
``display_freq`` steps as ``train()`` does; ``step_ms`` is the window over
its steps, after the device is done. The gate's counter, the state's
``counter_with_d``, is read once before the window and once after it. A
traced run profiles ``trace_items`` steps through
``harness/raw_trace.py:RawTracer``, whose summary is ``trace.Tracer``'s,
read from the profiler's raw events.

The check follows the first three steps in the plain reference
(``reference/gan.py``), which works the loader's batches out again from
its seed and the scenes' frames:

- ``loss_rel``: the largest relative gap of a step's content, warp, VGG,
  ping-pong, adversarial, discriminator or layer-sum loss;
- ``grad_rel``: the first gradient's norm by the worst leaf of G, FNet and
  Dst, over max(its reference norm, the median leaf's);
- ``change_rel``: the parameters' change after three steps, so, over the
  leaves whose reference gradient is at least a thousandth of the median
  leaf's;
- ``grad_diff_med``: the first gradient's difference from the reference's,
  leaf by leaf over the same norm, the median leaf (the number a lower
  precision moves: the others are norms, or Adam's first moves, which
  depend on the gradients' signs);
- ``stats_rel``: Dst's running statistics after three steps, the worst
  tensor's move against the reference's (:func:`reference.gan.stats_gap`);
- ``gate_mismatch``: the steps whose gate decision differs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.harness import program
from portbench.harness.gan_flops import gan_step_flops
from portbench.harness.raw_trace import RawTracer
from portbench.harness.runner import Check
from portbench.harness.seeds import derive
from portbench.reference import gan as RG
from portbench.reference import model as R
from portbench.reference import train as RT
from portbench.reference.compare import worst_leaf_gap
from portbench.traffic import train


def teco_config(config: Dict, **extra):
    """The port's ``TecoConfig`` with every key of the configuration file
    that it has (``program.teco_config`` keeps FRVSR's keys only)."""
    from tecogan_tpu_torch.config import TecoConfig

    fields = {f.name for f in dataclasses.fields(TecoConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in config.items() if k in fields}
    kw.update(extra)
    return TecoConfig(**kw)


class Cell(train.Cell):
    def _modules(self):
        """The port's discriminator and VGG19 holding copies of the weights."""
        from tecogan_tpu_torch.models import Discriminator
        from tecogan_tpu_torch.models.vgg19 import VGG19Features

        out = []
        for module, prefix, weights in ((Discriminator(27), "discriminator.", self.weights),
                                        (VGG19Features(), "vgg.", self.vgg)):
            missing, unexpected = module.to(self.device).load_state_dict(
                {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)},
                strict=False)
            if unexpected or any("running_" not in k for k in missing):
                raise KeyError(f"{prefix}: missing {missing}, unexpected {unexpected}")
            out.append(module)
        return out

    def setup(self) -> None:
        from tecogan_tpu_torch.data.loader import BatchLoader, SceneDataset
        from tecogan_tpu_torch.train.trainer import Trainer

        cfg = self.config
        self._write_scenes()
        tc = teco_config(cfg, input_video_dir=self.root)
        self.weights = R.make_weights(cfg["num_resblock"], derive(self.seed, "weights"),
                                      self.device, cfg["weights"]["resblock_conv2_gain"])
        self.weights.update(RG.make_d_weights(derive(self.seed, "discriminator"), self.device))
        self.vgg = RG.make_vgg19(derive(self.seed, "vgg19"), self.device)
        gen, fnet = program.models(cfg, self.weights)
        disc, vgg = self._modules()
        self.trainer = Trainer(tc, self.device, vgg=vgg)
        self.state = self.trainer.state_from_modules(gen, fnet, disc)
        self.loader = BatchLoader(SceneDataset(tc), seed=self.loader_seed,
                                  executor="native").start()
        self.losses: List[torch.Tensor] = []
        self.gates: List[bool] = []
        for step in range(1, train.SETUP_STEPS + 1):
            self.state, metrics = self.trainer.train_step(self.state, self.loader.next_batch())
            self.losses.append(torch.stack([metrics[k] for k in RG.LOSS_KEYS]).float().cpu())
            self.gates.append(int(self.state.counter_with_d) == sum(self.gates) + 1)
            if step == 1:
                self.grads = self._adam_first_moments(1.0 / (1.0 - cfg["beta1"]))
        self.params = {k: p.detach().clone() for k, p in self._leaves()}
        self.stats = {f"discriminator.{k}": v.detach().clone()
                      for k, v in self.state.discriminator.named_buffers()}
        for _ in range(self.traffic.get("cache_batches", 0)):
            self.loader.next_batch()
        self.gate_before = int(self.state.counter_with_d)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _leaves(self):
        yield from super()._leaves()
        for name, p in self.state.discriminator.named_parameters():
            yield "discriminator." + name, p

    def _adam_first_moments(self, scale: float) -> Dict[str, torch.Tensor]:
        out = super()._adam_first_moments(scale)
        s = self.state
        for (name, _), mu in zip(s.discriminator.named_parameters(), s.d_opt.mu):
            out["discriminator." + name] = mu.detach().float() * scale
        return out

    def window(self, seconds: float, tracer) -> None:
        raw = RawTracer(tracer.enabled)
        super().window(seconds, raw)
        tracer.summary = raw.summary
        # The gate's counter, once, after the device is done.
        self.gate_window = int(self.state.counter_with_d) - self.gate_before

    def counters(self) -> Dict:
        cfg = self.config
        out = super().counters()
        out["model_flops"] = out["steps"] * gan_step_flops(
            cfg["batch_size"], cfg["rnn_n"], cfg["crop_size"], cfg["num_resblock"])
        out["window_steps"] = self.steps
        out["d_updates"] = self.gate_window
        return out

    def readings(self) -> Dict:
        """What set-up read of the program, in the reference's form."""
        return {"losses": torch.stack(self.losses).double().numpy(), "grads": self.grads,
                "params": self.params, "stats": self.stats, "gates": self.gates}

    def reference(self, precision: str = "float32") -> Dict:
        """The reference's readings over the same three batches, its
        convolutions computed in ``precision`` (the control: bfloat16)."""
        hb = RT.batches(self.config, self.scenes, self.loader_seed, train.SETUP_STEPS)
        ref = RG.run_steps(self.weights, self.vgg, hb, self.config, RG.Precision(precision))
        ref["losses"] = np.array(ref["losses"], dtype=np.float64)
        return ref

    def numbers(self, got: Dict, ref: Dict) -> Dict[str, float]:
        """The compared numbers of ``got`` against the reference's ``ref``."""
        g_ref = RT.norms(ref["grads"])
        leaves = sorted(g_ref)
        median = float(np.median([g_ref[k] for k in leaves]))
        g_diff = RT.norms({k: got["grads"][k].to(ref["grads"][k].device) - ref["grads"][k]
                           for k in leaves})
        d_ref = RT.norms(RT.delta(ref["params"], self.weights))
        d_got = RT.norms(RT.delta({k: v.to(self.device) for k, v in got["params"].items()},
                                  self.weights))
        want = ref["losses"]
        return {
            "loss_rel": float(np.max(np.abs(got["losses"] - want) / np.abs(want))),
            "grad_rel": worst_leaf_gap(RT.norms(got["grads"]), g_ref, leaves),
            "change_rel": worst_leaf_gap(d_got, d_ref, RT.moved_leaves(g_ref)),
            "grad_diff_med": float(np.median([g_diff[k] / max(g_ref[k], median)
                                              for k in leaves])),
            "stats_rel": RG.stats_gap(got["stats"], ref["stats"]),
            "gate_mismatch": float(sum(a != b for a, b in zip(got["gates"], ref["gates"]))
                                   + abs(len(got["gates"]) - len(ref["gates"]))),
        }

    def check(self, got: Optional[Dict] = None) -> List[Check]:
        nums = self.numbers(self.readings() if got is None else got, self.reference())
        return [Check(k, v, self.traffic["limits"][k]) for k, v in nums.items()]
