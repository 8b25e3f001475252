"""The port's eager TecoGAN step (``Trainer.train_step`` on the CPU, case 3's
settings: ping-pong, VGG19, the merged Dst with its layer losses and gated
Adam) against the benchmark's plain reference, ``portbench/reference/gan.py``
(plain float32 PyTorch that imports nothing of the port), on seeded random
weights at a small size: batch 2, 4 frames with ping-pong (7), LR crop 8,
2 residual blocks, VGG19 and Dst at their real widths. Three steps from the
same weights and the same batches (the loader's draw worked out by the
reference from a synthetic scene), with the gate held open and closed (an
EMA of ``t_balance`` below and above ``d_balance``): every reported loss,
the first gradient of every leaf of G, FNet and Dst, the parameters after
three steps, Dst's running statistics, the gate's decisions and counters.
This file imports no JAX.

Tolerances (float32 on both sides; the two sum in other orders):

- losses: 1e-5 relative; the rounding of float32 sums over some 1e5
  terms, with room;
- gradients: 1e-4 of max(the leaf's norm, the median leaf's), the norm of
  the difference; a warp's floor or an L1 sign that flips on a last-bit
  difference moves single entries, which the median leaf's norm absorbs;
- parameters: each leaf's change over three Adam steps within 5e-3 of the
  reference's change (norms of the difference and of the change; the
  widest leaf reads 1.2e-3); Adam's first moves are about ``lr * sign(g)``,
  so an entry whose gradient is near nought can move the other way, and a
  leaf's change is compared whole;
- running statistics: 1e-5 of their move from TF-slim's initial values.
"""

import dataclasses

import numpy as np
import pytest
import torch

from portbench.harness import frames as FR
from portbench.harness import program
from portbench.reference import gan as RG
from portbench.reference import model as R
from portbench.reference import train as RT
from tecogan_tpu_torch.config import TECOGAN_PRESET
from tecogan_tpu_torch.models import Discriminator
from tecogan_tpu_torch.models.vgg19 import VGG19Features
from tecogan_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

CONFIG = TECOGAN_PRESET.replace(batch_size=2, rnn_n=4, crop_size=8, num_resblock=2,
                                max_frm=15)
STEPS = 3
LOSS_RTOL, GRAD_TOL, CHANGE_TOL, STATS_TOL = 1e-5, 1e-4, 5e-3, 1e-5
GATES = {"open": -100.0, "closed": 100.0}  # the EMA of t_balance before the first step


def _cfg():
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in dataclasses.asdict(CONFIG).items()}


def _load(module, weights, prefix):
    missing, unexpected = module.load_state_dict(
        {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)}, strict=False)
    assert not unexpected and all("running_" in k for k in missing)
    return module


def _port(weights, vgg, batches, ema):
    """Three eager steps of the port: its readings in the reference's form."""
    gen, fnet = program.models(_cfg(), weights)
    trainer = Trainer(CONFIG, "cpu", vgg=_load(VGG19Features(), vgg, "vgg."))
    state = trainer.state_from_modules(gen, fnet,
                                       _load(Discriminator(27), weights, "discriminator."))
    state.ema_tbalance.fill_(ema)
    modules = (("generator.", state.generator), ("fnet.", state.fnet),
               ("discriminator.", state.discriminator))
    out = {"losses": [], "gates": [], "grads": None}
    for step, batch in enumerate(batches):
        opened = int(state.counter_with_d)
        state, metrics = trainer.train_step(state, batch)
        out["losses"].append([float(metrics[k]) for k in RG.LOSS_KEYS])
        out["gates"].append(int(state.counter_with_d) == opened + 1)
        if step == 0:  # the gradients stay in .grad until the next step
            out["grads"] = {p + n: t.grad.detach().clone() for p, m in modules
                            for n, t in m.named_parameters()}
    out["params"] = {p + n: t.detach().clone() for p, m in modules
                     for n, t in m.named_parameters()}
    out["stats"] = {"discriminator." + n: b.clone()
                    for n, b in state.discriminator.named_buffers()}
    out["counts"] = (int(state.counter_with_d), int(state.counter_wo_d))
    out["d_count"] = int(state.d_opt.count)
    return out


@pytest.fixture(scope="module")
def steps():
    """Port and reference, three steps from one draw, each gate state."""
    cfg = _cfg()
    weights = R.make_weights(CONFIG.num_resblock, 21, "cpu", 0.5)
    weights.update(RG.make_d_weights(22, "cpu"))
    vgg = RG.make_vgg19(23, "cpu")
    scene = FR.make_clip(torch.Generator().manual_seed(24), 16, 56, 64, "cpu").numpy()
    batches = RT.batches(cfg, [scene], 25, STEPS)
    out = {"weights": weights}
    for gate, ema in GATES.items():
        out[gate] = (_port(weights, vgg, batches, ema),
                     RG.run_steps(weights, vgg, batches, cfg, ema_tbalance=ema))
    return out


def _gap(got, want, scale):
    return float((got.double() - want.double()).norm()) / scale


@pytest.mark.parametrize("gate", list(GATES))
def test_losses_match(steps, gate):
    got, ref = steps[gate]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL, atol=0)
    assert np.all(np.abs(np.array(ref["losses"])) > 1e-3)  # none is nought


@pytest.mark.parametrize("gate", list(GATES))
def test_first_gradients_match(steps, gate):
    got, ref = steps[gate]
    assert set(got["grads"]) == set(ref["grads"])
    assert any(k.startswith("discriminator.") for k in ref["grads"])
    norms = RT.norms(ref["grads"])
    median = float(np.median(list(norms.values())))
    for k, want in ref["grads"].items():
        assert norms[k] > 0, k
        assert _gap(got["grads"][k], want, max(norms[k], median)) <= GRAD_TOL, k


@pytest.mark.parametrize("gate", list(GATES))
def test_parameters_after_three_steps(steps, gate):
    got, ref = steps[gate]
    w0 = steps["weights"]
    frozen = gate == "closed"
    for k, want in ref["params"].items():
        moved = want - w0[k]
        if frozen and k.startswith("discriminator."):
            assert torch.equal(got["params"][k], w0[k]) and torch.equal(want, w0[k]), k
            continue
        assert float(moved.norm()) > 0, k
        assert _gap(got["params"][k] - w0[k], moved, float(moved.norm())) <= CHANGE_TOL, k


@pytest.mark.parametrize("gate", list(GATES))
def test_running_statistics(steps, gate):
    got, ref = steps[gate]
    assert set(got["stats"]) == set(ref["stats"])
    assert RG.stats_gap(got["stats"], ref["stats"]) <= STATS_TOL


@pytest.mark.parametrize("gate", list(GATES))
def test_gate_decisions_and_counters(steps, gate):
    got, ref = steps[gate]
    opened = gate == "open"
    assert got["gates"] == ref["gates"] == [opened] * STEPS
    assert got["counts"] == ref["counts"] == ((STEPS, 0) if opened else (0, STEPS))
    assert got["d_count"] == (STEPS if opened else 0)
