"""The port's bfloat16 training (float32 master weights, bfloat16 compute)
against the JAX package's ``compute_dtype="bfloat16"`` trainer on the CPU:
one FRVSR step (with and without per-frame recomputation) and one TecoGAN
step with the gate open and closed, from the same init and uint8 batch;
the state's dtypes; the building blocks that round where flax rounds (the
cast at use, the batch norm, the leaky ReLU); and the training CLI in
bfloat16 with a resume and the FRVSR -> TecoGAN warm start.

Tolerances are set against the JAX package's own bfloat16 error, its
bfloat16 step against its float32 step on the same init and batch: the two
packages round at the same points, but a bfloat16 rounding of one operand
that lands on the other side of a tie moves a result by a bfloat16 ulp
(2^-8 relative), and the convolutions sum in another order. The float32
step of that yardstick is the port's: tests/test_torch_train.py and
tests/test_torch_gan.py hold it to the JAX package's float32 step within
1e-4 of each gradient leaf's scale and 1e-5 of each metric, which moves
the yardstick by nothing these tolerances can see, and it spares this file
two JAX compilations (~30 s each on one core).
- Metrics: within METRIC_RTOL (1e-3) of their scale (the scales of the
  float32 tests: t_balance, a difference of two ~0.55 terms, against the
  adversarial loss; a VGG loss, 1 - a mean cosine, against 1), or within
  twice the JAX package's own bfloat16-vs-float32 gap where that is larger:
  the discriminator's outputs are bfloat16 values (an ulp of 0.6 is 0.004),
  so their means and logs move by rounding.
- Gradients, per leaf as ||g_port - g_jax|| / ||g_jax||: at most twice the
  JAX package's own bfloat16-vs-float32 error on that leaf plus 0.02, and
  their median over the leaves at most 0.08 (measured: 0.021 FRVSR, 0.036
  TecoGAN).
- Parameters after the first Adam step (adam_eps 1e-12: the move is
  lr * sign(g)): within 1e-6 wherever |g| is above 10% of its leaf's
  largest entry, for G and FNet. The discriminator's gradients are
  rounding noise well above that line (the JAX package's own bfloat16
  ones are 30-50% of their norm from its float32 ones, and entries up to
  35% of a leaf's largest flip sign between the packages), so of its
  entries above the line at least 99% must move as the JAX package's.
- The discriminator's running statistics: within 1e-3 of max(1, scale),
  or twice the JAX package's own gap.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxConfig
from tecogan_tpu.models.layers import SlimBatchNorm as JaxSlimBatchNorm
from tecogan_tpu.models.layers import lrelu as jax_lrelu
from tecogan_tpu.train import Trainer as JaxTrainer
from tecogan_tpu.train import TrainState as JaxTrainState
from tecogan_tpu_torch.cli.main import main
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.models import Discriminator
from tecogan_tpu_torch.models.layers import SlimBatchNorm, glorot_init_, lrelu
from tecogan_tpu_torch.train import Trainer
from tecogan_tpu_torch.train.checkpoint import latest_step
from tecogan_tpu_torch.train.trainer import cast_at_use, named_state_tensors
from tecogan_tpu_torch.weights import discriminator_to_jax, from_jax_params, to_jax_params
from tests.test_torch_gan import (  # noqa: F401  (vgg_params is a fixture)
    STEP,
    _batch,
    _copy_state,
    _first_moment_grads,
    _jax_state,
    _np,
    _port_state,
    _port_trees,
    vgg_params,
)
from tests.test_torch_gan import _grad_trees as _gan_grad_trees
from tests.test_torch_loop import _argv, _mini_argv, scenes  # noqa: F401
from tests.test_torch_train import TINY, _grad_trees

torch.set_num_threads(1)

BF16 = {"compute_dtype": "bfloat16"}
METRIC_RTOL = 1e-3
GRAD_OWN_FACTOR, GRAD_FLOOR, GRAD_MEDIAN = 2.0, 0.02, 0.08
PARAM_ATOL, GRAD_MASK, D_AGREE = 1e-6, 0.1, 0.99
STATS_TOL = 1e-3
# adam_eps 1e-12, as tests/test_torch_gan.py's: the first move is lr *
# sign(g) for every gradient above ~1e-9, FNet's (~1e-6) included.
FRVSR = {**TINY, "adam_eps": 1e-12}
GAN = STEP


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _frvsr_jax_state(tr, cfg):
    """A JAX FRVSR state at the port's seeded glorot init, FNet's output
    bias and conv set as in tests/test_torch_gan.py's ``_jax_state``, so
    every flow sits mid-cell: a bfloat16 flow there cannot round across a
    pixel boundary, where the warp's flow gradient jumps."""
    init = Trainer(cfg, "cpu").init_state(0)
    gen, fnet = to_jax_params(init.generator, init.fnet)
    fnet["output_conv2"]["bias"] = np.asarray([0.015625, -0.026], np.float32)
    fnet["output_conv2"]["kernel"] *= np.float32(0.1)
    return JaxTrainState(step=np.zeros((), np.int32), gen_params=gen, fnet_params=fnet,
                         gen_opt=tr.gen_tx.init(gen), fnet_opt=tr.fnet_tx.init(fnet),
                         ema_losses={k: np.zeros((), np.float32) for k in tr._telemetry_keys()})


@pytest.fixture(scope="module")
def jax_frvsr():
    """The JAX trainer's bfloat16 FRVSR step from one init on one uint8
    batch: the metrics, the gradients (from Adam's first moment) and the
    parameters after it; and the port's float32 step from the same init,
    the yardstick (module docstring)."""
    cfg = TecoConfig(**FRVSR)
    batch = _batch(cfg)
    tr = JaxTrainer(JaxConfig(**FRVSR, **BF16))
    state = _frvsr_jax_state(tr, cfg)
    init = _np((state.gen_params, state.fnet_params))
    new, metrics = tr.train_step(state, jnp.asarray(batch))
    new = _np(new)
    out = dict(batch=batch, init=init, bfloat16=dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads=tuple(_first_moment_grads(o, cfg.beta1) for o in (new.gen_opt, new.fnet_opt)),
        after=(new.gen_params, new.fnet_params)))
    trainer = Trainer(cfg, "cpu")
    port = trainer.state_from_modules(*from_jax_params(*init))
    port, metrics = trainer.train_step(port, batch)
    out["float32"] = dict(metrics={k: float(v) for k, v in metrics.items()},
                          grads=_grad_trees(port))
    return out


@pytest.fixture(scope="module")
def jax_gan(vgg_params):
    """The JAX trainer's bfloat16 TecoGAN step (ping-pong, layer loss, VGG;
    as tests/test_torch_gan.py's ``STEP``) with the gate forced open and
    closed from one init; and the port's float32 step, gate open, the
    yardstick (module docstring)."""
    cfg = JaxConfig(**GAN, **BF16)
    out = dict(batch=_batch(cfg))
    tr = JaxTrainer(cfg, vgg_params=vgg_params)
    state = _jax_state(tr, TecoConfig(**GAN))
    out["init"] = _np(state)
    for gate in ("open", "closed"):
        new, metrics = tr.train_step(_copy_state(state, -100.0 if gate == "open" else 100.0),
                                     jnp.asarray(out["batch"]))
        out["bfloat16", gate] = dict(state=_np(new),
                                     metrics={k: float(v) for k, v in metrics.items()})
    new = out["bfloat16", "open"]["state"]
    out["bfloat16", "grads"] = tuple(_first_moment_grads(o, cfg.beta1)
                                     for o in (new.gen_opt, new.fnet_opt, new.d_opt))
    trainer, port = _port_state(out["init"], TecoConfig(**GAN), vgg_params)
    port.ema_tbalance = torch.tensor(-100.0)
    port, metrics = trainer.train_step(port, out["batch"])
    out["float32"] = dict(metrics={k: float(v) for k, v in metrics.items()},
                          grads=_gan_grad_trees(port),
                          stats=discriminator_to_jax(port.discriminator)[1])
    return out


def _metric_scale(k, want):
    if k == "t_balance":
        return abs(want["t_adversarial_loss"])
    return 1.0 if k.startswith("vgg_") else abs(want[k])


def _check_metrics(got, want, want_f32):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        own = abs(w - want_f32[k])
        tol = max(METRIC_RTOL * _metric_scale(k, want), 2 * own)
        assert abs(float(got[k]) - w) <= tol, (k, float(got[k]), w, tol)


def _check_grads(got_trees, want_trees, f32_trees):
    rels = []
    for got, want, f32 in zip(got_trees, want_trees, f32_trees):
        for (path, g), (_, w), (_, f) in zip(_leaves(got), _leaves(want), _leaves(f32)):
            norm = np.linalg.norm(w)
            rel, own = np.linalg.norm(g - w) / norm, np.linalg.norm(f - w) / norm
            assert rel <= GRAD_OWN_FACTOR * own + GRAD_FLOOR, (path, rel, own)
            rels.append(rel)
    assert np.median(rels) <= GRAD_MEDIAN, np.median(rels)


def _check_params(got_trees, want_trees, grad_trees):
    for got, want, grads in zip(got_trees, want_trees, grad_trees):
        for (path, g), (_, a), (_, w) in zip(_leaves(grads), _leaves(got), _leaves(want)):
            mask = np.abs(g) > GRAD_MASK * np.abs(g).max()
            assert mask.any(), path
            diff = np.abs(a - w)[mask]
            assert diff.max() <= PARAM_ATOL, (path, diff.max())


def _port_frvsr(jax_frvsr, **kw):
    trainer = Trainer(TecoConfig(**{**FRVSR, **BF16, **kw}), "cpu")
    return trainer, trainer.state_from_modules(*from_jax_params(*jax_frvsr["init"]))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_frvsr_step_matches_jax(jax_frvsr, remat):
    """One bfloat16 FRVSR step: the eval metrics at init, the step's
    metrics, every gradient leaf and the parameters after Adam; with
    per-frame recomputation too (the recompute reads the same casts)."""
    trainer, state = _port_frvsr(jax_frvsr, remat_generator=remat)
    assert trainer.remat is remat and trainer.dtype == torch.bfloat16
    ref, f32 = jax_frvsr["bfloat16"], jax_frvsr["float32"]
    evals = trainer.eval_step(state, jax_frvsr["batch"])
    _check_metrics(evals, {k: v for k, v in ref["metrics"].items() if k in evals},
                   f32["metrics"])
    state, metrics = trainer.train_step(state, jax_frvsr["batch"])
    _check_metrics(metrics, ref["metrics"], f32["metrics"])
    grads = _grad_trees(state)
    _check_grads(grads, ref["grads"], f32["grads"])
    _check_params(to_jax_params(state.generator, state.fnet), ref["after"], ref["grads"])


def test_remat_reads_the_bf16_casts(jax_frvsr):
    """The recomputed frames run at the same bfloat16 casts as the forward
    (not at the float32 parameters): the gradients are bit-equal."""
    grads = []
    for remat in (False, True):
        trainer, state = _port_frvsr(jax_frvsr, remat_generator=remat)
        trainer.train_step(state, jax_frvsr["batch"])
        grads.append([p.grad for m in (state.generator, state.fnet) for p in m.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("gate", ["open", "closed"])
def test_tecogan_step_matches_jax(jax_gan, vgg_params, gate):
    """One bfloat16 TecoGAN step: every metric, gradient (G, FNet, D) and
    parameter after Adam; a closed gate leaves D's parameters and Adam
    state bit-unchanged; the running statistics move as the JAX
    package's in both gate states."""
    ref, f32 = jax_gan["bfloat16", gate], jax_gan["float32"]
    trainer, state = _port_state(jax_gan["init"], TecoConfig(**GAN, **BF16), vgg_params)
    assert next(trainer.vgg.parameters()).dtype == torch.bfloat16
    state.ema_tbalance = torch.tensor(-100.0 if gate == "open" else 100.0)
    state, metrics = trainer.train_step(state, jax_gan["batch"])
    _check_metrics(metrics, ref["metrics"], f32["metrics"])
    grads = _gan_grad_trees(state)
    _check_grads(grads, jax_gan["bfloat16", "grads"], f32["grads"])
    new = ref["state"]
    got = _port_trees(state)
    _check_params(got[:2], (new.gen_params, new.fnet_params), jax_gan["bfloat16", "grads"][:2])
    if gate == "open":
        agree = total = 0
        for (_, g), (_, a), (_, w) in zip(_leaves(jax_gan["bfloat16", "grads"][2]),
                                          _leaves(got[2]), _leaves(new.d_params)):
            mask = np.abs(g) > GRAD_MASK * np.abs(g).max()
            agree += int((np.abs(a - w)[mask] <= PARAM_ATOL).sum())
            total += int(mask.sum())
        assert agree >= D_AGREE * total, (agree, total)
        assert int(state.d_opt.count) == 1
    else:
        for (_, a), (_, w) in zip(_leaves(got[2]), _leaves(jax_gan["init"].d_params)):
            np.testing.assert_array_equal(a, w)
        assert int(state.d_opt.count) == 0
        assert not any(m.any() for m in state.d_opt.mu + state.d_opt.nu)
    for (path, a), (_, w), (_, f) in zip(_leaves(discriminator_to_jax(state.discriminator)[1]),
                                         _leaves(new.d_batch_stats), _leaves(f32["stats"])):
        tol = max(STATS_TOL * max(1.0, np.abs(w).max()), 2 * np.abs(f - w).max())
        assert np.abs(a - w).max() <= tol, (path, np.abs(a - w).max(), tol)
    assert (int(state.counter_with_d), int(state.counter_wo_d)) == (
        (1, 0) if gate == "open" else (0, 1))


def test_state_stays_float32(jax_gan, vgg_params):
    """After a bfloat16 TecoGAN step every parameter, gradient, Adam
    moment and count, learning rate, EMA, D running statistic and the
    metric vector are float32 (the counters int32)."""
    trainer, state = _port_state(jax_gan["init"], TecoConfig(**GAN, **BF16), vgg_params)
    state.ema_tbalance = torch.tensor(-100.0)
    state, metrics = trainer.train_step(state, jax_gan["batch"])
    ints = {"device_step", "counter_with_d", "counter_wo_d", "d_opt.count"}
    for name, t in named_state_tensors(state):
        assert t.dtype == (torch.int32 if name in ints else torch.float32), (name, t.dtype)
    for module in (state.generator, state.fnet, state.discriminator):
        for name, p in module.named_parameters():
            assert p.dtype == p.grad.dtype == torch.float32, name
    assert all(v.dtype == torch.float32 for k, v in metrics.items() if k != "learning_rate")


def test_eval_step_generates_bf16(jax_frvsr):
    """The generator and FNet run in bfloat16 in an eval step (their
    outputs), the metrics are float32."""
    trainer, state = _port_frvsr(jax_frvsr)
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append((type(m).__name__, o.dtype)))
             for m in (state.generator, state.fnet)]
    metrics = trainer.eval_step(state, jax_frvsr["batch"])
    for h in hooks:
        h.remove()
    assert {name for name, _ in seen} == {"Generator", "FNet"}
    assert all(dtype == torch.bfloat16 for _, dtype in seen), seen
    assert all(v.dtype == torch.float32 for v in metrics.values())
    assert all(p.dtype == torch.float32 for p in state.generator.parameters())


def test_bf16_step_differs_from_f32(jax_frvsr):
    """The bfloat16 step is not a float32 step: its losses and gradients
    differ from the port's float32 step on the same init and batch (by
    bfloat16 rounding, so within a few percent)."""
    runs = []
    for dtype in ("bfloat16", "float32"):
        trainer, state = _port_frvsr(jax_frvsr, compute_dtype=dtype)
        _, metrics = trainer.train_step(state, jax_frvsr["batch"])
        runs.append((float(metrics["All_loss_Gen"]),
                     torch.cat([p.grad.flatten() for p in state.generator.parameters()])))
    (loss_bf16, g_bf16), (loss_f32, g_f32) = runs
    assert loss_bf16 != loss_f32
    np.testing.assert_allclose(loss_bf16, loss_f32, rtol=1e-3)
    rel = ((g_bf16 - g_f32).norm() / g_f32.norm()).item()
    assert 1e-4 < rel < 0.1, rel


def test_cast_at_use_keeps_the_batch_norm_bias_float32():
    """cast_at_use(D, bfloat16) is D with every parameter but the batch
    norms' biases cast to bfloat16 (flax adds that bias in float32); its
    gradients land float32 on the float32 parameters; ``detach`` takes
    them as constants; in float32 with nothing to detach it is D itself."""
    disc = glorot_init_(Discriminator(27), torch.Generator().manual_seed(3))
    with torch.no_grad():
        for block in disc.blocks:
            block.bn.bias.normal_(0.0, 0.1)
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 32, 32, 27).astype(np.float32))
    want = copy.deepcopy(disc).to(torch.bfloat16)
    for block, src in zip(want.blocks, disc.blocks):
        block.bn.bias = torch.nn.Parameter(src.bn.bias.detach().clone())
    out, layers = cast_at_use(disc, torch.bfloat16)(x)
    ref, ref_layers = want(x)
    assert out.dtype == torch.bfloat16 and all(t.dtype == torch.bfloat16 for t in layers)
    assert torch.equal(out, ref) and all(torch.equal(a, b) for a, b in zip(layers, ref_layers))
    out.float().sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 and p.grad.any()
               for p in disc.parameters())
    assert not cast_at_use(disc, torch.bfloat16, detach=True)(x)[0].requires_grad
    assert cast_at_use(disc, torch.float32) is disc


def test_slim_batch_norm_bf16_matches_flax():
    """A bfloat16 input: float32 statistics and normalisation, the float32
    bias added before the one rounding to bfloat16, as flax's
    ``BatchNorm(dtype=bfloat16)``; the running statistics stay float32."""
    rng = np.random.RandomState(6)
    x = (rng.randn(3, 6, 5, 8) * 2.0 + 40.0).astype(np.float32)  # E[x^2] >> var
    bias = (rng.randn(8) * 0.1).astype(np.float32)
    x_bf16 = torch.from_numpy(x).bfloat16()
    xj = jnp.asarray(x_bf16.float().numpy()).astype(jnp.bfloat16)
    mod = JaxSlimBatchNorm(dtype=jnp.bfloat16)
    variables = mod.init(jax.random.PRNGKey(0), xj)
    variables = {"params": {"bn": {"bias": jnp.asarray(bias)}},
                 "batch_stats": variables["batch_stats"]}
    want, new = mod.apply(variables, xj, mutable=["batch_stats"])
    bn = SlimBatchNorm(8)
    with torch.no_grad():
        bn.bias.copy_(torch.from_numpy(bias))
    got = bn(x_bf16.permute(0, 3, 1, 2), update_stats=True).permute(0, 2, 3, 1).detach()
    assert got.dtype == torch.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    # Float32 sums in another order may flip a rounding: one bfloat16 ulp.
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)
    stats = new["batch_stats"]["bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-4)
    assert np.asarray(stats["var"]).min() > 0.1  # no cancellation to zero


def test_lrelu_rounds_its_slope_like_jax():
    """``alpha * x`` with a Python alpha rounds alpha to x's dtype in the
    JAX package: in bfloat16 the port's slope is 0.2001953125 too, so the
    two agree bit for bit (and in float32)."""
    x = np.random.RandomState(2).randn(4096).astype(np.float32) * 3
    for tdtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        xt = torch.from_numpy(x).to(tdtype)
        want = np.asarray(jax_lrelu(jnp.asarray(xt.float().numpy()).astype(jdtype), 0.2),
                          np.float32)
        np.testing.assert_array_equal(lrelu(xt, 0.2).float().numpy(), want)


def test_cli_trains_bf16_resumes_and_warm_starts(scenes, tmp_path, capsys):  # noqa: F811
    """``cli.main --mode train --compute_dtype bfloat16 --device cpu``: 2
    FRVSR steps whose checkpoint holds float32 weights, a resume to step 3,
    then a TecoGAN run (``--preset mini``) warm-started from it."""
    out = str(tmp_path / "frvsr")
    bf16 = ("--device", "cpu", "--compute_dtype", "bfloat16", "--no_test_while_train")
    main(_argv(scenes, out, *bf16))
    printed = capsys.readouterr().out
    assert "compute dtype bfloat16, float32 master weights" in printed
    ckpt = os.path.join(out, "checkpoints")
    assert latest_step(ckpt) == 2
    saved = torch.load(os.path.join(ckpt, "2", "state.pt"), weights_only=True)
    floats = [t for t in jax.tree_util.tree_leaves(saved)
              if torch.is_tensor(t) and t.is_floating_point()]
    assert floats and all(t.dtype == torch.float32 for t in floats)
    main(_argv(scenes, out, *bf16, "--max_iter", "3"))
    assert "Resumed from step 2" in capsys.readouterr().out
    assert latest_step(ckpt) == 3
    gan = str(tmp_path / "tecogan")
    main(_mini_argv(scenes, gan, "--allow_random_weights", "--compute_dtype", "bfloat16",
                    "--pre_trained_dir", ckpt))
    printed = capsys.readouterr().out
    assert f"Warm-started weights from {ckpt}" in printed
    assert "Training TecoGAN on cpu: compute dtype bfloat16" in printed
    assert latest_step(os.path.join(gan, "checkpoints")) == 2
