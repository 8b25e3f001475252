"""The port's device-side training step on the CPU, where it runs eagerly
over the same static buffers and state tensors that the card's captured
CUDA graphs use (``tecogan_tpu_torch/train/trainer.py``): three FRVSR steps
and three TecoGAN steps across a gate change against the JAX trainer's
``train_step``, the device learning rate and ``dt_ratio`` against optax and
``jnp.minimum``, a checkpoint restored into the state it was saved from,
metrics that outlive the next step, ``capture=True`` refused on the CPU,
and the capturing path with the graph stood in for."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxConfig
from tecogan_tpu.train import Trainer as JaxTrainer
from tecogan_tpu.train import TrainState as JaxTrainState
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.train import Trainer
from tecogan_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from tecogan_tpu_torch.train.loop import train
from tecogan_tpu_torch.train.trainer import state_tensors
from tecogan_tpu_torch.weights import _fnet_layers, _generator_layers, discriminator_to_jax

torch.set_num_threads(1)

# Each step starts both trainers from the port's state (the JAX TrainState
# is rebuilt from it: weights, Adam moments and counts, the discriminator's
# statistics, EMAs, counters, step), so what is compared is the step and
# not the two trajectories: an entry whose gradient is near zero moves by
# up to lr on its last bits, and a ReLU or warp-cell kink turns that into
# a different gradient a step later. Tolerances as tests/test_torch_train.py
# and tests/test_torch_gan.py hold one step: metric scalars 1e-5 (float32
# sums in another order), the parameters after each Adam step within 1e-6
# where the step's gradient stands clear of zero (above 1e-3 of its leaf's
# largest entry), the EMAs 0.01 x the metric.
METRIC_RTOL, PARAM_ATOL, GRAD_MASK = 1e-5, 1e-6, 1e-3

# adam_eps 1e-12, as tests/test_torch_gan.py: near |g| ~ 1e-8 the default
# eps would make an update follow a gradient's last bits.
BASE = dict(num_resblock=2, crop_size=8, batch_size=2, rnn_n=4, learning_rate=1e-3,
            adam_eps=1e-12, remat_generator=False, vgg_scaling=-0.002)
FRVSR = dict(BASE, ratio=-0.01)
# TecoGAN without VGG; the gate's threshold sits between the EMA's start
# (-1) and where the first step moves it (0.99 * -1 + 0.01 * t_balance,
# t_balance ~ 0 at the init): open at step 1, closed at steps 2 and 3. The
# L1 terms are off (the ping-pong's weight 0, no layer loss): an L1 has a
# kink where its two sides tie, and a tie closer than the two packages'
# rounding flips a sign (tests/test_torch_gan.py's STEP note); over three
# batches the layer loss meets one (here at step 3, moving FNet's
# gradient by 1% of its scale). tests/test_torch_gan.py holds the layer
# loss for one step.
GAN = dict(BASE, ratio=0.01, pingpong=True, pp_scaling=0.0, d_layerloss=False,
           d_balance=-0.995)


def _batch(cfg, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(cfg.batch_size, cfg.rnn_n, cfg.hr_load_size, cfg.hr_load_size, 3)
            * 255).astype(np.uint8)


def _np(t):
    return t.detach().cpu().numpy().copy()


def _trees(state, value):
    """(generator, FNet) as flax trees of ``value(parameter)``: the weights,
    their gradients or an Adam moment, in HWIO layout (``weights._tree``)."""
    def tree(layers):
        return {name: {"kernel": _np(value(m.weight).permute(2, 3, 1, 0)),
                       "bias": _np(value(m.bias))} for name, m in layers}
    return tree(_generator_layers(state.generator)), tree(_fnet_layers(state.fnet))


def _d_tree(disc, values):
    """The discriminator's parameter tree holding ``values`` (one tensor per
    parameter, in ``parameters()`` order), through ``discriminator_to_jax``."""
    saved = [p.detach().clone() for p in disc.parameters()]
    with torch.no_grad():
        for p, v in zip(disc.parameters(), values):
            p.copy_(v)
        tree = jax.tree_util.tree_map(np.copy, discriminator_to_jax(disc)[0])
        for p, v in zip(disc.parameters(), saved):
            p.copy_(v)
    return tree


def _adam(opt_state, count, mu, nu):
    adam, sched = opt_state
    count = np.asarray(count, np.int32)
    return (adam._replace(count=count, mu=mu, nu=nu), sched._replace(count=count))


def _jax_state(tr, trainer, state):
    """The JAX TrainState holding the port's state."""
    step = int(state.device_step)
    weights = _trees(state, lambda p: p)

    def moment(k):  # before the first step Adam has no state: zero
        return _trees(state, lambda p: (state.gen_opt.state.get(p) or state.fnet_opt.state.get(p)
                                        or {}).get(k, torch.zeros_like(p)))
    mu, nu = moment("exp_avg"), moment("exp_avg_sq")
    opts = [_adam(tr.gen_tx.init(weights[i]), step, mu[i], nu[i]) for i in (0, 1)]
    fields = dict(step=np.asarray(step, np.int32), gen_params=weights[0],
                  fnet_params=weights[1], gen_opt=opts[0], fnet_opt=opts[1],
                  ema_losses={k: _np(v) for k, v in state.ema_losses.items()})
    if trainer.config.gan:
        disc, d_opt = state.discriminator, state.d_opt
        d_params, d_stats = jax.tree_util.tree_map(np.copy, discriminator_to_jax(disc))
        fields.update(d_params=d_params, d_batch_stats=d_stats,
                      d_opt=_adam(tr.d_tx.init(d_params), int(d_opt.count),
                                  _d_tree(disc, d_opt.mu), _d_tree(disc, d_opt.nu)),
                      ema_tbalance=_np(state.ema_tbalance),
                      counter_with_d=_np(state.counter_with_d),
                      counter_wo_d=_np(state.counter_wo_d))
    return JaxTrainState(**fields)


def _leaves(tree):
    return [leaf for _, leaf in jax.tree_util.tree_leaves_with_path(tree)]


def _check_params(got, want, grads, eps):
    """Each leaf within PARAM_ATOL where its gradient stands clear of zero
    (and of Adam's eps)."""
    for g, a, w in zip(_leaves(grads), _leaves(got), _leaves(want)):
        mask = np.abs(g) > max(GRAD_MASK * np.abs(g).max(), 1e3 * eps)
        assert mask.any()
        assert np.abs(a - w)[mask].max() <= PARAM_ATOL


def _three_steps(kw, seeds, ema_tbalance=0.0):
    """Three steps of the port's step body, each against the JAX trainer's
    train_step from the same state on the same batch: the metrics, the
    weights after the update, the EMAs and both step counters. Returns
    the port's state, the JAX state after each step and, in TecoGAN mode,
    the discriminator's parameters before each step."""
    cfg = TecoConfig(**kw)
    trainer = Trainer(cfg, "cpu")
    state = trainer.init_state(0)
    with torch.no_grad():  # flows mid-cell, as tests/test_torch_gan.py
        state.fnet.output_conv2.bias.copy_(torch.tensor([0.015625, -0.026]))
        state.fnet.output_conv2.weight.mul_(0.1)
        if cfg.gan:
            state.ema_tbalance.fill_(ema_tbalance)
    tr = JaxTrainer(JaxConfig(**kw))
    history, d_before = [], []
    for s, seed in enumerate(seeds):
        batch = _batch(cfg, seed)
        jstate = _jax_state(tr, trainer, state)
        new, want = tr.train_step(jstate, jnp.asarray(batch))
        if cfg.gan:
            d_before.append([p.detach().clone() for p in state.discriminator.parameters()])
        _, got = trainer.train_step(state, batch)
        assert set(got) == set(want), set(got) ^ set(want)
        for k, w in want.items():
            # t_balance = mean(log D(real)) + adv: a difference of two ~0.7
            # terms, held to the tolerance of adv.
            atol = (2 * METRIC_RTOL * abs(float(want["t_adversarial_loss"]))
                    if k == "t_balance" else 0.0)
            np.testing.assert_allclose(float(got[k]), float(w), rtol=METRIC_RTOL, atol=atol,
                                       err_msg=f"step {s + 1} {k}")
        assert state.step == int(state.device_step) == int(new.step) == s + 1
        _check_params(_trees(state, lambda p: p), (new.gen_params, new.fnet_params),
                      _trees(state, lambda p: p.grad), cfg.adam_eps)
        for k, v in state.ema_losses.items():
            np.testing.assert_allclose(float(v), float(new.ema_losses[k]), rtol=METRIC_RTOL,
                                       atol=0.01 * METRIC_RTOL, err_msg=k)
        history.append(new)
    return state, history, d_before


def test_three_frvsr_steps_match_jax():
    """Three FRVSR steps on three batches (Adam counts 1 to 3, the EMAs
    accumulating) against the JAX trainer's train_step."""
    state, history, _ = _three_steps(FRVSR, (5, 6, 7))
    assert all(float(v) != 0.0 for v in state.ema_losses.values())
    assert int(history[-1].gen_opt[0].count) == 3


def test_three_tecogan_steps_close_the_gate_like_jax():
    """Three TecoGAN steps in which the gate closes through the EMA (open,
    closed, closed), against the JAX trainer's: the discriminator moves at
    the first step only, bit-unchanged after, each step's parameters within
    PARAM_ATOL of the JAX step's where the gradient is clear of zero, its
    statistics within 1e-5 of scale; the gate's EMA, its counters and the
    discriminator's Adam count after each step."""
    state, history, d_before = _three_steps(GAN, (8, 9, 10), ema_tbalance=-1.0)
    disc = state.discriminator
    after = [p.detach() for p in disc.parameters()]
    assert not all(torch.equal(a, b) for a, b in zip(d_before[0], d_before[1]))
    assert all(torch.equal(a, b) for a, b in zip(d_before[1], d_before[2]))
    assert all(torch.equal(a, b) for a, b in zip(d_before[2], after))
    got_params, got_stats = discriminator_to_jax(disc)
    _check_params(got_params, history[-1].d_params,
                  _d_tree(disc, [p.grad for p in disc.parameters()]), GAN["adam_eps"])
    for g, w in zip(_leaves(got_stats), _leaves(history[-1].d_batch_stats)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(1.0, np.abs(w).max()))
    gates = [(int(h.counter_with_d), int(h.counter_wo_d), int(h.d_opt[0].count))
             for h in history]
    assert gates == [(1, 0, 1), (1, 1, 1), (1, 2, 1)]
    assert (int(state.counter_with_d), int(state.counter_wo_d), int(state.d_opt.count)) \
        == gates[-1]
    np.testing.assert_allclose(float(state.ema_tbalance), float(history[-1].ema_tbalance),
                               rtol=1e-6)


@pytest.mark.parametrize("stair", [True, False])
def test_device_lr_and_dt_ratio_match_jax(stair):
    """The learning rate and the adversarial fade-in computed on the device
    from the int32 step, across a stair boundary (decay_step 4) and the
    fade-in's cap: the rate against ``optax.exponential_decay`` within
    float32 rounding of ``pow`` (1e-6), the fade-in bit-equal to the JAX
    trainer's ``jnp.minimum``; and the Adams' learning-rate tensor after a
    step is the rate at the step before it."""
    kw = dict(FRVSR, decay_step=4, decay_rate=0.5, stair=stair, dt_ratio_0=0.1,
              dt_ratio_add=0.25, dt_ratio_max=1.0)
    trainer = Trainer(TecoConfig(**kw), "cpu")
    sched = optax.exponential_decay(kw["learning_rate"], 4, 0.5, staircase=stair)
    jcfg = JaxConfig(**kw)
    for s in range(10):
        step = torch.tensor(s, dtype=torch.int32)
        np.testing.assert_allclose(float(trainer.lr_at(step)), float(sched(s)), rtol=1e-6)
        want = jnp.minimum(jcfg.dt_ratio_max, jcfg.dt_ratio_0
                           + jcfg.dt_ratio_add * jnp.asarray(s, jnp.int32).astype(jnp.float32))
        assert trainer.dt_ratio_at(step).dtype == torch.float32
        assert float(trainer.dt_ratio_at(step)) == float(want), s
    state = trainer.init_state(1)
    batch = _batch(trainer.config, 3)
    for s in range(5):
        _, metrics = trainer.train_step(state, batch)
        for opt in (state.gen_opt, state.fnet_opt):
            assert opt.param_groups[0]["lr"] == trainer.lr_at(torch.tensor(s, dtype=torch.int32))
        assert metrics["learning_rate"] == trainer.schedule(s)


def test_restore_into_the_same_state_is_bit_equal(tmp_path):
    """TecoGAN: train 2 steps, save, train a third, restore the checkpoint
    into the same state (in place: every state tensor keeps its storage, as
    a captured step needs) and train the third again: bit-equal to 3 steps
    straight, weights, Adam states, discriminator, EMAs and counters."""
    trainer = Trainer(TecoConfig(**GAN), "cpu")
    a, b = trainer.init_state(3), trainer.init_state(3)
    batches = [_batch(trainer.config, s) for s in (11, 12, 13)]
    for batch in batches[:2]:
        trainer.train_step(a, batch)
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, a)
    trainer.train_step(a, batches[2])
    addresses = [t.data_ptr() for t in state_tensors(a)]
    assert restore_checkpoint(ckpt, a) is a
    assert (a.step, int(a.device_step)) == (2, 2)
    assert [t.data_ptr() for t in state_tensors(a)] == addresses
    trainer.train_step(a, batches[2])
    for batch in batches:
        trainer.train_step(b, batch)
    assert (a.step, int(a.device_step)) == (b.step, int(b.device_step)) == (3, 3)
    for x, y in zip(state_tensors(a), state_tensors(b)):
        assert torch.equal(x, y)


def test_metrics_outlive_the_next_step():
    """A step's metrics (and an eval's) keep that step's values after the
    next step and eval, which give other values; a new batch shape or
    dtype gets its own static buffer."""
    trainer = Trainer(TecoConfig(**FRVSR), "cpu")
    state = trainer.init_state(4)
    b1, b2 = _batch(trainer.config, 14), _batch(trainer.config, 15)
    _, m1 = trainer.train_step(state, b1)
    e1 = trainer.eval_step(state, b1)
    held = {k: float(v) for k, v in {**m1, **{"eval_" + k: v for k, v in e1.items()}}.items()}
    _, m2 = trainer.train_step(state, b2)
    e2 = trainer.eval_step(state, b2.astype(np.float32) / np.float32(255.0))
    assert {k: float(v) for k, v in {**m1, **{"eval_" + k: v for k, v in e1.items()}}.items()} \
        == held
    assert float(m2["l2_content_loss"]) != held["l2_content_loss"]
    assert float(e2["l2_content_loss"]) != held["eval_l2_content_loss"]
    kinds = sorted((k[0], str(k[3])) for k in trainer._programs)
    assert kinds == [("eval", "torch.float32"), ("eval", "torch.uint8"),
                     ("train", "torch.uint8")]


def test_capture_true_on_the_cpu_raises(tmp_path):
    """capture=True needs the card: Trainer and train() raise on the CPU,
    before train() writes anything."""
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        Trainer(TecoConfig(**FRVSR), "cpu", capture=True)
    out = tmp_path / "run"
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        train(TecoConfig(**FRVSR), str(out), "cpu", capture=True)
    assert not out.exists()
    assert Trainer(TecoConfig(**FRVSR), "cpu").capture is False


class _EagerProgram:
    """A stand-in for ``CapturedProgram`` on the CPU: its warm-up really runs
    the body, as the card's does, and each call runs the body again (a
    replay); the capture itself, which runs nothing, has no stand-in."""

    captures = 0

    def __init__(self, body, inputs, name):
        body()
        self.body = body
        _EagerProgram.captures += 1

    def __call__(self):
        return self.body()

    def close(self):
        self.body = None

    def pool_bytes(self):
        return 0


def test_captured_path_updates_once_and_recaptures_moved_state(monkeypatch, tmp_path):
    """The capturing path of the step on the CPU, with the graph stood in
    for: the first call of a shape saves the state, warms up, restores it
    and replays, so it is one update, bit-equal to the eager step's; a
    rebound state tensor makes the next call capture again (counted in
    ``recaptures``); a checkpoint restored in place does not."""
    from tecogan_tpu_torch.train import trainer as trainer_module

    monkeypatch.setattr(trainer_module, "CapturedProgram", _EagerProgram)
    cfg = TecoConfig(**GAN)
    captured, eager = Trainer(cfg, "cpu"), Trainer(cfg, "cpu")
    captured.capture = True
    a, b = captured.init_state(5), eager.init_state(5)
    batches = [_batch(cfg, s) for s in (16, 17, 18, 19)]
    ckpt = str(tmp_path / "ckpt")
    start = _EagerProgram.captures
    for i, batch in enumerate(batches):
        if i == 1:
            save_checkpoint(ckpt, a)
            restore_checkpoint(ckpt, a)
        if i == 2:
            a.ema_tbalance = a.ema_tbalance.clone()
        _, got = captured.train_step(a, batch)
        _, want = eager.train_step(b, batch)
        assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
        for x, y in zip(state_tensors(a), state_tensors(b)):
            assert torch.equal(x, y)
    assert (_EagerProgram.captures - start, captured.recaptures) == (2, 1)
    assert (a.step, int(a.device_step)) == (4, 4)
