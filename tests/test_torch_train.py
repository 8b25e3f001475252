"""The port's FRVSR trainer and checkpoints against the JAX package, float32
on the CPU: one step from the same JAX init and batch (metrics, gradients,
parameters after the Adam update), two steps, the mode guards, save /
resume / warm start, and weights out to the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxConfig
from tecogan_tpu.train import Trainer as JaxTrainer
from tecogan_tpu.train.checkpoint import npz_to_params
from tecogan_tpu.train.trainer import prepare_batch as jax_prepare_batch
from tecogan_tpu.train.trainer import resolve_remat as jax_resolve_remat
from tecogan_tpu_torch.config import FRVSR_PRESET, TecoConfig
from tecogan_tpu_torch.train import Trainer, resolve_remat
from tecogan_tpu_torch.train.checkpoint import (
    latest_step,
    merge_partial_restore,
    restore_checkpoint,
    save_checkpoint,
    warm_start,
)
from tecogan_tpu_torch.weights import (
    _fnet_layers,
    _generator_layers,
    from_jax_params,
    params_to_npz,
    to_jax_params,
)

torch.set_num_threads(1)

# Metric scalars: float32 sums over ~10^4 terms in another order, and the
# uint8 batch divided by 255 where XLA multiplies by the reciprocal (1 ulp).
METRIC_RTOL = 1e-5
# Gradients, relative to each leaf's largest entry: float32 convolutions in
# another order, back through the recurrence.
GRAD_RTOL = 1e-4
# Parameters after one Adam step (lr 1e-3): the update is ~lr * sign(g), so
# they agree to rounding wherever |g| stands clear of zero (here: above
# GRAD_MASK of the leaf's largest entry); near-zero gradients may flip sign.
PARAM_ATOL, GRAD_MASK = 1e-6, 1e-3

TINY = dict(num_resblock=2, crop_size=8, batch_size=2, rnn_n=4, ratio=-0.01,
            vgg_scaling=-0.002, learning_rate=1e-3, remat_generator=False)


def tiny(**kw) -> TecoConfig:
    return TecoConfig(**{**TINY, **kw})


def _copy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), jax.device_get(tree))


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX trainer from its own init on one uint8 batch: the init, the
    gradients of the joint loss, the step's metrics (taken before the
    update, so also the eval metrics at init) and the parameters after it.

    FNet's output bias is set to (0.015625, -0.026): at the glorot init
    every flow is within ~1e-5 px of zero, so each warp query sits on a
    pixel boundary, where the warp's flow gradient jumps (it takes the left
    or the right cell) and a 1-ulp difference in the flow moves it. With
    this bias the HR flows sit near 1.5 / -2.4 px and the LR flows near
    0.38 / -0.6 px, mid-cell, where the gradient is smooth."""
    cfg = JaxConfig(**TINY)
    tr = JaxTrainer(cfg)
    state = tr.init_state(jax.random.PRNGKey(0))
    fnet_params = dict(state.fnet_params)
    fnet_params["output_conv2"] = dict(fnet_params["output_conv2"],
                                       bias=jnp.asarray([0.015625, -0.026], jnp.float32))
    state = state.replace(fnet_params=fnet_params)
    init = _copy((state.gen_params, state.fnet_params))
    rng = np.random.RandomState(5)
    batch = (rng.rand(2, 4, cfg.hr_load_size, cfg.hr_load_size, 3) * 255).astype(np.uint8)
    r_inputs, r_targets = jax_prepare_batch(jnp.asarray(batch), cfg)

    def joint(gp, fp):
        gen_loss, _, metrics, _ = tr._forward_losses(
            gp, fp, None, None, r_inputs, r_targets, state.step)
        return gen_loss + cfg.warp_scaling * metrics["l2_warp_loss"]

    grads = _copy(jax.jit(jax.grad(joint, argnums=(0, 1)))(
        state.gen_params, state.fnet_params))
    generated = _copy(tr.generate(state, jnp.asarray(batch)))
    # generate takes the batch's own frames with ping-pong on too.
    generated_pingpong = _copy(JaxTrainer(JaxConfig(**TINY, pingpong=True)).generate(
        state, jnp.asarray(batch)))
    new_state, metrics = tr.train_step(state, jnp.asarray(batch))
    return dict(init=init, grads=grads, batch=batch, generated=generated,
                generated_pingpong=generated_pingpong,
                metrics={k: float(v) for k, v in metrics.items()},
                after=_copy((new_state.gen_params, new_state.fnet_params)))


def _port(jax_ref, **cfg_kw):
    trainer = Trainer(tiny(**cfg_kw), "cpu")
    return trainer, trainer.state_from_modules(*from_jax_params(*jax_ref["init"]))


def _grad_trees(state):
    def tree(layers):
        return {name: {"kernel": m.weight.grad.permute(2, 3, 1, 0).numpy(),
                       "bias": m.bias.grad.numpy()} for name, m in layers}
    return tree(_generator_layers(state.generator)), tree(_fnet_layers(state.fnet))


def test_one_step_matches_jax(jax_ref):
    trainer, state = _port(jax_ref)
    evals = trainer.eval_step(state, jax_ref["batch"])
    for k, want in jax_ref["metrics"].items():
        if k != "learning_rate":
            np.testing.assert_allclose(float(evals[k]), want, rtol=METRIC_RTOL, err_msg=k)
    state, metrics = trainer.train_step(state, jax_ref["batch"])
    assert state.step == 1
    assert set(metrics) == set(jax_ref["metrics"])
    for k, want in jax_ref["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want, rtol=METRIC_RTOL, err_msg=k)
    after = to_jax_params(state.generator, state.fnet)
    for got_g, want_g, got_p, want_p in zip(_grad_trees(state), jax_ref["grads"],
                                            after, jax_ref["after"]):
        for layer, leaves in want_g.items():
            for leaf, g in leaves.items():
                scale = np.abs(g).max()
                err = np.abs(got_g[layer][leaf] - g).max()
                assert err <= GRAD_RTOL * scale, (layer, leaf, err, scale)
                mask = np.abs(g) > GRAD_MASK * scale
                assert mask.any()
                diff = np.abs(got_p[layer][leaf] - want_p[layer][leaf])[mask]
                assert diff.max() <= PARAM_ATOL, (layer, leaf, diff.max())


@pytest.mark.parametrize("pingpong", [False, True])
def test_generate_matches_jax(jax_ref, pingpong):
    """The summary sequences in [0, 1]: LR inputs, HR targets, generated
    frames and the warped previous outputs; with ping-pong on as well, as
    the JAX package's, of the batch's own 4 frames (no 2T-1 extension)."""
    trainer, state = _port(jax_ref, pingpong=pingpong)
    got = trainer.generate(state, jax_ref["batch"])
    shapes = [(2, 4, 8, 8, 3), (2, 4, 32, 32, 3), (2, 4, 32, 32, 3), (2, 3, 32, 32, 3)]
    want_all = jax_ref["generated_pingpong" if pingpong else "generated"]
    for g, want, shape in zip(got, want_all, shapes):
        assert g.shape == want.shape == shape
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-5)


def test_two_steps_eval_and_ema(jax_ref):
    trainer, state = _port(jax_ref)
    state, m1 = trainer.train_step(state, jax_ref["batch"])
    ema1 = {k: float(v) for k, v in state.ema_losses.items()}
    np.testing.assert_allclose(ema1["l2_content_loss"], 0.01 * float(m1["l2_content_loss"]),
                               rtol=1e-6)
    snapshot = ({k: v.clone() for k, v in state.generator.state_dict().items()},
                {k: v.clone() for k, v in state.gen_opt.state_dict()["state"][0].items()},
                state.step, dict(ema1))
    metrics = trainer.eval_step(state, jax_ref["batch"])  # mutates nothing
    assert all(np.isfinite(float(v)) for v in metrics.values())
    for k, v in state.generator.state_dict().items():
        assert torch.equal(v, snapshot[0][k])
    for k, v in state.gen_opt.state_dict()["state"][0].items():
        assert torch.equal(v, snapshot[1][k])
    assert (state.step, {k: float(v) for k, v in state.ema_losses.items()}) == snapshot[2:]
    state, m2 = trainer.train_step(state, jax_ref["batch"])
    assert state.step == 2
    for k, v in state.ema_losses.items():
        np.testing.assert_allclose(float(v), 0.99 * ema1[k] + 0.01 * float(m2[k]), rtol=1e-6)
    assert float(m2["l2_content_loss"]) != float(m1["l2_content_loss"])


def test_remat_step_equals_plain_step(jax_ref):
    """Per-frame checkpointing recomputes the same graph: equal losses and
    gradients."""
    results = []
    for remat in (False, True):
        trainer, state = _port(jax_ref, remat_generator=remat)
        assert trainer.remat is remat
        _, metrics = trainer.train_step(state, jax_ref["batch"])
        results.append((float(metrics["All_loss_Gen"]), _grad_trees(state)))
    assert results[0][0] == results[1][0]
    for tree_a, tree_b in zip(results[0][1], results[1][1]):
        for layer in tree_a:
            for leaf in tree_a[layer]:
                np.testing.assert_allclose(tree_a[layer][leaf], tree_b[layer][leaf],
                                           rtol=0, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(ratio=0.01, compute_dtype="bfloat16"),
                                dict(vgg_scaling=0.2, compute_dtype="bfloat16"),
                                dict(compute_dtype="bfloat16")],
                         ids=["gan", "vgg", "bfloat16"])
def test_unported_modes_raise(kw):
    """TecoGAN and VGG training are ported (tests/test_torch_gan.py);
    bfloat16 training, of any mode, is not (ROADMAP queue 1 item 17)."""
    with pytest.raises(NotImplementedError, match="item 17"):
        Trainer(tiny(**kw), "cpu")


def test_default_config_is_gan_and_raises():
    """The default configuration is TecoGAN's (ratio 0.01) and trains with a
    discriminator; with the VGG term on (vgg_scaling 0.2, as the TecoGAN
    preset) and no VGG19 weights the trainer raises, as the JAX package's."""
    assert TecoConfig().gan
    state = Trainer(TecoConfig(num_resblock=2), "cpu").init_state(0)
    assert state.discriminator is not None and int(state.counter_with_d) == 0
    with pytest.raises(ValueError, match="VGG19 weights"):
        Trainer(TecoConfig(vgg_scaling=0.2), "cpu")
    with pytest.raises(ValueError):
        JaxTrainer(JaxConfig(vgg_scaling=0.2))


def test_resolve_remat_matches_jax():
    for kw in (dict(), dict(crop_size=128), dict(remat_generator=True),
               dict(pingpong=True, rnn_n=10, crop_size=96)):
        cfg = FRVSR_PRESET.replace(**kw)
        assert resolve_remat(cfg) == jax_resolve_remat(JaxConfig(
            num_resblock=10, crop_size=cfg.crop_size, pingpong=cfg.pingpong,
            rnn_n=cfg.rnn_n, remat_generator=cfg.remat_generator)), kw


def _assert_states_equal(a, b):
    assert a.step == b.step
    for ma, mb in ((a.generator, b.generator), (a.fnet, b.fnet)):
        for k, v in ma.state_dict().items():
            assert torch.equal(v, mb.state_dict()[k]), k
    for oa, ob in ((a.gen_opt, b.gen_opt), (a.fnet_opt, b.fnet_opt)):
        sa, sb = oa.state_dict()["state"], ob.state_dict()["state"]
        assert sa.keys() == sb.keys()
        for i in sa:
            for k in sa[i]:
                assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert {k: float(v) for k, v in a.ema_losses.items()} == \
        {k: float(v) for k, v in b.ema_losses.items()}


def test_checkpoint_round_trip_is_bit_equal(jax_ref, tmp_path):
    trainer, state = _port(jax_ref)
    state, _ = trainer.train_step(state, jax_ref["batch"])
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, state)
    assert latest_step(ckpt) == 1
    with pytest.raises(FileExistsError):
        save_checkpoint(ckpt, state)
    restored = restore_checkpoint(ckpt, trainer.init_state(7))
    _assert_states_equal(state, restored)
    # Both continue identically.
    state, _ = trainer.train_step(state, jax_ref["batch"])
    restored, _ = trainer.train_step(restored, jax_ref["batch"])
    _assert_states_equal(state, restored)


def test_checkpoint_keeps_the_newest(tmp_path):
    trainer = Trainer(tiny(), "cpu")
    state = trainer.init_state(1)
    ckpt = str(tmp_path / "ckpt")
    for step in (3, 5, 8):
        state.step = step
        save_checkpoint(ckpt, state, keep=2)
    assert sorted(int(d) for d in __import__("os").listdir(ckpt)) == [5, 8]
    assert latest_step(ckpt) == 8
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), state)


def test_warm_start_grows_two_to_three_blocks(jax_ref, tmp_path):
    trainer, state = _port(jax_ref)
    state, _ = trainer.train_step(state, jax_ref["batch"])
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, state)

    big = Trainer(tiny(num_resblock=3), "cpu")
    fresh = big.init_state(9)
    conv1_init = fresh.generator.resblocks[2].conv_1.weight.detach().clone()
    grown = warm_start(big.init_state(9), ckpt)
    assert grown.step == 0 and not grown.gen_opt.state_dict()["state"]
    new = grown.generator.resblocks[2]
    assert not new.conv_2.weight.any() and not new.conv_2.bias.any()
    assert torch.equal(new.conv_1.weight, conv1_init)
    for k, v in state.fnet.state_dict().items():
        assert torch.equal(grown.fnet.state_dict()[k], v)
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 8, 8, 51).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(grown.generator(x), state.generator(x), rtol=0, atol=0)


def test_warm_start_rejects_wrong_models(jax_ref, tmp_path):
    trainer, state = _port(jax_ref)
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, state)
    narrow = Trainer(tiny(gen_channels=32), "cpu").init_state(1)
    with pytest.raises(ValueError, match="shape mismatch"):
        warm_start(narrow, ckpt)
    with pytest.raises(ValueError, match="no overlapping"):
        merge_partial_restore({"a": torch.zeros(1)}, {"b": torch.zeros(1)},
                              "generator", "test", zero_missing=True)


def test_params_npz_loads_in_jax(jax_ref, tmp_path):
    trainer, state = _port(jax_ref)
    state, _ = trainer.train_step(state, jax_ref["batch"])
    gen_tree, fnet_tree = to_jax_params(state.generator, state.fnet)
    path = str(tmp_path / "params.npz")
    params_to_npz(path, generator=gen_tree, fnet=fnet_tree)
    loaded = npz_to_params(path, {"generator": jax_ref["init"][0],
                                  "fnet": jax_ref["init"][1]})
    for tree, want in ((loaded["generator"], gen_tree), (loaded["fnet"], fnet_tree)):
        for layer, leaves in want.items():
            for leaf, arr in leaves.items():
                np.testing.assert_array_equal(np.asarray(tree[layer][leaf]), arr)
    gen2, fnet2 = from_jax_params(gen_tree, fnet_tree)
    for a, b in ((state.generator, gen2), (state.fnet, fnet2)):
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k])
