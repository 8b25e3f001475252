"""The port's TecoGAN modules and trainer against the JAX package, float32
on the CPU: the discriminator (outputs, block activations, running
statistics), VGG19 and its npz loader, the box warp, the VGG and
discriminator losses, the discriminator's input assembly, one TecoGAN step
with the gate open and closed (every metric, gradient and parameter after
Adam, the discriminator's statistics, the gate's EMA and counters), the
pure-Dt and non-ping-pong steps, the constructor's guards, the GAN
checkpoints and the TF npz's discriminator trees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxConfig
from tecogan_tpu.models import Discriminator as JaxDiscriminator
from tecogan_tpu.models.vgg19 import VGG19Features as JaxVGG19
from tecogan_tpu.models.vgg19 import vgg19_normalized_features as jax_vgg_features
from tecogan_tpu.ops.warp import dense_image_warp_box as jax_warp_box
from tecogan_tpu.train import Trainer as JaxTrainer
from tecogan_tpu.train import TrainState as JaxTrainState
from tecogan_tpu.train import losses as jax_losses
from tecogan_tpu.train.checkpoint import convert_tf_npz as jax_convert_tf_npz
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.models import Discriminator
from tecogan_tpu_torch.models.layers import glorot_init_
from tecogan_tpu_torch.models.vgg19 import (
    ALL_KEYS,
    load_vgg19_npz,
    random_vgg19,
    vgg19_normalized_features,
)
from tecogan_tpu_torch.ops import dense_image_warp_box
from tecogan_tpu_torch.train import Trainer, losses
from tecogan_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
    warm_start,
    warm_start_tf_npz,
)
from tecogan_tpu_torch.weights import (
    _fnet_layers,
    _generator_layers,
    _tree,
    convert_tf_npz,
    discriminator_from_jax,
    discriminator_to_jax,
    from_jax_params,
    to_jax_params,
    vgg19_from_jax,
)
from tests.test_tf_semantics import make_fake_checkpoint, np_discriminator_forward

torch.set_num_threads(1)

# As tests/test_torch_train.py: metric scalars rtol 1e-5 (float32 sums in
# another order; the uint8 batch divided where XLA multiplies by the
# reciprocal); gradients within 1e-4 of each leaf's largest entry; the
# parameters after one Adam step (lr 1e-3) within 1e-6 wherever the
# gradient stands clear of zero (above 1e-3 of the leaf's largest entry).
METRIC_RTOL, GRAD_RTOL, PARAM_ATOL, GRAD_MASK = 1e-5, 1e-4, 1e-6, 1e-3
# Activations of modules and ops, relative to the output's scale: float32
# convs and sums in another order (the batch norm's E[x^2] - E[x]^2
# variance loses a few more bits; measured 1.0e-5 of scale).
ACT_ATOL = 2e-5
# Running statistics, relative to max(1, their scale): 0.9 * old + 0.1 * a
# batch mean or variance of float32 activations summed in another order.
STATS_TOL = 1e-5

# adam_eps 1e-12: Adam's first update is lr * g / (|g| + eps); FNet's
# gradients here are ~1e-5, and near |g| ~ 1e-8 the default eps would make
# the update follow a gradient's last bits.
TINY = dict(num_resblock=2, crop_size=8, batch_size=2, rnn_n=4, learning_rate=1e-3,
            adam_eps=1e-12, remat_generator=False, ratio=0.01, pingpong=True,
            pp_scaling=0.5, d_layerloss=True, vgg_scaling=-0.002)


# The TecoGAN step of the parity test: VGG on; the ping-pong extension on
# with its L1 term's weight 0. The L1 terms (ping-pong, the discriminator's
# layer loss) have a kink where their two sides tie, and a tie closer than
# the two packages' rounding flips a sign and moves a gradient by up to
# ~1e-3 of its scale (as the warp's cell boundaries do, hence FNet's bias
# below). The ping-pong halves nearly agree, so their ties are dense; the
# layer loss at this batch has none. tests/test_torch_grads.py holds the
# ping-pong loss's gradient.
STEP = {**TINY, "vgg_scaling": 0.2, "pp_scaling": 0.0}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), jax.device_get(tree))


def _noisy(tree, rng, scale=0.05):
    """flax init plus seeded noise, so biases are non-zero too."""
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + (rng.randn(*np.shape(p)) * scale).astype(np.float32),
        jax.device_get(tree))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=ACT_ATOL, err_msg=""):
    """max|got - want| <= tol * max(1, max|want|)."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=err_msg)


# ----------------------------------------------------------- discriminator
@pytest.mark.parametrize("channels,size", [(27, 32), (9, 24), (9, 22)],
                         ids=["dst27", "dt9", "odd"])
def test_discriminator_matches_jax(channels, size):
    """Outputs, the four block activations and the running statistics
    after one update; 22 px reaches the odd sizes 11 and 3 in the blocks
    (TF SAME pads one more at the bottom and right there)."""
    rng = np.random.RandomState(channels + size)
    x = rng.rand(3, size, size, channels).astype(np.float32)
    params, stats = (_noisy(t, rng) for t in discriminator_to_jax(
        glorot_init_(Discriminator(channels), torch.Generator().manual_seed(1))))
    (want, want_layers), new = JaxDiscriminator().apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), mutable=["batch_stats"])
    disc = discriminator_from_jax(params, stats)
    got, got_layers = disc(_t(x))
    for g, w in zip([got, *got_layers], [want, *want_layers]):
        _close(g, w)
    # The forward without update_stats kept the statistics; with it they
    # move as flax's do (decay 0.9, the biased variance).
    _, kept = discriminator_to_jax(disc)
    jax.tree_util.tree_map(np.testing.assert_array_equal, kept, stats)
    disc(_t(x), update_stats=True)
    _, moved = discriminator_to_jax(disc)
    jax.tree_util.tree_map(lambda a, b: _close(a, b, STATS_TOL),
                           moved, _np(new["batch_stats"]))
    back_params, _ = discriminator_to_jax(disc)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back_params, params)


# ------------------------------------------------------------------- VGG19
@pytest.fixture(scope="module")
def vgg_params():
    """Seeded glorot VGG19 weights (the port's ``random_vgg19``; flax's init
    of the same takes seconds more) with noise on every leaf, as a flax
    tree. VGG's ReLUs are kinks too: a pre-activation within the packages'
    rounding of zero flips a gradient path. Of the draws 3-8, five move
    a generator gradient by 1e-4-5e-4 of its scale in the step below; draw
    8 has no such tie (1.3e-5)."""
    return _noisy(_tree(random_vgg19(8).convs.items()), np.random.RandomState(8), 0.01)


def test_vgg_features_match_jax(vgg_params):
    """Every post-ReLU endpoint, and the normalised features of the loss."""
    x = np.random.RandomState(4).rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
    vgg = vgg19_from_jax(vgg_params)
    assert not any(p.requires_grad for p in vgg.parameters())
    want = JaxVGG19().apply({"params": vgg_params}, jnp.asarray(x * 127.5))
    got = vgg(_t(x * 127.5), ALL_KEYS)
    assert list(got) == list(ALL_KEYS)
    for k in ALL_KEYS:
        _close(got[k], want[k], err_msg=k)
    want_n = jax_vgg_features(JaxVGG19().apply, vgg_params, jnp.asarray(x))
    got_n = vgg19_normalized_features(vgg, _t(x))
    assert list(got_n) == list(want_n)
    for k in want_n:
        _close(got_n[k], want_n[k], err_msg=k)


def test_load_vgg19_npz_reads_tf_names(vgg_params, tmp_path):
    path = str(tmp_path / "vgg_19.npz")
    np.savez(path, **{f"vgg_19/conv{k[4]}/{k}/{leaf}": vgg_params[k][name]
                      for k in ALL_KEYS for leaf, name in (("weights", "kernel"),
                                                           ("biases", "bias"))})
    vgg = load_vgg19_npz(path)
    want = vgg19_from_jax(vgg_params)
    for a, b in zip(vgg.state_dict().values(), want.state_dict().values()):
        assert torch.equal(a, b)
    a = random_vgg19(5).state_dict()
    for k, v in random_vgg19(5).state_dict().items():
        assert torch.equal(v, a[k])


# -------------------------------------------------------- ops and losses
def test_dense_image_warp_box_matches_jax():
    rng = np.random.RandomState(6)
    image = rng.rand(3, 20, 24, 5).astype(np.float32)
    flow = (rng.randn(3, 9, 11, 2) * 6).astype(np.float32)  # queries leave the box
    want = jax_warp_box(jnp.asarray(image), jnp.asarray(flow), (4, 7))
    img = _t(image).requires_grad_()
    got = dense_image_warp_box(img, _t(flow), (4, 7))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    cot = rng.randn(*got.shape).astype(np.float32)
    (g,) = torch.autograd.grad(got, img, _t(cot))
    gw = jax.grad(lambda i: jnp.sum(jax_warp_box(i, jnp.asarray(flow), (4, 7)) * cot))(
        jnp.asarray(image))
    np.testing.assert_allclose(g.numpy(), np.asarray(gw), rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        dense_image_warp_box(img, _t(flow), (12, 0))


def test_vgg_cosine_and_d_layer_losses_match_jax():
    rng = np.random.RandomState(7)
    feats = [{k: rng.randn(2, s, s, c).astype(np.float32) for k, s, c in
              (("a", 8, 4), ("b", 4, 6))} for _ in range(2)]
    want_total, want_layers = jax_losses.vgg_cosine_loss(
        *[{k: jnp.asarray(v) for k, v in f.items()} for f in feats])
    got_total, got_layers = losses.vgg_cosine_loss(
        *[{k: _t(v) for k, v in f.items()} for f in feats])
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=METRIC_RTOL)
    np.testing.assert_allclose([float(v) for v in got_layers],
                               [float(v) for v in want_layers], rtol=METRIC_RTOL)
    layers = [[rng.randn(2, s, s, c).astype(np.float32) for s, c in
               ((16, 64), (8, 64), (4, 128), (2, 256))] for _ in range(2)]
    norms = (12.0, 14.0, 24.0, 100.0)
    want_sum, want_raw = jax_losses.d_layer_losses(
        *[[jnp.asarray(a) for a in ls] for ls in layers], norms, 0.02)
    got_sum, got_raw = losses.d_layer_losses(*[[_t(a) for a in ls] for ls in layers],
                                             norms, 0.02)
    np.testing.assert_allclose(float(got_sum), float(want_sum), rtol=METRIC_RTOL)
    np.testing.assert_allclose([float(v) for v in got_raw], [float(v) for v in want_raw],
                               rtol=METRIC_RTOL)


@pytest.mark.parametrize("dt_mergeDs,crop_dt,pingpong", [
    (True, 0.75, True), (True, 1.0, True), (False, 0.75, True), (True, 0.75, False)],
    ids=["dst", "dst-nocrop", "pure-dt", "no-pingpong"])
def test_assemble_dst_inputs_matches_jax(dt_mergeDs, crop_dt, pingpong):
    """Real and fake inputs and the gradient into the generated frames, for
    the parameters of tests/test_train.py:230,347 and the non-ping-pong
    route, whose backward flows are passed in. Flows of 6 px send box
    queries outside the box."""
    rng = np.random.RandomState(8)
    cfg = dict(num_resblock=2, crop_size=8, batch_size=2, rnn_n=4, ratio=0.01,
               pingpong=pingpong, dt_mergeDs=dt_mergeDs, crop_dt=crop_dt,
               d_layerloss=dt_mergeDs)
    b, h, t = 2, 8, 7 if pingpong else 6
    r_inputs = rng.rand(b, t, h, h, 3).astype(np.float32)
    r_targets = rng.rand(b, t, 4 * h, 4 * h, 3).astype(np.float32) * 2 - 1
    gen = rng.rand(b, t, 4 * h, 4 * h, 3).astype(np.float32) * 2 - 1
    flow = (rng.randn(b, t - 1, 4 * h, 4 * h, 2) * 6).astype(np.float32)
    back = None if pingpong else (rng.randn(b, t // 3, 4 * h, 4 * h, 2) * 6).astype(np.float32)
    cot = rng.randn(2 * b * (t // 3) * (4 * h) ** 2 * 27).astype(np.float32)

    def jax_fn(g):
        real, fake = jax_losses.assemble_dst_inputs(
            jnp.asarray(r_inputs), jnp.asarray(r_targets), g, jnp.asarray(flow),
            JaxConfig(**cfg), None if back is None else jnp.asarray(back))
        return real, fake

    want = jax_fn(jnp.asarray(gen))
    g = _t(gen).requires_grad_()
    got = losses.assemble_dst_inputs(_t(r_inputs), _t(r_targets), g, _t(flow),
                                     TecoConfig(**cfg), None if back is None else _t(back))
    for a, w in zip(got, want):
        assert a.shape == w.shape
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w), rtol=0, atol=1e-6)
    n = got[1].numel()
    (grad,) = torch.autograd.grad(got[1], g, _t(cot[:n].reshape(got[1].shape)))
    want_grad = jax.grad(lambda x: jnp.sum(jax_fn(x)[1] * cot[:n].reshape(want[1].shape)))(
        jnp.asarray(gen))
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=0, atol=1e-5)


# --------------------------------------------------------------- the step
def _jax_state(tr, cfg):
    """A JAX TrainState at the port's seeded glorot init (flax's jitted
    init takes ~25 s to compile on one core; the weights are the same on
    both sides either way), with FNet's output bias set as in
    tests/test_torch_train.py's fixture and its output conv scaled by 0.1
    as in chip_smoke.py's phase 7, so every flow sits mid-cell."""
    init = Trainer(cfg.replace(vgg_scaling=-1.0), "cpu").init_state(0)  # VGG is not drawn
    gen, fnet = to_jax_params(init.generator, init.fnet)
    fnet["output_conv2"]["bias"] = np.asarray([0.015625, -0.026], np.float32)
    fnet["output_conv2"]["kernel"] *= np.float32(0.1)
    d_params, d_stats = discriminator_to_jax(init.discriminator)
    zero = np.zeros((), np.int32)
    return JaxTrainState(
        step=zero, gen_params=gen, fnet_params=fnet, gen_opt=tr.gen_tx.init(gen),
        fnet_opt=tr.fnet_tx.init(fnet), d_params=d_params, d_batch_stats=d_stats,
        d_opt=tr.d_tx.init(d_params), ema_tbalance=np.zeros((), np.float32),
        counter_with_d=zero, counter_wo_d=zero,
        ema_losses={k: np.zeros((), np.float32) for k in tr._telemetry_keys()})


def _batch(cfg, seed=5):
    rng = np.random.RandomState(seed)
    return (rng.rand(cfg.batch_size, cfg.rnn_n, cfg.hr_load_size, cfg.hr_load_size, 3)
            * 255).astype(np.uint8)


def _copy_state(state, ema):
    return jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), state).replace(
        ema_tbalance=jnp.asarray(ema, jnp.float32))


def _first_moment_grads(opt_state, b1):
    """A gradient from Adam's first moment after the first update, mu = (1 -
    b1) g: within a float32 rounding of g."""
    return jax.tree_util.tree_map(lambda m: np.asarray(m) / np.float32(1 - b1), opt_state[0].mu)


@pytest.fixture(scope="module")
def jax_gan(vgg_params):
    """The JAX trainer's TecoGAN step (ping-pong, layer loss, VGG) from one
    init on one uint8 batch, with the gate forced open (EMA -100) and
    closed (+100): the states and metrics after it, and the gradients of G,
    FNet and D (from the open step's Adam moments)."""
    cfg = JaxConfig(**STEP)
    tr = JaxTrainer(cfg, vgg_params=vgg_params)
    state = _jax_state(tr, TecoConfig(**STEP))
    out = dict(init=_np(state), batch=_batch(cfg))
    for gate, ema in (("open", -100.0), ("closed", 100.0)):
        new, metrics = tr.train_step(_copy_state(state, ema), jnp.asarray(out["batch"]))
        out[gate] = dict(state=_np(new), metrics={k: float(v) for k, v in metrics.items()})
    new = out["open"]["state"]
    out["grads"] = tuple(_first_moment_grads(opt, cfg.beta1)
                         for opt in (new.gen_opt, new.fnet_opt, new.d_opt))
    return out


def _port_state(init, cfg, vgg_params=None):
    trainer = Trainer(cfg, "cpu", vgg=None if vgg_params is None else vgg19_from_jax(vgg_params))
    state = trainer.state_from_modules(
        *from_jax_params(init.gen_params, init.fnet_params),
        discriminator_from_jax(init.d_params, init.d_batch_stats))
    return trainer, state


def _grad_trees(state):
    def tree(layers):
        return {name: {"kernel": m.weight.grad.permute(2, 3, 1, 0).numpy(),
                       "bias": m.bias.grad.numpy()} for name, m in layers}
    disc = {}
    d = state.discriminator
    disc["input_stage_conv"] = {"kernel": d.input_stage_conv.weight.grad.permute(2, 3, 1, 0).numpy(),
                                "bias": d.input_stage_conv.bias.grad.numpy()}
    for idx, block in zip((1, 3, 5, 7), d.blocks):
        disc[f"disblock_{idx}_conv"] = {"kernel": block.conv.weight.grad.permute(2, 3, 1, 0).numpy()}
        disc[f"disblock_{idx}_bn"] = {"bn": {"bias": block.bn.bias.grad.numpy()}}
    disc["dense"] = {"kernel": d.dense.weight.grad[:, :, 0, 0].t().numpy(),
                     "bias": d.dense.bias.grad.numpy()}
    return (tree(_generator_layers(state.generator)), tree(_fnet_layers(state.fnet)), disc)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _check_params(got_trees, want_trees, grad_trees):
    """Parameters after Adam: within PARAM_ATOL where |g| > GRAD_MASK of the
    leaf's largest entry."""
    for got, want, grads in zip(got_trees, want_trees, grad_trees):
        for (path, g), (_, a), (_, w) in zip(_leaves(grads), _leaves(got), _leaves(want)):
            mask = np.abs(g) > GRAD_MASK * np.abs(g).max()
            assert mask.any(), path
            diff = np.abs(a - w)[mask]
            assert diff.max() <= PARAM_ATOL, (path, diff.max())


def _port_trees(state):
    return (*to_jax_params(state.generator, state.fnet), discriminator_to_jax(state.discriminator)[0])


def _metric_atol(k, want):
    """t_balance = mean(log D(real)) + adv is a difference of two ~0.6
    terms, held to METRIC_RTOL of them; a VGG loss is 1 - a mean cosine
    near 0.9, held to METRIC_RTOL of 1."""
    if k == "t_balance":
        return 2 * METRIC_RTOL * abs(want["t_adversarial_loss"])
    return METRIC_RTOL if k.startswith("vgg_") else 0.0


def _check_metrics(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), w, rtol=METRIC_RTOL,
                                   atol=_metric_atol(k, want), err_msg=k)


@pytest.mark.parametrize("gate", ["open", "closed"])
def test_tecogan_step_matches_jax(jax_gan, vgg_params, gate):
    ref = jax_gan[gate]
    cfg = TecoConfig(**STEP)
    trainer, state = _port_state(jax_gan["init"], cfg, vgg_params)
    state.ema_tbalance = torch.tensor(-100.0 if gate == "open" else 100.0)
    d_before = {k: v.clone() for k, v in state.discriminator.state_dict().items()}
    if gate == "open":  # the eval metrics at init are the step's
        evals = trainer.eval_step(state, jax_gan["batch"])
        assert set(evals) == set(ref["metrics"]) - {"learning_rate", "t_balance"}
        _check_metrics(evals, {k: v for k, v in ref["metrics"].items() if k in evals})
        for k, v in state.discriminator.state_dict().items():
            assert torch.equal(v, d_before[k]), k  # eval updates no statistic
    state, metrics = trainer.train_step(state, jax_gan["batch"])
    _check_metrics(metrics, ref["metrics"])
    grads = _grad_trees(state)
    for got, want in zip(grads, jax_gan["grads"]):
        for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
            scale = np.abs(w).max()
            err = np.abs(g - w).max()
            assert err <= GRAD_RTOL * scale, (path, err, scale)
    new = ref["state"]
    _check_params(_port_trees(state)[:2], (new.gen_params, new.fnet_params), grads[:2])
    d_params, d_stats = discriminator_to_jax(state.discriminator)
    if gate == "open":
        _check_params([d_params], [new.d_params], grads[2:])
        assert int(state.d_opt.count) == 1
    else:  # bit-unchanged, Adam's count and moments too
        jax.tree_util.tree_map(np.testing.assert_array_equal, d_params, jax_gan["init"].d_params)
        jax.tree_util.tree_map(np.testing.assert_array_equal, d_params, new.d_params)
        assert int(state.d_opt.count) == 0
        assert not any(m.any() for m in state.d_opt.mu + state.d_opt.nu)
    # The running statistics move in both gate states, as the JAX package's.
    jax.tree_util.tree_map(lambda a, b: _close(a, b, STATS_TOL),
                           d_stats, new.d_batch_stats)
    assert any(not torch.equal(v, state.discriminator.state_dict()[k])
               for k, v in d_before.items() if "running" in k)
    np.testing.assert_allclose(float(state.ema_tbalance), float(new.ema_tbalance), rtol=1e-6)
    assert (int(state.counter_with_d), int(state.counter_wo_d)) == (
        int(new.counter_with_d), int(new.counter_wo_d)) == ((1, 0) if gate == "open" else (0, 1))
    for k, v in state.ema_losses.items():  # 0.01 x the metric
        np.testing.assert_allclose(float(v), float(new.ema_losses[k]), rtol=METRIC_RTOL,
                                   atol=0.01 * _metric_atol(k, ref["metrics"]), err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(dt_mergeDs=False, d_layerloss=False, crop_dt=0.75, rnn_n=2),
    dict(pingpong=False, rnn_n=3)], ids=["pure-dt", "no-pingpong"])
def test_gan_step_variants_match_jax(kw):
    """The pure temporal Dt (9 cropped channels) and the non-ping-pong step
    (backward flows from FNet), one triplet each, no VGG: the step's metrics
    against the JAX package's eval step (its forward; the update is the
    main step's), then the discriminator's first Adam move, lr * sign(g)
    where |g| stands clear of eps, at 0.3 x lr for the pure Dt."""
    cfg_kw = {**TINY, **kw}
    cfg = TecoConfig(**cfg_kw)
    tr = JaxTrainer(JaxConfig(**cfg_kw))
    state = _jax_state(tr, cfg)
    batch = _batch(cfg, seed=9)
    want = {k: float(v) for k, v in tr.eval_step(state, jnp.asarray(batch)).items()}
    trainer, port = _port_state(_np(state), cfg)
    d_before = [p.detach().clone() for p in port.discriminator.parameters()]
    port, metrics = trainer.train_step(port, batch)
    assert set(metrics) == set(want) | {"learning_rate", "t_balance"}
    _check_metrics({k: metrics[k] for k in want}, want)
    pure = not cfg.dt_mergeDs
    assert port.discriminator.input_stage_conv.in_channels == (9 if pure else 27)
    lr_d = cfg.learning_rate * (0.3 if pure else 1.0)
    for p, p0 in zip(port.discriminator.parameters(), d_before):
        clear = p.grad.abs() > 1e3 * cfg.adam_eps
        assert clear.any()
        step = (p.detach() - p0)[clear]
        torch.testing.assert_close(step, -lr_d * p.grad.sign()[clear], rtol=1e-3, atol=1e-8)
    assert (int(port.counter_with_d), int(port.d_opt.count)) == (1, 1)


def test_constructor_guards():
    """As tests/test_train.py:173,316: VGG weights are required, the pure Dt
    has no layer loss; a compute dtype other than float32 and bfloat16 is
    refused; the discriminator must take the channels the configuration
    feeds it."""
    with pytest.raises(ValueError, match="VGG19 weights"):
        Trainer(TecoConfig(**{**TINY, "vgg_scaling": 0.2}), "cpu")
    with pytest.raises(ValueError, match="d_layerloss"):
        Trainer(TecoConfig(**{**TINY, "dt_mergeDs": False}), "cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        Trainer(TecoConfig(**{**TINY, "compute_dtype": "float16"}), "cpu")
    trainer = Trainer(TecoConfig(**TINY), "cpu")
    gen_fnet = trainer.init_state(0)
    with pytest.raises(ValueError, match="9 channels"):
        trainer.state_from_modules(gen_fnet.generator, gen_fnet.fnet, Discriminator(9))
    with pytest.raises(ValueError, match="needs a discriminator"):
        trainer.state_from_modules(gen_fnet.generator, gen_fnet.fnet)


def test_d_learning_rate_follows_its_own_count():
    """optax's schedule reads the optimizer's count, which a closed gate
    holds: the discriminator's rate decays with its own updates, x0.3 for
    the pure Dt (tecogan_tpu/train/trainer.py:165-171)."""
    import optax

    for kw in (dict(decay_step=4, decay_rate=0.5), dict(decay_step=4, decay_rate=0.5, stair=True),
               dict(dt_mergeDs=False, d_layerloss=False), dict(decay_step=0)):
        cfg = TecoConfig(**{**TINY, **kw})
        trainer = Trainer(cfg, "cpu")
        sched = optax.exponential_decay(cfg.learning_rate, cfg.decay_step, cfg.decay_rate,
                                        staircase=cfg.stair)
        for count in (0, 1, 3, 6):
            want = float(sched(count)) * (1.0 if cfg.dt_mergeDs else 0.3)
            got = float(trainer.d_lr_schedule(torch.tensor(count, dtype=torch.int32)))
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str((kw, count)))


# ------------------------------------------------------------ checkpoints
def _tiny_gan(**kw):
    return Trainer(TecoConfig(**{**TINY, **kw}), "cpu")


def test_gan_checkpoint_round_trip(tmp_path):
    """Save after a step with the gate open and one closed, resume into a
    fresh state: weights, running statistics, both Adam states, the EMAs
    and the counters come back, and both continue identically."""
    trainer = _tiny_gan()
    state = trainer.init_state(3)
    batch = _batch(trainer.config, seed=11)
    state, _ = trainer.train_step(state, batch)
    state.ema_tbalance = torch.tensor(5.0)
    state, _ = trainer.train_step(state, batch)
    assert (int(state.counter_with_d), int(state.counter_wo_d), int(state.d_opt.count)) == (1, 1, 1)
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, state)
    restored = restore_checkpoint(ckpt, trainer.init_state(8))
    for a, b in ((state, restored),):
        assert a.step == b.step == 2
        for ma, mb in ((a.generator, b.generator), (a.fnet, b.fnet),
                       (a.discriminator, b.discriminator)):
            for k, v in ma.state_dict().items():
                assert torch.equal(v, mb.state_dict()[k]), k
        for x, y in zip([a.d_opt.count, *a.d_opt.mu, *a.d_opt.nu, a.ema_tbalance,
                         a.counter_with_d, a.counter_wo_d],
                        [b.d_opt.count, *b.d_opt.mu, *b.d_opt.nu, b.ema_tbalance,
                         b.counter_with_d, b.counter_wo_d]):
            assert torch.equal(x, y)
    state.ema_tbalance = restored.ema_tbalance = torch.tensor(-1.0)
    state, m1 = trainer.train_step(state, batch)
    restored, m2 = trainer.train_step(restored, batch)
    assert {k: float(v) for k, v in m1.items()} == {k: float(v) for k, v in m2.items()}
    for p, q in zip(state.discriminator.parameters(), restored.discriminator.parameters()):
        assert torch.equal(p, q)


def test_warm_start_frvsr_into_tecogan(tmp_path):
    """Reference case 3: a 2-block FRVSR run seeds a 3-block TecoGAN; the
    grown block is an identity, the discriminator keeps its fresh init (the
    FRVSR checkpoint has none); a TecoGAN checkpoint warm-starts the
    discriminator with its statistics."""
    frvsr = Trainer(TecoConfig(**{**TINY, "ratio": -0.01}), "cpu")
    fstate = frvsr.init_state(1)
    fstate, _ = frvsr.train_step(fstate, _batch(frvsr.config))
    ckpt = str(tmp_path / "frvsr")
    save_checkpoint(ckpt, fstate)

    gan = _tiny_gan(num_resblock=3)
    fresh_d = {k: v.clone() for k, v in gan.init_state(4).discriminator.state_dict().items()}
    grown = warm_start(gan.init_state(4), ckpt)
    assert grown.step == 0 and int(grown.counter_with_d) == 0
    assert not grown.generator.resblocks[2].conv_2.weight.any()
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 8, 8, 51).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(grown.generator(x), fstate.generator(x), rtol=0, atol=0)
    for k, v in grown.discriminator.state_dict().items():
        assert torch.equal(v, fresh_d[k]), k

    grown, _ = gan.train_step(grown, _batch(gan.config))
    save_checkpoint(str(tmp_path / "gan"), grown)
    again = warm_start(gan.init_state(6), str(tmp_path / "gan"))
    for k, v in grown.discriminator.state_dict().items():
        assert torch.equal(again.discriminator.state_dict()[k], v), k
    skipped = warm_start(gan.init_state(6), str(tmp_path / "gan"), include_discriminator=False)
    assert not torch.equal(skipped.discriminator.dense.weight, grown.discriminator.dense.weight)


def test_tf_npz_discriminator_trees_and_warm_start(tmp_path):
    """The TF npz's tdiscriminator trees: the JAX converter's, the JAX
    discriminator's outputs and TF-slim semantics in numpy; then
    warm_start_tf_npz grows the npz's 2-block generator into 3 blocks and
    loads the discriminator with its moving statistics."""
    rng = np.random.RandomState(12)
    data = make_fake_checkpoint(rng, num_resblock=2)
    path = str(tmp_path / "tf.npz")
    np.savez(path, **data)
    got, want = convert_tf_npz(path, num_resblock=None), jax_convert_tf_npz(path, 2)
    assert set(got) == set(want) == {"generator", "fnet", "discriminator",
                                     "discriminator_batch_stats"}
    for name in ("discriminator", "discriminator_batch_stats"):
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
                               got[name], want[name])
    x = rng.rand(2, 32, 32, 27).astype(np.float32)
    disc = discriminator_from_jax(got["discriminator"], got["discriminator_batch_stats"])
    out, layers = disc(_t(x))
    (jout, jlayers), _ = JaxDiscriminator().apply(
        {"params": want["discriminator"], "batch_stats": want["discriminator_batch_stats"]},
        jnp.asarray(x), mutable=["batch_stats"])
    np_out, np_layers = np_discriminator_forward(data, x)
    for g, j, n in zip([out, *layers], [jout, *jlayers], [np_out, *np_layers]):
        _close(g, j)
        _close(g, n)

    trainer = _tiny_gan(num_resblock=3, gen_channels=64)
    state = warm_start_tf_npz(trainer.init_state(2), path)
    assert state.step == 0
    loaded = state.discriminator.blocks[0].bn.running_var
    np.testing.assert_array_equal(
        loaded.numpy(), data["tdiscriminator/discriminator_unit/disblock_1/BatchNorm/moving_variance"])
    assert not state.generator.resblocks[2].conv_2.weight.any()
    np.testing.assert_array_equal(
        state.generator.resblocks[1].conv_1.weight.detach().permute(2, 3, 1, 0).numpy(),
        data["generator/generator_unit/resblock_2/conv_1/Conv/weights"])
    via_dir = warm_start(trainer.init_state(2), path)  # warm_start takes the npz too
    assert torch.equal(via_dir.discriminator.dense.weight, state.discriminator.dense.weight)
