"""Gradients of the port against the JAX package, float32 on the CPU: K2
(the upsample's adjoint) against ``jax.vjp`` of the Pallas kernel in
interpret mode, the chain's autograd Function against ``jax.vjp`` of
``resblock_chain``, and the training ops, losses and unroll against
``jax.grad``. On the CPU the kernel wrappers run their plain versions; the
CUDA kernels are held to those by ``tests/test_torch_cuda.py``."""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

import tecogan_tpu.kernels.resblocks as jax_chain
import tecogan_tpu.kernels.upsample4 as jax_up
from tecogan_tpu.config import TecoConfig as JaxConfig
from tecogan_tpu.models import FNet as JaxFNet
from tecogan_tpu.models import Generator as JaxGenerator
from tecogan_tpu.ops import dense_image_warp as jax_warp
from tecogan_tpu.ops import gauss_down_by4 as jax_gauss
from tecogan_tpu.recurrent import step as jax_step
from tecogan_tpu.train import losses as jax_losses
from tecogan_tpu.train.trainer import lr_schedule as jax_lr_schedule
from tecogan_tpu.train.trainer import prepare_batch as jax_prepare_batch
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.kernels import resblock_chain, upsample4, upsample4_bwd_plain
from tecogan_tpu_torch.ops import dense_image_warp, gauss_down_by4
from tecogan_tpu_torch.recurrent import (
    extend_pingpong,
    flows_for_sequence,
    unroll_generator,
)
from tecogan_tpu_torch.train import losses, lr_schedule, prepare_batch
from tecogan_tpu_torch.weights import _fnet_layers, _generator_layers, from_jax_params

torch.set_num_threads(1)

# K2: sums of 16-64 float32 products of O(1) values, times alpha <= 4.
K2_ATOL = 1e-5
# Gradients: float32 convolutions in another summation order, through a few
# layers; relative to each gradient's largest entry.
GRAD_RTOL = 1e-4
# Forward values of ops and losses: a few float32 ulps of O(1) values.
FWD_ATOL = 1e-5


def _interpret(module):
    return mock.patch.object(module.pl, "pallas_call",
                             functools.partial(pl.pallas_call, interpret=True))


def _close_to_max(got, want, rtol=GRAD_RTOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    assert scale > 0, f"{what}: zero reference gradient"
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


@pytest.mark.parametrize("shape", [(2, 12, 16, 3), (1, 7, 13, 2), (2, 1, 3, 2)],
                         ids=["even", "ragged", "tiny"])
@pytest.mark.parametrize("alpha", [1.0, 4.0])
@pytest.mark.parametrize("filt", ["bilinear", "bicubic"])
def test_k2_matches_pallas_vjp(filt, alpha, shape, rng):
    """The plain K2 and the upsample Function's CPU backward against the VJP
    of ``_upsample4_pallas`` (``_upsample4_bwd`` -> ``_plane_call_down``)."""
    b, h, w, c = shape
    x = rng.rand(*shape).astype(np.float32)
    g = (rng.randn(b, 4 * h, 4 * w, c) * 0.5).astype(np.float32)
    with _interpret(jax_up):
        _, vjp = jax.vjp(lambda v: jax_up._upsample4_pallas(v * alpha, filt),
                         jnp.asarray(x))
        want = np.asarray(vjp(jnp.asarray(g))[0])
    plain = upsample4_bwd_plain(torch.from_numpy(g), filt, alpha).numpy()
    np.testing.assert_allclose(plain, want, rtol=0, atol=K2_ATOL)
    xt = torch.from_numpy(x).requires_grad_()
    out = upsample4(xt, filt, alpha)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0, atol=K2_ATOL)


def test_upsample_backward_skipped_for_data():
    """A skip over data (no input needs a gradient) runs no backward."""
    x = torch.rand(1, 4, 5, 3)
    w = torch.rand(1, 16, 20, 3, requires_grad=True)
    (upsample4(x, "bicubic") * w).sum().backward()
    assert x.grad is None and w.grad is not None


def test_chain_function_grads_match_jax(rng):
    """CPU gradients of every input against ``jax.vjp`` of the JAX chain
    (its XLA-replay backward)."""
    c, n = 8, 2
    arrays = [(rng.rand(2, 9, 13, c) - 0.5).astype(np.float32),
              (rng.randn(n, 3, 3, c, c) * 0.1).astype(np.float32),
              (rng.randn(n, c) * 0.1).astype(np.float32),
              (rng.randn(n, 3, 3, c, c) * 0.1).astype(np.float32),
              (rng.randn(n, c) * 0.1).astype(np.float32)]
    g = rng.randn(2, 9, 13, c).astype(np.float32)
    out_j, vjp = jax.vjp(jax_chain.resblock_chain, *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = resblock_chain(*ts)
    assert out.grad_fn is not None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=FWD_ATOL)
    out.backward(torch.from_numpy(g))
    for name, t, w in zip(("x", "w1", "b1", "w2", "b2"), ts, want):
        _close_to_max(t.grad.numpy(), w, what=name)


def test_gauss_down_by4_matches_jax(rng):
    hr = rng.rand(3, 40, 44, 3).astype(np.float32)
    want = np.asarray(jax_gauss(jnp.asarray(hr), 1.5))
    got = gauss_down_by4(torch.from_numpy(hr), 1.5).numpy()
    assert got.shape == want.shape == (3, 8, 9, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("as_uint8", [False, True], ids=["float", "uint8"])
def test_prepare_batch_matches_jax(as_uint8, rng):
    """uint8: the port divides by 255 where XLA multiplies by the
    reciprocal, 1 ulp."""
    cfg = TecoConfig(crop_size=8, rnn_n=3)
    u8 = (rng.rand(2, 3, cfg.hr_load_size, cfg.hr_load_size, 3) * 255).astype(np.uint8)
    batch = u8 if as_uint8 else u8.astype(np.float32) / 255.0
    want = jax_prepare_batch(jnp.asarray(batch), JaxConfig(crop_size=8, rnn_n=3))
    got = prepare_batch(torch.from_numpy(batch), cfg)
    for g, w, shape in zip(got, want, [(2, 3, 8, 8, 3), (2, 3, 32, 32, 3)]):
        assert g.shape == w.shape == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=FWD_ATOL)


def test_losses_match_jax(rng):
    gen = (rng.rand(2, 7, 16, 16, 3) * 2 - 1).astype(np.float32)
    tar = (rng.rand(2, 7, 16, 16, 3) * 2 - 1).astype(np.float32)
    r = rng.rand(2, 4, 8, 8, 3).astype(np.float32)
    flow = (rng.randn(2, 3, 8, 8, 2) * 2).astype(np.float32)
    pairs = [
        (losses.content_loss(torch.from_numpy(gen), torch.from_numpy(tar)),
         jax_losses.content_loss(jnp.asarray(gen), jnp.asarray(tar))),
        (losses.warp_loss(torch.from_numpy(r), torch.from_numpy(flow)),
         jax_losses.warp_loss(jnp.asarray(r), jnp.asarray(flow))),
        (losses.pingpong_loss(torch.from_numpy(gen), 4),
         jax_losses.pingpong_loss(jnp.asarray(gen), 4)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_warp_and_warp_loss_grads_match_jax(rng):
    """Image and flow gradients of the warp (the flow moves up to ~8 px, so
    some queries leave the frame and take the border), and of the warp loss."""
    img = rng.rand(2, 9, 11, 3).astype(np.float32)
    flow = (rng.randn(2, 9, 11, 2) * 4).astype(np.float32)
    cot = rng.randn(2, 9, 11, 3).astype(np.float32)
    want = jax.grad(lambda i, f: jnp.sum(jax_warp(i, f) * cot), argnums=(0, 1))(
        jnp.asarray(img), jnp.asarray(flow))
    ti = torch.from_numpy(img).requires_grad_()
    tf = torch.from_numpy(flow).requires_grad_()
    (dense_image_warp(ti, tf) * torch.from_numpy(cot)).sum().backward()
    _close_to_max(ti.grad.numpy(), want[0], what="d image")
    _close_to_max(tf.grad.numpy(), want[1], what="d flow")

    r = rng.rand(2, 4, 8, 8, 3).astype(np.float32)
    fl = (rng.randn(2, 3, 8, 8, 2) * 2).astype(np.float32)
    want_r, want_f = jax.grad(jax_losses.warp_loss, argnums=(0, 1))(
        jnp.asarray(r), jnp.asarray(fl))
    tr = torch.from_numpy(r).requires_grad_()
    tfl = torch.from_numpy(fl).requires_grad_()
    losses.warp_loss(tr, tfl).backward()
    _close_to_max(tr.grad.numpy(), want_r, what="warp loss d frames")
    _close_to_max(tfl.grad.numpy(), want_f, what="warp loss d flow")


@pytest.fixture(scope="module")
def small_models():
    """A 2-block, 16-channel generator and a narrow FNet, flax init plus
    seeded noise, and the port's modules holding the same weights."""
    rng = np.random.RandomState(3)
    jgen = JaxGenerator(num_resblock=2, channels=16)
    jfnet = JaxFNet(channels=(8, 16, 32), up_channels=(32, 16, 8))
    gp = jax.jit(jgen.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 51)))["params"]
    fp = jax.jit(jfnet.init)(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 6)))["params"]
    gp, fp = (jax.tree_util.tree_map(
        lambda p: np.asarray(p) + (rng.randn(*p.shape) * 0.02).astype(np.float32),
        jax.device_get(tree)) for tree in (gp, fp))
    return jgen, jfnet, gp, fp


def _grad_trees(gen, fnet):
    def tree(layers):
        return {name: {"kernel": m.weight.grad.permute(2, 3, 1, 0).numpy(),
                       "bias": m.bias.grad.numpy()} for name, m in layers}
    return tree(_generator_layers(gen)), tree(_fnet_layers(fnet))


@pytest.mark.parametrize("remat", [False, True], ids=["keep", "remat"])
def test_unroll_matches_jax(small_models, remat, rng):
    """flows_for_sequence + unroll_generator: flows, outputs, warped previous
    outputs, and the gradients of a weighted sum of outputs and LR flows
    with respect to every parameter, against ``jax.grad``."""
    jgen, jfnet, gp, fp = small_models
    r = rng.rand(2, 4, 8, 8, 3).astype(np.float32)
    cot_out = rng.randn(2, 4, 32, 32, 3).astype(np.float32)
    cot_flow = rng.randn(2, 3, 8, 8, 2).astype(np.float32)

    def jax_fwd(gp_, fp_):
        flow_lr, flow_hr = jax_step.flows_for_sequence(jfnet.apply, fp_, jnp.asarray(r))
        outs, warppre = jax_step.unroll_generator(
            jgen.apply, gp_, jnp.asarray(r), flow_hr, remat=False,
            with_warppre=True, fold_input=False)
        return flow_lr, flow_hr, outs, warppre

    def jax_loss(gp_, fp_):
        flow_lr, _, outs, _ = jax_fwd(gp_, fp_)
        return jnp.sum(outs * cot_out) + jnp.sum(flow_lr * cot_flow)

    want_fwd = jax_fwd(gp, fp)
    want_g, want_f = jax.grad(jax_loss, argnums=(0, 1))(gp, fp)

    gen, fnet = from_jax_params(gp, fp)
    tr = torch.from_numpy(r)
    flow_lr, flow_hr = flows_for_sequence(fnet, tr)
    outs, warppre = unroll_generator(gen, tr, flow_hr, remat=remat)
    for got, want in zip((flow_lr, flow_hr, outs, warppre), want_fwd):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=24 * FWD_ATOL)  # flows: tanh * 24
    loss = (outs * torch.from_numpy(cot_out)).sum() + \
        (flow_lr * torch.from_numpy(cot_flow)).sum()
    loss.backward()
    got_g, got_f = _grad_trees(gen, fnet)
    for got_tree, want_tree in ((got_g, want_g), (got_f, want_f)):
        for layer, leaves in want_tree.items():
            for leaf, want in leaves.items():
                _close_to_max(got_tree[layer][leaf], want, what=f"{layer}/{leaf}")


def test_extend_pingpong_matches_jax(rng):
    seq = rng.rand(2, 4, 3, 3, 3).astype(np.float32)
    got = extend_pingpong(torch.from_numpy(seq)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_step.extend_pingpong(jnp.asarray(seq))))
    assert got.shape[1] == 7


@pytest.mark.parametrize("stair", [True, False], ids=["staircase", "smooth"])
def test_lr_schedule_matches_optax(stair):
    cfg = TecoConfig(learning_rate=5e-5, decay_step=7, decay_rate=0.5, stair=stair)
    want = jax_lr_schedule(JaxConfig(learning_rate=5e-5, decay_step=7,
                                     decay_rate=0.5, stair=stair))
    assert isinstance(want(0), jax.Array) and optax is not None
    got = lr_schedule(cfg)
    for s in (0, 1, 6, 7, 8, 13, 14, 30):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6)
    assert got(0) == 5e-5
