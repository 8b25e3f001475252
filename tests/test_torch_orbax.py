"""The JAX package's orbax checkpoints read and written by the port without
JAX (``train/orbax_io.py``, ``weights.train_state_from_jax`` /
``train_state_to_jax``, ``train/checkpoint.py``), against the JAX package
on the CPU: the committed fixture and its regeneration, every leaf of
FRVSR and TecoGAN TrainStates (2 and 3 blocks) bit-equal to the JAX
``restore_checkpoint``, one resumed training step against the JAX step, a
grown warm start, the port's own writes read back by the JAX package, the
inference CLI on a JAX checkpoint against the JAX CLI, ``train()``
resuming a JAX run, retention, B-tree interior nodes written by
tensorstore, and the refusals."""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.cli import main as jax_cli
from tecogan_tpu.config import TecoConfig as JaxConfig
from tecogan_tpu.train import Trainer as JaxTrainer
from tecogan_tpu.train import TrainState as JaxTrainState
from tecogan_tpu.train import checkpoint as jax_ckpt
from tecogan_tpu_torch.cli.main import main
from tecogan_tpu_torch.config import FRVSR_PRESET, TecoConfig
from tecogan_tpu_torch.data.synthetic import write_synthetic_scenes
from tecogan_tpu_torch.train import Trainer
from tecogan_tpu_torch.train import orbax_io
from tecogan_tpu_torch.train.checkpoint import (
    latest_step,
    load_models,
    restore_checkpoint,
    save_checkpoint,
    save_jax_checkpoint,
    warm_start,
)
from tecogan_tpu_torch.train.loop import train
from tecogan_tpu_torch.train.trainer import _init_adam_state
from tecogan_tpu_torch.weights import train_state_from_jax, train_state_to_jax

sys.path.insert(0, os.path.dirname(__file__))
import make_orbax_fixture  # noqa: E402
from test_torch_cli import U8_MAX_FLIPPED, _clip_dir, _read_dir  # noqa: E402
from test_torch_train import GRAD_MASK, METRIC_RTOL, PARAM_ATOL  # noqa: E402

torch.set_num_threads(1)

FRVSR = dict(num_resblock=2, crop_size=8, batch_size=2, rnn_n=4, ratio=-0.01,
             vgg_scaling=-0.002, learning_rate=1e-3, remat_generator=False)
TECOGAN = dict(FRVSR, ratio=0.01, pingpong=True, pp_scaling=0.5, d_layerloss=True,
               adam_eps=1e-12)
CONFIGS = {"frvsr2": FRVSR, "tecogan2": TECOGAN, "tecogan3": dict(TECOGAN, num_resblock=3)}


def _key(k):
    return str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))


def _jax_flat(tree):
    """{'a/b/c': numpy leaf} of a JAX pytree (None subtrees dropped)."""
    return {"/".join(_key(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(tree):
    """{'a/b/c': numpy leaf} of the port's tree (bfloat16 as uint16 bits)."""
    out = {}
    for path, leaf in make_orbax_fixture.flatten(tree):
        if leaf is None:
            continue
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.view(torch.uint16) if leaf.dtype == torch.bfloat16 else leaf
            leaf = leaf.numpy()
        out["/".join(path)] = np.asarray(leaf)
    return out


def _assert_bit_equal(got, want):
    assert got.keys() == want.keys(), set(got) ^ set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@torch.no_grad()
def _randomize(state, seed):
    """Every tensor of a port state drawn from ``seed``: parameters (init
    plus noise), Adam moments and counts, D's statistics, EMAs, counters."""
    g = torch.Generator().manual_seed(seed)

    def rand(t, scale=1.0):
        return torch.randn(t.shape, generator=g) * scale

    modules = [state.generator, state.fnet] + (
        [state.discriminator] if state.discriminator is not None else [])
    for m in modules:
        for p in m.parameters():
            p.add_(rand(p, 0.01))
    for opt in (state.gen_opt, state.fnet_opt):
        _init_adam_state(opt)
        for s in opt.state.values():
            s["exp_avg"].copy_(rand(s["exp_avg"], 1e-3))
            s["exp_avg_sq"].copy_(rand(s["exp_avg_sq"], 1e-6).abs())
            s["step"].fill_(3)
    for k, v in state.ema_losses.items():
        v.copy_(torch.rand((), generator=g))
    state.step = 3
    state.device_step.fill_(3)
    if state.discriminator is not None:
        for m in state.d_opt.mu + state.d_opt.nu:
            m.copy_(rand(m, 1e-3).abs())
        state.d_opt.count.fill_(2)
        for name, b in state.discriminator.named_buffers():
            b.copy_(rand(b).abs() + (0.5 if "var" in name else 0.0))
        state.ema_tbalance.fill_(0.375)
        state.counter_with_d.fill_(2)
        state.counter_wo_d.fill_(1)
    return state


def _port_state(kw, seed=0, randomize=True):
    state = Trainer(TecoConfig(**kw), "cpu").init_state(seed)
    return _randomize(state, seed + 100) if randomize else state


def _jax_state(kw, tree):
    """The JAX TrainState (optax's own state classes) holding ``tree``."""
    jtr = JaxTrainer(JaxConfig(**kw))
    arr = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731

    def opt(tx, o, params):
        adam, sched = tx.init(params)
        return (adam._replace(count=arr(o[0]["count"]), mu=arr(o[0]["mu"]), nu=arr(o[0]["nu"])),
                sched._replace(count=arr(o[1]["count"])))

    fields = dict(step=arr(tree["step"]), gen_params=arr(tree["gen_params"]),
                  fnet_params=arr(tree["fnet_params"]),
                  gen_opt=opt(jtr.gen_tx, tree["gen_opt"], tree["gen_params"]),
                  fnet_opt=opt(jtr.fnet_tx, tree["fnet_opt"], tree["fnet_params"]),
                  ema_losses=arr(tree["ema_losses"]))
    if tree["d_params"] is not None:
        fields.update(d_params=arr(tree["d_params"]), d_batch_stats=arr(tree["d_batch_stats"]),
                      d_opt=opt(jtr.d_tx, tree["d_opt"], tree["d_params"]),
                      **{k: arr(tree[k]) for k in ("ema_tbalance", "counter_with_d",
                                                   "counter_wo_d")})
    return JaxTrainState(**fields)


def _zeros_like(jstate):
    return jax.tree_util.tree_map(jnp.zeros_like, jstate)


# ------------------------------------------------------------------ fixture
def _fixture_hashes(step_dir):
    tree = orbax_io.read_jax_checkpoint(str(step_dir))
    flat = [(tuple(k.split("/")), v) for k, v in _port_flat(tree).items()]
    return make_orbax_fixture.leaf_hashes(flat)


def test_committed_fixture_matches_its_hashes():
    want = json.loads(make_orbax_fixture.SHA256.read_text())
    step_dir = make_orbax_fixture.FIXTURE / str(want["step"])
    assert _fixture_hashes(step_dir) == want["leaves"]
    assert make_orbax_fixture.expected_hashes() == want["leaves"]
    # It is the store the card is held to: OCDBT, zstd nodes, inline and
    # indirect values, the per-process sub-store.
    meta = json.loads((step_dir / "default" / "_METADATA").read_text())
    assert meta["use_ocdbt"] and not meta["use_zarr3"]
    reader = orbax_io.OcdbtReader(str(step_dir / "default"))
    kinds = {isinstance(v, bytes) for v in reader._values.values()}
    assert kinds == {True, False}
    assert any(v[0][0].startswith("ocdbt.process_0/") for v in reader._values.values()
               if not isinstance(v, bytes))


def test_regenerated_fixture_matches_the_committed_hashes(tmp_path):
    make_orbax_fixture.write_fixture(tmp_path)
    want = json.loads(make_orbax_fixture.SHA256.read_text())
    assert _fixture_hashes(tmp_path / str(make_orbax_fixture.STEP)) == want["leaves"]
    restored = jax_ckpt.restore_checkpoint(str(tmp_path), None)
    flat = {tuple(k.split("/")): v for k, v in _jax_flat(restored).items()}
    bf16 = {k: v.view(np.uint16) if k == ("bf16", "table") else v for k, v in flat.items()}
    assert make_orbax_fixture.leaf_hashes(sorted(bf16.items())) == want["leaves"]


# ------------------------------------------------------------------- reads
@pytest.mark.parametrize("name", list(CONFIGS))
def test_reads_jax_train_states_bit_equal(tmp_path, name):
    """The JAX ``save_checkpoint`` writes a TrainState (OCDBT); the port
    reads every leaf as the JAX ``restore_checkpoint`` does, and
    ``restore_checkpoint`` puts them into a fresh port state whose tree is
    the written one."""
    kw = CONFIGS[name]
    tree = train_state_to_jax(_port_state(kw))
    jstate = _jax_state(kw, tree)
    ckpt = str(tmp_path / "ckpt")
    jax_ckpt.save_checkpoint(ckpt, jstate, 3)
    want = _jax_flat(jax_ckpt.restore_checkpoint(ckpt, _zeros_like(jstate)))
    got = orbax_io.read_jax_checkpoint(os.path.join(ckpt, "3"))
    _assert_bit_equal(_port_flat(got), want)
    if name == "frvsr2":  # orbax records a None field as such
        assert got["d_params"] is None and got["d_opt"] is None
    fresh = Trainer(TecoConfig(**kw), "cpu").init_state(7)
    assert latest_step(ckpt) == 3
    restored = restore_checkpoint(ckpt, fresh)
    assert restored is fresh and fresh.step == 3 and int(fresh.device_step) == 3
    _assert_bit_equal(_port_flat(train_state_to_jax(fresh)), _port_flat(tree))


def test_full_resume_step_matches_jax(tmp_path):
    """A JAX FRVSR run's checkpoint after one step, restored by the port:
    the next step matches the JAX trainer's next step from the same
    checkpoint (tests/test_torch_train.py's tolerances and FNet bias)."""
    kw = FRVSR
    cfg = JaxConfig(**kw)
    jtr = JaxTrainer(cfg)
    tree = train_state_to_jax(_port_state(kw, randomize=False))
    tree["fnet_params"]["output_conv2"]["bias"] = np.asarray([0.015625, -0.026], np.float32)
    rng = np.random.RandomState(5)
    batches = [(rng.rand(2, 4, cfg.hr_load_size, cfg.hr_load_size, 3) * 255).astype(np.uint8)
               for _ in range(2)]
    state1, _ = jtr.train_step(_jax_state(kw, tree), jnp.asarray(batches[0]))
    ckpt = str(tmp_path / "ckpt")
    jax_ckpt.save_checkpoint(ckpt, state1, 1)
    mu1 = _jax_flat(state1.gen_opt[0].mu) | {f"f/{k}": v for k, v in
                                            _jax_flat(state1.fnet_opt[0].mu).items()}
    state2, want_metrics = jtr.train_step(
        jax_ckpt.restore_checkpoint(ckpt, _zeros_like(state1)), jnp.asarray(batches[1]))

    trainer = Trainer(TecoConfig(**kw), "cpu")
    port = restore_checkpoint(ckpt, trainer.init_state(11))
    assert port.step == 1
    port, metrics = trainer.train_step(port, batches[1])
    for k, w in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(w), rtol=METRIC_RTOL, err_msg=k)
    got = train_state_to_jax(port)
    assert int(got["step"]) == int(state2.step) == 2
    assert int(got["gen_opt"][0]["count"]) == int(state2.gen_opt[0].count) == 2
    b1 = cfg.beta1
    for prefix, got_p, want_p, want_mu in (
            ("", got["gen_params"], state2.gen_params, state2.gen_opt[0].mu),
            ("f/", got["fnet_params"], state2.fnet_params, state2.fnet_opt[0].mu)):
        gp, wp, wmu = _port_flat(got_p), _jax_flat(want_p), _jax_flat(want_mu)
        for k in wp:
            g2 = (wmu[k] - b1 * mu1[prefix + k]) / (1 - b1)  # the second step's gradient
            mask = np.abs(g2) > GRAD_MASK * np.abs(g2).max()
            assert mask.any(), k
            diff = np.abs(gp[k] - wp[k])[mask]
            assert diff.max() <= PARAM_ATOL, (k, diff.max())


def test_warm_start_grows_a_jax_run_like_jax(tmp_path, capsys):
    """A 2-block JAX checkpoint warm-starts a 3-block state: the port's
    ``warm_start`` gives the JAX ``warm_start``'s leaves, the grown
    block's fresh conv_1 and zero conv_2 included; optimizers stay fresh."""
    small = train_state_to_jax(_port_state(FRVSR))
    ckpt = str(tmp_path / "ckpt")
    jax_ckpt.save_checkpoint(ckpt, _jax_state(FRVSR, small), 3)
    big_kw = dict(FRVSR, num_resblock=3)
    port = _port_state(big_kw, seed=9, randomize=False)
    jbig = _jax_state(big_kw, train_state_to_jax(port))
    want = jax_ckpt.warm_start(jbig, ckpt)
    got = warm_start(port, ckpt)
    assert "partial generator restore" in capsys.readouterr().out
    assert got.step == 0 and not got.gen_opt.state_dict()["state"]
    tree = train_state_to_jax(got)
    for key in ("gen_params", "fnet_params"):
        _assert_bit_equal(_port_flat(tree[key]), _jax_flat(getattr(want, key)))
    assert not tree["gen_params"]["resblock_3_conv_2"]["kernel"].any()
    assert tree["gen_params"]["resblock_3_conv_1"]["kernel"].any()


# ------------------------------------------------------------------- writes
@pytest.mark.parametrize("name", ["frvsr2", "tecogan2"])
def test_jax_reads_the_ports_writes(tmp_path, name):
    """``save_jax_checkpoint``: the JAX ``latest_step`` finds it and its
    ``restore_checkpoint`` (into a TrainState template, and raw, as its
    warm start and CLI restore) reads ``train_state_to_jax`` bit-equal."""
    kw = CONFIGS[name]
    state = _port_state(kw)
    tree = train_state_to_jax(state)
    ckpt = str(tmp_path / "ckpt")
    path = save_jax_checkpoint(ckpt, state)
    assert path == os.path.join(ckpt, "3") and sorted(os.listdir(ckpt)) == ["3"]
    assert jax_ckpt.latest_step(ckpt) == 3 == latest_step(ckpt)
    jstate = _jax_state(kw, tree)
    restored = jax_ckpt.restore_checkpoint(ckpt, _zeros_like(jstate))
    _assert_bit_equal(_jax_flat(restored), _port_flat(tree))
    raw = jax_ckpt.restore_checkpoint(ckpt, None)
    _assert_bit_equal(_jax_flat(raw), _port_flat(tree))
    step, gen, fnet = load_models(ckpt, TecoConfig(**kw))
    assert step == 3 and len(gen.resblocks) == 2
    for a, b in ((gen, state.generator), (fnet, state.fnet)):
        for k, v in b.state_dict().items():
            assert torch.equal(a.state_dict()[k], v), k


def test_keep_drops_the_oldest_like_orbax(tmp_path):
    state = _port_state(FRVSR)
    ckpt = str(tmp_path / "ckpt")
    for step in (3, 5, 8):
        state.step = step
        save_jax_checkpoint(ckpt, state, keep=2)
    assert sorted(int(d) for d in os.listdir(ckpt)) == [5, 8]
    assert jax_ckpt.latest_step(ckpt) == 8
    with pytest.raises(FileExistsError):
        save_jax_checkpoint(ckpt, state)
    # Both layouts count toward ``keep`` and ``latest_step``.
    state.step = 9
    save_checkpoint(ckpt, state, keep=2)
    assert sorted(os.listdir(ckpt)) == ["8", "9"] and latest_step(ckpt) == 9
    assert os.path.isfile(os.path.join(ckpt, "9", "state.pt"))


# --------------------------------------------------------------- the CLIs
def test_inference_cli_on_a_jax_checkpoint(tmp_path, capsys, monkeypatch):
    """``--checkpoint`` on the JAX trainer's orbax directory: the port's
    CLI gives the JAX CLI's PNGs within one uint8 level (as
    tests/test_torch_cli.py) and prints its depth NOTE."""
    monkeypatch.setenv("TECOGAN_NO_COMPILE_CACHE", "1")
    ckpt = str(tmp_path / "ckpt")
    jax_ckpt.save_checkpoint(ckpt, _jax_state(FRVSR, train_state_to_jax(_port_state(FRVSR))), 3)
    lr, _ = _clip_dir(str(tmp_path), "lr", t=10)
    jax_cli.main(["--mode", "inference", "--input_dir_LR", lr, "--output_dir",
                  str(tmp_path / "jax"), "--checkpoint", ckpt])
    want_out = capsys.readouterr().out
    main(["--mode", "inference", "--device", "cpu", "--input_dir_LR", lr,
          "--output_dir", str(tmp_path / "port"), "--checkpoint", ckpt])
    out = capsys.readouterr().out
    note = ("NOTE: checkpoint has 2 resblocks; overriding --num_resblock 16 (the "
            "checkpoint defines the model)")
    assert note in out and note in want_out
    assert f"Loaded checkpoint step 3 from {ckpt}" in out
    got, want = _read_dir(tmp_path / "port"), _read_dir(tmp_path / "jax")
    assert list(got) == list(want) and len(got) == 10
    stack = lambda d: np.stack([d[f] for f in sorted(d)]).astype(np.int16)  # noqa: E731
    diff = np.abs(stack(got) - stack(want))
    assert diff.max() <= 1 and (diff != 0).mean() <= U8_MAX_FLIPPED, (diff != 0).mean()
    assert stack(got).std() > 1.0


def test_train_resumes_a_jax_run(tmp_path, capsys):
    """``train()`` finds the JAX run's step 4 in its checkpoint dir, resumes
    from it and saves the port's ``state.pt`` beside it; ``pre_trained_dir``
    takes a JAX run's weights."""
    scenes = str(tmp_path / "scenes")
    write_synthetic_scenes(scenes, 2, 6, 60, 64, start_index=2000)
    cfg = FRVSR_PRESET.replace(input_video_dir=scenes, num_resblock=2, crop_size=8,
                               batch_size=2, rnn_n=4, max_frm=5, queue_thread=2,
                               display_freq=1, summary_freq=2, save_freq=2)
    state = _randomize(Trainer(cfg, "cpu").init_state(cfg.rand_seed), 4)
    state.step = 4
    tree = train_state_to_jax(state)
    out = str(tmp_path / "run")
    jax_ckpt.save_checkpoint(os.path.join(out, "checkpoints"), _jax_state(
        dict(FRVSR, gen_channels=cfg.gen_channels), tree), 4)
    resumed = train(cfg, out, "cpu", max_steps=6, test_while_train=False)
    printed = capsys.readouterr().out
    assert "Resumed from step 4" in printed and "step 6: image/sec*frames" in printed
    assert resumed.step == 6
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["4", "6"]
    assert os.path.isfile(os.path.join(out, "checkpoints", "6", "state.pt"))
    warm = train(cfg, str(tmp_path / "warm"), "cpu", max_steps=1, test_while_train=False,
                 pre_trained_dir=os.path.join(out, "checkpoints"))
    assert f"Warm-started weights from {os.path.join(out, 'checkpoints')}" in \
        capsys.readouterr().out
    assert warm.step == 1


# ------------------------------------------------------------ the format
def test_ocdbt_interior_nodes_and_data_files_match_tensorstore(tmp_path):
    """A store with small nodes (a B-tree four levels deep, keys
    prefix-compressed under subtree prefixes) and values inline and
    indirect, written by tensorstore: the reader's keys and values are
    tensorstore's."""
    ts = pytest.importorskip("tensorstore")
    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}/",
            "config": {"max_decoded_node_bytes": 400, "max_inline_value_bytes": 16}}
    kv = ts.KvStore.open(spec).result()
    rng = np.random.RandomState(0)
    with ts.Transaction() as txn:
        for i in range(80):
            kv.with_transaction(txn)[f"group{i % 3}/key{i:03d}/leaf"] = rng.bytes(i % 41)
    reader = orbax_io.OcdbtReader(str(tmp_path))
    keys = sorted(k.decode() for k in kv.list().result())
    assert reader.keys() == keys and len(keys) == 80
    for k in keys:
        assert reader.read(k) == kv.read(k).result().value, k
    manifest = ts.ocdbt.dump(ts.KvStore.open(f"file://{tmp_path}/").result()).result()
    assert manifest["versions"][-1]["root_height"] >= 2


def test_read_zarr_v2_chunk_grid_dtypes_and_fill():
    """A 5x7 array in 2x3 chunks (edge chunks clipped), '/' separators, no
    compressor, one chunk missing (the fill value), and each dtype."""
    want = np.arange(35, dtype=np.int64).reshape(5, 7)
    store = {"a/.zarray": json.dumps({
        "zarr_format": 2, "shape": [5, 7], "chunks": [2, 3], "dtype": "<i8",
        "compressor": None, "fill_value": -1, "order": "C", "filters": None,
        "dimension_separator": "/"}).encode()}
    for i in range(3):
        for j in range(3):
            if (i, j) == (1, 2):
                continue  # missing: fill_value
            chunk = np.full((2, 3), -9, np.int64)
            block = want[2 * i:2 * i + 2, 3 * j:3 * j + 3]
            chunk[:block.shape[0], :block.shape[1]] = block
            store[f"a/{i}/{j}"] = chunk.tobytes()
    got = orbax_io.read_zarr_v2(store.get, "a")
    expect = want.copy()
    expect[2:4, 6:7] = -1
    np.testing.assert_array_equal(got, expect)
    for dtype, arr in (("<f2", np.float16([1.5, -2])), ("|b1", np.array([True, False])),
                       ("<i4", np.int32([7, -7])), ("<f4", np.float32([np.pi, 0]))):
        meta = {"zarr_format": 2, "shape": [2], "chunks": [2], "dtype": dtype,
                "compressor": None, "fill_value": None, "order": "C", "filters": None}
        one = {"x/.zarray": json.dumps(meta).encode(), "x/0": arr.tobytes()}
        np.testing.assert_array_equal(orbax_io.read_zarr_v2(one.get, "x"), arr)
    bf = torch.tensor([1.5, -3.25], dtype=torch.bfloat16)
    meta.update(dtype="bfloat16")
    one = {"x/.zarray": json.dumps(meta).encode(), "x/0": bf.view(torch.uint16).numpy().tobytes()}
    got = orbax_io.read_zarr_v2(one.get, "x")
    assert got.dtype == torch.bfloat16 and torch.equal(got, bf)


def test_refusals(tmp_path):
    """zarr v3 leaves, a numbered manifest, a corrupt node, another
    compressor and an unknown dtype are refused with a named error."""
    src = make_orbax_fixture.FIXTURE / "1"
    step = tmp_path / "ckpt" / "1"
    shutil.copytree(src, step)
    meta_path = step / "default" / "_METADATA"
    meta = json.loads(meta_path.read_text())
    meta_path.write_text(json.dumps(dict(meta, use_zarr3=True)))
    with pytest.raises(orbax_io.OrbaxFormatError, match="zarr v3"):
        orbax_io.read_jax_checkpoint(str(step))
    meta_path.write_text(json.dumps(meta))
    manifest = step / "default" / "manifest.ocdbt"
    data = bytearray(manifest.read_bytes())
    data[20] ^= 0x40
    manifest.write_bytes(bytes(data))
    with pytest.raises(orbax_io.OrbaxFormatError, match="CRC-32C"):
        orbax_io.read_jax_checkpoint(str(step))
    manifest.rename(step / "default" / "manifest.0000000000000001")
    with pytest.raises(orbax_io.OrbaxFormatError, match="numbered manifests"):
        orbax_io.OcdbtReader(str(step / "default"))
    for meta, match in (({"compressor": {"id": "blosc"}}, "blosc"),
                        ({"dtype": "<c8"}, "<c8")):
        base = {"zarr_format": 2, "shape": [1], "chunks": [1], "dtype": "<f4",
                "compressor": None, "fill_value": None, "order": "C", "filters": None}
        store = {"x/.zarray": json.dumps({**base, **meta}).encode()}
        with pytest.raises(orbax_io.OrbaxFormatError, match=match):
            orbax_io.read_zarr_v2(store.get, "x")


def test_mode_mismatch_and_missing_leaves_raise():
    """A TecoGAN tree into an FRVSR state, a tree of another depth, and an
    unknown loss EMA are refused before a tensor is written."""
    gan = train_state_to_jax(_port_state(TECOGAN))
    with pytest.raises(ValueError, match="mode"):
        train_state_from_jax(gan, _port_state(FRVSR, randomize=False))
    deep = train_state_to_jax(_port_state(dict(FRVSR, num_resblock=3)))
    with pytest.raises(ValueError, match="resblock_3_conv_1"):
        train_state_from_jax(deep, _port_state(FRVSR, randomize=False))
    tree = train_state_to_jax(_port_state(FRVSR))
    tree["ema_losses"]["unknown"] = np.float32(0)
    fresh = _port_state(FRVSR, randomize=False)
    before = train_state_to_jax(fresh)
    with pytest.raises(ValueError, match="unknown"):
        train_state_from_jax(tree, fresh)
    _assert_bit_equal(_port_flat(train_state_to_jax(fresh)), _port_flat(before))
