"""The port's ``tecogan_tpu_torch.parallel`` against the JAX package's
``tecogan_tpu.parallel`` on the conftest's 8 virtual CPU devices: meshes
and shardings, the loader's shards, data-parallel training in two gloo
processes (``tests/torch_dp_worker.py``) and the slot pool across devices.

Sizes: 2 residual blocks, 8-px LR crops, LR 16x16 serving frames.
"""

import glob
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxConfig
from tecogan_tpu.data.loader import BatchLoader as JaxBatchLoader
from tecogan_tpu.data.loader import SceneDataset as JaxSceneDataset
from tecogan_tpu.models import FNet as JaxFNet
from tecogan_tpu.models import Generator as JaxGenerator
from tecogan_tpu.parallel import DataParallelTrainer as JaxDataParallelTrainer
from tecogan_tpu.parallel import make_mesh as jax_make_mesh
from tecogan_tpu.serve import VSRServer as JaxVSRServer
from tecogan_tpu.train.checkpoint import params_to_npz as jax_params_to_npz
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.data.loader import BatchLoader, SceneDataset
from tecogan_tpu_torch.data.synthetic import write_synthetic_scenes
from tecogan_tpu_torch.parallel import (
    DataParallelTrainer,
    batch_sharding,
    init_distributed,
    make_mesh,
    replicated,
    shard_batch,
)
from tecogan_tpu_torch.serve import MultiGeometryServer, VSRServer
from tecogan_tpu_torch.train import Trainer
from tecogan_tpu_torch.weights import from_jax_params

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dp_worker as worker  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Two ranks' step against one process on the global batch: float32 sums in
# another order (the batch means of two halves averaged, the batch norm's
# statistics likewise).
STEP_RTOL = 1e-5
# The gradients' norms: float32 convolutions and the averaged halves, back
# through the recurrence (measured 6e-5 on FNet's).
GRAD_RTOL = 2e-4
# uint8 serving frames: a pool of 2 slots runs the convolutions at another
# batch than one of 4 (float32 in another order), which can cross a
# rounding step: one level at most (tests/test_torch_serve.py).
U8_MAX_FLIPPED = 1e-3


# ------------------------------------------------------------------ meshes
def test_make_mesh_matches_jax():
    """The -1 rule, several axes, a repeated device and JAX's error."""
    eight = ["cpu"] * 8
    for axes in ({"data": -1}, {"data": 4, "space": 2}, {"data": -1, "space": 2},
                 {"space": 8}):
        ours, theirs = make_mesh(axes, eight), jax_make_mesh(axes)
        assert ours.shape == dict(theirs.shape) and ours.size == theirs.devices.size
        assert ours.axis_names == theirs.axis_names
    assert make_mesh({"space": 3}, "cpu").axis_devices("space") == [torch.device("cpu")] * 3
    assert make_mesh({"data": -1}, "cpu").shape == {"data": 1}
    mesh = make_mesh({"data": 2, "space": 2}, ["cpu", "cpu", "meta", "meta"])
    assert mesh.axis_devices("space") == [torch.device("cpu")] * 2
    assert mesh.axis_devices("data") == [torch.device("cpu"), torch.device("meta")]
    for make in (make_mesh, jax_make_mesh):
        with pytest.raises(ValueError, match="needs 16 devices, have 8"):
            make({"data": 16}, *([eight] if make is make_mesh else []))
    with pytest.raises(ValueError, match="no 'model'"):
        mesh.axis_devices("model")


def test_shardings_and_shard_batch():
    """``batch_sharding`` splits the leading dimension over an axis,
    ``replicated`` copies to every device, ``shard_batch`` maps trees."""
    mesh = make_mesh({"data": 4}, "cpu")
    batch = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    bsh = batch_sharding(mesh, "data")
    assert bsh.bounds(8) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    pieces = shard_batch(mesh, batch)
    assert [p.shape for p in pieces] == [(2, 3)] * 4
    np.testing.assert_array_equal(torch.cat(pieces).numpy(), batch)
    tree = shard_batch(mesh, {"a": batch, "b": batch[:4]})
    assert set(tree) == {"a", "b"} and [p.shape for p in tree["b"]] == [(1, 3)] * 4
    pair = shard_batch(mesh, (batch, batch[:, :1]))
    assert isinstance(pair, tuple) and pair[1][3].shape == (2, 1)
    copies = replicated(mesh).put(torch.from_numpy(batch))
    assert len(copies) == 4 and all(torch.equal(c, copies[0]) for c in copies)
    with pytest.raises(ValueError, match="does not split evenly"):
        shard_batch(mesh, batch[:6])


def test_init_distributed_without_a_group():
    """No arguments and no group: nothing joined, one process; partial
    arguments raise; a trainer without a group refuses."""
    assert init_distributed() == 1
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="together"):
        init_distributed(num_processes=2)
    with pytest.raises(ValueError, match="process group"):
        DataParallelTrainer(worker.config("frvsr"), "cpu")


# ------------------------------------------------------------------ loader
LOADER = dict(crop_size=8, rnn_n=4, batch_size=2, max_frm=7, str_dir=2000,
              end_dir=2001, end_dir_val=2002, queue_thread=2, rand_seed=4)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Three scenes of 8 frames (two for training: 8 windows), 60x64."""
    root = str(tmp_path_factory.mktemp("scenes"))
    write_synthetic_scenes(root, 3, 8, 60, 64, start_index=2000)
    return root


@pytest.mark.parametrize("executor", ["python", "native"])
def test_loader_shards_match_jax(scenes, executor):
    """Shard i of 2 samples the stride ``indices[i::2]`` with its own
    ``RandomState(seed + i)``: disjoint windows, batches equal to the JAX
    loader's shard, from either executor."""
    cfg = TecoConfig(input_video_dir=scenes, **LOADER)
    seen = []
    for shard in (0, 1):
        dataset = SceneDataset(cfg)
        picked = []
        plan = dataset.plan_sequence
        dataset.plan_sequence = lambda i, rng: picked.append(i) or plan(i, rng)
        with BatchLoader(dataset, executor=executor, shard_id=shard, num_shards=2,
                         prefetch=1) as ours, \
                JaxBatchLoader(JaxSceneDataset(JaxConfig(input_video_dir=scenes, **LOADER)),
                               executor="python", shard_id=shard, num_shards=2) as theirs:
            assert ours.executor_used == executor
            for _ in range(3):
                np.testing.assert_array_equal(ours.next_batch(), theirs.next_batch())
        assert picked and all(i % 2 == shard for i in picked)
        seen.append(set(picked))
    assert not seen[0] & seen[1]
    with pytest.raises(ValueError, match="shard_id"):
        BatchLoader(SceneDataset(cfg), shard_id=2, num_shards=2)


# ------------------------------------------------------------- data parallel
def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, scenes):
    """Two gloo processes taking an FRVSR step from the JAX data-parallel
    trainer's init and a TecoGAN step, with the JAX trainer's FRVSR metrics
    on a 2-device mesh; then the training CLI under torchrun."""
    tmp = tmp_path_factory.mktemp("dp")
    cfg = worker.config("frvsr")
    jcfg = JaxConfig(**{k: getattr(cfg, k) for k in (
        "num_resblock", "crop_size", "batch_size", "rnn_n", "learning_rate", "adam_eps",
        "remat_generator", "vgg_scaling", "ratio")})
    jdp = JaxDataParallelTrainer(jcfg, jax_make_mesh({"data": 2}))
    jstate = jdp.init_state(jax.random.PRNGKey(0))
    # Flows mid-cell, where the warp's gradient is smooth (as in
    # tests/test_torch_train.py).
    fnet_params = dict(jstate.fnet_params)
    fnet_params["output_conv2"] = dict(fnet_params["output_conv2"],
                                       bias=jnp.asarray([0.015625, -0.026], jnp.float32))
    jstate = jstate.replace(fnet_params=fnet_params)
    init = str(tmp / "init.npz")
    jax_params_to_npz(init, generator=jax.device_get(jstate.gen_params),
                      fnet=jax.device_get(fnet_params))
    _, jmetrics = jdp.train_step(jstate, jdp.put_batch(worker.global_batch(cfg, 0)))

    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_dp_worker.py"), str(port),
         str(rank), "2", "frvsr,tecogan", "cpu", "--init", init],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
        for rank in range(2)]
    ranks = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, f"rc={p.returncode}\n{stdout}\n{stderr[-3000:]}"
        ranks.append({line.split(" ", 2)[1]: json.loads(line.split(" ", 2)[2])
                      for line in stdout.splitlines() if line.startswith("RESULT")})

    # The training CLI as torchrun launches it: 3 FRVSR steps on 2 ranks.
    # Each rank's output goes to a file of its own (``--redirects 3``): two
    # ranks writing block-buffered stdout into one pipe can interleave in
    # the middle of a line once a flush exceeds the pipe's atomic write.
    out, logs = str(tmp / "run"), str(tmp / "torchrun_logs")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    launch = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_port", str(_free_port()), "--log-dir", logs, "--redirects", "3",
         "-m", "tecogan_tpu_torch.cli.main",
         "--mode", "train", "--device", "cpu", "--preset", "frvsr", "--num_resblock", "2",
         "--crop_size", "8", "--batch_size", "2", "--rnn_n", "4", "--max_iter", "3",
         "--input_video_dir", scenes, "--str_dir", "2000", "--end_dir", "2001",
         "--end_dir_val", "2002", "--max_frm", "7", "--queue_thread", "1",
         "--display_freq", "1", "--summary_freq", "3", "--save_freq", "3",
         "--no_test_while_train", "--output_dir", out],
        capture_output=True, text=True, cwd=str(tmp), env=env, timeout=300)
    printed = {}
    for name in ("stdout", "stderr"):
        files = [glob.glob(os.path.join(logs, "*", "attempt_*", str(r), f"{name}.log"))
                 for r in (0, 1)]
        printed[name] = [open(f[0]).read() if len(f) == 1 else "" for f in files]
    assert launch.returncode == 0, (f"{launch.stderr[-3000:]}\n" + "\n".join(
        f"rank {r}: {printed['stdout'][r][-2000:]}\n{printed['stderr'][r][-2000:]}"
        for r in (0, 1)))
    return dict(ranks=ranks, init=init, out=out, launch="".join(printed["stdout"]),
                jax={k: float(v) for k, v in jmetrics.items()})


@pytest.mark.parametrize("preset", ["frvsr", "tecogan"])
def test_two_process_step_matches_one_process(two_ranks, preset):
    """World size 2 over gloo: the first step's losses equal one process's
    step on the concatenated batch; the ranks' metrics (both steps) and the
    discriminator's batch statistics are identical; the gradients' norms
    agree; FRVSR's step also matches the JAX data-parallel trainer's."""
    r0, r1 = two_ranks["ranks"]
    got = r0[preset]
    assert got["metrics"] == r1[preset]["metrics"]
    assert got["d_stats"] == r1[preset]["d_stats"]
    cfg = worker.config(preset)
    trainer = Trainer(cfg, "cpu", vgg=worker.vgg_for(cfg), capture=False)
    if preset == "frvsr":
        from tecogan_tpu_torch.weights import read_params_npz

        trees = read_params_npz(two_ranks["init"])
        state = trainer.state_from_modules(*from_jax_params(trees["generator"], trees["fnet"]))
    else:
        state = trainer.init_state(0)
    want = worker.record(trainer, state, steps=1)
    assert set(got["metrics"][0]) == set(want["metrics"][0])
    for k, v in want["metrics"][0].items():
        np.testing.assert_allclose(got["metrics"][0][k], v, rtol=STEP_RTOL, err_msg=k)
    for k, v in want["grad_norms"].items():
        np.testing.assert_allclose(got["grad_norms"][k], v, rtol=GRAD_RTOL, err_msg=k)
    if preset == "tecogan":
        np.testing.assert_allclose(got["d_stats"], want["d_stats"], rtol=0, atol=STEP_RTOL)
        assert got["metrics"][0]["t_discrim_loss"] > 0
    else:
        for k, v in two_ranks["jax"].items():
            np.testing.assert_allclose(got["metrics"][0][k], v, rtol=STEP_RTOL, err_msg=k)


def test_torchrun_training_cli(two_ranks):
    """``torchrun --nproc_per_node 2 -m tecogan_tpu_torch.cli.main --mode
    train --device cpu``: both ranks reach step 3 with the same losses,
    each on 1 row of the global batch of 2 (the two ranks' outputs read
    from their own log files, one after the other); rank 0 alone writes the
    config, the checkpoint and the summaries."""
    out = two_ranks["launch"]
    assert out.count("Data parallel: rank") == 2
    assert "rank 0 of 2, 1 of the global batch of 2 a rank" in out
    steps = [line.split("| ", 1)[1] for line in out.splitlines()
             if line.startswith("step 3:")]
    assert len(steps) == 2 and steps[0] == steps[1]
    run = two_ranks["out"]
    assert os.path.isdir(os.path.join(run, "checkpoints", "3"))
    with open(os.path.join(run, "log", "scalars.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert records and {r["step"] for r in records} == {3}
    assert len([f for f in os.listdir(os.path.join(run, "log")) if "tfevents" in f]) == 1


# ------------------------------------------------------------------ serving
H = W = 16


@pytest.fixture(scope="module")
def serve_weights():
    rng = np.random.RandomState(0)
    gp = jax.jit(JaxGenerator(num_resblock=2).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 51)))["params"]
    fp = jax.jit(JaxFNet().init)(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 6)))["params"]
    return tuple(jax.tree_util.tree_map(
        lambda p: np.asarray(p) + (rng.randn(*p.shape) * 0.01).astype(np.float32),
        jax.device_get(tree)) for tree in (gp, fp))


def test_server_mesh_matches_unsharded_and_jax(serve_weights):
    """A 4-slot pool over a 2-device ``data`` axis (2 slots a device):
    streams join late, one sits idle, one closes and its slot is reused;
    every tick's frames against the unsharded 4-slot pool and the JAX
    package's meshed server, within one level."""
    cfg = TecoConfig(num_resblock=2)
    mesh = make_mesh({cfg.dp_axis: 2}, "cpu")
    sharded = VSRServer(cfg, *from_jax_params(*serve_weights), H, W, max_streams=4,
                        mesh=mesh, device="cpu")
    plain = VSRServer(cfg, *from_jax_params(*serve_weights), H, W, max_streams=4,
                      device="cpu")
    jsrv = JaxVSRServer(JaxConfig(num_resblock=2, fold_input_s2d="off"), *serve_weights,
                        H, W, max_streams=4, mesh=jax_make_mesh({"data": 2}))
    rng = np.random.RandomState(3)
    clips = {s: (rng.rand(4, H, W, 3) * 255).astype(np.uint8) for s in "abcde"}
    script = [("open", "a"), ("open", "b"), ("open", "c"), {"a": 0, "b": 0, "c": 0},
              ("open", "d"), {"a": 1, "c": 1, "d": 0}, ("close", "b"), ("open", "e"),
              {"a": 2, "c": 2, "d": 1, "e": 0}]
    for tick in script:
        if isinstance(tick, tuple):
            slots = [getattr(s, tick[0])(tick[1]) for s in (sharded, plain, jsrv)]
            assert tick[0] == "close" or len(set(slots)) == 1, slots
            continue
        frames = {sid: clips[sid][i] for sid, i in tick.items()}
        got, want, theirs = (s.step(frames) for s in (sharded, plain, jsrv))
        for sid in tick:
            for ref in (want, theirs):
                diff = np.abs(got[sid].astype(np.int16) - ref[sid])
                assert diff.max() <= 1 and (diff != 0).mean() <= U8_MAX_FLIPPED, sid
    # Streams take the first device's slots first; e reused b's.
    assert [p.open_streams for p in sharded._pools] == [("a", "e"), ("c", "d")]
    assert [p.max_streams for p in sharded._pools] == [2, 2]
    with pytest.raises(ValueError, match="divide evenly"):
        VSRServer(cfg, *from_jax_params(*serve_weights), H, W, max_streams=3, mesh=mesh,
                  device="cpu")


def test_multi_geometry_server_mesh_budget(serve_weights):
    """A meshed MultiGeometryServer: each bucket's pool split over the
    devices, and its budget per device (JAX's ``bucket_bytes`` / n)."""
    cfg = TecoConfig(num_resblock=2)
    mesh = make_mesh({cfg.dp_axis: 2}, "cpu")
    srv = MultiGeometryServer(cfg, *from_jax_params(*serve_weights), slots_per_geometry=2,
                              mesh=mesh, device="cpu")
    plain = MultiGeometryServer(cfg, *from_jax_params(*serve_weights), slots_per_geometry=2,
                                device="cpu")
    assert srv.bucket_bytes(H, W) * 2 == plain.bucket_bytes(H, W)
    frame = (np.random.RandomState(1).rand(H, W, 3) * 255).astype(np.uint8)
    for s in (srv, plain):
        s.open("a", H, W)
        s.open("b", H, W)
    got, want = srv.step({"a": frame, "b": frame}), plain.step({"a": frame, "b": frame})
    assert [p.open_streams for p in srv._buckets[(H, W)]._pools] == [("a",), ("b",)]
    for sid in "ab":
        assert np.abs(got[sid].astype(np.int16) - want[sid]).max() <= 1
    assert srv.footprint_bytes * 2 == plain.footprint_bytes
