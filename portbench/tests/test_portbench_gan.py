"""The TecoGAN training cell (``traffic/gan.py``, ``reference/gan.py``,
``harness/gan_flops.py``, its readers and entries) on the CPU: the whole
run at a tiny size is correct; faults planted in the program make it not
correct; the reference computed in bfloat16, in the program's place, fails
the limits; the FLOP counters against hand counts and against the
reference's own convolutions; the new readers' arithmetic. The control on
the card at the cell's own size is a ``cuda`` test."""

import gc
import json

import pytest
import torch
import torch.nn.functional as F

from portbench.harness import gan_flops as GF
from portbench.harness.flops import fnet_macs, generator_macs
from portbench.harness.manifest import ROOT, Manifest
from portbench.harness.runner import run_cell
from portbench.harness.trace import Tracer
from portbench.reference import gan as RG

WORKLOAD = "train_tecogan_resident"
SEED = 2**31 + 211
TINY = {"scenes": 2, "scene_frames": 12, "height": 64, "width": 80, "cache_batches": 2}
NEW_METRICS = ["device_ms_per_step.gan", "glue_pct.gan", "idle_pct.gan", "chain_roofline.gan",
               "mfu.gan", "train_host_ms.gan", "replay_launch_ms.gan", "capture_s.gan",
               "library_pct.gan", "d_update_pct", "loader_wait_ms.gan", "loader_get_ms.gan",
               "loader_produce_ms.gan"]


def _run(manifest, **traffic):
    return run_cell(manifest, WORKLOAD, SEED, 0.5, False, device="cpu",
                    traffic_overrides=dict(TINY, **traffic))


def test_sound_run_is_correct(tiny_manifest):
    result = _run(tiny_manifest)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == {"loss_rel", "grad_rel", "change_rel", "grad_diff_med",
                                     "stats_rel", "gate_mismatch"}
    assert set(result["metrics"]) == {"step_ms", "setup_s"}
    assert list(result)[-1] == "checks"


def test_discriminator_update_left_out(tiny_manifest, monkeypatch):
    """Dst's Adam applies nothing: its parameters do not move."""
    from tecogan_tpu_torch.train import trainer

    monkeypatch.setattr(trainer.MaskedAdam, "step", lambda self, apply: None)
    result = _run(tiny_manifest)
    assert not result["correct"]
    assert result["checks"]["change_rel"]["value"] == pytest.approx(1.0)


def test_gate_held_closed(tiny_manifest, monkeypatch):
    """The program's gate reads an EMA above ``d_balance``: it closes where
    the reference's is open."""
    from tecogan_tpu_torch.train import trainer

    d_step = trainer.Trainer._d_step

    def closed(self, state, real, fake):
        state.ema_tbalance.fill_(1.0)
        d_step(self, state, real, fake)

    monkeypatch.setattr(trainer.Trainer, "_d_step", closed)
    result = _run(tiny_manifest)
    assert not result["correct"]
    assert result["checks"]["gate_mismatch"]["value"] == 3


def test_statistics_left_alone(tiny_manifest, monkeypatch):
    """Dst's running statistics never move."""
    from tecogan_tpu_torch.models import layers

    forward = layers.SlimBatchNorm.forward
    monkeypatch.setattr(layers.SlimBatchNorm, "forward",
                        lambda self, x, update_stats=False: forward(self, x, False))
    result = _run(tiny_manifest)
    assert not result["correct"]
    assert result["checks"]["stats_rel"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(tiny_manifest, monkeypatch):
    """The trainer prepares only the first half of each batch (the losses'
    means taken over the rest)."""
    from tecogan_tpu_torch.train import trainer

    prepare = trainer.prepare_batch
    monkeypatch.setattr(trainer, "prepare_batch",
                        lambda hr, config: prepare(hr[: hr.shape[0] // 2], config))
    result = _run(tiny_manifest)
    assert not result["correct"]
    assert result["checks"]["loss_rel"]["value"] > result["checks"]["loss_rel"]["limit"]


@pytest.mark.parametrize("loss", ["vgg_cosine_loss", "pingpong_loss", "d_layer_losses"])
def test_a_loss_altered(tiny_manifest, monkeypatch, loss):
    """One loss term of the generator's scaled by 1.5 where it is made."""
    from tecogan_tpu_torch.train import losses

    made = getattr(losses, loss)

    def scaled(*args):
        out = made(*args)
        return (out[0] * 1.5, out[1]) if isinstance(out, tuple) else out * 1.5

    monkeypatch.setattr(losses, loss, scaled)
    assert not _run(tiny_manifest)["correct"]


def test_bfloat16_reference_fails_the_limits(tiny_manifest):
    """The control: the reference with its convolutions in bfloat16, in the
    program's place, is not correct by at least one limit."""
    spec = tiny_manifest.workload(WORKLOAD)
    traffic = dict(tiny_manifest.traffic(spec["traffic"]), **TINY)
    cell = tiny_manifest.kind("gan").Cell(tiny_manifest.config(spec["config"]), traffic, SEED,
                                          torch.device("cpu"), 1)
    cell.setup()
    cell.window(0.2, Tracer(False))
    cell.release()
    gc.collect()
    assert all(c.ok for c in cell.check())
    control = cell.check(got=cell.reference("bfloat16"))
    failed = [c.name for c in control if not c.ok]
    assert failed, {c.name: c.value for c in control}


def test_gate_counter_over_the_window(tiny_manifest):
    """``d_updates`` is the state's ``counter_with_d`` after the window less
    its reading before: the window's steps whose gate was open."""
    spec = tiny_manifest.workload(WORKLOAD)
    traffic = dict(tiny_manifest.traffic(spec["traffic"]), **TINY)
    cell = tiny_manifest.kind("gan").Cell(tiny_manifest.config(spec["config"]), traffic, SEED,
                                          torch.device("cpu"), 1)
    cell.setup()
    try:
        cell.window(0.2, Tracer(False))
        state, c = cell.state, cell.counters()
        assert int(state.counter_with_d) + int(state.counter_wo_d) == 3 + c["window_steps"]
        assert c["d_updates"] == int(state.counter_with_d) - sum(cell.gates)
        assert 0 <= c["d_updates"] <= c["window_steps"] == cell.steps > 0
    finally:
        cell.release()


# ----------------------------------------------------------------- trace
def _profiled():
    """A CPU profile of named spans around ops, ops of one name nested
    (``aten::sum`` calls itself), and the harness's window marks."""
    x = torch.randn(32, 32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("portbench.trace_start"):
            pass
        for i in range(20):
            with torch.profiler.record_function(f"tecogan.train.step{i % 3}"):
                torch.relu(x @ x).sum()
        with torch.profiler.record_function("portbench.trace_stop"):
            pass
    return prof


def _key(e):
    return (e.name, e.device_type, e.time_range.start, e.time_range.end, e.is_user_annotation)


def test_raw_events_are_the_profilers():
    """The raw events hold every event of the profiler's ``events()`` with
    the same name, kind and times, in its order; the ones it adds are host
    ops inside a parent of their own name; the summary is the same."""
    from portbench.harness.trace import summarize
    from portbench.harness.raw_trace import _Finished

    prof = _profiled()
    finished = _Finished(prof)
    raw = finished.events()
    assert finished.events() is raw  # read once
    want = [_key(e) for e in prof.events()]
    got = [_key(e) for e in raw]
    it = iter(got)
    assert all(k in it for k in want)  # a subsequence, in order
    extra = [e for e in raw if _key(e) not in set(want)]
    for e in extra:
        assert any(p is not e and p.name == e.name and p.time_range.start <= e.time_range.start
                   and e.time_range.end <= p.time_range.end for p in raw)
    marks = {e.name: e.time_range.start for e in raw if e.name.startswith("portbench.")}
    for lo, hi in ((marks["portbench.trace_start"], marks["portbench.trace_stop"]),
                   (got[len(got) // 3][2], got[len(got) // 2][2])):
        assert summarize(finished, 1.0, lo, hi) == summarize(prof, 1.0, lo, hi)


# ---------------------------------------------------------------- counts
def test_vgg19_by_hand():
    h = w = 128
    want = (h * w * 9 * (3 * 64 + 64 * 64)
            + 64 * 64 * 9 * (64 * 128 + 128 * 128)
            + 32 * 32 * 9 * (128 * 256 + 3 * 256 * 256)
            + 16 * 16 * 9 * (256 * 512 + 3 * 512 * 512)
            + 8 * 8 * 9 * 4 * 512 * 512)
    assert GF.vgg19_macs(h, w) == want == 6_370_099_200  # 6.37 GMAC an image


def test_dst_triplet_by_hand():
    first = 128 * 128 * 9 * 27 * 64
    want = (first + 64 * 64 * 16 * 64 * 64 + 32 * 32 * 16 * 64 * 64
            + 16 * 16 * 16 * 64 * 128 + 8 * 8 * 16 * 128 * 256 + 8 * 8 * 256)
    assert GF.dst_macs(128, 128) == (want, first)
    # An odd size takes SAME's ceiling: 25 -> 13 -> 7 -> 4 -> 2.
    macs, _ = GF.dst_macs(25, 25)
    assert macs == (25 * 25 * 9 * 27 * 64 + 13 * 13 * 16 * 64 * 64 + 7 * 7 * 16 * 64 * 64
                    + 4 * 4 * 16 * 64 * 128 + 2 * 2 * 16 * 128 * 256 + 2 * 2 * 256)


def _count_macs(fn):
    """Multiply-adds of the 2-D convolutions ``fn`` runs."""
    total = [0]
    conv2d = F.conv2d

    def counted(x, w, b=None, stride=1, padding=0, *a, **k):
        out = conv2d(x, w, b, stride, padding, *a, **k)
        total[0] += out.numel() // out.shape[1] * w.shape[0] * w[0].numel()
        return out

    F.conv2d = counted
    try:
        with torch.no_grad():
            fn()
    finally:
        F.conv2d = conv2d
    return total[0]


@pytest.mark.parametrize("h, w", [(32, 32), (40, 24)])
def test_counts_match_the_reference_convs(h, w):
    vgg = RG.make_vgg19(1, "cpu")
    x = torch.rand(1, h, w, 3) * 2 - 1
    assert _count_macs(lambda: RG.vgg_features(vgg, x)) == GF.vgg19_macs(h, w)
    d = RG.make_d_weights(2, "cpu")
    y = torch.rand(1, h, w, 27)
    assert _count_macs(lambda: RG.discriminator(d, y)) == GF.dst_macs(h, w)[0]


def test_gan_step_flops():
    b, n, crop, blocks = 4, 10, 32, 16
    t = 2 * n - 1
    g = b * ((t - 1) * fnet_macs(crop, crop) + t * generator_macs(crop, crop, blocks))
    d, first = GF.dst_macs(128, 128)
    want = 2 * (3 * g + 3 * b * t * GF.vgg19_macs(128, 128) + b * 6 * (9 * d - 2 * first))
    assert GF.gan_step_flops(b, n, crop, blocks) == want
    assert 3.8e12 < want < 3.95e12  # ~3.8 TFLOP: VGG19 2.90, Dst 0.26, G and FNet 0.72


# --------------------------------------------------------------- readers
def test_new_readers():
    m = Manifest()
    trace = {"window_s": 2.0, "busy_s": 1.6, "groups_s": {"library": 0.8, "glue": 0.4}}
    assert m.reader("library_pct.gan")({"trace": trace}) == pytest.approx(50.0)
    assert m.reader("library_pct.gan")({"trace": None}) is None
    read = m.reader("d_update_pct")
    assert read({"counters": {"d_updates": 30, "window_steps": 120}}) == pytest.approx(25.0)
    assert read({"counters": {"window_steps": 120}}) is None  # a program with no reader


def test_entries():
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = Manifest()
    (cfg,) = [c for c in data["configs"] if c["name"] == "tecogan16_gan_f32_resident"]
    assert cfg["reduced"] == ["end_dir"]
    config = m.config(cfg["name"])
    assert (config["num_resblock"], config["gen_channels"], config["batch_size"],
            config["crop_size"], config["rnn_n"], config["pingpong"]) == (16, 64, 4, 32, 10, True)
    assert (config["vgg_scaling"], config["ratio"], config["pp_scaling"], config["d_balance"],
            config["crop_dt"], config["d_layerloss"], config["learning_rate"],
            config["compute_dtype"]) == (0.2, 0.01, 0.5, 0.4, 0.75, True, 5e-5, "float32")
    assert [x["name"] for x in m.end_to_end(WORKLOAD)] == ["step_ms", "setup_s"]
    assert [x["name"] for x in m.per_layer(WORKLOAD)] == NEW_METRICS
    for name in NEW_METRICS:
        assert callable(m.reader(name))
    assert not set(NEW_METRICS) & {x["name"] for x in m.per_layer("train_frvsr_resident")}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_control_fails_on_the_card(card, seed):
    """At the cell's own size: the program's sound run is correct, the
    bfloat16 reference in its place is not."""
    m = Manifest()
    spec = m.workload(WORKLOAD)
    cell = m.kind("gan").Cell(m.config(spec["config"]), m.traffic(spec["traffic"]), seed, card, 1)
    cell.setup()
    cell.window(1.0, Tracer(False))
    cell.release()
    gc.collect()
    torch.cuda.empty_cache()
    assert all(c.ok for c in cell.check())
    assert not all(c.ok for c in cell.check(got=cell.reference("bfloat16")))
