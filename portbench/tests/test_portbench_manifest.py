"""BENCHMARK.json against the benchmark's contract, and the harness finding
configurations, traffic mixes and per-layer metrics by name, a new cell
from a fixture directory included."""

import json
import re
import shutil

import pytest

from portbench.harness.manifest import BENCH_DIR, ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def data():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(data):
    assert set(data) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert data["command"] == ["python3", "portbench/run.py"]
    assert data["paths"] == ["portbench"]
    assert 1 <= data["run_seconds"] <= 51 and isinstance(data["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units(data):
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in data[key]]
    assert all(NAME.match(n) for n in names), names
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in data[key]]
        assert len(got) == len(set(got)), key
    for m in data["end_to_end"] + data["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in data["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["unit"] for m in data["end_to_end"]} == {
        "frames_per_s": "frames/s", "frames_per_s.vid4": "frames/s", "frame_p95_ms": "ms",
        "step_ms": "ms", "setup_s": "s"}


def test_entry_keys_and_text(data):
    for c in data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert NAME.match(w["traffic"])
    for m in data["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in data["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    texts = [x["why"] for key in ("configs", "workloads") for x in data[key]]
    texts += [c["source"] for c in data["configs"]] + [m["layer"] for m in data["per_layer"]]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


def test_every_cell_reports_what_it_must(data):
    manifest = Manifest()
    configs = {c["name"] for c in data["configs"]}
    e2e_names = {m["name"] for m in data["end_to_end"]}
    used = set()
    for w in data["workloads"]:
        used.add(w["config"])
        e2e = {m["name"] for m in manifest.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = manifest.per_layer(w["name"])
        assert per
        for m in per:
            assert m["moves"] in e2e
    assert used == configs
    for m in data["per_layer"]:
        assert m["moves"] in e2e_names
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"


def test_files_found_by_name(data):
    manifest = Manifest()
    for w in data["workloads"]:
        cfg = manifest.config(w["config"])
        traffic = manifest.traffic(w["traffic"])
        assert hasattr(manifest.kind(traffic["kind"]), "Cell")
        assert cfg["num_resblock"] in (10, 16)
        for key in ("lr_height", "height"):
            if key in traffic:
                assert traffic[key] > 0
    for m in data["per_layer"]:
        assert callable(manifest.reader(m["name"]))
        own = BENCH_DIR / "metrics" / f"{m['name']}.py"
        base = BENCH_DIR / "metrics" / f"{m['name'].split('.', 1)[0]}.py"
        assert own.is_file() or base.is_file()


def test_a_cell_and_metric_added_as_files(tmp_path):
    """A later cell is files and entries only: a traffic mix, a
    configuration and a per-layer metric, found by name."""
    root = tmp_path / "checkout"
    bench = root / "portbench"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    (bench / "configs" / "tecogan10_bf16.json").write_text(json.dumps(
        dict(json.loads((bench / "configs" / "tecogan16_bf16.json").read_text()),
             num_resblock=10)))
    (bench / "traffic" / "clips_720p.json").write_text(json.dumps(
        dict(json.loads((bench / "traffic" / "clips_vid4.json").read_text()),
             lr_height=180, lr_width=320, metric="frames_per_s")))
    (bench / "metrics" / "frames_traced.stream.py").write_text(
        "def read(ctx):\n    return ctx['counters'].get('frames_processed')\n")
    (bench / "metrics" / "pool_mib.py").write_text(
        "def read(ctx):\n    return ctx['cell'].pool_bytes / 2 ** 20\n")
    data["configs"].append({"name": "tecogan10_bf16", "source": "x",
                            "file": "portbench/configs/tecogan10_bf16.json",
                            "reduced": ["num_resblock"], "why": "x"})
    data["workloads"].append({"name": "stream_720p", "config": "tecogan10_bf16",
                              "traffic": "clips_720p", "chips": 1, "why": "x"})
    data["per_layer"].append({"name": "frames_traced.stream", "unit": "frames",
                              "better": "higher", "source": "program_counter",
                              "layer": "streaming engine", "moves": "frames_per_s",
                              "workloads": ["stream_720p"]})
    for m in data["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("stream_720p")
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    manifest = Manifest(root, bench)
    assert manifest.config(manifest.workload("stream_720p")["config"])["num_resblock"] == 10
    assert manifest.traffic("clips_720p")["lr_width"] == 320
    names = [m["name"] for m in manifest.per_layer("stream_720p")]
    assert "frames_traced.stream" in names and "glue_pct.stream" not in names
    assert [m["name"] for m in manifest.end_to_end("stream_720p")] == ["frames_per_s", "setup_s"]
    assert manifest.reader("frames_traced.stream")({"counters": {"frames_processed": 7}}) == 7
    # a suffixed name with no file of its own is read by its base's file,
    # and a reader reaches a program counter through the cell
    assert manifest.reader("glue_pct.stream_720p").__module__ == "portbench_metric_glue_pct"
    cell = type("Cell", (), {"pool_bytes": 3 * 2 ** 20})()
    assert manifest.reader("pool_mib.stream_720p")({"cell": cell}) == 3
    assert "frames_traced.stream" not in [m["name"] for m in manifest.per_layer("stream_vid4")]
