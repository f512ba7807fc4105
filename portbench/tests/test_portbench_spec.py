"""``BENCHMARK.json`` against the rules its fields keep, and the harness
finding a configuration, traffic mix or metric by its name alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import run as runmod
from portbench.spec import HERE, ROOT, Spec
from portbench.trace import Trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    b = _bench()
    assert set(b) == KEYS
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert len(b["command"]) <= 32 and all(_line(w) and not w.startswith("/") for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_lines(kind):
    b = _bench()
    entries = b[kind]
    assert entries and len({e["name"] for e in entries}) == len(entries)
    allowed = {"configs": CONFIG_KEYS, "workloads": CELL_KEYS, "end_to_end": E2E_KEYS,
               "per_layer": LAYER_KEYS}[kind]
    for e in entries:
        assert set(e) <= allowed and NAME.match(e["name"]), e
        for k in ("why", "layer", "source"):
            if k in e and kind in ("configs", "workloads", "per_layer"):
                assert _line(e[k]), e
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher"), e
        if kind == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"]) and e["chips"] in (1, 4)
        if kind == "configs":
            assert all(NAME.match(k) for k in e["reduced"]) and len(e["reduced"]) <= 16
            assert e["file"].startswith("portbench/") and (ROOT / e["file"]).is_file()


def test_every_cell_reports_setup_another_metric_and_a_layer():
    b = _bench()
    spec = Spec()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for w in b["workloads"]:
        got = [m["name"] for m in spec.metrics("end_to_end", w["name"])]
        assert "setup_s" in got and len(got) >= 2, w["name"]
        layers = spec.metrics("per_layer", w["name"])
        assert layers, w["name"]
        for m in layers:
            assert m["moves"] in got, (w["name"], m["name"])
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert callable(spec.reader("layers", m["name"]))
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    for m in b["end_to_end"]:
        assert callable(spec.reader("end_to_end", m["name"]))


def test_a_metric_of_a_family_is_read_by_its_own_file_or_the_family_s(tmp_path):
    """``<family>.<cells>`` is read by ``<family>.py`` unless it has a file
    of its own; every reader file is some metric's."""
    (tmp_path / "layers").mkdir()
    (tmp_path / "layers" / "share.py").write_text("def read(t):\n    return 1.0\n")
    (tmp_path / "layers" / "share.b.py").write_text("def read(t):\n    return 2.0\n")
    spec = Spec(ROOT, tmp_path)
    assert spec.reader("layers", "share.a")(None) == 1.0
    assert spec.reader("layers", "share.b")(None) == 2.0
    with pytest.raises(FileNotFoundError):
        spec.reader("layers", "other.a")
    b = _bench()
    for kind, folder in (("end_to_end", "end_to_end"), ("per_layer", "layers")):
        names = {m["name"] for m in b[kind]}
        for path in (HERE / folder).glob("*.py"):
            stem = path.name[:-3]
            assert any(n == stem or n.split(".", 1)[0] == stem for n in names), path.name


def test_configs_hold_their_source_and_cuts():
    for c in _bench()["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert data["assumed"] and data["guarantee"] and data["precision"]


def test_added_files_are_found_by_name(tiny, tmp_path):
    """A new deployment, traffic mix and per-layer metric need only new files
    and new entries: the harness runs the new cell and reads the new
    metric with no edit to a file that was there."""
    here = tiny.here
    cfg = json.loads((here / "configs" / "arena20.json").read_text())
    cfg["name"] = "arena12"
    cfg["arena"]["markers"] = 12
    (here / "configs" / "arena12.json").write_text(json.dumps(cfg))
    t = json.loads((here / "traffic" / "corners_b4096.json").read_text())
    t["lanes"], t["distinct"] = 3, 3
    (here / "traffic" / "corners_b3.json").write_text(json.dumps(t))
    (here / "end_to_end" / "mean_replay_ms.py").write_text(
        "def read(window):\n    return 1e3 * sum(window.seconds) / window.calls\n")
    (here / "layers" / "k1_share.py").write_text(
        "def read(t):\n    dev = t.kernel_s('')\n"
        "    return 100 * t.kernel_s('pnp') / dev if dev else None\n")
    b = json.loads((tiny.root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "arena12", "source": "test", "reduced": ["arena"], "why": "test",
                         "file": "portbench/configs/arena12.json"})
    b["workloads"].append({"name": "arena12_corners_b3", "config": "arena12",
                           "traffic": "corners_b3", "chips": 1, "why": "test"})
    b["end_to_end"].append({"name": "mean_replay_ms", "unit": "ms", "better": "lower",
                            "bound": 0.05, "source": "host_clock",
                            "workloads": ["arena12_corners_b3"]})
    b["per_layer"].append({"name": "k1_share", "unit": "%", "better": "lower",
                           "source": "device_trace", "layer": "K1 PnP front-end kernel",
                           "moves": "batch_frames_per_s", "workloads": ["arena12_corners_b3"]})
    for m in b["end_to_end"]:
        if m["name"] in ("batch_frames_per_s",):
            m["workloads"].append("arena12_corners_b3")
    (tiny.root / "BENCHMARK.json").write_text(json.dumps(b))
    spec = Spec(tiny.root, here)
    res = runmod.run("arena12_corners_b3", 12345, 0.1, False, "cpu", spec=spec)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"batch_frames_per_s", "setup_s", "mean_replay_ms"}
    assert res["metrics"]["mean_replay_ms"]["value"] > 0
    layers = spec.metrics("per_layer", "arena12_corners_b3")
    assert [m["name"] for m in layers] == ["k1_share"]
    t = Trace([("pnp_frontend_kernel", 0.0, 30.0), ("ekf_frame_batched", 30.0, 100.0)], 1.0, 1,
              2, 3)
    assert spec.reader("layers", "k1_share")(t) == pytest.approx(30.0)


def test_the_harness_folder_holds_nothing_else():
    b = _bench()
    assert b["paths"] == ["portbench"]
    assert not any(p.name.endswith("_torch") for p in HERE.parents if p != ROOT)
    assert shutil.which("python3") is not None
