"""The whole command at a tiny size through the port's plain versions on
the CPU, its refusals, and what it loads; on a card, the command itself."""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run as runmod
from portbench.spec import HERE, ROOT

CELLS = ["arena20_corners_b4096", "tour100_stream", "tour100_corners_b256", "arena20_images_b32"]
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_through_the_plain_versions(cell, tiny):
    seconds = 0.05
    res = runmod.run(cell, 2**31 + 11, seconds, False, "cpu", spec=tiny)
    assert set(res) == RESULT_KEYS and list(res)[-1] == "checks"
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, res["checks"]
    names = {m["name"] for m in tiny.metrics("end_to_end", cell)}
    assert set(res["metrics"]) == names
    assert all(m["value"] > 0 and math.isfinite(m["value"]) for m in res["metrics"].values())
    for row in res["checks"].values():
        assert row["value"] <= row["limit"]


def test_the_same_seed_makes_the_same_inputs(tiny):
    from portbench.cell import Cell

    w = tiny.workload("arena20_corners_b4096")
    cfg, tr = tiny.config(w["config"]), tiny.traffic(w["traffic"])
    a, b = Cell(cfg, tr, 2**31 + 5, "cpu"), Cell(cfg, tr, 2**31 + 5, "cpu")
    c = Cell(cfg, tr, 2**31 + 6, "cpu")
    assert (a.enc_w == b.enc_w).all() and (a.corners == b.corners).all()
    assert not (a.enc_w == c.enc_w).all()
    assert a.ids.shape == c.ids.shape


def test_a_fixed_join_gives_every_seed_the_same_markers(tiny):
    """With ``join_s`` (the stream's traffic) two seeds replay the same
    markers in the same frames, with other noise; without it, the seed
    also moves the start."""
    from portbench.cell import Cell

    w = tiny.workload("tour100_stream")
    cfg, tr = tiny.config(w["config"]), tiny.traffic(w["traffic"])
    assert tr["join_s"] == 0.0
    a, b = Cell(cfg, tr, 2**31 + 5, "cpu"), Cell(cfg, tr, 2**31 + 6, "cpu")
    assert (a.ids == b.ids).all() and (a.valid == b.valid).all() and a.valid.any()
    assert not (a.z == b.z).all() and not (a.enc_w == b.enc_w).all()
    free = {k: v for k, v in tr.items() if k != "join_s"}
    c, d = Cell(cfg, free, 2**31 + 5, "cpu"), Cell(cfg, free, 2**31 + 6, "cpu")
    assert not (c.base["poses"] == d.base["poses"]).all()


def _python(code: str, cwd) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=env)


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    from portbench.tests.conftest import tiny_copy

    tiny_copy(tmp_path / "t")
    code = (
        "import sys, pathlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import run\n"
        "from portbench.spec import Spec\n"
        f"root = pathlib.Path({str(tmp_path / 't')!r})\n"
        "spec = Spec(root, root / 'portbench')\n"
        "res = run.run('tour100_stream', 3, 0.05, False, 'cpu', spec=spec)\n"
        "assert res['correct']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', "
        "'aruco_slam_tpu', 'aruco_slam_tpu_torch'}))\n"
        "print(run.loaded_forbidden())\n"
    )
    out = _python(code, tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-3:-1] == ["['aruco_slam_tpu_torch']", "[]"]


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "aruco_slam_tpu_torch_x", sys)
    assert "aruco_slam_tpu" not in runmod.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "aruco_slam_tpu.runner", sys)
    assert runmod.loaded_forbidden() == ["aruco_slam_tpu"]


def test_no_card_no_result(tmp_path):
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "tour100_stream",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_only_the_benchmark_files_no_result(tmp_path):
    """In a checkout that holds only BENCHMARK.json and the harness, the
    port is missing: the run fails before any result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys\nsys.path.insert(0, '.')\nfrom portbench import run\n"
            "print(run.run('tour100_stream', 1, 0.05, False, 'cpu'))\n")
    out = _python(code, tmp_path)
    assert out.returncode != 0 and "ModuleNotFoundError" in out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_the_command_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "tour100_stream",
                          "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res
    assert list(res)[-1] == "checks"
