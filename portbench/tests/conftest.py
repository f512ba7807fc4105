"""Fixtures of the benchmark's tests: a copy of the harness's data files
cut to a size the CPU replays in seconds, and the card check of the tests
that need one."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from portbench.spec import HERE, ROOT, Spec

DATA = ("configs", "traffic", "end_to_end", "layers", "entries")


def tiny_copy(dest: Path, seconds: float = 2.0, lanes: int = 4, distinct: int = 2) -> Spec:
    """``BENCHMARK.json`` and the harness's data files under ``dest``, every
    run ``seconds`` long and every cell at most ``lanes`` lanes of
    ``distinct`` sequences; the harness's code stays the package's."""
    (dest / "portbench").mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for d in DATA:
        shutil.copytree(HERE / d, dest / "portbench" / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for p in (dest / "portbench" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c["duration_s"] = seconds
        p.write_text(json.dumps(c))
    for p in (dest / "portbench" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t["lanes"], t["distinct"] = min(t["lanes"], lanes), min(t["distinct"], distinct)
        t["trace_calls"] = 1
        if t["check_lanes"] != "all":
            t["check_lanes"] = min(t["check_lanes"], lanes)
        p.write_text(json.dumps(t))
    return Spec(dest, dest / "portbench")


@pytest.fixture
def tiny(tmp_path) -> Spec:
    return tiny_copy(tmp_path)


@pytest.fixture
def card():
    """Skips a test that needs an NVIDIA GPU where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda")
