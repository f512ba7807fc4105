"""Where the harness finds what a cell names: ``BENCHMARK.json`` at the
root of the checkout, and beside this file ``configs/<config>.json``,
``traffic/<traffic>.json``, ``end_to_end/<metric>.py`` and
``layers/<metric>.py`` (a metric ``<family>.<cells>`` without a file of its
own is read by ``<family>.py``). Nothing here knows a cell, a deployment or a
metric by name, so a later change adds one by adding files and an entry
in ``BENCHMARK.json``."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Spec:
    """The benchmark's entries, read from ``root`` (the checkout) and its
    data files from ``here`` (the harness's folder)."""

    def __init__(self, root: Path = ROOT, here: Path = HERE):
        self.root, self.here = Path(root), Path(here)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return json.loads((self.here / "configs" / f"{name}.json").read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.here / "traffic" / f"{name}.json").read_text())

    def metrics(self, kind: str, workload: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries that ``workload``
        reports: those that list it, or list no cells."""
        return [m for m in self.bench[kind] if workload in m.get("workloads", [workload])]

    def reader(self, folder: str, metric: str):
        """The ``read`` function of ``<folder>/<metric>.py`` (``end_to_end``
        or ``layers``), or of its family's ``<folder>/<family>.py`` where
        ``metric`` is ``<family>.<cells>`` and has no file of its own."""
        path = self.here / folder / f"{metric}.py"
        if not path.is_file() and "." in metric:
            path = self.here / folder / f"{metric.split('.', 1)[0]}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
