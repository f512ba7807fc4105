"""Where the harness finds what a cell names: ``BENCHMARK.json`` at the
root of the checkout, and beside this file ``configs/<config>.json``,
``traffic/<traffic>.json``, ``end_to_end/<metric>.py``,
``layers/<metric>.py`` (a metric ``<family>.<cells>`` without a file of its
own is read by ``<family>.py``) and ``entries/<entry>.py`` (the port's entry
that a traffic file names, other than the replays ``cell.Program`` runs).
Nothing here knows a cell, a deployment, a metric or an entry by name, so a
later change adds one by adding files and an entry in ``BENCHMARK.json``.

An entry's module gives ``Program(cell)`` (called as ``program()``: the
window's unit of work, ending with its output on the device; with
``close()`` and ``launches()``, as ``cell.Program``), ``result(out)`` (the
compared parts of one output), ``reference(cell)`` (the plain reference's,
run after the window), ``numbers(cell, got, ref)`` (each compared number,
limited in the traffic file), ``control(cell)`` (the control's result, in
the program's place) and ``bounds(cell, ref)`` (kernel family -> least
seconds a call, for the roofline readers)."""

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
        return _load(path, f"portbench_{folder}_{metric}").read

    def entry(self, name: str):
        """The module ``entries/<name>.py``."""
        return _load(self.here / "entries" / f"{name}.py", f"portbench_entries_{name}")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
