"""The traced run's reading of the card: ``torch.profiler`` over whole calls
of the cell's entry, device activity only, with idle pads at both ends of
the window (a frozen copy of ``chip_smoke.py``'s ``_profiled`` and
``_device_busy``: the profiler has placed device events before their
launches and dropped those that fell outside its window, and a profile
that also traced the host made later ones drop events).

What the layer readers (``layers/<metric>.py``) read is a :class:`Trace`.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import torch

PADS_S = (1.0, 3.0)  # idle seconds at each end of the window, tried in turn


@dataclass
class Trace:
    """One traced window: its device events ``(name, start_us, end_us)``,
    the host clock's seconds from the first call to the last call's
    synchronize, and what the readers need of the cell."""

    events: list
    window_s: float
    calls: int
    frames: int  # frame steps a call (the replay's frames)
    lanes: int
    bounds: dict = field(default_factory=dict)  # kernel family -> bound seconds a call
    stage_ms: list = field(default_factory=list)  # per detector call: {stage: ms}
    detected_frames: int = 0  # frames a call detects
    traffic: dict = field(default_factory=dict)  # the cell's traffic file

    def busy_us(self) -> float:
        """Device-busy microseconds: the union of the events' intervals."""
        busy, last = 0.0, float("-inf")
        for _, start, end in sorted(self.events, key=lambda e: e[1]):
            if end > last:
                busy += end - max(start, last)
                last = end
        return busy

    def kernel_s(self, part: str) -> float:
        """Device seconds of the events whose names hold ``part``."""
        return sum(end - start for name, start, end in self.events if part in name) / 1e6

    def count(self, part: str = "") -> int:
        return sum(part in name for name, _, _ in self.events)

    @staticmethod
    def short(name: str) -> str:
        """A kernel's name without its namespace noise and arguments, and
        without its template arguments where they run long."""
        name = name.replace("void ", "").replace("(anonymous namespace)::", "")
        name = name.split("(", 1)[0]
        return name.split("<", 1)[0] if len(name) > 80 else name

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the operation that ended it."""
        by_name = {}
        for name, start, end in self.events:
            name = self.short(name)
            by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, last = [], None
        for name, start, end in sorted(self.events, key=lambda e: e[1]):
            if last is not None and start > last:
                gaps.append((f"before {self.short(name)}", (start - last) / 1e6))
            last = end if last is None else max(last, end)
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [list(x) for x in ops], "idle_gaps": [list(x) for x in gaps[:top]]}


def _device_events(prof) -> list:
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


class PartialTrace(RuntimeError):
    """The profiler kept fewer device events than the calls launched, in
    every window tried: a trace that would read too little device time."""


def profile_calls(call, calls: int, expected: int, part: str, reset=None):
    """Run ``call`` ``calls`` times under the profiler; where fewer than
    ``expected`` events of ``part`` came back, once more in a wider window
    (``reset()`` first, where given, before each try). Returns (device
    events, host seconds of the calls, the last output); raises
    :class:`PartialTrace` where the widest window still kept fewer."""
    from torch.profiler import ProfilerActivity, profile

    for pad in PADS_S:
        if reset is not None:
            reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            t0 = time.perf_counter()
            for _ in range(calls):
                out = call()
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
            time.sleep(pad)
        events = _device_events(prof)
        got = sum(part in e[0] for e in events)
        if got >= expected:
            return events, window, out
        print(f"portbench: the profiler kept {got} of {expected} events of {part} in a "
              f"{pad} s pad", file=sys.stderr, flush=True)
    raise PartialTrace(f"the profiler kept {got} of {expected} events of {part} in every "
                       f"window tried ({', '.join(str(p) for p in PADS_S)} s pads)")
