"""The port's program spans (``utils.logging``'s recorder) at the
boundaries of the runner and the detector: results bit-equal with
recording on and off, the spans' tree, nothing recorded while off, the
recorder that follows a torch.profiler session, and the benchmark's span
readers and idle-gap labels (``portbench/spans.py``) on hand-placed
traces."""

import pytest
import torch

from aruco_slam_tpu_torch import runner
from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
from aruco_slam_tpu_torch.sim import synthetic
from aruco_slam_tpu_torch.utils import logging as slog
from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig
from portbench import spans as pspans
from portbench.spec import Spec
from portbench.trace import Trace

torch.set_num_threads(1)

CFG = SlamConfig(ekf=EkfConfig(max_landmarks=16, max_observations_per_frame=16))
CAM = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
STAGES = ["ccl", "stats", "chain", "union", "subpix", "decode", "dedup"]


@pytest.fixture(scope="module")
def seqs():
    """Two image-level sequences of 5 frames (1 s at 5 frames/s)."""
    return [synthetic.generate_sequence(synthetic.SimParams(seed=s, duration=1.0,
                                                            frames_per_sec=5.0),
                                        level="images", camera=CAM, device="cpu")
            for s in range(2)]


@pytest.fixture(autouse=True)
def recording_off():
    slog.RECORDER = None
    yield
    slog.RECORDER = None


def _call(entry, level, seqs):
    if entry == "replay_batch":
        data = runner.build_batch_data(seqs, 3, level, "cpu")
        return lambda: runner.replay_batch(data, CFG, CAM, level, det_chunk=8)
    data = runner.replay_data_from_sequence(seqs[0], level, "cpu")
    return lambda: runner.replay(data, CFG, CAM, level, det_chunk=8)


def _flat(result):
    return [*result[:3], *result.final_state]


@pytest.mark.parametrize("entry,level", [("replay_batch", "obs"), ("replay_batch", "corners"),
                                         ("replay_batch", "images"), ("replay", "obs"),
                                         ("replay", "corners")])
def test_recording_leaves_the_results_bit_equal(entry, level, seqs):
    call = _call(entry, level, seqs)
    off = call()
    slog.RECORDER = rec = slog.Recorder()
    on = call()
    assert rec.names and len(rec.closed()) == len(rec.names) and rec.current == -1
    for a, b in zip(_flat(off), _flat(on), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("entry", ["replay_batch", "replay"])
def test_a_replay_call_is_one_root_over_its_frame_steps(entry, seqs):
    call = _call(entry, "obs", seqs)
    slog.RECORDER = rec = slog.Recorder()
    call()
    call()
    spans = rec.closed()
    F = seqs[0].obs_ids.shape[0]
    roots = [s for s in spans if s.parent is None]
    assert [(r.name, r.call) for r in roots] == [("replay", 1), ("replay", 2)]
    lanes = 3 if entry == "replay_batch" else 1
    assert all(r.counts == {"frames": F, "lanes": lanes} for r in roots)
    own = slog.self_ns(spans)
    for root in roots:
        kids = [s for s in spans if s.call == root.call and s is not root]
        assert all(s.parent is root for s in kids)
        assert [s.name for s in kids] == ["replay.setup"] + ["replay.frame"] * F
        assert all(s.counts == {"frames": 1} for s in kids[1:])
        assert all(a.end <= b.start for a, b in zip(kids, kids[1:]))
        assert root.start <= kids[0].start and kids[-1].end <= root.end
        assert own[id(root)] == root.ns - sum(s.ns for s in kids)
        assert all(own[id(s)] == s.ns for s in kids)
    rows = {r[0]: r for r in slog.summary(spans)}
    assert rows["replay.frame"][1] == 2 * F and rows["replay"][1] == 2


def test_self_time_takes_out_the_covered_part_once():
    """Children that overlap one another or run past their parent count
    only the part of the parent they cover."""
    root = slog.Span("replay", 0, None, 1)
    root.end = 100
    spans = [root]
    for a, b in ((10, 30), (20, 40), (90, 120)):
        s = slog.Span("replay.frame", a, root, 1)
        s.end = b
        spans.append(s)
    own = slog.self_ns(spans)
    assert own[id(root)] == 100 - 30 - 10
    assert [own[id(s)] for s in spans[1:]] == [20, 20, 30]
    rows = slog.summary(spans)
    assert [r[:2] for r in rows] == [("replay", 1), ("replay.frame", 3)]
    assert [r[2:] for r in rows] == [pytest.approx((100e-6, 60e-6)), pytest.approx((70e-6, 70e-6))]


def test_recording_off_records_nothing(seqs):
    _call("replay_batch", "images", seqs)()
    assert slog.RECORDER is None and slog.recorder() is None


def test_a_profiler_session_records_until_a_call_after_it(seqs):
    from torch.profiler import ProfilerActivity, profile

    call = _call("replay", "obs", seqs)
    with profile(activities=[ProfilerActivity.CPU]):
        call()
    rec = slog.RECORDER
    assert rec is not None and rec.follows_profiler
    assert [s.name for s in rec.closed() if s.parent is None] == ["replay"]
    call()
    assert slog.RECORDER is None and len(rec.closed()) == 2 + seqs[0].obs_ids.shape[0]


def test_the_detector_stages_nest_under_their_chunk(seqs):
    images = torch.as_tensor(seqs[0].images)  # 5 frames: chunks of 3 and 2
    slog.RECORDER = rec = slog.Recorder()
    runner.detect_frames(images, chunk=3)
    detect, *rest = spans = rec.closed()
    assert detect.name == "detect" and detect.parent is None and detect.counts == {"frames": 5}
    chunks = [s for s in rest if s.name == "detect.chunk"]
    assert [c.counts for c in chunks] == [{"frames": 3}, {"frames": 2}]
    for c in chunks:
        assert c.parent is detect
        stages = [s for s in rest if s.parent is c]
        assert [s.name for s in stages] == [f"detect.{x}" for x in STAGES]
        assert stages[0].start == c.start and stages[-1].end <= c.end
        assert all(a.end == b.start for a, b in zip(stages, stages[1:]))
    assert len(spans) == len(rec.names) and not rec.cuda_events and slog.stage_ms(spans) == {}


def _span(name, start, end, parent=None, call=1, **counts):
    s = slog.Span(name, start, parent, call, counts or None)
    s.end = end
    return s


def _calls(n_calls=2, first_call=1, t0=0, frames=3, detect=False, x=1):
    """Hand-placed spans of replay calls 1 ms apart: a root of 900 us, a
    setup (and a detect of 300 us over two chunks of 4 frames), then
    ``frames`` frame steps of 100 us; every time ``x`` times that."""
    out = []
    for c in range(first_call, first_call + n_calls):
        at = t0 + (c - first_call) * 1_000_000 * x
        root = _span("replay", at, at + 900_000 * x, None, c, frames=frames, lanes=2)
        out.append(root)
        if detect:
            det = _span("detect", at + 10_000 * x, at + 310_000 * x, root, c, frames=8)
            out.append(det)
            for k in range(2):
                out.append(_span("detect.chunk", at + (10_000 + k * 150_000) * x,
                                 at + (150_000 + k * 150_000) * x, det, c, frames=4))
        setup = at + (320_000 if detect else 10_000) * x
        out.append(_span("replay.setup", setup, setup + 50_000 * x, root, c))
        for f in range(frames):
            s = setup + (100_000 + f * 100_000) * x
            out.append(_span("replay.frame", s, s + 100_000 * x, root, c, frames=1))
    return out


@pytest.mark.parametrize("metric,detect,expected", [
    ("host_frame_us.batch", False, 100.0),
    ("host_frame_us.stream", False, 100.0),
    ("replay_setup_ms.batch", False, 0.11),
    ("replay_setup_ms.images", True, 0.12),
    ("detector_host_ms_per_frame", True, 0.14 / 4),
])
def test_the_span_readers_on_hand_placed_spans(metric, detect, expected):
    """The readers take the trace's last ``calls`` roots (an earlier try of
    a widened window left call 1), and read nothing where the program
    records no spans."""
    spans = _calls(1, 1, 0, frames=2, detect=detect, x=3) + _calls(2, 2, 5_000_000, detect=detect)
    t = Trace([], 1.0, 2, 3, 2)
    read = Spec().reader("layers", metric)
    assert read(t) is None
    slog.RECORDER = rec = slog.Recorder()
    rec.closed = lambda: spans
    assert read(t) == pytest.approx(expected)
    assert read(Trace([], 1.0, 4, 3, 2)) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    monkeypatch.delattr(slog, "RECORDER")
    assert pspans.recorded() is None
    assert Spec().reader("layers", "host_frame_us.batch")(Trace([], 1.0, 1, 1, 1)) is None


def test_idle_gaps_are_named_by_the_span_open_on_the_host():
    """A window of 0-100 ns around one call: the idle stretches fall under
    the setup, the frame steps and the caller's loop (``outside``); they
    sum to the window less the device's busy time."""
    root = _span("replay", 10, 90)
    spans = [root, _span("replay.setup", 10, 30, root)]
    spans += [_span("replay.frame", a, a + 20, root, frames=1) for a in (30, 50, 70)]
    events = [("K1", 35, 60), ("K2", 55, 62), ("K6", 72, 80)]
    window = (0, 95)
    gaps = pspans.idle_intervals(events, window)
    assert gaps == [(0, 35, "K1", None), (62, 72, "K6", "K2"), (80, 95, None, "K6")]
    split = pspans.idle_by_span(events, spans, window)
    assert split == {"outside": 10 + 5, "replay.setup": 20, "replay.frame": 5 + 10 + 10}
    busy = Trace([(n, a / 1e3, b / 1e3) for n, a, b in events], 0, 1, 1, 1).busy_us() * 1e3
    assert sum(split.values()) == pytest.approx(window[1] - busy)
    assert pspans.labelled_gaps(events, spans, window) == [
        ["replay.setup: before K1", 35e-9], ["replay.frame: after K6", 15e-9],
        ["replay.frame: before K6", 10e-9]]
    assert pspans.labelled_gaps(events, [], window)[0] == ["outside: before K1", 35e-9]
