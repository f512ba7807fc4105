"""The port's ``.asq`` container, its image-level replay and the demo on
the CPU, modelled on ``tests/test_native_seqio.py``:

- the port's binding: round trip, prefetch in order and on a subrange, a
  corrupt file refused, the CRC catching a flipped payload byte, a build
  without g++ raising and naming it, ``is_available`` as JAX's with and
  without g++ and the source;
- a file written by either package's ``write_frames`` is byte-identical to
  the other's and reads in both;
- ``Sequence.save(image_format="asq")`` / ``load`` and an image-level
  ``replay_sequence`` from the ``.asq``, grey and colour: the container is
  the JAX package's byte for byte, the streamed detections equal the npz
  sequence's bit for bit and the trajectory is the same; against the JAX
  package's ``detect_frames_asq`` / ``replay_sequence`` of its own ``.asq``
  ids and valid are equal, corners within 1e-3 px, the trajectory within
  1e-4 (``tests/test_torch_image_replay.py``'s bounds);
- ``simulate --level images --image-format asq`` then ``replay --level
  images`` through the port's CLI: the JAX CLI's JSON on the same file;
- ``python -m aruco_slam_tpu_torch.demo``'s ``main`` at 5 s on the CPU
  writes its map and plot.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from aruco_slam_tpu import cli as jcli
from aruco_slam_tpu import runner as jrunner
from aruco_slam_tpu.io import native_seqio as jseqio
from aruco_slam_tpu.io.sequence import Sequence as JSequence
from aruco_slam_tpu.ops.camera import CameraIntrinsics as JCamera
from aruco_slam_tpu.sim import synthetic as jsyn
from aruco_slam_tpu.utils import config as jconfig
from aruco_slam_tpu_torch import cli, convert, demo, runner
from aruco_slam_tpu_torch.io import map_io, native_seqio
from aruco_slam_tpu_torch.io.sequence import Sequence

torch.set_num_threads(1)

CORNER_TOL = 1e-3  # px
TRAJ_TOL = 1e-4
JCFG = jconfig.SlamConfig(ekf=jconfig.EkfConfig(max_landmarks=16, max_observations_per_frame=24))
CFG = convert.config_from_dict(dataclasses.asdict(JCFG))


def test_write_read_roundtrip(tmp_path, rng):
    frames = rng.integers(0, 255, size=(12, 48, 64), dtype=np.uint8)
    path = str(tmp_path / "seq.asq")
    native_seqio.write_frames(path, frames)
    with native_seqio.NativeSequenceReader(path) as r:
        assert (r.n_frames, r.height, r.width) == (12, 48, 64)
        assert r.verify()
        for i in (0, 5, 11):
            np.testing.assert_array_equal(r.read(i), frames[i])
        with pytest.raises(IndexError):
            r.read(12)


def test_prefetch_in_order(tmp_path, rng):
    frames = rng.integers(0, 255, size=(40, 32, 32), dtype=np.uint8)
    path = str(tmp_path / "seq.asq")
    native_seqio.write_frames(path, frames)
    with native_seqio.NativeSequenceReader(path) as r:
        seen = []
        for idx, frame in r.iter_prefetched(threads=4, queue=4):
            seen.append(idx)
            np.testing.assert_array_equal(frame, frames[idx])
        assert seen == list(range(40))


def test_prefetch_subrange(tmp_path, rng):
    frames = rng.integers(0, 255, size=(20, 16, 16), dtype=np.uint8)
    path = str(tmp_path / "seq.asq")
    native_seqio.write_frames(path, frames)
    with native_seqio.NativeSequenceReader(path) as r:
        assert [i for i, _ in r.iter_prefetched(start=5, end=15)] == list(range(5, 15))


def test_corrupt_file_rejected(tmp_path):
    path = str(tmp_path / "bad.asq")
    with open(path, "wb") as f:
        f.write(b"NOPE" + b"\0" * 100)
    with pytest.raises(IOError):
        native_seqio.NativeSequenceReader(path)


def test_crc_detects_corruption(tmp_path, rng):
    frames = rng.integers(0, 255, size=(4, 8, 8), dtype=np.uint8)
    path = str(tmp_path / "seq.asq")
    native_seqio.write_frames(path, frames)
    with open(path, "r+b") as f:
        f.seek(40)  # in the payload
        f.write(b"\xff\xff")
    with native_seqio.NativeSequenceReader(path) as r:
        assert not r.verify()


def test_build_without_gxx_names_the_compiler(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native_seqio, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_seqio, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native_seqio.write_frames(str(tmp_path / "f.asq"), np.zeros((1, 4, 4), np.uint8))
    assert not (tmp_path / "f.asq").exists()


@pytest.mark.parametrize("missing", [None, "g++", "source"])
def test_is_available_matches_jax(monkeypatch, tmp_path, missing):
    """``is_available`` as JAX's: True where the library builds and loads;
    False, without raising, where g++ or the source is missing (each
    package made to build afresh in a temporary directory); the port's
    ``_load`` still raises for the callers that need the library."""
    if missing is not None:
        monkeypatch.setattr(native_seqio, "_lib", None)
        monkeypatch.setattr(native_seqio, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(jseqio, "_lib", None)
        monkeypatch.setattr(jseqio, "_BUILD", str(tmp_path / "jbuild"))
        monkeypatch.setattr(jseqio, "_LIB_PATH", str(tmp_path / "jbuild" / "libseqio.so"))
    if missing == "g++":
        monkeypatch.setenv("PATH", str(tmp_path))
    elif missing == "source":
        monkeypatch.setattr(native_seqio, "SOURCE", tmp_path / "seqio.cpp")
        monkeypatch.setattr(jseqio, "_SRC", str(tmp_path))
    assert native_seqio.is_available() is jseqio.is_available() is (missing is None)
    if missing is not None:
        with pytest.raises((RuntimeError, OSError)):
            native_seqio._load()


def test_asq_files_interchange_with_the_jax_package(tmp_path, rng):
    frames = rng.integers(0, 255, size=(6, 24, 40), dtype=np.uint8)
    theirs, ours = str(tmp_path / "jax.asq"), str(tmp_path / "port.asq")
    jseqio.write_frames(theirs, frames)
    native_seqio.write_frames(ours, frames)
    assert open(theirs, "rb").read() == open(ours, "rb").read()
    for reader, path in ((native_seqio.NativeSequenceReader, theirs),
                         (jseqio.NativeSequenceReader, ours)):
        with reader(path) as r:
            assert r.verify() and (r.n_frames, r.height, r.width) == (6, 24, 40)
            np.testing.assert_array_equal(np.stack([f for _, f in r.iter_prefetched()]), frames)


@pytest.fixture(scope="module")
def jseq():
    """test_native_seqio.py's image-level sequence, cut to 1 s (10 frames)."""
    cam = JCamera.create(600.0, 600.0, 320.0, 240.0)
    return jsyn.generate_sequence(jsyn.SimParams(duration=1.0, seed=3, max_obs=8),
                                  level="images", camera=cam)


def _colour(grey):
    """A BGR stack whose channels differ, as test_native_seqio.py makes it."""
    g = np.asarray(grey, np.float32)
    return np.stack([np.clip(g * 0.9, 0, 255), np.clip(g * 1.05, 0, 255), g],
                    axis=-1).astype(np.uint8)


@pytest.fixture(scope="module", params=["grey", "colour"])
def saved(request, jseq, tmp_path_factory):
    """The sequence saved by the port (npz and asq) and by the JAX package
    (asq), in grey or colour."""
    d = tmp_path_factory.mktemp(request.param)
    images = jseq.images if request.param == "grey" else _colour(jseq.images)
    theirs = dataclasses.replace(jseq, images=images, meta=dict(jseq.meta))
    theirs.save(str(d / "jax.npz"), image_format="asq")
    ours = Sequence(**{f.name: getattr(jseq, f.name) for f in dataclasses.fields(Sequence)
                       if f.name not in ("images", "meta")}, images=images, meta=dict(jseq.meta))
    ours.save(str(d / "npz.npz"))
    ours.save(str(d / "asq.npz"), image_format="asq")
    return d


def test_asq_replay_equals_npz_and_the_jax_package(saved):
    s_npz, s_asq = Sequence.load(str(saved / "npz.npz")), Sequence.load(str(saved / "asq.npz"))
    path = s_asq.meta["images_asq_path"]
    assert s_asq.images is None and path == str(saved / "asq.asq")
    assert open(path, "rb").read() == open(saved / "jax.asq", "rb").read()

    got = runner.detect_frames_asq(path, chunk=4, device="cpu")
    want = runner.detect_frames(torch.as_tensor(s_npz.images), chunk=4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got[2].any())
    r_asq = runner.replay_sequence(s_asq, CFG, level="images", device="cpu")
    r_npz = runner.replay_sequence(s_npz, CFG, level="images", device="cpu")
    assert torch.equal(r_asq.trajectory, r_npz.trajectory)

    j = JSequence.load(str(saved / "jax.npz"))
    j_ids, j_corners, j_valid = jrunner.detect_frames_asq(j.meta["images_asq_path"], chunk=4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(j_valid))
    v = got[2].numpy()
    np.testing.assert_allclose(got[1].numpy()[v], np.asarray(j_corners)[v], atol=CORNER_TOL)
    ref = jrunner.replay_sequence(j, JCFG, level="images")
    np.testing.assert_allclose(r_asq.trajectory.numpy(), np.asarray(ref.trajectory), atol=TRAJ_TOL)
    np.testing.assert_array_equal(r_asq.n_landmarks.numpy(), np.asarray(ref.n_landmarks))


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_simulate_asq_then_replay_images(tmp_path, capsys):
    seq_path = str(tmp_path / "seq.npz")
    cli.main(["simulate", "--out", seq_path, "--duration", "1", "--seed", "2", "--level",
              "images", "--image-format", "asq", "--device", "cpu"])
    assert _last_json(capsys) == {"frames": 10, "out": seq_path, "level": "images"}
    assert (tmp_path / "seq.asq").exists()
    assert "images" not in np.load(seq_path).files
    common = ["--max-landmarks", "16", "--max-obs", "16", "--level", "images"]
    cli.main(["replay", "--sequence", seq_path, "--device", "cpu", *common])
    ours = _last_json(capsys)
    jcli.main(["replay", "--sequence", seq_path, *common])
    ref = _last_json(capsys)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-4, err_msg=k)


def test_demo_writes_its_map_and_plot(tmp_path):
    out = demo.main(str(tmp_path / "demo"), device="cpu", duration=5.0)
    m = out["metrics"]
    assert len(map_io.load_map(out["map"])) == m["n_landmarks"] > 0
    assert m["ate"] < 0.1 and m["diverged"] == 0
    assert out["ba_cost"][1] < out["ba_cost"][0]
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert out["plot"] is None
    else:
        assert os.path.getsize(out["plot"]) > 0
