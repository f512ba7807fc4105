"""The port's frame-batched detector against the JAX package's, stage by
stage and end to end, on rendered marker scenes (the arena and camera of
``tests/test_detector.py``), and on ``tests/test_robustness.py``'s
degraded frames. Both sides get the same numpy frames. Ids,
validity and every integer stage output must be equal; corners agree to
1e-3 px (subpixel refinement and decoding sum floats in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aruco_slam_tpu.ops import detector as jdet
from aruco_slam_tpu.ops import dictionary as jdict
from aruco_slam_tpu.ops.camera import CameraIntrinsics as JCamera
from aruco_slam_tpu.sim import renderer as jrenderer
from aruco_slam_tpu.sim import synthetic as jsyn
from aruco_slam_tpu_torch import convert
from aruco_slam_tpu_torch.ops import detector, dictionary

torch.set_num_threads(1)

CORNER_TOL = 1e-3  # px
POSES = ((2.55, -2.0, 1.2), (2.0, -2.5, 2.5), (1.0, -1.0, 0.3), (3.5, -3.0, -2.0))
CONFIGS = {
    "default": {},
    "no_closing_union": {"closing_union": False},
    "radii_3_7_11": {"adaptive_radii": (3, 7, 11)},
    "stride_3": {"mean_stride": 3},  # the unfused branch: plain threshold, K5, K5s
}


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def scenes():
    cam = JCamera.create(600.0, 600.0, 320.0, 240.0)
    stack = jrenderer.build_marker_stack(jsyn.make_arena(n_markers=20))
    frames = []
    for pose in POSES:
        cam_pos, R_wc = jrenderer.camera_pose_from_robot(jnp.asarray(pose, jnp.float32))
        frames.append(np.asarray(jrenderer.render_frame(cam_pos, R_wc, stack, cam)))
    return np.stack(frames)


@pytest.fixture(scope="module")
def stages(scenes):
    """The JAX stages on scene 0 under the default config, each fed the
    previous stage's JAX output."""
    cfg = jdet.DetectorConfig()
    img = jnp.asarray(scenes[0])
    fg, lab, fg_c, lab_c = jax.jit(
        lambda im: jdet._union_masks_and_labels(im, cfg.adaptive_radius, cfg)
    )(img)
    stats = jdet._component_stats_multi([lab, lab_c], [fg, fg_c], cfg)
    (r_roots, r_bbox, r_valid, _), (c_roots, c_bbox, c_valid, _) = stats
    roots = jnp.concatenate([r_roots, c_roots])
    bbox = jnp.concatenate([r_bbox, c_bbox])
    valid = jnp.concatenate([r_valid, c_valid])
    src = jnp.concatenate([jnp.zeros_like(r_roots), jnp.ones_like(c_roots)])
    labels2 = jnp.stack([lab.reshape(fg.shape), lab_c.reshape(fg.shape)])
    quads, qvalid = jdet.quads_from_candidates(labels2, roots, bbox, valid, cfg, src=src)
    small = jnp.max(jnp.max(quads, 1) - jnp.min(quads, 1), -1) < cfg.subpix_small_extent
    refined = jdet.refine_corners_subpix(img, quads, window=cfg.subpix_window,
                                         iters=cfg.subpix_iters,
                                         window_small=cfg.subpix_window_small, small=small)
    decoded = jdet.decode_candidates(img, refined, cfg)
    return dict(fg=fg, lab=lab, fg_c=fg_c, lab_c=lab_c, stats=stats, roots=roots, bbox=bbox,
                valid=valid, src=src, quads=quads, qvalid=qvalid, small=small,
                refined=refined, decoded=decoded)


@pytest.fixture(scope="module")
def degraded(scenes):
    """Scene 0 (``tests/test_robustness.py``'s scene) three ways degraded, as
    that file does: sensor noise of sigma 8 from a numpy seed, a 0.55-1.2
    illumination ramp across the width, and a 3x3 box blur."""
    img = scenes[0].astype(np.float32)
    noisy = img + np.random.default_rng(8).normal(scale=8.0, size=img.shape)
    ramp = img * (0.55 + 0.65 * np.linspace(0, 1, img.shape[1])[None, :])
    pad = np.pad(img, 1, mode="edge")
    blur = sum(pad[1 + dy: 1 + dy + img.shape[0], 1 + dx: 1 + dx + img.shape[1]]
               for dy in (-1, 0, 1) for dx in (-1, 0, 1)) / 9.0
    return np.stack([np.clip(x, 0, 255).astype(np.uint8) for x in (noisy, ramp, blur)])


@pytest.fixture(scope="module")
def jax_detections(scenes, degraded):
    colour = _colour(scenes[3])
    out = {}
    for name, kw in CONFIGS.items():
        cfg = jdet.DetectorConfig(**kw)
        fn = jax.jit(jax.vmap(lambda im, c=cfg: jdet.detect_markers(im, c)))
        out[name] = [np.asarray(x) for x in fn(jnp.asarray(scenes[:3]))]
        out[name + "_degraded"] = [np.asarray(x) for x in fn(jnp.asarray(degraded))]  # same shape
        single = jax.jit(lambda im, c=cfg: jdet.detect_markers(im, c))(jnp.asarray(colour))
        out[name + "_colour"] = [np.asarray(x) for x in single]
    return out


def _colour(gray):
    """A BGR frame whose luma is not the gray frame itself."""
    g = gray.astype(np.int32)
    return np.stack([g, np.clip(g + 9, 0, 255), np.clip(g * 0.8, 0, 255)], -1).astype(np.uint8)


def _assert_detections(ours, ids, corners, valid):
    np.testing.assert_array_equal(ours.ids.numpy(), ids)
    np.testing.assert_array_equal(ours.valid.numpy(), valid)
    np.testing.assert_allclose(ours.corners.numpy()[valid], corners[valid], atol=CORNER_TOL)


# ---------------------------------------------------------------------------
# dictionary and grayscale
# ---------------------------------------------------------------------------


def test_dictionary_tables_equal():
    np.testing.assert_array_equal(dictionary.aruco_original_bits(), jdict.aruco_original_bits())
    np.testing.assert_array_equal(dictionary.aruco_original_rotations(),
                                  jdict.aruco_original_rotations())
    for mid in (0, 5, 1023):
        np.testing.assert_array_equal(dictionary.marker_pattern(mid), jdict.marker_pattern(mid))


def test_match_bits_rotations_and_correction():
    bits = dictionary.aruco_original_bits()
    grids = []
    for mid in (0, 7, 512, 800, 42):
        for r in range(4):
            grids.append(np.rot90(bits[mid], r))
    one = bits[42].copy()
    one[2, 2] ^= 1  # one flip: corrected
    two = bits[42].copy()
    two[0, 1] ^= 1
    two[0, 3] ^= 1  # two flips: rejected
    grids += [one, two]
    g = np.stack(grids).astype(np.uint8)
    ours = dictionary.match_bits(torch.as_tensor(g), max_correction=1)
    ref = jdict.match_bits(jnp.asarray(g), max_correction=1)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ours[0][:20].tolist() == [m for m in (0, 7, 512, 800, 42) for _ in range(4)]
    assert ours[1][:20].tolist() == [0, 1, 2, 3] * 5
    assert ours[0][20] == 42 and bool(ours[3][20]) and not bool(ours[3][21])


def test_to_grayscale_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (2, 16, 24, 3), np.uint8)
    for order in ("bgr", "rgb"):
        np.testing.assert_array_equal(
            detector.to_grayscale(torch.as_tensor(img), order).numpy(),
            np.asarray(jdet.to_grayscale(jnp.asarray(img), order)),
        )
    f = rng.random((16, 24, 3)).astype(np.float32) * 255
    np.testing.assert_allclose(detector.to_grayscale(torch.as_tensor(f)).numpy(),
                               np.asarray(jdet.to_grayscale(jnp.asarray(f))), rtol=1e-6)
    with pytest.raises(ValueError, match="channel_order"):
        detector.to_grayscale(torch.as_tensor(img), "gbr")


def test_detector_config_round_trips():
    for kw in CONFIGS.values():
        j = jdet.DetectorConfig(**kw)
        assert dataclasses.asdict(convert.detector_config_from_dict(dataclasses.asdict(j))) == (
            dataclasses.asdict(j)
        )
    assert dataclasses.asdict(detector.DetectorConfig()) == dataclasses.asdict(jdet.DetectorConfig())
    as_json = {**dataclasses.asdict(jdet.DetectorConfig()), "shape_buckets": [[480, 640]]}
    assert convert.detector_config_from_dict(as_json).shape_buckets == ((480, 640),)


# ---------------------------------------------------------------------------
# stages on a rendered scene
# ---------------------------------------------------------------------------


def test_stage_threshold_and_labels(scenes, stages):
    cfg = detector.DetectorConfig()
    img = torch.as_tensor(scenes[:1])
    fg = detector.adaptive_threshold(img, cfg.adaptive_radius, cfg.adaptive_C, cfg.mean_stride)
    np.testing.assert_array_equal(fg[0].numpy(), np.asarray(stages["fg"]))
    lab = detector.label_components(fg, cfg.ccl_rounds)
    np.testing.assert_array_equal(lab[0].numpy(), np.asarray(stages["lab"]))
    out = detector._union_masks_and_labels(img, cfg.adaptive_radius, cfg)
    for name, a in zip(("fg", "lab", "fg_c", "lab_c"), out):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(stages[name]), err_msg=name)


def test_stage_component_stats(stages):
    cfg = detector.DetectorConfig()
    ours = detector._component_stats_multi(
        [_t(stages["lab"])[None], _t(stages["lab_c"])[None]],
        [_t(stages["fg"])[None], _t(stages["fg_c"])[None]], cfg,
    )
    for src, (o, r) in enumerate(zip(ours, stages["stats"])):
        for name, a, b in zip(("roots", "bbox", "valid", "count"), o, r):
            np.testing.assert_array_equal(a[0].numpy(), np.asarray(b), err_msg=f"{name} {src}")
    assert int(ours[0][2].sum()) >= 3


def test_stage_quads(stages):
    cfg = detector.DetectorConfig()
    fg_shape = stages["fg"].shape
    labels2 = torch.stack([_t(stages["lab"]).reshape(fg_shape),
                           _t(stages["lab_c"]).reshape(fg_shape)])[None]
    quads, qvalid = detector.quads_from_candidates(
        labels2, _t(stages["roots"])[None], _t(stages["bbox"])[None],
        _t(stages["valid"])[None], cfg, src=_t(stages["src"])[None],
    )
    np.testing.assert_array_equal(qvalid[0].numpy(), np.asarray(stages["qvalid"]))
    v = np.asarray(stages["qvalid"])
    np.testing.assert_allclose(quads[0].numpy()[v], np.asarray(stages["quads"])[v], atol=1e-4)


def test_stage_subpix_and_decode(scenes, stages):
    cfg = detector.DetectorConfig()
    img = torch.as_tensor(scenes[:1])
    v = np.asarray(stages["qvalid"])
    refined = detector.refine_corners_subpix(
        img, _t(stages["quads"])[None], window=cfg.subpix_window, iters=cfg.subpix_iters,
        window_small=cfg.subpix_window_small, small=_t(stages["small"])[None],
    )
    np.testing.assert_allclose(refined[0].numpy()[v], np.asarray(stages["refined"])[v],
                               atol=CORNER_TOL)
    mids, corners, contrast, border, ok = detector.decode_candidates(
        img, _t(stages["refined"])[None], cfg
    )
    j_mids, j_corners, j_contrast, j_border, j_ok = (np.asarray(x) for x in stages["decoded"])
    np.testing.assert_array_equal(ok[0].numpy()[v], j_ok[v])
    np.testing.assert_array_equal(border[0].numpy()[v], j_border[v])
    good = v & j_ok
    assert good.sum() >= 4
    np.testing.assert_array_equal(mids[0].numpy()[good], j_mids[good])
    np.testing.assert_allclose(corners[0].numpy()[good], j_corners[good], atol=1e-5)
    np.testing.assert_allclose(contrast[0].numpy()[good], j_contrast[good], atol=1e-3)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_detect_markers_matches_jax(scenes, jax_detections, name):
    cfg = detector.DetectorConfig(**CONFIGS[name])
    ours = detector.detect_markers_batch(torch.as_tensor(scenes[:3]), cfg)
    ids, corners, valid = jax_detections[name]
    _assert_detections(ours, ids, corners, valid)
    assert valid.sum() >= 6
    colour = detector.detect_markers(torch.as_tensor(_colour(scenes[3])), cfg)
    _assert_detections(colour, *jax_detections[name + "_colour"])
    assert bool(colour.valid.any())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_detect_markers_matches_jax_on_degraded_frames(degraded, jax_detections, name):
    """The robustness scenes (noise, illumination ramp, blur) through both
    detectors: ids and validity equal, corners within 1e-3 px, markers
    found in every frame."""
    ours = detector.detect_markers_batch(torch.as_tensor(degraded),
                                         detector.DetectorConfig(**CONFIGS[name]))
    ids, corners, valid = jax_detections[name + "_degraded"]
    _assert_detections(ours, ids, corners, valid)
    assert valid.any(axis=1).all()


def test_single_frame_equals_its_batch_row(scenes):
    batch = detector.detect_markers_batch(torch.as_tensor(scenes[:2]))
    one = detector.detect_markers(torch.as_tensor(scenes[1]))
    for a, b in zip(one, batch):
        assert torch.equal(a, b[1])


def test_equal_size_components_keep_jax_order():
    """More equal-size components than max_candidates: the kept ones are
    the lowest-indexed among the ties, in ascending order, as lax.top_k
    orders them (torch.topk would not)."""
    fg = np.zeros((144, 160), bool)
    for k in range(24):
        # 24 squares of 14x14 px on the stats grid's phase: 16 samples each
        y, x = 8 + 28 * (k // 6), 8 + 24 * (k % 6)
        fg[y: y + 14, x: x + 14] = True
    fg[120:138, 140:158] = True  # one larger square wins first
    cfg = detector.DetectorConfig(max_candidates=16, closing_union=False)
    jcfg = jdet.DetectorConfig(max_candidates=16, closing_union=False)
    lab = jdet.label_components(jnp.asarray(fg), cfg.ccl_rounds)
    ref = jdet.component_candidates(lab, jnp.asarray(fg), jcfg)
    ours = detector.component_candidates(_t(lab)[None], torch.as_tensor(fg)[None], cfg)
    for name, a, b in zip(("roots", "bbox", "valid", "count"), ours, ref):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b), err_msg=name)
    roots, counts = ours[0][0].tolist(), ours[3][0].tolist()
    assert roots[0] == 120 * 160 + 140 and counts[0] > counts[1]
    assert set(counts[1:]) == {16.0} and roots[1:] == sorted(roots[1:])
    quads, valid = detector.extract_quads(_t(lab)[None], torch.as_tensor(fg)[None], cfg)
    j_quads, j_valid = jdet.extract_quads(lab, jnp.asarray(fg), jcfg)
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(j_valid))
    np.testing.assert_allclose(quads[0].numpy(), np.asarray(j_quads), atol=1e-4)


def test_empty_frame_has_no_detections():
    det = detector.detect_markers_batch(torch.full((2, 240, 320), 178, dtype=torch.uint8))
    assert not bool(det.valid.any())
    assert bool((det.ids == -1).all())
