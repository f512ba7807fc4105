"""The CCL kernel family's plain versions (K3-K5s) held against the JAX
package: its XLA stage functions and its Pallas kernels in interpret mode,
on the shapes, strides and radii of ``tests/test_pallas_kernels.py`` and on
one rendered 480x640 frame under ``DetectorConfig()``, and on a 480x640
mask whose components cross the bands of the cluster body (a serpentine
through all eight, components on every band edge), and on a 96x1280 mask
(rows wider than the cluster body takes) drawn across the block body's
tiles and row splits. Every comparison is exact: the threshold is integer
arithmetic in float32 until its divisions and the labelling is integer
min-propagation. On CPU tensors the kernel wrappers take these plain
versions and launch nothing. Also the wrappers' choice between the
kernel's two bodies, by frame shape alone, and the block body's plan."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aruco_slam_tpu.ops import detector as jdet
from aruco_slam_tpu.ops.camera import CameraIntrinsics as JCamera
from aruco_slam_tpu.ops.kernels import ccl as jccl
from aruco_slam_tpu.sim import renderer as jrenderer
from aruco_slam_tpu.sim import synthetic as jsyn
from aruco_slam_tpu_torch.ops import detector
from aruco_slam_tpu_torch.ops.kernels import ccl
from torch_ccl_masks import tile_crossing_mask

torch.set_num_threads(1)

THRESHOLD_CASES = (((64, 256), 4, 7), ((64, 128), 1, 5), ((128, 128), 2, 7))
CCL_CASES = (((64, 256), 0.4, 4), ((64, 128), 0.7, 6), ((128, 128), 0.05, 2))


def _eq(ours: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def rendered():
    """The scene of tests/test_detector.py, one uint8 480x640 frame."""
    cam = JCamera.create(600.0, 600.0, 320.0, 240.0)
    stack = jrenderer.build_marker_stack(jsyn.make_arena(n_markers=20))
    cam_pos, R_wc = jrenderer.camera_pose_from_robot(jnp.asarray((2.55, -2.0, 1.2), jnp.float32))
    return np.array(jrenderer.render_frame(cam_pos, R_wc, stack, cam))


def band_crossing_mask(h=480, w=640, bands=8):
    """A serpentine that winds down through every band (the bounded rounds
    do not converge on it), plus components that touch each band edge from
    above, from below, and across it."""
    fg = np.zeros((h, w), bool)
    for y in range(2, h - 2, 4):
        fg[y, 4:w - 4] = True
        fg[y + 1: y + 4, w - 5 if (y // 4) % 2 == 0 else 4] = True
    fg[:, w // 2 - 20: w // 2 - 18] = False  # cut it into two windings
    band = h // bands
    for b in range(1, bands):
        y = b * band
        fg[y - 3: y, 40 + 60 * b: 60 + 60 * b] = True  # ends on the edge
        fg[y: y + 3, 50 + 60 * b: 70 + 60 * b] = True  # starts on it
        fg[y - 1: y + 1, 10: 20] = True  # straddles it
    return fg


@pytest.mark.parametrize("shape,dens,rounds", CCL_CASES)
def test_label_components_matches_xla_and_pallas(shape, dens, rounds):
    fg = np.random.default_rng(2).random(shape) < dens
    ours = ccl.label_components(torch.as_tensor(fg)[None], rounds)[0]
    _eq(ours, jax.jit(lambda m: jdet.label_components(m, rounds))(jnp.asarray(fg)))
    _eq(ours, jccl.label_components_tpu(jnp.asarray(fg), rounds, interpret=True))


def test_seeded_label_components_matches_xla_and_pallas():
    fg = np.random.default_rng(11).random((64, 256)) < 0.4
    lab = detector.label_components(torch.as_tensor(fg)[None], 4)
    fg_c = detector.binary_close3(torch.as_tensor(fg)[None])
    ours = ccl.label_components(fg_c, 2, init=lab.reshape(fg_c.shape))[0]
    seed = jnp.asarray(lab[0].numpy().reshape(fg.shape))
    fgc_j = jnp.asarray(fg_c[0].numpy())
    _eq(ours, jax.jit(lambda m, s: jdet.label_components(m, 2, init=s))(fgc_j, seed))
    _eq(ours, jccl.label_components_tpu(fgc_j, 2, interpret=True, init=seed))


@pytest.mark.parametrize("shape,stride,radius", THRESHOLD_CASES)
def test_threshold_and_close_match_xla(shape, stride, radius):
    img = np.random.default_rng(5).integers(0, 256, (3, *shape)).astype(np.uint8)
    fg = detector.adaptive_threshold(torch.as_tensor(img), radius, 7.0, stride)
    thr = jax.jit(jax.vmap(lambda im: jdet.adaptive_threshold(im, radius, 7.0, stride)))
    fg_j = thr(jnp.asarray(img))
    _eq(fg, fg_j)
    _eq(detector.binary_close3(fg), jax.jit(jax.vmap(jdet.binary_close3))(fg_j))


@pytest.mark.parametrize("shape,stride,radius", THRESHOLD_CASES)
def test_threshold_label_matches_pallas(shape, stride, radius):
    img = np.random.default_rng(5).integers(0, 256, shape).astype(np.uint8)
    fg, lab = ccl.threshold_label(torch.as_tensor(img)[None], radius, 7.0, stride, 4)
    fg_k, lab_k = jccl.threshold_label_tpu(jnp.asarray(img), radius, 7.0, stride, 4,
                                           interpret=True)
    _eq(fg[0], fg_k)
    _eq(lab[0], lab_k)


@pytest.mark.parametrize("shape,stride,radius", THRESHOLD_CASES)
def test_threshold_label_union_matches_pallas(shape, stride, radius):
    img = np.random.default_rng(9).integers(0, 256, shape).astype(np.uint8)
    ours = ccl.threshold_label_union(torch.as_tensor(img)[None], radius, 7.0, stride, 4, 2)
    ref = jccl.threshold_label_union_tpu(jnp.asarray(img), radius, 7.0, stride, 4,
                                         closed_rounds=2, interpret=True)
    for a, b in zip(ours, ref):
        _eq(a[0], b)


def test_union_on_a_rendered_frame_matches_xla_and_pallas(rendered):
    """The detector default on a marker scene: all four outputs of K3's
    plain version against the Pallas kernel and the unfused XLA stages."""
    cfg = detector.DetectorConfig()
    args = (cfg.adaptive_radius, cfg.adaptive_C, cfg.mean_stride, cfg.ccl_rounds,
            cfg.closed_ccl_rounds)
    ours = ccl.threshold_label_union(torch.as_tensor(rendered)[None], *args)
    ref = jccl.threshold_label_union_tpu(jnp.asarray(rendered), *args[:4],
                                         closed_rounds=args[4], interpret=True)
    for a, b in zip(ours, ref):
        _eq(a[0], b)
    xla = jax.jit(lambda im: jdet._union_masks_and_labels(im, args[0], jdet.DetectorConfig()))(
        jnp.asarray(rendered)
    )
    for a, b in zip(ours, xla):
        _eq(a[0], b)
    assert 0 < int(ours[0].sum()) < rendered.size // 4


def test_wrappers_on_cpu_take_the_plain_versions(rendered):
    img = torch.as_tensor(np.stack([rendered, rendered[::-1].copy()]))
    before = dict(ccl.LAUNCHES)
    out = ccl.threshold_label_union(img, 7, 7.0, 4, 3, 2)
    ref = ccl.threshold_label_union_reference(img, 7, 7.0, 4, 3, 2)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    fg4, lab4 = ccl.threshold_label(img, 7, 7.0, 4, 3)
    assert torch.equal(fg4, out[0]) and torch.equal(lab4, out[1])
    assert torch.equal(ccl.label_components(out[0], 3), out[1])
    assert ccl.LAUNCHES == before
    # frames are independent: the second frame alone gives its own rows
    single = ccl.threshold_label_union(img[1:].contiguous(), 7, 7.0, 4, 3, 2)
    for a, b in zip(single, out):
        assert torch.equal(a[0], b[1])


def test_float_images_take_the_same_path():
    img = np.random.default_rng(3).integers(0, 256, (2, 64, 256)).astype(np.uint8)
    a = ccl.threshold_label_union(torch.as_tensor(img), 7, 7.0, 4, 3, 2)
    b = ccl.threshold_label_union(torch.as_tensor(img.astype(np.float32)), 7, 7.0, 4, 3, 2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_fused_threshold_gate():
    assert ccl.fused_threshold_ok(480, 640, 4)
    assert ccl.fused_threshold_ok(1080, 1920, 4)
    assert ccl.fused_threshold_ok(64, 128, 1)
    assert not ccl.fused_threshold_ok(480, 640, 3)  # not a power of two
    assert not ccl.fused_threshold_ok(482, 640, 4)  # the block grid does not tile
    with pytest.raises(ValueError, match="power-of-two"):
        ccl.threshold_label(torch.zeros(1, 480, 640, dtype=torch.uint8), 7, 7.0, 3, 3)


def test_band_crossing_mask_matches_xla_and_pallas():
    """K5 and K5s at 480x640 (the cluster body's frame) on components that
    cross every band edge: the plain version against the JAX XLA CCL and
    the Pallas kernel in interpret mode, bit for bit."""
    fg = band_crossing_mask()
    ours = ccl.label_components(torch.as_tensor(fg)[None], 3)[0]
    fgj = jnp.asarray(fg)
    _eq(ours, jax.jit(lambda m: jdet.label_components(m, 3))(fgj))
    _eq(ours, jccl.label_components_tpu(fgj, 3, interpret=True))
    assert len(np.unique(ours.numpy()[fg.reshape(-1)])) > 16  # bounded rounds: unconverged
    seed = ours.reshape(1, *fg.shape)
    seeded = ccl.label_components(torch.as_tensor(fg)[None], 2, init=seed)[0]
    _eq(seeded, jccl.label_components_tpu(fgj, 2, interpret=True,
                                          init=jnp.asarray(seed[0].numpy())))


def test_body_is_chosen_by_shape_alone():
    """The cluster body where a band of h/8 rows fits 227 KB of shared
    memory, the block body otherwise; the fused threshold also needs whole
    block rows in a band."""
    assert ccl.cluster_shared_bytes(480, 640, 4) == 232_160  # a Jacobi chunk of 18 rows
    assert ccl.cluster_shared_bytes(480, 640) == 232_160
    assert ccl.body(480, 640, 4) == ccl.body(480, 640) == "cluster"
    assert ccl.body(720, 1280, 4) == ccl.body(720, 1280) == "block"
    assert ccl.body(1080, 1920, 4) == ccl.body(1080, 1920) == "block"
    assert ccl.body(64, 256, 4) == "cluster"
    assert ccl.body(480, 640, 3) == "block"  # 640 is no whole number of 3-pixel blocks
    assert ccl.body(484, 640) == "block"  # h not a multiple of 8
    assert ccl.body(480, 656) == "block"  # w not a multiple of 32
    assert ccl.body(520, 640) == "block"  # bands of 65 rows
    assert ccl.body(256, 1056) == "block"  # rows of more than 1024 pixels
    # at 480x768 the three block grids no longer fit beside the band; a bare
    # CCL still does
    assert ccl.cluster_shared_bytes(480, 768, 4) is None
    assert ccl.cluster_shared_bytes(480, 768) == 229_440
    assert ccl.MAX_SHARED_BYTES == 232_448


def test_tile_crossing_mask_matches_xla_and_pallas():
    """K5 and K5s at 96x1280 (the block body's frame: rows wider than 1,024
    pixels) on a serpentine through every tile of the block body's plan,
    components on its tile edges and runs across its row splits: the plain
    version against the JAX XLA CCL and the Pallas kernel in interpret
    mode, bit for bit, unconverged after the bounded rounds."""
    h, w = 96, 1280
    assert ccl.body(h, w) == "block"
    plan = ccl.block_plan(h, w, 1)
    fg = tile_crossing_mask(h, w, plan.tile_rows, plan.tile_width // 32)
    ours = ccl.label_components(torch.as_tensor(fg)[None], 3)[0]
    fgj = jnp.asarray(fg)
    _eq(ours, jax.jit(lambda m: jdet.label_components(m, 3))(fgj))
    _eq(ours, jccl.label_components_tpu(fgj, 3, interpret=True))
    assert len(np.unique(ours.numpy()[fg.reshape(-1)])) > 16  # bounded rounds: unconverged
    seed = ours.reshape(1, h, w)
    seeded = ccl.label_components(torch.as_tensor(fg)[None], 2, init=seed)[0]
    _eq(seeded, jccl.label_components_tpu(fgj, 2, interpret=True,
                                          init=jnp.asarray(seed[0].numpy())))


@pytest.mark.parametrize("h,w,n,rows,width,teams,ctas,smem", [
    (720, 1280, 1, 6, 1280, 1, 120, 47_312),
    (720, 1280, 16, 22, 1280, 4, 33, 142_544),
    (1080, 1920, 1, 9, 1920, 1, 120, 97_568),
    (1080, 1920, 16, 17, 1920, 2, 64, 168_864),
    (1083, 1920, 16, 17, 1920, 2, 64, 168_864),  # odd H: a last tile of 12 rows
    (7, 5, 3, 1, 32, 3, 7, 548),  # a tiny frame: one padded word a row
])
def test_block_plan_on_an_h100(h, w, n, rows, width, teams, ctas, smem):
    """The block body's plan at the detector's HD buckets, an odd height
    and a tiny frame on an H100's 132 SMs: a CTA a tile on at most one CTA
    an SM, the tiles' workspaces in shared memory (csrc tile_layout), and
    the frames in flight."""
    plan = ccl.block_plan(h, w, n)
    tiles_y = -(-h // rows)
    assert plan == ccl.BlockPlan(rows, width, 1, tiles_y, teams, ctas, False, smem, 0)
    assert ctas == tiles_y and teams * ctas <= ccl.H100_SMS and teams <= n
    assert smem == 4 * ccl.block_tile_words(rows, width) <= ccl.MAX_SHARED_BYTES
    cells = (h // 4) * (w // 4) if h % 4 == 0 and w % 4 == 0 else 0
    assert ccl.block_scratch_words(h, w, plan, 4 if cells else None) == (
        2 * cells + 4 * tiles_y * w + 4 * h)


def test_block_tile_layout():
    """A tile's workspace (csrc tile_layout): labels, the halo rows and
    columns, three bit masks with their rings, and the Jacobi step's saved
    first and last label of every 32-pixel word."""
    # 9 x 1920: 17,280 labels, 2 x 1,922 + 2 x 9 halo, (3 x 9 + 8) x 62 mask
    # words, 2 x 9 x 60 word ends
    assert ccl.block_tile_words(9, 1920) == 17_280 + 3_862 + 2_170 + 1_080
    assert ccl.block_tile_words(24, 1920) == 57_812  # the tallest 1920-wide tile
    assert ccl.block_tile_words(25, 1920) is None  # past 227 KB
    assert ccl.block_tile_words(64, 2048) is None
    assert ccl.block_tile_words(64, 2048, shared=False) == 156_692  # in device memory
    assert ccl.block_tile_words(65, 32) is None  # a column's bits in one 64-bit register
    assert ccl.block_tile_words(4, 2080) is None  # a lane's share of a row likewise
    assert ccl.block_tile_words(4, 48) is None  # whole 32-pixel words


def test_block_plan_spills_frames_larger_than_the_card():
    """A 2160x3840 frame needs more tiles than an H100 has SMs at any tile
    height that fits shared memory: two tiles across, their workspaces in
    device memory, 33-row tiles so that the team's 132 CTAs take one each."""
    plan = ccl.block_plan(2160, 3840, 1)
    assert plan == ccl.BlockPlan(33, 1920, 2, 66, 1, ccl.H100_SMS, True, 0,
                                 132 * ccl.block_tile_words(33, 1920, shared=False))
    assert ccl.body(2160, 3840) == "block"


def _threshold_chunk_rows(plan, w, stride, radius):
    """The fewest cell rows a threshold chunk of the plan's tiles holds
    (csrc ``thr_chunk_rows``): the words past a tile's labels and raw mask
    over a cell row's vertical window sums and window means."""
    rows, width = plan.tile_rows, plan.tile_width
    room = (ccl.block_tile_words(rows, width, shared=not plan.spilled)
            - rows * width - (rows + 4) * (width // 32 + 2))
    r = ccl._window_radius(radius, stride) if stride > 1 else radius
    ws, most = w // stride, None
    for x0 in range(0, w, width):
        cx0, cx1 = x0 // stride, (min(x0 + width, w) - 1) // stride
        vw = min(cx1 + r, ws - 1) - max(cx0 - r, 0) + 1
        m = room // (vw + cx1 - cx0 + 1)
        most = m if most is None else min(most, m)
    return most


@pytest.mark.parametrize("h,w,tiles_x,width,spilled", [
    (720, 1284, 1, 1312, False),  # a multiple of 4 but not of 16 wide
    (720, 1280, 1, 1280, False),
    (1080, 1920, 1, 1920, False),
    (2160, 3840, 2, 1920, True),
    (2160, 3844, 2, 1952, True),  # the second tile 1,892 pixels wide
])
@pytest.mark.parametrize("n", [1, 20])
def test_block_plan_of_the_threshold_card_tests(h, w, tiles_x, width, spilled, n):
    """The plans that tests/test_torch_cuda.py's threshold tests run on an
    H100: tiles across, their width, where their workspaces live, and room
    in every tile for at least one cell row of the threshold's window sums
    and means at strides 1, 2 and 4 and radii 5 and 7 (the launch refuses
    a plan without it)."""
    plan = ccl.block_plan(h, w, n)
    assert (plan.tiles_x, plan.tile_width, plan.spilled) == (tiles_x, width, spilled)
    for stride in (1, 2, 4):
        for radius in (5, 7):
            assert _threshold_chunk_rows(plan, w, stride, radius) >= 1


@pytest.mark.parametrize("sms", [ccl.H100_SMS, 114])
@pytest.mark.parametrize("h,w", [(1080, 1920), (2160, 3840), (2160, 4096), (3000, 4000),
                                 (4320, 7680)])
def test_spilled_plan_balances_the_team(h, w, sms):
    """The spilled plan at 1080p and at the 4K, 12 MP and 8K frames that
    spill, on an H100 SXM's 132 SMs and a PCIe card's 114: tiles of at most
    64 rows, at most a CTA an SM, every CTA of the team taking
    ceil(tiles / ctas) tiles or one fewer under the kernel's rule (CTA r
    takes tiles r, r + ctas, ...), none without a tile, the busiest as few
    as the SMs allow, and the workspaces of every tile in device memory.
    Where the frame spills, the planner's plan is this one; where it does
    not, this one has the resident plan's tiles and team."""
    plan = ccl.spilled_plan(h, w, sms)
    tiles = plan.tiles_x * plan.tiles_y
    assert plan.spilled and plan.teams == 1 and plan.smem_bytes == 0
    assert 1 <= plan.tile_rows <= ccl.MAX_TILE_ROWS
    assert plan.tiles_y == -(-h // plan.tile_rows)
    assert (plan.tiles_x, plan.tile_width) == ccl._tile_columns(w)
    assert plan.ctas <= sms
    busiest = -(-tiles // plan.ctas)
    per_cta = [len(range(r, tiles, plan.ctas)) for r in range(plan.ctas)]
    assert set(per_cta) <= {busiest, busiest - 1} and min(per_cta) >= 1
    assert busiest == -(-tiles // sms)
    assert plan.work_words == tiles * ccl.block_tile_words(plan.tile_rows, plan.tile_width,
                                                           shared=False)
    resident = ccl.block_plan(h, w, 1, sms)
    if resident.spilled:
        assert resident == plan
    else:
        assert (resident.tile_rows, resident.tiles_y, resident.ctas) == (
            plan.tile_rows, plan.tiles_y, plan.ctas)
