"""Synthetic marker-image renderer (L3) — counterpart of
``aruco_slam_tpu.sim.renderer``, the image-level data source that replaces
the reference's Gazebo camera (launch/slam.launch:22-36).

Per-pixel inverse ray casting over a batch of camera poses at once: each
pixel's ray is intersected with every marker's plane, and the nearest hit
samples the marker's printed pattern (5x5 bits and a 1-cell black border;
outer side = marker_length, the convention of the reference's corners and
PnP, aruco_slam.h:189). Rays are undistorted through the camera model, so
the rendered geometry matches what PnP assumes.
"""

from __future__ import annotations

import numpy as np
import torch

from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics, pixels_to_normalized
from aruco_slam_tpu_torch.ops.dictionary import marker_pattern
from aruco_slam_tpu_torch.utils.device import resolve

Tensor = torch.Tensor

BACKGROUND = 178
WHITE = 255
BLACK = 25

# Poses rendered per batch inside render_sequence_frames: the per-marker
# ray fields are [poses, markers, H*W] float32, about 25 MB per pose at
# 640x480 with 20 markers.
RENDER_BATCH = 8


def build_marker_stack(marker_map, device=None) -> dict:
    """Per-marker pattern bits, world rotation, position and side length,
    as tensors on ``device`` (None: the card)."""
    device = resolve(device)
    from aruco_slam_tpu_torch.sim.synthetic import rpy_matrix_np

    n = len(marker_map)
    patterns = np.stack([marker_pattern(int(marker_map.ids[i])) for i in range(n)])
    R_wm = np.stack([rpy_matrix_np(*marker_map.rpys[i]) for i in range(n)])
    return {
        "patterns": torch.as_tensor(patterns, device=device),
        "R_wm": torch.as_tensor(R_wm, dtype=torch.float32, device=device),
        "pos": torch.as_tensor(np.asarray(marker_map.positions), dtype=torch.float32,
                               device=device),
        "lengths": torch.as_tensor(np.asarray(marker_map.lengths), dtype=torch.float32,
                                   device=device),
    }


def render_frame(
    cam_pos: Tensor,  # [N, 3] camera positions in world
    R_wc: Tensor,  # [N, 3, 3] camera axes in world (cols: x right, y down, z fwd)
    stack: dict,
    camera: CameraIntrinsics,
    height: int = 480,
    width: int = 640,
) -> Tensor:
    """Render N grayscale uint8 frames ``[N, H, W]``, one per pose."""
    dev = cam_pos.device
    v, u = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    px = torch.stack([u, v], dim=-1).reshape(-1, 2)  # [P, 2]
    norm = pixels_to_normalized(px, camera)  # undistorted ray slopes
    dirs = torch.cat([norm, torch.ones_like(norm[:, :1])], dim=-1)  # [P, 3]

    R_wm, pos = stack["R_wm"], stack["pos"]  # [L, 3, 3], [L, 3]
    R_cm = R_wc.transpose(-1, -2)[:, None] @ R_wm[None]  # [N, L, 3, 3] marker axes in camera
    c0 = ((pos[None] - cam_pos[:, None])[..., None, :]
          @ R_wc[:, None])[..., 0, :]  # [N, L, 3] marker centres in camera
    n = R_cm[..., 2]  # [N, L, 3] plane normals
    denom = torch.einsum("pk,nlk->nlp", dirs, n)
    t = (c0 * n).sum(-1)[..., None] / torch.where(denom.abs() < 1e-9, 1e-9, denom)
    # mu/mv = (dirs * t - c0) . axis, per pixel, without the [N, L, P, 3] field
    ax_u, ax_v = R_cm[..., 0], R_cm[..., 1]
    mu = torch.einsum("pk,nlk->nlp", dirs, ax_u) * t - (c0 * ax_u).sum(-1)[..., None]
    mv = torch.einsum("pk,nlk->nlp", dirs, ax_v) * t - (c0 * ax_v).sum(-1)[..., None]
    half = (stack["lengths"] / 2.0)[None, :, None]
    inside = (mu.abs() <= half) & (mv.abs() <= half) & (t > 0.05)
    cell = (stack["lengths"] / 7.0)[None, :, None]
    # astype(int32) truncates toward zero, as .to(int32) does
    col = torch.clamp(((mu + half) / cell).to(torch.int32), 0, 6)
    row = torch.clamp(((half - mv) / cell).to(torch.int32), 0, 6)
    L = R_wm.shape[0]
    pat = stack["patterns"].reshape(L, 49).to(torch.int32)
    bit = torch.gather(
        pat[None].expand(cam_pos.shape[0], L, 49), 2, (row * 7 + col).to(torch.int64)
    )
    color = torch.where(bit > 0, float(WHITE), float(BLACK))

    t_masked = torch.where(inside, t, torch.inf)
    nearest = torch.argmin(t_masked, dim=1, keepdim=True)  # [N, 1, P]
    any_hit = inside.any(dim=1)
    chosen = torch.gather(color, 1, nearest)[:, 0]
    img = torch.where(any_hit, chosen, float(BACKGROUND))
    return img.reshape(-1, height, width).to(torch.uint8)


def camera_pose_from_robot(pose: Tensor, t_r2c=(0.0, 0.0), cam_height: float = 0.3):
    """Robot planar poses ``[..., 3]`` -> (cam_pos ``[..., 3]``, R_wc
    ``[..., 3, 3]``), optical convention z = heading, x = right, y = down."""
    x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
    c, s = torch.cos(th), torch.sin(th)
    cam_pos = torch.stack(
        [x + c * t_r2c[0] - s * t_r2c[1], y + s * t_r2c[0] + c * t_r2c[1],
         torch.full_like(x, cam_height)],
        dim=-1,
    )
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    # columns: x_cam = (s, -c, 0), y_cam = (0, 0, -1), z_cam = (c, s, 0)
    R_wc = torch.stack(
        [
            torch.stack([s, zero, c], dim=-1),
            torch.stack([-c, zero, s], dim=-1),
            torch.stack([zero, -one, zero], dim=-1),
        ],
        dim=-2,
    )
    return cam_pos, R_wc


def render_poses(poses, marker_map, camera, t_r2c=(0.0, 0.0), height: int = 480,
                 width: int = 640, device=None) -> Tensor:
    """Render robot poses ``[F, 3]`` (arena frame) to ``[F, H, W]`` uint8
    frames on ``device`` (None: the card), RENDER_BATCH poses per call."""
    device = resolve(device)
    stack = build_marker_stack(marker_map, device)
    p = torch.as_tensor(np.asarray(poses), dtype=torch.float32, device=device)
    out = []
    for i in range(0, p.shape[0], RENDER_BATCH):
        cam_pos, R_wc = camera_pose_from_robot(p[i: i + RENDER_BATCH], t_r2c)
        out.append(render_frame(cam_pos, R_wc, stack, camera, height, width))
    return torch.cat(out) if out else torch.zeros(0, height, width, dtype=torch.uint8,
                                                  device=device)


def render_sequence_frames(seq, marker_map, camera, t_r2c=(0.0, 0.0),
                           height: int = 480, width: int = 640, device=None) -> np.ndarray:
    """Render every frame of a sequence at its true arena-frame poses on
    ``device`` (None: the card); returns host uint8 ``[F, H, W]``."""
    poses = seq.meta.get("true_pose_frames_world", seq.true_pose_frames)
    return render_poses(poses, marker_map, camera, t_r2c, height, width, device).cpu().numpy()
