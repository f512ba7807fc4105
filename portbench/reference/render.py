"""The benchmark's renderer: a frozen copy of the port's ``sim.renderer``
(per-pixel ray casting against every marker's plane; the nearest hit
samples the marker's printed 7x7 pattern), for a pinhole camera without
distortion. It runs on the device the poses are on, in batches of
``batch`` poses, and makes the frames of the image-level cells in set-up.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.dictionary import marker_pattern
from portbench.reference.sim import Arena, camera_frames

BACKGROUND, WHITE, BLACK = 178, 255, 25


def render(arena: Arena, poses: np.ndarray, cam: dict, cam_height: float, device,
           batch: int = 8) -> torch.Tensor:
    """Grayscale uint8 frames ``[F, H, W]`` of the arena seen from robot
    poses ``[F, 3]`` (world frame), on ``device``."""
    H, W = cam["height"], cam["width"]
    f32 = dict(dtype=torch.float32, device=device)
    v, u = torch.meshgrid(torch.arange(H, **f32), torch.arange(W, **f32), indexing="ij")
    dirs = torch.stack([(u.reshape(-1) - cam["cx"]) / cam["fx"],
                        (v.reshape(-1) - cam["cy"]) / cam["fy"],
                        torch.ones(H * W, **f32)], -1)  # [P, 3]
    pat = torch.as_tensor(np.stack([marker_pattern(int(i)) for i in arena.ids]),
                          device=device).reshape(len(arena.ids), 49).to(torch.int32)
    R_wm = torch.as_tensor(arena.R_wm, **f32)
    pos = torch.as_tensor(arena.positions, **f32)
    half = torch.as_tensor(arena.lengths / 2.0, **f32)[None, :, None]
    cell = torch.as_tensor(arena.lengths / 7.0, **f32)[None, :, None]
    cam_pos, R_wc = (torch.as_tensor(a, **f32) for a in camera_frames(poses, cam_height))
    out = []
    for i in range(0, len(poses), batch):
        cp, rwc = cam_pos[i:i + batch], R_wc[i:i + batch]
        R_cm = rwc.transpose(-1, -2)[:, None] @ R_wm[None]  # marker axes in camera
        c0 = ((pos[None] - cp[:, None])[..., None, :] @ rwc[:, None])[..., 0, :]
        n = R_cm[..., 2]
        denom = torch.einsum("pk,nlk->nlp", dirs, n)
        t = (c0 * n).sum(-1)[..., None] / torch.where(denom.abs() < 1e-9, 1e-9, denom)
        ax_u, ax_v = R_cm[..., 0], R_cm[..., 1]
        mu = torch.einsum("pk,nlk->nlp", dirs, ax_u) * t - (c0 * ax_u).sum(-1)[..., None]
        mv = torch.einsum("pk,nlk->nlp", dirs, ax_v) * t - (c0 * ax_v).sum(-1)[..., None]
        inside = (mu.abs() <= half) & (mv.abs() <= half) & (t > 0.05)
        col = torch.clamp(((mu + half) / cell).to(torch.int32), 0, 6)
        row = torch.clamp(((half - mv) / cell).to(torch.int32), 0, 6)
        L = R_wm.shape[0]
        bit = torch.gather(pat[None].expand(cp.shape[0], L, 49), 2,
                           (row * 7 + col).to(torch.int64))
        color = torch.where(bit > 0, float(WHITE), float(BLACK))
        nearest = torch.argmin(torch.where(inside, t, torch.inf), dim=1, keepdim=True)
        img = torch.where(inside.any(dim=1), torch.gather(color, 1, nearest)[:, 0],
                          float(BACKGROUND))
        out.append(img.reshape(-1, H, W).to(torch.uint8))
    return torch.cat(out)
