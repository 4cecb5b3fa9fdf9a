"""Point-cloud -> image projection with a depth occlusion test.

Port of geopurify_tpu/ops/projection.py (``compute_point_image_mapping``,
``adjust_intrinsic_for_dim``) and of the data loader's host mapping
geopurify_tpu/data/loaders.py:119-162 (``compute_mapping``): pinhole-project
world points through world->camera, round to pixels (half to even, as
``np.round`` and ``jnp.round``), reject points outside the image less a
``cut_bound`` margin, and reject occluded ones
(|depth(px) - z| > vis_thres * depth(px)).

The loader's mapping runs in float64 on whatever device holds the points:
a scene's points cross to the card once and every view projects there,
which replaces the JAX package's numpy / g++ host path. The operation
order (``homo @ w2c.T``, then ``x * f / z + c``) is the numpy one, so the
pixels and the visibility mask equal the JAX loader's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class PointImageMapping(NamedTuple):
    rows: torch.Tensor       # [N] int32 pixel row (y); 0 where invisible
    cols: torch.Tensor       # [N] int32 pixel col (x); 0 where invisible
    visible: torch.Tensor    # [N] bool
    depth_cam: torch.Tensor  # [N] point depth in the camera frame


# geopurify_tpu/ops/projection.py:29
def adjust_intrinsic_for_dim(intrinsic: np.ndarray, image_dim: Tuple[int, int]) -> np.ndarray:
    """Rescale a pinhole intrinsic whose principal point encodes the original
    resolution to a target (W, H)."""
    K = np.array(intrinsic, dtype=np.float64).copy()
    scale_x = image_dim[0] / (K[0, 2] * 2)
    scale_y = image_dim[1] / (K[1, 2] * 2)
    K[0, 0] *= scale_x
    K[1, 1] *= scale_y
    K[0, 2] = image_dim[0] / 2
    K[1, 2] = image_dim[1] / 2
    return K


def _pixels(points: torch.Tensor, world_to_camera, intrinsic):
    """(u, v, z): rounded pixel columns and rows as int64, camera depth."""
    n = points.shape[0]
    w2c = torch.as_tensor(world_to_camera, dtype=points.dtype, device=points.device)
    K = torch.as_tensor(intrinsic, dtype=points.dtype, device=points.device)
    homo = torch.cat([points, points.new_ones((n, 1))], 1)
    p_cam = homo @ w2c.T
    z = p_cam[:, 2]
    safe_z = torch.where(torch.abs(z) < 1e-8, 1e-8, z)
    # clamped before the integer cast so that a point at the camera plane
    # (|x / z| huge) cannot wrap into the image; no in-image pixel moves
    u = torch.round(p_cam[:, 0] * K[0, 0] / safe_z + K[0, 2]).clamp_(-2 ** 31, 2 ** 31)
    v = torch.round(p_cam[:, 1] * K[1, 1] / safe_z + K[1, 2]).clamp_(-2 ** 31, 2 ** 31)
    return u.long(), v.long(), z


# geopurify_tpu/ops/projection.py:45
def compute_point_image_mapping(
    points: torch.Tensor,          # [N, 3] world coords
    valid: torch.Tensor,           # [N] bool padding mask
    world_to_camera,               # [4, 4]
    intrinsic,                     # [3, 3] or [4, 4]
    depth: Optional[torch.Tensor],  # [H, W] metres, or None (front-facing test only)
    image_dim: Tuple[int, int],    # (W, H)
    cut_bound: int = 0,
    vis_thres: float = 0.05,
) -> PointImageMapping:
    """Occlusion-tested projection in the points' dtype (the JAX ops
    version's semantics: with a depth map, the depth test alone decides
    the points' side of the camera)."""
    W, H = image_dim
    u, v, z = _pixels(points, world_to_camera, intrinsic)
    inside = (u >= cut_bound) & (v >= cut_bound) & (u < W - cut_bound) & (v < H - cut_bound) & valid
    if depth is not None:
        d_px = depth[torch.clamp(v, 0, H - 1), torch.clamp(u, 0, W - 1)]
        visible = inside & (torch.abs(d_px - z) <= vis_thres * d_px) & (d_px > 0)
    else:
        visible = inside & (z > 0)
    rows = torch.where(visible, v, 0).to(torch.int32)
    cols = torch.where(visible, u, 0).to(torch.int32)
    return PointImageMapping(rows, cols, visible, z)


# geopurify_tpu/data/loaders.py:119
def compute_mapping(
    points: torch.Tensor,           # [N, 3] float64
    world_to_camera: np.ndarray,    # [4, 4]
    intrinsic: np.ndarray,          # [3, 3] at (W, H)
    depth: Optional[np.ndarray],    # [H, W] metres
    image_dim: Tuple[int, int],     # (W, H)
    cut_bound: int = 10,
    vis_thres: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The data loader's mapping: (rows int32, cols int32, visible bool) on
    the points' device, in float64. Points behind the camera are never
    visible, with or without a depth map."""
    if points.dtype != torch.float64:
        raise TypeError(f"the loader's mapping runs in float64, got {points.dtype}")
    W, H = image_dim
    u, v, z = _pixels(points, world_to_camera, np.asarray(intrinsic)[:3, :3])
    inside = (u >= cut_bound) & (v >= cut_bound) & (u < W - cut_bound) & (v < H - cut_bound) & (z > 0)
    if depth is not None:
        d = torch.as_tensor(depth, dtype=torch.float64).to(points.device)
        d_px = d[torch.clamp(v, 0, H - 1), torch.clamp(u, 0, W - 1)]
        visible = inside & (d_px > 0) & (torch.abs(d_px - z) <= vis_thres * d_px)
    else:
        visible = inside
    rows = torch.where(visible, v, 0).to(torch.int32)
    cols = torch.where(visible, u, 0).to(torch.int32)
    return rows, cols, visible
