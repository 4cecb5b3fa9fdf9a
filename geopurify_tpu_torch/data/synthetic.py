"""Synthetic scenes for smoke runs of the trainer and for the tests.

Port of geopurify_tpu/data/synthetic.py (:19-167) in numpy: a random room
(floor, wall and object blobs with distinct colours), point-splat depth
views, packed as a padded ``SceneBatch``. The same draws in the same order,
so a seed gives the JAX package's arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from geopurify_tpu_torch.data.batch import SceneBatch, pad_to
from geopurify_tpu_torch.ops.voxelize import Voxelizer


# geopurify_tpu/data/synthetic.py:19
def make_room_points(rng: np.random.Generator, n_points: int = 2000, size: float = 4.0
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(points [N, 3], colors [N, 3] in 0..1, labels [N])."""
    n_floor = n_points // 3
    n_wall = n_points // 3
    n_obj = n_points - n_floor - n_wall
    floor = np.stack([rng.uniform(0, size, n_floor), rng.uniform(0, size, n_floor),
                      np.zeros(n_floor)], 1)
    wall = np.stack([rng.uniform(0, size, n_wall), np.zeros(n_wall),
                     rng.uniform(0, size / 2, n_wall)], 1)
    centers = rng.uniform(0.5, size - 0.5, (4, 3)) * np.array([1, 1, 0.3])
    obj = centers[rng.integers(0, 4, n_obj)] + rng.normal(scale=0.15, size=(n_obj, 3))
    points = np.concatenate([floor, wall, obj]).astype(np.float32)
    labels = np.concatenate(
        [np.zeros(n_floor), np.ones(n_wall), 2 + rng.integers(0, 2, n_obj)]).astype(np.int32)
    palette = rng.uniform(0.2, 1.0, (8, 3))
    return points, palette[labels].astype(np.float32), labels


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """world -> camera 4x4 with +z forward."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right = right / np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = -R @ eye
    return w2c


def _project(points, w2c, K):
    homo = np.concatenate([points, np.ones((len(points), 1))], 1)
    p = (w2c @ homo.T)[:3]
    z = p[2]
    u = np.round(p[0] * K[0, 0] / np.maximum(z, 1e-6) + K[0, 2]).astype(int)
    v = np.round(p[1] * K[1, 1] / np.maximum(z, 1e-6) + K[1, 2]).astype(int)
    return z, u, v


# geopurify_tpu/data/synthetic.py:60
def render_depth(points: np.ndarray, w2c: np.ndarray, K: np.ndarray,
                 hw: Tuple[int, int]) -> np.ndarray:
    """Point-splat z-buffer depth, 0 where no point lands."""
    H, W = hw
    z, u, v = _project(points, w2c, K)
    ok = (z > 0.05) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    depth = np.full((H, W), np.inf)
    np.minimum.at(depth, (v[ok], u[ok]), z[ok])
    depth[np.isinf(depth)] = 0.0
    return depth


# geopurify_tpu/data/synthetic.py:80
def make_scene_batch(seed: int = 0, n_points: int = 2000, n_views: int = 3,
                     image_hw: Tuple[int, int] = (48, 64), voxel_size: float = 0.05,
                     max_points: int = 2048, max_voxels: int = 2048, max_views: int = 4,
                     max_view_points: int = 1024, vis_thres: float = 0.1,
                     device="cpu") -> SceneBatch:
    rng = np.random.default_rng(seed)
    points, colors, labels = make_room_points(rng, n_points)
    normals = rng.normal(size=points.shape)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    geom = np.concatenate([colors, normals], 1).astype(np.float32)

    vox = Voxelizer(voxel_size=voxel_size).voxelize(points, geom, labels)
    # voxels lexicographically sorted (the neighbour table's contract)
    order = np.lexsort((vox.voxel_coords[:, 2], vox.voxel_coords[:, 1],
                        vox.voxel_coords[:, 0]))
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    voxel_coords = vox.voxel_coords[order].astype(np.int32)
    point2voxel = rank[vox.inds_reverse].astype(np.int32)
    M = len(voxel_coords)

    H, W = image_hw
    K = np.array([[W * 0.8, 0, W / 2], [0, W * 0.8, H / 2], [0, 0, 1.0]])
    center = points.mean(0)
    images, vids, vrows, vcols, vvalid = [], [], [], [], []
    for v in range(n_views):
        ang = 2 * np.pi * v / max(n_views, 1)
        eye = center + np.array([3.5 * np.cos(ang), 3.5 * np.sin(ang), 2.0])
        w2c = _look_at(eye, center)
        depth = render_depth(points, w2c, K, (H, W))
        z, u, vv = _project(points, w2c, K)
        inside = (z > 0.05) & (u >= 0) & (u < W) & (vv >= 0) & (vv < H)
        d_at = np.where(inside, depth[np.clip(vv, 0, H - 1), np.clip(u, 0, W - 1)], 0)
        visible = inside & (np.abs(d_at - z) <= vis_thres * np.maximum(d_at, 1e-6))
        ids = np.where(visible)[0]
        img = np.zeros((H, W, 3), np.uint8)
        img[vv[ids], u[ids]] = np.clip(colors[ids] * 255.0, 0, 255).astype(np.uint8)
        images.append(img)
        vids.append(pad_to(ids.astype(np.int32), max_view_points, value=max_points))
        vrows.append(pad_to(vv[ids].astype(np.int32), max_view_points))
        vcols.append(pad_to(u[ids].astype(np.int32), max_view_points))
        m = np.zeros(max_view_points, bool)
        m[: min(len(ids), max_view_points)] = True
        vvalid.append(m)

    P = max_points
    view_valid = np.zeros(max_views, bool)
    view_valid[:n_views] = True

    def stack_pad(lst, fill):
        return pad_to(np.stack(lst), max_views, axis=0, value=fill)

    pvalid = np.zeros(P, bool)
    pvalid[: len(points)] = True
    return SceneBatch.from_numpy(dict(
        points=pad_to(points, P),
        point_valid=pvalid,
        geom_feats=pad_to(geom, P),
        labels=pad_to(labels, P, value=255),
        voxel_coords=pad_to(voxel_coords, max_voxels),
        voxel_valid=pad_to(np.ones(M, bool), max_voxels, value=False),
        point2voxel=pad_to(point2voxel, P, value=max_voxels),
        images=stack_pad(images, 0),
        view_valid=view_valid,
        view_point_ids=stack_pad(vids, max_points).astype(np.int32),
        view_point_valid=stack_pad(vvalid, False).astype(bool),
        view_rows=stack_pad(vrows, 0).astype(np.int32),
        view_cols=stack_pad(vcols, 0).astype(np.int32),
    ), device=device)
