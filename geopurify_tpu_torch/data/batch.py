"""SceneBatch — the statically-padded scene contract, as torch tensors.

Port of geopurify_tpu/data/batch.py:28. The layout contract is unchanged:
- padding rides masks (``point_valid``, ``voxel_valid``, ``view_valid``,
  ``view_point_valid``);
- ``point2voxel == M`` for padded points;
- ``view_point_ids == P`` for padded view points;
- voxels are lexicographically sorted (the sparse-conv neighbour table
  relies on it).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class SceneBatch:
    # --- scene-level ---
    points: torch.Tensor          # [P, 3] f32 world coords
    point_valid: torch.Tensor     # [P] bool
    geom_feats: torch.Tensor      # [P, 6] f32 rgb(0..1) || normal
    labels: torch.Tensor          # [P] int32
    voxel_coords: torch.Tensor    # [M, 3] int32 (lex-sorted)
    voxel_valid: torch.Tensor     # [M] bool
    point2voxel: torch.Tensor     # [P] int32, == M for padding points
    # --- view-level ---
    images: torch.Tensor          # [V, H, W, 3] uint8 (or f32) RGB 0..255
    view_valid: torch.Tensor      # [V] bool
    view_point_ids: torch.Tensor  # [V, Pv] int32, == P for padding
    view_point_valid: torch.Tensor  # [V, Pv] bool
    view_rows: torch.Tensor       # [V, Pv] int32 pixel row (mask_shape space)
    view_cols: torch.Tensor       # [V, Pv] int32 pixel col

    def to(self, device) -> "SceneBatch":
        return SceneBatch(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })

    @classmethod
    def from_numpy(cls, arrays: dict, device="cpu") -> "SceneBatch":
        """Build from a dict of numpy arrays keyed by field name."""
        return cls(**{
            f.name: torch.from_numpy(np.ascontiguousarray(arrays[f.name]))
            for f in dataclasses.fields(cls)
        }).to(device)


def build_scene(seed: int, P: int, M: int, V: int, Pv: int, hw):
    """Numpy scene at bench scale — the port's own copy of bench.build_scene
    (bench.py:50-130), same draws in the same order, so a seed gives the same
    arrays as the JAX bench. Returns a dict of numpy arrays by SceneBatch
    field name."""
    rng = np.random.default_rng(seed)
    H, W = hw
    E = 200 if M <= 65536 else 352
    Ez = 120 if M <= 65536 else 180
    n_draw = 3 * M
    quarters = n_draw // 4
    floor = np.stack([
        rng.integers(0, E, quarters), rng.integers(0, E, quarters),
        rng.integers(0, 3, quarters),
    ], 1)
    wall1 = np.stack([
        rng.integers(0, 3, quarters), rng.integers(0, E, quarters),
        rng.integers(0, Ez, quarters),
    ], 1)
    wall2 = np.stack([
        rng.integers(0, E, quarters), rng.integers(0, 3, quarters),
        rng.integers(0, Ez, quarters),
    ], 1)
    n_ctr = max(24, M // 2730)
    centers = rng.integers(20, E - 20, (n_ctr, 3)) * np.array([1, 1, 0]) + np.array([0, 0, 12])
    n_obj = n_draw - 3 * quarters
    radii = rng.uniform(5.0, 14.0, (n_ctr, 3))
    which = rng.integers(0, n_ctr, n_obj)
    dirs = rng.normal(size=(n_obj, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    blob_pts = (centers[which] + dirs * radii[which]).clip(0, E - 1)
    cand = np.concatenate([floor, wall1, wall2, blob_pts]).astype(np.int32)
    vox = np.unique(cand, axis=0)
    assert vox.shape[0] >= M, f"only {vox.shape[0]} unique voxels; increase draws"
    keep = np.sort(rng.choice(vox.shape[0], M, replace=False))
    vox = vox[keep]
    pts_per_vox = P // M
    points = (
        np.repeat(vox, pts_per_vox, axis=0).astype(np.float32) * 0.02
        + rng.uniform(0, 0.02, (M * pts_per_vox, 3)).astype(np.float32)
    )
    point2voxel = np.repeat(np.arange(M, dtype=np.int32), pts_per_vox)
    geom = rng.uniform(-1, 1, (P, 6)).astype(np.float32)
    labels = rng.integers(0, 19, P, dtype=np.int32)
    images = rng.integers(0, 256, (V, H, W, 3), dtype=np.uint8)
    ids = np.stack([
        rng.choice(P, Pv, replace=False).astype(np.int32) for _ in range(V)
    ])
    rows = rng.integers(0, H, (V, Pv), dtype=np.int32)
    cols = rng.integers(0, W, (V, Pv), dtype=np.int32)
    return dict(
        points=points,
        point_valid=np.ones(P, bool),
        geom_feats=geom,
        labels=labels,
        voxel_coords=vox,
        voxel_valid=np.ones(M, bool),
        point2voxel=point2voxel,
        images=images,
        view_valid=np.ones(V, bool),
        view_point_ids=ids,
        view_point_valid=np.ones((V, Pv), bool),
        view_rows=rows,
        view_cols=cols,
    )


# geopurify_tpu/data/batch.py:46
def pad_to(arr: np.ndarray, n: int, axis: int = 0, value=0) -> np.ndarray:
    """Host-side pad / truncate along ``axis`` to exactly ``n``."""
    cur = arr.shape[axis]
    if cur == n:
        return arr
    if cur > n:
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(0, n)
        return arr[tuple(sl)]
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, n - cur)
    return np.pad(arr, widths, constant_values=value)
