"""Voxel quantization: the host path of the data loader and the synthetic
scenes, and the static-shape device path of the Sonata teacher's grid
pooling.

Port of geopurify_tpu/ops/voxelize.py. The host path dedups floored
coordinates by their FNV-1a 64-bit hash (or, with ``hash_type="ravel"``,
their collision-free raveled key), first occurrence per voxel (the
reference's ``sparse_quantize``), in numpy. Here the port departs from
JAX, whose FNV dedup of non-negative coordinates takes its host C++
library: the port's copy of that route (``native.fnv_voxelize``, bit-equal)
was measured slower than numpy's on an H100 host (PERF.md, chip_smoke.py
phase 18), so the loader keeps one route. The device path sorts by
(valid first, x, y, z) and numbers voxels in that order, so voxels come
out lexicographically sorted, as the sparse-conv neighbour table needs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

_FNV_OFFSET = np.uint64(14695981039346656037)
_FNV_PRIME = np.uint64(1099511628211)


# geopurify_tpu/ops/voxelize.py:31
def fnv_hash_vec(arr: np.ndarray) -> np.ndarray:
    """FNV-1a 64-bit hash per row of an integer array."""
    arr = arr.astype(np.uint64, copy=True)
    hashed = np.full(arr.shape[0], _FNV_OFFSET, dtype=np.uint64)
    for j in range(arr.shape[1]):
        hashed *= _FNV_PRIME
        hashed = np.bitwise_xor(hashed, arr[:, j])
    return hashed


# geopurify_tpu/ops/voxelize.py:42
def ravel_hash_vec(arr: np.ndarray) -> np.ndarray:
    """Collision-free raveled key per row, after shifting each column's
    minimum to 0."""
    arr = arr.copy()
    arr -= arr.min(0)
    arr = arr.astype(np.uint64, copy=False)
    arr_max = arr.max(0).astype(np.uint64) + 1
    keys = np.zeros(arr.shape[0], dtype=np.uint64)
    for j in range(arr.shape[1] - 1):
        keys += arr[:, j]
        keys *= arr_max[j + 1]
    keys += arr[:, -1]
    return keys


# geopurify_tpu/ops/voxelize.py:57
def sparse_quantize_np(coords: np.ndarray, quantization_size: float = 1.0,
                       hash_type: str = "fnv") -> Tuple[np.ndarray, np.ndarray]:
    """(inds, inds_reverse): one representative point per voxel (first
    occurrence, ascending key order) and every point's voxel id."""
    if hash_type not in ("fnv", "ravel"):
        raise ValueError(f"hash_type must be 'fnv' or 'ravel', got {hash_type!r}")
    discrete = np.floor(coords / quantization_size)
    key = fnv_hash_vec(discrete) if hash_type == "fnv" else ravel_hash_vec(discrete)
    _, inds, inds_reverse = np.unique(key, return_index=True, return_inverse=True)
    return inds, inds_reverse.reshape(-1)


class VoxelizeResult(NamedTuple):
    voxel_coords: np.ndarray       # [M, 3] float voxel-grid coords (min at 0)
    feats: np.ndarray              # [M, C] representative features
    labels: Optional[np.ndarray]   # [M] representative labels
    inds_reverse: np.ndarray       # [N] point -> voxel id
    inds: np.ndarray               # [M] voxel -> representative point id


# geopurify_tpu/ops/voxelize.py:94
class Voxelizer:
    """Random rigid augmentation + floor-quantize + dedup.

    Augmentation (``use_augmentation``, the training loader's): a random
    rotation about each axis within its bound, composed in shuffled order,
    and a uniform scale jitter on 1 / voxel_size, drawn from ``rng`` with the
    JAX version's calls in its order, then a shift so the min coord sits at
    0. Normal channels feats[:, 3:6] rotate with the points when feats has
    more than 6 channels, as in the JAX version."""

    def __init__(
        self,
        voxel_size: float = 1.0,
        use_augmentation: bool = False,
        scale_augmentation_bound: Optional[Tuple[float, float]] = None,
        rotation_augmentation_bound: Optional[Tuple] = None,
        rng: Optional[np.random.Generator] = None,
    ):
        self.voxel_size = voxel_size
        self.use_augmentation = use_augmentation
        self.scale_augmentation_bound = scale_augmentation_bound
        self.rotation_augmentation_bound = rotation_augmentation_bound
        self.rng = rng or np.random.default_rng()

    # geopurify_tpu/ops/voxelize.py:118
    @staticmethod
    def _axis_rot(axis: np.ndarray, theta: float) -> np.ndarray:
        """Rodrigues rotation about a unit axis."""
        axis = axis / np.linalg.norm(axis)
        K = np.cross(np.eye(3), axis)
        return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)

    # geopurify_tpu/ops/voxelize.py:125
    def get_transformation_matrix(self) -> Tuple[np.ndarray, np.ndarray]:
        vox, rot = np.eye(4), np.eye(4)
        rot3 = np.eye(3)
        if self.use_augmentation and self.rotation_augmentation_bound is not None:
            mats = []
            for axis_ind, bound in enumerate(self.rotation_augmentation_bound):
                theta = self.rng.uniform(*bound) if bound is not None else 0.0
                axis = np.zeros(3)
                axis[axis_ind] = 1.0
                mats.append(self._axis_rot(axis, theta))
            self.rng.shuffle(mats)
            rot3 = mats[0] @ mats[1] @ mats[2]
        rot[:3, :3] = rot3
        scale = 1.0 / self.voxel_size
        if self.use_augmentation and self.scale_augmentation_bound is not None:
            scale *= self.rng.uniform(*self.scale_augmentation_bound)
        np.fill_diagonal(vox[:3, :3], scale)
        return vox, rot

    # geopurify_tpu/ops/voxelize.py:144
    def voxelize(self, coords: np.ndarray, feats: np.ndarray,
                 labels: Optional[np.ndarray] = None) -> VoxelizeResult:
        if coords.ndim != 2 or coords.shape[1] != 3:
            raise ValueError(f"coords must be [N, 3], got {coords.shape}")
        M_v, M_r = self.get_transformation_matrix()
        rigid = (M_r @ M_v) if self.use_augmentation else M_v
        homo = np.hstack([coords, np.ones((coords.shape[0], 1), dtype=coords.dtype)])
        coords_aug = np.floor(homo @ rigid.T[:, :3])
        coords_aug = np.floor(coords_aug - coords_aug.min(0))
        inds, inds_reverse = sparse_quantize_np(coords_aug)
        vox_feats = feats[inds].copy()
        if vox_feats.shape[1] > 6:
            vox_feats[:, 3:6] = vox_feats[:, 3:6] @ M_r[:3, :3].T
        vox_labels = labels[inds] if labels is not None else None
        return VoxelizeResult(coords_aug[inds], vox_feats, vox_labels, inds_reverse, inds)


class DeviceVoxels(NamedTuple):
    voxel_coords: torch.Tensor   # [max_voxels, 3] int32, padded with 0
    point2voxel: torch.Tensor    # [N] int32; max_voxels for invalid points
    voxel_valid: torch.Tensor    # [max_voxels] bool
    num_voxels: torch.Tensor     # [] int32


# geopurify_tpu/ops/voxelize.py:178
def voxelize_points(coords: torch.Tensor, valid: torch.Tensor,
                    max_voxels: int) -> DeviceVoxels:
    """Static-shape sparse quantize of integer coords [N, 3] (>= 0). Voxel
    ids follow the sort (valid first, x, y, z); each voxel's coords are its
    first point's in that order. Voxels past ``max_voxels`` are dropped and
    their points keep their id (>= max_voxels), as in the JAX version."""
    n = coords.shape[0]
    dev = coords.device
    order = torch.arange(n, device=dev)
    # lexsort: stable sorts from the least significant key up
    for key in (coords[:, 2], coords[:, 1], coords[:, 0], (~valid).to(torch.int32)):
        order = order[torch.argsort(key[order], stable=True)]
    sc = coords[order]
    valid_s = valid[order]
    prev = torch.cat([torch.full((1, 3), -1, dtype=coords.dtype, device=dev), sc[:-1]])
    new_voxel = (sc != prev).any(1) & valid_s
    vid = torch.cumsum(new_voxel.to(torch.int32), 0, dtype=torch.int32) - 1
    num_voxels = torch.where(valid_s.any(), torch.clamp(vid[-1] + 1, min=0), 0)
    point2voxel = torch.zeros((n,), dtype=torch.int32, device=dev)
    point2voxel[order] = torch.where(valid_s, vid, max_voxels)
    point2voxel = torch.where(valid, point2voxel, max_voxels)
    voxel_coords = torch.zeros((max_voxels + 1, 3), dtype=coords.dtype, device=dev)
    write = torch.where(new_voxel & (vid < max_voxels), vid, max_voxels).long()
    voxel_coords[write] = sc          # each voxel id written once; row M absorbs the rest
    voxel_valid = torch.arange(max_voxels, device=dev) < torch.clamp(num_voxels, max=max_voxels)
    return DeviceVoxels(voxel_coords[:max_voxels], point2voxel, voxel_valid,
                        num_voxels.to(torch.int32))
