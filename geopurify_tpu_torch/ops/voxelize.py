"""Voxel quantization: the host path the synthetic scenes use, and the
static-shape device path of the Sonata teacher's grid pooling.

Port of geopurify_tpu/ops/voxelize.py. The host path (numpy) dedups
floored coordinates by their FNV-1a 64-bit hash, first occurrence per voxel
(the reference's ``sparse_quantize``); the device path sorts by (valid
first, x, y, z) and numbers voxels in that order, so voxels come out
lexicographically sorted, as the sparse-conv neighbour table needs.
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


# geopurify_tpu/ops/voxelize.py:57
def sparse_quantize_np(coords: np.ndarray, quantization_size: float = 1.0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(inds, inds_reverse): one representative point per voxel (first
    occurrence, ascending hash order) and every point's voxel id."""
    key = fnv_hash_vec(np.floor(coords / quantization_size))
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
    """Floor-quantize at ``voxel_size`` (min coord shifted to 0) + dedup.
    The JAX version's random rigid augmentation is off by default and is
    not part of this port."""

    def __init__(self, voxel_size: float = 1.0):
        self.voxel_size = voxel_size

    def voxelize(self, coords: np.ndarray, feats: np.ndarray,
                 labels: Optional[np.ndarray] = None) -> VoxelizeResult:
        if coords.ndim != 2 or coords.shape[1] != 3:
            raise ValueError(f"coords must be [N, 3], got {coords.shape}")
        vox = np.eye(4)
        np.fill_diagonal(vox[:3, :3], 1.0 / self.voxel_size)
        homo = np.hstack([coords, np.ones((coords.shape[0], 1), dtype=coords.dtype)])
        coords_aug = np.floor(homo @ vox.T[:, :3])
        coords_aug = np.floor(coords_aug - coords_aug.min(0))
        inds, inds_reverse = sparse_quantize_np(coords_aug)
        vox_labels = labels[inds] if labels is not None else None
        return VoxelizeResult(coords_aug[inds], feats[inds].copy(), vox_labels,
                              inds_reverse, inds)


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
