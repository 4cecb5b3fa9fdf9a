"""Precomputed fused-feature loader (the OpenScene layout).

Port of geopurify_tpu/data/feature_loader.py: per-scene 2D-fused feature
files (torch ``.pt`` holding ``{"feat": [Nv, C], "mask_full" or "mask":
[N] bool}``) precomputed offline are row-aligned with the scene batch the
loader builds, so that Stage 1 trains from them instead of running the
X-Decoder lift in the loop (``run.train --fused-features``).
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from geopurify_tpu_torch.config import GeoPurifyConfig
from geopurify_tpu_torch.data.loaders import SceneDataset, load_scene_any


# geopurify_tpu/data/feature_loader.py:26
@dataclass
class FusedScene:
    point_feats: np.ndarray     # [N, C] f32 fused 2D features (0 where unseen)
    point_mask: np.ndarray      # [N] bool: points with a fused feature
    xyz: np.ndarray             # [N, 3]
    labels: np.ndarray          # [N]


# geopurify_tpu/data/feature_loader.py:34
def load_fused_features(path: str, num_points: int) -> Tuple[np.ndarray, np.ndarray]:
    """One feature file -> ([N, C] features, [N] mask). The file is
    unpickled in full: load only files you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    feat = np.asarray(obj["feat"], np.float32)
    mask = obj.get("mask_full", obj.get("mask"))
    if mask is None:
        if len(feat) != num_points:
            raise ValueError(f"{path}: {len(feat)} feats for {num_points} points and no mask")
        return feat, np.ones(num_points, bool)
    mask = np.asarray(mask).astype(bool).reshape(-1)
    full = np.zeros((num_points, feat.shape[1]), np.float32)
    full[mask] = feat[: int(mask.sum())]
    return full, mask


# geopurify_tpu/data/feature_loader.py:55
class FusedFeatureDataset:
    """Scene point clouds paired with precomputed fused features.
    ``feature_root`` holds ``<scene_id>*.pt`` files; the first match in
    sorted order wins."""

    def __init__(self, cfg: GeoPurifyConfig, feature_root: str, split: str = "train",
                 device="cuda"):
        self.cfg = cfg
        self.feature_root = feature_root
        self.base = SceneDataset(cfg, split=split, augment=False, device=device)

    def __len__(self) -> int:
        return len(self.base)

    def feature_path(self, sid: str) -> Optional[str]:
        hits = sorted(glob.glob(os.path.join(self.feature_root, f"{sid}*.pt")))
        return hits[0] if hits else None

    def load(self, sid: str) -> Optional[FusedScene]:
        fp = self.feature_path(sid)
        if fp is None:
            return None
        sp = load_scene_any(self.base.scene_3d_path(sid))
        feats, mask = load_fused_features(fp, len(sp.xyz))
        return FusedScene(feats, mask, sp.xyz, sp.label)

    # geopurify_tpu/data/feature_loader.py:82
    def make_scene_batch_with_features(self, sid: str):
        """(SceneBatch, f2d [max_points, C] f32 numpy): the fused features
        row-aligned to the batch, the frozen 2D input of ``stage1_loss``;
        None when the scene has no feature file or is unusable. Scenes
        without views are kept: the features replace the lift. Row i is
        the feature of the batch's point i, through the point cap and the
        voxel budget (the JAX version indexes the file by the cap alone, and
        its rows slip past the first point the budget drops)."""
        fused = self.load(sid)
        if fused is None:
            return None
        got = self.base.make_scene_batch(sid, require_views=False, with_rows=True)
        if got is None:
            return None
        batch, rows = got
        feats = fused.point_feats[rows]
        padded = np.zeros((self.cfg.data.max_points, feats.shape[1]), np.float32)
        padded[: len(feats)] = feats
        return batch, padded
