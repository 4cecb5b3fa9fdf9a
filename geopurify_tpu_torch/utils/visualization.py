"""Label-coloured PLY dumps of predictions (host-side numpy).

Port of the parts of geopurify_tpu/utils/visualization.py that
``run/validate.py --save-preds`` and ``run/infer2d.py`` use: the class
palette (ScanNet-20 colours, then seeded random ones), ``save_semantic_ply``,
which writes the same bytes as the JAX package's for the same points and
labels, and ``overlay_2d_semantic``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from geopurify_tpu_torch.data.ply import write_ply_points

# ScanNet-20 colour palette
SCANNET20_PALETTE = np.array([
    [174, 199, 232], [152, 223, 138], [31, 119, 180], [255, 187, 120],
    [188, 189, 34], [140, 86, 75], [255, 152, 150], [214, 39, 40],
    [197, 176, 213], [148, 103, 189], [196, 156, 148], [23, 190, 207],
    [247, 182, 210], [219, 219, 141], [255, 127, 14], [158, 218, 229],
    [44, 160, 44], [112, 128, 144], [227, 119, 194], [82, 84, 163],
], dtype=np.uint8)


# geopurify_tpu/utils/visualization.py:30
def class_palette(num_classes: int, seed: int = 1) -> np.ndarray:
    """[num_classes, 3] uint8; ScanNet-20 colours reused where possible."""
    if num_classes <= len(SCANNET20_PALETTE):
        return SCANNET20_PALETTE[:num_classes]
    rng = np.random.default_rng(seed)
    extra = rng.integers(30, 255, (num_classes - len(SCANNET20_PALETTE), 3))
    return np.concatenate([SCANNET20_PALETTE, extra.astype(np.uint8)])


# geopurify_tpu/utils/visualization.py:81
def save_semantic_ply(
    path: str, points: np.ndarray, labels: np.ndarray,
    num_classes: Optional[int] = None, valid: Optional[np.ndarray] = None,
) -> None:
    """Dump a label-coloured point cloud; labels < 0 render black."""
    if valid is not None:
        points, labels = points[valid], labels[valid]
    n_cls = num_classes or int(labels.max()) + 1
    pal = class_palette(n_cls)
    colors = pal[np.clip(labels, 0, n_cls - 1)]
    colors[labels < 0] = 0
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_ply_points(path, points.astype(np.float32), colors)


# geopurify_tpu/utils/visualization.py:220
def overlay_2d_semantic(image: np.ndarray, labels_2d: np.ndarray, num_classes: int,
                        alpha: float = 0.5, ignore_label: int = 255) -> np.ndarray:
    """Blend a semantic map [H, W] over an RGB image [H, W, 3] (0..255)."""
    pal = class_palette(num_classes).astype(np.float32)
    color = pal[np.clip(labels_2d, 0, num_classes - 1)]
    keep = (labels_2d != ignore_label)[..., None]
    return np.where(keep, (1 - alpha) * image + alpha * color, image).astype(np.uint8)
