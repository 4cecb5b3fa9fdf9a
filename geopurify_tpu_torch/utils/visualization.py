"""Visualization and qualitative-debug utilities (host-side numpy).

Port of geopurify_tpu/utils/visualization.py: the class palette
(ScanNet-20 colours, then seeded random ones), PCA and k-means feature
colourings, PLY dumps through the port's own writer (label-coloured
predictions, PCA-coloured features, affinity-entropy heatmaps, one point's
kNN neighbourhood; the same bytes as the JAX package's for the same
inputs), the affinity weights' row-entropy statistics, the query / text
embedding PCA plot (through matplotlib, ``False`` without it) and the 2D
semantic overlay.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

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


# geopurify_tpu/utils/visualization.py:39
def pca_color(features: np.ndarray, valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Project features to 3 PCA dims, normalize to 0..1 RGB
    (reference get_pca_color, visualization.py)."""
    f = np.asarray(features, np.float64)
    if valid is None:
        valid = np.ones(len(f), bool)
    fv = f[valid]
    mu = fv.mean(0, keepdims=True)
    x = fv - mu
    # top-3 right singular vectors
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    proj = (f - mu) @ vt[:3].T
    lo = np.percentile(proj[valid], 2, axis=0)
    hi = np.percentile(proj[valid], 98, axis=0)
    rgb = (proj - lo) / np.maximum(hi - lo, 1e-9)
    return np.clip(rgb, 0, 1).astype(np.float32)


# geopurify_tpu/utils/visualization.py:57
def kmeans_color(
    features: np.ndarray, k: int = 10, seed: int = 0,
    valid: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Cluster features, return palette colors per point."""
    f = np.asarray(features, np.float64)
    if valid is None:
        valid = np.ones(len(f), bool)
    rng = np.random.default_rng(seed)
    fv = f[valid]
    centers = fv[rng.choice(len(fv), min(k, len(fv)), replace=False)]
    for _ in range(25):
        d = ((fv[:, None] - centers[None]) ** 2).sum(-1)
        a = d.argmin(1)
        for c in range(len(centers)):
            m = a == c
            if m.any():
                centers[c] = fv[m].mean(0)
    d_all = ((f[:, None] - centers[None]) ** 2).sum(-1)
    assign = d_all.argmin(1)
    pal = class_palette(len(centers)).astype(np.float32) / 255.0
    return pal[assign]


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


# geopurify_tpu/utils/visualization.py:96
def save_feature_pca_ply(
    path: str, points: np.ndarray, features: np.ndarray,
    valid: Optional[np.ndarray] = None,
) -> None:
    rgb = pca_color(features, valid)
    if valid is not None:
        points, rgb = points[valid], rgb[valid]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_ply_points(path, points.astype(np.float32), rgb)


# geopurify_tpu/utils/visualization.py:107
def affinity_entropy_stats(weights: np.ndarray, valid: Optional[np.ndarray] = None
                           ) -> Dict[str, float]:
    """Row-entropy statistics of affinity weights [M, K] — the reference's
    affinity-weight debug probes (affinity_module.py:1291-1488)."""
    w = np.asarray(weights, np.float64)
    if valid is not None:
        w = w[valid]
    w = w / np.maximum(w.sum(1, keepdims=True), 1e-12)
    ent = -(w * np.log(np.maximum(w, 1e-12))).sum(1)
    max_ent = np.log(w.shape[1])
    return {
        "mean_entropy": float(ent.mean()),
        "median_entropy": float(np.median(ent)),
        "max_entropy": float(max_ent),
        "normalized_mean": float(ent.mean() / max_ent),
        "frac_peaked": float((ent < 0.5 * max_ent).mean()),
    }


# geopurify_tpu/utils/visualization.py:126
def save_affinity_heatmap_ply(
    path: str,
    points: np.ndarray,            # [M, 3] (voxel centers or points)
    weights: np.ndarray,           # [M, K] affinity weights
    valid: Optional[np.ndarray] = None,
    mode: str = "entropy",         # entropy | max
) -> None:
    """3D affinity heatmap: color each point by its row entropy (how diffuse
    its smoothing weights are) or its max edge weight — the reference's
    plot_affinity_heatmap_3d (models/affinity_module.py:1291-1373).
    Blue = peaked/confident, red = diffuse."""
    w = np.asarray(weights, np.float64)
    w = w / np.maximum(w.sum(1, keepdims=True), 1e-12)
    if mode == "entropy":
        val = -(w * np.log(np.maximum(w, 1e-12))).sum(1) / np.log(w.shape[1])
    else:
        val = 1.0 - w.max(1)
    val = np.clip(val, 0, 1)
    rgb = np.stack([val, 0.2 * np.ones_like(val), 1.0 - val], axis=1)
    if valid is not None:
        points, rgb = points[valid], rgb[valid]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_ply_points(path, points.astype(np.float32), rgb.astype(np.float32))


# geopurify_tpu/utils/visualization.py:151
def save_neighborhood_ply(
    path: str,
    points: np.ndarray,            # [M, 3]
    nbr: np.ndarray,               # [M, K] neighbor indices
    weights: np.ndarray,           # [M, K]
    center: int,
    valid: Optional[np.ndarray] = None,
) -> None:
    """Dump one point's kNN neighborhood: the center point white, neighbors
    colored by edge weight (hot = strong), everything else dim gray — the
    reference's visualize_local_neighborhoods
    (models/affinity_module.py:1375-1488)."""
    M = len(points)
    rgb = np.full((M, 3), 0.25, np.float32)
    w = np.asarray(weights[center], np.float64)
    w = w / np.maximum(w.sum(), 1e-12)
    wn = w / np.maximum(w.max(), 1e-12)
    idx = np.asarray(nbr[center], np.int64)
    rgb[idx] = np.stack(
        [wn, 0.1 + 0.4 * wn, 1.0 - wn], axis=1
    ).astype(np.float32)
    rgb[center] = 1.0
    if valid is not None:
        points, rgb = points[valid], rgb[valid]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_ply_points(path, points.astype(np.float32), rgb)


# geopurify_tpu/utils/visualization.py:179
def plot_query_embeddings(
    path: str,
    query_embeddings: np.ndarray,  # [Q, C] (e.g. mask_embed of one view)
    text_embeddings: Optional[np.ndarray] = None,  # [n_cls, C]
    class_names: Optional[Sequence[str]] = None,
) -> bool:
    """2D PCA scatter of query embeddings (+ text anchors) — the reference's
    query-embedding debug plots (models/utils/visualization.py). Returns
    False (no file written) when matplotlib is unavailable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False
    q = np.asarray(query_embeddings, np.float64)
    stack = q if text_embeddings is None else np.concatenate(
        [q, np.asarray(text_embeddings, np.float64)]
    )
    mu = stack.mean(0, keepdims=True)
    _, _, vt = np.linalg.svd(stack - mu, full_matrices=False)
    p2 = (stack - mu) @ vt[:2].T
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(p2[: len(q), 0], p2[: len(q), 1], s=12, c="tab:blue",
               label="queries", alpha=0.7)
    if text_embeddings is not None:
        t2 = p2[len(q):]
        ax.scatter(t2[:, 0], t2[:, 1], s=60, c="tab:red", marker="*",
                   label="text")
        if class_names is not None:
            for i, name in enumerate(class_names[: len(t2)]):
                ax.annotate(str(name), t2[i], fontsize=7)
    ax.legend()
    ax.set_title("query / text embedding PCA")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


# geopurify_tpu/utils/visualization.py:220
def overlay_2d_semantic(image: np.ndarray, labels_2d: np.ndarray, num_classes: int,
                        alpha: float = 0.5, ignore_label: int = 255) -> np.ndarray:
    """Blend a semantic map [H, W] over an RGB image [H, W, 3] (0..255)."""
    pal = class_palette(num_classes).astype(np.float32)
    color = pal[np.clip(labels_2d, 0, num_classes - 1)]
    keep = (labels_2d != ignore_label)[..., None]
    return np.where(keep, (1 - alpha) * image + alpha * color, image).astype(np.uint8)
