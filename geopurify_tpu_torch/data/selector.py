"""Data-efficiency scene selector: picks the ~1.5% training subset.

Port of geopurify_tpu/data/selector.py (host-only numpy): per scene the
semantic-class histogram, the count of distinct classes Nc and the label
entropy Hc; outlier Nc clamped by a median filter; scenes clustered by
k-means over their normalised histograms, scored by norm(Hc) + gamma *
norm(Nc), and the best of each cluster taken. The k-means draws from
``np.random.default_rng(seed)`` as the JAX version does, so a seed gives
its assignments.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np

from geopurify_tpu_torch.data.loaders import load_scene_any


# geopurify_tpu/data/selector.py:24
def scene_label_stats(path: str, num_classes: int, ignore_label: int = 255
                      ) -> Tuple[np.ndarray, int, float]:
    """(class histogram [num_classes], Nc distinct classes, Hc entropy)."""
    lab = load_scene_any(path).label
    lab = lab[(lab >= 0) & (lab < num_classes)]
    hist = np.bincount(lab, minlength=num_classes).astype(np.float64)
    total = hist.sum()
    if total == 0:
        return hist, 0, 0.0
    p = hist / total
    nz = p[p > 0]
    return hist, int((hist > 0).sum()), float(-(nz * np.log(nz)).sum())


# geopurify_tpu/data/selector.py:41
def _kmeans(x: np.ndarray, k: int, iters: int = 50, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = len(x)
    k = min(k, n)
    centers = x[rng.choice(n, k, replace=False)]
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = ((x[:, None] - centers[None]) ** 2).sum(-1)
        new_assign = d.argmin(1)
        if np.all(new_assign == assign):
            break
        assign = new_assign
        for c in range(k):
            m = assign == c
            if m.any():
                centers[c] = x[m].mean(0)
    return assign


# geopurify_tpu/data/selector.py:60
def _normalize(v: np.ndarray) -> np.ndarray:
    lo, hi = v.min(), v.max()
    return (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)


# geopurify_tpu/data/selector.py:65
def select_training_subset(scene_paths: Dict[str, str], num_classes: int,
                           subset_size: int = 20, num_clusters: int = 5,
                           gamma: float = 0.5, ignore_label: int = 255,
                           workers: int = 8, seed: int = 0) -> List[str]:
    """``subset_size`` scene ids (sorted) that maximise class coverage and
    diversity; ``scene_paths`` maps scene id -> its ``.pth`` / ``.ply``."""
    ids = sorted(scene_paths)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        stats = list(ex.map(
            lambda sid: scene_label_stats(scene_paths[sid], num_classes, ignore_label), ids))
    hists = np.stack([h for h, _, _ in stats])
    nc = np.array([n for _, n, _ in stats], np.float64)
    hc = np.array([h for _, _, h in stats], np.float64)

    # median filter: clamp outlier class counts
    med = np.median(nc)
    mad = np.median(np.abs(nc - med)) + 1e-9
    nc = np.clip(nc, med - 3 * mad, med + 3 * mad)

    hist_norm = hists / np.maximum(hists.sum(1, keepdims=True), 1.0)
    clusters = _kmeans(hist_norm, num_clusters, seed=seed)
    score = _normalize(hc) + gamma * _normalize(nc)

    chosen: List[str] = []
    per_cluster = -(-subset_size // num_clusters)
    for c in range(num_clusters):
        members = np.where(clusters == c)[0]
        if len(members) == 0:
            continue
        order = members[np.argsort(-score[members])]
        chosen += [ids[i] for i in order[:per_cluster]]
    # top up / trim to the exact size by global score
    if len(chosen) < subset_size:
        rest = [i for i in np.argsort(-score) if ids[i] not in chosen]
        chosen += [ids[i] for i in rest[: subset_size - len(chosen)]]
    return sorted(chosen[:subset_size])


# geopurify_tpu/data/selector.py:117
def write_scene_list(path: str, scene_ids: Sequence[str]) -> None:
    with open(path, "w") as f:
        for sid in scene_ids:
            f.write(sid + "\n")
