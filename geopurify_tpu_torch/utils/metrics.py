"""Segmentation metrics — histogram I/U/target with Base/Novel/All splits.

Port of geopurify_tpu/utils/metrics.py: ``intersection_and_union`` computes
the per-class histograms on the tensors' device (the reference's
intersectionAndUnionGPU); ``SegMeter`` accumulates them on the host and
reports mIoU / mAcc / allAcc over all classes and the base, novel and
foreground (non-structural) groups; ``psum_histograms`` and
``allreduce_meter_across_hosts`` sum the histograms over the processes of a
multi-process evaluation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from geopurify_tpu_torch.parallel.mesh import all_reduce_, world


# geopurify_tpu/utils/metrics.py:21
def intersection_and_union(
    pred: torch.Tensor,          # [N] int predicted class
    target: torch.Tensor,        # [N] int gt class
    valid: torch.Tensor,         # [N] bool padding mask
    num_classes: int,
    ignore_labels: Tuple[int, ...] = (),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(intersection, union, target) histograms, each [num_classes] f32."""
    ignore = torch.zeros_like(valid)
    for ig in ignore_labels:
        ignore = ignore | (target == ig)
    keep = valid & ~ignore
    sentinel = num_classes
    p = torch.where(keep, pred.long(), sentinel)
    t = torch.where(keep, target.long(), sentinel)
    inter = torch.where(p == t, p, sentinel)

    def hist(x):
        # a class outside [0, num_classes] lands in a trash bin past the
        # sentinel and is cut off, as segment_sum drops out-of-range ids
        x = torch.where((x < 0) | (x > num_classes), num_classes + 1, x)
        return torch.bincount(x, minlength=num_classes + 2)[:num_classes].to(torch.float32)

    area_i, area_p, area_t = hist(inter), hist(p), hist(t)
    return area_i, area_p + area_t - area_i, area_t


# geopurify_tpu/utils/metrics.py:51
def psum_histograms(hists, group=None):
    """(I, U, T) summed over the ranks of ``group`` (the default group when
    None), each as an exact int64 count on its own device."""
    return tuple(all_reduce_(h.round().to(torch.int64), group=group) for h in hists)


# geopurify_tpu/utils/metrics.py:56
def allreduce_meter_across_hosts(meter: "SegMeter") -> "SegMeter":
    """Sum a SegMeter's histograms over every process of the default group,
    in place (each process evaluates its shard of the scenes; the summary
    covers them all). One process: a no-op, no collective issued."""
    if world()[1] == 1:
        return meter
    stacked = torch.from_numpy(np.stack([meter.intersection, meter.union, meter.target]))
    (total,) = psum_histograms([stacked])
    meter.intersection, meter.union, meter.target = total.numpy().astype(np.float64)
    return meter


# geopurify_tpu/utils/metrics.py:77
@dataclass
class SegMeter:
    """Accumulates per-class I/U/T and reports Base/Novel/All mIoU, mAcc,
    allAcc, plus the foreground group (all classes but wall/floor/ceiling,
    the reference's f-mIoU)."""

    num_classes: int
    base_category: Sequence[int] = ()
    novel_category: Sequence[int] = ()
    foreground_category: Sequence[int] = ()
    intersection: np.ndarray = None
    union: np.ndarray = None
    target: np.ndarray = None

    def __post_init__(self):
        self.intersection = np.zeros(self.num_classes)
        self.union = np.zeros(self.num_classes)
        self.target = np.zeros(self.num_classes)

    def update(self, inter, union, target):
        for acc, x in ((self.intersection, inter), (self.union, union),
                       (self.target, target)):
            acc += x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def _group(self, idx: Optional[Sequence[int]] = None) -> Dict[str, float]:
        sel = np.arange(self.num_classes) if idx is None or len(idx) == 0 else np.array(idx)
        i, u, t = self.intersection[sel], self.union[sel], self.target[sel]
        iou = i / np.maximum(u, 1e-10)
        acc = i / np.maximum(t, 1e-10)
        return {
            "mIoU": float(iou.mean()),
            "mAcc": float(acc.mean()),
            "allAcc": float(i.sum() / max(t.sum(), 1e-10)),
        }

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {"all": self._group(None)}
        if len(self.base_category):
            out["base"] = self._group(self.base_category)
        if len(self.novel_category):
            out["novel"] = self._group(self.novel_category)
        if len(self.foreground_category):
            out["foreground"] = self._group(self.foreground_category)
        return out

    def per_class_iou(self) -> np.ndarray:
        return self.intersection / np.maximum(self.union, 1e-10)


# geopurify_tpu/utils/metrics.py:126
class AverageMeter:
    """Running scalar average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = 0.0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)
