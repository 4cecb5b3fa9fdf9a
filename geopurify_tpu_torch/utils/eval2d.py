"""2D semantic-segmentation evaluator: mIoU / fwIoU / pACC over images.

Port of geopurify_tpu/utils/eval2d.py (the detectron2-style SemSegEvaluator
of the 2D teacher's validation path): an (n+1)^2 confusion matrix over
predicted against ground-truth label images, the ignore label and
out-of-range ground truth on the extra row. The histogram is an int32
``bincount`` on the tensors' device; the summary runs on the host.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


# geopurify_tpu/utils/eval2d.py:23
def confusion_update(pred: torch.Tensor, gt: torch.Tensor, num_classes: int,
                     ignore_label: int = 255) -> torch.Tensor:
    """[(n+1), (n+1)] int32 counts, rows = ground truth, columns = the
    prediction clipped into [0, n)."""
    n = num_classes
    g = gt.reshape(-1).long()
    g = torch.where((g == ignore_label) | (g >= n), n, g)
    p = pred.reshape(-1).long().clamp(0, n - 1)
    counts = torch.bincount(g * (n + 1) + p, minlength=(n + 1) * (n + 1))
    return counts.to(torch.int32).reshape(n + 1, n + 1)


# geopurify_tpu/utils/eval2d.py:49
class SemSeg2DEvaluator:
    """Accumulates confusion over (pred, gt) image pairs; detectron2-style
    summary keys (mIoU, fwIoU, IoU-<cls>, mACC, pACC, ACC-<cls>)."""

    def __init__(self, num_classes: int, class_names=None, ignore_label: int = 255):
        self.num_classes = num_classes
        self.class_names = (list(class_names) if class_names
                            else [str(i) for i in range(num_classes)])
        self.ignore_label = ignore_label
        self.reset()

    def reset(self):
        n = self.num_classes
        self.conf = np.zeros((n + 1, n + 1), np.float64)

    def process(self, pred, gt):
        self.conf += confusion_update(torch.as_tensor(pred), torch.as_tensor(gt),
                                      self.num_classes, self.ignore_label).cpu().numpy()

    def evaluate(self) -> Dict[str, float]:
        n = self.num_classes
        acc_matrix = self.conf[:n, :n]          # rows = gt, cols = pred
        tp = np.diag(acc_matrix)
        pos_gt = acc_matrix.sum(axis=1)
        pos_pred = acc_matrix.sum(axis=0)
        union = pos_gt + pos_pred - tp
        valid = pos_gt > 0
        iou = np.full(n, np.nan)
        iou[union > 0] = tp[union > 0] / union[union > 0]
        acc = np.full(n, np.nan)
        acc[valid] = tp[valid] / pos_gt[valid]
        miou = float(np.nanmean(iou[valid])) if valid.any() else 0.0
        freq = pos_gt / max(pos_gt.sum(), 1e-10)
        fwiou = float((iou[valid] * freq[valid]).sum()) if valid.any() else 0.0
        macc = float(np.nanmean(acc[valid])) if valid.any() else 0.0
        pacc = float(tp.sum() / max(pos_gt.sum(), 1e-10))
        out = {"mIoU": 100 * miou, "fwIoU": 100 * fwiou,
               "mACC": 100 * macc, "pACC": 100 * pacc}
        for i, name in enumerate(self.class_names):
            out[f"IoU-{name}"] = 100 * float(np.nan_to_num(iou[i]))
            out[f"ACC-{name}"] = 100 * float(np.nan_to_num(acc[i]))
        return out
