"""The X-Decoder evaluator family beyond semantic segmentation.

Port of geopurify_tpu/utils/eval2d_suite.py, a copy of its host numpy (the
port imports nothing of the JAX package). ``run/infer_interactive.py``'s
NoC evaluation runs ``InteractiveEvaluator``; the others wait for the 2D
training slice. The JAX module rebuilds the reference's detectron2-style
evaluators (reference third_party/X-Decoder/xdecoder/datasets/evaluation/
*.py) as dependency-light numpy accumulators with the reference's exact
metric math: panopticapi / COCOeval / pycocoevalcap are replaced by direct
implementations of the published formulas. Each evaluator follows the
reset() / process() / evaluate() protocol.

| evaluator      | reference file                     | metrics |
|----------------|------------------------------------|---------|
| Grounding      | grounding_evaluation.py:20-118     | cIoU, mIoU, precision@{.5...9} |
| Interactive    | interactive_evaluation.py:20-140   | NoC@{.5,.8,.85,.9}, mIoU@iter |
| Retrieval      | retrieval_evaluation.py:100-205    | ir/tr R@{1,5,10}, irtr |
| Classification | classification_evaluation.py:20-76 | top-1/top-5 accuracy |
| Captioning     | captioning_evaluation.py (CIDEr/\
                   BLEU via pycocoevalcap)           | BLEU-4 (direct impl) |
| Panoptic       | panoptic_evaluation.py (pq_compute)| PQ / SQ / RQ |
| Instance       | instance_evaluation.py (COCOeval)  | mask AP, AP50, AP75 |
"""

from __future__ import annotations

import math
from collections import Counter, OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Grounding (referring segmentation)
# ---------------------------------------------------------------------------

class GroundingEvaluator:
    """cIoU (cumulative I over cumulative U), mIoU, precision@t
    (grounding_evaluation.py:35-118)."""

    EVAL_IOUS = (0.5, 0.6, 0.7, 0.8, 0.9)

    def __init__(self):
        self.reset()

    def reset(self):
        self.cum_i = 0.0
        self.cum_u = 0.0
        self.miou = 0.0
        self.correct = np.zeros(len(self.EVAL_IOUS))
        self.total = 0

    def process(self, pred_masks: np.ndarray, gt_masks: np.ndarray):
        """pred_masks, gt_masks: [N, H, W] bool."""
        p = np.asarray(pred_masks, bool)
        g = np.asarray(gt_masks, bool)
        inter = (p & g).reshape(len(p), -1).sum(1)
        union = (p | g).reshape(len(p), -1).sum(1)
        iou = inter / (union + 1e-6)
        self.cum_i += float(inter.sum())
        self.cum_u += float(union.sum())
        self.miou += float(iou.sum())
        for k, t in enumerate(self.EVAL_IOUS):
            self.correct[k] += int((iou >= t).sum())
        self.total += len(p)

    def evaluate(self) -> Dict[str, float]:
        out = {
            f"precision@{t}": 100.0 * self.correct[k] / max(self.total, 1)
            for k, t in enumerate(self.EVAL_IOUS)
        }
        out["cIoU"] = 100.0 * self.cum_i / max(self.cum_u, 1e-6)
        out["mIoU"] = 100.0 * self.miou / max(self.total, 1)
        return out


# ---------------------------------------------------------------------------
# Interactive (click refinement)
# ---------------------------------------------------------------------------

class InteractiveEvaluator:
    """Number-of-clicks-to-IoU + mIoU at a fixed iteration
    (interactive_evaluation.py:39-77): NoC@t = first click index reaching
    IoU >= t (max_clicks when never reached)."""

    ALL_IOUS = (0.5, 0.8, 0.85, 0.9)

    def __init__(self, max_clicks: int = 20, iou_iter: int = 1):
        self.max_clicks = max_clicks
        self.iou_iter = iou_iter
        self.reset()

    def reset(self):
        self.iou_list: List[np.ndarray] = []

    def process(self, mask_ious: Sequence[np.ndarray]):
        """mask_ious: per-sample [max_clicks] IoU-after-click-k arrays."""
        self.iou_list += [np.asarray(x, np.float64) for x in mask_ious]

    def evaluate(self) -> Dict[str, float]:
        n = max(len(self.iou_list), 1)
        out = {}
        for t in self.ALL_IOUS:
            nocs = []
            for arr in self.iou_list:
                hit = arr >= t
                nocs.append(int(np.argmax(hit)) + 1 if hit.any() else self.max_clicks)
            out[f"noc@{t}"] = float(sum(nocs)) / n
        out[f"miou@iter{self.iou_iter}"] = float(
            sum(a[self.iou_iter - 1] for a in self.iou_list)
        ) / n
        return out


# ---------------------------------------------------------------------------
# Retrieval (image <-> text)
# ---------------------------------------------------------------------------

class RetrievalEvaluator:
    """Bidirectional recall@k over normalized embedding similarity
    (retrieval_evaluation.py:123-205). text_ids carry the image id each
    caption belongs to; multiple captions per image are standard."""

    def __init__(self, ensemble: bool = False):
        self.ensemble = ensemble
        self.reset()

    def reset(self):
        self.image_ids: List[int] = []
        self.text_ids: List[int] = []
        self.image_embeds: List[np.ndarray] = []
        self.image_embeds2: List[np.ndarray] = []
        self.text_embeds: List[np.ndarray] = []

    def process(self, image_id: int, image_embed: np.ndarray,
                caption_ids: Sequence[int], text_embeds: np.ndarray,
                image_embed2: Optional[np.ndarray] = None):
        self.image_ids.append(int(image_id))
        self.image_embeds.append(np.asarray(image_embed, np.float64))
        self.text_ids.extend(int(c) for c in caption_ids)
        self.text_embeds.append(np.asarray(text_embeds, np.float64))
        if self.ensemble:
            self.image_embeds2.append(np.asarray(image_embed2, np.float64))

    def evaluate(self) -> Dict[str, float]:
        iids = np.asarray(self.image_ids)
        tiids = np.asarray(self.text_ids)
        im = np.stack(self.image_embeds)
        tx = np.concatenate(self.text_embeds)
        im = im / np.linalg.norm(im, axis=-1, keepdims=True)
        tx = tx / np.linalg.norm(tx, axis=-1, keepdims=True)
        scores = im @ tx.T
        if self.ensemble:
            im2 = np.stack(self.image_embeds2)
            im2 = im2 / np.linalg.norm(im2, axis=-1, keepdims=True)
            scores = 0.5 * scores + 0.5 * (im2 @ tx.T)

        def recall_tr(k):     # image -> text
            top = np.argsort(-scores, axis=1)[:, :k]
            return float((tiids[top] == iids[:, None]).any(1).mean())

        def recall_ir(k):     # text -> image
            top = np.argsort(-scores, axis=0)[:k]
            return float((iids[top] == tiids[None, :]).any(0).mean())

        out = OrderedDict()
        ir1, tr1 = recall_ir(1), recall_tr(1)
        out["irtr"] = round(100 * (ir1 + tr1), 3)
        for k in (1, 5, 10):
            out[f"ir{k}"] = round(100 * recall_ir(k), 3)
            out[f"tr{k}"] = round(100 * recall_tr(k), 3)
        return out


# ---------------------------------------------------------------------------
# Classification
# ---------------------------------------------------------------------------

class ClassificationEvaluator:
    """top-1 / top-5 accuracy (classification_evaluation.py:38-76)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.top1 = 0
        self.top5 = 0
        self.total = 0

    def process(self, logits: np.ndarray, labels: np.ndarray):
        logits = np.asarray(logits)
        labels = np.asarray(labels)
        top5 = np.argsort(-logits, axis=1)[:, :5]
        self.top1 += int((top5[:, 0] == labels).sum())
        self.top5 += int((top5 == labels[:, None]).any(1).sum())
        self.total += len(labels)

    def evaluate(self) -> Dict[str, float]:
        n = max(self.total, 1)
        return {"top1": 100.0 * self.top1 / n, "top5": 100.0 * self.top5 / n}


# ---------------------------------------------------------------------------
# Captioning (BLEU-4, direct implementation of the standard formula)
# ---------------------------------------------------------------------------

def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu4(candidates: Sequence[str], references: Sequence[Sequence[str]]) -> float:
    """Corpus BLEU-4 with uniform weights + brevity penalty (Papineni et al.;
    the metric pycocoevalcap reports for captioning_evaluation.py)."""
    p_num = [0] * 4
    p_den = [0] * 4
    cand_len = 0
    ref_len = 0
    for cand, refs in zip(candidates, references):
        c = cand.lower().split()
        rs = [r.lower().split() for r in refs]
        cand_len += len(c)
        ref_len += min((abs(len(r) - len(c)), len(r)) for r in rs)[1]
        for n in range(1, 5):
            cn = _ngrams(c, n)
            if not cn:
                continue
            best = Counter()
            for r in rs:
                rn = _ngrams(r, n)
                for g in cn:
                    best[g] = max(best[g], rn.get(g, 0))
            p_num[n - 1] += sum(min(cnt, best[g]) for g, cnt in cn.items())
            p_den[n - 1] += sum(cn.values())
    if min(p_den) == 0 or min(p_num) == 0:
        return 0.0
    log_p = sum(math.log(p_num[n] / p_den[n]) for n in range(4)) / 4.0
    bp = 1.0 if cand_len > ref_len else math.exp(1.0 - ref_len / max(cand_len, 1))
    return bp * math.exp(log_p)


class CaptioningEvaluator:
    def __init__(self):
        self.reset()

    def reset(self):
        self.cands: List[str] = []
        self.refs: List[List[str]] = []

    def process(self, caption: str, references: Sequence[str]):
        self.cands.append(caption)
        self.refs.append(list(references))

    def evaluate(self) -> Dict[str, float]:
        return {"BLEU4": 100.0 * bleu4(self.cands, self.refs)}


# ---------------------------------------------------------------------------
# Panoptic quality
# ---------------------------------------------------------------------------

class PanopticEvaluator:
    """PQ/SQ/RQ (panopticapi semantics used by panoptic_evaluation.py):
    segments match iff IoU > 0.5 (unique by construction); per class
    PQ = sum IoU(TP) / (|TP| + |FP|/2 + |FN|/2), averaged over classes seen.
    VOID-labeled gt pixels are excluded; predicted segments with > 50% of
    their area over VOID don't count as FP."""

    def __init__(self, void_label: int = -1):
        self.void = void_label
        self.reset()

    def reset(self):
        # per-class accumulators
        self.iou_sum: Dict[int, float] = {}
        self.tp: Dict[int, int] = {}
        self.fp: Dict[int, int] = {}
        self.fn: Dict[int, int] = {}

    def _bump(self, d, c, v=1):
        d[c] = d.get(c, 0) + v

    def process(
        self,
        pred_seg: np.ndarray,    # [H, W] segment ids
        pred_info: Dict[int, int],   # segment id -> class id
        gt_seg: np.ndarray,      # [H, W] segment ids (void_label for VOID)
        gt_info: Dict[int, int],
    ):
        pred_seg = np.asarray(pred_seg)
        gt_seg = np.asarray(gt_seg)
        void_mask = gt_seg == self.void
        gt_areas = {s: int((gt_seg == s).sum()) for s in gt_info}
        pred_areas = {s: int((pred_seg == s).sum()) for s in pred_info}

        matched_gt = set()
        matched_pred = set()
        # pair overlaps via the combined id trick (panopticapi)
        combo = gt_seg.astype(np.int64) * (2 ** 32) + pred_seg.astype(np.int64)
        ids, counts = np.unique(combo[~void_mask], return_counts=True)
        inter = {}
        for cid, cnt in zip(ids, counts):
            gs, ps = int(cid >> 32), int(cid & (2 ** 32 - 1))
            inter[(gs, ps)] = int(cnt)
        for (gs, ps), it in inter.items():
            if gs not in gt_info or ps not in pred_info:
                continue
            if gt_info[gs] != pred_info[ps]:
                continue
            union = gt_areas[gs] + pred_areas[ps] - it \
                - int(((pred_seg == ps) & void_mask).sum())
            iou = it / max(union, 1)
            if iou > 0.5:
                c = gt_info[gs]
                self._bump(self.tp, c)
                self._bump(self.iou_sum, c, iou)
                matched_gt.add(gs)
                matched_pred.add(ps)
        for gs, c in gt_info.items():
            if gs not in matched_gt:
                self._bump(self.fn, c)
        for ps, c in pred_info.items():
            if ps in matched_pred:
                continue
            # mostly-void predictions are ignored, not FP (panopticapi rule)
            void_overlap = int(((pred_seg == ps) & void_mask).sum())
            if void_overlap / max(pred_areas[ps], 1) > 0.5:
                continue
            self._bump(self.fp, c)

    def evaluate(self) -> Dict[str, float]:
        classes = set(self.tp) | set(self.fp) | set(self.fn)
        pqs, sqs, rqs = [], [], []
        for c in classes:
            tp = self.tp.get(c, 0)
            fp = self.fp.get(c, 0)
            fn = self.fn.get(c, 0)
            denom = tp + 0.5 * fp + 0.5 * fn
            if denom == 0:
                continue
            sq = self.iou_sum.get(c, 0.0) / max(tp, 1)
            rq = tp / denom
            pqs.append(sq * rq)
            sqs.append(sq)
            rqs.append(rq)
        n = max(len(pqs), 1)
        return {
            "PQ": 100.0 * sum(pqs) / n,
            "SQ": 100.0 * sum(sqs) / n,
            "RQ": 100.0 * sum(rqs) / n,
        }


# ---------------------------------------------------------------------------
# Instance AP (mask AP over IoU thresholds .5:.95)
# ---------------------------------------------------------------------------

def _mask_iou_matrix(preds: np.ndarray, gts: np.ndarray) -> np.ndarray:
    p = preds.reshape(len(preds), -1).astype(bool)
    g = gts.reshape(len(gts), -1).astype(bool)
    inter = (p[:, None] & g[None]).sum(-1).astype(np.float64)
    union = (p[:, None] | g[None]).sum(-1).astype(np.float64)
    return inter / np.maximum(union, 1)


class InstanceEvaluator:
    """COCO-style mask AP (instance_evaluation.py ≙ COCOeval segm, 101-point
    interpolation, greedy score-ordered matching per IoU threshold)."""

    IOU_THRS = tuple(np.round(np.arange(0.5, 1.0, 0.05), 2))

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        # per class, per threshold: list of (score, is_tp); plus gt counts
        self.records: Dict[Tuple[int, float], List[Tuple[float, bool]]] = {}
        self.n_gt: Dict[int, int] = {}

    def process(self, pred_masks, pred_classes, pred_scores, gt_masks, gt_classes):
        pred_masks = np.asarray(pred_masks, bool)
        gt_masks = np.asarray(gt_masks, bool)
        pred_classes = np.asarray(pred_classes)
        gt_classes = np.asarray(gt_classes)
        scores = np.asarray(pred_scores, np.float64)
        for c in range(self.num_classes):
            gsel = np.nonzero(gt_classes == c)[0]
            psel = np.nonzero(pred_classes == c)[0]
            self.n_gt[c] = self.n_gt.get(c, 0) + len(gsel)
            if len(psel) == 0:
                continue
            order = psel[np.argsort(-scores[psel])]
            iou = (
                _mask_iou_matrix(pred_masks[order], gt_masks[gsel])
                if len(gsel) else np.zeros((len(order), 0))
            )
            for t in self.IOU_THRS:
                taken = np.zeros(len(gsel), bool)
                rec = self.records.setdefault((c, t), [])
                for pi in range(len(order)):
                    best, best_j = t, -1
                    for j in range(len(gsel)):
                        if not taken[j] and iou[pi, j] >= best:
                            best, best_j = iou[pi, j], j
                    if best_j >= 0:
                        taken[best_j] = True
                        rec.append((scores[order[pi]], True))
                    else:
                        rec.append((scores[order[pi]], False))

    def _ap(self, c: int, t: float) -> Optional[float]:
        n_gt = self.n_gt.get(c, 0)
        rec = self.records.get((c, t), [])
        if n_gt == 0:
            return None
        if not rec:
            return 0.0
        rec = sorted(rec, key=lambda r: -r[0])
        tps = np.cumsum([r[1] for r in rec])
        fps = np.cumsum([not r[1] for r in rec])
        recall = tps / n_gt
        precision = tps / np.maximum(tps + fps, 1)
        # 101-point interpolated AP (COCOeval)
        ap = 0.0
        for r in np.linspace(0, 1, 101):
            p = precision[recall >= r]
            ap += float(p.max()) if len(p) else 0.0
        return ap / 101.0

    def evaluate(self) -> Dict[str, float]:
        def mean_ap(thrs):
            vals = []
            for c in range(self.num_classes):
                per_t = [self._ap(c, t) for t in thrs]
                per_t = [v for v in per_t if v is not None]
                if per_t:
                    vals.append(sum(per_t) / len(per_t))
            return 100.0 * sum(vals) / max(len(vals), 1)

        return {
            "AP": mean_ap(self.IOU_THRS),
            "AP50": mean_ap([0.5]),
            "AP75": mean_ap([0.75]),
        }
