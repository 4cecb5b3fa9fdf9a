"""Inference-time post-processing for the 2D X-Decoder task family.

Port of geopurify_tpu/models/inference2d.py: query predictions -> task
outputs for semantic, panoptic and instance segmentation, referring
segmentation (grounding), image-text retrieval and greedy captioning. The
outputs keep the JAX package's static shapes: each carries a ``valid``
mask instead of a dynamic length.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


# geopurify_tpu/models/inference2d.py:32
def semantic_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor,
                       keep_sem_bgd: bool = False) -> torch.Tensor:
    """Per-class probability maps [h, w, n_cls(+1)]: softmax over all
    columns (background last, dropped unless ``keep_sem_bgd``) against
    sigmoid masks."""
    probs = torch.softmax(mask_cls, -1)
    if not keep_sem_bgd:
        probs = probs[:, :-1]
    return torch.einsum("qc,qhw->hwc", probs, torch.sigmoid(mask_pred))


# geopurify_tpu/models/inference2d.py:46
class PanopticSegments(NamedTuple):
    """Row q describes the segment owned by query q (1-based ids)."""

    category_id: torch.Tensor  # [Q] int32
    isthing: torch.Tensor      # [Q] bool
    valid: torch.Tensor        # [Q] bool — query opened a segment
    seg_id: torch.Tensor       # [Q] int32 — this query's pixels' segment id


# geopurify_tpu/models/inference2d.py:58
def panoptic_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor,
                       is_thing: torch.Tensor, object_mask_threshold: float = 0.8,
                       overlap_threshold: float = 0.8
                       ) -> Tuple[torch.Tensor, PanopticSegments]:
    """Panoptic fusion, vectorized: keep non-background queries scoring
    above ``object_mask_threshold``; each pixel goes to the kept query
    maximizing score * sigmoid(mask) whose own mask is >= 0.5 there; a query
    keeps its segment when it wins pixels covering >= ``overlap_threshold``
    of its binarized mask; stuff queries of one class merge into the first
    such segment; ids increase in query order. Returns (panoptic_seg [h, w]
    int32, 0 = void, PanopticSegments)."""
    Q, n_cls = mask_cls.shape[0], mask_cls.shape[1] - 1
    dev = mask_cls.device
    probs = torch.softmax(mask_cls, -1)
    scores = probs.max(-1).values
    labels = torch.argmax(probs, -1).to(torch.int32)
    masks = torch.sigmoid(mask_pred)

    keep = (labels != n_cls) & (scores > object_mask_threshold)
    labels = labels.clamp(max=n_cls - 1).long()       # safe index for dropped rows
    prob_masks = torch.where(keep[:, None, None], scores[:, None, None] * masks,
                             torch.full_like(masks, -1.0))
    winner = torch.argmax(prob_masks, 0)                              # [h, w]
    binm = masks >= 0.5                                               # [Q, h, w]

    q_oh = F.one_hot(winner, Q).permute(2, 0, 1).to(torch.float32)    # [Q, h, w]
    winner_area = q_oh.sum((1, 2))
    orig_area = binm.sum((1, 2)).to(torch.float32)
    assigned = (q_oh * binm).sum((1, 2))
    passed = (keep & (winner_area > 0) & (orig_area > 0) & (assigned > 0)
              & (winner_area / orig_area.clamp(min=1.0) >= overlap_threshold))

    thing_q = is_thing.to(dev)[labels]
    stuff_pass = passed & ~thing_q
    qi = torch.arange(Q, device=dev)
    # the first passing stuff query of each class (stuff_memory_list merge)
    first_of_cls = torch.full((n_cls,), Q, device=dev, dtype=torch.long).scatter_reduce(
        0, labels, torch.where(stuff_pass, qi, Q), reduce="amin")
    rep = torch.where(stuff_pass, first_of_cls[labels], qi)
    opens = passed & (rep == qi)
    seg_of_q = torch.cumsum(opens.to(torch.int32), 0)
    seg_id = torch.where(passed, seg_of_q[rep], 0).to(torch.int32)

    pix_bin = torch.gather(binm, 0, winner[None])[0]
    pan = torch.where(passed[winner] & pix_bin, seg_id[winner], 0).to(torch.int32)
    return pan, PanopticSegments(category_id=labels.to(torch.int32), isthing=thing_q,
                                 valid=opens, seg_id=seg_id)


# geopurify_tpu/models/inference2d.py:133
class InstancePredictions(NamedTuple):
    masks: torch.Tensor    # [K, h, w] bool
    boxes: torch.Tensor    # [K, 4] f32 xyxy (x1 / y1 exclusive; zeros if empty)
    scores: torch.Tensor   # [K] f32 — class prob * mean in-mask mask prob
    classes: torch.Tensor  # [K] int32
    valid: torch.Tensor    # [K] bool


# geopurify_tpu/models/inference2d.py:141
def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """[N, h, w] bool -> [N, 4] f32 [xmin, ymin, xmax + 1, ymax + 1]; zeros
    for empty masks."""
    n, h, w = masks.shape
    x_any = masks.any(1).to(torch.uint8)                # [N, w]
    y_any = masks.any(2).to(torch.uint8)                # [N, h]
    x0 = torch.argmax(x_any, 1)
    x1 = w - torch.argmax(x_any.flip(1), 1)
    y0 = torch.argmax(y_any, 1)
    y1 = h - torch.argmax(y_any.flip(1), 1)
    box = torch.stack([x0, y0, x1, y1], 1).to(torch.float32)
    return torch.where(x_any.any(1)[:, None].bool(), box, torch.zeros_like(box))


# geopurify_tpu/models/inference2d.py:159
def instance_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor, topk: int = 10,
                       thing_mask: Optional[torch.Tensor] = None) -> InstancePredictions:
    """Top-k (query, class) pairs of the flattened class probabilities,
    masks binarized at logit 0, score = class prob * mean in-mask sigmoid;
    ``thing_mask`` marks non-thing picks invalid. Equal probabilities keep
    the lower flat index first (``jax.lax.top_k``'s order), through a stable
    descending sort."""
    n_cls = mask_cls.shape[1] - 1
    scores = torch.softmax(mask_cls, -1)[:, :-1].reshape(-1)
    top_scores, top_idx = torch.sort(scores, descending=True, stable=True)
    top_scores, top_idx = top_scores[:topk], top_idx[:topk]
    classes = (top_idx % n_cls).to(torch.int32)
    logits = mask_pred[top_idx // n_cls]                              # [K, h, w]
    binm = logits > 0
    area = binm.sum((1, 2)).to(torch.float32)
    mask_score = (torch.sigmoid(logits) * binm).sum((1, 2)) / (area + 1e-6)
    valid = torch.ones((topk,), dtype=torch.bool, device=mask_cls.device)
    if thing_mask is not None:
        valid = valid & thing_mask.to(mask_cls.device)[classes.long()]
    return InstancePredictions(masks=binm, boxes=masks_to_boxes(binm),
                               scores=top_scores * mask_score, classes=classes,
                               valid=valid)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-7)


# geopurify_tpu/models/inference2d.py:193
def grounding_inference(query_embeds: torch.Tensor, text_embeds: torch.Tensor,
                        mask_pred: torch.Tensor, logit_scale=1.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Referring segmentation: the best query per phrase by scaled cosine
    (min(exp(logit_scale), 100) x cosine). Returns (matched mask logits
    [T, h, w], matched query ids [T] int32)."""
    scale = torch.exp(torch.as_tensor(logit_scale, dtype=torch.float32)).clamp(max=100.0)
    sim = scale.to(query_embeds.device) * (_unit(query_embeds) @ _unit(text_embeds).T)
    matched = torch.argmax(sim, 0)
    return mask_pred[matched], matched.to(torch.int32)


# geopurify_tpu/models/inference2d.py:216
def retrieval_scores(image_embeds: torch.Tensor, text_embeds: torch.Tensor) -> torch.Tensor:
    """Image-text cosine similarity [T, N] (image embeddings: the class
    token's)."""
    return _unit(text_embeds) @ _unit(image_embeds).T


# geopurify_tpu/models/inference2d.py:228
def caption_greedy_decode(logits_fn: Callable[[torch.Tensor], torch.Tensor], steps: int,
                          context_length: int = 77, bos_id: int = 49406, batch: int = 1,
                          device="cpu") -> torch.Tensor:
    """Greedy autoregressive captioning: the buffer starts as BOS
    everywhere and step i writes ``argmax(logits_fn(tokens)[:, i])`` into
    slot i + 1 (row i predicts token i + 1). Returns the ids [B, L] int32."""
    steps = min(steps, context_length - 1)
    tokens = torch.full((batch, context_length), bos_id, dtype=torch.int32, device=device)
    for i in range(steps):
        tokens[:, i + 1] = torch.argmax(logits_fn(tokens)[:, i], -1).to(torch.int32)
    return tokens
