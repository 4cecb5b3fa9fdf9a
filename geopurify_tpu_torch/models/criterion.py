"""Set-prediction training criterion: Hungarian matching and mask losses.

Port of geopurify_tpu/models/criterion.py. Predicted queries are matched
to ground-truth masks by a weighted (class, dice, linearised mask-BCE)
cost, then the matched pairs take point-sampled dice and sigmoid-CE mask
losses and every query a class CE (no-object for the unmatched). The
assignment runs on the host through scipy, one image at a time, as JAX's
``pure_callback`` does, and carries no gradient. The mask losses read
``num_points`` uniform points of the stride-4 mask grid, the same points
for every mask: drawn from an explicit ``torch.Generator``, or given
(a test hands over the points the JAX sampler drew). Also the VLP losses:
next-token captioning CE and the in-batch image-text contrastive loss.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# geopurify_tpu/models/criterion.py:29
def _hungarian_host(cost: np.ndarray) -> np.ndarray:
    """cost [Q, T] -> assignment [Q] (col per row; -1 if unassigned)."""
    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(cost)
    out = np.full(cost.shape[0], -1, np.int64)
    out[rows] = cols
    return out


# geopurify_tpu/models/criterion.py:40
def hungarian_match(cost: torch.Tensor) -> torch.Tensor:
    """cost [B, Q, T] -> assignment [B, Q] int64 on ``cost``'s device (-1 =
    unmatched), each image solved on the host."""
    c = cost.detach().float().cpu().numpy()
    out = np.stack([_hungarian_host(ci) for ci in c])
    return torch.from_numpy(out).to(cost.device)


# geopurify_tpu/models/criterion.py:54
def dice_loss(inputs: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """inputs [N, P] logits, targets [N, P] in {0,1}; mean over valid rows."""
    probs = torch.sigmoid(inputs)
    num = 2 * (probs * targets).sum(-1)
    den = probs.sum(-1) + targets.sum(-1)
    loss = 1 - (num + 1) / (den + 1)
    return (loss * valid).sum() / valid.sum().clamp_min(1)


# geopurify_tpu/models/criterion.py:63
def sigmoid_ce_loss(inputs: torch.Tensor, targets: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    loss = inputs.clamp_min(0) - inputs * targets + torch.log1p(torch.exp(-inputs.abs()))
    return (loss.mean(-1) * valid).sum() / valid.sum().clamp_min(1)


# geopurify_tpu/models/criterion.py:69
def sample_mask_points(hw: Tuple[int, int], generator: torch.Generator, num_points: int,
                       device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``num_points`` uniform (rows, cols) of an [H, W] grid from
    ``generator`` (on its device; moved to ``device``)."""
    H, W = hw
    gdev = generator.device
    rows = torch.randint(0, H, (num_points,), generator=generator, device=gdev)
    cols = torch.randint(0, W, (num_points,), generator=generator, device=gdev)
    return rows.to(device), cols.to(device)


# geopurify_tpu/models/criterion.py:81
def set_criterion(
    pred_logits: torch.Tensor,   # [B, Q, n_cls+1] (last = no-object)
    pred_masks: torch.Tensor,    # [B, Q, H, W] logits (stride-4 grid)
    gt_classes: torch.Tensor,    # [B, T] int
    gt_masks: torch.Tensor,      # [B, T, h, w] {0,1}
    gt_valid: torch.Tensor,      # [B, T] bool
    generator: Optional[torch.Generator] = None,
    num_points: int = 4096,
    cost_class: float = 2.0,
    cost_dice: float = 5.0,
    cost_mask: float = 5.0,
    points: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    return_cost: bool = False,
) -> Dict[str, torch.Tensor]:
    """Matching + losses: {'loss_ce', 'loss_dice', 'loss_mask', 'loss'}
    (and the masked cost and the assignment with ``return_cost``). The
    points are ``points`` = (rows, cols), else ``num_points`` drawn from
    ``generator`` over the predicted mask grid. A ground-truth grid smaller
    than the predicted one (an image padded to the size divisibility) is
    read at the points clamped to its last row and column, as JAX's gather
    clamps out-of-range indices."""
    B, Q, C1 = pred_logits.shape
    n_cls = C1 - 1
    dev = pred_masks.device
    if points is None:
        points = sample_mask_points(pred_masks.shape[-2:], generator, num_points, dev)
    rows, cols = (p.to(dev).long() for p in points)
    P = rows.shape[0]
    h, w = gt_masks.shape[-2:]
    pm = pred_masks[..., rows, cols].float()                                # [B, Q, P]
    gm = gt_masks[..., rows.clamp(max=h - 1), cols.clamp(max=w - 1)].float()  # [B, T, P]
    gt_valid = gt_valid.to(dev, torch.bool)
    gt_classes = gt_classes.to(dev).long()

    # ---- matching costs (no grad) ---------------------------------------
    with torch.no_grad():
        probs = torch.softmax(pred_logits.float(), -1)
        safe_cls = gt_classes.clamp(0, n_cls - 1)
        cost_cls = -torch.gather(probs[..., :n_cls], 2,
                                 safe_cls[:, None, :].expand(B, Q, -1))    # [B, Q, T]
        p = torch.sigmoid(pm)
        num = 2 * torch.einsum("bqp,btp->bqt", p, gm)
        den = p.sum(-1)[:, :, None] + gm.sum(-1)[:, None, :]
        cost_d = 1 - (num + 1) / (den + 1)
        # pointwise BCE cost, linearised (Mask2Former)
        soft = torch.log1p(torch.exp(-pm.abs()))
        pos = soft + (-pm).clamp_min(0)                                     # -log sig
        neg = soft + pm.clamp_min(0)                                        # -log(1-sig)
        cost_m = (torch.einsum("bqp,btp->bqt", pos, gm)
                  + torch.einsum("bqp,btp->bqt", neg, 1 - gm)) / P
        cost = cost_class * cost_cls + cost_dice * cost_d + cost_mask * cost_m
        cost = torch.where(gt_valid[:, None, :], cost, torch.full_like(cost, 1e6))
        assign = hungarian_match(cost)                                      # [B, Q]
        safe = assign.clamp_min(0)
        matched = (assign >= 0) & torch.gather(gt_valid, 1, safe)

    # ---- class CE over all queries (no-object for the unmatched) --------
    tgt_cls = torch.where(matched, torch.gather(gt_classes, 1, safe), n_cls)
    logp = F.log_softmax(pred_logits.float(), -1)
    ce = -torch.gather(logp, -1, tgt_cls[..., None])[..., 0]
    wgt = torch.where(tgt_cls == n_cls, 0.1, 1.0)                           # eos_coef 0.1
    loss_ce = (ce * wgt).sum() / wgt.sum().clamp_min(1)

    # ---- mask losses on the matched pairs --------------------------------
    tgt_masks = torch.gather(gm, 1, safe[..., None].expand(B, Q, P))        # [B, Q, P]
    mvalid = matched.float().reshape(-1)
    pm2, tm2 = pm.reshape(B * Q, P), tgt_masks.reshape(B * Q, P)
    loss_d = dice_loss(pm2, tm2, mvalid)
    loss_m = sigmoid_ce_loss(pm2, tm2, mvalid)
    total = cost_class * loss_ce + cost_dice * loss_d + cost_mask * loss_m
    out = {"loss_ce": loss_ce, "loss_dice": loss_d, "loss_mask": loss_m, "loss": total}
    if return_cost:
        out["cost"], out["assign"] = cost, assign
    return out


# geopurify_tpu/models/criterion.py:161
def captioning_loss(pred_captionings: torch.Tensor, token_embedding: torch.Tensor,
                    target_ids: torch.Tensor, target_mask: torch.Tensor) -> torch.Tensor:
    """Next-token CE over the caption slots: logits = pred[:, :-1] @ table.T,
    targets and mask shifted by one, masked mean with +1 in the
    denominator."""
    logits = pred_captionings[:, :-1] @ token_embedding.T                   # [B, T-1, V]
    tgt = target_ids[:, 1:].long()
    mask = target_mask[:, 1:].float()
    ce = -torch.gather(F.log_softmax(logits, -1), -1, tgt[..., None])[..., 0]
    return (ce * mask).sum() / (mask.sum() + 1.0)


# geopurify_tpu/models/criterion.py:180
def image_text_contrastive_loss(v_emb: torch.Tensor, t_emb: torch.Tensor,
                                logit_scale: torch.Tensor) -> torch.Tensor:
    """In-batch symmetric InfoNCE: both sides L2-normalised, scaled by
    min(exp(logit_scale), 100), CE against the diagonal both ways."""
    v = v_emb / (torch.linalg.norm(v_emb, dim=-1, keepdim=True) + 1e-7)
    t = t_emb / (torch.linalg.norm(t_emb, dim=-1, keepdim=True) + 1e-7)
    scale = torch.exp(logit_scale).clamp_max(100.0)
    logits = scale * (v @ t.T)
    gt = torch.arange(logits.shape[0], device=logits.device)
    l1 = -torch.gather(F.log_softmax(logits, -1), -1, gt[:, None]).mean()
    l2 = -torch.gather(F.log_softmax(logits.T, -1), -1, gt[:, None]).mean()
    return 0.5 * (l1 + l2)
