"""Alternative 2D-teacher lifts — LSeg (dense pixels) and APE (instances).

Port of geopurify_tpu/models/lift_variants.py. A backend callable
registered in ``models/lift_backends.py`` gives each view either dense
per-pixel embeddings (LSeg-style) or instance masks with embeddings and
scores (APE-style); both become the dense ``ViewLift`` of
``models/lift.py`` and go through the same consensus fusion and unseen
fill as the X-Decoder's.
"""

from __future__ import annotations

from typing import Protocol, Tuple

import torch

from geopurify_tpu_torch.models.lift import ViewLift, _normalized_lift
from geopurify_tpu_torch.ops.knn import nearest_fill


# geopurify_tpu/models/lift_variants.py:25
class DensePixelLift(Protocol):
    """LSeg-style backend: dense per-pixel embedding map for one view."""

    def __call__(self, image: torch.Tensor) -> torch.Tensor:  # [H, W, C]
        ...


# geopurify_tpu/models/lift_variants.py:32
class InstanceMaskLift(Protocol):
    """APE-style backend: (masks [Q, H, W] logits, embeds [Q, C], scores [Q])."""

    def __call__(self, image: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        ...


# geopurify_tpu/models/lift_variants.py:39
def lift_view_dense(pixel_feats, rows, cols, pv_valid, view_coords, text_embeddings,
                    logit_scale) -> ViewLift:
    """Dense-feature lift: each visible point takes its pixel's embedding
    (``pixel_feats`` [H, W, C] at the mask resolution); every visible point
    lands on a pixel, so no hole fill."""
    H, W, _ = pixel_feats.shape
    r = torch.clamp(rows.long(), 0, H - 1)
    c = torch.clamp(cols.long(), 0, W - 1)
    return _normalized_lift(pixel_feats[r, c].to(torch.float32), pv_valid,
                            text_embeddings, logit_scale)


# geopurify_tpu/models/lift_variants.py:62
def lift_view_instance(masks, embeds, scores, rows, cols, pv_valid, view_coords,
                       text_embeddings, logit_scale, mask_threshold: float = 0.5
                       ) -> ViewLift:
    """Instance-mask lift: the score-weighted argmax mask per pixel, its
    embedding where its sigmoid reaches ``mask_threshold``, and each
    uncovered visible point filled from its nearest covered point, as the
    X-Decoder lift does."""
    Q, H, W = masks.shape
    sig = torch.sigmoid(masks.to(torch.float32))
    mask_ids = torch.argmax(scores.to(torch.float32)[:, None, None] * sig, dim=0)
    r = torch.clamp(rows.long(), 0, H - 1)
    c = torch.clamp(cols.long(), 0, W - 1)
    winner = mask_ids[r, c]
    covered = (sig[winner, r, c] >= mask_threshold) & pv_valid
    feats = torch.where(covered[:, None], embeds.to(torch.float32)[winner], 0.0)
    feats = nearest_fill(feats, view_coords.to(torch.float32), covered, pv_valid)
    return _normalized_lift(feats, pv_valid, text_embeddings, logit_scale)
