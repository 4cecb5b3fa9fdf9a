"""Stage-1 contrastive pair sampling and the InfoNCE loss.

Port of geopurify_tpu/ops/contrastive.py. The hybrid sampler picks
``num_anchors`` random valid points (the anchor count capped at
n_valid // 3 by ``anchor_valid``); the positive of each anchor is its most
similar teacher feature (self and invalid points excluded); the negatives
are the ``num_macro`` globally least similar and the ``num_micro`` least
similar among the anchor's spatial kNN. Anchor selection, the only random
part, is split from the rest (``select_anchors`` / ``pairs_from_anchors``)
so that a caller can hand in anchors drawn elsewhere.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from geopurify_tpu_torch.ops.knn import (
    _chunked_topk_min,
    _matmul_f32,
    knn_anchors_grid,
    knn_search,
)
from geopurify_tpu_torch.utils import profiling


# geopurify_tpu/ops/contrastive.py:29
class ContrastivePairs(NamedTuple):
    anchor_idx: torch.Tensor     # [A] int32
    positive_idx: torch.Tensor   # [A] int32
    negative_idx: torch.Tensor   # [A, num_negatives] int32
    anchor_valid: torch.Tensor   # [A] bool


# geopurify_tpu/ops/contrastive.py:36
def _normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


# geopurify_tpu/ops/contrastive.py:64-75
def select_anchors(generator: torch.Generator, valid: torch.Tensor, num_anchors: int):
    """Random valid points first: (anchor_idx [A] int32, anchor_valid [A]
    bool). Uniform scores, +2 on invalid points, stable argsort; the valid
    count is capped at min(take, n_valid // 3)."""
    N = valid.shape[0]
    dev = valid.device
    scores = torch.rand((N,), generator=generator, device=dev) + (~valid).float() * 2.0
    order = torch.argsort(scores, stable=True)
    take = min(num_anchors, N)
    anchor_idx = torch.zeros((num_anchors,), dtype=torch.int32, device=dev)
    anchor_idx[:take] = order[:take].to(torch.int32)
    cap = torch.clamp(valid.sum() // 3, max=take)
    anchor_valid = torch.arange(num_anchors, device=dev) < cap
    return anchor_idx, anchor_valid


# geopurify_tpu/ops/contrastive.py:77-159
def pairs_from_anchors(
    teacher_feats: torch.Tensor,   # [N, D]
    valid: torch.Tensor,           # [N] bool
    anchor_idx: torch.Tensor,      # [A]
    anchor_valid: torch.Tensor,    # [A] bool
    neighbor_idx: Optional[torch.Tensor] = None,   # [N, K] spatial kNN
    coords: Optional[torch.Tensor] = None,         # [N, 3]: kNN of the anchors
    num_macro: int = 48,
    num_micro: int = 15,
    spatial_k: int = 96,
    anchor_tile: int = 512,
    spatial_radius: float = 0.3,
    spatial_method: str = "grid",
) -> ContrastivePairs:
    """The deterministic part of the sampler, given the anchors. The
    anchors' spatial kNN, where no ``neighbor_idx`` is given: 'grid' the
    pruned ``knn_anchors_grid`` at ``spatial_radius``, 'brute' the full
    ``knn_search`` (geopurify_tpu/ops/contrastive.py:77-97); the same
    neighbours for every anchor on a valid point."""
    if spatial_method not in ("grid", "brute"):
        raise ValueError(f"unknown spatial_method {spatial_method!r}")
    f = _normalize(teacher_feats.to(torch.float32))
    f = torch.where(valid[:, None], f, 0.0)
    aidx = anchor_idx.long()
    if neighbor_idx is None:
        if coords is None:
            raise ValueError("pass either neighbor_idx or coords")
        cf = coords.to(torch.float32)
        if spatial_method == "grid":
            _, anbr = knn_anchors_grid(cf, valid, aidx, k=spatial_k, radius=spatial_radius)
        else:
            _, anbr = knn_search(cf[aidx], cf, valid, k=spatial_k, query_ids=aidx,
                                 exclude_identical_index=True)
    else:
        anbr = neighbor_idx[aidx]
    anbr = anbr.long()
    N = f.shape[0]
    cols = torch.arange(N, device=f.device)
    dead = ~valid[None, :]
    pos_all, neg_all = [], []
    for lo in range(0, aidx.shape[0], anchor_tile):
        ai = aidx[lo:lo + anchor_tile]
        nb = anbr[lo:lo + anchor_tile]
        fa = f[ai]
        sims = _matmul_f32(fa, f.T)                           # [T, N]
        excl = (cols[None, :] == ai[:, None]) | dead
        # positive: max excluding self and dead points, first index on ties
        pos_i = torch.argmax(sims.masked_fill(excl, float("-inf")), dim=1)
        # macro: the bottom num_macro + 1, the positive stably moved to the
        # back (it can only appear there under exact ties), keep num_macro
        _, worst_i = _chunked_topk_min(sims.masked_fill_(excl, float("inf")),
                                       num_macro + 1)
        perm = torch.argsort((worst_i == pos_i[:, None]).to(torch.int8), dim=1,
                             stable=True)
        macro = torch.gather(worst_i, 1, perm)[:, :num_macro]
        # micro: the least similar of the spatial kNN, positive and self out
        local = (f[nb] * fa[:, None, :]).sum(-1)
        local = local.masked_fill((nb == pos_i[:, None]) | (nb == ai[:, None]),
                                  float("inf"))
        _, hard = _chunked_topk_min(local, num_micro)
        micro = torch.gather(nb, 1, hard)
        pos_all.append(pos_i)
        neg_all.append(torch.cat([macro, micro], 1))
    return ContrastivePairs(
        anchor_idx.to(torch.int32), torch.cat(pos_all).to(torch.int32),
        torch.cat(neg_all).to(torch.int32), anchor_valid)


# geopurify_tpu/ops/contrastive.py:41
def sample_contrastive_pairs_hybrid(
    generator: torch.Generator,
    teacher_feats: torch.Tensor,
    valid: torch.Tensor,
    neighbor_idx: Optional[torch.Tensor] = None,
    coords: Optional[torch.Tensor] = None,
    num_anchors: int = 4096,
    num_macro: int = 48,
    num_micro: int = 15,
    spatial_k: int = 96,
    anchor_tile: int = 512,
    spatial_method: str = "grid",
    spatial_radius: float = 0.3,
) -> ContrastivePairs:
    """Anchors from ``generator``, then ``pairs_from_anchors``."""
    with profiling.span("sampler"):
        anchor_idx, anchor_valid = select_anchors(generator, valid, num_anchors)
        return pairs_from_anchors(
            teacher_feats, valid, anchor_idx, anchor_valid, neighbor_idx=neighbor_idx,
            coords=coords, num_macro=num_macro, num_micro=num_micro,
            spatial_k=spatial_k, anchor_tile=anchor_tile, spatial_radius=spatial_radius,
            spatial_method=spatial_method)


# geopurify_tpu/ops/contrastive.py:162
def info_nce_loss(anchor_embed, positive_embed, negative_embed, anchor_valid,
                  temperature: float = 0.07) -> torch.Tensor:
    """InfoNCE over cosine logits, label 0 = positive, masked mean."""
    a = _normalize(anchor_embed.to(torch.float32))
    p = _normalize(positive_embed.to(torch.float32))
    n = _normalize(negative_embed.to(torch.float32))
    l_pos = (a * p).sum(-1)[:, None]
    l_neg = torch.einsum("ae,ane->an", a, n)
    logits = torch.cat([l_pos, l_neg], 1) / temperature
    per_anchor = -torch.log_softmax(logits, dim=-1)[:, 0]
    w = anchor_valid.to(torch.float32)
    return (per_anchor * w).sum() / torch.clamp(w.sum(), min=1.0)
