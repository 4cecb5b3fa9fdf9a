"""Within-scene view parallelism: one scene's views split over the ranks.

Port of geopurify_tpu/parallel/view_parallel.py. For the latency of a
single scene, the per-view 2D forwards (most of a scene's lift) are
independent: each rank of a power-of-two world that divides the view
bucket lifts a contiguous block of the views (dense features,
``GeoPurifyPipeline._view_step_dense``), and the cross-view consensus
fusion of ``models/lift.fuse_views`` is rebuilt from collectives:

- the consensus class: each rank's per-point sums of view logits and view
  counts, all-reduced;
- the top-k agreement merge: each rank merges its own views' (score,
  feature) candidates, then a hypercube tournament of log2(n) pairwise
  exchanges (rank i with i ^ 2^s) merges the top-k sets; the lower rank's
  candidates come first on equal scores, which keeps the sequential
  merge's order (score, then view), so every rank ends with the same
  global top-k;
- the unseen fill runs on every rank on the fused result.

The result equals ``pipeline.lift_scene`` up to the order of the consensus
sums (a point whose consensus class is a near-tie may pick another class)
and the view micro-batches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from geopurify_tpu_torch.models.lift import consensus_sums, mix_topk, topk_agreement
from geopurify_tpu_torch.parallel.mesh import all_reduce_, exchange

# points per tile of a merge's [tile, 2k, C] transient
_TILE = 1 << 17


# geopurify_tpu/parallel/view_parallel.py:37
def _merge_topk(ts_a, tf_a, ts_b, tf_b, k: int):
    """Top-k of the union of two per-point top-k candidate sets, ``a``'s
    first on equal scores."""
    s_out = torch.empty_like(ts_a)
    f_out = torch.empty_like(tf_a)
    for lo in range(0, ts_a.shape[0], _TILE):
        sl = slice(lo, lo + _TILE)
        cat_s = torch.cat([ts_a[sl], ts_b[sl]], 1)
        cat_f = torch.cat([tf_a[sl], tf_b[sl]], 1)
        new_s, arg = torch.sort(cat_s, dim=1, descending=True, stable=True)
        s_out[sl] = new_s[:, :k]
        f_out[sl] = torch.gather(cat_f, 1, arg[:, :k, None].expand(-1, -1, cat_f.shape[2]))
    return s_out, f_out


# geopurify_tpu/parallel/view_parallel.py:46
@torch.inference_mode()
def sharded_lift_scene(pipeline, batch, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lift of ONE scene with its views split over the ranks of
    ``group`` (the default group when None); every rank calls it with the
    same scene. Returns (fused features [P, C] f32, view count [P]) on every
    rank, equal to ``pipeline.lift_scene(batch)`` up to consensus near-ties
    and reduction order."""
    dist = torch.distributed
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    V = batch.images.shape[0]
    if V % n or (n & (n - 1)):
        raise ValueError(f"views {V} must split over a power-of-two world, got {n}")
    cfg = pipeline.cfg
    P = batch.points.shape[0]
    C = cfg.pooling.feature_dim
    top_k = cfg.xdecoder.fusion_top_k
    Vl = V // n
    lo = rank * Vl
    # the valid views are packed first; padding views never reach the model
    mine = min(max(int(batch.view_valid.sum()) - lo, 0), Vl)
    B = max(1, min(cfg.xdecoder.view_batch, Vl))
    feats, logits = [], []
    for s in range(0, mine, B):
        start = min(lo + s, V - B)
        lift = pipeline._view_step_dense(batch, start, B)
        keep = slice(lo + s - start, lo + s - start + min(B, mine - s))
        feats.append(lift.features[keep])
        logits.append(lift.logits[keep])
    n_cls = len(cfg.data.all_label)
    dev = batch.points.device
    feats = torch.cat(feats) if feats else torch.zeros((0, 1, C), device=dev)
    logits = torch.cat(logits) if logits else torch.zeros((0, 1, n_cls), device=dev)
    valid = (batch.view_point_valid & batch.view_valid[:, None])[lo: lo + mine]
    ids = torch.where(valid, batch.view_point_ids[lo: lo + mine].long(), P)

    # the global consensus: summed logits and counts (fuse_views' vote)
    sum_logits, count = consensus_sums(logits, ids, valid, P)
    summed = all_reduce_(torch.cat([sum_logits, count[:, None]], 1), group=group)
    sum_logits, count = summed[:, :n_cls], summed[:, n_cls]
    consensus = torch.argmax(sum_logits / torch.clamp(count, min=1.0)[:, None], dim=-1)

    # this rank's top-k, then the tournament
    Pv = ids.shape[1]
    ptrs = torch.arange(mine * Pv, device=dev).reshape(mine, Pv)
    ts, tp = topk_agreement(logits, ptrs, ids, valid, consensus, top_k)
    tf = feats.reshape(-1, C)[tp] if mine else torch.zeros((P, top_k, C), device=dev)
    for s in range(n.bit_length() - 1):
        peer = rank ^ (1 << s)
        ts_o, tf_o = exchange(ts, peer, group), exchange(tf, peer, group)
        ts, tf = (_merge_topk(ts, tf, ts_o, tf_o, top_k) if rank < peer
                  else _merge_topk(ts_o, tf_o, ts, tf, top_k))
    fused = mix_topk(ts, lambda a, b: tf[a:b], C)
    fused = torch.where(count[:, None] > 0, fused, 0.0)
    return pipeline.fill_unseen(fused, count, batch), count
