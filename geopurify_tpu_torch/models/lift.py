"""Multi-view 2D->3D lifting + cross-view consensus fusion.

Port of geopurify_tpu/models/lift.py: each view's X-Decoder masks are
evaluated at its visible points' pixels and every point takes the argmax
mask's embedding; uncovered points take their nearest covered point's; the
views are fused by a consensus vote plus a top-k agreement merge. The
index-valued form (``lift_view_ids`` + ``fuse_views_indexed``: a row of a
Q+1-row table per point, row Q the zero sentinel) is the X-Decoder
pipeline's; the dense form (``lift_view_features`` + ``fuse_views``: [Pv, C]
features per view) serves the lseg / ape backends and the view-parallel
lift.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from geopurify_tpu_torch.models.layers import _aa_resize_taps, resize_bicubic_antialias
from geopurify_tpu_torch.ops.knn import nearest_donor, nearest_fill, nearest_fill_grid
from geopurify_tpu_torch.ops.segment import segment_sum
from geopurify_tpu_torch.utils import profiling


# geopurify_tpu/models/lift.py:33
class ViewLift(NamedTuple):
    features: torch.Tensor     # [Pv, C] L2-normalized per-point features (0 if unseen)
    logits: torch.Tensor       # [Pv, n_cls] scaled cosine logits vs text


class ViewLiftIds(NamedTuple):
    winner: torch.Tensor       # [Pv] int32 in [0, Q]; Q = the no-feature sentinel
    embed_table: torch.Tensor  # [Q+1, C] L2-normalized mask embeds, zero last row
    logit_table: torch.Tensor  # [Q+1, n_cls] scaled cosine logits, zero last row


# geopurify_tpu/models/lift.py:48
def lift_view_features(pred_masks, mask_embed, pred_logits, rows, cols, pv_valid,
                       view_coords, text_embeddings, logit_scale,
                       mask_shape: Tuple[int, int], mask_threshold: float = 0.5
                       ) -> ViewLift:
    """Dense single-view lift: each covered point takes its winning mask's
    embedding, each uncovered visible point its nearest covered point's;
    then L2-normalized, with the scaled cosine logits against the text."""
    winner, covered = _view_winner(pred_masks, pred_logits, rows, cols, pv_valid,
                                   mask_shape, mask_threshold)
    feats = torch.where(covered[:, None], mask_embed.to(torch.float32)[winner], 0.0)
    feats = nearest_fill(feats, view_coords.to(torch.float32), covered, pv_valid)
    return _normalized_lift(feats, pv_valid, text_embeddings, logit_scale)


def _normalized_lift(feats, pv_valid, text_embeddings, logit_scale) -> ViewLift:
    """Zero the padding rows, L2-normalize, and the scaled cosine logits
    (the tail every dense lift shares; models/lift_variants.py too)."""
    feats = torch.where(pv_valid[:, None], feats, 0.0)
    feats = feats / torch.clamp(torch.linalg.norm(feats, dim=-1, keepdim=True), min=1e-12)
    logits = logit_scale * feats @ text_embeddings.to(torch.float32).T
    return ViewLift(feats, logits)


# geopurify_tpu/models/lift.py:86
def _view_winner(pred_masks, pred_logits, rows, cols, pv_valid,
                 mask_shape: Tuple[int, int], mask_threshold: float):
    """Winning mask id + covered flag per view point. Evaluates the
    antialiased bicubic resample only at the point pixels when that touches
    fewer samples than the full [Q, H, W] grid (the same static gate)."""
    H, W = mask_shape
    Q, h, w = pred_masks.shape
    dev = pred_masks.device
    probs = torch.softmax(pred_logits.to(torch.float32), dim=-1)
    scores = probs[..., :-1].max(dim=-1).values                   # [Q]
    r = torch.clamp(rows.long(), 0, H - 1)
    c = torch.clamp(cols.long(), 0, W - 1)
    lo_y, w_y = (torch.from_numpy(a).to(dev) for a in _aa_resize_taps(h, H))
    lo_x, w_x = (torch.from_numpy(a).to(dev) for a in _aa_resize_taps(w, W))
    Ty, Tx = w_y.shape[1], w_x.shape[1]
    Pv = rows.shape[0]
    if Pv * Ty * Tx <= H * W:
        py, wy = lo_y[r].long(), w_y[r]
        px, wx = lo_x[c].long(), w_x[c]
        pix = ((py[:, None, None] + torch.arange(Ty, device=dev)[None, :, None]) * w
               + (px[:, None, None] + torch.arange(Tx, device=dev)[None, None, :])
               ).reshape(-1, Ty * Tx)                                # [Pv, T]
        masks_flat = pred_masks.permute(1, 2, 0).reshape(h * w, Q)
        g = masks_flat[pix].to(torch.float32)                        # [Pv, T, Q]
        wts = (wy[:, :, None] * wx[:, None, :]).reshape(-1, Ty * Tx)
        vals = torch.bmm(wts[:, None, :], g)[:, 0]                   # [Pv, Q]
        sig_pts = torch.sigmoid(vals)
        winner = torch.argmax(scores[None, :] * sig_pts, dim=-1)
        sig_win = torch.gather(sig_pts, 1, winner[:, None])[:, 0]
    else:
        masks = resize_bicubic_antialias(
            pred_masks.permute(1, 2, 0)[None], (H, W))[0].permute(2, 0, 1)
        sig = torch.sigmoid(masks)
        mask_ids = torch.argmax(scores[:, None, None] * sig, dim=0)  # [H, W]
        winner = mask_ids[r, c]
        sig_win = sig[winner, r, c]
    covered = (sig_win >= mask_threshold) & pv_valid
    return winner, covered


# geopurify_tpu/models/lift.py:160
def lift_view_ids(pred_masks, mask_embed, pred_logits, rows, cols, pv_valid,
                  view_coords, text_embeddings, logit_scale,
                  mask_shape: Tuple[int, int], mask_threshold: float = 0.5
                  ) -> ViewLiftIds:
    """Index-valued single-view lift: winner row per point (covered points:
    their mask; hole-filled points: their donor's; unseen: the sentinel Q)
    plus the normalized embedding and logit tables."""
    winner, covered = _view_winner(pred_masks, pred_logits, rows, cols, pv_valid,
                                   mask_shape, mask_threshold)
    Q, C = mask_embed.shape
    emb = mask_embed.to(torch.float32)
    emb_n = emb / torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True), min=1e-12)
    logits_q = logit_scale * emb_n @ text_embeddings.to(torch.float32).T
    embed_table = torch.cat([emb_n, emb_n.new_zeros((1, C))])
    logit_table = torch.cat([logits_q, logits_q.new_zeros((1, logits_q.shape[1]))])
    donor, filled = nearest_donor(view_coords.to(torch.float32), covered, pv_valid)
    wq = torch.full_like(winner, Q)
    w = torch.where(covered, winner, torch.where(filled, winner[donor.long()], wq))
    w = torch.where(pv_valid, w, wq).to(torch.int32)
    return ViewLiftIds(w, embed_table, logit_table)


# geopurify_tpu/models/lift.py:214
def fuse_views(view_feats, view_logits, view_point_ids, view_point_valid,
               num_points: int, top_k: int = 3):
    """Cross-view consensus fusion of dense views ([V, Pv, C] features):
    pointers into the flattened [V*Pv, C] feature buffer."""
    V, Pv, C = view_feats.shape
    ptrs = (torch.arange(V, device=view_feats.device)[:, None] * Pv
            + torch.arange(Pv, device=view_feats.device)[None, :])
    return _fuse_core(view_logits, ptrs, view_feats.reshape(V * Pv, C),
                      view_point_ids, view_point_valid, num_points, top_k)


# geopurify_tpu/models/lift.py:239
def fuse_views_indexed(winner, embed_tables, logit_tables, view_point_ids,
                       view_point_valid, num_points: int, top_k: int = 3):
    """Cross-view consensus fusion over index-valued views: pointers into
    the flattened [V*(Q+1), C] embedding table."""
    V, Pv = winner.shape
    Qe, C = embed_tables.shape[1:]
    n_cls = logit_tables.shape[-1]
    ptrs = torch.arange(V, device=winner.device)[:, None] * Qe + winner.long()
    view_logits = logit_tables.reshape(V * Qe, n_cls).to(torch.float32)[
        ptrs.reshape(-1)].reshape(V, Pv, n_cls)
    return _fuse_core(view_logits, ptrs, embed_tables.reshape(V * Qe, C),
                      view_point_ids, view_point_valid, num_points, top_k)


# geopurify_tpu/models/lift.py:274
def _fuse_core(view_logits, ptrs, table, view_point_ids, view_point_valid,
               num_points: int, top_k: int):
    """Consensus class per point from the summed view logits, then a running
    top-k merge (a loop over views) of (agreement score, table pointer);
    the final feature is the softmax(score)-weighted mix of the k rows.
    Returns (fused [P, C] f32, view_count [P] f32)."""
    ids = torch.where(view_point_valid, view_point_ids.long(), num_points)   # [V, Pv]
    sum_logits, count = consensus_sums(view_logits, ids, view_point_valid, num_points)
    consensus = torch.argmax(sum_logits / torch.clamp(count, min=1.0)[:, None], dim=-1)
    ts, tp = topk_agreement(view_logits, ptrs, ids, view_point_valid, consensus, top_k)
    fused = mix_topk(ts, lambda lo, hi: table[tp[lo:hi]], table.shape[1])
    fused = torch.where(count[:, None] > 0, fused, 0.0)
    return fused, count


def consensus_sums(view_logits, ids, view_point_valid, num_points: int):
    """Per point, the sum of its views' logits [P, n_cls] and its view
    count [P] (f32); ``ids`` [V, Pv] with ``num_points`` on invalid slots."""
    n_cls = view_logits.shape[-1]
    flat = ids.reshape(-1)
    sum_logits = segment_sum(view_logits.reshape(-1, n_cls).to(torch.float32), flat,
                             num_points)
    count = segment_sum(view_point_valid.reshape(-1).to(torch.float32), flat, num_points)
    return sum_logits, count


def topk_agreement(view_logits, ptrs, ids, view_point_valid, consensus, top_k: int):
    """The running top-k merge, view after view, of each point's (agreement
    score with its consensus class, pointer of the view's row): returns
    scores [P, k] (-inf: no candidate) and pointers [P, k] int64, ordered by
    score, ties to the earlier view (``lax.top_k`` over the stable order)."""
    V = view_logits.shape[0]
    P = consensus.shape[0]
    dev = view_logits.device
    ts = torch.full((P, top_k), float("-inf"), device=dev)
    tp = torch.zeros((P, top_k), dtype=torch.int64, device=dev)
    for v in range(V):
        ok = view_point_valid[v]
        rid = profiling.masked(ids[v], ok)                             # unique ids
        agree = profiling.masked(view_logits[v], ok).to(torch.float32).gather(
            1, consensus[rid][:, None])
        cat_s = torch.cat([ts[rid], agree], 1)
        cat_p = torch.cat([tp[rid], profiling.masked(ptrs[v], ok).long()[:, None]], 1)
        new_s, arg = torch.sort(cat_s, dim=1, descending=True, stable=True)
        ts[rid] = new_s[:, :top_k]
        tp[rid] = torch.gather(cat_p, 1, arg[:, :top_k])
    return ts, tp


def mix_topk(scores: torch.Tensor, rows, C: int) -> torch.Tensor:
    """The softmax(score)-weighted mix of each point's k candidates: scores
    [P, k] (-inf: no candidate, weight 0) and ``rows(lo, hi)`` the
    candidates' features [hi - lo, k, C] of points [lo, hi), taken in
    tiles of 2^17 points. Returns [P, C] f32."""
    P = scores.shape[0]
    fin = torch.isfinite(scores)
    w = torch.where(fin, torch.softmax(torch.where(fin, scores, float("-inf")), dim=-1), 0.0)
    w = torch.nan_to_num(w)
    fused = torch.empty((P, C), dtype=torch.float32, device=scores.device)
    tile = 1 << 17
    for lo in range(0, P, tile):
        hi = min(lo + tile, P)
        fused[lo:hi] = torch.bmm(w[lo:hi, None, :], rows(lo, hi).to(torch.float32))[:, 0]
    return fused


# geopurify_tpu/models/lift.py:370
def fill_unseen_points(fused, points, count, point_valid):
    """Global nearest fill for never-seen points."""
    return nearest_fill(fused, points.to(torch.float32), count > 0, point_valid)


# geopurify_tpu/models/lift.py:384
def fill_unseen_points_voxel(fused, count, point_valid, point2voxel,
                             voxel_coords, voxel_valid):
    """Voxel-resolution unseen fill for scenes of P >= 2^19 points: each
    voxel's mean fused feature over its seen points; a valid voxel with no
    seen point takes the mean of its nearest seen voxel; an unseen point
    takes its voxel's (filled) mean. The donor search is the pruned
    ``ops/knn.nearest_fill_grid`` over the integer voxel grid, as in the JAX
    version (:414-420): the nearest seen voxel, the lowest id between seen
    voxels at one distance, the same voxel the exhaustive ``nearest_fill``
    picks."""
    M = voxel_coords.shape[0]
    seen = count > 0
    p2v = torch.where(point_valid, point2voxel.long(), M)
    vox_seen_cnt = segment_sum(seen.to(torch.float32)[:, None], p2v, M)[:, 0]
    vox_seen = vox_seen_cnt > 0
    masked = torch.where(seen[:, None], fused, 0.0)
    vox_feat = segment_sum(masked, p2v, M) / torch.clamp(vox_seen_cnt, min=1.0)[:, None]
    filled_vox = nearest_fill_grid(vox_feat, voxel_coords.to(torch.float32),
                                   vox_seen & voxel_valid, voxel_valid,
                                   num_candidates=4096)
    filled_vox = torch.cat([filled_vox, filled_vox.new_zeros((1, fused.shape[1]))])
    donated = filled_vox[torch.clamp(p2v, max=M)]
    return torch.where(seen[:, None], fused, donated)
