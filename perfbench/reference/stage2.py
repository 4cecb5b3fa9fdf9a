"""Stage 2 of GeoPurify, plain: one scene's per-point open-vocabulary logits.

The steps of the port's ``GeoPurifyPipeline.evaluate_scene`` with logit
space smoothing, written out over the reference's frozen modules:

1. every view through the X-Decoder, ``view_chunk`` views a call, and its
   index-valued lift (``lift.lift_view_ids``);
2. the cross-view consensus fusion (``lift.fuse_views_indexed``) and the
   unseen fill: from the nearest seen point, or at voxel resolution from
   2^19 points on (both exhaustive searches);
3. the voxel scatter-mean of semantic || geometric features and the student
   over the plain neighbour table (eval-mode BatchNorm);
4. the projections of the voxels' semantic features on the class prompts,
   smoothed over the brute-force kNN graph in f32;
5. the points' logits (``logit_scale`` x their voxel's smoothed row) and
   their argmax.

Everything runs in the dtype of the modules it is given (f32 for the
reference; the control lowers their operands).
"""

from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference.lift import (
    ViewLiftIds,
    fill_unseen_points,
    fill_unseen_points_voxel,
    fuse_views_indexed,
    lift_view_ids,
)
from perfbench.reference.pooling import geometry_guided_pooling
from perfbench.reference.segment import segment_mean
from perfbench.reference.sparse_conv import build_neighbor_table


def lift_views(xdecoder, scene: Dict[str, torch.Tensor], text: torch.Tensor,
               logit_scale: float, x_cfg: dict, lo: int, hi: int) -> ViewLiftIds:
    """X-Decoder forward + index-valued lift of views [lo, hi)."""
    P = scene["points"].shape[0]
    images = scene["images"][lo:hi].to(torch.float32)
    out = xdecoder(images, text, logit_scale)
    coords = scene["points"][scene["view_point_ids"][lo:hi].long() % P]
    lifts = [
        lift_view_ids(out["pred_masks"][b], out["mask_embed"][b], out["pred_logits"][b],
                      scene["view_rows"][lo + b], scene["view_cols"][lo + b],
                      scene["view_point_valid"][lo + b], coords[b], text[:-1],
                      logit_scale, tuple(x_cfg["mask_shape"]),
                      mask_threshold=x_cfg["mask_threshold"])
        for b in range(hi - lo)
    ]
    return ViewLiftIds(*(torch.stack(x) for x in zip(*lifts)))


@torch.no_grad()
def evaluate_scene(xdecoder, student, scene: Dict[str, torch.Tensor], text: torch.Tensor,
                   logit_scale: float, program: dict, view_chunk: int = 8
                   ) -> Dict[str, torch.Tensor]:
    """``program``: the configuration file's ``program`` section. Returns
    ``logits`` [P, n_cls], ``pred`` [P] and ``view_count`` [P]."""
    x_cfg, pc = program["xdecoder"], program["pooling"]
    if pc["smooth_space"] != "logit":
        raise ValueError("the reference smooths in logit space only")
    V = scene["images"].shape[0]
    P = scene["points"].shape[0]
    M = scene["voxel_coords"].shape[0]
    n_valid = int(scene["view_valid"].sum())
    parts = [lift_views(xdecoder, scene, text, logit_scale, x_cfg, lo,
                        min(lo + view_chunk, n_valid))
             for lo in range(0, n_valid, view_chunk)]
    winner, emb_t, logit_t = (torch.cat(x) for x in zip(*parts))
    pad = V - n_valid
    if pad:
        Qe, C = emb_t.shape[1:]
        winner = torch.cat([winner, winner.new_zeros((pad, winner.shape[1]))])
        emb_t = torch.cat([emb_t, emb_t.new_zeros((pad, Qe, C))])
        logit_t = torch.cat([logit_t, logit_t.new_zeros((pad, Qe, logit_t.shape[2]))])
    vp_valid = scene["view_point_valid"] & scene["view_valid"][:, None]
    fused, count = fuse_views_indexed(winner, emb_t, logit_t, scene["view_point_ids"],
                                      vp_valid, num_points=P,
                                      top_k=x_cfg["fusion_top_k"])
    if P >= (1 << 19):
        fused = fill_unseen_points_voxel(fused, count, scene["point_valid"],
                                         scene["point2voxel"], scene["voxel_coords"],
                                         scene["voxel_valid"])
    else:
        fused = fill_unseen_points(fused, scene["points"], count, scene["point_valid"])

    p2v = torch.where(scene["point_valid"], scene["point2voxel"].long(), M)
    voxel_sem = segment_mean(fused, p2v, M)
    voxel_geom = segment_mean(scene["geom_feats"].to(torch.float32), p2v, M)
    voxel_in = torch.cat([voxel_sem, voxel_geom], 1)
    nbr = build_neighbor_table(scene["voxel_coords"], scene["voxel_valid"])
    embed = student(voxel_in, nbr, scene["voxel_valid"]).to(torch.float32)
    proj = voxel_in[:, : pc["feature_dim"]] @ text[:-1].to(torch.float32).T
    smoothed = geometry_guided_pooling(embed, proj, scene["voxel_coords"],
                                       scene["voxel_valid"], k=pc["knn_k"],
                                       sharpen=pc["sharpen"],
                                       num_iterations=pc["num_iterations"])
    smoothed = torch.cat([smoothed, smoothed.new_zeros((1, smoothed.shape[1]))])
    pt = smoothed[torch.clamp(p2v, max=M)]
    logits = logit_scale * torch.where(scene["point_valid"][:, None], pt, 0.0)
    return {"logits": logits, "pred": torch.argmax(logits, dim=-1), "view_count": count}
