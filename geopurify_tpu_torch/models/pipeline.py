"""GeoPurify Stage-1 distillation loss and Stage-2 inference.

Port of geopurify_tpu/models/pipeline.py.

Stage 1 (``stage1_loss``): frozen Sonata features per point
(``teacher_point_features``) pick contrastive pairs; the student embeds
the voxels (BatchNorm in train mode) and InfoNCE pulls the anchor towards
its positive, through kernel K2 when ``contrastive.fused_loss`` is set.

Stage 2 (``evaluate_scene``), per scene:
1. per micro-batch of ``view_batch`` views, the X-Decoder forward and the
   index-valued lift (``_view_step``), or with ``xdecoder.lift_backend``
   lseg / ape the registered backend's dense lift (``_view_step_dense``);
2. cross-view top-k consensus fusion and the global unseen-point fill
   (``lift_scene``);
3. voxel scatter-mean of semantic || geometric features and the sparse-conv
   student (``_voxel_embed``);
4. the kNN-96 affinity graph and the smoothing rounds, banded through
   kernel K1 (``_smooth``);
5. classification against the text embeddings, in logit space (smooth the
   [M, n_cls] projections; argmax-exact) or in feature space.

The pipeline holds its modules on one device: ``cuda`` by default, which
raises on a machine without a card; tests pass ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from geopurify_tpu_torch import resolve_device
from geopurify_tpu_torch.config import GeoPurifyConfig, SonataConfig
from geopurify_tpu_torch.data.batch import SceneBatch
from geopurify_tpu_torch.models.lift import (
    ViewLift,
    ViewLiftIds,
    fill_unseen_points,
    fill_unseen_points_voxel,
    fuse_views,
    fuse_views_indexed,
    lift_view_features,
    lift_view_ids,
)
from geopurify_tpu_torch.models.lift_variants import lift_view_dense, lift_view_instance
from geopurify_tpu_torch.models.sonata import SonataTeacher
from geopurify_tpu_torch.models.student import AffinityPredictor
from geopurify_tpu_torch.models.xdecoder import XDecoderSegModel
from geopurify_tpu_torch.ops.contrastive import (
    ContrastivePairs,
    info_nce_loss,
    sample_contrastive_pairs_hybrid,
)
from geopurify_tpu_torch.ops.infonce import info_nce_loss_fused
from geopurify_tpu_torch.ops.pooling import geometry_guided_pooling
from geopurify_tpu_torch.ops.segment import segment_mean
from geopurify_tpu_torch.ops.sparse_conv import build_neighbor_table, build_zstack_table
from geopurify_tpu_torch.utils import profiling


# geopurify_tpu/models/pipeline.py:58
class SceneFeatures(NamedTuple):
    features: torch.Tensor     # [P, feature_dim] fused (and filled) features, f32
    view_count: torch.Tensor   # [P] number of views that saw each point


# geopurify_tpu/models/pipeline.py:63
class GeoPurifyPipeline:
    """Frozen X-Decoder and Sonata teachers + student + smoothing, on one
    device."""

    def __init__(self, cfg: GeoPurifyConfig, text_embeddings: torch.Tensor,
                 logit_scale: float, teacher_state: Optional[dict] = None,
                 student_state: Optional[dict] = None, device="cuda",
                 sonata_state: Optional[dict] = None, lift_backend_fn=None):
        """``text_embeddings`` [n_cls + 1, dim] (background last, L2-normed);
        ``teacher_state`` / ``student_state`` / ``sonata_state``: state
        dicts of the port's modules (``utils.from_jax`` builds them from JAX
        variables). The X-Decoder and the student keep their zero weights
        without one; the Sonata teacher is built only from its state (Stage 2
        never runs it), and ``teacher_point_features`` raises without it.
        ``lift_backend_fn``: the lseg / ape callable of
        ``cfg.xdecoder.lift_backend`` (``models/lift_backends.py``)."""
        self.cfg = cfg
        self.lift_backend_fn = lift_backend_fn
        self.device = resolve_device(device)
        # a captioning checkpoint's caption slots (predictor.pos_embed_caping)
        cap = teacher_state.get("predictor.pos_embed_caping") if teacher_state else None
        self.xdecoder = XDecoderSegModel(cfg.xdecoder, caption_len=0 if cap is None
                                         else cap.shape[0]).eval()
        if teacher_state is not None:
            self.xdecoder.load_state_dict(teacher_state)
        s = cfg.student
        self.student = AffinityPredictor(s.input_dim, s.hidden_dim, s.embed_dim,
                                         s.num_res_blocks, s.compute_dtype,
                                         s.bn_momentum).eval()
        if student_state is not None:
            self.student.load_state_dict(student_state)
        self.sonata = None
        if sonata_state is not None:
            self.sonata = build_sonata(cfg.sonata)
            self.sonata.load_state_dict(sonata_state)
            self.sonata.to(self.device)
        for m in (self.xdecoder, self.student):
            m.to(self.device)
        self.text_embeddings = torch.as_tensor(text_embeddings, dtype=torch.float32,
                                               device=self.device)
        self.logit_scale = float(logit_scale)

    # ------------------------------------------------------------------
    # geopurify_tpu/models/pipeline.py:131
    def _view_step(self, batch: SceneBatch, lo: int) -> ViewLiftIds:
        """X-Decoder forward + index-valued lift of views [lo, lo + B)."""
        B = max(1, min(self.cfg.xdecoder.view_batch, batch.images.shape[0]))
        P = batch.points.shape[0]
        sl = slice(lo, lo + B)
        images = batch.images[sl].to(torch.float32)
        rows, cols = batch.view_rows[sl], batch.view_cols[sl]
        pv_valid = batch.view_point_valid[sl]
        view_coords = batch.points[batch.view_point_ids[sl].long() % P]
        out = self.xdecoder(images, self.text_embeddings, self.logit_scale)
        text_no_bg = self.text_embeddings[:-1]
        with profiling.span("lift"):
            lifts = [
                lift_view_ids(
                    out["pred_masks"][b], out["mask_embed"][b], out["pred_logits"][b],
                    rows[b], cols[b], pv_valid[b], view_coords[b], text_no_bg,
                    self.logit_scale, tuple(self.cfg.xdecoder.mask_shape),
                    mask_threshold=self.cfg.xdecoder.mask_threshold)
                for b in range(images.shape[0])
            ]
            return ViewLiftIds(*(torch.stack(x) for x in zip(*lifts)))

    # geopurify_tpu/models/pipeline.py:150-182
    def _view_step_dense(self, batch: SceneBatch, lo: int, B: Optional[int] = None
                         ) -> ViewLift:
        """Dense lift of views [lo, lo + B) (``B`` defaults to the view
        batch): the X-Decoder through ``lift_view_features``, or the lseg
        (dense pixel features) / ape (instance masks) backend callable
        through ``models/lift_variants.py``, one view at a time."""
        if B is None:
            B = max(1, min(self.cfg.xdecoder.view_batch, batch.images.shape[0]))
        P = batch.points.shape[0]
        sl = slice(lo, lo + B)
        images = batch.images[sl].to(torch.float32)
        rows, cols = batch.view_rows[sl], batch.view_cols[sl]
        pv_valid = batch.view_point_valid[sl]
        view_coords = batch.points[batch.view_point_ids[sl].long() % P]
        text_no_bg = self.text_embeddings[:-1]
        x = self.cfg.xdecoder
        if x.lift_backend == "xdecoder":
            out = self.xdecoder(images, self.text_embeddings, self.logit_scale)
            lifts = [lift_view_features(
                out["pred_masks"][b], out["mask_embed"][b], out["pred_logits"][b],
                rows[b], cols[b], pv_valid[b], view_coords[b], text_no_bg,
                self.logit_scale, tuple(x.mask_shape), mask_threshold=x.mask_threshold)
                for b in range(images.shape[0])]
        elif x.lift_backend == "lseg":
            lifts = [lift_view_dense(self.lift_backend_fn(images[b]), rows[b], cols[b],
                                     pv_valid[b], view_coords[b], text_no_bg,
                                     self.logit_scale)
                     for b in range(images.shape[0])]
        else:  # ape
            lifts = [lift_view_instance(*self.lift_backend_fn(images[b]), rows[b], cols[b],
                                        pv_valid[b], view_coords[b], text_no_bg,
                                        self.logit_scale, mask_threshold=x.mask_threshold)
                     for b in range(images.shape[0])]
        return ViewLift(*(torch.stack(t) for t in zip(*lifts)))

    # geopurify_tpu/models/pipeline.py:210
    def lift_scene(self, batch: SceneBatch, n_valid: Optional[int] = None,
                   stage_seconds: Optional[dict] = None) -> SceneFeatures:
        """Lift every valid view (packed first) in micro-batches, fuse, fill.
        Returns ``SceneFeatures(features [P, feature_dim] f32, view_count
        [P])``. The
        X-Decoder lifts index-valued views; the lseg / ape backends dense
        ones (stored in bf16 from 2^28 view-feature values on, as in JAX)."""
        V = batch.images.shape[0]
        Pv = batch.view_point_ids.shape[1]
        C = self.cfg.pooling.feature_dim
        n_cls = len(self.cfg.data.all_label)
        P = batch.points.shape[0]
        B = max(1, min(self.cfg.xdecoder.view_batch, V))
        dev = batch.points.device
        indexed = self.cfg.xdecoder.lift_backend == "xdecoder"
        vdtype = torch.bfloat16 if V * Pv * C >= (1 << 28) else torch.float32
        if n_valid is None:
            n_valid = int(profiling.host_read(batch.view_valid.sum()))
        with profiling.stage_span("views", stage_seconds, dev):
            bufs = ([], [], []) if indexed else ([], [])
            for lo in range(0, n_valid, B):
                start = min(lo, max(V - B, 0))     # shift the tail batch back, no wrap
                lift = (self._view_step(batch, start) if indexed
                        else self._view_step_dense(batch, start))
                keep = min(B, n_valid - lo)
                sl = slice(lo - start, lo - start + keep)
                for buf, x in zip(bufs, lift):
                    buf.append(x[sl])
        with profiling.stage_span("fuse_fill", stage_seconds, dev):
            pad = V - n_valid
            vp_valid = batch.view_point_valid & batch.view_valid[:, None]
            top_k = self.cfg.xdecoder.fusion_top_k
            if indexed:
                if n_valid == 0:
                    winner = torch.zeros((V, Pv), dtype=torch.int32, device=dev)
                    emb_t = torch.zeros((V, 2, C), device=dev)
                    logit_t = torch.zeros((V, 2, n_cls), device=dev)
                else:
                    winner, emb_t, logit_t = (torch.cat(b) for b in bufs)
                    if pad:
                        Qe = emb_t.shape[1]
                        winner = torch.cat([winner, winner.new_zeros((pad, Pv))])
                        emb_t = torch.cat([emb_t, emb_t.new_zeros((pad, Qe, C))])
                        logit_t = torch.cat([logit_t, logit_t.new_zeros((pad, Qe, n_cls))])
                fused, count = fuse_views_indexed(
                    winner, emb_t, logit_t, batch.view_point_ids, vp_valid,
                    num_points=P, top_k=top_k)
            else:
                feats = torch.zeros((V, Pv, C), dtype=vdtype, device=dev)
                logits = torch.zeros((V, Pv, n_cls), device=dev)
                if n_valid:
                    feats[:n_valid] = torch.cat(bufs[0]).to(vdtype)
                    logits[:n_valid] = torch.cat(bufs[1])
                fused, count = fuse_views(feats, logits, batch.view_point_ids, vp_valid,
                                          num_points=P, top_k=top_k)
            fused = self.fill_unseen(fused, count, batch)
        return SceneFeatures(fused, count)

    # geopurify_tpu/models/pipeline.py:300-321
    def fill_unseen(self, fused, count, batch: SceneBatch) -> torch.Tensor:
        """The never-seen points' features: from the nearest seen point, or
        at voxel resolution for scenes of P >= 2^19 points."""
        if batch.points.shape[0] >= (1 << 19):
            return fill_unseen_points_voxel(
                fused, count, batch.point_valid, batch.point2voxel,
                batch.voxel_coords, batch.voxel_valid)
        return fill_unseen_points(fused, batch.points, count, batch.point_valid)

    # geopurify_tpu/models/pipeline.py:320
    def _voxel_embed(self, f2d: torch.Tensor, batch: SceneBatch):
        """Voxel scatter-mean (semantic || geometric) + student forward;
        from ``student.zstack_min_voxels`` voxels on, the student's 3^3
        convs run z-stacked (``ops.sparse_conv.ZStackTable``, residual
        budget max(16384, M // 16)): the same convolution."""
        M = batch.voxel_coords.shape[0]
        with profiling.span("student"):
            p2v = torch.where(batch.point_valid, batch.point2voxel.long(), M)
            voxel_sem = segment_mean(f2d, p2v, M)
            voxel_geom = segment_mean(batch.geom_feats.to(torch.float32), p2v, M)
            voxel_in = torch.cat([voxel_sem, voxel_geom], 1)
            nbr = build_neighbor_table(batch.voxel_coords, batch.voxel_valid)
            if M >= self.cfg.student.zstack_min_voxels:
                nbr = build_zstack_table(batch.voxel_coords, batch.voxel_valid, nbr,
                                         res_budget=max(16384, M // 16))
            embed = self.student(voxel_in, nbr, batch.voxel_valid)
        return voxel_in, embed, p2v

    # geopurify_tpu/models/pipeline.py:343
    def _smooth(self, embed, feats, batch: SceneBatch):
        pc = self.cfg.pooling
        return geometry_guided_pooling(
            embed, feats, batch.voxel_coords, batch.voxel_valid,
            k=pc.knn_k, sharpen=pc.sharpen, num_iterations=pc.num_iterations,
            spmm_mode=pc.spmm_mode, band=pc.band, max_residual=pc.max_residual,
            knn_mode=pc.knn_mode, knn_radius=pc.knn_radius,
            knn_candidates=pc.knn_candidates)

    # geopurify_tpu/models/pipeline.py:354
    def _pool_scene(self, f2d, batch: SceneBatch):
        M = batch.voxel_coords.shape[0]
        voxel_in, embed, p2v = self._voxel_embed(f2d, batch)
        refined, band_overflow = self._smooth(
            embed, voxel_in[:, : self.cfg.pooling.feature_dim], batch)
        refined = torch.cat([refined, refined.new_zeros((1, refined.shape[1]))])
        out = refined[torch.clamp(p2v, max=M)]
        return torch.where(batch.point_valid[:, None], out, 0.0), band_overflow

    # geopurify_tpu/models/pipeline.py:471
    def _classify(self, refined):
        with profiling.span("classify"):
            f = refined / torch.clamp(torch.linalg.norm(refined, dim=-1, keepdim=True),
                                      min=1e-12)
            logits = self.logit_scale * f @ self.text_embeddings[:-1].T
            return logits, torch.argmax(logits, dim=-1)

    # geopurify_tpu/models/pipeline.py:420
    def _pool_classify(self, f2d, batch: SceneBatch, want_features: bool = False):
        pc = self.cfg.pooling
        if pc.smooth_space == "logit":
            # smooth the [M, n_cls] projections: the rounds are linear and the
            # per-row normalization cannot move the argmax
            M = batch.voxel_coords.shape[0]
            voxel_in, embed, p2v = self._voxel_embed(f2d, batch)
            with profiling.span("classify"):
                proj = voxel_in[:, : pc.feature_dim] @ self.text_embeddings[:-1].T
            smoothed, band_overflow = self._smooth(embed, proj, batch)
            with profiling.span("classify"):
                smoothed = torch.cat([smoothed, smoothed.new_zeros((1, smoothed.shape[1]))])
                pt = smoothed[torch.clamp(p2v, max=M)]
                logits = self.logit_scale * torch.where(batch.point_valid[:, None], pt, 0.0)
                pred = torch.argmax(logits, dim=-1)
            refined = None
            if want_features:
                vi = voxel_in[:, : pc.feature_dim]
                vi = torch.cat([vi, vi.new_zeros((1, vi.shape[1]))])
                refined = torch.where(batch.point_valid[:, None],
                                      vi[torch.clamp(p2v, max=M)], 0.0)
            return refined, band_overflow, logits, pred
        refined, band_overflow = self._pool_scene(f2d, batch)
        logits, pred = self._classify(refined)
        return (refined if want_features else None), band_overflow, logits, pred

    # geopurify_tpu/models/pipeline.py:376
    @torch.inference_mode()
    def evaluate_scene(self, batch: SceneBatch, n_valid_views: Optional[int] = None,
                       want_features: bool = False, profile: bool = False
                       ) -> Dict[str, object]:
        """Full Stage-2: per-point open-vocab logits + predictions.

        Returns ``scene_features`` (None unless ``want_features``),
        ``logits`` [P, n_cls], ``pred`` [P], ``view_count`` [P] and
        ``band_overflow`` (int: > 0 means the banded operator overflowed and
        the exact gather path ran). ``profile`` records the scene's spans
        (``utils.profiling``: the root ``scene`` and its parts), synchronizes
        the device at the stage boundaries and adds ``stage_seconds`` (views,
        fuse_fill, pool_classify: each stage's host seconds)."""
        stages = {} if profile else None
        record = profiling.recording(self.device) if profile else contextlib.nullcontext()
        with record, profiling.span("scene", item=True):
            f2d, view_count = self.lift_scene(batch, n_valid=n_valid_views,
                                              stage_seconds=stages)
            with profiling.stage_span("pool_classify", stages, f2d.device):
                refined, band_overflow, logits, pred = self._pool_classify(
                    f2d, batch, want_features=want_features)
        out = {"scene_features": refined, "logits": logits, "pred": pred,
               "view_count": view_count, "band_overflow": band_overflow}
        if profile:
            out["stage_seconds"] = stages
        return out

    # ------------------------------------------------------------------
    # Stage 1: distillation loss
    # ------------------------------------------------------------------

    # geopurify_tpu/models/pipeline.py:481-497
    @torch.inference_mode()
    def teacher_point_features(self, batch: SceneBatch) -> torch.Tensor:
        """Frozen Sonata features per point, [P, out_channels] f32."""
        if self.sonata is None:
            raise ValueError("No sonata params")
        M = batch.voxel_coords.shape[0]
        return self.sonata(
            batch.geom_feats, batch.voxel_coords, batch.voxel_valid,
            torch.where(batch.point_valid, batch.point2voxel, M), batch.point_valid)

    # geopurify_tpu/models/pipeline.py:499
    def stage1_loss(self, generator: Optional[torch.Generator], batch: SceneBatch,
                    f2d: torch.Tensor, f_teacher: torch.Tensor, train: bool = True,
                    pairs: Optional[ContrastivePairs] = None, group=None
                    ) -> Tuple[torch.Tensor, ContrastivePairs]:
        """InfoNCE distillation loss of the student; returns (loss, pairs).
        ``generator`` draws the anchors unless ``pairs`` is given. With
        ``train`` the student's BatchNorm uses batch moments and updates its
        running statistics in place; ``group`` sums its moments over that
        process group's ranks (SyncBN). K2 (``info_nce_loss_fused``) runs when
        ``contrastive.fused_loss`` is set and ``num_anchors`` divides by
        min(128, A) and min(64, A): its kernels on a CUDA tensor, its plain
        versions on a CPU one."""
        cc = self.cfg.contrastive
        M = batch.voxel_coords.shape[0]
        if pairs is None:
            with torch.no_grad():
                pairs = sample_contrastive_pairs_hybrid(
                    generator, f_teacher, batch.point_valid, coords=batch.points,
                    num_anchors=cc.num_anchors, num_macro=cc.num_macro_negatives,
                    num_micro=cc.num_micro_negatives, spatial_k=cc.spatial_knn_k,
                    spatial_method=cc.spatial_method,
                    spatial_radius=cc.spatial_radius)
        with profiling.span("forward"):
            p2v = torch.where(batch.point_valid, batch.point2voxel.long(), M)
            voxel_sem = segment_mean(f2d.to(torch.float32), p2v, M)
            voxel_geom = segment_mean(batch.geom_feats.to(torch.float32), p2v, M)
            voxel_in = torch.cat([voxel_sem, voxel_geom], 1)
            nbr = build_neighbor_table(batch.voxel_coords, batch.voxel_valid)
            embed = self.student(voxel_in, nbr, batch.voxel_valid, train=train, group=group)
            embed_pad = torch.cat([embed, embed.new_zeros((1, embed.shape[1]))])
            p2v_c = torch.clamp(p2v, max=M)

            def sample_embed(idx):
                return embed_pad[p2v_c[idx.long()]]

            # f32 for both losses: the K2 kernels take f32 only, as the TPU
            # kernels cast their blocks (a bf16 student's gradient casts back)
            a = sample_embed(pairs.anchor_idx).float()
            p = sample_embed(pairs.positive_idx).float()
            n = sample_embed(pairs.negative_idx.reshape(-1)).reshape(
                cc.num_anchors, cc.num_negatives, -1).float()
        A = cc.num_anchors
        with profiling.span("loss"):
            if cc.fused_loss and A % min(128, A) == 0 and A % min(64, A) == 0:
                loss = info_nce_loss_fused(a, p, n, pairs.anchor_valid, cc.temperature)
            else:
                loss = info_nce_loss(a, p, n, pairs.anchor_valid, cc.temperature)
        return loss, pairs


def build_sonata(sc: SonataConfig) -> SonataTeacher:
    """The frozen Sonata teacher of ``cfg.sonata``, on the CPU, in eval mode."""
    return SonataTeacher(
        in_channels=sc.in_channels, enc_depths=tuple(sc.enc_depths),
        enc_channels=tuple(sc.enc_channels), enc_num_head=tuple(sc.enc_num_head),
        enc_patch_size=tuple(sc.enc_patch_size), upcast_levels=sc.upcast_levels,
        stem_kernel=sc.stem_kernel, pool_reduce=sc.pool_reduce,
        aux_norm_affine_only=(sc.norm == "bn_folded"),
        dtype=torch.bfloat16 if sc.dtype == "bfloat16" else torch.float32).eval()
