"""SEEM interactive segmentation heads and the click-refinement host loop.

Port of geopurify_tpu/models/seem.py. The three decoders share the
X-Decoder trunk (learned queries, a 3-level memory with level embeddings
and sine PE, ``dec_layers`` rounds of masked cross-attention -> grouped
self-attention -> FFN, the class and mask prediction heads) and differ in
their query and token groups:

- ``SEEMHead`` (v0): grounding and spatial query sets that start as copies
  of the object queries, learned spatial memories fed by ``prev_mask``;
- ``SEEMHeadV1``: multi-mask prompts, object queries sampled into
  ``sample_size`` spatial queries a mask (the draws are inputs), per-mask
  block-diagonal self-attention, per-layer channel-matched memories;
- ``SEEMHeadDemo``: the object queries alone cross-attend, composed with up
  to four token groups (spatial, grounding, audio, visual).

Every round's cross-attention mask is a group's own predicted mask resized
bilinearly without antialiasing (``layers.resize_bilinear_torch``),
thresholded at ``sigmoid < 0.5`` (True = blocked), with all-blocked rows
unmasked, in that order. Prompt points are sampled with
``align_corners=True`` (the reference's ``point_sample``: pixel = p *
(size - 1)). Unlike Flax, which creates the spatial parameters only for
the prompt kinds passed at ``.init``, every parameter exists from
construction; ``utils.from_jax.seem_from_jax`` names a group the JAX tree
lacks.

The host loop (``sample_mask_points``, ``prepare_next_spatial_mask``,
``points_from_masks``, ``interactive_refine``) is numpy, a copy of the JAX
package's, so that a seeded run makes the same draws in both packages.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from geopurify_tpu_torch.models.layers import (
    CrossAttentionLayer,
    FFNLayer,
    LayerNorm,
    MLPHead,
    SelfAttentionLayer,
    position_embedding_sine,
    resize_bilinear_torch,
)


# geopurify_tpu/models/seem.py:47
def sample_mask_points(mask: np.ndarray, budget: int, rng: np.random.Generator
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Click / mask prompt -> up to ``budget`` normalized (y, x) points and
    their valid mask (rand_sample over mask.nonzero()). Host-side."""
    ys, xs = np.nonzero(mask)
    H, W = mask.shape
    n = len(ys)
    pts = np.zeros((budget, 2), np.float32)
    valid = np.zeros(budget, bool)
    if n:
        take = min(n, budget)
        sel = rng.choice(n, take, replace=False) if n > budget else np.arange(n)
        pts[:take, 0] = ys[sel] / H
        pts[:take, 1] = xs[sel] / W
        valid[:take] = True
    return pts, valid


def point_sample(fmap: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of the NHWC ``fmap`` [B, h, w, C] at normalized (y,
    x) points ``pts`` [B, S, 2] with align_corners=True (pixel = p * (size -
    1), zero outside), f32 [B, S, C]. JAX: seem.py:171-173."""
    grid = torch.stack([2 * pts[..., 1] - 1, 2 * pts[..., 0] - 1], -1).to(torch.float32)
    out = F.grid_sample(fmap.to(torch.float32).permute(0, 3, 1, 2), grid[:, None],
                        mode="bilinear", padding_mode="zeros", align_corners=True)
    return out[:, :, 0].transpose(1, 2)


def _blocked(masks: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Next-round cross-attention mask of [B, N, H, W] mask logits: resized
    to ``size`` (bilinear, no antialias), True where sigmoid < 0.5,
    flattened to [B, N, h*w]."""
    am = resize_bilinear_torch(masks.permute(0, 2, 3, 1), size).permute(0, 3, 1, 2)
    return (torch.sigmoid(am) < 0.5).reshape(masks.shape[0], masks.shape[1], -1)


def _unblock_full_rows(am: torch.Tensor) -> torch.Tensor:
    """Rows blocked everywhere attend everywhere; [B, 1, N, hw]."""
    return (am & ~am.all(-1, keepdim=True))[:, None]


class _SEEMTrunk(nn.Module):
    """Parameters and helpers the three decoders share. Names follow the
    Flax trees (``utils.from_jax.seem_from_jax``)."""

    def __init__(self, hidden_dim: int, dim_proj: int, num_queries: int, nheads: int,
                 dim_feedforward: int, dec_layers: int, mask_dim: int,
                 max_spatial_tokens: int, num_levels: int, dtype=torch.float32):
        super().__init__()
        C = hidden_dim
        self.hidden_dim, self.num_queries, self.dec_layers = C, num_queries, dec_layers
        self.max_spatial_tokens, self.dtype = max_spatial_tokens, dtype
        self.level_embed = nn.Parameter(torch.zeros(num_levels, C))
        self.query_feat = nn.Parameter(torch.zeros(num_queries, C))
        self.query_embed = nn.Parameter(torch.zeros(num_queries, C))
        self.class_embed = nn.Parameter(torch.zeros(C, dim_proj))
        self.mask_embed = MLPHead(C, C, mask_dim, 3, dtype=dtype)
        self.decoder_norm = LayerNorm(C)
        self.pn_indicator = nn.Parameter(torch.zeros(2, C))
        for i in range(num_levels):
            self.register_parameter(f"mask_spatial_embed{i}", nn.Parameter(torch.zeros(C, C)))
        for i in range(dec_layers):
            self.add_module(f"cross_attn{i}", CrossAttentionLayer(C, nheads, dtype))
            self.add_module(f"self_attn{i}", SelfAttentionLayer(C, nheads, dtype))
            self.add_module(f"ffn{i}", FFNLayer(C, dim_feedforward, dtype))

    def _memory(self, multi_scale: Sequence[torch.Tensor]):
        """Flattened level maps + level embedding, their sine PE, sizes."""
        C, dt = self.hidden_dim, self.dtype
        srcs, poss, sizes = [], [], []
        for i, x in enumerate(multi_scale):
            b, h, w, c = x.shape
            sizes.append((h, w))
            pe = position_embedding_sine(h, w, C // 2, dtype=dt, device=x.device)
            poss.append(pe[None].expand(b, h, w, C).reshape(b, h * w, C))
            srcs.append(x.reshape(b, h * w, c) + self.level_embed[i].to(dt)[None, None])
        return srcs, poss, sizes

    def _spatial_tokens(self, srcs, sizes, pts, valid, posneg) -> List[torch.Tensor]:
        """Per level: the projected level map sampled at the prompt points,
        plus the +-1 indicator row; zero in invalid slots."""
        B, C = pts.shape[0], self.hidden_dim
        tag = torch.where((posneg > 0)[..., None], self.pn_indicator[0], self.pn_indicator[1])
        toks = []
        for i, (h, w) in enumerate(sizes):
            proj = getattr(self, f"mask_spatial_embed{i}")
            feat = srcs[i].to(torch.float32).reshape(B, h, w, C) @ proj
            tok = point_sample(feat, pts)
            toks.append(torch.where(valid[..., None], tok + tag, 0.0).to(self.dtype))
        return toks

    def _heads(self, X, mf, text_t, logit_scale):
        """(class logits, mask logits [B, N, H, W], mask embeddings, class
        embeddings) of the query rows ``X``."""
        dec = self.decoder_norm(X)                                  # f32
        cls_emb = dec @ self.class_embed
        v = cls_emb / (torch.linalg.norm(cls_emb, dim=-1, keepdim=True) + 1e-7)
        outputs_class = logit_scale * torch.einsum("bqd,nd->bqn", v, text_t)
        m_emb = self.mask_embed(dec.to(self.dtype)).to(torch.float32)
        masks = torch.einsum("blc,bhwc->blhw", m_emb, mf)
        return outputs_class, masks, m_emb, cls_emb

    def _layer(self, i: int, level: int, X, X_pos, srcs, poss, attn_mask, NQ: int,
               tokens, tokens_pos, self_mask):
        """Round ``i``: cross-attention of the rows ``X`` (NQ query rows,
        then any memories), then self-attention and FFN over the query
        rows, the token groups and the memories, in that order."""
        X = getattr(self, f"cross_attn{i}")(X, srcs[level], memory_mask=attn_mask,
                                            pos=poss[level], query_pos=X_pos)
        Y = torch.cat([X[:, :NQ], *tokens, X[:, NQ:]], 1)
        Y_pos = torch.cat([X_pos[:, :NQ], *tokens_pos, X_pos[:, NQ:]], 1)
        Y = getattr(self, f"self_attn{i}")(Y, query_pos=Y_pos, tgt_mask=self_mask)
        return getattr(self, f"ffn{i}")(Y)


def _prompt_means(mf_at: torch.Tensor, valid: torch.Tensor, posneg: torch.Tensor):
    """Mean of the sampled mask features over the positive and the negative
    points, [B, D] each (0 for an empty set)."""
    out = []
    for sign in (1, -1):
        wgt = (valid & (posneg * sign > 0)).to(torch.float32)
        out.append(torch.einsum("bs,bsd->bd", wgt, mf_at)
                   / wgt.sum(1, keepdim=True).clamp_min(1.0))
    return out


def _block_mask(NY: int, allowed) -> np.ndarray:
    """[NY, NY] bool, True = blocked, but for the (rows, cols) slices in
    ``allowed``."""
    base = np.ones((NY, NY), bool)
    for rows, cols in allowed:
        base[rows, cols] = False
    return base


# geopurify_tpu/models/seem.py:66
class SEEMHead(_SEEMTrunk):
    """SEEM v0 decoder. Cross-attention rows: [object Q | grounding Q? |
    spatial Q? | memories M?] (grounding and spatial start as copies of the
    object queries; memories join with ``prev_mask``). Self-attention
    sequence: those query sets, then grounding tokens, spatial tokens, then
    the memories. Object queries see only each other; grounding queries
    their set and the grounding tokens (both ways); spatial queries their
    set, the spatial tokens and the memories; each token group itself;
    memories themselves. Padded prompt slots are blocked as keys. The
    memory rows' cross-attention mask comes from ``prev_mask``.

    Outputs: pred_logits, pred_masks, pred_captions; with grounding
    pred_gmasks, pred_gtexts; with spatial prompts pred_smasks,
    pred_smaskembs, pred_pspatials, pred_nspatials and ``prev_mask``, the
    spatial query mask whose embedding best matches pred_pspatials."""

    def __init__(self, hidden_dim: int = 512, dim_proj: int = 512, num_queries: int = 101,
                 nheads: int = 8, dim_feedforward: int = 2048, dec_layers: int = 9,
                 mask_dim: int = 512, max_spatial_tokens: int = 512,
                 num_spatial_memories: int = 32, max_grounding_tokens: int = 8,
                 num_levels: int = 3, dtype=torch.float32):
        super().__init__(hidden_dim, dim_proj, num_queries, nheads, dim_feedforward, dec_layers,
                         mask_dim, max_spatial_tokens, num_levels, dtype)
        self.num_spatial_memories = num_spatial_memories
        self.max_grounding_tokens = max_grounding_tokens
        self.spatial_embed = nn.Parameter(torch.zeros(num_spatial_memories, hidden_dim))
        self.spatial_featured = nn.Parameter(torch.zeros(num_spatial_memories, hidden_dim))

    def forward(self, multi_scale: List[torch.Tensor], mask_features: torch.Tensor,
                text_embeddings: torch.Tensor, logit_scale,
                spatial_points: Optional[torch.Tensor] = None,    # [B, S, 2] (y/H, x/W)
                spatial_valid: Optional[torch.Tensor] = None,     # [B, S] bool
                spatial_posneg: Optional[torch.Tensor] = None,    # [B, S] +1 / -1
                grounding_tokens: Optional[torch.Tensor] = None,  # [B, G, C]
                grounding_valid: Optional[torch.Tensor] = None,   # [B, G] bool
                prev_mask: Optional[torch.Tensor] = None,         # [B, 1, H4, W4] logits
                ) -> Dict[str, torch.Tensor]:
        dt, dev = self.dtype, mask_features.device
        B = mask_features.shape[0]
        Q, C = self.num_queries, self.hidden_dim
        S, G, M = self.max_spatial_tokens, self.max_grounding_tokens, self.num_spatial_memories
        has_spatial = spatial_points is not None
        has_grounding = grounding_tokens is not None
        if has_grounding and grounding_valid is None:
            raise ValueError("grounding_tokens needs grounding_valid")
        has_memory = has_spatial and prev_mask is not None
        srcs, poss, sizes = self._memory(multi_scale)
        mf = mask_features.to(torch.float32)
        text_t = text_embeddings.to(torch.float32)

        if has_spatial:
            pts = spatial_points.to(torch.float32)
            sq_pos, sq_neg = _prompt_means(point_sample(mf, pts), spatial_valid, spatial_posneg)
            tok_spa_levels = self._spatial_tokens(srcs, sizes, pts, spatial_valid,
                                                  spatial_posneg)

        n_grd_q = Q if has_grounding else 0
        n_spa_q = Q if has_spatial else 0
        n_mem = M if has_memory else 0
        NQ = Q + n_grd_q + n_spa_q
        o_grd, o_spa, o_mem = Q, Q + n_grd_q, NQ
        obj0 = self.query_feat[None].expand(B, Q, C)
        obj0_pe = self.query_embed[None].expand(B, Q, C)
        n_sets = 1 + has_grounding + has_spatial
        x_parts, xp_parts = [obj0] * n_sets, [obj0_pe] * n_sets
        if has_memory:
            x_parts.append(self.spatial_featured[None].expand(B, M, C))
            xp_parts.append(self.spatial_embed[None].expand(B, M, C))
        X = torch.cat(x_parts, 1).to(dt)
        X_pos = torch.cat(xp_parts, 1).to(dt)

        n_tok_grd = G if has_grounding else 0
        n_tok_spa = S if has_spatial else 0
        y_grd_t = NQ
        y_spa_t = y_grd_t + n_tok_grd
        y_mem = y_spa_t + n_tok_spa
        NY = y_mem + n_mem
        q_o, q_g, q_s = slice(0, Q), slice(o_grd, o_grd + Q), slice(o_spa, o_spa + Q)
        t_g, t_s = slice(y_grd_t, y_grd_t + G), slice(y_spa_t, y_spa_t + S)
        m_y = slice(y_mem, y_mem + M)
        allowed = [(q_o, q_o)]
        if has_grounding:
            allowed += [(q_g, q_g), (q_g, t_g), (t_g, q_g), (t_g, t_g)]
        if has_spatial:
            allowed += [(q_s, q_s), (q_s, t_s), (t_s, t_s)]
        if has_memory:
            allowed += [(q_s, m_y), (m_y, m_y)]
        base = torch.from_numpy(_block_mask(NY, allowed)).to(dev)[None, None]
        key_valid = [torch.ones((B, NQ), dtype=torch.bool, device=dev)]
        if has_grounding:
            key_valid.append(grounding_valid.to(dev, torch.bool))
        if has_spatial:
            key_valid.append(spatial_valid.to(dev, torch.bool))
        if has_memory:
            key_valid.append(torch.ones((B, M), dtype=torch.bool, device=dev))
        self_mask = base | ~torch.cat(key_valid, 1)[:, None, None, :]
        pm = prev_mask.to(torch.float32) if has_memory else None

        def heads(Xo, size):
            oc, masks, m_emb, cls_emb = self._heads(Xo, mf, text_t, logit_scale)
            am = _blocked(masks, size)
            if has_memory:
                am[:, o_mem:o_mem + M] = _blocked(pm, size).expand(B, M, -1)
            return oc, masks, m_emb, cls_emb, _unblock_full_rows(am)

        oc, masks, m_emb, cls_emb, attn_mask = heads(X, sizes[0])
        tok_grd = grounding_tokens.to(dt) if has_grounding else None
        tok_grd_pos = tok_grd.detach() if has_grounding else None
        for i in range(self.dec_layers):
            level = i % len(multi_scale)
            toks, toks_pos = [], []
            if has_grounding:
                toks.append(tok_grd)
                toks_pos.append(tok_grd_pos)
            if has_spatial:
                toks.append(tok_spa_levels[level])
                toks_pos.append(tok_spa_levels[level].detach())
            Y = self._layer(i, level, X, X_pos, srcs, poss, attn_mask, NQ, toks, toks_pos,
                            self_mask)
            # grounding tokens persist across rounds, spatial tokens are
            # refreshed from their level
            X = torch.cat([Y[:, :NQ], Y[:, y_mem:]], 1)
            if has_grounding:
                tok_grd = Y[:, t_g]
            oc, masks, m_emb, cls_emb, attn_mask = heads(X, sizes[(i + 1) % len(multi_scale)])

        out = {"pred_logits": oc[:, q_o], "pred_masks": masks[:, q_o],
               "pred_captions": cls_emb[:, q_o]}
        if has_grounding:
            out["pred_gmasks"] = masks[:, q_g]
            out["pred_gtexts"] = cls_emb[:, q_g]
        if has_spatial:
            out["pred_smasks"] = masks[:, q_s]
            out["pred_smaskembs"] = m_emb[:, q_s]
            out["pred_pspatials"] = sq_pos[:, None]
            out["pred_nspatials"] = sq_neg[:, None]
            best = torch.einsum("bqd,bd->bq", out["pred_smaskembs"], sq_pos).argmax(1)
            out["prev_mask"] = out["pred_smasks"][torch.arange(B, device=dev), best][:, None]
        return out


# geopurify_tpu/models/seem.py:383
class SEEMHeadV1(_SEEMTrunk):
    """SEEM v1 decoder: v0's groups for multi-mask prompts.

    - Prompt points carry a mask id; pred_pspatials / pred_nspatials are the
      per-mask means of the mask features at the positive / negative points
      (-1 for an empty mask).
    - The spatial queries are ``sample_size`` object queries a mask, picked
      by ``spatial_query_indices`` [sample_size * num_masks] (the
      reference's torch draws, an input here).
    - Spatial queries see the spatial queries of their own mask and only
      that mask's valid tokens.
    - With ``prev_mask`` [B, num_masks, H4, W4], memory j of round i takes
      the cross-attention mask of channel ``memory_indices[i, j]``; spatial
      queries see the memories of their mask's channel and memories those
      of their own channel.
    - pred_stexts are the spatial queries' class embeddings; ``prev_mask``
      is, per mask, the spatial query mask of that mask whose embedding
      best matches its pred_pspatials."""

    def __init__(self, hidden_dim: int = 512, dim_proj: int = 512, num_queries: int = 101,
                 nheads: int = 8, dim_feedforward: int = 2048, dec_layers: int = 9,
                 mask_dim: int = 512, max_spatial_tokens: int = 512,
                 num_spatial_memories: int = 32, sample_size: int = 3,
                 max_grounding_tokens: int = 8, num_levels: int = 3, dtype=torch.float32):
        super().__init__(hidden_dim, dim_proj, num_queries, nheads, dim_feedforward, dec_layers,
                         mask_dim, max_spatial_tokens, num_levels, dtype)
        self.num_spatial_memories, self.sample_size = num_spatial_memories, sample_size
        self.max_grounding_tokens = max_grounding_tokens
        self.spatial_embed = nn.Parameter(torch.zeros(num_spatial_memories, hidden_dim))
        self.spatial_featured = nn.Parameter(torch.zeros(num_spatial_memories, hidden_dim))

    def forward(self, multi_scale: List[torch.Tensor], mask_features: torch.Tensor,
                text_embeddings: torch.Tensor, logit_scale,
                spatial_points: torch.Tensor,          # [B, S, 2] (y/H, x/W)
                spatial_valid: torch.Tensor,           # [B, S] bool
                spatial_posneg: torch.Tensor,          # [B, S] +1 / -1
                spatial_mask_id: torch.Tensor,         # [B, S] int, prompt-mask index
                spatial_query_indices: torch.Tensor,   # [K * num_masks] into the queries
                num_masks: int = 1,
                grounding_tokens: Optional[torch.Tensor] = None,   # [B, G, C]
                grounding_valid: Optional[torch.Tensor] = None,    # [B, G] bool
                prev_mask: Optional[torch.Tensor] = None,          # [B, num_masks, H4, W4]
                memory_indices: Optional[torch.Tensor] = None,     # [dec_layers, M] int
                ) -> Dict[str, torch.Tensor]:
        dt, dev = self.dtype, mask_features.device
        B = mask_features.shape[0]
        Q, C = self.num_queries, self.hidden_dim
        S, G, M, K = (self.max_spatial_tokens, self.max_grounding_tokens,
                      self.num_spatial_memories, self.sample_size)
        NM = num_masks
        NS = K * NM
        has_grounding = grounding_tokens is not None
        if has_grounding and grounding_valid is None:
            raise ValueError("grounding_tokens needs grounding_valid")
        has_memory = prev_mask is not None
        if has_memory and memory_indices is None:
            raise ValueError("prev_mask needs memory_indices")
        srcs, poss, sizes = self._memory(multi_scale)
        mf = mask_features.to(torch.float32)
        text_t = text_embeddings.to(torch.float32)
        pts = spatial_points.to(torch.float32)
        valid = spatial_valid.to(torch.bool)
        mask_id = spatial_mask_id.long()

        # per-mask means of the positive / negative points; -1 where empty
        mf_at = point_sample(mf, pts)
        mid_oh = F.one_hot(mask_id, NM).to(torch.float32)                  # [B, S, NM]
        sq = []
        for sign in (1, -1):
            w_m = (valid & (spatial_posneg * sign > 0)).to(torch.float32)[..., None] * mid_oh
            cnt = w_m.sum(1)                                                # [B, NM]
            mean = torch.einsum("bsm,bsd->bmd", w_m, mf_at) / cnt[..., None].clamp_min(1.0)
            sq.append(torch.where(cnt[..., None] > 0, mean, -1.0))
        sq_pos, sq_neg = sq
        tok_spa_levels = self._spatial_tokens(srcs, sizes, pts, valid, spatial_posneg)

        n_grd_q = Q if has_grounding else 0
        NQ = Q + n_grd_q + NS
        o_spa = Q + n_grd_q
        sqi = spatial_query_indices.long()
        obj0 = self.query_feat[None].expand(B, Q, C)
        obj0_pe = self.query_embed[None].expand(B, Q, C)
        x_parts = [obj0] * (1 + has_grounding) + [self.query_feat[sqi][None].expand(B, NS, C)]
        xp_parts = [obj0_pe] * (1 + has_grounding) + [self.query_embed[sqi][None].expand(B, NS, C)]
        if has_memory:
            x_parts.append(self.spatial_featured[None].expand(B, M, C))
            xp_parts.append(self.spatial_embed[None].expand(B, M, C))
        X = torch.cat(x_parts, 1).to(dt)
        X_pos = torch.cat(xp_parts, 1).to(dt)

        n_tok_grd = G if has_grounding else 0
        y_grd_t = NQ
        y_spa_t = y_grd_t + n_tok_grd
        y_mem = y_spa_t + S
        NY = y_mem + (M if has_memory else 0)
        q_g, q_s = slice(Q, Q + n_grd_q), slice(o_spa, o_spa + NS)
        t_g, t_s, m_y = slice(y_grd_t, y_spa_t), slice(y_spa_t, y_mem), slice(y_mem, NY)
        allowed = [(slice(0, Q), slice(0, Q)), (t_s, t_s)]
        if has_grounding:
            allowed += [(q_g, q_g), (q_g, t_g), (t_g, q_g), (t_g, t_g)]
        base = _block_mask(NY, allowed)
        eye = np.eye(NM, dtype=bool).repeat(K, axis=0).repeat(K, axis=1)
        base[q_s, q_s] = ~eye
        base = torch.from_numpy(base).to(dev)[None, None].repeat(B, 1, 1, 1)
        # spatial query i (mask i // K) sees only the valid tokens of its mask
        q_mid = torch.arange(NS, device=dev) // K
        tok_match = q_mid[None, :, None] == mask_id[:, None, :]             # [B, NS, S]
        base[:, 0, q_s, t_s] = ~(tok_match & valid[:, None, :])
        key_valid = [torch.ones((B, NQ), dtype=torch.bool, device=dev)]
        if has_grounding:
            key_valid.append(grounding_valid.to(dev, torch.bool))
        key_valid.append(valid)
        if has_memory:
            key_valid.append(torch.ones((B, M), dtype=torch.bool, device=dev))
        self_mask = base | ~torch.cat(key_valid, 1)[:, None, None, :]
        if has_memory:
            pm = prev_mask.to(torch.float32)
            mem_idx = memory_indices.long().to(dev)                         # [L, M]

        def heads(Xo, size):
            oc, masks, m_emb, cls_emb = self._heads(Xo, mf, text_t, logit_scale)
            return oc, masks, m_emb, cls_emb, (_blocked(masks, size), size)

        def finalize(am_size, layer):
            # this round's memory channels override the memory rows, then
            # rows blocked everywhere are unblocked
            am, size = am_size
            if has_memory:
                am = am.clone()
                am[:, NQ:] = _blocked(pm, size)[:, mem_idx[layer]]
            return _unblock_full_rows(am)

        oc, masks, m_emb, cls_emb, am_size = heads(X, sizes[0])
        tok_grd = grounding_tokens.to(dt) if has_grounding else None
        tok_grd_pos = tok_grd.detach() if has_grounding else None
        for i in range(self.dec_layers):
            level = i % len(multi_scale)
            toks, toks_pos = [], []
            if has_grounding:
                toks.append(tok_grd)
                toks_pos.append(tok_grd_pos)
            toks.append(tok_spa_levels[level])
            toks_pos.append(tok_spa_levels[level].detach())
            sm = self_mask
            if has_memory:
                mi = mem_idx[i]
                sm = sm.clone()
                sm[:, :, q_s, m_y] = ~(q_mid[:, None] == mi[None, :])
                sm[:, :, m_y, m_y] = ~(mi[:, None] == mi[None, :])
            Y = self._layer(i, level, X, X_pos, srcs, poss, finalize(am_size, i), NQ, toks,
                            toks_pos, sm)
            X = torch.cat([Y[:, :NQ], Y[:, m_y]], 1)
            if has_grounding:
                tok_grd = Y[:, t_g]
            oc, masks, m_emb, cls_emb, am_size = heads(X, sizes[(i + 1) % len(multi_scale)])

        out = {"pred_logits": oc[:, :Q], "pred_masks": masks[:, :Q],
               "pred_captions": cls_emb[:, :Q], "pred_smasks": masks[:, q_s],
               "pred_smaskembs": m_emb[:, q_s], "pred_stexts": cls_emb[:, q_s],
               "pred_pspatials": sq_pos, "pred_nspatials": sq_neg}
        if has_grounding:
            out["pred_gmasks"] = masks[:, q_g]
            out["pred_gtexts"] = cls_emb[:, q_g]
        # per mask, the best of its own K spatial queries
        sel = torch.einsum("bqd,bmd->bqm", out["pred_smaskembs"], sq_pos)
        diag = q_mid[:, None] == torch.arange(NM, device=dev)[None, :]
        best = torch.where(diag[None], sel, -torch.inf).argmax(1)          # [B, NM]
        H, W = masks.shape[-2:]
        out["prev_mask"] = torch.gather(out["pred_smasks"], 1,
                                        best[:, :, None, None].expand(B, NM, H, W))
        return out


# geopurify_tpu/models/seem.py:715
class SEEMHeadDemo(_SEEMTrunk):
    """SEEM demo decoder: the object queries alone cross-attend, composed
    in one forward with up to four token groups: spatial (clicks), text
    grounding, audio (the grounding pathway) and visual tokens from a
    reference image (``task='refimg'`` returns that bundle).

    Self-attention sequence: [object Q | grounding | spatial | visual |
    audio]. Object queries see themselves and every present group;
    grounding and audio tokens see themselves and the object queries;
    spatial and visual tokens see only themselves. Padded slots are blocked
    as keys. Grounding and audio tokens carry over between rounds, spatial
    and visual ones are taken from their level each round.

    Outputs: pred_logits, pred_masks, pred_maskembs; pred_captions with
    grounding or audio; pred_pspatials / pred_nspatials with clicks;
    pred_pvisuals / pred_nvisuals with a visual prompt
    (``demo_select_mask`` picks the winner)."""

    def __init__(self, hidden_dim: int = 512, dim_proj: int = 512, num_queries: int = 101,
                 nheads: int = 8, dim_feedforward: int = 2048, dec_layers: int = 9,
                 mask_dim: int = 512, max_spatial_tokens: int = 512,
                 max_grounding_tokens: int = 8, max_audio_tokens: int = 8,
                 num_levels: int = 3, dtype=torch.float32):
        super().__init__(hidden_dim, dim_proj, num_queries, nheads, dim_feedforward, dec_layers,
                         mask_dim, max_spatial_tokens, num_levels, dtype)
        self.max_grounding_tokens, self.max_audio_tokens = max_grounding_tokens, max_audio_tokens

    def forward(self, multi_scale: List[torch.Tensor], mask_features: torch.Tensor,
                text_embeddings: torch.Tensor, logit_scale,
                spatial_points: Optional[torch.Tensor] = None,    # [B, S, 2] (y/H, x/W)
                spatial_valid: Optional[torch.Tensor] = None,     # [B, S] bool
                spatial_posneg: Optional[torch.Tensor] = None,    # [B, S] +1 / -1
                grounding_tokens: Optional[torch.Tensor] = None,  # [B, G, C]
                grounding_valid: Optional[torch.Tensor] = None,   # [B, G] bool
                audio_tokens: Optional[torch.Tensor] = None,      # [B, A, C]
                audio_valid: Optional[torch.Tensor] = None,       # [B, A] bool
                visual_tokens_by_level: Optional[List[torch.Tensor]] = None,   # levels x [B, S, C]
                visual_valid: Optional[torch.Tensor] = None,      # [B, S] bool
                visual_query_pos: Optional[torch.Tensor] = None,  # [B, mask_dim]
                visual_query_neg: Optional[torch.Tensor] = None,  # [B, mask_dim]
                task: str = "demo"):
        dt, dev = self.dtype, mask_features.device
        B = mask_features.shape[0]
        Q, C = self.num_queries, self.hidden_dim
        S, G, A = self.max_spatial_tokens, self.max_grounding_tokens, self.max_audio_tokens
        has_spatial = spatial_points is not None
        has_grounding = grounding_tokens is not None
        has_audio = audio_tokens is not None
        has_visual = visual_tokens_by_level is not None
        if task == "refimg" and not has_spatial:
            raise ValueError("task='refimg' needs spatial prompts")
        srcs, poss, sizes = self._memory(multi_scale)
        mf = mask_features.to(torch.float32)
        text_t = text_embeddings.to(torch.float32)

        if has_spatial:
            pts = spatial_points.to(torch.float32)
            sq_pos, sq_neg = _prompt_means(point_sample(mf, pts), spatial_valid, spatial_posneg)
            tok_spa_levels = self._spatial_tokens(srcs, sizes, pts, spatial_valid,
                                                  spatial_posneg)
        if task == "refimg":
            # the reference-image pass returns the visual prompt bundle
            return {"visual_query_pos": sq_pos, "visual_query_neg": sq_neg,
                    "src_visual_queries": tok_spa_levels,
                    "src_visual_maskings": spatial_valid}

        y_grd = Q
        y_spa = y_grd + (G if has_grounding else 0)
        y_vis = y_spa + (S if has_spatial else 0)
        y_aud = y_vis + (S if has_visual else 0)
        NY = y_aud + (A if has_audio else 0)
        q = slice(0, Q)
        t_g, t_s = slice(y_grd, y_spa), slice(y_spa, y_vis)
        t_v, t_a = slice(y_vis, y_aud), slice(y_aud, NY)
        X = self.query_feat[None].expand(B, Q, C).to(dt)
        X_pos = self.query_embed[None].expand(B, Q, C).to(dt)
        allowed = [(q, q)]
        key_valid = [torch.ones((B, Q), dtype=torch.bool, device=dev)]
        for present, t, both_ways, v in ((has_grounding, t_g, True, grounding_valid),
                                         (has_spatial, t_s, False, spatial_valid),
                                         (has_visual, t_v, False, visual_valid),
                                         (has_audio, t_a, True, audio_valid)):
            if present:
                allowed += [(q, t), (t, t)] + ([(t, q)] if both_ways else [])
                key_valid.append(v.to(dev, torch.bool))
        base = torch.from_numpy(_block_mask(NY, allowed)).to(dev)[None, None]
        self_mask = base | ~torch.cat(key_valid, 1)[:, None, None, :]

        def heads(Xo, size):
            oc, masks, m_emb, cls_emb = self._heads(Xo, mf, text_t, logit_scale)
            return oc, masks, m_emb, cls_emb, _unblock_full_rows(_blocked(masks, size))

        oc, masks, m_emb, cls_emb, attn_mask = heads(X, sizes[0])
        tok_grd = grounding_tokens.to(dt) if has_grounding else None
        tok_grd_pos = tok_grd.detach() if has_grounding else None
        tok_aud = audio_tokens.to(dt) if has_audio else None
        tok_aud_pos = tok_aud.detach() if has_audio else None
        for i in range(self.dec_layers):
            level = i % len(multi_scale)
            toks, toks_pos = [], []
            if has_grounding:
                toks.append(tok_grd)
                toks_pos.append(tok_grd_pos)
            if has_spatial:
                toks.append(tok_spa_levels[level])
                toks_pos.append(tok_spa_levels[level].detach())
            if has_visual:
                tok_vis = visual_tokens_by_level[level].to(dt)
                toks.append(tok_vis)
                toks_pos.append(tok_vis.detach())
            if has_audio:
                toks.append(tok_aud)
                toks_pos.append(tok_aud_pos)
            Y = self._layer(i, level, X, X_pos, srcs, poss, attn_mask, Q, toks, toks_pos,
                            self_mask)
            X = Y[:, :Q]
            if has_grounding:
                tok_grd = Y[:, t_g]
            if has_audio:
                tok_aud = Y[:, t_a]
            oc, masks, m_emb, cls_emb, attn_mask = heads(X, sizes[(i + 1) % len(multi_scale)])

        out = {"pred_logits": oc, "pred_masks": masks, "pred_maskembs": m_emb}
        if has_grounding or has_audio:
            out["pred_captions"] = cls_emb
        if has_spatial:
            out["pred_pspatials"] = sq_pos[:, None]
            out["pred_nspatials"] = sq_neg[:, None]
        if has_visual:
            out["pred_pvisuals"] = visual_query_pos[:, None]
            out["pred_nvisuals"] = visual_query_neg[:, None]
        return out


# geopurify_tpu/models/seem.py:997
def demo_select_mask(out: Dict[str, torch.Tensor], prompt: str = "spatial"):
    """The demo's winning object query: the one whose mask embedding best
    matches the positive prompt mean (pred_pspatials, or pred_pvisuals for
    ``prompt='visual'``). Returns (best [B], its mask logits [B, 1, H, W])."""
    s_emb = out["pred_pspatials" if prompt == "spatial" else "pred_pvisuals"]
    sel = torch.einsum("bqd,bkd->bqk", out["pred_maskembs"], s_emb)[:, :, 0]
    best = sel.argmax(1)
    masks = out["pred_masks"]
    return best, masks[torch.arange(masks.shape[0], device=masks.device), best][:, None]


# ---------------------------------------------------------------------------
# v1 interactive refinement (host loop, numpy)
# ---------------------------------------------------------------------------

# geopurify_tpu/models/seem.py:1016
def prepare_next_spatial_mask(pred_mask: np.ndarray, gt_mask: np.ndarray,
                              pos_mask: np.ndarray, neg_mask: np.ndarray,
                              rng: Optional[np.random.Generator] = None, mode: str = "best",
                              dilation: int = 3, iou_stop: float = 0.925
                              ) -> Tuple[np.ndarray, np.ndarray, float]:
    """The next click: the point deepest inside the larger error region
    (false negatives -> a positive click, false positives -> a negative
    one) by the euclidean distance transform, dilated ``dilation`` x
    ``dilation`` and OR-ed into the prompt masks. Returns (pos_mask,
    neg_mask, IoU of ``pred_mask``); the masks are unchanged at
    ``iou >= iou_stop`` or when no error region is left."""
    from scipy import ndimage

    prev = pos_mask | neg_mask
    fn = gt_mask & ~pred_mask & ~prev
    fp = ~gt_mask & pred_mask & ~prev
    inter = (gt_mask & pred_mask).sum()
    union = (gt_mask | pred_mask).sum()
    iou = float(inter) / (float(union) + 1e-8)
    is_positive = fn.sum() > fp.sum()
    select = fn if is_positive else fp
    if iou >= iou_stop or not select.any():
        return pos_mask, neg_mask, iou
    # distance into the selected region; the padding makes the border count
    dt = ndimage.distance_transform_edt(np.pad(select, 1, constant_values=False)
                                        )[1:-1, 1:-1].reshape(-1)
    if mode == "best":
        idx = int(np.argmax(dt))
    else:  # best_random
        idx = int((rng or np.random.default_rng()).choice(np.nonzero(dt > 0)[0]))
    click = np.zeros(select.size, bool)
    click[idx] = True
    click = ndimage.binary_dilation(click.reshape(select.shape),
                                    np.ones((dilation, dilation), bool))
    if is_positive:
        pos_mask = pos_mask | click
    else:
        neg_mask = neg_mask | click
    return pos_mask, neg_mask, iou


# geopurify_tpu/models/seem.py:1062
def points_from_masks(pos_mask: np.ndarray, neg_mask: np.ndarray, budget: int,
                      rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Up to ``budget`` normalized (y, x) pixel-centre points drawn from the
    positive and negative prompt masks, with their +-1 tags and valid mask
    (the per-round resampling)."""
    H, W = pos_mask.shape
    pts = np.zeros((budget, 2), np.float32)
    valid = np.zeros(budget, bool)
    tags = np.ones(budget, np.int32)
    entries = []
    for m, tag in ((pos_mask, 1), (neg_mask, -1)):
        ys, xs = np.nonzero(m)
        entries += [(y, x, tag) for y, x in zip(ys, xs)]
    if entries:
        entries = np.asarray(entries)
        take = min(len(entries), budget)
        sel = (rng.choice(len(entries), take, replace=False)
               if len(entries) > budget else np.arange(len(entries)))
        chosen = entries[sel]
        pts[:take, 0] = (chosen[:, 0] + 0.5) / H
        pts[:take, 1] = (chosen[:, 1] + 0.5) / W
        tags[:take] = chosen[:, 2]
        valid[:take] = True
    return pts, valid, tags


# geopurify_tpu/models/seem.py:1091
def interactive_refine(apply_fn, gt_mask: np.ndarray, init_pos: np.ndarray, budget: int = 64,
                       iters: int = 10, seed: int = 0, iou_stop: float = 0.9
                       ) -> Tuple[np.ndarray, List[float]]:
    """The v1 click-refinement loop: forward -> IoU -> next click -> again,
    with the previous round's mask as spatial memory. ``apply_fn(points,
    valid, tags, prev_mask or None)`` returns the head's outputs (torch);
    ``gt_mask`` and ``init_pos`` are [H4, W4] bool on the mask grid.
    Returns (the last mask logits [H4, W4], the IoU of each round)."""
    rng = np.random.default_rng(seed)
    pos, neg = init_pos.copy(), np.zeros_like(init_pos)
    prev = None
    ious: List[float] = []
    last = None
    for _ in range(iters):
        pts, valid, tags = points_from_masks(pos, neg, budget, rng)
        out = apply_fn(pts, valid, tags, prev)
        prev = out["prev_mask"]
        last = prev[0].reshape(prev.shape[-2:]).detach().float().cpu().numpy()
        pred = 1.0 / (1.0 + np.exp(-last)) > 0.5
        pos, neg, iou = prepare_next_spatial_mask(pred, gt_mask, pos, neg, rng=rng,
                                                  iou_stop=iou_stop)
        ious.append(iou)
        if iou >= iou_stop:
            break
    return last, ious
