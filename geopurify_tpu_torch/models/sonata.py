"""Sonata-style 3D teacher — a PTv3-flavoured hierarchical point transformer.

Port of geopurify_tpu/models/sonata.py (frozen Stage-1 teacher): a sparse
conv stem, five stages of point blocks (xCPE sparse conv + patch attention
over a space-filling-curve order + MLP) with grid pooling between them, and
the reference's 2-level upcast back to the finest grid (1088-d features at
the default widths). All of it is plain PyTorch: the JAX package runs it
through XLA, not Pallas. Parameter names follow the JAX tree, so
``utils.from_jax.sonata_from_jax`` maps the weights 1:1; parameters stay
f32 and ``dtype`` is the compute type (bf16 by default).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch
from torch import nn

from geopurify_tpu_torch.models.layers import Dense, LayerNorm, gelu_exact
from geopurify_tpu_torch.ops.morton import hilbert_code, morton_code
from geopurify_tpu_torch.ops.segment import segment_mean
from geopurify_tpu_torch.ops.sparse_conv import build_neighbor_table, sparse_conv3
from geopurify_tpu_torch.ops.voxelize import voxelize_points

_LOGIT_ELEMS = 1 << 28     # f32 attention logits per patch group (1 GiB)


# geopurify_tpu/models/sonata.py:58
def serialize(coords: torch.Tensor, valid: torch.Tensor, order: int) -> torch.Tensor:
    """Sort permutation by space-filling-curve code, invalid rows last:
    0 = z (Morton), 1 = z-trans, 2 = Hilbert, 3 = Hilbert-trans."""
    if order >= 2:
        c = torch.clamp(coords, min=0).to(torch.int32)
        if order == 3:
            c = c[:, [1, 0, 2]]
        code = hilbert_code(c)
    else:
        code = morton_code(coords, order)
    code = torch.where(valid, code, 2 ** 30)
    return torch.argsort(code, stable=True)


# geopurify_tpu/models/sonata.py:82
class NormOrAffine(nn.Module):
    """LayerNorm, or a per-channel affine (folded BatchNorm) when
    ``affine_only``; computed and returned in f32."""

    def __init__(self, dim: int, affine_only: bool = False, eps: float = 1e-5):
        super().__init__()
        self.affine_only = affine_only
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        x32 = x.to(torch.float32)
        if not self.affine_only:
            mu = x32.mean(-1, keepdim=True)
            var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
            x32 = (x32 - mu) * torch.rsqrt(var + self.eps)
        return x32 * self.weight + self.bias


# geopurify_tpu/models/sonata.py:106
class PatchAttention(nn.Module):
    """Dense multi-head attention within fixed-size patches of the
    serialized sequence; f32 logits and softmax, fully-masked rows give 0.
    Patches are processed in groups that keep the logits near 1 GiB."""

    def __init__(self, dim: int, num_heads: int, patch_size: int, dtype=torch.float32):
        super().__init__()
        self.dim, self.num_heads, self.patch_size, self.dtype = dim, num_heads, patch_size, dtype
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)

    def forward(self, x, perm, valid):
        N, C = x.shape
        S = min(self.patch_size, N)
        n_patch = -(-N // S)
        Np = n_patch * S
        H = self.num_heads
        d = C // H
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(N, device=perm.device, dtype=perm.dtype)
        xs = torch.nn.functional.pad(x[perm], (0, 0, 0, Np - N)).reshape(n_patch, S, C)
        vs = torch.nn.functional.pad(valid[perm], (0, Np - N)).reshape(n_patch, S)
        qkv = self.qkv(xs)
        q, k, v = qkv.split(C, dim=-1)

        def heads(t):
            return t.reshape(t.shape[0], S, H, d).transpose(1, 2)

        group = max(1, _LOGIT_ELEMS // (H * S * S))
        outs = []
        for lo in range(0, n_patch, group):
            sl = slice(lo, lo + group)
            qh, kh, vh = heads(q[sl]), heads(k[sl]), heads(v[sl])
            logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / (d ** 0.5)
            logits = logits.masked_fill(~vs[sl][:, None, None, :], float("-inf"))
            attn = torch.nan_to_num(torch.softmax(logits, dim=-1)).to(self.dtype)
            outs.append(torch.matmul(attn, vh))
        out = torch.cat(outs).transpose(1, 2).reshape(Np, C)[:N]
        return self.proj(out)[inv]


# geopurify_tpu/models/sonata.py:144
class PointBlock(nn.Module):
    """xCPE (3^3 sparse conv -> Linear -> LayerNorm, residual) + pre-norm
    patch attention + MLP, zero on invalid rows."""

    def __init__(self, dim: int, num_heads: int, patch_size: int,
                 mlp_ratio: float = 4.0, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.cpe_kernel = nn.Parameter(torch.zeros(27, dim, dim))
        self.cpe_bias = nn.Parameter(torch.zeros(dim))
        self.cpe_fc = Dense(dim, dim, dtype)
        self.cpe_norm = LayerNorm(dim)
        self.norm1 = LayerNorm(dim)
        self.attn = PatchAttention(dim, num_heads, patch_size, dtype)
        self.norm2 = LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.mlp_fc1 = Dense(dim, hidden, dtype)
        self.mlp_fc2 = Dense(hidden, dim, dtype)

    def forward(self, x, perm, valid, neighbor_idx):
        dt = self.dtype
        h = sparse_conv3(x, neighbor_idx, self.cpe_kernel.to(dt), valid, bias=self.cpe_bias)
        h = self.cpe_norm(self.cpe_fc(h))
        x = x + h.to(dt)
        x = x + self.attn(self.norm1(x).to(dt), perm, valid)
        h = self.mlp_fc2(gelu_exact(self.mlp_fc1(self.norm2(x).to(dt))))
        x = x + h
        return torch.where(valid[:, None], x, 0.0).to(dt)


class StageLevel(NamedTuple):
    feats: torch.Tensor            # [Mi, Ci]
    coords: torch.Tensor           # [Mi, 3]
    valid: torch.Tensor            # [Mi]
    pooling_inverse: Optional[torch.Tensor]   # [M_child] child -> this level


# geopurify_tpu/models/sonata.py:211
class SonataEncoder(nn.Module):
    """Stem + stages with grid pooling; returns every level, fine to coarse.
    Each stage's blocks cycle the z / z-trans / Hilbert / Hilbert-trans
    orders; pooling halves the grid, projects the children, reduces by max
    (or mean), then norm + GELU. Every level keeps the full child count as
    its row budget (only the valid count shrinks)."""

    def __init__(self, in_channels: int = 6,
                 enc_depths: Sequence[int] = (3, 3, 3, 12, 3),
                 enc_channels: Sequence[int] = (48, 96, 192, 384, 512),
                 enc_num_head: Sequence[int] = (3, 6, 12, 24, 32),
                 enc_patch_size: Sequence[int] = (1024, 1024, 1024, 1024, 1024),
                 mlp_ratio: float = 4.0, stem_kernel: int = 5,
                 pool_reduce: str = "max", aux_norm_affine_only: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem_kernel = stem_kernel
        self.pool_reduce = pool_reduce
        self.depths = tuple(enc_depths)
        C0 = enc_channels[0]
        if stem_kernel > 1:
            self.stem_kernel_w = nn.Parameter(torch.zeros(stem_kernel ** 3, in_channels, C0))
        else:
            self.embed = Dense(in_channels, C0, dtype)
        self.embed_norm = NormOrAffine(C0, aux_norm_affine_only)
        for s, depth in enumerate(self.depths):
            c = enc_channels[s]
            self.add_module(f"stage{s}_blocks", nn.ModuleList([
                PointBlock(c, enc_num_head[s], enc_patch_size[s], mlp_ratio, dtype)
                for _ in range(depth)]))
            if s < len(self.depths) - 1:
                self.add_module(f"pool_proj{s}", Dense(c, enc_channels[s + 1], dtype))
                self.add_module(f"pool_norm{s}",
                                NormOrAffine(enc_channels[s + 1], aux_norm_affine_only))

    def forward(self, feats, coords, valid) -> List[StageLevel]:
        dt = self.dtype
        if self.stem_kernel > 1:
            stem_nbr = build_neighbor_table(coords, valid, kernel_size=self.stem_kernel)
            x = sparse_conv3(feats.to(dt), stem_nbr, self.stem_kernel_w.to(dt), valid)
        else:
            x = self.embed(feats.to(dt))
        x = gelu_exact(self.embed_norm(x)).to(dt)
        levels: List[StageLevel] = []
        cur_coords, cur_valid, pooling_inverse = coords, valid, None
        for s, depth in enumerate(self.depths):
            perms = [serialize(cur_coords, cur_valid, o) for o in range(min(depth, 4))]
            nbr = build_neighbor_table(cur_coords, cur_valid)
            for b, block in enumerate(getattr(self, f"stage{s}_blocks")):
                x = block(x.to(dt), perms[b % 4], cur_valid, nbr)
            levels.append(StageLevel(x, cur_coords, cur_valid, pooling_inverse))
            if s == len(self.depths) - 1:
                break
            M_next = cur_coords.shape[0]
            dv = voxelize_points(torch.div(cur_coords, 2, rounding_mode="floor"),
                                 cur_valid, max_voxels=M_next)
            inv = dv.point2voxel.long()
            proj = getattr(self, f"pool_proj{s}")(x).to(torch.float32)
            if self.pool_reduce == "max":
                neg = torch.finfo(torch.float32).min
                src = torch.where(cur_valid[:, None], proj, neg)
                pooled = torch.full((M_next + 1, proj.shape[1]), neg, device=x.device)
                pooled.scatter_reduce_(0, inv[:, None].expand_as(src), src, "amax")
                pooled = pooled[:M_next]
                pooled = torch.where(pooled <= neg / 2, 0.0, pooled).to(dt)
            else:
                pooled = segment_mean(proj, inv, M_next).to(dt)
            x = gelu_exact(getattr(self, f"pool_norm{s}")(pooled)).to(dt)
            x = torch.where(dv.voxel_valid[:, None], x, 0.0)
            cur_coords, cur_valid = dv.voxel_coords, dv.voxel_valid
            pooling_inverse = torch.clamp(inv, max=M_next - 1)
        return levels


# geopurify_tpu/models/sonata.py:321
def sonata_features(levels: List[StageLevel], upcast_levels: int = 2) -> torch.Tensor:
    """The reference's upcast: concat the deepest ``upcast_levels`` levels'
    features down the hierarchy, then propagate through the rest. Returns
    features at the finest grid, [M0, C]."""
    feat = levels[-1].feats
    for li in range(len(levels) - 1, 0, -1):
        gathered = feat[levels[li].pooling_inverse]
        if len(levels) - li <= upcast_levels:
            feat = torch.cat([levels[li - 1].feats.to(torch.float32),
                              gathered.to(torch.float32)], -1)
        else:
            feat = gathered
    return feat


# geopurify_tpu/models/sonata.py:341
class SonataTeacher(nn.Module):
    """Per-point features from a voxelized scene: voxel scatter-mean of the
    point features, encode, upcast, gather back per point."""

    def __init__(self, in_channels: int = 6,
                 enc_depths: Sequence[int] = (3, 3, 3, 12, 3),
                 enc_channels: Sequence[int] = (48, 96, 192, 384, 512),
                 enc_num_head: Sequence[int] = (3, 6, 12, 24, 32),
                 enc_patch_size: Sequence[int] = (1024, 1024, 1024, 1024, 1024),
                 upcast_levels: int = 2, stem_kernel: int = 5,
                 pool_reduce: str = "max", aux_norm_affine_only: bool = False,
                 dtype=torch.float32, mlp_ratio: float = 4.0):
        super().__init__()
        self.upcast_levels = upcast_levels
        ch = list(enc_channels)
        d = ch[-1]
        for li in range(len(ch) - 1, 0, -1):
            if len(ch) - li <= upcast_levels:
                d = ch[li - 1] + d
        self.out_channels = d
        self.encoder = SonataEncoder(
            in_channels, enc_depths, enc_channels, enc_num_head, enc_patch_size,
            mlp_ratio, stem_kernel, pool_reduce, aux_norm_affine_only, dtype)

    def forward(self, point_feats, voxel_coords, voxel_valid, point2voxel, point_valid):
        M0 = voxel_coords.shape[0]
        p2v = torch.where(point_valid, point2voxel.long(), M0)
        vox_feats = segment_mean(point_feats.to(torch.float32), p2v, M0)
        levels = self.encoder(vox_feats, voxel_coords, voxel_valid)
        f0 = sonata_features(levels, self.upcast_levels)
        f0 = torch.cat([f0, f0.new_zeros((1, f0.shape[1]))])
        out = f0[torch.clamp(point2voxel.long(), max=M0)]
        return torch.where(point_valid[:, None], out, 0.0)
