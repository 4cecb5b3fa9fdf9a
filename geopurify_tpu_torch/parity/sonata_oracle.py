"""Independent Sonata/PTv3 oracle — de-novo naive-loop numpy forward.

Port of geopurify_tpu/parity/sonata_oracle.py, kept as a copy so that the
two are held against each other bit for bit.

VERDICT r4 next #7: the reference's `sonata` submodule is EMPTY
(the reference tree's .gitmodules:1-6), so nothing in-tree can oracle the PTv3
port and the previous regression pinned the rebuild's own frozen output.
This module implements the SAME documented contract as models/sonata.py —
the usage contract of reference models/affinity_module.py:995-1063 (grid
pooling, serialized patch attention, 2-level upcast) over the public
Pointcept PointTransformerV3 layout — but SHARES ZERO CODE with it:

- per-point scalar Morton interleave and Skilling transpose Hilbert codes
  ("Programming the Hilbert curve", AIP 2004 — the published algorithm,
  re-derived here as the paper's scalar in-place routine rather than the
  vectorized bit-plane version in ops/morton.py);
- sparse convs via an explicit {(x,y,z): row} hash map, one python loop
  per (voxel, offset);
- patch attention with per-patch, per-head python loops over the sorted
  sequence;
- grid pooling via sorted-unique parent cells (x-major lexicographic, the
  repo-wide voxel order contract) + per-parent python max/mean reduction.

It consumes the Flax-layout parameter tree DIRECTLY (Dense kernel [in, out],
y = x @ k + b; LayerNorm/NormOrAffine scale/bias at eps 1e-5 in f32;
scanned stage blocks carry a leading depth axis) — so this is a
cross-implementation check of the attention/pooling/serialization MATH,
not of the torch-checkpoint converter's layout assumptions (only real
released weights can validate those; utils/convert_sonata.py documents
them). The port's SonataTeacher state dict reaches this layout through
utils/from_jax.sonata_to_jax.

Numpy only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["sonata_forward_naive", "morton_naive", "hilbert_naive",
           "serialize_naive"]


# ---------------------------------------------------------------------------
# Space-filling curves (scalar, per point)
# ---------------------------------------------------------------------------


def morton_naive(x: int, y: int, z: int, order: int = 0) -> int:
    """30-bit z-order code; order 1 swaps the x/y axes (the z-trans pair)."""
    if order == 1:
        x, y = y, x
    x, y, z = x & 0x3FF, y & 0x3FF, z & 0x3FF
    code = 0
    for b in range(10):
        code |= ((x >> b) & 1) << (3 * b)
        code |= ((y >> b) & 1) << (3 * b + 1)
        code |= ((z >> b) & 1) << (3 * b + 2)
    return code


def hilbert_naive(x: int, y: int, z: int, bits: int = 10,
                  trans: bool = False) -> int:
    """3-D Hilbert index via Skilling's AxesToTranspose (the paper's scalar
    in-place routine) followed by bit interleave with axis 0 most
    significant per 3-bit group. ``trans`` swaps x/y first."""
    if trans:
        x, y = y, x
    lim = (1 << bits) - 1
    X = [min(max(x, 0), lim), min(max(y, 0), lim), min(max(z, 0), lim)]
    # inverse undo (high bit plane -> plane 1)
    Q = 1 << (bits - 1)
    while Q > 1:
        P = Q - 1
        for i in range(3):
            if X[i] & Q:
                X[0] ^= P                       # invert low bits of X[0]
            else:
                t = (X[0] ^ X[i]) & P           # swap low bits X[0]<->X[i]
                X[0] ^= t
                X[i] ^= t
        Q >>= 1
    # Gray encode
    for i in range(1, 3):
        X[i] ^= X[i - 1]
    t = 0
    Q = 1 << (bits - 1)
    while Q > 1:
        if X[2] & Q:
            t ^= Q - 1
        Q >>= 1
    for i in range(3):
        X[i] ^= t
    code = 0
    for b in range(bits):
        code |= ((X[0] >> b) & 1) << (3 * b + 2)
        code |= ((X[1] >> b) & 1) << (3 * b + 1)
        code |= ((X[2] >> b) & 1) << (3 * b)
    return code


def serialize_naive(coords: np.ndarray, valid: np.ndarray,
                    order: int) -> np.ndarray:
    """Stable argsort by curve code, invalid rows pushed last (the contract
    of models/sonata.serialize: orders 0/1 = z / z-trans Morton, 2/3 =
    hilbert / hilbert-trans)."""
    big = 2 ** 30
    codes = np.empty(len(coords), np.int64)
    for i, (c, v) in enumerate(zip(coords, valid)):
        if not v:
            codes[i] = big
        elif order == 0 or order == 1:
            codes[i] = morton_naive(int(c[0]), int(c[1]), int(c[2]), order)
        else:
            codes[i] = hilbert_naive(int(c[0]), int(c[1]), int(c[2]),
                                     trans=(order == 3))
    return np.argsort(codes, kind="stable")


# ---------------------------------------------------------------------------
# Primitive layers (f32, literal)
# ---------------------------------------------------------------------------


def _dense(p: Dict, x: np.ndarray) -> np.ndarray:
    return x @ p["kernel"] + p["bias"]


def _layernorm(p: Dict, x: np.ndarray, affine_only: bool = False,
               eps: float = 1e-5) -> np.ndarray:
    x = x.astype(np.float64).astype(np.float32)
    if not affine_only:
        mu = x.mean(-1, keepdims=True)
        var = ((x - mu) ** 2).mean(-1, keepdims=True)
        x = (x - mu) / np.sqrt(var + eps)
    return x * p["scale"] + p["bias"]


def _gelu(x: np.ndarray) -> np.ndarray:
    out = np.empty_like(x, np.float32)
    flat_in, flat_out = x.reshape(-1), out.reshape(-1)
    for i in range(flat_in.size):
        v = float(flat_in[i])
        flat_out[i] = 0.5 * v * (1.0 + math.erf(v / math.sqrt(2.0)))
    return out


def _offsets(kernel_size: int) -> List[Tuple[int, int, int]]:
    r = range(-(kernel_size // 2), kernel_size // 2 + 1)
    return [(dx, dy, dz) for dx in r for dy in r for dz in r]   # x-major


def _sparse_conv(feats: np.ndarray, coords: np.ndarray, valid: np.ndarray,
                 weights: np.ndarray, bias: Optional[np.ndarray],
                 kernel_size: int) -> np.ndarray:
    """out[i] = sum_k F[at(coords[i] + offset_k)] @ W[k] (+ bias), zeros on
    invalid rows — the submanifold conv contract (weights [K, Cin, Cout],
    offsets x-major)."""
    lut = {}
    for i in range(len(coords)):
        if valid[i]:
            lut[tuple(int(v) for v in coords[i])] = i
    offs = _offsets(kernel_size)
    out = np.zeros((len(coords), weights.shape[2]), np.float32)
    for i in range(len(coords)):
        if not valid[i]:
            continue
        cx, cy, cz = (int(v) for v in coords[i])
        acc = np.zeros(weights.shape[2], np.float32)
        for k, (dx, dy, dz) in enumerate(offs):
            j = lut.get((cx + dx, cy + dy, cz + dz))
            if j is not None:
                acc += feats[j] @ weights[k]
        if bias is not None:
            acc += bias
        out[i] = acc
    return out


def _patch_attention(p: Dict, x: np.ndarray, perm: np.ndarray,
                     valid: np.ndarray, num_heads: int,
                     patch_size: int) -> np.ndarray:
    """Dense masked MHA over fixed-size patches of the sorted sequence
    (padded to a whole number of patches; fully-masked query rows emit 0
    before the output projection)."""
    N, C = x.shape
    S = min(patch_size, N)
    n_patch = -(-N // S)
    Np = n_patch * S
    xs = np.zeros((Np, C), np.float32)
    vs = np.zeros(Np, bool)
    xs[:N] = x[perm]
    vs[:N] = valid[perm]
    qkv = _dense(p["qkv"], xs)                   # [Np, 3C]
    q, k, v = qkv[:, :C], qkv[:, C:2 * C], qkv[:, 2 * C:]
    d = C // num_heads
    attn_out = np.zeros((Np, C), np.float32)
    for pi in range(n_patch):
        lo = pi * S
        key_ok = vs[lo: lo + S]
        for h in range(num_heads):
            hd0 = h * d
            qh = q[lo: lo + S, hd0: hd0 + d]
            kh = k[lo: lo + S, hd0: hd0 + d]
            vh = v[lo: lo + S, hd0: hd0 + d]
            logits = (qh.astype(np.float32) @ kh.T) / math.sqrt(float(d))
            for r in range(S):
                row = np.where(key_ok, logits[r], -np.inf)
                if not key_ok.any():
                    continue
                m = row[key_ok].max()
                e = np.where(key_ok, np.exp(row - m), 0.0)
                attn_out[lo + r, hd0: hd0 + d] = (e / e.sum()) @ vh
    out = _dense(p["proj"], attn_out)[:N]
    inv = np.empty(N, np.int64)
    inv[perm] = np.arange(N)
    return out[inv]


# ---------------------------------------------------------------------------
# Blocks / stages
# ---------------------------------------------------------------------------


def _block(p: Dict, x: np.ndarray, coords: np.ndarray, valid: np.ndarray,
           perm: np.ndarray, num_heads: int, patch_size: int,
           mlp_ratio: float) -> np.ndarray:
    h = _sparse_conv(x, coords, valid, p["cpe_kernel"], p["cpe_bias"], 3)
    h = _dense(p["cpe_fc"], h)
    h = _layernorm(p["cpe_norm"], h)
    x = x + h
    h = _layernorm(p["norm1"], x)
    x = x + _patch_attention(p["attn"], h, perm, valid, num_heads, patch_size)
    h = _layernorm(p["norm2"], x)
    h = _dense(p["mlp_fc1"], h)
    h = _gelu(h)
    h = _dense(p["mlp_fc2"], h)
    x = x + h
    x[~valid] = 0
    return x


def _grid_pool_structure(coords: np.ndarray, valid: np.ndarray):
    """Parent cells of coords//2 in ascending x-major lexicographic order
    (the repo-wide voxel order contract); returns (parent_coords [M,3],
    parent_valid [M], inv [M] child->parent id, == M for invalid children).
    The parent BUDGET equals the child count (models/sonata.py pooling)."""
    M = len(coords)
    parents = coords // 2
    keys = [tuple(int(v) for v in parents[i]) for i in range(M) if valid[i]]
    uniq = sorted(set(keys))
    pid = {c: i for i, c in enumerate(uniq)}
    inv = np.full(M, M, np.int64)
    for i in range(M):
        if valid[i]:
            inv[i] = pid[tuple(int(v) for v in parents[i])]
    pc = np.zeros((M, 3), coords.dtype)
    pv = np.zeros(M, bool)
    for c, i in pid.items():
        pc[i] = c
        pv[i] = True
    return pc, pv, inv


def sonata_forward_naive(
    params: Dict,
    point_feats: np.ndarray,     # [N, in_ch]
    voxel_coords: np.ndarray,    # [M0, 3] int32 sorted lexicographic
    voxel_valid: np.ndarray,     # [M0]
    point2voxel: np.ndarray,     # [N] (== M0 padding)
    point_valid: np.ndarray,     # [N]
    enc_depths: Sequence[int],
    enc_channels: Sequence[int],
    enc_num_head: Sequence[int],
    enc_patch_size: Sequence[int],
    mlp_ratio: float = 4.0,
    stem_kernel: int = 5,
    pool_reduce: str = "max",
    upcast_levels: int = 2,
    aux_norm_affine_only: bool = False,
) -> np.ndarray:
    """Literal SonataTeacher forward: scatter-mean -> stem -> stages with
    per-block serialization order b % 4 -> grid pooling -> 2-level upcast
    -> per-point gather. ``params`` is the Flax-layout tree (numpy
    leaves) of models/sonata.SonataTeacher."""
    enc = params["encoder"]
    M0 = len(voxel_coords)
    N = len(point_feats)

    # scatter mean points -> voxels (empty voxels 0)
    vox = np.zeros((M0, point_feats.shape[1]), np.float32)
    cnt = np.zeros(M0, np.float32)
    for i in range(N):
        if point_valid[i] and point2voxel[i] < M0:
            vox[point2voxel[i]] += point_feats[i]
            cnt[point2voxel[i]] += 1
    vox[cnt > 0] /= cnt[cnt > 0, None]

    # stem
    if stem_kernel > 1:
        x = _sparse_conv(vox, voxel_coords, voxel_valid,
                         enc["stem_kernel_w"], None, stem_kernel)
    else:
        x = _dense(enc["embed"], vox)
    x = _layernorm(enc["embed_norm"], x, affine_only=aux_norm_affine_only)
    x = _gelu(x)
    x[~voxel_valid] = 0

    levels = []                                   # (feats, inv_from_child)
    cur_coords, cur_valid = voxel_coords, voxel_valid
    pooling_inverse = None
    for s, depth in enumerate(enc_depths):
        blocks = enc[f"stage{s}_blocks"]["block"]
        for b in range(depth):
            bp = {
                "cpe_kernel": blocks["cpe_kernel"][b],
                "cpe_bias": blocks["cpe_bias"][b],
                "cpe_fc": {k: v[b] for k, v in blocks["cpe_fc"].items()},
                "cpe_norm": {k: v[b] for k, v in blocks["cpe_norm"].items()},
                "norm1": {k: v[b] for k, v in blocks["norm1"].items()},
                "norm2": {k: v[b] for k, v in blocks["norm2"].items()},
                "attn": {
                    "qkv": {k: v[b] for k, v in blocks["attn"]["qkv"].items()},
                    "proj": {k: v[b] for k, v in blocks["attn"]["proj"].items()},
                },
                "mlp_fc1": {k: v[b] for k, v in blocks["mlp_fc1"].items()},
                "mlp_fc2": {k: v[b] for k, v in blocks["mlp_fc2"].items()},
            }
            perm = serialize_naive(cur_coords, cur_valid, order=b % 4)
            x = _block(bp, x, cur_coords, cur_valid, perm,
                       enc_num_head[s], enc_patch_size[s], mlp_ratio)
        levels.append((x, pooling_inverse))

        if s < len(enc_depths) - 1:
            pc, pv, inv = _grid_pool_structure(cur_coords, cur_valid)
            Mi = len(cur_coords)
            proj = _dense(enc[f"pool_proj{s}"], x)
            pooled = np.zeros((Mi, proj.shape[1]), np.float32)
            if pool_reduce == "max":
                filled = np.zeros(Mi, bool)
                for i in range(Mi):
                    if cur_valid[i]:
                        j = inv[i]
                        pooled[j] = (proj[i] if not filled[j]
                                     else np.maximum(pooled[j], proj[i]))
                        filled[j] = True
            else:
                c2 = np.zeros(Mi, np.float32)
                for i in range(Mi):
                    if cur_valid[i]:
                        pooled[inv[i]] += proj[i]
                        c2[inv[i]] += 1
                pooled[c2 > 0] /= c2[c2 > 0, None]
            x = _layernorm(enc[f"pool_norm{s}"], pooled,
                           affine_only=aux_norm_affine_only)
            x = _gelu(x)
            x[~pv] = 0
            cur_coords, cur_valid = pc, pv
            pooling_inverse = np.minimum(inv, Mi - 1)

    # upcast (affinity_module.py:1038-1050): concat the deepest
    # ``upcast_levels`` levels down, then propagate (replace)
    feat = levels[-1][0]
    for li in range(len(levels) - 1, 0, -1):
        parent_feats = levels[li - 1][0]
        inv = levels[li][1]
        gathered = feat[inv]
        if len(levels) - li <= upcast_levels:
            feat = np.concatenate(
                [parent_feats.astype(np.float32),
                 gathered.astype(np.float32)], axis=-1)
        else:
            feat = gathered

    out = np.zeros((N, feat.shape[1]), np.float32)
    for i in range(N):
        if point_valid[i] and point2voxel[i] < M0:
            out[i] = feat[point2voxel[i]]
    return out
