"""Geometry-guided pooling — the Stage-2 smoothing core.

Port of geopurify_tpu/ops/pooling.py: an exact kNN-96 graph over voxel
coordinates, edge weights softmax_k(sharpen * cos(e_i, e_j)) from the
student embeddings, then ``num_iterations`` rounds of F <- A @ F. The
default ``banded`` mode reorders voxels along the Hilbert curve, splits A
into a banded-dense operator S (applied by kernel K1, ops/band.py) plus an
exact row-sorted residual of out-of-window edges, and falls back to the
fixed-degree gather when the residual overflows its capacity. Both paths
carry the features in bf16 between rounds, as the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from geopurify_tpu_torch.ops.band import banded_window_matmul
from geopurify_tpu_torch.ops.knn import knn_self_grid
from geopurify_tpu_torch.ops.morton import hilbert_code

RES_GROUP = 8


# geopurify_tpu/ops/pooling.py:24
def build_affinity_graph(
    embeddings: torch.Tensor,    # [M, E]
    voxel_coords: torch.Tensor,  # [M, 3] int
    valid: torch.Tensor,         # [M] bool
    k: int = 96,
    sharpen: float = 20.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neighbor_idx [M, k] int32, weights [M, k] f32 row-stochastic);
    invalid rows and unfilled kNN slots get zero weight. The JAX
    ``knn_mode`` / ``knn_radius`` / ``knn_candidates`` pick among TPU search
    strategies that all give these exact neighbours; the port has one."""
    M = embeddings.shape[0]
    dists, nbr = knn_self_grid(voxel_coords, valid, k=k)
    e = embeddings.to(torch.float32)
    e = e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True), min=1e-12)
    aff = torch.empty((M, k), dtype=torch.float32, device=e.device)
    nb = nbr.long()
    tile = 8192
    for lo in range(0, M, tile):
        hi = min(lo + tile, M)
        aff[lo:hi] = torch.bmm(e[nb[lo:hi]], e[lo:hi, :, None])[:, :, 0]
    filled = torch.isfinite(dists)
    aff = torch.where(filled, aff, float("-inf"))
    w = torch.nan_to_num(torch.softmax(aff * sharpen, dim=-1))
    w = torch.where(valid[:, None] & filled, w, 0.0)
    return nbr, w


# geopurify_tpu/ops/pooling.py:90
def fixed_degree_spmm(weights: torch.Tensor, nbr: torch.Tensor,
                      feats: torch.Tensor) -> torch.Tensor:
    """F'[i] = sum_k w[i, k] * F[nbr[i, k]] — row-tiled gather, f32 sum."""
    M, C = feats.shape
    K = nbr.shape[1]
    out = torch.empty_like(feats)
    tile = max(1, (1 << 26) // max(K * C, 1))
    nb = nbr.long()
    for lo in range(0, M, tile):
        hi = min(lo + tile, M)
        g = feats[nb[lo:hi]].to(torch.float32)          # [T, K, C]
        out[lo:hi] = torch.bmm(weights[lo:hi, None, :], g)[:, 0].to(feats.dtype)
    return out


# geopurify_tpu/ops/pooling.py:122
def iterate_pooling(weights, nbr, feats, num_iterations: int = 19,
                    compute_dtype=torch.bfloat16) -> torch.Tensor:
    """F <- A @ F ``num_iterations`` times, features carried in
    ``compute_dtype`` between rounds (the gather path)."""
    out = feats.to(compute_dtype)
    for _ in range(num_iterations):
        out = fixed_degree_spmm(weights, nbr, out)
    return out.to(feats.dtype)


# geopurify_tpu/ops/pooling.py:147
class BandedOperator(NamedTuple):
    S: torch.Tensor          # [M, band] compute dtype
    starts: torch.Tensor     # [n_t] int32 per-tile window starts
    res_row: torch.Tensor    # [R] int64 non-decreasing, padded with M
    res_col: torch.Tensor    # [R] int64
    res_w: torch.Tensor      # [R] f32
    n_dropped: torch.Tensor  # [] int64: edges beyond capacity
    grp_row: torch.Tensor    # [Rg] int64 non-decreasing, padded with M
    grp_col: torch.Tensor    # [Rg, RES_GROUP] int64
    grp_w: torch.Tensor      # [Rg, RES_GROUP] f32


# geopurify_tpu/ops/pooling.py:183
def _group_residual(res_row, res_col, res_w, M: int):
    """Pack the row-sorted residual into same-row groups of up to RES_GROUP
    edges; dead slots carry w=0. Returns (grp_row, grp_col, grp_w,
    n_edges_dropped)."""
    R = res_row.shape[0]
    G = RES_GROUP
    dev = res_row.device
    if R == 0:
        z = torch.zeros((0,), dtype=torch.int64, device=dev)
        return (z, torch.zeros((0, G), dtype=torch.int64, device=dev),
                torch.zeros((0, G), device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    Rg = min(R, M + -(-R // G))
    e = torch.arange(R, device=dev)
    live_e = res_row < M
    new_row = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                         res_row[1:] != res_row[:-1]])
    run_start = torch.cummax(torch.where(new_row, e, -1), dim=0).values
    pos = e - run_start
    new_grp = new_row | (pos % G == 0)
    gid = torch.cumsum(new_grp.long(), 0) - 1
    slot = torch.where(new_grp & (gid < Rg), gid, Rg)
    first = torch.full((Rg + 1,), R - 1, dtype=torch.int64, device=dev)
    first[slot] = e                   # slot Rg is a trash row, sliced off
    first = first[:Rg]
    n_grp_live = (new_grp & live_e).sum()
    rg_ids = torch.arange(Rg, device=dev)
    g_live = rg_ids < torch.clamp(n_grp_live, max=Rg)
    grp_row = torch.where(g_live, res_row[first], M)
    idx_raw = first[:, None] + torch.arange(G, device=dev)[None]
    idx = torch.clamp(idx_raw, max=R - 1)
    ok = g_live[:, None] & (idx_raw < R) & (gid[idx] == rg_ids[:, None])
    grp_col = torch.where(ok, res_col[idx], 0)
    grp_w = torch.where(ok, res_w[idx], 0.0)
    n_edges_dropped = (live_e & (gid >= Rg)).sum()
    return grp_row, grp_col, grp_w, n_edges_dropped


# geopurify_tpu/ops/pooling.py:247
def build_banded_operator(
    weights: torch.Tensor,   # [M, K] f32
    nbr: torch.Tensor,       # [M, K] int
    band: int = 12288,
    row_tile: int = 2048,
    max_residual: int = 262144,
    dtype=torch.bfloat16,
) -> BandedOperator:
    """Banded-dense S [M, band] (column j of row i is neighbour
    starts[tile(i)] + j) plus the exact row-sorted residual of every live
    out-of-window edge, in row-major (row, tap) edge order. The JAX
    ``assume_unique_neighbors=True`` branch with adaptive window starts (the
    one the path takes): a row's neighbours must be distinct, as exact kNN
    rows are. S is written by one direct scatter of the weights in
    ``dtype`` — the values the JAX package writes through its u16
    bit-pattern scatter (:341-392)."""
    M, K = weights.shape
    dev = weights.device
    n_t = -(-M // row_tile)
    rows = torch.arange(M, device=dev)
    tile = rows // row_tile
    nbr = nbr.long()
    dead = weights == 0.0
    t_center = torch.arange(n_t, device=dev) * row_tile + row_tile // 2
    if M > band:
        center = tile * row_tile + row_tile // 2
        devn = torch.clamp(nbr - center[:, None], -band, band)
        live = (~dead).to(torch.float32)
        pad = n_t * row_tile - M
        dev_p = torch.nn.functional.pad(devn * live, (0, 0, 0, pad))
        live_p = torch.nn.functional.pad(live, (0, 0, 0, pad))
        t_dev = dev_p.reshape(n_t, -1).sum(1) / torch.clamp(
            live_p.reshape(n_t, -1).sum(1), min=1.0)
        starts = t_center + t_dev.to(torch.int32) - band // 2
    else:
        starts = t_center - band // 2
    starts = torch.clamp(starts, 0, max(M - band, 0))
    # multiples of 8: the TPU kernel's DMA row-offset contract (:306-312),
    # kept so that S and the residual match the JAX operator exactly
    starts = (starts // 8) * 8
    ws = starts[tile]
    li = nbr - ws[:, None]
    in_band = (li >= 0) & (li < band) & ~dead

    S = torch.zeros((M, band), dtype=dtype, device=dev)
    r_ib, k_ib = torch.nonzero(in_band, as_tuple=True)
    S[r_ib, li[r_ib, k_ib]] = weights[r_ib, k_ib].to(dtype)

    out_mask = (~in_band & ~dead).reshape(-1)
    n_out = out_mask.sum()
    R = max_residual
    E = torch.nonzero(out_mask, as_tuple=False)[:R, 0]       # row-major order
    n_live = E.shape[0]
    res_row = torch.full((R,), M, dtype=torch.int64, device=dev)
    res_col = torch.zeros((R,), dtype=torch.int64, device=dev)
    res_w = torch.zeros((R,), dtype=torch.float32, device=dev)
    res_row[:n_live] = E // K
    res_col[:n_live] = nbr.reshape(-1)[E]
    res_w[:n_live] = weights.reshape(-1)[E]
    grp_row, grp_col, grp_w, grp_drop = _group_residual(res_row, res_col, res_w, M)
    n_dropped = torch.clamp(n_out - R, min=0) + grp_drop
    return BandedOperator(S, starts.to(torch.int32), res_row, res_col, res_w,
                          n_dropped, grp_row, grp_col, grp_w)


# geopurify_tpu/ops/pooling.py:428
def iterate_pooling_banded(op: BandedOperator, feats: torch.Tensor,
                           num_iterations: int = 19, band: int = 12288,
                           row_tile: int = 2048) -> torch.Tensor:
    """``num_iterations`` rounds of F <- S-window matmul (K1) + grouped
    residual. Each round casts its input to S's dtype and its output back,
    as pooling.py:482-533 does."""
    S = op.S
    M, C = feats.shape
    R = op.res_col.shape[0]
    Rg_cap = op.grp_row.shape[0]
    head = min(Rg_cap, max(R // RES_GROUP, 1))
    # the JAX lax.cond on the headroom tail, decided once per scene
    tail = Rg_cap > head and bool(op.grp_row[head] < M)
    parts = [(op.grp_col[:head], op.grp_w[:head], op.grp_row[:head])]
    if tail:
        parts.append((op.grp_col[head:], op.grp_w[head:], op.grp_row[head:]))

    # the residual's [groups, G, C] f32 gather in chunks of at most 2^27
    # elements (512 MiB): the preset residual (2^21 edges) at C = 512 would
    # gather 4 GiB a round at once
    chunk = max(1, (1 << 27) // (RES_GROUP * C))
    f = feats.to(S.dtype)
    for _ in range(num_iterations):
        banded = banded_window_matmul(S, op.starts, f, band=band, row_tile=row_tile)
        # segment_sum of every chunk of every part into one accumulator;
        # row M takes the padding groups (row id M)
        resid = torch.zeros((M + 1, C), dtype=torch.float32, device=f.device)
        for cols, w, grow in parts if Rg_cap else ():
            for lo in range(0, cols.shape[0], chunk):
                g = f[cols[lo:lo + chunk]].to(torch.float32)            # [n, G, C]
                seg = torch.bmm(w[lo:lo + chunk, None, :], g)[:, 0]    # [n, C]
                resid.index_add_(0, grow[lo:lo + chunk].clamp(max=M), seg)
        f = (banded + resid[:M]).to(S.dtype)
    return f.to(feats.dtype)


# geopurify_tpu/ops/pooling.py:542
def geometry_guided_pooling(
    embeddings: torch.Tensor,    # [M, E]
    feats: torch.Tensor,         # [M, C]
    voxel_coords: torch.Tensor,  # [M, 3]
    valid: torch.Tensor,         # [M]
    k: int = 96,
    sharpen: float = 20.0,
    num_iterations: int = 19,
    spmm_mode: str = "banded",
    band: int = 12288,
    max_residual: int = 262144,
) -> Tuple[torch.Tensor, int]:
    """Graph build + iterated aggregation. Returns (smoothed feats [M, C],
    band overflow: edges past the residual capacity; > 0 means the exact
    gather path ran instead of the banded one)."""
    nbr, w = build_affinity_graph(embeddings, voxel_coords, valid, k=k,
                                  sharpen=sharpen)
    M = feats.shape[0]
    if spmm_mode == "banded" and M > band:
        code = torch.where(valid, hilbert_code(torch.clamp(voxel_coords, min=0)),
                           2 ** 30)
        order = torch.argsort(code, stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(M, device=order.device)
        w_h = w[order]
        nbr_h = rank[nbr.long()[order]]
        feats_h = feats[order]
        op = build_banded_operator(w_h, nbr_h, band=band, max_residual=max_residual)
        # the JAX lax.cond on n_dropped (:595-603): one host read per scene
        n_dropped = int(op.n_dropped)
        if n_dropped > 0:
            del op
            out_h = iterate_pooling(w_h, nbr_h, feats_h, num_iterations)
        else:
            out_h = iterate_pooling_banded(op, feats_h, num_iterations, band=band)
        return out_h[rank], n_dropped
    return iterate_pooling(w, nbr, feats, num_iterations), 0
