"""Geometry-guided pooling of the plain reference: the exact kNN-96 graph by
brute force, edge weights softmax_k(sharpen * cos(e_i, e_j)) from the
student's embeddings, and ``num_iterations`` rounds of F <- A @ F by the
fixed-degree gather in f32. A frozen copy of the port's ``ops/pooling.py``
gather path; the port's banded operator (kernel K1) and its residual
compute the same rounds from a Hilbert-ordered band.
"""

from __future__ import annotations

from typing import Tuple

import torch

from perfbench.reference.knn import knn_search


def geometry_guided_pooling(embeddings, feats, voxel_coords, valid, k: int = 96,
                            sharpen: float = 20.0, num_iterations: int = 19) -> torch.Tensor:
    """Graph build + ``num_iterations`` rounds; returns the smoothed [M, C]."""
    nbr, w = build_affinity_graph(embeddings, voxel_coords, valid, k=k, sharpen=sharpen)
    return iterate_pooling(w, nbr, feats.to(torch.float32), num_iterations)


# geopurify_tpu/ops/pooling.py:24
def build_affinity_graph(
    embeddings: torch.Tensor,    # [M, E]
    voxel_coords: torch.Tensor,  # [M, 3] int
    valid: torch.Tensor,         # [M] bool
    k: int = 96,
    sharpen: float = 20.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neighbor_idx [M, k] int32, weights [M, k] f32 row-stochastic);
    invalid rows and unfilled kNN slots get zero weight. The kNN is the
    brute force over the integer voxel coordinates."""
    M = embeddings.shape[0]
    ids = torch.arange(M, device=voxel_coords.device)
    dists, nbr = knn_search(voxel_coords, voxel_coords, valid, k=k, query_ids=ids,
                            exclude_identical_index=True)
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
                    compute_dtype=torch.float32) -> torch.Tensor:
    """F <- A @ F ``num_iterations`` times, features carried in
    ``compute_dtype`` between rounds (f32 here; the port carries bf16)."""
    out = feats.to(compute_dtype)
    for _ in range(num_iterations):
        out = fixed_degree_spmm(weights, nbr, out)
    return out.to(feats.dtype)
