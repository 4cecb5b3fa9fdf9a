"""Exact nearest-neighbour searches — the contracts the Stage-2 path uses.

Port of the contracts of geopurify_tpu/ops/knn.py, not of its TPU tiling
(Morton/Hilbert-tiled candidate pruning, packed top-k keys, gated fallback
tiles). Here a tiled brute force computes:
- exact squared-L2 distances (from coordinate differences on integer grids,
  so no matmul rounding — and no TF32 — can touch them);
- self excluded, +inf distance and index 0 in unfilled slots;
- the (d2, id) tie order of the JAX ``knn_self_grid`` (knn.py:243-264) and
  ``knn_search(selector='topk')``: the selection runs on one composite int64
  key ``d2 << shift | id``, so ties break by the lowest id, as they do there.

At M=65536 the brute force is 4.3e9 pairs, small work for the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

_TILE_ELEMS = 1 << 25   # pairs per distance tile (256 MiB of int64 keys)


# geopurify_tpu/ops/knn.py:191
def knn_self_grid(
    coords: torch.Tensor,     # [M, 3] integer voxel coords
    valid: torch.Tensor,      # [M] bool
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact self-kNN. Returns (dists [M, k] f32 with +inf padding,
    idx [M, k] int32, 0 in unfilled slots), neighbours in (d2, id) order.
    The JAX version's ``radius`` / ``num_candidates`` tune its TPU pruning
    and have no counterpart here."""
    M = coords.shape[0]
    dev = coords.device
    if coords.dtype.is_floating_point:
        raise TypeError("knn_self_grid takes integer voxel coordinates")
    c = coords.to(torch.int64)
    shift = max(int(M).bit_length(), 1)
    big = torch.iinfo(torch.int64).max
    ids = torch.arange(M, device=dev, dtype=torch.int64)
    T = max(1, min(M, _TILE_ELEMS // max(M, 1)))
    kk = min(k, M)
    dists = torch.full((M, k), float("inf"), dtype=torch.float32, device=dev)
    idx = torch.zeros((M, k), dtype=torch.int32, device=dev)
    for lo in range(0, M, T):
        hi = min(lo + T, M)
        q = c[lo:hi]
        d2 = (q[:, None, 0] - c[None, :, 0]) ** 2
        d2 += (q[:, None, 1] - c[None, :, 1]) ** 2
        d2 += (q[:, None, 2] - c[None, :, 2]) ** 2
        key = (d2 << shift) | ids[None, :]
        bad = (~valid)[None, :] | (ids[None, :] == ids[lo:hi, None])
        key = key.masked_fill_(bad, big)
        sel = torch.topk(key, kk, dim=1, largest=False, sorted=True).values
        fin = sel != big
        dists[lo:hi, :kk] = torch.where(
            fin, (sel >> shift).to(torch.float32), float("inf"))
        idx[lo:hi, :kk] = torch.where(
            fin, sel & ((1 << shift) - 1), 0).to(torch.int32)
    return dists, idx


def _nearest_donor_core(cf, donors_ok, need, query_tile):
    """Shared donor search (geopurify_tpu/ops/knn.py:794): for each needing
    row (ascending id) the nearest donor row, first-lowest donor id on equal
    distances. Distances use the JAX form q_sq + d_sq - 2 q.d in f32 so the
    choice between near-equal donors follows the same rounding.
    Returns (qpos [n_need] int64, donor [n_need] int64, n_donors)."""
    dpos = torch.nonzero(donors_ok, as_tuple=False)[:, 0]
    qpos = torch.nonzero(need, as_tuple=False)[:, 0]
    n_donors = int(dpos.shape[0])
    if n_donors == 0 or qpos.shape[0] == 0:
        # JAX: an all-+inf argmin row lands on donor slot 0 == row 0
        return qpos, torch.zeros_like(qpos), n_donors
    db = cf[dpos]
    db_sq = (db * db).sum(-1)
    donor = torch.empty_like(qpos)
    for lo in range(0, qpos.shape[0], query_tile):
        q = cf[qpos[lo:lo + query_tile]]
        q_sq = (q * q).sum(-1, keepdim=True)
        d2 = q_sq + db_sq[None, :] - 2.0 * (q @ db.T)
        donor[lo:lo + query_tile] = dpos[torch.argmin(d2, dim=1)]
    return qpos, donor, n_donors


def _donor_tile(n_donors: int) -> int:
    # [tile, n_donors] f32 distance blocks of at most 512 MiB
    return max(1, min(4096, (_TILE_ELEMS << 2) // max(n_donors, 1)))


# geopurify_tpu/ops/knn.py:881
def nearest_fill(
    features: torch.Tensor,   # [N, C]
    coords: torch.Tensor,     # [N, D]
    has_value: torch.Tensor,  # [N] bool — rows with real features
    valid: torch.Tensor,      # [N] bool — padding mask
) -> torch.Tensor:
    """Fill rows without features from their nearest row that has one."""
    cf = coords.to(torch.float32)
    donors_ok = has_value & valid
    qpos, donor, _ = _nearest_donor_core(
        cf, donors_ok, valid & ~has_value,
        _donor_tile(int(donors_ok.sum())))
    out = features.clone()
    out[qpos] = features[donor]
    return torch.where(has_value[:, None], features, out)


# geopurify_tpu/ops/knn.py:916
def nearest_donor(
    coords: torch.Tensor,     # [N, D]
    has_value: torch.Tensor,  # [N] bool — rows usable as donors
    valid: torch.Tensor,      # [N] bool — padding mask
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index form of ``nearest_fill``: (donor [N] int32, filled [N] bool);
    ``donor[i] == i`` where no donor was assigned."""
    N = coords.shape[0]
    cf = coords.to(torch.float32)
    donors_ok = has_value & valid
    qpos, donor, n_donors = _nearest_donor_core(
        cf, donors_ok, valid & ~has_value,
        _donor_tile(int(donors_ok.sum())))
    donor_full = torch.arange(N, dtype=torch.int32, device=coords.device)
    filled = torch.zeros((N,), dtype=torch.bool, device=coords.device)
    if n_donors > 0:
        donor_full[qpos] = donor.to(torch.int32)
        filled[qpos] = True
    return donor_full, filled
