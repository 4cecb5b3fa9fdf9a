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


def _ordered_key(x: torch.Tensor) -> torch.Tensor:
    """int64 keys with the order of the f32 values ``x`` in the high 32 bits
    (the sign-magnitude bits flipped into two's-complement order), so that
    ``key << 32 | column`` sorts by (value, column)."""
    i = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i) << 32


# geopurify_tpu/ops/knn.py:150
def _chunked_topk_min(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest of each row of ``d2`` [T, C] f32, ascending, ties
    broken by the lowest column: (values [T, k], columns [T, k] int64). One
    ``torch.topk`` over (value, column) int64 keys; the JAX version's chunked
    top-k union and ``approx_min_k`` are TPU speed paths to the same set."""
    C = d2.shape[1]
    cols = torch.arange(C, device=d2.device, dtype=torch.int64)
    key = _ordered_key(d2) | cols[None, :]
    sel = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    col = sel & 0xFFFFFFFF
    return torch.gather(d2, 1, col), col


# geopurify_tpu/ops/knn.py:561
def knn_anchors_grid(
    points: torch.Tensor,      # [N, 3] float coords
    valid: torch.Tensor,       # [N] bool
    anchor_idx: torch.Tensor,  # [A] query subset (self excluded by id)
    k: int,
    radius: float = 0.3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of the anchors over float coords: (d2 [A, k] f32, +inf in
    unfilled slots; idx [A, k] int32, 0 there), in (d2, id) order. The
    contract of the JAX version (knn.py:577-588): equal to a brute-force
    search of ``points[anchor_idx]`` over ``points`` with the anchor's own id
    excluded, up to equal-distance ties. Here an anchor-tiled brute force
    computes d2 from coordinate differences in f32 (no matmul, so no TF32);
    ``radius`` tunes the JAX version's pruning and has no counterpart."""
    N = points.shape[0]
    A = anchor_idx.shape[0]
    dev = points.device
    cf = points.to(torch.float32)
    aidx = anchor_idx.to(torch.int64)
    ids = torch.arange(N, device=dev, dtype=torch.int64)
    kk = min(k, N)
    T = max(1, min(A, _TILE_ELEMS // max(N, 1)))
    dists = torch.full((A, k), float("inf"), dtype=torch.float32, device=dev)
    idx = torch.zeros((A, k), dtype=torch.int32, device=dev)
    for lo in range(0, A, T):
        qid = aidx[lo:lo + T]
        q = cf[qid]
        d2 = (q[:, None, 0] - cf[None, :, 0]) ** 2
        d2 += (q[:, None, 1] - cf[None, :, 1]) ** 2
        d2 += (q[:, None, 2] - cf[None, :, 2]) ** 2
        bad = (~valid)[None, :] | (ids[None, :] == qid[:, None])
        d, i = _chunked_topk_min(d2.masked_fill_(bad, float("inf")), kk)
        fin = torch.isfinite(d)
        dists[lo:lo + T, :kk] = d
        idx[lo:lo + T, :kk] = torch.where(fin, i, 0).to(torch.int32)
    return dists, idx
