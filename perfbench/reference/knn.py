"""Exhaustive nearest-neighbour searches of the plain reference: a frozen
copy of the brute-force parts of the port's ``ops/knn.py`` (``knn_search``
and the donor fills). The port prunes its searches by a
grid and certifies them; these compare every pair. Ties break by the
lowest id, as there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_TILE_ELEMS = 1 << 25    # pairs per brute-force distance tile (256 MiB of int64 keys)
_INT64_MAX = torch.iinfo(torch.int64).max


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full f32 on every device (TF32 off for the call), as the
    JAX version's ``Precision.HIGHEST``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


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


def _diff_d2(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Squared distances from coordinate differences, one axis after the
    other: ``q`` [..., T, 1, D] against ``d`` [..., 1, C, D]. Every search of
    float coords here forms d2 with this one expression (no matmul, so no
    TF32), so a pair's distance is the same bits on every route."""
    d2 = (q[..., 0] - d[..., 0]) ** 2
    for a in range(1, q.shape[-1]):
        d2 += (q[..., a] - d[..., a]) ** 2
    return d2


# geopurify_tpu/ops/knn.py:39
def knn_search(
    queries: torch.Tensor,        # [Q, D]
    db: torch.Tensor,             # [N, D]
    db_valid: torch.Tensor,       # [N] bool
    k: int,
    query_ids: Optional[torch.Tensor] = None,   # [Q] global ids (self-exclusion)
    exclude_identical_index: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN by squared L2, a query-tiled brute force: (dists [Q, k] f32
    with +inf padding, idx [Q, k] int32, 0 in unfilled slots), in (d2, id)
    order. With ``exclude_identical_index`` the database row whose index
    equals the query's id is skipped.

    Integer coords give exact int64 distances (keys ``d2 << shift | id``);
    float coords give f32 distances from coordinate differences (the JAX
    version's form up to D = 4; above, its ``|q|^2 + |x|^2 - 2 q.x`` form
    agrees up to rounding). Each query tile is one ``torch.topk`` over
    full-row (d2, id) keys: the order of the JAX version's
    ``selector='topk'`` (its default ``'approx'`` gives the same distances,
    ties in another order). Unlike the JAX version, unfilled slots carry
    index 0."""
    Q = queries.shape[0]
    N = db.shape[0]
    dev = queries.device
    dists = torch.full((Q, k), float("inf"), dtype=torch.float32, device=dev)
    idx = torch.zeros((Q, k), dtype=torch.int32, device=dev)
    if Q == 0 or N == 0:
        return dists, idx
    kk = min(k, N)
    cols = torch.arange(N, device=dev, dtype=torch.int64)
    qids = query_ids.to(torch.int64) if query_ids is not None else None
    exclude = exclude_identical_index and qids is not None
    T = max(1, min(Q, _TILE_ELEMS // N))
    integer = not (queries.dtype.is_floating_point or db.dtype.is_floating_point)
    if integer:
        c = db.to(torch.int64)
        qc = queries.to(torch.int64)
        shift = max(int(N).bit_length(), 1)
    else:
        c = db.to(torch.float32)
        qc = queries.to(torch.float32)
    for lo in range(0, Q, T):
        hi = min(lo + T, Q)
        q = qc[lo:hi]
        bad = ~db_valid[None, :]
        if exclude:
            bad = bad | (cols[None, :] == qids[lo:hi, None])
        d2 = _diff_d2(q[:, None, :], c[None, :, :])
        if integer:
            key = (d2 << shift) | cols[None, :]
            key = key.masked_fill_(bad, _INT64_MAX)
            sel = torch.topk(key, kk, dim=1, largest=False, sorted=True).values
            fin = sel != _INT64_MAX
            dists[lo:hi, :kk] = torch.where(fin, (sel >> shift).to(torch.float32),
                                            float("inf"))
            idx[lo:hi, :kk] = torch.where(fin, sel & ((1 << shift) - 1), 0).to(torch.int32)
            continue
        d, i = _chunked_topk_min(d2.masked_fill_(bad, float("inf")), kk)
        dists[lo:hi, :kk] = d
        idx[lo:hi, :kk] = torch.where(torch.isfinite(d), i, 0).to(torch.int32)
    return dists, idx


# ---------------------------------------------------------------------------
# donor fills
# ---------------------------------------------------------------------------

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
        d2 = q_sq + db_sq[None, :] - 2.0 * _matmul_f32(q, db.T)
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
