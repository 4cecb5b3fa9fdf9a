"""Exact nearest-neighbour searches: the Stage-2 graph's kNN-96, the Stage-1
anchors' spatial kNN and the unseen-point donor fills.

Port of geopurify_tpu/ops/knn.py, its algorithms included:
- ``knn_search`` / ``argmin_search``: tiled brute force (the
  ``knn_mode='full'`` and ``spatial_method='brute'`` routes, and the exact
  full-row recompute of the pruned searches);
- ``knn_self_grid`` / ``knn_anchors_grid`` / ``nearest_fill_grid``: queries
  in Hilbert order, in tiles; each tile's candidates are the database rows
  inside the bounding box of its queries dilated by a radius; a query whose
  k-th candidate lies within the radius provably saw its true neighbours
  (the certificate); every other query, and every query of a tile whose
  candidates exceed the budget, is recomputed against the full row.

The results are those of the brute force, ties included: every selection
runs on one composite int64 key (d2, id), so equal distances break by the
lowest id, as the JAX ``knn_self_grid`` (knn.py:243-264) and
``knn_search(selector='topk')`` do. The TPU mechanics of the JAX version
(``lax.map`` over supertiles, ``lax.cond`` branches, f32 packed keys, block
compaction) get around fixed shapes and per-index scatter cost; here each
tile's candidates are an x-sorted window of the database masked by y and
z, and many tiles go through one padded [G, T, C] key block and one
``torch.topk``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from geopurify_tpu_torch.ops.morton import hilbert_code
from geopurify_tpu_torch.utils import profiling

_TILE_ELEMS = 1 << 25    # pairs per brute-force distance tile (256 MiB of int64 keys)
_BLOCK_ELEMS = 1 << 25   # pairs per pruned key block: [G, T, C] of at most 256 MiB
_FLAT_ELEMS = 1 << 23    # window rows a candidate-selection chunk tests at once
_INT32_MAX = torch.iinfo(torch.int32).max
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


def _key_value(key: torch.Tensor) -> torch.Tensor:
    """The f32 values of ``_ordered_key`` keys (the inverse map)."""
    i = key >> 32
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i).to(torch.int32).view(torch.float32)


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


# geopurify_tpu/ops/knn.py:744
def argmin_search(
    queries: torch.Tensor,        # [Q, D]
    db: torch.Tensor,             # [N, D]
    db_valid: torch.Tensor,       # [N] bool
) -> torch.Tensor:
    """Index [Q] int32 of the nearest valid db row per query, distances in
    the JAX ``|q|^2 + |x|^2 - 2 q.x`` f32 form, the first lowest index on
    equal distances (0 where no row is valid)."""
    Q = queries.shape[0]
    N = db.shape[0]
    out = torch.zeros((Q,), dtype=torch.int32, device=queries.device)
    if Q == 0 or N == 0:
        return out
    q32 = queries.to(torch.float32)
    d = db.to(torch.float32)
    d_sq = (d * d).sum(-1)
    T = max(1, min(Q, _TILE_ELEMS // N))
    for lo in range(0, Q, T):
        q = q32[lo:lo + T]
        d2 = (q * q).sum(-1, keepdim=True) + d_sq[None, :] - 2.0 * _matmul_f32(q, d.T)
        d2 = d2.masked_fill_(~db_valid[None, :], float("inf"))
        out[lo:lo + T] = torch.argmin(d2, dim=1).to(torch.int32)
    return out


# ---------------------------------------------------------------------------
# the pruned searches: tiles, boxes, candidates
# ---------------------------------------------------------------------------

def _hilbert_tiles(code: torch.Tensor, live: torch.Tensor, T: int):
    """The ``live`` rows sorted by ``code`` (stable), cut into tiles of
    ``T``: (rows [n_t, T] int64, -1 past the last live row; n_live)."""
    n_live = int(profiling.host_read(live.sum()))
    big = torch.iinfo(code.dtype).max
    order = torch.argsort(torch.where(live, code, big), stable=True)[:n_live]
    n_t = -(-n_live // T)
    rows = torch.full((n_t * T,), -1, dtype=torch.int64, device=code.device)
    rows[:n_live] = order
    return rows.reshape(n_t, T), n_live


def _tile_boxes(xyz: torch.Tensor, rows: torch.Tensor, pad):
    """Per-tile (lo, hi) [n_t, 3] of the coords ``xyz`` at the tile's live
    rows (``rows`` >= 0), each dilated by ``pad`` on both sides."""
    q = xyz[rows.clamp(min=0)]
    live = (rows >= 0)[:, :, None]
    if xyz.dtype.is_floating_point:
        top = torch.tensor(float("inf"), dtype=xyz.dtype, device=xyz.device)
    else:
        top = torch.tensor(torch.iinfo(xyz.dtype).max, dtype=xyz.dtype, device=xyz.device)
    lo = torch.where(live, q, top).amin(1) - pad
    hi = torch.where(live, q, -top).amax(1) + pad
    return lo, hi


def _count_lower_bound(p: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                       cells: int = 32) -> torch.Tensor:
    """A lower bound [n_t] int64 on how many of the points ``p`` [n, 3] lie
    in each box [lo, hi]: the points of a cells^3 occupancy grid over their
    extent, summed (one summed-volume table) over the cells that lie inside
    the box with one cell to spare on every side, so that no rounding of a
    point's cell can count a point outside the box."""
    p, lo, hi = p.double(), lo.double(), hi.double()
    o = p.amin(0)
    cs = torch.clamp(p.amax(0) - o, min=1e-9) / cells
    ci = torch.clamp(((p - o) / cs).floor(), 0, cells - 1).long()
    h = torch.bincount((ci[:, 0] * cells + ci[:, 1]) * cells + ci[:, 2],
                       minlength=cells ** 3).reshape(cells, cells, cells)
    vol = torch.zeros((cells + 1,) * 3, dtype=torch.int64, device=p.device)
    vol[1:, 1:, 1:] = h.cumsum(0).cumsum(1).cumsum(2)
    a = torch.clamp(((lo - o) / cs).ceil() + 1, 0, cells).long()
    b = torch.maximum(torch.clamp(((hi - o) / cs).floor() - 1, 0, cells).long(), a)
    out = torch.zeros((lo.shape[0],), dtype=torch.int64, device=p.device)
    for corner in range(8):
        s = [b[:, d] if (corner >> d) & 1 else a[:, d] for d in range(3)]
        sign = -1 if (3 - bin(corner).count("1")) % 2 else 1
        out += sign * vol[s[0], s[1], s[2]]
    return out


def _box_candidates(xyz: torch.Tensor, rows: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor, budget: int):
    """For each tile box [lo, hi] (inclusive, [n_t, 3]), the rows of
    ``rows`` whose ``xyz`` lies inside it: (cand [n_t, budget] int64, the
    first count slots filled and -1 after, all -1 for a tile over budget;
    count [n_t] int64, the in-box count, or for a tile over budget possibly
    only a lower bound above ``budget``). Tiles that ``_count_lower_bound``
    already puts over budget are not searched. For the others the rows are
    sorted by x once; each box's x-range is then a contiguous window
    (``searchsorted``), masked by y and z and counted with a ``cumsum``,
    the windows of many tiles flattened into one pass of at most
    ``_FLAT_ELEMS`` rows; only the tiles within budget are compacted into
    ``cand``."""
    dev = xyz.device
    n_t = lo.shape[0]
    cand = torch.full((n_t, budget), -1, dtype=torch.int64, device=dev)
    if n_t == 0 or rows.numel() == 0:
        return cand, torch.zeros((n_t,), dtype=torch.int64, device=dev)
    p = xyz[rows]
    count = _count_lower_bound(p, lo, hi)
    live = count <= budget
    if not bool(profiling.host_read(live.any())):
        return cand, count
    o = torch.argsort(p[:, 0], stable=True)
    rows, p = rows[o], p[o]
    xs, ys, zs = (p[:, a].contiguous() for a in range(3))
    ws = torch.searchsorted(xs, lo[:, 0].contiguous())
    wl = (torch.searchsorted(xs, hi[:, 0].contiguous(), right=True) - ws).clamp_(min=0)
    wl = wl * live
    wl_h = profiling.host_read(wl).numpy()
    ends = np.cumsum(wl_h)
    starts = ends - wl_h
    cid = starts // _FLAT_ELEMS
    bounds = [0, *(np.flatnonzero(np.diff(cid)) + 1).tolist(), n_t]
    for a, b in zip(bounds[:-1], bounds[1:]):
        tot = int(ends[b - 1] - starts[a])
        if tot == 0:
            continue
        L = wl[a:b]
        tile = torch.repeat_interleave(torch.arange(a, b, device=dev), L, output_size=tot)
        fstart = torch.cumsum(L, 0) - L
        pos = ws[tile] + torch.arange(tot, device=dev) - fstart[tile - a]
        inb = ((ys[pos] >= lo[tile, 1]) & (ys[pos] <= hi[tile, 1])
               & (zs[pos] >= lo[tile, 2]) & (zs[pos] <= hi[tile, 2]))
        cs0 = torch.zeros((tot + 1,), dtype=torch.int64, device=dev)
        cs0[1:] = torch.cumsum(inb, 0)
        n_in = cs0[fstart + L] - cs0[fstart]
        count[a:b] = torch.where(live[a:b], n_in, count[a:b])
        sel = profiling.nonzero(inb & (n_in <= budget)[tile - a])[:, 0]
        ts = tile[sel]
        cand[ts, cs0[sel] - cs0[fstart[ts - a]]] = rows[pos[sel]]
    return cand, count


def _blocks(count: np.ndarray, eligible: np.ndarray, T: int):
    """Batches of tiles for the key blocks: the eligible tiles by candidate
    count, largest first, each batch of G tiles padded to its first tile's
    count C with G * T * C <= ``_BLOCK_ELEMS``. Yields (tiles, C)."""
    tiles = np.flatnonzero(eligible)
    tiles = tiles[np.argsort(-count[tiles], kind="stable")]
    i = 0
    while i < tiles.shape[0]:
        width = int(count[tiles[i]])
        G = max(1, _BLOCK_ELEMS // (T * width))
        yield tiles[i:i + G], width
        i += G


def _place(out_d, out_i, rows, d, i):
    """Write result rows at ``rows`` (unique)."""
    out_d[rows] = d
    out_i[rows] = i


# geopurify_tpu/ops/knn.py:191
def knn_self_grid(
    coords: torch.Tensor,     # [M, 3] integer voxel coords
    valid: torch.Tensor,      # [M] bool
    k: int,
    radius: int = 12,
    num_candidates: int = 4096,
    query_tile: int = 128,
    tiles_per_call: int = 16,
    selector: str = "approx",
    compact_block: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact self-kNN over integer voxel coords by Hilbert-tiled box pruning
    with a per-query certificate and exact full-row recompute (JAX
    docstring, knn.py:202-233):

    - valid queries in Hilbert order, in tiles of ``query_tile``;
    - a tile's candidates are the valid rows inside the bounding box of its
      queries dilated by ``radius``; a tile with more than
      ``num_candidates`` of them certifies nothing;
    - a query is certified when its k-th candidate distance is <= radius^2:
      every row within ``radius`` is in the box, so the candidates hold its
      true k nearest, ties included;
    - every uncertified valid query is recomputed by ``knn_search`` against
      the full row; results come back in the caller's order.

    Returns (dists [M, k] f32 with +inf padding, idx [M, k] int32, 0 in
    unfilled slots), self excluded, in (d2, id) order: on every valid row
    bit-equal to ``knn_search(coords, coords, valid, k, query_ids=arange(M),
    exclude_identical_index=True)``. Invalid rows are not queries: they come
    back unfilled (the full route fills them; the affinity graph gives them
    zero weight either way).

    ``tiles_per_call``, ``selector`` and ``compact_block`` are the JAX
    version's TPU knobs (tiles a top-k call, its top-k implementation,
    block compaction) and change nothing here: its keys carry the id, so
    every selector gives this one (d2, id) order. An unknown ``selector``
    raises, as no route here could honour it."""
    if selector not in ("approx", "topk"):
        raise ValueError(f"unknown selector {selector!r}")
    dists, idx, _ = _knn_self_grid(coords, valid, k, radius, num_candidates, query_tile)
    return dists, idx


def _knn_self_grid(coords, valid, k: int, radius: int = 12, num_candidates: int = 4096,
                   query_tile: int = 128):
    """``knn_self_grid`` and its counts: (dists, idx, stats) with stats the
    valid queries, those that failed the certificate (recomputed), the
    tiles and those over their candidate budget."""
    if coords.dtype.is_floating_point:
        raise TypeError("knn_self_grid takes integer voxel coordinates")
    M = coords.shape[0]
    dev = coords.device
    T, C, r = query_tile, min(num_candidates, max(M, 1)), int(radius)
    dists = torch.full((M, k), float("inf"), dtype=torch.float32, device=dev)
    idx = torch.zeros((M, k), dtype=torch.int32, device=dev)
    c = coords.to(torch.int32)
    code = hilbert_code(torch.clamp(c, min=0))
    qt, nv = _hilbert_tiles(code, valid, T)
    n_t = qt.shape[0]
    stats = dict(queries=nv, failed=0, tiles=n_t, overflow_tiles=0)
    if nv == 0 or k == 0:
        return dists, idx, stats
    lo, hi = _tile_boxes(c, qt, r)
    rows = profiling.nonzero(valid)[:, 0]
    cand, count = _box_candidates(c, rows, lo, hi, C)
    count_h = profiling.host_read(count).numpy()
    over = count_h > C
    stats["overflow_tiles"] = int(over.sum())

    # keys (min(d2, r^2 + 1) << shift) | id: each |difference| capped at r+1
    # first, so nothing overflows and any d2 past r^2 lands on the cap; int32
    # wherever the key fits, int64 beyond
    shift = max(int(M - 1).bit_length(), 1)
    cap = r * r + 1
    kdt = torch.int32 if (cap + 1) << shift < _INT32_MAX else torch.int64
    big = _INT32_MAX if kdt == torch.int32 else _INT64_MAX
    c_k = c.to(kdt)
    done = torch.zeros((M,), dtype=torch.bool, device=dev)
    for tiles, width in _blocks(count_h, ~over & (count_h > k), T):
        tb = torch.as_tensor(tiles, device=dev)
        ci = cand[tb, :width]                                  # [G, W]
        qi = qt[tb]                                            # [G, T]
        cc = c_k[ci.clamp(min=0)][:, None, :, :]
        qc = c_k[qi.clamp(min=0)][:, :, None, :]
        d2 = None
        for a in range(3):
            t = (qc[..., a] - cc[..., a]).abs_().clamp_(max=r + 1)
            d2 = t.mul_(t) if d2 is None else d2.add_(t.mul_(t))
        key = (d2.clamp_(max=cap) << shift) | ci.to(kdt)[:, None, :]
        key.masked_fill_((ci < 0)[:, None, :] | (ci[:, None, :] == qi[:, :, None]), big)
        top = torch.topk(key.reshape(-1, width), k, dim=1, largest=False,
                         sorted=True).values                   # [G*T, k]
        d_k = top[:, k - 1] >> shift
        ok = (top[:, k - 1] != big) & (d_k <= r * r) & (qi.reshape(-1) >= 0)
        q_ok = profiling.masked(qi.reshape(-1), ok)
        top = profiling.masked(top, ok)
        _place(dists, idx, q_ok, (top >> shift).to(torch.float32),
               (top & ((1 << shift) - 1)).to(torch.int32))
        done[q_ok] = True
    failed = profiling.nonzero(valid & ~done)[:, 0]
    stats["failed"] = int(failed.shape[0])
    profiling.count("knn_self.queries", nv)
    profiling.count("knn_self.failed", stats["failed"])
    if stats["failed"]:
        d_f, i_f = knn_search(c[failed], c, valid, k, query_ids=failed,
                              exclude_identical_index=True)
        _place(dists, idx, failed, d_f, i_f)
    return dists, idx, stats


# geopurify_tpu/ops/knn.py:561
def knn_anchors_grid(
    points: torch.Tensor,      # [N, 3] float coords
    valid: torch.Tensor,       # [N] bool
    anchor_idx: torch.Tensor,  # [A] query subset (self excluded by id)
    k: int,
    radius: float = 0.3,
    num_candidates: int = 4096,
    query_tile: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of the anchors over float coords, ``knn_self_grid``'s
    machinery (JAX knn.py:572-588): anchors in Hilbert order over a
    radius-sized grid, tiles of ``query_tile``, candidates in the tile box
    dilated by ``radius``, the certificate, and ``knn_search`` for every
    uncertified valid anchor. Returns (d2 [A, k] f32, +inf in unfilled
    slots; idx [A, k] int32, 0 there) in (d2, id) order, with d2 formed from
    coordinate differences in f32: on every valid anchor bit-equal to
    ``knn_search(points[anchor_idx], points, valid, k, query_ids=anchor_idx,
    exclude_identical_index=True)``; anchors on invalid points come back
    unfilled.

    Float rounding is kept out of the certificate. The box test runs in
    f64, where f32 coords and radius subtract exactly, so a row outside the
    box differs from every query of the tile by more than ``radius`` on
    some axis; its computed d2 is then at least fl(radius^2) (rounding is
    monotone). The certificate is strict, d_k < fl(radius^2): such a row
    can neither beat nor tie the k-th candidate."""
    d, i, _ = _knn_anchors_grid(points, valid, anchor_idx, k, radius, num_candidates,
                                query_tile)
    return d, i


def _knn_anchors_grid(points, valid, anchor_idx, k: int, radius: float = 0.3,
                      num_candidates: int = 4096, query_tile: int = 128):
    """``knn_anchors_grid`` and its counts (see ``_knn_self_grid``)."""
    N = points.shape[0]
    A = anchor_idx.shape[0]
    dev = points.device
    T, C = query_tile, min(num_candidates, max(N, 1))
    dists = torch.full((A, k), float("inf"), dtype=torch.float32, device=dev)
    idx = torch.zeros((A, k), dtype=torch.int32, device=dev)
    cf = points.to(torch.float32)
    aidx = anchor_idx.to(torch.int64)
    a_valid = valid[aidx]
    r32 = torch.tensor(radius, dtype=torch.float32)
    r2 = float(r32 * r32)
    # Hilbert order over a radius-quantized grid (ordering only)
    lo_all = torch.where(valid[:, None], cf, float("inf")).amin(0)
    q_all = cf[aidx]
    qcode = torch.clamp((q_all - lo_all[None]) / max(float(r32), 1e-6), 0, 1023)
    code = hilbert_code(torch.nan_to_num(qcode).to(torch.int32))
    qt, nq = _hilbert_tiles(code, a_valid, T)              # anchor slots
    n_t = qt.shape[0]
    stats = dict(queries=nq, failed=0, tiles=n_t, overflow_tiles=0)
    if nq == 0 or k == 0:
        return dists, idx, stats
    qid = torch.where(qt >= 0, aidx[qt.clamp(min=0)], -1)    # [n_t, T] point ids
    c64 = cf.to(torch.float64)
    lo, hi = _tile_boxes(c64, qid, float(r32))
    rows = profiling.nonzero(valid)[:, 0]
    cand, count = _box_candidates(c64, rows, lo, hi, C)
    count_h = profiling.host_read(count).numpy()
    over = count_h > C
    stats["overflow_tiles"] = int(over.sum())
    done = torch.zeros((A,), dtype=torch.bool, device=dev)
    for tiles, width in _blocks(count_h, ~over & (count_h > k), T):
        tb = torch.as_tensor(tiles, device=dev)
        ci = cand[tb, :width]
        qs, qi = qt[tb], qid[tb]
        d2 = _diff_d2(cf[qi.clamp(min=0)][:, :, None, :], cf[ci.clamp(min=0)][:, None, :, :])
        key = _ordered_key(d2) | ci.clamp(min=0)[:, None, :]
        key.masked_fill_((ci < 0)[:, None, :] | (ci[:, None, :] == qi[:, :, None]),
                         _INT64_MAX)
        top = torch.topk(key.reshape(-1, width), k, dim=1, largest=False,
                         sorted=True).values
        ok = ((top[:, k - 1] != _INT64_MAX) & (_key_value(top[:, k - 1]) < r2)
              & (qs.reshape(-1) >= 0))
        s_ok = profiling.masked(qs.reshape(-1), ok)
        top = profiling.masked(top, ok)
        _place(dists, idx, s_ok, _key_value(top), (top & 0xFFFFFFFF).to(torch.int32))
        done[s_ok] = True
    failed = profiling.nonzero(a_valid & ~done)[:, 0]
    stats["failed"] = int(failed.shape[0])
    if stats["failed"]:
        d_f, i_f = knn_search(cf[aidx[failed]], cf, valid, k, query_ids=aidx[failed],
                              exclude_identical_index=True)
        _place(dists, idx, failed, d_f, i_f)
    return dists, idx, stats


# ---------------------------------------------------------------------------
# donor fills
# ---------------------------------------------------------------------------

def _nearest_donor_core(cf, donors_ok, need, query_tile):
    """Shared donor search (geopurify_tpu/ops/knn.py:794): for each needing
    row (ascending id) the nearest donor row, first-lowest donor id on equal
    distances. Distances use the JAX form q_sq + d_sq - 2 q.d in f32 so the
    choice between near-equal donors follows the same rounding.
    Returns (qpos [n_need] int64, donor [n_need] int64, n_donors)."""
    dpos = profiling.nonzero(donors_ok)[:, 0]
    qpos = profiling.nonzero(need)[:, 0]
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
        _donor_tile(int(profiling.host_read(donors_ok.sum()))))
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
        _donor_tile(int(profiling.host_read(donors_ok.sum()))))
    donor_full = torch.arange(N, dtype=torch.int32, device=coords.device)
    filled = torch.zeros((N,), dtype=torch.bool, device=coords.device)
    if n_donors > 0:
        donor_full[qpos] = donor.to(torch.int32)
        filled[qpos] = True
    return donor_full, filled


# geopurify_tpu/ops/knn.py:963
def nearest_fill_grid(
    features: torch.Tensor,   # [N, C]
    coords: torch.Tensor,     # [N, 3] float world coords
    has_value: torch.Tensor,  # [N] bool — rows with real features
    valid: torch.Tensor,      # [N] bool — padding mask
    query_tile: int = 512,
    num_candidates: int = 2048,
    radius_cells: int = 16,
    grid_bits: int = 9,
) -> torch.Tensor:
    """``nearest_fill`` with the grid machinery at k = 1, donors (covered
    rows) apart from queries (uncovered rows) (JAX knn.py:975-1003): the
    scene box cut into 2^``grid_bits`` cells an axis, the needing rows in
    Hilbert order over those cells, tiles of ``query_tile``, candidates the
    donors in the tile box dilated by ``radius_cells`` cells (at most
    ``num_candidates``), the certificate best d2 <= radius^2, and the
    exact sweep of ``nearest_fill`` for every uncertified query.

    The donor is ``nearest_fill``'s: the nearest in the q_sq + d_sq - 2 q.d
    f32 form, the lowest donor id on equal distances (the JAX version
    takes the same: its candidates are in ascending id order and its
    argmin keeps the first). On integer-valued coords (the voxel fill)
    every distance is an exact f32 integer and the box is dilated to
    max(radius, sqrt(fl(radius^2))), so the donor equals ``nearest_fill``'s
    bit for bit; on general float coords the two agree up to the rounding
    of that form, as in the JAX version."""
    qpos, donor, _ = _nearest_fill_grid(coords, has_value, valid, query_tile,
                                        num_candidates, radius_cells, grid_bits)
    out = features.clone()
    out[qpos] = features[donor]
    return torch.where(has_value[:, None], features, out)


def _nearest_fill_grid(coords, has_value, valid, query_tile: int = 512,
                       num_candidates: int = 2048, radius_cells: int = 16,
                       grid_bits: int = 9):
    """The donor search of ``nearest_fill_grid``: (qpos [n_need] int64, the
    needing rows ascending as ``_nearest_donor_core`` gives them; donor
    [n_need] int64; stats as ``_knn_self_grid``'s)."""
    N = coords.shape[0]
    dev = coords.device
    T, C = query_tile, min(num_candidates, max(N, 1))
    cf = coords.to(torch.float32)
    donors_ok = has_value & valid
    need = valid & ~has_value
    lo_v = torch.where(valid[:, None], cf, float("inf")).amin(0)
    hi_v = torch.where(valid[:, None], cf, float("-inf")).amax(0)
    n_cells = float(2 ** grid_bits)
    cell = torch.clamp((hi_v - lo_v).amax(), min=1e-6) / n_cells
    gi = torch.clamp(torch.nan_to_num((cf - lo_v[None]) / cell), 0, n_cells - 1)
    qt, n_need = _hilbert_tiles(hilbert_code(gi.to(torch.int32)), need, T)
    qpos = profiling.nonzero(need)[:, 0]
    stats = dict(queries=n_need, failed=0, tiles=qt.shape[0], overflow_tiles=0)
    donor = torch.zeros((N,), dtype=torch.int64, device=dev)
    n_donors = int(profiling.host_read(donors_ok.sum()))
    if n_need == 0 or n_donors == 0:
        # JAX: with no donor, every needing row takes row 0
        return qpos, donor[qpos], stats
    cell_h = profiling.host_read(cell)
    radius = torch.tensor(radius_cells, dtype=torch.float32) * cell_h
    r2 = radius * radius
    R = max(float(radius), float(r2.double().sqrt()))
    c64 = cf.to(torch.float64)
    lo, hi = _tile_boxes(c64, qt, R)
    cand, count = _box_candidates(c64, profiling.nonzero(donors_ok)[:, 0], lo, hi, C)
    count_h = profiling.host_read(count).numpy()
    over = count_h > C
    stats["overflow_tiles"] = int(over.sum())
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    sq = (cf * cf).sum(-1)
    for tiles, width in _blocks(count_h, ~over & (count_h > 0), T):
        tb = torch.as_tensor(tiles, device=dev)
        ci = cand[tb, :width]
        qi = qt[tb]
        q, cd = cf[qi.clamp(min=0)], cf[ci.clamp(min=0)]
        d2 = (sq[qi.clamp(min=0)][:, :, None] + sq[ci.clamp(min=0)][:, None, :]
              - 2.0 * _matmul_f32(q, cd.transpose(1, 2)))
        key = _ordered_key(d2.masked_fill_((ci < 0)[:, None, :], float("inf")))
        best = (key | ci.clamp(min=0)[:, None, :]).amin(2).reshape(-1)
        ok = (_key_value(best) <= r2.item()) & (qi.reshape(-1) >= 0)
        q_ok = profiling.masked(qi.reshape(-1), ok)
        donor[q_ok] = profiling.masked(best, ok) & 0xFFFFFFFF
        done[q_ok] = True
    failed = need & ~done
    stats["failed"] = int(profiling.host_read(failed.sum()))
    if stats["failed"]:
        fpos, fdon, _ = _nearest_donor_core(cf, donors_ok, failed, _donor_tile(n_donors))
        donor[fpos] = fdon
    return qpos, donor[qpos], stats

