"""The port's pruned exact searches held against its brute force and the JAX
package on the CPU: ``knn_self_grid`` (bit-equal to ``knn_search`` on every
valid row, equal to the JAX grid and brute kNN in (d2, id) order) on
certified, fallback and overflow inputs, padding, M off the tile, k above
the valid count and an all-invalid input; ``knn_anchors_grid`` over float
coords, points exactly at the radius included; ``nearest_fill_grid``
against ``nearest_fill`` and the JAX ``nearest_fill_grid``; ``knn_search``
and ``argmin_search`` against JAX; and the config switches that pick the
routes (spies, not timings)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.ops import knn as jknn
from geopurify_tpu_torch.ops import contrastive as tctr
from geopurify_tpu_torch.ops import knn as tknn
from geopurify_tpu_torch.ops import pooling as tpool


def _t(x):
    return torch.from_numpy(np.array(x))


def _voxels(rng, n, ext=(30, 26, 12), n_pad=0):
    """``n`` unique lex-sorted voxels of a dense integer grid (ties
    everywhere), then ``n_pad`` padding rows at the origin."""
    allc = np.stack(np.meshgrid(*[np.arange(e) for e in ext], indexing="ij"),
                    -1).reshape(-1, 3)
    vox = allc[np.sort(rng.choice(allc.shape[0], n, replace=False))].astype(np.int32)
    vox = np.concatenate([vox, np.zeros((n_pad, 3), np.int32)])
    valid = np.arange(n + n_pad) < n
    return vox, valid


# (valid voxels, padding rows, k, radius, candidate budget, what it covers)
SELF_CASES = {
    "certified": (3000, 0, 8, 3, 1024),
    "fallback": (3000, 0, 8, 1, 1024),
    "overflow": (3000, 0, 8, 6, 150),
    "padding": (2900, 37, 8, 3, 1024),
    "k_above_valid": (100, 110, 120, 12, 4096),
    "all_invalid": (0, 50, 8, 3, 4096),
}


@pytest.mark.parametrize("case", list(SELF_CASES))
def test_knn_self_grid_bit_equal_full_and_jax(case):
    n, n_pad, k, r, C = SELF_CASES[case]
    vox, valid = _voxels(np.random.default_rng(len(case)), n, n_pad=n_pad)
    M = vox.shape[0]
    d, i, st = tknn._knn_self_grid(_t(vox), _t(valid), k, r, C, 128)
    assert (d.dtype, i.dtype, d.shape) == (torch.float32, torch.int32, (M, k))
    assert st["queries"] == n
    if case == "certified":
        assert 0 < st["failed"] < n // 10 and st["overflow_tiles"] == 0
    elif case == "fallback":
        assert st["failed"] == n and st["overflow_tiles"] == 0
    elif case == "overflow":
        assert st["overflow_tiles"] > 0
    # the full route, bit for bit on every valid row; invalid rows unfilled
    d_f, i_f = tknn.knn_search(_t(vox), _t(vox), _t(valid), k, query_ids=torch.arange(M),
                               exclude_identical_index=True)
    assert torch.equal(d[valid], d_f[valid]) and torch.equal(i[valid], i_f[valid])
    assert torch.isinf(d[~valid]).all() and (i[~valid] == 0).all()
    # JAX: its grid kNN (packed keys) and its brute force with the id-stable
    # selector; unfilled slots compared by distance only (JAX leaves an
    # arbitrary index there)
    cf = jnp.asarray(vox, jnp.float32)
    refs = [jknn.knn_search(cf, cf, jnp.asarray(valid), k=k,
                            query_ids=jnp.arange(M, dtype=jnp.int32),
                            exclude_identical_index=True, selector="topk")]
    if k < M:
        refs.append(jknn.knn_self_grid(jnp.asarray(vox), jnp.asarray(valid), k=k,
                                       radius=r, num_candidates=C))
    for d_j, i_j in refs:
        d_j, i_j = np.asarray(d_j), np.asarray(i_j)
        np.testing.assert_array_equal(d.numpy()[valid], d_j[valid])
        fin = np.isfinite(d_j)
        np.testing.assert_array_equal(np.where(fin, i.numpy(), 0)[valid],
                                      np.where(fin, i_j, 0)[valid])


def _cloud(rng, N, n_invalid, exact=False):
    """Room-sized float points: a jittered 2 cm grid, or (``exact``) points on
    a 0.125 lattice, where distances are exact binary fractions and a
    point's 16th neighbour lies inside, at exactly, or beyond 0.25."""
    if exact:
        pts = rng.integers(0, 24, (N, 3)).astype(np.float32) * 0.125
    else:
        pts = rng.integers(0, 40, (N, 3)).astype(np.float32) * 0.02
        pts += rng.uniform(0, 0.02, (N, 3)).astype(np.float32)
    valid = np.ones(N, bool)
    valid[rng.choice(N, n_invalid, replace=False)] = False
    return pts, valid


# (points, radius, exact lattice, k): certificates, fallbacks, and k-th
# neighbours at exactly the radius (the strict certificate sends those rows
# to the recompute)
ANCHOR_CASES = {"certified": (6000, 0.1, False, 16), "fallback": (6000, 0.01, False, 16),
                "at_radius": (8000, 0.25, True, 16)}


@pytest.mark.parametrize("case", list(ANCHOR_CASES))
def test_knn_anchors_grid_matches_brute_and_jax(case):
    N, radius, exact, k = ANCHOR_CASES[case]
    rng = np.random.default_rng(3)
    pts, valid = _cloud(rng, N, 120, exact)
    aidx = rng.choice(N, 1024, replace=False).astype(np.int32)
    av = valid[aidx]
    d, i, st = tknn._knn_anchors_grid(_t(pts), _t(valid), _t(aidx), k, radius, 4096, 128)
    assert st["queries"] == av.sum()
    if case == "certified":
        assert st["failed"] < st["queries"] // 2
    elif case == "fallback":
        assert st["failed"] == st["queries"]
    else:
        # the k-th neighbour at exactly the radius: recomputed, not certified
        kth_at_r = d.numpy()[av, k - 1] == np.float32(radius) ** 2
        assert kth_at_r.mean() > 0.2 and 0 < st["failed"] < st["queries"]
        assert st["failed"] >= kth_at_r.sum()
    d_b, i_b = tknn.knn_search(_t(pts[aidx]), _t(pts), _t(valid), k, query_ids=_t(aidx),
                               exclude_identical_index=True)
    assert torch.equal(d[av], d_b[av]) and torch.equal(i[av], i_b[av])
    assert torch.isinf(d[~av]).all() and (i[~av] == 0).all()
    assert valid[i.numpy()[av]].all() and not (i.numpy() == aidx[:, None])[av].any()
    # JAX's grid search forms d2 as |q|^2 + |x|^2 - 2 q.x and selects with
    # approx_min_k: on the lattice its distances are exact and equal ours;
    # on jittered coords its set differs only at the k-th-distance boundary
    jd, ji = jknn.knn_anchors_grid(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(aidx),
                                   k=k, radius=radius)
    jd, ji = np.asarray(jd)[av], np.asarray(ji)[av]
    if exact:
        np.testing.assert_array_equal(np.sort(jd, 1), d.numpy()[av])
    else:
        same = (np.sort(ji, 1) == np.sort(i.numpy()[av], 1)).all(1)
        assert same.mean() >= 0.95
        np.testing.assert_allclose(np.sort(jd, 1), d.numpy()[av], rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("integer", [True, False])
def test_box_candidates_exact_sets_and_lower_bound(integer):
    """``_box_candidates``: each tile within budget gets exactly its in-box
    rows, ascending by x; the occupancy-grid bound never exceeds a box's
    true count (points on the cell edges and the box faces included), and
    a tile it puts over budget really is."""
    rng = np.random.default_rng(11 + integer)
    if integer:
        pts = rng.integers(0, 64, (6000, 3)).astype(np.int32)
    else:
        pts = np.round(rng.uniform(0, 4, (6000, 3)) * 8) / 8      # on a 1/8 lattice
        pts = pts.astype(np.float32)
    rows = np.flatnonzero(rng.uniform(size=6000) < 0.9)
    c = pts[rng.choice(rows, 64)].astype(np.float64)
    w = rng.uniform(0.05, 0.6, (64, 3)) * (pts.max(0) - pts.min(0))
    lo, hi = np.round((c - w) * 8) / 8, np.round((c + w) * 8) / 8
    x = _t(pts) if integer else _t(pts).double()
    lb = tknn._count_lower_bound(x[_t(rows)], _t(lo), _t(hi)).numpy()
    inside = ((pts[rows][None] >= lo[:, None]) & (pts[rows][None] <= hi[:, None])).all(-1)
    true = inside.sum(1)
    assert (lb <= true).all() and (lb > 0).sum() > 10
    budget = int(np.median(true))
    cand, count = tknn._box_candidates(x, _t(rows), _t(lo), _t(hi), budget)
    cand, count = cand.numpy(), count.numpy()
    over = true > budget
    assert over.any() and (~over).any()
    np.testing.assert_array_equal(count[~over], true[~over])
    assert (count[over] > budget).all() and (cand[over] == -1).all()
    for t in np.flatnonzero(~over):
        got = cand[t][cand[t] >= 0]
        assert sorted(got.tolist()) == sorted(rows[inside[t]].tolist())


@pytest.mark.parametrize("cover,budget", [(0.3, 4096), (0.85, 4096), (0.3, 64)])
def test_nearest_fill_grid_matches_sweep_and_jax(cover, budget):
    """Integer voxel coords over a room-sized extent (the voxel fill's
    input): the pruned donor fill equals the exhaustive ``nearest_fill``
    and the JAX ``nearest_fill_grid`` bit for bit. Features are row ids, so
    equal fills mean equal donors; on this tie-heavy grid the donor is the
    lowest id among the nearest donors, checked against numpy."""
    rng = np.random.default_rng(int(cover * 100) + budget)
    vox, valid = _voxels(rng, 2500, ext=(160, 120, 24), n_pad=40)
    M = vox.shape[0]
    has = rng.uniform(size=M) < cover
    feats = np.repeat(np.arange(M, dtype=np.float32)[:, None], 3, 1)
    cf = vox.astype(np.float32)
    qpos, donor, st = tknn._nearest_fill_grid(_t(cf), _t(has), _t(valid), 512, budget, 16, 9)
    if budget == 64:
        assert st["overflow_tiles"] > 0
    else:
        assert st["failed"] < st["queries"]          # some tiles certify
    grid = tknn.nearest_fill_grid(_t(feats), _t(cf), _t(has), _t(valid),
                                  num_candidates=budget)
    sweep = tknn.nearest_fill(_t(feats), _t(cf), _t(has), _t(valid))
    assert torch.equal(grid, sweep)
    ref = jknn.nearest_fill_grid(jnp.asarray(feats), jnp.asarray(cf), jnp.asarray(has),
                                 jnp.asarray(valid), num_candidates=budget)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(ref))
    dons = np.flatnonzero(has & valid)
    d2 = ((vox[qpos.numpy()][:, None].astype(np.int64) - vox[dons][None]) ** 2).sum(-1)
    want = dons[np.argmin(d2, 1)]             # numpy: the first (lowest) minimum
    np.testing.assert_array_equal(donor.numpy(), want)
    assert (d2 == d2.min(1, keepdims=True)).sum(1).max() > 1     # ties present


def test_nearest_fill_grid_without_donors():
    vox, valid = _voxels(np.random.default_rng(5), 300, n_pad=10)
    feats = np.random.default_rng(6).normal(size=(310, 4)).astype(np.float32)
    has = np.zeros(310, bool)
    args = (_t(feats), _t(vox.astype(np.float32)), _t(has), _t(valid))
    assert torch.equal(tknn.nearest_fill_grid(*args), tknn.nearest_fill(*args))


@pytest.mark.parametrize("D", [3, 8])
def test_knn_search_and_argmin_search_match_jax(D):
    rng = np.random.default_rng(D)
    q = rng.uniform(0, 2, (300, D)).astype(np.float32)
    db = rng.uniform(0, 2, (900, D)).astype(np.float32)
    dbv = rng.uniform(size=900) < 0.9
    d, i = tknn.knn_search(_t(q), _t(db), _t(dbv), 10)
    d_j, i_j = jknn.knn_search(jnp.asarray(q), jnp.asarray(db), jnp.asarray(dbv), k=10,
                               selector="topk")
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    # XLA may contract the JAX form into fused multiply-adds (an ulp apart);
    # above D = 4 JAX forms |q|^2 + |x|^2 - 2 q.x, whose cancellation costs
    # ~1e-5 at these norms
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=1e-5,
                               atol=1e-6 if D <= 4 else 2e-5)
    a = tknn.argmin_search(_t(q), _t(db), _t(dbv))
    a_j = jknn.argmin_search(jnp.asarray(q), jnp.asarray(db), jnp.asarray(dbv))
    assert a.dtype == torch.int32
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))
    none = tknn.argmin_search(_t(q), _t(db), torch.zeros(900, dtype=torch.bool))
    assert (none == 0).all()


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def wrapped(*a, **k):
        calls.append((name, k))
        return fn(*a, **k)

    monkeypatch.setattr(module, name, wrapped)


def test_knn_mode_picks_the_route(monkeypatch):
    """``pooling.knn_mode='full'`` reaches ``knn_search``, 'grid' reaches
    ``knn_self_grid`` with ``knn_radius`` and ``knn_candidates``; the graphs
    are equal on the valid rows."""
    rng = np.random.default_rng(9)
    vox, valid = _voxels(rng, 1500, n_pad=20)
    emb = rng.normal(size=(vox.shape[0], 6)).astype(np.float32)
    calls = []
    _spy(monkeypatch, tpool, "knn_search", calls)
    _spy(monkeypatch, tpool, "knn_self_grid", calls)
    out = {}
    for mode in ("grid", "full"):
        calls.clear()
        out[mode] = tpool.build_affinity_graph(_t(emb), _t(vox), _t(valid), k=8,
                                               knn_mode=mode, knn_radius=5,
                                               knn_candidates=2048)
        want = "knn_self_grid" if mode == "grid" else "knn_search"
        assert [c[0] for c in calls] == [want]
    (n_g, w_g), (n_f, w_f) = out["grid"], out["full"]
    assert torch.equal(n_g[valid], n_f[valid]) and torch.equal(w_g, w_f)
    calls.clear()
    tpool.build_affinity_graph(_t(emb), _t(vox), _t(valid), k=8, knn_radius=5,
                               knn_candidates=2048)
    assert calls[0][1]["radius"] == 5 and calls[0][1]["num_candidates"] == 2048
    with pytest.raises(ValueError, match="knn_mode"):
        tpool.build_affinity_graph(_t(emb), _t(vox), _t(valid), k=8, knn_mode="approx")


def test_spatial_method_picks_the_route(monkeypatch):
    """``contrastive.spatial_method`` 'grid' reaches ``knn_anchors_grid`` at
    ``spatial_radius``, 'brute' reaches ``knn_search``; the same pairs."""
    rng = np.random.default_rng(11)
    N = 3000
    pts, valid = _cloud(rng, N, 60)
    feats = rng.normal(size=(N, 16)).astype(np.float32)
    calls = []
    _spy(monkeypatch, tctr, "knn_search", calls)
    _spy(monkeypatch, tctr, "knn_anchors_grid", calls)
    pairs = {}
    for method in ("grid", "brute"):
        calls.clear()
        pairs[method] = tctr.sample_contrastive_pairs_hybrid(
            torch.Generator().manual_seed(0), _t(feats), _t(valid), coords=_t(pts),
            num_anchors=64, num_macro=5, num_micro=2, spatial_k=8,
            spatial_method=method, spatial_radius=0.07)
        assert [c[0] for c in calls] == [
            "knn_anchors_grid" if method == "grid" else "knn_search"]
        if method == "grid":
            assert calls[0][1]["radius"] == 0.07
    for a, b in zip(pairs["grid"], pairs["brute"]):
        assert torch.equal(a, b)
