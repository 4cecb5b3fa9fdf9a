"""The Stage-1 sampler's pieces held against the JAX package on the CPU:
the anchors' exact spatial kNN over float coords, and the hybrid sampler
given the JAX anchors (positives, macro and micro negatives). Negatives
come out of top-k selections whose order the loss ignores, so they are
compared as sets per anchor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.ops.contrastive import sample_contrastive_pairs_hybrid as j_sample
from geopurify_tpu.ops.knn import knn_anchors_grid as j_knn
from geopurify_tpu_torch.ops.contrastive import pairs_from_anchors, select_anchors
from geopurify_tpu_torch.ops.knn import _chunked_topk_min, knn_anchors_grid


def _cloud(rng, N, n_invalid):
    # a jittered 2 cm grid over a room-sized box: float coords, no exact ties
    pts = rng.integers(0, 40, (N, 3)).astype(np.float32) * 0.02
    pts += rng.uniform(0, 0.02, (N, 3)).astype(np.float32)
    valid = np.ones(N, bool)
    valid[rng.choice(N, n_invalid, replace=False)] = False
    return pts, valid


def test_knn_anchors_matches_jax(rng):
    N, A, k = 4096, 256, 16
    pts, valid = _cloud(rng, N, 100)
    aidx = rng.choice(np.where(valid)[0], A, replace=False).astype(np.int32)
    jd, ji = j_knn(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(aidx), k=k,
                   radius=0.05)
    td, ti = knn_anchors_grid(torch.from_numpy(pts), torch.from_numpy(valid),
                              torch.from_numpy(aidx), k=k)
    ji, ti = np.asarray(ji), ti.numpy()
    assert ti.shape == (A, k) and td.dtype == torch.float32
    assert valid[ti].all() and not (ti == aidx[:, None]).any()
    # exact f64 distances of both answers
    d64 = lambda idx: ((pts[idx].astype(np.float64)
                        - pts[aidx][:, None].astype(np.float64)) ** 2).sum(-1)
    dt, dj = d64(ti), d64(ji)
    assert np.all(np.diff(dt, axis=1) >= 0)
    np.testing.assert_allclose(td.numpy(), dt, rtol=1e-5, atol=1e-9)
    same = np.sort(ti, 1) == np.sort(ji, 1)
    assert same.all(1).mean() >= 0.95
    # where the sets differ, only at the k-th-distance boundary, and there
    # only by the rounding of the JAX version's |q|^2 + |x|^2 - 2 q.x form
    rows = ~same.all(1)
    np.testing.assert_allclose(np.sort(dj[rows], 1)[:, -1], dt[rows][:, -1],
                               rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(np.sort(dj, 1), dt, rtol=1e-5, atol=2e-6)


def test_chunked_topk_min_order():
    x = torch.tensor([[3.0, -1.0, 2.0, -1.0, float("inf"), -5.0, 2.0]])
    v, i = _chunked_topk_min(x, 5)
    assert i.tolist() == [[5, 1, 3, 2, 6]]
    assert v.tolist() == [[-5.0, -1.0, -1.0, 2.0, 2.0]]


@pytest.mark.parametrize("n_valid_frac", [1.0, 0.9])
def test_sampler_given_jax_anchors(n_valid_frac):
    rng = np.random.default_rng(7)
    N, D = 2048, 32
    pts, valid = _cloud(rng, N, int(N * (1 - n_valid_frac)))
    feats = rng.normal(size=(N, D)).astype(np.float32)
    # the tiny preset's counts
    kw = dict(num_anchors=32, num_macro=5, num_micro=2, spatial_k=8)
    jp = j_sample(jax.random.key(3), jnp.asarray(feats), jnp.asarray(valid),
                  coords=jnp.asarray(pts), **kw)
    tp = pairs_from_anchors(
        torch.from_numpy(feats), torch.from_numpy(valid),
        torch.from_numpy(np.array(jp.anchor_idx)),
        torch.from_numpy(np.array(jp.anchor_valid)), coords=torch.from_numpy(pts),
        num_macro=5, num_micro=2, spatial_k=8)
    av = np.asarray(jp.anchor_valid)
    assert av.sum() == min(32, int(valid.sum()) // 3)
    _, tav = select_anchors(torch.Generator().manual_seed(0), torch.from_numpy(valid), 32)
    np.testing.assert_array_equal(tav.numpy(), av)
    # a precomputed full-N neighbour table gives the same pairs
    _, full = knn_anchors_grid(torch.from_numpy(pts), torch.from_numpy(valid),
                               torch.arange(N), k=8)
    tq = pairs_from_anchors(torch.from_numpy(feats), torch.from_numpy(valid),
                            tp.anchor_idx, tp.anchor_valid, neighbor_idx=full,
                            num_macro=5, num_micro=2)
    for a, b in zip(tq, tp):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(tp.positive_idx.numpy(), np.asarray(jp.positive_idx))
    np.testing.assert_array_equal(np.sort(tp.negative_idx.numpy()[:, :5], 1),
                                  np.sort(np.asarray(jp.negative_idx)[:, :5], 1))
    np.testing.assert_array_equal(np.sort(tp.negative_idx.numpy()[av, 5:], 1),
                                  np.sort(np.asarray(jp.negative_idx)[av, 5:], 1))


def test_select_anchors_cap():
    valid = torch.zeros(300, dtype=torch.bool)
    valid[::2] = True                                  # 150 valid points
    g = torch.Generator().manual_seed(0)
    idx, av = select_anchors(g, valid, 64)
    assert av.sum() == 50                              # min(64, 150 // 3)
    assert valid[idx[:150].long()].all()               # valid points first
    assert len(set(idx.tolist())) == 64
