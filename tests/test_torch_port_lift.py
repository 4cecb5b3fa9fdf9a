"""Lift and fusion port held against the JAX package on the CPU: winners,
donors and view counts exact; tables and fused features to f32 rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.models import lift as jlift
from geopurify_tpu_torch.models import lift as tlift


def _t(x):
    return torch.from_numpy(np.array(x))


def _view(rng, Q=12, h=16, w=24, C=16, n_cls=5, Pv=64, H=64, W=96):
    # masks offset so a useful share of points clears sigmoid >= 0.5
    masks = (rng.normal(size=(Q, h, w)) * 3.0 - 1.0).astype(np.float32)
    embed = rng.normal(size=(Q, C)).astype(np.float32)
    logits = rng.normal(size=(Q, n_cls + 1)).astype(np.float32)
    rows = rng.integers(0, H, Pv).astype(np.int32)
    cols = rng.integers(0, W, Pv).astype(np.int32)
    pv_valid = rng.uniform(size=Pv) < 0.9
    coords = rng.uniform(0, 3, (Pv, 3)).astype(np.float32)
    text = rng.normal(size=(n_cls, C)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    return masks, embed, logits, rows, cols, pv_valid, coords, text


@pytest.mark.parametrize("Pv", [64, 700])    # point-evaluated / full-grid resize
def test_lift_view_ids_exact(rng, Pv):
    args = _view(rng, Pv=Pv)
    H, W = 64, 96
    ref = jlift.lift_view_ids(*[jnp.asarray(a) for a in args], jnp.float32(20.0),
                              (H, W), mask_threshold=0.5)
    got = tlift.lift_view_ids(*[_t(a) for a in args], 20.0, (H, W), mask_threshold=0.5)
    np.testing.assert_array_equal(got.winner.numpy(), np.asarray(ref.winner))
    np.testing.assert_allclose(got.embed_table.numpy(), np.asarray(ref.embed_table),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.logit_table.numpy(), np.asarray(ref.logit_table),
                               rtol=1e-5, atol=1e-5)
    # the test exercises covered, hole-filled and sentinel points
    w = got.winner.numpy()
    assert (w == 12).any() and (w < 12).sum() > 10
    jw, jc = jlift._view_winner(jnp.asarray(args[0]), jnp.asarray(args[2]),
                                jnp.asarray(args[3]), jnp.asarray(args[4]),
                                jnp.asarray(args[5]), (H, W), 0.5)
    tw, tc = tlift._view_winner(_t(args[0]), _t(args[2]), _t(args[3]), _t(args[4]),
                                _t(args[5]), (H, W), 0.5)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_fuse_views_indexed_matches_jax(rng):
    V, Pv, Q, C, n_cls, P = 5, 80, 9, 12, 4, 150
    winner = rng.integers(0, Q + 1, (V, Pv)).astype(np.int32)
    emb = rng.normal(size=(V, Q + 1, C)).astype(np.float32)
    emb[:, Q] = 0.0
    logit = rng.normal(size=(V, Q + 1, n_cls)).astype(np.float32)
    logit[:, Q] = 0.0
    ids = np.stack([rng.choice(P, Pv, replace=False) for _ in range(V)]).astype(np.int32)
    valid = rng.uniform(size=(V, Pv)) < 0.9
    ids[~valid] = P
    ref_f, ref_c = jlift.fuse_views_indexed(
        jnp.asarray(winner), jnp.asarray(emb), jnp.asarray(logit), jnp.asarray(ids),
        jnp.asarray(valid), num_points=P, top_k=3)
    got_f, got_c = tlift.fuse_views_indexed(
        _t(winner), _t(emb), _t(logit), _t(ids), _t(valid), num_points=P, top_k=3)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(ref_f), rtol=1e-5, atol=1e-6)
    assert (got_c.numpy() >= 3).any() and (got_c.numpy() == 0).any()


def test_fill_unseen_points_exact(rng):
    P, C = 300, 8
    fused = rng.normal(size=(P, C)).astype(np.float32)
    count = rng.integers(0, 3, P).astype(np.float32)
    fused[count == 0] = 0.0
    pts = rng.uniform(0, 2, (P, 3)).astype(np.float32)
    valid = rng.uniform(size=P) < 0.95
    ref = jlift.fill_unseen_points(jnp.asarray(fused), jnp.asarray(pts),
                                   jnp.asarray(count), jnp.asarray(valid))
    got = tlift.fill_unseen_points(_t(fused), _t(pts), _t(count), _t(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_fill_unseen_points_voxel_not_ported():
    with pytest.raises(NotImplementedError):
        tlift.fill_unseen_points_voxel()
