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


def check_voxel_fill(got, ref, count, point_valid, p2v, coords, voxel_valid,
                     seen_rtol=1e-6):
    """``fill_unseen_points_voxel``'s contract, for the port's output ``got``
    and the JAX one ``ref`` (both [P, C]): seen rows stay as they were (equal
    across the two to ``seen_rtol``); an unseen point takes the mean, over
    its seen points, of its own voxel if that has one, else of a nearest
    seen voxel. Where that nearest voxel is unique the two agree to
    ``seen_rtol`` of the scale; on equal-distance ties each takes a voxel at
    the nearest distance (the JAX order between them is open)."""
    P, C = got.shape
    M = coords.shape[0]
    scale = np.abs(ref).max()
    seen = (count > 0) & point_valid
    np.testing.assert_allclose(got[seen], ref[seen], rtol=seen_rtol, atol=seen_rtol * scale)
    np.testing.assert_array_equal(got[~point_valid], ref[~point_valid])

    def voxel_means(out):
        s = np.zeros((M, C))
        n = np.zeros(M)
        np.add.at(s, p2v[seen], out[seen])
        np.add.at(n, p2v[seen], 1.0)
        return s / np.maximum(n, 1)[:, None], n > 0

    c = coords.astype(np.int64)
    (mean_got, has), (mean_ref, _) = voxel_means(got), voxel_means(ref)
    n_unique = n_tie = 0
    for i in np.nonzero(point_valid & ~seen)[0]:
        v = p2v[i]
        if has[v]:
            cands = [v]
        else:
            donors = np.nonzero(has & voxel_valid)[0]
            d2 = ((c[donors] - c[v]) ** 2).sum(1)
            cands = donors[d2 == d2.min()]
        # the means recomputed here in f64 against the packages' f32 ones
        for row, mean in ((got[i], mean_got), (ref[i], mean_ref)):
            err = np.abs(mean[cands] - row[None]).max(1)
            assert err.min() <= 1e-5 * scale, (i, v, cands)
        if len(cands) == 1:
            n_unique += 1
            np.testing.assert_allclose(got[i], ref[i], rtol=seen_rtol, atol=seen_rtol * scale)
        else:
            n_tie += 1
    return n_unique, n_tie


def _voxel_scene(rng, M=300, P=1200, C=8, box=12):
    flat = rng.choice(box ** 3, M + 40, replace=False)
    coords = np.stack(np.unravel_index(flat, (box,) * 3), 1).astype(np.int32)
    voxel_valid = np.ones(M + 40, bool)
    voxel_valid[M:] = False                      # padding voxels
    p2v = rng.integers(0, M, P).astype(np.int32)
    point_valid = rng.uniform(size=P) < 0.95
    p2v[~point_valid] = M + 40
    count = (rng.uniform(size=P) < 0.35) * rng.integers(1, 4, P)
    fused = rng.normal(size=(P, C)).astype(np.float32)
    fused[count == 0] = 0.0
    return fused, count.astype(np.float32), point_valid, p2v, coords, voxel_valid


def test_fill_unseen_points_voxel_matches_jax(rng):
    """Voxel fill against JAX on an integer grid where equal-distance donors
    are common."""
    args = _voxel_scene(rng)
    ref = np.asarray(jlift.fill_unseen_points_voxel(*[jnp.asarray(a) for a in args]))
    got = tlift.fill_unseen_points_voxel(*[_t(a) for a in args]).numpy()
    fused, count, point_valid, p2v, coords, voxel_valid = args
    n_unique, n_tie = check_voxel_fill(got, ref, count, point_valid, p2v, coords,
                                       voxel_valid)
    # the fixture exercises unique donors, ties and voxels with seen points
    assert n_unique > 20 and n_tie > 5, (n_unique, n_tie)


def test_lift_scene_voxel_fill_branch_matches_jax():
    """``lift_scene`` at P = 2^19 (a 512-point scene padded to the bucket)
    takes the voxel fill in both packages."""
    from tests.test_torch_port_pipeline import build_pair
    from geopurify_tpu.data.batch import SceneBatch as JSceneBatch
    from geopurify_tpu_torch.data.batch import SceneBatch, build_scene, pad_to

    cfg, jp, svars, tp = build_pair()
    P = 1 << 19
    a = build_scene(5, 512, 256, 2, 128, tuple(cfg.xdecoder.mask_shape))
    a["point_valid"] = pad_to(a["point_valid"], P, value=False)
    a["point2voxel"] = pad_to(a["point2voxel"], P, value=256)
    for k in ("points", "geom_feats", "labels"):
        a[k] = pad_to(a[k], P)
    ref = jp.lift_scene(JSceneBatch(**{k: jnp.asarray(v) for k, v in a.items()}))
    with torch.no_grad():
        fused, count = tp.lift_scene(SceneBatch.from_numpy(a))
    count = count.numpy()
    np.testing.assert_array_equal(count, np.asarray(ref.view_count))
    assert (count[:512] == 0).sum() > 50 and (count > 0).sum() > 50
    # the fused features themselves carry f32 rounding of the fusion (1e-4,
    # as test_lift_scene_matches_jax), the fill copies them exactly
    check_voxel_fill(fused.numpy(), np.asarray(ref.features), count, a["point_valid"],
                     a["point2voxel"], a["voxel_coords"], a["voxel_valid"],
                     seen_rtol=1e-4)
