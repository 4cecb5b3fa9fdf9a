"""The port's host C++ library (``geopurify_tpu_torch.native``) and the
voxelizer, held against the JAX package: case by case as
tests/test_native.py, the port's native, the port's numpy route (the
loader's one route), JAX's native and JAX's numpy route give bit-equal
results; ``ravel_hash_vec`` and ``hash_type="ravel"`` are exact; a failed
build is a logged warning, not a silent switch; ``native.compute_mapping``
equals the loader's device mapping (``ops/projection.compute_mapping``)
run on the CPU."""

import logging

import numpy as np
import pytest
import torch

from geopurify_tpu import native as jnative
from geopurify_tpu.data import ply as jply
from geopurify_tpu.data.loaders import compute_mapping_np as jax_mapping
from geopurify_tpu.ops import voxelize as jvox
from geopurify_tpu_torch import native
from geopurify_tpu_torch.data import ply as tply
from geopurify_tpu_torch.ops import voxelize as tvox
from geopurify_tpu_torch.ops.projection import compute_mapping as device_mapping

pytestmark = pytest.mark.skipif(
    not (native.available() and jnative.available()), reason="no g++ to build the host library")


def _numpy_unique(key):
    _, inds, rev = np.unique(key, return_index=True, return_inverse=True)
    return inds, rev.reshape(-1)


@pytest.mark.parametrize("hi,n", [(50, 5000), (4, 3000), (100000, 20000)])
def test_fnv_voxelize_four_ways(rng, hi, n):
    coords = rng.integers(0, hi, (n, 3)).astype(np.float64)
    key = tvox.fnv_hash_vec(coords)
    assert np.array_equal(key, jvox.fnv_hash_vec(coords))
    ref = _numpy_unique(key)
    for inds, rev in (native.fnv_voxelize(coords.astype(np.int64)),
                      jnative.fnv_voxelize(coords.astype(np.int64)),
                      _numpy_unique(jvox.fnv_hash_vec(coords))):
        np.testing.assert_array_equal(inds, ref[0])
        np.testing.assert_array_equal(rev, ref[1])


def test_sparse_quantize_routes_counted_and_equal_to_jaxs(rng):
    """The port's numpy dedup against JAX's, which takes its native route
    for non-negative coordinates and numpy for negative ones, and against
    the port's ``native.fnv_voxelize``."""
    coords = rng.uniform(0, 40, (4000, 3))
    got = tvox.sparse_quantize_np(coords, 0.5)
    want = jvox.sparse_quantize_np(coords, 0.5)
    nat = native.fnv_voxelize(np.floor(coords / 0.5).astype(np.int64))
    for a, b, c in zip(got, want, nat):
        np.testing.assert_array_equal(a, np.asarray(b).reshape(-1))
        np.testing.assert_array_equal(a, c)
    neg = coords - 20.0
    got = tvox.sparse_quantize_np(neg, 0.5)
    for a, b in zip(got, jvox.sparse_quantize_np(neg, 0.5)):
        np.testing.assert_array_equal(a, np.asarray(b).reshape(-1))
    with pytest.raises(ValueError, match="hash_type"):
        tvox.sparse_quantize_np(coords, hash_type="morton")


@pytest.mark.parametrize("signed", [False, True])
def test_ravel_hash_and_ravel_route_exact(rng, signed):
    lo = -30 if signed else 0
    arr = rng.integers(lo, 60, (3000, 3)).astype(np.int64)
    key = tvox.ravel_hash_vec(arr)
    np.testing.assert_array_equal(key, jvox.ravel_hash_vec(arr))
    # collision-free: equal keys exactly for equal rows
    uniq_rows = len(np.unique(arr, axis=0))
    assert len(np.unique(key)) == uniq_rows
    coords = rng.uniform(lo, 50, (3000, 3))
    got = tvox.sparse_quantize_np(coords, 0.7, hash_type="ravel")
    for a, b in zip(got, jvox.sparse_quantize_np(coords, 0.7, hash_type="ravel")):
        np.testing.assert_array_equal(a, np.asarray(b).reshape(-1))


def test_voxelizer_equal_to_jaxs(rng):
    coords = rng.uniform(0, 4, (2000, 3)).astype(np.float32)
    feats = rng.normal(size=(2000, 9)).astype(np.float32)
    labels = rng.integers(0, 5, 2000).astype(np.int32)
    bounds = dict(use_augmentation=True, scale_augmentation_bound=(0.9, 1.1),
                  rotation_augmentation_bound=((-0.1, 0.1), (-0.1, 0.1), (-np.pi, np.pi)))
    t = tvox.Voxelizer(0.1, rng=np.random.default_rng(4), **bounds).voxelize(coords, feats, labels)
    j = jvox.Voxelizer(0.1, rng=np.random.default_rng(4), **bounds).voxelize(coords, feats, labels)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, np.asarray(b).reshape(np.asarray(a).shape))


def _mapping_case(rng, n=4000):
    pts = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    w2c = np.eye(4)
    w2c[:3, 3] = [0.1, -0.2, 4.0]
    w2c[:3, :3] = np.array([[0.98, -0.2, 0.0], [0.2, 0.98, 0.0], [0.0, 0.0, 1.0]])
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
    depth = rng.uniform(2, 6, (48, 64)).astype(np.float32)
    depth[::7] = 0.0
    return pts, w2c, K, depth


@pytest.mark.parametrize("with_depth", [True, False])
def test_compute_mapping_native_jax_and_the_device_mapping(rng, with_depth):
    pts, w2c, K, depth = _mapping_case(rng)
    d = depth if with_depth else None
    want = native.compute_mapping(pts, w2c, K, d, (64, 48), 2, 0.1)
    assert want[2].any() and not want[2].all()
    for got in (jnative.compute_mapping(pts, w2c, K, d, (64, 48), 2, 0.1),
                jax_mapping(pts.astype(np.float64), w2c, K, d, (64, 48), 2, 0.1)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    rows, cols, vis = device_mapping(torch.from_numpy(pts).to(torch.float64), w2c, K,
                                     d, (64, 48), cut_bound=2, vis_thres=0.1)
    np.testing.assert_array_equal(vis.numpy(), want[2])
    np.testing.assert_array_equal(rows.numpy(), want[0])
    np.testing.assert_array_equal(cols.numpy(), want[1])


def test_vertex_normals_and_nearest_donor(rng):
    xyz = rng.normal(size=(60, 3)).astype(np.float32)
    faces = rng.integers(0, 60, (100, 3)).astype(np.int64)
    got = native.vertex_normals(xyz, faces)
    np.testing.assert_array_equal(got, jnative.vertex_normals(xyz, faces))
    np.testing.assert_allclose(got, tply.vertex_normals(xyz, faces), atol=1e-5)
    np.testing.assert_array_equal(tply.vertex_normals(xyz, faces), jply.vertex_normals(xyz, faces))
    coords = rng.normal(size=(300, 3)).astype(np.float32)
    has = rng.random(300) < 0.4
    has[0] = True
    idx = native.nearest_donor(coords, has)
    np.testing.assert_array_equal(idx, jnative.nearest_donor(coords, has))
    np.testing.assert_array_equal(idx[has], np.where(has)[0])
    donors, holes = np.where(has)[0], np.where(~has)[0]
    d2 = ((coords[holes, None] - coords[None, donors]) ** 2).sum(-1)
    np.testing.assert_array_equal(idx[holes], donors[d2.argmin(1)])


def test_grid_knn_equal_to_jaxs_and_exact(rng):
    from scipy.spatial import cKDTree

    n = 3000
    floor = np.stack([rng.integers(0, 40, n // 2), rng.integers(0, 40, n // 2),
                      rng.integers(0, 2, n // 2)], 1)
    wall = np.stack([rng.integers(0, 2, n - n // 2), rng.integers(0, 40, n - n // 2),
                     rng.integers(0, 30, n - n // 2)], 1)
    vox = np.unique(np.concatenate([floor, wall]), axis=0).astype(np.int32)
    idx, d2 = native.grid_knn(vox, 16)
    jidx, jd2 = jnative.grid_knn(vox, 16)
    np.testing.assert_array_equal(d2, jd2)
    np.testing.assert_array_equal(idx, jidx)
    d_ref, _ = cKDTree(vox.astype(np.float64)).query(vox.astype(np.float64), k=17)
    np.testing.assert_allclose(d2, d_ref[:, 1:] ** 2, rtol=1e-5)
    small = np.array([[0, 0, 0], [3, 0, 0], [6, 0, 0]], np.int32)
    idx, d2 = native.grid_knn(small, 4)
    assert (idx[:, 2:] == -1).all() and np.isinf(d2[:, 2:]).all()
    with pytest.raises(ValueError, match="packed-key range"):
        native.grid_knn(np.array([[-20000, 0, 0]], np.int32), 2)


def test_failed_build_warns_once_and_voxelize_counts_numpy(rng, monkeypatch, caplog):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "COMMAND", ("g++", "-no-such-flag-xyz"))
    monkeypatch.setattr(native, "library_path",
                        lambda: native.SRC.parent / "_no_such_dir" / "lib.so")
    """A failed build is one warning, ``available()`` stays False, and the
    voxelizer (numpy) gives JAX's result all the same."""
    coords = rng.uniform(0, 10, (500, 3))
    with caplog.at_level(logging.WARNING, logger="geopurify.native"):
        assert not native.available() and not native.available()
        got = tvox.sparse_quantize_np(coords)
        got2 = tvox.sparse_quantize_np(coords)
    warnings = [r for r in caplog.records if r.name == "geopurify.native"]
    assert len(warnings) == 1 and "did not build" in warnings[0].getMessage()
    for a, b in zip(got, jvox.sparse_quantize_np(coords)):
        np.testing.assert_array_equal(a, np.asarray(b).reshape(-1))
    assert all(np.array_equal(a, b) for a, b in zip(got, got2))
    with pytest.raises(RuntimeError, match="not available"):
        native.fnv_voxelize(np.zeros((2, 3), np.int64))
