"""Port ops held against the JAX package on the CPU: segment reductions,
Hilbert codes (bit-exact), exact kNN in (d2, id) order, the sparse-conv
neighbour table, the donor searches, and the config trees."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.ops import knn as jknn
from geopurify_tpu.ops import morton as jmorton
from geopurify_tpu.ops import segment as jseg
from geopurify_tpu.ops import sparse_conv as jsc
from geopurify_tpu_torch.ops import knn as tknn
from geopurify_tpu_torch.ops import morton as tmorton
from geopurify_tpu_torch.ops import segment as tseg
from geopurify_tpu_torch.ops import sparse_conv as tsc


def _t(x):
    return torch.from_numpy(np.array(x))


def _grid_voxels(rng, n, ext=(12, 10, 8), n_pad=0):
    """Unique lex-sorted integer voxels of a small dense grid (tie-heavy),
    optionally followed by padding rows."""
    allc = np.stack(np.meshgrid(*[np.arange(e) for e in ext], indexing="ij"),
                    -1).reshape(-1, 3)
    keep = np.sort(rng.choice(allc.shape[0], n, replace=False))
    vox = allc[keep].astype(np.int32)
    valid = np.ones(n, bool)
    if n_pad:
        vox = np.concatenate([vox, np.zeros((n_pad, 3), np.int32)])
        valid = np.concatenate([valid, np.zeros(n_pad, bool)])
    return vox, valid


@pytest.mark.parametrize("sorted_ids", [True, False])
def test_segment_sum_and_mean(rng, sorted_ids):
    n, m, c = 300, 40, 7
    data = rng.normal(size=(n, c)).astype(np.float32)
    ids = rng.integers(0, m + 1, n).astype(np.int32)     # m == padding id
    if sorted_ids:
        ids = np.sort(ids)
    np.testing.assert_allclose(
        tseg.segment_sum(_t(data), _t(ids), m).numpy(),
        np.asarray(jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids), m)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tseg.segment_mean(_t(data), _t(ids), m).numpy(),
        np.asarray(jseg.segment_mean(jnp.asarray(data), jnp.asarray(ids), m)),
        rtol=1e-5, atol=1e-6)


def test_hilbert_code_bit_exact(rng):
    coords = rng.integers(0, 1024, (5000, 3)).astype(np.int32)
    coords[:8] = [[0, 0, 0], [1023, 1023, 1023], [1, 0, 0], [0, 1, 0],
                  [0, 0, 1], [512, 511, 3], [1023, 0, 1023], [7, 7, 7]]
    got = tmorton.hilbert_code(_t(coords))
    ref = np.asarray(jmorton.hilbert_code(jnp.asarray(coords)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n_pad", [0, 37])
def test_knn_self_grid_matches_jax_tie_order(rng, n_pad):
    """Dense integer grid: ties everywhere. Distances exact and neighbour ids
    in (d2, id) order, against the JAX grid kNN (packed keys) and the JAX
    brute force with the id-stable top-k selector."""
    vox, valid = _grid_voxels(rng, 700, n_pad=n_pad)
    k = 24
    d_t, i_t = tknn.knn_self_grid(_t(vox), _t(valid), k=k)
    d_g, i_g = jknn.knn_self_grid(jnp.asarray(vox), jnp.asarray(valid), k=k,
                                  radius=3, num_candidates=256)
    cf = jnp.asarray(vox, jnp.float32)
    d_b, i_b = jknn.knn_search(cf, cf, jnp.asarray(valid), k=k,
                               query_ids=jnp.arange(vox.shape[0], dtype=jnp.int32),
                               exclude_identical_index=True, selector="topk")
    v = valid
    for d_j, i_j in ((d_g, i_g), (d_b, i_b)):
        np.testing.assert_array_equal(d_t.numpy()[v], np.asarray(d_j)[v])
        np.testing.assert_array_equal(i_t.numpy()[v], np.asarray(i_j)[v])


def test_knn_self_grid_unfilled_slots(rng):
    """Fewer valid voxels than k: +inf distances, index 0 in the empty slots."""
    vox, valid = _grid_voxels(rng, 10, n_pad=6)
    d, i = tknn.knn_self_grid(_t(vox), _t(valid), k=12)
    d, i = d.numpy(), i.numpy()
    assert np.isinf(d[:10, 9:]).all() and np.isfinite(d[:10, :9]).all()
    assert (i[:10, 9:] == 0).all()
    d_j, i_j = jknn.knn_self_grid(jnp.asarray(vox), jnp.asarray(valid), k=12)
    np.testing.assert_array_equal(d[:10], np.asarray(d_j)[:10])
    np.testing.assert_array_equal(i[:10, :9], np.asarray(i_j)[:10, :9])


def test_kernel_offsets_same_tap_order():
    np.testing.assert_array_equal(tsc.kernel_offsets_3d(3), jsc.kernel_offsets_3d(3))


@pytest.mark.parametrize("n_pad", [0, 20])
def test_build_neighbor_table_exact(rng, n_pad):
    vox, valid = _grid_voxels(rng, 500, n_pad=n_pad)
    got = tsc.build_neighbor_table(_t(vox), _t(valid))
    ref = np.asarray(jsc.build_neighbor_table(jnp.asarray(vox), jnp.asarray(valid)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sparse_conv3_and_conv1(rng):
    vox, valid = _grid_voxels(rng, 300, n_pad=10)
    M = vox.shape[0]
    nbr = np.asarray(jsc.build_neighbor_table(jnp.asarray(vox), jnp.asarray(valid)))
    f = rng.normal(size=(M, 9)).astype(np.float32)
    w3 = rng.normal(size=(27, 9, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    w1 = rng.normal(size=(9, 4)).astype(np.float32)
    ref3 = jsc.sparse_conv3(jnp.asarray(f), jnp.asarray(nbr), jnp.asarray(w3),
                            jnp.asarray(valid), bias=jnp.asarray(b))
    got3 = tsc.sparse_conv3(_t(f), _t(nbr), _t(w3), _t(valid), bias=_t(b))
    np.testing.assert_allclose(got3.numpy(), np.asarray(ref3), rtol=1e-5, atol=1e-5)
    ref1 = jsc.sparse_conv1(jnp.asarray(f), jnp.asarray(w1), jnp.asarray(valid),
                            bias=jnp.asarray(b[:4]))
    got1 = tsc.sparse_conv1(_t(f), _t(w1.T), _t(valid), bias=_t(b[:4]))
    np.testing.assert_allclose(got1.numpy(), np.asarray(ref1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cover", [0.1, 0.6, 0.0])
def test_nearest_donor_and_fill_exact(rng, cover):
    n = 400
    coords = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    has = rng.uniform(size=n) < cover
    valid = rng.uniform(size=n) < 0.95
    feats = rng.normal(size=(n, 6)).astype(np.float32)
    d_j, f_j = jknn.nearest_donor(jnp.asarray(coords), jnp.asarray(has),
                                  jnp.asarray(valid))
    d_t, f_t = tknn.nearest_donor(_t(coords), _t(has), _t(valid))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    fill_j = jknn.nearest_fill(jnp.asarray(feats), jnp.asarray(coords),
                               jnp.asarray(has), jnp.asarray(valid))
    fill_t = tknn.nearest_fill(_t(feats), _t(coords), _t(has), _t(valid))
    np.testing.assert_array_equal(fill_t.numpy(), np.asarray(fill_j))


@pytest.mark.parametrize("preset", ["scannet", "tiny"])
def test_config_trees_equal(preset):
    from geopurify_tpu.config import load_config as jload
    from geopurify_tpu_torch.config import load_config as tload

    over = ["pooling.band=4096", "xdecoder.view_batch=2"]
    assert dataclasses.asdict(tload(preset)) == dataclasses.asdict(jload(preset))
    assert (dataclasses.asdict(tload(preset, overrides=over))
            == dataclasses.asdict(jload(preset, overrides=over)))
