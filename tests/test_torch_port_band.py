"""Kernel K1 (banded-window matmul) and the banded smoothing path, port
against JAX on the CPU: the plain version against the Pallas kernel in
interpret mode, the banded operator bit for bit, and the smoothing rounds
through both the banded branch and the gather fallback."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.ops import pooling as jpool
from geopurify_tpu.ops.pallas_band import banded_window_matmul as j_bwm
from geopurify_tpu_torch.ops import pooling as tpool
from geopurify_tpu_torch.ops.band import (
    banded_window_matmul,
    banded_window_matmul_ref,
)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16(x):
    """numpy f32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, _t(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("C", [128, 19])
def test_band_ref_matches_pallas_interpret(rng, C):
    M, band, row_tile, row_sub = 700, 256, 128, 8
    Mp = -(-M // row_tile) * row_tile
    n_t = Mp // row_tile
    S_j, S_t = _bf16(rng.normal(size=(Mp, band)).astype(np.float32))
    starts = (rng.integers(0, M - band, size=(n_t,)) // 8 * 8).astype(np.int32)
    f_j, f_t = _bf16(rng.normal(size=(M, C)).astype(np.float32))
    ref = j_bwm(S_j, jnp.asarray(starts), f_j, band=band, row_tile=row_tile,
                row_sub=row_sub, interpret=True)
    got = banded_window_matmul_ref(S_t, _t(starts), f_t, band=band, row_tile=row_tile)
    assert got.dtype == torch.float32 and got.shape == (Mp, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)
    # the wrapper takes the plain version for CPU tensors, and counts no launch
    n0 = banded_window_matmul.launches
    out = banded_window_matmul(S_t, _t(starts), f_t, band=band, row_tile=row_tile)
    np.testing.assert_array_equal(out.numpy(), got.numpy())
    assert banded_window_matmul.launches == n0


def _graph(rng, M, K, n_dead_rows=5):
    """Spatially-local unique-neighbour graph with a few dead rows/slots."""
    nbr = np.zeros((M, K), np.int32)
    for i in range(M):
        cand = np.clip(i + rng.integers(-90, 90, size=4 * K), 0, M - 1)
        cand = cand[cand != i]
        u = np.unique(cand)
        rng.shuffle(u)
        nbr[i] = u[:K]
    w = rng.uniform(0.1, 1.0, (M, K)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    dead = rng.choice(M, n_dead_rows, replace=False)
    w[dead] = 0.0
    w[rng.uniform(size=(M, K)) < 0.02] = 0.0
    return nbr, w


@pytest.mark.parametrize("max_residual", [4096, 64])
def test_build_banded_operator_exact(rng, max_residual):
    M, K, band, row_tile = 777, 12, 128, 64
    nbr, w = _graph(rng, M, K)
    opj = jpool.build_banded_operator(
        jnp.asarray(w), jnp.asarray(nbr), band=band, row_tile=row_tile,
        max_residual=max_residual, assume_unique_neighbors=True)
    opt = tpool.build_banded_operator(
        _t(w), _t(nbr), band=band, row_tile=row_tile, max_residual=max_residual)
    S_j = np.asarray(opj.S.astype(jnp.float32))
    assert opt.S.dtype == torch.bfloat16
    np.testing.assert_array_equal(opt.S.float().numpy(), S_j)      # bit-equal
    for name in ("starts", "res_row", "res_col", "res_w", "n_dropped",
                 "grp_row", "grp_col", "grp_w"):
        np.testing.assert_array_equal(
            getattr(opt, name).numpy(), np.asarray(getattr(opj, name)),
            err_msg=name)
    assert np.all(np.diff(opt.res_row.numpy()) >= 0)
    if max_residual == 64:
        assert int(opt.n_dropped) > 0


def test_iterate_pooling_banded_matches_jax(rng):
    M, K, band, row_tile, C = 777, 12, 128, 64, 19
    nbr, w = _graph(rng, M, K)
    feats = rng.normal(size=(M, C)).astype(np.float32)
    opj = jpool.build_banded_operator(jnp.asarray(w), jnp.asarray(nbr), band=band,
                                      row_tile=row_tile, max_residual=4096,
                                      assume_unique_neighbors=True)
    ref = jpool.iterate_pooling_banded(opj, jnp.asarray(feats), num_iterations=5,
                                       band=band, row_tile=row_tile)
    opt = tpool.build_banded_operator(_t(w), _t(nbr), band=band, row_tile=row_tile,
                                      max_residual=4096)
    got = tpool.iterate_pooling_banded(opt, _t(feats), num_iterations=5, band=band,
                                       row_tile=row_tile)
    # bf16 between rounds on both sides: agreement to a few bf16 ulps
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-2, atol=2e-2)
    assert np.mean(np.abs(got.numpy() - np.asarray(ref))) < 2e-3


def _pool_scene(rng, M=900):
    ext = 14
    allc = np.stack(np.meshgrid(*[np.arange(ext)] * 3, indexing="ij"), -1).reshape(-1, 3)
    vox = allc[np.sort(rng.choice(allc.shape[0], M, replace=False))].astype(np.int32)
    valid = np.ones(M, bool)
    valid[-9:] = False
    emb = rng.normal(size=(M, 16)).astype(np.float32)
    feats = rng.normal(size=(M, 19)).astype(np.float32)
    return vox, valid, emb, feats


@pytest.mark.parametrize("max_residual,expect_overflow", [(16384, False), (64, True)])
def test_geometry_guided_pooling_matches_jax(rng, max_residual, expect_overflow):
    """Band below M, so the banded branch runs; a tiny residual capacity
    forces the exact gather fallback."""
    vox, valid, emb, feats = _pool_scene(rng)
    kw = dict(k=16, sharpen=20.0, num_iterations=4, spmm_mode="banded",
              band=512, max_residual=max_residual)
    ref, ov_j = jpool.geometry_guided_pooling(
        jnp.asarray(emb), jnp.asarray(feats), jnp.asarray(vox), jnp.asarray(valid),
        knn_radius=3, knn_candidates=512, **kw)
    got, ov_t = tpool.geometry_guided_pooling(_t(emb), _t(feats), _t(vox), _t(valid), **kw)
    assert ov_t == int(ov_j)
    assert (ov_t > 0) == expect_overflow
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-2, atol=2e-2)
    assert np.mean(np.abs(got.numpy() - np.asarray(ref))) < 2e-3


def test_affinity_graph_matches_jax(rng):
    vox, valid, emb, _ = _pool_scene(rng)
    nbr_j, w_j = jpool.build_affinity_graph(
        jnp.asarray(emb), jnp.asarray(vox), jnp.asarray(valid), k=16,
        knn_radius=3, knn_candidates=512)
    nbr_t, w_t = tpool.build_affinity_graph(_t(emb), _t(vox), _t(valid), k=16)
    live = np.asarray(w_j) > 0
    np.testing.assert_array_equal(nbr_t.numpy()[live], np.asarray(nbr_j)[live])
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-6)


def test_iterate_pooling_gather_f32_matches_jax(rng):
    M, K = 300, 10
    nbr, w = _graph(rng, M, K)
    feats = rng.normal(size=(M, 7)).astype(np.float32)
    ref = jpool.iterate_pooling(jnp.asarray(w), jnp.asarray(nbr), jnp.asarray(feats),
                                num_iterations=6, compute_dtype=jnp.float32)
    got = tpool.iterate_pooling(_t(w), _t(nbr), _t(feats), num_iterations=6,
                                compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# K1's launch plan (host side; the kernels themselves run only on a card)
# ---------------------------------------------------------------------------

_PRESET_CLASSES = {"scannet": 19, "matterport": 21, "matterport40": 40,
                   "matterport80": 80, "matterport160": 160, "scannet200": 200}


@pytest.mark.parametrize("row_tile", [2048, 128, 384])
def test_k1_plan_covers_every_width(row_tile):
    from geopurify_tpu_torch.ops.band import WGMMA_COLS, _plan

    assert list(WGMMA_COLS) == sorted(WGMMA_COLS) and WGMMA_COLS[-1] == 256
    assert all(b % 8 == 0 for b in WGMMA_COLS)          # the wgmma N step
    for C in range(1, 513):
        p = _plan(C, row_tile)
        assert p.slabs * p.bn == p.ldf >= C and p.ldf % 8 == 0
        if C <= 32:
            assert (p.kernel, p.bn, p.ldf, p.cluster) == ("wmma", 32, 32, 1)
            continue
        assert p.kernel == "wgmma" and p.bn in WGMMA_COLS
        assert p.slabs == -(-C // 256) and p.bn <= 256
        per = -(-C // p.slabs)          # each slab's share of C
        assert per <= p.bn <= 1.25 * per, (C, p)
        assert p.cluster == (2 if row_tile % 256 == 0 else 1)


def test_k1_plan_at_the_presets():
    from geopurify_tpu_torch.ops.band import _plan

    got = {name: _plan(C, 2048)[:4] for name, C in _PRESET_CLASSES.items()}
    assert got == {"scannet": ("wmma", 32, 32, 1), "matterport": ("wmma", 32, 32, 1),
                   "matterport40": ("wgmma", 40, 40, 1),
                   "matterport80": ("wgmma", 80, 80, 1),
                   "matterport160": ("wgmma", 160, 160, 1),
                   "scannet200": ("wgmma", 200, 200, 1)}
    assert _plan(512, 2048)[:4] == ("wgmma", 256, 512, 2)      # feature space
    for bad in (0, 513):
        with pytest.raises(ValueError):
            _plan(bad, 2048)


def test_wgmma_header_is_generated_from_the_plan():
    from geopurify_tpu_torch.ops.band import WGMMA_COLS
    from geopurify_tpu_torch.utils.gen_wgmma import HEADER, render

    assert HEADER.read_text() == render(WGMMA_COLS)
