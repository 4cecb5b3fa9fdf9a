"""The z-stacked 3^3 conv held against the JAX package and the plain table
on the CPU: ``build_zstack_table``'s fields (integers exact), the conv on a
scene with z-holes, the overflow route, the student forward, and the
``student.zstack_min_voxels`` gate of ``evaluate_scene``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.models.student import AffinityPredictor as JStudent
from geopurify_tpu.ops import sparse_conv as jsc
from geopurify_tpu_torch.models.student import AffinityPredictor as TStudent
from geopurify_tpu_torch.ops import sparse_conv as tsc
from geopurify_tpu_torch.utils.from_jax import student_from_jax
from tests.test_torch_port_pipeline import build_pair, smoke_scene
from tests.test_torch_port_student import _vars


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(rng, extent=7, n=700, n_pad=9):
    """Unique lex-sorted voxels at random occupancy (z-holes aplenty), then
    padding rows: (coords, valid, plain table) as numpy and torch."""
    c = np.unique(rng.integers(0, extent, (n, 3)), axis=0).astype(np.int32)
    c = np.concatenate([c, np.zeros((n_pad, 3), np.int32)])
    valid = np.arange(c.shape[0]) < c.shape[0] - n_pad
    nbr = tsc.build_neighbor_table(_t(c), _t(valid))
    return c, valid, nbr


@pytest.mark.parametrize("budget", [256, 1])
def test_build_zstack_table_matches_jax(rng, budget):
    c, valid, nbr = _scene(rng)
    ref = jsc.build_zstack_table(jnp.asarray(c), jnp.asarray(valid), jnp.asarray(nbr.numpy()),
                                 res_budget=budget)
    got = tsc.build_zstack_table(_t(c), _t(valid), nbr, res_budget=budget)
    assert got._fields == ref._fields
    for name in ref._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert bool(got.overflow) == (budget == 1)


def test_zstack_conv_matches_plain(rng):
    c, valid, nbr = _scene(rng)
    zt = tsc.build_zstack_table(_t(c), _t(valid), nbr, res_budget=256)
    assert not bool(zt.overflow)
    assert int(zt.res_cnt.sum()) > 0, "no z-holes: the residual is not exercised"
    M = c.shape[0]
    f = _t(rng.normal(size=(M, 12)).astype(np.float32))
    w = _t((rng.normal(size=(27, 12, 10)) * 0.1).astype(np.float32))
    b = _t(rng.normal(size=(10,)).astype(np.float32))
    n0 = dict(tsc.ZSTACK_ROUTES)
    ref = tsc.sparse_conv3(f, nbr, w, _t(valid), bias=b)
    got = tsc.sparse_conv3(f, zt, w, _t(valid), bias=b)
    assert tsc.ZSTACK_ROUTES["zstack"] == n0["zstack"] + 1
    assert tsc.ZSTACK_ROUTES["overflow"] == n0["overflow"]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)
    assert (got.numpy()[~valid] == 0).all()


def test_zstack_overflow_routes_exactly(rng):
    """A residual budget of 1 overflows: the tap scan over the plain table
    runs, bit for bit the plain conv, and the route is counted."""
    c, valid, nbr = _scene(rng)
    zt = tsc.build_zstack_table(_t(c), _t(valid), nbr, res_budget=1)
    assert bool(zt.overflow)
    M = c.shape[0]
    f = _t(rng.normal(size=(M, 8)).astype(np.float32))
    w = _t((rng.normal(size=(27, 8, 6)) * 0.1).astype(np.float32))
    n0 = dict(tsc.ZSTACK_ROUTES)
    got = tsc.sparse_conv3(f, zt, w, _t(valid))
    assert tsc.ZSTACK_ROUTES["overflow"] == n0["overflow"] + 1
    assert tsc.ZSTACK_ROUTES["zstack"] == n0["zstack"]
    assert torch.equal(got, tsc.sparse_conv3(f, nbr, w, _t(valid)))


def test_student_forward_zstack_matches_jax(rng):
    c, valid, nbr = _scene(rng, extent=6, n=500)
    M = c.shape[0]
    js = JStudent(input_dim=14, hidden_dim=16, embed_dim=8, num_res_blocks=2)
    variables = jax.tree_util.tree_map(jnp.asarray, _vars(js, 14, seed=3))
    jn = jnp.asarray(nbr.numpy())
    jzt = jsc.build_zstack_table(jnp.asarray(c), jnp.asarray(valid), jn, res_budget=256)
    f = rng.normal(size=(M, 14)).astype(np.float32)
    ref = np.asarray(js.apply(variables, jnp.asarray(f), jzt, jnp.asarray(valid), train=False))
    ts = TStudent(14, 16, 8, 2).eval()
    ts.load_state_dict(student_from_jax(variables))
    zt = tsc.build_zstack_table(_t(c), _t(valid), nbr, res_budget=256)
    with torch.no_grad():
        got = ts(_t(f), zt, _t(valid)).numpy()
        plain = ts(_t(f), nbr, _t(valid)).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 2e-4
    assert np.abs(got - plain).max() / scale < 2e-4
    assert (got[~valid] == 0).all()


def test_evaluate_scene_zstack_gate():
    """``student.zstack_min_voxels`` lowered below M sends the student
    through the z-stack (counted) and leaves predictions and logits as with
    the gate off (M = 256 < 131072, the plain table)."""
    cfg, _, _, tp = build_pair()
    _, tb = smoke_scene(1, cfg)
    n0 = sum(tsc.ZSTACK_ROUTES.values())
    out = tp.evaluate_scene(tb)
    assert sum(tsc.ZSTACK_ROUTES.values()) == n0
    tp.cfg = dataclasses.replace(
        tp.cfg, student=dataclasses.replace(tp.cfg.student, zstack_min_voxels=1))
    out_z = tp.evaluate_scene(tb)
    convs = 1 + 2 * cfg.student.num_res_blocks
    assert sum(tsc.ZSTACK_ROUTES.values()) == n0 + convs
    valid = tb.point_valid
    assert torch.equal(out_z["pred"][valid], out["pred"][valid])
    np.testing.assert_allclose(out_z["logits"][valid].numpy(), out["logits"][valid].numpy(),
                               rtol=5e-4, atol=5e-4)
