"""The port's naive Sonata check (``parity/compare.parity_sonata``), which
needs no reference tree: the port's SonataTeacher against the naive-loop
numpy Sonata of ``parity/sonata_oracle.py`` on seeded weights, the naive
copy and its curves against the JAX package's bit for bit, and
``utils.from_jax.sonata_to_jax`` as the inverse of ``params_from_jax``.
None of it traces JAX but the layout check's ``jax.eval_shape``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.models.sonata import SonataTeacher as JSonata
from geopurify_tpu.parity import sonata_oracle as jso
from geopurify_tpu_torch.ops.morton import hilbert_code, morton_code
from geopurify_tpu_torch.parity import compare
from geopurify_tpu_torch.parity import sonata_oracle as tso
from geopurify_tpu_torch.utils.from_jax import params_from_jax, sonata_to_jax

TOL = 1e-5


@pytest.fixture(scope="module")
def rows():
    return compare.parity_sonata(device="cpu")


@pytest.mark.parametrize("case", sorted(compare.SONATA_CASES))
def test_parity_sonata_rows(rows, case):
    mx, rel = rows[f"sonata/{case}"]
    assert rel < TOL, f"sonata/{case}: rel={rel:.3e} max|d|={mx:.3e}"


def test_parity_sonata_sees_a_pooling_mutant(rows):
    """The naive side max-pooling by mean must move the max-pool case far
    past the limit; the mean-pool case is that contract already."""
    mutant = compare.parity_sonata(device="cpu", mutate_naive={"pool_reduce": "mean"})
    assert mutant["sonata/maxpool_stem"][1] > 1e-2, mutant
    assert mutant["sonata/meanpool_affine"] == rows["sonata/meanpool_affine"]


def _coords():
    """Every corner and edge region of the 10-bit cube plus a seeded sweep."""
    edge = np.array([0, 1, 2, 3, 511, 512, 1021, 1022, 1023])
    grid = np.stack(np.meshgrid(edge, edge, edge, indexing="ij"), -1).reshape(-1, 3)
    rnd = np.random.default_rng(5).integers(0, 1024, (1500, 3))
    return np.concatenate([grid, rnd]).astype(np.int32)


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_naive_curves_match_ops_morton_and_jax(order):
    c = _coords()
    t = torch.from_numpy(c)
    if order < 2:
        vec = morton_code(t, order).numpy()
        ours = [tso.morton_naive(*map(int, p), order=order) for p in c]
        jax_naive = [jso.morton_naive(*map(int, p), order=order) for p in c]
    else:
        trans = order == 3
        vec = hilbert_code(t[:, [1, 0, 2]] if trans else t).numpy()
        ours = [tso.hilbert_naive(*map(int, p), trans=trans) for p in c]
        jax_naive = [jso.hilbert_naive(*map(int, p), trans=trans) for p in c]
    np.testing.assert_array_equal(np.asarray(ours, np.int64), vec.astype(np.int64))
    assert ours == jax_naive
    valid = np.ones(len(c), bool)
    valid[::7] = False
    np.testing.assert_array_equal(tso.serialize_naive(c, valid, order),
                                  jso.serialize_naive(c, valid, order))


def test_naive_forward_equals_jax_copy_bit_for_bit():
    """One shared numpy tree (the port teacher's seeded weights written by
    sonata_to_jax) through both naive copies, on a smaller scene."""
    kw = dict(compare.SONATA_CASES["maxpool_stem"], enc_depths=(2, 1, 1))
    feats, vc, vv, p2v, valid = compare.sonata_scene(seed=4, N=120, box=8)
    tree = sonata_to_jax(compare.seeded_sonata(kw, seed=2).state_dict())
    ours = tso.sonata_forward_naive(tree, feats, vc, vv, p2v, valid, **kw)
    theirs = jso.sonata_forward_naive(tree, feats, vc, vv, p2v, valid, **kw)
    assert np.isfinite(ours).all() and np.abs(ours[valid]).max() > 0
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("case", sorted(compare.SONATA_CASES))
def test_sonata_to_jax_round_trips_and_has_the_jax_layout(case):
    kw = compare.SONATA_CASES[case]
    sd = compare.seeded_sonata(kw).state_dict()
    tree = sonata_to_jax(sd)
    back = params_from_jax(tree)
    assert set(back) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)
    # the same leaves, names and shapes as the JAX teacher's parameter tree
    feats, vc, vv, p2v, valid = compare.sonata_scene(N=64, box=6)
    shapes = jax.eval_shape(
        lambda: JSonata(in_channels=6, dtype=jnp.float32, **kw).init(
            jax.random.key(0), *map(jnp.asarray, (feats, vc, vv, p2v, valid))))["params"]
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(np.shape(leaf))
           for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    assert got == want
