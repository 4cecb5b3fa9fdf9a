"""Kernel K2's plain versions (the fused InfoNCE forward and backward) and
the unfused InfoNCE held against the JAX package on the CPU. The JAX side
runs ``info_nce_loss_fused`` in Pallas interpret mode, as
tests/test_pallas_infonce.py does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.ops.contrastive import info_nce_loss as j_info_nce
from geopurify_tpu.ops.pallas_infonce import info_nce_loss_fused as j_fused
from geopurify_tpu_torch.ops.contrastive import info_nce_loss as t_info_nce
from geopurify_tpu_torch.ops.infonce import (
    info_nce_bwd,
    info_nce_fwd,
    info_nce_loss_fused,
)


def _data(seed, A, NEG, E, p_valid=0.8):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(A, E)).astype(np.float32)
    p = rng.normal(size=(A, E)).astype(np.float32)
    n = rng.normal(size=(A, NEG, E)).astype(np.float32)
    valid = rng.random(A) < p_valid
    return a, p, n, valid


def _t(*xs, grad=False):
    return [torch.from_numpy(x).requires_grad_(grad and x.dtype != bool) for x in xs]


@pytest.mark.parametrize("A,NEG,E,T", [(512, 7, 16, 0.07), (512, 5, 8, 0.1)])
def test_fused_value_and_grads_match_jax(A, NEG, E, T):
    a, p, n, valid = _data(A + NEG, A, NEG, E)
    jv = jnp.asarray(valid)
    ref, jg = jax.value_and_grad(
        lambda x, y, z: j_fused(x, y, z, jv, T, True), argnums=(0, 1, 2))(
            jnp.asarray(a), jnp.asarray(p), jnp.asarray(n))
    ta, tp, tn = _t(a, p, n, grad=True)
    n0, n1 = info_nce_fwd.launches, info_nce_bwd.launches
    got = info_nce_loss_fused(ta, tp, tn, torch.from_numpy(valid), T)
    got.backward()
    # CPU tensors run the plain versions: no kernel launch is counted
    assert (info_nce_fwd.launches, info_nce_bwd.launches) == (n0, n1)
    assert got.item() == pytest.approx(float(ref), rel=1e-5)
    for t, j in zip((ta, tp, tn), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=2e-4, atol=1e-6)


def test_fused_all_invalid_is_zero():
    a, p, n, _ = _data(1, 64, 3, 8)
    ta, tp, tn = _t(a, p, n, grad=True)
    loss = info_nce_loss_fused(ta, tp, tn, torch.zeros(64, dtype=torch.bool), 0.07)
    assert loss.item() == 0.0
    loss.backward()
    for t in (ta, tp, tn):
        assert torch.count_nonzero(t.grad) == 0


def test_unfused_loss_matches_jax():
    a, p, n, valid = _data(2, 96, 7, 16)
    args = [jnp.asarray(x) for x in (a, p, n, valid)]
    ref, jg = jax.value_and_grad(
        lambda x, y, z: j_info_nce(x, y, z, args[3], 0.07), argnums=(0, 1, 2))(*args[:3])
    ta, tp, tn = _t(a, p, n, grad=True)
    got = t_info_nce(ta, tp, tn, torch.from_numpy(valid), 0.07)
    got.backward()
    assert got.item() == pytest.approx(float(ref), rel=1e-5)
    for t, j in zip((ta, tp, tn), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=2e-4, atol=1e-6)


def test_fused_gradcheck_f64():
    a, p, n, valid = _data(3, 8, 3, 4, p_valid=0.7)
    xs = [torch.from_numpy(x.astype(np.float64)).requires_grad_() for x in (a, p, n)]
    v = torch.from_numpy(valid)
    assert torch.autograd.gradcheck(
        lambda x, y, z: info_nce_loss_fused(x, y, z, v, 0.5), xs)
