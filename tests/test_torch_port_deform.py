"""Multi-scale deformable attention and the deformable pixel decoder held
against the JAX package on the CPU: ``bilinear_sample`` and
``ms_deform_attn`` (sampling points inside and outside the maps; f32 rel <
1e-5, bf16 values against the JAX bf16 path) and its autograd gradients
against ``jax.grad`` for the values, the locations and the weights;
``make_reference_points``; ``MSDeformAttnPixelDecoder`` (f32 and bf16;
``tests/test_torch_port_seg2d.py`` holds it inside ``XDecoderSegModel``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.models import pixel_decoder_deform as jpdd
from geopurify_tpu.ops import ms_deform_attn as jmsda
from geopurify_tpu_torch.models import pixel_decoder_deform as tpdd
from geopurify_tpu_torch.ops import ms_deform_attn as tmsda
from geopurify_tpu_torch.utils.from_jax import params_from_jax
from tests.test_torch_port_backbones2d import _rel, seeded_jax_params

SHAPES = ((6, 9), (3, 5), (2, 2))


def _attn_inputs(seed=0, B=2, Q=7, H=2, D=4, P=3, shapes=SHAPES):
    """Values, locations in [-0.25, 1.25] (a share outside the maps) and
    softmaxed weights."""
    rng = np.random.default_rng(seed)
    L = sum(h * w for h, w in shapes)
    value = rng.normal(size=(B, L, H, D)).astype(np.float32)
    loc = rng.uniform(-0.25, 1.25, size=(B, Q, H, len(shapes), P, 2)).astype(np.float32)
    w = rng.normal(size=(B, Q, H, len(shapes) * P)).astype(np.float32)
    w = np.exp(w) / np.exp(w).sum(-1, keepdims=True)
    return value, loc, w.reshape(B, Q, H, len(shapes), P)


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(1)
    value = rng.normal(size=(5, 7, 3)).astype(np.float32)
    x = rng.uniform(-1.5, 7.5, 64).astype(np.float32)
    y = rng.uniform(-1.5, 5.5, 64).astype(np.float32)
    x[:4], y[:4] = [0.0, 6.0, -1.0, 6.5], [0.0, 4.0, 2.0, 4.5]   # on and past the edges
    ref = np.asarray(jmsda.bilinear_sample(jnp.asarray(value), jnp.asarray(x), jnp.asarray(y)))
    got = tmsda.bilinear_sample(torch.from_numpy(value), torch.from_numpy(x),
                                torch.from_numpy(y)).numpy()
    assert got.shape == ref.shape == (64, 3)
    assert np.abs(got - ref).max() < 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ms_deform_attn_matches_jax(dtype):
    value, loc, w = _attn_inputs()
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jmsda.ms_deform_attn(jnp.asarray(value, jdt), SHAPES, jnp.asarray(loc),
                               jnp.asarray(w))
    got = tmsda.ms_deform_attn(torch.from_numpy(value).to(getattr(torch, dtype)), SHAPES,
                               torch.from_numpy(loc), torch.from_numpy(w))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 7, 8)
    r = _rel(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    assert r < (1e-5 if dtype == "float32" else 1e-2), r


def test_ms_deform_attn_gradient_matches_jax():
    """d<out, cot> / d(value, locations, weights) through autograd."""
    value, loc, w = _attn_inputs(seed=3, P=2)
    cot = np.random.default_rng(4).normal(size=(2, 7, 8)).astype(np.float32)

    def f(v, s, a):
        return jnp.sum(jmsda.ms_deform_attn(v, SHAPES, s, a) * cot)

    ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(value), jnp.asarray(loc), jnp.asarray(w))
    args = [torch.from_numpy(a).requires_grad_() for a in (value, loc, w)]
    (tmsda.ms_deform_attn(args[0], SHAPES, args[1], args[2]) * torch.from_numpy(cot)).sum() \
        .backward()
    for name, a, r in zip(("value", "locations", "weights"), args, ref):
        assert _rel(a.grad.numpy(), r) < 1e-5, name


def test_reference_points_match_jax():
    ref = np.asarray(jpdd.make_reference_points(SHAPES))
    got = tpdd.make_reference_points(SHAPES).numpy()
    assert got.shape == ref.shape and np.array_equal(got, ref)


def test_deform_pixel_decoder_matches_jax():
    """One set of seeded weights through both decoders, f32 then bf16."""
    rng = np.random.default_rng(5)
    chans = (8, 16, 32, 64)
    feats = {f"res{i + 2}": rng.normal(size=(2, 16 // 2 ** i, 24 // 2 ** i, chans[i]))
             .astype(np.float32) for i in range(4)}
    kw = dict(conv_dim=16, mask_dim=16, num_enc_layers=2, num_heads=2, dim_feedforward=32)
    params = seeded_jax_params(tpdd.MSDeformAttnPixelDecoder(chans, **kw), 6, scale=0.3)
    state = params_from_jax(params)
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 3e-2)):
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        ref = jax.jit(jpdd.MSDeformAttnPixelDecoder(**kw, dtype=jdt).apply)(
            params, {k: jnp.asarray(v, jdt) for k, v in feats.items()})
        tm = tpdd.MSDeformAttnPixelDecoder(chans, **kw, dtype=getattr(torch, dtype)).eval()
        tm.load_state_dict(state)
        with torch.no_grad():
            got = tm({k: torch.from_numpy(v).to(getattr(torch, dtype))
                      for k, v in feats.items()})
        for a, b in [(got[0], ref[0]), (got[1], ref[1]), *zip(got[2], ref[2])]:
            assert a.dtype == getattr(torch, dtype)
            r = _rel(a.float().numpy(), np.asarray(b.astype(jnp.float32)))
            assert r < tol, (dtype, r)
