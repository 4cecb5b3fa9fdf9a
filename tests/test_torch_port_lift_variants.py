"""The dense lift API and the lseg / ape lift backends held against the JAX
package on the CPU: ``lift_view_features``, ``fuse_views``,
``lift_view_dense`` and ``lift_view_instance`` (f32 to rel 1e-5, counts
exactly), the backend registry, and ``lift_scene`` of the smoke pipeline
with the same lseg / ape callable registered on both sides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.models import lift as jlift
from geopurify_tpu.models import lift_backends as jbackends
from geopurify_tpu.models import lift_variants as jvariants
from geopurify_tpu_torch.config import load_config
from geopurify_tpu_torch.models import lift as tlift
from geopurify_tpu_torch.models import lift_backends as tbackends
from geopurify_tpu_torch.models import lift_variants as tvariants
from geopurify_tpu_torch.run import train as ttrain
from tests.test_torch_port_lift import _t, _view
from tests.test_torch_port_pipeline import build_pair, smoke_scene

H, W = 64, 96


def _close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("Pv", [64, 700])    # point-evaluated / full-grid resize
def test_lift_view_features_matches_jax(rng, Pv):
    args = _view(rng, Pv=Pv)
    ref = jlift.lift_view_features(*[jnp.asarray(a) for a in args], jnp.float32(20.0),
                                   (H, W), mask_threshold=0.5)
    got = tlift.lift_view_features(*[_t(a) for a in args], 20.0, (H, W), mask_threshold=0.5)
    _close(got.features, ref.features)
    _close(got.logits, ref.logits, atol=1e-5)
    # covered, hole-filled and padding points all occur
    norms = np.linalg.norm(got.features.numpy(), axis=1)
    assert (norms == 0).any() and (np.abs(norms - 1) < 1e-5).sum() > 10


def test_fuse_views_matches_jax(rng):
    V, Pv, C, n_cls, P = 5, 80, 12, 4, 150
    feats = rng.normal(size=(V, Pv, C)).astype(np.float32)
    logits = rng.normal(size=(V, Pv, n_cls)).astype(np.float32)
    ids = np.stack([rng.choice(P, Pv, replace=False) for _ in range(V)]).astype(np.int32)
    valid = rng.uniform(size=(V, Pv)) < 0.9
    ids[~valid] = P
    ref_f, ref_c = jlift.fuse_views(jnp.asarray(feats), jnp.asarray(logits),
                                    jnp.asarray(ids), jnp.asarray(valid),
                                    num_points=P, top_k=3)
    got_f, got_c = tlift.fuse_views(_t(feats), _t(logits), _t(ids), _t(valid),
                                    num_points=P, top_k=3)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
    _close(got_f, ref_f)
    assert (got_c.numpy() >= 4).any() and (got_c.numpy() == 0).any()


def test_lift_view_dense_matches_jax(rng):
    _, _, _, rows, cols, pv_valid, coords, text = _view(rng, Pv=200)
    pix = rng.normal(size=(H // 2, W // 2, 16)).astype(np.float32)   # rows clip to H/2 - 1
    ref = jvariants.lift_view_dense(*[jnp.asarray(a) for a in (pix, rows, cols, pv_valid,
                                                               coords, text)],
                                    jnp.float32(20.0))
    got = tvariants.lift_view_dense(*[_t(a) for a in (pix, rows, cols, pv_valid, coords,
                                                      text)], 20.0)
    _close(got.features, ref.features)
    _close(got.logits, ref.logits, atol=1e-5)


def test_lift_view_instance_matches_jax(rng):
    _, _, _, rows, cols, pv_valid, coords, text = _view(rng, Pv=300)
    Q = 7
    masks = (rng.normal(size=(Q, H, W)) * 3.0 - 1.5).astype(np.float32)
    embeds = rng.normal(size=(Q, 16)).astype(np.float32)
    scores = rng.uniform(size=Q).astype(np.float32)
    inputs = (masks, embeds, scores, rows, cols, pv_valid, coords, text)
    ref = jvariants.lift_view_instance(*[jnp.asarray(a) for a in inputs], jnp.float32(20.0),
                                       mask_threshold=0.5)
    got = tvariants.lift_view_instance(*[_t(a) for a in inputs], 20.0, mask_threshold=0.5)
    _close(got.features, ref.features)
    _close(got.logits, ref.logits, atol=1e-5)


# the same backend callables on both sides, from one set of numpy weights:
# lseg maps each pixel's colour to 16 channels; ape makes 6 instance masks
# from the colours, with fixed embeddings and per-mask scores
_BW = np.random.default_rng(5).normal(size=(3, 16)).astype(np.float32)
_MW = np.random.default_rng(6).normal(size=(3, 6)).astype(np.float32) * 3
_EMB = np.random.default_rng(7).normal(size=(6, 16)).astype(np.float32)


def _lseg(xp, tanh):
    return lambda img: tanh(img / 255.0 @ xp(_BW) - 0.5)


def _ape(xp, tanh, sigmoid, mean, channels_first):
    def fn(img):
        masks = channels_first(tanh(img / 255.0 @ xp(_MW) - 1.0) * 4.0)
        return masks, xp(_EMB), sigmoid(mean(masks, (1, 2)))
    return fn


JAX_FNS = dict(lseg=_lseg(jnp.asarray, jnp.tanh),
               ape=_ape(jnp.asarray, jnp.tanh, jax.nn.sigmoid, jnp.mean,
                        lambda x: jnp.transpose(x, (2, 0, 1))))
TORCH_FNS = dict(lseg=_lseg(torch.from_numpy, torch.tanh),
                 ape=_ape(torch.from_numpy, torch.tanh, torch.sigmoid,
                          lambda x, d: x.mean(dim=d), lambda x: x.permute(2, 0, 1)))


@pytest.mark.parametrize("backend", ["lseg", "ape"])
def test_pipeline_lift_with_a_registered_backend_matches_jax(backend):
    cfg, jp, _, tp = build_pair()
    jx = dataclasses.replace(cfg.xdecoder, lift_backend=backend)
    jp.cfg = dataclasses.replace(cfg, xdecoder=jx)
    jp.lift_backend_fn = JAX_FNS[backend]
    jp._view_step = jax.jit(jp._view_step_impl)     # rebuilt for the new backend
    tp.cfg = dataclasses.replace(tp.cfg, xdecoder=dataclasses.replace(
        tp.cfg.xdecoder, lift_backend=backend))
    tp.lift_backend_fn = TORCH_FNS[backend]
    jb, tb = smoke_scene(2, cfg)
    ref = jp.lift_scene(jb)
    with torch.no_grad():
        fused, count = tp.lift_scene(tb)
    np.testing.assert_array_equal(count.numpy(), np.asarray(ref.view_count))
    _close(fused, ref.features, rtol=1e-4, atol=1e-5)
    assert (count.numpy() > 0).sum() > 100 and np.abs(fused.numpy()).max() > 0.1


def test_backend_registry(monkeypatch):
    monkeypatch.setattr(tbackends, "_REGISTRY", {})
    monkeypatch.setattr(jbackends, "_REGISTRY", {})
    with pytest.raises(KeyError, match="geopurify_tpu_torch.models.lift_backends"):
        tbackends.get_backend("lseg")
    cfg = load_config("tiny", overrides=["xdecoder.lift_backend=ape"])
    with pytest.raises(KeyError, match="'ape'"):
        ttrain.build_pipeline(cfg, torch.Generator().manual_seed(0), "cpu",
                              with_sonata=False)
    for mod, fns in ((tbackends, TORCH_FNS), (jbackends, JAX_FNS)):
        mod.register_backend("APE", fns["ape"])
        assert mod.get_backend("ape") is fns["ape"] and set(mod.available()) == {"ape"}
    pipe = ttrain.build_pipeline(cfg, torch.Generator().manual_seed(0), "cpu",
                                 with_sonata=False)
    assert pipe.lift_backend_fn is TORCH_FNS["ape"]
