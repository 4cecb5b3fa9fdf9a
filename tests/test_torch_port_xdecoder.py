"""X-Decoder port held against the JAX package on the CPU, weights carried
across with utils.from_jax: FocalNet at FOCAL_SMALL, the FPN pixel decoder,
the query head, and the assembled model — in fp32 with exact erf (rel <
1e-5) and in bf16 with fast_gelu against the JAX bf16 path. The head's
chain through the 0.5 attention-mask threshold is compared in three steps:
the round-0 pre-threshold masks tightly, the flip fraction of the binarized
masks bounded, then the outputs with both sides forced onto the same masks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.config import FocalNetConfig, XDecoderConfig
from geopurify_tpu.models import xdecoder as jxd
from geopurify_tpu.parity.oracle import FOCAL_SMALL
from geopurify_tpu_torch import config as tconfig
from geopurify_tpu_torch.models import xdecoder as txd
from geopurify_tpu_torch.utils.from_jax import xdecoder_from_jax


def _t(x):
    return torch.from_numpy(np.array(np.asarray(x, np.float32)))


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _randomize(tree, seed, scale=0.1):
    """Seeded numpy weights in the JAX tree's shapes (norm scales near 1)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for path, leaf in leaves:
        x = rng.normal(size=leaf.shape).astype(np.float32) * scale
        if jax.tree_util.keystr(path).endswith("['scale']"):
            x = x + 1.0
        out.append(jnp.asarray(x))
    return jax.tree_util.tree_unflatten(treedef, out)


def _cfg(dtype="float32", **kw):
    base = dict(
        backbone=FocalNetConfig(**FOCAL_SMALL), hidden_dim=32, conv_dim=32,
        mask_dim=32, num_queries=9, nheads=4, dim_feedforward=64, dec_layers=3,
        enc_layers=2, mask_shape=(64, 96), dtype=dtype,
    )
    base.update(kw)
    return XDecoderConfig(**base)


def _tcfg(cfg):
    """The same XDecoderConfig as the port's own dataclass."""
    return tconfig._apply_dict(tconfig.XDecoderConfig(), dataclasses.asdict(cfg))


def _inputs(seed=0, B=2, hw=(64, 96), n_cls=6, dim=32):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (B, hw[0], hw[1], 3)).astype(np.float32)
    text = rng.normal(size=(n_cls + 1, dim)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    return img, text


@pytest.fixture(scope="module")
def models():
    """JAX and port models, f32 and bf16, on one set of seeded weights."""
    out = {}
    img, text = _inputs()
    for dtype in ("float32", "bfloat16"):
        cfg = _cfg(dtype)
        jm = jxd.XDecoderSegModel(cfg)
        shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(img[:1]),
                                jnp.asarray(text), jnp.float32(20.0))
        params = _randomize(shapes, seed=1)
        tm = txd.XDecoderSegModel(_tcfg(cfg)).eval()
        tm.load_state_dict(xdecoder_from_jax(jax.tree_util.tree_map(np.asarray, params)))
        out[dtype] = (cfg, jm, params, tm)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_focalnet_matches_jax(models, dtype):
    cfg, _, params, tm = models[dtype]
    img, _ = _inputs()
    x = jxd._normalize_and_pad(cfg, jnp.asarray(img))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jxd._make_backbone(cfg).apply({"params": params["params"]["backbone"]},
                                        x.astype(jdt))
    with torch.no_grad():
        got = tm.backbone(_t(x).to(txd.model_dtype(tm.cfg)))
    tol = 1e-5 if dtype == "float32" else 3e-2
    for k in ("res2", "res3", "res4", "res5"):
        assert got[k].dtype == txd.model_dtype(tm.cfg)
        r = _rel(got[k].float().numpy(), np.asarray(ref[k].astype(jnp.float32)))
        assert r < tol, f"{dtype} {k}: rel={r:.2e}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pixel_decoder_matches_jax(models, dtype):
    cfg, _, params, tm = models[dtype]
    rng = np.random.default_rng(3)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    feats = {f"res{i + 2}": rng.normal(size=(2, 16 // 2 ** i, 24 // 2 ** i, 16 * 2 ** i))
             .astype(np.float32) for i in range(4)}
    ref = jxd._make_pixel_decoder(cfg).apply(
        {"params": params["params"]["pixel_decoder"]},
        {k: jnp.asarray(v, jdt) for k, v in feats.items()})
    with torch.no_grad():
        got = tm.pixel_decoder({k: _t(v).to(txd.model_dtype(tm.cfg))
                                for k, v in feats.items()})
    tol = 1e-5 if dtype == "float32" else 3e-2
    r = _rel(got[0].float().numpy(), np.asarray(ref[0].astype(jnp.float32)))
    assert r < tol, f"mask_features rel={r:.2e}"
    for a, b in zip(got[2], ref[2]):
        assert _rel(a.float().numpy(), np.asarray(b.astype(jnp.float32))) < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_model_matches_jax_three_step(models, dtype):
    """Assembled model: pixel features, then the head in three steps."""
    cfg, jm, params, tm = models[dtype]
    img, text = _inputs()
    p = params["params"]
    mf_j, ms_j = jxd.encode_pixel_features(cfg, params, jnp.asarray(img))
    with torch.no_grad():
        mf_t, ms_t = txd.encode_pixel_features(tm, _t(img))
        free = txd.apply_head(tm, ms_t, mf_t, _t(text), 20.0, return_attn=True)
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert _rel(mf_t.float().numpy(), np.asarray(mf_j.astype(jnp.float32))) < tol

    # (1) round-0 pre-threshold attention logits at the level-0 size, against
    # JAX's reference-order resize of its round-0 stride-4 masks
    # (2) flip fraction of the binarized masks against JAX's reference-order
    # masks (return_aux=True resizes after the einsum: same math,
    # re-associated)
    head = jxd._make_head(cfg)
    aux = head.apply({"params": p["predictor"]}, list(ms_j), mf_j, jnp.asarray(text),
                     jnp.float32(20.0), return_aux=True)
    flips = [np.mean(a.numpy() != np.asarray(b)[:, 0])
             for a, b in zip(free["attn_masks"], aux["aux_attn"])]
    # bf16: each free-running round feeds its bf16-rounded queries into the
    # next threshold, so the two chains drift by more flips than in f32
    assert max(flips) < (1e-2 if dtype == "float32" else 1e-1), flips
    lvl0 = tuple(ms_j[0].shape[1:3])
    ref0 = jxd.resize_bicubic_antialias(aux["aux_masks"][0].transpose(0, 2, 3, 1), lvl0)
    r0 = _rel(free["attn_logits0"].numpy(), np.asarray(ref0.transpose(0, 3, 1, 2)))
    assert r0 < (1e-5 if dtype == "float32" else 3e-2), f"round-0 logits rel={r0:.2e}"

    # (3) both sides forced onto the port's binarized masks
    forced = [m.numpy() for m in free["attn_masks"][:-1]]
    ref = head.apply({"params": p["predictor"]}, list(ms_j), mf_j, jnp.asarray(text),
                     jnp.float32(20.0), attn_mask_override=[jnp.asarray(m) for m in forced])
    # the port with the same forced masks reproduces its free run exactly
    with torch.no_grad():
        got = txd.apply_head(tm, ms_t, mf_t, _t(text), 20.0,
                             attn_mask_override=[torch.from_numpy(m) for m in forced])
    np.testing.assert_array_equal(got["pred_masks"].numpy(), free["pred_masks"].numpy())
    htol = 1e-5 if dtype == "float32" else 5e-2
    for k in ("pred_logits", "pred_masks", "mask_embed", "cls_logits"):
        r = _rel(got[k].float().numpy(), np.asarray(ref[k]).astype(np.float32))
        assert r < htol, f"{dtype} {k}: rel={r:.2e}"
    assert got["pred_masks"].shape == (2, cfg.num_queries - 1, 16, 24)


def test_model_forward_outputs(models):
    cfg, jm, params, tm = models["float32"]
    img, text = _inputs()
    with torch.no_grad():
        out = tm(_t(img), _t(text), 20.0)
    assert out["pred_logits"].shape == (2, cfg.num_queries - 1, text.shape[0])
    assert out["mask_embed"].shape == (2, cfg.num_queries - 1, cfg.hidden_dim)
    assert out["padded_hw"].tolist() == [64, 96]
    assert all(torch.isfinite(v).all() for v in out.values())
