"""The port's side of the reference-oracle harness (``parity/compare.py``)
held against stand-in oracles, on the CPU, without the reference tree.

Each stand-in is the record the reference oracle would return, in its
schema: the reference-layout state dict written from a seeded port module
by ``convert_xdecoder.synthesize_torch_state_dict``, and the activations
from the JAX package's module on the same weights (handed across with
``tests/test_torch_port_backbones2d.seeded_jax_params``, no traced init),
which the JAX harness holds at ~1e-6 against the reference
(PARITY_REPORT.md). ``parity_focalnet``, ``parity_pixel_decoder``,
``parity_head`` and ``parity_lift`` take the stand-in through their ``ref``
seam at ``FOCAL_SMALL`` / the oracles' default sizes and must agree within
rel 1e-5; the same stand-in with one layer's weights permuted must fail."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geopurify_tpu.models import focalnet as jfocal
from geopurify_tpu.models import pixel_decoder as jpixdec
from geopurify_tpu.models import xdecoder as jxdec
from geopurify_tpu.parity import compare as jcompare
from geopurify_tpu_torch.models import focalnet as tfocal
from geopurify_tpu_torch.models import pixel_decoder as tpixdec
from geopurify_tpu_torch.models import xdecoder as txdec
from geopurify_tpu_torch.parity import compare
from geopurify_tpu_torch.parity.oracle import FOCAL_SMALL
from geopurify_tpu_torch.utils.convert_xdecoder import synthesize_torch_state_dict
from tests.test_torch_port_backbones2d import seeded_jax_params

TOL = 1e-5


def _reference_sd(module, part: str):
    """The reference-layout state dict of a seeded port ``module`` standing
    in as the X-Decoder's ``part`` (backbone / pixel_decoder / predictor)."""
    return synthesize_torch_state_dict(
        {f"{part}.{k}": v for k, v in module.state_dict().items()}, {})


def _nhwc(rng, shape):
    return rng.normal(0, 1, shape).astype(np.float32)


def focalnet_standin():
    kw = dict(embed_dim=FOCAL_SMALL["embed_dim"], depths=FOCAL_SMALL["depths"],
              focal_levels=(4, 4, 4, 4), focal_windows=(3, 3, 3, 3))
    port = tfocal.FocalNet(**kw)
    params = seeded_jax_params(port, 3)
    x = np.random.default_rng(0).uniform(-1, 1, (1, 64, 96, 3)).astype(np.float32)
    acts = jax.jit(jfocal.FocalNet(**kw, dtype=jnp.float32).apply)(params, jnp.asarray(x))
    return {"input_nhwc": x, "acts": {k: np.asarray(v) for k, v in acts.items()},
            "sd": _reference_sd(port, "backbone"), "depths": FOCAL_SMALL["depths"]}


def pixel_decoder_standin(channels=(16, 32, 64, 128), base_hw=(16, 24), enc_layers=2):
    port = tpixdec.TransformerEncoderPixelDecoder(channels, conv_dim=32, mask_dim=32,
                                                  num_enc_layers=enc_layers, num_heads=8,
                                                  dim_feedforward=64)
    params = seeded_jax_params(port, 4)
    rng = np.random.default_rng(1)
    H, W = base_hw
    feats = {f"res{i + 2}": _nhwc(rng, (1, H // 2 ** i, W // 2 ** i, c))
             for i, c in enumerate(channels)}
    model = jpixdec.TransformerEncoderPixelDecoder(
        conv_dim=32, mask_dim=32, num_enc_layers=enc_layers, num_heads=8,
        dim_feedforward=64, dtype=jnp.float32)
    mf, tf, ms = jax.jit(model.apply)(params, {k: jnp.asarray(v) for k, v in feats.items()})
    return {"inputs_nhwc": feats, "mask_features": np.asarray(mf),
            "transformer_features": np.asarray(tf), "multi_scale": [np.asarray(m) for m in ms],
            "sd": _reference_sd(port, "pixel_decoder"),
            "enc_layers": enc_layers}


HEAD = dict(hidden_dim=32, dim_proj=32, num_queries=13, nheads=4, dim_feedforward=64,
            dec_layers=3, mask_dim=32)


def head_standin(base_hw=(16, 24), n_text=5):
    port = txdec.XDecoderHead(**HEAD)
    params = seeded_jax_params(port, 5)
    rng = np.random.default_rng(2)
    H, W = base_hw
    ms = [_nhwc(rng, (1, H // 2 ** i, W // 2 ** i, 32)) for i in (2, 1, 0)]
    mf = _nhwc(rng, (1, H, W, 32))
    text = _nhwc(rng, (n_text, 32))
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    logit_scale = float(np.exp(1.3))
    out = jax.jit(jxdec.XDecoderHead(**HEAD, dtype=jnp.float32).apply)(
        params, [jnp.asarray(m) for m in ms], jnp.asarray(mf), jnp.asarray(text),
        jnp.float32(logit_scale))
    return {"multi_scale_nhwc": ms, "mask_features_nhwc": mf, "text": text,
            "logit_scale": logit_scale, "sd": _reference_sd(port, "predictor"),
            "dec_layers": HEAD["dec_layers"],
            **{k: np.asarray(out[k]) for k in ("pred_logits", "cls_logits", "pred_masks",
                                                "mask_embed")}}


def lift_standin(N=80, V=3, mask_hw=(24, 32), stride4_hw=(6, 8), Q=7, C=512, n_cls=5):
    """The lift oracle's synthetic scene (oracle.lift_oracle's draws), its
    final features from the JAX package's lift (the JAX harness's
    ``_our_lift_from``)."""
    rng = np.random.default_rng(6)
    H, W = mask_hw
    coords = rng.uniform(0, 10, (N, 3)).astype(np.float32)
    vis = rng.uniform(size=(V, N)) < 0.6
    vis[:, 0] = True
    ref = {
        "coords": coords, "vis": vis,
        "xl": rng.integers(0, H, (V, N)), "yl": rng.integers(0, W, (V, N)),
        "teacher": [{"pred_masks": rng.normal(0, 2, (Q,) + stride4_hw).astype(np.float32),
                     "pred_logits": rng.normal(0, 1, (Q, n_cls + 1)).astype(np.float32),
                     "mask_embed": rng.normal(0, 1, (Q, C)).astype(np.float32)}
                    for _ in range(V)],
        "text": rng.normal(0, 1, (n_cls, C)).astype(np.float32), "logit_scale": 2.5,
        "mask_hw": mask_hw, "num_points": N,
    }
    ref["final_features"] = np.asarray(jcompare._our_lift_from(ref, "coords"))
    return ref


def _permute_sd(ref, pattern: str):
    """The stand-in with the output rows of the first weight matching
    ``pattern`` rolled by one (its bias left in place)."""
    bad = dict(ref)
    bad["sd"] = dict(ref["sd"])
    key = next(k for k in sorted(bad["sd"]) if pattern in k)
    bad["sd"][key] = np.roll(bad["sd"][key], 1, axis=0)
    return bad


def _permute_embed(ref):
    """One view's mask embeddings (the lift's only learnt-layer output)
    rolled by one query."""
    bad = dict(ref)
    bad["teacher"] = [dict(t) for t in ref["teacher"]]
    bad["teacher"][0]["mask_embed"] = np.roll(ref["teacher"][0]["mask_embed"], 1, axis=0)
    return bad


STAGES = {
    "focalnet": (compare.parity_focalnet, focalnet_standin,
                 lambda r: _permute_sd(r, "mlp.fc1.weight")),
    "pixel_decoder": (compare.parity_pixel_decoder, pixel_decoder_standin,
                      lambda r: _permute_sd(r, "linear1.weight")),
    "head": (compare.parity_head, head_standin,
             lambda r: _permute_sd(r, "transformer_ffn_layers.1.linear1.weight")),
    "lift": (compare.parity_lift, lift_standin, _permute_embed),
}


@pytest.fixture(scope="module")
def standins():
    return {}


def _standin(standins, stage):
    if stage not in standins:
        standins[stage] = STAGES[stage][1]()
    return standins[stage]


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_port_stage_matches_the_standin_oracle(standins, stage):
    rows = STAGES[stage][0]("small", device="cpu", ref=_standin(standins, stage))
    assert rows and all(k.startswith(f"{stage}/") for k in rows), rows
    for name, (mx, rel) in rows.items():
        assert rel < TOL, f"{name}: rel={rel:.3e} max|d|={mx:.3e}"


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_port_stage_fails_a_permuted_standin(standins, stage):
    fn, _, permute = STAGES[stage]
    rows = fn("small", device="cpu", ref=permute(_standin(standins, stage)))
    worst = max(rel for _, rel in rows.values())
    assert worst > 1e-3, f"{stage}: a permuted layer passes (worst rel {worst:.3e})"

