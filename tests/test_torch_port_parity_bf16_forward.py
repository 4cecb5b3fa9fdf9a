"""The X-Decoder's backbone, pixel decoder and whole forward in bf16 (the
parity entry's default precision) held against the JAX package's at the
parity tests' tiny config, with the forward forced onto one set of binary
attention masks (the port's bf16 run's). Each package's bf16-to-f32 spread
stays within twice the other's: their bf16 convolutions round apart, so
the ratio moves between ~0.7 and ~1.6 with where each rounds, where a
stage kept in bf16 against JAX's f32 would show as a spread of its own.
The port against JAX in bf16 stays below the parity tool's 5e-2 limit, and
in f32 within 1e-5. JAX runs under ``jax.jit`` here (the head op by op is
in ``test_torch_port_parity_bf16.py``); ``pytest -s`` prints each measured
distance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu import config as jconfig
from geopurify_tpu.models import xdecoder as jxd
from geopurify_tpu_torch.models import xdecoder as txd
from tests.test_torch_port_parity_bf16 import (
    KEYS,
    PRECISIONS,
    as_np,
    config,
    jax_head,
    port_model,
    seeded,
)
from tests.test_torch_port_xdecoder import _rel


@pytest.fixture(scope="module")
def runs():
    image, text, params, sd = seeded(np.random.default_rng(7))
    x_t = torch.from_numpy(image)[None]
    out, forced = {}, None
    for p in reversed(PRECISIONS):          # bf16 first: its masks are the forced set
        tm = port_model(p, sd)
        with torch.no_grad():
            if forced is None:
                forced = tm(x_t, torch.from_numpy(text), 20.0,
                            return_attn=True)["attn_masks"][:-1]
            t_mf, t_ms = txd.encode_pixel_features(tm, x_t)
            t_full = tm(x_t, torch.from_numpy(text), 20.0, attn_mask_override=forced)
        jc = config(jconfig, p).xdecoder
        j_mf, j_ms = jax.jit(lambda v, x, jc=jc: jxd.encode_pixel_features(jc, v, x))(
            params, jnp.asarray(image)[None])
        j_full = jax.jit(jax_head(p, params, text))(
            list(j_ms), j_mf, [jnp.asarray(m.numpy()) for m in forced])
        out[p] = dict(t_enc=[t_mf] + list(t_ms), j_enc=[j_mf] + list(j_ms), t_full=t_full,
                      j_full=j_full)
    return out


def test_bf16_encoder_spread_matches_jaxs(runs):
    b, f = runs["bfloat16"], runs["float32"]
    for i, name in enumerate(["mask_features"] + [f"multi_scale{i}" for i in range(3)]):
        t_spread = _rel(as_np(b["t_enc"][i]), as_np(f["t_enc"][i]))
        j_spread = _rel(as_np(b["j_enc"][i]), as_np(f["j_enc"][i]))
        f32 = _rel(as_np(f["t_enc"][i]), as_np(f["j_enc"][i]))
        print(f"{name}: bf16 against f32, port {t_spread:.3e}, JAX {j_spread:.3e}; "
              f"port against JAX in f32 {f32:.3e}")
        assert b["t_enc"][i].dtype == torch.bfloat16
        assert f32 < 1e-5, (name, f32)
        assert t_spread <= 2 * j_spread and j_spread <= 2 * t_spread, (name, t_spread, j_spread)


def test_bf16_forward_forced_onto_one_mask_set(runs):
    b, f = runs["bfloat16"], runs["float32"]
    worst = {"port": 0.0, "jax": 0.0}
    for k in KEYS:
        t, j = as_np(b["t_full"][k]), as_np(b["j_full"][k])
        across = _rel(t, j)
        spread = {"port": _rel(t, as_np(f["t_full"][k])), "jax": _rel(j, as_np(f["j_full"][k]))}
        f32 = _rel(as_np(f["t_full"][k]), as_np(f["j_full"][k]))
        print(f"forward {k}: port against JAX in bf16 {across:.3e} (f32 {f32:.3e}); bf16 "
              f"against f32, port {spread['port']:.3e}, JAX {spread['jax']:.3e}")
        assert f32 < 1e-5, (k, f32)
        assert across < 5e-2, (k, across)
        worst = {s: max(worst[s], spread[s]) for s in worst}
    # the worst key, as run.parity.compare reports it
    assert worst["port"] <= 2 * worst["jax"] and worst["jax"] <= 2 * worst["port"], worst
