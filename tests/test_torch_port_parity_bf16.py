"""The X-Decoder head in bf16 (the parity entry's default precision) held
against the JAX package's at the parity tests' tiny config: the witness
that the port rounds to bf16 where JAX does.

One set of seeded weights (JAX variables, handed to the port through
``utils.from_jax``) and one set of head inputs run in f32 and in bf16 in
each package. The binary attention masks turn rounding into flips, so both
heads are forced onto one set of masks (the port's bf16 run's), as the
``return_aux`` test forces them. The port's head is held against JAX's head
applied op by op (as JAX's ``run_ours`` applies the model) within 1e-5 at
each precision, while bf16 moves it ~1e-2 from f32. JAX's own head under
``jax.jit`` is printed beside it: XLA's fusion drops some of the op-by-op
bf16 roundings. The backbone, the pixel decoder and the whole forward are
in ``test_torch_port_parity_bf16_forward.py``; ``pytest -s`` prints each
measured distance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu import config as jconfig
from geopurify_tpu.models import xdecoder as jxd
from geopurify_tpu_torch import config as tconfig
from geopurify_tpu_torch.models import xdecoder as txd
from geopurify_tpu_torch.utils.from_jax import xdecoder_from_jax
from tests.test_torch_port_parity_cli import CLASSES, OVERRIDES
from tests.test_torch_port_xdecoder import _randomize, _rel

PRECISIONS = ("float32", "bfloat16")
KEYS = ("pred_logits", "pred_masks", "mask_embed", "cls_logits")


def config(package, precision):
    return package.load_config("tiny", overrides=OVERRIDES + [f"xdecoder.dtype={precision}"])


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def seeded(rng):
    """(a 64 x 96 image, unit class embeddings, JAX variables, the port's
    state dict) at the tiny config."""
    image = rng.uniform(0, 255, (64, 96, 3)).astype(np.float32)
    text = rng.normal(size=(len(CLASSES) + 1, config(jconfig, "float32").text.dim_proj))
    text = (text / np.linalg.norm(text, axis=-1, keepdims=True)).astype(np.float32)
    jm = jxd.XDecoderSegModel(config(jconfig, "float32").xdecoder)
    params = _randomize(jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(image)[None],
                                       jnp.asarray(text), jnp.float32(20.0)), seed=1)
    return image, text, params, xdecoder_from_jax(jax.tree_util.tree_map(np.asarray, params))


def port_model(precision, state_dict):
    m = txd.XDecoderSegModel(config(tconfig, precision).xdecoder).eval()
    m.load_state_dict(state_dict)
    return m


def jax_head(precision, params, text):
    """JAX's head at ``precision`` as a function of (multi_scale,
    mask_features, forced masks), applied op by op."""
    head = jxd._make_head(config(jconfig, precision).xdecoder)
    return lambda ms, mf, o: head.apply({"params": params["params"]["predictor"]}, ms, mf,
                                        jnp.asarray(text), jnp.float32(20.0),
                                        attn_mask_override=o)


@pytest.fixture(scope="module")
def heads():
    rng = np.random.default_rng(7)
    _, text, params, sd = seeded(rng)
    xc = config(jconfig, "float32").xdecoder
    # the pixel decoder's outputs at a 64 x 96 image
    ms = [rng.normal(size=(1, h, w, xc.hidden_dim)).astype(np.float32)
          for h, w in ((2, 3), (4, 6), (8, 12))]
    mf = rng.normal(size=(1, 16, 24, xc.mask_dim)).astype(np.float32)
    out, forced = {}, None
    for p in reversed(PRECISIONS):          # bf16 first: its masks are the forced set
        tm = port_model(p, sd)
        dt = txd.model_dtype(tm.cfg)
        args = ([torch.from_numpy(m).to(dt) for m in ms], torch.from_numpy(mf).to(dt),
                torch.from_numpy(text), 20.0)
        with torch.no_grad():
            if forced is None:
                forced = tm.predictor(*args, return_attn=True)["attn_masks"][:-1]
            t = tm.predictor(*args, attn_mask_override=forced)
        jdt = jnp.bfloat16 if p == "bfloat16" else jnp.float32
        jargs = ([jnp.asarray(m, jdt) for m in ms], jnp.asarray(mf, jdt),
                 [jnp.asarray(m.numpy()) for m in forced])
        f = jax_head(p, params, text)
        out[p] = dict(port=t, jax=f(*jargs))
        if p == "bfloat16":
            out[p]["jax_jit"] = jax.jit(f)(*jargs)
    return out


def test_bf16_head_rounds_where_jaxs_does(heads):
    for p in PRECISIONS:
        for k in KEYS:
            r = _rel(as_np(heads[p]["port"][k]), as_np(heads[p]["jax"][k]))
            print(f"head {p} {k}: port against JAX {r:.3e}")
            assert r < 1e-5, (p, k, r)
    b = heads["bfloat16"]
    for k in KEYS:
        spread = _rel(as_np(b["port"][k]), as_np(heads["float32"]["port"][k]))
        jit = _rel(as_np(b["jax_jit"][k]), as_np(b["jax"][k]))
        print(f"head {k}: bf16 against f32 {spread:.3e}; JAX's bf16 head under jit against "
              f"op by op {jit:.3e}")
        assert spread > 1e-3, (k, spread)       # the bf16 run did round
