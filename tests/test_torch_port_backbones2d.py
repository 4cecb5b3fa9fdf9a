"""The X-Decoder's alternative backbones held against the JAX package on the
CPU, weights carried across with utils.from_jax: FocalNet's option set
(non-overlapped patch embed, pre-LN, no LayerScale, LN in the modulation,
no scaling modulator, the focal_dw variant under post- and pre-LN with
pre-norm downsample embeds), DaViT and ViT (with ``_rel_pos_bias`` on a downscaled and an
upscaled table), each at narrow widths (``tests/test_torch_port_seg2d.py``
holds them inside ``XDecoderSegModel``). fp32 rel < 1e-5; bf16 against the
JAX bf16 path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.models import davit as jdavit
from geopurify_tpu.models import focalnet as jfocal
from geopurify_tpu.models import vit_backbone as jvit
from geopurify_tpu_torch.models import davit as tdavit
from geopurify_tpu_torch.models import focalnet as tfocal
from geopurify_tpu_torch.models import vit_backbone as tvit
from geopurify_tpu_torch.utils.from_jax import params_from_jax

TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def seeded_jax_params(module: torch.nn.Module, seed: int, scale=0.1):
    """Seed the port ``module`` (matrices and kernels N(0, 1 / fan-in), norm
    scales 1 + N(0, scale^2), the rest N(0, scale^2)) and return the same
    weights as JAX variables, the inverse of ``utils.from_jax`` (Dense and
    Conv layouts, norm ``scale``, the ViT neck's flipped ConvTranspose, the
    scanned FocalNet stages stacked under ``block``): no JAX init is traced."""
    g = torch.Generator().manual_seed(seed)
    tree, stacked = {}, {}
    with torch.no_grad():
        for name, p in module.named_parameters():
            *path, leaf = name.split(".")
            r = torch.randn(p.shape, generator=g)
            convt = bool(path) and path[-1] in ("d4_up1", "d4_up2", "d8_up")
            if leaf == "weight" and p.dim() == 1:
                p.copy_(1 + scale * r)
            elif leaf == "weight":
                fan_in = (p.shape[0] * p.shape[2] * p.shape[3] if convt
                          else int(np.prod(p.shape[1:])))
                p.copy_(r / float(np.sqrt(fan_in)))
            else:
                p.copy_(scale * r)
            a = p.numpy()
            if leaf == "weight":
                leaf, a = ("scale", a) if a.ndim == 1 else ("kernel", (
                    a.T if a.ndim == 2 else a.transpose(2, 3, 0, 1)[::-1, ::-1] if convt
                    else a.transpose(2, 3, 1, 0)))
            a = np.ascontiguousarray(a)
            i = next((i for i, q in enumerate(path[:-1])
                      if q.endswith("_blocks") and path[i + 1].isdigit()), None)
            if i is not None:           # a scanned stage's block: stack over depth
                key = (*path[:i + 1], "block", *path[i + 2:], leaf)
                stacked.setdefault(key, {})[int(path[i + 1])] = a
                continue
            node = tree
            for q in path:
                node = node.setdefault(q, {})
            node[leaf] = a
    for key, by_depth in stacked.items():
        node = tree
        for q in key[:-1]:
            node = node.setdefault(q, {})
        node[key[-1]] = np.stack([by_depth[d] for d in sorted(by_depth)])
    return {"params": tree}


def _image(hw=(64, 96), seed=0, B=2):
    return np.random.default_rng(seed).normal(size=(B, *hw, 3)).astype(np.float32)


def _check_maps(got, ref, dtype):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        r = _rel(got[k].float().numpy(), np.asarray(ref[k].astype(jnp.float32)))
        assert r < TOL[dtype], f"{dtype} {k}: rel={r:.2e}"


def _compare(jcls, tcls, kw, x, dtypes):
    """One set of seeded weights (the parameters are f32 whatever the
    compute dtype) through the JAX module and the port's, in each dtype."""
    params = seeded_jax_params(tcls(**kw), 1)
    state = params_from_jax(params)
    for dtype in dtypes:
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        ref = jax.jit(jcls(**kw, dtype=jdt).apply)(params, jnp.asarray(x, jdt))
        tm = tcls(**kw, dtype=getattr(torch, dtype)).eval()
        tm.load_state_dict(state)
        with torch.no_grad():
            got = tm(torch.from_numpy(x).to(getattr(torch, dtype)))
        _check_maps(got, ref, dtype)


# every branch of the JAX FocalNet's options in three builds (the default,
# post-LN conv-embed focal build is tests/test_torch_port_xdecoder.py's):
# non-overlapped patch embed, pre-LN, no LayerScale, LN in the modulation,
# no scaling modulator; focal_dw under post-LN with pre-norm downsample
# embeds; focal_dw under pre-LN
FOCAL_OPTIONS = {
    "pre_ln": dict(use_conv_embed=False, use_postln=False, use_layerscale=False,
                   use_postln_in_modulation=True, scaling_modulator=False),
    "focal_dw": dict(use_dw=True, use_pre_norms=(False, True, False, True)),
    "focal_dw_pre_ln": dict(use_dw=True, use_postln=False, use_conv_embed=False,
                            use_layerscale=False),
}


@pytest.mark.parametrize("option", sorted(FOCAL_OPTIONS))
def test_focalnet_options_match_jax(option):
    kw = dict(embed_dim=8, depths=(1, 2, 1, 1), focal_levels=(2, 2, 2, 2),
              **FOCAL_OPTIONS[option])
    dtypes = ["float32", "bfloat16"] if option == "focal_dw" else ["float32"]
    _compare(jfocal.FocalNet, tfocal.FocalNet, kw, _image(), dtypes)


DAVIT_SMALL = dict(embed_dims=(8, 16, 32, 64), depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 4),
                   num_groups=(1, 2, 4, 4), window_size=3)


def test_davit_matches_jax():
    # 56 x 80: windows padded at every stage
    _compare(jdavit.DaViT, tdavit.DaViT, DAVIT_SMALL, _image((56, 80)),
             ["float32", "bfloat16"])


@pytest.mark.parametrize("L,q", [(127, 31), (7, 9), (13, 7)])
def test_rel_pos_bias_matches_jax(L, q):
    """Downscaled (127 -> 61), upscaled (7 -> 17) and untouched tables."""
    table = np.random.default_rng(L).normal(size=(L, 6)).astype(np.float32)
    ref = np.asarray(jvit._rel_pos_bias(jnp.asarray(table), q, q))
    got = tvit._rel_pos_bias(torch.from_numpy(table), q, q).numpy()
    assert got.shape == ref.shape == (q, q, 6)
    assert _rel(got, ref) < 1e-5


def _vit_small(grid):
    return dict(embed_dim=32, depth=2, num_heads=2, window_size=3, global_attn_indexes=(1,),
                out_dims=(8, 16, 24, 32), pretrain_grid=grid)


@pytest.mark.parametrize("grid", [8, 3])
def test_vit_matches_jax(grid):
    """A 4 x 6 token grid: the position table and the global block's rel-pos
    tables downscaled from an 8-grid, upscaled from a 3-grid."""
    _compare(jvit.ViTBackbone, tvit.ViTBackbone, _vit_small(grid), _image((64, 96)),
             ["float32", "bfloat16"] if grid == 8 else ["float32"])
