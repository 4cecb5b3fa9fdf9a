"""Released Sonata (Pointcept PTv3) checkpoint -> the port's teacher.

Port of geopurify_tpu/utils/convert_sonata.py. The state-dict layout of
the facebook/sonata release:

  embedding.stem.conv.weight                  SubMConv3d(in, C0, k=5, no bias)
  embedding.stem.norm.{weight,bias[,running_mean,running_var]}
  enc.enc{s}.down.proj.{weight,bias}          SerializedPooling Linear
  enc.enc{s}.down.norm.0.{weight,bias[,running_*]}
  enc.enc{s}.block{b}.cpe.0.{weight,bias}     SubMConv3d(C, C, k=3, bias)
  enc.enc{s}.block{b}.cpe.1.{weight,bias}     Linear
  enc.enc{s}.block{b}.cpe.2.{weight,bias}     LayerNorm
  enc.enc{s}.block{b}.norm{1,2}.0.{weight,bias}
  enc.enc{s}.block{b}.attn.{qkv,proj}.{weight,bias}
  enc.enc{s}.block{b}.mlp.0.fc{1,2}.{weight,bias}

spconv kernels come as ``(out, kx, ky, kz, in)`` (spconv >= 2) or
``(kx, ky, kz, in, out)`` (spconv 1), told apart by shape, and flatten
over (kx, ky, kz) in C order, the port's x-major tap order
(``ops/sparse_conv.kernel_offsets_3d``). BatchNorm at the embedding and
pooling sites is folded into a per-channel affine in float64, which the
teacher then applies with ``sonata.norm=bn_folded``. The Flax-layout tree
(a stage's blocks as numbered children) goes through
``utils.from_jax._state_dict`` onto the port's names.

``export_sonata_state_dict`` is the inverse for a LayerNorm teacher: the
port's ``SonataTeacher`` under the release's keys, spconv >= 2 layout.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from geopurify_tpu_torch.utils.from_jax import _state_dict

SD = Dict[str, np.ndarray]


# geopurify_tpu/utils/convert_sonata.py:46
class SonataConversionError(KeyError):
    pass


# geopurify_tpu/utils/convert_sonata.py:50
def _find(sd: SD, *candidates: str) -> Optional[str]:
    for c in candidates:
        if c in sd:
            return c
    return None


# geopurify_tpu/utils/convert_sonata.py:57
def _get(sd: SD, *candidates: str) -> np.ndarray:
    key = _find(sd, *candidates)
    if key is None:
        raise SonataConversionError(
            f"none of {candidates} in checkpoint (have e.g. {sorted(sd)[:8]}...)")
    return np.asarray(sd[key])


# geopurify_tpu/utils/convert_sonata.py:67
def _spconv_kernel(w: np.ndarray, k: int) -> np.ndarray:
    """A spconv SubMConv3d weight in the port's [k^3, Cin, Cout] tap layout."""
    if w.ndim == 2:                       # 1x1x1 stored dense
        return w[None]
    if w.ndim == 4 and w.shape[0] == k ** 3:
        raise SonataConversionError(f"unexpected 4-d spconv weight {w.shape}")
    if w.ndim == 3 and w.shape[0] == k ** 3:
        return w                          # already [K, in, out]
    if w.ndim != 5:
        raise SonataConversionError(f"unrecognized spconv weight shape {w.shape}")
    if w.shape[1] == w.shape[2] == w.shape[3] == k:
        w = np.transpose(w, (1, 2, 3, 4, 0))      # (out, kx, ky, kz, in): spconv >= 2
    elif not w.shape[0] == w.shape[1] == w.shape[2] == k:   # (kx, ky, kz, in, out): 1.x
        raise SonataConversionError(f"cannot locate kernel dims (k={k}) in spconv weight "
                                    f"{w.shape}")
    return w.reshape(k ** 3, w.shape[3], w.shape[4])


# geopurify_tpu/utils/convert_sonata.py:91
def _lin(sd: SD, *prefixes: str) -> Dict[str, Any]:
    prefix = next((p for p in prefixes if f"{p}.weight" in sd), None)
    if prefix is None:
        raise SonataConversionError(f"no linear at any of {prefixes}")
    w = _get(sd, f"{prefix}.weight").T
    b = _find(sd, f"{prefix}.bias")
    return {"kernel": w,
            "bias": np.asarray(sd[b]) if b else np.zeros((w.shape[1],), np.float32)}


# geopurify_tpu/utils/convert_sonata.py:102
def _norm(sd: SD, *prefixes: str) -> Tuple[Dict[str, Any], bool]:
    """({scale, bias}, was_batchnorm): BatchNorm running statistics are
    folded, (w / sqrt(var + 1e-5), b - mean * scale) in float64."""
    prefix = next((p for p in prefixes if f"{p}.weight" in sd), None)
    if prefix is None:
        raise SonataConversionError(f"no norm at any of {prefixes}")
    w = np.asarray(sd[f"{prefix}.weight"]).astype(np.float64)
    b = np.asarray(sd[f"{prefix}.bias"]).astype(np.float64)
    rm_key = _find(sd, f"{prefix}.running_mean")
    if rm_key is None:
        return {"scale": w.astype(np.float32), "bias": b.astype(np.float32)}, False
    rm = np.asarray(sd[rm_key]).astype(np.float64)
    rv = np.asarray(sd[f"{prefix}.running_var"]).astype(np.float64)
    scale = w / np.sqrt(rv + 1e-5)
    return {"scale": scale.astype(np.float32),
            "bias": (b - rm * scale).astype(np.float32)}, True


# geopurify_tpu/utils/convert_sonata.py:126
def convert_sonata_checkpoint(sd: SD, cfg=None) -> Dict[str, torch.Tensor]:
    """The state dict of ``models.sonata.SonataTeacher`` from a PTv3-layout
    checkpoint (under ``module.``, ``backbone.``, ``student.backbone.`` or
    ``model.`` too). ``cfg`` (a ``SonataConfig``) gives the stem kernel and
    is checked against the checkpoint: its stage depths, and BatchNorm
    sites against ``norm`` (``bn_folded`` exactly when the checkpoint has
    running statistics); ``None`` reads the depths from the keys. Raises
    ``SonataConversionError`` where the layout disagrees."""
    sd = {k.removeprefix("module."): np.asarray(v) for k, v in sd.items()}
    for candidate in ("backbone.", "student.backbone.", "model."):
        if any(k.startswith(candidate + "embedding.") for k in sd):
            sd = {k.removeprefix(candidate): v for k, v in sd.items()
                  if k.startswith(candidate)}
            break

    stem_kernel = cfg.stem_kernel if cfg is not None else 5
    w = _get(sd, "embedding.stem.conv.weight", "embedding.stem.0.weight")
    enc: Dict[str, Any] = {"stem_kernel_w": _spconv_kernel(w, stem_kernel)}
    enc["embed_norm"], saw_bn = _norm(sd, "embedding.stem.norm", "embedding.stem.1")

    depths = []
    s = 0
    while _find(sd, f"enc.enc{s}.block0.attn.qkv.weight") is not None:
        blocks: Dict[str, Any] = {}
        b = 0
        while _find(sd, f"enc.enc{s}.block{b}.attn.qkv.weight") is not None:
            p = f"enc.enc{s}.block{b}"
            cpe = _spconv_kernel(_get(sd, f"{p}.cpe.0.weight"), 3)
            cpe_b = _find(sd, f"{p}.cpe.0.bias")
            cpe_norm, bn_c = _norm(sd, f"{p}.cpe.2")
            if bn_c:
                raise SonataConversionError(
                    f"{p}.cpe.2 carries BatchNorm running stats — PTv3 blocks are "
                    "LayerNorm; refusing a layout this converter cannot represent "
                    "(cpe_norm is unconditionally LN).")
            blocks[str(b)] = {
                "cpe_kernel": cpe,
                "cpe_bias": (np.asarray(sd[cpe_b]) if cpe_b
                             else np.zeros((cpe.shape[-1],), np.float32)),
                "cpe_fc": _lin(sd, f"{p}.cpe.1"),
                "cpe_norm": cpe_norm,
                "norm1": _norm(sd, f"{p}.norm1.0", f"{p}.norm1")[0],
                "norm2": _norm(sd, f"{p}.norm2.0", f"{p}.norm2")[0],
                "attn": {"qkv": _lin(sd, f"{p}.attn.qkv"),
                         "proj": _lin(sd, f"{p}.attn.proj")},
                "mlp_fc1": _lin(sd, f"{p}.mlp.0.fc1", f"{p}.mlp.fc1"),
                "mlp_fc2": _lin(sd, f"{p}.mlp.0.fc2", f"{p}.mlp.fc2"),
            }
            b += 1
        enc[f"stage{s}_blocks"] = blocks
        depths.append(b)
        if _find(sd, f"enc.enc{s + 1}.down.proj.weight") is not None:
            enc[f"pool_proj{s}"] = _lin(sd, f"enc.enc{s + 1}.down.proj")
            enc[f"pool_norm{s}"], bn_p = _norm(
                sd, f"enc.enc{s + 1}.down.norm.0", f"enc.enc{s + 1}.down.norm")
            saw_bn |= bn_p
        s += 1

    if cfg is not None:
        want = tuple(cfg.enc_depths)
        if tuple(depths) != want:
            raise SonataConversionError(
                f"checkpoint stage depths {tuple(depths)} != config {want}")
        if saw_bn and cfg.norm != "bn_folded":
            raise SonataConversionError(
                "checkpoint uses BatchNorm at embedding/pooling sites; set "
                "sonata.norm=bn_folded so the teacher applies the folded running "
                "stats as a per-channel affine.")
        if not saw_bn and cfg.norm == "bn_folded":
            raise SonataConversionError(
                "sonata.norm=bn_folded but the checkpoint has no BN running stats; "
                "use sonata.norm=ln.")
    return _state_dict({"encoder": enc})


# geopurify_tpu/utils/convert_sonata.py:224
def fake_sonata_state_dict(enc_depths=(1, 1), enc_channels=(8, 16), in_channels: int = 6,
                           stem_kernel: int = 3, mlp_ratio: float = 4.0,
                           batchnorm_aux: bool = False, seed: int = 0) -> SD:
    """A synthetic release-layout state dict: the stem in the spconv >= 2
    layout, the blocks' xCPE in the spconv 1 layout; BatchNorm running
    statistics at the embedding and pooling sites with ``batchnorm_aux``."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    sd: SD = {}

    def norm(prefix: str, c: int, bn: bool):
        sd[f"{prefix}.weight"] = r(c)
        sd[f"{prefix}.bias"] = r(c)
        if bn:
            sd[f"{prefix}.running_mean"] = r(c)
            sd[f"{prefix}.running_var"] = np.abs(r(c)) + 0.5

    sd["embedding.stem.conv.weight"] = r(
        enc_channels[0], stem_kernel, stem_kernel, stem_kernel, in_channels)
    norm("embedding.stem.norm", enc_channels[0], batchnorm_aux)
    for s, depth in enumerate(enc_depths):
        c = enc_channels[s]
        if s > 0:
            sd[f"enc.enc{s}.down.proj.weight"] = r(c, enc_channels[s - 1])
            sd[f"enc.enc{s}.down.proj.bias"] = r(c)
            norm(f"enc.enc{s}.down.norm.0", c, batchnorm_aux)
        for b in range(depth):
            p = f"enc.enc{s}.block{b}"
            sd[f"{p}.cpe.0.weight"] = r(3, 3, 3, c, c)
            sd[f"{p}.cpe.0.bias"] = r(c)
            sd[f"{p}.cpe.1.weight"] = r(c, c)
            sd[f"{p}.cpe.1.bias"] = r(c)
            norm(f"{p}.cpe.2", c, False)
            norm(f"{p}.norm1.0", c, False)
            norm(f"{p}.norm2.0", c, False)
            sd[f"{p}.attn.qkv.weight"] = r(3 * c, c)
            sd[f"{p}.attn.qkv.bias"] = r(3 * c)
            sd[f"{p}.attn.proj.weight"] = r(c, c)
            sd[f"{p}.attn.proj.bias"] = r(c)
            h = int(c * mlp_ratio)
            sd[f"{p}.mlp.0.fc1.weight"] = r(h, c)
            sd[f"{p}.mlp.0.fc1.bias"] = r(h)
            sd[f"{p}.mlp.0.fc2.weight"] = r(c, h)
            sd[f"{p}.mlp.0.fc2.bias"] = r(c)
    return sd


_EXPORT = (
    (r"^embed_norm\.", "embedding.stem.norm."),
    (r"^stage(\d+)_blocks\.(\d+)\.cpe_bias$", r"enc.enc\1.block\2.cpe.0.bias"),
    (r"^stage(\d+)_blocks\.(\d+)\.cpe_fc\.", r"enc.enc\1.block\2.cpe.1."),
    (r"^stage(\d+)_blocks\.(\d+)\.cpe_norm\.", r"enc.enc\1.block\2.cpe.2."),
    (r"^stage(\d+)_blocks\.(\d+)\.(norm[12])\.", r"enc.enc\1.block\2.\3.0."),
    (r"^stage(\d+)_blocks\.(\d+)\.attn\.", r"enc.enc\1.block\2.attn."),
    (r"^stage(\d+)_blocks\.(\d+)\.mlp_(fc[12])\.", r"enc.enc\1.block\2.mlp.0.\3."),
)


def _spconv2(kernel: np.ndarray) -> np.ndarray:
    """[k^3, in, out] -> spconv >= 2's (out, kx, ky, kz, in)."""
    k = round(kernel.shape[0] ** (1 / 3))
    return kernel.reshape(k, k, k, *kernel.shape[1:]).transpose(4, 0, 1, 2, 3)


def export_sonata_state_dict(teacher) -> SD:
    """The release-layout state dict of the port's ``SonataTeacher`` (a
    module or its state dict) with LayerNorm everywhere (``sonata.norm=ln``)
    and spconv >= 2 kernels; ``convert_sonata_checkpoint`` gives the
    teacher's state dict back unchanged."""
    sd = teacher.state_dict() if isinstance(teacher, torch.nn.Module) else teacher
    out: SD = {}
    for key, val in sd.items():
        name = key.removeprefix("encoder.")
        val = val.detach().cpu().numpy()
        m = re.match(r"^stage(\d+)_blocks\.(\d+)\.cpe_kernel$", name)
        pool = re.match(r"^pool_(proj|norm)(\d+)\.(.*)$", name)
        if name == "stem_kernel_w":
            out["embedding.stem.conv.weight"] = _spconv2(val)
        elif m:
            out[f"enc.enc{m.group(1)}.block{m.group(2)}.cpe.0.weight"] = _spconv2(val)
        elif pool:
            site = "proj" if pool.group(1) == "proj" else "norm.0"
            out[f"enc.enc{int(pool.group(2)) + 1}.down.{site}.{pool.group(3)}"] = val
        else:
            for pat, rep in _EXPORT:
                new, n = re.subn(pat, rep, name)
                if n:
                    out[new] = val
                    break
            else:
                raise ValueError(f"{key}: no place in the Sonata release layout")
    return out
