"""Transformer / conv building blocks of the plain reference (NHWC).

A frozen copy of the port's ``models/layers.py`` (the parts the Stage-2
X-Decoder uses), kept here so that the benchmark's reference does not move
when the program does. Parameters are f32 and the reference builds every
module with ``dtype=torch.float32``: a Dense / Conv computes in that dtype,
norms and attention logits in f32.

``lower_precision("fp8")`` is the control's switch: inside it every Dense
and Conv rounds its input and its weight to float8 e4m3 (one scale a
tensor, its largest magnitude to 448) and multiplies in f32, the precision
below the bf16 that the configuration states for the X-Decoder.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# geopurify_tpu/models/layers.py:23
def position_embedding_sine(h: int, w: int, num_pos_feats: int,
                            temperature: float = 10000.0, dtype=torch.float32,
                            device=None) -> torch.Tensor:
    """2D sine positional encoding, [H, W, 2*num_pos_feats] (normalized, 2*pi)."""
    scale, eps = 2 * math.pi, 1e-6
    ones = torch.ones((h, w), dtype=torch.float32, device=device)
    y_embed = torch.cumsum(ones, 0)
    x_embed = torch.cumsum(ones, 1)
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = torch.stack([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()], 3).reshape(h, w, -1)
    pos_y = torch.stack([pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()], 3).reshape(h, w, -1)
    return torch.cat([pos_y, pos_x], -1).to(dtype)


# geopurify_tpu/models/layers.py:45
def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """GELU with erf via the Abramowitz & Stegun 7.1.26 polynomial
    (|erf err| <= 1.5e-7), computed in f32, returned in x's dtype."""
    x32 = x.to(torch.float32)
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5, p = -1.453152027, 1.061405429, 0.3275911
    z = x32.abs() * np.float32(1.0 / np.sqrt(2.0))
    t = 1.0 / (1.0 + p * z)
    e = (((((a5 * t + a4) * t) + a3) * t + a2) * t + a1) * t * torch.exp(-z * z)
    erf = torch.sign(x32) * (1.0 - e)
    return (0.5 * x32 * (1.0 + erf)).to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


_LOWP = {"mode": None}
FP8_MAX = 448.0


@contextlib.contextmanager
def lower_precision(mode: Optional[str]):
    """Round every Dense / Conv operand to ``mode`` ("fp8", "bf16" or None)
    inside."""
    prev = _LOWP["mode"]
    _LOWP["mode"] = mode
    try:
        yield
    finally:
        _LOWP["mode"] = prev


def _operand(x: torch.Tensor) -> torch.Tensor:
    if _LOWP["mode"] is None:
        return x
    if _LOWP["mode"] == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    x32 = x.to(torch.float32)
    scale = torch.clamp(x32.abs().amax() / FP8_MAX, min=1e-30)
    return ((x32 / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale).to(x.dtype)


class Dense(nn.Module):
    """flax nn.Dense(dtype=...) semantics with a torch [out, in] weight."""

    def __init__(self, in_dim: int, out_dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x):
        return (F.linear(_operand(x.to(self.dtype)), _operand(self.weight.to(self.dtype)))
                + self.bias.to(self.dtype))


class Conv(nn.Module):
    """flax nn.Conv on NHWC tensors (dtype semantics as Dense), OIHW weight."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: Optional[int] = None, groups: int = 1, bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.padding = kernel // 2 if padding is None else padding   # "SAME"
        self.groups = groups
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x):                       # [B, H, W, C]
        y = F.conv2d(_operand(x.to(self.dtype)).permute(0, 3, 1, 2),
                     _operand(self.weight.to(self.dtype)),
                     None, self.stride, self.padding, 1, self.groups)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class LayerNorm(nn.Module):
    """LayerNorm computed and returned in f32 (flax dtype=float32)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x.to(torch.float32), (x.shape[-1],), self.weight,
                            self.bias, self.eps)


class GroupNorm(nn.Module):
    """GroupNorm over an NHWC tensor, computed and returned in f32."""

    def __init__(self, groups: int, dim: int, eps: float = 1e-5):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        y = F.group_norm(x.to(torch.float32).permute(0, 3, 1, 2), self.groups,
                         self.weight, self.bias, self.eps)
        return y.permute(0, 2, 3, 1)


# geopurify_tpu/models/layers.py:64
class Mlp(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 act: Callable = gelu_exact, dtype=torch.float32):
        super().__init__()
        self.act = act
        self.fc1 = Dense(in_dim, hidden_dim, dtype)
        self.fc2 = Dense(hidden_dim, out_dim, dtype)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


# geopurify_tpu/models/layers.py:79
class MLPHead(nn.Module):
    """num_layers-deep ReLU MLP; layers named ``layers{i}`` as in Flax."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 3, dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        for i in range(num_layers):
            self.add_module(f"layers{i}", Dense(dims[i], dims[i + 1], dtype))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layers{i}")(x)
            if i < self.num_layers - 1:
                x = torch.relu(x)
        return x


# geopurify_tpu/models/layers.py:95
class MultiHeadAttention(nn.Module):
    """Explicit MHA; boolean mask True = BLOCKED; logits/softmax in f32,
    fully-masked rows give zero attention."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.q_proj = Dense(dim, dim, dtype)
        self.k_proj = Dense(dim, dim, dtype)
        self.v_proj = Dense(dim, dim, dtype)
        self.out_proj = Dense(dim, dim, dtype)

    def forward(self, q, k, v, mask: Optional[torch.Tensor] = None):
        d = self.dim // self.num_heads

        def split(x):
            b, l, _ = x.shape
            return x.reshape(b, l, self.num_heads, d).transpose(1, 2)

        qh, kh, vh = split(self.q_proj(q)), split(self.k_proj(k)), split(self.v_proj(v))
        logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / math.sqrt(d)
        if mask is not None:
            logits = logits.masked_fill(mask, float("-inf"))
        attn = torch.nan_to_num(torch.softmax(logits, dim=-1))
        out = torch.matmul(attn.to(self.dtype), vh)
        out = out.transpose(1, 2).reshape(q.shape[0], q.shape[1], self.dim)
        return self.out_proj(out)


# geopurify_tpu/models/layers.py:132
class SelfAttentionLayer(nn.Module):
    """DETR self-attention, post-norm (or ``pre_norm``); pos added to q and
    k only."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32,
                 pre_norm: bool = False):
        super().__init__()
        self.dtype, self.pre_norm = dtype, pre_norm
        self.self_attn = MultiHeadAttention(dim, num_heads, dtype)
        self.norm = LayerNorm(dim)

    def forward(self, tgt, query_pos, tgt_mask=None):
        x = self.norm(tgt) if self.pre_norm else tgt
        q = x + query_pos
        attn = self.self_attn(q, q, x, mask=tgt_mask)
        if self.pre_norm:
            return tgt + attn
        return self.norm(tgt + attn).to(self.dtype)


# geopurify_tpu/models/layers.py:154
class CrossAttentionLayer(nn.Module):
    """Masked cross-attention, post-norm (or ``pre_norm``); pos added to the
    keys only."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32,
                 pre_norm: bool = False):
        super().__init__()
        self.dtype, self.pre_norm = dtype, pre_norm
        self.multihead_attn = MultiHeadAttention(dim, num_heads, dtype)
        self.norm = LayerNorm(dim)

    def forward(self, tgt, memory, memory_mask, pos, query_pos):
        x = self.norm(tgt) if self.pre_norm else tgt
        attn = self.multihead_attn(x + query_pos, memory + pos, memory, mask=memory_mask)
        if self.pre_norm:
            return tgt + attn
        return self.norm(tgt + attn).to(self.dtype)


# geopurify_tpu/models/layers.py:175
class FFNLayer(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dtype=torch.float32,
                 pre_norm: bool = False):
        super().__init__()
        self.dtype, self.pre_norm = dtype, pre_norm
        self.linear1 = Dense(dim, hidden_dim, dtype)
        self.linear2 = Dense(hidden_dim, dim, dtype)
        self.norm = LayerNorm(dim)

    def forward(self, x):
        if self.pre_norm:
            return x + self.linear2(torch.relu(self.linear1(self.norm(x))))
        return self.norm(x + self.linear2(torch.relu(self.linear1(x)))).to(self.dtype)


# geopurify_tpu/models/layers.py:195
class TransformerEncoderLayer(nn.Module):
    """DETR encoder layer, post-norm (or ``pre_norm``): q=k=src+pos, v=src,
    then FFN."""

    def __init__(self, dim: int, num_heads: int, hidden_dim: int, dtype=torch.float32,
                 pre_norm: bool = False):
        super().__init__()
        self.dtype, self.pre_norm = dtype, pre_norm
        self.self_attn = MultiHeadAttention(dim, num_heads, dtype)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.linear1 = Dense(dim, hidden_dim, dtype)
        self.linear2 = Dense(hidden_dim, dim, dtype)

    def _ffn(self, x):
        return self.linear2(torch.relu(self.linear1(x)))

    def forward(self, src, pos):
        if self.pre_norm:
            x = self.norm1(src)
            q = x + pos
            src = src + self.self_attn(q, q, x)
            return src + self._ffn(self.norm2(src))
        q = src + pos
        src = self.norm1(src + self.self_attn(q, q, src)).to(self.dtype)
        return self.norm2(src + self._ffn(src)).to(self.dtype)


# geopurify_tpu/models/layers.py:227
class ConvGN(nn.Module):
    """Conv2D (NHWC, bias only if asked) + GroupNorm(32) + optional ReLU."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 relu: bool = False, bias: bool = False, dtype=torch.float32):
        super().__init__()
        self.relu, self.dtype = relu, dtype
        self.conv = Conv(in_ch, features, kernel, bias=bias, dtype=dtype)
        self.norm = GroupNorm(math.gcd(32, features), features)

    def forward(self, x):
        x = self.norm(self.conv(x)).to(self.dtype)
        return torch.relu(x) if self.relu else x


# geopurify_tpu/models/layers.py:253
def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """NHWC nearest resize, torch semantics: src = floor(i * in / out)."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    ri = torch.arange(oh, device=x.device) * h // oh
    ci = torch.arange(ow, device=x.device) * w // ow
    return x[:, ri][:, :, ci]


def _torch_cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    inner = (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0
    outer = a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a
    return np.where(ax <= 1.0, inner, np.where(ax < 2.0, outer, 0.0))


# geopurify_tpu/models/layers.py:283
@functools.lru_cache(maxsize=64)
def _aa_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] weights of torch's antialiased bicubic resample on one axis."""
    scale = in_size / out_size
    support_scale = max(scale, 1.0)
    support = 2.0 * support_scale
    W = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = scale * (i + 0.5)
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        j = np.arange(lo, hi)
        w = _torch_cubic((j - center + 0.5) / support_scale)
        s = w.sum()
        if s != 0:
            w = w / s
        W[i, lo:hi] = w
    return W.astype(np.float32)


# geopurify_tpu/models/layers.py:345
@functools.lru_cache(maxsize=64)
def _aa_resize_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Compact per-output-row taps of ``_aa_resize_weights``:
    (tap_lo [out] int32, tap_w [out, T] float32)."""
    W = _aa_resize_weights(in_size, out_size)
    scale = in_size / out_size
    support = 2.0 * max(scale, 1.0)
    los = np.zeros((out_size,), np.int32)
    his = np.zeros((out_size,), np.int32)
    for i in range(out_size):
        center = scale * (i + 0.5)
        los[i] = max(int(center - support + 0.5), 0)
        his[i] = min(int(center + support + 0.5), in_size)
    T = int(np.max(his - los))
    tap_w = np.zeros((out_size, T), np.float32)
    for i in range(out_size):
        n = his[i] - los[i]
        tap_w[i, :n] = W[i, los[i]: his[i]]
    lo_c = np.minimum(los, max(in_size - T, 0))
    for i in range(out_size):
        d = los[i] - lo_c[i]
        if d:
            tap_w[i] = np.concatenate([np.zeros(d, np.float32), tap_w[i, :-d]])
    return lo_c.astype(np.int32), tap_w


# geopurify_tpu/models/layers.py:382
def resize_bicubic_antialias(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """NHWC bicubic antialiased resize as two f32 matmuls with the cached
    [out, in] weight matrices."""
    _, h, w, _ = x.shape
    Wh = torch.from_numpy(_aa_resize_weights(h, out_hw[0])).to(x.device)
    Ww = torch.from_numpy(_aa_resize_weights(w, out_hw[1])).to(x.device)
    y = torch.einsum("Hh,bhwc->bHwc", Wh, x.to(torch.float32))
    y = torch.einsum("Ww,bhwc->bhWc", Ww, y)
    return y.to(x.dtype)
