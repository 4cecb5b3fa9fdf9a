"""Student affinity network — sparse-conv stack on voxels.

Port of geopurify_tpu/models/student.py:32-175: 3^3 conv (input_dim ->
hidden) + BN + ReLU, ``num_res_blocks`` residual blocks of two 3^3 convs
with BN, and a 1^3 projection to the embedding dim. BatchNorm is
mask-aware: ``train=True`` (Stage-1) normalises with the batch moments of
the valid rows and updates the running statistics in place; ``train=False``
(Stage-2) uses the running statistics. The parameter and buffer names
follow the JAX tree so ``utils.from_jax`` maps them 1:1.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from geopurify_tpu_torch.ops.sparse_conv import (
    masked_batch_stats,
    sparse_conv1,
    sparse_conv3,
)

KERNEL_VOLUME = 27


# geopurify_tpu/models/student.py:32
class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows, zero on invalid rows. ``train``: batch
    moments (gradients flow through them), running stats updated in place
    as ``ra = momentum * ra + (1 - momentum) * batch`` with the biased
    variance (not ``nn.BatchNorm1d``'s unbiased one). ``group``: the batch
    moments are taken over the valid rows of every rank of that process
    group (SyncBN; JAX's ``axis_name``)."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, valid, train: bool = False, group=None):
        if train:
            mean, var = masked_batch_stats(x, valid, group)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean[None, :]) * torch.rsqrt(var[None, :] + self.eps)
        y = y * self.weight[None, :] + self.bias[None, :]
        return torch.where(valid[:, None], y, 0.0).to(x.dtype)


# geopurify_tpu/models/student.py:65
class SparseConv3Layer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(KERNEL_VOLUME, in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x, neighbor_idx, valid):
        return sparse_conv3(x, neighbor_idx, self.kernel.to(x.dtype), valid,
                            bias=self.bias)


# geopurify_tpu/models/student.py:81
class SparseConv1Layer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x, valid):
        return sparse_conv1(x, self.weight.to(x.dtype), valid, bias=self.bias)


# geopurify_tpu/models/student.py:94
class ResBlock(nn.Module):
    def __init__(self, channels: int, bn_momentum: float = 0.9):
        super().__init__()
        self.conv1 = SparseConv3Layer(channels, channels)
        self.norm1 = MaskedBatchNorm(channels, bn_momentum)
        self.conv2 = SparseConv3Layer(channels, channels)
        self.norm2 = MaskedBatchNorm(channels, bn_momentum)

    def forward(self, x, neighbor_idx, valid, train: bool = False, group=None):
        y = torch.relu(self.norm1(self.conv1(x, neighbor_idx, valid), valid, train, group))
        y = self.norm2(self.conv2(y, neighbor_idx, valid), valid, train, group)
        return torch.relu(y + x)


# geopurify_tpu/models/student.py:120
class AffinityPredictor(nn.Module):
    def __init__(self, input_dim: int = 518, hidden_dim: int = 512,
                 embed_dim: int = 128, num_res_blocks: int = 4,
                 compute_dtype: str = "float32", bn_momentum: float = 0.9):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.input_conv = SparseConv3Layer(input_dim, hidden_dim)
        self.input_norm = MaskedBatchNorm(hidden_dim, bn_momentum)
        for i in range(num_res_blocks):
            self.add_module(f"res{i}", ResBlock(hidden_dim, bn_momentum))
        self.num_res_blocks = num_res_blocks
        self.output_conv = SparseConv1Layer(hidden_dim, embed_dim)

    def forward(self, features, neighbor_idx, valid, train: bool = False, group=None):
        """``group``: SyncBN's process group in train mode (None: local moments)."""
        if self.compute_dtype == "bfloat16":
            features = features.to(torch.bfloat16)
        x = self.input_conv(features, neighbor_idx, valid)
        x = torch.relu(self.input_norm(x, valid, train, group))
        for i in range(self.num_res_blocks):
            x = getattr(self, f"res{i}")(x, neighbor_idx, valid, train, group)
        return self.output_conv(x, valid)


def truncated_normal_(t: torch.Tensor, std: float, generator: torch.Generator):
    """Normal(0, std) truncated to +-2 std, drawn by the inverse CDF from
    ``generator`` (on the CPU, then copied to ``t``'s device)."""
    with torch.no_grad():
        lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
        u = torch.rand(t.shape, generator=generator, dtype=torch.float64)
        u = lo + (1 - 2 * lo) * u
        x = math.sqrt(2) * torch.erfinv(2 * u - 1) * std
        t.copy_(x.clamp_(-2 * std, 2 * std).to(t.dtype))
    return t


# the std of a unit normal truncated to +-2
_TRUNC_STD = 0.87962566103423978


def variance_scaling_(t: torch.Tensor, scale: float, fan_in: int,
                      generator: torch.Generator):
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")``: a
    truncated draw whose std is sqrt(scale / fan_in). He normal is scale 2,
    LeCun normal (Flax Dense's default) scale 1."""
    return truncated_normal_(t, math.sqrt(scale / fan_in) / _TRUNC_STD, generator)


# geopurify_tpu/models/student.py:71-75, :87-89 (the Flax initialisers)
def init_student_(student: AffinityPredictor, generator: torch.Generator):
    """The JAX initialisers' distributions from ``generator``: He-normal
    (truncated) conv kernels, fan-in over (taps, Cin) for the [27, Cin,
    Cout] kernels and Cin for the 1^3 projection; zero biases; BatchNorm
    scale 1, bias 0, running mean 0, var 1. Matches the distribution, not
    the bits, of ``AffinityPredictor.init``."""
    with torch.no_grad():
        for name, p in student.named_parameters():
            if name.endswith("kernel"):
                variance_scaling_(p, 2.0, p.shape[0] * p.shape[1], generator)
            elif name == "output_conv.weight":
                variance_scaling_(p, 2.0, p.shape[1], generator)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)
        for name, b in student.named_buffers():
            b.fill_(0.0 if name.endswith("mean") else 1.0)
    return student


# geopurify_tpu/models/student.py:166
def param_group_label(name: str) -> str:
    """3-tier differential-LR group of a parameter name: input adapter
    (``input_*``) x0.1, middle res blocks x1, output projection x5."""
    top = name.split(".")[0]
    if top.startswith("input"):
        return "input"
    if top.startswith("output"):
        return "output"
    return "middle"
