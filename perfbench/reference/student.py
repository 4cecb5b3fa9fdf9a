"""Student affinity network of the plain reference: a frozen copy of the
port's ``models/student.py`` (3^3 conv + BN + ReLU, residual blocks, a 1^3
projection) over the tap-scan convolution, without SyncBN. Parameter and
buffer names are the port's, so one state dict loads into both.
"""

from __future__ import annotations

import torch
from torch import nn

from perfbench.reference.sparse_conv import (
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
    variance (not ``nn.BatchNorm1d``'s unbiased one)."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, valid, train: bool = False):
        if train:
            mean, var = masked_batch_stats(x, valid)
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

    def forward(self, x, neighbor_idx, valid, train: bool = False):
        y = torch.relu(self.norm1(self.conv1(x, neighbor_idx, valid), valid, train))
        y = self.norm2(self.conv2(y, neighbor_idx, valid), valid, train)
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

    def forward(self, features, neighbor_idx, valid, train: bool = False):
        if self.compute_dtype == "bfloat16":
            features = features.to(torch.bfloat16)
        x = self.input_conv(features, neighbor_idx, valid)
        x = torch.relu(self.input_norm(x, valid, train))
        for i in range(self.num_res_blocks):
            x = getattr(self, f"res{i}")(x, neighbor_idx, valid, train)
        return self.output_conv(x, valid)


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
