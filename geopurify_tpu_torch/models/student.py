"""Student affinity network — sparse-conv stack on voxels (inference).

Port of geopurify_tpu/models/student.py:32-165: 3^3 conv (input_dim ->
hidden) + BN + ReLU, ``num_res_blocks`` residual blocks of two 3^3 convs
with BN, and a 1^3 projection to the embedding dim. BatchNorm runs in eval
mode on its running statistics (Stage-2 inference); the parameter and
buffer names follow the JAX tree so ``utils.from_jax`` maps them 1:1.
"""

from __future__ import annotations

import torch
from torch import nn

from geopurify_tpu_torch.ops.sparse_conv import sparse_conv1, sparse_conv3

KERNEL_VOLUME = 27


# geopurify_tpu/models/student.py:32
class MaskedBatchNorm(nn.Module):
    """BatchNorm on running statistics, zero on invalid rows."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, valid):
        y = (x - self.mean[None, :]) * torch.rsqrt(self.var[None, :] + self.eps)
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
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = SparseConv3Layer(channels, channels)
        self.norm1 = MaskedBatchNorm(channels)
        self.conv2 = SparseConv3Layer(channels, channels)
        self.norm2 = MaskedBatchNorm(channels)

    def forward(self, x, neighbor_idx, valid):
        y = torch.relu(self.norm1(self.conv1(x, neighbor_idx, valid), valid))
        y = self.norm2(self.conv2(y, neighbor_idx, valid), valid)
        return torch.relu(y + x)


# geopurify_tpu/models/student.py:120
class AffinityPredictor(nn.Module):
    def __init__(self, input_dim: int = 518, hidden_dim: int = 512,
                 embed_dim: int = 128, num_res_blocks: int = 4,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.input_conv = SparseConv3Layer(input_dim, hidden_dim)
        self.input_norm = MaskedBatchNorm(hidden_dim)
        for i in range(num_res_blocks):
            self.add_module(f"res{i}", ResBlock(hidden_dim))
        self.num_res_blocks = num_res_blocks
        self.output_conv = SparseConv1Layer(hidden_dim, embed_dim)

    def forward(self, features, neighbor_idx, valid):
        if self.compute_dtype == "bfloat16":
            features = features.to(torch.bfloat16)
        x = self.input_conv(features, neighbor_idx, valid)
        x = torch.relu(self.input_norm(x, valid))
        for i in range(self.num_res_blocks):
            x = getattr(self, f"res{i}")(x, neighbor_idx, valid)
        return self.output_conv(x, valid)
