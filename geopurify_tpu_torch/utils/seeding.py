"""Seeded random weights and class prompts for runs without checkpoints.

The bench (``run/bench.py``) and the GPU smoke run (``chip_smoke.py``)
time the full-width pipeline with random weights drawn from a seed. The
scales matter: N(0, 1) x 0.02 for every X-Decoder parameter (the JAX
bench's recipe, ``seed_weights``) drives FocalNet-L's bf16 activations to
zero, and random class prompts all pick one class. ``seed_lecun`` keeps
the activations alive, and ``query_prompts`` takes the class prompts from
the seeded queries' own embeddings, so that several classes win.
"""

from __future__ import annotations

import numpy as np
import torch


def seed_weights(pipe, seed: int, device):
    """bench.py's teacher recipe (N(0, 1) x 0.02 for every parameter) and a
    He-normal student with identity BatchNorm statistics, from a seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for p in pipe.xdecoder.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=device) * 0.02)
    seed_student(pipe, g, device)


def seed_student(pipe, g: torch.Generator, device):
    """He-normal student kernels from ``g``; biases and BatchNorm as built."""
    with torch.no_grad():
        for name, p in pipe.student.named_parameters():
            if name.endswith("kernel"):
                fan_in = p.shape[0] * p.shape[1]
            elif name.endswith("output_conv.weight"):
                fan_in = p.shape[1]
            else:
                continue
            p.copy_(torch.randn(p.shape, generator=g, device=device)
                    * (2.0 / fan_in) ** 0.5)


def seed_lecun(pipe, seed: int, device):
    """The X-Decoder's matrices N(0, 1 / fan-in), zero biases, unit norm
    scales, from a seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in pipe.xdecoder.named_parameters():
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=g, device=device)
                        / float(np.prod(p.shape[1:])) ** 0.5)
            else:
                p.fill_(0.0 if name.endswith("bias") else 1.0)


def query_prompts(pipe, batch, seed: int):
    """Class prompts for a seeded X-Decoder: the embeddings of the queries
    that win the most points of ``batch``'s first view, one a class, and a
    random background row. Random prompts all pick the one class nearest
    the direction the seeded queries' embeddings share."""
    n_cls = pipe.text_embeddings.shape[0] - 1
    with torch.inference_mode():
        lift = pipe._view_step(batch, 0)
        table = lift.embed_table[0]                     # [Q + 1, C], L2-normed
        Q = table.shape[0] - 1
        top = torch.bincount(lift.winner[0].long(), minlength=Q + 1)[:Q].topk(n_cls).indices
    bg = text_embeddings(1, table.shape[1], seed).to(table.device)
    pipe.text_embeddings = torch.cat([table[top], bg])


def text_embeddings(n: int, dim: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    t = torch.randn((n, dim), generator=g)
    return t / t.norm(dim=-1, keepdim=True)
