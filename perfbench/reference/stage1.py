"""Stage 1 of GeoPurify, plain: the student's distillation steps.

The steps of the port's ``run/train.py::make_train_step`` over
``GeoPurifyPipeline.stage1_loss`` and ``run/optim.py``, written out:

1. the step's anchor generator: a seed drawn from the shared generator, as
   the port's ``rank_generator`` draws it for rank 0;
2. the contrastive pairs (``sampler.sample_contrastive_pairs_hybrid``, the
   anchors' spatial kNN by brute force);
3. the voxel scatter-mean of the lifted and geometric features, the student
   in train mode (batch moments of the valid rows), the InfoNCE loss in f32
   (``sampler.info_nce_loss``, where the port runs kernel K2);
4. its gradient by autograd, and AdamW by hand: one group a tier (input
   x0.1, middle x1, output x5) under the warm-up and cosine schedule, the
   decoupled weight decay first, then the bias-corrected moments.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from perfbench.reference.sampler import info_nce_loss, sample_contrastive_pairs_hybrid
from perfbench.reference.segment import segment_mean
from perfbench.reference.sparse_conv import build_neighbor_table
from perfbench.reference.student import param_group_label

BETAS = (0.9, 0.999)
EPS = 1e-8


def make_schedule(train: dict, steps_per_epoch: int) -> Callable[[int], float]:
    """LR of the k-th update (k from 0): a linear warm-up from 1% of the peak,
    then a cosine decay to 0 over the rest of the epochs."""
    warmup = train["warmup_epochs"] * steps_per_epoch
    total = train["epochs"] * steps_per_epoch
    decay = max(total - warmup, 1)
    peak = train["lr_3d"]

    def cosine(c):
        c = min(max(c, 0), decay)
        return peak * 0.5 * (1 + math.cos(math.pi * c / decay))

    if warmup <= 0:
        return cosine
    init = peak * 0.01

    def schedule(c):
        if c < warmup:
            return (init - peak) * (1 - max(c, 0) / warmup) + peak
        return cosine(c - warmup)

    return schedule


def stage1_loss(student, scene: Dict[str, torch.Tensor], f2d, pairs, cc: dict) -> torch.Tensor:
    M = scene["voxel_coords"].shape[0]
    p2v = torch.where(scene["point_valid"], scene["point2voxel"].long(), M)
    voxel_sem = segment_mean(f2d.to(torch.float32), p2v, M)
    voxel_geom = segment_mean(scene["geom_feats"].to(torch.float32), p2v, M)
    voxel_in = torch.cat([voxel_sem, voxel_geom], 1)
    nbr = build_neighbor_table(scene["voxel_coords"], scene["voxel_valid"])
    embed = student(voxel_in, nbr, scene["voxel_valid"], train=True)
    embed_pad = torch.cat([embed, embed.new_zeros((1, embed.shape[1]))])
    p2v_c = torch.clamp(p2v, max=M)

    def rows(idx):
        return embed_pad[p2v_c[idx.long()]].float()

    A = cc["num_anchors"]
    a, p = rows(pairs.anchor_idx), rows(pairs.positive_idx)
    n = rows(pairs.negative_idx.reshape(-1)).reshape(A, cc["num_negatives"], -1)
    return info_nce_loss(a, p, n, pairs.anchor_valid, cc["temperature"])


def train_steps(student, scenes: List[Dict[str, torch.Tensor]], f2d: List[torch.Tensor],
                f_teacher: List[torch.Tensor], generator_seed: int, program: dict,
                steps_per_epoch: int, steps: int = 3) -> dict:
    """``steps`` steps on scene ``t % len(scenes)``. Returns the losses, the
    first step's gradients and the parameters after the last step."""
    cc, tr = program["contrastive"], program["train"]
    dev = scenes[0]["points"].device
    mult = {"input": tr["lr_input_mult"], "middle": tr["lr_middle_mult"],
            "output": tr["lr_output_mult"]}
    sched = make_schedule(tr, steps_per_epoch)
    params = dict(student.named_parameters())
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    shared = torch.Generator(device=dev).manual_seed(generator_seed)
    losses, grads1 = [], None
    for t in range(steps):
        i = t % len(scenes)
        seed = int(torch.randint(0, 1 << 62, (1,), generator=shared, device=dev).item())
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            pairs = sample_contrastive_pairs_hybrid(
                gen, f_teacher[i], scenes[i]["point_valid"], coords=scenes[i]["points"],
                num_anchors=cc["num_anchors"], num_macro=cc["num_macro_negatives"],
                num_micro=cc["num_micro_negatives"], spatial_k=cc["spatial_knn_k"])
        loss = stage1_loss(student, scenes[i], f2d[i], pairs, cc)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses.append(float(loss.detach()))
        if t == 0:
            grads1 = {k: g.detach().clone() for k, g in grads.items()}
        k = t + 1
        with torch.no_grad():
            for name, p in params.items():
                g = grads[name]
                lr = mult[param_group_label(name)] * sched(t)
                p.mul_(1.0 - lr * tr["weight_decay"])
                m[name].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[name].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = (v[name] / (1 - BETAS[1] ** k)).sqrt_().add_(EPS)
                p.addcdiv_(m[name], denom, value=-lr / (1 - BETAS[0] ** k))
    return {"losses": losses, "grads1": grads1,
            "params": {k: p.detach().clone() for k, p in params.items()}}
