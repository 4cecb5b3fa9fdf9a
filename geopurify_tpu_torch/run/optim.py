"""Optimizer and LR schedule of Stage-1.

Port of geopurify_tpu/run/optim.py (optax) to torch.optim: AdamW with three
LR tiers (input adapter x0.1, middle res blocks x1, output projection x5)
as one param group each, under a linear warmup (from 1% of the peak) and
cosine decay; optional clipping by the global gradient norm over all
tiers, and optional gradient accumulation over ``grad_accum_steps`` raw
steps with one schedule tick per applied update (optax ``MultiSteps``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
from torch import nn

from geopurify_tpu_torch.config import TrainConfig
from geopurify_tpu_torch.models.student import param_group_label


# geopurify_tpu/run/optim.py:21
def label_params(module: nn.Module) -> Dict[str, str]:
    """Parameter name -> 'input' | 'middle' | 'output'."""
    return {name: param_group_label(name) for name, _ in module.named_parameters()}


# geopurify_tpu/run/optim.py:28
def make_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """LR of the k-th applied update (k from 0): optax's
    ``join_schedules([linear(1% -> 100%), cosine])``."""
    warmup = cfg.warmup_epochs * steps_per_epoch
    total = cfg.epochs * steps_per_epoch
    decay = max(total - warmup, 1)
    peak = cfg.lr_3d

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


class StudentOptimizer:
    """``optax.MultiSteps(chain(clip_by_global_norm, multi_transform(adamw
    per tier)))`` over the parameters' ``.grad``: ``step()`` after each
    backward. Returns True when an update was applied."""

    def __init__(self, cfg: TrainConfig, module: nn.Module, steps_per_epoch: int):
        self.schedule = make_schedule(cfg, steps_per_epoch)
        mults = {"input": cfg.lr_input_mult, "middle": cfg.lr_middle_mult,
                 "output": cfg.lr_output_mult}
        labels = label_params(module)
        groups = []
        for tier, mult in mults.items():
            params = [p for n, p in module.named_parameters() if labels[n] == tier]
            if params:
                groups.append({"params": params, "lr": mult, "tier": tier})
        self.params = [p for g in groups for p in g["params"]]
        self.adamw = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=cfg.weight_decay)
        # each group's lr = mult * schedule(k) for the k-th applied update
        self.lr_sched = torch.optim.lr_scheduler.LambdaLR(self.adamw, self.schedule)
        self.clip = cfg.grad_clip
        self.every = max(cfg.grad_accum_steps, 1)
        self.mini_step = 0
        self.acc = None

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    def _grads(self):
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    def step(self) -> bool:
        grads = self._grads()
        if self.every > 1:
            # optax MultiSteps: running mean acc += (g - acc) / (n + 1)
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step += 1
            if self.mini_step < self.every:
                return False
            grads, self.acc, self.mini_step = self.acc, None, 0
        if self.clip:
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            scale = torch.where(norm < self.clip, 1.0, self.clip / norm)
            grads = [g * scale.to(g.dtype) for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adamw.step()
        self.lr_sched.step()
        return True

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "lr_sched": self.lr_sched.state_dict(),
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, sd: dict) -> None:
        self.adamw.load_state_dict(sd["adamw"])
        self.lr_sched.load_state_dict(sd["lr_sched"])
        self.mini_step, acc = sd["mini_step"], sd["acc"]
        # a checkpoint loads onto the CPU: the accumulators go where the
        # parameters live, as AdamW's own state does
        self.acc = None if acc is None else [
            a.to(device=p.device, dtype=p.dtype) for a, p in zip(acc, self.params)]


# geopurify_tpu/run/optim.py:40
def make_optimizer(cfg: TrainConfig, module: nn.Module, steps_per_epoch: int):
    """(optimizer, base schedule), as the JAX version's (tx, base)."""
    opt = StudentOptimizer(cfg, module, steps_per_epoch)
    return opt, opt.schedule
