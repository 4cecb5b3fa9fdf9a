"""X-Decoder 2D pretraining: the seg, vlp, joint and interactive tasks.

Port of geopurify_tpu/run/train2d.py. Each task trains one parameter tree
(``Train2DParams``, named as JAX's ``Train2DState.params``) with one
optimizer that does what ``optax.MultiSteps(chain(clip_by_global_norm,
adamw(sched, weight_decay)))`` does (``Train2DOptimizer``):

- seg: mask classification. Class logits are cosine(class_embed, text)
  with one learned no-object logit appended; ``models.criterion.
  set_criterion`` (host Hungarian matching, point-sampled mask losses);
- vlp: the caption slots ride the decoder; next-token captioning CE plus
  the in-batch image-text contrastive loss, the language tower trained too;
- joint: seg (class text from the shared language tower) and vlp over one
  tree, zipped (one batch of each task a step, one summed update) or
  switched (one task a step);
- interactive: SEEM's v1 head on the visual sampler's prompt points,
  sigmoid-CE + dice between each prompt's mask and its instance.

Batches are drawn from numpy as in JAX, so that a seed gives the same
synthetic batches in both packages; the weights, the text embeddings and
the criterion's points come from ``torch.Generator``s. ``--distributed``
runs one rank a card (``parallel.mesh``): every rank draws the batches of
all ranks from the shared numpy stream and keeps its own, as JAX's mesh
shards one global batch; the gradients and the losses are averaged over
the ranks in one flat all-reduce. Only rank 0 writes. Checkpoints (seg
only, as in JAX) hold the parameters, the optimizer, the step and the
generator states, the numpy stream's included, so that a resumed run goes
on as the uninterrupted one.

Usage:
  python -m geopurify_tpu_torch.run.train2d --synthetic --steps 10     # the card
  python -m geopurify_tpu_torch.run.train2d --device cpu --preset tiny --synthetic --steps 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from geopurify_tpu_torch import resolve_device
from geopurify_tpu_torch.config import load_config
from geopurify_tpu_torch.models.criterion import (
    captioning_loss,
    image_text_contrastive_loss,
    set_criterion,
)
from geopurify_tpu_torch.models.xdecoder import XDecoderSegModel, model_dtype
from geopurify_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_mean_,
    init_distributed,
    make_mesh,
)
from geopurify_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint_with_retry

log = logging.getLogger("geopurify.train2d")

# CLIP's initial logit scale, exp(ln(1/0.07)) rounded to f32 (train2d.py:924)
LOGIT_SCALE = float(np.float32(np.exp(2.659260036932778)))


class Train2DParams(nn.Module):
    """One task's parameters under JAX's names: seg ``{model, no_object}``,
    vlp ``{model, lang}``, joint ``{model, lang, no_object}``, interactive
    ``{backbone, pixdec, head}`` (``utils.from_jax.train2d_from_jax``)."""

    def __init__(self, **parts):
        super().__init__()
        for name, part in parts.items():
            if isinstance(part, nn.Module):
                self.add_module(name, part)
            else:
                self.register_parameter(name, nn.Parameter(part))


# geopurify_tpu/run/train2d.py:85
def make_schedule(base_lr: float, warmup_steps: int, decay_steps, gamma: float = 0.1):
    """Linear warm-up, then x ``gamma`` at each of ``decay_steps``: the
    learning rate of update ``step`` (from 0; ``sched(0) = 0``), in f32
    arithmetic as JAX's."""
    f32 = np.float32

    def sched(step):
        warm = min(f32(step) / f32(max(warmup_steps, 1)), f32(1.0))
        decay = f32(gamma) ** f32(sum(step >= d for d in decay_steps))
        return float(f32(base_lr) * warm * decay)
    return sched


def train_schedule(args) -> Callable[[int], float]:
    """The schedule of every task: warm-up over 10 updates, decays at 88%
    and 96% of ``--steps`` (train2d.py:939-940)."""
    decay = (int(args.steps * 0.88), int(args.steps * 0.96))
    return make_schedule(args.lr, warmup_steps=10, decay_steps=decay)


class Train2DOptimizer:
    """``optax.MultiSteps(chain(clip_by_global_norm(clip) or identity,
    adamw(sched, weight_decay)), k)`` over the parameters' ``.grad``
    (train2d.py:941-946). ``step()`` after each backward: the gradients
    (zero where a task did not touch a parameter) join a running mean;
    every ``k``-th call the mean is clipped to global norm ``clip`` (``g *
    clip / norm`` where the norm reaches it) and AdamW (optax's betas and
    eps, decay on every parameter, scaled by the learning rate) applies it
    at ``sched(n)`` for the n-th update, so the first update moves nothing.
    Returns True when an update was applied."""

    def __init__(self, params: Sequence[nn.Parameter], sched: Callable[[int], float],
                 weight_decay: float, grad_clip: float, grad_accum: int = 1):
        self.params = list(params)
        self.sched = sched
        # one fused kernel over every tensor on the card
        self.adamw = torch.optim.AdamW(self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay,
                                       fused=all(p.is_cuda for p in self.params) or None)
        self.clip, self.every = grad_clip, max(grad_accum, 1)
        self.count = self.mini_step = 0
        self.acc = None

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    def grads(self):
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    def step(self) -> bool:
        grads = self.grads()
        if self.every > 1:
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
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            if norm >= self.clip:
                grads = torch._foreach_mul(torch._foreach_div(grads, norm), self.clip)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = self.sched(self.count)
        self.adamw.step()
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, sd: dict) -> None:
        self.adamw.load_state_dict(sd["adamw"])
        self.count, self.mini_step, acc = sd["count"], sd["mini_step"], sd["acc"]
        self.acc = None if acc is None else [a.to(p.device) for a, p in zip(acc, self.params)]


def make_optimizer(params: nn.Module, args) -> Train2DOptimizer:
    return Train2DOptimizer(params.parameters(), train_schedule(args), args.weight_decay,
                            args.grad_clip, args.grad_accum)


# geopurify_tpu/run/train2d.py:56
@dataclass
class Train2DState:
    """The parameters, their optimizer, the step count and the generator of
    the criterion's points (JAX's key)."""

    params: Train2DParams
    opt_state: Train2DOptimizer
    step: int
    generator: torch.Generator

    def state_dict(self) -> dict:
        return {"params": {k: v.detach().cpu() for k, v in self.params.state_dict().items()},
                "opt_state": self.opt_state.state_dict(), "step": self.step,
                "rng": self.generator.get_state()}

    def load_state_dict(self, sd: dict) -> None:
        self.params.load_state_dict(sd["params"])
        self.opt_state.load_state_dict(sd["opt_state"])
        self.step = int(sd["step"])
        self.generator.set_state(sd["rng"])


def _to(batch, dev):
    return tuple(x.to(dev) for x in batch)


# geopurify_tpu/run/train2d.py:62
def synthetic_batch(rng: np.random.Generator, batch: int, hw, n_cls: int,
                    max_targets: int = 8):
    """Random images with rectangle instances on the stride-4 mask grid:
    (images [B, H, W, 3], gt_classes [B, T], gt_masks [B, T, H/4, W/4],
    gt_valid [B, T]) CPU tensors."""
    H, W = hw
    images = rng.uniform(0, 255, (batch, H, W, 3)).astype(np.float32)
    h, w = H // 4, W // 4
    gt_masks = np.zeros((batch, max_targets, h, w), np.float32)
    gt_classes = np.zeros((batch, max_targets), np.int32)
    gt_valid = np.zeros((batch, max_targets), bool)
    for b in range(batch):
        n_t = int(rng.integers(1, max_targets + 1))
        for t in range(n_t):
            y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
            y1, x1 = y0 + rng.integers(2, h // 2), x0 + rng.integers(2, w // 2)
            gt_masks[b, t, y0:y1, x0:x1] = 1.0
            gt_classes[b, t] = rng.integers(0, n_cls)
            gt_valid[b, t] = True
    return tuple(torch.from_numpy(a) for a in (images, gt_classes, gt_masks, gt_valid))


# geopurify_tpu/run/train2d.py:96
def synthetic_captions(rng: np.random.Generator, batch: int, cap_len: int, vocab: int):
    """CLIP-layout random captions: BOS, tokens, EOT (= max id), zero pad;
    (ids [B, L] int64, mask [B, L] f32)."""
    ids = np.zeros((batch, cap_len), np.int64)
    mask = np.zeros((batch, cap_len), np.float32)
    for b in range(batch):
        L = int(rng.integers(3, cap_len - 2))
        ids[b, 0] = vocab - 2
        ids[b, 1: 1 + L] = rng.integers(1, vocab - 2, L)
        ids[b, 1 + L] = vocab - 1
        mask[b, : 2 + L] = 1.0
    return torch.from_numpy(ids), torch.from_numpy(mask)


# geopurify_tpu/run/train2d.py:163
def synthetic_interactive_scene(rng: np.random.Generator, hw, n_cls: int,
                                max_targets: int = 4):
    """One synthetic panoptic dataset dict (rectangular segments in a
    label-divisor raster) for the interactive mapper."""
    from geopurify_tpu_torch.data.mappers import id2rgb

    H, W = hw
    pan_id = np.zeros((H, W), np.int32)
    segments = []
    n_t = int(rng.integers(1, max_targets + 1))
    for t in range(n_t):
        y0, x0 = int(rng.integers(0, H // 2)), int(rng.integers(0, W // 2))
        y1 = y0 + int(rng.integers(H // 4, H // 2))
        x1 = x0 + int(rng.integers(W // 4, W // 2))
        sid = t + 1
        pan_id[y0:y1, x0:x1] = sid
        segments.append({"id": sid, "category_id": int(rng.integers(n_cls)), "iscrowd": 0})
    # only the segments that survived occlusion by later rectangles
    segments = [s for s in segments if (pan_id == s["id"]).sum() >= 16]
    image = rng.uniform(0, 255, (H, W, 3)).astype(np.uint8)
    return {"image_np": image, "pan_seg_np": id2rgb(pan_id), "segments_info": segments,
            "height": H, "width": W}


# geopurify_tpu/run/train2d.py:189
def synthetic_interactive_batch(rng: np.random.Generator, mapper, batch: int, hw, n_cls: int,
                                num_masks: int, budget: int):
    """Synthetic panoptic scenes through ``InteractiveMapper`` (jitter and
    the visual sampler's prompts) -> the SEEM head's inputs: (images, prompt
    points [B, budget, 2] normalised, valid, mask ids, stride-4 gt masks [B,
    num_masks, H/4, W/4], slot valid) CPU tensors."""
    from geopurify_tpu_torch.models.seem import points_from_masks

    H, W = hw
    h4, w4 = H // 4, W // 4
    images = np.zeros((batch, H, W, 3), np.float32)
    pts = np.zeros((batch, budget, 2), np.float32)
    valid = np.zeros((batch, budget), bool)
    mask_ids = np.zeros((batch, budget), np.int32)
    gt4 = np.zeros((batch, num_masks, h4, w4), np.float32)
    slot_valid = np.zeros((batch, num_masks), bool)
    per_slot = max(budget // num_masks, 1)
    for b in range(batch):
        out = mapper(synthetic_interactive_scene(rng, hw, n_cls), rng)
        images[b] = out["image"].astype(np.float32)
        sq = out["spatial_query"]
        shapes, gts, types = sq["rand_shape"], sq["gt_masks"], sq["types"]
        cursor = 0
        for s in range(min(len(shapes), num_masks)):
            if types[s] == "none" or not shapes[s].any():
                continue
            p, v, _ = points_from_masks(shapes[s], np.zeros_like(shapes[s]), per_slot, rng)
            n = int(v.sum())
            if n == 0:
                continue
            pts[b, cursor: cursor + n] = p[:n]
            valid[b, cursor: cursor + n] = True
            mask_ids[b, cursor: cursor + n] = s
            cursor += n
            gt4[b, s] = gts[s].astype(np.float32).reshape(h4, 4, w4, 4).max(axis=(1, 3))
            slot_valid[b, s] = True
    return tuple(torch.from_numpy(a) for a in (images, pts, valid, mask_ids, gt4, slot_valid))


# ---------------------------------------------------------------------------
# losses (the loss_fn bodies of the JAX step builders)
# ---------------------------------------------------------------------------

def with_no_object(out: Dict[str, torch.Tensor], no_object: torch.Tensor,
                   logit_scale) -> torch.Tensor:
    """The class logits with the learned no-object logit appended: cosine of
    the projected query embeddings with the no-object embedding, at the
    text logits' scale (train2d.py:301-312)."""
    no_obj = no_object / torch.linalg.norm(no_object).clamp_min(1e-8)
    emb = out["mask_embed"]
    emb = emb / torch.linalg.norm(emb, dim=-1, keepdim=True).clamp_min(1e-8)
    return torch.cat([out["pred_logits"], (logit_scale * emb @ no_obj)[..., None]], -1)


def seg_losses(params: Train2DParams, images, gt_cls, gt_masks, gt_valid, text, logit_scale,
               num_points: int, generator=None, points=None, **head_kw):
    """(total, losses) of one seg batch against the class ``text``
    (train2d.py:298-317). ``points`` / ``head_kw`` (the head's forced
    attention masks) are the tests' seams."""
    out = params.model(images, text, logit_scale, **head_kw)
    losses = set_criterion(with_no_object(out, params.no_object, logit_scale),
                           out["pred_masks"], gt_cls, gt_masks, gt_valid, generator,
                           num_points=num_points, points=points)
    return losses["loss"], losses


def class_text(params: Train2DParams, class_ids) -> torch.Tensor:
    """Class prompts through the shared language tower, a zero background
    row appended (train2d.py:352-354)."""
    pooled = params.lang(class_ids)
    return torch.cat([pooled, pooled.new_zeros((1, pooled.shape[1]))], 0)


def vlp_losses(params: Train2DParams, images, cap_ids, cap_mask, text, logit_scale,
               caption_weight: float = 2.0, retrieval_weight: float = 2.0, **head_kw):
    """(total, losses) of one VLP batch: captioning CE over the caption slots
    and the image-text contrastive loss of the class token against the
    pooled captions (train2d.py:125-144)."""
    tok_emb, pooled = params.lang.encode_tokens(cap_ids)
    out = params.model(images, text, logit_scale, caption_tokens=tok_emb, **head_kw)
    table = params.lang.lang_encoder.token_embedding.embedding
    l_cap = captioning_loss(out["pred_captionings"], table, cap_ids, cap_mask)
    l_ret = image_text_contrastive_loss(out["pred_captions"][:, -1], pooled,
                                        params.lang.logit_scale)
    total = caption_weight * l_cap + retrieval_weight * l_ret
    return total, {"loss": total, "loss_captioning": l_cap, "loss_retrieval": l_ret}


def joint_seg_losses(params: Train2DParams, images, gt_cls, gt_masks, gt_valid, class_ids,
                     logit_scale, num_points: int, generator=None, points=None, **head_kw):
    """The seg loss with the class text from the shared tower (train2d.py:351-371)."""
    return seg_losses(params, images, gt_cls, gt_masks, gt_valid, class_text(params, class_ids),
                      logit_scale, num_points, generator, points, **head_kw)


def joint_zip_losses(params: Train2DParams, seg_batch, vlp_batch, class_ids, logit_scale,
                     num_points: int, generator=None, points=None, seg_kw=None, vlp_kw=None,
                     caption_weight: float = 2.0, retrieval_weight: float = 2.0):
    """One seg and one VLP batch through the shared trunk and tower, the
    losses summed (train2d.py:411-446); ``seg_kw`` / ``vlp_kw`` are each
    forward's head instrumentation."""
    text = class_text(params, class_ids)
    _, seg = seg_losses(params, *seg_batch, text, logit_scale, num_points, generator, points,
                        **(seg_kw or {}))
    _, vlp = vlp_losses(params, *vlp_batch, text, logit_scale, caption_weight,
                        retrieval_weight, **(vlp_kw or {}))
    total = seg["loss"] + caption_weight * vlp["loss_captioning"] \
        + retrieval_weight * vlp["loss_retrieval"]
    return total, {**{k: v for k, v in seg.items() if k != "loss"}, "loss": total,
                   "loss_captioning": vlp["loss_captioning"],
                   "loss_retrieval": vlp["loss_retrieval"]}


def interactive_losses(params: Train2DParams, images, pts, valid, mask_ids, gt4, slot_valid,
                       text, logit_scale, qidx, dtype=torch.float32):
    """Sigmoid-CE + dice between each prompt slot's mask (the head's
    ``prev_mask``) and its instance, weights 2 / 2 (train2d.py:246-270)."""
    num_masks = gt4.shape[1]
    feats = params.backbone((images / 127.5 - 1.0).to(dtype))
    mask_features, _, multi_scale = params.pixdec(feats)
    out = params.head(list(multi_scale), mask_features, text, logit_scale, pts, valid,
                      torch.ones_like(mask_ids), mask_ids, qidx, num_masks=num_masks)
    p = out["prev_mask"].reshape(out["prev_mask"].shape[0], num_masks, -1)
    g = gt4.reshape(gt4.shape[0], num_masks, -1).to(p.dtype)
    ce = (p.clamp_min(0) - p * g + torch.log1p(torch.exp(-p.abs()))).mean(-1)
    prob = torch.sigmoid(p)
    dice = 1.0 - (2.0 * (prob * g).sum(-1) + 1.0) / (prob.sum(-1) + g.sum(-1) + 1.0)
    w = slot_valid.to(p.dtype)
    denom = w.sum().clamp_min(1.0)
    l_ce, l_dice = (ce * w).sum() / denom, (dice * w).sum() / denom
    total = 2.0 * l_ce + 2.0 * l_dice
    return total, {"loss": total, "loss_spatial_ce": l_ce, "loss_spatial_dice": l_dice}


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def apply_step(state: Train2DState, loss_fn, mesh: Optional[Mesh] = None
               ) -> Dict[str, torch.Tensor]:
    """Value and gradient of ``loss_fn(params)``, the mean of the gradients
    and the losses over the ranks (one flat all-reduce, JAX's pmean), the
    optimizer; the losses, detached."""
    opt = state.opt_state
    opt.zero_grad()
    total, losses = loss_fn(state.params)
    total.backward()
    names = list(losses)
    vals = torch.stack([losses[k].detach().float() for k in names])
    if mesh is not None and mesh.group is not None:
        grads = opt.grads()
        all_reduce_mean_(grads + [vals], mesh.dp, mesh.group)
        for p, g in zip(opt.params, grads):
            p.grad = g
    opt.step()
    state.step += 1
    return dict(zip(names, vals))


def rank_generator(state: Train2DState, mesh: Optional[Mesh]) -> torch.Generator:
    """The criterion's generator of one step and rank: JAX's ``split`` of the
    key, then ``fold_in(axis_index)`` (train2d.py:296, :1000)."""
    from geopurify_tpu_torch.run.train import rank_generator as fold

    return fold(state.generator, mesh.rank if mesh is not None else 0)


# geopurify_tpu/run/train2d.py:290
def make_train2d_step(mesh: Optional[Mesh], num_points: int):
    """``step(state, images, gt_cls, gt_masks, gt_valid, text, logit_scale)
    -> losses``: one seg update."""
    def step(state, images, gt_cls, gt_masks, gt_valid, text, logit_scale):
        gen = rank_generator(state, mesh)
        return apply_step(state, lambda p: seg_losses(
            p, images, gt_cls, gt_masks, gt_valid, text, logit_scale, num_points, gen), mesh)
    return step


# geopurify_tpu/run/train2d.py:110
def make_vlp_step(mesh: Optional[Mesh], caption_weight: float = 2.0,
                  retrieval_weight: float = 2.0):
    def step(state, images, cap_ids, cap_mask, text, logit_scale):
        return apply_step(state, lambda p: vlp_losses(
            p, images, cap_ids, cap_mask, text, logit_scale, caption_weight,
            retrieval_weight), mesh)
    return step


# geopurify_tpu/run/train2d.py:337
def make_joint_seg_step(mesh: Optional[Mesh], num_points: int):
    def step(state, images, gt_cls, gt_masks, gt_valid, class_ids, logit_scale):
        gen = rank_generator(state, mesh)
        return apply_step(state, lambda p: joint_seg_losses(
            p, images, gt_cls, gt_masks, gt_valid, class_ids, logit_scale, num_points, gen),
            mesh)
    return step


# geopurify_tpu/run/train2d.py:391
def make_joint_zip_step(mesh: Optional[Mesh], num_points: int, caption_weight: float = 2.0,
                        retrieval_weight: float = 2.0):
    def step(state, seg_batch, vlp_batch, class_ids, logit_scale):
        gen = rank_generator(state, mesh)
        return apply_step(state, lambda p: joint_zip_losses(
            p, seg_batch, vlp_batch, class_ids, logit_scale, num_points, gen,
            caption_weight=caption_weight, retrieval_weight=retrieval_weight), mesh)
    return step


# geopurify_tpu/run/train2d.py:232
def make_interactive_step(mesh: Optional[Mesh], dtype=torch.float32):
    def step(state, batch, text, logit_scale, qidx):
        return apply_step(state, lambda p: interactive_losses(
            p, *batch, text, logit_scale, qidx, dtype), mesh)
    return step


# ---------------------------------------------------------------------------
# the task loops
# ---------------------------------------------------------------------------

@dataclass
class Run:
    """What every task shares: arguments, config, device, data axis,
    generators (weights ``init``, criterion points ``key``), the numpy
    batch stream and the log."""

    args: argparse.Namespace
    cfg: object
    dev: torch.device
    mesh: Mesh
    init: torch.Generator
    key: torch.Generator
    rng_np: np.random.Generator
    is_main: bool

    @property
    def n_dp(self) -> int:
        return self.mesh.dp

    def own(self, batches):
        """This rank's share of the ``n_dp`` batches all ranks drew."""
        return batches[self.mesh.rank]

    def record(self, rec: dict) -> None:
        log.info("%s", rec)
        if self.is_main:
            with open(os.path.join(self.args.save_path, "metrics.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")

    def logged(self, it: int, step: int) -> bool:
        return step % self.args.print_every == 0 or it == self.args.steps - 1


def unit_rows(n: int, dim: int, generator: torch.Generator) -> torch.Tensor:
    """``n`` random unit rows (the pretraining text matrix, train2d.py:919-923)."""
    t = torch.randn((n, dim), generator=generator)
    return t / torch.linalg.norm(t, dim=-1, keepdim=True)


def build_model(cfg, generator: torch.Generator, caption_len: int = 0) -> XDecoderSegModel:
    from geopurify_tpu_torch.models.layers import flax_init_

    model = XDecoderSegModel(cfg.xdecoder, caption_len=caption_len)
    flax_init_(model, generator)
    return model


def build_lang(cfg, context_length: int, generator: torch.Generator):
    from geopurify_tpu_torch.models.lang import LanguageEncoder, init_language_

    tc = cfg.text
    if not (tc.width == tc.dim_proj == cfg.xdecoder.hidden_dim):
        raise SystemExit("vlp / joint tasks require text.width == text.dim_proj == "
                         "xdecoder.hidden_dim (the reference runs all three at 512)")
    lang = LanguageEncoder(vocab_size=tc.vocab_size, width=tc.width, layers=tc.layers,
                           heads=tc.heads, context_length=context_length, dim_proj=tc.dim_proj)
    return init_language_(lang, generator)


def new_state(r: Run, params: Train2DParams) -> Train2DState:
    params.to(r.dev).train()
    return Train2DState(params, make_optimizer(params, r.args), 0, r.key)


def finish(r: Run, state: Train2DState, label: str, t0: float) -> Train2DState:
    if r.is_main:
        save_checkpoint_with_retry(os.path.join(r.args.save_path, "ckpt"),
                                   checkpoint(state, r.rng_np), state.step)
    log.info("%s done: %d steps in %.1fs", label, state.step, time.time() - t0)
    return state


def checkpoint(state: Train2DState, rng_np: np.random.Generator) -> dict:
    return {**state.state_dict(), "np_rng": rng_np.bit_generator.state}


# geopurify_tpu/run/train2d.py:840-1027 (the seg task)
def run_seg(r: Run, model: XDecoderSegModel, text: torch.Tensor, logit_scale: float,
            n_cls: int) -> Train2DState:
    args, H, W = r.args, *r.cfg.xdecoder.mask_shape
    params = Train2DParams(model=model, no_object=torch.randn(
        (r.cfg.xdecoder.hidden_dim,), generator=r.init) * 0.02)
    state = new_state(r, params)
    if args.resume:
        restored, step0 = restore_checkpoint(args.resume)
        if restored is not None:
            state.load_state_dict(restored)
            r.rng_np.bit_generator.state = restored["np_rng"]
            log.info("resumed from step %d", step0)
    data_iter = None
    if args.data_root:
        from geopurify_tpu_torch.data.seg2d import Seg2DDataset

        ds = Seg2DDataset(args.data_root)
        if ds.class_names:
            n_cls = len(ds.class_names)
            text = unit_rows(n_cls + 1, r.cfg.xdecoder.hidden_dim, r.init)
        log.info("dataset: %d images, %d classes (%s layout)", len(ds), n_cls, ds.mode)
        data_iter = ds.batches(args.batch_size, (H, W), max_targets=args.max_targets,
                               seed=r.cfg.train.manual_seed)
    text = text.to(r.dev)
    step_fn = make_train2d_step(r.mesh, args.num_points)
    ckpt_dir = os.path.join(args.save_path, "ckpt")
    t0 = time.time()
    for it in range(args.steps):
        if data_iter is not None:
            batches = [tuple(torch.from_numpy(x) for x in next(data_iter))
                       for _ in range(r.n_dp)]
        else:
            batches = [synthetic_batch(r.rng_np, args.batch_size, (H, W), n_cls)
                       for _ in range(r.n_dp)]
        losses = step_fn(state, *_to(r.own(batches), r.dev), text, logit_scale)
        step = state.step
        if r.logged(it, step):
            r.record({"step": step, **{k: float(v) for k, v in losses.items()},
                      "lr": state.opt_state.sched(step),
                      "items_per_sec": step * r.n_dp * args.batch_size
                      / max(time.time() - t0, 1e-9)})
        if args.save_every and step % args.save_every == 0 and r.is_main:
            save_checkpoint_with_retry(ckpt_dir, checkpoint(state, r.rng_np), step)
    return finish(r, state, "seg", t0)


# geopurify_tpu/run/train2d.py:762
def run_vlp(r: Run, text: torch.Tensor, logit_scale: float) -> Train2DState:
    args, cfg = r.args, r.cfg
    H, W = cfg.xdecoder.mask_shape
    tc = cfg.text
    lang = build_lang(cfg, max(args.caption_len, 8), r.init)
    # the JAX entry draws its init captions from the batch stream
    synthetic_captions(r.rng_np, args.batch_size, args.caption_len, tc.vocab_size)
    params = Train2DParams(model=build_model(cfg, r.init, caption_len=args.caption_len),
                           lang=lang)
    state = new_state(r, params)
    text = text.to(r.dev)
    step_fn = make_vlp_step(r.mesh)
    t0 = time.time()
    for it in range(args.steps):
        batches = []
        for _ in range(r.n_dp):
            imgs = torch.from_numpy(r.rng_np.uniform(
                0, 255, (args.batch_size, H, W, 3)).astype(np.float32))
            batches.append((imgs, *synthetic_captions(r.rng_np, args.batch_size,
                                                      args.caption_len, tc.vocab_size)))
        losses = step_fn(state, *_to(r.own(batches), r.dev), text, logit_scale)
        if r.logged(it, state.step):
            r.record({"step": state.step, **{k: float(v) for k, v in losses.items()},
                      "lr": state.opt_state.sched(state.step)})
    return finish(r, state, "vlp", t0)


# geopurify_tpu/run/train2d.py:466
def run_joint(r: Run, logit_scale: float) -> Train2DState:
    from geopurify_tpu_torch.models.lang import PROMPT_TEMPLATES, HashTokenizer

    args, cfg = r.args, r.cfg
    tc = cfg.text
    H, W = cfg.xdecoder.mask_shape
    n_cls = max(len(cfg.data.all_label), 2)
    cap_len = max(args.caption_len, 8)
    lang = build_lang(cfg, cap_len, r.init)
    # class prompts through the shared tower (template 0)
    tk = HashTokenizer(vocab_size=tc.vocab_size, context_length=cap_len)
    names = list(cfg.data.all_label) or [f"c{i}" for i in range(n_cls)]
    class_ids = tk([PROMPT_TEMPLATES[0].format(n) for n in names[:n_cls]])[0]
    # the JAX entry draws its init captions from the batch stream
    synthetic_captions(r.rng_np, args.batch_size, cap_len, tc.vocab_size)
    text0 = unit_rows(n_cls + 1, cfg.xdecoder.hidden_dim, r.init)
    # the caption slots: the superset of both tasks' parameters
    params = Train2DParams(model=build_model(cfg, r.init, caption_len=cap_len), lang=lang,
                           no_object=torch.randn((cfg.xdecoder.hidden_dim,),
                                                 generator=r.init) * 0.02)
    state = new_state(r, params)

    seg_iter = vlp_iter = None
    if args.data_root:
        from geopurify_tpu_torch.data.seg2d import Seg2DDataset

        ds = Seg2DDataset(args.data_root)
        if ds.class_names:
            class_ids = tk([PROMPT_TEMPLATES[0].format(n) for n in ds.class_names])[0]
        # one iterator a shard, seeded by its index: this rank's
        seg_iter = ds.batches(args.batch_size, (H, W), max_targets=args.max_targets,
                              seed=cfg.train.manual_seed + r.mesh.rank)
    if args.vlp_data_root:
        from geopurify_tpu_torch.data.joint_loader import CaptionDataset

        vlp_iter = CaptionDataset(args.vlp_data_root).batches(
            args.batch_size, (H, H), tk, cap_len, seed=cfg.train.manual_seed + r.mesh.rank)
    class_ids = torch.from_numpy(class_ids).to(r.dev)

    def seg_batch():
        if seg_iter is not None:
            return tuple(torch.from_numpy(x) for x in next(seg_iter))
        return r.own([synthetic_batch(r.rng_np, args.batch_size, (H, W), n_cls)
                      for _ in range(r.n_dp)])

    def vlp_batch():
        if vlp_iter is not None:
            imgs, ids, mask = next(vlp_iter)
            if imgs.shape[1:3] != (H, W):
                imgs = np.pad(imgs, ((0, 0), (0, max(W - imgs.shape[1], 0)),
                                     (0, max(W - imgs.shape[2], 0)), (0, 0)))[:, :H, :W]
            return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (imgs, ids, mask))
        batches = []
        for _ in range(r.n_dp):
            imgs = torch.from_numpy(r.rng_np.uniform(
                0, 255, (args.batch_size, H, W, 3)).astype(np.float32))
            batches.append((imgs, *synthetic_captions(r.rng_np, args.batch_size, cap_len,
                                                      tc.vocab_size)))
        return r.own(batches)

    if args.joint_mode == "zip":
        zip_step = make_joint_zip_step(r.mesh, args.num_points)
    else:
        seg_step = make_joint_seg_step(r.mesh, args.num_points)
        vlp_step = make_vlp_step(r.mesh)
        text0 = text0.to(r.dev)
    w_seg, w_vlp = (float(x) for x in args.task_weights.split(":"))
    p_seg = w_seg / max(w_seg + w_vlp, 1e-9)
    t0 = time.time()
    counts = {"seg": 0, "vlp": 0, "zip": 0}
    for it in range(args.steps):
        if args.joint_mode == "zip":
            task = "zip"
            sb, vb = seg_batch(), vlp_batch()
            losses = zip_step(state, _to(sb, r.dev), _to(vb, r.dev), class_ids, logit_scale)
        else:
            # the first two steps cover both tasks
            task = "seg" if it == 0 else "vlp" if it == 1 else (
                "seg" if r.rng_np.uniform() < p_seg else "vlp")
            if task == "seg":
                losses = seg_step(state, *_to(seg_batch(), r.dev), class_ids, logit_scale)
            else:
                losses = vlp_step(state, *_to(vlp_batch(), r.dev), text0, logit_scale)
        counts[task] += 1
        if r.logged(it, state.step):
            r.record({"step": state.step, "task": task,
                      **{k: float(v) for k, v in losses.items()},
                      "lr": state.opt_state.sched(state.step)})
    log.info("joint tasks: %s", counts)
    return finish(r, state, "joint", t0)


# geopurify_tpu/run/train2d.py:652
def run_interactive(r: Run, text: torch.Tensor, logit_scale: float) -> Train2DState:
    """SEEM v1 spatial-prompt training. The backbone and pixel decoder are
    the X-Decoder config's (the JAX entry builds FocalNet from four of its
    options and the FPN decoder whatever the config says)."""
    from geopurify_tpu_torch.data.mappers import InteractiveMapper
    from geopurify_tpu_torch.data.visual_sampler import StrokeSamplerConfig
    from geopurify_tpu_torch.models.layers import flax_init_
    from geopurify_tpu_torch.models.seem import SEEMHeadV1
    from geopurify_tpu_torch.models.xdecoder import _make_backbone, _make_pixel_decoder

    args, xc = r.args, r.cfg.xdecoder
    H, W = xc.mask_shape
    if H != W:
        raise SystemExit("interactive task needs square mask_shape (the mapper's "
                         "FixedSizeCrop is square, INPUT.IMAGE_SIZE)")
    num_masks, budget = args.max_candidate, args.prompt_budget
    head = SEEMHeadV1(hidden_dim=xc.hidden_dim, dim_proj=xc.hidden_dim,
                      num_queries=xc.num_queries, nheads=xc.nheads,
                      dim_feedforward=xc.dim_feedforward, dec_layers=xc.dec_layers,
                      mask_dim=xc.mask_dim, max_spatial_tokens=budget, dtype=model_dtype(xc))
    params = Train2DParams(backbone=_make_backbone(xc), pixdec=_make_pixel_decoder(xc), head=head)
    flax_init_(params, r.init)
    mapper = InteractiveMapper(image_size=H, min_scale=args.jitter_min,
                               max_scale=args.jitter_max,
                               sampler_cfg=StrokeSamplerConfig(max_candidate=num_masks),
                               grounding=False)
    n_cls = max(len(r.cfg.data.all_label), 2)
    # the JAX entry draws its init batch from the batch stream
    synthetic_interactive_batch(r.rng_np, mapper, args.batch_size, (H, W), n_cls, num_masks,
                                budget)
    state = new_state(r, params)
    text = text[:-1].to(r.dev)
    step_fn = make_interactive_step(r.mesh, model_dtype(xc))
    t0 = time.time()
    for it in range(args.steps):
        shards = [synthetic_interactive_batch(r.rng_np, mapper, args.batch_size, (H, W), n_cls,
                                              num_masks, budget) for _ in range(r.n_dp)]
        # the spatial queries' sample, from the batch stream
        qidx = torch.from_numpy(r.rng_np.integers(
            0, xc.num_queries, head.sample_size * num_masks)).to(r.dev)
        losses = step_fn(state, _to(r.own(shards), r.dev), text, logit_scale, qidx)
        if r.logged(it, state.step):
            r.record({"step": state.step, **{k: float(v) for k, v in losses.items()},
                      "lr": state.opt_state.sched(state.step)})
    return finish(r, state, "interactive", t0)


def main(argv=None) -> Optional[Train2DState]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", default="scannet")
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--task", default="seg",
                        choices=["seg", "vlp", "joint", "interactive"],
                        help="seg: mask-classification pretraining; vlp: caption slots + "
                             "captioning CE + image-text contrastive; joint: seg and vlp "
                             "over one parameter tree; interactive: SEEM spatial-prompt "
                             "training through the visual sampler")
    parser.add_argument("--task-weights", default="1:1",
                        help="joint (switch) task sampling weights seg:vlp")
    parser.add_argument("--joint-mode", default="zip", choices=["zip", "switch"],
                        help="zip: one batch of each task a step, one summed update; "
                             "switch: one task a step, drawn by --task-weights")
    parser.add_argument("--vlp-data-root", default=None,
                        help="joint: on-disk caption dataset (images/ + captions.json)")
    parser.add_argument("--max-candidate", type=int, default=2,
                        help="interactive: prompt instances per image")
    parser.add_argument("--prompt-budget", type=int, default=64,
                        help="interactive: spatial prompt points per image")
    parser.add_argument("--jitter-min", type=float, default=0.9)
    parser.add_argument("--jitter-max", type=float, default=1.1)
    parser.add_argument("--caption-len", type=int, default=32)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--data-root", default=None,
                        help="on-disk dataset (COCO annotations.json or the images/ + "
                             "masks/ folder layout)")
    parser.add_argument("--max-targets", type=int, default=8)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=1, help="images per rank per step")
    parser.add_argument("--image-hw", default=None, help="HxW override (e.g. 96x128)")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight-decay", type=float, default=0.05)
    parser.add_argument("--grad-accum", type=int, default=1)
    parser.add_argument("--grad-clip", type=float, default=0.01,
                        help="grad norm clip (X-Decoder trainer default)")
    parser.add_argument("--num-points", type=int, default=4096)
    parser.add_argument("--save-path", default="runs/train2d")
    parser.add_argument("--save-every", type=int, default=500, help="seg task only")
    parser.add_argument("--print-every", type=int, default=10)
    parser.add_argument("--resume", default=None, help="seg task only")
    parser.add_argument("--distributed", action="store_true")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    if args.resume and args.task != "seg":
        # the JAX entry reads --resume for the seg task only and starts the
        # others from scratch without a word (ROADMAP Queue 3)
        parser.error(f"--resume is implemented for --task seg only, not {args.task!r}")
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s %(filename)s:%(lineno)d] %(message)s")
    cfg = load_config(args.preset, overrides=args.overrides, yaml_path=args.config)
    if args.image_hw:
        h, w = (int(x) for x in args.image_hw.split("x"))
        cfg = dataclasses.replace(cfg, xdecoder=dataclasses.replace(cfg.xdecoder,
                                                                    mask_shape=(h, w)))
    if args.task == "seg" and not (args.data_root or args.synthetic):
        parser.error("pass --synthetic or --data-root")
    owns_group = args.distributed and not torch.distributed.is_initialized()
    dev = init_distributed(args.device) if args.distributed else resolve_device(args.device)
    mesh = make_mesh(cfg.parallel.dp, cfg.parallel.tp)
    if args.distributed:
        log.info("distributed: rank %d of %d on %s", mesh.rank, mesh.dp, dev)
    seed = cfg.train.manual_seed
    r = Run(args, cfg, dev, mesh, init=torch.Generator().manual_seed(seed),
            key=torch.Generator(device=dev).manual_seed(seed),
            rng_np=np.random.default_rng(seed), is_main=mesh.rank == 0)
    if r.is_main:
        os.makedirs(args.save_path, exist_ok=True)
    n_cls = max(len(cfg.data.all_label), 2)
    text = unit_rows(n_cls + 1, cfg.xdecoder.hidden_dim, r.init)
    try:
        if args.task == "vlp":
            return run_vlp(r, text, LOGIT_SCALE)
        if args.task == "joint":
            return run_joint(r, LOGIT_SCALE)
        if args.task == "interactive":
            return run_interactive(r, text, LOGIT_SCALE)
        return run_seg(r, build_model(cfg, r.init), text, LOGIT_SCALE, n_cls)
    finally:
        if owns_group:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
