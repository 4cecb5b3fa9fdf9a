"""Stage-1 training entry — geometric distillation of the student.

Port of geopurify_tpu/run/train.py on one device: each step lifts the 2D
teacher (X-Decoder) and runs the frozen Sonata teacher outside autograd,
then takes the value and gradient of ``stage1_loss`` and an AdamW step over
three LR tiers (``run/optim.py``). Checkpoints hold the student's
parameters and running statistics, the optimizer state, the step and the
anchor generator's state (``utils/checkpoint.py``); ``train.resume``
continues from them.

The JAX trainer's data parallelism (``parallel.dp`` > 1, SyncBN), the
teacher cache, the precomputed fused features and real datasets (the data
layer exists, ``data/loaders.SceneDataset``, but is not wired in yet) wait
in ROADMAP Queue 1: they raise ``NotImplementedError`` here. ``dp = -1`` (all
devices) resolves to one device.

Usage:
  python -m geopurify_tpu_torch.run.train --synthetic --epochs 1 --steps-per-epoch 2
  python -m geopurify_tpu_torch.run.train --preset tiny --synthetic --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch

from geopurify_tpu_torch import resolve_device
from geopurify_tpu_torch.config import GeoPurifyConfig, load_config
from geopurify_tpu_torch.data.batch import SceneBatch
from geopurify_tpu_torch.models.lang import (
    LanguageEncoder,
    build_tokenizer,
    embed_class_names,
    init_language_,
)
from geopurify_tpu_torch.models.pipeline import GeoPurifyPipeline, build_sonata
from geopurify_tpu_torch.models.student import init_student_
from geopurify_tpu_torch.run.optim import StudentOptimizer, make_optimizer
from geopurify_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint_with_retry as save_checkpoint,
)
from geopurify_tpu_torch.utils.profiling import StageTimer

log = logging.getLogger("geopurify.train")


# geopurify_tpu/run/train.py:50
@dataclass
class TrainState:
    """The student (parameters + running statistics, updated in place), its
    optimizer, the step count and the anchor generator."""

    student: torch.nn.Module
    optimizer: StudentOptimizer
    step: int
    generator: torch.Generator

    def state_dict(self) -> dict:
        params = dict(self.student.named_parameters())
        return {
            "params": {k: v.detach().cpu() for k, v in params.items()},
            "batch_stats": {k: v.cpu() for k, v in self.student.named_buffers()},
            "opt_state": self.optimizer.state_dict(),
            "step": self.step,
            "rng": self.generator.get_state(),
        }

    def load_state_dict(self, sd: dict) -> None:
        self.student.load_state_dict({**sd["params"], **sd["batch_stats"]})
        self.optimizer.load_state_dict(sd["opt_state"])
        self.step = int(sd["step"])
        self.generator.set_state(sd["rng"])


# geopurify_tpu/run/train.py:57-107
def make_train_step(pipeline: GeoPurifyPipeline):
    """One Stage-1 step on one device: value and gradient of
    ``stage1_loss`` (train-mode BatchNorm), then the optimizer. Returns
    ``step(state, scene, f2d, f_teacher) -> loss`` (a detached scalar)."""

    def step(state: TrainState, scene: SceneBatch, f2d, f_teacher):
        state.optimizer.zero_grad()
        loss, _ = pipeline.stage1_loss(state.generator, scene, f2d, f_teacher, train=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    return step


# geopurify_tpu/run/train.py:110
def stack_scenes(scenes) -> SceneBatch:
    """Stack SceneBatches along a new leading axis."""
    return SceneBatch(**{f.name: torch.stack([getattr(s, f.name) for s in scenes])
                         for f in dataclasses.fields(SceneBatch)})


def _zero_(module: torch.nn.Module) -> None:
    with torch.no_grad():
        for p in module.parameters():
            p.zero_()


# geopurify_tpu/run/train.py:119
def build_pipeline(cfg: GeoPurifyConfig, generator: torch.Generator, device="cuda",
                   require_teachers: bool = False, with_sonata: bool = True):
    """The pipeline with frozen teachers and class-name text embeddings.

    The language tower is initialised from ``generator`` (a CPU generator)
    and embeds the class prompts. Without released checkpoints the
    X-Decoder and Sonata teachers are zero stand-ins, as in the JAX trainer
    when ``xdecoder.ckpt`` / ``sonata.ckpt`` are unset: fine for smoke runs,
    meaningless on real data, so ``require_teachers`` (the real-data entry
    points) logs the JAX package's warnings. Converting the released
    checkpoints is not ported yet. ``with_sonata=False`` leaves the Sonata
    teacher out (Stage 2 never runs it)."""
    if cfg.xdecoder.ckpt or cfg.sonata.ckpt:
        raise NotImplementedError(
            "converting the released X-Decoder / Sonata checkpoints is not ported "
            "yet (ROADMAP Queue 1); unset xdecoder.ckpt and sonata.ckpt")
    if cfg.xdecoder.lift_backend != "xdecoder":
        raise NotImplementedError("only the xdecoder lift backend is ported")
    if require_teachers:
        log.warning(
            "REAL-DATA RUN WITH UNINITIALIZED 2D TEACHER: xdecoder.ckpt is not "
            "set, so the frozen X-Decoder teacher is all zeros and every lifted "
            "feature (and any mIoU built on it) is meaningless. Set "
            "xdecoder.ckpt=/path/to/xdecoder_focall_last.pt.")
        if with_sonata:
            log.warning(
                "REAL-DATA RUN WITH UNINITIALIZED 3D TEACHER: sonata.ckpt is "
                "not set — Stage-1 distillation targets are random. Set "
                "sonata.ckpt=/path/to/sonata.pth (facebook/sonata release).")
    dev = resolve_device(device)
    t = cfg.text
    tk = build_tokenizer(t.tokenizer_vocab, t.context_length, t.vocab_size)
    lang = LanguageEncoder(t.vocab_size, t.width, t.layers, t.heads,
                           t.context_length, t.dim_proj)
    init_language_(lang, generator)
    lang.to(dev).eval()
    text = embed_class_names(lang, tk, list(cfg.data.all_label),
                             use_templates=t.prompt_eng, template=t.prompt_template,
                             device=dev)
    logit_scale = float(lang.scale().detach())
    sonata_state = None
    if with_sonata:
        sonata = build_sonata(cfg.sonata)
        _zero_(sonata)
        sonata_state = sonata.state_dict()
    pipeline = GeoPurifyPipeline(cfg, text, logit_scale, device=dev,
                                 sonata_state=sonata_state)
    _zero_(pipeline.xdecoder)
    return pipeline


def _dp(cfg: GeoPurifyConfig) -> int:
    dp = cfg.parallel.dp
    if dp not in (-1, 1):
        raise NotImplementedError(
            f"parallel.dp={dp}: data parallelism with SyncBN over torch.distributed "
            "is not ported yet (ROADMAP Queue 1); the port trains "
            "on one device")
    return 1


# geopurify_tpu/run/train.py:257
def main(argv=None) -> Optional[TrainState]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", default="scannet")
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--distributed", action="store_true")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--teacher-cache", default=None)
    parser.add_argument("--fused-features", default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--steps-per-epoch", type=int, default=None)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s %(filename)s:%(lineno)d] %(message)s")
    for flag, item in ((args.distributed, "--distributed (DP / SyncBN over torch.distributed)"),
                       (args.teacher_cache, "--teacher-cache (data layer, run/precompute.py)"),
                       (args.fused_features, "--fused-features (data layer)")):
        if flag:
            raise NotImplementedError(f"{item} is not ported yet (ROADMAP Queue 1)")
    if not args.synthetic:
        raise NotImplementedError(
            "real datasets (data/loaders.SceneDataset in the trainer) are not wired in "
            "yet (ROADMAP Queue 1); "
            "pass --synthetic")
    cfg = load_config(args.preset, overrides=args.overrides, yaml_path=args.config)
    if args.epochs:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, epochs=args.epochs))
    n_dp = _dp(cfg)
    dev = resolve_device(args.device)

    init_gen = torch.Generator().manual_seed(cfg.train.manual_seed)
    pipeline = build_pipeline(cfg, init_gen, dev)
    from geopurify_tpu_torch.data.synthetic import make_scene_batch

    scenes = [make_scene_batch(seed=i, n_points=1500, n_views=2, device=dev)
              for i in range(max(2, n_dp))]
    init_student_(pipeline.student, init_gen)
    steps_per_epoch = args.steps_per_epoch or len(scenes) * cfg.data.loop // n_dp
    optimizer, schedule = make_optimizer(cfg.train, pipeline.student, steps_per_epoch)
    generator = torch.Generator(device=dev).manual_seed(cfg.train.manual_seed)
    state = TrainState(pipeline.student, optimizer, 0, generator)

    ckpt_dir = os.path.join(cfg.train.save_path, "ckpt")
    if cfg.train.resume:
        restored, step = restore_checkpoint(cfg.train.resume)
        if restored is not None:
            state.load_state_dict(restored)
            log.info("resumed from step %d", step)

    train_step = make_train_step(pipeline)
    metrics_path = os.path.join(cfg.train.save_path, "metrics.jsonl")
    os.makedirs(cfg.train.save_path, exist_ok=True)
    timer = StageTimer()
    t0 = time.time()
    for epoch in range(cfg.train.epochs):
        for it in range(steps_per_epoch):
            batch = scenes[it % len(scenes)]
            with timer.stage("lift_2d", block_on=dev), torch.inference_mode():
                f2d, _ = pipeline.lift_scene(batch)
            with timer.stage("teacher_3d", block_on=dev):
                ft = pipeline.teacher_point_features(batch)
            with timer.stage("train_step", block_on=dev):
                loss = train_step(state, batch, f2d, ft)
            if state.step % cfg.train.print_freq == 0:
                # accumulation ticks the schedule once per k raw steps
                lr = schedule(state.step // max(cfg.train.grad_accum_steps, 1))
                rec = {"step": state.step, "epoch": epoch, "loss": float(loss),
                       "lr": lr, "elapsed_s": time.time() - t0,
                       "scenes_per_sec": state.step * n_dp / max(time.time() - t0, 1e-9),
                       "stages": timer.summary()}
                log.info("%s", rec)
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        if (epoch + 1) % cfg.train.save_freq == 0:
            save_checkpoint(ckpt_dir, state.state_dict(), state.step)
            log.info("checkpointed at step %d", state.step)
    save_checkpoint(ckpt_dir, state.state_dict(), state.step)
    log.info("done: %d steps in %.1fs", state.step, time.time() - t0)
    return state


if __name__ == "__main__":
    main()
