"""Stage-1 training entry — geometric distillation of the student.

Port of geopurify_tpu/run/train.py: each step takes, on each rank, the
frozen inputs of one scene (the X-Decoder lift and the Sonata teacher's
features, computed live outside autograd or read from precomputed files),
then the value and gradient of ``stage1_loss`` and an AdamW step over three
LR tiers (``run/optim.py``). Checkpoints hold the student's parameters and
running statistics, the optimizer state, the step and the anchor
generator's state (``utils/checkpoint.py``); ``train.resume`` continues
from them.

Data: ``--synthetic`` rooms, or the on-disk train split
(``data/loaders.SceneDataset``) with, optionally, a teacher cache written
by ``run/precompute.py`` (``--teacher-cache``) or fused 2D feature files
(``--fused-features``); augmentation is off in those two modes, whose
features belong to the unaugmented geometry. ``xdecoder.ckpt`` /
``sonata.ckpt`` name the released teachers (converted on load).

Data parallelism: ``--distributed`` joins the process group the launcher
set up (``torchrun``: NCCL between cards; gloo with ``--device cpu``), one
rank per device and one scene per rank a step. BatchNorm moments are summed
over the ranks (SyncBN, ``parallel.sync_batchnorm``); gradients, running
statistics and the loss are averaged before the optimizer, so the replicas
stay equal; each rank draws its anchors from a stream of its own. Rank 0
alone logs and checkpoints. ``parallel.dp`` must be -1 or the world size;
``parallel.tp`` > 1 raises.

Usage:
  torchrun --nproc_per_node=8 -m geopurify_tpu_torch.run.train --distributed \
      --preset scannet --teacher-cache runs/teacher_cache data.data_root=...
  python -m geopurify_tpu_torch.run.train --preset scannet data.data_root=... \
      xdecoder.ckpt=xdecoder_focall_last.pt sonata.ckpt=sonata.pth
  python -m geopurify_tpu_torch.run.train --teacher-cache runs/teacher_cache ...
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
from typing import Optional, Tuple

import numpy as np
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
from geopurify_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_,
    all_reduce_mean_,
    init_distributed,
    make_mesh,
    scene_index,
)
from geopurify_tpu_torch.run.optim import StudentOptimizer, make_optimizer
from geopurify_tpu_torch.utils.checkpoint import (
    load_torch_state_dict,
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
def make_train_step(pipeline: GeoPurifyPipeline, mesh: Optional[Mesh] = None):
    """One Stage-1 step: value and gradient of ``stage1_loss`` (train-mode
    BatchNorm), then the optimizer. Returns ``step(state, scene, f2d,
    f_teacher, pairs=None) -> loss`` (a detached scalar). The anchors come
    from a generator drawn for this step and rank from ``state.generator``
    (JAX's ``fold_in(rng, axis_index)``) unless ``pairs`` is given.

    Over a mesh with a process group, each rank's step is the JAX
    ``shard_map`` body: BatchNorm moments summed over the ranks when
    ``parallel.sync_batchnorm``, then the mean over the ranks of the
    gradients, the updated running statistics and the loss (one flat
    all-reduce) ahead of the optimizer."""
    group = mesh.group if mesh is not None else None
    rank = mesh.rank if mesh is not None else 0
    bn_group = group if pipeline.cfg.parallel.sync_batchnorm else None

    def step(state: TrainState, scene: SceneBatch, f2d, f_teacher, pairs=None):
        state.optimizer.zero_grad()
        gen = None if pairs is not None else rank_generator(state.generator, rank)
        loss, _ = pipeline.stage1_loss(gen, scene, f2d, f_teacher, train=True, pairs=pairs,
                                       group=bn_group)
        loss.backward()
        loss = loss.detach()
        if group is not None:
            student = pipeline.student
            all_reduce_mean_([p.grad for p in student.parameters()]
                             + list(student.buffers()) + [loss.reshape(1)], mesh.dp, group)
        state.optimizer.step()
        state.step += 1
        return loss

    return step


def rank_generator(shared: torch.Generator, rank: int) -> torch.Generator:
    """A generator of one step and rank: a seed drawn from ``shared`` (the
    same draw on every rank, which keeps ``shared`` in step across them),
    offset by ``rank``."""
    seed = int(torch.randint(0, 1 << 62, (1,), generator=shared,
                             device=shared.device).item())
    return torch.Generator(device=shared.device).manual_seed(seed + rank)


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

    With ``xdecoder.ckpt`` the X-Decoder and the language tower load from
    the converted released checkpoint (``utils/convert_xdecoder.py``) and
    the logit scale is the checkpoint's; with ``sonata.ckpt`` the teacher
    loads from ``utils/convert_sonata.py``. Loads are strict: a missing or
    extra parameter raises. Unset, the language tower is initialised from
    ``generator`` (a CPU generator) and the teachers are zero stand-ins, as
    in the JAX trainer: fine for smoke runs, meaningless on real data, so
    ``require_teachers`` (the real-data entry points) logs the JAX
    package's warnings. ``with_sonata=False`` leaves the Sonata teacher out
    (Stage 2 never runs it). With ``xdecoder.lift_backend`` lseg / ape the
    backend's callable comes from ``models/lift_backends.py``."""
    dev = resolve_device(device)
    t, x = cfg.text, cfg.xdecoder
    tk = build_tokenizer(t.tokenizer_vocab, t.context_length, t.vocab_size)
    lang = LanguageEncoder(t.vocab_size, t.width, t.layers, t.heads,
                           t.context_length, t.dim_proj)
    conv = None
    if x.ckpt:
        from geopurify_tpu_torch.utils.convert_xdecoder import convert_xdecoder_checkpoint

        log.info("converting X-Decoder teacher checkpoint %s", x.ckpt)
        conv = convert_xdecoder_checkpoint(
            load_torch_state_dict(x.ckpt), depths=tuple(x.backbone.depths),
            enc_layers=x.enc_layers, dec_layers=x.dec_layers)
        lang.load_state_dict(conv["lang"])
    else:
        if require_teachers:
            log.warning(
                "REAL-DATA RUN WITH UNINITIALIZED 2D TEACHER: xdecoder.ckpt is not "
                "set, so the frozen X-Decoder teacher is all zeros and every lifted "
                "feature (and any mIoU built on it) is meaningless. Set "
                "xdecoder.ckpt=/path/to/xdecoder_focall_last.pt.")
        init_language_(lang, generator)
    lang.to(dev).eval()
    text = embed_class_names(lang, tk, list(cfg.data.all_label),
                             use_templates=t.prompt_eng, template=t.prompt_template,
                             device=dev)
    # each route as JAX takes it: the converter's numpy exp of the
    # checkpoint's parameter, else the correctly rounded exp of the f32
    # parameter that jnp.exp gives (numpy's can be an ulp off)
    logit_scale = (conv["logit_scale"] if conv
                   else float(torch.exp(lang.logit_scale.detach().float().cpu())))
    sonata_state = None
    if with_sonata:
        sc = cfg.sonata
        if sc.ckpt:
            from geopurify_tpu_torch.utils.convert_sonata import convert_sonata_checkpoint

            log.info("converting Sonata teacher checkpoint %s", sc.ckpt)
            sonata_state = convert_sonata_checkpoint(load_torch_state_dict(sc.ckpt), sc)
        else:
            if require_teachers:
                log.warning(
                    "REAL-DATA RUN WITH UNINITIALIZED 3D TEACHER: sonata.ckpt is "
                    "not set — Stage-1 distillation targets are random. Set "
                    "sonata.ckpt=/path/to/sonata.pth (facebook/sonata release), "
                    "or train from a teacher cache (run/precompute.py) built with "
                    "a converted teacher.")
            sonata = build_sonata(sc)
            _zero_(sonata)
            sonata_state = sonata.state_dict()
    lift_backend_fn = None
    if x.lift_backend != "xdecoder":
        from geopurify_tpu_torch.models.lift_backends import get_backend

        lift_backend_fn = get_backend(x.lift_backend)
    pipeline = GeoPurifyPipeline(cfg, text, logit_scale, device=dev,
                                 teacher_state=conv["xdecoder"] if conv else None,
                                 sonata_state=sonata_state,
                                 lift_backend_fn=lift_backend_fn)
    if conv is None:
        _zero_(pipeline.xdecoder)
    return pipeline


# geopurify_tpu/run/train.py:377-407
class StepInputs:
    """This rank's inputs of each step, ``(sid, scene, f2d, f_teacher)``, or
    None when its scene is unusable (the step is skipped, as in JAX). The
    scene comes from ``scenes`` (synthetic; rank r of ``mesh`` takes scene
    ``it * dp + r``), from ``fused_ds`` (fused 2D features read with it) or,
    with a ``teacher_cache``, from ``ds`` by id; otherwise from ``ds``'s
    prefetching stream, whose scenes carry no id. Over several ranks every
    rank draws the same ``dp`` ids from ``ds`` and loads the one of its rank
    (the live mode too, without the prefetch).
    ``f2d`` and ``f_teacher`` come from ``<teacher_cache>/<sid>.npz`` where
    it exists; what is still missing is computed live (the X-Decoder lift,
    the Sonata teacher), timed as ``lift_2d`` / ``teacher_3d``."""

    def __init__(self, pipeline: GeoPurifyPipeline, timer: StageTimer, scenes=None,
                 ds=None, fused_ds=None, teacher_cache: Optional[str] = None,
                 mesh: Mesh = Mesh(1, 0, None)):
        self.pipeline, self.timer, self.scenes = pipeline, timer, scenes
        self.ds, self.fused_ds, self.teacher_cache = ds, fused_ds, teacher_cache
        self.mesh = mesh

    def _scene(self, it: int) -> Optional[Tuple[Optional[str], SceneBatch, Optional[torch.Tensor]]]:
        if self.scenes is not None:
            return None, self.scenes[scene_index(it, self.mesh, len(self.scenes))], None
        frozen = self.teacher_cache or self.fused_ds is not None
        if self.mesh.dp == 1 and not frozen:
            return None, self.ds.next_scene(), None
        sid = [self.ds._next_sid() for _ in range(self.mesh.dp)][self.mesh.rank]
        if self.fused_ds is not None:
            pair = self.fused_ds.make_scene_batch_with_features(sid)
            if pair is None:
                return None
            return sid, pair[0], torch.from_numpy(pair[1]).to(self.ds.device)
        scene = self.ds.make_scene_batch(sid)
        return None if scene is None else (sid, scene, None)

    def __call__(self, it: int):
        got = self._scene(it)
        if got is None:
            return None
        sid, scene, f2d = got
        dev, ft = scene.points.device, None
        if self.teacher_cache and sid is not None:
            path = os.path.join(self.teacher_cache, f"{sid}.npz")
            if os.path.exists(path):
                with np.load(path) as data:
                    if f2d is None:
                        f2d = torch.from_numpy(data["f2d"]).to(dev)
                    ft = torch.from_numpy(data["f_teacher"]).to(dev)
        if f2d is None:
            with self.timer.stage("lift_2d", block_on=dev), torch.inference_mode():
                f2d, _ = self.pipeline.lift_scene(scene)
        if ft is None:
            with self.timer.stage("teacher_3d", block_on=dev):
                ft = self.pipeline.teacher_point_features(scene)
        return sid, scene, f2d, ft


# geopurify_tpu/run/train.py:257
def main(argv=None) -> Optional[TrainState]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", default="scannet")
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--distributed", action="store_true")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--teacher-cache", default=None,
                        help="dir of precomputed teacher features (run/precompute.py)")
    parser.add_argument("--fused-features", default=None,
                        help="dir of precomputed fused 2D feature .pt files (OpenScene "
                             "layout), the frozen 2D input in place of the lift")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--steps-per-epoch", type=int, default=None)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s %(filename)s:%(lineno)d] %(message)s")
    cfg = load_config(args.preset, overrides=args.overrides, yaml_path=args.config)
    if args.epochs:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, epochs=args.epochs))
    owns_group = args.distributed and not torch.distributed.is_initialized()
    dev = init_distributed(args.device) if args.distributed else resolve_device(args.device)
    mesh = make_mesh(cfg.parallel.dp, cfg.parallel.tp)
    n_dp, lead = mesh.dp, mesh.rank == 0
    if args.distributed:
        log.info("distributed: rank %d of %d on %s (%s)", mesh.rank, n_dp, dev,
                 torch.distributed.get_backend())

    init_gen = torch.Generator().manual_seed(cfg.train.manual_seed)
    pipeline = build_pipeline(cfg, init_gen, dev,
                              require_teachers=not args.synthetic and not args.teacher_cache)
    timer = StageTimer()
    if args.synthetic:
        from geopurify_tpu_torch.data.synthetic import make_scene_batch

        scenes = [make_scene_batch(seed=i, n_points=1500, n_views=2, device=dev)
                  for i in range(max(2, n_dp))]
        inputs = StepInputs(pipeline, timer, scenes=scenes, mesh=mesh)
        n_scenes = len(scenes)
    else:
        from geopurify_tpu_torch.data.loaders import SceneDataset

        frozen_inputs = bool(args.teacher_cache or args.fused_features)
        ds = SceneDataset(cfg, split="train", augment=False if frozen_inputs else None,
                          device=dev)
        fused_ds = None
        if args.fused_features:
            from geopurify_tpu_torch.data.feature_loader import FusedFeatureDataset

            fused_ds = FusedFeatureDataset(cfg, args.fused_features, device=dev)
            fused_ds.base = ds
        if n_dp > 1:
            ds.split_streams(mesh.rank)
        inputs = StepInputs(pipeline, timer, ds=ds, fused_ds=fused_ds,
                            teacher_cache=args.teacher_cache, mesh=mesh)
        n_scenes = len(ds)
    init_student_(pipeline.student, init_gen)
    steps_per_epoch = args.steps_per_epoch or n_scenes * cfg.data.loop // n_dp
    optimizer, schedule = make_optimizer(cfg.train, pipeline.student, steps_per_epoch)
    generator = torch.Generator(device=dev).manual_seed(cfg.train.manual_seed)
    state = TrainState(pipeline.student, optimizer, 0, generator)

    ckpt_dir = os.path.join(cfg.train.save_path, "ckpt")
    if cfg.train.resume:
        restored, step = restore_checkpoint(cfg.train.resume)
        if restored is not None:
            state.load_state_dict(restored)
            log.info("resumed from step %d", step)

    train_step = make_train_step(pipeline, mesh)
    metrics_path = os.path.join(cfg.train.save_path, "metrics.jsonl")
    os.makedirs(cfg.train.save_path, exist_ok=True)
    t0 = time.time()
    for epoch in range(cfg.train.epochs):
        for it in range(steps_per_epoch):
            step_in = inputs(it)
            if mesh.group is not None:
                # every rank enters the step's collectives, or none does
                ready = torch.tensor([float(step_in is not None)], device=dev)
                if all_reduce_(ready, torch.distributed.ReduceOp.MIN).item() == 0:
                    continue
            if step_in is None:
                continue            # an unusable scene: no step
            _, batch, f2d, ft = step_in
            with timer.stage("train_step", block_on=dev):
                loss = train_step(state, batch, f2d, ft)
            if lead and state.step % cfg.train.print_freq == 0:
                # accumulation ticks the schedule once per k raw steps
                lr = schedule(state.step // max(cfg.train.grad_accum_steps, 1))
                rec = {"step": state.step, "epoch": epoch, "loss": float(loss),
                       "lr": lr, "elapsed_s": time.time() - t0,
                       "scenes_per_sec": state.step * n_dp / max(time.time() - t0, 1e-9),
                       "stages": timer.summary()}
                log.info("%s", rec)
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        if lead and (epoch + 1) % cfg.train.save_freq == 0:
            save_checkpoint(ckpt_dir, state.state_dict(), state.step)
            log.info("checkpointed at step %d", state.step)
    if lead:
        save_checkpoint(ckpt_dir, state.state_dict(), state.step)
    log.info("done: %d steps in %.1fs", state.step, time.time() - t0)
    if owns_group:
        torch.distributed.destroy_process_group()
    return state


if __name__ == "__main__":
    main()
