"""Multi-process dry run of the parallel layer.

Counterpart of ``__graft_entry__.dryrun_multichip`` (__graft_entry__.py:114):
spawns ``--nproc`` ranks of one process group (gloo on the CPU; on cards
NCCL when every rank has its own card, else gloo, since NCCL refuses two
ranks on one card), and in each runs, at the preset's widths:

1. one data-parallel Stage-1 step with SyncBN (``run.train.make_train_step``
   over the mesh, one scene per rank), after which every replica must hold
   bit-equal parameters and running statistics;
2. a view-parallel lift of one scene (``parallel.view_parallel``), held
   against the sequential ``lift_scene``: the same view counts, features
   within 2e-3 (when the world is a power of two);
3. a sharded Stage-2 evaluation: one scene per rank through
   ``evaluate_scene``, the histograms summed over the ranks into mIoU.

Rank 0's summary prints as one line. Weights and scenes are random, drawn
from seeds.

Usage:
  python -m geopurify_tpu_torch.run.dryrun --nproc 2 --device cpu
  python -m geopurify_tpu_torch.run.dryrun --nproc 8 --device cuda --preset scannet
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from geopurify_tpu_torch.config import GeoPurifyConfig, load_config
from geopurify_tpu_torch.data.batch import SceneBatch
from geopurify_tpu_torch.models.pipeline import GeoPurifyPipeline
from geopurify_tpu_torch.models.student import init_student_
from geopurify_tpu_torch.parallel.mesh import Mesh, make_mesh, replicas_equal, spawn
from geopurify_tpu_torch.parallel.view_parallel import sharded_lift_scene
from geopurify_tpu_torch.run.optim import make_optimizer
from geopurify_tpu_torch.run.train import TrainState, make_train_step
from geopurify_tpu_torch.utils.metrics import (
    SegMeter,
    intersection_and_union,
    psum_histograms,
)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seeded_pipeline(cfg: GeoPurifyConfig, device, seed: int) -> GeoPurifyPipeline:
    """The pipeline with unit text embeddings and X-Decoder and student
    weights drawn from ``seed`` (zero biases, norm scales 1 + N(0, 0.1^2),
    N(0, 0.35^2) elsewhere: at small widths several queries win and the
    points spread over several classes), the same on every rank."""
    g = torch.Generator().manual_seed(seed)
    text = torch.randn((len(cfg.data.all_label) + 1, cfg.xdecoder.hidden_dim), generator=g)
    pipe = GeoPurifyPipeline(cfg, text / text.norm(dim=-1, keepdim=True), 20.0,
                             device=device)
    with torch.no_grad():
        for mod in (pipe.xdecoder, pipe.student):
            for name, p in mod.named_parameters():
                r = torch.randn(p.shape, generator=g)
                if name.endswith("bias"):
                    p.zero_()
                elif "norm" in name and name.endswith("weight"):
                    p.copy_(1 + 0.1 * r)
                else:
                    p.copy_(0.35 * r)
    return pipe


def stage1_dp(pipe: GeoPurifyPipeline, mesh: Mesh, scene: SceneBatch, f2d, f_teacher,
              steps: int = 1, seed: int = 0, pairs=None) -> Dict[str, object]:
    """``steps`` data-parallel Stage-1 steps on this rank's scene from a
    student initialised alike on every rank (anchors drawn per step and
    rank, or ``pairs``); after each, whether the replicas' parameters and
    running statistics are bit-equal. Returns the losses, the seconds of
    each step (host clock, the device synchronised) and the equality of
    each step; the student keeps the last step's averaged gradients."""
    dev = scene.points.device
    init_student_(pipe.student, torch.Generator().manual_seed(seed))
    optimizer, _ = make_optimizer(pipe.cfg.train, pipe.student, steps_per_epoch=max(steps, 1))
    state = TrainState(pipe.student, optimizer, 0,
                       torch.Generator(device=dev).manual_seed(seed))
    step = make_train_step(pipe, mesh)
    tensors = list(pipe.student.parameters()) + list(pipe.student.buffers())
    losses, seconds, equal = [], [], []
    for _ in range(steps):
        _sync(dev)
        t = time.perf_counter()
        loss = step(state, scene, f2d, f_teacher, pairs)
        _sync(dev)
        seconds.append(time.perf_counter() - t)
        losses.append(loss.item())
        equal.append(replicas_equal(tensors, mesh.group))
    return dict(losses=losses, step_seconds=seconds, replicas_equal=equal)


def view_parallel_lift(pipe: GeoPurifyPipeline, batch: SceneBatch, group=None
                       ) -> Dict[str, object]:
    """The view-parallel lift of ``batch`` against the sequential
    ``lift_scene`` on this rank: whether the view counts are equal, the
    largest feature difference, the points that differ by more than 2e-3,
    and both times."""
    dev = batch.points.device
    _sync(dev)
    t = time.perf_counter()
    fused, count = sharded_lift_scene(pipe, batch, group)
    _sync(dev)
    sharded_s = time.perf_counter() - t
    with torch.inference_mode():
        ref, ref_count = pipe.lift_scene(batch)
    _sync(dev)
    sequential_s = time.perf_counter() - t - sharded_s
    diff = (fused - ref).abs().amax(dim=1)
    return dict(counts_equal=torch.equal(count, ref_count),
                max_abs_diff=diff.max().item(), n_beyond=int((diff > 2e-3).sum()),
                seen=int((count > 0).sum()), finite=bool(torch.isfinite(fused).all()),
                sharded_s=sharded_s, sequential_s=sequential_s)


def sharded_eval(pipe: GeoPurifyPipeline, scenes: List[SceneBatch], mesh: Mesh
                 ) -> Dict[str, object]:
    """Rank r evaluates ``scenes[r::dp]``; the (I, U, T) histograms are summed
    over the ranks into one meter (the same summary on every rank)."""
    cfg = pipe.cfg
    C = cfg.data.test_classes
    dev = scenes[0].points.device
    hists = [torch.zeros(C, device=dev) for _ in range(3)]
    for batch in scenes[mesh.rank::mesh.dp]:
        out = pipe.evaluate_scene(batch)
        for h, x in zip(hists, intersection_and_union(
                out["pred"], batch.labels, batch.point_valid, C,
                tuple(cfg.data.test_ignore_label))):
            h += x
    if mesh.group is not None:
        hists = psum_histograms(hists, mesh.group)
    meter = SegMeter(num_classes=C)
    meter.update(*(h.cpu().numpy() for h in hists))
    return dict(summary=meter.summary(), target=meter.target.tolist())


def _scene(cfg: GeoPurifyConfig, seed: int, n_views: int, device) -> SceneBatch:
    from geopurify_tpu_torch.data.synthetic import make_scene_batch

    d = cfg.data
    return make_scene_batch(seed=seed, n_points=int(0.8 * d.max_points), n_views=n_views,
                            image_hw=tuple(cfg.xdecoder.mask_shape),
                            voxel_size=d.voxel_size, max_points=d.max_points,
                            max_voxels=d.max_voxels, max_views=n_views,
                            max_view_points=d.max_view_points, device=device)


def dryrun_rank(device: torch.device, preset: str, overrides: List[str]) -> Dict[str, object]:
    """One rank's dry run (the module docstring's three parts)."""
    cfg = load_config(preset, overrides=overrides)
    mesh = make_mesh(cfg.parallel.dp, cfg.parallel.tp)
    pipe = seeded_pipeline(cfg, device, seed=0)
    scene = _scene(cfg, mesh.rank, 1, device)
    rng = np.random.default_rng(mesh.rank)
    P = scene.points.shape[0]
    f2d = torch.from_numpy(rng.normal(size=(P, cfg.pooling.feature_dim)).astype(np.float32))
    ft = torch.from_numpy(rng.normal(size=(P, 16)).astype(np.float32))
    out = dict(stage1=stage1_dp(pipe, mesh, scene, f2d.to(device), ft.to(device)))
    pipe = seeded_pipeline(cfg, device, seed=0)         # the student as seeded again
    if mesh.dp & (mesh.dp - 1) == 0:
        out["view_parallel"] = view_parallel_lift(
            pipe, _scene(cfg, 99, 2 * mesh.dp, device), mesh.group)
    scenes = [_scene(cfg, 100 + r, 1, device) for r in range(mesh.dp)]
    out["eval"] = sharded_eval(pipe, scenes, mesh)
    return out


def check(out: Dict[str, object], nproc: int) -> str:
    """Rank 0's summary line; raises where a part failed."""
    s1 = out["stage1"]
    if not (all(s1["replicas_equal"]) and np.isfinite(s1["losses"]).all()):
        raise RuntimeError(f"data-parallel step: {s1}")
    line = f"dryrun({nproc}) OK: loss={s1['losses'][-1]:.4f}  replicas bit-equal"
    vp = out.get("view_parallel")
    if vp is None:
        line += "  (view-parallel lift skipped: not a power-of-two world)"
    elif not (vp["counts_equal"] and vp["finite"] and vp["max_abs_diff"] <= 2e-3):
        raise RuntimeError(f"view-parallel lift against the sequential one: {vp}")
    else:
        line += (f"  view-parallel lift OK: max |diff| {vp['max_abs_diff']:.2e} over "
                 f"{vp['seen']} seen points")
    miou = out["eval"]["summary"]["all"]["mIoU"]
    if not np.isfinite(miou):
        raise RuntimeError(f"sharded evaluation: {out['eval']}")
    return line + f"  stage2 sharded eval OK: mIoU={miou:.4f} over {nproc} scenes"


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--nproc", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--preset", default="tiny")
    parser.add_argument("--timeout", type=float, default=600.0,
                        help="seconds before the ranks are killed")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    backend: Optional[str] = None
    if torch.device(args.device).type == "cuda" and args.nproc > torch.cuda.device_count():
        backend = "gloo"
    outs = spawn(dryrun_rank, args.nproc, args.device, backend,
                 args=(args.preset, args.overrides), timeout_s=args.timeout)
    line = check(outs[0], args.nproc)
    print(line)
    return line


if __name__ == "__main__":
    main()
