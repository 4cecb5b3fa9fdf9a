"""Stage-2 validation entry — open-vocabulary segmentation eval.

Port of geopurify_tpu/run/validate.py: every scene of the (sharded)
evaluation list goes through the data layer
(``data/loaders.SceneDataset``) and ``GeoPurifyPipeline.evaluate_scene`` at
the preset's static buckets; per-class histograms accumulate into a
``SegMeter`` (Base / Novel / All, and the foreground group); the result
prints as one JSON line and is appended to
``<train.save_path>/eval_results.jsonl``, both with the JAX entry point's
keys. The run is on the card unless ``--device cpu`` is given.

``xdecoder.ckpt`` names the released X-Decoder (converted on load with its
text tower; ``text.tokenizer_vocab`` names CLIP's BPE merges file); without
it the X-Decoder teacher is a zero stand-in (a warning says so on real
data). The student is initialised from a seeded generator;
``--student-ckpt`` takes a released MinkowskiEngine
checkpoint (``.pth``), a checkpoint file of the port's trainer
(``step_<n>.pt``) or its checkpoint directory (the newest step).
``--lift-backend lseg|ape`` lifts through a backend registered in
``models/lift_backends.py``.

``--distributed`` joins the process group the launcher set up (one rank a
card over NCCL, gloo with ``--device cpu``): rank r of n evaluates every
n-th scene of its ``--shard-idx/--shard-total`` slice, the histograms are
summed over the ranks before the summary, and rank 0 alone prints it and
appends the log.

Usage:
  python -m geopurify_tpu_torch.run.validate --preset scannet [overrides]
  torchrun --nproc_per_node=8 -m geopurify_tpu_torch.run.validate --distributed \
      --preset scannet [overrides]
  python -m geopurify_tpu_torch.run.validate --synthetic --device cpu --preset tiny
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from geopurify_tpu_torch import resolve_device
from geopurify_tpu_torch.config import GeoPurifyConfig, load_config
from geopurify_tpu_torch.parallel.mesh import init_distributed, world
from geopurify_tpu_torch.utils.metrics import (
    SegMeter,
    allreduce_meter_across_hosts,
    intersection_and_union,
)

log = logging.getLogger("geopurify.validate")


# geopurify_tpu/run/validate.py:36
def shard_scene_list(scene_ids: List[str], shard_idx: int, shard_total: int) -> List[str]:
    """Contiguous slice sharding."""
    n = len(scene_ids)
    per = -(-n // shard_total)
    return scene_ids[shard_idx * per: (shard_idx + 1) * per]


# geopurify_tpu/run/validate.py:43
def evaluate_scenes(pipeline, scene_iter, cfg: GeoPurifyConfig, log_every: int = 1,
                    save_preds: Optional[str] = None):
    """Evaluate every scene of ``scene_iter`` (``SceneBatch`` es on the
    pipeline's device); returns (meter, seconds per scene). The JAX
    version's ``student_vars`` live in the pipeline here."""
    meter = SegMeter(
        num_classes=cfg.data.test_classes,
        base_category=cfg.data.base_category,
        novel_category=cfg.data.novel_category,
        foreground_category=cfg.data.foreground_category(),
    )
    times = []
    for i, batch in enumerate(scene_iter):
        t0 = time.time()
        out = pipeline.evaluate_scene(batch)
        hists = intersection_and_union(
            out["pred"], batch.labels, batch.point_valid,
            cfg.data.test_classes, tuple(cfg.data.test_ignore_label),
        )
        hists = [h.cpu().numpy() for h in hists]       # waits for the device
        times.append(time.time() - t0)
        meter.update(*hists)
        overflow = int(out.get("band_overflow", 0))
        if overflow:
            log.warning(
                "scene %d: banded pooling residual overflowed by %d edges — "
                "exact gather fallback ran (consider raising pooling.band)",
                i, overflow,
            )
        if save_preds:
            from geopurify_tpu_torch.utils.visualization import save_semantic_ply

            valid = batch.point_valid.cpu().numpy()
            pts = batch.points.cpu().numpy()
            save_semantic_ply(
                os.path.join(save_preds, f"scene{i:04d}_pred.ply"),
                pts, out["pred"].cpu().numpy(),
                num_classes=cfg.data.test_classes, valid=valid,
            )
            gt = batch.labels.cpu().numpy()
            ignore = (gt >= cfg.data.test_classes) | np.isin(
                gt, np.asarray(cfg.data.test_ignore_label, dtype=gt.dtype)
            )
            save_semantic_ply(
                os.path.join(save_preds, f"scene{i:04d}_gt.ply"),
                pts, np.where(ignore, -1, gt),   # ignore regions render black
                num_classes=cfg.data.test_classes, valid=valid,
            )
        if (i + 1) % log_every == 0:
            full = meter.summary()
            s = full["all"]
            fg = full.get("foreground")
            log.info(
                "scene %d: mIoU=%.4f mAcc=%.4f allAcc=%.4f%s (%.2fs/scene)",
                i + 1, s["mIoU"], s["mAcc"], s["allAcc"],
                f" f-mIoU={fg['mIoU']:.4f} f-mAcc={fg['mAcc']:.4f}" if fg else "",
                np.mean(times),
            )
    return meter, times


def load_student_state(path: str) -> Optional[Dict[str, torch.Tensor]]:
    """The student's state dict from ``--student-ckpt``: a checkpoint
    directory of the port's trainer (its newest step; None when it holds
    none), one of its ``step_<n>.pt`` files, or a released MinkowskiEngine
    checkpoint (converted with the JAX package's tap order). Files are
    unpickled in full: load only files you trust."""
    from geopurify_tpu_torch.utils.checkpoint import (
        convert_student_checkpoint,
        load_torch_state_dict,
        restore_checkpoint,
    )

    if os.path.isdir(path):
        state, _ = restore_checkpoint(path)
    else:
        state = torch.load(path, map_location="cpu", weights_only=False)
        if not (isinstance(state, dict) and {"params", "batch_stats"} <= state.keys()):
            return convert_student_checkpoint(load_torch_state_dict(path))
    if state is None:
        return None
    return {**state["params"], **state["batch_stats"]}


# geopurify_tpu/run/validate.py:101
def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", default="scannet")
    parser.add_argument("--config", default=None)
    parser.add_argument("--student-ckpt", default=None)
    parser.add_argument("--shard-idx", type=int, default=0)
    parser.add_argument("--shard-total", type=int, default=1)
    parser.add_argument("--distributed", action="store_true",
                        help="multi-process: join the launcher's process group")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--max-scenes", type=int, default=None)
    parser.add_argument("--save-preds", default=None,
                        help="dir for per-scene pred/gt PLY dumps")
    parser.add_argument("--lift-backend", default=None,
                        choices=["xdecoder", "lseg", "ape"],
                        help="2D lift backend; lseg / ape need a registered "
                             "callable (models/lift_backends.py)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s %(filename)s:%(lineno)d] %(message)s")
    owns_group = args.distributed and not torch.distributed.is_initialized()
    dev = init_distributed(args.device) if args.distributed else resolve_device(args.device)
    rank, n_proc = world()
    if args.distributed:
        log.info("distributed: rank %d of %d on %s", rank, n_proc, dev)
    cfg = load_config(args.preset, overrides=args.overrides, yaml_path=args.config)
    if args.lift_backend:
        cfg = dataclasses.replace(
            cfg, xdecoder=dataclasses.replace(cfg.xdecoder, lift_backend=args.lift_backend))

    from geopurify_tpu_torch.models.student import init_student_
    from geopurify_tpu_torch.run.train import build_pipeline

    pipeline = build_pipeline(cfg, torch.Generator().manual_seed(cfg.train.manual_seed),
                              dev, require_teachers=not args.synthetic, with_sonata=False)
    init_student_(pipeline.student, torch.Generator().manual_seed(cfg.train.manual_seed))
    if args.student_ckpt:
        state = load_student_state(args.student_ckpt)
        if state is None:
            log.warning("no checkpoint under %s: the student keeps its seeded init",
                        args.student_ckpt)
        else:
            pipeline.student.load_state_dict(state)

    if args.synthetic:
        from geopurify_tpu_torch.data.synthetic import make_scene_batch

        n = args.max_scenes or 2
        scene_iter = (make_scene_batch(seed=i, n_points=1500, n_views=2, device=dev)
                      for i in range(n))
    else:
        from geopurify_tpu_torch.data.loaders import SceneDataset

        ds = SceneDataset(cfg, split="val", device=dev)
        ids = shard_scene_list(ds.scene_ids, args.shard_idx, args.shard_total)
        ids = ids[rank::n_proc]                 # further shard over processes
        if args.max_scenes:
            ids = ids[: args.max_scenes]
        scene_iter = (
            b for b in (ds.make_scene_batch(sid) for sid in ids) if b is not None
        )

    if args.save_preds:
        os.makedirs(args.save_preds, exist_ok=True)
    meter, times = evaluate_scenes(pipeline, scene_iter, cfg, save_preds=args.save_preds)
    meter = allreduce_meter_across_hosts(meter)
    result = {
        "summary": meter.summary(),
        "scenes_per_sec": 1.0 / float(np.mean(times)) if times else 0.0,
        "per_class_iou": meter.per_class_iou().tolist(),
    }
    if owns_group:
        torch.distributed.destroy_process_group()
    if rank != 0:
        return result
    print(json.dumps(result))
    # append-mode result log, anchored under cfg.train.save_path so shards
    # launched from different working directories land in one run directory
    os.makedirs(cfg.train.save_path, exist_ok=True)
    with open(os.path.join(cfg.train.save_path, "eval_results.jsonl"), "a") as f:
        f.write(json.dumps({"preset": args.preset, "shard": [args.shard_idx,
                args.shard_total], **result}) + "\n")
    return result


if __name__ == "__main__":
    main()
