"""Offline teacher-feature precompute.

Port of geopurify_tpu/run/precompute.py: the frozen teachers' outputs (the
X-Decoder lift and the Sonata features) are computed once per scene, with
augmentation off, and cached as ``<out>/<scene id>.npz``, which
``run.train --teacher-cache`` reads instead of running the teachers every
step. The file holds ``f2d`` [P, feature_dim] f32, ``f_teacher`` [P, C] f32
(unless ``--no-sonata``) and ``point_valid`` [P] bool, as the JAX package
writes it, so a cache written by either package trains the other. The run
is on the card unless ``--device cpu`` is given.

Usage:
  python -m geopurify_tpu_torch.run.precompute --preset scannet \
      data.data_root=... data.data_root_2d=... xdecoder.ckpt=... sonata.ckpt=... \
      --out runs/teacher_cache
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Dict

import numpy as np
import torch

from geopurify_tpu_torch import resolve_device
from geopurify_tpu_torch.config import load_config
from geopurify_tpu_torch.data.batch import SceneBatch

log = logging.getLogger("geopurify.precompute")


# geopurify_tpu/run/precompute.py:27
def precompute_scene(pipeline, batch: SceneBatch, sonata_live: bool = True
                     ) -> Dict[str, np.ndarray]:
    """The cache entry of one scene: ``f2d``, ``f_teacher`` (when
    ``sonata_live`` and the pipeline has a teacher) and ``point_valid``."""
    with torch.inference_mode():
        f2d, _ = pipeline.lift_scene(batch)
    out = {"f2d": f2d.to(torch.float32).cpu().numpy()}
    if sonata_live and pipeline.sonata is not None:
        ft = pipeline.teacher_point_features(batch)
        out["f_teacher"] = ft.to(torch.float32).cpu().numpy()
    out["point_valid"] = batch.point_valid.cpu().numpy()
    return out


# geopurify_tpu/run/precompute.py:39
def main(argv=None) -> Dict[str, float]:
    """Writes the cache; returns the seconds each written scene took."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", default="scannet")
    parser.add_argument("--config", default=None)
    parser.add_argument("--out", default="runs/teacher_cache")
    parser.add_argument("--split", default="train")
    parser.add_argument("--max-scenes", type=int, default=None)
    parser.add_argument("--no-sonata", action="store_true")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s %(filename)s:%(lineno)d] %(message)s")

    from geopurify_tpu_torch.data.loaders import SceneDataset
    from geopurify_tpu_torch.run.train import build_pipeline

    cfg = load_config(args.preset, overrides=args.overrides, yaml_path=args.config)
    dev = resolve_device(args.device)
    pipeline = build_pipeline(cfg, torch.Generator().manual_seed(cfg.train.manual_seed), dev,
                              require_teachers=True, with_sonata=not args.no_sonata)
    # augmentation off: the cached features belong to the unaugmented geometry
    ds = SceneDataset(cfg, split=args.split, augment=False, device=dev)
    os.makedirs(args.out, exist_ok=True)
    ids = ds.scene_ids[: args.max_scenes] if args.max_scenes else ds.scene_ids
    seconds: Dict[str, float] = {}
    for i, sid in enumerate(ids):
        dst = os.path.join(args.out, f"{sid}.npz")
        if os.path.exists(dst):
            log.info("[%d/%d] %s cached, skipping", i + 1, len(ids), sid)
            continue
        batch = ds.make_scene_batch(sid)
        if batch is None:
            log.warning("[%d/%d] %s unusable, skipping", i + 1, len(ids), sid)
            continue
        t0 = time.time()
        out = precompute_scene(pipeline, batch, sonata_live=not args.no_sonata)
        np.savez_compressed(dst, **out)
        seconds[sid] = time.time() - t0
        log.info("[%d/%d] %s -> %s (%.1fs)", i + 1, len(ids), sid, dst, seconds[sid])
    return seconds


if __name__ == "__main__":
    main()
