"""Joint multi-dataset training loaders.

Port of geopurify_tpu/data/joint_loader.py: ``CaptionDataset`` (images/
and captions.json, either ``[{"file_name": ..., "captions": [...]}]`` or a
``{"file.jpg": ["caption", ...]}`` mapping) with its batches of square-
resized images and tokenised captions, and ``JointLoader``, which zips one
iterator per task so that each step carries a batch of every task. Host
numpy, as in JAX.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
from PIL import Image

__all__ = ["CaptionDataset", "JointLoader"]


# geopurify_tpu/data/joint_loader.py:31
class CaptionDataset:
    """(image, captions) pairs for VLP pretraining."""

    def __init__(self, root: str):
        self.root = root
        ann = os.path.join(root, "captions.json")
        if not os.path.exists(ann):
            raise FileNotFoundError(f"{root}: captions.json not found")
        with open(ann) as f:
            raw = json.load(f)
        if isinstance(raw, dict):
            self.records = [{"file_name": k, "captions": v}
                            for k, v in sorted(raw.items())]
        else:
            self.records = list(raw)
        if not self.records:
            raise ValueError(f"{root}: captions.json is empty")

    def __len__(self) -> int:
        return len(self.records)

    def sample(self, idx: int) -> Tuple[np.ndarray, list]:
        rec = self.records[idx]
        path = os.path.join(self.root, "images", rec["file_name"])
        img = np.asarray(Image.open(path).convert("RGB"))
        caps = rec["captions"]
        return img, caps if isinstance(caps, list) else [caps]

    def batches(self, batch_size: int, image_hw: Tuple[int, int],
                tokenizer: Callable, cap_len: int, seed: int = 0,
                shuffle: bool = True):
        """Infinite (images [B,H,W,3] f32, cap_ids [B,L] i32,
        cap_mask [B,L] f32) batches — the VLP mapper's square resize +
        tokenization (data/mappers.VLPMapper) at a fixed bucket."""
        from geopurify_tpu_torch.data.mappers import VLPMapper

        rng = np.random.default_rng(seed)
        H, W = image_hw
        mapper = VLPMapper(image_size=H, tokenizer=None)
        order = np.arange(len(self))
        pos = len(order)
        while True:
            images = np.zeros((batch_size, H, W, 3), np.float32)
            texts = []
            for b in range(batch_size):
                if pos >= len(order):
                    if shuffle:
                        rng.shuffle(order)
                    pos = 0
                img, caps = self.sample(int(order[pos]))
                pos += 1
                out = mapper({"image_np": img}, rng)
                im = out["image"]
                images[b, : im.shape[0], : im.shape[1]] = im[:H, :W]
                texts.append(caps[int(rng.integers(len(caps)))])
            ids, mask = tokenizer(texts)
            ids = ids[:, :cap_len].astype(np.int64)
            mask = mask[:, :cap_len].astype(np.float32)
            if ids.shape[1] < cap_len:
                pad = cap_len - ids.shape[1]
                ids = np.pad(ids, ((0, 0), (0, pad)))
                mask = np.pad(mask, ((0, 0), (0, pad)))
            yield images, ids, mask


# geopurify_tpu/data/joint_loader.py:96
class JointLoader:
    """Zip per-task iterators: each step yields {task: batch} with one
    batch from EVERY loader (≙ build.py JointLoader.__iter__'s zip)."""

    def __init__(self, loaders: Dict[str, Iterator]):
        if not loaders:
            raise ValueError("JointLoader needs at least one task loader")
        self.loaders = dict(loaders)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, object]:
        return {task: next(it) for task, it in self.loaders.items()}
