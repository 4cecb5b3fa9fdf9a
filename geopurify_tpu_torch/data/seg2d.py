"""On-disk 2D instance-segmentation datasets for X-Decoder pretraining.

Port of geopurify_tpu/data/seg2d.py: images, per-instance masks and class
ids -> the (images, gt_classes, gt_masks, gt_valid) numpy batches that
``run.train2d`` trains on. Two layouts:

1. COCO-instance json (``annotations.json`` at the root): images[] and
   annotations[] with polygon segmentations (rasterised with PIL),
   uncompressed RLE counts, or compressed RLE strings (a pure-Python
   decoder of COCO's varint format);
2. the folder layout::

     root/images/<stem>.{jpg,png}
     root/masks/<stem>/<classid>_<k>.png   # one binary mask per instance
     root/classes.txt                      # one class name per line

Images resize (nearest) to the configured (H, W); masks are taken at
stride 4 (the criterion's mask grid); instances pad or truncate to
``max_targets``. Host numpy, a copy of the JAX module's, so that a seed
gives the same batches in both packages.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


# geopurify_tpu/data/seg2d.py:33
def _resize_nearest(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    H, W = img.shape[:2]
    oh, ow = out_hw
    if (H, W) == (oh, ow):
        return img
    ri = (np.arange(oh) * (H / oh)).astype(np.int64)
    ci = (np.arange(ow) * (W / ow)).astype(np.int64)
    return img[ri][:, ci]


# geopurify_tpu/data/seg2d.py:43
def _poly_to_mask(polys: Sequence[Sequence[float]], hw: Tuple[int, int]) -> np.ndarray:
    from PIL import Image, ImageDraw

    H, W = hw
    img = Image.new("1", (W, H), 0)
    draw = ImageDraw.Draw(img)
    for poly in polys:
        if len(poly) >= 6:
            draw.polygon([(poly[i], poly[i + 1]) for i in range(0, len(poly), 2)],
                         outline=1, fill=1)
    return np.asarray(img, bool)


# geopurify_tpu/data/seg2d.py:56
def _decode_rle_string(s) -> List[int]:
    """Decode COCO's compressed RLE ``counts`` string to run lengths.

    Pure-python port of the published maskApi encoding (pycocotools
    rleFrString): each count is a little-endian base-32 varint in printable
    chars (ASCII - 48), 5 data bits + 1 continuation bit per char, sign-
    extended when the last chunk's 0x10 bit is set; counts from the third
    on are deltas against count[i-2]."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


# geopurify_tpu/data/seg2d.py:86
def _rle_to_mask(rle: Dict, hw: Tuple[int, int]) -> np.ndarray:
    counts = rle.get("counts")
    if isinstance(counts, (bytes, str)):
        counts = _decode_rle_string(counts)
    H, W = rle.get("size", hw)
    flat = np.zeros(H * W, bool)
    pos = 0
    val = False
    for c in counts:
        if val:
            flat[pos: pos + c] = True
        pos += c
        val = not val
    return flat.reshape(H, W, order="F")   # COCO RLE runs down columns


# geopurify_tpu/data/seg2d.py:102
class Seg2DDataset:
    """Iterates (image u8 HWC, masks [N,H,W] bool, classes [N] int) samples."""

    def __init__(self, root: str):
        self.root = root
        ann = os.path.join(root, "annotations.json")
        if os.path.exists(ann):
            self._init_coco(ann)
        elif os.path.isdir(os.path.join(root, "images")):
            self._init_folder()
        else:
            raise FileNotFoundError(
                f"{root}: neither annotations.json nor images/ found"
            )

    # ---------------- COCO json ----------------

    def _init_coco(self, ann_path: str):
        with open(ann_path) as f:
            coco = json.load(f)
        self.mode = "coco"
        cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
        self.class_names = [c["name"] for c in cats]
        self._cat_to_contig = {c["id"]: i for i, c in enumerate(cats)}
        self._images = {im["id"]: im for im in coco["images"]}
        self._by_image: Dict[int, List[Dict]] = {}
        for a in coco.get("annotations", []):
            self._by_image.setdefault(a["image_id"], []).append(a)
        self._ids = sorted(self._images)

    # ---------------- folder layout ----------------

    def _init_folder(self):
        self.mode = "folder"
        img_dir = os.path.join(self.root, "images")
        self._files = sorted(
            os.path.join(img_dir, f) for f in os.listdir(img_dir)
            if f.lower().endswith((".jpg", ".jpeg", ".png"))
        )
        if not self._files:
            raise FileNotFoundError(f"no images under {img_dir}")
        cls_path = os.path.join(self.root, "classes.txt")
        self.class_names = (
            [ln.strip() for ln in open(cls_path) if ln.strip()]
            if os.path.exists(cls_path) else []
        )
        self._ids = list(range(len(self._files)))

    def __len__(self) -> int:
        return len(self._ids)

    def sample(self, idx: int):
        from PIL import Image

        if self.mode == "coco":
            im_id = self._ids[idx % len(self._ids)]
            info = self._images[im_id]
            img = np.asarray(
                Image.open(os.path.join(
                    self.root, info.get("file_name", f"{im_id}.jpg")
                )).convert("RGB")
            )
            hw = (info.get("height", img.shape[0]), info.get("width", img.shape[1]))
            masks, classes = [], []
            for a in self._by_image.get(im_id, []):
                seg = a.get("segmentation")
                if isinstance(seg, list):
                    m = _poly_to_mask(seg, hw)
                elif isinstance(seg, dict):
                    m = _rle_to_mask(seg, hw)
                else:
                    continue
                if m.any():
                    masks.append(m)
                    classes.append(self._cat_to_contig.get(a["category_id"], 0))
            return img, masks, classes

        path = self._files[idx % len(self._files)]
        img = np.asarray(Image.open(path).convert("RGB"))
        stem = os.path.splitext(os.path.basename(path))[0]
        mask_dir = os.path.join(self.root, "masks", stem)
        masks, classes = [], []
        if os.path.isdir(mask_dir):
            for f in sorted(os.listdir(mask_dir)):
                if not f.endswith(".png"):
                    continue
                cid = int(f.split("_")[0])
                m = np.asarray(Image.open(os.path.join(mask_dir, f))) > 0
                if m.ndim == 3:
                    m = m[..., 0]
                if m.any():
                    masks.append(m)
                    classes.append(cid)
        return img, masks, classes

    def batches(
        self,
        batch_size: int,
        image_hw: Tuple[int, int],
        max_targets: int = 8,
        seed: int = 0,
        shuffle: bool = True,
    ):
        """Infinite iterator of jit-ready numpy batches:
        (images [B,H,W,3] f32, gt_classes [B,T] i32,
         gt_masks [B,T,H/4,W/4] f32, gt_valid [B,T] bool)."""
        rng = np.random.default_rng(seed)
        H, W = image_hw
        h, w = H // 4, W // 4
        order = np.arange(len(self))
        pos = len(order)
        while True:
            images = np.zeros((batch_size, H, W, 3), np.float32)
            gt_masks = np.zeros((batch_size, max_targets, h, w), np.float32)
            gt_classes = np.zeros((batch_size, max_targets), np.int32)
            gt_valid = np.zeros((batch_size, max_targets), bool)
            for b in range(batch_size):
                if pos >= len(order):
                    if shuffle:
                        rng.shuffle(order)
                    pos = 0
                img, masks, classes = self.sample(int(order[pos]))
                pos += 1
                images[b] = _resize_nearest(img, (H, W)).astype(np.float32)
                keep = list(range(len(masks)))[:max_targets]
                for t, k in enumerate(keep):
                    gt_masks[b, t] = _resize_nearest(
                        masks[k].astype(np.float32), (h, w)
                    )
                    gt_classes[b, t] = classes[k]
                    gt_valid[b, t] = gt_masks[b, t].any()
            yield images, gt_classes, gt_masks, gt_valid
