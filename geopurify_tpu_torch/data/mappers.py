"""Dataset mappers of 2D training: host numpy, explicit randomness.

Port of the part of geopurify_tpu/data/mappers.py that ``run.train2d``
reaches: the panoptic label codec (``rgb2id`` / ``id2rgb``, id = R + 256 G
+ 256^2 B), the transform toolkit (the documented semantics of
detectron2's ResizeShortestEdge, Resize, ResizeScale, FixedSizeCrop and
RandomFlip, over numpy and PIL with an explicit ``np.random.Generator``),
and three mappers: ``PanopticMapper`` (per-segment masks, classes and
boxes; ``new_baseline`` adds large-scale jitter), ``InteractiveMapper``
(panoptic instances -> the visual sampler's spatial prompts, class or
sentence groundings) and ``VLPMapper`` (square resize, caption tokens).
A copy of the JAX code, so that a seed gives the same outputs in both
packages. ``InteractiveMapper`` stores ``hash(text)`` of each grounding,
which Python randomises per process.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from geopurify_tpu_torch.data.seg2d import _poly_to_mask, _rle_to_mask
from geopurify_tpu_torch.data.visual_sampler import Draws, ShapeSampler, StrokeSamplerConfig

__all__ = [
    "rgb2id", "id2rgb",
    "ResizeShortestEdge", "ResizeFixed", "ResizeScaleAug", "FixedSizeCrop",
    "RandomFlip", "apply_transform_gens",
    "PanopticMapper", "InteractiveMapper", "VLPMapper",
]


# geopurify_tpu/data/mappers.py:72
def rgb2id(color: np.ndarray) -> np.ndarray:
    """[..., 3] uint8 RGB -> int32 segment id (id = R + 256 G + 65536 B)."""
    c = color.astype(np.int32)
    return c[..., 0] + 256 * c[..., 1] + 256 * 256 * c[..., 2]


# geopurify_tpu/data/mappers.py:78
def id2rgb(seg_id: np.ndarray) -> np.ndarray:
    s = seg_id.astype(np.int32)
    return np.stack([s % 256, (s // 256) % 256, (s // 65536) % 256],
                    axis=-1).astype(np.uint8)


# geopurify_tpu/data/mappers.py:89
def _resize_image(img: np.ndarray, hw: Tuple[int, int],
                  resample=Image.BILINEAR) -> np.ndarray:
    h, w = hw
    return np.asarray(
        Image.fromarray(img).resize((w, h), resample=resample))


# geopurify_tpu/data/mappers.py:96
def _resize_nearest(seg: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    h, w = hw
    sh, sw = seg.shape[:2]
    ri = (np.arange(h) * (sh / h)).astype(np.int64).clip(0, sh - 1)
    ci = (np.arange(w) * (sw / w)).astype(np.int64).clip(0, sw - 1)
    return seg[ri][:, ci]


# geopurify_tpu/data/mappers.py:104
@dataclass
class _Applied:
    """One concrete geometric transform: shared by image + all label maps."""

    kind: str
    new_hw: Optional[Tuple[int, int]] = None
    flip: bool = False
    crop: Optional[Tuple[int, int, int, int]] = None       # y0, x0, h, w
    pad_to: Optional[Tuple[int, int]] = None
    pad_value: float = 128
    seg_pad_value: float = 255

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        if self.kind == "resize":
            return _resize_image(img, self.new_hw)
        if self.kind == "flip":
            return img[:, ::-1] if self.flip else img
        if self.kind == "crop_pad":
            return self._crop_pad(img, self.pad_value)
        raise ValueError(self.kind)

    def apply_segmentation(self, seg: np.ndarray) -> np.ndarray:
        if self.kind == "resize":
            return _resize_nearest(seg, self.new_hw)
        if self.kind == "flip":
            return seg[:, ::-1] if self.flip else seg
        if self.kind == "crop_pad":
            return self._crop_pad(seg, self.seg_pad_value)
        raise ValueError(self.kind)

    def _crop_pad(self, x: np.ndarray, value) -> np.ndarray:
        y0, x0, ch, cw = self.crop
        x = x[y0: y0 + ch, x0: x0 + cw]
        if self.pad_to is not None:
            th, tw = self.pad_to
            pads = [(0, max(0, th - x.shape[0])), (0, max(0, tw - x.shape[1]))]
            pads += [(0, 0)] * (x.ndim - 2)
            x = np.pad(x, pads, constant_values=value)
        return x


# geopurify_tpu/data/mappers.py:145
class ResizeShortestEdge:
    """≙ T.ResizeShortestEdge: sample a target shortest edge from
    ``min_sizes`` ('choice' sampling), scale, cap the longest edge."""

    def __init__(self, min_sizes: Sequence[int], max_size: int,
                 sampling: str = "choice"):
        self.min_sizes = ([min_sizes] if isinstance(min_sizes, int)
                          else list(min_sizes))
        self.max_size = max_size
        self.sampling = sampling

    def get_transform(self, img: np.ndarray, rng: np.random.Generator) -> _Applied:
        h, w = img.shape[:2]
        if self.sampling == "range":
            size = int(rng.integers(min(self.min_sizes),
                                    max(self.min_sizes) + 1))
        else:
            size = int(self.min_sizes[rng.integers(len(self.min_sizes))])
        scale = size / min(h, w)
        if max(h, w) * scale > self.max_size:
            scale = self.max_size / max(h, w)
        return _Applied("resize",
                        new_hw=(int(round(h * scale)), int(round(w * scale))))


# geopurify_tpu/data/mappers.py:170
class ResizeFixed:
    """≙ T.Resize((size, size)) — the VLP mapper's square resize."""

    def __init__(self, hw: Tuple[int, int]):
        self.hw = hw

    def get_transform(self, img, rng) -> _Applied:
        return _Applied("resize", new_hw=self.hw)


# geopurify_tpu/data/mappers.py:180
class ResizeScaleAug:
    """≙ T.ResizeScale (large-scale jitter): pick scale in
    [min_scale, max_scale], fit (target_h*s, target_w*s) preserving aspect."""

    def __init__(self, min_scale: float, max_scale: float,
                 target_height: int, target_width: int):
        self.min_scale, self.max_scale = min_scale, max_scale
        self.th, self.tw = target_height, target_width

    def get_transform(self, img, rng) -> _Applied:
        h, w = img.shape[:2]
        s = float(rng.uniform(self.min_scale, self.max_scale))
        scale = min(self.th * s / h, self.tw * s / w)
        return _Applied("resize",
                        new_hw=(int(h * scale), int(w * scale)))


# geopurify_tpu/data/mappers.py:197
class FixedSizeCrop:
    """≙ T.FixedSizeCrop: random-origin crop to at most ``size``, then pad
    bottom/right to exactly ``size`` (image 128, segmentation 255)."""

    def __init__(self, size: Tuple[int, int], pad_value: float = 128,
                 seg_pad_value: float = 255):
        self.size = size
        self.pad_value = pad_value
        self.seg_pad_value = seg_pad_value

    def get_transform(self, img, rng) -> _Applied:
        h, w = img.shape[:2]
        th, tw = self.size
        y0 = int(rng.integers(0, max(h - th, 0) + 1))
        x0 = int(rng.integers(0, max(w - tw, 0) + 1))
        return _Applied("crop_pad", crop=(y0, x0, min(th, h), min(tw, w)),
                        pad_to=self.size, pad_value=self.pad_value,
                        seg_pad_value=self.seg_pad_value)


# geopurify_tpu/data/mappers.py:217
class RandomFlip:
    def __init__(self, prob: float = 0.5, horizontal: bool = True):
        self.prob = prob
        self.horizontal = horizontal

    def get_transform(self, img, rng) -> _Applied:
        do = bool(rng.uniform() < self.prob) and self.horizontal
        return _Applied("flip", flip=do)


# geopurify_tpu/data/mappers.py:227
def apply_transform_gens(gens, image: np.ndarray,
                         rng: Optional[np.random.Generator] = None,
                         seg: Optional[np.ndarray] = None):
    """≙ T.apply_transform_gens: materialize each gen on the CURRENT image,
    apply to image (+ optional seg), return (image, seg, applied list)."""
    rng = rng if rng is not None else np.random.default_rng(0)
    applied: List[_Applied] = []
    for g in gens:
        t = g.get_transform(image, rng)
        image = t.apply_image(image)
        if seg is not None:
            seg = t.apply_segmentation(seg)
        applied.append(t)
    return image, seg, applied


# geopurify_tpu/data/mappers.py:243
def _apply_to_seg(applied: List[_Applied], seg: np.ndarray) -> np.ndarray:
    for t in applied:
        seg = t.apply_segmentation(seg)
    return seg


# geopurify_tpu/data/mappers.py:249
def _pad_divisible(image: np.ndarray, div: int, value: float):
    """≙ the mask_former mappers' F.pad-to-SIZE_DIVISIBILITY (literal
    semantics: pad bottom/right by (div - dim); negative pads crop)."""
    if div <= 0:
        return image
    h, w = image.shape[:2]
    ph, pw = div - h, div - w
    if ph < 0:
        image = image[:div]
    if pw < 0:
        image = image[:, :div]
    pads = [(0, max(ph, 0)), (0, max(pw, 0))] + [(0, 0)] * (image.ndim - 2)
    return np.pad(image, pads, constant_values=value)


# geopurify_tpu/data/mappers.py:264
def _masks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """[N, H, W] bool -> [N, 4] xyxy (BitMasks.get_bounding_boxes)."""
    n = len(masks)
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        ys, xs = np.nonzero(masks[i])
        if len(ys):
            boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    return boxes


# geopurify_tpu/data/mappers.py:275
def _decode_segm(segm, hw: Tuple[int, int]) -> np.ndarray:
    """COCO segmentation (polygon list | RLE dict | binary array) -> bool
    mask (≙ mask_former_instance_dataset_mapper.py:121-143)."""
    if isinstance(segm, list):
        return _poly_to_mask(segm, hw).astype(bool)
    if isinstance(segm, dict):
        return _rle_to_mask(segm, tuple(segm.get("size", hw))).astype(bool)
    seg = np.asarray(segm)
    assert seg.ndim == 2, f"bad segmentation ndim {seg.ndim}"
    return seg.astype(bool)


# geopurify_tpu/data/mappers.py:287
def _load_image(dd: Dict) -> np.ndarray:
    """image_np (HWC uint8) takes priority; else read file_name via PIL."""
    if "image_np" in dd:
        return np.asarray(dd["image_np"])
    return np.asarray(Image.open(dd["file_name"]).convert("RGB"))


# geopurify_tpu/data/mappers.py:333
class PanopticMapper:
    """pan_seg (RGB label-divisor raster) + segments_info -> per-segment
    masks/classes; mode='new_baseline' adds large-scale jitter + boxes."""

    def __init__(self, ignore_label: int = 255, size_divisibility: int = -1,
                 mode: str = "mask_former", image_size: int = 64,
                 min_scale: float = 0.1, max_scale: float = 2.0,
                 min_sizes=(64,), max_size: int = 1333):
        self.ignore_label = ignore_label
        self.size_divisibility = size_divisibility
        self.mode = mode
        if mode == "new_baseline":
            self.tfm_gens = [
                RandomFlip(),
                ResizeScaleAug(min_scale, max_scale, image_size, image_size),
                FixedSizeCrop((image_size, image_size)),
            ]
        else:
            self.tfm_gens = [ResizeShortestEdge(min_sizes, max_size),
                             RandomFlip()]

    def __call__(self, dataset_dict: Dict,
                 rng: Optional[np.random.Generator] = None) -> Dict:
        dd = copy.deepcopy(dataset_dict)
        image = _load_image(dd)
        pan_rgb = np.asarray(dd.pop("pan_seg_np") if "pan_seg_np" in dd
                             else Image.open(dd.pop("pan_seg_file_name")))
        segments_info = dd["segments_info"]
        sem = dd.pop("sem_seg_np", None)
        image, sem, applied = apply_transform_gens(
            self.tfm_gens, image, rng,
            seg=None if sem is None else np.asarray(sem, np.float64))
        pan_rgb = _apply_to_seg(applied, pan_rgb)
        pan_id = rgb2id(pan_rgb)
        if self.mode != "new_baseline":
            image = _pad_divisible(image, self.size_divisibility, 128)
            pan_id = _pad_divisible(pan_id, self.size_divisibility, 0)
            if sem is not None:
                sem = _pad_divisible(sem, self.size_divisibility,
                                     self.ignore_label)
        dd["image"] = image
        if sem is not None:
            dd["sem_seg"] = sem.astype(np.int64)
        classes, masks = [], []
        for info in segments_info:
            if not info.get("iscrowd", 0):
                classes.append(info["category_id"])
                masks.append(pan_id == info["id"])
        masks = (np.stack(masks) if masks
                 else np.zeros((0,) + pan_id.shape, bool))
        dd["instances"] = {
            "gt_classes": np.asarray(classes, np.int64),
            "gt_masks": masks,
            "gt_boxes": _masks_to_boxes(masks),
        }
        return dd


# geopurify_tpu/data/mappers.py:426
class InteractiveMapper:
    """Panoptic instances + boxes -> visual-sampler spatial prompts; the
    SEEM interactive-training mapper. grounding selects up to
    max_grounding_num class-name prompts (class mode; the sentence mode
    activates when grounding_info annotations are present); retrieval
    tokenizes captions."""

    def __init__(self, image_size: int = 64, min_scale: float = 0.1,
                 max_scale: float = 2.0,
                 sampler_cfg: Optional[StrokeSamplerConfig] = None,
                 class_names: Optional[Sequence[str]] = None,
                 grounding: bool = True, max_grounding_num: int = 3,
                 retrieval: bool = False,
                 tokenizer: Optional[Callable] = None):
        self.pan = PanopticMapper(mode="new_baseline", image_size=image_size,
                                  min_scale=min_scale, max_scale=max_scale)
        self.shape_sampler = ShapeSampler(
            sampler_cfg or StrokeSamplerConfig(), is_train=True)
        self.class_names = list(class_names) if class_names else None
        self.grounding = grounding
        self.max_grounding_num = max_grounding_num
        self.retrieval = retrieval
        self.tokenizer = tokenizer

    def __call__(self, dataset_dict: Dict,
                 rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng if rng is not None else np.random.default_rng(0)
        dd = self.pan(dataset_dict, rng)
        inst = dd["instances"]
        draws = Draws(rng)
        dd["spatial_query"] = self.shape_sampler(
            inst["gt_masks"], inst["gt_boxes"], draws)
        # captions pass through; the noun-similarity filter needs the
        # caption_similarity asset (see module docstring)
        if "captions" in dd:
            dd["captions_noun"] = None
        if self.retrieval and self.tokenizer is not None and "captions" in dd:
            ids, attn = self.tokenizer(dd["captions"])
            dd["tokens"] = {"input_ids": ids, "attention_mask": attn}
        if self.grounding:
            gi = dd.get("grounding_info", [])
            g_len = int(rng.integers(1, self.max_grounding_num))
            if gi:
                # sentence mode ≙ :293-310 (semantics; selection via rng)
                order = rng.permutation(len(gi))
                hw0 = (dd["height"], dd["width"])
                masks, texts = [], []
                for j in order:
                    ann = gi[j]
                    masks.append(_decode_segm(ann["segmentation"], hw0))
                    sent = ann["sentences"][
                        int(rng.integers(len(ann["sentences"])))]
                    texts.append(sent["raw"].lower())
                keep = min(g_len, len(texts))
                dd["groundings"] = {
                    "masks": np.stack(masks[:keep]),
                    "texts": texts[:keep], "mode": "text",
                    "hash": [hash(t) for t in texts[:keep]],
                }
            else:
                # class mode ≙ :311-328: unique classes, shuffled, prompted
                classes = inst["gt_classes"]
                if len(classes) == 0:
                    dd["groundings"] = {
                        "masks": np.zeros((0,) + dd["image"].shape[:2], bool),
                        "texts": ["none"], "mode": "class",
                        "hash": [hash("none")]}
                else:
                    names = (
                        [self.class_names[c] for c in classes]
                        if self.class_names
                        else [f"class_{c}" for c in classes])
                    uniq = sorted(set(names))
                    rng.shuffle(uniq)
                    keep = set(uniq[: min(g_len, len(uniq))])
                    sel = np.array([n in keep for n in names])
                    from geopurify_tpu_torch.models.lang import PROMPT_TEMPLATES

                    texts = [
                        PROMPT_TEMPLATES[int(rng.integers(
                            len(PROMPT_TEMPLATES)))].format(
                            n.replace("-other", "").replace("-merged", "")
                            .replace("-stuff", ""))
                        for n, s in zip(names, sel) if s]
                    dd["groundings"] = {
                        "masks": inst["gt_masks"][sel], "texts": texts,
                        "mode": "class", "hash": [hash(t) for t in texts]}
        return dd


# geopurify_tpu/data/mappers.py:566
class VLPMapper:
    """Square resize + caption tokenization (input_ids/attention_mask)."""

    def __init__(self, image_size: int = 64,
                 tokenizer: Optional[Callable] = None,
                 max_token_num: int = 77):
        self.tfm_gens = [ResizeFixed((image_size, image_size))]
        self.tokenizer = tokenizer
        self.max_token_num = max_token_num

    def __call__(self, dataset_dict: Dict,
                 rng: Optional[np.random.Generator] = None) -> Dict:
        dd = copy.deepcopy(dataset_dict)
        image = _load_image(dd)
        image, _, _ = apply_transform_gens(self.tfm_gens, image, rng)
        dd["image"] = image
        if self.tokenizer is not None:
            ids, attn = self.tokenizer(dd["captions"])
            dd["tokens"] = {"input_ids": ids[:, : self.max_token_num],
                            "attention_mask": attn[:, : self.max_token_num]}
        return dd
