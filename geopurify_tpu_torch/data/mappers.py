"""Dataset mappers of 2D training and evaluation: host numpy, explicit
randomness.

Port of geopurify_tpu/data/mappers.py: the panoptic label codec
(``rgb2id`` / ``id2rgb``, id = R + 256 G + 256^2 B), the transform toolkit
(the documented semantics of detectron2's ResizeShortestEdge, Resize,
ResizeScale, FixedSizeCrop and RandomFlip, over numpy and PIL with an
explicit ``np.random.Generator``), the ten mappers and ``build_mapper``,
which dispatches on the registry catalog's mapper kinds
(``data/registry_catalog.py``): ``SemanticMapper`` (per-class masks),
``PanopticMapper`` (per-segment masks, classes and boxes; ``new_baseline``
adds large-scale jitter), ``InstanceMapper`` (COCO polygons / RLEs /
arrays), ``InteractiveMapper`` (panoptic instances -> the visual sampler's
spatial prompts, class or sentence groundings), ``RefCOCOMapper``
(referring masks and sentences), ``VLPMapper`` (square resize, caption
tokens) and the evaluation mappers ``EvalSemSegMapper``,
``PanoEvalMapper``, ``ImageNetMapper`` and ``PascalVOCIXMapper`` (object
masks, shape-sampler prompts, prompted class names). A copy of the JAX
code, so that a seed gives the same outputs in both packages.
``InteractiveMapper`` and ``RefCOCOMapper`` store ``hash(text)`` of each
grounding, which Python randomises per process.
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
    "SemanticMapper", "PanopticMapper", "InstanceMapper", "InteractiveMapper",
    "RefCOCOMapper", "VLPMapper", "EvalSemSegMapper", "PanoEvalMapper",
    "ImageNetMapper", "PascalVOCIXMapper", "build_mapper", "MAPPER_KINDS",
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


# geopurify_tpu/data/mappers.py:299
class SemanticMapper:
    """sem_seg -> per-category binary masks + classes (train)."""

    def __init__(self, ignore_label: int = 255, size_divisibility: int = -1,
                 min_sizes=(64,), max_size: int = 1333,
                 flip_prob: float = 0.5):
        self.ignore_label = ignore_label
        self.size_divisibility = size_divisibility
        self.tfm_gens = [ResizeShortestEdge(min_sizes, max_size),
                         RandomFlip(flip_prob)]

    def __call__(self, dataset_dict: Dict,
                 rng: Optional[np.random.Generator] = None) -> Dict:
        dd = copy.deepcopy(dataset_dict)
        image = _load_image(dd)
        sem = np.asarray(dd.pop("sem_seg_np")
                         if "sem_seg_np" in dd
                         else Image.open(dd.pop("sem_seg_file_name")))
        image, sem, _ = apply_transform_gens(
            self.tfm_gens, image, rng, seg=sem.astype(np.float64))
        image = _pad_divisible(image, self.size_divisibility, 128)
        sem = _pad_divisible(sem, self.size_divisibility,
                             self.ignore_label).astype(np.int64)
        dd["image"] = image
        dd["sem_seg"] = sem
        classes = np.unique(sem)
        classes = classes[classes != self.ignore_label]
        masks = np.stack([sem == c for c in classes]) if len(classes) else \
            np.zeros((0,) + sem.shape, bool)
        dd["instances"] = {"gt_classes": classes.astype(np.int64),
                           "gt_masks": masks}
        return dd


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


# geopurify_tpu/data/mappers.py:391
class InstanceMapper:
    """COCO-style annotations (polygon/RLE/array segmentations) ->
    instances; iscrowd filtered; boxes from masks."""

    def __init__(self, size_divisibility: int = -1, min_sizes=(64,),
                 max_size: int = 1333):
        self.size_divisibility = size_divisibility
        self.tfm_gens = [ResizeShortestEdge(min_sizes, max_size),
                         RandomFlip()]

    def __call__(self, dataset_dict: Dict,
                 rng: Optional[np.random.Generator] = None) -> Dict:
        dd = copy.deepcopy(dataset_dict)
        image = _load_image(dd)
        hw0 = image.shape[:2]
        annos = [a for a in dd.pop("annotations")
                 if not a.get("iscrowd", 0)]
        masks0 = [_decode_segm(a["segmentation"], hw0) for a in annos]
        image, _, applied = apply_transform_gens(self.tfm_gens, image, rng)
        masks = [_apply_to_seg(applied, m.astype(np.float64)) > 0.5
                 for m in masks0]
        image = _pad_divisible(image, self.size_divisibility, 128)
        masks = [_pad_divisible(m, self.size_divisibility, 0) for m in masks]
        masks = (np.stack(masks) if masks
                 else np.zeros((0,) + image.shape[:2], bool))
        dd["image"] = image
        dd["instances"] = {
            "gt_classes": np.asarray(
                [int(a["category_id"]) for a in annos], np.int64),
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


# geopurify_tpu/data/mappers.py:516
class RefCOCOMapper:
    """grounding_info -> referring masks + sentences. Train: large-scale
    jitter + ONE random sentence per annotation; eval: all sentences,
    un-transformed masks (≙ refcoco_dataset_mapper.py:139-201)."""

    def __init__(self, is_train: bool = True, image_size: int = 64,
                 min_scale: float = 0.1, max_scale: float = 2.0,
                 min_size_test: int = 64, max_size_test: int = 1333):
        self.is_train = is_train
        if is_train:
            self.tfm_gens = [
                RandomFlip(),
                ResizeScaleAug(min_scale, max_scale, image_size, image_size),
                FixedSizeCrop((image_size, image_size)),
            ]
        else:
            self.tfm_gens = [ResizeShortestEdge([min_size_test],
                                                max_size_test)]

    def __call__(self, dataset_dict: Dict,
                 rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng if rng is not None else np.random.default_rng(0)
        dd = copy.deepcopy(dataset_dict)
        image = _load_image(dd)
        hw0 = (dd["height"], dd["width"])
        image, _, applied = apply_transform_gens(self.tfm_gens, image, rng)
        dd["image"] = image
        gi = dd["grounding_info"]
        assert len(gi) > 0
        masks, texts, hashes, boxes = [], [], [], []
        for ann in gi:
            m = _decode_segm(ann["segmentation"], hw0)
            if self.is_train:
                m = _apply_to_seg(applied, m.astype(np.float64)) > 0.5
                sent = ann["sentences"][int(rng.integers(len(ann["sentences"])))]
                texts.append(sent["raw"].lower())
                hashes.append(hash(sent["raw"].lower()))
            else:
                texts.append([s["raw"].lower() for s in ann["sentences"]])
                boxes.append(ann.get("bbox", [0, 0, 0, 0]))
            masks.append(m)
        g = {"masks": np.stack(masks), "texts": texts}
        if self.is_train:
            g.update(hash=hashes, mode="text")
        else:
            g.update(boxes=np.asarray(boxes, np.float32))
        dd["groundings"] = g
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


# geopurify_tpu/data/mappers.py:589
class EvalSemSegMapper:
    """Eval-only: bicubic shortest-edge resize of the IMAGE, semseg kept at
    native resolution (≙ bdd/scannet/sunrgbd mappers — predictions are
    upsampled back to gt size by the evaluator)."""

    def __init__(self, min_size_test: int = 64):
        self.min_size_test = min_size_test

    def _resize_shortest_bicubic(self, image: np.ndarray) -> np.ndarray:
        h, w = image.shape[:2]
        s = self.min_size_test / min(h, w)
        return _resize_image(image, (int(round(h * s)), int(round(w * s))),
                             resample=Image.BICUBIC)

    def __call__(self, dataset_dict: Dict,
                 rng: Optional[np.random.Generator] = None) -> Dict:
        dd = copy.deepcopy(dataset_dict)
        image = _load_image(dd)
        dd["height"], dd["width"] = image.shape[:2]
        dd["image"] = self._resize_shortest_bicubic(image)
        sem = np.asarray(dd["sem_seg_np"] if "sem_seg_np" in dd
                         else Image.open(dd["sem_seg_file_name"]))
        dd["semseg"] = sem.astype(np.int32)
        return dd


# geopurify_tpu/data/mappers.py:615
class PanoEvalMapper:
    """Eval-only panoptic: bicubic image resize; pan_seg decoded to ids at
    native resolution (≙ scannet_pano_dataset_mapper.py)."""

    def __init__(self, min_size_test: int = 64):
        self.base = EvalSemSegMapper(min_size_test)

    def __call__(self, dataset_dict: Dict,
                 rng: Optional[np.random.Generator] = None) -> Dict:
        dd = copy.deepcopy(dataset_dict)
        image = _load_image(dd)
        dd["height"], dd["width"] = image.shape[:2]
        dd["image"] = self.base._resize_shortest_bicubic(image)
        if "pan_seg_np" in dd or "pan_seg_file_name" in dd:
            pan_rgb = np.asarray(dd.pop("pan_seg_np") if "pan_seg_np" in dd
                                 else Image.open(dd.pop("pan_seg_file_name")))
            dd["pan_seg"] = rgb2id(pan_rgb)
        return dd


# geopurify_tpu/data/mappers.py:635
class ImageNetMapper:
    """Eval-only classification: bicubic resize + center crop."""

    def __init__(self, size_crop: int = 64, size_test: int = 56):
        self.size_crop = size_crop
        self.size_test = size_test

    def __call__(self, dataset_dict: Dict,
                 rng: Optional[np.random.Generator] = None) -> Dict:
        dd = copy.deepcopy(dataset_dict)
        image = _load_image(dd)
        h, w = image.shape[:2]
        s = self.size_crop / min(h, w)
        image = _resize_image(image, (int(round(h * s)), int(round(w * s))),
                              resample=Image.BICUBIC)
        h, w = image.shape[:2]
        y0 = (h - self.size_test) // 2
        x0 = (w - self.size_test) // 2
        dd["image"] = image[y0: y0 + self.size_test, x0: x0 + self.size_test]
        dd["height"], dd["width"] = dd["image"].shape[:2]
        return dd


# geopurify_tpu/data/mappers.py:658
class PascalVOCIXMapper:
    """Eval-only interactive: per-object masks from an id raster, bicubic
    image resize, shape-sampler prompts, prompted class names, ignore -> -1
    originals (≙ pascalvoc_dataset_mapper_ix.py:133-183)."""

    def __init__(self, min_size_test: int = 64, ignore_id: int = 255,
                 sampler_cfg: Optional[StrokeSamplerConfig] = None,
                 mode: Optional[str] = None,
                 class_names: Optional[Sequence[str]] = None):
        self.base = EvalSemSegMapper(min_size_test)
        self.ignore_id = ignore_id
        cfg = sampler_cfg or StrokeSamplerConfig(eval_mode="random")
        from geopurify_tpu_torch.data.visual_sampler import build_shape_sampler

        self.shape_sampler = build_shape_sampler(cfg, is_train=False,
                                                 mode=mode)
        self.class_names = list(class_names) if class_names else None

    def __call__(self, dataset_dict: Dict,
                 rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng if rng is not None else np.random.default_rng(0)
        dd = copy.deepcopy(dataset_dict)
        image = _load_image(dd)
        dd["height"], dd["width"] = image.shape[:2]
        image = self.base._resize_shortest_bicubic(image)
        dd["image"] = image
        inst_raster = np.asarray(dd["inst_np"] if "inst_np" in dd
                                 else Image.open(dd["inst_name"]))
        ids = dd["objects_ids"]
        by_id0 = [(inst_raster == i) for i in ids]
        h, w = image.shape[:2]
        masks = np.stack([
            _resize_image(m.astype(np.uint8) * 255, (h, w),
                          resample=Image.BICUBIC) > 127
            for m in by_id0])
        boxes = _masks_to_boxes(masks)
        dd["instances"] = {"gt_masks": masks, "gt_boxes": boxes}
        dd["spatial_query"] = self.shape_sampler(masks, boxes,
                                                 draws=Draws(rng))
        sem = np.asarray(dd["semseg_np"] if "semseg_np" in dd
                         else Image.open(dd["semseg_name"]))
        gt_ori = np.stack([m.astype(np.int16) for m in by_id0])
        gt_ori[:, inst_raster == self.ignore_id] = -1
        dd["gt_masks_orisize"] = gt_ori
        if self.class_names:
            names = []
            for m in by_id0:
                cls = np.unique(sem[m])
                cls = cls[(cls > 0) & (cls != self.ignore_id)]
                names.append(self.class_names[int(cls[0]) - 1]
                             if len(cls) else "background")
            from geopurify_tpu_torch.models.lang import PROMPT_TEMPLATES

            dd["classes"] = [PROMPT_TEMPLATES[0].format(n) for n in names]
        return dd


# ---------------------------------------------------------------------------
# Dispatch by the registry catalog's mapper kinds
# ---------------------------------------------------------------------------

# geopurify_tpu/data/mappers.py:719
MAPPER_KINDS: Dict[str, Callable] = {
    "mask_former_semantic_dataset_mapper": SemanticMapper,
    "mask_former_panoptic_dataset_mapper": PanopticMapper,
    "mask_former_instance_dataset_mapper": InstanceMapper,
    "coco_instance_new_baseline_dataset_mapper": InstanceMapper,
    "coco_panoptic_new_baseline_dataset_mapper":
        lambda **kw: PanopticMapper(mode="new_baseline", **kw),
    "coco_panoptic_interactive_dataset_mapper": InteractiveMapper,
    "refcoco_dataset_mapper": RefCOCOMapper,
    "vlp_dataset_mapper": VLPMapper,
    "bdd_semseg_dataset_mapper": EvalSemSegMapper,
    "scannet_dataset_mapper": EvalSemSegMapper,
    "sunrgbd_dataset_mapper": EvalSemSegMapper,
    "scannet_pano_dataset_mapper": PanoEvalMapper,
    "imagenet_dataset_mapper": ImageNetMapper,
    "pascalvoc_dataset_mapper_ix": PascalVOCIXMapper,
}


# geopurify_tpu/data/mappers.py:738
def build_mapper(kind: str, **kwargs):
    """Mapper dispatch by the registry catalog's mapper-kind string
    (data/registry_catalog.py `mapper` field)."""
    if kind not in MAPPER_KINDS:
        raise KeyError(
            f"unknown mapper kind {kind!r}; known: {sorted(MAPPER_KINDS)}")
    return MAPPER_KINDS[kind](**kwargs)
