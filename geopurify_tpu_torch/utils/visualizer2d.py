"""Detectron2-style 2D prediction drawing, dependency-light (numpy + PIL).

The port's own copy of geopurify_tpu/utils/visualizer2d.py (numpy only in
the JAX package too; the port imports nothing of it): semantic region fills
with boundary contours and class text at each region's centre of mass,
per-instance coloured masks with score text and boxes, panoptic drawing,
dataset-dict annotations, rotated boxes, keypoint skeletons, and the
primitives they compose (text, box, circle, line, binary and soft masks,
polygon, the grayscale IMAGE_BW mode). Text goes through PIL; the pixels
equal the JAX package's for the same inputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from geopurify_tpu_torch.utils.visualization import class_palette


def _mask_boundary(mask: np.ndarray) -> np.ndarray:
    """Boundary pixels of a bool mask (4-neighborhood erosion difference)."""
    m = mask.astype(bool)
    er = m.copy()
    er[1:] &= m[:-1]
    er[:-1] &= m[1:]
    er[:, 1:] &= m[:, :-1]
    er[:, :-1] &= m[:, 1:]
    return m & ~er


def _text_anchor(mask: np.ndarray) -> Tuple[int, int]:
    """Center of mass of the mask's largest occupied row band — cheap stand-in
    for the reference's largest-connected-component median (:1068-1088)."""
    ys, xs = np.nonzero(mask)
    return int(np.median(xs)), int(np.median(ys))


def _brightness(color: np.ndarray, factor: float) -> np.ndarray:
    """± lightness shift, ≙ _change_color_brightness (:1192-1215)."""
    c = color.astype(np.float32)
    if factor >= 0:
        return c + (255.0 - c) * factor
    return c * (1.0 + factor)


class Visualizer2D:
    """Draw predictions onto one RGB image (values 0..255, HWC uint8)."""

    def __init__(
        self,
        image: np.ndarray,
        class_names: Optional[Sequence[str]] = None,
        palette: Optional[np.ndarray] = None,
        font_size: Optional[int] = None,
    ):
        self.img = np.ascontiguousarray(image).astype(np.float32)
        self.H, self.W = self.img.shape[:2]
        self.class_names = list(class_names) if class_names else None
        n = max(len(self.class_names) if self.class_names else 0, 64)
        self.palette = palette if palette is not None else class_palette(n)
        self.font_size = font_size or max(
            int(np.sqrt(self.H * self.W) // 40), 10
        )
        self._texts: List[Tuple[str, int, int, Tuple[int, int, int]]] = []

    # ------------------------------------------------------------------
    # primitives
    # ------------------------------------------------------------------

    def draw_binary_mask(
        self,
        mask: np.ndarray,
        color: np.ndarray,
        alpha: float = 0.65,
        text: Optional[str] = None,
        draw_boundary: bool = True,
    ) -> "Visualizer2D":
        m = mask.astype(bool)
        if not m.any():
            return self
        c = np.asarray(color, np.float32)
        self.img[m] = (1 - alpha) * self.img[m] + alpha * c
        if draw_boundary:
            b = _mask_boundary(m)
            self.img[b] = _brightness(c, -0.7)
        if text:
            x, y = _text_anchor(m)
            self._texts.append((text, x, y, tuple(
                int(v) for v in _brightness(c, 0.7)
            )))
        return self

    def draw_box(
        self, box_xyxy: Sequence[float], color: np.ndarray, width: int = 2
    ) -> "Visualizer2D":
        x0, y0, x1, y1 = [int(round(v)) for v in box_xyxy]
        x0, x1 = np.clip([x0, x1], 0, self.W - 1)
        y0, y1 = np.clip([y0, y1], 0, self.H - 1)
        c = np.asarray(color, np.float32)
        for w in range(width):
            self.img[np.clip(y0 + w, 0, self.H - 1), x0:x1 + 1] = c
            self.img[np.clip(y1 - w, 0, self.H - 1), x0:x1 + 1] = c
            self.img[y0:y1 + 1, np.clip(x0 + w, 0, self.W - 1)] = c
            self.img[y0:y1 + 1, np.clip(x1 - w, 0, self.W - 1)] = c
        return self

    def draw_text(
        self, text: str, x: int, y: int,
        color: Tuple[int, int, int] = (255, 255, 255),
    ) -> "Visualizer2D":
        self._texts.append((text, int(x), int(y), color))
        return self

    def draw_line(
        self, x0: float, y0: float, x1: float, y1: float,
        color: np.ndarray, width: int = 2,
    ) -> "Visualizer2D":
        """Anti-alias-free raster line (≙ draw_line :1015-1044)."""
        c = np.asarray(color, np.float32)
        n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
        xs = np.clip(np.linspace(x0, x1, n).round().astype(int), 0, self.W - 1)
        ys = np.clip(np.linspace(y0, y1, n).round().astype(int), 0, self.H - 1)
        for w in range(-(width // 2), width - width // 2):
            self.img[np.clip(ys + w, 0, self.H - 1), xs] = c
            self.img[ys, np.clip(xs + w, 0, self.W - 1)] = c
        return self

    def draw_circle(
        self, x: float, y: float, color: np.ndarray, radius: int = 3
    ) -> "Visualizer2D":
        """Filled disk (≙ draw_circle :997-1013)."""
        yy, xx = np.ogrid[: self.H, : self.W]
        m = (xx - x) ** 2 + (yy - y) ** 2 <= radius ** 2
        self.img[m] = np.asarray(color, np.float32)
        return self

    def draw_polygon(
        self, points_xy: np.ndarray, color: np.ndarray,
        alpha: float = 0.5, edge: bool = True,
    ) -> "Visualizer2D":
        """Filled polygon + darkened edge (≙ draw_polygon :1125-1159).
        ``points_xy`` [N, 2] in (x, y) order; even-odd scanline fill."""
        pts = np.asarray(points_xy, np.float32)
        ys, xs = np.mgrid[: self.H, : self.W]
        inside = np.zeros((self.H, self.W), bool)
        n = len(pts)
        for i in range(n):
            x0, y0 = pts[i]
            x1, y1 = pts[(i + 1) % n]
            if y0 == y1:
                continue
            cond = ((ys >= min(y0, y1)) & (ys < max(y0, y1)))
            xi = x0 + (ys - y0) * (x1 - x0) / (y1 - y0)
            inside ^= cond & (xs < xi)
        self.draw_binary_mask(inside, color, alpha=alpha, draw_boundary=False)
        if edge:
            ec = _brightness(np.asarray(color, np.float32), -0.7)
            for i in range(n):
                x0, y0 = pts[i]
                x1, y1 = pts[(i + 1) % n]
                self.draw_line(x0, y0, x1, y1, ec, width=2)
        return self

    def draw_soft_mask(
        self, soft_mask: np.ndarray, color: Optional[np.ndarray] = None,
        text: Optional[str] = None, alpha: float = 0.5,
    ) -> "Visualizer2D":
        """Per-pixel alpha = soft_mask * alpha (≙ draw_soft_mask :1097-1123)."""
        c = np.asarray(
            color if color is not None else self.palette[0], np.float32
        )
        a = (np.clip(soft_mask, 0, 1) * alpha)[..., None]
        self.img = (1 - a) * self.img + a * c[None, None]
        if text and (soft_mask > 0.5).any():
            x, y = _text_anchor(soft_mask > 0.5)
            self._texts.append(
                (text, x, y, tuple(int(v) for v in _brightness(c, 0.7)))
            )
        return self

    def draw_rotated_box_with_label(
        self,
        rotated_box: Sequence[float],       # (cnt_x, cnt_y, w, h, angle_deg CCW)
        color: np.ndarray,
        label: Optional[str] = None,
        width: int = 2,
    ) -> "Visualizer2D":
        """≙ draw_rotated_box_with_label (:942-995): corners at the rotated
        rect (x right, y down; the second edge dashed in the reference — a
        raster line here), label at the top-left corner."""
        import math

        cnt_x, cnt_y, w, h, angle = rotated_box
        theta = angle * math.pi / 180.0
        cth, sth = math.cos(theta), math.sin(theta)
        rect = [(-w / 2, h / 2), (-w / 2, -h / 2), (w / 2, -h / 2), (w / 2, h / 2)]
        rot = [
            (sth * yy + cth * xx + cnt_x, cth * yy - sth * xx + cnt_y)
            for (xx, yy) in rect
        ]
        c = np.asarray(color, np.float32)
        for k in range(4):
            j = (k + 1) % 4
            self.draw_line(rot[k][0], rot[k][1], rot[j][0], rot[j][1], c,
                           width=width)
        if label is not None:
            self._texts.append((
                label, int(rot[1][0]), int(rot[1][1]),
                tuple(int(v) for v in _brightness(c, 0.7)),
            ))
        return self

    # ------------------------------------------------------------------
    # prediction-level API (≙ draw_sem_seg / draw_instance_predictions)
    # ------------------------------------------------------------------

    def overlay_rotated_instances(
        self,
        boxes: np.ndarray,                  # [N, 5] (cx, cy, w, h, angle)
        labels: Optional[Sequence[str]] = None,
        colors: Optional[np.ndarray] = None,
    ) -> "Visualizer2D":
        """≙ overlay_rotated_instances (:760-796): draw large boxes first."""
        if len(boxes) == 0:
            return self
        areas = boxes[:, 2] * boxes[:, 3]
        order = np.argsort(-areas)
        for i in order:
            color = (
                colors[i] if colors is not None
                else self.palette[(i * 11 + 3) % len(self.palette)]
            )
            self.draw_rotated_box_with_label(
                boxes[i], color, label=labels[i] if labels else None
            )
        return self

    def draw_and_connect_keypoints(
        self,
        keypoints: np.ndarray,              # [K, 3] (x, y, prob)
        keypoint_names: Optional[Sequence[str]] = None,
        connection_rules: Optional[Sequence[Tuple[str, str, Tuple[int, int, int]]]] = None,
        threshold: float = 0.05,
    ) -> "Visualizer2D":
        """≙ draw_and_connect_keypoints (:798-855): red dots for visible
        keypoints, skeleton lines per the connection rules, plus the
        person-specific nose->mid-shoulder and mid-shoulder->mid-hip lines
        (no-ops when those names are absent)."""
        RED = np.array([255, 60, 60], np.float32)
        visible: Dict[str, Tuple[float, float]] = {}
        for idx, (x, y, prob) in enumerate(np.asarray(keypoints, np.float32)):
            if prob > threshold:
                self.draw_circle(x, y, RED)
                if keypoint_names:
                    visible[keypoint_names[idx]] = (x, y)
        for kp0, kp1, color in connection_rules or ():
            if kp0 in visible and kp1 in visible:
                (x0, y0), (x1, y1) = visible[kp0], visible[kp1]
                self.draw_line(x0, y0, x1, y1, np.asarray(color, np.float32))
        if "left_shoulder" in visible and "right_shoulder" in visible:
            (lsx, lsy), (rsx, rsy) = visible["left_shoulder"], visible["right_shoulder"]
            msx, msy = (lsx + rsx) / 2, (lsy + rsy) / 2
            if "nose" in visible:
                nx, ny = visible["nose"]
                self.draw_line(nx, ny, msx, msy, RED)
            if "left_hip" in visible and "right_hip" in visible:
                (lhx, lhy), (rhx, rhy) = visible["left_hip"], visible["right_hip"]
                self.draw_line((lhx + rhx) / 2, (lhy + rhy) / 2, msx, msy, RED)
        return self

    def to_grayscale_outside(self, masks: Optional[np.ndarray] = None) -> "Visualizer2D":
        """≙ _create_grayscale_image (:1181-1190, the IMAGE_BW color mode):
        gray out everything outside the union of the given masks."""
        gray = self.img.mean(axis=2, keepdims=True) * np.ones((1, 1, 3), np.float32)
        if masks is None:
            self.img = gray
        else:
            keep = np.any(np.asarray(masks, bool), axis=0)
            self.img = np.where(keep[..., None], self.img, gray)
        return self

    def draw_sem_seg(
        self,
        sem_seg: np.ndarray,               # [H, W] int class ids
        area_threshold: int = 0,
        alpha: float = 0.65,
        ignore_label: int = 255,
    ) -> "Visualizer2D":
        ids, areas = np.unique(sem_seg, return_counts=True)
        order = np.argsort(-areas)          # large regions first (:458)
        for k in order:
            cid = int(ids[k])
            if cid == ignore_label or areas[k] <= area_threshold:
                continue
            name = (
                self.class_names[cid]
                if self.class_names and cid < len(self.class_names)
                else str(cid)
            )
            self.draw_binary_mask(
                sem_seg == cid, self.palette[cid % len(self.palette)],
                alpha=alpha, text=name,
            )
        return self

    def draw_instance_predictions(
        self,
        masks: np.ndarray,                 # [N, H, W] bool
        classes: Sequence[int],
        scores: Optional[Sequence[float]] = None,
        boxes: Optional[np.ndarray] = None,  # [N, 4] xyxy
        alpha: float = 0.55,
    ) -> "Visualizer2D":
        order = np.argsort([-m.sum() for m in masks])  # big first (:700-704)
        for i in order:
            cid = int(classes[i])
            color = self.palette[(cid * 7 + i) % len(self.palette)]
            name = (
                self.class_names[cid]
                if self.class_names and cid < len(self.class_names)
                else str(cid)
            )
            label = name if scores is None else f"{name} {scores[i]:.0%}"
            self.draw_binary_mask(masks[i], color, alpha=alpha, text=label)
            if boxes is not None:
                self.draw_box(boxes[i], _brightness(color, -0.3))
        return self

    def draw_panoptic_seg(
        self,
        panoptic_seg: np.ndarray,          # [H, W] int segment ids, 0 = void
        category_ids: Sequence[int],       # per segment id (1-based indexing)
        isthing: Sequence[bool],
        alpha: float = 0.6,
    ) -> "Visualizer2D":
        """≙ Visualizer.draw_panoptic_seg (reference utils/visualizer.py:
        draw_panoptic_seg_predictions): stuff segments use the class palette
        color, thing instances get distinct jittered colors; every segment is
        labeled at its mass center. ``category_ids[s-1]`` / ``isthing[s-1]``
        describe segment id ``s``."""
        ids, areas = np.unique(panoptic_seg, return_counts=True)
        order = np.argsort(-areas)
        for k in order:
            sid = int(ids[k])
            if sid == 0 or sid - 1 >= len(category_ids):
                continue
            cid = int(category_ids[sid - 1])
            base = self.palette[cid % len(self.palette)]
            color = (
                _brightness(base, 0.25 * (sid % 3 - 1))
                if isthing[sid - 1]
                else base
            )
            name = (
                self.class_names[cid]
                if self.class_names and cid < len(self.class_names)
                else str(cid)
            )
            self.draw_binary_mask(panoptic_seg == sid, color, alpha=alpha,
                                  text=name)
        return self

    def draw_dataset_dict(self, dic: Dict) -> "Visualizer2D":
        """≙ draw_dataset_dict (:549-616): draw a detectron2-format
        annotation dict — per-annotation bbox (XYWH -> XYXY), polygon or
        bitmask segmentation, keypoints, and category labels; then an
        optional 'sem_seg' layer."""
        annos = dic.get("annotations", [])
        for i, anno in enumerate(annos):
            cid = int(anno.get("category_id", 0))
            color = self.palette[(cid * 7 + i) % len(self.palette)]
            name = (
                self.class_names[cid]
                if self.class_names and cid < len(self.class_names)
                else str(cid)
            )
            if "bbox" in anno:
                x, y, w, h = anno["bbox"][:4]
                # detectron2 BoxMode: XYXY_ABS == 0, XYWH_ABS == 1; also
                # accept the string forms
                mode = anno.get("bbox_mode", "xywh")
                if mode in ("xyxy", 0):
                    box = [x, y, w, h]
                else:
                    box = [x, y, x + w, y + h]
                self.draw_box(box, color)
                self.draw_text(
                    ("crowd " if anno.get("iscrowd") else "") + name,
                    int(box[0]) + 4, int(box[1]) + 6,
                    tuple(int(v) for v in _brightness(color, 0.7)),
                )
            seg = anno.get("segmentation")
            if seg is not None:
                if isinstance(seg, np.ndarray):
                    self.draw_binary_mask(seg, color, alpha=0.4)
                else:
                    for poly in seg:                      # COCO [x0,y0,x1,...]
                        pts = np.asarray(poly, np.float32).reshape(-1, 2)
                        self.draw_polygon(pts, color, alpha=0.4)
            if "keypoints" in anno:
                kps = np.asarray(anno["keypoints"], np.float32).reshape(-1, 3)
                # COCO visibility flag v>0 -> prob 1
                kps[:, 2] = (kps[:, 2] > 0).astype(np.float32)
                self.draw_and_connect_keypoints(
                    kps, keypoint_names=anno.get("keypoint_names"),
                    connection_rules=anno.get("keypoint_connection_rules"),
                    threshold=0.5,
                )
        if "sem_seg" in dic:
            self.draw_sem_seg(np.asarray(dic["sem_seg"]))
        return self

    # ------------------------------------------------------------------

    def get_image(self) -> np.ndarray:
        """Composite + rasterize queued text; returns HWC uint8."""
        out = np.clip(self.img, 0, 255).astype(np.uint8)
        if not self._texts:
            return out
        from PIL import Image, ImageDraw, ImageFont

        pil = Image.fromarray(out)
        draw = ImageDraw.Draw(pil)
        try:
            font = ImageFont.truetype(
                "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
                self.font_size,
            )
        except OSError:
            font = ImageFont.load_default()
        for text, x, y, color in self._texts:
            # dark halo for contrast (≙ the reference's text path effects)
            for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                draw.text((x + dx, y + dy), text, fill=(0, 0, 0), font=font,
                          anchor="mm")
            draw.text((x, y), text, fill=color, font=font, anchor="mm")
        return np.asarray(pil)
