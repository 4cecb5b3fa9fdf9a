"""Interactive-segmentation spatial-prompt samplers, host numpy.

Port of geopurify_tpu/data/visual_sampler.py, the whole module: the
samplers that turn an instance mask into a SEEM training prompt (point,
circle, scribble, polygon, the weighted ``ShapeSampler`` over them), the
free-form stroke raster and Bezier outlines they draw with, and the
SimpleClick sampler whose next click is the deepest pixel of the false
negatives (``distance_transform_conv``, the conv approximation of kornia's
``distance_transform``). Host numpy, scipy and PIL, as in JAX, and
randomness through an explicit ``Draws``: a seeded numpy generator makes
the same draws, and so the same prompts, in both packages.
``Draws.torch_compat()`` routes each draw to the library call the
original torch sampler makes (python ``random``, numpy's global state,
``torch.randperm``) in its order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw

__all__ = [
    "Draws",
    "StrokeSamplerConfig",
    "PointSampler",
    "CircleSampler",
    "ScribbleSampler",
    "PolygonSampler",
    "ShapeSampler",
    "SimpleClickSampler",
    "build_shape_sampler",
    "distance_transform_conv",
    "get_bezier_curve",
    "mask_by_input_strokes",
]


# geopurify_tpu/data/visual_sampler.py:68
class Draws:
    """Explicit randomness source for the samplers.

    Production mode wraps ONE ``np.random.Generator``. ``torch_compat()``
    instead routes each primitive to the exact library call the reference
    makes (python ``random`` / legacy ``np.random`` global / ``torch.randperm``)
    so that, with identical seeds, the draw STREAM — and therefore every
    sampled mask — bit-matches the original torch sampler."""

    def __init__(self, rng: Optional[np.random.Generator] = None):
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self._compat = False

    @classmethod
    def torch_compat(cls) -> "Draws":
        d = cls(np.random.default_rng(0))
        d._compat = True
        return d

    # --- python-`random` shaped primitives (inclusive randint) ---
    def py_randint(self, a: int, b: int) -> int:
        if self._compat:
            import random

            return random.randint(a, b)
        return int(self.rng.integers(a, b + 1))

    def py_shuffle(self, seq: List) -> None:
        if self._compat:
            import random

            random.shuffle(seq)
        else:
            self.rng.shuffle(seq)

    def py_choices(self, n: int, weights: Sequence[float], k: int) -> List[int]:
        """k weighted index choices in [0, n) — ``random.choices`` consumes
        rng identically for any population of length n."""
        if self._compat:
            import random

            return random.choices(list(range(n)), weights=list(weights), k=k)
        w = np.asarray(weights, np.float64)
        return [int(i) for i in self.rng.choice(n, size=k, p=w / w.sum())]

    # --- torch.randperm ---
    def randperm(self, n: int) -> np.ndarray:
        if self._compat:
            import torch

            return torch.randperm(n).numpy()
        return self.rng.permutation(n)

    # --- legacy np.random shaped primitives (exclusive randint) ---
    def np_randint(self, lo, hi) -> int:
        if self._compat:
            return int(np.random.randint(lo, hi))
        return int(self.rng.integers(int(lo), int(hi)))

    def np_uniform(self, lo: float, hi: float) -> float:
        if self._compat:
            return float(np.random.uniform(lo, hi))
        return float(self.rng.uniform(lo, hi))

    def np_normal(self, mu: float, sigma: float) -> float:
        if self._compat:
            return float(np.random.normal(mu, sigma))
        return float(self.rng.normal(mu, sigma))

    def np_shuffle(self, arr: np.ndarray) -> None:
        if self._compat:
            np.random.shuffle(arr)
        else:
            self.rng.shuffle(arr)


# geopurify_tpu/data/visual_sampler.py:149
@dataclass(frozen=True)
class StrokeSamplerConfig:
    """≙ the STROKE_SAMPLER config tree (SEEM release defaults; the yamls
    are not vendored — TRAIN.md:101 documents the MAX_CANDIDATE knob)."""

    max_candidate: int = 1
    candidate_names: Tuple[str, ...] = ("Point", "Polygon", "Scribble", "Circle")
    candidate_probs: Tuple[float, ...] = (0.25, 0.25, 0.25, 0.25)
    point_num_points: int = 20
    polygon_max_points: int = 9
    circle_num_strokes: int = 5
    circle_stroke_preset: Tuple[str, ...] = (
        "object_like", "object_like_middle", "object_like_small",
    )
    circle_stroke_prob: Tuple[float, ...] = (0.33, 0.33, 0.33)
    scribble_num_strokes: int = 5
    scribble_stroke_preset: Tuple[str, ...] = ("rand_curve", "rand_curve_small")
    scribble_stroke_prob: Tuple[float, ...] = (0.5, 0.5)
    dilation: int = 3
    eval_mode: str = "best"          # random | best | best_random
    eval_negative: bool = False
    eval_max_iter: int = 20


# stroke presets ≙ circle.py:15-53 / scribble.py:16-43 (protocol constants)
_CIRCLE_PRESETS: Dict[str, Dict] = {
    "object_like": dict(
        nVertexBound=[5, 30], maxHeadSpeed=15, maxHeadAcceleration=(10, 1.5),
        brushWidthBound=(20, 50), nMovePointRatio=0.5, maxPiontMove=10,
        maxLineAcceleration=(5, 0.5), boarderGap=None, maxInitSpeed=10,
    ),
    "object_like_middle": dict(
        nVertexBound=[5, 15], maxHeadSpeed=8, maxHeadAcceleration=(4, 1.5),
        brushWidthBound=(20, 50), nMovePointRatio=0.5, maxPiontMove=5,
        maxLineAcceleration=(5, 0.5), boarderGap=None, maxInitSpeed=10,
    ),
    "object_like_small": dict(
        nVertexBound=[5, 20], maxHeadSpeed=7, maxHeadAcceleration=(3.5, 1.5),
        brushWidthBound=(10, 30), nMovePointRatio=0.5, maxPiontMove=5,
        maxLineAcceleration=(3, 0.5), boarderGap=None, maxInitSpeed=4,
    ),
}
_SCRIBBLE_PRESETS: Dict[str, Dict] = {
    "rand_curve": dict(
        nVertexBound=[10, 30], maxHeadSpeed=20, maxHeadAcceleration=(15, 0.5),
        brushWidthBound=(3, 10), nMovePointRatio=0.5, maxPiontMove=3,
        maxLineAcceleration=(5, 0.5), boarderGap=None, maxInitSpeed=6,
    ),
    "rand_curve_small": dict(
        nVertexBound=[6, 22], maxHeadSpeed=12, maxHeadAcceleration=(8, 0.5),
        brushWidthBound=(2.5, 5), nMovePointRatio=0.5, maxPiontMove=1.5,
        maxLineAcceleration=(3, 0.5), boarderGap=None, maxInitSpeed=3,
    ),
}


# geopurify_tpu/data/visual_sampler.py:210
def _bezier(points: np.ndarray, num: int = 200) -> np.ndarray:
    """Bernstein-basis Bezier curve through control ``points`` [N, 2]."""
    n = len(points)
    t = np.linspace(0.0, 1.0, num=num)
    curve = np.zeros((num, 2))
    for i in range(n):
        b = math.comb(n - 1, i) * t ** i * (1.0 - t) ** (n - 1 - i)
        curve += np.outer(b, points[i])
    return curve


# geopurify_tpu/data/visual_sampler.py:221
def _ccw_sort(p: np.ndarray) -> np.ndarray:
    d = p - np.mean(p, axis=0)
    return p[np.argsort(np.arctan2(d[:, 0], d[:, 1])), :]


# geopurify_tpu/data/visual_sampler.py:226
def get_bezier_curve(a: np.ndarray, rad: float = 0.2, edgy: float = 0.0):
    """Closed smooth curve through the points ``a`` [N, 2] — per-segment
    cubic Beziers with heading-blended control angles (polygon.py:54-75)."""
    p = np.arctan(edgy) / np.pi + 0.5
    a = _ccw_sort(np.asarray(a, np.float64))
    a = np.append(a, np.atleast_2d(a[0, :]), axis=0)
    d = np.diff(a, axis=0)
    ang = np.arctan2(d[:, 1], d[:, 0])
    ang = np.where(ang >= 0, ang, ang + 2 * np.pi)
    ang1, ang2 = ang, np.roll(ang, 1)
    ang = p * ang1 + (1 - p) * ang2 + (np.abs(ang2 - ang1) > np.pi) * np.pi
    ang = np.append(ang, [ang[0]])
    pts = np.append(a, np.atleast_2d(ang).T, axis=1)
    curves = []
    for i in range(len(pts) - 1):
        p1, p2 = pts[i, :2], pts[i + 1, :2]
        a1, a2 = pts[i, 2], pts[i + 1, 2]
        r = rad * math.sqrt(float(np.sum((p2 - p1) ** 2)))
        ctrl = np.stack([
            p1,
            p1 + np.array([r * math.cos(a1), r * math.sin(a1)]),
            p2 + np.array([r * math.cos(a2 + math.pi), r * math.sin(a2 + math.pi)]),
            p2,
        ])
        curves.append(_bezier(ctrl, 100))
    c = np.concatenate(curves)
    return c[:, 0], c[:, 1], pts


# geopurify_tpu/data/visual_sampler.py:260
def _random_accelerate(draws: Draws, velocity, max_acc, dist: str):
    speed, angle = velocity
    d_speed, d_angle = max_acc
    if dist == "uniform":
        speed += draws.np_uniform(-d_speed, d_speed)
        angle += draws.np_uniform(-d_angle, d_angle)
    else:                                  # 'guassian' [sic]
        speed += draws.np_normal(0.0, d_speed / 2)
        angle += draws.np_normal(0.0, d_angle / 2)
    return speed, angle


# geopurify_tpu/data/visual_sampler.py:272
def _stroke_control_points(
    draws: Draws, init_point, W: int, H: int, nVertexBound, maxHeadSpeed,
    maxHeadAcceleration, boarderGap, maxInitSpeed,
):
    """One stroke's control points + line velocity
    (mask_generators.py:126-167, the Yu et al. free-form algorithm).
    NOTE the reference's axis quirk is preserved: head steps are
    x += speed*sin(angle), y += speed*cos(angle)."""
    startX, startY = float(init_point[0]), float(init_point[1])
    Xs, Ys = [startX], [startY]
    numVertex = draws.np_randint(nVertexBound[0], nVertexBound[1])
    angle = draws.np_uniform(0.0, 2 * np.pi)
    speed = draws.np_uniform(0.0, maxHeadSpeed)
    for _ in range(numVertex):
        speed, angle = _random_accelerate(
            draws, (speed, angle), maxHeadAcceleration, "uniform")
        speed = float(np.clip(speed, 0, maxHeadSpeed))
        nextX = startX + speed * np.sin(angle)
        nextY = startY + speed * np.cos(angle)
        if boarderGap is not None:
            nextX = float(np.clip(nextX, boarderGap, W - boarderGap))
            nextY = float(np.clip(nextY, boarderGap, H - boarderGap))
        startX, startY = nextX, nextY
        Xs.append(nextX)
        Ys.append(nextY)
    # initial line velocity (mask_generators.py:169-177, 'guassian')
    v_speed = abs(draws.np_normal(0.0, maxInitSpeed / 2))
    v_angle = draws.np_uniform(0.0, 2 * np.pi)
    return np.array(Xs), np.array(Ys), (v_speed, v_angle)


# geopurify_tpu/data/visual_sampler.py:303
def _move_control_points(
    draws: Draws, Xs, Ys, velocity, nMovePointRatio, maxPiontMove,
    maxLineAcceleration,
):
    """Whole-line shift + per-point jitter (mask_generators.py:106-123)."""
    new_Xs, new_Ys = Xs.copy(), Ys.copy()
    speed, angle = velocity
    new_Xs += int(speed * np.cos(angle))
    new_Ys += int(speed * np.sin(angle))
    _random_accelerate(draws, velocity, maxLineAcceleration, "guassian")
    chosen = np.arange(len(Xs))
    draws.np_shuffle(chosen)
    chosen = chosen[: int(len(Xs) * nMovePointRatio)]
    for i in chosen:
        new_Xs[i] += draws.np_randint(-maxPiontMove, maxPiontMove)
        new_Ys[i] += draws.np_randint(-maxPiontMove, maxPiontMove)
    return new_Xs, new_Ys


# geopurify_tpu/data/visual_sampler.py:322
def _draw_stroke(img: Image.Image, Xs, Ys, brushWidth: int, fill=0) -> None:
    """PIL polyline + endpoint disks (mask_generators.py:180-189)."""
    radius = brushWidth // 2 - 1
    draw = ImageDraw.Draw(img)
    for i in range(1, len(Xs)):
        draw.line((Xs[i - 1], Ys[i - 1], Xs[i], Ys[i]), fill=fill,
                  width=brushWidth)
    for x, y in zip(Xs, Ys):
        draw.ellipse((x - radius, y - radius, x + radius, y + radius), fill=fill)


# geopurify_tpu/data/visual_sampler.py:333
def mask_by_input_strokes(
    draws: Draws, init_points: np.ndarray, W: int, H: int, nStroke: int,
    nVertexBound=(10, 30), maxHeadSpeed=15, maxHeadAcceleration=(15, 0.5),
    brushWidthBound=(5, 20), boarderGap=None, nMovePointRatio=0.5,
    maxPiontMove=10, maxLineAcceleration=5, maxInitSpeed=5,
) -> np.ndarray:
    """[H, W] bool where True = NOT covered by a stroke (the reference
    returns a PIL '1' image with strokes drawn as 0 on a 1 background;
    callers use ``~mask`` — mask_generators.py:6-86). The first raster is
    drawn and DISCARDED, then every stroke is jittered once and redrawn —
    the video-mask heritage the rng stream must preserve."""
    mask = Image.new(mode="1", size=(W, H), color=1)
    strokes = []
    for i in range(nStroke):
        brushWidth = draws.np_randint(brushWidthBound[0], brushWidthBound[1])
        Xs, Ys, velocity = _stroke_control_points(
            draws, init_points[i], W, H, nVertexBound, maxHeadSpeed,
            maxHeadAcceleration, boarderGap, maxInitSpeed)
        strokes.append((Xs, Ys, velocity, brushWidth))
        _draw_stroke(mask, Xs, Ys, brushWidth, fill=0)
    mask = Image.new(mode="1", size=(W, H), color=1)
    for j in range(len(strokes)):
        Xs, Ys, velocity, brushWidth = strokes[j]
        new_Xs, new_Ys = _move_control_points(
            draws, Xs, Ys, velocity, nMovePointRatio, maxPiontMove,
            maxLineAcceleration)
        strokes[j] = (new_Xs, new_Ys, velocity, brushWidth)
    for Xs, Ys, velocity, brushWidth in strokes:
        _draw_stroke(mask, Xs, Ys, brushWidth, fill=0)
    return np.array(mask)


# geopurify_tpu/data/visual_sampler.py:370
def _random_mask_points(draws: Draws, mask: np.ndarray, n: int) -> np.ndarray:
    """n random (x, y) pixel coords from the mask's True set, selected via
    randperm over the row-major nonzero order (circle.py:55-63)."""
    h, w = mask.shape
    nz = np.flatnonzero(mask.reshape(-1))
    sel = nz[draws.randperm(len(nz))[:n]]
    return np.stack([(sel % w).astype(np.float64),
                     (sel // w).astype(np.float64)], axis=1)


# geopurify_tpu/data/visual_sampler.py:380
class PointSampler:
    """≙ point.py Point: train draws a random subset of mask pixels; eval
    emits a growing click sequence with +1/-1 polarity channels."""

    def __init__(self, cfg: StrokeSamplerConfig, is_train: bool = True):
        self.max_points = cfg.point_num_points
        self.max_eval = cfg.eval_max_iter
        self.is_train = is_train

    def draw(self, mask: np.ndarray, box=None, draws: Optional[Draws] = None):
        draws = draws or Draws()
        if mask.sum() < 10:
            return np.zeros(mask.shape, bool)
        if not self.is_train:
            return self.draw_eval(mask, box, draws)
        max_points = min(self.max_points, int(mask.sum()))
        num_points = draws.py_randint(1, max_points)
        h, w = mask.shape
        nz = np.flatnonzero(mask.reshape(-1))
        sel = nz[draws.randperm(len(nz))[:num_points]]
        rand = np.zeros(h * w, bool)
        rand[sel] = True
        return rand.reshape(h, w)

    def draw_eval(self, mask, box=None, draws: Optional[Draws] = None):
        """[n_iter, H, W] float in {-1, 0, +1}: prefix-growing click stacks,
        first click always positive (point.py:35-71)."""
        draws = draws or Draws()
        background = ~mask
        neg_num = min(self.max_eval // 2, int(background.sum()))
        pos_num = min(self.max_eval - neg_num, int(mask.sum()) - 1) + 1
        h, w = mask.shape
        nz_pos = np.flatnonzero(mask.reshape(-1))
        pos = nz_pos[draws.randperm(len(nz_pos))[:pos_num]]
        nz_neg = np.flatnonzero(background.reshape(-1))
        neg = nz_neg[draws.randperm(len(nz_neg))[:neg_num]]
        idx_all = np.concatenate([pos, neg])
        sign = np.concatenate([np.ones(len(pos)), -np.ones(len(neg))])
        order = np.concatenate([[0], draws.randperm(len(idx_all) - 1) + 1]).astype(int)
        idx_all, sign = idx_all[order], sign[order]
        out = np.zeros((len(idx_all), h * w), np.float32)
        for i in range(len(idx_all)):
            out[i:, :][:, idx_all[i]] = sign[i]
        return out.reshape(-1, h, w)


# geopurify_tpu/data/visual_sampler.py:426
class _StrokeBase:
    """Shared train/eval body of Circle and Scribble (they differ only in
    presets and two rng-order quirks — circle.py:66-96, scribble.py:55-85)."""

    presets: Dict[str, Dict] = {}
    kind = ""

    def __init__(self, num_strokes, preset_names, preset_probs, max_eval,
                 is_train):
        self.num_stroke = num_strokes
        self.stroke_preset = list(preset_names)
        self.stroke_prob = list(preset_probs)
        self.max_eval = max_eval
        self.is_train = is_train

    def _n_stroke_train(self, draws: Draws, mask_sum: int) -> int:
        raise NotImplementedError

    def draw(self, mask: np.ndarray, box=None, draws: Optional[Draws] = None):
        draws = draws or Draws()
        if mask.sum() < 10:
            return np.zeros(mask.shape, bool)
        if not self.is_train:
            return self.draw_eval(mask, box, draws)
        pi = draws.py_choices(len(self.stroke_preset), self.stroke_prob, 1)[0]
        preset = self.presets[self.stroke_preset[pi]]
        nStroke = self._n_stroke_train(draws, int(mask.sum()))
        h, w = mask.shape
        points = _random_mask_points(draws, mask, n=nStroke)
        rand = mask_by_input_strokes(
            draws, points, w, h, min(nStroke, len(points)), **preset)
        return (~rand) & mask

    def draw_eval(self, mask, box=None, draws: Optional[Draws] = None):
        draws = draws or Draws()
        pi = draws.py_choices(len(self.stroke_preset), self.stroke_prob, 1)[0]
        preset = self.presets[self.stroke_preset[pi]]
        nStroke = min(self.max_eval, int(mask.sum()))
        h, w = mask.shape
        points = _random_mask_points(draws, mask, n=nStroke)
        out = []
        for i in range(len(points)):
            n = self._n_stroke_eval(i, len(points))
            rand = mask_by_input_strokes(
                draws, points[: i + 1], w, h, n, **preset)
            out.append((~rand) & mask)
        return np.stack(out)

    def _n_stroke_eval(self, i: int, n_points: int) -> int:
        return min(i + 1, n_points)


# geopurify_tpu/data/visual_sampler.py:478
class CircleSampler(_StrokeBase):
    presets = _CIRCLE_PRESETS
    kind = "circle"

    def __init__(self, cfg: StrokeSamplerConfig, is_train: bool = True):
        super().__init__(cfg.circle_num_strokes, cfg.circle_stroke_preset,
                         cfg.circle_stroke_prob, cfg.eval_max_iter, is_train)

    def _n_stroke_train(self, draws, mask_sum):
        # circle.py:74: min(randint(1, num_stroke), mask.sum())
        return min(draws.py_randint(1, self.num_stroke), mask_sum)

    @staticmethod
    def draw_by_points(points: np.ndarray, mask: np.ndarray, h: int, w: int,
                       draws: Optional[Draws] = None) -> np.ndarray:
        """[1, H, W] stroke through given points (circle.py:98-105)."""
        draws = draws or Draws()
        pi = draws.py_choices(3, [0.33, 0.33, 0.33], 1)[0]
        preset = _CIRCLE_PRESETS[
            ("object_like", "object_like_middle", "object_like_small")[pi]]
        rand = mask_by_input_strokes(draws, points, w, h, len(points), **preset)
        return (~rand)[None] & mask


# geopurify_tpu/data/visual_sampler.py:502
class ScribbleSampler(_StrokeBase):
    presets = _SCRIBBLE_PRESETS
    kind = "scribble"

    def __init__(self, cfg: StrokeSamplerConfig, is_train: bool = True):
        super().__init__(cfg.scribble_num_strokes, cfg.scribble_stroke_preset,
                         cfg.scribble_stroke_prob, cfg.eval_max_iter, is_train)

    def _n_stroke_train(self, draws, mask_sum):
        # scribble.py:63: randint(1, min(num_stroke, mask.sum()))
        return draws.py_randint(1, min(self.num_stroke, mask_sum))

    def _n_stroke_eval(self, i, n_points):
        # scribble.py:82 quirk: nStroke = min(i, len(points)) — the FIRST
        # eval iteration draws zero strokes (preserved for parity)
        return min(i, n_points)

    @staticmethod
    def draw_by_points(points: np.ndarray, mask: np.ndarray, h: int, w: int,
                       draws: Optional[Draws] = None) -> np.ndarray:
        draws = draws or Draws()
        pi = draws.py_choices(2, [0.5, 0.5], 1)[0]
        preset = _SCRIBBLE_PRESETS[("rand_curve", "rand_curve_small")[pi]]
        rand = mask_by_input_strokes(draws, points, w, h, len(points), **preset)
        return (~rand)[None] & mask


# geopurify_tpu/data/visual_sampler.py:529
def _rasterize_bezier(coords_norm, box, full_shape) -> np.ndarray:
    """Bezier curve through box-normalized points -> sparse pixel canvas in
    the box, placed on the full raster (polygon.py:96-112)."""
    x1, y1, x2, y2 = (int(v) for v in box)
    bx, by, _ = get_bezier_curve(coords_norm, rad=0.2, edgy=0.05)
    bx = bx.clip(0.0, 1.0)
    by = by.clip(0.0, 1.0)
    rows = (by * (y2 - y1 - 1)).astype(np.int64)
    cols = (bx * (x2 - x1 - 1)).astype(np.int64)
    canvas = np.zeros((y2 - y1, x2 - x1), np.float32)
    canvas[rows, cols] = 1
    out = np.zeros(full_shape, np.float32)
    out[y1:y2, x1:x2] = canvas
    return out


# geopurify_tpu/data/visual_sampler.py:545
class PolygonSampler:
    """≙ polygon.py Polygon: a closed bezier outline through random points
    of the box-cropped mask; eval dilates the outline (struct(2,2) x5)."""

    def __init__(self, cfg: StrokeSamplerConfig, is_train: bool = True):
        self.max_points = cfg.polygon_max_points
        self.eval_points = cfg.eval_max_iter
        self.is_train = is_train

    def _norm_points(self, draws, mask, n):
        h, w = mask.shape
        nz = np.flatnonzero(mask.reshape(-1))
        sel = nz[draws.randperm(len(nz))[:n]]
        y = (sel // w).astype(np.float64) / (h + 1)
        x = (sel % w).astype(np.float64) / (w + 1)
        return np.stack([x, y], axis=1)

    def draw(self, mask: np.ndarray, box=None, draws: Optional[Draws] = None):
        draws = draws or Draws()
        if mask.sum() < 10:
            return np.zeros(mask.shape, bool)
        if not self.is_train:
            return self.draw_eval(mask, box, draws)
        x1, y1, x2, y2 = (int(v) for v in box)
        num_points = draws.py_randint(1, min(self.max_points, int(mask.sum())))
        a = self._norm_points(draws, mask[y1:y2, x1:x2], num_points)
        return _rasterize_bezier(a, (x1, y1, x2, y2), mask.shape).astype(bool)

    def draw_eval(self, mask, box=None, draws: Optional[Draws] = None):
        from scipy import ndimage

        draws = draws or Draws()
        x1, y1, x2, y2 = (int(v) for v in box)
        num_points = min(self.eval_points, int(mask.sum()))
        a = self._norm_points(draws, mask[y1:y2, x1:x2], num_points)
        struct = ndimage.generate_binary_structure(2, 2)
        out = []
        for i in range(len(a)):
            r = _rasterize_bezier(a[: i + 1], (x1, y1, x2, y2), mask.shape)
            r = ndimage.binary_dilation(r, structure=struct, iterations=5)
            out.append(r.astype(bool))
        return np.stack(out)


_SHAPE_CLASSES = {
    "Point": PointSampler,
    "Polygon": PolygonSampler,
    "Scribble": ScribbleSampler,
    "Circle": CircleSampler,
}
_SHAPE_NAMES = {
    PointSampler: "point", PolygonSampler: "polygon",
    ScribbleSampler: "scribble", CircleSampler: "circle",
}


# geopurify_tpu/data/visual_sampler.py:601
class ShapeSampler:
    """≙ sampler.py ShapeSampler: shuffle instances, keep ``max_candidate``,
    draw one weighted-random shape per kept instance."""

    def __init__(self, cfg: StrokeSamplerConfig, is_train: bool = True,
                 mode: Optional[str] = None):
        probs = list(cfg.candidate_probs)
        if not is_train and mode is not None:
            probs = [0.0] * len(cfg.candidate_names)
            probs[list(cfg.candidate_names).index(mode)] = 1.0
        self.max_candidate = cfg.max_candidate
        self.shape_prob = probs
        self.shape_candidate = [
            _SHAPE_CLASSES[n](cfg, is_train) for n in cfg.candidate_names]
        self.is_train = is_train

    def __call__(self, masks: np.ndarray, boxes: np.ndarray,
                 draws: Optional[Draws] = None) -> Dict:
        """masks [N, H, W] bool, boxes [N, 4] (x1,y1,x2,y2). Returns
        {'gt_masks': [C,H,W], 'rand_shape': [C,(iter,)H,W] bool,
        'types': list[str]} (sampler.py:47-72)."""
        draws = draws or Draws()
        if len(masks) == 0:
            h, w = masks.shape[-2:]
            z = np.zeros((h, w), bool)
            return {"gt_masks": z[None], "rand_shape": z[None],
                    "types": ["none"]}
        indices = list(range(len(masks)))
        if self.is_train:
            draws.py_shuffle(indices)
            keep = indices[: self.max_candidate]
        else:
            keep = indices
        cand_mask = masks[keep].copy()
        cand_box = boxes[keep]
        pick = draws.py_choices(len(self.shape_candidate), self.shape_prob,
                                k=len(cand_mask))
        shapes, types = [], []
        for j, (pi, m, b) in enumerate(zip(pick, cand_mask, cand_box)):
            d = self.shape_candidate[pi]
            shapes.append(d.draw(m, b, draws))
            types.append(_SHAPE_NAMES[type(d)])
        for i in range(len(shapes)):
            if shapes[i].sum() == 0:
                cand_mask[i] = cand_mask[i] & False
                types[i] = "none"
        return {"gt_masks": cand_mask, "rand_shape": np.stack(shapes).astype(bool),
                "types": types}


# geopurify_tpu/data/visual_sampler.py:656
def distance_transform_conv(image: np.ndarray, kernel_size: int = 3,
                            h: float = 0.35) -> np.ndarray:
    """Conv-approximated distance transform (the kornia.contrib algorithm the
    reference calls at simpleclick_sampler.py:66): each ZERO pixel of
    ``image`` gets an approximate distance to the nearest NON-zero pixel,
    built by iteratively convolving the growing boundary with an
    exp(-d/h) kernel and reading -h*log of the response. Non-zero pixels
    return 0. image: [..., H, W] float of {0, 1}."""
    from scipy.signal import convolve2d

    img = np.asarray(image, np.float32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
    n, H, W = img.shape
    half = kernel_size // 2
    ki, kj = np.meshgrid(np.arange(kernel_size) - half,
                         np.arange(kernel_size) - half, indexing="ij")
    kernel = np.exp(-np.hypot(ki, kj) / h).astype(np.float32)
    out = np.zeros_like(img)
    n_iters = math.ceil(max(H, W) / half)
    for b in range(n):
        boundary = img[b].copy()
        for i in range(n_iters):
            pad = np.pad(boundary, half, mode="edge")
            cdt = convolve2d(pad, kernel, mode="valid")
            with np.errstate(divide="ignore"):
                cdt = -h * np.log(cdt)
            cdt = np.nan_to_num(cdt, posinf=0.0)
            m = cdt > 0
            if not m.any():
                break
            out[b] += (i * half + cdt) * m
            boundary = np.where(m, 1.0, boundary)
    return out[0] if squeeze else out


# geopurify_tpu/data/visual_sampler.py:693
def _center_clicks(fp: np.ndarray) -> np.ndarray:
    """[N] flat argmax of the border-padded distance transform per mask —
    the deepest pixel inside each false-negative region
    (simpleclick_sampler.py:64-70: dt of ~pad(fp) with the image border
    counting as boundary)."""
    n, h, w = fp.shape
    padded = np.pad(fp, ((0, 0), (1, 1), (1, 1)), constant_values=False)
    dt = distance_transform_conv((~padded).astype(np.float32))[:, 1:-1, 1:-1]
    return dt.reshape(n, -1).argmax(axis=1)


# geopurify_tpu/data/visual_sampler.py:704
def _dilate_clicks(click_masks: np.ndarray, dilation: int) -> np.ndarray:
    """ones(d, d) conv > 0 ≙ the reference's grouped dilation conv."""
    from scipy.signal import convolve2d

    k = np.ones((dilation, dilation), np.float32)
    pad = dilation // 2
    out = []
    for m in click_masks.astype(np.float32):
        p = np.pad(m, pad)
        c = convolve2d(p, k, mode="valid")
        c = c[: m.shape[0], : m.shape[1]]
        out.append(c > 0)
    return np.stack(out)


# geopurify_tpu/data/visual_sampler.py:719
class SimpleClickSampler:
    """≙ simpleclick_sampler.py SimpleClickSampler: the next prompt targets
    the center of the current false-negative region fp = gt & ~pred & ~prev;
    modes Point/Box dilate the click, Circle/Scribble grow a stroke from it,
    Polygon draws a bezier outline inside fp."""

    def __init__(self, cfg: StrokeSamplerConfig, is_train: bool = True,
                 mode: str = "Point"):
        self.mask_mode = mode
        self.sample_negative = cfg.eval_negative
        self.is_train = is_train
        self.dilation = cfg.dilation
        self.max_points = cfg.polygon_max_points

    def _fp(self, gt, pred, prev):
        pred = np.zeros_like(gt) if pred is None else pred[:, : gt.shape[1], : gt.shape[2]]
        prev = np.zeros_like(gt) if prev is None else prev
        return gt & ~(gt & pred) & ~prev, prev

    def __call__(self, gt_masks: np.ndarray, boxes: Optional[np.ndarray] = None,
                 pred_masks=None, prev_masks=None,
                 draws: Optional[Draws] = None) -> Dict:
        draws = draws or Draws()
        mode = self.mask_mode
        n, h, w = gt_masks.shape
        if mode == "Box":
            gt_masks = gt_masks.copy()
            for i in range(n):
                x1, y1, x2, y2 = (int(v) for v in boxes[i])
                gt_masks[i, y1:y2, x1:x2] = True
        fp, prev = self._fp(gt_masks, pred_masks, prev_masks)
        if mode in ("Point", "Box"):
            clicks = _center_clicks(fp)
            nm = np.zeros((n, h * w), bool)
            nm[np.arange(n), clicks] = True
            next_mask = _dilate_clicks(nm.reshape(n, h, w), self.dilation)
        elif mode in ("Circle", "Scribble"):
            clicks = _center_clicks(fp)
            draw_by = (CircleSampler if mode == "Circle"
                       else ScribbleSampler).draw_by_points
            parts = []
            for i in range(n):
                y, x = divmod(int(clicks[i]), w)
                pts = np.array([[x, y]], np.float64)
                parts.append(draw_by(pts, gt_masks[i: i + 1], h, w, draws))
            next_mask = np.concatenate(parts, axis=0)
        elif mode == "Polygon":
            parts = []
            for i in range(n):
                num_points = draws.py_randint(
                    1, min(self.max_points, int(fp[i].sum())))
                nz = np.flatnonzero(fp[i].reshape(-1))
                sel = nz[draws.randperm(len(nz))[:num_points]]
                y = (sel // w).astype(np.float64) / (h + 1)
                x = (sel % w).astype(np.float64) / (w + 1)
                coords = np.stack([x, y], axis=1)
                parts.append(_rasterize_bezier(
                    coords, tuple(int(v) for v in boxes[i]), (h, w)))
            next_mask = np.stack(parts).astype(bool)
        else:
            raise ValueError(f"unknown mask_mode {mode!r}")
        rand_shapes = prev | next_mask
        return {"gt_masks": gt_masks, "rand_shape": rand_shapes[:, None],
                "types": [mode.lower()] * n}


# geopurify_tpu/data/visual_sampler.py:785
def build_shape_sampler(cfg: StrokeSamplerConfig, is_train: bool = True,
                        mode: Optional[str] = None):
    """≙ visual_sampler/__init__.py build_shape_sampler: EVAL.MODE 'random'
    -> ShapeSampler; 'best'/'best_random' -> SimpleClickSampler."""
    if cfg.eval_mode == "random" or is_train:
        return ShapeSampler(cfg, is_train=is_train, mode=mode)
    if cfg.eval_mode in ("best", "best_random"):
        return SimpleClickSampler(cfg, is_train=is_train,
                                  mode=mode or "Point")
    raise ValueError(f"unknown eval mode {cfg.eval_mode!r}")
