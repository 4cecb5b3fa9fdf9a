"""The visual sampler (SEEM's prompt generation) held against the JAX package
on the CPU: every sampler kind, in train and in eval draws, equal bit for
bit from one numpy seed; the SimpleClick sampler in each of its five
modes; the stroke raster and Bezier outline; and the ``torch_compat``
draws (python ``random``, numpy's global state, ``torch.randperm``) reseeded
alike on both sides."""

import random

import numpy as np
import pytest
import torch

from geopurify_tpu.data import visual_sampler as jvs
from geopurify_tpu_torch.data import visual_sampler as tvs


def masks_and_boxes(seed, n=3, hw=(40, 56)):
    """``n`` blob masks (a rectangle and a disc each) and their boxes."""
    rng = np.random.default_rng(seed)
    H, W = hw
    yy, xx = np.mgrid[:H, :W]
    masks = np.zeros((n, H, W), bool)
    for i in range(n):
        y0, x0 = rng.integers(2, H // 2), rng.integers(2, W // 2)
        masks[i, y0: y0 + rng.integers(6, H // 2), x0: x0 + rng.integers(6, W // 2)] = True
        cy, cx, r = rng.integers(8, H - 8), rng.integers(8, W - 8), rng.integers(4, 8)
        masks[i] |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    boxes = np.zeros((n, 4), np.float32)
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    return masks, boxes


def same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def draws(seed):
    return tvs.Draws(np.random.default_rng(seed)), jvs.Draws(np.random.default_rng(seed))


@pytest.mark.parametrize("kind", ["PointSampler", "CircleSampler", "ScribbleSampler",
                                  "PolygonSampler"])
@pytest.mark.parametrize("is_train", [True, False])
def test_shape_kinds_equal(kind, is_train):
    masks, boxes = masks_and_boxes(1)
    cfg_t = tvs.StrokeSamplerConfig(eval_max_iter=5)
    cfg_j = jvs.StrokeSamplerConfig(eval_max_iter=5)
    st, sj = getattr(tvs, kind)(cfg_t, is_train), getattr(jvs, kind)(cfg_j, is_train)
    dt, dj = draws(2)
    for m, b in zip(masks, boxes):
        got, want = st.draw(m, b, dt), sj.draw(m, b, dj)
        same(got, want)
        assert got.any()
    assert not st.draw(np.zeros_like(masks[0]), boxes[0], dt).any()


@pytest.mark.parametrize("is_train,mode", [(True, None), (False, "Scribble"),
                                           (False, "Polygon")])
def test_shape_sampler_equal(is_train, mode):
    masks, boxes = masks_and_boxes(3)
    kw = dict(max_candidate=2, eval_max_iter=4, eval_mode="random")
    cfg_t, cfg_j = tvs.StrokeSamplerConfig(**kw), jvs.StrokeSamplerConfig(**kw)
    st = tvs.build_shape_sampler(cfg_t, is_train, mode)
    sj = jvs.build_shape_sampler(cfg_j, is_train, mode)
    assert isinstance(st, tvs.ShapeSampler)
    for seed in range(3):
        dt, dj = draws(seed)
        same(st(masks, boxes, dt), sj(masks, boxes, dj))
    empty = st(masks[:0], boxes[:0])
    assert empty["types"] == ["none"]


@pytest.mark.parametrize("mode", ["Point", "Box", "Circle", "Scribble", "Polygon"])
def test_simple_click_sampler_equal(mode):
    """The next prompt at the centre of the false negatives, from a previous
    prediction and prompt."""
    masks, boxes = masks_and_boxes(4, n=2, hw=(24, 32))
    cfg_t, cfg_j = tvs.StrokeSamplerConfig(), jvs.StrokeSamplerConfig()
    st = tvs.build_shape_sampler(cfg_t, is_train=False, mode=mode)
    sj = jvs.build_shape_sampler(cfg_j, is_train=False, mode=mode)
    assert isinstance(st, tvs.SimpleClickSampler)
    pred = np.zeros_like(masks)
    pred[:, :, :10] = True
    prev = np.zeros_like(masks)
    prev[0, 3, 3] = True
    dt, dj = draws(5)
    got = st(masks, boxes, pred_masks=pred, prev_masks=prev, draws=dt)
    same(got, sj(masks, boxes, pred_masks=pred, prev_masks=prev, draws=dj))
    assert got["rand_shape"].any() and got["types"] == [mode.lower()] * 2


def test_stroke_raster_and_bezier_equal():
    """The raster under a preset (the default ``maxLineAcceleration=5``, a
    scalar, cannot be unpacked in either package: every caller passes a
    preset's pair)."""
    dt, dj = draws(6)
    pts = np.array([[10.0, 12.0], [30.0, 20.0], [22.0, 5.0]])
    preset = jvs._SCRIBBLE_PRESETS["rand_curve"]
    got = tvs.mask_by_input_strokes(dt, pts, 48, 40, 3, **preset)
    same(got, jvs.mask_by_input_strokes(dj, pts, 48, 40, 3, **preset))
    assert not got.all()
    a = np.random.default_rng(7).random((5, 2))
    same(tvs.get_bezier_curve(a, rad=0.2, edgy=0.05), jvs.get_bezier_curve(a, rad=0.2, edgy=0.05))
    clicks = np.zeros((2, 9, 11), bool)
    clicks[0, 4, 5] = clicks[1, 0, 10] = True
    same(tvs._dilate_clicks(clicks, 3), jvs._dilate_clicks(clicks, 3))


def test_torch_compat_draws_equal():
    """The reference-order draws through python ``random``, numpy's global
    state and ``torch.randperm``: both samplers reseeded alike."""
    masks, boxes = masks_and_boxes(8)
    outs = []
    for mod in (tvs, jvs):
        random.seed(3)
        np.random.seed(3)
        torch.manual_seed(3)
        sampler = mod.ShapeSampler(mod.StrokeSamplerConfig(max_candidate=3), is_train=True)
        outs.append(sampler(masks, boxes, mod.Draws.torch_compat()))
    same(*outs)
