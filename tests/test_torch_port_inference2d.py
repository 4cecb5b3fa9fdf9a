"""The 2D task family's post-processing held against the JAX package on the
CPU, on the same seeded inputs: ``semantic_inference`` (f32 rel < 1e-5),
``panoptic_inference`` (segment map and table equal, stuff merging and
overlap rejection exercised), ``instance_inference`` / ``masks_to_boxes``
(equal picks, classes, masks and boxes, with tied probabilities ordered as
``jax.lax.top_k`` orders them), ``grounding_inference``,
``retrieval_scores``, ``caption_greedy_decode`` (equal ids), the semseg
evaluator (equal int32 confusion counts and summary), and the drawing
(``overlay_2d_semantic``, ``Visualizer2D``) pixel-equal to JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.models import inference2d as jinf
from geopurify_tpu.utils import eval2d as jeval
from geopurify_tpu.utils import visualization as jvis
from geopurify_tpu.utils import visualizer2d as jviz2d
from geopurify_tpu_torch.models import inference2d as tinf
from geopurify_tpu_torch.utils import eval2d as teval
from geopurify_tpu_torch.utils import visualization as tvis
from geopurify_tpu_torch.utils import visualizer2d as tviz2d

Q, N_CLS, H, W = 12, 5, 24, 32


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def preds():
    """Confident, overlapping query predictions: several queries share a
    class (stuff merges), a few predict the background, two are copies of
    another (tied probabilities)."""
    rng = np.random.default_rng(0)
    cls = rng.normal(size=(Q, N_CLS + 1)).astype(np.float32)
    cls[np.arange(Q), rng.integers(0, N_CLS + 1, Q)] += 6.0
    cls[:3, 1] += 8.0                          # three queries of class 1
    cls[9] = cls[10] = cls[4]                  # exact ties
    masks = rng.normal(size=(Q, H, W)).astype(np.float32) * 3
    yy, xx = np.mgrid[:H, :W]
    for q in range(Q):
        cy, cx = rng.integers(0, H), rng.integers(0, W)
        masks[q] += 8.0 * (((yy - cy) ** 2 + (xx - cx) ** 2) < rng.integers(20, 120)) - 4.0
    masks[11] = -10.0                          # an empty mask
    return cls, masks


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("keep_bgd", [False, True])
def test_semantic_inference_matches_jax(preds, keep_bgd):
    cls, masks = preds
    ref = np.asarray(jinf.semantic_inference(jnp.asarray(cls), jnp.asarray(masks), keep_bgd))
    got = tinf.semantic_inference(_t(cls), _t(masks), keep_bgd).numpy()
    assert got.shape == ref.shape == (H, W, N_CLS + keep_bgd)
    assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("thresholds", [(0.8, 0.8), (0.3, 0.5), (0.0, 0.0)])
def test_panoptic_inference_matches_jax(preds, thresholds):
    cls, masks = preds
    is_thing = np.array([True, False, True, False, False])
    pan_j, info_j = jinf.panoptic_inference(jnp.asarray(cls), jnp.asarray(masks),
                                            jnp.asarray(is_thing), *thresholds)
    pan_t, info_t = tinf.panoptic_inference(_t(cls), _t(masks), _t(is_thing), *thresholds)
    assert pan_t.dtype == torch.int32 and np.array_equal(pan_t.numpy(), np.asarray(pan_j))
    for field in tinf.PanopticSegments._fields:
        a, b = getattr(info_t, field).numpy(), np.asarray(getattr(info_j, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    if thresholds == (0.3, 0.5):
        assert info_t.valid.sum() >= 2 and (pan_t > 0).any()


@pytest.mark.parametrize("topk,things", [(10, False), (Q * N_CLS, True)])
def test_instance_inference_matches_jax(preds, topk, things):
    """Every (query, class) pair at the largest k, so the tied copies'
    order shows."""
    cls, masks = preds
    tm = np.array([True, False, True, True, False]) if things else None
    ref = jinf.instance_inference(jnp.asarray(cls), jnp.asarray(masks), topk,
                                  None if tm is None else jnp.asarray(tm))
    got = tinf.instance_inference(_t(cls), _t(masks), topk, None if tm is None else _t(tm))
    for field in ("masks", "boxes", "classes", "valid"):
        a, b = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert _rel(got.scores.numpy(), ref.scores) < 1e-5


def test_masks_to_boxes_matches_jax():
    rng = np.random.default_rng(1)
    m = rng.random((6, 9, 13)) < 0.05
    m[0] = False
    m[1] = False
    m[1, 8, 12] = True                         # a one-pixel mask at the corner
    ref = np.asarray(jinf.masks_to_boxes(jnp.asarray(m)))
    got = tinf.masks_to_boxes(_t(m)).numpy()
    assert np.array_equal(got, ref) and not ref[0].any()


def test_grounding_and_retrieval_match_jax(preds):
    _, masks = preds
    rng = np.random.default_rng(2)
    q = rng.normal(size=(Q, 16)).astype(np.float32)
    t = rng.normal(size=(3, 16)).astype(np.float32)
    mj, ij = jinf.grounding_inference(jnp.asarray(q), jnp.asarray(t), jnp.asarray(masks),
                                      logit_scale=jnp.log(jnp.float32(50.0)))
    mt, it = tinf.grounding_inference(_t(q), _t(t), _t(masks), logit_scale=np.log(50.0))
    assert np.array_equal(it.numpy(), np.asarray(ij)) and np.array_equal(mt.numpy(), mj)
    img = rng.normal(size=(5, 16)).astype(np.float32)
    ref = np.asarray(jinf.retrieval_scores(jnp.asarray(img), jnp.asarray(t)))
    got = tinf.retrieval_scores(_t(img), _t(t)).numpy()
    assert got.shape == (3, 5) and _rel(got, ref) < 1e-5
    assert np.array_equal(np.argsort(-got, 1), np.argsort(-ref, 1))


def test_caption_greedy_decode_matches_jax():
    """A fixed next-token table: token i's logits depend on the buffer."""
    rng = np.random.default_rng(3)
    V, L = 37, 9
    table = rng.normal(size=(V, V)).astype(np.float32)
    pos = rng.normal(size=(L, V)).astype(np.float32)

    def logits_j(tokens):
        return jnp.asarray(table)[tokens] + jnp.asarray(pos)[None]

    def logits_t(tokens):
        return _t(table)[tokens.long()] + _t(pos)[None]

    ref = np.asarray(jinf.caption_greedy_decode(logits_j, steps=6, context_length=L,
                                                bos_id=V - 2, batch=2))
    got = tinf.caption_greedy_decode(logits_t, steps=6, context_length=L, bos_id=V - 2,
                                     batch=2)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), ref)
    assert (ref[:, 7:] == V - 2).all() and len(set(ref[0, 1:7])) > 1


def test_semseg_evaluator_matches_jax():
    rng = np.random.default_rng(4)
    ev_j, ev_t = (m.SemSeg2DEvaluator(4, ["a", "b", "c", "d"]) for m in (jeval, teval))
    for _ in range(3):
        pred = rng.integers(0, 6, (20, 30))
        gt = rng.integers(0, 5, (20, 30)).astype(np.uint8)
        gt[rng.random((20, 30)) < 0.1] = 255
        c_j = np.asarray(jeval.confusion_update(jnp.asarray(pred), jnp.asarray(gt), 4))
        c_t = teval.confusion_update(_t(pred), _t(gt), 4)
        assert c_t.dtype == torch.int32 and np.array_equal(c_t.numpy(), c_j)
        ev_j.process(pred, gt)
        ev_t.process(pred, gt)
    assert ev_t.evaluate() == ev_j.evaluate()


def _drawings(mod, img, preds):
    """Every drawing path of ``Visualizer2D`` on one image."""
    cls, masks = preds
    rng = np.random.default_rng(5)
    names = ["wall", "floor", "chair", "table", "sofa"]
    seg = rng.integers(0, 5, (H, W))
    seg[:6] = 255
    pan = np.zeros((H, W), np.int32)
    pan[4:14, 3:20], pan[10:22, 15:30] = 1, 2
    binm = masks[:4] > 0
    out = {
        "sem": mod.Visualizer2D(img, names).draw_sem_seg(seg, alpha=0.6).get_image(),
        "pan": mod.Visualizer2D(img, names).draw_panoptic_seg(pan, [2, 1], [True, False])
        .get_image(),
        "inst": mod.Visualizer2D(img, names).draw_instance_predictions(
            binm, np.array([0, 2, 2, 4]), scores=np.array([0.9, 0.5, 0.4, 0.1]),
            boxes=np.array([[1, 2, 20, 15], [0, 0, 5, 5], [3, 3, 30, 20], [0, 0, 0, 0]],
                           np.float32)).get_image(),
        "ref": mod.Visualizer2D(img, ["the red box"]).draw_binary_mask(
            binm[0], np.array([200, 40, 40]), alpha=0.5, text="the red box").get_image(),
    }
    v = mod.Visualizer2D(img, names)
    v.draw_dataset_dict({"annotations": [
        {"category_id": 1, "bbox": [2, 3, 10, 8], "segmentation": [[2, 3, 12, 3, 12, 11]]},
        {"category_id": 3, "bbox": [5, 5, 20, 18], "bbox_mode": "xyxy", "iscrowd": 1,
         "keypoints": [5, 6, 2, 9, 9, 1, 0, 0, 0]}], "sem_seg": seg})
    v.draw_soft_mask(1 / (1 + np.exp(-masks[5])), text="soft")
    v.overlay_rotated_instances(np.array([[15, 12, 10, 6, 30.0]]), labels=["rot"])
    out["misc"] = v.to_grayscale_outside(binm[:1]).get_image()
    return out


def test_drawing_pixel_equal_to_jax(preds):
    img = np.random.default_rng(6).integers(0, 256, (H, W, 3)).astype(np.uint8)
    seg = np.random.default_rng(7).integers(0, 4, (H, W))
    seg[:3] = 255
    assert np.array_equal(tvis.overlay_2d_semantic(img.astype(np.float32), seg, 4, 0.4),
                          jvis.overlay_2d_semantic(img.astype(np.float32), seg, 4, 0.4))
    got, ref = _drawings(tviz2d, img, preds), _drawings(jviz2d, img, preds)
    for k in ref:
        assert got[k].dtype == np.uint8 and np.array_equal(got[k], ref[k]), k
