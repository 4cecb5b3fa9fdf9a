"""The port's 2D dataset mappers held against the JAX package: every
mapper of data/mappers.py, on the inputs tests/test_mappers.py uses (and
a few more: the files route, panoptic with a semantic map, sentence
groundings, an eval-mode shape sampler of every kind), gives bit-equal
outputs in both packages under the same ``np.random.Generator`` draws,
with the properties that file checks. The tokenizers are the hash ones at
49408 ids, where both packages number SOT / EOT alike (a smaller
vocabulary is the JAX hash tokenizer's trap, ROADMAP Queue 3).
``hash(text)`` of a grounding matches because both run in one process.
``build_mapper`` builds the counterpart of every kind."""

import numpy as np
import pytest
from PIL import Image

from geopurify_tpu.data import mappers as JM
from geopurify_tpu.models.lang import HashTokenizer as JTok
from geopurify_tpu_torch.data import mappers as TM
from geopurify_tpu_torch.models.lang import HashTokenizer as TTok


def assert_same(got, want, path="out"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


def _image(h=48, w=64, seed=1):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8)


def _sem(h=48, w=64):
    sem = np.full((h, w), 255, np.uint8)
    sem[5:20, 5:30] = 2
    sem[25:45, 10:50] = 7
    sem[30:40, 52:60] = 11
    return sem


def _pan(h, w, segments):
    pan_id = np.zeros((h, w), np.int32)
    for (y0, y1, x0, x1), sid in segments:
        pan_id[y0:y1, x0:x1] = sid
    return JM.id2rgb(pan_id)


SQUARE = [8.0, 8.0, 24.0, 8.0, 24.0, 24.0, 8.0, 24.0]


def _instance_dd(h=48, w=48):
    arr = np.zeros((h, w), bool)
    arr[30:40, 30:44] = True
    return {"image_np": _image(h, w), "annotations": [
        {"segmentation": [SQUARE], "category_id": 1},
        {"segmentation": {"size": [h, w], "counts": [48 * 20 + 2, 12, 48 - 12]},
         "category_id": 2},
        {"segmentation": arr, "category_id": 3},
        {"segmentation": [SQUARE], "category_id": 9, "iscrowd": 1}]}


def _interactive_dd(sentences=False):
    h = w = 64
    dd = {"image_np": _image(h, w),
          "pan_seg_np": _pan(h, w, [((6, 30, 6, 34), 11), ((36, 60, 20, 56), 22),
                                    ((2, 5, 40, 60), 33)]),
          "segments_info": [{"id": 11, "category_id": 0, "iscrowd": 0},
                            {"id": 22, "category_id": 1, "iscrowd": 0},
                            {"id": 33, "category_id": 2, "iscrowd": 0}],
          "captions": ["a room with a chair"], "height": h, "width": w}
    if sentences:
        dd["grounding_info"] = [
            {"segmentation": [SQUARE], "sentences": [{"raw": "The Red Chair"},
                                                     {"raw": "a chair"}]},
            {"segmentation": [[30.0, 30.0, 50.0, 30.0, 50.0, 50.0]],
             "sentences": [{"raw": "A Table"}]}]
    return dd


def _refcoco_dd():
    return {"image_np": _image(48, 48), "height": 48, "width": 48, "grounding_info": [
        {"segmentation": [[4.0, 4.0, 20.0, 4.0, 20.0, 20.0, 4.0, 20.0]],
         "sentences": [{"raw": "The Red Chair"}, {"raw": "a chair"}], "bbox": [4, 4, 16, 16]},
        {"segmentation": [[24.0, 24.0, 40.0, 24.0, 40.0, 44.0]],
         "sentences": [{"raw": "Lamp"}]}]}


def _voc_dd():
    h = w = 48
    inst = np.zeros((h, w), np.uint8)
    inst[6:26, 6:30] = 1
    inst[30:46, 20:44] = 2
    inst[0:3, 0:3] = 255
    sem = np.zeros((h, w), np.uint8)
    sem[inst == 1] = 1
    sem[inst == 2] = 3
    return {"image_np": _image(h, w), "inst_np": inst, "semseg_np": sem, "objects_ids": [1, 2]}


# (name, mapper kwargs for each package (given the module), input dict, seed)
CASES = {
    "semantic": (lambda M: M.SemanticMapper(ignore_label=255, size_divisibility=64,
                                            min_sizes=(48,), max_size=1333),
                 lambda: {"image_np": _image(), "sem_seg_np": _sem()}, 0),
    "panoptic": (lambda M: M.PanopticMapper(min_sizes=(40, 48, 56), max_size=1333,
                                            size_divisibility=32),
                 lambda: {"image_np": _image(48, 48), "sem_seg_np": _sem(48, 48),
                          "pan_seg_np": _pan(48, 48, [((4, 20, 4, 24), 9001),
                                                      ((26, 44, 8, 40), 42)]),
                          "segments_info": [{"id": 9001, "category_id": 3, "iscrowd": 0},
                                            {"id": 42, "category_id": 5, "iscrowd": 0},
                                            {"id": 7, "category_id": 1, "iscrowd": 1}]}, 0),
    "panoptic_new_baseline": (lambda M: M.build_mapper(
        "coco_panoptic_new_baseline_dataset_mapper", image_size=32),
        lambda: {"image_np": _image(40, 72), "pan_seg_np": _pan(40, 72, [((8, 30, 10, 50), 1234)]),
                 "segments_info": [{"id": 1234, "category_id": 2, "iscrowd": 0}]}, 3),
    "instance": (lambda M: M.InstanceMapper(min_sizes=(48,), max_size=1333,
                                            size_divisibility=32), _instance_dd, 0),
    "interactive_class": (lambda M: M.InteractiveMapper(
        image_size=64, min_scale=0.5, max_scale=1.5, class_names=["wall", "chair-other", "lamp"],
        retrieval=True, tokenizer=(TTok if M is TM else JTok)(context_length=16)),
        _interactive_dd, 5),
    "interactive_sentences": (lambda M: M.InteractiveMapper(image_size=64, max_grounding_num=3),
                              lambda: _interactive_dd(sentences=True), 6),
    "refcoco_train": (lambda M: M.RefCOCOMapper(is_train=True, image_size=32), _refcoco_dd, 2),
    "refcoco_eval": (lambda M: M.RefCOCOMapper(is_train=False, min_size_test=40),
                     _refcoco_dd, 2),
    "vlp": (lambda M: M.VLPMapper(image_size=32, max_token_num=10,
                                  tokenizer=(TTok if M is TM else JTok)(context_length=12)),
            lambda: {"image_np": _image(40, 72), "captions": ["a photo of a room", "the kitchen"]},
            0),
    "eval_semseg": (lambda M: M.EvalSemSegMapper(min_size_test=20),
                    lambda: {"image_np": _image(40, 60), "sem_seg_np": _sem(40, 60)}, 0),
    "pano_eval": (lambda M: M.PanoEvalMapper(min_size_test=20),
                  lambda: {"image_np": _image(40, 60),
                           "pan_seg_np": _pan(40, 60, [((5, 20, 5, 30), 77)])}, 0),
    "imagenet": (lambda M: M.ImageNetMapper(size_crop=32, size_test=24),
                 lambda: {"image_np": _image(50, 80)}, 0),
    "pascalvoc_point": (lambda M: M.PascalVOCIXMapper(
        min_size_test=48, sampler_cfg=M.StrokeSamplerConfig(eval_mode="best"), mode="Point",
        class_names=["aeroplane", "bicycle", "bird"]), _voc_dd, 4),
    "pascalvoc_random": (lambda M: M.PascalVOCIXMapper(min_size_test=40), _voc_dd, 8),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_mapper_bit_equal_to_jaxs(name):
    build, make, seed = CASES[name]
    got = build(TM)(make(), np.random.default_rng(seed))
    want = build(JM)(make(), np.random.default_rng(seed))
    assert_same(got, want)
    if "instances" in got and "gt_boxes" in got["instances"]:
        for m, b in zip(got["instances"]["gt_masks"], got["instances"]["gt_boxes"]):
            ys, xs = np.nonzero(m)
            if len(xs):
                assert (xs >= b[0]).all() and (xs < b[2]).all()


def test_mapper_properties():
    out = CASES["semantic"][0](TM)(CASES["semantic"][1](), np.random.default_rng(0))
    assert out["image"].shape == (64, 64, 3) and set(out["instances"]["gt_classes"]) == {2, 7, 11}
    assert np.array_equal(out["instances"]["gt_masks"].any(0), out["sem_seg"] != 255)
    out = CASES["pascalvoc_point"][0](TM)(_voc_dd(), np.random.default_rng(4))
    assert (out["gt_masks_orisize"][:, 0:3, 0:3] == -1).all()
    assert out["classes"] == ["aeroplane.", "bird."]
    out = CASES["refcoco_eval"][0](TM)(_refcoco_dd(), np.random.default_rng(2))
    assert out["groundings"]["texts"][0] == ["the red chair", "a chair"]
    assert out["groundings"]["masks"].shape == (2, 48, 48)


def test_files_route_equal(tmp_path):
    Image.fromarray(_image(40, 60)).save(tmp_path / "img.png")
    Image.fromarray(_sem(40, 60)).save(tmp_path / "sem.png")
    dd = {"file_name": str(tmp_path / "img.png"), "sem_seg_file_name": str(tmp_path / "sem.png")}
    for kind in ("scannet_dataset_mapper", "mask_former_semantic_dataset_mapper"):
        kw = {"min_size_test": 20} if kind.startswith("scannet") else {"min_sizes": (40,)}
        assert_same(TM.build_mapper(kind, **kw)(dd, np.random.default_rng(1)),
                    JM.build_mapper(kind, **kw)(dd, np.random.default_rng(1)))


def test_build_mapper_kinds_match_jaxs():
    assert sorted(TM.MAPPER_KINDS) == sorted(JM.MAPPER_KINDS)
    for kind in TM.MAPPER_KINDS:
        t, j = TM.build_mapper(kind), JM.build_mapper(kind)
        assert type(t).__name__ == type(j).__name__, kind
        assert type(t).__module__ == "geopurify_tpu_torch.data.mappers"
    assert TM.build_mapper("coco_panoptic_new_baseline_dataset_mapper").mode == "new_baseline"
    with pytest.raises(KeyError, match="unknown mapper kind"):
        TM.build_mapper("no_such_mapper")
