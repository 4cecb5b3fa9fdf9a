"""The 2D trainer's data layer held against the JAX package on the CPU: bit
for bit from one numpy seed.

The synthetic batches of every task (``synthetic_batch``,
``synthetic_captions``, ``synthetic_interactive_scene`` / ``_batch``),
``Seg2DDataset.batches`` over COCO json (polygons, uncompressed RLE and
compressed RLE, written here with COCO's published string encoder) and
over the folder layout, ``CaptionDataset.batches`` over both caption
layouts, and the three mappers the trainer reaches (``PanopticMapper`` in
both modes, ``InteractiveMapper`` with class and sentence groundings,
``VLPMapper``). ``InteractiveMapper`` stores Python's ``hash`` of each
grounding text, randomised per process: equal here because both run in
this one."""

import json

import jax
import numpy as np
import pytest
from PIL import Image

from geopurify_tpu.data import joint_loader as jjl
from geopurify_tpu.data import mappers as jmap
from geopurify_tpu.data import seg2d as jseg
from geopurify_tpu.models import lang as jlang
from geopurify_tpu.run import train2d as jtrain
from geopurify_tpu_torch.data import joint_loader as tjl
from geopurify_tpu_torch.data import mappers as tmap
from geopurify_tpu_torch.data import seg2d as tseg
from geopurify_tpu_torch.models import lang as tlang
from geopurify_tpu_torch.run import train2d as ttrain


def same(a, b, where=""):
    """Nested outputs equal: arrays bit for bit (dtype and shape too)."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif hasattr(a, "shape") or hasattr(b, "shape"):
        a = a.numpy() if hasattr(a, "numpy") and not isinstance(a, np.ndarray) else np.asarray(a)
        # a JAX array holds 64-bit numpy data at 32 bits (x64 off)
        dtype = jax.dtypes.canonicalize_dtype(a.dtype) if isinstance(b, jax.Array) else a.dtype
        b = np.asarray(b)
        assert dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


def test_synthetic_batches_equal():
    for fn, args in (("synthetic_batch", ((2, (64, 96), 5))),
                     ("synthetic_captions", ((3, 16, 512)))):
        same(getattr(ttrain, fn)(np.random.default_rng(3), *args),
             getattr(jtrain, fn)(np.random.default_rng(3), *args), fn)
    same(ttrain.synthetic_interactive_scene(np.random.default_rng(4), (64, 64), 3),
         jtrain.synthetic_interactive_scene(np.random.default_rng(4), (64, 64), 3))


@pytest.mark.parametrize("grounding", [False, True])
def test_synthetic_interactive_batch_equal(grounding):
    """The mapper-driven interactive batch (jitter, the visual sampler's
    prompts, the prompt points), two images."""
    def batch(mod_map, mod_train, mod_vs):
        mapper = mod_map.InteractiveMapper(
            image_size=64, min_scale=0.9, max_scale=1.1, grounding=grounding,
            sampler_cfg=mod_vs.StrokeSamplerConfig(max_candidate=2))
        return mod_train.synthetic_interactive_batch(np.random.default_rng(5), mapper, 2,
                                                     (64, 64), 3, 2, 16)

    from geopurify_tpu.data import visual_sampler as jvs
    from geopurify_tpu_torch.data import visual_sampler as tvs

    same(batch(tmap, ttrain, tvs), batch(jmap, jtrain, jvs))


def rle_string(counts):
    """COCO's compressed RLE string of run lengths (maskApi rleToString)."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if c & 0x10 else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def rle_counts(mask):
    """Uncompressed COCO RLE run lengths (column-major, starting with 0s)."""
    flat = mask.reshape(-1, order="F").astype(np.int8)
    edges = np.flatnonzero(np.diff(np.concatenate([[0], flat, [1 - flat[-1]]])))
    runs = np.diff(np.concatenate([[0], edges])).tolist()
    return runs if len(runs) and flat[0] == 0 else [0] + runs


def write_coco(root, rng, n_images=3):
    (root / "imgs").mkdir(parents=True)
    images, anns = [], []
    for i in range(n_images):
        h, w = 40 + 8 * i, 56 - 4 * i
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            root / "imgs" / f"{i}.png")
        images.append({"id": 10 + i, "file_name": f"imgs/{i}.png", "height": h, "width": w})
        for k in range(3):
            m = np.zeros((h, w), bool)
            y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
            m[y0: y0 + rng.integers(4, h // 2), x0: x0 + rng.integers(4, w // 2)] = True
            if k == 0:
                ys, xs = np.nonzero(m)
                seg = [[float(xs.min()), float(ys.min()), float(xs.max()), float(ys.min()),
                        float(xs.max()), float(ys.max()) - 2.5, float(xs.min()), float(ys.max())]]
            elif k == 1:
                seg = {"size": [h, w], "counts": rle_counts(m)}
            else:
                seg = {"size": [h, w], "counts": rle_string(rle_counts(m))}
            anns.append({"id": len(anns), "image_id": 10 + i, "category_id": int(7 + k % 2),
                         "segmentation": seg})
    cats = [{"id": 8, "name": "chair"}, {"id": 7, "name": "wall"}]
    (root / "annotations.json").write_text(json.dumps(
        {"images": images, "annotations": anns, "categories": cats}))


def write_folder(root, rng, n_images=3):
    (root / "images").mkdir(parents=True)
    for i in range(n_images):
        h, w = 48, 40 + 8 * i
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            root / "images" / f"im{i}.png")
        (root / "masks" / f"im{i}").mkdir(parents=True)
        for k in range(2 + i % 2):
            m = np.zeros((h, w), np.uint8)
            m[rng.integers(0, h // 2):, rng.integers(0, w // 2): w - 3] = 255
            Image.fromarray(m).save(root / "masks" / f"im{i}" / f"{k % 3}_{k}.png")
    (root / "classes.txt").write_text("wall\nfloor\nchair\n")


def test_rle_string_decodes():
    """The test's encoder against the decoder of both packages."""
    rng = np.random.default_rng(0)
    m = rng.random((13, 9)) < 0.4
    counts = rle_counts(m)
    for mod in (jseg, tseg):
        assert mod._decode_rle_string(rle_string(counts)) == counts
        assert np.array_equal(mod._rle_to_mask({"size": [13, 9], "counts": counts}, (13, 9)), m)


@pytest.mark.parametrize("layout", ["coco", "folder"])
def test_seg2d_batches_equal(layout, tmp_path):
    """Four batches of two (past the end of the shuffled order), images
    resized, stride-4 masks, three targets a batch row."""
    rng = np.random.default_rng(1)
    (write_coco if layout == "coco" else write_folder)(tmp_path, rng)
    tds, jds = tseg.Seg2DDataset(str(tmp_path)), jseg.Seg2DDataset(str(tmp_path))
    assert tds.mode == jds.mode == layout and tds.class_names == jds.class_names
    it_t = tds.batches(2, (32, 48), max_targets=3, seed=2)
    it_j = jds.batches(2, (32, 48), max_targets=3, seed=2)
    for _ in range(4):
        bt, bj = next(it_t), next(it_j)
        same(bt, bj)
    assert bt[3].any()
    for i in range(len(tds)):
        same(tds.sample(i), jds.sample(i))


@pytest.mark.parametrize("layout", ["list", "mapping"])
def test_caption_batches_equal(layout, tmp_path):
    rng = np.random.default_rng(6)
    (tmp_path / "images").mkdir()
    records = []
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (30 + 4 * i, 44, 3), dtype=np.uint8)).save(
            tmp_path / "images" / f"c{i}.png")
        records.append({"file_name": f"c{i}.png",
                        "captions": [f"a photo of thing {i}", "another caption"]})
    data = records if layout == "list" else {r["file_name"]: r["captions"] for r in records}
    (tmp_path / "captions.json").write_text(json.dumps(data))
    it_t = tjl.CaptionDataset(str(tmp_path)).batches(
        2, (32, 32), tlang.HashTokenizer(512, 16), 12, seed=3)
    it_j = jjl.CaptionDataset(str(tmp_path)).batches(
        2, (32, 32), jlang.HashTokenizer(512, 16), 12, seed=3)
    for _ in range(3):
        same(next(it_t), next(it_j))
    zipped = tjl.JointLoader({"a": iter([1, 2]), "b": iter("xy")})
    assert next(zipped) == {"a": 1, "b": "x"}


def panoptic_dict(rng, hw=(48, 64)):
    return ttrain.synthetic_interactive_scene(rng, hw, 5)


@pytest.mark.parametrize("mode", ["mask_former", "new_baseline"])
def test_panoptic_mapper_equal(mode):
    kw = dict(mode=mode, image_size=40, size_divisibility=32, min_sizes=(32, 48),
              max_size=80)
    for seed in range(3):
        dd = panoptic_dict(np.random.default_rng(seed))
        dd["sem_seg_np"] = np.random.default_rng(seed).integers(0, 4, dd["pan_seg_np"].shape[:2])
        same(tmap.PanopticMapper(**kw)(dd, np.random.default_rng(9)),
             jmap.PanopticMapper(**kw)(dd, np.random.default_rng(9)), f"{mode} {seed}")


@pytest.mark.parametrize("grounding", ["class", "sentence"])
def test_interactive_mapper_equal(grounding):
    """Spatial prompts from the visual sampler and the groundings (the
    texts' ``hash``, per process, equal within this one)."""
    for seed in range(3):
        dd = panoptic_dict(np.random.default_rng(seed))
        if grounding == "sentence":
            m = np.zeros((48, 64), np.uint8)
            m[5:30, 8:40] = 1
            dd["grounding_info"] = [
                {"segmentation": m, "sentences": [{"raw": "The Left Box"}, {"raw": "a box"}]},
                {"segmentation": 1 - m, "sentences": [{"raw": "Everything Else"}]}]
        kw = dict(image_size=40, class_names=[f"n{i}-other" for i in range(5)],
                  max_grounding_num=3)
        got = tmap.InteractiveMapper(**kw)(dd, np.random.default_rng(11))
        want = jmap.InteractiveMapper(**kw)(dd, np.random.default_rng(11))
        same(got, want, f"{grounding} {seed}")
        assert got["groundings"]["mode"] == ("text" if grounding == "sentence" else "class")


def test_vlp_mapper_equal():
    rng = np.random.default_rng(12)
    dd = {"image_np": rng.integers(0, 256, (30, 50, 3), dtype=np.uint8),
          "captions": ["two dogs on a sofa", "a room"]}
    same(tmap.VLPMapper(32, tlang.HashTokenizer(512, 16), max_token_num=10)(dd, rng),
         jmap.VLPMapper(32, jlang.HashTokenizer(512, 16), max_token_num=10)(
             dd, np.random.default_rng(12)))


def test_label_codec_round_trips():
    ids = np.random.default_rng(0).integers(0, 1 << 24, (5, 7))
    assert np.array_equal(tmap.rgb2id(tmap.id2rgb(ids)), ids)
    same(tmap.id2rgb(ids), jmap.id2rgb(ids))
