"""The port's data layer held against the JAX package on the CPU: preset
trees, PLY IO, camera records, the point -> pixel mapping, augmentations
and every field of the loader's scene batches, all exact; then Stage-2
evaluation of the loaded scenes, with the same predictions and summary."""

import dataclasses
import json
import logging
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu import config as jconfig
from geopurify_tpu.data import augment as jaug
from geopurify_tpu.data import cameras as jcams
from geopurify_tpu.data import loaders as jloaders
from geopurify_tpu.data import ply as jply
from geopurify_tpu.models.pipeline import GeoPurifyPipeline as JPipeline
from geopurify_tpu.ops import projection as jproj
from geopurify_tpu.ops import voxelize as jvox
from geopurify_tpu.run import validate as jvalidate
from geopurify_tpu.utils import visualization as jviz
from geopurify_tpu_torch import config as tconfig
from geopurify_tpu_torch.data import augment as taug
from geopurify_tpu_torch.data import cameras as tcams
from geopurify_tpu_torch.data import loaders as tloaders
from geopurify_tpu_torch.data import ply as tply
from geopurify_tpu_torch.models.pipeline import GeoPurifyPipeline as TPipeline
from geopurify_tpu_torch.ops import projection as tproj
from geopurify_tpu_torch.ops import voxelize as tvox
from geopurify_tpu_torch.run import validate as tvalidate
from geopurify_tpu_torch.utils import visualization as tviz
from geopurify_tpu_torch.utils.from_jax import student_from_jax, xdecoder_from_jax
from tests.test_data_pipeline import _make_matterport_scene_dir, _make_scannet_scene_dir
from tests.test_torch_port_pipeline import _randomize

PRESETS = ("scannet", "scannet200", "matterport", "matterport40", "matterport80",
           "matterport160", "tiny")


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_trees_equal(preset):
    assert (dataclasses.asdict(tconfig.load_config(preset))
            == dataclasses.asdict(jconfig.load_config(preset)))


def test_scene_lists_are_copies():
    from pathlib import Path

    jdir = Path(jloaders.__file__).parent.parent / "lists"
    tdir = Path(tloaders.__file__).parent.parent / "lists"
    names = sorted(p.name for p in jdir.glob("*.txt"))
    assert names == sorted(p.name for p in tdir.glob("*.txt")) and len(names) == 4
    for n in names:
        assert (jdir / n).read_bytes() == (tdir / n).read_bytes()


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(jply, tply), (tply, jply)])
def test_ply_round_trip_across_packages(tmp_path, rng, writer, reader):
    xyz = rng.normal(size=(300, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (300, 3)).astype(np.uint8)
    nrm = rng.normal(size=(300, 3)).astype(np.float32)
    p = str(tmp_path / "pts.ply")
    writer.write_ply_points(p, xyz, rgb, nrm)
    got, ref = reader.load_point_ply(p), writer.load_point_ply(p)
    assert got.keys() == ref.keys() == {"xyz", "rgb", "normal"}
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_array_equal(got["xyz"], xyz)


def test_ply_mesh_normals_and_ascii(tmp_path, rng):
    """A binary mesh with faces (face-area normals) and an ascii cloud."""
    n, nf = 50, 80
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    faces = rng.integers(0, n, (nf, 3)).astype(np.int32)
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {n}\nproperty float x\nproperty float y\nproperty float z\n"
            "property ushort label\n"
            f"element face {nf}\nproperty list uchar int vertex_indices\nend_header\n")
    labels = rng.integers(0, 20, n).astype("<u2")
    vert = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("l", "<u2")])
    vert["x"], vert["y"], vert["z"], vert["l"] = xyz[:, 0], xyz[:, 1], xyz[:, 2], labels
    face = np.empty(nf, dtype=[("c", "u1"), ("i", "<i4", (3,))])
    face["c"], face["i"] = 3, faces
    p = tmp_path / "mesh.ply"
    p.write_bytes(head.encode() + vert.tobytes() + face.tobytes())
    got, ref = tply.load_point_ply(str(p)), jply.load_point_ply(str(p))
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])
    a = tmp_path / "a.ply"
    a.write_text("ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\n"
                 "property float y\nproperty float z\nend_header\n0 1 2\n3 4 5\n")
    for k, v in tply.read_ply(str(a))["vertex"].items():
        np.testing.assert_array_equal(v, jply.read_ply(str(a))["vertex"][k])


@pytest.mark.parametrize("n_cls", [4, 19, 200])
def test_save_semantic_ply_byte_equal(tmp_path, rng, n_cls):
    pts = rng.normal(size=(400, 3)).astype(np.float32)
    labels = rng.integers(-1, n_cls, 400)
    valid = rng.uniform(size=400) < 0.9
    np.testing.assert_array_equal(tviz.class_palette(n_cls), jviz.class_palette(n_cls))
    tviz.save_semantic_ply(str(tmp_path / "t.ply"), pts, labels, num_classes=n_cls, valid=valid)
    jviz.save_semantic_ply(str(tmp_path / "j.ply"), pts, labels, num_classes=n_cls, valid=valid)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------

def _same_cameras(got, ref):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da.keys() == db.keys()
        for k in da:
            if isinstance(da[k], np.ndarray):
                np.testing.assert_array_equal(da[k], db[k])
            else:
                assert da[k] == db[k], k


def _write_colmap(d, rng):
    """sparse/0/{cameras,images}.bin: a PINHOLE and a SIMPLE_RADIAL camera,
    three images with a few 2D points each."""
    sp = d / "sparse" / "0"
    os.makedirs(sp)
    with open(sp / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ", 1, 1, 64, 48) + struct.pack("<4d", 50.0, 51.0, 32.0, 24.0))
        f.write(struct.pack("<iiQQ", 2, 2, 80, 60) + struct.pack("<4d", 70.0, 40.0, 30.0, 0.01))
    with open(sp / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 3))
        for iid, cid in ((3, 1), (1, 2), (2, 1)):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            t = rng.normal(size=3)
            f.write(struct.pack("<i7di", iid, *q, *t, cid))
            f.write(f"img_{iid}.png".encode() + b"\x00")
            npts = int(rng.integers(0, 4))
            f.write(struct.pack("<Q", npts))
            for _ in range(npts):
                f.write(struct.pack("<ddq", *rng.normal(size=2), int(rng.integers(-1, 9))))


def test_camera_records_equal(tmp_path, rng):
    d = _make_scannet_scene_dir(tmp_path / "s", n_frames=7, w=64, h=48)
    np.savetxt(os.path.join(d, "pose", "2.txt"), np.full((4, 4), np.inf))  # skipped
    for kw in (dict(frame_stride=2), dict(frame_stride=1, resolution_scale=2.0)):
        _same_cameras(tcams.load_scene_cameras(d, **kw), jcams.load_scene_cameras(d, **kw))
    m = _make_matterport_scene_dir(tmp_path / "m", n_frames=4)
    pts = rng.uniform(-1, 1, (200, 3))
    for kw in (dict(), dict(points=pts), dict(points=pts + 10.0)):   # bbox / nearest
        _same_cameras(tcams.load_scene_cameras(m, **kw), jcams.load_scene_cameras(m, **kw))
    b = tmp_path / "b"
    os.makedirs(b)
    frames = [{"file_path": f"r_{i}", "transform_matrix": (np.eye(4) + 0.1 * i).tolist()}
              for i in range(3)]
    (b / "transforms_train.json").write_text(json.dumps({"camera_angle_x": 0.8,
                                                         "frames": frames}))
    _same_cameras(tcams.load_scene_cameras(str(b)), jcams.load_scene_cameras(str(b)))
    c = tmp_path / "c"
    _write_colmap(c, rng)
    got = tcams.load_scene_cameras(str(c))
    _same_cameras(got, jcams.load_scene_cameras(str(c)))
    assert [x.uid for x in got] == ["img_1.png", "img_2.png", "img_3.png"]
    assert got[0].intrinsic[0, 0] == got[0].intrinsic[1, 1] == 70.0   # SIMPLE_RADIAL


# ---------------------------------------------------------------------------
# projection
# ---------------------------------------------------------------------------

def _view_setup(rng, n=4000, W=96, H=72):
    pts = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    ang = rng.uniform(-0.3, 0.3, 3)
    R = (jvox.Voxelizer._axis_rot(np.array([1.0, 0, 0]), ang[0])
         @ jvox.Voxelizer._axis_rot(np.array([0, 1.0, 0]), ang[1]))
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = [0.1, -0.2, 3.0]
    K = np.array([[60.0, 0, W / 2 - 0.5], [0, 61.0, H / 2 + 0.25], [0, 0, 1]])
    # a depth map that makes some points visible and hides the rest
    depth = rng.uniform(2.0, 4.5, (H, W))
    depth[rng.uniform(size=(H, W)) < 0.1] = 0.0
    return pts, w2c, K, depth, (W, H)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("with_depth", [True, False])
def test_loader_mapping_exact(rng, monkeypatch, native, with_depth):
    """``compute_mapping`` (f64, the points' device) against the JAX loader's
    ``compute_mapping_np``, through its g++ path and its numpy path."""
    from geopurify_tpu import native as jnative

    if native and not jnative.available():
        pytest.skip("the JAX package's native library is not built here")
    monkeypatch.setattr(jnative, "available", lambda: native)
    pts, w2c, K, depth, wh = _view_setup(rng)
    depth = depth if with_depth else None
    # the points' depth matches the map for a share of them: visible ones
    rows, cols, vis = jloaders.compute_mapping_np(pts, w2c, K, depth, wh, cut_bound=3,
                                                  vis_thres=0.3)
    got = tproj.compute_mapping(torch.from_numpy(pts).double(), w2c, K, depth, wh,
                                cut_bound=3, vis_thres=0.3)
    np.testing.assert_array_equal(got[2].numpy(), vis)
    np.testing.assert_array_equal(got[0].numpy(), rows)
    np.testing.assert_array_equal(got[1].numpy(), cols)
    assert 50 < vis.sum() < len(pts) - 50


def test_point_image_mapping_matches_jax(rng):
    """The ops-level mapping at the points' dtype (f32 here, as the JAX
    function runs), with a padding mask; pixel centres kept off the .5
    rounding ties, where the two f32 matmuls may round apart."""
    W, H = 96, 72
    n = 3000
    z = rng.choice([1.0, 2.0, 4.0], n)
    u = rng.integers(-5, W + 5, n) + rng.choice([0.25, 0.75], n)
    v = rng.integers(-5, H + 5, n) + rng.choice([0.25, 0.75], n)
    K = np.array([[64.0, 0, 48.0], [0, 32.0, 36.0], [0, 0, 1]])
    pts = np.stack([(u - 48.0) * z / 64.0, (v - 36.0) * z / 32.0, z], 1).astype(np.float32)
    pts[:100, 2] *= -1                      # behind the camera
    valid = rng.uniform(size=n) < 0.9
    depth = np.where(rng.uniform(size=(H, W)) < 0.5, 2.0, 1.0).astype(np.float32)
    for d in (depth, None):
        ref = jproj.compute_point_image_mapping(
            jnp.asarray(pts), jnp.asarray(valid), jnp.eye(4), jnp.asarray(K, jnp.float32),
            None if d is None else jnp.asarray(d), (W, H), cut_bound=2, vis_thres=0.05)
        got = tproj.compute_point_image_mapping(
            torch.from_numpy(pts), torch.from_numpy(valid), np.eye(4), K,
            None if d is None else torch.from_numpy(d), (W, H), cut_bound=2, vis_thres=0.05)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert 100 < int(got.visible.sum()) < n - 100
    np.testing.assert_array_equal(tproj.adjust_intrinsic_for_dim(K, (640, 480)),
                                  jproj.adjust_intrinsic_for_dim(K, (640, 480)))


# ---------------------------------------------------------------------------
# augmentation
# ---------------------------------------------------------------------------

def test_augmentations_exact_for_a_seed(rng):
    coords = rng.normal(size=(800, 3)).astype(np.float32) * 2
    feats = np.concatenate([rng.uniform(0, 255, (800, 3)), rng.normal(size=(800, 3))],
                           axis=1).astype(np.float32)
    labels = rng.integers(0, 5, 800).astype(np.int32)
    for seed in (3, 4):      # the random branches differ between the seeds
        got = taug.default_train_augmentations()(coords, feats, labels,
                                                 np.random.default_rng(seed))
        ref = jaug.default_train_augmentations()(coords, feats, labels,
                                                 np.random.default_rng(seed))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    rot = ((-np.pi / 64, np.pi / 64), (-np.pi / 64, np.pi / 64), (-np.pi, np.pi))
    for C in (6, 7):         # normals rotate only above 6 channels (as in JAX)
        f = rng.normal(size=(800, C)).astype(np.float32)
        out = [cls(voxel_size=0.05, use_augmentation=True, scale_augmentation_bound=(0.9, 1.1),
                   rotation_augmentation_bound=rot, rng=np.random.default_rng(C)
                   ).voxelize(coords, f, labels)
               for cls in (tvox.Voxelizer, jvox.Voxelizer)]
        for a, b in zip(*out):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the loader's scene batches
# ---------------------------------------------------------------------------

@pytest.fixture
def on_disk(tmp_path, rng):
    return write_on_disk(tmp_path, rng)


def write_on_disk(tmp_path, rng):
    """Three ScanNet-layout scenes: one with 3 views (the view bucket grows
    above max_views = 2), one with 6 (above max_views_eval = 4: the JAX
    loader's warning path), one with more points than max_points (512) and
    more voxels than max_voxels (384); cameras 3 m from the points, depth
    3 m. Returns (root, scene ids); ``list.txt`` names all three."""
    root3d, root2d = tmp_path / "3d", tmp_path / "2d"
    os.makedirs(root3d)
    os.makedirs(root2d)
    sids = []
    for i, (n_pts, n_frames) in enumerate(((400, 3), (450, 6), (700, 3))):
        sid = f"scene000{i}_00"
        xyz = rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
        if i < 2:
            xyz[:, 2] *= 0.2          # a slab: every point in the depth test's band
        torch.save((xyz, rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32),
                    rng.integers(0, 4, n_pts).astype(np.int64)),
                   root3d / f"{sid}_vh_clean_2.pth")
        d = _make_scannet_scene_dir(root2d / sid, n_frames=n_frames, w=64, h=48)
        os.rename(d, root2d / sid / "x")
        for sub in os.listdir(root2d / sid / "x"):
            os.rename(root2d / sid / "x" / sub, root2d / sid / sub)
        sids.append(sid)
    (tmp_path / "list.txt").write_text("\n".join(sids) + "\n")
    return tmp_path, sids


def loader_cfg(pkg, root, preset="tiny"):
    cfg = pkg.load_config(preset)
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(
            cfg.data, data_root=str(root / "3d"), data_root_2d=str(root / "2d"),
            train_scene_list=str(root / "list.txt"), eval_scene_list=str(root / "list.txt"),
            max_views=2, max_views_eval=4, max_voxels=384),
        fusion=dataclasses.replace(cfg.fusion, visibility_threshold=0.1),
    )


def _same_batch(got, ref):
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), np.array(getattr(ref, f.name))
        assert a.dtype == torch.from_numpy(b).dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f.name)


@pytest.mark.parametrize("split", ["val", "train"])
def test_scene_batches_equal(on_disk, monkeypatch, caplog, split):
    """Every SceneBatch field, for each scene, in the val split and in the
    seeded train split (augmentation, point and view subsampling, rotated
    and scaled voxels). The JAX loader dies with NameError on the scene
    above max_views_eval (its warning names an undefined ``log``); the test
    gives that module a logger to compare with it."""
    from geopurify_tpu import native as jnative

    root, sids = on_disk
    if split == "train":
        # augmented points are float64: the JAX loader's g++ mapping casts
        # them to float32, its numpy body (the port's semantics) does not
        monkeypatch.setattr(jnative, "available", lambda: False)
    tds = tloaders.SceneDataset(loader_cfg(tconfig, root), split=split, seed=5, device="cpu")
    jds = jloaders.SceneDataset(loader_cfg(jconfig, root), split=split, seed=5)
    if split == "val":
        with pytest.raises(NameError):
            jds.make_scene_batch(sids[1])
        jds = jloaders.SceneDataset(loader_cfg(jconfig, root), split=split, seed=5)
    monkeypatch.setattr(jloaders, "log", logging.getLogger("jax-loaders"), raising=False)
    n_views = []
    with caplog.at_level(logging.WARNING, logger="geopurify.loaders"):
        for sid in sids:
            got, ref = tds.make_scene_batch(sid), jds.make_scene_batch(sid)
            _same_batch(got, ref)
            n_views.append((got.view_valid.shape[0], int(got.view_valid.sum())))
    if split == "val":
        assert n_views == [(4, 3), (4, 4), (4, 3)], n_views
        assert "exceed max_views_eval=4" in caplog.text
    else:
        assert n_views == [(2, 2)] * 3, n_views
    assert int(got.point_valid.sum()) < len(got.point_valid)   # the voxel budget dropped points


# ---------------------------------------------------------------------------
# Stage-2 evaluation of the loaded scenes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_pair():
    """JAX and port pipelines at the ``tiny`` preset on the same seeded
    weights and text embeddings (the JAX tiny tokenizer's text is NaN, a
    fault of that package; both sides take these instead)."""
    jcfg, tcfg = jconfig.load_config("tiny"), tconfig.load_config("tiny")
    rng = np.random.default_rng(1)
    n_cls = len(tcfg.data.all_label)
    text = rng.normal(size=(n_cls + 1, tcfg.xdecoder.hidden_dim)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    jp = JPipeline(cfg=jcfg, teacher_params=None, text_embeddings=jnp.asarray(text),
                   logit_scale=jnp.float32(20.0))
    H, W = jcfg.xdecoder.mask_shape
    tshapes = jax.eval_shape(jp.xdecoder.init, jax.random.key(0), jnp.zeros((1, H, W, 3)),
                             jnp.asarray(text), jnp.float32(20.0))
    # scale 1 on this seed: several queries win, the points take two classes
    tparams = _randomize(tshapes, rng, 1.0)
    sshapes = jax.eval_shape(lambda k: jp.student.init(
        k, jnp.zeros((8, jcfg.student.input_dim)), jnp.full((8, 27), 8, jnp.int32),
        jnp.ones(8, bool), train=False), jax.random.key(0))
    svars = _randomize(sshapes, rng, 0.2)
    jp.teacher_params = jax.tree_util.tree_map(jnp.asarray, tparams)
    tp = TPipeline(tcfg, text, 20.0, teacher_state=xdecoder_from_jax(tparams),
                   student_state=student_from_jax(svars), device="cpu")
    return jcfg, jp, jax.tree_util.tree_map(jnp.asarray, svars), tcfg, tp


class _Preds:
    """Pass-through pipeline that keeps each scene's predictions."""

    def __init__(self, pipeline):
        self.pipeline, self.preds = pipeline, []

    def evaluate_scene(self, *args, **kw):
        out = self.pipeline.evaluate_scene(*args, **kw)
        self.preds.append(np.array(out["pred"]))
        return out


def _same_eval(tiny_pair, jscenes, tscenes, n_scenes):
    jcfg, jp, svars, tcfg, tp = tiny_pair
    jrec, trec = _Preds(jp), _Preds(tp)
    jmeter, _ = jvalidate.evaluate_scenes(jrec, svars, jscenes, jcfg)
    tmeter, times = tvalidate.evaluate_scenes(trec, tscenes, tcfg)
    assert len(trec.preds) == len(jrec.preds) == len(times) == n_scenes
    for a, b in zip(trec.preds, jrec.preds):
        np.testing.assert_array_equal(a, b)
    assert tmeter.summary() == jmeter.summary()
    np.testing.assert_array_equal(tmeter.per_class_iou(), jmeter.per_class_iou())
    assert len(np.unique(np.concatenate(trec.preds))) > 1   # not one class everywhere
    return tmeter


def test_evaluate_scenes_on_disk_matches_jax(tiny_pair, on_disk, monkeypatch):
    """Both loaders over the same on-disk ScanNet-layout scenes (one above
    ``max_views_eval``: the JAX loader gets a logger for its warning)."""
    root, sids = on_disk
    monkeypatch.setattr(jloaders, "log", logging.getLogger("jax-loaders"), raising=False)
    jds = jloaders.SceneDataset(loader_cfg(jconfig, root), split="val")
    tds = tloaders.SceneDataset(loader_cfg(tconfig, root), split="val", device="cpu")
    meter = _same_eval(tiny_pair, (b for _, b in jds.iter_scenes()),
                       (b for _, b in tds.iter_scenes()), len(sids))
    assert meter.target.sum() > 0
