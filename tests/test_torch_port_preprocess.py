"""The port's ``geopurify-torch-preprocess`` held against the JAX package's
``geopurify-preprocess``: each of the eight subcommands runs in both
packages, in this process, on the raw fixtures tests/test_preprocess.py
writes, and their output trees must be equal file for file: ``.pth``
tuples array-equal (dtypes too), every other file (JPEG / PNG images,
16-bit depth PNGs, pose, intrinsics and ``.npy`` files) byte-equal and,
for images, equal once decoded. JPEG bytes depend on the PIL build, which
is why both packages write in one process. Then the port's preprocessed
ScanNet reads back through the port's ``SceneDataset`` into the batch the
JAX chain (JAX preprocess, JAX loader) gives."""

import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from geopurify_tpu import config as jconfig
from geopurify_tpu.data import loaders as jloaders
from geopurify_tpu.data import preprocess as jpp
from geopurify_tpu_torch import config as tconfig
from geopurify_tpu_torch.data import loaders as tloaders
from geopurify_tpu_torch.data import preprocess as tpp
from tests.test_preprocess import write_sens, write_vertex_ply
from tests.test_torch_port_data import _same_batch


def _files(root: Path):
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file())


def assert_trees_equal(got: Path, want: Path):
    names = _files(want)
    assert names and _files(got) == names
    for name in names:
        a, b = got / name, want / name
        if name.endswith(".pth"):
            ta = torch.load(a, weights_only=False)
            tb = torch.load(b, weights_only=False)
            assert type(ta) is type(tb) and len(ta) == len(tb), name
            for x, y in zip(ta, tb):
                if isinstance(y, np.ndarray):
                    assert x.dtype == y.dtype and x.shape == y.shape, name
                    np.testing.assert_array_equal(x, y, err_msg=name)
                else:
                    assert x == y, name
            continue
        assert a.read_bytes() == b.read_bytes(), name
        if name.endswith((".jpg", ".png")):
            np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))


def run_both(tmp_path, argv):
    """``argv`` with ``{out}`` for the output directory, through both CLIs."""
    outs = []
    for tag, mod in (("port", tpp), ("jax", jpp)):
        out = tmp_path / f"out_{tag}"
        mod.main([a.replace("{out}", str(out)) for a in argv] + ["--workers", "1"])
        outs.append(out)
    assert_trees_equal(*outs)
    return outs[0]


def _scannet_scans(tmp_path, rng, sid="scene0000_00", n=300, frames=5, H=24, W=32,
                   label_images=False):
    scans = tmp_path / "scans" / sid
    scans.mkdir(parents=True)
    xyz = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(2.0, 4.0, n)
    rgb = rng.integers(0, 255, (n, 3))
    labels = rng.choice([1, 2, 4, 13, 39], n)
    write_vertex_ply(scans / f"{sid}_vh_clean_2.ply", xyz, rgb)
    write_vertex_ply(scans / f"{sid}_vh_clean_2.labels.ply", xyz, labels=labels)
    poses = [np.eye(4, dtype=np.float32) for _ in range(frames)]
    for i, p in enumerate(poses):
        p[0, 3] = 0.1 * i
    colors = [rng.integers(0, 255, (H, W, 3), dtype=np.uint8) for _ in range(frames)]
    depths = [rng.integers(100, 4000, (H, W), dtype=np.uint16) for _ in range(frames)]
    write_sens(scans / f"{sid}.sens", poses, colors, depths)
    if label_images:
        (scans / "label-filt").mkdir()
        for i in range(frames):
            Image.fromarray(rng.integers(0, 8, (H, W), dtype=np.uint8)).save(
                scans / "label-filt" / f"{i}.png")
    return tmp_path / "scans", (poses, colors, depths)


def test_scannet_3d(tmp_path, rng):
    scans, _ = _scannet_scans(tmp_path, rng)
    _scannet_scans(tmp_path, rng, sid="scene0001_00", n=200)
    out = run_both(tmp_path, ["scannet-3d", "--scans", str(scans), "--out", "{out}"])
    # the same files from two spawned workers
    tpp.main(["scannet-3d", "--scans", str(scans), "--out", str(tmp_path / "pool"),
              "--workers", "2"])
    assert_trees_equal(tmp_path / "pool", out)
    coords, colors, labels = torch.load(out / "scene0000_00_vh_clean_2.pth", weights_only=False)
    assert coords.dtype == colors.dtype == labels.dtype == np.float64
    assert set(np.unique(labels)) <= {0.0, 1.0, 3.0, 19.0, 255.0} and (labels == 255).any()


def test_sens_reader_and_scannet_2d(tmp_path, rng):
    scans, (poses, colors, depths) = _scannet_scans(tmp_path, rng, label_images=True)
    sens = str(scans / "scene0000_00" / "scene0000_00.sens")
    t, j = tpp.SensReader(sens), jpp.SensReader(sens)
    for attr in ("sensor_name", "color_compression", "depth_compression", "color_width",
                 "color_height", "depth_width", "depth_height", "depth_shift", "num_frames"):
        assert getattr(t, attr) == getattr(j, attr), attr
    for attr in ("intrinsic_color", "extrinsic_color", "intrinsic_depth", "extrinsic_depth"):
        np.testing.assert_array_equal(getattr(t, attr), getattr(j, attr))
    for i, ((tp, tc, td), (jp, jc, jd)) in enumerate(zip(t.frames(), j.frames())):
        np.testing.assert_array_equal(tp, poses[i])
        np.testing.assert_array_equal(t.decode_depth(td), depths[i])
        np.testing.assert_array_equal(t.decode_color(tc), j.decode_color(jc))
        assert (tc, td) == (jc, jd)
    t.close()
    j.close()
    tsv = tmp_path / "labels.tsv"
    tsv.write_text("id\tnyu40id\tcategory\n1\t5\ta\n2\t39\tb\n3\tx\tc\n5\t22\td\n")
    assert tpp.read_label_tsv(str(tsv)) == jpp.read_label_tsv(str(tsv)) == {1: 5, 2: 39, 5: 22}
    out = run_both(tmp_path, ["scannet-2d", "--scans", str(scans), "--out", "{out}",
                              "--frame-skip", "2", "--width", "16", "--height", "12",
                              "--label-map", str(tsv)])
    base = out / "scene0000_00"
    assert sorted(os.listdir(base / "color")) == ["0.jpg", "2.jpg", "4.jpg"]
    assert sorted(os.listdir(base / "label")) == ["0.png", "2.png", "4.png"]
    d = np.asarray(Image.open(base / "depth" / "0.png"))
    assert d.shape == (12, 16) and np.isin(d, depths[0]).all()


def test_scannet_2d_defaults(tmp_path, rng):
    """The subcommand's own defaults: every 20th frame at 320x240."""
    scans, _ = _scannet_scans(tmp_path, rng, frames=21, H=48, W=64)
    out = run_both(tmp_path, ["scannet-2d", "--scans", str(scans), "--out", "{out}"])
    assert sorted(os.listdir(out / "scene0000_00" / "color")) == ["0.jpg", "20.jpg"]
    assert np.asarray(Image.open(out / "scene0000_00" / "color" / "0.jpg")).shape == (240, 320, 3)


def test_intrinsics_and_remaps_equal():
    np.testing.assert_array_equal(tpp.scannet20_remapper(), jpp.scannet20_remapper())
    np.testing.assert_array_equal(tpp.matterport_class_remap(), jpp.matterport_class_remap())
    np.testing.assert_array_equal(tpp.nuscenes_class_remap(), jpp.nuscenes_class_remap())
    K = tpp.make_intrinsic(577.870605, 577.870605, 319.5, 239.5)
    np.testing.assert_array_equal(K, jpp.make_intrinsic(577.870605, 577.870605, 319.5, 239.5))
    for dims in (((640, 480), (320, 240)), ((1280, 1024), (640, 512)), ((640, 480), (640, 480))):
        np.testing.assert_array_equal(tpp.adjust_intrinsic(K, *dims), jpp.adjust_intrinsic(K, *dims))
    img = np.arange(7 * 9 * 3).reshape(7, 9, 3)
    np.testing.assert_array_equal(tpp._resize_nearest(img, (4, 5)), jpp._resize_nearest(img, (4, 5)))


def test_matterport_3d(tmp_path, rng):
    region_dir = tmp_path / "scans" / "sceneA" / "region_segmentations"
    region_dir.mkdir(parents=True)
    tsv = tmp_path / "category_mapping.tsv"
    tsv.write_text("index\tcategory\tnyu40id\n1\twall\t1\n2\tceiling\t22\n3\tmisc\t40\n"
                   "4\tchair\t5\n5\tbad\t\n")
    np.testing.assert_array_equal(tpp.read_category_mapping(str(tsv)),
                                  jpp.read_category_mapping(str(tsv)))
    for r in range(2):
        n = 40
        xyz = rng.uniform(0, 3, (n, 3)).astype(np.float32)
        faces = rng.integers(0, n, (60, 3))
        cat = rng.integers(-1, 6, 60)
        write_vertex_ply(region_dir / f"region{r}.ply", xyz, rng.integers(0, 255, (n, 3)),
                         faces=faces, face_extra={"category_id": cat})
    out = run_both(tmp_path, ["matterport-3d", "--scans", str(tmp_path / "scans"),
                              "--out", "{out}", "--category-mapping", str(tsv)])
    coords, colors, normal, labels = torch.load(out / "sceneA_region1.pth", weights_only=False)
    assert normal.shape == (40, 3) and labels.dtype == np.int64


def test_matterport_2d(tmp_path, rng):
    scene = tmp_path / "scans" / "S1"
    for sub in ("undistorted_camera_parameters", "undistorted_color_images",
                "undistorted_depth_images"):
        (scene / sub).mkdir(parents=True)
    pose = np.eye(4)
    pose[0, 3] = 1.0
    pose[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    lines = ["intrinsics_matrix 100 0 32  0 100 24  0 0 1"]
    for yaw in range(6):
        if yaw == 3:
            lines.append("intrinsics_matrix 90 0 30  0 95 22  0 0 1")
        vals = " ".join(str(v) for v in pose.reshape(-1))
        lines.append(f"scan depth_x pano_i0_{yaw}.jpg {vals}")
    conf = scene / "undistorted_camera_parameters" / "S1.conf"
    conf.write_text("\n".join(lines) + "\n")
    for yaw in range(6):
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(
            scene / "undistorted_color_images" / f"pano_i0_{yaw}.jpg")
        if yaw != 2:
            Image.fromarray(rng.integers(0, 8000, (48, 64), dtype=np.uint16), mode="I;16").save(
                scene / "undistorted_depth_images" / f"pano_d0_{yaw}.png")
    # an image the conf does not name is skipped by both
    Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(
        scene / "undistorted_color_images" / "other_i1_0.jpg")
    for got, want in zip(tpp.parse_matterport_conf(str(conf)), jpp.parse_matterport_conf(str(conf))):
        np.testing.assert_array_equal(got, want)
    out = run_both(tmp_path, ["matterport-2d", "--scans", str(tmp_path / "scans"),
                              "--out", "{out}", "--width", "32", "--height", "24"])
    assert len(os.listdir(out / "S1" / "color")) == 6
    assert len(os.listdir(out / "S1" / "depth")) == 5


def test_nuscenes_3d(tmp_path, rng):
    for i, n in enumerate((60, 45)):
        scans = tmp_path / "nusc" / f"scene-000{i}"
        scans.mkdir(parents=True)
        raw = rng.integers(0, 32, n)
        write_vertex_ply(scans / "scene.ply", rng.uniform(-30, 30, (n, 3)), labels=raw)
        np.save(scans / "scene-timestamps.npy", rng.integers(0, 3, (n, 1)))
    for extra in ([], ["--annotated-only"]):
        out = run_both(tmp_path / str(len(extra)), ["nuscenes-3d", "--scans",
                                                    str(tmp_path / "nusc"), "--out", "{out}",
                                                    *extra])
    coords, zero, lab = torch.load(out / "scene-0000.pth", weights_only=False)
    assert zero == 0 and len(coords) < 60


def test_nuscenes_2d(tmp_path, rng):
    root = tmp_path / "nusc2d" / "scene-0001" / "frames"
    for ts in ("0000000100", "0000000123"):
        for cam in tpp.NUSCENES_CAM_LOCS:
            d = root / ts / cam
            d.mkdir(parents=True)
            if cam == "back_left":
                continue            # a camera without its image: skipped by both
            Image.fromarray(rng.integers(0, 255, (90, 160, 3), dtype=np.uint8)).save(
                d / "color_image.jpg")
            np.savetxt(d / "cam2scene.txt", np.eye(4) + rng.normal(size=(4, 4)) * 0.01)
            K = np.eye(3)
            K[0, 0] = K[1, 1] = 1266.4
            K[0, 2], K[1, 2] = 800.0, 450.0
            np.savetxt(d / "K.txt", K)
    out = run_both(tmp_path, ["nuscenes-2d", "--scans", str(tmp_path / "nusc2d"),
                              "--out", "{out}", "--width", "80", "--height", "45"])
    assert len(os.listdir(out / "scene-0001" / "color")) == 5


def test_replica_3d_and_2d(tmp_path, rng):
    raw = tmp_path / "replica"
    (raw / "room0" / "results").mkdir(parents=True)
    write_vertex_ply(raw / "room0_mesh.ply", rng.uniform(0, 5, (40, 3)),
                     rgb=rng.integers(0, 255, (40, 3)))
    run_both(tmp_path / "a", ["replica-3d", "--scans", str(raw), "--out", "{out}"])
    np.savetxt(raw / "room0" / "traj.txt", rng.normal(size=(6, 16)))
    for i in range(6):
        Image.fromarray(rng.integers(0, 255, (68, 120, 3), dtype=np.uint8)).save(
            raw / "room0" / "results" / f"frame{i:05d}.jpg")
        Image.fromarray(rng.integers(0, 5000, (68, 120), dtype=np.uint16).astype(np.int32),
                        mode="I").save(raw / "room0" / "results" / f"depth{i:05d}.png")
    out = run_both(tmp_path / "b", ["replica-2d", "--scans", str(raw), "--out", "{out}",
                                    "--sample-freq", "2", "--width", "64", "--height", "36"])
    assert sorted(os.listdir(out / "room0" / "color")) == ["0.jpg", "1.jpg", "2.jpg"]


def test_preprocessed_scannet_reads_back_as_jaxs_chain(tmp_path, rng):
    """raw -> preprocess 3d + 2d in each package -> each package's
    SceneDataset: every SceneBatch field equal."""
    sid = "scene0002_00"
    scans = tmp_path / "scans" / sid
    scans.mkdir(parents=True)
    n = 400
    xyz = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(2.0, 4.0, n)
    write_vertex_ply(scans / f"{sid}_vh_clean_2.ply", xyz, rng.integers(0, 255, (n, 3)))
    write_vertex_ply(scans / f"{sid}_vh_clean_2.labels.ply", xyz,
                     labels=rng.choice([1, 2, 4, 39], n))
    H, W = 24, 32
    write_sens(scans / f"{sid}.sens", [np.eye(4, dtype=np.float32)] * 2,
               [rng.integers(0, 255, (H, W, 3), dtype=np.uint8) for _ in range(2)],
               [np.full((H, W), 3000, np.uint16)] * 2)
    batches = []
    for tag, pp, cfg_mod, loaders, kw in (("port", tpp, tconfig, tloaders, {"device": "cpu"}),
                                          ("jax", jpp, jconfig, jloaders, {})):
        out3d, out2d = tmp_path / tag / "3d", tmp_path / tag / "2d"
        pp.main(["scannet-3d", "--scans", str(tmp_path / "scans"), "--out", str(out3d),
                 "--workers", "1"])
        pp.main(["scannet-2d", "--scans", str(tmp_path / "scans"), "--out", str(out2d),
                 "--frame-skip", "1", "--width", str(W), "--height", str(H), "--workers", "1"])
        (out2d / sid / "intrinsic").mkdir()
        K = np.eye(4)
        K[0, 0] = K[1, 1] = 50.0
        K[0, 2], K[1, 2] = W / 2, H / 2
        np.savetxt(out2d / sid / "intrinsic" / "intrinsic_color.txt", K)
        (out3d / "list.txt").write_text(sid + "\n")
        cfg = cfg_mod.load_config("tiny")
        cfg = dataclasses.replace(
            cfg,
            data=dataclasses.replace(cfg.data, data_root=str(out3d), data_root_2d=str(out2d),
                                     train_scene_list="list.txt", eval_scene_list="list.txt",
                                     max_points=512, max_voxels=512, max_views=2),
            fusion=dataclasses.replace(cfg.fusion, img_dim=(W, H), frame_stride=1,
                                       resolution_scale=1.0, min_visible_points=1,
                                       cut_boundary=0))
        ds = loaders.SceneDataset(cfg, split="val", **kw)
        batches.append(ds.make_scene_batch(sid))
    got, want = batches
    _same_batch(got, want)
    assert int(got.point_valid.sum()) == n and int(got.view_valid.sum()) == 2
    assert int(got.view_point_valid.sum()) > 0
