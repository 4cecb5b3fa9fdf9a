"""Raw-data preprocessing: raw ScanNet / Matterport / nuScenes / Replica
captures -> the ``.pth`` scenes and 2D frame directories that
``data/loaders.SceneDataset`` reads (``geopurify-torch-preprocess``).

Port of geopurify_tpu/data/preprocess.py, with its eight subcommands,
flags and defaults:
- ``scannet-3d``: ``*_vh_clean_2.ply`` + ``.labels.ply`` -> (coords,
  colours in [-1, 1], NYU40 -> ScanNet-20 labels) tuples;
- ``scannet-2d``: ``.sens`` v4 streams (JPEG colour, zlib depth) -> every
  N-th colour JPEG, 16-bit depth PNG and pose txt, one resized
  intrinsics.txt, optional label-image remap through the label tsv;
- ``matterport-3d``: region PLYs with per-face categories -> per-vertex
  majority labels and face-area-weighted normals;
- ``matterport-2d``: undistorted colour / depth + ``.conf`` cameras ->
  resized images, poses (y / z columns flipped) and adjusted intrinsics;
- ``nuscenes-3d`` / ``nuscenes-2d``, ``replica-3d`` / ``replica-2d``.

Host only: numpy and PIL, ``torch.save`` for the loader's ``.pth`` files
(plain numpy tuples, as the JAX module writes them). Nothing here touches
CUDA, and ``_parallel_map`` spawns its workers, so a caller that has
initialised the card can run it. Meshes are read through the port's
``data/ply.py``.
"""

from __future__ import annotations

import argparse
import csv
import glob
import logging
import os
import struct
import sys
import zlib
from functools import partial
from io import BytesIO
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger("geopurify.preprocess")

# NYU40 ids kept for ScanNet-20 (preprocess_3d_scannet.py:8-10); order defines
# the contiguous train ids 0..19, everything else -> 255.
SCANNET20_NYU40_IDS = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39
)
# Matterport adds ceiling (nyu40 id 22) as class 20 (preprocess_3d_matterport.py:28-56).
MATTERPORT_NYU40_IDS = SCANNET20_NYU40_IDS + (22,)


# geopurify_tpu/data/preprocess.py:50
def scannet20_remapper() -> np.ndarray:
    remap = np.full(150, 255, np.float64)
    for i, x in enumerate(SCANNET20_NYU40_IDS):
        remap[x] = i
    return remap


# geopurify_tpu/data/preprocess.py:57
def matterport_class_remap() -> np.ndarray:
    """nyu40 id -> 1-based matterport-21 id (0 = unlabeled); the final vertex
    labels subtract 1 so unlabeled becomes 255 (preprocess_3d_matterport.py:28-56,91-94)."""
    remap = np.zeros(41, np.int64)
    for i, x in enumerate(SCANNET20_NYU40_IDS):
        remap[x] = i + 1
    remap[22] = 21
    return remap


# geopurify_tpu/data/preprocess.py:67
def make_intrinsic(fx: float, fy: float, mx: float, my: float) -> np.ndarray:
    intr = np.eye(4)
    intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2] = fx, fy, mx, my
    return intr


# geopurify_tpu/data/preprocess.py:73
def adjust_intrinsic(
    intrinsic: np.ndarray,
    intrinsic_image_dim: Tuple[int, int],
    image_dim: Tuple[int, int],
) -> np.ndarray:
    """Rescale intrinsics for a resized image (preprocess_util.py:14-25);
    dims are (W, H)."""
    if tuple(intrinsic_image_dim) == tuple(image_dim):
        return intrinsic
    intrinsic = intrinsic.copy()
    resize_width = int(
        np.floor(image_dim[1] * float(intrinsic_image_dim[0]) / intrinsic_image_dim[1])
    )
    intrinsic[0, 0] *= float(resize_width) / intrinsic_image_dim[0]
    intrinsic[1, 1] *= float(image_dim[1]) / intrinsic_image_dim[1]
    intrinsic[0, 2] *= float(image_dim[0] - 1) / (intrinsic_image_dim[0] - 1)
    intrinsic[1, 2] *= float(image_dim[1] - 1) / (intrinsic_image_dim[1] - 1)
    return intrinsic


# geopurify_tpu/data/preprocess.py:93
def _resize_nearest(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize without cv2 (keeps label/depth values intact)."""
    H, W = img.shape[:2]
    oh, ow = out_hw
    if (H, W) == (oh, ow):
        return img
    ri = (np.arange(oh) * (H / oh)).astype(np.int64)
    ci = (np.arange(ow) * (W / ow)).astype(np.int64)
    return img[ri][:, ci]


# geopurify_tpu/data/preprocess.py:104
def _save_png16(path: str, depth: np.ndarray) -> None:
    from PIL import Image

    # a uint16 array is mode "I;16" (the mode= argument is deprecated)
    Image.fromarray(np.ascontiguousarray(depth, np.uint16)).save(path)


# geopurify_tpu/data/preprocess.py:110
def _save_image(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(arr).save(path)


# geopurify_tpu/data/preprocess.py:116
def _torch_save(obj, path: str) -> None:
    import torch

    torch.save(obj, path)


# geopurify_tpu/data/preprocess.py:122
def read_scene_list(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]


# ---------------------------------------------------------------------------
# ScanNet 3D
# ---------------------------------------------------------------------------

# geopurify_tpu/data/preprocess.py:131
def process_scannet_3d_scene(ply_path: str, out_dir: str) -> str:
    """One `*_vh_clean_2.ply` (+ sibling `.labels.ply`) -> `<scene>.pth`
    holding (coords f64, colors f64 in [-1,1], labels f64 0..19/255)
    (preprocess_3d_scannet.py:14-27)."""
    from geopurify_tpu_torch.data.ply import read_ply

    labels_path = ply_path[:-4] + ".labels.ply"
    v = read_ply(ply_path)["vertex"]
    coords = np.ascontiguousarray(
        np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float64)
    )
    colors = np.ascontiguousarray(
        np.stack([v["red"], v["green"], v["blue"]], 1).astype(np.float64)
    ) / 127.5 - 1.0
    lv = read_ply(labels_path)["vertex"]
    labels = scannet20_remapper()[np.asarray(lv["label"], np.int64)]
    name = os.path.basename(ply_path)[:-4] + ".pth"
    dst = os.path.join(out_dir, name)
    _torch_save((coords, colors, labels), dst)
    return dst


# geopurify_tpu/data/preprocess.py:153
def run_scannet_3d(args) -> None:
    os.makedirs(args.out, exist_ok=True)
    scenes = read_scene_list(args.scene_list) if args.scene_list else sorted(
        os.listdir(args.scans)
    )
    files = []
    for scene in scenes:
        hits = glob.glob(os.path.join(args.scans, scene, "*_vh_clean_2.ply"))
        if not hits:
            log.warning("no *_vh_clean_2.ply under %s", scene)
            continue
        files.append(hits[0])
    _parallel_map(partial(process_scannet_3d_scene, out_dir=args.out),
                  files, args.workers)
    log.info("wrote %d scenes to %s", len(files), args.out)


# ---------------------------------------------------------------------------
# ScanNet 2D (.sens reader)
# ---------------------------------------------------------------------------

# geopurify_tpu/data/preprocess.py:174
class SensReader:
    """Streaming reader for ScanNet `.sens` RGB-D captures
    (scannet_sensordata.py:1-122 semantics; version 4 format). Frames are
    decoded lazily so a 2 GB capture never fully materializes."""

    COLOR_COMPRESSION = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
    DEPTH_COMPRESSION = {-1: "unknown", 0: "raw_ushort", 1: "zlib_ushort", 2: "occi_ushort"}

    def __init__(self, path: str):
        self.f = open(path, "rb")
        f = self.f
        version = struct.unpack("I", f.read(4))[0]
        if version != 4:
            raise ValueError(f"unsupported .sens version {version}")
        strlen = struct.unpack("Q", f.read(8))[0]
        self.sensor_name = f.read(strlen).decode("ascii", "replace")
        self.intrinsic_color = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
        self.extrinsic_color = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
        self.intrinsic_depth = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
        self.extrinsic_depth = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
        self.color_compression = self.COLOR_COMPRESSION[struct.unpack("i", f.read(4))[0]]
        self.depth_compression = self.DEPTH_COMPRESSION[struct.unpack("i", f.read(4))[0]]
        self.color_width = struct.unpack("I", f.read(4))[0]
        self.color_height = struct.unpack("I", f.read(4))[0]
        self.depth_width = struct.unpack("I", f.read(4))[0]
        self.depth_height = struct.unpack("I", f.read(4))[0]
        self.depth_shift = struct.unpack("f", f.read(4))[0]
        self.num_frames = struct.unpack("Q", f.read(8))[0]
        self._offsets: List[int] = []

    def frames(self):
        """Yields (camera_to_world [4,4], color_bytes, depth_bytes)."""
        f = self.f
        for _ in range(self.num_frames):
            pose = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
            f.read(16)  # color/depth timestamps
            color_n, depth_n = struct.unpack("QQ", f.read(16))
            color = f.read(color_n)
            depth = f.read(depth_n)
            yield pose, color, depth

    def decode_color(self, data: bytes) -> np.ndarray:
        if self.color_compression != "jpeg":
            raise ValueError(f"unsupported color compression {self.color_compression}")
        from PIL import Image

        return np.asarray(Image.open(BytesIO(data)).convert("RGB"))

    def decode_depth(self, data: bytes) -> np.ndarray:
        if self.depth_compression != "zlib_ushort":
            raise ValueError(f"unsupported depth compression {self.depth_compression}")
        raw = zlib.decompress(data)
        return np.frombuffer(raw, np.uint16).reshape(self.depth_height, self.depth_width)

    def close(self):
        self.f.close()


# geopurify_tpu/data/preprocess.py:232
def read_label_tsv(path: str, label_from: str = "id", label_to: str = "nyu40id") -> Dict[int, int]:
    """scannetv2-labels.combined.tsv mapping (preprocess_2d_scannet.py:60-71)."""
    out: Dict[int, int] = {}
    with open(path) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            try:
                out[int(row[label_from])] = int(row[label_to])
            except (ValueError, KeyError):
                continue
    return out


# geopurify_tpu/data/preprocess.py:244
def process_scannet_2d_scene(
    scene: str, scans_dir: str, out_dir: str, frame_skip: int,
    image_hw: Tuple[int, int], label_map: Optional[Dict[int, int]],
    label_type: str = "label-filt",
) -> None:
    sens_path = os.path.join(scans_dir, scene, scene + ".sens")
    if not os.path.exists(sens_path):
        log.warning("%s: no .sens file, skipping", scene)
        return
    base = os.path.join(out_dir, scene)
    for sub in ("color", "depth", "pose") + (("label",) if label_map else ()):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    sd = SensReader(sens_path)
    oh, ow = image_hw
    for idx, (pose, color_b, depth_b) in enumerate(sd.frames()):
        if idx % frame_skip:
            continue
        color = _resize_nearest(sd.decode_color(color_b), (oh, ow))
        _save_image(os.path.join(base, "color", f"{idx}.jpg"), color)
        depth = _resize_nearest(sd.decode_depth(depth_b), (oh, ow))
        _save_png16(os.path.join(base, "depth", f"{idx}.png"), depth)
        np.savetxt(os.path.join(base, "pose", f"{idx}.txt"), pose.astype(np.float64))
        if label_map:
            from PIL import Image

            lp = os.path.join(scans_dir, scene, label_type, f"{idx}.png")
            if os.path.exists(lp):
                lab = np.asarray(Image.open(lp))
                lab = _resize_nearest(lab, (oh, ow))
                mapped = lab.copy()
                for k, vv in label_map.items():
                    mapped[lab == k] = vv
                _save_image(
                    os.path.join(base, "label", f"{idx}.png"),
                    mapped.astype(np.uint8),
                )
    sd.close()


# geopurify_tpu/data/preprocess.py:283
def run_scannet_2d(args) -> None:
    os.makedirs(args.out, exist_ok=True)
    # global intrinsics for the resized stream (preprocess_2d_scannet.py:79-84)
    intr = make_intrinsic(fx=577.870605, fy=577.870605, mx=319.5, my=239.5)
    intr = adjust_intrinsic(intr, (640, 480), (args.width, args.height))
    np.savetxt(os.path.join(args.out, "intrinsics.txt"), intr)
    label_map = read_label_tsv(args.label_map) if args.label_map else None
    scenes = read_scene_list(args.scene_list) if args.scene_list else sorted(
        d for d in os.listdir(args.scans)
        if os.path.isdir(os.path.join(args.scans, d))
    )
    _parallel_map(
        partial(process_scannet_2d_scene, scans_dir=args.scans, out_dir=args.out,
                frame_skip=args.frame_skip, image_hw=(args.height, args.width),
                label_map=label_map, label_type=args.label_type),
        scenes, args.workers,
    )
    log.info("exported %d scenes to %s", len(scenes), args.out)


# ---------------------------------------------------------------------------
# Matterport 3D
# ---------------------------------------------------------------------------

# geopurify_tpu/data/preprocess.py:307
def read_category_mapping(tsv_path: str) -> np.ndarray:
    """category_mapping.tsv -> array mapping raw category_id -> nyu40id with a
    0 row prepended (preprocess_3d_matterport.py:113-116)."""
    vals = [0]
    with open(tsv_path) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            raw = row.get("nyu40id", "")
            try:
                vals.append(int(float(raw)))
            except ValueError:
                vals.append(0)
    return np.asarray(vals, np.int64)


# geopurify_tpu/data/preprocess.py:321
def process_matterport_3d_region(
    ply_path: str, out_dir: str, mapping: np.ndarray
) -> str:
    """One region PLY -> `<scene>_<region>.pth` with per-vertex majority labels
    (preprocess_3d_matterport.py:59-98): face category -> nyu40 -> 21-class
    remap, accumulated per vertex over incident faces, argmax, unlabeled->255."""
    from geopurify_tpu_torch.data.ply import read_ply, vertex_normals

    scene_name = ply_path.split(os.sep)[-3]
    region_name = os.path.basename(ply_path).split(".")[0]
    data = read_ply(ply_path)
    v = data["vertex"]
    coords = np.ascontiguousarray(
        np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float64)
    )
    colors = np.ascontiguousarray(
        np.stack([v["red"], v["green"], v["blue"]], 1).astype(np.float64)
    ) / 127.5 - 1.0
    faces = np.asarray(data["face"]["vertex_indices"], np.int64)
    normal = vertex_normals(coords.astype(np.float32), faces)

    category_id = np.asarray(data["face"]["category_id"], np.int64)
    category_id[category_id == -1] = 0
    category_id = np.clip(category_id, 0, len(mapping) - 1)
    nyu = mapping[category_id]
    nyu[~np.isin(nyu, MATTERPORT_NYU40_IDS)] = 0
    remapped = matterport_class_remap()[nyu]          # 0 (unlabeled) or 1..21

    # per-vertex majority vote over incident faces (vectorized np.add.at
    # replaces the reference's python double loop, :85-90)
    votes = np.zeros((len(coords), 22), np.int32)
    for i in range(3):
        np.add.at(votes, (faces[:, i], remapped), 1)
    vertex_labels = np.argmax(votes, 1).astype(np.int64)
    vertex_labels[vertex_labels == 0] = 256
    vertex_labels -= 1                                # 0..20, unlabeled = 255

    dst = os.path.join(out_dir, f"{scene_name}_{region_name}.pth")
    _torch_save((coords, colors, normal, vertex_labels), dst)
    return dst


# geopurify_tpu/data/preprocess.py:363
def run_matterport_3d(args) -> None:
    os.makedirs(args.out, exist_ok=True)
    mapping = read_category_mapping(args.category_mapping)
    scenes = read_scene_list(args.scene_list) if args.scene_list else sorted(
        os.listdir(args.scans)
    )
    files: List[str] = []
    for scene in scenes:
        files += sorted(glob.glob(
            os.path.join(args.scans, scene, "region_segmentations", "*.ply")
        ))
    _parallel_map(partial(process_matterport_3d_region, out_dir=args.out,
                          mapping=mapping), files, args.workers)
    log.info("wrote %d regions to %s", len(files), args.out)


# ---------------------------------------------------------------------------
# Matterport 2D
# ---------------------------------------------------------------------------

# geopurify_tpu/data/preprocess.py:383
def parse_matterport_conf(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse undistorted_camera_parameters `.conf`: returns (img_names [N],
    intrinsics [N,3,3], camera_to_world [N,4,4]) — each intrinsics_matrix line
    covers the following 6 scan lines (preprocess_2d_matterport.py:14-45)."""
    names: List[str] = []
    intr: List[np.ndarray] = []
    extr: List[np.ndarray] = []
    cur_K = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("intrinsics_matrix"):
                vals = [x for x in line.split(" ")[1:] if x]
                cur_K = np.asarray(vals, np.float64).reshape(3, 3)
            elif line.startswith("scan"):
                parts = [x for x in line.split(" ") if x]
                names.append(parts[2])
                extr.append(np.asarray(parts[3:19], np.float64).reshape(4, 4))
                intr.append(cur_K)
    return np.asarray(names), np.stack(intr), np.stack(extr)


# geopurify_tpu/data/preprocess.py:405
def process_matterport_2d_scene(
    scene: str, in_path: str, out_dir: str,
    img_dim: Tuple[int, int] = (640, 512),
    original_img_dim: Tuple[int, int] = (1280, 1024),
) -> None:
    from PIL import Image

    base = os.path.join(out_dir, scene)
    for sub in ("color", "depth", "pose", "intrinsic"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    conf = os.path.join(in_path, scene, "undistorted_camera_parameters",
                        f"{scene}.conf")
    img_names, intr_list, pose_list = parse_matterport_conf(conf)
    name_to_id = {n: i for i, n in enumerate(img_names)}
    W, H = img_dim
    for fn in sorted(glob.glob(
        os.path.join(in_path, scene, "undistorted_color_images", "*.jpg")
    )):
        img_name = os.path.basename(fn)
        if img_name not in name_to_id:
            log.warning("%s not in conf, skipping", img_name)
            continue
        img_id = name_to_id[img_name]
        img = _resize_nearest(np.asarray(Image.open(fn).convert("RGB")), (H, W))
        _save_image(os.path.join(base, "color", img_name), img)

        # depth file name: color `<pano>_i<cam>_<yaw>.jpg` -> depth
        # `<pano>_d<cam>_<yaw>.png` (preprocess_2d_matterport.py:58-64)
        pano, img_type, yaw = img_name.split("_")
        depth_name = f"{pano}_d{img_type[1]}_{yaw[0]}.png"
        fn_depth = os.path.join(
            in_path, scene, "undistorted_depth_images", depth_name
        )
        if os.path.exists(fn_depth):
            depth = np.asarray(Image.open(fn_depth)).astype(np.uint16)
            _save_png16(
                os.path.join(base, "depth", depth_name),
                _resize_nearest(depth, (H, W)),
            )
        stem = img_name.split(".jpg")[0]
        pose = pose_list[img_id].copy()
        pose[:3, 1] *= -1.0   # matterport camera convention -> ours
        pose[:3, 2] *= -1.0
        np.savetxt(os.path.join(base, "pose", f"{stem}.txt"), pose)
        K = adjust_intrinsic(intr_list[img_id], original_img_dim, img_dim)
        np.savetxt(os.path.join(base, "intrinsic", f"{stem}.txt"), K)


# geopurify_tpu/data/preprocess.py:453
def run_matterport_2d(args) -> None:
    os.makedirs(args.out, exist_ok=True)
    scenes = read_scene_list(args.scene_list) if args.scene_list else sorted(
        os.listdir(args.scans)
    )
    _parallel_map(
        partial(process_matterport_2d_scene, in_path=args.scans, out_dir=args.out,
                img_dim=(args.width, args.height)),
        scenes, args.workers,
    )
    log.info("exported %d scenes to %s", len(scenes), args.out)


# ---------------------------------------------------------------------------
# nuScenes (outdoor lidar; reference preprocess_{3d,2d}_nuscenes.py)
# ---------------------------------------------------------------------------

# 32-class nuScenes ontology -> 16 eval classes, then -1 so unlabeled -> 255
# (protocol table, preprocess_3d_nuscenes.py:9-71)
# geopurify_tpu/data/preprocess.py:472
def nuscenes_class_remap() -> np.ndarray:
    remap = 256 * np.ones(32, np.int64)
    for src, dst in [
        (2, 7), (3, 7), (4, 7), (6, 7),          # person
        (9, 1),                                   # barrier
        (12, 8),                                  # traffic cone
        (14, 2),                                  # bicycle
        (15, 3), (16, 3),                         # bus
        (17, 4),                                  # car
        (18, 5),                                  # construction vehicle
        (21, 6),                                  # motorcycle
        (22, 9),                                  # trailer
        (23, 10),                                 # truck
        (24, 11),                                 # drivable surface
        (25, 12),                                 # other flat
        (26, 13),                                 # sidewalk
        (27, 14),                                 # terrain
        (28, 15),                                 # manmade
        (30, 16),                                 # vegetation
    ]:
        remap[src] = dst
    return remap - 1                              # 255 stays unlabeled


NUSCENES_CAM_LOCS = ("back", "back_left", "back_right",
                     "front", "front_left", "front_right")


# geopurify_tpu/data/preprocess.py:500
def process_nuscenes_3d_sequence(
    ply_path: str, out_dir: str, annotated_only: bool = False
) -> str:
    """One `<scene>/scene.ply` -> `<scene>.pth` holding (coords, 0, labels)
    — nuScenes exports carry no colors (preprocess_3d_nuscenes.py:74-95)."""
    from geopurify_tpu_torch.data.ply import read_ply

    scene_name = ply_path.split(os.sep)[-2]
    v = read_ply(ply_path)["vertex"]
    coords = np.ascontiguousarray(
        np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float64)
    )
    # label rides the LAST vertex property (ref reads v[:, -1]; property
    # order is preserved by read_ply)
    category_id = np.asarray(v[list(v.keys())[-1]], np.int64)
    if annotated_only:
        ts_path = ply_path[: -len("scene.ply")] + "scene-timestamps.npy"
        ts = np.load(ts_path)
        mask = (ts == ts.max())[:, 0]
        coords = coords[mask]
        category_id = category_id[mask]
    category_id = np.where(category_id == -1, 0, category_id)
    labels = nuscenes_class_remap()[category_id].astype(np.float64)
    dst = os.path.join(out_dir, scene_name + ".pth")
    _torch_save((coords, 0, labels), dst)
    return dst


# geopurify_tpu/data/preprocess.py:528
def run_nuscenes_3d(args) -> None:
    os.makedirs(args.out, exist_ok=True)
    scenes = read_scene_list(args.scene_list) if args.scene_list else sorted(
        d for d in os.listdir(args.scans)
        if os.path.isdir(os.path.join(args.scans, d))
    )
    files = []
    for scene in scenes:
        fp = os.path.join(args.scans, scene, "scene.ply")
        if not os.path.exists(fp):
            log.warning("no scene.ply under %s", scene)
            continue
        files.append(fp)
    _parallel_map(
        partial(process_nuscenes_3d_sequence, out_dir=args.out,
                annotated_only=args.annotated_only),
        files, args.workers,
    )
    log.info("wrote %d sequences to %s", len(files), args.out)


# geopurify_tpu/data/preprocess.py:549
def process_nuscenes_2d_sequence(
    scene: str, data_path: str, out_dir: str,
    img_size: Tuple[int, int] = (800, 450),
) -> None:
    """Last-timestamp 6-camera frame set -> color/pose/K per cam
    (preprocess_2d_nuscenes.py:26-55; pose = cam2scene, K rescaled from
    1600x900)."""
    from PIL import Image

    base = os.path.join(out_dir, scene)
    for sub in ("color", "pose", "K"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    frames_dir = os.path.join(data_path, scene, "frames")
    timestamp = sorted(os.listdir(frames_dir))[-1]
    W, H = img_size
    for cam in NUSCENES_CAM_LOCS:
        cam_dir = os.path.join(frames_dir, timestamp, cam)
        img_path = os.path.join(cam_dir, "color_image.jpg")
        if not os.path.exists(img_path):
            log.warning("%s/%s: no color_image.jpg", scene, cam)
            continue
        img = _resize_nearest(np.asarray(Image.open(img_path).convert("RGB")),
                              (H, W))
        _save_image(os.path.join(base, "color", cam + ".jpg"), img)
        pose = np.loadtxt(os.path.join(cam_dir, "cam2scene.txt"))
        np.save(os.path.join(base, "pose", cam + ".npy"), pose)
        K = np.loadtxt(os.path.join(cam_dir, "K.txt"))
        K = adjust_intrinsic(K, (1600, 900), img_size)
        np.save(os.path.join(base, "K", cam + ".npy"), K)


# geopurify_tpu/data/preprocess.py:580
def run_nuscenes_2d(args) -> None:
    os.makedirs(args.out, exist_ok=True)
    scenes = read_scene_list(args.scene_list) if args.scene_list else sorted(
        d for d in os.listdir(args.scans)
        if os.path.isdir(os.path.join(args.scans, d))
    )
    _parallel_map(
        partial(process_nuscenes_2d_sequence, data_path=args.scans,
                out_dir=args.out, img_size=(args.width, args.height)),
        scenes, args.workers,
    )
    log.info("exported %d sequences to %s", len(scenes), args.out)


# ---------------------------------------------------------------------------
# Replica (reference preprocess_{3d,2d}_replica.py)
# ---------------------------------------------------------------------------

REPLICA_SCENES = ("office0", "office1", "office2", "office3",
                  "office4", "room0", "room1", "room2")


# geopurify_tpu/data/preprocess.py:602
def process_replica_3d_scene(ply_path: str, out_dir: str) -> str:
    """`<scene>_mesh.ply` -> `<scene>.pth` (coords, colors in [-1,1],
    labels=255 — Replica ships no GT) (preprocess_3d_replica.py:9-22)."""
    from geopurify_tpu_torch.data.ply import read_ply

    scene_name = os.path.basename(ply_path).split("_mesh")[0]
    v = read_ply(ply_path)["vertex"]
    coords = np.ascontiguousarray(
        np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float64)
    )
    colors = np.ascontiguousarray(
        np.stack([v["red"], v["green"], v["blue"]], 1).astype(np.float64)
    ) / 127.5 - 1.0
    labels = 255.0 * np.ones((coords.shape[0],), np.float64)
    dst = os.path.join(out_dir, scene_name + ".pth")
    _torch_save((coords, colors, labels), dst)
    return dst


# geopurify_tpu/data/preprocess.py:621
def run_replica_3d(args) -> None:
    os.makedirs(args.out, exist_ok=True)
    scenes = read_scene_list(args.scene_list) if args.scene_list \
        else list(REPLICA_SCENES)
    files = []
    for scene in scenes:
        fp = os.path.join(args.scans, f"{scene}_mesh.ply")
        if not os.path.exists(fp):
            log.warning("no %s_mesh.ply", scene)
            continue
        files.append(fp)
    _parallel_map(partial(process_replica_3d_scene, out_dir=args.out),
                  files, args.workers)
    log.info("wrote %d scenes to %s", len(files), args.out)


# geopurify_tpu/data/preprocess.py:637
def process_replica_2d_scene(
    scene: str, in_path: str, out_dir: str,
    sample_freq: int = 10, img_dim: Tuple[int, int] = (640, 360),
) -> None:
    """`results/frameNNNNN.jpg` + `depthNNNNN.png` + `traj.txt` -> subsampled
    color/depth/pose streams (preprocess_2d_replica.py:9-81)."""
    from PIL import Image

    traj = os.path.join(in_path, scene, "traj.txt")
    if not os.path.exists(traj):
        log.warning("%s: no traj.txt, skipping", scene)
        return
    base = os.path.join(out_dir, scene)
    for sub in ("color", "depth", "pose"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    poses = np.loadtxt(traj).reshape(-1, 4, 4)
    pose_list = poses[::sample_freq]
    files = sorted(glob.glob(os.path.join(in_path, scene, "results", "*.jpg")))
    files = files[::sample_freq]
    W, H = img_dim
    for fn in files:
        img_name = os.path.basename(fn)
        img_id = int(img_name.split("frame")[-1].split(".")[0]) // sample_freq
        img = _resize_nearest(np.asarray(Image.open(fn).convert("RGB")), (H, W))
        _save_image(os.path.join(base, "color", f"{img_id}.jpg"), img)
        depth_name = img_name.replace(".jpg", ".png").replace("frame", "depth")
        fn_depth = os.path.join(os.path.dirname(fn), depth_name)
        if os.path.exists(fn_depth):
            depth = np.asarray(Image.open(fn_depth)).astype(np.uint16)
            _save_png16(os.path.join(base, "depth", f"{img_id}.png"),
                        _resize_nearest(depth, (H, W)))
        if img_id < len(pose_list):
            np.savetxt(os.path.join(base, "pose", f"{img_id}.txt"),
                       pose_list[img_id])


# geopurify_tpu/data/preprocess.py:673
def run_replica_2d(args) -> None:
    os.makedirs(args.out, exist_ok=True)
    # Replica renders share one pinhole model (preprocess_2d_replica.py:50-55)
    intr = make_intrinsic(fx=600.0, fy=600.0, mx=599.5, my=339.5)
    intr = adjust_intrinsic(intr, (1200, 680), (args.width, args.height))
    np.savetxt(os.path.join(args.out, "intrinsics.txt"), intr)
    scenes = read_scene_list(args.scene_list) if args.scene_list \
        else list(REPLICA_SCENES)
    _parallel_map(
        partial(process_replica_2d_scene, in_path=args.scans, out_dir=args.out,
                sample_freq=args.sample_freq,
                img_dim=(args.width, args.height)),
        scenes, args.workers,
    )
    log.info("exported %d scenes to %s", len(scenes), args.out)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

# geopurify_tpu/data/preprocess.py:694
def _parallel_map(fn, items: Sequence, workers: int) -> None:
    """``fn`` over ``items``, in ``workers`` processes when there are more
    than one. The workers are spawned (the JAX module forks): a caller's
    threads and CUDA context are not inherited, and ``fn`` is pickled by
    import path."""
    if workers <= 1 or len(items) <= 1:
        for it in items:
            fn(it)
        return
    import multiprocessing as mp

    with mp.get_context("spawn").Pool(processes=min(workers, len(items))) as pool:
        pool.map(fn, items)


# geopurify_tpu/data/preprocess.py:705
def main(argv=None):
    parser = argparse.ArgumentParser(
        description="raw ScanNet/Matterport -> loader-ready .pth/2D layout"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("scannet-3d")
    p.add_argument("--scans", required=True, help="scannet/scans root")
    p.add_argument("--out", required=True)
    p.add_argument("--scene-list", default=None)
    p.add_argument("--workers", type=int, default=os.cpu_count())
    p.set_defaults(fn=run_scannet_3d)

    p = sub.add_parser("scannet-2d")
    p.add_argument("--scans", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--scene-list", default=None)
    p.add_argument("--frame-skip", type=int, default=20)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--label-map", default=None,
                   help="scannetv2-labels.combined.tsv for label image export")
    p.add_argument("--label-type", default="label-filt")
    p.add_argument("--workers", type=int, default=os.cpu_count())
    p.set_defaults(fn=run_scannet_2d)

    p = sub.add_parser("matterport-3d")
    p.add_argument("--scans", required=True, help="matterport v1/scans root")
    p.add_argument("--out", required=True)
    p.add_argument("--category-mapping", required=True,
                   help="category_mapping.tsv")
    p.add_argument("--scene-list", default=None)
    p.add_argument("--workers", type=int, default=os.cpu_count())
    p.set_defaults(fn=run_matterport_3d)

    p = sub.add_parser("matterport-2d")
    p.add_argument("--scans", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--scene-list", default=None)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--workers", type=int, default=os.cpu_count())
    p.set_defaults(fn=run_matterport_2d)

    p = sub.add_parser("nuscenes-3d")
    p.add_argument("--scans", required=True, help="nuscenes split root "
                   "(<scene>/scene.ply exports)")
    p.add_argument("--out", required=True)
    p.add_argument("--scene-list", default=None)
    p.add_argument("--annotated-only", action="store_true",
                   help="keep only last-timestamp (annotated) points")
    p.add_argument("--workers", type=int, default=os.cpu_count())
    p.set_defaults(fn=run_nuscenes_3d)

    p = sub.add_parser("nuscenes-2d")
    p.add_argument("--scans", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--scene-list", default=None)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=450)
    p.add_argument("--workers", type=int, default=os.cpu_count())
    p.set_defaults(fn=run_nuscenes_2d)

    p = sub.add_parser("replica-3d")
    p.add_argument("--scans", required=True, help="Replica root "
                   "(<scene>_mesh.ply files)")
    p.add_argument("--out", required=True)
    p.add_argument("--scene-list", default=None)
    p.add_argument("--workers", type=int, default=os.cpu_count())
    p.set_defaults(fn=run_replica_3d)

    p = sub.add_parser("replica-2d")
    p.add_argument("--scans", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--scene-list", default=None)
    p.add_argument("--sample-freq", type=int, default=10)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--workers", type=int, default=os.cpu_count())
    p.set_defaults(fn=run_replica_2d)

    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s %(filename)s:%(lineno)d] %(message)s")
    args.fn(args)


if __name__ == "__main__":
    main()
