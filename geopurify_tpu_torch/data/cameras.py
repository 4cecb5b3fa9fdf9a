"""Camera and scene enumeration — ScanNet / Matterport / COLMAP / Blender.

Port of geopurify_tpu/data/cameras.py (numpy): a ``Camera`` record with the
world->camera transform, a reader per on-disk layout, and
``load_scene_cameras``, which picks the reader from the directory layout.
The port keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


# geopurify_tpu/data/cameras.py:22
@dataclass
class Camera:
    """One view: extrinsics (world->camera), pinhole intrinsics, image paths."""

    uid: str
    world_to_camera: np.ndarray          # [4,4] f64
    intrinsic: np.ndarray                # [3,3] f64 (at the color image's resolution)
    width: int
    height: int
    image_path: Optional[str] = None
    depth_path: Optional[str] = None
    depth_scale: float = 1000.0          # depth png -> metres divisor

    @property
    def camera_to_world(self) -> np.ndarray:
        return np.linalg.inv(self.world_to_camera)

    @property
    def position(self) -> np.ndarray:
        return self.camera_to_world[:3, 3]


# geopurify_tpu/data/cameras.py:43
def _pose_is_valid(pose: np.ndarray) -> bool:
    return bool(np.all(np.isfinite(pose))) and abs(np.linalg.det(pose[:3, :3])) > 1e-8


# ---------------------------------------------------------------------------
# ScanNet layout:  <scene>/color/N.jpg, depth/N.png, pose/N.txt,
#                  intrinsic/intrinsic_color.txt  (pose = camera->world)
# ---------------------------------------------------------------------------

# geopurify_tpu/data/cameras.py:52
def load_scannet_cameras(
    scene_dir: str,
    frame_stride: int = 20,
    resolution_scale: float = 1.0,
) -> List[Camera]:
    """Every ``frame_stride``-th frame, skipping invalid (inf/degenerate) poses
    — the reference's every-20th-frame rule (scannet_loader.py:34) and
    invalid-pose skip (:60-66)."""
    pose_dir = os.path.join(scene_dir, "pose")
    intr_path = os.path.join(scene_dir, "intrinsic", "intrinsic_color.txt")
    K4 = np.loadtxt(intr_path)
    K = K4[:3, :3].copy()
    if resolution_scale != 1.0:
        K[:2] /= resolution_scale

    frame_ids = sorted(
        int(f[:-4]) for f in os.listdir(pose_dir) if f.endswith(".txt")
    )
    cams: List[Camera] = []
    for fid in frame_ids[::frame_stride]:
        pose = np.loadtxt(os.path.join(pose_dir, f"{fid}.txt"))  # camera->world
        if not _pose_is_valid(pose):
            continue
        img = os.path.join(scene_dir, "color", f"{fid}.jpg")
        if not os.path.exists(img):
            img = os.path.join(scene_dir, "color", f"{fid}.png")
        depth = os.path.join(scene_dir, "depth", f"{fid}.png")
        w, h = _image_size_or_default(img, K)
        cams.append(
            Camera(
                uid=str(fid),
                world_to_camera=np.linalg.inv(pose),
                intrinsic=K,
                width=int(round(w / resolution_scale)),
                height=int(round(h / resolution_scale)),
                image_path=img if os.path.exists(img) else None,
                depth_path=depth if os.path.exists(depth) else None,
            )
        )
    return cams


# geopurify_tpu/data/cameras.py:94
def _image_size_or_default(img_path: str, K: np.ndarray) -> Tuple[int, int]:
    if os.path.exists(img_path):
        try:
            from PIL import Image

            with Image.open(img_path) as im:
                return im.size
        except Exception:
            pass
    # fall back to principal-point convention (cx ~ W/2)
    return int(round(K[0, 2] * 2)), int(round(K[1, 2] * 2))


# ---------------------------------------------------------------------------
# Matterport layout: per-image pose + intrinsics under
#   <scene>/matterport_camera_poses/<uid>_pose_<cam>_<frame>.txt
#   <scene>/matterport_camera_intrinsics/<uid>_intrinsics_<cam>.txt
#   <scene>/matterport_color_images/<uid>_i<cam>_<frame>.jpg
#   <scene>/matterport_depth_images/<uid>_d<cam>_<frame>.png
# ---------------------------------------------------------------------------

# geopurify_tpu/data/cameras.py:115
def load_matterport_cameras(
    scene_dir: str,
    points: Optional[np.ndarray] = None,
    margin: float = 0.5,
    min_cameras: int = 100,
    depth_scale: float = 4000.0,
) -> List[Camera]:
    """Enumerate Matterport cameras; if ``points`` is given, keep cameras whose
    position lies inside the region bbox (+margin), falling back to the
    ``min_cameras`` nearest when too few survive
    (reference scannet_loader.py:99-301, fusion_util.py:150-215)."""
    pose_dir = os.path.join(scene_dir, "matterport_camera_poses")
    intr_dir = os.path.join(scene_dir, "matterport_camera_intrinsics")
    img_dir = os.path.join(scene_dir, "matterport_color_images")
    depth_dir = os.path.join(scene_dir, "matterport_depth_images")

    cams: List[Camera] = []
    for fname in sorted(os.listdir(pose_dir)):
        if not fname.endswith(".txt"):
            continue
        stem = fname[:-4]                       # <uid>_pose_<cam>_<frame>
        parts = stem.split("_pose_")
        if len(parts) != 2:
            continue
        uid, camframe = parts
        cam_i, frame_i = camframe.split("_")
        pose = np.loadtxt(os.path.join(pose_dir, fname))  # camera->world
        if not _pose_is_valid(pose):
            continue
        intr_file = os.path.join(intr_dir, f"{uid}_intrinsics_{cam_i}.txt")
        vals = np.loadtxt(intr_file)            # w h fx fy cx cy [distortion...]
        w, h = int(vals[0]), int(vals[1])
        K = np.array(
            [[vals[2], 0, vals[4]], [0, vals[3], vals[5]], [0, 0, 1.0]]
        )
        img = os.path.join(img_dir, f"{uid}_i{cam_i}_{frame_i}.jpg")
        depth = os.path.join(depth_dir, f"{uid}_d{cam_i}_{frame_i}.png")
        cams.append(
            Camera(
                uid=stem,
                world_to_camera=np.linalg.inv(pose),
                intrinsic=K, width=w, height=h,
                image_path=img if os.path.exists(img) else None,
                depth_path=depth if os.path.exists(depth) else None,
                depth_scale=depth_scale,
            )
        )
    if points is not None and cams:
        lo, hi = points.min(0) - margin, points.max(0) + margin
        pos = np.stack([c.position for c in cams])
        inside = np.all((pos >= lo) & (pos <= hi), axis=1)
        if inside.sum() >= min(min_cameras, len(cams)):
            cams = [c for c, m in zip(cams, inside) if m]
        else:
            center = points.mean(0)
            order = np.argsort(np.linalg.norm(pos - center, axis=1))
            cams = [cams[i] for i in order[:min_cameras]]
    return cams


# ---------------------------------------------------------------------------
# COLMAP binary (sparse/0/{cameras,images}.bin)
# ---------------------------------------------------------------------------

# geopurify_tpu/data/cameras.py:179
def _read_next_bytes(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


# geopurify_tpu/data/cameras.py:183
def read_colmap_cameras_bin(path: str) -> Dict[int, Dict]:
    """cameras.bin -> {camera_id: {model, width, height, params}}."""
    models = {0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4)}
    out = {}
    with open(path, "rb") as f:
        (n,) = _read_next_bytes(f, 8, "Q")
        for _ in range(n):
            cid, model_id, w, h = _read_next_bytes(f, 24, "iiQQ")
            name, np_ = models.get(model_id, (f"MODEL{model_id}", 4))
            params = _read_next_bytes(f, 8 * np_, "d" * np_)
            out[cid] = {"model": name, "width": w, "height": h, "params": params}
    return out


# geopurify_tpu/data/cameras.py:197
def read_colmap_images_bin(path: str) -> Dict[int, Dict]:
    """images.bin -> {image_id: {qvec, tvec, camera_id, name}}."""
    out = {}
    with open(path, "rb") as f:
        (n,) = _read_next_bytes(f, 8, "Q")
        for _ in range(n):
            vals = _read_next_bytes(f, 64, "idddddddi")
            iid, qw, qx, qy, qz, tx, ty, tz, cid = vals
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (npts,) = _read_next_bytes(f, 8, "Q")
            f.seek(24 * npts, 1)  # skip 2D points
            out[iid] = {
                "qvec": np.array([qw, qx, qy, qz]),
                "tvec": np.array([tx, ty, tz]),
                "camera_id": cid,
                "name": name.decode("utf-8"),
            }
    return out


# geopurify_tpu/data/cameras.py:221
def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


# geopurify_tpu/data/cameras.py:230
def load_colmap_cameras(scene_dir: str, images_subdir: str = "images") -> List[Camera]:
    sparse = os.path.join(scene_dir, "sparse", "0")
    cam_info = read_colmap_cameras_bin(os.path.join(sparse, "cameras.bin"))
    images = read_colmap_images_bin(os.path.join(sparse, "images.bin"))
    cams: List[Camera] = []
    for iid in sorted(images):
        im = images[iid]
        ci = cam_info[im["camera_id"]]
        if ci["model"] == "SIMPLE_PINHOLE" or ci["model"] == "SIMPLE_RADIAL":
            fx = fy = ci["params"][0]
            cx, cy = ci["params"][1], ci["params"][2]
        else:
            fx, fy, cx, cy = ci["params"][:4]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        w2c = np.eye(4)
        w2c[:3, :3] = qvec_to_rotmat(im["qvec"])
        w2c[:3, 3] = im["tvec"]
        cams.append(
            Camera(
                uid=im["name"],
                world_to_camera=w2c, intrinsic=K,
                width=ci["width"], height=ci["height"],
                image_path=os.path.join(scene_dir, images_subdir, im["name"]),
            )
        )
    return cams


# ---------------------------------------------------------------------------
# Blender transforms.json
# ---------------------------------------------------------------------------

# geopurify_tpu/data/cameras.py:262
def load_blender_cameras(scene_dir: str, split: str = "train") -> List[Camera]:
    path = os.path.join(scene_dir, f"transforms_{split}.json")
    if not os.path.exists(path):
        path = os.path.join(scene_dir, "transforms.json")
    with open(path) as f:
        meta = json.load(f)
    cams: List[Camera] = []
    fovx = meta.get("camera_angle_x")
    for fr in meta["frames"]:
        c2w = np.array(fr["transform_matrix"], dtype=np.float64)
        # Blender/NeRF convention: flip y,z axes to get the CV camera frame
        c2w[:3, 1:3] *= -1
        img = os.path.join(scene_dir, fr["file_path"])
        for ext in ("", ".png", ".jpg"):
            if os.path.exists(img + ext):
                img = img + ext
                break
        w, h = 800, 800
        if os.path.exists(img):
            try:
                from PIL import Image

                with Image.open(img) as im:
                    w, h = im.size
            except Exception:
                pass
        fx = 0.5 * w / np.tan(0.5 * fovx) if fovx else fr.get("fl_x", w)
        K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]])
        cams.append(
            Camera(
                uid=fr["file_path"],
                world_to_camera=np.linalg.inv(c2w),
                intrinsic=K, width=w, height=h,
                image_path=img if os.path.exists(img) else None,
            )
        )
    return cams


# ---------------------------------------------------------------------------
# Dispatch (reference models/scene/scene.py:37-90 directory sniffing)
# ---------------------------------------------------------------------------

# geopurify_tpu/data/cameras.py:305
def load_scene_cameras(scene_dir: str, **kwargs) -> List[Camera]:
    if os.path.isdir(os.path.join(scene_dir, "matterport_camera_poses")):
        kwargs.pop("frame_stride", None)   # ScanNet-only knob
        kwargs.pop("resolution_scale", None)
        return load_matterport_cameras(scene_dir, **kwargs)
    if os.path.isdir(os.path.join(scene_dir, "pose")):
        kwargs.pop("points", None)
        return load_scannet_cameras(scene_dir, **kwargs)
    if os.path.isdir(os.path.join(scene_dir, "sparse")):
        kwargs.pop("points", None)
        return load_colmap_cameras(scene_dir)
    if os.path.exists(os.path.join(scene_dir, "transforms_train.json")) or os.path.exists(
        os.path.join(scene_dir, "transforms.json")
    ):
        kwargs.pop("points", None)
        return load_blender_cameras(scene_dir)
    raise FileNotFoundError(f"Unrecognized scene layout at {scene_dir}")
