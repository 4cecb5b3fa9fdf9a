"""Scene dataset — loading, projection, filtering, batching.

Port of geopurify_tpu/data/loaders.py: loads preprocessed scene point
clouds (torch ``.pth`` tuples, the OpenScene / ScanNet convention, or
labelled PLYs), enumerates cameras (every-20th-frame rule), computes the
occlusion-tested point -> pixel mapping of every view, drops unusable views,
voxelizes the scene and assembles one statically padded ``SceneBatch`` per
scene on the device the caller names.

What differs from the JAX loader: the mapping runs in float64 on that
device (``ops/projection.compute_mapping``; the scene's points cross once),
not on the host through numpy or the g++ ``native/`` library, and the
view-point padding happens there too. Host-side draws (augmentation, point
and view subsampling) use the same ``np.random.Generator`` calls in the
same order, so a seed gives the JAX loader's batches. The module has a
logger: the JAX loader's warning for scenes above ``max_views_eval`` names
a ``log`` that module never defines.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import zlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from geopurify_tpu_torch import resolve_device
from geopurify_tpu_torch.config import GeoPurifyConfig
from geopurify_tpu_torch.data.augment import Compose, default_train_augmentations
from geopurify_tpu_torch.data.batch import SceneBatch, pad_to
from geopurify_tpu_torch.data.cameras import load_scene_cameras
from geopurify_tpu_torch.data.ply import load_point_ply
from geopurify_tpu_torch.ops.projection import compute_mapping
from geopurify_tpu_torch.ops.voxelize import Voxelizer

log = logging.getLogger("geopurify.loaders")


# geopurify_tpu/data/loaders.py:37
@dataclass
class ScenePoints:
    xyz: np.ndarray      # [N, 3] f32
    rgb: np.ndarray      # [N, 3] f32 in 0..1
    normal: np.ndarray   # [N, 3] f32
    label: np.ndarray    # [N] int32


# geopurify_tpu/data/loaders.py:45
def load_scene_pth(path: str) -> ScenePoints:
    """An OpenScene-style preprocessed scene: a torch-saved tuple of (coords,
    feats in [-1, 1], labels), or (coords, colors, normals, labels) for
    Matterport, or a dict with ``coord`` / ``color`` / ``normal`` /
    ``semantic_gt``. The file holds numpy arrays, so it is unpickled in full:
    load only datasets you trust."""
    data = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(data, dict):
        xyz = np.asarray(data["coord"], np.float32)
        rgb = np.asarray(data.get("color", np.zeros_like(xyz)), np.float32)
        normal = np.asarray(data.get("normal", np.zeros_like(xyz)), np.float32)
        label = np.asarray(data.get("semantic_gt", np.full(len(xyz), 255)), np.int64)
    elif len(data) == 4:
        xyz, rgb, normal, label = (np.asarray(x) for x in data)
    else:
        xyz, rgb, label = (np.asarray(x) for x in data[:3])
        normal = np.zeros_like(xyz, dtype=np.float32)
    xyz = np.ascontiguousarray(xyz, np.float32)
    rgb = np.ascontiguousarray(rgb, np.float32)
    if rgb.min() < -0.01:                      # [-1, 1] -> [0, 1]
        rgb = (rgb + 1.0) / 2.0
    elif rgb.max() > 1.5:                      # 0..255 -> 0..1
        rgb = rgb / 255.0
    label = np.ascontiguousarray(label.reshape(-1), np.int32)
    return ScenePoints(xyz, rgb, np.ascontiguousarray(normal, np.float32), label)


# geopurify_tpu/data/loaders.py:73
def load_scene_any(path_3d: str, normals_ply: Optional[str] = None) -> ScenePoints:
    if path_3d.endswith(".pth") or path_3d.endswith(".pt"):
        sp = load_scene_pth(path_3d)
    elif path_3d.endswith(".ply"):
        d = load_point_ply(path_3d)
        sp = ScenePoints(
            d["xyz"], d.get("rgb", np.zeros_like(d["xyz"])),
            d.get("normal", np.zeros_like(d["xyz"])),
            d.get("label", np.full(len(d["xyz"]), 255)).astype(np.int32),
        )
    else:
        raise ValueError(f"unsupported scene file {path_3d}")
    if normals_ply and os.path.exists(normals_ply) and not sp.normal.any():
        d = load_point_ply(normals_ply)
        if len(d["xyz"]) == len(sp.xyz):
            sp.normal = d["normal"]
    return sp


# geopurify_tpu/data/loaders.py:93
def eval_view_bucket(n_views: int, max_views: int, max_views_eval: int) -> int:
    """Static view-count bucket for eval: every usable view is kept, with the
    bucket growing on a power-of-two ladder above ``max_views`` up to the
    hard cap ``max_views_eval``."""
    if n_views <= max_views:
        return max_views
    if n_views <= max_views_eval:
        return 1 << int(np.ceil(np.log2(n_views)))
    return max_views_eval


# geopurify_tpu/data/loaders.py:104
def deterministic_keep(sid: str, n: int, budget: int) -> np.ndarray:
    """The per-scene deterministic point subsample (sorted indices) used when
    a scene exceeds the static point budget without augmentation."""
    if n <= budget:
        return np.arange(n)
    sub_rng = np.random.default_rng(zlib.crc32(sid.encode()))
    keep = sub_rng.choice(n, budget, replace=False)
    keep.sort()
    return keep


# geopurify_tpu/data/loaders.py:165
def _scale_intrinsic(K: np.ndarray, src_wh: Tuple[int, int], dst_wh: Tuple[int, int]):
    """Rescale a pinhole intrinsic between resolutions."""
    K = K.astype(np.float64).copy()
    sx = dst_wh[0] / src_wh[0]
    sy = dst_wh[1] / src_wh[1]
    K[0, 0] *= sx
    K[0, 2] = (K[0, 2] + 0.5) * sx - 0.5
    K[1, 1] *= sy
    K[1, 2] = (K[1, 2] + 0.5) * sy - 0.5
    return K


# geopurify_tpu/data/loaders.py:177
def _load_image(path: str, wh: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize(wh, Image.BILINEAR)
        # uint8: the pipeline casts on the device
        return np.asarray(im, np.uint8)


# geopurify_tpu/data/loaders.py:187
def _load_depth(path: str, wh: Tuple[int, int], scale: float) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.resize(wh, Image.NEAREST)
        return np.asarray(im, np.float64) / scale


def _pad_rows(x: torch.Tensor, n: int, value=0) -> torch.Tensor:
    """``pad_to`` along axis 0 for a tensor, on its device."""
    if x.shape[0] >= n:
        return x[:n]
    return torch.cat([x, x.new_full((n - x.shape[0],) + tuple(x.shape[1:]), value)])


# geopurify_tpu/data/loaders.py:195
class SceneDataset:
    """Per-scene batches for training (Stage 1) and evaluation (Stage 2),
    on ``device`` (``cuda`` by default; the tests pass ``cpu``).
    ``augment=None`` augments the train split only (the JAX default); the
    trainer's frozen-input modes pass ``False``, since their cached
    features belong to the unaugmented geometry."""

    def __init__(
        self,
        cfg: GeoPurifyConfig,
        split: str = "train",
        augment: Optional[bool] = None,
        seed: int = 0,
        device="cuda",
    ):
        self.cfg = cfg
        self.split = split
        self.device = resolve_device(device)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._order_rng = self.rng
        self.augment: Optional[Compose] = None
        if augment is None:
            augment = split == "train"
        if augment:
            self.augment = default_train_augmentations()
        self.voxelizer = Voxelizer(
            voxel_size=cfg.data.voxel_size,
            use_augmentation=bool(augment),
            scale_augmentation_bound=(0.9, 1.1) if augment else None,
            rotation_augmentation_bound=(
                (-np.pi / 64, np.pi / 64), (-np.pi / 64, np.pi / 64), (-np.pi, np.pi)
            ) if augment else None,
            rng=self.rng,
        )
        list_name = (
            cfg.data.train_scene_list if split == "train" else cfg.data.eval_scene_list
        )
        self.scene_ids = self._read_scene_list(list_name)
        # the 20-scene training subset loops 16x per epoch: keep parsed scenes
        self._scene_cache: Dict[str, ScenePoints] = {}
        self._scene_cache_max = 32
        self._order = np.arange(len(self.scene_ids))
        self._pos = 0
        self._epoch = 0
        self._prefetcher: Optional[_Prefetcher] = None

    def split_streams(self, rank: int) -> None:
        """For data parallelism over ranks that each hold a dataset: the
        scene order takes a generator of its own, seeded alike on every
        rank, so that ``_next_sid`` gives every rank the same ids whatever
        each rank loads; augmentation and view subsampling draw from a
        generator of ``rank``."""
        self._order_rng = np.random.default_rng(self.seed)
        self.rng = np.random.default_rng([self.seed, rank])
        self.voxelizer.rng = self.rng

    # ----------------------------------------------------------------- paths
    # geopurify_tpu/data/loaders.py:241
    def _read_scene_list(self, name: str) -> List[str]:
        candidates = [
            name,
            os.path.join(self.cfg.data.data_root, name),
            os.path.join(os.path.dirname(__file__), "..", "lists", name),
        ]
        for c in candidates:
            if os.path.exists(c):
                with open(c) as f:
                    return [
                        ln.strip() for ln in f
                        if ln.strip() and not ln.lstrip().startswith("#")
                    ]
        raise FileNotFoundError(f"scene list {name!r}; tried {candidates}")

    # geopurify_tpu/data/loaders.py:256
    def scene_3d_path(self, sid: str) -> str:
        root = self.cfg.data.data_root
        for pat in (
            f"{sid}_vh_clean_2.pth", f"{sid}.pth", f"{sid}.ply",
            os.path.join(self.split, f"{sid}_vh_clean_2.pth"),
            os.path.join(self.split, f"{sid}.pth"),
            os.path.join(sid, f"{sid}_vh_clean_2.pth"),
        ):
            p = os.path.join(root, pat)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"no 3D data for scene {sid} under {root}")

    def scene_2d_dir(self, sid: str) -> str:
        return os.path.join(self.cfg.data.data_root_2d, sid)

    def __len__(self) -> int:
        return len(self.scene_ids)

    # ----------------------------------------------------------------- build
    # geopurify_tpu/data/loaders.py:276
    def make_scene_batch(self, sid: str, require_views: bool = True,
                         with_rows: bool = False):
        """The scene's batch (None when unusable). ``with_rows``: also the
        index of each valid point row into the scene's points, after the
        point cap and the voxel budget (``(batch, rows)``), which rows of a
        per-point file follow."""
        cfg = self.cfg
        fus = cfg.fusion
        dev = self.device
        W, H = tuple(fus.img_dim)
        sp = self._scene_cache.get(sid)
        if sp is None:
            sp = load_scene_any(
                self.scene_3d_path(sid),
                normals_ply=os.path.join(self.scene_2d_dir(sid), "points3d.labels.ply"),
            )
            if len(self._scene_cache) >= self._scene_cache_max:
                self._scene_cache.pop(next(iter(self._scene_cache)))
            self._scene_cache[sid] = sp
        xyz, rgb, normal, label = sp.xyz, sp.rgb, sp.normal, sp.label

        if self.augment is not None:
            feats255 = np.concatenate([rgb * 255.0, normal], axis=1)
            xyz, feats255, label = self.augment(xyz, feats255, label, self.rng)
            rgb = feats255[:, :3] / 255.0
            normal = feats255[:, 3:6]

        # cap points (static bucket); without augmentation the subsample is
        # deterministic per scene, so row-aligned per-scene files agree
        P = cfg.data.max_points
        src = np.arange(len(xyz))               # each row's point in the scene
        if len(xyz) > P:
            if self.augment is not None:
                keep = self.rng.choice(len(xyz), P, replace=False)
                keep.sort()
            else:
                keep = deterministic_keep(sid, len(xyz), P)
            xyz, rgb, normal, label = xyz[keep], rgb[keep], normal[keep], label[keep]
            src = keep
        n_pts = len(xyz)

        # cameras + views: the points cross to the device once, every view
        # projects there; only the visibility mask comes back to the host
        cams = load_scene_cameras(
            self.scene_2d_dir(sid),
            frame_stride=fus.frame_stride,
            resolution_scale=fus.resolution_scale,
            points=xyz,
        ) if os.path.isdir(self.scene_2d_dir(sid)) else []
        if cfg.data.dataset != "matterport":
            for cam in cams:  # config-driven depth scale (ScanNet-style data)
                cam.depth_scale = fus.depth_scale
        pts = torch.from_numpy(np.ascontiguousarray(xyz)).to(dev, torch.float64)
        views = []
        for cam in cams:
            if cam.image_path is None:
                continue
            K = _scale_intrinsic(cam.intrinsic, (cam.width, cam.height), (W, H))
            depth = (
                _load_depth(cam.depth_path, (W, H), cam.depth_scale)
                if cam.depth_path and os.path.exists(cam.depth_path)
                else None
            )
            rows, cols, vis = compute_mapping(
                pts, cam.world_to_camera, K, depth, (W, H),
                cut_bound=fus.cut_boundary, vis_thres=fus.visibility_threshold,
            )
            vis = vis.cpu().numpy()
            n_vis = int(vis.sum())
            lo = fus.min_visible_points
            hi = fus.max_visible_points if self.split == "train" else cfg.data.val_keep
            if n_vis < lo or n_vis > hi:
                continue  # unusable view
            views.append((cam, rows, cols, vis))
        del pts
        if not views and require_views:
            return None

        V = cfg.data.max_views
        if len(views) > V:
            if self.split == "train":
                sel = self.rng.choice(len(views), V, replace=False)
                views = [views[i] for i in sorted(sel)]
            else:
                # eval uses every usable view, in a power-of-two bucket
                V = eval_view_bucket(len(views), cfg.data.max_views, cfg.data.max_views_eval)
                if len(views) > V:  # beyond the hard cap: warn + subsample
                    log.warning(
                        "scene %s: %d usable views exceed max_views_eval=%d — "
                        "linspace-subsampling (mIoU may shift vs all-view eval)",
                        sid, len(views), V,
                    )
                    sel = np.linspace(0, len(views) - 1, V).astype(int)
                    views = [views[i] for i in sel]

        # voxelize the whole scene (sorted voxel order, the device contract)
        geom = np.concatenate([rgb, normal], axis=1).astype(np.float32)
        vox = self.voxelizer.voxelize(xyz, geom, label)
        order = np.lexsort(
            (vox.voxel_coords[:, 2], vox.voxel_coords[:, 1], vox.voxel_coords[:, 0])
        )
        rank = np.empty(len(order), np.int64)
        rank[order] = np.arange(len(order))
        voxel_coords = vox.voxel_coords[order].astype(np.int32)
        point2voxel = rank[vox.inds_reverse].astype(np.int32)
        M_budget = cfg.data.max_voxels
        M = len(voxel_coords)
        if M > M_budget:
            # drop the points of the voxels past the budget
            keep_pts = point2voxel < M_budget
            keep_t = torch.from_numpy(keep_pts).to(dev)
            xyz, rgb, normal, label = (a[keep_pts] for a in (xyz, rgb, normal, label))
            geom = geom[keep_pts]
            point2voxel = point2voxel[keep_pts]
            src = src[keep_pts]
            views = [(c, r[keep_t], co[keep_t], vi[keep_pts]) for c, r, co, vi in views]
            voxel_coords = voxel_coords[:M_budget]
            M = M_budget
            n_pts = len(xyz)

        Pv = cfg.data.max_view_points
        images, vids, vrows, vcols, vvalid = [], [], [], [], []
        for cam, rows, cols, vis in views:
            ids = np.where(vis)[0]
            if len(ids) > Pv:
                ids = self.rng.choice(ids, Pv, replace=False)
                ids.sort()
            ids_t = torch.from_numpy(ids).to(dev)
            images.append(_load_image(cam.image_path, (W, H)))
            vids.append(pad_to(ids.astype(np.int32), Pv, value=n_pts))
            vrows.append(_pad_rows(rows[ids_t], Pv))
            vcols.append(_pad_rows(cols[ids_t], Pv))
            m = np.zeros(Pv, bool)
            m[: len(ids)] = True
            vvalid.append(m)

        P = cfg.data.max_points
        pvalid = np.zeros(P, bool)
        pvalid[:n_pts] = True
        view_valid = np.zeros(V, bool)
        view_valid[: len(views)] = True

        def stack_pad(lst, fill):
            return pad_to(np.stack(lst), V, axis=0, value=fill)

        if views:
            images_a = stack_pad(images, 0)
            vids_a = stack_pad(vids, n_pts).astype(np.int32)
            vvalid_a = stack_pad(vvalid, False).astype(bool)
            vrows_t = _pad_rows(torch.stack(vrows), V)
            vcols_t = _pad_rows(torch.stack(vcols), V)
        else:  # view-less batch (fused-feature mode): all-padding view slots
            images_a = np.zeros((V, H, W, 3), np.uint8)
            vids_a = np.full((V, Pv), n_pts, np.int32)
            vvalid_a = np.zeros((V, Pv), bool)
            vrows_t = torch.zeros((V, Pv), dtype=torch.int32, device=dev)
            vcols_t = torch.zeros((V, Pv), dtype=torch.int32, device=dev)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        batch = SceneBatch(
            points=t(pad_to(xyz.astype(np.float32), P)),
            point_valid=t(pvalid),
            geom_feats=t(pad_to(geom, P)),
            labels=t(pad_to(label, P, value=cfg.data.ignore_label)),
            voxel_coords=t(pad_to(voxel_coords, M_budget)),
            voxel_valid=t(pad_to(np.ones(M, bool), M_budget, value=False)),
            point2voxel=t(pad_to(point2voxel, P, value=M_budget)),
            images=t(images_a),
            view_valid=t(view_valid),
            view_point_ids=t(vids_a),
            view_point_valid=t(vvalid_a),
            view_rows=vrows_t,
            view_cols=vcols_t,
        )
        return (batch, src) if with_rows else batch

    # ------------------------------------------------------------- iteration
    # geopurify_tpu/data/loaders.py:450
    def next_scene(self) -> SceneBatch:
        """Sequential (shuffled each epoch at train) scene stream with a
        background prefetch thread; skips unusable scenes."""
        if self._prefetcher is None:
            self._prefetcher = _Prefetcher(self)
        return self._prefetcher.get()

    # geopurify_tpu/data/loaders.py:457
    def _next_sid(self) -> str:
        if self._pos >= len(self._order):
            self._pos = 0
            self._epoch += 1
            if self.split == "train":
                self._order_rng.shuffle(self._order)
        sid = self.scene_ids[self._order[self._pos]]
        self._pos += 1
        return sid

    # geopurify_tpu/data/loaders.py:467
    def iter_scenes(self) -> Iterator[Tuple[str, Optional[SceneBatch]]]:
        """One pass over all scenes in order (the eval harness)."""
        for sid in self.scene_ids:
            yield sid, self.make_scene_batch(sid)


# geopurify_tpu/data/loaders.py:473
class _Prefetcher:
    """Builds the next scenes on a daemon thread, ``depth`` ahead; a loader
    failure reaches the consumer at its next ``get``."""

    def __init__(self, ds: SceneDataset, depth: int = 2):
        self.ds = ds
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.t = threading.Thread(target=self._work, daemon=True)
        self.t.start()

    def _work(self):
        while True:
            try:
                batch = None
                tries = 0
                while batch is None:
                    batch = self.ds.make_scene_batch(self.ds._next_sid())
                    tries += 1
                    if batch is None and tries > 2 * len(self.ds.scene_ids):
                        raise RuntimeError(
                            "no usable scene in the dataset (all views filtered?)"
                        )
                self.q.put(batch)
            except Exception as e:  # surface loader failures to the consumer
                self.q.put(e)
                return

    def get(self) -> SceneBatch:
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return item
