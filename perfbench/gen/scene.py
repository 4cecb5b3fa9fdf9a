"""The benchmark's scene generator: a frozen copy of the port's
``data/batch.py::build_scene``, with its seed widened to any sequence of
whole numbers (``numpy.random.default_rng`` takes one), so that a run's
``--seed`` and a scene's place in the pool give its draws.

A scene is the statically padded layout every entry of the port takes
(``SceneBatch``): P points in M lexicographically sorted voxels of 2 cm
(floor, two walls and blobby objects), six geometric channels, and V
views of H x W uint8 pixels, each seeing Pv distinct points at given
pixels. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

FIELDS = ("points", "point_valid", "geom_feats", "labels", "voxel_coords", "voxel_valid",
          "point2voxel", "images", "view_valid", "view_point_ids", "view_point_valid",
          "view_rows", "view_cols")


def build_scene(seed, P: int, M: int, V: int, Pv: int, hw, geometry_seed=None):
    """A dict of numpy arrays by ``SceneBatch`` field name. ``seed``: an int
    or a sequence of ints. With ``geometry_seed`` the room (its voxels and
    points) is drawn from that seed instead, so that scenes of different
    seeds share their geometry, and with it every data-dependent amount of
    work (the kNN's certificates, the band's residual, the z-stack's
    holes), and differ in the rest (pixels, features, views)."""
    rng = np.random.default_rng(seed)
    geo = rng if geometry_seed is None else np.random.default_rng(geometry_seed)
    H, W = hw
    E = 200 if M <= 65536 else 352
    Ez = 120 if M <= 65536 else 180
    n_draw = 3 * M
    quarters = n_draw // 4
    floor = np.stack([
        geo.integers(0, E, quarters), geo.integers(0, E, quarters),
        geo.integers(0, 3, quarters),
    ], 1)
    wall1 = np.stack([
        geo.integers(0, 3, quarters), geo.integers(0, E, quarters),
        geo.integers(0, Ez, quarters),
    ], 1)
    wall2 = np.stack([
        geo.integers(0, E, quarters), geo.integers(0, 3, quarters),
        geo.integers(0, Ez, quarters),
    ], 1)
    n_ctr = max(24, M // 2730)
    centers = geo.integers(20, E - 20, (n_ctr, 3)) * np.array([1, 1, 0]) + np.array([0, 0, 12])
    n_obj = n_draw - 3 * quarters
    radii = geo.uniform(5.0, 14.0, (n_ctr, 3))
    which = geo.integers(0, n_ctr, n_obj)
    dirs = geo.normal(size=(n_obj, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    blob_pts = (centers[which] + dirs * radii[which]).clip(0, E - 1)
    cand = np.concatenate([floor, wall1, wall2, blob_pts]).astype(np.int32)
    vox = np.unique(cand, axis=0)
    assert vox.shape[0] >= M, f"only {vox.shape[0]} unique voxels; increase draws"
    keep = np.sort(geo.choice(vox.shape[0], M, replace=False))
    vox = vox[keep]
    pts_per_vox = P // M
    points = (
        np.repeat(vox, pts_per_vox, axis=0).astype(np.float32) * 0.02
        + geo.uniform(0, 0.02, (M * pts_per_vox, 3)).astype(np.float32)
    )
    point2voxel = np.repeat(np.arange(M, dtype=np.int32), pts_per_vox)
    geom = rng.uniform(-1, 1, (P, 6)).astype(np.float32)
    labels = rng.integers(0, 19, P, dtype=np.int32)
    images = rng.integers(0, 256, (V, H, W, 3), dtype=np.uint8)
    ids = np.stack([
        rng.choice(P, Pv, replace=False).astype(np.int32) for _ in range(V)
    ])
    rows = rng.integers(0, H, (V, Pv), dtype=np.int32)
    cols = rng.integers(0, W, (V, Pv), dtype=np.int32)
    return dict(
        points=points,
        point_valid=np.ones(P, bool),
        geom_feats=geom,
        labels=labels,
        voxel_coords=vox,
        voxel_valid=np.ones(M, bool),
        point2voxel=point2voxel,
        images=images,
        view_valid=np.ones(V, bool),
        view_point_ids=ids,
        view_point_valid=np.ones((V, Pv), bool),
        view_rows=rows,
        view_cols=cols,
    )


def to_device(arrays: dict, device, pin: bool = False) -> dict:
    """The scene's arrays as torch tensors on ``device`` (from pinned host
    memory, asynchronously, with ``pin``)."""
    import torch

    out = {}
    for k in FIELDS:
        t = torch.from_numpy(np.ascontiguousarray(arrays[k]))
        if pin:
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=pin)
    return out
