"""SimpleClick's first-click rule for the interactive NoC evaluation.

Port of the part of geopurify_tpu/data/visual_sampler.py that
``run/infer_interactive.py --eval-noc`` uses: ``distance_transform_conv``
(the conv-approximated distance transform of kornia's
``distance_transform``, which the reference's simpleclick_sampler.py:66
calls) and ``_center_clicks`` (the deepest pixel of each mask). Host numpy
and scipy, as in JAX. The stroke, point, circle, scribble, polygon and
SimpleClick samplers feed 2D training and wait for that slice (ROADMAP).
"""

from __future__ import annotations

import math

import numpy as np


# geopurify_tpu/data/visual_sampler.py:656
def distance_transform_conv(image: np.ndarray, kernel_size: int = 3,
                            h: float = 0.35) -> np.ndarray:
    """Each zero pixel of ``image`` ([..., H, W] float of {0, 1}) gets an
    approximate distance to the nearest non-zero pixel: the growing
    boundary is convolved with an exp(-d/h) kernel and -h*log of the
    response read, round by round. Non-zero pixels return 0."""
    from scipy.signal import convolve2d

    img = np.asarray(image, np.float32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
    n, H, W = img.shape
    half = kernel_size // 2
    ki, kj = np.meshgrid(np.arange(kernel_size) - half, np.arange(kernel_size) - half,
                         indexing="ij")
    kernel = np.exp(-np.hypot(ki, kj) / h).astype(np.float32)
    out = np.zeros_like(img)
    n_iters = math.ceil(max(H, W) / half)
    for b in range(n):
        boundary = img[b].copy()
        for i in range(n_iters):
            cdt = convolve2d(np.pad(boundary, half, mode="edge"), kernel, mode="valid")
            with np.errstate(divide="ignore"):
                cdt = -h * np.log(cdt)
            cdt = np.nan_to_num(cdt, posinf=0.0)
            m = cdt > 0
            if not m.any():
                break
            out[b] += (i * half + cdt) * m
            boundary = np.where(m, 1.0, boundary)
    return out[0] if squeeze else out


# geopurify_tpu/data/visual_sampler.py:693
def _center_clicks(fp: np.ndarray) -> np.ndarray:
    """[N] flat index of the deepest pixel inside each of the [N, h, w]
    masks ``fp``: the argmax of the distance transform of the border-padded
    complement (the image border counts as boundary)."""
    n, h, w = fp.shape
    padded = np.pad(fp, ((0, 0), (1, 1), (1, 1)), constant_values=False)
    dt = distance_transform_conv((~padded).astype(np.float32))[:, 1:-1, 1:-1]
    return dt.reshape(n, -1).argmax(axis=1)
