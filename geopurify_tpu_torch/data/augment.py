"""Point-cloud and colour augmentations (host-side numpy).

Port of geopurify_tpu/data/augment.py: chromatic translation /
auto-contrast / jitter, HSV shift, random horizontal flip and elastic
distortion, plus a Compose. Each draws from the caller's
``np.random.Generator`` with the same calls in the same order as the JAX
package's, so a seed gives the same arrays in both.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.ndimage
import scipy.interpolate

Arrays = Tuple[np.ndarray, np.ndarray, np.ndarray]


# geopurify_tpu/data/augment.py:22
class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, coords, feats, labels, rng: np.random.Generator):
        for t in self.transforms:
            coords, feats, labels = t(coords, feats, labels, rng)
        return coords, feats, labels


# geopurify_tpu/data/augment.py:32
class ChromaticTranslation:
    """Add a global random color offset (+- 255*trans_range/2 per channel)."""

    def __init__(self, trans_range_ratio: float = 0.1):
        self.ratio = trans_range_ratio

    def __call__(self, coords, feats, labels, rng):
        if rng.random() < 0.95:
            tr = (rng.random((1, 3)) - 0.5) * 255 * 2 * self.ratio
            feats = feats.copy()
            feats[:, :3] = np.clip(tr + feats[:, :3], 0, 255)
        return coords, feats, labels


# geopurify_tpu/data/augment.py:46
class ChromaticAutoContrast:
    """Blend toward a per-cloud contrast-stretched version."""

    def __init__(self, randomize_blend_factor: bool = True, blend_factor: float = 0.5):
        self.randomize = randomize_blend_factor
        self.blend_factor = blend_factor

    def __call__(self, coords, feats, labels, rng):
        if rng.random() < 0.2:
            lo = feats[:, :3].min(0, keepdims=True)
            hi = feats[:, :3].max(0, keepdims=True)
            scale = 255 / np.maximum(hi - lo, 1e-6)
            contrast = (feats[:, :3] - lo) * scale
            blend = rng.random() if self.randomize else self.blend_factor
            feats = feats.copy()
            feats[:, :3] = (1 - blend) * feats[:, :3] + blend * contrast
        return coords, feats, labels


# geopurify_tpu/data/augment.py:65
class ChromaticJitter:
    def __init__(self, std: float = 0.01):
        self.std = std

    def __call__(self, coords, feats, labels, rng):
        if rng.random() < 0.95:
            noise = rng.standard_normal((feats.shape[0], 3)) * self.std * 255
            feats = feats.copy()
            feats[:, :3] = np.clip(feats[:, :3] + noise, 0, 255)
        return coords, feats, labels


# geopurify_tpu/data/augment.py:77
class HueSaturationTranslation:
    def __init__(self, hue_max: float = 0.5, saturation_max: float = 0.2):
        self.hue_max = hue_max
        self.saturation_max = saturation_max

    def __call__(self, coords, feats, labels, rng):
        rgb = feats[:, :3] / 255.0
        mx = rgb.max(-1)
        mn = rgb.min(-1)
        delta = mx - mn
        # vectorized rgb->hsv
        h = np.zeros_like(mx)
        mask = delta > 1e-12
        r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
        idx = mask & (mx == r)
        h[idx] = ((g[idx] - b[idx]) / delta[idx]) % 6
        idx = mask & (mx == g)
        h[idx] = (b[idx] - r[idx]) / delta[idx] + 2
        idx = mask & (mx == b)
        h[idx] = (r[idx] - g[idx]) / delta[idx] + 4
        h = h / 6.0
        s = np.where(mx > 1e-12, delta / np.maximum(mx, 1e-12), 0.0)
        v = mx

        h = (h + (rng.random() - 0.5) * 2 * self.hue_max) % 1.0
        s = np.clip(s + (rng.random() - 0.5) * 2 * self.saturation_max, 0, 1)

        # hsv->rgb
        i = np.floor(h * 6).astype(int) % 6
        f = h * 6 - np.floor(h * 6)
        p = v * (1 - s)
        q = v * (1 - f * s)
        t = v * (1 - (1 - f) * s)
        out = np.choose(
            i[:, None],
            [
                np.stack([v, t, p], 1), np.stack([q, v, p], 1),
                np.stack([p, v, t], 1), np.stack([p, q, v], 1),
                np.stack([t, p, v], 1), np.stack([v, p, q], 1),
            ],
        )
        feats = feats.copy()
        feats[:, :3] = np.clip(out * 255.0, 0, 255)
        return coords, feats, labels


# geopurify_tpu/data/augment.py:123
class RandomHorizontalFlip:
    """Flip x and/or y with probability 0.5 each (upright axis z)."""

    def __init__(self, upright_axis: str = "z"):
        self.upright = {"x": 0, "y": 1, "z": 2}[upright_axis.lower()]
        self.horz_axes = [a for a in range(3) if a != self.upright]

    def __call__(self, coords, feats, labels, rng):
        coords = coords.copy()
        for ax in self.horz_axes:
            if rng.random() < 0.5:
                mx = coords[:, ax].max()
                coords[:, ax] = mx - coords[:, ax]
                if feats.shape[1] >= 6:  # flip the normal channel too
                    feats = feats.copy()
                    feats[:, 3 + ax] = -feats[:, 3 + ax]
        return coords, feats, labels


# geopurify_tpu/data/augment.py:142
class ElasticDistortion:
    """Blurred-noise displacement grid interpolated at the points
    (reference dataset/augmentation.py ElasticDistortion)."""

    def __init__(self, distortion_params: Optional[Sequence[Tuple[float, float]]] = None):
        self.params = distortion_params or [(0.2, 0.4), (0.8, 1.6)]

    @staticmethod
    def distort(coords: np.ndarray, granularity: float, magnitude: float,
                rng: np.random.Generator) -> np.ndarray:
        lo = coords.min(0)
        noise_dim = ((coords - lo).max(0) // granularity).astype(int) + 3
        noise = rng.standard_normal((*noise_dim, 3)).astype(np.float32)
        for ax in range(3):  # triple box-blur per axis
            noise = scipy.ndimage.uniform_filter1d(noise, size=3, axis=ax)
            noise = scipy.ndimage.uniform_filter1d(noise, size=3, axis=ax)
            noise = scipy.ndimage.uniform_filter1d(noise, size=3, axis=ax)
        ax_grids = [
            lo[i] + granularity * (np.arange(noise_dim[i]) - 1)
            for i in range(3)
        ]
        interp = scipy.interpolate.RegularGridInterpolator(
            ax_grids, noise, bounds_error=False, fill_value=0
        )
        return coords + interp(coords) * magnitude

    def __call__(self, coords, feats, labels, rng):
        if rng.random() < 0.95:
            for granularity, magnitude in self.params:
                coords = self.distort(coords, granularity, magnitude, rng)
        return coords, feats, labels


# geopurify_tpu/data/augment.py:175
def default_train_augmentations(
    elastic: bool = True,
    chromatic: bool = True,
) -> Compose:
    ts: List = []
    if elastic:
        ts.append(ElasticDistortion())
    ts.append(RandomHorizontalFlip("z"))
    if chromatic:
        ts += [
            ChromaticAutoContrast(),
            ChromaticTranslation(0.1),
            ChromaticJitter(0.05),
            HueSaturationTranslation(0.5, 0.2),
        ]
    return Compose(ts)
