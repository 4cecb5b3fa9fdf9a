"""Registry of the alternative 2D-lift backends (LSeg / APE).

Port of geopurify_tpu/models/lift_backends.py. ``xdecoder.lift_backend``
(``run.validate --lift-backend {xdecoder,lseg,ape}``) selects the 2D
teacher; lseg and ape resolve through this registry. Neither model is in
the reference tree or in the JAX package: a port of either registers its
callable with ``register_backend`` before the pipeline is built, and
selecting an unregistered one raises.

Backend callables follow ``models/lift_variants.py``'s protocols:
- lseg-style (dense):    image [H, W, 3] -> pixel features [H', W', C]
- ape-style (instance):  image [H, W, 3] -> (masks [Q, H', W'] logits,
                         embeds [Q, C], scores [Q])
"""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


# geopurify_tpu/models/lift_backends.py:24
def register_backend(name: str, fn: Callable) -> None:
    """Register a lift backend callable under ``name`` (e.g. 'lseg', 'ape')."""
    _REGISTRY[name.lower()] = fn


# geopurify_tpu/models/lift_backends.py:29
def get_backend(name: str) -> Callable:
    key = name.lower()
    if key in _REGISTRY:
        return _REGISTRY[key]
    raise KeyError(
        f"No {name!r} lift backend registered. The reference's LSeg/APE "
        "models are external checkouts (not vendored; affinity_module.py:"
        "348,736) — port one to PyTorch and call "
        "geopurify_tpu_torch.models.lift_backends.register_backend("
        f"{name!r}, fn) before building the pipeline.")


# geopurify_tpu/models/lift_backends.py:42
def available() -> Dict[str, Callable]:
    return dict(_REGISTRY)
