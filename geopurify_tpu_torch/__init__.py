"""geopurify_tpu_torch — the PyTorch / CUDA port of geopurify_tpu.

Stage-2 inference (``models.pipeline.GeoPurifyPipeline.evaluate_scene``)
and its validation entry over on-disk scenes (``run.validate``, through the
data layer ``data.loaders``), and Stage-1 training
(``GeoPurifyPipeline.stage1_loss``, ``run.train``, ``run.precompute``) over
synthetic or on-disk scenes, with the released checkpoints converted on load
(``utils.convert_xdecoder``, ``utils.convert_sonata``), and the bench
(``run.bench``: scenes/s and steps/s, one JSON line), for one NVIDIA
H100; and the harness against the reference torch code (``parity``,
``run.parity --torch-oracle``). The JAX package ``geopurify_tpu`` stays the reference:
every module here cites its JAX counterpart by file:line, and the tests in
``tests/test_torch_port_*.py`` hold the two against each other on the CPU.

This package imports torch, numpy and pyyaml (the data layer also scipy
and Pillow) — never jax, flax, regex or anything of geopurify_tpu.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``cuda`` is the default of every
    entry point; asking for it on a machine without a card raises — nothing
    moves to the CPU unless the caller passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain CPU versions"
        )
    return dev
