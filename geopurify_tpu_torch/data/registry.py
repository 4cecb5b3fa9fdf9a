"""Dataset registry: named datasets with a factory and their metadata.

Port of geopurify_tpu/data/registry.py (the reference's detectron2-style
registration layer and MetadataCatalog): a dataset registers a factory
and a ``DatasetMeta`` (class names, ignore label, evaluator type);
consumers resolve it by name. The port's registry is its own dict, filled
when this module is imported: the six GeoPurify presets (their factories
build the port's ``data/loaders.SceneDataset`` on the device the caller
names, the card by default), ``seg2d_folder`` (``data/seg2d.Seg2DDataset``)
and the 17 catalog families of ``data/registry_catalog.py``.
``build_evaluator`` dispatches to the port's ``utils/eval2d`` and
``utils/eval2d_suite``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple


# geopurify_tpu/data/registry.py:19
@dataclass
class DatasetMeta:
    name: str
    class_names: Tuple[str, ...] = ()
    ignore_label: int = 255
    evaluator_type: str = "sem_seg"      # sem_seg | panoptic | instance |
    # retrieval | grounding | captioning | classification | interactive
    extra: Dict[str, Any] = field(default_factory=dict)


# geopurify_tpu/data/registry.py:29
_REGISTRY: Dict[str, Tuple[Callable[..., Any], DatasetMeta]] = {}


# geopurify_tpu/data/registry.py:32
def register(name: str, factory: Callable[..., Any], meta: DatasetMeta) -> None:
    if name in _REGISTRY:
        raise KeyError(f"dataset '{name}' already registered")
    _REGISTRY[name] = (factory, meta)


# geopurify_tpu/data/registry.py:38
def get(name: str, **kwargs) -> Any:
    factory, _ = _REGISTRY[name]
    return factory(**kwargs)


# geopurify_tpu/data/registry.py:43
def metadata(name: str) -> DatasetMeta:
    return _REGISTRY[name][1]


# geopurify_tpu/data/registry.py:47
def list_datasets() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# geopurify_tpu/data/registry.py:51
def _register_builtin() -> None:
    """The datasets buildable in-tree: the 6 GeoPurify presets (3D scene
    eval, reference config/geopurify_*.yaml) and the 2D on-disk layouts
    (data/seg2d.py)."""
    from geopurify_tpu_torch.config import load_config

    def preset_factory(preset: str):
        def build(data_root: Optional[str] = None, split: str = "eval", device="cuda"):
            from geopurify_tpu_torch.data.loaders import SceneDataset

            cfg = load_config(preset)
            if data_root:
                import dataclasses

                cfg = dataclasses.replace(
                    cfg, data=dataclasses.replace(cfg.data, data_root=data_root)
                )
            return SceneDataset(cfg, split=split, device=device)

        return build

    for preset in ("scannet", "scannet200", "matterport",
                   "matterport40", "matterport80", "matterport160"):
        cfg = load_config(preset)
        register(
            f"geopurify_{preset}", preset_factory(preset),
            DatasetMeta(
                name=f"geopurify_{preset}",
                class_names=tuple(cfg.data.all_label),
                ignore_label=cfg.data.ignore_label,
                evaluator_type="sem_seg",
                extra={
                    "base_category": tuple(cfg.data.base_category),
                    "novel_category": tuple(cfg.data.novel_category),
                    "foreground_category": cfg.data.foreground_category(),
                },
            ),
        )

    def seg2d_factory(root: str):
        from geopurify_tpu_torch.data.seg2d import Seg2DDataset

        return Seg2DDataset(root)

    register(
        "seg2d_folder", seg2d_factory,
        DatasetMeta(name="seg2d_folder", evaluator_type="instance"),
    )


_register_builtin()

# the reference's 17 registration families (metadata + external-data
# factories) — see data/registry_catalog.py
from geopurify_tpu_torch.data.registry_catalog import register_catalog  # noqa: E402

register_catalog()


# geopurify_tpu/data/registry.py:113
def build_evaluator(name_or_type: str, **kwargs):
    """Evaluator dispatch by dataset name or evaluator type
    (≙ the reference's build_evaluator switch in its trainer pipeline)."""
    etype = name_or_type
    if name_or_type in _REGISTRY:
        meta = metadata(name_or_type)
        etype = meta.evaluator_type
        # dataset-derived defaults (the reference pulls these from
        # MetadataCatalog inside each evaluator's __init__)
        nc = len(meta.class_names) or meta.extra.get("num_classes", 0)
        # only default num_classes from real metadata — injecting 0 for a
        # metadata-less dataset silently builds a degenerate evaluator;
        # let the evaluator's required-arg error surface instead
        if etype in ("sem_seg", "instance") and nc > 0:
            kwargs.setdefault("num_classes", nc)
        if etype == "sem_seg":
            kwargs.setdefault("ignore_label", meta.ignore_label)
            kwargs.setdefault("class_names", meta.class_names or None)
    from geopurify_tpu_torch.utils import eval2d_suite as ev

    if etype == "sem_seg":
        from geopurify_tpu_torch.utils.eval2d import SemSeg2DEvaluator

        return SemSeg2DEvaluator(**kwargs)
    table = {
        "panoptic": ev.PanopticEvaluator,
        "instance": ev.InstanceEvaluator,
        "retrieval": ev.RetrievalEvaluator,
        "grounding": ev.GroundingEvaluator,
        "captioning": ev.CaptioningEvaluator,
        "classification": ev.ClassificationEvaluator,
        "interactive": ev.InteractiveEvaluator,
    }
    return table[etype](**kwargs)
