"""The reference's dataset-registry catalog: all 17 registration families.

Port of geopurify_tpu/data/registry_catalog.py: the metadata layer of the
reference's X-Decoder registration modules and their mapper wiring, as
registered names, class tables (or class counts for the large COCO / ADE
catalogs), ignore labels, the reference's evaluator-type strings, the
``build_evaluator`` family and the mapper kind (``data/mappers.MAPPER_KINDS``)
of each dataset. The data itself is the user's: each factory returns an
``ExternalDataset`` that resolves its on-disk directory under a root (or
``$DATASET``) and raises, naming the expected layout, when it is missing.
The class tables (SCAN_20 / 37 / 40, SUN_RGBD_37, BDD_SEM, BDD_PANO,
PASCAL_20) are protocol constants, copied.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

from geopurify_tpu_torch.data.registry import DatasetMeta, register

# --- class tables (reference utils/constants.py) ---
SCAN_20 = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture",
)
SCAN_37 = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "blinds", "desk", "shelves",
    "curtain", "dresser", "pillow", "mirror", "floor mat", "clothes",
    "ceiling", "books", "refridgerator", "television", "paper", "towel",
    "shower curtain", "box", "whiteboard", "person", "night stand", "toilet",
    "sink", "lamp", "bathtub", "bag",
)
SCAN_40 = SCAN_37 + ("otherstructure", "otherfurniture", "otherprop")
SUN_RGBD_37 = SCAN_37
BDD_SEM = (
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
)
BDD_PANO = (
    "dynamic", "ego vehicle", "ground", "static", "parking", "rail track",
    "road", "sidewalk", "bridge", "building", "fence", "garage", "guard rail",
    "tunnel", "wall", "banner", "billboard", "lane divider", "parking sign",
    "pole", "polegroup", "street light", "traffic cone", "traffic device",
    "traffic light", "traffic sign", "traffic sign frame", "terrain",
    "vegetation", "sky", "person", "rider", "bicycle", "bus", "car",
    "caravan", "motorcycle", "trailer", "train", "truck",
)
PASCAL_20 = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)

# reference evaluator_type string -> our build_evaluator family
# geopurify_tpu/data/registry_catalog.py:65
EVALUATOR_FAMILY = {
    "sem_seg": "sem_seg",
    "coco_panoptic_seg": "panoptic",
    "ade20k_panoptic_seg": "panoptic",
    "scannet_panoptic_seg": "panoptic",
    "bdd_panoptic_pano": "panoptic",
    "instance": "instance",
    "classification": "classification",
    "interactive": "interactive",
    "grounding_refcoco": "grounding",
    "retrieval": "retrieval",
    "captioning": "captioning",
}


# geopurify_tpu/data/registry_catalog.py:80
@dataclass
class ExternalDataset:
    """Descriptor for a registered dataset whose raw data is user-supplied.

    ``resolve()`` checks the expected on-disk layout under ``root`` and
    returns the concrete paths; without a root (or with a missing layout)
    it raises with the expected structure spelled out — mirroring the
    reference's DATASET-env-rooted loaders."""

    name: str
    dirname: str                     # expected subdirectory under the root
    split: str = "val"
    mapper: str = ""                 # dataset_mappers/ module kind
    root: Optional[str] = None

    def resolve(self) -> str:
        root = self.root or os.environ.get("DATASET", "")
        path = os.path.join(root, self.dirname) if root else ""
        if not path or not os.path.isdir(path):
            raise FileNotFoundError(
                f"dataset '{self.name}' expects its raw data at "
                f"<root>/{self.dirname} (split '{self.split}', mapper "
                f"'{self.mapper}'); pass root= or set $DATASET"
            )
        return path


# geopurify_tpu/data/registry_catalog.py:107
def _ext(name, dirname, split, mapper):
    def factory(root: Optional[str] = None) -> ExternalDataset:
        return ExternalDataset(
            name=name, dirname=dirname, split=split, mapper=mapper, root=root
        )

    return factory


# geopurify_tpu/data/registry_catalog.py:116
def _reg(name, dirname, split, mapper, ref_evaluator, *, family_module,
         class_names=(), num_classes=None, ignore_label=255):
    register(
        name,
        _ext(name, dirname, split, mapper),
        DatasetMeta(
            name=name,
            class_names=tuple(class_names),
            ignore_label=ignore_label,
            evaluator_type=EVALUATOR_FAMILY[ref_evaluator],
            extra={
                "ref_evaluator_type": ref_evaluator,
                "mapper": mapper,
                "registration_module": family_module,
                "num_classes": (
                    num_classes if num_classes is not None else len(class_names)
                ),
                "split": split,
            },
        ),
    )


# geopurify_tpu/data/registry_catalog.py:139
def register_catalog() -> None:
    """Register the 17 reference registration families (idempotent)."""
    if getattr(register_catalog, "_done", False):
        return
    register_catalog._done = True

    # 1. register_ade20k_full.py: 847-class ADE-full, 16-bit TIFF gt
    for split in ("train", "val"):
        _reg(f"ade20k_full_sem_seg_{split}", "ADE20K_2021_17_01", split,
             "mask_former_semantic_dataset_mapper", "sem_seg",
             family_module="register_ade20k_full", num_classes=847,
             ignore_label=65535)
    # 2. register_ade20k_instance.py: 100 thing classes
    for split in ("train", "val"):
        _reg(f"ade20k_instance_{split}", "ADEChallengeData2016", split,
             "coco_instance_new_baseline_dataset_mapper", "instance",
             family_module="register_ade20k_instance", num_classes=100)
    # 3. register_ade20k_panoptic.py: 150 classes
    for split in ("train", "val"):
        _reg(f"ade20k_panoptic_{split}", "ADEChallengeData2016", split,
             "mask_former_panoptic_dataset_mapper", "ade20k_panoptic_seg",
             family_module="register_ade20k_panoptic", num_classes=150)
    # 4. register_bdd100k_panoseg.py
    _reg("bdd10k_40_panoptic_val", "bdd100k", "val",
         "mask_former_panoptic_dataset_mapper", "bdd_panoptic_pano",
         family_module="register_bdd100k_panoseg", class_names=BDD_PANO)
    # 5. register_bdd100k_semseg.py
    _reg("bdd10k_val_sem_seg", "bdd100k", "val",
         "bdd_semseg_dataset_mapper", "sem_seg",
         family_module="register_bdd100k_semseg", class_names=BDD_SEM)
    # 6. register_coco_lvis_panoptic_annos_caption_grounding.py
    for base in ("coco_2017_train_panoptic_filtrefgumdval",
                 "coco_2017_train_panoptic_filtall"):
        _reg(f"{base}_with_sem_seg_caption_grounding_lvis", "coco", "train",
             "coco_panoptic_interactive_dataset_mapper", "coco_panoptic_seg",
             family_module="register_coco_lvis_panoptic_annos_caption_grounding",
             num_classes=133)
    # 7. register_coco_panoptic_annos_caption.py
    for split in ("train", "val"):
        _reg(f"coco_2017_{split}_panoptic_with_sem_seg_caption", "coco", split,
             "coco_panoptic_new_baseline_dataset_mapper", "coco_panoptic_seg",
             family_module="register_coco_panoptic_annos_caption",
             num_classes=133)
    # 8. register_coco_panoptic_annos_caption_grounding.py
    for base in ("coco_2017_train_panoptic", "coco_2017_train_panoptic_filtkar",
                 "coco_2017_train_panoptic_filtrefgumdval",
                 "coco_2017_train_panoptic_filtall"):
        _reg(f"{base}_with_sem_seg_caption_grounding", "coco", "train",
             "coco_panoptic_interactive_dataset_mapper", "coco_panoptic_seg",
             family_module="register_coco_panoptic_annos_caption_grounding",
             num_classes=133)
    # 9. register_coco_panoptic_annos_semseg.py
    for split in ("train", "val"):
        _reg(f"coco_2017_{split}_panoptic_with_sem_seg", "coco", split,
             "mask_former_panoptic_dataset_mapper", "coco_panoptic_seg",
             family_module="register_coco_panoptic_annos_semseg",
             num_classes=133)
    # 10. register_coco_stuff_10k.py: 171 stuff+thing classes
    for split in ("train", "test"):
        _reg(f"coco_2017_{split}_stuff_10k_sem_seg", "coco/coco_stuff_10k",
             split, "mask_former_semantic_dataset_mapper", "sem_seg",
             family_module="register_coco_stuff_10k", num_classes=171)
    # 11. register_imagenet_cls.py
    _reg("imagenet_val", "imagenet", "val", "imagenet_dataset_mapper",
         "classification", family_module="register_imagenet_cls",
         num_classes=1000)
    # 12. register_pascalvoc_eval.py: interactive eval, 5 prompt modes
    for mode in ("Point", "Scribble", "Polygon", "Circle", "Box"):
        _reg(f"pascalvoc_val_{mode}", "PascalVOC", "val",
             "pascalvoc_dataset_mapper_ix", "interactive",
             family_module="register_pascalvoc_eval", class_names=PASCAL_20)
    # 13. register_refcoco_dataset.py
    _reg("refcocog_val_umd", "coco", "val", "refcoco_dataset_mapper",
         "grounding_refcoco", family_module="register_refcoco_dataset",
         num_classes=0)
    # 14. register_scannet_panoptic.py
    _reg("scannet_21_panoptic_val", "scannet_frames_25k", "val",
         "scannet_pano_dataset_mapper", "scannet_panoptic_seg",
         family_module="register_scannet_panoptic", class_names=SCAN_20)
    # 15. register_scannet_semseg.py: 41/38/21-label subsets
    for name, classes in (("scannet_41_val_seg", SCAN_40),
                          ("scannet_38_val_seg", SCAN_37),
                          ("scannet_21_val_seg", SCAN_20)):
        _reg(name, "scannet_frames_25k", "val", "scannet_dataset_mapper",
             "sem_seg", family_module="register_scannet_semseg",
             class_names=classes)
    # 16. register_sunrgbd_semseg.py
    _reg("sunrgbd_37_val_seg", "sun_rgbd", "val", "sunrgbd_dataset_mapper",
         "sem_seg", family_module="register_sunrgbd_semseg",
         class_names=SUN_RGBD_37)
    # 17. register_vlp_datasets.py (evaluator per name, arrow-file shards)
    for name, ev in (("vlp_train", "retrieval"), ("vlp_val", "retrieval"),
                     ("vlp_captioning_val", "captioning"),
                     ("vlp_val2017", "retrieval"),
                     ("vlp_captioning_val2017", "captioning")):
        _reg(name, "coco_caption", name.split("_")[-1], "vlp_dataset_mapper",
             ev, family_module="register_vlp_datasets", num_classes=0)


# geopurify_tpu/data/registry_catalog.py:238
FAMILY_MODULES: Tuple[str, ...] = (
    "register_ade20k_full", "register_ade20k_instance",
    "register_ade20k_panoptic", "register_bdd100k_panoseg",
    "register_bdd100k_semseg",
    "register_coco_lvis_panoptic_annos_caption_grounding",
    "register_coco_panoptic_annos_caption",
    "register_coco_panoptic_annos_caption_grounding",
    "register_coco_panoptic_annos_semseg", "register_coco_stuff_10k",
    "register_imagenet_cls", "register_pascalvoc_eval",
    "register_refcoco_dataset", "register_scannet_panoptic",
    "register_scannet_semseg", "register_sunrgbd_semseg",
    "register_vlp_datasets",
)
