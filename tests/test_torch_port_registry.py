"""The port's dataset registry and its catalog held against the JAX
package's: the same names, class tables, ignore labels, evaluator types,
mapper kinds and families; ``build_evaluator`` builds, for every
registered name and every evaluator type, the port's counterpart of the
JAX evaluator, with the same dataset-derived defaults; the preset
factories build the port's ``SceneDataset`` on the device asked for, and
``seg2d_folder`` its ``Seg2DDataset``; ``ExternalDataset`` resolves a root
or raises naming the expected layout."""

import dataclasses

import numpy as np
import pytest
import torch

from geopurify_tpu.data import registry as JR
from geopurify_tpu.data import registry_catalog as JC
from geopurify_tpu_torch.data import mappers as TM
from geopurify_tpu_torch.data import registry as TR
from geopurify_tpu_torch.data import registry_catalog as TC


def test_names_and_metadata_equal_jaxs():
    names = TR.list_datasets()
    assert names == JR.list_datasets() and len(names) == 44
    for name in names:
        t, j = TR.metadata(name), JR.metadata(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
    assert TC.FAMILY_MODULES == JC.FAMILY_MODULES and len(TC.FAMILY_MODULES) == 17
    assert TC.EVALUATOR_FAMILY == JC.EVALUATOR_FAMILY
    for table in ("SCAN_20", "SCAN_37", "SCAN_40", "SUN_RGBD_37", "BDD_SEM", "BDD_PANO",
                  "PASCAL_20"):
        assert getattr(TC, table) == getattr(JC, table), table
    families = {TR.metadata(n).extra.get("registration_module") for n in names} - {None}
    assert families == set(TC.FAMILY_MODULES)
    # every mapper kind the catalog names has a body
    kinds = {TR.metadata(n).extra.get("mapper") for n in names} - {None}
    assert kinds <= set(TM.MAPPER_KINDS)
    TC.register_catalog()        # idempotent
    assert TR.list_datasets() == names


def _evaluator_state(ev):
    return {k: v for k, v in vars(ev).items() if not callable(v)}


@pytest.mark.parametrize("family", sorted(set(JC.EVALUATOR_FAMILY.values())))
def test_build_evaluator_counterparts(family):
    names = [n for n in TR.list_datasets() if TR.metadata(n).evaluator_type == family]
    kw = {"num_classes": 3} if family in ("sem_seg", "instance") else {}
    cases = [(family, kw)] + [(n, {}) for n in names]
    for name, kw in cases:
        meta = JR.metadata(name) if name in JR.list_datasets() else None
        nc = (len(meta.class_names) or meta.extra.get("num_classes", 0)) if meta else 1
        if family in ("sem_seg", "instance") and nc == 0:
            # no class count in the metadata: the evaluator's own error, in both
            for reg in (TR, JR):
                with pytest.raises(TypeError):
                    reg.build_evaluator(name)
            continue
        t, j = TR.build_evaluator(name, **kw), JR.build_evaluator(name, **kw)
        assert type(t).__name__ == type(j).__name__, name
        assert type(t).__module__.startswith("geopurify_tpu_torch.utils.eval2d"), name
        ts, js = _evaluator_state(t), _evaluator_state(j)
        assert sorted(ts) == sorted(js), name
        for k in js:
            if isinstance(js[k], (int, float, str, tuple, list, type(None))):
                assert ts[k] == js[k], (name, k)


def test_preset_factories_and_seg2d_folder(tmp_path):
    ds = TR.get("geopurify_scannet", data_root=str(tmp_path), split="eval", device="cpu")
    assert type(ds).__module__ == "geopurify_tpu_torch.data.loaders"
    assert ds.cfg.data.data_root == str(tmp_path) and ds.split == "eval"
    assert ds.device.type == "cpu" and len(ds) > 0
    jds = JR.get("geopurify_scannet", data_root=str(tmp_path), split="eval")
    assert ds.scene_ids == jds.scene_ids
    meta = TR.metadata("geopurify_matterport160")
    assert len(meta.class_names) == 160 and meta.evaluator_type == "sem_seg"
    if not torch.cuda.is_available():        # the card by default, as the entry points
        with pytest.raises(RuntimeError, match="cuda"):
            TR.get("geopurify_scannet", data_root=str(tmp_path))
    (tmp_path / "images").mkdir()
    (tmp_path / "masks").mkdir()
    from PIL import Image

    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "images" / "a.png")
    Image.fromarray(np.ones((8, 8), np.uint8)).save(tmp_path / "masks" / "a.png")
    seg = TR.get("seg2d_folder", root=str(tmp_path))
    assert type(seg).__module__ == "geopurify_tpu_torch.data.seg2d"
    with pytest.raises(KeyError, match="already registered"):
        TR.register("seg2d_folder", lambda: None, TR.DatasetMeta(name="seg2d_folder"))


def test_external_dataset_resolves_or_names_the_layout(tmp_path, monkeypatch):
    monkeypatch.delenv("DATASET", raising=False)
    ext = TR.get("scannet_21_val_seg")
    assert (ext.dirname, ext.split, ext.mapper) == ("scannet_frames_25k", "val",
                                                    "scannet_dataset_mapper")
    with pytest.raises(FileNotFoundError, match="scannet_frames_25k"):
        ext.resolve()
    (tmp_path / "scannet_frames_25k").mkdir()
    assert TR.get("scannet_21_val_seg", root=str(tmp_path)).resolve() == \
        str(tmp_path / "scannet_frames_25k")
    monkeypatch.setenv("DATASET", str(tmp_path))
    assert ext.resolve() == str(tmp_path / "scannet_frames_25k")
