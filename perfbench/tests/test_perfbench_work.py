"""The counted work of ``work/<cell>.json`` against hand counts at a small
shape, and the committed files against a fresh derivation."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import derive_work, stage2
from perfbench.gen.scene import build_scene
from perfbench.tests.tiny import tiny_cell

WORK = Path(__file__).resolve().parents[1] / "work"


def neighbours_by_hand(vox: np.ndarray) -> int:
    """Existing 3^3 neighbours (the centre included) of every voxel."""
    have = {tuple(v) for v in vox.tolist()}
    r = (-1, 0, 1)
    return sum((x + a, y + b, z + c) in have for x, y, z in have
               for a in r for b in r for c in r)


def test_student_count_by_hand():
    cell = tiny_cell("scannet-s2-v64")
    s = cell["program"]["student"]
    scene = build_scene([3, 0], 1024, 512, 1, 16, (8, 8))
    taps = neighbours_by_hand(scene["voxel_coords"])
    H = s["hidden_dim"]
    fwd = 2 * taps * (s["input_dim"] * H + 2 * s["num_res_blocks"] * H * H) \
        + 2 * 512 * H * s["embed_dim"]
    assert derive_work.student_flops(cell["program"], scene, False)["student"] == fwd
    assert derive_work.student_flops(cell["program"], scene, True)["student"] == 3 * fwd


def test_dense_layer_count_by_hand():
    """The flop counter the X-Decoder's count comes from, on one layer."""
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.reference.layers import Conv, Dense

    with torch.device("meta"):
        d, c = Dense(48, 96).requires_grad_(False), Conv(8, 16, 3).requires_grad_(False)
        x, y = torch.zeros((5, 48)), torch.zeros((2, 10, 12, 8))
    with FlopCounterMode(display=False) as fc:
        d(x)
        c(y)
    assert fc.get_total_flops() == 2 * 5 * 48 * 96 + 2 * (2 * 10 * 12) * 16 * 8 * 9


def test_stage2_parts():
    cell = tiny_cell("scannet-s2-v64")
    w = stage2.work(cell)
    sc, pc = cell["traffic"]["scene"], cell["program"]["pooling"]
    n_cls = 19
    assert w["parts"]["smoothing"] == pc["num_iterations"] * 2 * sc["voxels"] * pc["knn_k"] * n_cls
    one = derive_work.xdecoder_flops_per_view(cell["program"], n_cls, (48, 64))
    assert w["parts"]["xdecoder"] == sc["views"] * one > 0
    assert w["flops_per_item"] == pytest.approx(sum(w["parts"].values()))
    assert w["k1"]["launches_per_item"] == pc["num_iterations"]


@pytest.mark.parametrize("name", sorted(p.stem for p in WORK.glob("*.json")))
def test_committed_stage1_work_is_current(name):
    """A Stage-1 cell's file (cheap to derive) equals a fresh derivation."""
    committed = json.loads((WORK / f"{name}.json").read_text())
    cell_stage = json.loads((WORK.parent / "workloads" / f"{name}.json").read_text())["stage"]
    if cell_stage != 1:
        assert committed["flops_per_item"] > 1e12 and committed["k1"]["C"] in (19, 160)
        return
    fresh = json.loads(json.dumps(derive_work.derive(name)))
    assert fresh == committed
