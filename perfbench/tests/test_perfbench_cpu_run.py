"""Whole runs of the harness on the CPU at tiny widths: the cell loader, the
program's timed path, the reference and the comparison. A sound run comes
out correct; the control, and each fault a cell can have planted under the
timed path, come out not correct. The limits here are the tiny size's own
(its sound readings with room), not the cells' (set at the published
widths on the card); the mechanism under test is the same."""

import pytest
import torch

from perfbench import compare, faults, run, stage1, stage2
from perfbench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 7
CPU = torch.device("cpu")
# sound tiny runs read 4.3e-3 to 1.01e-2 (Stage 2: the program carries the
# smoothing rounds in bf16; the faults read 0.91-3.12, the control
# 1.25-2.24) and ~1e-7 (Stage 1)
TINY_S2 = {"logit_err_scene": 0.1}
TINY_S1 = {"loss_rel": 1e-4, "grad_leaf_gap": 1e-4, "change_leaf_gap": 1e-3}


def s2_cell():
    return dict(tiny_cell("scannet-s2-v64"), limits=TINY_S2)


def s1_cell():
    return dict(tiny_cell("scannet-s1-step"), limits=TINY_S1)


@pytest.mark.parametrize("trace", [False, True])
def test_stage2_sound_run(trace):
    res = run.run_cell(s2_cell(), SEED, 0.2, trace, CPU)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    if trace:
        # the stage spans are read; the device readers find nothing on a CPU
        assert {"views_s.s2", "fuse_fill_s.s2", "pool_classify_s.s2"} <= set(res["metrics"])
        assert "idle_pct.s2" not in res["metrics"]
    else:
        assert set(res["metrics"]) == {"scenes_per_s", "peak_gib", "setup_s"}
    assert list(res["checks"]) == list(TINY_S2)


def test_stage1_sound_run():
    res = run.run_cell(s1_cell(), SEED, 0.2, False, CPU)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"step_s", "peak_gib", "setup_s"}


@pytest.mark.parametrize("name", [n for n, f in faults.FAULTS.items() if f[0] == 2])
def test_stage2_fault_is_caught(name):
    _, hooks, ctx = faults.FAULTS[name]
    with ctx():
        res = run.run_cell(s2_cell(), SEED, 0.2, False, CPU, **hooks)
    assert not res["correct"] and res["failed"] == 1, res["checks"]


@pytest.mark.parametrize("name", [n for n, f in faults.FAULTS.items() if f[0] == 1])
def test_stage1_fault_is_caught(name):
    _, hooks, ctx = faults.FAULTS[name]
    with ctx():
        res = run.run_cell(s1_cell(), SEED, 0.2, False, CPU, **hooks)
    assert not res["correct"], res["checks"]


def test_controls_fail_the_limits():
    """The reference a precision step down in the program's place."""
    n2 = stage2.control(s2_cell(), SEED, CPU)
    assert not all(c["ok"] for c in compare.judge(n2, TINY_S2).values()), n2
    n1 = stage1.control(s1_cell(), SEED, CPU)
    assert not all(c["ok"] for c in compare.judge(n1, TINY_S1).values()), n1
