"""A cell's runner, found by name: the default from ``stage``, a runner the
workload file names, the exit that names a missing runner's file; and a
runner of a new kind that exists only here (``toy_runner``), which reuses
Stage 1's set-up, window and comparison through ``stage1.run``'s seams with
a teacher computed inside the timed call. Its sound tiny CPU run is correct,
a teacher fault planted under the timed path is caught, and its control
fails the limits."""

import pytest
import torch

from perfbench import cells, run, stage1, stage2
from perfbench.tests import toy_runner
from perfbench.tests.test_perfbench_cpu_run import SEED, TINY_S1
from perfbench.tests.tiny import tiny_cell

CPU = torch.device("cpu")
CELLS = {"scannet-s2-v64": stage2, "matterport160-s2-large": stage2,
         "scannet-s1-step": stage1, "matterport160-s1-large": stage1}
# the toy's teacher is the same f32 map on both sides: sound runs read 0;
# the control's bf16 map reads ~3e-3, an altered teacher 1e-2
TINY_TOY = dict(TINY_S1, teacher_gap=1e-4)


def toy_cell():
    return dict(tiny_cell("scannet-s1-step"), runner="tests.toy_runner", limits=TINY_TOY)


def with_runner(monkeypatch, name):
    """``load_cell`` over a workload file that names the runner ``name``."""
    real = cells._read

    def read(kind, cell):
        out = real(kind, cell)
        return dict(out, runner=name) if kind == "workloads" else out

    monkeypatch.setattr(cells, "_read", read)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_default_runner_from_stage(name):
    cell = cells.load_cell(name)
    assert cell["runner"] == cells.DEFAULT_RUNNER[cell["stage"]]
    assert cells.runner(cell) is CELLS[name]


def test_runner_named_by_the_workload_file(monkeypatch):
    with_runner(monkeypatch, "tests.toy_runner")
    cell = cells.load_cell("scannet-s1-step")
    assert cell["runner"] == "tests.toy_runner" and cells.runner(cell) is toy_runner


@pytest.mark.parametrize("name", ["nowhere", "tests.nowhere", "..stage1", "stage1/x"])
def test_unknown_runner_exits_naming_its_file(monkeypatch, name):
    with_runner(monkeypatch, name)
    with pytest.raises(SystemExit, match=r"no runner named .*\.py is missing"):
        cells.load_cell("scannet-s1-step")
    with pytest.raises(SystemExit, match="no runner named"):
        cells.runner({"runner": name})


def test_toy_work_adds_the_teacher_to_the_step():
    cell = toy_cell()
    w, base = toy_runner.work(cell), stage1.work(cell)
    tr = cell["traffic"]
    assert w["parts"]["teacher"] == 2 * tr["scene"]["points"] * 6 * tr["teacher_dim"]
    assert w["flops_per_item"] == pytest.approx(base["flops_per_item"] + w["parts"]["teacher"])


@pytest.mark.parametrize("trace", [False, True])
def test_toy_sound_run(trace):
    res = run.run_cell(toy_cell(), SEED, 0.2, trace, CPU)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert list(res["checks"]) == list(TINY_TOY)
    if trace:
        assert {"forward_s.s1", "backward_s.s1", "update_s.s1"} <= set(res["metrics"])
    else:
        assert set(res["metrics"]) == {"step_s", "peak_gib", "setup_s"}


def test_toy_teacher_fault_is_caught():
    """The teacher's features altered where they are produced, inside the
    timed call."""
    res = run.run_cell(toy_cell(), SEED, 0.2, False, CPU,
                       teach=lambda w, geom: (geom @ w) * 1.01)
    gap = res["checks"]["teacher_gap"]
    assert not res["correct"] and gap["value"] > gap["limit"], res["checks"]


def test_toy_control_fails_the_limits():
    numbers = toy_runner.control(toy_cell(), SEED, CPU)
    assert numbers["teacher_gap"] > TINY_TOY["teacher_gap"], numbers
    assert numbers["loss_rel"] > TINY_TOY["loss_rel"], numbers
