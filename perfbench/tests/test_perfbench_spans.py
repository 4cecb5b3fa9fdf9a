"""The span and counter readers (``spans.py`` and their ``metrics/``
files) on hand-made recorder items: the expected numbers, the steady
items, None off their stage or without the program's recorder; and traced
runs on the CPU, whose scenes (Stage 2) and steps (Stage 1) the program
records."""

import importlib.util
from pathlib import Path

import pytest
import torch

from geopurify_tpu_torch.utils import profiling
from perfbench import run, spans
from perfbench.tests.tiny import tiny_cell

METRICS = Path(__file__).resolve().parents[1] / "metrics"
S2 = {"backbone_s.s2": "scene/views/backbone", "pixel_decoder_s.s2": "scene/views/pixel_decoder",
      "head_s.s2": "scene/views/head", "student_s.s2": "scene/pool_classify/student",
      "graph_s.s2": "scene/pool_classify/graph", "smooth_s.s2": "scene/pool_classify/smooth"}
COUNTED = ("knn_fallback_pct.s2", "host_syncs.s2")
S1 = {"forward_s.s1": "step/forward", "backward_s.s1": "step/backward"}


def reader(name):
    spec = importlib.util.spec_from_file_location(f"m_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _item(secs, counts):
    return {"spans": {p: {"host_s": 2 * s, "device_s": s, "n": 1} for p, s in secs.items()},
            "counts": counts}


@pytest.fixture
def recorded(monkeypatch):
    """Three scene items and three step items, the first of each the
    set-up's."""
    scene = [_item({p: 9.0 for p in S2.values()},
                   {"host_syncs": 90, "knn_self.queries": 10, "knn_self.failed": 10}),
             _item({p: 1.0 for p in S2.values()},
                   {"host_syncs": 4, "knn_self.queries": 100, "knn_self.failed": 1}),
             _item({p: 3.0 for p in S2.values()},
                   {"host_syncs": 6, "knn_self.queries": 100, "knn_self.failed": 3})]
    step = [_item({p: 9.0 for p in S1.values()}, {}),
            _item({p: 1.0 for p in S1.values()}, {"host_syncs": 2}),
            _item({p: 3.0 for p in S1.values()}, {})]
    monkeypatch.setattr(profiling.RECORDER, "items",
                        lambda root: {"scene": scene, "step": step}[root])


def _rec(stage, n_steady):
    key = "stage_seconds" if stage == 2 else "split"
    return {"cell": {"stage": stage}, "trace_items": 1, key: [{}] * (1 + n_steady)}


@pytest.mark.parametrize("name", sorted(S2) + sorted(COUNTED) + sorted(S1))
def test_reader_reads_its_stage_only(recorded, name):
    mod = reader(name)
    stage = 1 if name.endswith(".s1") else 2
    assert mod.read(_rec(3 - stage, 2)) is None
    assert mod.read(_rec(stage, 2)) is not None


def test_span_and_counter_means_over_the_steady_items(recorded):
    rec2 = _rec(2, 2)                    # two steady scenes: the set-up's is left out
    for name in S2:
        assert reader(name).read(rec2) == pytest.approx(2.0)
    assert reader("host_syncs.s2").read(rec2) == pytest.approx(5.0)
    assert reader("knn_fallback_pct.s2").read(rec2) == pytest.approx(2.0)
    rec9 = _rec(2, 9)                    # fewer scenes recorded than steady: all of them
    assert reader("host_syncs.s2").read(rec9) == pytest.approx(100 / 3)
    assert spans.span_s(rec2, "scene/nowhere") is None
    rec1 = _rec(1, 2)                    # two steady steps
    for name in S1:
        assert reader(name).read(rec1) == pytest.approx(2.0)
    assert spans.count_mean(rec1, "step", "host_syncs") == pytest.approx(1.0)
    assert spans.count_mean(rec1, "scene", "host_syncs") is None


def test_readers_find_nothing_without_the_recorder(monkeypatch):
    monkeypatch.delattr(profiling, "RECORDER")
    for name in list(S2) + list(COUNTED):
        assert reader(name).read(_rec(2, 2)) is None
    for name in S1:
        assert reader(name).read(_rec(1, 2)) is None


def test_traced_stage2_run_on_the_cpu_reads_the_scenes_spans():
    profiling.RECORDER.clear()
    try:
        cell = dict(tiny_cell("scannet-s2-v64"), limits={"logit_err_scene": 0.1})
        res = run.run_cell(cell, 2 ** 31 + 7, 0.2, True, torch.device("cpu"))
    finally:
        profiling.RECORDER.clear()
    assert res["correct"], res["checks"]
    assert set(S2) | {"knn_fallback_pct.s2", "host_syncs.s2"} <= set(res["metrics"])
    m = res["metrics"]
    assert sum(m[n]["value"] for n in ("backbone_s.s2", "pixel_decoder_s.s2", "head_s.s2")) \
        <= m["views_s.s2"]["value"]
    assert m["host_syncs.s2"]["unit"] == "syncs/scene" and m["host_syncs.s2"]["value"] > 0


def test_traced_stage1_run_on_the_cpu_reads_the_steps_spans():
    profiling.RECORDER.clear()
    try:
        cell = dict(tiny_cell("scannet-s1-step"),
                    limits={"loss_rel": 1e-4, "grad_leaf_gap": 1e-4, "change_leaf_gap": 1e-3})
        res = run.run_cell(cell, 2 ** 31 + 7, 0.2, True, torch.device("cpu"))
        # the window's steps, and only they, were recorded: the set-up's
        # three ran with recording off
        steps = profiling.RECORDER.items("step")
    finally:
        profiling.RECORDER.clear()
    assert res["correct"], res["checks"]
    assert len(steps) == res["attempted"]
    assert {"step/forward", "step/loss", "step/backward", "step/optimizer"} <= set(steps[-1]["spans"])
    m = res["metrics"]
    assert set(S1) | {"sampler_s.s1", "update_s.s1"} <= set(m)
    assert 0 < m["forward_s.s1"]["value"] + m["backward_s.s1"]["value"] <= m["update_s.s1"]["value"]
