"""The port's span and counter recorder (``utils/profiling.py``): nesting,
parents, items and per-item counters; the fold into a bounded history when
the outermost block exits; the pool of CUDA events; the off path, which
records nothing and touches no CUDA event; the counted reads (``host_read``,
``nonzero``, ``masked``); the launch registry; the ``StageTimer`` summary
over its spans; and the spans that Stage 2's ``evaluate_scene`` and one
Stage-1 step record at the tiny preset, with outputs bit-equal whether
recording is on or off."""

from collections import deque

import numpy as np
import pytest
import torch

from geopurify_tpu_torch.config import load_config
from geopurify_tpu_torch.data.synthetic import make_scene_batch
from geopurify_tpu_torch.models.pipeline import GeoPurifyPipeline
from geopurify_tpu_torch.models.student import init_student_
from geopurify_tpu_torch.ops import knn
from geopurify_tpu_torch.run import train as ttrain
from geopurify_tpu_torch.run.optim import make_optimizer
from geopurify_tpu_torch.utils import profiling

SCENE = dict(n_points=400, n_views=2, max_points=512, max_voxels=512, max_views=2,
             max_view_points=64)


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.RECORDER.clear()
    yield
    profiling.RECORDER.clear()


def _assert_nested(rec: profiling.Recorder):
    """Every span lies inside its parent, on the host clock and on the
    device's, and its path extends its parent's."""
    rec.resolve()
    for s in rec.spans:
        if s.parent is None:
            assert "/" not in s.path
            continue
        p = s.parent
        assert s.path == f"{p.path}/{s.name}" and s.item == p.item
        assert p.t0 <= s.t0 <= s.t1 <= p.t1
        assert p.d0 <= s.d0 <= s.d1 <= p.d1


def test_spans_nest_with_parents_items_and_counters():
    with profiling.recording("cpu") as rec:
        profiling.count("loose")
        with profiling.span("scene", item=True):
            profiling.count("hits", 2)
            with profiling.span("views") as views:
                with profiling.span("backbone"):
                    profiling.count("hits")
            with profiling.span("views"):
                pass
        with profiling.span("scene", item=True):
            with profiling.span("pool_classify"):
                profiling.count("hits", 5)
        assert rec.counters[(None, "loose")] == 1
        _assert_nested(rec)
    assert rec is profiling.RECORDER
    assert views.parent.name == "scene" and views.item == 0
    items = rec.items("scene")
    assert [it["counts"] for it in items] == [{"hits": 3}, {"hits": 5}]
    assert items[0]["spans"]["scene/views"]["n"] == 2
    assert set(items[0]["spans"]) == {"scene", "scene/views", "scene/views/backbone"}
    assert set(items[1]["spans"]) == {"scene", "scene/pool_classify"}
    for it in items:
        for v in it["spans"].values():     # on the CPU the device clock is the host's
            assert v["device_s"] == pytest.approx(v["host_s"], abs=1e-9)


def test_the_outermost_block_folds_into_a_bounded_history(monkeypatch):
    rec = profiling.RECORDER
    with profiling.recording("cpu"):
        with profiling.recording():
            with profiling.span("loose"):
                profiling.count("x")
            with profiling.span("step", item=True):
                profiling.count("x", 2)
        assert len(rec.spans) == 2 and rec.history == deque()   # the inner block keeps them
        with profiling.span("step", item=True):
            pass
    assert rec.spans == [] and dict(rec.counters) == {} and rec._ref is None
    assert [it["counts"] for it in rec.items("step")] == [{"x": 2}, {}]
    assert [it["counts"] for it in rec.take("step")] == [{"x": 2}, {}]
    assert rec.items("step") == []
    with pytest.raises(RuntimeError):           # a block that raises keeps nothing
        with profiling.recording("cpu"), profiling.span("step", item=True):
            raise RuntimeError
    assert rec.spans == [] and rec.stack == [] and rec.items("step") == []
    monkeypatch.setattr(profiling, "HISTORY", 3)
    small = profiling.Recorder("cpu")
    for _ in range(5):
        with small.span("scene", item=True):
            small.count("n")
    assert len(small.items("scene")) == 3 and small.spans == []


class _FakeEvent:
    """Stands in for ``torch.cuda.Event``: a record stamps a tick."""
    made = 0
    tick = 0

    def __init__(self, enable_timing):
        assert enable_timing
        type(self).made += 1

    def record(self, stream):
        type(self).tick += 1
        self.at = type(self).tick

    def elapsed_time(self, other):
        return float(other.at - self.at)


def test_cuda_spans_reuse_pooled_events_and_sync_only_where_asked(monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: syncs.append(device))
    _FakeEvent.made = 0
    rec = profiling.Recorder("cuda")
    for i in range(3):
        with rec.span("scene", item=True):
            with rec.span("views"):
                pass
        assert len(syncs) == i                 # no synchronize while spans record
        (it,) = rec.items("scene")[-1:]
        assert it["spans"]["scene/views"]["device_s"] == pytest.approx(1e-3)
        assert it["spans"]["scene"]["device_s"] == pytest.approx(3e-3)
    assert len(syncs) == 3                     # one a read, to resolve
    assert _FakeEvent.made == 5                # the reference and one item's four
    with rec.span("views", sync=True):
        pass
    assert len(syncs) == 4


def test_off_records_nothing_and_touches_no_cuda_event(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA call while recording is off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    s = profiling.span("scene", item=True)
    assert s is profiling.span("other") is profiling._NULL
    with s as got:
        assert got is None
        profiling.count("hits", 3)
        x = torch.arange(4)
        assert profiling.host_read(x) is x
        assert torch.equal(profiling.nonzero(x > 1), torch.nonzero(x > 1))
        assert torch.equal(profiling.masked(x, x > 1), x[x > 1])
    with profiling.stage_span("views", None, "cpu"):
        pass
    rec = profiling.RECORDER
    assert rec.spans == [] and dict(rec.counters) == {} and rec.n_items == 0


_X = torch.tensor([3, 0, 5])


@pytest.mark.parametrize("call,want", [
    (lambda: int(profiling.host_read(_X.sum())), 8),
    (lambda: bool(profiling.host_read(_X.any())), True),
    (lambda: profiling.host_read(_X).numpy().tolist(), [3, 0, 5]),
    (lambda: profiling.host_read(_X).tolist(), [3, 0, 5]),
    (lambda: profiling.nonzero(_X)[:, 0].tolist(), [0, 2]),
    (lambda: [t.tolist() for t in profiling.nonzero(_X, as_tuple=True)], [[0, 2]]),
    (lambda: profiling.masked(_X, _X < 4).tolist(), [3, 0]),
], ids=["int", "bool", "numpy", "tolist", "nonzero", "nonzero_tuple", "masked"])
def test_host_read_counts_one_read_and_returns_the_value(call, want):
    with profiling.recording("cpu") as rec:
        with profiling.span("step", item=True):
            got = call()
    assert got == want
    (item,) = rec.items("step")
    assert item["counts"] == {"host_syncs": 1}
    assert set(item["spans"]) == {"step"}


def test_a_profiler_session_leaves_recording_off():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("step", item=True) is profiling._NULL
        profiling.count("hits")
    assert profiling.RECORDER.items("step") == [] and dict(profiling.RECORDER.counters) == {}


def test_launch_registry_reads_the_wrappers():
    from geopurify_tpu_torch.ops.band import banded_window_matmul
    from geopurify_tpu_torch.ops.infonce import info_nce_bwd, info_nce_fwd

    counts = profiling.launch_counts()
    assert {"banded_window_matmul", "info_nce_fwd", "info_nce_bwd"} <= set(counts)
    n0 = banded_window_matmul.launches
    try:
        banded_window_matmul.launches += 19   # what 19 launches leave behind
        assert profiling.launch_counts()["banded_window_matmul"] == n0 + 19
        assert (info_nce_fwd.launches, info_nce_bwd.launches) == (
            counts["info_nce_fwd"], counts["info_nce_bwd"])
    finally:
        banded_window_matmul.launches = n0


def test_stage_timer_summarises_its_spans():
    t = profiling.StageTimer()
    for _ in range(2):
        with t.stage("train_step", block_on=torch.zeros(1)):
            pass
    with t.stage("lift_2d"):
        pass
    with profiling.recording("cpu"):
        with t.stage("lift_2d", block_on="cpu"):
            pass
    s = t.summary()
    assert {k: v["count"] for k, v in s.items()} == {"lift_2d": 2, "train_step": 2}
    assert all(v["total_s"] >= 0 for v in s.values())
    assert t.summary() == s                   # the spans are summed once
    assert profiling.RECORDER.spans == []     # the timer keeps its own recorder


def _stage2():
    cfg = load_config("tiny", overrides=["pooling.band=128"])
    g = torch.Generator().manual_seed(0)
    n_cls = len(cfg.data.all_label)
    text = torch.nn.functional.normalize(
        torch.randn((n_cls + 1, cfg.xdecoder.hidden_dim), generator=g), dim=-1)
    pipe = GeoPurifyPipeline(cfg, text, 20.0, device="cpu")
    with torch.no_grad():
        for p in pipe.xdecoder.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=g))
    init_student_(pipe.student, g)
    return pipe, make_scene_batch(seed=1, **SCENE)


STAGE2_SPANS = {"scene", "scene/views", "scene/views/backbone", "scene/views/pixel_decoder",
                "scene/views/head", "scene/views/lift", "scene/fuse_fill",
                "scene/pool_classify", "scene/pool_classify/student",
                "scene/pool_classify/graph", "scene/pool_classify/smooth",
                "scene/pool_classify/classify"}


def test_evaluate_scene_records_its_spans_and_answers_the_same():
    pipe, batch = _stage2()
    plain = pipe.evaluate_scene(batch)
    with profiling.recording("cpu") as rec:
        recorded = pipe.evaluate_scene(batch)
        _assert_nested(rec)
    profiled = pipe.evaluate_scene(batch, profile=True)
    for out in (recorded, profiled):
        assert torch.equal(out["logits"], plain["logits"])
        assert torch.equal(out["pred"], plain["pred"])
    assert set(profiled["stage_seconds"]) == {"views", "fuse_fill", "pool_classify"}
    items = rec.items("scene")
    assert len(items) == 2
    for it in items:
        assert STAGE2_SPANS <= set(it["spans"])
        assert it["counts"]["host_syncs"] >= 2
        assert it["counts"]["knn_self.queries"] >= it["counts"].get("knn_self.failed", 0)
        assert not any("sync" in p for p in it["spans"])
    spans = items[1]["spans"]
    for name, secs in profiled["stage_seconds"].items():
        assert secs == spans[f"scene/{name}"]["host_s"]


def test_a_train_step_records_its_spans_and_loses_the_same():
    cfg = load_config("tiny", overrides=["contrastive.fused_loss=true"])
    batch = make_scene_batch(seed=0, **SCENE)
    rng = np.random.default_rng(0)
    f2d = torch.from_numpy(rng.normal(size=(512, 16)).astype(np.float32))
    ft = torch.from_numpy(rng.normal(size=(512, 24)).astype(np.float32))
    losses = []
    for on in (False, True):
        g = torch.Generator().manual_seed(0)
        text = torch.nn.functional.normalize(torch.randn((5, 16), generator=g), dim=-1)
        pipe = GeoPurifyPipeline(cfg, text, 20.0, device="cpu")
        init_student_(pipe.student, g)
        opt, _ = make_optimizer(cfg.train, pipe.student, steps_per_epoch=4)
        state = ttrain.TrainState(pipe.student, opt, 0, torch.Generator().manual_seed(3))
        step = ttrain.make_train_step(pipe)
        with profiling.recording("cpu") if on else profiling._NULL:
            losses.append([step(state, batch, f2d, ft) for _ in range(2)])
            if on:
                _assert_nested(profiling.RECORDER)
    assert [x.item() for x in losses[0]] == [x.item() for x in losses[1]]
    items = profiling.RECORDER.items("step")
    assert len(items) == 2
    for it in items:
        assert {"step", "step/sampler", "step/forward", "step/loss", "step/backward",
                "step/optimizer"} <= set(it["spans"])
        assert it["counts"]["host_syncs"] >= 1


def test_grid_knn_counts_its_queries_and_fallbacks():
    g = torch.Generator().manual_seed(0)
    coords = torch.randint(0, 40, (600, 3), generator=g)
    valid = torch.rand(600, generator=g) < 0.9
    with profiling.recording("cpu") as rec, profiling.span("scene", item=True):
        _, _, stats = knn._knn_self_grid(coords, valid, k=8, radius=2, num_candidates=64)
    counts = rec.items("scene")[0]["counts"]
    assert counts["knn_self.queries"] == stats["queries"] == int(valid.sum())
    assert counts["knn_self.failed"] == stats["failed"] > 0
