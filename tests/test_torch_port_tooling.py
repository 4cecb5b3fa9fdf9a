"""The port's visualization and profiling tools held against the JAX
package: the same colourings, statistics and PLY bytes for the same
inputs, the same report and JSONL record, plus the properties
tests/test_utils_viz.py checks; ``trace`` writes a torch.profiler trace and
is a no-op without a directory."""

import json
import os

import numpy as np
import pytest
import torch

from geopurify_tpu.utils import profiling as jprof
from geopurify_tpu.utils import visualization as jviz
from geopurify_tpu_torch.data.ply import read_ply
from geopurify_tpu_torch.utils import profiling as tprof
from geopurify_tpu_torch.utils import visualization as tviz


def _clusters(rng):
    a = rng.normal(size=(100, 16)) + 5
    b = rng.normal(size=(100, 16)) - 5
    return np.concatenate([a, b])


def test_pca_and_kmeans_colours_equal_jaxs(rng):
    f = _clusters(rng)
    valid = rng.random(200) < 0.8
    for v in (None, valid):
        rgb = tviz.pca_color(f, v)
        np.testing.assert_array_equal(rgb, jviz.pca_color(f, v))
    assert rgb.min() >= 0 and rgb.max() <= 1
    rgb = tviz.pca_color(f)
    assert np.abs(rgb[:100].mean(0) - rgb[100:].mean(0)).max() > 0.3
    g = rng.normal(size=(120, 8))
    for v in (None, valid[:120]):
        k = tviz.kmeans_color(g, k=4, seed=3, valid=v)
        assert k.shape == (120, 3)
        np.testing.assert_array_equal(k, jviz.kmeans_color(g, k=4, seed=3, valid=v))


def test_affinity_entropy_stats_equal_jaxs(rng):
    w = np.full((10, 8), 1 / 8)
    assert abs(tviz.affinity_entropy_stats(w)["normalized_mean"] - 1.0) < 1e-6
    w = np.zeros((10, 8))
    w[:, 0] = 1
    s = tviz.affinity_entropy_stats(w)
    assert s["mean_entropy"] < 1e-9 and s["frac_peaked"] == 1.0
    w = rng.random((50, 6))
    valid = rng.random(50) < 0.7
    for v in (None, valid):
        assert tviz.affinity_entropy_stats(w, v) == jviz.affinity_entropy_stats(w, v)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("valid", [False, True])
def test_ply_dumps_byte_equal_to_jaxs(tmp_path, rng, valid):
    M, K = 40, 5
    pts = rng.uniform(size=(M, 3)).astype(np.float32)
    feats = rng.normal(size=(M, 16))
    w = rng.random((M, K)).astype(np.float32)
    nbr = rng.integers(0, M, (M, K)).astype(np.int32)
    v = (rng.random(M) < 0.75) if valid else None
    calls = {
        "pca": lambda mod, p: mod.save_feature_pca_ply(p, pts, feats, v),
        "heat": lambda mod, p: mod.save_affinity_heatmap_ply(p, pts, w, v),
        "heat_max": lambda mod, p: mod.save_affinity_heatmap_ply(p, pts, w, v, mode="max"),
        "nbh": lambda mod, p: mod.save_neighborhood_ply(p, pts, nbr, w, center=7, valid=v),
    }
    for name, call in calls.items():
        pt, pj = str(tmp_path / f"t_{name}.ply"), str(tmp_path / f"j_{name}.ply")
        call(tviz, pt)
        call(jviz, pj)
        assert _bytes(pt) == _bytes(pj), name
    heat = read_ply(str(tmp_path / "t_heat.ply"))["vertex"]
    assert len(heat["x"]) == (M if v is None else int(v.sum()))
    if v is None:
        nb = read_ply(str(tmp_path / "t_nbh.ply"))["vertex"]
        assert nb["red"][7] == 255 and nb["green"][7] == 255      # the centre is white
        w2 = np.full((M, K), 1.0 / K, np.float32)
        w2[0] = 0.0
        w2[0, 0] = 1.0
        tviz.save_affinity_heatmap_ply(str(tmp_path / "h2.ply"), pts, w2)
        h2 = read_ply(str(tmp_path / "h2.ply"))["vertex"]
        assert h2["red"][0] < h2["red"][1]        # peaked rows bluer than diffuse ones


def test_query_embedding_plot(tmp_path, rng, monkeypatch):
    q = rng.normal(size=(20, 16)).astype(np.float32)
    t = rng.normal(size=(4, 16)).astype(np.float32)
    p = str(tmp_path / "q.png")
    ok = tviz.plot_query_embeddings(p, q, t, class_names=["a", "b", "c", "d"])
    assert ok == jviz.plot_query_embeddings(str(tmp_path / "j.png"), q, t,
                                            class_names=["a", "b", "c", "d"])
    if ok:
        assert os.path.getsize(p) > 0
    # no matplotlib: False and no file, as in JAX
    import builtins

    real = builtins.__import__

    def no_mpl(name, *a, **k):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    assert tviz.plot_query_embeddings(str(tmp_path / "none.png"), q) is False
    assert not os.path.exists(tmp_path / "none.png")


def test_stage_timer_report_and_jsonl_equal_jaxs(tmp_path):
    timers = (tprof.StageTimer(), jprof.StageTimer())
    for t in timers:
        t.observe("b", 0.5)
        t.observe("a", 0.125)
        t.observe("a", 0.25)
    assert timers[0].summary() == timers[1].summary()
    assert timers[0].report() == timers[1].report()
    assert "a" in timers[0].report() and "b" in timers[0].report()
    paths = (str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl"))
    for t, p in zip(timers, paths):
        t.dump_jsonl(p, step=3)
        t.dump_jsonl(p, step=4)
    assert _bytes(paths[0]) == _bytes(paths[1])
    rec = [json.loads(line) for line in open(paths[0])]
    assert [r["step"] for r in rec] == [3, 4] and rec[0]["stages"]["a"]["count"] == 2


def test_trace_writes_a_profile_and_is_a_no_op_without_a_dir(tmp_path):
    with tprof.trace(None):
        x = torch.ones(3) + 1
    assert x.sum() == 6
    d = tmp_path / "trace"
    with tprof.trace(str(d)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(d.glob("*.json"))
    assert files and "traceEvents" in json.loads(files[0].read_text())
