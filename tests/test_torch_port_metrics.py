"""The port's segmentation metrics held against the JAX package on the
CPU: histograms and meter summaries exact, and the result line of
``run/validate.main`` with the JAX entry point's keys."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.config import load_config as jload_config
from geopurify_tpu.run import validate as jvalidate
from geopurify_tpu.utils import metrics as jm
from geopurify_tpu_torch.config import load_config
from geopurify_tpu_torch.parallel import spawn
from geopurify_tpu_torch.run import validate as tvalidate
from geopurify_tpu_torch.utils import metrics as tm
from tests import torch_dist_workers as workers
from tests.test_torch_port_data import tiny_pair  # noqa: F401  (fixture)


def _case(rng, n, num_classes, ignore):
    pred = rng.integers(0, num_classes, n)
    # targets past the class range (the 255 / 200 ignore labels) and below
    # it: both drop out of the histograms
    target = rng.integers(-1, num_classes + 3, n)
    target[rng.uniform(size=n) < 0.1] = 255
    target[rng.uniform(size=n) < 0.05] = ignore[0] if ignore else 0
    valid = rng.uniform(size=n) < 0.9
    return pred.astype(np.int64), target.astype(np.int32), valid


@pytest.mark.parametrize("num_classes,ignore", [(19, ()), (4, (2,)), (200, (200,)),
                                                (21, (0, 20))])
def test_intersection_and_union_exact(rng, num_classes, ignore):
    pred, target, valid = _case(rng, 5000, num_classes, ignore)
    ref = jm.intersection_and_union(jnp.asarray(pred), jnp.asarray(target),
                                    jnp.asarray(valid), num_classes, ignore)
    got = tm.intersection_and_union(torch.from_numpy(pred), torch.from_numpy(target),
                                    torch.from_numpy(valid), num_classes, ignore)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == (num_classes,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[0].sum() > 0 and (got[1] >= got[0]).all()


@pytest.mark.parametrize("preset", ["scannet", "scannet200", "matterport40", "tiny"])
def test_seg_meter_summary_exact(rng, preset):
    """Several updates, then every group (all / base / novel / foreground)
    and the per-class IoU, with each preset's class groups."""
    cfg, jcfg = load_config(preset), jload_config(preset)
    C = cfg.data.test_classes
    kw = dict(num_classes=C, base_category=cfg.data.base_category,
              novel_category=cfg.data.novel_category,
              foreground_category=cfg.data.foreground_category())
    assert cfg.data.foreground_category() == jcfg.data.foreground_category()
    tmeter, jmeter = tm.SegMeter(**kw), jm.SegMeter(**kw)
    for _ in range(3):
        pred, target, valid = _case(rng, 3000, C, tuple(cfg.data.test_ignore_label))
        hists = tm.intersection_and_union(
            torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(valid), C,
            tuple(cfg.data.test_ignore_label))
        tmeter.update(*hists)
        jmeter.update(*jm.intersection_and_union(
            jnp.asarray(pred), jnp.asarray(target), jnp.asarray(valid), C,
            tuple(cfg.data.test_ignore_label)))
    assert tmeter.summary() == jmeter.summary()
    np.testing.assert_array_equal(tmeter.per_class_iou(), jmeter.per_class_iou())
    assert tmeter.summary().keys() == jmeter.summary().keys()


def test_average_meter_and_single_process_allreduce():
    a, b = tm.AverageMeter(), jm.AverageMeter()
    for v, n in ((1.5, 2), (3.0, 1), (0.25, 4)):
        a.update(v, n)
        b.update(v, n)
    assert (a.val, a.sum, a.count, a.avg) == (b.val, b.sum, b.count, b.avg)
    meter = tm.SegMeter(num_classes=3)
    assert tm.allreduce_meter_across_hosts(meter) is meter
    # two gloo processes: each rank's histograms summed, exactly, on both
    rng = np.random.default_rng(4)
    hists = [rng.integers(0, 1 << 40, (3, 5)).astype(np.float64) for _ in range(2)]
    ranks = spawn(workers.meter_allreduce, 2, "cpu", args=(hists,), timeout_s=120)
    for got in ranks:
        np.testing.assert_array_equal(got, hists[0] + hists[1])


def _key_tree(x):
    if isinstance(x, dict):
        return {k: _key_tree(v) for k, v in x.items()}
    return type(x).__name__ if not isinstance(x, list) else ("list", len(x))


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def test_validate_main_synthetic_schema(tmp_path, capsys, monkeypatch, tiny_pair):
    """``main --synthetic --device cpu --preset tiny`` and the JAX entry
    point print results with the same keys and append the same record. The
    JAX ``main`` runs on the fixture's pipeline (compiled already for these
    scenes; its own would be built with the NaN text of its tiny tokenizer)
    and without its persistent compile cache."""
    import geopurify_tpu.run.train as jtrain
    import geopurify_tpu.utils.cache as jcache

    monkeypatch.setattr(jcache, "enable_persistent_cache", lambda *a, **k: "")
    monkeypatch.setattr(jtrain, "build_pipeline", lambda *a, **k: (tiny_pair[1], None))
    res = tvalidate.main(["--synthetic", "--device", "cpu", "--preset", "tiny",
                          f"train.save_path={tmp_path / 't'}"])
    tout = _last_json(capsys.readouterr().out)
    jvalidate.main(["--synthetic", "--preset", "tiny", f"train.save_path={tmp_path / 'j'}"])
    jout = _last_json(capsys.readouterr().out)
    assert tout == json.loads(json.dumps(res))
    assert _key_tree(tout) == _key_tree(jout)
    assert set(tout["summary"]) == {"all", "base", "novel", "foreground"}
    trec, jrec = ((tmp_path / d / "eval_results.jsonl").read_text().splitlines()
                  for d in ("t", "j"))
    assert len(trec) == len(jrec) == 1
    assert _key_tree(json.loads(trec[0])) == _key_tree(json.loads(jrec[0]))
    assert all(np.isfinite(v) for g in tout["summary"].values() for v in g.values())
