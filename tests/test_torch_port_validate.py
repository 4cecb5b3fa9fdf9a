"""Stage-2 validation (``run/validate.py``) held against the JAX package on
the CPU at the ``tiny`` preset: the same weights (carried over with
``utils/from_jax``) give the same predictions and the same meter summary
on synthetic scenes (on-disk scenes: tests/test_torch_port_data.py);
``main`` runs over on-disk scenes, in one process and in two
(``--distributed``; its JSON schema against the JAX entry point's:
tests/test_torch_port_metrics.py); released student checkpoints
convert to the same student outputs."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.data import synthetic as jsynth
from geopurify_tpu.run import validate as jvalidate
from geopurify_tpu.utils import checkpoint as jckpt
from geopurify_tpu_torch.config import load_config
from geopurify_tpu_torch.data import synthetic as tsynth
from geopurify_tpu_torch.run import validate as tvalidate
from geopurify_tpu_torch.utils import checkpoint as tckpt
from geopurify_tpu_torch.parallel import spawn
from tests import torch_dist_workers as workers
from tests.test_torch_port_data import _same_eval, on_disk, tiny_pair  # noqa: F401  (fixtures)
from tests.test_torch_port_metrics import _last_json


def test_evaluate_scenes_synthetic_matches_jax(tiny_pair):
    jscenes = (jsynth.make_scene_batch(seed=i, n_points=1500, n_views=2) for i in range(2))
    tscenes = (tsynth.make_scene_batch(seed=i, n_points=1500, n_views=2) for i in range(2))
    _same_eval(tiny_pair, jscenes, tscenes, 2)


def test_validate_main_on_disk(tmp_path, on_disk, capsys, monkeypatch):
    """``main`` over the on-disk fixture, sharded, with --save-preds and a
    student checkpoint directory of the port's trainer; then over the whole
    list in one process and with ``--distributed`` in two gloo processes,
    which must sum to the same histograms and print one line."""
    from geopurify_tpu_torch.data.ply import load_point_ply
    from geopurify_tpu_torch.models.student import AffinityPredictor, init_student_

    root, sids = on_disk
    s = load_config("tiny").student
    student = AffinityPredictor(s.input_dim, s.hidden_dim, s.embed_dim, s.num_res_blocks)
    init_student_(student, torch.Generator().manual_seed(3))
    tckpt.save_checkpoint(str(tmp_path / "ckpt"), {
        "params": dict(student.named_parameters()),
        "batch_stats": dict(student.named_buffers())}, step=7)
    overrides = [f"data.data_root={root / '3d'}", f"data.data_root_2d={root / '2d'}",
                 f"data.eval_scene_list={root / 'list.txt'}", "data.max_views=2",
                 "data.max_views_eval=4", "data.max_voxels=384",
                 "fusion.visibility_threshold=0.1", f"train.save_path={tmp_path / 'run'}"]
    res = tvalidate.main(["--device", "cpu", "--preset", "tiny", "--shard-idx", "1",
                          "--shard-total", "2", "--save-preds", str(tmp_path / "preds"),
                          "--student-ckpt", str(tmp_path / "ckpt")] + overrides)
    assert _last_json(capsys.readouterr().out) == json.loads(json.dumps(res))
    # shard 1 of 2 over 3 scenes: the last one
    assert tvalidate.shard_scene_list(sids, 1, 2) == jvalidate.shard_scene_list(sids, 1, 2)
    assert sorted(os.listdir(tmp_path / "preds")) == ["scene0000_gt.ply", "scene0000_pred.ply"]
    pred = load_point_ply(str(tmp_path / "preds" / "scene0000_pred.ply"))
    assert 0 < len(pred["xyz"]) <= 512
    assert res["scenes_per_sec"] > 0

    argv = ["--device", "cpu", "--preset", "tiny", "--student-ckpt",
            str(tmp_path / "ckpt")] + overrides
    seen = {}
    allreduce = tvalidate.allreduce_meter_across_hosts

    def recording(meter):
        seen["iut"] = np.stack([meter.intersection, meter.union, meter.target])
        return allreduce(meter)

    monkeypatch.setattr(tvalidate, "allreduce_meter_across_hosts", recording)
    single = tvalidate.main(argv)
    ranks = spawn(workers.validate_main, 2, "cpu", args=(["--distributed"] + argv,),
                  timeout_s=300)
    np.testing.assert_array_equal(ranks[0]["iut"], seen["iut"])
    np.testing.assert_array_equal(ranks[1]["iut"], seen["iut"])
    assert seen["iut"][2].sum() > 0
    assert ranks[0]["result"]["summary"] == single["summary"]
    assert ranks[0]["result"]["per_class_iou"] == single["per_class_iou"]
    assert len(ranks[0]["stdout"].strip().splitlines()) == 1 and not ranks[1]["stdout"]
    assert _last_json(ranks[0]["stdout"]) == json.loads(json.dumps(ranks[0]["result"]))


@pytest.mark.parametrize("n,total", [(10, 3), (7, 1), (2, 4), (314, 8)])
def test_shard_scene_list_matches_jax(n, total):
    ids = [f"s{i}" for i in range(n)]
    for i in range(total):
        assert tvalidate.shard_scene_list(ids, i, total) == jvalidate.shard_scene_list(ids, i, total)


def _me_state_dict(rng, cin=22, hid=16, emb=8, bn_wrapped=True):
    """A MinkowskiEngine-named AffinityPredictor state dict with one res
    block; BatchNorms under ``.bn`` or bare."""
    sd = {}

    def bn(name, c):
        pre = f"{name}.bn" if bn_wrapped else name
        sd[f"{pre}.weight"] = 1 + 0.1 * rng.normal(size=c)
        sd[f"{pre}.bias"] = 0.1 * rng.normal(size=c)
        sd[f"{pre}.running_mean"] = 0.1 * rng.normal(size=c)
        sd[f"{pre}.running_var"] = 0.5 + rng.uniform(size=c)

    sd["input_layer.0.kernel"] = rng.normal(size=(27, cin, hid)) / np.sqrt(27 * cin)
    bn("input_layer.1", hid)
    for j in (1, 2):
        sd[f"res_blocks.0.conv{j}.kernel"] = rng.normal(size=(27, hid, hid)) / np.sqrt(27 * hid)
        bn(f"res_blocks.0.norm{j}", hid)
    sd["res_blocks.0.conv2.bias"] = 0.1 * rng.normal(size=hid)
    sd["output_layer.kernel"] = rng.normal(size=(1, hid, emb)) / np.sqrt(hid)
    sd["output_layer.bias"] = 0.1 * rng.normal(size=emb)
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}


@pytest.mark.parametrize("bn_wrapped", [True, False])
def test_convert_student_checkpoint_matches_jax(tmp_path, rng, bn_wrapped):
    """A released-layout (MinkowskiEngine) checkpoint through both
    converters: the student's outputs agree at rel 1e-5, the tap
    permutation is the JAX package's, and ``--student-ckpt`` reads the
    file."""
    from geopurify_tpu.models.student import AffinityPredictor as JStudent
    from geopurify_tpu.ops.sparse_conv import build_neighbor_table as jtable
    from geopurify_tpu_torch.models.student import AffinityPredictor
    from geopurify_tpu_torch.ops.sparse_conv import build_neighbor_table

    sd = _me_state_dict(rng, bn_wrapped=bn_wrapped)
    path = tmp_path / "geopurify.pth"
    torch.save({"model_state_dict": sd}, path)
    np.testing.assert_array_equal(tckpt._me_offset_permutation(),
                                  jckpt._me_offset_permutation())
    jvars = jckpt.convert_student_checkpoint(jckpt.load_torch_state_dict(str(path)))
    tstate = tvalidate.load_student_state(str(path))
    student = AffinityPredictor(22, 16, 8, 1).eval()
    student.load_state_dict(tstate)

    M = 300
    flat = rng.choice(8 ** 3, M, replace=False)
    coords = np.stack(np.unravel_index(np.sort(flat), (8,) * 3), 1).astype(np.int32)
    valid = np.ones(M, bool)
    valid[-20:] = False
    feats = rng.normal(size=(M, 22)).astype(np.float32)
    ref = JStudent(input_dim=22, hidden_dim=16, embed_dim=8, num_res_blocks=1).apply(
        jvars, jnp.asarray(feats), jtable(jnp.asarray(coords), jnp.asarray(valid)),
        jnp.asarray(valid), train=False)
    with torch.no_grad():
        got = student(torch.from_numpy(feats), build_neighbor_table(
            torch.from_numpy(coords), torch.from_numpy(valid)), torch.from_numpy(valid))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    assert np.abs(ref).max() > 0.1
