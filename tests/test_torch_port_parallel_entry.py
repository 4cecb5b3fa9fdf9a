"""The parallel layer's entry points on the CPU: ``run.train.main
--distributed`` over two gloo ranks (one scene each, equal replicas, rank 0
alone logs and checkpoints), ``run.dryrun`` (the counterpart of
``__graft_entry__.dryrun_multichip``), the scene each rank takes, the
streams of ids ranks share, and boolean config overrides."""

import json

import numpy as np
import pytest
import torch

from geopurify_tpu.config import load_config as j_load_config
from geopurify_tpu_torch.config import load_config
from geopurify_tpu_torch.data.loaders import SceneDataset
from geopurify_tpu_torch.parallel import Mesh, spawn
from geopurify_tpu_torch.run import dryrun
from geopurify_tpu_torch.run.train import StepInputs
from tests import torch_dist_workers as workers


def test_train_main_distributed_two_ranks(tmp_path):
    out = tmp_path / "run"
    argv = ["--distributed", "--preset", "tiny", "--synthetic", "--device", "cpu",
            "--epochs", "1", "--steps-per-epoch", "2", "parallel.dp=2",
            "contrastive.fused_loss=true", f"train.save_path={out}"]
    (s0, sd0), (s1, sd1) = spawn(workers.train_main, 2, "cpu", args=(argv,), timeout_s=300)
    assert s0 == s1 == 2
    for k in sd0:
        np.testing.assert_array_equal(sd0[k], sd1[k], err_msg=k)
    recs = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]           # rank 0's lines only
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert sorted(p.name for p in (out / "ckpt").iterdir()) == ["step_2.pt"]
    saved = torch.load(out / "ckpt" / "step_2.pt", weights_only=False)
    for k, v in saved["params"].items():
        np.testing.assert_array_equal(v.numpy(), sd0[k], err_msg=k)


def test_dryrun_two_ranks():
    line = dryrun.main(["--nproc", "2", "--device", "cpu"])
    assert line.startswith("dryrun(2) OK") and "replicas bit-equal" in line
    assert "view-parallel lift OK" in line and "mIoU=" in line


class _Stream:
    """A stand-in dataset: ids in turn, every scene usable but ``bad``."""

    def __init__(self, n, bad=()):
        self.ids, self.pos, self.bad, self.device = [f"s{i}" for i in range(n)], 0, bad, "cpu"
        self.loaded = []

    def _next_sid(self):
        sid = self.ids[self.pos % len(self.ids)]
        self.pos += 1
        return sid

    def make_scene_batch(self, sid):
        self.loaded.append(sid)
        return None if sid in self.bad else sid


@pytest.mark.parametrize("teacher_cache", [None, "cache"])
def test_each_rank_takes_its_scene(teacher_cache):
    """Synthetic: rank r takes scene it * dp + r; on disk (live or with a
    cache) every rank draws dp ids and loads only its own."""
    scenes = [f"scene{i}" for i in range(5)]
    for r in range(2):
        inputs = StepInputs(None, None, scenes=scenes, mesh=Mesh(2, r, None))
        assert [inputs._scene(it)[1] for it in range(4)] == [scenes[(2 * it + r) % 5]
                                                            for it in range(4)]
        ds = _Stream(5, bad=("s2",))
        inputs = StepInputs(None, None, ds=ds, teacher_cache=teacher_cache,
                            mesh=Mesh(2, r, None))
        got = [inputs._scene(it) for it in range(3)]
        mine = [f"s{(2 * it + r) % 5}" for it in range(3)]
        assert ds.loaded == mine
        assert [g and g[1] for g in got] == [None if s == "s2" else s for s in mine]


def test_split_streams_keep_the_ranks_on_one_order(tmp_path):
    """Two ranks that load different scenes (drawing their generators
    differently) still draw the same ids, epoch after epoch."""
    (tmp_path / "list.txt").write_text("\n".join(f"scene{i:04d}_00" for i in range(5)))
    cfg = load_config("tiny", overrides=[f"data.data_root={tmp_path}",
                                         f"data.train_scene_list={tmp_path / 'list.txt'}"])
    streams = []
    for r in range(2):
        ds = SceneDataset(cfg, split="train", device="cpu")
        ds.split_streams(r)
        sids = []
        for it in range(12):
            sids.append(ds._next_sid())
            ds.rng.random(r + it % 3)           # a load's draws, other on each rank
        streams.append((sids, ds.rng.random()))
    assert streams[0][0] == streams[1][0] and len(set(streams[0][0][5:10])) == 5
    assert streams[0][0][:5] != streams[0][0][5:10]      # shuffled after the first epoch
    assert streams[0][1] != streams[1][1]                 # the loads' generators differ


def test_boolean_overrides_parse():
    """``key=false`` is False in the port; the JAX loader keeps the string
    'false', which is truthy (a JAX fault the port does not share)."""
    cfg = load_config("tiny", overrides=["parallel.sync_batchnorm=false",
                                         "contrastive.fused_loss=True"])
    assert cfg.parallel.sync_batchnorm is False and cfg.contrastive.fused_loss is True
    assert j_load_config("tiny", overrides=["parallel.sync_batchnorm=false"]
                         ).parallel.sync_batchnorm == "false"
    with pytest.raises(ValueError, match="boolean"):
        load_config("tiny", overrides=["parallel.sync_batchnorm=maybe"])
