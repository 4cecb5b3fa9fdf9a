"""The Stage-1 trainer's real-data modes held against the JAX package on
the CPU at the ``tiny`` preset: ``run.train.main`` with ``--teacher-cache``,
with ``--fused-features`` and live (no frozen inputs) over two on-disk
train scenes, two steps each; the per-step ``(sid, scene, f2d, f_teacher)``
must equal what the JAX trainer's loop assembles from the same directory,
checkpoint files and cache.
The fixtures (scenes, checkpoint files, merges file, the port's teacher
cache, the JAX trainer's tiny conversion) are
``tests/test_torch_port_stage1_data.py``'s."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.data import loaders as jloaders
from geopurify_tpu.run import train as jtrain
from tests.test_torch_port_data import _same_batch
from tests.test_torch_port_stage1_data import (  # noqa: F401 (fixtures)
    _port_run,
    _rel,
    caches,
    jax_tiny,
    world,
)


def _jax_inputs(monkeypatch, argv):
    """The inputs the JAX trainer's loop assembles for each step, on one
    device: its train step and checkpoint save are replaced by a recorder;
    the scene ids come from its loader's ``_next_sid``."""
    steps, sids = [], []

    def make_train_step(pipeline, tx, mesh, axis):
        def step(state, scenes, f2ds, fts, key):
            steps.append((jax.tree_util.tree_map(lambda x: np.asarray(x[0]), scenes),
                          np.asarray(f2ds[0]), np.asarray(fts[0])))
            return state, jnp.float32(0.0)
        return step

    next_sid = jloaders.SceneDataset._next_sid

    def recording(self):
        sids.append(next_sid(self))
        return sids[-1]

    # one device of the tests' eight-device CPU platform: one scene a step
    monkeypatch.setattr(jtrain, "make_mesh", functools.partial(
        jtrain.make_mesh, devices=jax.devices()[:1]))
    monkeypatch.setattr(jtrain, "make_train_step", make_train_step)
    monkeypatch.setattr(jtrain, "save_checkpoint", lambda *a, **k: None)
    monkeypatch.setattr(jloaders.SceneDataset, "_next_sid", recording)
    jtrain.main(["--preset", "tiny"] + argv)
    monkeypatch.setattr(jloaders.SceneDataset, "_next_sid", next_sid)
    return steps, sids


@pytest.mark.parametrize("mode", ["teacher_cache", "fused", "live"])
def test_trainer_inputs_match_jax(world, caches, jax_tiny, monkeypatch, tmp_path, mode):
    """Two steps of each trainer over the two train scenes. Inputs read from
    the cache or the fused files are exact; the live ones (the lift and the
    teacher on augmented scenes) agree at f32 rel < 1e-5."""
    argv = {"teacher_cache": ["--teacher-cache", str(caches / "npz")],
            "fused": ["--fused-features", str(caches / "fused"),
                      "--teacher-cache", str(caches / "npz")],
            "live": []}[mode]
    argv = argv + ["--steps-per-epoch", "2"]
    common = world["overrides"] + ["train.epochs=1", "train.print_freq=1"]
    if mode == "fused":
        # a voxel budget that drops no point: there the JAX loader's rows
        # align too (tests/test_torch_port_stage1_data.py::
        # test_fused_features_stay_aligned_when_the_voxel_budget_drops_points)
        common.append("data.max_voxels=512")
    state, got = _port_run(monkeypatch, argv + common + [f"train.save_path={tmp_path / 't'}"])
    ref, sids = _jax_inputs(monkeypatch, argv + common + [f"train.save_path={tmp_path / 'j'}"])
    assert len(got) == len(ref) == state.step == 2
    keyed = mode != "live"
    if keyed:
        assert [g[0] for g in got] == sids == world["train"]
    for (sid, scene, f2d, ft), (jscene, jf2d, jft) in zip(got, ref):
        assert (sid is None) != keyed
        _same_batch(scene, jscene)
        for a, b in ((f2d, jf2d), (ft, jft)):
            assert a.dtype == torch.float32 and a.shape == b.shape
            if keyed:
                np.testing.assert_array_equal(a.numpy(), b)
            else:
                assert _rel(a.numpy(), b) < 1e-5
    if mode == "fused":           # f2d is the fused file's, not the cache's
        with np.load(caches / "npz" / f"{sids[0]}.npz") as cached:
            assert not np.array_equal(got[0][2].numpy(), cached["f2d"])
    recs = [json.loads(x) for x in (tmp_path / "t" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["loss"] > 0 for r in recs)
    stages = set(recs[-1]["stages"])
    assert stages == ({"train_step"} if keyed else {"lift_2d", "teacher_3d", "train_step"})
    assert (tmp_path / "t" / "ckpt" / "step_2.pt").exists()
