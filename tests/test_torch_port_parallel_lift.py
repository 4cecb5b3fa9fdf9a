"""The view-parallel lift held against the JAX package on the CPU: the
port's ``sharded_lift_scene`` over two gloo ranks against JAX's over a
two-device mesh (``shard_map``, psum consensus, ppermute tournament) and
against the sequential ``lift_scene`` of both packages, on the smoke
pipeline's seeded X-Decoder: view counts exactly, features within the
JAX test's 2e-3 (tests/test_train_eval.py::test_view_parallel_lift_matches_sequential)."""

import dataclasses

import jax
import numpy as np
import torch

from geopurify_tpu.data.batch import SceneBatch as JSceneBatch
from geopurify_tpu.parallel.mesh import make_mesh as j_make_mesh
from geopurify_tpu.parallel.view_parallel import sharded_lift_scene as j_sharded
from geopurify_tpu_torch.data.batch import SceneBatch, build_scene
from geopurify_tpu_torch.parallel import spawn
from tests import torch_dist_workers as workers
from tests.test_torch_port_pipeline import build_pair


def test_sharded_lift_scene_matches_jax_and_the_sequential_lift():
    cfg, jp, _, tp = build_pair(seed=3)
    arrays = build_scene(4, 512, 256, 4, 128, tuple(cfg.xdecoder.mask_shape))
    jb = JSceneBatch(**{k: jax.numpy.asarray(v) for k, v in arrays.items()})
    j_fused, j_count = j_sharded(jp, jb, j_make_mesh(dp=2, devices=jax.devices()[:2]), "data")
    j_seq = jp.lift_scene(jb)
    with torch.no_grad():
        t_fused, t_count = tp.lift_scene(SceneBatch.from_numpy(arrays))
    text = tp.text_embeddings.numpy()
    state = {k: v.numpy() for k, v in tp.xdecoder.state_dict().items()}
    ranks = spawn(workers.sharded_lift, 2, "cpu",
                  args=(dataclasses.asdict(cfg), text, state, arrays), timeout_s=300)
    (f0, c0), (f1, c1) = ranks
    np.testing.assert_array_equal(f0, f1)          # every rank holds the same result
    np.testing.assert_array_equal(c0, c1)
    for ref_f, ref_c in ((j_fused, j_count), (j_seq.features, j_seq.view_count),
                         (t_fused, t_count)):
        np.testing.assert_array_equal(c0, np.asarray(ref_c))
        np.testing.assert_allclose(f0, np.asarray(ref_f), atol=2e-3)
    assert (c0 >= 2).sum() > 50 and np.abs(f0).max() > 0.1
