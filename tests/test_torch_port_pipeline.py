"""Stage-2 evaluate_scene, port against the JAX package end to end on the
CPU at the bench --smoke sizes (P=512, M=256, V=2, Pv=128) with the band
below M so the banded smoothing path (kernel K1's plain version) runs; plus
the port's import hygiene and its device rule."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.config import (
    FocalNetConfig,
    GeoPurifyConfig,
    PoolingConfig,
    StudentConfig,
    XDecoderConfig,
)
from geopurify_tpu.data.batch import SceneBatch as JSceneBatch
from geopurify_tpu.models.pipeline import GeoPurifyPipeline as JPipeline
from geopurify_tpu_torch.config import GeoPurifyConfig as TConfig
from geopurify_tpu_torch.config import _apply_dict
from geopurify_tpu_torch.data.batch import SceneBatch, build_scene
from geopurify_tpu_torch.models.pipeline import GeoPurifyPipeline as TPipeline
from geopurify_tpu_torch.utils.from_jax import student_from_jax, xdecoder_from_jax

REPO = Path(__file__).resolve().parent.parent


def smoke_cfg(smooth_space="logit"):
    cfg = GeoPurifyConfig()
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, all_label=tuple(f"c{i}" for i in range(4))),
        student=StudentConfig(input_dim=22, hidden_dim=16, embed_dim=8, num_res_blocks=1),
        pooling=PoolingConfig(knn_k=8, num_iterations=3, feature_dim=16, band=128,
                              smooth_space=smooth_space),
        xdecoder=XDecoderConfig(
            backbone=FocalNetConfig(embed_dim=8, depths=(1, 1, 1, 1)),
            hidden_dim=16, conv_dim=16, mask_dim=16, num_queries=5, nheads=2,
            dim_feedforward=32, dec_layers=2, enc_layers=1,
            mask_shape=(48, 64), dtype="float32",
        ),
    )


def _randomize(tree, rng, scale):
    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        x = rng.normal(size=leaf.shape).astype(np.float32)
        if name.endswith("['var']"):
            return np.abs(x) + 0.5
        if name.endswith("['scale']"):
            return 1.0 + scale * x
        return scale * x
    return jax.tree_util.tree_map_with_path(fill, tree)


def build_pair(smooth_space="logit", seed=0):
    """JAX and port pipelines on the same seeded weights and text."""
    cfg = smoke_cfg(smooth_space)
    rng = np.random.default_rng(seed)
    n_cls = len(cfg.data.all_label)
    text = rng.normal(size=(n_cls + 1, cfg.xdecoder.hidden_dim)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    jp = JPipeline(cfg=cfg, teacher_params=None, text_embeddings=jnp.asarray(text),
                   logit_scale=jnp.float32(20.0))
    hw = cfg.xdecoder.mask_shape
    tshapes = jax.eval_shape(jp.xdecoder.init, jax.random.key(0),
                             jnp.zeros((1, hw[0], hw[1], 3)), jnp.asarray(text),
                             jnp.float32(20.0))
    # scale 0.6: several queries win across the views and the predictions
    # spread over several classes (smaller scales collapse to one query)
    tparams = _randomize(tshapes, rng, 0.6)
    sshapes = jax.eval_shape(lambda k: jp.student.init(
        k, jnp.zeros((8, cfg.student.input_dim)), jnp.full((8, 27), 8, jnp.int32),
        jnp.ones(8, bool), train=False), jax.random.key(0))
    svars = _randomize(sshapes, rng, 0.2)
    jp.teacher_params = jax.tree_util.tree_map(jnp.asarray, tparams)
    tp = TPipeline(_apply_dict(TConfig(), dataclasses.asdict(cfg)), text, 20.0,
                   teacher_state=xdecoder_from_jax(tparams),
                   student_state=student_from_jax(svars), device="cpu")
    return cfg, jp, jax.tree_util.tree_map(jnp.asarray, svars), tp


def smoke_scene(seed, cfg):
    arrays = build_scene(seed, 512, 256, 2, 128, tuple(cfg.xdecoder.mask_shape))
    return (JSceneBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            SceneBatch.from_numpy(arrays))


@pytest.mark.parametrize("smooth_space", ["logit", "feature"])
def test_evaluate_scene_matches_jax(smooth_space):
    cfg, jp, svars, tp = build_pair(smooth_space)
    jb, tb = smoke_scene(1, cfg)
    ref = jp.evaluate_scene(svars, jb)
    got = tp.evaluate_scene(tb)
    assert got["band_overflow"] == int(ref["band_overflow"]) == 0   # banded branch
    np.testing.assert_array_equal(got["view_count"].numpy(), np.asarray(ref["view_count"]))
    lj = np.asarray(ref["logits"])
    lt = got["logits"].numpy()
    assert lt.shape == lj.shape == (512, 4) and np.isfinite(lt).all()
    # smoothing carries bf16 between rounds on both sides: logits agree to a
    # few bf16 ulps of their scale, and predictions flip only where the
    # top-2 margin is inside that noise
    scale = np.max(np.abs(lj))
    assert np.max(np.abs(lt - lj)) < 2e-2 * scale
    assert len(np.unique(np.asarray(ref["pred"]))) > 1
    flips = got["pred"].numpy() != np.asarray(ref["pred"])
    assert flips.mean() <= 0.02, flips.mean()
    top2 = np.sort(lj, axis=1)[:, -2:]
    assert np.all((top2[:, 1] - top2[:, 0])[flips] < 2e-2 * scale)


def test_lift_scene_matches_jax():
    cfg, jp, svars, tp = build_pair()
    jb, tb = smoke_scene(2, cfg)
    ref = jp.lift_scene(jb)
    with torch.no_grad():
        lifted = tp.lift_scene(tb)
    fused, count = lifted
    # a NamedTuple with the JAX fields (geopurify_tpu/models/pipeline.py:58-61)
    assert lifted._fields == type(ref)._fields == ("features", "view_count")
    assert lifted.features is fused and lifted.view_count is count
    np.testing.assert_array_equal(count.numpy(), np.asarray(ref.view_count))
    np.testing.assert_allclose(fused.numpy(), np.asarray(ref.features),
                               rtol=1e-4, atol=1e-5)


def test_port_imports_no_jax():
    """Every module of the port imports without JAX, the JAX package or the
    ``regex`` module, the Stage-1 modules, the data layer, the validation
    entry, the converters, the precompute entry, the parallel layer, the
    lift backends and the 2D trainer with its criterion and data layer
    included."""
    stage1 = ("ops.infonce", "ops.contrastive", "ops.voxelize", "models.sonata",
              "models.lang", "data.synthetic", "run.optim", "run.train",
              "utils.checkpoint", "utils.profiling", "data.loaders", "data.ply",
              "data.cameras", "data.augment", "ops.projection", "utils.metrics",
              "utils.visualization", "run.validate", "utils.convert_xdecoder",
              "utils.convert_sonata", "data.feature_loader", "data.selector",
              "run.precompute", "parallel.mesh", "parallel.view_parallel", "run.dryrun",
              "models.lift_backends", "models.lift_variants", "run.train2d",
              "models.criterion", "data.seg2d", "data.mappers", "data.joint_loader",
              "data.visual_sampler")
    code = (
        "import importlib, pkgutil, sys\n"
        "import geopurify_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'geopurify_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"missing = [m for m in {stage1!r} if 'geopurify_tpu_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'geopurify_tpu', 'regex'))\n"
        "assert not bad, bad\n"
        "print('ok', len([n for n in sys.modules if n.startswith('geopurify_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[1]) >= 70


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _apply_dict(TConfig(), dataclasses.asdict(smoke_cfg()))
    with pytest.raises(RuntimeError, match="cuda"):
        TPipeline(cfg, np.zeros((5, 16), np.float32), 20.0)


def test_sonata_teacher_only_from_its_state():
    """Stage 2 builds no Sonata teacher; Stage 1 without its weights raises
    as the JAX pipeline does."""
    cfg = _apply_dict(TConfig(), dataclasses.asdict(smoke_cfg()))
    tp = TPipeline(cfg, np.zeros((5, 16), np.float32), 20.0, device="cpu")
    assert tp.sonata is None
    with pytest.raises(ValueError, match="No sonata params"):
        tp.teacher_point_features(None)
