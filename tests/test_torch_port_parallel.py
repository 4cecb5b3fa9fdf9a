"""The data-parallel Stage-1 step held against the JAX package on the CPU:
two gloo ranks of the port (``run.train.make_train_step`` over
``parallel.make_mesh``) against JAX's ``make_train_step`` on a two-device
CPU mesh (``shard_map``), with ``parallel.sync_batchnorm`` on (here) and
off (``test_torch_port_parallel_localbn.py``), over two steps. JAX draws
device d's anchors under ``fold_in(key, d)``; the port gets those pairs. Each step: the loss (rel 1e-5), the averaged
gradients (rel 1e-4), the running statistics (rtol 1e-5) and parameters,
and the two replicas bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from geopurify_tpu.config import load_config as j_load_config
from geopurify_tpu.data.synthetic import make_scene_batch as j_scene
from geopurify_tpu.models.pipeline import GeoPurifyPipeline as JPipeline
from geopurify_tpu.ops.contrastive import sample_contrastive_pairs_hybrid as j_sample
from geopurify_tpu.parallel.mesh import make_mesh as j_make_mesh
from geopurify_tpu.run import train as jtrain
from geopurify_tpu.run.optim import make_optimizer as j_make_optimizer
from geopurify_tpu_torch.parallel import spawn
from geopurify_tpu_torch.utils.from_jax import student_from_jax
from tests import torch_dist_workers as workers

SCENE = dict(n_points=700, n_views=1, max_points=768, max_voxels=640, max_view_points=64)
STEPS_PER_EPOCH = 4


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / max(np.abs(ref).max(), 1e-30)


def _capture():
    """A transformation that passes the updates on and keeps them in its
    state: the averaged gradients the step's optimizer receives."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))


def _jax_run(sync: bool, seed: int = 11):
    """Two JAX steps at dp=2; per step the loss, the averaged gradients and
    the student's variables after it, and the per-device pairs."""
    import dataclasses

    jcfg = j_load_config("tiny")
    jcfg = dataclasses.replace(jcfg, parallel=dataclasses.replace(
        jcfg.parallel, sync_batchnorm=sync))
    rng = np.random.default_rng(seed)
    text = rng.normal(size=(len(jcfg.data.all_label) + 1,
                            jcfg.xdecoder.hidden_dim)).astype(np.float32)
    jp = JPipeline(cfg=jcfg, teacher_params=None, text_embeddings=jnp.asarray(text),
                   logit_scale=jnp.float32(20.0))
    s = jcfg.student
    shapes = jax.eval_shape(lambda k: jp.student.init(
        k, jnp.zeros((8, s.input_dim)), jnp.full((8, 27), 8, jnp.int32), jnp.ones(8, bool),
        train=False), jax.random.key(4))

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        x = rng.normal(size=leaf.shape).astype(np.float32)
        if name.endswith("['kernel']"):
            return jnp.asarray(x * np.sqrt(2.0 / np.prod(leaf.shape[:-1])))
        if name.endswith("['scale']"):
            return jnp.asarray(1.0 + 0.1 * x)
        if name.endswith("['var']"):
            return jnp.asarray(np.abs(x) + 0.5)
        return jnp.asarray(0.1 * x)

    svars = jax.tree_util.tree_map_with_path(fill, shapes)
    scenes = [j_scene(seed=r, **SCENE) for r in range(2)]
    P = scenes[0].points.shape[0]
    f2ds = rng.normal(size=(2, P, jcfg.pooling.feature_dim)).astype(np.float32)
    fts = rng.normal(size=(2, P, 24)).astype(np.float32)
    tx, _ = j_make_optimizer(jcfg.train, svars["params"], STEPS_PER_EPOCH)
    tx = optax.chain(_capture(), tx)
    mesh = j_make_mesh(dp=2, devices=jax.devices()[:2])
    step = jtrain.make_train_step(jp, tx, mesh, "data")
    state = jtrain.TrainState(svars["params"], svars["batch_stats"],
                              tx.init(svars["params"]), jnp.zeros((), jnp.int32))
    stacked = jtrain.stack_scenes(scenes)
    cc = jcfg.contrastive
    steps, pairs = [], []
    for key in (jax.random.key(21), jax.random.key(22)):
        pairs.append([tuple(np.asarray(x) for x in j_sample(
            jax.random.fold_in(key, d), jnp.asarray(fts[d]), scenes[d].point_valid,
            coords=scenes[d].points, num_anchors=cc.num_anchors,
            num_macro=cc.num_macro_negatives, num_micro=cc.num_micro_negatives,
            spatial_k=cc.spatial_knn_k, spatial_method=cc.spatial_method,
            spatial_radius=cc.spatial_radius)) for d in range(2)])
        state, loss = step(state, stacked, jnp.asarray(f2ds), jnp.asarray(fts), key)
        steps.append(dict(
            loss=float(loss),
            grads=student_from_jax({"params": state.opt_state[0], "batch_stats": {}}),
            state=student_from_jax({"params": state.params,
                                    "batch_stats": state.batch_stats})))
    return dict(text=text, svars=svars, f2ds=f2ds, fts=fts, pairs=pairs, steps=steps)


def check_dp_step(sync: bool):
    """The port's two ranks against JAX's two devices, step by step."""
    ref = _jax_run(sync)
    overrides = [f"parallel.sync_batchnorm={str(sync).lower()}"]
    student_state = {k: v.numpy() for k, v in student_from_jax(ref["svars"]).items()}
    ranks = spawn(workers.dp_steps, 2, "cpu", args=(
        overrides, ref["text"], student_state, SCENE, ref["f2ds"], ref["fts"],
        ref["pairs"], STEPS_PER_EPOCH), timeout_s=300)
    shift = {}      # running mean -> (1 - momentum) x its conv bias's difference
    for i, (jstep, *got) in enumerate(zip(ref["steps"], *ranks)):
        assert all(g["equal"] for g in got), f"step {i}: replicas differ"
        for k in got[0]["state"]:
            np.testing.assert_array_equal(got[0]["state"][k], got[1]["state"][k], err_msg=k)
        port = got[0]
        assert jstep["loss"] > 0.1
        assert port["loss"] == pytest.approx(jstep["loss"], rel=1e-5), i
        jg = {k: v.numpy() for k, v in jstep["grads"].items()}
        top = max(np.abs(g).max() for g in jg.values())
        noise = set()
        for name, g in port["grads"].items():
            if np.abs(jg[name]).max() < 1e-5 * top:
                # a conv bias ahead of train-mode BatchNorm: 0 up to rounding
                assert np.abs(g).max() < 1e-5 * top, (i, name)
                noise.add(name)
                continue
            assert _rel(g, jg[name]) < 1e-4, (i, name)
        for name, v in port["state"].items():
            j = jstep["state"][name].numpy()
            if name in noise:
                # AdamW's step on rounding noise: at most the output tier's LR
                assert np.abs(v - j).max() <= 2 * 5 * 1e-4, (i, name)
                continue
            # the batch mean carries the bias ahead of the BatchNorm, so the
            # noise biases' difference after a step reaches the next step's
            # running mean, exactly scaled by 1 - momentum
            np.testing.assert_allclose(v - shift.get(name, 0.0), j, rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {name}")
        shift = {name.replace("_conv.bias", "_norm.mean").replace(".conv", ".norm")
                 .replace(".bias", ".mean"):
                 (1 - 0.9) * (port["state"][name] - jstep["state"][name].numpy())
                 for name in noise}


def test_dp_step_with_syncbn_matches_jax_at_dp2():
    check_dp_step(sync=True)
