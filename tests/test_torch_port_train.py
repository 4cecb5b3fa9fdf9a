"""Stage-1 training held against the JAX package on the CPU: the masked
batch moments and train-mode BatchNorm, ``stage1_loss`` with its gradients
and new running statistics (the JAX ``pairs`` handed to the port, since the
two frameworks draw other anchors from one seed), the optimizer against
optax on identical gradients, the checkpoint round trip, and the trainer's
entry point end to end at the ``tiny`` preset."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geopurify_tpu.config import load_config as j_load_config
from geopurify_tpu.data.synthetic import make_scene_batch as j_scene
from geopurify_tpu.models.pipeline import GeoPurifyPipeline as JPipeline
from geopurify_tpu.models.student import AffinityPredictor as JStudent
from geopurify_tpu.models.student import MaskedBatchNorm as JBN
from geopurify_tpu.ops.contrastive import sample_contrastive_pairs_hybrid as j_sample
from geopurify_tpu.ops.sparse_conv import masked_batch_stats as j_stats
from geopurify_tpu.run.optim import make_optimizer as j_make_optimizer
from geopurify_tpu_torch.config import load_config
from geopurify_tpu_torch.data.synthetic import make_scene_batch
from geopurify_tpu_torch.models.pipeline import GeoPurifyPipeline as TPipeline
from geopurify_tpu_torch.models.student import AffinityPredictor as TStudent
from geopurify_tpu_torch.models.student import MaskedBatchNorm as TBN
from geopurify_tpu_torch.models.student import init_student_
from geopurify_tpu_torch.ops.contrastive import ContrastivePairs
from geopurify_tpu_torch.ops.sparse_conv import masked_batch_stats
from geopurify_tpu_torch.run import train as ttrain
from geopurify_tpu_torch.run.optim import make_optimizer
from geopurify_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
    save_checkpoint_with_retry,
)
from geopurify_tpu_torch.utils.from_jax import student_from_jax

SCENE = dict(n_points=700, n_views=1, max_points=768, max_voxels=640, max_view_points=64)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / max(np.abs(ref).max(), 1e-30)


def test_masked_batch_stats_and_train_bn_match_jax(rng):
    x = (rng.normal(size=(300, 12)) * 3 + 1).astype(np.float32)
    valid = rng.random(300) < 0.8
    jm, jv = j_stats(jnp.asarray(x), jnp.asarray(valid))
    tm, tv = masked_batch_stats(_t(x), _t(valid))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)

    jbn = JBN(12)
    variables = jbn.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(valid), train=False)
    params = {"scale": jnp.asarray(1 + 0.1 * rng.normal(size=12), jnp.float32),
              "bias": jnp.asarray(0.1 * rng.normal(size=12), jnp.float32)}
    stats = {"mean": jnp.asarray(rng.normal(size=12), jnp.float32),
             "var": jnp.asarray(rng.random(12) + 0.5, jnp.float32)}
    ref, upd = jbn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                         jnp.asarray(valid), train=True, mutable=["batch_stats"])
    tbn = TBN(12)
    tbn.load_state_dict({"weight": _t(params["scale"]), "bias": _t(params["bias"]),
                         "mean": _t(stats["mean"]), "var": _t(stats["var"])})
    got = tbn(_t(x), _t(valid), train=True)
    assert _rel(got.detach().numpy(), ref) < 1e-5
    assert np.all(got.detach().numpy()[~valid] == 0)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(tbn, name).numpy(),
                                   np.asarray(upd["batch_stats"][name]), rtol=1e-5, atol=1e-7)
    assert set(variables["params"]) == {"scale", "bias"}


def _same_distribution(port_sd, jax_sd):
    """Each tensor: equal where the JAX draw is constant (zero biases, unit
    scales, running statistics), else the same std within 10%."""
    assert set(port_sd) == set(jax_sd)
    for name, p in port_sd.items():
        j = jax_sd[name]
        if j.numel() == 1 or float(j.std()) == 0:
            assert torch.equal(p, j), name
        else:
            assert 0.9 < float(p.std() / j.std()) < 1.1, name


def test_init_student_matches_the_jax_distributions():
    js = JStudent(input_dim=22, hidden_dim=64, embed_dim=32, num_res_blocks=1)
    jv = js.init(jax.random.key(0), jnp.zeros((8, 22)), jnp.full((8, 27), 8, jnp.int32),
                 jnp.ones(8, bool), train=False)
    ts = init_student_(TStudent(22, 64, 32, 1), torch.Generator().manual_seed(0))
    _same_distribution(ts.state_dict(), student_from_jax(jv))


@pytest.fixture(scope="module")
def stage1():
    """The tiny preset on one synthetic scene: the student's JAX-initialised
    variables, random f2d / teacher features, the JAX pairs, and the JAX
    loss, gradients and new running statistics (train mode) and loss (eval
    mode) that the port is held against."""
    jcfg = j_load_config("tiny")
    rng = np.random.default_rng(11)
    n_cls = len(jcfg.data.all_label)
    text = rng.normal(size=(n_cls + 1, jcfg.xdecoder.hidden_dim)).astype(np.float32)
    jp = JPipeline(cfg=jcfg, teacher_params=None, text_embeddings=jnp.asarray(text),
                   logit_scale=jnp.float32(20.0))
    s = jcfg.student
    shapes = jax.eval_shape(lambda k: jp.student.init(
        k, jnp.zeros((8, s.input_dim)), jnp.full((8, 27), 8, jnp.int32), jnp.ones(8, bool),
        train=False), jax.random.key(4))

    def fill(path, leaf):
        # He-scaled kernels, near-unit BatchNorm scales, small biases, and
        # running statistics away from their (0, 1) start so the update shows
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
    jb = j_scene(seed=2, **SCENE)
    tb = make_scene_batch(seed=2, **SCENE)
    for f in dataclasses.fields(tb):
        np.testing.assert_array_equal(getattr(tb, f.name).numpy(),
                                      np.asarray(getattr(jb, f.name)), err_msg=f.name)
    P = jb.points.shape[0]
    f2d = rng.normal(size=(P, jcfg.pooling.feature_dim)).astype(np.float32)
    ft = rng.normal(size=(P, 24)).astype(np.float32)
    cc = jcfg.contrastive
    jpairs = j_sample(jax.random.key(9), jnp.asarray(ft), jb.point_valid, coords=jb.points,
                      num_anchors=cc.num_anchors, num_macro=cc.num_macro_negatives,
                      num_micro=cc.num_micro_negatives, spatial_k=cc.spatial_knn_k,
                      spatial_method=cc.spatial_method, spatial_radius=cc.spatial_radius)

    def loss_fn(params, train):
        loss, upd = jp.stage1_loss({"params": params, "batch_stats": svars["batch_stats"]},
                                   None, jb, jnp.asarray(f2d), jnp.asarray(ft), train=train,
                                   pairs=jpairs)
        return loss, upd.get("batch_stats")

    (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                                       static_argnums=1)(svars["params"], True)
    eval_loss, _ = jax.jit(loss_fn, static_argnums=1)(svars["params"], False)
    ref = dict(loss=float(loss), eval_loss=float(eval_loss),
               grads=student_from_jax({"params": grads, "batch_stats": new_stats}))
    return dict(text=text, svars=svars, tb=tb, f2d=_t(f2d), ft=_t(ft),
                pairs=ContrastivePairs(*(_t(x) for x in jpairs)), ref=ref)


def _port_stage1(d, fused: bool):
    tcfg = load_config("tiny", overrides=[f"contrastive.fused_loss={str(fused).lower()}"])
    return TPipeline(tcfg, d["text"], 20.0, student_state=student_from_jax(d["svars"]),
                     device="cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_stage1_loss_grads_and_stats_match_jax(stage1, fused):
    """With ``fused`` the port runs K2's plain versions; JAX on the CPU
    never runs its fused kernel inside ``stage1_loss`` (its gate needs a
    TPU), so both are held against the JAX unfused loss."""
    tp = _port_stage1(stage1, fused)
    ref = stage1["ref"]
    loss, _ = tp.stage1_loss(None, stage1["tb"], stage1["f2d"], stage1["ft"], train=True,
                             pairs=stage1["pairs"])
    loss.backward()
    assert ref["loss"] > 0.1
    assert loss.item() == pytest.approx(ref["loss"], rel=1e-5)
    jg = ref["grads"]
    top = max(float(np.abs(jg[n].numpy()).max()) for n, _ in tp.student.named_parameters())
    for name, p in tp.student.named_parameters():
        assert p.grad is not None, name
        if np.abs(jg[name].numpy()).max() < 1e-5 * top:
            # a conv bias ahead of train-mode BatchNorm: the batch mean takes
            # it out, its gradient is 0 up to rounding on both sides
            assert np.abs(p.grad.numpy()).max() < 1e-5 * top, name
            continue
        assert _rel(p.grad.numpy(), jg[name].numpy()) < 1e-4, name
    for name, b in tp.student.named_buffers():
        np.testing.assert_allclose(b.numpy(), jg[name].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=name)


def test_stage1_loss_eval_mode_keeps_running_stats(stage1):
    tp = _port_stage1(stage1, False)
    before = {k: v.clone() for k, v in tp.student.named_buffers()}
    with torch.no_grad():
        loss, _ = tp.stage1_loss(None, stage1["tb"], stage1["f2d"], stage1["ft"],
                                 train=False, pairs=stage1["pairs"])
    assert loss.item() == pytest.approx(stage1["ref"]["eval_loss"], rel=1e-5)
    assert all(torch.equal(before[k], v) for k, v in tp.student.named_buffers())


def _optimizer_pair(train_overrides, steps_per_epoch):
    jcfg = j_load_config("tiny")
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, **train_overrides))
    tcfg = load_config("tiny", overrides=[f"train.{k}={v}" for k, v in train_overrides.items()])
    js = JStudent(input_dim=22, hidden_dim=16, embed_dim=8, num_res_blocks=1)
    shapes = jax.eval_shape(lambda k: js.init(
        k, jnp.zeros((8, 22)), jnp.full((8, 27), 8, jnp.int32), jnp.ones(8, bool),
        train=False), jax.random.key(1))
    rng = np.random.default_rng(1)
    svars = jax.tree_util.tree_map(
        lambda x: jnp.asarray(0.1 * rng.normal(size=x.shape), jnp.float32), shapes)
    params = svars["params"]
    tx, jsched = j_make_optimizer(jcfg.train, params, steps_per_epoch)
    ts = TStudent(22, 16, 8, 1)
    ts.load_state_dict(student_from_jax(svars))
    opt, tsched = make_optimizer(tcfg.train, ts, steps_per_epoch)
    return params, tx, jsched, ts, opt, tsched


def _feed(params, tx, ts, opt, n_steps, seed):
    """Identical numpy gradients to optax and to the port, ``n_steps`` raw
    steps; returns the port's per-step group LRs."""
    rng = np.random.default_rng(seed)
    state = tx.init(params)
    update = jax.jit(tx.update)
    lrs = []
    for _ in range(n_steps):
        g = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(size=x.shape) * 1e-2, jnp.float32), params)
        lrs.append({gr["tier"]: gr["lr"] for gr in opt.adamw.param_groups})
        updates, state = update(g, state, params)
        params = optax.apply_updates(params, updates)
        tg = student_from_jax({"params": g, "batch_stats": {}})
        for name, p in ts.named_parameters():
            p.grad = tg[name].clone()
        opt.step()
    return params, lrs


def _assert_params_equal(params, ts):
    # optax takes Adam's bias corrections 1 - beta^t in f32, where 0.999 is
    # inexact and 1 - 0.999 keeps only ~1e-5 of relative precision;
    # torch.optim.AdamW takes them in f64. Each step of up to lr x 5 = 5e-4
    # then differs by ~1e-5 of itself: atol 1e-8 over the steps, which only
    # weights near 0 show against rtol alone
    ref = student_from_jax({"params": params, "batch_stats": {}})
    for name, p in ts.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=1e-6,
                                   atol=1e-8, err_msg=name)


def test_optimizer_matches_optax_across_warmup():
    # 2 steps an epoch, 1 warmup epoch of 3: steps 0-1 warm up, 2-4 decay
    params, tx, jsched, ts, opt, tsched = _optimizer_pair(
        {"warmup_epochs": 1, "epochs": 3}, steps_per_epoch=2)
    for k in range(8):
        assert tsched(k) == pytest.approx(float(jsched(k)), rel=1e-6, abs=1e-15)
    params, lrs = _feed(params, tx, ts, opt, 5, seed=0)
    _assert_params_equal(params, ts)
    for k, lr in enumerate(lrs):
        assert lr == pytest.approx({"input": 0.1 * tsched(k), "middle": tsched(k),
                                    "output": 5.0 * tsched(k)}, rel=1e-12)
    assert lrs[1]["middle"] < lrs[2]["middle"]             # the warmup boundary


def test_optimizer_clip_and_accumulation_match_optax():
    params, tx, jsched, ts, opt, tsched = _optimizer_pair(
        {"warmup_epochs": 1, "epochs": 2, "grad_clip": 0.05, "grad_accum_steps": 2},
        steps_per_epoch=2)
    params, lrs = _feed(params, tx, ts, opt, 4, seed=1)
    _assert_params_equal(params, ts)
    # one schedule tick per 2 raw steps
    assert [lr["middle"] for lr in lrs] == [tsched(0), tsched(0), tsched(1), tsched(1)]


def _trainer(tmp_path, seed_offset=0, grad_accum=1):
    cfg = load_config("tiny", overrides=["contrastive.fused_loss=true",
                                         f"train.save_path={tmp_path}",
                                         f"train.grad_accum_steps={grad_accum}"])
    gen = torch.Generator().manual_seed(cfg.train.manual_seed + seed_offset)
    pipe = ttrain.build_pipeline(cfg, gen, device="cpu")
    init_student_(pipe.student, gen)
    opt, _ = make_optimizer(cfg.train, pipe.student, steps_per_epoch=4)
    state = ttrain.TrainState(pipe.student, opt, 0, torch.Generator().manual_seed(3))
    scenes = [make_scene_batch(seed=i, n_points=400, n_views=1, max_points=512,
                               max_voxels=512, max_view_points=64) for i in range(2)]
    rng = np.random.default_rng(0)
    feats = [(torch.from_numpy(rng.normal(size=(512, 16)).astype(np.float32)),
              torch.from_numpy(rng.normal(size=(512, 24)).astype(np.float32)))
             for _ in scenes]
    step = ttrain.make_train_step(pipe)

    def run(k):
        s = state.step % 2
        return step(state, scenes[s], *feats[s]).item()

    return state, run


@pytest.mark.parametrize("grad_accum,saved_at", [
    (1, 2),
    (2, 1),      # saved halfway through an accumulation: the running mean rides along
])
def test_checkpoint_resume_is_bit_exact(tmp_path, grad_accum, saved_at):
    straight, run_a = _trainer(tmp_path / "a", grad_accum=grad_accum)
    losses = [run_a(i) for i in range(3)]
    first, run_b = _trainer(tmp_path / "b", grad_accum=grad_accum)
    assert [run_b(i) for i in range(saved_at)] == losses[:saved_at]
    save_checkpoint(str(tmp_path / "b" / "ckpt"), first.state_dict(), first.step)
    # a fresh trainer with other initial weights and generator, restored
    resumed, run_c = _trainer(tmp_path / "c", seed_offset=1, grad_accum=grad_accum)
    sd, step = restore_checkpoint(str(tmp_path / "b" / "ckpt"))
    assert step == saved_at
    resumed.load_state_dict(sd)
    assert (resumed.optimizer.acc is None) == (grad_accum == 1)
    assert [run_c(i) for i in range(saved_at, 3)] == losses[saved_at:]
    for (name, p), q in zip(straight.student.state_dict().items(),
                            resumed.student.state_dict().values()):
        assert torch.equal(p, q), name
    for s, r in zip(straight.optimizer.params, resumed.optimizer.params):
        st, sr = straight.optimizer.adamw.state[s], resumed.optimizer.adamw.state[r]
        assert all(torch.equal(st[k], sr[k]) for k in st)
    assert torch.equal(straight.generator.get_state(), resumed.generator.get_state())


def test_checkpoint_keeps_newest_and_retries(tmp_path):
    d = str(tmp_path / "ckpt")
    for step in (1, 2, 3, 4):
        save_checkpoint(d, {"step": step, "w": torch.full((2,), float(step))}, step)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_2.pt", "step_3.pt", "step_4.pt"]
    sd, step = restore_checkpoint(d, step=3)
    assert step == 3 and sd["w"].tolist() == [3.0, 3.0]
    assert restore_checkpoint(str(tmp_path / "none")) == (None, None)

    calls = []

    def flaky(path, state, step, keep=3):
        calls.append(step)
        if len(calls) < 3:
            raise OSError("transient")
        save_checkpoint(path, state, step, keep=keep)

    assert save_checkpoint_with_retry(d, {"step": 5}, 5, sleep_s=0, _save=flaky) == 3
    assert restore_checkpoint(d)[1] == 5

    def broken(*a, **k):
        raise OSError("down")

    with pytest.raises(OSError, match="down"):
        save_checkpoint_with_retry(d, {}, 6, attempts=2, sleep_s=0, _save=broken)


def test_train_main_synthetic_end_to_end(tmp_path):
    out = tmp_path / "run"
    base = ["--preset", "tiny", "--synthetic", "--device", "cpu", "--epochs", "1"]
    overrides = ["contrastive.fused_loss=true", f"train.save_path={out}"]
    state = ttrain.main(base + ["--steps-per-epoch", "2"] + overrides)
    assert state.step == 2
    recs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["loss"] > 0 for r in recs)
    assert {"lift_2d", "teacher_3d", "train_step"} <= set(recs[-1]["stages"])
    assert (out / "ckpt" / "step_2.pt").exists()
    resumed = ttrain.main(base + ["--steps-per-epoch", "1"] + overrides
                          + [f"train.resume={out / 'ckpt'}"])
    assert resumed.step == 3
    assert (out / "ckpt" / "step_3.pt").exists()


def test_stack_scenes():
    scenes = [make_scene_batch(seed=i, n_points=300, n_views=1, max_points=384,
                               max_voxels=320, max_view_points=32) for i in range(3)]
    stacked = ttrain.stack_scenes(scenes)
    assert stacked.points.shape == (3, 384, 3) and stacked.images.shape[0] == 3
    assert torch.equal(stacked.point2voxel[2], scenes[2].point2voxel)


def test_train_main_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--preset", "tiny", "--synthetic"])


@pytest.mark.parametrize("argv", [
    ["parallel.tp=2"],          # nothing shards over the model axis
    ["parallel.dp=2"],          # one process: the world is 1
])
def test_train_main_refuses_what_is_not_ported(argv):
    err = NotImplementedError if "tp" in argv[0] else ValueError
    with pytest.raises(err, match=argv[0]):
        ttrain.main(["--preset", "tiny", "--device", "cpu", "--synthetic"] + argv)
