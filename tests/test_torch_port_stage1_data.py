"""Stage 1 over on-disk scenes, held against the JAX package on the CPU at
the ``tiny`` preset: the fused-feature loader and its batches (exact, with
``mask_full``, ``mask`` and no mask), the scene selector (the same ids),
``precompute_scene`` (f32 rel < 1e-5), the loader without augmentation on
the train split, and a cache written by the JAX ``precompute_scene``, which
must train the port's step to the losses of the port's own cache.
``tests/test_torch_port_train_data.py`` holds the trainer's real-data modes
against JAX over the same fixtures.

Both packages build their pipelines from the same released-layout
checkpoint files (``xdecoder.ckpt``, ``sonata.ckpt``; seeded weights
written out by the port's inverse converters) and the same BPE merges file
(``text.tokenizer_vocab``, with ``text.vocab_size`` set to its 517 ids, so
that neither side's text embeddings are NaN). The JAX ``build_pipeline``
converts ``xdecoder.ckpt`` with the FocalNet-L depths whatever the config
says; the tests hand its converter the tiny depths."""

import dataclasses
import functools
import gzip
import json

import jax
import numpy as np
import pytest
import torch

from geopurify_tpu import config as jconfig
from geopurify_tpu import native as jnative
from geopurify_tpu.data import feature_loader as jfeat
from geopurify_tpu.data import loaders as jloaders
from geopurify_tpu.data import selector as jsel
from geopurify_tpu.run import precompute as jprecompute
from geopurify_tpu.run import train as jtrain
from geopurify_tpu.utils import cache as jcache
from geopurify_tpu.utils import convert_xdecoder as jcx
from geopurify_tpu_torch import config as tconfig
from geopurify_tpu_torch.data import feature_loader as tfeat
from geopurify_tpu_torch.data import loaders as tloaders
from geopurify_tpu_torch.data import selector as tsel
from geopurify_tpu_torch.models import lang as tlang
from geopurify_tpu_torch.models import xdecoder as txd
from geopurify_tpu_torch.models.pipeline import build_sonata
from geopurify_tpu_torch.run import precompute as tprecompute
from geopurify_tpu_torch.run import train as ttrain
from geopurify_tpu_torch.utils.convert_sonata import export_sonata_state_dict
from geopurify_tpu_torch.utils.convert_xdecoder import synthesize_torch_state_dict
from tests.test_torch_port_data import _same_batch, loader_cfg, write_on_disk

TOY_MERGES = "#version: 0.2\nh e\nl o</w>\nhe l\n"      # 517 BPE ids


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _seeded(module, seed):
    """Zero biases, norm scales near 1, N(0, 0.35^2) elsewhere."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if name.endswith("bias"):
                p.zero_()
            elif ("norm" in name or "ln" in name) and p.dim() == 1:
                p.copy_(1 + 0.1 * r)
            elif p.dim() == 3:          # sparse-conv taps [K, Cin, Cout]
                p.copy_(r * (2.0 / (p.shape[0] * p.shape[1])) ** 0.5)
            else:
                p.copy_(0.35 * r)
    return module


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Three on-disk scenes (tests/test_torch_port_data.write_on_disk), a
    train list of the first and third, the released-layout checkpoints and
    the merges file; ``overrides`` point both packages' tiny preset at them."""
    root = tmp_path_factory.mktemp("stage1")
    root, sids = write_on_disk(root, np.random.default_rng(0))
    train = [sids[0], sids[2]]
    (root / "train.txt").write_text("\n".join(train) + "\n")
    merges = root / "bpe.txt.gz"
    with gzip.open(merges, "wt", encoding="utf-8") as f:
        f.write(TOY_MERGES)
    tcfg = tconfig.load_config("tiny", overrides=["text.vocab_size=517"])
    t = tcfg.text
    xdec = _seeded(txd.XDecoderSegModel(tcfg.xdecoder), 13)
    lang = _seeded(tlang.LanguageEncoder(t.vocab_size, t.width, t.layers, t.heads,
                                         t.context_length, t.dim_proj), 14)
    torch.save({k: torch.from_numpy(v) for k, v in
                synthesize_torch_state_dict(xdec, lang).items()}, root / "xdecoder.pt")
    sonata = _seeded(build_sonata(tcfg.sonata), 15)
    torch.save({k: torch.from_numpy(v) for k, v in export_sonata_state_dict(sonata).items()},
               root / "sonata.pth")
    overrides = [
        f"data.data_root={root / '3d'}", f"data.data_root_2d={root / '2d'}",
        f"data.train_scene_list={root / 'train.txt'}",
        f"data.eval_scene_list={root / 'list.txt'}",
        "data.max_views=2", "data.max_views_eval=4", "data.max_voxels=384",
        "fusion.visibility_threshold=0.1", "text.vocab_size=517",
        f"text.tokenizer_vocab={merges}", f"xdecoder.ckpt={root / 'xdecoder.pt'}",
        f"sonata.ckpt={root / 'sonata.pth'}", "contrastive.fused_loss=true",
        "parallel.dp=1"]
    return dict(root=root, sids=sids, train=train, overrides=overrides)


@pytest.fixture
def jax_tiny(monkeypatch):
    """The JAX trainer's checkpoint conversion at the tiny depths, its
    numpy mapping (the port's semantics: augmented points stay float64),
    and no persistent compile cache."""
    x = tconfig.load_config("tiny").xdecoder
    monkeypatch.setattr(jcx, "convert_xdecoder_checkpoint", functools.partial(
        jcx.convert_xdecoder_checkpoint, depths=tuple(x.backbone.depths),
        enc_layers=x.enc_layers, dec_layers=x.dec_layers))
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(jcache, "enable_persistent_cache", lambda *a, **k: "")


# ---------------------------------------------------------------------------
# fused features
# ---------------------------------------------------------------------------

def _write_fused(d, root, sids, kind, rng):
    """One ``<sid>_0.pt`` per scene but the last (which then has none), in
    the reference layout: ``feat`` over the masked points, and ``mask_full``
    or ``mask`` (or no mask: a feature per point)."""
    d.mkdir(exist_ok=True)
    for sid in sids[:-1]:
        n = len(jloaders.load_scene_any(str(root / "3d" / f"{sid}_vh_clean_2.pth")).xyz)
        mask = rng.random(n) < 0.7
        feat = rng.normal(size=(n if kind == "none" else int(mask.sum()), 16))
        obj = {"feat": torch.from_numpy(feat.astype(np.float32))}
        if kind != "none":
            obj[kind] = torch.from_numpy(mask)
        torch.save(obj, d / f"{sid}_0.pt")
        torch.save({"feat": torch.zeros(1, 16)}, d / f"{sid}_1.pt")   # sorted after _0


@pytest.mark.parametrize("kind", ["mask_full", "mask", "none"])
def test_fused_features_match_jax(world, tmp_path, kind):
    root, sids = world["root"], world["sids"]
    _write_fused(tmp_path, root, sids, kind, np.random.default_rng(3))
    # a voxel budget of max_points drops no point, where the two loaders'
    # rows agree (test_fused_features_stay_aligned_when_the_voxel_budget_drops_points)
    jcfg, tcfg = (loader_cfg(pkg, root) for pkg in (jconfig, tconfig))
    jcfg, tcfg = (dataclasses.replace(c, data=dataclasses.replace(c.data, max_voxels=512))
                  for c in (jcfg, tcfg))
    jds = jfeat.FusedFeatureDataset(jcfg, str(tmp_path))
    tds = tfeat.FusedFeatureDataset(tcfg, str(tmp_path), device="cpu")
    assert len(tds) == len(jds) == 3
    for sid in sids[:-1]:
        n = len(tloaders.load_scene_any(tds.base.scene_3d_path(sid)).xyz)
        path = tds.feature_path(sid)
        assert path == jds.feature_path(sid) and path.endswith("_0.pt")
        for a, b in zip(tfeat.load_fused_features(path, n), jfeat.load_fused_features(path, n)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        (tb, tf), (jb, jf) = (tds.make_scene_batch_with_features(sid),
                              jds.make_scene_batch_with_features(sid))
        _same_batch(tb, jb)
        assert int(tb.point_valid.sum()) == min(n, 512)
        assert tf.dtype == jf.dtype == np.float32 and tf.shape == (512, 16)
        np.testing.assert_array_equal(tf, jf)
        assert np.abs(tf).sum() > 0
    assert tds.make_scene_batch_with_features(sids[-1]) is None
    assert jds.make_scene_batch_with_features(sids[-1]) is None
    if kind == "none":      # a feature count that is not the point count
        bad = tmp_path / "bad.pt"
        torch.save({"feat": torch.zeros(3, 16)}, bad)
        for pkg in (tfeat, jfeat):
            with pytest.raises(ValueError, match="no mask"):
                pkg.load_fused_features(str(bad), 4)


# ---------------------------------------------------------------------------
# scene selector
# ---------------------------------------------------------------------------

def test_selector_matches_jax(tmp_path):
    """Twelve scenes whose labels cover different class subsets (one with
    no valid label), two seeds and two subset sizes."""
    rng = np.random.default_rng(7)
    paths = {}
    for i in range(12):
        n = int(rng.integers(50, 400))
        classes = rng.choice(20, size=int(rng.integers(1, 12)), replace=False)
        labels = rng.choice(classes, n) if i else np.full(n, 255)
        labels[rng.random(n) < 0.1] = 255
        p = tmp_path / f"scene{i:04d}_00.pth"
        torch.save((rng.normal(size=(n, 3)).astype(np.float32),
                    rng.uniform(-1, 1, (n, 3)).astype(np.float32), labels.astype(np.int64)), p)
        paths[p.stem] = str(p)
    for sid in sorted(paths):
        a, b = tsel.scene_label_stats(paths[sid], 20), jsel.scene_label_stats(paths[sid], 20)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]
    for kw in (dict(subset_size=5, num_clusters=3, seed=0),
               dict(subset_size=8, num_clusters=4, seed=1, gamma=1.0)):
        got = tsel.select_training_subset(paths, 20, workers=2, **kw)
        assert got == jsel.select_training_subset(paths, 20, workers=2, **kw)
        assert len(got) == kw["subset_size"] == len(set(got))
    tsel.write_scene_list(str(tmp_path / "t.txt"), got)
    jsel.write_scene_list(str(tmp_path / "j.txt"), got)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


# ---------------------------------------------------------------------------
# teacher-feature precompute
# ---------------------------------------------------------------------------

def test_precompute_scene_matches_jax(world, jax_tiny):
    """Both trainers' ``build_pipeline`` on the checkpoint files, the same
    loaded scene (augmentation off), one cache entry each."""
    ov = world["overrides"]
    jcfg = jconfig.load_config("tiny", overrides=ov)
    tcfg = tconfig.load_config("tiny", overrides=ov)
    jp, _ = jtrain.build_pipeline(jcfg, jax.random.key(0), require_teachers=True)
    tp = ttrain.build_pipeline(tcfg, torch.Generator().manual_seed(0), "cpu",
                               require_teachers=True)
    np.testing.assert_allclose(tp.text_embeddings.numpy(), np.asarray(jp.text_embeddings),
                               rtol=1e-5, atol=1e-6)
    assert tp.logit_scale == float(jp.logit_scale)
    sid = world["train"][1]
    jb = jloaders.SceneDataset(jcfg, split="train", augment=False).make_scene_batch(sid)
    tb = tloaders.SceneDataset(tcfg, split="train", augment=False,
                               device="cpu").make_scene_batch(sid)
    _same_batch(tb, jb)
    got, ref = tprecompute.precompute_scene(tp, tb), jprecompute.precompute_scene(jp, jb)
    assert list(got) == list(ref) == ["f2d", "f_teacher", "point_valid"]
    for k in got:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
    np.testing.assert_array_equal(got["point_valid"], ref["point_valid"])
    for k in ("f2d", "f_teacher"):
        assert np.abs(ref[k]).max() > 0 and np.isfinite(got[k]).all()
        assert _rel(got[k], ref[k]) < 1e-5, k
    assert list(tprecompute.precompute_scene(tp, tb, sonata_live=False)) == [
        "f2d", "point_valid"]


def test_scene_dataset_augment_flag_matches_jax(world):
    """``augment=False`` on the train split: the port's batches equal the
    JAX loader's for every scene of the list (the frozen-input modes' and
    the precompute's loader)."""
    root = world["root"]
    tds = tloaders.SceneDataset(loader_cfg(tconfig, root), split="train", augment=False,
                                seed=5, device="cpu")
    jds = jloaders.SceneDataset(loader_cfg(jconfig, root), split="train", augment=False,
                                seed=5)
    assert tds.augment is None and jds.augment is None
    for sid in world["sids"]:
        _same_batch(tds.make_scene_batch(sid), jds.make_scene_batch(sid))
    assert tloaders.SceneDataset(loader_cfg(tconfig, root), split="train",
                                 device="cpu").augment is not None


# ---------------------------------------------------------------------------
# the teacher cache: one written by either package trains the port
# ---------------------------------------------------------------------------

def _port_run(monkeypatch, argv):
    """``run.train.main`` on the CPU; returns (state, per-step inputs)."""
    rec = []
    call = ttrain.StepInputs.__call__

    def recording(self, it):
        out = call(self, it)
        rec.append(out)
        return out

    monkeypatch.setattr(ttrain.StepInputs, "__call__", recording)
    state = ttrain.main(["--preset", "tiny", "--device", "cpu"] + argv)
    monkeypatch.setattr(ttrain.StepInputs, "__call__", call)
    return state, rec


@pytest.fixture(scope="module")
def caches(world, tmp_path_factory):
    """The port's teacher cache (``run.precompute.main`` over the train
    list) and fused-feature files made from it."""
    d = tmp_path_factory.mktemp("cache")
    seconds = tprecompute.main(["--preset", "tiny", "--device", "cpu", "--out", str(d / "npz")]
                               + world["overrides"])
    assert sorted(seconds) == sorted(world["train"])
    s = world["sids"]
    _write_fused(d / "fused", world["root"], [s[0], s[2], s[1]], "mask_full",
                 np.random.default_rng(5))
    return d


def test_jax_cache_trains_like_the_ports(world, caches, jax_tiny, monkeypatch, tmp_path):
    """A cache written by the JAX ``precompute_scene`` trains the port's
    step to the port's own cache's losses."""
    ov = world["overrides"]
    jcfg = jconfig.load_config("tiny", overrides=ov)
    jp, _ = jtrain.build_pipeline(jcfg, jax.random.key(0), require_teachers=True)
    jds = jloaders.SceneDataset(jcfg, split="train", augment=False)
    (tmp_path / "jax").mkdir()
    for sid in world["train"]:
        np.savez_compressed(tmp_path / "jax" / f"{sid}.npz",
                            **jprecompute.precompute_scene(jp, jds.make_scene_batch(sid)))
    losses = {}
    for name, cache in (("port", caches / "npz"), ("jax", tmp_path / "jax")):
        _port_run(monkeypatch, ["--teacher-cache", str(cache), "--steps-per-epoch", "2",
                                f"train.save_path={tmp_path / name}"] + ov)
        recs = (tmp_path / name / "metrics.jsonl").read_text().splitlines()
        losses[name] = [json.loads(x)["loss"] for x in recs]
    assert len(losses["jax"]) == 2
    np.testing.assert_allclose(losses["jax"], losses["port"], rtol=1e-5)


def test_fused_features_stay_aligned_when_the_voxel_budget_drops_points(world, tmp_path):
    """A budget of 64 voxels drops most points of each scene: row i of the
    port's features is still point i's (each file row holds its point's
    coordinates). The JAX loader indexes the file by the point cap alone,
    so its rows slip from the first dropped point on."""
    root, sids = world["root"], world["sids"]
    for sid in sids:
        xyz = tloaders.load_scene_any(str(root / "3d" / f"{sid}_vh_clean_2.pth")).xyz
        feat = np.concatenate([xyz, np.zeros((len(xyz), 13))], 1).astype(np.float32)
        torch.save({"feat": torch.from_numpy(feat)}, tmp_path / f"{sid}.pt")
    cfgs = [dataclasses.replace(c, data=dataclasses.replace(c.data, max_voxels=64))
            for c in (loader_cfg(tconfig, root), loader_cfg(jconfig, root))]
    tds = tfeat.FusedFeatureDataset(cfgs[0], str(tmp_path), device="cpu")
    jds = jfeat.FusedFeatureDataset(cfgs[1], str(tmp_path))
    for sid in sids:
        (tb, tf), (jb, jf) = (tds.make_scene_batch_with_features(sid),
                              jds.make_scene_batch_with_features(sid))
        _same_batch(tb, jb)
        n = int(tb.point_valid.sum())
        n_all = len(tloaders.load_scene_any(tds.base.scene_3d_path(sid)).xyz)
        assert n < min(n_all, 512)                       # the budget dropped points
        np.testing.assert_allclose(tf[:n, :3], tb.points[:n].numpy(), rtol=1e-6, atol=1e-6)
        assert not np.allclose(jf[:n, :3], tb.points[:n].numpy(), atol=1e-3)
        assert not tf[n:].any()


def test_logit_scale_without_a_checkpoint_is_jaxs(world, jax_tiny):
    """Without ``xdecoder.ckpt`` both trainers take the exp of the language
    tower's f32 parameter (1.0 at init): the correctly rounded value of
    ``jnp.exp``, one ulp from numpy's. (With the checkpoint both take the
    converter's numpy exp: test_precompute_scene_matches_jax.)"""
    ov = [o for o in world["overrides"] if not o.startswith(("xdecoder.ckpt", "sonata.ckpt"))]
    jp, _ = jtrain.build_pipeline(jconfig.load_config("tiny", overrides=ov), jax.random.key(0))
    tp = ttrain.build_pipeline(tconfig.load_config("tiny", overrides=ov),
                               torch.Generator().manual_seed(0), "cpu", with_sonata=False)
    assert tp.logit_scale == float(jp.logit_scale) == float(np.float32(np.e))
    assert tp.logit_scale != float(np.exp(np.float32(1.0)))
