"""The interactive entry held against the JAX package on the CPU.

``run.infer_interactive.main`` runs in both packages at tiny widths on the
96x128 synthetic image. The JAX entry seeds its weights from
``jax.random.key(0)``, which torch cannot reproduce: the test seeds the
port's models, hands their weights to the JAX entry's ``.init`` calls as
arrays (no JAX init is traced) and replaces the port's ``build_models``
with them and JAX's text embeddings; the per-round draws are numpy in
both. Compared: the v1 loop's mask logits round by round (f32 rel <
1e-5) and the written masks (flips only at near-ties), and the
``--eval-noc`` JSON line (``--task demo`` is in
``tests/test_torch_port_interactive_demo.py``). Then the first-click rule
(``distance_transform_conv``, ``_center_clicks``) and every evaluator of
``utils/eval2d_suite.py`` against JAX's on seeded inputs."""

import dataclasses
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from geopurify_tpu.data import visual_sampler as jvs
from geopurify_tpu.models import focalnet as jfocal
from geopurify_tpu.models import pixel_decoder as jpixdec
from geopurify_tpu.models import seem as jseem
from geopurify_tpu.run import infer_interactive as jinter
from geopurify_tpu.utils import cache as jcache
from geopurify_tpu.utils import eval2d_suite as jev
from geopurify_tpu_torch import config as tconfig
from geopurify_tpu_torch.data import visual_sampler as tvs
from geopurify_tpu_torch.models import seem as tseem
from geopurify_tpu_torch.run import infer_interactive as tinter
from geopurify_tpu_torch.utils import eval2d_suite as tev
from tests.test_torch_port_backbones2d import seeded_jax_params
from tests.test_torch_port_seem import seed_head_

TINY = ["xdecoder.hidden_dim=16", "xdecoder.conv_dim=16", "xdecoder.mask_dim=16",
        "xdecoder.num_queries=5", "xdecoder.nheads=2", "xdecoder.dim_feedforward=32",
        "xdecoder.dec_layers=2", "xdecoder.enc_layers=1", "xdecoder.dtype=float32",
        "xdecoder.backbone.embed_dim=8", "xdecoder.backbone.depths=[1,1,1,1]",
        "xdecoder.backbone.focal_levels=[2,2,2,2]", "data.all_label=['a','b','c']"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def run_both(monkeypatch, capsys, argv, out_dir, task="v1", budget=8):
    """``main(argv)`` in both packages (``--out`` into ``out_dir``) on the
    same weights: the port's models seeded here, their JAX variables handed
    to the JAX entry's ``.init`` calls. Returns each side's return value,
    its head outputs call by call, its demo picks and its stdout lines."""
    cfg = tconfig.load_config("scannet", overrides=TINY)
    n_cls = max(len(cfg.data.all_label), 2)
    xc = dataclasses.replace(cfg.xdecoder, dtype="float32")
    models = tinter.build_models(xc, task, budget, n_cls, "cpu")
    jvars = {"backbone": seeded_jax_params(models.backbone, 1),
             "pixel_decoder": seeded_jax_params(models.pixel_decoder, 2),
             "head": seed_head_(models.head, 3)}
    text = jax.random.normal(jax.random.key(0), (n_cls, xc.hidden_dim))
    models.text = torch.from_numpy(np.array(text / jnp.linalg.norm(text, axis=-1,
                                                                   keepdims=True)))
    monkeypatch.setattr(jcache, "enable_persistent_cache", lambda *a, **k: "")
    jcalls, jpicks, tcalls, tpicks = [], [], [], []
    for cls, key in ((jfocal.FocalNet, "backbone"),
                     (jpixdec.TransformerEncoderPixelDecoder, "pixel_decoder"),
                     (jseem.SEEMHeadV1, "head"), (jseem.SEEMHeadDemo, "head")):
        monkeypatch.setattr(cls, "init", lambda self, *a, _key=key, **k: jvars[_key])
    keep = ("pred_masks", "prev_mask", "pred_logits")
    for cls in (jseem.SEEMHeadV1, jseem.SEEMHeadDemo):
        def apply(self, *a, **k):
            out = fnn.Module.apply(self, *a, **k)
            if "pred_masks" in out:               # not the refimg bundle
                jax.debug.callback(lambda d: jcalls.append(jax.tree_util.tree_map(
                    np.asarray, d)), {n: out[n] for n in keep if n in out})
            return out
        monkeypatch.setattr(cls, "apply", apply)
    models.head.register_forward_hook(lambda mod, a, out: tcalls.append(
        {n: out[n].numpy() for n in keep if n in out}) if "pred_masks" in out else None)

    def picks(orig, rec):
        def pick(out, prompt="spatial"):
            best, mask = orig(out, prompt)
            rec.append((np.asarray(best), np.asarray(mask)))
            return best, mask
        return pick

    monkeypatch.setattr(jseem, "demo_select_mask", picks(jseem.demo_select_mask, jpicks))
    monkeypatch.setattr(tseem, "demo_select_mask", picks(tseem.demo_select_mask, tpicks))
    monkeypatch.setattr(tinter, "build_models", lambda *a, **k: models)
    capsys.readouterr()
    res_j = jinter.main([*argv, "--out", str(out_dir / "jax.png"), *TINY])
    lines_j = capsys.readouterr().out.splitlines()
    res_t = tinter.main([*argv, "--out", str(out_dir / "port.png"), *TINY, "--device", "cpu"])
    lines_t = capsys.readouterr().out.splitlines()
    return (res_j, jcalls, jpicks, lines_j), (res_t, tcalls, tpicks, lines_t)


def _same_calls(jcalls, tcalls):
    assert len(tcalls) == len(jcalls) > 0
    for j, t in zip(jcalls, tcalls):
        assert set(j) == set(t)
        for k in j:
            assert t[k].shape == j[k].shape, k
            assert _rel(t[k], j[k]) < 1e-5, (k, _rel(t[k], j[k]))


def test_v1_loop_matches_jax(monkeypatch, capsys, tmp_path):
    """Three rounds of the refinement loop with a negative click: each
    round's mask logits tight, then the written overlays."""
    (rj, cj, _, _), (rt, ct, _, _) = run_both(
        monkeypatch, capsys, ["--synthetic", "--clicks", "40,60;44,70", "--neg-clicks", "10,10",
                      "--rounds", "3", "--budget", "8"], tmp_path)
    _same_calls(cj, ct)
    assert len(ct) == 3
    last = cj[-1]["prev_mask"][0, 0]
    on_j, on_t = last > 0, ct[-1]["prev_mask"][0, 0] > 0
    flips = on_j != on_t
    assert not flips.any() or np.abs(last[flips]).max() < 1e-5 * np.abs(last).max()
    img_j, img_t = np.asarray(Image.open(rj)), np.asarray(Image.open(rt))
    if not flips.any():
        assert np.array_equal(img_t, img_j)
    assert 0 < on_t.mean() < 1


def test_eval_noc_matches_jax(monkeypatch, capsys, tmp_path):
    """``--eval-noc 2 --rounds 3``: the same clicks (every forward's logits
    tight) and the same JSON line."""
    (rj, cj, _, lj), (rt, ct, _, lt) = run_both(
        monkeypatch, capsys, ["--synthetic", "--eval-noc", "2", "--rounds", "3", "--budget", "32"],
        tmp_path, budget=32)
    assert rj == rt == 0
    _same_calls(cj, ct)
    assert lt == lj and len(lt) == 1
    rec = json.loads(lt[0])
    assert set(rec) == {"noc@0.5", "noc@0.8", "noc@0.85", "noc@0.9", "miou@iter1"}


def test_first_click_rule_matches_jax():
    """``distance_transform_conv`` on single maps and stacks, and
    ``_center_clicks`` on ellipses, a border-touching mask and a one-pixel
    mask."""
    rng = np.random.default_rng(5)
    for img in ((rng.uniform(size=(13, 17)) < 0.1).astype(np.float32),
                (rng.uniform(size=(3, 9, 11)) < 0.3).astype(np.float32)):
        got = tvs.distance_transform_conv(img)
        assert np.array_equal(got, jvs.distance_transform_conv(img))
    yy, xx = np.mgrid[0:24, 0:32]
    masks = [(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0
             for cy, cx, ry, rx in ((12, 16, 6, 9), (5, 28, 4, 3), (20, 4, 8, 8))]
    dot = np.zeros((24, 32), bool)
    dot[3, 7] = True
    fp = np.stack(masks + [dot])
    got = tvs._center_clicks(fp)
    assert np.array_equal(got, jvs._center_clicks(fp))
    assert got[-1] == 3 * 32 + 7


def test_eval2d_suite_matches_jax():
    """Every evaluator on the same seeded inputs gives JAX's numbers."""
    rng = np.random.default_rng(6)

    def both(name, *init):
        return getattr(tev, name)(*init), getattr(jev, name)(*init)

    def same(t, j):
        rt, rj = t.evaluate(), j.evaluate()
        assert list(rt) == list(rj) and all(rt[k] == rj[k] for k in rj), (rt, rj)
        return rt

    t, j = both("GroundingEvaluator")
    for _ in range(3):
        p, g = rng.uniform(size=(4, 12, 16)) < 0.4, rng.uniform(size=(4, 12, 16)) < 0.4
        t.process(p, g)
        j.process(p, g)
    same(t, j)
    t, j = both("InteractiveEvaluator", 5, 2)
    ious = [rng.uniform(size=5) for _ in range(6)]
    t.process(ious)
    j.process(ious)
    same(t, j)
    for ensemble in (False, True):
        t, j = both("RetrievalEvaluator", ensemble)
        for i in range(12):
            args = (i, rng.normal(size=8), [i, i], rng.normal(size=(2, 8)), rng.normal(size=8))
            t.process(*args)
            j.process(*args)
        same(t, j)
    t, j = both("ClassificationEvaluator")
    logits, labels = rng.normal(size=(40, 10)), rng.integers(0, 10, 40)
    t.process(logits, labels)
    j.process(logits, labels)
    same(t, j)
    words = "a chair a table the floor near wall".split()
    cands = [" ".join(rng.choice(words, 6)) for _ in range(5)]
    refs = [[" ".join(rng.choice(words, 7)) for _ in range(2)] for _ in range(5)]
    assert tev.bleu4(cands, refs) == jev.bleu4(cands, refs)
    t, j = both("CaptioningEvaluator")
    for c, r in zip(cands, refs):
        t.process(c, r)
        j.process(c, r)
    same(t, j)
    t, j = both("PanopticEvaluator", 0)
    for _ in range(3):
        gt = rng.integers(0, 5, (20, 24))
        pred = np.where(rng.uniform(size=gt.shape) < 0.8, gt, rng.integers(1, 6, gt.shape))
        gi = {s: int(s % 3) for s in range(1, 5)}
        pi = {s: int(s % 3) for s in range(1, 6)}
        t.process(pred, pi, gt, gi)
        j.process(pred, pi, gt, gi)
    same(t, j)
    t, j = both("InstanceEvaluator", 3)
    for _ in range(2):
        gm = rng.uniform(size=(4, 16, 16)) < 0.3
        pm = np.concatenate([gm[:3] ^ (rng.uniform(size=(3, 16, 16)) < 0.1),
                             rng.uniform(size=(2, 16, 16)) < 0.3])
        args = (pm, rng.integers(0, 3, 5), rng.uniform(size=5), gm, rng.integers(0, 3, 4))
        t.process(*args)
        j.process(*args)
    same(t, j)


@pytest.mark.parametrize("over,probe", [("xdecoder.backbone.variant=focal_dw", "dw1."),
                                        ("xdecoder.pixel_decoder=deform", "level_embed")])
def test_build_models_follows_the_config(over, probe):
    """The port's entry builds the backbone and pixel decoder that
    ``xdecoder`` names (the JAX entry builds the plain FocalNet and the FPN
    whatever it says; ROADMAP Queue 3)."""
    cfg = tconfig.load_config("scannet", overrides=[*TINY, over])
    m = tinter.build_models(dataclasses.replace(cfg.xdecoder, dtype="float32"), "v1", 8, 3,
                            "cpu")
    names = [n for mod in (m.backbone, m.pixel_decoder) for n, _ in mod.named_parameters()]
    assert any(probe in n for n in names), over
    assert m.head.max_spatial_tokens == 8 and m.text.shape == (3, 16)
