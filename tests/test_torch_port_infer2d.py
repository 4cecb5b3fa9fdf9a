"""The 2D inference entry held against the JAX package on the CPU.

``LanguageEncoder.encode_tokens`` (f32 rel < 1e-5); the port's model equal
to its encode / head split with caption tokens; then
``run.infer2d.main`` in both packages at the ``tiny`` preset over the same
released-layout checkpoint (seeded weights with caption slots, written by
the port's inverse converter) and the same BPE merges file
(``text.tokenizer_vocab``, ``text.vocab_size`` its 517 ids, so that
neither side's text embeddings are NaN): every task and ``--eval-list``.
Compared: the query logits and mask logits tightly, then the semseg maps
(flips only at near-ties), the panoptic segment map and table, the
instance picks, the refseg matches, the caption ids, the retrieval ranking
and the evaluation's mIoU. The JAX entry's panoseg, instseg and refseg
overlays fail on any non-empty mask (it draws the stride-4 masks onto the
working-resolution image; ROADMAP Queue 3): there the tables are compared
and the port's overlay checked. The JAX ``build_pipeline`` converts
``xdecoder.ckpt`` with the FocalNet-L depths whatever the config says
(ROADMAP Queue 3); its converter is handed the tiny depths. For time, the
JAX side builds its pipeline once, compiles its forward once and runs
captioning's image encoding compiled: the same functions, fewer traces."""

import functools
import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from geopurify_tpu.models import inference2d as jinf
from geopurify_tpu.models import lang as jlang
from geopurify_tpu.models import xdecoder as jxd
from geopurify_tpu.run import infer2d as jinfer
from geopurify_tpu.run import train as jtrain
from geopurify_tpu.utils import cache as jcache
from geopurify_tpu.utils import convert_xdecoder as jcx
from geopurify_tpu_torch import config as tconfig
from geopurify_tpu_torch.models import inference2d as tinf
from geopurify_tpu_torch.models import lang as tlang
from geopurify_tpu_torch.models import xdecoder as txd
from geopurify_tpu_torch.run import infer2d as tinfer
from geopurify_tpu_torch.utils.convert_xdecoder import synthesize_torch_state_dict
from geopurify_tpu_torch.utils.from_jax import lang_from_jax

TOY_MERGES = "#version: 0.2\nh e\nl o</w>\nhe l\n"      # 517 BPE ids
CLASSES = "wall,floor,chair,table"


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
            else:
                p.copy_(0.35 * r)
    return module


def test_encode_tokens_matches_jax():
    kw = dict(vocab_size=40, width=16, layers=2, heads=2, context_length=7, dim_proj=12)
    jm = jlang.LanguageEncoder(**kw)
    ids = np.random.default_rng(0).integers(0, 38, (3, 7)).astype(np.int32)
    ids[:, -1] = 39                                       # EOT, the argmax
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32) * 0.3,
        jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(ids)))
    tok_j, pooled_j = jm.apply(params, jnp.asarray(ids), method=jm.encode_tokens)
    tm = tlang.LanguageEncoder(**kw)
    tm.load_state_dict(lang_from_jax(params))
    with torch.no_grad():
        tok_t, pooled_t = tm.encode_tokens(torch.from_numpy(ids))
    assert tok_t.shape == (3, 7, 12) and _rel(tok_t.numpy(), tok_j) < 1e-5
    assert _rel(pooled_t.numpy(), pooled_j) < 1e-5


def test_model_equals_its_encode_head_split():
    cfg = tconfig.load_config("tiny").xdecoder
    m = _seeded(txd.XDecoderSegModel(cfg, caption_len=6), 3).eval()
    g = torch.Generator().manual_seed(4)
    img = torch.rand((2, 48, 64, 3), generator=g) * 255
    text, cap = torch.randn((5, 16), generator=g), torch.randn((2, 6, 16), generator=g)
    with torch.no_grad():
        whole = m(img, text, 7.0, caption_tokens=cap)
        mf, ms = txd.encode_pixel_features(m, img)
        split = txd.apply_head(m, ms, mf, text, 7.0, caption_tokens=cap)
    assert whole["pred_captionings"].shape == (2, 6, 16)
    assert whole["pred_captions"].shape == (2, cfg.num_queries, 16)
    for k in split:
        assert torch.equal(whole[k], split[k]), k


# ---------------------------------------------------------------------------
# run.infer2d.main in both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """An image, a gallery of 4, three image / label-png pairs, the merges
    file and the released-layout checkpoint; the overrides point both
    packages' tiny preset at them."""
    root = tmp_path_factory.mktemp("infer2d")
    rng = np.random.default_rng(0)

    def image(path, hw):
        img = rng.integers(0, 255, (*hw, 3), dtype=np.uint8)
        img[10:40, 20:60] = [200, 40, 40]
        Image.fromarray(img).save(path)
        return str(path)

    img = image(root / "scene.png", (96, 128))
    (root / "gallery").mkdir()
    for i in range(4):
        image(root / "gallery" / f"g{i}.jpg" if i % 2 else root / "gallery" / f"g{i}.png",
              (48, 64))
    lines = []
    for i in range(3):
        gt = rng.integers(0, 6, (60, 80)).astype(np.uint8)
        gt[:8] = 99                                        # unmapped -> ignore
        Image.fromarray(gt).save(root / f"gt{i}.png")
        lines.append(f"{image(root / f'e{i}.png', (60, 80))} {root / f'gt{i}.png'}")
    (root / "list.txt").write_text("\n".join(lines) + "\n")
    merges = root / "bpe.txt.gz"
    with gzip.open(merges, "wt", encoding="utf-8") as f:
        f.write(TOY_MERGES)
    over = ["text.vocab_size=517", "text.width=16", f"text.tokenizer_vocab={merges}"]
    cfg = tconfig.load_config("tiny", overrides=over)
    t = cfg.text
    # seeds under which three classes and the background win queries and
    # every class wins pixels; a logit scale of 30
    xdec = _seeded(txd.XDecoderSegModel(cfg.xdecoder, caption_len=t.context_length), 17)
    lang = _seeded(tlang.LanguageEncoder(t.vocab_size, t.width, t.layers, t.heads,
                                         t.context_length, t.dim_proj), 14)
    with torch.no_grad():
        lang.logit_scale.fill_(np.log(30.0))
    torch.save({k: torch.from_numpy(v) for k, v in
                synthesize_torch_state_dict(xdec, lang).items()}, root / "xdecoder.pt")
    over = ["--preset", "tiny", *over, f"xdecoder.ckpt={root / 'xdecoder.pt'}"]
    return dict(root=root, image=img, overrides=over, cfg=cfg)


class Spy:
    """Records what a wrapped function returns (and the first two
    arguments), per package."""

    def __init__(self, monkeypatch):
        self.calls = {}
        self.mp = monkeypatch

    def wrap(self, owner, name, tag):
        fn = getattr(owner, name)

        def spy(*a, **k):
            out = fn(*a, **k)
            self.calls.setdefault(tag, []).append((a[:2], out))
            return out

        self.mp.setattr(owner, name, spy)


@pytest.fixture
def both(world, monkeypatch, tmp_path):
    """``run(task_args)`` -> (jax result, port result) of the two mains,
    with spies on the post-processing and the caption decode."""
    x = world["cfg"].xdecoder
    monkeypatch.setattr(jcx, "convert_xdecoder_checkpoint", functools.partial(
        jcx.convert_xdecoder_checkpoint, depths=tuple(x.backbone.depths),
        enc_layers=x.enc_layers, dec_layers=x.dec_layers))
    monkeypatch.setattr(jcache, "enable_persistent_cache", lambda *a, **k: "")
    # one JAX pipeline for every run (the same class list throughout):
    # building and tracing it again for each task is most of the JAX time
    built = world.setdefault("jax_pipeline", {})

    def build_once(cfg, key, **kw):
        if "p" not in built:
            built["p"] = build_jax(cfg, key, **{**kw, "return_lang": True})
        return built["p"] if kw.get("return_lang") else built["p"][:2]

    build_jax = jtrain.build_pipeline
    monkeypatch.setattr(jtrain, "build_pipeline", build_once)
    # and one compiled forward of it (each run wraps the same bound apply in
    # a new jax.jit)
    jitted = world.setdefault("jax_jit", {})
    jit = jax.jit

    def jit_once(fn, *a, **k):
        if a or k or not hasattr(fn, "__self__"):
            return jit(fn, *a, **k)
        key = (id(fn.__self__), fn.__func__)
        if key not in jitted:
            jitted[key] = (fn.__self__, jit(fn))
        return jitted[key][1]

    monkeypatch.setattr(jax, "jit", jit_once)
    # captioning's image encoding, which the JAX entry runs eagerly (op by op,
    # most of this file's time on the CPU), as one compiled function
    encode = jxd.encode_pixel_features
    monkeypatch.setattr(jxd, "encode_pixel_features", lambda cfg, params, images: jit(
        functools.partial(encode, cfg))(params, images))
    spy = Spy(monkeypatch)
    for owner, tag in ((jinfer, "j"), (tinfer, "t")):
        spy.wrap(owner, "semseg_from_outputs", f"semseg_{tag}")
    for owner, tag in ((jinf, "j"), (tinf, "t")):
        for name in ("panoptic_inference", "instance_inference", "grounding_inference"):
            spy.wrap(owner, name, f"{name}_{tag}")
    for owner, tag in ((jlang.ClipBPETokenizer, "j"), (tlang.ClipBPETokenizer, "t")):
        spy.wrap(owner, "decode", f"decode_{tag}")

    def run(args, out=None, jax_draw_fails=False):
        """``jax_draw_fails``: the JAX entry draws the stride-4 masks onto
        the working-resolution image and fails at the first non-empty one
        (ROADMAP Queue 3); its post-processing has run by then."""
        res = []
        for tag, mod in (("j", jinfer), ("t", tinfer)):
            extra = ["--device", "cpu"] if tag == "t" else []
            dst = [] if out is None else ["--out", str(tmp_path / f"{tag}_{out}")]
            argv = [*args, *dst, *extra, *world["overrides"]]
            if tag == "j" and jax_draw_fails:
                with pytest.raises(IndexError, match="boolean index did not match"):
                    mod.main(argv)
                res.append(None)
            else:
                res.append(mod.main(argv))
        return res

    run.spy = spy.calls
    return run


def _check_semseg(calls):
    """Query and mask logits tight; argmax flips only at near-ties."""
    for ((lj, mj), sj), ((lt, mt), st) in zip(calls["semseg_j"], calls["semseg_t"]):
        assert _rel(lt.numpy(), lj) < 1e-5 and _rel(mt.numpy(), mj) < 1e-5
        sj, st = np.asarray(sj), st.numpy()
        flips = sj != st
        assert flips.mean() <= 1e-3
        if flips.any():
            sem = np.asarray(jinf.semantic_inference(lj, mj))
            from geopurify_tpu.models.layers import resize_bicubic_antialias

            sem = np.asarray(resize_bicubic_antialias(jnp.asarray(sem)[None], sj.shape))[0]
            yy, xx = np.nonzero(flips)
            margin = np.abs(sem[yy, xx, sj[flips]] - sem[yy, xx, st[flips]])
            assert margin.max() < 1e-5 * np.abs(sem).max()


def test_infer2d_mask_tasks_match_jax(world, both):
    img = world["image"]
    dst = both(["--image", img, "--task", "semseg", "--classes", CLASSES, "--rich-overlay"],
               out="sem.png")
    assert all(d.endswith("sem.png") for d in dst)
    _check_semseg(both.spy)
    _, dst = both(["--image", img, "--task", "panoseg", "--classes", CLASSES,
                   "--things", "chair,table", "--object-threshold", "0.3",
                   "--overlap-threshold", "0.2"], out="pan.png", jax_draw_fails=True)
    assert np.asarray(Image.open(dst)).shape == (48, 64, 3)
    (_, (pan_j, info_j)), = both.spy["panoptic_inference_j"]
    (_, (pan_t, info_t)), = both.spy["panoptic_inference_t"]
    assert np.array_equal(pan_t.numpy(), pan_j) and info_t.valid.any()
    for f in info_t._fields:
        assert np.array_equal(getattr(info_t, f).numpy(), np.asarray(getattr(info_j, f))), f
    _, dst = both(["--image", img, "--task", "instseg", "--classes", CLASSES, "--topk", "6"],
                  out="inst.png", jax_draw_fails=True)
    assert np.asarray(Image.open(dst)).shape == (48, 64, 3)
    (_, inst_j), = both.spy["instance_inference_j"]
    (_, inst_t), = both.spy["instance_inference_t"]
    for f in ("masks", "boxes", "classes", "valid"):
        assert np.array_equal(getattr(inst_t, f).numpy(), np.asarray(getattr(inst_j, f))), f
    assert _rel(inst_t.scores.numpy(), inst_j.scores) < 1e-5
    _, dst = both(["--image", img, "--task", "refseg", "--phrases", "the red box,the floor",
                   "--classes", CLASSES],
                  out="ref.png", jax_draw_fails=True)
    assert np.asarray(Image.open(dst)).shape == (48, 64, 3)
    (_, (_, m_j)), = both.spy["grounding_inference_j"]
    (_, (_, m_t)), = both.spy["grounding_inference_t"]
    assert np.array_equal(m_t.numpy(), m_j)


def test_infer2d_text_tasks_and_eval_match_jax(world, both):
    img = world["image"]
    dst = both(["--image", img, "--task", "captioning", "--caption-steps", "5",
                "--classes", CLASSES], out="cap.png")
    assert all(d.endswith("cap.txt") for d in dst)
    # decode(self, ids[1:]): the 15 slots after BOS, 5 of them decoded
    ((_, ids_j), cj), = both.spy["decode_j"]
    ((_, ids_t), ct), = both.spy["decode_t"]
    ids_j, ids_t = np.asarray(ids_j), np.asarray(ids_t)
    assert ids_t.shape == (15,) and np.array_equal(ids_t, ids_j) and ct == cj
    assert ((0 <= ids_t) & (ids_t < 517)).all()
    assert [open(d).read() for d in dst] == [cj + "\n"] * 2

    dst = both(["--image", img, "--task", "retrieval", "--phrases", "a red box,a floor",
                "--gallery", str(world["root"] / "gallery"), "--classes", CLASSES], out="ret.png")
    rank_j, rank_t = (json.load(open(d)) for d in dst)
    assert list(rank_t) == list(rank_j) == ["a red box", "a floor"]
    for phrase in rank_j:
        assert [r["image"] for r in rank_t[phrase]] == [r["image"] for r in rank_j[phrase]]
        assert len(rank_j[phrase]) == 5
        assert np.allclose([r["score"] for r in rank_t[phrase]],
                           [r["score"] for r in rank_j[phrase]], atol=1e-4)

    res_j, res_t = both(["--eval-list", str(world["root"] / "list.txt"), "--classes", CLASSES,
                         "--label-map", "0:0,1:1,2:2,3:3,5:1"])
    _check_semseg(both.spy)
    assert len(both.spy["semseg_t"]) == 3
    assert set(res_t) == set(res_j) and np.isfinite(res_t["mIoU"])
    for k in res_j:
        assert res_t[k] == pytest.approx(res_j[k], abs=1e-9), k
