"""The port's ``geopurify-torch-parity`` (dump / compare) and the X-Decoder
head's ``return_aux=True`` order, held against the JAX package on the CPU.

One set of seeded weights at the ``tiny`` preset (3 decoder rounds, so
every memory level recurs; the 49408-id hash tokenizer, whose SOT / EOT
both packages number alike) goes to JAX as variables and to the port
through ``utils.from_jax``, and out to one released-layout checkpoint
through the port's inverse converter. The port's ``run_ours`` at that
config is held against the body of JAX's ``run_ours`` at that config
(JAX's own ignores any config and always builds FocalNet-L: ROADMAP Queue
3): f32 rel < 1e-5. ``compare`` prints the same lines and gives the same
status as JAX's on the same dicts; JAX's ``compare`` passes on the port's
dump and the port's ``main`` passes on JAX's. The head's ``return_aux``
order is compared as the thresholded chain must be: the stride-4 masks
before any threshold tightly, the flip fraction of the binary attention
masks bounded, then everything with both sides forced onto one set of
binary masks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu import config as jconfig
from geopurify_tpu.models import lang as jlang
from geopurify_tpu.models import xdecoder as jxd
from geopurify_tpu.run import parity as jparity
from geopurify_tpu.utils import convert_xdecoder as jcx
from geopurify_tpu.utils.checkpoint import load_torch_state_dict as jload
from geopurify_tpu_torch import config as tconfig
from geopurify_tpu_torch.models import lang as tlang
from geopurify_tpu_torch.models import xdecoder as txd
from geopurify_tpu_torch.run import parity as tparity
from geopurify_tpu_torch.utils.convert_xdecoder import synthesize_torch_state_dict
from geopurify_tpu_torch.utils.from_jax import lang_from_jax, xdecoder_from_jax
from tests.test_torch_port_xdecoder import _randomize, _rel

OVERRIDES = ["text.vocab_size=49408", "xdecoder.dec_layers=3"]
CLASSES = ["wall", "floor", "chair", "table"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity")
    jcfg = jconfig.load_config("tiny", overrides=OVERRIDES)
    tcfg = tconfig.load_config("tiny", overrides=OVERRIDES)
    rng = np.random.default_rng(0)
    image = rng.uniform(0, 255, (64, 96, 3)).astype(np.float32)
    tc = jcfg.text
    jm = jxd.XDecoderSegModel(jcfg.xdecoder)
    text0 = jnp.zeros((len(CLASSES) + 1, tc.dim_proj), jnp.float32)
    params = _randomize(jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(image)[None],
                                       text0, jnp.float32(20.0)), seed=1)
    jl = jlang.LanguageEncoder(vocab_size=tc.vocab_size, width=tc.width, layers=tc.layers,
                               heads=tc.heads, context_length=tc.context_length,
                               dim_proj=tc.dim_proj)
    lparams = _randomize(jax.eval_shape(jl.init, jax.random.key(0),
                                        jnp.zeros((1, tc.context_length), jnp.int32)), seed=2)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    tm = txd.XDecoderSegModel(tcfg.xdecoder).eval()
    tm.load_state_dict(xdecoder_from_jax(np_tree(params)))
    tl = tlang.LanguageEncoder(tc.vocab_size, tc.width, tc.layers, tc.heads,
                               tc.context_length, tc.dim_proj)
    tl.load_state_dict(lang_from_jax(np_tree(lparams)))
    with torch.no_grad():
        tl.logit_scale.fill_(float(np.log(25.0)))
    ckpt = root / "xdecoder_focall_last.pt"
    torch.save({k: torch.from_numpy(v) for k, v in synthesize_torch_state_dict(tm, tl).items()},
               ckpt)
    np.save(root / "image.npy", image)
    return dict(root=root, jcfg=jcfg, tcfg=tcfg, image=image, ckpt=str(ckpt),
                params=params, tm=tm)


def jax_run_ours(ckpt, image, class_names, cfg):
    """geopurify_tpu/run/parity.py::run_ours's body at ``cfg`` (the
    converter given the config's depths), the model's apply compiled for
    time."""
    x, tc = cfg.xdecoder, cfg.text
    conv = jcx.convert_xdecoder_checkpoint(jload(ckpt), depths=tuple(x.backbone.depths),
                                           enc_layers=x.enc_layers, dec_layers=x.dec_layers)
    model = jxd.XDecoderSegModel(x)
    lang = jlang.LanguageEncoder(vocab_size=tc.vocab_size, width=tc.width, layers=tc.layers,
                                 heads=tc.heads, context_length=tc.context_length,
                                 dim_proj=tc.dim_proj)
    tk = jlang.build_tokenizer(tc.tokenizer_vocab, tc.context_length)
    text = jnp.asarray(jlang.embed_class_names(
        lambda v, i: lang.apply(v, i), conv["lang"], tk, list(class_names),
        use_templates=tc.prompt_eng, template=tc.prompt_template))
    out = jax.jit(model.apply)(conv["xdecoder"], jnp.asarray(image)[None], text,
                               jnp.float32(conv["logit_scale"]))
    return {"pred_logits": np.asarray(out["pred_logits"], np.float32),
            "pred_masks": np.asarray(out["pred_masks"], np.float32),
            "mask_embed": np.asarray(out["mask_embed"], np.float32),
            "text": np.asarray(text, np.float32)}


@pytest.fixture(scope="module")
def both(world):
    t = tparity.run_ours(world["ckpt"], world["image"], CLASSES, cfg=world["tcfg"],
                         device="cpu")
    j = jax_run_ours(world["ckpt"], world["image"], CLASSES, world["jcfg"])
    return t, j


def test_run_ours_matches_jaxs_body(both):
    t, j = both
    assert sorted(t) == sorted(j) == ["mask_embed", "pred_logits", "pred_masks", "text"]
    for k in j:
        assert t[k].dtype == np.float32 and t[k].shape == j[k].shape, k
        assert np.isfinite(t[k]).all() and np.abs(t[k]).max() > 0, k
        r = _rel(t[k], j[k])
        assert r < 1e-5, f"{k}: rel={r:.2e}"
    assert t["pred_logits"].shape == (1, 4, len(CLASSES) + 1)
    assert t["pred_masks"].shape == (1, 4, 16, 24)


def test_run_ours_bf16_passes_compare_against_jaxs_body(world, capsys):
    """At the default precision (the X-Decoder in bf16), unforced: both
    packages' ``compare`` pass the port's outputs against JAX's
    (tests/test_torch_port_parity_bf16.py holds where each rounds)."""
    over = OVERRIDES + ["xdecoder.dtype=bfloat16"]
    t = tparity.run_ours(world["ckpt"], world["image"], CLASSES,
                         cfg=tconfig.load_config("tiny", overrides=over), device="cpu")
    j = jax_run_ours(world["ckpt"], world["image"], CLASSES,
                     jconfig.load_config("tiny", overrides=over))
    assert all(np.isfinite(v).all() for v in t.values())
    assert jparity.compare(t, j) == 0 and tparity.compare(t, j) == 0
    with capsys.disabled():
        print("run_ours in bf16, the port against JAX:",
              {k: f"{_rel(t[k], j[k]):.3e}" for k in j})


def test_compare_lines_and_status_equal_jaxs(both, capsys):
    t, j = both
    off = dict(t, pred_masks=t["pred_masks"] * 1.5)
    bad_shape = dict(t, text=t["text"][:-1])
    for ours, theirs in ((t, j), (t, off), (bad_shape, j), (t, {"other": t["text"]})):
        st = tparity.compare(ours, theirs)
        lines_t = capsys.readouterr().out
        sj = jparity.compare(ours, theirs)
        lines_j = capsys.readouterr().out
        assert st == sj and lines_t == lines_j
    assert tparity.compare(t, j) == 0 and tparity.compare(t, off) == 1
    assert tparity.compare(bad_shape, j) == 1
    capsys.readouterr()


def test_main_dump_and_compare_across_packages(world, both, capsys, monkeypatch):
    """The port's ``main`` at the test's config (its default config swapped
    for the tiny one) dumps; JAX's ``compare`` passes on that dump, and the
    port's ``main --compare`` on JAX's dump exits 0."""
    root = world["root"]
    monkeypatch.setattr(tparity, "GeoPurifyConfig", lambda: world["tcfg"])
    base = ["--ckpt", world["ckpt"], "--image", str(root / "image.npy"),
            "--classes", ",".join(CLASSES), "--device", "cpu"]
    tparity.main(base + ["--dump", str(root / "port.npz")])
    dump = dict(np.load(root / "port.npz"))
    assert jparity.compare(both[1], dump) == 0
    for k, v in both[0].items():
        np.testing.assert_array_equal(dump[k], v)
    np.savez_compressed(root / "jax.npz", **both[1])
    with pytest.raises(SystemExit) as e:
        tparity.main(base + ["--compare", str(root / "jax.npz")])
    assert e.value.code == 0
    assert "parity: OK" in capsys.readouterr().out


def test_main_runs_the_default_config_without_a_preset(world, monkeypatch):
    seen = {}

    def spy(ckpt, image, classes, cfg=None, device="cuda"):
        seen.update(cfg=cfg, device=device, shape=image.shape, classes=classes)
        return {"text": np.zeros((1, 2), np.float32)}

    monkeypatch.setattr(tparity, "run_ours", spy)
    tparity.main(["--ckpt", world["ckpt"], "--dump", str(world["root"] / "d.npz")])
    default = tparity.GeoPurifyConfig()
    assert seen["cfg"] == default and seen["device"] == "cuda"
    assert default.xdecoder.dtype == "bfloat16"
    assert seen["shape"] == (484, 648, 3)
    assert seen["classes"] == ["wall", "floor", "chair", "table", "door"]
    # --dtype changes the X-Decoder's dtype and nothing else
    tparity.main(["--ckpt", world["ckpt"], "--dtype", "float32",
                  "--dump", str(world["root"] / "d.npz")])
    assert seen["cfg"].xdecoder.dtype == "float32"
    assert seen["cfg"] == dataclasses.replace(
        default, xdecoder=dataclasses.replace(default.xdecoder, dtype="float32"))
    with pytest.raises(SystemExit):
        tparity.main(["--ckpt", world["ckpt"], "--dtype", "float16"])


def test_main_refuses_the_oracle_modes_and_needs_a_checkpoint():
    for flags in (["--torch-oracle", "small"], ["--stages", "head"], ["--report", "r.md"]):
        with pytest.raises(NotImplementedError, match="reference torch code"):
            tparity.main(["--ckpt", "x.pt"] + flags)
    with pytest.raises(SystemExit) as e:
        tparity.main(["--device", "cpu"])
    assert e.value.code == 2


def test_return_aux_order_matches_jax(world):
    """``aux_masks`` / ``aux_attn`` against JAX's ``return_aux=True``: the
    round-0 stride-4 masks (before any threshold) tightly, the binary masks'
    flip fraction bounded, then both sides forced onto JAX's binary masks:
    every round's stride-4 masks and the outputs within 1e-5. The default
    order gives the same outputs up to float reassociation."""
    cfg, params, tm = world["jcfg"], world["params"], world["tm"]
    rng = np.random.default_rng(5)
    text = rng.normal(size=(len(CLASSES) + 1, cfg.text.dim_proj)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    C = cfg.xdecoder.hidden_dim
    # the pixel decoder's outputs at a 64 x 96 image: three levels, then
    # the stride-4 mask features
    ms = [rng.normal(size=(2, h, w, C)).astype(np.float32) for h, w in ((2, 3), (4, 6), (8, 12))]
    mf = rng.normal(size=(2, 16, 24, cfg.xdecoder.mask_dim)).astype(np.float32)
    head = jxd._make_head(cfg.xdecoder)
    p = {"params": params["params"]["predictor"]}
    apply = jax.jit(lambda ms, mf, over: head.apply(p, ms, mf, jnp.asarray(text),
                                                    jnp.float32(20.0), return_aux=True,
                                                    attn_mask_override=over))
    ref = apply([jnp.asarray(m) for m in ms], jnp.asarray(mf), None)
    ms_t = [torch.from_numpy(m) for m in ms]
    mf_t = torch.from_numpy(mf)
    with torch.no_grad():
        free = txd.apply_head(tm, ms_t, mf_t, torch.from_numpy(text), 20.0, return_aux=True)
        fast = txd.apply_head(tm, ms_t, mf_t, torch.from_numpy(text), 20.0)
    n = cfg.xdecoder.dec_layers + 1
    assert len(free["aux_masks"]) == len(free["aux_attn"]) == n
    Q = cfg.xdecoder.num_queries
    for i, (a, b) in enumerate(zip(free["aux_attn"], ref["aux_attn"])):
        level = ms[i % 3].shape[1:3]
        assert a.dtype == torch.bool and a.shape == (2, 1, Q, level[0] * level[1])
        assert tuple(a.shape) == np.asarray(b).shape
    assert _rel(free["aux_masks"][0].numpy(), np.asarray(ref["aux_masks"][0])) < 1e-5
    flips = [np.mean(a.numpy() != np.asarray(b))
             for a, b in zip(free["aux_attn"], ref["aux_attn"])]
    assert max(flips) < 1e-2, flips
    forced = [np.array(b)[:, 0] for b in ref["aux_attn"][:-1]]
    ref = apply([jnp.asarray(m) for m in ms], jnp.asarray(mf), [jnp.asarray(m) for m in forced])
    with torch.no_grad():
        got = txd.apply_head(tm, ms_t, mf_t, torch.from_numpy(text), 20.0, return_aux=True,
                             attn_mask_override=[torch.from_numpy(m) for m in forced])
    for i, (a, b) in enumerate(zip(got["aux_masks"], ref["aux_masks"])):
        assert _rel(a.numpy(), np.asarray(b)) < 1e-5, i
    for k in ("pred_logits", "pred_masks", "mask_embed", "cls_logits", "cls_embed"):
        assert _rel(got[k].numpy(), np.asarray(ref[k])) < 1e-5, k
    # the two orders differ by reassociation only
    for k in ("pred_logits", "pred_masks", "mask_embed"):
        assert _rel(fast[k].numpy(), free[k].numpy()) < 1e-4, k
    assert "aux_masks" not in fast and "aux_attn" not in fast
