"""The SEEM heads held against the JAX package on the CPU.

Narrow widths as in ``tests/test_seem.py`` (C=16, Q=5, 2 heads, 2 layers,
mask features 16x24). The port's heads are seeded and their weights handed
to JAX as arrays (the inverse of ``utils.from_jax.seem_from_jax``, which
carries them back). Every round thresholds bilinearly resized mask logits
at sigmoid < 0.5, so each comparison runs in three steps: the resized
logits before every threshold are recorded on both sides (the JAX head's
``resize_bilinear_torch`` wrapped while it is traced) and agree at f32 rel
< 1e-5, with the port forced onto JAX's binary masks; a flip (a side of
the threshold the two disagree on) must sit within 1e-5 of the logits'
scale of it; every output of the forced run agrees at rel < 1e-5; and
with no flip the port's own run equals the forced one bit for bit. Then
the host helpers, ``point_sample``'s align_corners=True convention, both
resizes and the lazy Flax parameter groups."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from geopurify_tpu.models import layers as jlayers
from geopurify_tpu.models import seem as jseem
from geopurify_tpu.ops.ms_deform_attn import bilinear_sample as jbilinear_sample
from geopurify_tpu_torch.models import layers as tlayers
from geopurify_tpu_torch.models import seem as tseem
from geopurify_tpu_torch.utils.from_jax import seem_from_jax

C, Q, S, G, A, M, K = 16, 5, 8, 4, 3, 3, 2
KW = dict(hidden_dim=C, dim_proj=C, num_queries=Q, nheads=2, dim_feedforward=32,
          dec_layers=2, mask_dim=C, max_spatial_tokens=S)
V0_KW = dict(KW, num_spatial_memories=M, max_grounding_tokens=G)
V1_KW = dict(KW, num_spatial_memories=M, sample_size=K, max_grounding_tokens=G)
DEMO_KW = dict(KW, max_grounding_tokens=G, max_audio_tokens=A)
SCALE = np.float32(10.0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def seed_head_(head, seed: int):
    """Seed a port SEEM head from ``seed`` (Dense kernels N(0, 1/fan-in),
    biases N(0, 0.1^2), norm scales 1 + N(0, 0.1^2), queries, level and
    memory embeddings N(0, 1), the projections N(0, 1/C), the indicator
    N(0, 0.5^2)) and return the same weights as JAX variables."""
    g = torch.Generator().manual_seed(seed)
    tree = {}
    with torch.no_grad():
        for name, p in head.named_parameters():
            *path, leaf = name.split(".")
            r = torch.randn(p.shape, generator=g)
            if leaf == "weight":
                p.copy_(1 + 0.1 * r if p.dim() == 1 else r / p.shape[1] ** 0.5)
            elif leaf == "bias":
                p.copy_(0.1 * r)
            elif leaf == "class_embed" or leaf.startswith("mask_spatial_embed"):
                p.copy_(r / p.shape[0] ** 0.5)
            elif leaf == "pn_indicator":
                p.copy_(0.5 * r)
            else:
                p.copy_(r)
            a = p.numpy().copy()
            if leaf == "weight":
                leaf, a = ("scale", a) if a.ndim == 1 else ("kernel", a.T.copy())
            node = tree
            for q in path:
                node = node.setdefault(q, {})
            node[leaf] = a
    return {"params": tree}


def seeded_head(cls, seed: int, **kw):
    """A seeded port head of ``cls`` and its JAX variables."""
    head = cls(**kw).eval()
    return head, seed_head_(head, seed)


def feature_inputs(seed: int, B: int = 1):
    rng = np.random.default_rng(seed)
    ms = [rng.normal(size=(B, h, w, C)).astype(np.float32)
          for h, w in ((2, 3), (4, 6), (8, 12))]
    mf = rng.normal(size=(B, 16, 24, C)).astype(np.float32)
    text = rng.normal(size=(4, C)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    return rng, ms, mf, text


def spatial_prompts(rng, B: int = 1, n_valid: int = 6, n_pos: int = 4):
    pts = rng.uniform(0, 1, (B, S, 2)).astype(np.float32)
    valid = np.zeros((B, S), bool)
    valid[:, :n_valid] = True
    tags = np.where(np.arange(S) < n_pos, 1, -1).astype(np.int32)[None].repeat(B, 0)
    return pts, valid, tags


def _to(x, conv):
    if isinstance(x, np.ndarray):
        return conv(x)
    if isinstance(x, (list, tuple)):
        return [_to(y, conv) for y in x]
    return x


def _flat(out, prefix=""):
    """name -> numpy array of a (nested) output dict."""
    items = {}
    for k, v in out.items():
        vs = v if isinstance(v, (list, tuple)) else [v]
        for i, x in enumerate(vs):
            name = f"{prefix}{k}" + (f"[{i}]" if isinstance(v, (list, tuple)) else "")
            items[name] = (x.detach().numpy() if isinstance(x, torch.Tensor)
                           else np.asarray(x))
    return items


def run_both(monkeypatch, jhead, jvars, thead, *args, **kw):
    """Both heads on the same inputs (numpy args; the JAX head jitted, its
    resizes' outputs returned beside its own): the JAX outputs, the port's
    forced onto JAX's binary masks, the port's own, and per threshold the
    (rel, flips) of the resized logits."""
    trec = []
    arrays = {k: v for k, v in kw.items() if isinstance(v, (np.ndarray, list))}
    static = {k: v for k, v in kw.items() if k not in arrays}

    def j_fn(jvars, args, arrays):
        rec = []
        j_resize = jseem.resize_bilinear_torch

        def recording(x, out_hw):
            y = j_resize(x, out_hw)
            rec.append(y)
            return y

        with monkeypatch.context() as m:
            m.setattr(jseem, "resize_bilinear_torch", recording)
            return jhead.apply(jvars, *args, **arrays, **static), rec

    jout, jrec = jax.jit(j_fn)(jvars, list(args), arrays)
    jrec = [np.asarray(y) for y in jrec]
    t_resize, t_blocked = tseem.resize_bilinear_torch, tseem._blocked

    def t_recording(x, out_hw):
        y = t_resize(x, out_hw)
        trec.append(y.numpy())
        return y

    def forced(masks, size):
        t_blocked(masks, size)                  # records the port's own logits
        k = len(trec) - 1
        jm = jrec[k]                            # NHWC [B, h, w, N]
        blocked = 1.0 / (1.0 + np.exp(-jm.astype(np.float64))) < 0.5
        return torch.from_numpy(blocked.transpose(0, 3, 1, 2).reshape(
            jm.shape[0], jm.shape[3], -1).copy())

    targs = _to(list(args), torch.from_numpy)
    tkw = {k: _to(v, torch.from_numpy) for k, v in kw.items()}
    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(tseem, "resize_bilinear_torch", t_recording)
        m.setattr(tseem, "_blocked", forced)
        tforced = thead(*targs, **tkw)
    with torch.no_grad():
        tfree = thead(*targs, **tkw)
    assert len(trec) == len(jrec)
    stats = []
    for a, b in zip(trec, jrec):
        sa = 1 / (1 + np.exp(-a.astype(np.float64))) < 0.5
        sb = 1 / (1 + np.exp(-b.astype(np.float64))) < 0.5
        flips = sa != sb
        if flips.any():
            assert np.abs(b[flips]).max() <= 1e-5 * np.abs(b).max(), "flip off a near-tie"
        stats.append((_rel(a, b), int(flips.sum())))
    return jout, tforced, tfree, stats


def check(jout, tforced, tfree, stats, keys=None):
    assert max((r for r, _ in stats), default=0.0) < 1e-5, stats
    j, t, f = _flat(jout), _flat(tforced), _flat(tfree)
    assert set(j) == set(t) == set(f)
    if keys is not None:
        assert set(keys) <= set(j), set(keys) - set(j)
    for k in j:
        assert t[k].shape == j[k].shape, (k, t[k].shape, j[k].shape)
        if j[k].dtype == bool:
            assert np.array_equal(t[k], j[k]), k
        else:
            assert _rel(t[k], j[k]) < 1e-5, (k, _rel(t[k], j[k]))
    if sum(n for _, n in stats) == 0:
        for k in t:
            assert np.array_equal(f[k], t[k]), k


# ---------------------------------------------------------------------------
# SEEMHead (v0)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def v0():
    thead, jvars = seeded_head(tseem.SEEMHead, 11, **V0_KW)
    return jseem.SEEMHead(**V0_KW), jvars, thead


@pytest.mark.parametrize("grounding,memory", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_seem_v0_matches_jax(monkeypatch, v0, grounding, memory):
    jhead, jvars, thead = v0
    rng, ms, mf, text = feature_inputs(1)
    pts, valid, tags = spatial_prompts(rng)
    kw = dict(spatial_points=pts, spatial_valid=valid, spatial_posneg=tags)
    if grounding:
        kw.update(grounding_tokens=rng.normal(size=(1, G, C)).astype(np.float32),
                  grounding_valid=np.array([[True, True, True, False]]))
    if memory:
        kw["prev_mask"] = rng.normal(size=(1, 1, 16, 24)).astype(np.float32)
    res = run_both(monkeypatch, jhead, jvars, thead, ms, mf, text, SCALE, **kw)
    check(*res, keys=["pred_logits", "pred_masks", "pred_captions", "pred_smasks",
                      "pred_smaskembs", "pred_pspatials", "pred_nspatials", "prev_mask"]
          + (["pred_gmasks", "pred_gtexts"] if grounding else []))


def test_seem_v0_object_queries_isolated(monkeypatch, v0):
    """Object queries attend only each other: their logits and masks equal
    with and without prompts (JAX pins atol 2e-4 / 2e-3; the port holds
    them to JAX at 1e-5 either way), and JAX's prompt-free run matches."""
    jhead, jvars, thead = v0
    rng, ms, mf, text = feature_inputs(2)
    pts, valid, tags = spatial_prompts(rng)
    res = run_both(monkeypatch, jhead, jvars, thead, ms, mf, text, SCALE)
    check(*res, keys=["pred_logits", "pred_masks", "pred_captions"])
    with torch.no_grad():
        plain = thead(*_to([ms, mf, text], torch.from_numpy), SCALE)
        prompted = thead(*_to([ms, mf, text], torch.from_numpy), SCALE,
                         spatial_points=torch.from_numpy(pts),
                         spatial_valid=torch.from_numpy(valid),
                         spatial_posneg=torch.from_numpy(tags))
    for k, atol in (("pred_logits", 2e-4), ("pred_masks", 2e-3)):
        np.testing.assert_allclose(prompted[k].numpy(), plain[k].numpy(), atol=atol)


# ---------------------------------------------------------------------------
# SEEMHeadV1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def v1():
    thead, jvars = seeded_head(tseem.SEEMHeadV1, 12, **V1_KW)
    return jseem.SEEMHeadV1(**V1_KW), jvars, thead


def v1_inputs(seed: int, num_masks: int):
    """Prompts over ``num_masks`` masks; with two, the second is empty (no
    valid point), so its means fill with -1."""
    rng, ms, mf, text = feature_inputs(seed)
    pts, valid, tags = spatial_prompts(rng)
    mids = np.zeros((1, S), np.int32)
    if num_masks == 2:
        mids[0, 6:] = 1                         # slots 6, 7 are invalid
    qidx = rng.integers(0, Q, K * num_masks).astype(np.int32)
    return rng, (ms, mf, text, SCALE, pts, valid, tags, mids, qidx)


@pytest.mark.parametrize("num_masks,memory,grounding", [(1, False, False), (1, True, False),
                                                        (2, False, True), (2, True, False)])
def test_seem_v1_matches_jax(monkeypatch, v1, num_masks, memory, grounding):
    jhead, jvars, thead = v1
    rng, args = v1_inputs(3 + num_masks, num_masks)
    kw = dict(num_masks=num_masks)
    if memory:
        kw.update(prev_mask=rng.normal(size=(1, num_masks, 16, 24)).astype(np.float32),
                  memory_indices=rng.integers(0, num_masks, (2, M)).astype(np.int32))
    if grounding:
        kw.update(grounding_tokens=rng.normal(size=(1, G, C)).astype(np.float32),
                  grounding_valid=np.array([[True, False, True, True]]))
    jout, tforced, tfree, stats = run_both(monkeypatch, jhead, jvars, thead, *args, **kw)
    check(jout, tforced, tfree, stats,
          keys=["pred_logits", "pred_masks", "pred_captions", "pred_smasks", "pred_smaskembs",
                "pred_stexts", "pred_pspatials", "pred_nspatials", "prev_mask"]
          + (["pred_gmasks", "pred_gtexts"] if grounding else []))
    assert tfree["prev_mask"].shape == (1, num_masks, 16, 24)
    if num_masks == 2:
        assert torch.all(tfree["pred_pspatials"][0, 1] == -1)


def test_seem_v1_memory_leaves_object_queries_bit_equal(v1):
    """As the JAX test pins: the previous mask as memory (and the prompts)
    move the interactive output, not the object queries. Two rounds of the
    same shapes with other prompts and another memory give bit-equal
    object logits and masks; with and without memory the row counts differ
    and torch's CPU GEMMs round by shape, so those agree within 1e-5 of
    their scale."""
    _, _, thead = v1
    rng, args = v1_inputs(5, 1)
    targs = _to(list(args), torch.from_numpy)
    other = list(targs)
    pts, valid, tags = spatial_prompts(rng, n_valid=3, n_pos=1)
    other[4:7] = torch.from_numpy(pts), torch.from_numpy(valid), torch.from_numpy(tags)
    mem = torch.zeros((2, M), dtype=torch.int64)
    with torch.no_grad():
        out = thead(*targs)
        out2 = thead(*targs, prev_mask=out["prev_mask"], memory_indices=mem)
        out3 = thead(*other, prev_mask=-out["prev_mask"], memory_indices=mem)
    assert not torch.allclose(out2["prev_mask"], out["prev_mask"])
    assert not torch.allclose(out3["prev_mask"], out2["prev_mask"])
    for k in ("pred_logits", "pred_masks"):
        assert torch.equal(out3[k], out2[k]), k
        assert _rel(out2[k].numpy(), out[k].numpy()) < 1e-5, k


# ---------------------------------------------------------------------------
# SEEMHeadDemo
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def demo():
    thead, jvars = seeded_head(tseem.SEEMHeadDemo, 13, **DEMO_KW)
    return jseem.SEEMHeadDemo(**DEMO_KW), jvars, thead


@pytest.mark.parametrize("kinds", ["spatial", "spatial+grounding+audio", "visual",
                                   "spatial+grounding+visual+audio"])
def test_seem_demo_matches_jax(monkeypatch, demo, kinds):
    """The refimg bundle (from a second image) is compared, then fed back
    as the visual prompt on both sides."""
    jhead, jvars, thead = demo
    rng, ms, mf, text = feature_inputs(6)
    kw = {}
    if "visual" in kinds:
        _, rms, rmf, _ = feature_inputs(7)
        rpts, rvalid, rtags = spatial_prompts(rng, n_valid=5, n_pos=3)
        res = run_both(monkeypatch, jhead, jvars, thead, rms, rmf, text, SCALE,
                       spatial_points=rpts, spatial_valid=rvalid, spatial_posneg=rtags,
                       task="refimg")
        check(*res, keys=["visual_query_pos", "visual_query_neg", "src_visual_queries[2]",
                          "src_visual_maskings"])
        bundle = res[0]
        kw.update(visual_tokens_by_level=[np.asarray(t) for t in bundle["src_visual_queries"]],
                  visual_valid=rvalid,
                  visual_query_pos=np.asarray(bundle["visual_query_pos"]),
                  visual_query_neg=np.asarray(bundle["visual_query_neg"]))
    if "spatial" in kinds:
        pts, valid, tags = spatial_prompts(rng)
        kw.update(spatial_points=pts, spatial_valid=valid, spatial_posneg=tags)
    if "grounding" in kinds:
        kw.update(grounding_tokens=rng.normal(size=(1, G, C)).astype(np.float32),
                  grounding_valid=np.array([[True, True, False, False]]))
    if "audio" in kinds:
        kw.update(audio_tokens=rng.normal(size=(1, A, C)).astype(np.float32),
                  audio_valid=np.array([[True, False, True]]))
    jout, tforced, tfree, stats = run_both(monkeypatch, jhead, jvars, thead, ms, mf, text,
                                           SCALE, task="demo", **kw)
    check(jout, tforced, tfree, stats, keys=["pred_logits", "pred_masks", "pred_maskembs"])
    for prompt in ("spatial", "visual"):
        if prompt in kinds:
            jb, jm = jseem.demo_select_mask(jout, prompt)
            tb, tm = tseem.demo_select_mask(tfree, prompt)
            assert np.array_equal(tb.numpy(), np.asarray(jb))
            assert _rel(tm.numpy(), jm) < 1e-5


# ---------------------------------------------------------------------------
# lazy Flax parameters, point sampling, resizes, host helpers
# ---------------------------------------------------------------------------

def test_seem_from_jax_names_missing_groups():
    """A JAX head traced without spatial prompts has no spatial parameters
    (Flax makes them lazily); carried into the port it must fail naming
    the group. Traced with every prompt kind, its tree has exactly the
    port head's parameters."""
    rng, ms, mf, text = feature_inputs(8)
    pts, valid, tags = spatial_prompts(rng)
    gt = np.zeros((1, G, C), np.float32)
    jhead = jseem.SEEMHead(**V0_KW)
    thead = tseem.SEEMHead(**V0_KW)
    zeros = lambda tree: jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)
    bare = zeros(jax.eval_shape(jhead.init, jax.random.key(0), ms, mf, text, SCALE))
    with pytest.raises(KeyError, match="spatial prompts.*spatial memories"):
        seem_from_jax(bare, thead)
    with pytest.raises(KeyError, match="spatial prompts"):
        seem_from_jax(bare)
    full = zeros(jax.eval_shape(
        jhead.init, jax.random.key(0), ms, mf, text, SCALE, pts, valid, tags, gt,
        np.ones((1, G), bool), np.zeros((1, 1, 16, 24), np.float32)))
    assert set(seem_from_jax(full, thead)) == set(thead.state_dict())
    thead.load_state_dict(seem_from_jax(full, thead))
    demo_j = jseem.SEEMHeadDemo(**DEMO_KW)
    tree = zeros(jax.eval_shape(demo_j.init, jax.random.key(0), ms, mf, text, SCALE, pts,
                                valid, tags))
    demo_t = tseem.SEEMHeadDemo(**DEMO_KW)
    demo_t.load_state_dict(seem_from_jax(tree, demo_t))


def test_point_sample_is_align_corners_true():
    """pixel = p * (size - 1), as the JAX heads sample (seem.py:171-173),
    not ``bilinear_sample``'s half-pixel convention: the corners p = 0 and
    p = 1 land on the first and last pixel centres."""
    rng = np.random.default_rng(9)
    fmap = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    pts = rng.uniform(0, 1, (2, 11, 2)).astype(np.float32)
    pts[:, 0] = 0.0
    pts[:, 1] = 1.0
    got = tseem.point_sample(torch.from_numpy(fmap), torch.from_numpy(pts)).numpy()
    for b in range(2):
        ref = jbilinear_sample(jnp.asarray(fmap[b]), jnp.asarray(pts[b, :, 1] * 6),
                               jnp.asarray(pts[b, :, 0] * 4))
        assert _rel(got[b], ref) < 1e-6
    np.testing.assert_allclose(got[:, 0], fmap[:, 0, 0], rtol=1e-6)
    np.testing.assert_allclose(got[:, 1], fmap[:, -1, -1], rtol=1e-6)


@pytest.mark.parametrize("hw,out_hw", [((7, 9), (16, 20)), ((16, 24), (4, 6)),
                                       ((16, 24), (5, 7))])
def test_resizes_match_jax(hw, out_hw):
    """``resize_bilinear_torch`` (no antialias) and ``resize_bilinear``
    (jax.image.resize's antialiased triangle) each equal their JAX
    counterpart on an upscale and on downscales, and differ from each
    other on a downscale."""
    x = np.random.default_rng(10).normal(size=(2, *hw, 3)).astype(np.float32)
    noaa = tlayers.resize_bilinear_torch(torch.from_numpy(x), out_hw).numpy()
    aa = tlayers.resize_bilinear(torch.from_numpy(x), out_hw).numpy()
    assert _rel(noaa, jlayers.resize_bilinear_torch(jnp.asarray(x), out_hw)) < 1e-5
    assert _rel(aa, jax.image.resize(jnp.asarray(x), (2, *out_hw, 3), "bilinear")) < 1e-5
    ref = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=out_hw,
                        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    assert torch.equal(torch.from_numpy(noaa), ref)
    if out_hw[0] < hw[0]:
        assert _rel(noaa, aa) > 1e-3


def test_host_helpers_match_jax():
    """``sample_mask_points``, ``points_from_masks`` and
    ``prepare_next_spatial_mask`` (both modes, both click signs, the early
    stop) give the same arrays and draws as JAX from the same generators."""
    rng = np.random.default_rng(11)
    for mask in (rng.uniform(size=(10, 20)) < 0.05, rng.uniform(size=(10, 20)) < 0.5,
                 np.zeros((4, 4), bool)):
        got = tseem.sample_mask_points(mask, 8, np.random.default_rng(1))
        ref = jseem.sample_mask_points(mask, 8, np.random.default_rng(1))
        for a, b in zip(got, ref):
            assert np.array_equal(a, b)
    for budget in (4, 64):
        pos, neg = rng.uniform(size=(12, 16)) < 0.1, rng.uniform(size=(12, 16)) < 0.05
        got = tseem.points_from_masks(pos, neg, budget, np.random.default_rng(2))
        ref = jseem.points_from_masks(pos, neg, budget, np.random.default_rng(2))
        for a, b in zip(got, ref):
            assert np.array_equal(a, b)
    gt = np.zeros((20, 24), bool)
    gt[4:16, 5:19] = True
    cases = [(np.zeros_like(gt), gt), (np.ones_like(gt), gt), (gt, gt),
             (rng.uniform(size=gt.shape) < 0.4, gt)]
    for pred, g in cases:
        pos = np.zeros_like(g)
        pos[10, 10] = True
        for mode in ("best", "best_random"):
            got = tseem.prepare_next_spatial_mask(pred, g, pos, np.zeros_like(g),
                                                  rng=np.random.default_rng(3), mode=mode)
            ref = jseem.prepare_next_spatial_mask(pred, g, pos, np.zeros_like(g),
                                                  rng=np.random.default_rng(3), mode=mode)
            assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
            assert got[2] == ref[2]
