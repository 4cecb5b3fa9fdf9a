"""The language tower's port held against the JAX package on the CPU: the
hash tokenizer and CLIP's BPE tokenizer (a toy merges file and one learnt
from every preset's class prompts; hypothesis-drawn unicode), a tiny
LanguageEncoder with the weights carried across by ``lang_from_jax``, and
the class-name embeddings built on them."""

import gzip
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from geopurify_tpu.config import load_config as j_load_config
from geopurify_tpu.models import lang as jlang
from geopurify_tpu.models.lang import HashTokenizer as JTok
from geopurify_tpu.models.lang import LanguageEncoder as JLang
from geopurify_tpu.models.lang import embed_class_names as j_embed
from geopurify_tpu_torch.models import lang as tlang
from geopurify_tpu_torch.models.lang import HashTokenizer as TTok
from geopurify_tpu_torch.models.lang import LanguageEncoder as TLang
from geopurify_tpu_torch.models.lang import build_tokenizer, embed_class_names, init_language_
from geopurify_tpu_torch.utils.from_jax import lang_from_jax

TEXTS = ["a chair in a scene.", "  the  Bathtub &amp; sink ", "background",
         "a photo of a shower curtain"]
# the tiny preset's tower at the hash tokenizer's full vocabulary
CFG = dict(vocab_size=49408, width=32, layers=2, heads=2, context_length=16, dim_proj=16)


def test_hash_tokenizer_matches_jax():
    for L in (16, 77):
        ids_j, mask_j = JTok(context_length=L)(TEXTS)
        ids_t, mask_t = TTok(context_length=L)(TEXTS)
        np.testing.assert_array_equal(ids_t, ids_j)
        np.testing.assert_array_equal(mask_t, mask_j)


def test_build_tokenizer_raises_on_a_missing_vocab(tmp_path):
    """A misspelt ``text.tokenizer_vocab``: the JAX package falls back to
    the hash tokenizer without a word (ROADMAP Queue 3); the port raises."""
    missing = str(tmp_path / "bpe_simple_vocab_16e6.txt.gz")
    assert isinstance(jlang.build_tokenizer(missing), jlang.HashTokenizer)
    with pytest.raises(FileNotFoundError, match="tokenizer_vocab"):
        build_tokenizer(missing)
    assert isinstance(build_tokenizer(None, 16, vocab_size=512), TTok)


# ---------------------------------------------------------------------------
# CLIP's BPE tokenizer
# ---------------------------------------------------------------------------

PRESETS = ("scannet", "scannet200", "matterport", "matterport40", "matterport80",
           "matterport160", "tiny")
# tests/test_lang_tokenizer.py:20
TOY_MERGES = "#version: 0.2\nh e\nl o</w>\nhe l\n"


def _write_merges(path, text):
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write(text)
    return str(path)


def _class_prompts():
    """Every string ``embed_class_names`` tokenizes, at every preset, under
    every prompt template."""
    texts = []
    for preset in PRESETS:
        cfg = j_load_config(preset)
        for cls in jlang.class_name_prompts(list(cfg.data.all_label),
                                            cfg.text.prompt_template):
            clean = cls.replace("-other", "").replace("-merged", "").replace("-stuff", "")
            texts += [t.format(clean) for t in jlang.PROMPT_TEMPLATES]
    return texts


def _learn_merges(texts, n_merges):
    """A merges file learnt from ``texts`` by plain BPE (most frequent
    adjacent pair first, over byte-encoded words ending in ``</w>``)."""
    enc = jlang._bytes_to_unicode()
    words = Counter()
    for t in texts:
        for w in t.lower().split():
            sym = [enc[b] for b in w.encode("utf-8")]
            words[tuple(sym[:-1] + [sym[-1] + "</w>"])] += 1
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for w, n in words.items():
            for a, b in zip(w, w[1:]):
                pairs[a, b] += n
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append(f"{a} {b}")
        new = Counter()
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new[tuple(out)] += n
        words = new
    return "#version: 0.2\n" + "\n".join(merges) + "\n"


@pytest.fixture(scope="module")
def bpe_pair(tmp_path_factory):
    """(JAX, port) tokenizers over the toy merges file and over 200 merges
    learnt from the presets' class prompts, at context 16."""
    d = tmp_path_factory.mktemp("bpe")
    texts = _class_prompts()
    files = {"toy": _write_merges(d / "toy.txt.gz", TOY_MERGES),
             "classes": _write_merges(d / "classes.txt.gz", _learn_merges(texts[::7], 200))}
    return texts, {k: (jlang.ClipBPETokenizer(p, 16), build_tokenizer(p, 16))
                   for k, p in files.items()}


@pytest.mark.parametrize("merges", ["toy", "classes"])
def test_bpe_tokenizer_matches_jax_on_every_class_prompt(bpe_pair, merges):
    texts, pairs = bpe_pair
    jt, tt = pairs[merges]
    assert isinstance(tt, tlang.ClipBPETokenizer)
    assert tt.vocab_size == jt.vocab_size == (517 if merges == "toy" else 714)
    assert (tt.sot, tt.eot) == (jt.sot, jt.eot) and tt.encoder == jt.encoder
    ids_t, mask_t = tt(texts)
    ids_j, mask_j = jt(texts)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(mask_t, mask_j)
    if merges == "classes":      # most words become merged symbols
        body = ids_t[(mask_t == 1) & (ids_t != tt.sot) & (ids_t != tt.eot)]
        assert (body >= 512).mean() > 0.5, (body >= 512).mean()
    for row in ids_t[::997]:
        assert tt.decode(row) == jt.decode(row)
    assert tt.encode("hello") == jt.encode("hello")


# numerals beyond \d (Nl: roman numerals; No: superscripts, fractions,
# circled digits), letters of several scripts, and HTML entities that the
# cleanup unescapes twice
_PIECES = st.one_of(
    st.text(st.characters(codec="utf-8", exclude_categories=("Cn", "Cs")), max_size=12),
    st.sampled_from(["Ⅻ", "ⅷ", "²", "¾", "①", "٣", "߂", "𝟗", "ǅ", "ß", "İ", "ﬁ",
                     "\u0345", "中文", "Ωμέγα", "naïve", "&amp;", "&amp;lt;", "&#39;s",
                     "&quot;", "&nbsp;", "'ll", "'S", " ", "\t\n", "0", "42"]),
)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(pieces=st.lists(_PIECES, max_size=8), context=st.sampled_from([8, 16, 77]))
def test_bpe_tokenizer_matches_jax_on_unicode(bpe_pair, pieces, context):
    """Drawn from every assigned code point (category Cn is left out: the
    two packages' Unicode databases differ in version, and a code point
    unassigned in Python's is no letter here and may be one for ``regex``).
    Short contexts truncate past ``context_length - 2`` ids."""
    text = "".join(pieces)
    for jt, tt in bpe_pair[1].values():
        assert tt.encode(text) == jt.encode(text)
        jt.context_length = tt.context_length = context
        try:
            ids_t, mask_t = tt([text])
            ids_j, mask_j = jt([text])
        finally:
            jt.context_length = tt.context_length = 16
        np.testing.assert_array_equal(ids_t, ids_j)
        np.testing.assert_array_equal(mask_t, mask_j)
        assert tt.decode(ids_t[0]) == jt.decode(ids_j[0])


@pytest.fixture(scope="module")
def pair():
    jl = JLang(**CFG)
    ids, _ = JTok(context_length=16)(TEXTS)
    variables = jl.init(jax.random.key(1), jnp.asarray(ids))
    tl = TLang(**CFG)
    sd = lang_from_jax(variables)
    assert set(sd) == set(tl.state_dict())       # no missing, no unexpected keys
    tl.load_state_dict(sd)
    return jl, variables, tl


def test_language_encoder_matches_jax(pair):
    jl, variables, tl = pair
    ids, _ = JTok(context_length=16)(TEXTS)
    ref = np.asarray(jl.apply(variables, jnp.asarray(ids)))
    with torch.no_grad():
        got = tl(torch.from_numpy(ids)).numpy()
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 1e-5, rel
    assert tl.scale().item() == pytest.approx(float(jnp.exp(variables["params"]["logit_scale"])))


@pytest.mark.parametrize("use_templates", [False, True])
def test_embed_class_names_matches_jax(pair, use_templates):
    jl, variables, tl = pair
    names = ["wall", "floor", "chair-other"]
    ref = j_embed(lambda v, i: jl.apply(v, i), variables, JTok(context_length=16), names,
                  use_templates=use_templates, template="a {} in a scene")
    got = embed_class_names(tl, TTok(context_length=16), names,
                            use_templates=use_templates, template="a {} in a scene")
    assert got.shape == ref.shape == (4, 16)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_tokenizer_fits_a_small_vocab():
    """The tiny preset's tower has 512 ids. The JAX tokenizer numbers SOT /
    EOT from 49408 regardless, its embedding gather fills those rows with
    NaN and every text embedding of the JAX ``tiny`` pipeline is NaN
    (ROADMAP Queue 3); the port sizes the tokenizer to the tower."""
    cfg = dict(CFG, vocab_size=512)
    ids_j, _ = JTok(context_length=16)(TEXTS)
    jl = JLang(**cfg)
    out = jl.apply(jl.init(jax.random.key(0), jnp.asarray(ids_j)), jnp.asarray(ids_j))
    assert np.isnan(np.asarray(out)).all()
    tk = build_tokenizer(None, 16, vocab_size=512)
    ids, _ = tk(TEXTS)
    assert ids.max() == 511 and ids[0, 0] == 510
    tl = TLang(**cfg)
    tl.load_state_dict(lang_from_jax(jl.init(jax.random.key(0), jnp.asarray(ids))))
    with torch.no_grad():
        assert torch.isfinite(tl(torch.from_numpy(ids))).all()


def test_init_language_matches_the_jax_distributions():
    cfg = dict(CFG, vocab_size=4096, width=64)
    ids, _ = JTok(context_length=16)(TEXTS)
    jv = lang_from_jax(JLang(**cfg).init(jax.random.key(2), jnp.asarray(ids % 4096)))
    tl = init_language_(TLang(**cfg), torch.Generator().manual_seed(2))
    assert set(jv) == set(tl.state_dict())
    for name, p in tl.state_dict().items():
        j = jv[name]
        if j.numel() == 1 or float(j.std()) == 0:
            assert torch.equal(p, j), name
        else:
            assert 0.9 < float(p.std() / j.std()) < 1.1, name
