"""The language tower's port held against the JAX package on the CPU: the
hash tokenizer, a tiny LanguageEncoder with the weights carried across by
``lang_from_jax``, and the class-name embeddings built on them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.models.lang import HashTokenizer as JTok
from geopurify_tpu.models.lang import LanguageEncoder as JLang
from geopurify_tpu.models.lang import embed_class_names as j_embed
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
    with pytest.raises(NotImplementedError):
        build_tokenizer("/no/such/bpe_simple_vocab_16e6.txt.gz")


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
