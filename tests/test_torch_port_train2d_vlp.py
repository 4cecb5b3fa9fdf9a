"""The 2D trainer's VLP loss held against the JAX package on the CPU,
gradients included, as ``tests/test_torch_port_train2d_steps.py`` holds the
seg losses (``tests/test_torch_port_train2d_zip.py`` the joint-zip loss):
one set of seeded weights through ``train2d_from_jax``, the JAX loss
composed as ``run/train2d.py``'s step body composes it, the round-0
pre-threshold logits first, then both sides on the port's binary attention
masks (the caption rows attend everywhere). The losses within rel 1e-5;
every gradient leaf (the caption slots, the language tower with its token
table and logit scale) within 1e-4 of its norm."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from geopurify_tpu.models import criterion as jcrit
from geopurify_tpu_torch.run import train2d as ttrain
from tests.test_torch_port_train2d_steps import (
    CAP_LEN,
    LOGIT_SCALE,
    VOCAB,
    _rel,
    build_pair,
    check_losses_and_grads,
    check_round0,
    jax_head_out,
    jax_lang,
    port_masks,
    unit_text,
)

HW = (64, 96)


def vlp_batch(seed: int, B: int = 2):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (B, *HW, 3)).astype(np.float32)
    ids, mask = ttrain.synthetic_captions(rng, B, CAP_LEN, VOCAB)
    return [images, ids.numpy(), mask.numpy()]


def jax_vlp_losses(jcfg, params, batch, text, forced):
    """The loss_fn body of ``make_vlp_step`` (train2d.py:125-144)."""
    images, cap_ids, cap_mask = batch
    lang = jax_lang()
    tok_emb, pooled = lang.apply({"params": params["lang"]}, cap_ids, method=lang.encode_tokens)
    out = jax_head_out(jcfg, params["model"], images, text, forced, caption_tokens=tok_emb)
    table = params["lang"]["lang_encoder"]["token_embedding"]["embedding"]
    l_cap = jcrit.captioning_loss(out["pred_captionings"], table, cap_ids, cap_mask)
    l_ret = jcrit.image_text_contrastive_loss(out["pred_captions"][:, -1], pooled,
                                              params["lang"]["logit_scale"])
    total = 2.0 * l_cap + 2.0 * l_ret
    return total, {"loss": total, "loss_captioning": l_cap, "loss_retrieval": l_ret}


def vlp_forcing(jcfg, jtree, params, batch, text, jtext):
    """The port's masks for a captioning forward, after its round-0 logits
    are held against JAX's."""
    with torch.no_grad():
        tok, _ = params.lang.encode_tokens(torch.from_numpy(batch[1]))
    forced, logits0 = port_masks(params, batch[0], text, caption_tokens=tok)
    lang = jax_lang()
    jtok, _ = lang.apply({"params": jtree["lang"]}, jnp.asarray(batch[1]),
                         method=lang.encode_tokens)
    assert _rel(tok.numpy(), jtok) < 1e-5
    check_round0(jcfg, jtree, batch[0], np.asarray(jtext), logits0, caption_tokens=jtok)
    return forced


def test_vlp_loss_matches_jax():
    """``make_vlp_step``'s body: captioning CE + image-text contrastive over
    the caption slots, the tower trained with the decoder."""
    jcfg, jtree, params = build_pair(11, caption_len=CAP_LEN, lang=True, no_object=False)
    batch = vlp_batch(12)
    text = unit_text(13)
    forced = vlp_forcing(jcfg, jtree, params, batch, torch.from_numpy(text), text)
    jforced = [jnp.asarray(m.numpy()) for m in forced]
    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_vlp_losses(jcfg, p, [jnp.asarray(a) for a in batch], jnp.asarray(text),
                                 jforced), has_aux=True))(jtree)
    total, tlosses = ttrain.vlp_losses(params, *(torch.from_numpy(a) for a in batch),
                                       torch.from_numpy(text), LOGIT_SCALE,
                                       attn_mask_override=forced)
    total.backward()
    check_losses_and_grads(params, tlosses, jlosses, jgrads)
    assert float(tlosses["loss_retrieval"].detach()) > 0
    for p in (params.lang.logit_scale, params.lang.lang_encoder.token_embedding.embedding,
              params.model.predictor.caping_embed, params.model.predictor.pos_embed_caping):
        assert p.grad.abs().max() > 0
