"""The 2D trainer's joint-zip loss held against the JAX package on the CPU,
gradients included, as ``tests/test_torch_port_train2d_steps.py`` holds
the seg losses: a seg batch and a VLP batch through one set of seeded
weights (``train2d_from_jax``), the class text from the shared tower, the
round-0 pre-threshold logits of both forwards first, then both sides on
the port's binary attention masks. The losses within rel 1e-5; every
gradient leaf within 1e-4 of its norm."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from geopurify_tpu_torch.models.lang import PROMPT_TEMPLATES, HashTokenizer
from geopurify_tpu_torch.run import train2d as ttrain
from tests.test_torch_port_train2d_steps import (
    CAP_LEN,
    LOGIT_SCALE,
    NUM_POINTS,
    VOCAB,
    build_pair,
    check_losses_and_grads,
    check_round0,
    jax_class_text,
    jax_points,
    jax_seg_losses,
    port_masks,
    seg_batch,
)
from tests.test_torch_port_train2d_vlp import jax_vlp_losses, vlp_batch, vlp_forcing


def test_joint_zip_loss_matches_jax():
    """``make_joint_zip_step``'s body: a seg batch and a VLP batch through the
    shared trunk and tower, the class text from the tower, one summed loss."""
    jcfg, jtree, params = build_pair(14, caption_len=CAP_LEN, lang=True)
    sb, vb = seg_batch(15), vlp_batch(16)
    tk = HashTokenizer(vocab_size=VOCAB, context_length=CAP_LEN)
    class_ids = tk([PROMPT_TEMPLATES[0].format(n) for n in ("wall", "floor", "chair", "desk")])[0]
    text = ttrain.class_text(params, torch.from_numpy(class_ids)).detach()
    jtext = jax_class_text(jtree, jnp.asarray(class_ids))
    seg_forced, logits0 = port_masks(params, sb[0], text)
    check_round0(jcfg, jtree, sb[0], np.asarray(jtext), logits0)
    vlp_forced = vlp_forcing(jcfg, jtree, params, vb, text, jtext)
    rng, points = jax_points(17)
    jseg = [jnp.asarray(m.numpy()) for m in seg_forced]
    jvlp = [jnp.asarray(m.numpy()) for m in vlp_forced]

    def jloss(p):
        """train2d.py:411-446."""
        text = jax_class_text(p, jnp.asarray(class_ids))
        _, seg = jax_seg_losses(jcfg, p, [jnp.asarray(a) for a in sb], text, rng, jseg)
        _, vlp = jax_vlp_losses(jcfg, p, [jnp.asarray(a) for a in vb], text, jvlp)
        total = seg["loss"] + 2.0 * vlp["loss_captioning"] + 2.0 * vlp["loss_retrieval"]
        return total, {**{k: v for k, v in seg.items() if k != "loss"}, "loss": total,
                       "loss_captioning": vlp["loss_captioning"],
                       "loss_retrieval": vlp["loss_retrieval"]}

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jtree)
    total, tlosses = ttrain.joint_zip_losses(
        params, [torch.from_numpy(a) for a in sb], [torch.from_numpy(a) for a in vb],
        torch.from_numpy(class_ids), LOGIT_SCALE, NUM_POINTS, points=points,
        seg_kw=dict(attn_mask_override=seg_forced), vlp_kw=dict(attn_mask_override=vlp_forced))
    total.backward()
    check_losses_and_grads(params, tlosses, jlosses, jgrads)
    assert params.no_object.grad.abs().max() > 0
