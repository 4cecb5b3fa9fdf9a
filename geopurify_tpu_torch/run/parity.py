"""Checkpoint parity dump and compare (``geopurify-torch-parity``).

Port of geopurify_tpu/run/parity.py's dump / compare modes: convert a
released-layout X-Decoder checkpoint (``xdecoder_focall_last.pt``,
``utils/convert_xdecoder.py``), embed the class names through the converted
language tower, run ``XDecoderSegModel`` on one image, and write its
outputs (``pred_logits``, ``pred_masks``, ``mask_embed``, ``text``, f32) to
an ``.npz``, or compare them with another run's dump: the same printed
lines, the same 5e-2 relative limit and the same exit status as the JAX
tool, whose dumps it reads and which reads its dumps.

What differs from the JAX tool: ``run_ours`` takes the config (default
``GeoPurifyConfig()``, which the JAX one always uses) and converts with its
X-Decoder depths; ``main`` runs ``GeoPurifyConfig()`` (the released
FocalNet-L X-Decoder, bf16), ``--dtype float32`` runs its X-Decoder in
f32, and ``--device`` picks the card (default) or the CPU. The
``--torch-oracle`` mode (with ``--stages`` / ``--report``) runs the JAX
package's harness against the mounted reference torch code; it is not
ported, and those flags raise.

Usage:
  python -m geopurify_tpu_torch.run.parity --ckpt xdecoder_focall_last.pt \\
      [--image img.npy] [--classes wall,floor,...] [--dump ours.npz] [--compare theirs.npz] \\
      [--dtype float32] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from geopurify_tpu_torch import resolve_device
from geopurify_tpu_torch.config import GeoPurifyConfig

log = logging.getLogger("geopurify.parity")


# geopurify_tpu/run/parity.py:36
@torch.no_grad()
def run_ours(ckpt_path: str, image: np.ndarray, class_names: Sequence[str],
             cfg: Optional[GeoPurifyConfig] = None, device="cuda") -> Dict[str, np.ndarray]:
    """The converted checkpoint's outputs on ``image`` (H x W x 3, 0..255) as
    f32 numpy arrays: ``pred_logits``, ``pred_masks``, ``mask_embed`` and the
    class-name embeddings ``text``."""
    from geopurify_tpu_torch.models.lang import (
        LanguageEncoder,
        build_tokenizer,
        embed_class_names,
    )
    from geopurify_tpu_torch.models.xdecoder import XDecoderSegModel
    from geopurify_tpu_torch.utils.checkpoint import load_torch_state_dict
    from geopurify_tpu_torch.utils.convert_xdecoder import convert_xdecoder_checkpoint

    cfg = cfg or GeoPurifyConfig()
    dev = resolve_device(device)
    x, tc = cfg.xdecoder, cfg.text
    conv = convert_xdecoder_checkpoint(load_torch_state_dict(ckpt_path),
                                       depths=tuple(x.backbone.depths),
                                       enc_layers=x.enc_layers, dec_layers=x.dec_layers)
    model = XDecoderSegModel(x)
    model.load_state_dict(conv["xdecoder"])
    model.to(dev).eval()
    lang = LanguageEncoder(tc.vocab_size, tc.width, tc.layers, tc.heads,
                           tc.context_length, tc.dim_proj)
    lang.load_state_dict(conv["lang"])
    lang.to(dev).eval()
    tk = build_tokenizer(tc.tokenizer_vocab, tc.context_length, tc.vocab_size)
    text = torch.from_numpy(embed_class_names(
        lang, tk, list(class_names), use_templates=tc.prompt_eng,
        template=tc.prompt_template, device=dev)).to(dev)
    images = torch.from_numpy(np.asarray(image, np.float32)).to(dev)[None]
    out = model(images, text, conv["logit_scale"])
    return {
        "pred_logits": out["pred_logits"].float().cpu().numpy(),
        "pred_masks": out["pred_masks"].float().cpu().numpy(),
        "mask_embed": out["mask_embed"].float().cpu().numpy(),
        "text": text.float().cpu().numpy(),
    }


# geopurify_tpu/run/parity.py:78
def compare(ours: dict, theirs: dict) -> int:
    """Per key shared by both: max / mean |difference| and the max
    difference relative to max |theirs|; 0 when the worst is below 5e-2."""
    worst = 0.0
    for k in sorted(set(ours) & set(theirs)):
        a, b = np.asarray(ours[k]), np.asarray(theirs[k])
        if a.shape != b.shape:
            print(f"{k}: SHAPE MISMATCH {a.shape} vs {b.shape}")
            worst = np.inf
            continue
        d = np.abs(a - b)
        rel = d.max() / (np.abs(b).max() + 1e-9)
        print(f"{k}: max|d|={d.max():.3e} mean|d|={d.mean():.3e} rel={rel:.3e}")
        worst = max(worst, rel)
    status = 0 if worst < 5e-2 else 1
    print(f"parity: {'OK' if status == 0 else 'FAIL'} (worst rel {worst:.3e})")
    return status


# geopurify_tpu/run/parity.py:173
def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--torch-oracle", default=None, choices=["small", "full"],
                        help="not ported: needs the reference torch code")
    parser.add_argument("--stages", default=None, help="not ported (--torch-oracle)")
    parser.add_argument("--report", default=None, help="not ported (--torch-oracle)")
    parser.add_argument("--image", default=None, help=".npy HxWx3 float 0..255")
    parser.add_argument("--classes", default="wall,floor,chair,table,door")
    parser.add_argument("--dump", default=None)
    parser.add_argument("--compare", default=None, help="another run's .npz dump")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                        help="the X-Decoder's compute dtype (default: the config's, bfloat16)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.torch_oracle or args.stages or args.report:
        raise NotImplementedError(
            "--torch-oracle / --stages / --report run the JAX package's harness against "
            "the reference torch code (geopurify_tpu/parity), which the port does not carry")
    if not args.ckpt:
        parser.error("--ckpt is required")

    if args.image:
        image = np.load(args.image).astype(np.float32)
    else:
        rng = np.random.default_rng(0)
        image = rng.uniform(0, 255, (484, 648, 3)).astype(np.float32)

    cfg = GeoPurifyConfig()
    if args.dtype:
        cfg = dataclasses.replace(cfg, xdecoder=dataclasses.replace(cfg.xdecoder,
                                                                    dtype=args.dtype))
    acts = run_ours(args.ckpt, image, args.classes.split(","), cfg=cfg, device=args.device)
    if args.dump:
        np.savez_compressed(args.dump, **acts)
        log.info("dumped %d activations to %s", len(acts), args.dump)
    if args.compare:
        theirs = dict(np.load(args.compare))
        sys.exit(compare(acts, theirs))


if __name__ == "__main__":
    main()
