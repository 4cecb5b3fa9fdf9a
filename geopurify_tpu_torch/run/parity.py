"""Checkpoint parity dump and compare, and the reference-oracle harness
(``geopurify-torch-parity``).

Port of geopurify_tpu/run/parity.py, in two modes.

Dump / compare: convert a released-layout X-Decoder checkpoint
(``xdecoder_focall_last.pt``, ``utils/convert_xdecoder.py``), embed the
class names through the converted language tower, run ``XDecoderSegModel``
on one image, and write its outputs (``pred_logits``, ``pred_masks``,
``mask_embed``, ``text``, f32) to an ``.npz``, or compare them with
another run's dump: the same printed lines, the same 5e-2 relative limit
and the same exit status as the JAX tool, whose dumps it reads and which
reads its dumps. ``run_ours`` takes the config (default
``GeoPurifyConfig()``, which the JAX one always uses) and converts with its
X-Decoder depths; ``main`` runs ``GeoPurifyConfig()`` (the released
FocalNet-L X-Decoder, bf16), ``--dtype float32`` runs its X-Decoder in
f32.

``--torch-oracle small|full`` (with ``--stages`` / ``--report``): stagewise
activation parity against the reference torch code with seeded random
weights, no checkpoint needed (``parity/compare.py``). The reference runs
on the CPU under the import shims; the port's side of each stage runs on
``--device``, in f32 with TF32 off on the card (the Stage-2 stage's
smoothing there through kernel K1). The verdict is the JAX tool's: rel <
1e-4 for every plain row, the calibrated rows of the composed Stage-2
stage on their own limits, exit status 1 when any row fails. Every stage
but ``sonata`` (the naive numpy Sonata) needs the reference tree at
``parity.shims.reference_root()``; without it the run stops before any
stage, non-zero, naming the path.

``--device`` picks the card (default) or the CPU for both modes.

Usage:
  python -m geopurify_tpu_torch.run.parity --ckpt xdecoder_focall_last.pt \\
      [--image img.npy] [--classes wall,floor,...] [--dump ours.npz] [--compare theirs.npz] \\
      [--dtype float32] [--device cpu]
  python -m geopurify_tpu_torch.run.parity --torch-oracle small [--stages sonata,stage2] \\
      [--report report.md] [--device cpu]
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


# geopurify_tpu/run/parity.py:95
def run_torch_oracle(size: str, stages=None, report_path=None, device="cuda") -> int:
    """Stagewise activation parity against the mounted reference torch code
    with seeded random weights (parity/compare.run_all), the port's side on
    ``device``; prints the table, writes the markdown ``report_path``, and
    returns the exit status: 0 when every row passes."""
    from geopurify_tpu_torch.parity import compare, shims

    dev = resolve_device(device)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if dev.type == "cuda":
        # activation parity is a layout / semantics check: exact f32 on the card
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        rows = compare.run_all(size, stages, device=dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    tol = 1e-4
    # composed-Stage-2 rows past the sharpen-x20 softmax carry its measured
    # amplification of honest fp32 rounding (mutation-calibrated: honest
    # noise rel ~1e-2, the known mutants >= 3.3e-2); pred_agree / knn_sets
    # are exact-count rows whose second element must be 0
    special_tol = {
        "stage2/features": 2e-2, "stage2/logits": 2e-2,
        "stage2/pred_agree": 1e-12, "stage2/knn_sets": 1e-12,
    }
    # histogram rows are exact-count diffs bounded by the sub-noise-margin
    # row count (pred_agree's first element): a real regression moves them
    # far beyond it
    n_tie = rows.get("stage2/pred_agree", (0.0, 0.0))[0]
    for h in ("stage2/hist_I", "stage2/hist_U", "stage2/hist_T"):
        special_tol[h] = None      # judged on max|d| vs n_tie below
    lines = [f"{'stage':40s} {'max|d|':>12s} {'rel':>12s}  verdict"]
    worst = 0.0
    any_fail = False
    for name, (mx, rel) in rows.items():
        t = special_tol.get(name, tol)
        if name not in special_tol:
            worst = max(worst, rel)
        ok = (mx <= n_tie) if t is None else (rel <= t)
        any_fail = any_fail or not ok
        lines.append(f"{name:40s} {mx:12.3e} {rel:12.3e}  {'OK' if ok else 'FAIL'}")
    lines.append(f"worst rel: {worst:.3e}  (target < {tol:g} f32)")
    text = "\n".join(lines)
    print(text)
    if report_path:
        with open(report_path, "w") as f:
            f.write(
                f"# Torch-oracle activation parity ({size})\n\n"
                f"Reference modules (mounted at {shims.geopurify_root()}, seeded random\n"
                f"weights, torch {torch.__version__} on the CPU) vs the port\n"
                f"(geopurify_tpu_torch, on {dev}) through utils/convert_xdecoder.py.\n"
                "rel = max|a-b| / max|b|.\n\n"
                "```\n" + text + "\n```\n\n"
                "## Known amplifier: the 0.5 attention-mask binarization\n\n"
                "At full size the query decoder thresholds ~200x19602\n"
                "sigmoid(mask) values at 0.5 every round (xdecoder.py:459-463).\n"
                "With seeded RANDOM weights, borderline pixels flip on f32\n"
                "reduction-order noise (~1e-5 for 19602-wide contractions), and\n"
                "each flip perturbs downstream rounds discretely. The head stages\n"
                "above the 1e-4 bar at FULL size are this amplification, not\n"
                "layout errors: every stage is exact at small size, and the\n"
                "mask / embed paths track to 1e-6 before binarization feedback\n"
                "(parity/compare.parity_head_fullsize forces the port's head onto\n"
                "the reference's binarized masks).\n"
            )
        log.info("report written to %s", report_path)
    # any_fail covers the special_tol rows (composed Stage-2), which `worst`
    # deliberately excludes
    return 0 if (worst < tol and not any_fail) else 1


# geopurify_tpu/run/parity.py:163
def main(argv=None):
    from geopurify_tpu_torch.parity.compare import ALL_STAGES

    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--torch-oracle", default=None, choices=["small", "full"],
                        help="stagewise parity vs the mounted reference torch "
                             "code with seeded random weights (no ckpt needed)")
    parser.add_argument("--stages", default=None,
                        help="comma list of --torch-oracle stages: " + ",".join(ALL_STAGES))
    parser.add_argument("--report", default=None,
                        help="write the --torch-oracle markdown report here")
    parser.add_argument("--image", default=None, help=".npy HxWx3 float 0..255")
    parser.add_argument("--classes", default="wall,floor,chair,table,door")
    parser.add_argument("--dump", default=None)
    parser.add_argument("--compare", default=None, help="another run's .npz dump")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                        help="the X-Decoder's compute dtype (default: the config's, bfloat16)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.torch_oracle:
        stages = args.stages.split(",") if args.stages else None
        unknown = sorted(set(stages or ()) - set(ALL_STAGES))
        if unknown:
            parser.error(f"unknown --stages {','.join(unknown)}; "
                         f"choose from {','.join(ALL_STAGES)}")
        try:
            status = run_torch_oracle(args.torch_oracle, stages, args.report, args.device)
        except FileNotFoundError as e:
            print(f"geopurify-torch-parity: {e}", file=sys.stderr)
            sys.exit(1)
        sys.exit(status)
    if args.stages or args.report:
        parser.error("--stages / --report need --torch-oracle")
    if not args.ckpt:
        parser.error("--ckpt is required unless --torch-oracle is given")

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
