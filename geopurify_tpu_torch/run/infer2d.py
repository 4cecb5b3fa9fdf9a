"""2D open-vocabulary inference on single images — the X-Decoder task family.

Port of geopurify_tpu/run/infer2d.py: one CLI with a ``--task`` switch
(semseg, panoseg, instseg, refseg, captioning, retrieval) and a batch
semseg evaluation (``--eval-list``). The per-task query-prediction math
lives in ``models/inference2d.py``, drawing in ``utils/visualizer2d.py``.
It is also the qualitative check of a converted teacher checkpoint
(``xdecoder.ckpt``). Runs on the card unless ``--device cpu``.

Usage:
  python -m geopurify_tpu_torch.run.infer2d --image photo.jpg \
      --classes "wall,floor,chair" [--task semseg] [xdecoder.ckpt=...]
  ... --task panoseg --things "chair"         # thing/stuff split
  ... --task instseg --topk 5
  ... --task refseg --phrases "the red chair"
  ... --task captioning [--caption-steps 20]
  ... --task retrieval --gallery imgs_dir --phrases "a chair"
  ... --eval-list pairs.txt --label-map 5:0,7:1 --classes "a,b"
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os

import numpy as np
import torch

log = logging.getLogger("geopurify.infer2d")


# geopurify_tpu/run/infer2d.py:32
def semseg_from_outputs(pred_logits: torch.Tensor, pred_masks: torch.Tensor, out_hw):
    """Per-pixel class map from the FULL [Q, n_cls+1] logits and the mask
    logits: softmax over every column, the background dropped after it,
    sigmoid masks, bicubic-antialias resize to ``out_hw``, argmax."""
    from geopurify_tpu_torch.models.inference2d import semantic_inference
    from geopurify_tpu_torch.models.layers import resize_bicubic_antialias

    sem = semantic_inference(pred_logits, pred_masks, keep_sem_bgd=False)
    sem = resize_bicubic_antialias(sem[None], tuple(out_hw))[0]      # [H, W, n_cls]
    return torch.argmax(sem, -1)


# geopurify_tpu/run/infer2d.py:50
def _load_work_image(path, mask_shape) -> np.ndarray:
    """Load and nearest-resize to the model's working resolution (the
    overlay is emitted at working resolution)."""
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB")).astype(np.float32)
    H, W = img.shape[:2]
    mh, mw = mask_shape
    ri = (np.arange(mh) * (H / mh)).astype(np.int64)
    ci = (np.arange(mw) * (W / mw)).astype(np.int64)
    return img[ri][:, ci]


def _to_work(x: torch.Tensor, hw) -> torch.Tensor:
    """Nearest upsampling of [..., h, w] masks or segment ids from the
    stride-4 mask grid to the working resolution ``hw`` (ids stay intact).
    The JAX entry draws the stride-4 maps onto the working-resolution image
    and fails on the first non-empty one (ROADMAP Queue 3)."""
    h, w = x.shape[-2:]
    ri = torch.arange(hw[0], device=x.device) * h // hw[0]
    ci = torch.arange(hw[1], device=x.device) * w // hw[1]
    return x[..., ri, :][..., ci]


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--image", default=None)
    parser.add_argument("--task", default="semseg",
                        choices=["semseg", "panoseg", "instseg", "refseg",
                                 "captioning", "retrieval"])
    parser.add_argument("--classes", default=None,
                        help="comma-separated open-vocab class names "
                             "(required for semseg/panoseg/instseg)")
    parser.add_argument("--things", default=None,
                        help="panoseg: comma-separated subset of --classes "
                             "treated as things (default: all)")
    parser.add_argument("--phrases", default=None,
                        help="refseg/retrieval: comma-separated referring "
                             "phrases / text queries")
    parser.add_argument("--gallery", default=None,
                        help="retrieval: directory of candidate images "
                             "(ranked against --phrases; --image joins them)")
    parser.add_argument("--topk", type=int, default=5, help="instseg: instances to keep")
    parser.add_argument("--caption-steps", type=int, default=20,
                        help="captioning: greedy decode steps")
    parser.add_argument("--object-threshold", type=float, default=0.8)
    parser.add_argument("--overlap-threshold", type=float, default=0.8)
    parser.add_argument("--preset", default="scannet")
    parser.add_argument("--out", default=None,
                        help="overlay png (default: <image>_<task>.png)")
    parser.add_argument("--alpha", type=float, default=0.5)
    parser.add_argument("--rich-overlay", action="store_true",
                        help="detectron2-style drawing: boundaries + label "
                             "text at region centers (utils/visualizer2d.py)")
    parser.add_argument("--eval-list", default=None,
                        help="semseg batch evaluation: file of '<image> "
                             "<gt_label_png>' lines; the predictions accumulate "
                             "a confusion-matrix mIoU (utils/eval2d.py)")
    parser.add_argument("--label-map", default=None,
                        help="eval-list: 'raw:train' comma pairs remapping gt "
                             "label-png ids to contiguous train ids, unmapped "
                             "-> ignore; default identity")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("overrides", nargs="*")
    return parser


def _eval_list(args, classes, mask_shape, forward):
    """Batch semseg evaluation over '<image> <gt png>' lines: per-image
    forward, gt remapped raw -> train (unmapped -> 255), confusion mIoU."""
    from PIL import Image

    from geopurify_tpu_torch.utils.eval2d import SemSeg2DEvaluator

    mh, mw = mask_shape
    remap = np.full(256, 255, np.uint8)
    if args.label_map:
        for pair in args.label_map.split(","):
            raw, train = pair.split(":")
            remap[int(raw)] = int(train)
    else:
        remap[: len(classes)] = np.arange(len(classes), dtype=np.uint8)
    ev = SemSeg2DEvaluator(len(classes), class_names=classes, ignore_label=255)
    with open(args.eval_list) as f:
        pairs = [ln.split() for ln in f.read().splitlines() if ln]
    for img_path, gt_path in pairs:
        o = forward(_load_work_image(img_path, mask_shape))
        seg = semseg_from_outputs(o["pred_logits"][0], o["pred_masks"][0], (mh, mw))
        gt_raw = np.asarray(Image.open(gt_path))
        ri = (np.arange(mh) * (gt_raw.shape[0] / mh)).astype(np.int64)
        ci = (np.arange(mw) * (gt_raw.shape[1] / mw)).astype(np.int64)
        gt = remap[np.clip(gt_raw[ri][:, ci], 0, 255)]
        ev.process(seg, torch.from_numpy(gt).to(seg.device))
    res = ev.evaluate()
    log.info("2D eval over %d images: mIoU=%.2f pACC=%.2f", len(pairs), res["mIoU"],
             res["pACC"])
    return res


# geopurify_tpu/run/infer2d.py:69
def main(argv=None):
    parser = _parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s %(filename)s:%(lineno)d] %(message)s")
    if args.task in ("semseg", "panoseg", "instseg") and not args.classes:
        parser.error(f"--task {args.task} requires --classes")
    if args.task in ("refseg", "retrieval") and not args.phrases:
        parser.error(f"--task {args.task} requires --phrases")
    if not args.image and not args.eval_list:
        parser.error("--image (or --eval-list for batch semseg) is required")

    from PIL import Image

    from geopurify_tpu_torch import resolve_device
    from geopurify_tpu_torch.config import load_config
    from geopurify_tpu_torch.models import inference2d as inf
    from geopurify_tpu_torch.models.lang import embed_class_names
    from geopurify_tpu_torch.run.train import build_pipeline
    from geopurify_tpu_torch.utils.visualization import overlay_2d_semantic
    from geopurify_tpu_torch.utils.visualizer2d import Visualizer2D

    dev = resolve_device(args.device)
    classes = [c.strip() for c in (args.classes or "object").split(",") if c.strip()]
    cfg = load_config(args.preset, overrides=args.overrides)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, all_label=tuple(classes)))
    gen = torch.Generator().manual_seed(0)
    pipeline, (tk, lang) = build_pipeline(cfg, gen, device=dev, require_teachers=True,
                                          with_sonata=False, return_lang=True)
    model, text, scale = pipeline.xdecoder, pipeline.text_embeddings, pipeline.logit_scale

    def forward(work):
        with torch.inference_mode():
            return model(torch.from_numpy(work).to(dev)[None], text, scale)

    def embed_phrases(phrases):
        # raw phrases: no templates, no background (evaluate_grounding_baseline)
        return torch.from_numpy(embed_class_names(
            lang, tk, phrases, use_templates=False, add_background=False, device=dev)).to(dev)

    mask_shape = tuple(cfg.xdecoder.mask_shape)
    if args.eval_list:
        return _eval_list(args, classes, mask_shape, forward)

    work = _load_work_image(args.image, mask_shape)
    out = forward(work)
    dst = args.out or os.path.splitext(args.image)[0] + f"_{args.task}.png"
    base = work.astype(np.uint8)
    logits, masks = out["pred_logits"][0], out["pred_masks"][0]

    if args.task == "semseg":
        seg = semseg_from_outputs(logits, masks, mask_shape).cpu().numpy()
        if args.rich_overlay:
            overlay = (Visualizer2D(base, class_names=classes)
                       .draw_sem_seg(seg, alpha=args.alpha).get_image())
        else:
            overlay = overlay_2d_semantic(work, seg, num_classes=len(classes),
                                          alpha=args.alpha)
        Image.fromarray(overlay).save(dst)
        log.info("class pixel counts: %s",
                 {classes[c]: int((seg == c).sum()) for c in range(len(classes))})

    elif args.task == "panoseg":
        things = set(t.strip() for t in (args.things or args.classes).split(",") if t.strip())
        is_thing = torch.tensor([c in things for c in classes], device=dev)
        pan, info = inf.panoptic_inference(logits, masks, is_thing,
                                           object_mask_threshold=args.object_threshold,
                                           overlap_threshold=args.overlap_threshold)
        # the segment table in segment-id order (1-based)
        valid = info.valid.cpu().numpy()
        seg_id = info.seg_id.cpu().numpy()
        owners = np.flatnonzero(valid)[np.argsort(seg_id[valid])]
        cats = [int(info.category_id[q]) for q in owners]
        isth = [bool(info.isthing[q]) for q in owners]
        overlay = (Visualizer2D(base, class_names=classes)
                   .draw_panoptic_seg(_to_work(pan, mask_shape).cpu().numpy(), cats, isth,
                                      alpha=args.alpha)
                   .get_image())
        Image.fromarray(overlay).save(dst)
        log.info("%d segments: %s", len(owners),
                 [(i + 1, classes[c], t) for i, (c, t) in enumerate(zip(cats, isth))])

    elif args.task == "instseg":
        inst = inf.instance_inference(logits, masks, topk=args.topk)
        keep = inst.valid.cpu().numpy()
        cls_k = inst.classes.cpu().numpy()[keep]
        scores_k = inst.scores.cpu().numpy()[keep]
        inst_masks = _to_work(inst.masks, mask_shape)
        overlay = (Visualizer2D(base, class_names=classes)
                   .draw_instance_predictions(inst_masks.cpu().numpy()[keep], cls_k,
                                              scores=scores_k,
                                              boxes=inf.masks_to_boxes(inst_masks)
                                              .cpu().numpy()[keep],
                                              alpha=args.alpha)
                   .get_image())
        Image.fromarray(overlay).save(dst)
        log.info("instances: %s", [(classes[int(c)], float(s))
                                   for c, s in zip(cls_k, scores_k)])

    elif args.task == "refseg":
        phrases = [p.strip() for p in args.phrases.split(",") if p.strip()]
        matched_masks, matched = inf.grounding_inference(
            out["mask_embed"][0], embed_phrases(phrases), masks,
            logit_scale=float(np.log(np.float32(scale))))
        viz = Visualizer2D(base, class_names=phrases)
        for i, phrase in enumerate(phrases):
            viz.draw_binary_mask(_to_work(matched_masks[i] > 0, mask_shape).cpu().numpy(),
                                 viz.palette[i % len(viz.palette)], alpha=args.alpha,
                                 text=phrase)
        Image.fromarray(viz.get_image()).save(dst)
        log.info("matched query per phrase: %s",
                 dict(zip(phrases, matched.cpu().numpy().tolist())))

    elif args.task == "captioning":
        from geopurify_tpu_torch.models.xdecoder import apply_head, encode_pixel_features

        # encode the image once; each step re-runs the query decoder and the
        # language tower's token embedding only
        head = model.predictor
        if head.caping_embed is None:
            # a model built without caption slots gets zero stand-ins, as in
            # JAX (converted captioning checkpoints carry them)
            head.add_caption_slots(cfg.text.context_length)
        table = lang.lang_encoder.token_embedding.embedding
        with torch.inference_mode():
            mask_features, multi_scale = encode_pixel_features(
                model, torch.from_numpy(work).to(dev)[None])

            def logits_fn(tokens):
                tok_emb, _ = lang.encode_tokens(tokens)
                o = apply_head(model, multi_scale, mask_features, text, scale,
                               caption_tokens=tok_emb)
                return o["pred_captionings"][:, :-1] @ table.T

            tokens = inf.caption_greedy_decode(
                logits_fn, steps=args.caption_steps, context_length=cfg.text.context_length,
                bos_id=int(getattr(tk, "sot", 49406)), device=dev)
        ids = tokens[0].cpu().numpy()
        caption = tk.decode(ids[1:])          # skip the BOS slot; stops at EOT
        dst = os.path.splitext(dst)[0] + ".txt"
        with open(dst, "w") as f:
            f.write(caption + "\n")
        log.info("caption: %r (token ids %s...)", caption, ids[:8].tolist())

    elif args.task == "retrieval":
        phrases = [p.strip() for p in args.phrases.split(",") if p.strip()]
        paths = [args.image]
        if args.gallery:
            paths += sorted(os.path.join(args.gallery, p) for p in os.listdir(args.gallery)
                            if p.lower().endswith((".png", ".jpg", ".jpeg")))
        embeds = [out["cls_embed"][0]]
        for p in paths[1:]:
            embeds.append(forward(_load_work_image(p, mask_shape))["cls_embed"][0])
        sim = inf.retrieval_scores(torch.stack(embeds), embed_phrases(phrases)).cpu().numpy()
        ranking = {}
        for t, phrase in enumerate(phrases):
            ranking[phrase] = [{"image": paths[i], "score": round(float(sim[t, i]), 4)}
                               for i in np.argsort(-sim[t])]
            log.info("ranking for %r: %s", phrase,
                     [(r["image"], r["score"]) for r in ranking[phrase]])
        dst = os.path.splitext(dst)[0] + ".json"
        with open(dst, "w") as f:
            json.dump(ranking, f, indent=1)

    log.info("wrote %s", dst)
    return dst


if __name__ == "__main__":
    main()
