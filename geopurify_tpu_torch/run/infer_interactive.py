"""Interactive click -> mask segmentation (SEEM): refinement loop, demo, NoC.

Port of geopurify_tpu/run/infer_interactive.py. Clicks seed positive
prompt masks on the stride-4 mask grid; each round ``SEEMHeadV1`` predicts
a mask from points resampled off the prompt masks, with the previous
round's mask as spatial memory. ``--task demo`` runs ``SEEMHeadDemo`` once
(with ``--refimg`` / ``--ref-clicks`` a visual prompt from a reference
image, through its ``task='refimg'`` bundle); ``--eval-noc N`` runs the
NoC protocol over N synthetic instances (first click by SimpleClick's
rule, then ``interactive_refine``, then ``InteractiveEvaluator``) and
prints one JSON line. The backbone and pixel decoder are the X-Decoder's
(``models/xdecoder.py``), in f32 as in JAX, with random weights seeded
from ``torch.Generator`` (``build_models``); the per-round draws (the
spatial query indices from ``np.random.default_rng(1)``, the memory
channels all 0) are numpy, as in JAX, so a seeded run draws the same in
both packages. Runs on the card unless ``--device cpu``.

Usage (synthetic image, random weights):
  python -m geopurify_tpu_torch.run.infer_interactive --synthetic \\
      --clicks "24,32" --out mask.png
  python -m geopurify_tpu_torch.run.infer_interactive --image photo.jpg \\
      --clicks "120,200;90,210" [--neg-clicks "10,10"] --out overlay.png
  ... --task demo [--refimg ref.png --ref-clicks "40,60"]
  ... --synthetic --eval-noc 20 --rounds 5
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
from types import SimpleNamespace

import numpy as np
import torch

log = logging.getLogger("geopurify.interactive")


# geopurify_tpu/run/infer_interactive.py:30
def parse_clicks(spec: str):
    out = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if part:
            y, x = part.split(",")
            out.append((int(y), int(x)))
    return out


def build_models(xc, task: str, budget: int, n_cls: int, device) -> SimpleNamespace:
    """The backbone, pixel decoder and SEEM head (``SEEMHeadV1``, or
    ``SEEMHeadDemo`` for ``task='demo'``, ``budget`` prompt tokens) of the
    f32 X-Decoder config ``xc``, seeded from ``torch.Generator`` seed 0,
    and ``n_cls`` unit text embeddings. The one place weights are made: a
    test replaces it to carry the JAX entry's weights across."""
    from geopurify_tpu_torch.models.layers import flax_init_
    from geopurify_tpu_torch.models.seem import SEEMHeadDemo, SEEMHeadV1
    from geopurify_tpu_torch.models.xdecoder import _make_backbone, _make_pixel_decoder

    head_cls = SEEMHeadDemo if task == "demo" else SEEMHeadV1
    m = SimpleNamespace(
        backbone=_make_backbone(xc), pixel_decoder=_make_pixel_decoder(xc),
        head=head_cls(hidden_dim=xc.hidden_dim, dim_proj=xc.hidden_dim,
                      num_queries=xc.num_queries, nheads=xc.nheads,
                      dim_feedforward=xc.dim_feedforward, dec_layers=xc.dec_layers,
                      mask_dim=xc.mask_dim, max_spatial_tokens=budget))
    g = torch.Generator().manual_seed(0)
    for mod in (m.backbone, m.pixel_decoder, m.head):
        flax_init_(mod, g)
        mod.to(device).eval()
    text = torch.randn((n_cls, xc.hidden_dim), generator=g)
    m.text = (text / text.norm(dim=-1, keepdim=True)).to(device)
    return m


def encode_image(models, img: np.ndarray, div: int, device):
    """[H, W, 3] RGB in 0..255 -> (mask_features, multi_scale): scaled to
    [-1, 1] as the JAX entry does, zero-padded to ``div``, backbone, pixel
    decoder."""
    H, W = img.shape[:2]
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(device)[None] / 127.5 - 1.0
    x = torch.nn.functional.pad(x, (0, 0, 0, -(-W // div) * div - W, 0, -(-H // div) * div - H))
    with torch.inference_mode():
        mask_features, _, multi_scale = models.pixel_decoder(models.backbone(x))
    return mask_features, multi_scale


def _overlay(img, mask_logits: np.ndarray, H: int, W: int, color, text: str, dst: str):
    """The stride-4 mask (sigmoid > 0.5), nearest-upsampled to the image,
    drawn onto it and written to ``dst``."""
    from PIL import Image

    from geopurify_tpu_torch.utils.visualizer2d import Visualizer2D

    Hm, Wm = mask_logits.shape
    mask = 1 / (1 + np.exp(-mask_logits)) > 0.5
    mask_full = mask[np.minimum(np.arange(H) // 4, Hm - 1)[:, None],
                     np.minimum(np.arange(W) // 4, Wm - 1)[None, :]]
    overlay = (Visualizer2D(img.astype(np.uint8))
               .draw_binary_mask(mask_full, np.array(color), text=text).get_image())
    Image.fromarray(overlay).save(dst)
    log.info("wrote %s", dst)
    return dst


# geopurify_tpu/run/infer_interactive.py:40
def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--image", default=None)
    parser.add_argument("--synthetic", action="store_true",
                        help="96x128 synthetic image with a bright rectangle")
    parser.add_argument("--eval-noc", type=int, default=0,
                        help="run the NoC protocol over N synthetic instances instead "
                             "of the overlay: SimpleClick-placed first click -> "
                             "refinement -> NoC@{0.5,0.8,0.85,0.9}, one JSON line")
    parser.add_argument("--clicks", default="8,8",
                        help='"y,x;y,x" positive clicks (image coordinates)')
    parser.add_argument("--neg-clicks", default="")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--budget", type=int, default=64)
    parser.add_argument("--preset", default="scannet")
    parser.add_argument("--task", default="v1", choices=("v1", "demo"),
                        help="v1 = click-refinement loop (SEEMHeadV1); demo = one-shot "
                             "composed-prompt head (SEEMHeadDemo)")
    parser.add_argument("--refimg", default=None,
                        help="[demo] reference image for a visual prompt")
    parser.add_argument("--ref-clicks", default="",
                        help='[demo] "y,x;y,x" clicks on --refimg marking the exemplar')
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s %(filename)s:%(lineno)d] %(message)s")
    if not args.synthetic and not args.image:
        parser.error("--image or --synthetic required")

    from PIL import Image

    from geopurify_tpu_torch import resolve_device
    from geopurify_tpu_torch.config import load_config
    from geopurify_tpu_torch.models.seem import points_from_masks

    dev = resolve_device(args.device)
    cfg = load_config(args.preset, overrides=args.overrides)
    xc = dataclasses.replace(cfg.xdecoder, dtype="float32")    # the JAX entry's f32
    if args.synthetic:
        rng = np.random.default_rng(0)
        H, W = 96, 128
        img = rng.uniform(40, 80, (H, W, 3)).astype(np.float32)
        img[20:70, 30:100] = rng.uniform(180, 230, (50, 70, 3))
    else:
        img = np.asarray(Image.open(args.image).convert("RGB")).astype(np.float32)
        H, W = img.shape[:2]

    n_cls = max(len(cfg.data.all_label), 2)
    models = build_models(xc, args.task, args.budget, n_cls, dev)
    mask_features, multi_scale = encode_image(models, img, xc.size_divisibility, dev)
    Hm, Wm = mask_features.shape[1:3]
    if args.task == "demo":
        return _run_demo(args, xc, models, multi_scale, mask_features, img, H, W, dev)

    head, text = models.head, models.text
    S = args.budget
    host_rng = np.random.default_rng(1)
    NS = head.sample_size                    # a single prompt mask: num_masks = 1
    L, M = head.dec_layers, head.num_spatial_memories
    mids0 = torch.zeros((1, S), dtype=torch.int64, device=dev)

    def head_apply(pts, valid, tags, prev):
        # the reference draws the spatial-query sample and the per-layer
        # memory channels from torch RNG each forward; the host draws them
        # here (a single mask: channel 0 always)
        qidx = torch.from_numpy(host_rng.integers(0, head.num_queries, NS)).to(dev)
        kw = {} if prev is None else dict(
            prev_mask=prev, memory_indices=torch.zeros((L, M), dtype=torch.int64, device=dev))
        with torch.inference_mode():
            return head(multi_scale, mask_features, text, 20.0,
                        *(torch.from_numpy(a).to(dev)[None] for a in (pts, valid, tags)),
                        mids0, qidx, **kw)

    if args.eval_noc:
        # synthetic elliptical instances; the first click at the deepest gt
        # pixel (SimpleClick's rule), then the loop's error-driven clicks
        from geopurify_tpu_torch.data.visual_sampler import _center_clicks
        from geopurify_tpu_torch.models.seem import interactive_refine
        from geopurify_tpu_torch.utils.eval2d_suite import InteractiveEvaluator

        max_clicks = args.rounds
        ev = InteractiveEvaluator(max_clicks=max_clicks, iou_iter=1)
        g = np.random.default_rng(3)
        yy, xx = np.mgrid[0:Hm, 0:Wm]
        per_sample = []
        for i in range(args.eval_noc):
            cy = int(g.integers(Hm // 4, 3 * Hm // 4))
            cx = int(g.integers(Wm // 4, 3 * Wm // 4))
            ry = int(g.integers(3, max(Hm // 3, 4)))
            rx = int(g.integers(3, max(Wm // 3, 4)))
            gt = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0
            click = int(_center_clicks(gt[None])[0])
            init = np.zeros((Hm, Wm), bool)
            init[divmod(click, Wm)] = True
            _, ious = interactive_refine(head_apply, gt, init, budget=S, iters=max_clicks,
                                         seed=i, iou_stop=0.99)
            arr = np.asarray(ious + [ious[-1]] * (max_clicks - len(ious)))
            per_sample.append(arr)
            log.info("instance %d: IoU per click %s", i, np.round(arr, 3))
        ev.process(per_sample)
        metrics = ev.evaluate()
        log.info("NoC metrics: %s", metrics)
        print(json.dumps({k: round(v, 4) for k, v in metrics.items()}))
        return 0

    # prompt masks on the stride-4 grid from the clicks
    pos = np.zeros((Hm, Wm), bool)
    neg = np.zeros((Hm, Wm), bool)
    for (y, x) in parse_clicks(args.clicks):
        pos[min(y // 4, Hm - 1), min(x // 4, Wm - 1)] = True
    for (y, x) in parse_clicks(args.neg_clicks):
        neg[min(y // 4, Hm - 1), min(x // 4, Wm - 1)] = True
    rng = np.random.default_rng(0)
    prev = None
    mask_logits = None
    for r in range(args.rounds):
        pts, valid, tags = points_from_masks(pos, neg, S, rng)
        out = head_apply(pts, valid, tags, prev)
        prev = out["prev_mask"]
        mask_logits = prev[0, 0].float().cpu().numpy()
        log.info("round %d: mask covers %.1f%% of the frame", r,
                 100 * float((1 / (1 + np.exp(-mask_logits)) > 0.5).mean()))
    dst = args.out or os.path.splitext(args.image or "synthetic")[0] + "_interactive.png"
    return _overlay(img, mask_logits, H, W, (66, 135, 245), "object", dst)


# geopurify_tpu/run/infer_interactive.py:270
def _run_demo(args, xc, models, multi_scale, mask_features, img, H, W, dev):
    """One ``SEEMHeadDemo`` forward composing the click prompt with an
    optional visual prompt from ``--refimg``; the winning object mask by
    ``demo_select_mask``."""
    from PIL import Image

    from geopurify_tpu_torch.models.seem import demo_select_mask

    head, text, S = models.head, models.text, args.budget
    Hm, Wm = mask_features.shape[1:3]

    def clicks_to_prompt(clicks, neg_clicks, hm, wm):
        pts = np.zeros((1, S, 2), np.float32)
        valid = np.zeros((1, S), bool)
        tags = np.ones((1, S), np.int32)
        n = 0
        for tag, spec in ((1, clicks), (-1, neg_clicks)):
            for (y, x) in parse_clicks(spec):
                if n >= S:
                    break
                pts[0, n] = min(y // 4, hm - 1) / hm, min(x // 4, wm - 1) / wm
                tags[0, n] = tag
                valid[0, n] = True
                n += 1
        return tuple(torch.from_numpy(a).to(dev) for a in (pts, valid, tags))

    pts, valid, tags = clicks_to_prompt(args.clicks, args.neg_clicks, Hm, Wm)
    kwargs = dict(spatial_points=pts, spatial_valid=valid, spatial_posneg=tags)
    with torch.inference_mode():
        if args.refimg:
            rimg = np.asarray(Image.open(args.refimg).convert("RGB")).astype(np.float32)
            rmask_features, rmulti = encode_image(models, rimg, xc.size_divisibility, dev)
            rpts, rvalid, rtags = clicks_to_prompt(args.ref_clicks, "",
                                                   *rmask_features.shape[1:3])
            bundle = head(rmulti, rmask_features, text, 20.0, spatial_points=rpts,
                          spatial_valid=rvalid, spatial_posneg=rtags, task="refimg")
            kwargs.update(visual_tokens_by_level=list(bundle["src_visual_queries"]),
                          visual_valid=rvalid, visual_query_pos=bundle["visual_query_pos"],
                          visual_query_neg=bundle["visual_query_neg"])
        out = head(multi_scale, mask_features, text, 20.0, task="demo", **kwargs)
    best, mask = demo_select_mask(
        out, prompt="visual" if (args.refimg and not args.clicks) else "spatial")
    log.info("demo: winning object query %d", int(best[0]))
    dst = args.out or os.path.splitext(args.image or "synthetic")[0] + "_demo.png"
    return _overlay(img, mask[0, 0].float().cpu().numpy(), H, W, (245, 135, 66), "demo", dst)


if __name__ == "__main__":
    main()
