#!/usr/bin/env python3
"""How far ``run.parity``'s outputs move between devices and precisions.

Writes the full-width released-layout X-Decoder that ``chip_smoke.py``
phases 12 and 18 build (``released_xdecoder``) to a temporary directory,
then runs ``run.parity.run_ours`` on the default 484x648 noise image four
times: on the card and on the CPU, each in bf16 (the default config) and
in f32 (``xdecoder.dtype=float32``; the card's TF32 off). Prints the
relative difference (max |a - b| / max |b|, as ``run.parity.compare``) of
each output for the card against the CPU at each precision and for each
device's bf16 against its own f32, then the head's round-0 attention
logits and the fraction of binary attention-mask entries that differ
between the devices, round by round, at each precision. Needs a card. From
the repo root:

    python3 scripts/parity_precision.py
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from geopurify_tpu_torch.config import GeoPurifyConfig  # noqa: E402
from geopurify_tpu_torch.models.xdecoder import XDecoderSegModel  # noqa: E402
from geopurify_tpu_torch.run import parity  # noqa: E402
from geopurify_tpu_torch.utils.checkpoint import load_torch_state_dict  # noqa: E402
from geopurify_tpu_torch.utils.convert_xdecoder import convert_xdecoder_checkpoint  # noqa: E402

CLASSES = ["wall", "floor", "chair", "table", "door"]


def rel(a, b) -> float:
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def main() -> int:
    if not torch.cuda.is_available():
        print("parity_precision: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GeoPurifyConfig()
    cfgs = {"bf16": cfg, "f32": dataclasses.replace(
        cfg, xdecoder=dataclasses.replace(cfg.xdecoder, dtype="float32"))}
    image = np.random.default_rng(0).uniform(0, 255, (484, 648, 3)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, _, _ = chip_smoke.released_xdecoder(chip_smoke.load_mods(), Path(tmp))
        runs = {}
        for prec, c in cfgs.items():
            for dev in ("cuda", "cpu"):
                t = time.perf_counter()
                runs[prec, dev] = parity.run_ours(str(ckpt), image, CLASSES, cfg=c, device=dev)
                print(f"run_ours {prec} on {dev}: {time.perf_counter() - t:.1f} s", flush=True)
        for a, b in ((("bf16", "cuda"), ("bf16", "cpu")), (("f32", "cuda"), ("f32", "cpu")),
                     (("bf16", "cuda"), ("f32", "cuda")), (("bf16", "cpu"), ("f32", "cpu"))):
            print(f"{a} against {b}:", {k: f"{rel(runs[a][k], runs[b][k]):.3e}"
                                        for k in runs[a]}, flush=True)
        conv = convert_xdecoder_checkpoint(load_torch_state_dict(str(ckpt)))
    text = torch.from_numpy(runs["bf16", "cuda"]["text"])
    for prec, c in cfgs.items():
        heads = {}
        for dev in ("cuda", "cpu"):
            model = XDecoderSegModel(c.xdecoder)
            model.load_state_dict(conv["xdecoder"])
            model.to(dev).eval()
            with torch.no_grad():
                out = model(torch.from_numpy(image).to(dev)[None], text.to(dev),
                            conv["logit_scale"], return_attn=True)
            heads[dev] = ([m.cpu().numpy() for m in out["attn_masks"]],
                          out["attn_logits0"].float().cpu().numpy())
            del model
        flips = [float(np.mean(a != b)) for a, b in zip(heads["cuda"][0], heads["cpu"][0])]
        print(f"{prec}: round-0 attention logits card against CPU rel "
              f"{rel(heads['cuda'][1], heads['cpu'][1]):.3e}; binary mask entries that differ, "
              f"round by round: {[f'{f:.2e}' for f in flips]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
