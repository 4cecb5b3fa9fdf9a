#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port (geopurify_tpu_torch).

Needs one CUDA card (``torch.cuda.is_available()``) and the CUDA toolkit;
exits non-zero, printing no result, without them. Run from the repo root:

    python3 chip_smoke.py

Phases (any failure exits non-zero; each prints its seconds):
1. the card's name and power limit; build every CUDA kernel from csrc/;
2. kernel K1 (banded-window matmul) against its plain PyTorch version at
   the Stage-2 shapes (M=65536, band=12288, C=19 and C=32), with its time,
   the plain version's, a torch.bmm yardstick and the bytes bound;
3. the Stage-2 main path at full width: ``GeoPurifyPipeline.evaluate_scene``
   at the ``scannet`` preset (FocalNet-L X-Decoder in bf16, 518-512-128
   student, kNN-96 + 19 banded smoothing rounds) on 3 bench-spec scenes
   (P=131072, M=65536, V=8, Pv=16384, 484x648), seeded random weights
   (fan-in-scaled, with the winning queries' embeddings as class prompts,
   so that more than one class wins), counting K1's launches; plus the
   gather path timed on one scene's graph and one more scene under
   torch.profiler (kernels by device time);
4. the same seeded pipeline at the small bench --smoke sizes on the card and
   on the CPU (plain versions): predictions must agree;
5. kernel K2 (fused InfoNCE forward and backward) against its plain
   versions at the Stage-1 shapes (A=4096, NEG=63, E=128) and at an awkward
   one, all-invalid anchors, and its times beside the plain versions', a
   torch.bmm + cross_entropy yardstick and the bytes bounds;
6. the Stage-1 main path at full width: ``scannet`` with
   ``contrastive.fused_loss=true`` on one bench-spec scene: f2d from the
   seeded X-Decoder lift, teacher features from the full Sonata in bf16,
   then 1 warm-up and 5 timed training steps (``run.train.make_train_step``:
   sampler, student in train mode, K2, AdamW), counting K2's launches, with
   the sampler / spatial kNN / fwd+bwd / optimizer split and one profiled
   step;
7. the training entry point ``run.train.main --synthetic`` at the scannet
   preset: 2 steps, checkpoint, resume for one more step;
8. Stage 1 at the ``tiny`` preset on the card and on the CPU (K2 against
   its plain versions, f32 tiny Sonata, TF32 off): loss, gradients and
   running statistics must agree;
9. K1 against its plain version at the shapes of the preset-scale paths
   (M=2^18, band 6144, C=19, 40, 80, 160, 200 and 512: every preset's class
   count but matterport's 21, and feature space) and at C=64, 200 and 512
   for M=65536, band 12288, with times, bounds and the torch.bmm yardstick;
10. Stage-2 validation at preset scale through the entry point
   ``run.validate.main``: two ScanNet-layout scenes written to a temporary
   directory (~2^20 points in ~2^18 2 cm voxels, 36 and 140 views of
   1296x968 colour and 640x480 depth rendered from the points), evaluated
   at the ``scannet`` preset's buckets (P=2^20, M=2^18, Pv=2^16, V=64 and
   256) with band 6144 and a 2^21-edge residual, then the first scene at
   ``scannet200`` (logit space, C=200) and in feature space (C=512), the
   X-Decoder seeded as in phase 12 (more than one class must win); per
   scene the host load, views / fuse_fill / pool_classify, the smoothing's
   kNN (the pruned grid route, with its certificate's counts), the voxel
   fill's donor search, the student's 3^3 convs by route (z-stacked or,
   where the residual overflows its budget, the tap scan), K1's launches,
   band_overflow and peak memory;
11. the same path at the ``tiny`` preset on the card and on the CPU over a
   small on-disk fixture padded to P=2^19 (so the voxel-resolution unseen
   fill runs), seeded so that all four classes win: equal batches from
   both loaders, logits within 1% of their scale, predictions flipped only
   at near-ties and at most 9 points, histograms accounted for by the
   flips;
12. released-layout checkpoints in, on-disk scenes through both stages:
   two ScanNet-layout scenes (2^20 points, 36 views) written as in phase
   10; the full-width X-Decoder and language tower written out by the
   port's inverse converter and run through ``run.validate.main
   xdecoder.ckpt=...`` against the same weights loaded directly (identical
   predictions, logits and mIoU, 19 K1 launches each); the full-width
   Sonata out to the release layout and back through ``sonata.ckpt``
   (bit-equal teacher features at P=2^20); ``run.precompute.main`` over
   both scenes and fused-feature files made from its cache (P = M = 2^16,
   the cache's cut); ``run.train.main`` with ``--teacher-cache`` (3
   steps), ``--fused-features`` (2) and live at the preset's own buckets
   (2; P=2^20, M=2^18, V=64), each with K2's forward and backward launched
   once a step, finite losses and a checkpoint, timed per step (the
   directly loaded route given the converter's logit scale);
13. the parallel layer: ``run.validate.main`` over each of phase 10's two
   scenes in a run of its own (deterministic algorithms), then two ranks
   over gloo on the one card (``parallel.spawn``), each running (a) 3
   data-parallel Stage-1 steps at ``scannet`` with SyncBN and K2 on a
   bench-spec scene of its own (replicas bit-equal after every step, K2 once a step, s/step and
   peak), and one ``tiny`` step on the card against the CPU (phase 8's
   tolerance); (c) the view-parallel lift of a bench-spec scene's 8 views
   against the sequential lift (counts equal, features up to consensus
   near-ties, both times); (b) ``run.validate.main --distributed`` over the
   two scenes (I/U/T equal exactly to those of the runs of one scene each,
   19 K1 launches a scene, one JSON line); and (d) ``run.train.main
   --distributed`` as a world of 1 over NCCL, launched through the
   environment as ``torchrun`` does, 2 synthetic steps, beside the runs of
   one scene;
14. the pruned searches and the z-stack at phase 10's first scene: the
   smoothing's kNN-96 (``knn_self_grid``, M=2^18) against the full route
   (dists and idx bit-equal on the valid rows; the shares of queries that
   failed the certificate and of tiles over budget), the voxel fill's
   donors (``nearest_fill_grid``'s search) against ``nearest_fill``'s
   sweep (equal), the sampler's anchors' kNN (``knn_anchors_grid``, 4096
   anchors over P=2^20 points) against ``knn_search`` (equal), and the
   full-width student with a ``ZStackTable`` (its budget raised to the
   largest tap where the pipeline's overflows) against the plain table
   (within 2e-4 of the embedding scale), each with both times;
15. the 2D family, which launches neither kernel (both counts read 0):
   (a) ``run.infer2d.main`` at ``scannet`` (FocalNet-L X-Decoder in bf16 at
   484x648) through ``xdecoder.ckpt``, a LeCun-seeded checkpoint with
   caption slots written by the port's inverse converter, over synthetic
   480x640 frames: semseg (rich overlay), panoseg, instseg, refseg and
   captioning (20 greedy steps) on 3 images each, retrieval over a gallery
   of 4, and ``--eval-list`` over 8 image / label-png pairs, with seconds
   an image from the second image on, the pipeline built once, and the
   peak memory; more than one class must win a semseg map, the caption
   ids lie in the vocabulary and the mIoU is finite; (b) one forward of
   each alternative X-Decoder at full width (bf16, 484x648): focal_dw
   FocalNet-L, DaViT (96-768, depths 1-1-3-1), ViT-B (768 wide, 12 deep,
   window 14) and FocalNet-L with the deformable pixel decoder (6 layers,
   8 heads, 4 points, 3 scales), median ms of 3 after a warm-up, peak
   memory, finite outputs, and ms_deform_attn's share of the deformable
   forward; (c) the card against the CPU in f32 with TF32 off at narrow
   widths: each configuration of (b) (pixel features, and the head on the
   CPU's attention masks, rel < 1e-4), ms_deform_attn with sampling points
   outside the maps, and every infer2d task at the ``tiny`` preset (logits
   within 1e-4, semseg flips only at near-ties, equal tables, caption ids,
   ranking and mIoU);
16. the interactive path (SEEM), which launches neither kernel (both
   counts read 0): (a) ``run.infer_interactive.main`` at ``scannet``'s
   full width with SEEM's 101 queries (FocalNet-L, the 6-layer FPN
   encoder, the 9-layer SEEM heads, 512 wide, f32 as the JAX entry) on a
   synthetic 480x640 photo: the v1 click-refinement loop (3 rounds, 64
   prompt tokens), the demo head with a reference image's visual prompt,
   and the NoC protocol over 4 instances of 3 rounds, with each call's
   seconds, its backbone + pixel decoder and head rounds, the peak memory,
   finite head outputs and a NoC line in range; (b) the card against the
   CPU in f32 with TF32 off at narrow widths, the card forced onto the
   CPU's binary attention masks: each head (v0 with grounding and memory,
   v1 over two masks with memory, the demo's refimg bundle and all four
   prompt kinds) and the v1 loop of ``main`` (outputs and pre-threshold
   logits within 1e-4, flips only at near-ties).
17. the 2D trainer, which launches neither kernel (both counts read 0):
   (a) ``run.train2d.main`` at ``scannet``'s full width (FocalNet-L, the
   6-layer FPN, the 9-layer head, 512 wide with 201 queries, bf16 compute
   on f32 parameters, 4096 criterion points; the 12-layer language tower,
   49408 tokens): seg on synthetic 484x648 images (6 steps, then
   ``--resume`` for one more), vlp (3 steps, 32-token captions), joint zip
   (3) and switch (2: both tasks), interactive at 512x512 with SEEM's 101
   queries (3), and seg over a COCO-json fixture and joint zip beside a
   caption fixture (2 each), with seconds a step from the second on, its
   split (forward + backward, the host Hungarian, clip + AdamW), the peak
   memory, finite losses, parameters moved, a checkpoint; (b) one step's
   losses and gradients of each task on the card against the CPU in f32
   with TF32 off at tiny widths, the card on the CPU's attention masks
   (within 1e-4 of their scale).
18. the data-preparation path: (a) a raw ScanNet scan written to a
   temporary directory (a ``_vh_clean_2.ply`` of 150,000 vertices over a
   6 x 5 x 3 m room with its ``.labels.ply``, a version-4 ``.sens`` of 400
   frames, 1296x968 JPEG colour and 640x480 zlib depth rendered from the
   points, label images and a label tsv) through ``data.preprocess.main``
   ``scannet-3d`` and ``scannet-2d`` at the subcommands' defaults; (b)
   ``run.validate.main --device cuda`` at ``scannet`` over that output (K1
   launched 19 times, K2 none; seconds split into preprocess 3D / 2D, host
   load and evaluate); (c) the host load by part on that scene: the
   ``.pth`` read, cameras, images, depths, the mapping on the card against
   ``native.compute_mapping`` (exact) and the loader's numpy voxel dedup
   against ``native.fnv_voxelize`` (bit-equal), each timed, the dedup also
   at phase 10's 2^20 points; (d)
   ``run.parity.main`` over a released-layout checkpoint: ``--dump`` on the
   card, ``--device cpu --compare`` on that dump, at the default config
   (bf16; status and worst rel recorded, a ``FLAG:`` line when above the
   tool's 5e-2 limit) and with ``--dtype float32`` (TF32 off), which
   must exit 0.
19. the bench entry point ``python -m geopurify_tpu_torch.run.bench``, a
   process a run: the default (8 scenes), ``--profile-stages`` (the stage
   split and ``mfu_table``), ``--views 64``, ``--preset-scale``,
   ``--resident``, ``--prefetch-h2d``, ``--stage1 --profile-stages``,
   ``--view-parallel 2`` (two gloo ranks on the card) and ``--smoke
   --stage1`` (8 gloo ranks on the host's CPU): exactly one JSON line on
   stdout with the mode's metric and a finite positive value, the K1 / K2
   launches its stderr reports (``bench_launches``), each run's stderr
   echoed; the default run's seconds a scene against phase 3's steady ones
   (a ``FLAG:`` line beyond 15%).

A K1 row at a preset's class count (or feature space's 512) that is
slower than its library call is flagged (``FLAG:`` lines naming the preset,
``k1_behind_library`` in the record) without failing the run, whether or
not phase 10 ran that preset. The line before the last holds the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. A fuller record goes to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from geopurify_tpu_torch.ops.band import banded_window_matmul_work
from geopurify_tpu_torch.ops.infonce import info_nce_work
from geopurify_tpu_torch.utils.seeding import (
    query_prompts,
    seed_lecun,
    seed_student,
    seed_weights,
    text_embeddings,
)

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 peak memory rate
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12                  # H100 SXM f32 peak outside the tensor cores
BENCH_SPEC = dict(P=131072, M=65536, V=8, Pv=16384)
SMOKE_SPEC = dict(P=512, M=256, V=2, Pv=128)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: K1 against its plain version
# ---------------------------------------------------------------------------

def k1_inputs(M: int, band: int, C: int, row_tile: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_t = -(-M // row_tile)
    S = torch.randn((M, band), generator=g, device="cuda").to(torch.bfloat16)
    f = torch.randn((M, C), generator=g, device="cuda").to(torch.bfloat16)
    # window starts obeying the operator's contract: multiples of 8,
    # start + band <= M
    starts = torch.randint(0, M - band + 1, (n_t,), generator=g, device="cuda")
    starts = (starts // 8 * 8).to(torch.int32)
    return S, starts, f


def k1_bound_ms(R: int, M: int, band: int, C: int, n_t: int):
    flops, bytes_ = banded_window_matmul_work(R, M, band, C, n_t)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k1_row(band_mod, M: int, band: int, C: int, row_tile: int = 2048):
    """K1 at one shape against its plain version, then its time, the plain
    version's, the bmm-over-gathered-windows yardstick's and the bound."""
    S, starts, f = k1_inputs(M, band, C, row_tile, seed=C + band)
    out = band_mod.banded_window_matmul(S, starts, f, band=band, row_tile=row_tile)
    torch.cuda.synchronize()
    ref = band_mod.banded_window_matmul_ref(S, starts, f, band=band, row_tile=row_tile)
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    # both sum exact bf16 products in f32, in different orders
    tol = 1e-4 * scale
    tag = f"K1 M={M} band={band} C={C}"
    log(f"{tag}: max_abs_err={err:.3e} (tolerance {tol:.3e}, max|ref|={scale:.1f})")
    assert out.shape == (M, C) and torch.isfinite(out).all()
    assert err <= tol, f"K1 disagrees with its plain version at {tag}"
    del out, ref
    kernel_ms = cuda_ms(lambda: band_mod.banded_window_matmul(
        S, starts, f, band=band, row_tile=row_tile), iters=20)
    plain_ms = cuda_ms(lambda: band_mod.banded_window_matmul_ref(
        S, starts, f, band=band, row_tile=row_tile), iters=3, warmup=1)
    n_t = M // row_tile
    win = starts.long()[:, None] + torch.arange(band, device="cuda")[None]
    FW = f[win]
    S3 = S.reshape(n_t, row_tile, band)
    library_ms = cuda_ms(lambda: torch.bmm(S3, FW), iters=20)
    bound_ms, bound_by = k1_bound_ms(M, M, band, C, n_t)
    log(f"{tag}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"{bound_ms / kernel_ms:.1%} of the bound")
    del S, f, FW, S3
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def phase_k1(band_mod, M=65536, band=12288):
    return {C: k1_row(band_mod, M, band, C) for C in (19, 32)}


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

def seed_released(pipe, seed: int, device):
    """Phase 3's recipe (N(0, 1) x 0.02) for the X-Decoder's weights and
    biases, but norm scales at 1 + N(0, 1) x 0.02: the 0.02 scales of
    ``seed_weights`` shrink the bf16 activations of FocalNet-L's 24 blocks
    until the lifted features and the logits are all zero, and a
    comparison of two runs would then see only zeros."""
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in pipe.xdecoder.named_parameters():
            r = torch.randn(p.shape, generator=g, device=device) * 0.02
            norm = p.dim() == 1 and name.endswith("weight") and "norm" in name
            p.copy_(1 + r if norm else r)


def seed_at_scale(logit_scale: float):
    """``seed_released`` and the logit scale ``logit_scale``: a pipeline built
    without a checkpoint takes the exp of the language tower's parameter
    with torch (as JAX does), the X-Decoder converter with numpy, and the
    two may be an ulp apart; a comparison of the routes sets one scale."""
    def seed(pipe, seed: int, device):
        seed_released(pipe, seed, device)
        pipe.logit_scale = logit_scale
    return seed


def seed_small(pipe, seed: int):
    """Zero biases, norm scales near 1, N(0, 0.35^2) elsewhere: at the small
    widths several queries win and the points spread over several classes."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in (pipe.xdecoder, pipe.student):
            for name, p in mod.named_parameters():
                r = torch.randn(p.shape, generator=g)
                if name.endswith("bias"):
                    p.zero_()
                elif "norm" in name and name.endswith("weight"):
                    p.copy_(1 + 0.1 * r)
                else:
                    p.copy_(0.35 * r)


def phase_main(cfg_mod, pipe_mod, batch_mod, band_mod, pool_mod, n_scenes=3):
    cfg = cfg_mod.load_config("scannet")
    n_cls = len(cfg.data.all_label)
    text = text_embeddings(n_cls + 1, cfg.xdecoder.hidden_dim, seed=0)
    t0 = time.perf_counter()
    pipe = pipe_mod.GeoPurifyPipeline(cfg, text, 20.0, device="cuda")
    # the bench spec maps each point to a random pixel of a noise image, so
    # the smoothing averages neighbours' unrelated classes: seed_released
    # with random prompts predicts one class (PERF.md §6); these weights
    # and prompts keep a few classes through the 19 rounds
    seed_lecun(pipe, 1, "cuda")
    seed_student(pipe, torch.Generator(device="cuda").manual_seed(2), "cuda")
    n_params = sum(p.numel() for p in pipe.xdecoder.parameters())
    log(f"pipeline built in {time.perf_counter() - t0:.1f} s "
        f"(X-Decoder {n_params / 1e6:.1f} M parameters, {cfg.xdecoder.dtype})")
    hw = tuple(cfg.xdecoder.mask_shape)
    sp = BENCH_SPEC
    scenes = [batch_mod.build_scene(i + 1, sp["P"], sp["M"], sp["V"], sp["Pv"], hw)
              for i in range(n_scenes)]
    query_prompts(pipe, batch_mod.SceneBatch.from_numpy(scenes[0], device="cuda"), seed=7)
    torch.cuda.reset_peak_memory_stats()
    band_mod.banded_window_matmul.launches = 0
    per_scene = []
    for i, arrays in enumerate(scenes):
        batch = batch_mod.SceneBatch.from_numpy(arrays, device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe.evaluate_scene(batch, n_valid_views=sp["V"], profile=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        logits, pred = out["logits"], out["pred"]
        st = out["stage_seconds"]
        predicted = int(torch.unique(pred[batch.point_valid]).numel())
        per_scene.append(dict(seconds=dt, band_overflow=out["band_overflow"],
                              predicted=predicted, **st))
        log(f"scene {i}: {dt:.3f} s (views {st['views']:.3f}, fuse+fill "
            f"{st['fuse_fill']:.3f}, pool+classify {st['pool_classify']:.3f}) "
            f"band_overflow={out['band_overflow']}, {predicted} classes predicted")
        assert predicted > 1, "one class predicted: the seeded weights say nothing"
        assert out["band_overflow"] == 0, "banded operator overflowed"
        assert pred.shape == (sp["P"],) and logits.shape == (sp["P"], n_cls)
        assert torch.isfinite(logits).all(), "non-finite logits"
        assert int(pred.max()) < n_cls
    launches = band_mod.banded_window_matmul.launches
    peak = torch.cuda.max_memory_allocated()
    log(f"main path: K1 launches={launches} over {n_scenes} scenes, "
        f"peak device memory {peak / 2**30:.2f} GiB")
    assert launches == cfg.pooling.num_iterations * n_scenes, launches

    # the gather path and the banded path on one scene's graph
    batch = batch_mod.SceneBatch.from_numpy(scenes[-1], device="cuda")
    pc = cfg.pooling
    with torch.inference_mode():
        f2d, _ = pipe.lift_scene(batch, n_valid=sp["V"])
        voxel_in, embed, _ = pipe._voxel_embed(f2d, batch)
        proj = voxel_in[:, : pc.feature_dim] @ pipe.text_embeddings[:-1].T
        torch.cuda.synchronize()
        t = time.perf_counter()
        nbr, w = pool_mod.build_affinity_graph(embed, batch.voxel_coords,
                                               batch.voxel_valid, k=pc.knn_k,
                                               sharpen=pc.sharpen)
        torch.cuda.synchronize()
        graph_s = time.perf_counter() - t
        gather_ms = cuda_ms(lambda: pool_mod.iterate_pooling(
            w, nbr, proj, pc.num_iterations), iters=1, warmup=1)
        smooth_ms = cuda_ms(lambda: pool_mod.geometry_guided_pooling(
            embed, proj, batch.voxel_coords, batch.voxel_valid, k=pc.knn_k,
            sharpen=pc.sharpen, num_iterations=pc.num_iterations,
            band=pc.band, max_residual=pc.max_residual), iters=1, warmup=1)
    log(f"smoothing on one scene: kNN-96 graph {graph_s * 1e3:.1f} ms; "
        f"gather path ({pc.num_iterations} rounds) {gather_ms:.1f} ms; "
        f"banded path incl. graph + operator build {smooth_ms:.1f} ms")
    prof = profile_call(lambda: pipe.evaluate_scene(batch, n_valid_views=sp["V"]),
                        "profiled scene")
    steady = per_scene[1:] or per_scene
    return dict(scenes=per_scene, k1_launches=launches, peak_bytes=peak, profile=prof,
                seconds_per_scene_steady=sum(s["seconds"] for s in steady) / len(steady),
                graph_ms=graph_s * 1e3, gather_path_ms=gather_ms,
                banded_smoothing_ms=smooth_ms)


def profile_call(fn, label: str):
    """``fn`` once under torch.profiler: device kernels ranked by their own
    device time, and the device's busy share of the profiled wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages() if e.device_type == cuda),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    log(f"{label}: wall {wall_ms:.1f} ms (profiler on), device busy "
        f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}); top kernels by own time:")
    for name, ms, n in rows[:15]:
        log(f"  {ms:9.2f} ms  x{n:<5d} {name[:100]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, kernels=rows[:60])


# ---------------------------------------------------------------------------
# phase 4: card against CPU at the smoke sizes
# ---------------------------------------------------------------------------

def smoke_config(cfg_mod):
    """The bench's --smoke config, smoothing banded (band 128 < M=256) so
    that K1 runs on the card."""
    from geopurify_tpu_torch.run.bench import smoke_config as bench_smoke

    cfg = bench_smoke()
    return dataclasses.replace(cfg, pooling=dataclasses.replace(cfg.pooling, band=128))


def phase_small(cfg_mod, pipe_mod, batch_mod, band_mod):
    cfg = smoke_config(cfg_mod)
    text = text_embeddings(5, 16, seed=2)
    cpu = pipe_mod.GeoPurifyPipeline(cfg, text, 20.0, device="cpu")
    seed_small(cpu, 4)
    gpu = pipe_mod.GeoPurifyPipeline(cfg, text, 20.0, device="cuda",
                                     teacher_state=cpu.xdecoder.state_dict(),
                                     student_state=cpu.student.state_dict())
    sp = SMOKE_SPEC
    arrays = batch_mod.build_scene(7, sp["P"], sp["M"], sp["V"], sp["Pv"],
                                   tuple(cfg.xdecoder.mask_shape))
    # f32 on both sides: no TF32 in the card's convolutions and matmuls
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    n0 = band_mod.banded_window_matmul.launches
    try:
        out_c = cpu.evaluate_scene(batch_mod.SceneBatch.from_numpy(arrays))
        out_g = gpu.evaluate_scene(batch_mod.SceneBatch.from_numpy(arrays, "cuda"))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    assert band_mod.banded_window_matmul.launches - n0 == cfg.pooling.num_iterations
    pc, pg = out_c["pred"].numpy(), out_g["pred"].cpu().numpy()
    lc, lg = out_c["logits"].numpy(), out_g["logits"].cpu().numpy()
    flips = float(np.mean(pc != pg))
    scale = float(np.abs(lc).max())
    dmax = float(np.abs(lc - lg).max())
    log(f"small scene card vs CPU: pred flips {flips:.4f}, max|dlogit| "
        f"{dmax:.3e} of scale {scale:.2f}, band_overflow "
        f"{out_g['band_overflow']}/{out_c['band_overflow']}, "
        f"classes {np.bincount(pc, minlength=4).tolist()}")
    assert out_c["band_overflow"] == out_g["band_overflow"] == 0
    assert len(np.unique(pc)) > 1, "degenerate small scene: one class only"
    # bf16 smoothing rounds on both devices: predictions may flip only at
    # near-ties (bound 2% of points), logits within 2% of their scale
    assert flips <= 0.02 and dmax <= 2e-2 * scale
    return dict(flips=flips, max_abs_logit_diff=dmax, logit_scale=scale)


# ---------------------------------------------------------------------------
# phase 5: K2 against its plain versions
# ---------------------------------------------------------------------------

def k2_inputs(A: int, NEG: int, E: int, seed: int, p_valid: float):
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((A, E), generator=g, device="cuda")
    p = torch.randn((A, E), generator=g, device="cuda")
    n = torch.randn((A, NEG, E), generator=g, device="cuda")
    valid = torch.rand((A,), generator=g, device="cuda") < p_valid
    return a, p, n, valid


def k2_bound_ms(A: int, NEG: int, E: int, backward: bool):
    """``info_nce_work``'s bytes and operations, the latter at the f32 rate."""
    flops, bytes_ = info_nce_work(A, NEG, E, backward)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k2_library(a, p, n, valid, temperature: float):
    """The yardstick the port never calls: F.normalize, torch.bmm logits and
    F.cross_entropy, masked mean."""
    import torch.nn.functional as F

    an, pn, nn_ = (F.normalize(x, dim=-1, eps=1e-12) for x in (a, p, n))
    lp = (an * pn).sum(-1, keepdim=True)
    ln = torch.bmm(nn_, an[:, :, None])[..., 0]
    logits = torch.cat([lp, ln], 1) / temperature
    target = torch.zeros((a.shape[0],), dtype=torch.long, device=a.device)
    per = F.cross_entropy(logits, target, reduction="none")
    w = valid.to(per.dtype)
    return (per * w).sum() / w.sum().clamp(min=1.0)


def phase_k2(nce_mod, T=0.07):
    fwd, bwd = nce_mod.info_nce_fwd, nce_mod.info_nce_bwd
    checks = {}
    for (A, NEG, E, p_valid) in ((4096, 63, 128, 1.0), (512, 7, 16, 0.8)):
        a, p, n, valid = k2_inputs(A, NEG, E, seed=A + NEG, p_valid=p_valid)
        denom = valid.float().sum().clamp(min=1.0)
        per = fwd(a, p, n, valid, T)
        # an upstream gradient of order 1 (not the masked mean's 1/sum(valid)),
        # so that atol 1e-6 sits far below the gradients' own size
        g = torch.rand((A,), generator=torch.Generator(device="cuda").manual_seed(A),
                       device="cuda")
        da, dp, dn = bwd(a, p, n, valid, T, g)
        torch.cuda.synchronize()
        per_ref = nce_mod.per_anchor_loss_ref(a, p, n, valid, T)
        grads_ref = nce_mod.per_anchor_grads_ref(a, p, n, valid, T, g)
        loss, loss_ref = (per.sum() / denom).item(), (per_ref.sum() / denom).item()
        rel = abs(loss - loss_ref) / abs(loss_ref)
        fwd_err = (per - per_ref).abs().max().item()
        bwd_err = max((x - y).abs().max().item() for x, y in zip((da, dp, dn), grads_ref))
        grad_scale = min(y.abs().max().item() for y in grads_ref)
        log(f"K2 (A={A}, NEG={NEG}, E={E}, {int(valid.sum())} valid): loss {loss:.6f} "
            f"vs plain {loss_ref:.6f} (rel {rel:.2e}); max_abs_err per-anchor "
            f"{fwd_err:.2e}, gradients {bwd_err:.2e} (smallest max|grad| of da, dp, "
            f"dn {grad_scale:.2e})")
        assert rel <= 1e-5, f"K2 forward disagrees with its plain version (rel {rel})"
        # each anchor's loss too, so that errors cannot cancel in the mean
        torch.testing.assert_close(per, per_ref, rtol=1e-5,
                                   atol=1e-6 * per_ref.abs().max().item())
        # f32 sums over E and the negatives in another order than the plain
        # version's einsum / logsumexp: tests/test_pallas_infonce.py's bound
        for x, y in zip((da, dp, dn), grads_ref):
            torch.testing.assert_close(x, y, rtol=2e-4, atol=1e-6)
        checks[(A, NEG, E)] = dict(loss=loss, loss_rel=rel, fwd_err=fwd_err,
                                   bwd_err=bwd_err, grad_scale=grad_scale)
    xs = [x.clone().requires_grad_() for x in (a, p, n)]
    dead = nce_mod.info_nce_loss_fused(*xs, torch.zeros_like(valid), T)
    dead.backward()
    assert dead.item() == 0.0 and all(torch.count_nonzero(x.grad) == 0 for x in xs)
    log("K2 all-invalid: loss 0, gradients 0")

    # times at the path's shapes
    A, NEG, E = 4096, 63, 128
    a, p, n, valid = k2_inputs(A, NEG, E, seed=A + NEG, p_valid=1.0)
    g = torch.full((A,), 1.0 / A, device="cuda")
    rows = {}
    xs = [x.clone().requires_grad_() for x in (a, p, n)]
    lib_loss = k2_library(*xs, valid, T)
    for name, kernel, plain, library, backward in (
            ("info_nce_fwd", lambda: fwd(a, p, n, valid, T),
             lambda: nce_mod.per_anchor_loss_ref(a, p, n, valid, T),
             lambda: k2_library(a, p, n, valid, T), False),
            ("info_nce_bwd", lambda: bwd(a, p, n, valid, T, g),
             lambda: nce_mod.per_anchor_grads_ref(a, p, n, valid, T, g),
             lambda: torch.autograd.grad(lib_loss, xs, retain_graph=True), True)):
        kernel_ms = cuda_ms(kernel, iters=50)
        plain_ms = cuda_ms(plain, iters=10)
        library_ms = cuda_ms(library, iters=20)
        bound_ms, bound_by = k2_bound_ms(A, NEG, E, backward)
        err = checks[(A, NEG, E)]["bwd_err" if backward else "fwd_err"]
        rows[name] = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        log(f"{name}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bmm + cross_entropy {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}); {bound_ms / kernel_ms:.1%} of the bound")

    def fused_step():
        ys = [x.clone().requires_grad_() for x in (a, p, n)]
        nce_mod.info_nce_loss_fused(*ys, valid, T).backward()

    def library_step():
        ys = [x.clone().requires_grad_() for x in (a, p, n)]
        k2_library(*ys, valid, T).backward()

    fused_ms = cuda_ms(fused_step, iters=20)
    lib_step_ms = cuda_ms(library_step, iters=20)
    log(f"K2 loss forward + backward through autograd: fused {fused_ms:.4f} ms, "
        f"bmm + cross_entropy {lib_step_ms:.4f} ms")
    return dict(rows=rows, checks={str(k): v for k, v in checks.items()},
                fused_fwd_bwd_ms=fused_ms, library_fwd_bwd_ms=lib_step_ms)


# ---------------------------------------------------------------------------
# phase 6: the Stage-1 main path at full width
# ---------------------------------------------------------------------------

def seed_sonata(sonata, seed: int, device):
    """The JAX initialisers' scales from a seed: He normal for the sparse-conv
    kernels [K, Cin, Cout], LeCun normal for the Dense weights [out, in];
    biases 0 and norm scales 1 as built."""
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for p in sonata.parameters():
            if p.dim() == 3:
                std = (2.0 / (p.shape[0] * p.shape[1])) ** 0.5
            elif p.dim() == 2:
                std = (1.0 / p.shape[1]) ** 0.5
            else:
                continue
            p.copy_(torch.randn(p.shape, generator=g, device=device) * std)


def synced(fn):
    """(result, seconds) of ``fn`` on the host clock, the card synchronised."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def phase_stage1(mods, n_steps=5):
    cfg_mod, pipe_mod, batch_mod = mods["cfg"], mods["pipe"], mods["batch"]
    nce, train_mod = mods["nce"], mods["train"]
    cfg = cfg_mod.load_config("scannet", overrides=["contrastive.fused_loss=true"])
    cc = cfg.contrastive
    n_cls = len(cfg.data.all_label)
    text = text_embeddings(n_cls + 1, cfg.xdecoder.hidden_dim, seed=0)
    sonata = pipe_mod.build_sonata(cfg.sonata).to("cuda")
    seed_sonata(sonata, 3, "cuda")
    pipe = pipe_mod.GeoPurifyPipeline(cfg, text, 20.0, device="cuda",
                                      sonata_state=sonata.state_dict())
    del sonata
    seed_weights(pipe, 1, "cuda")
    mods["student"].init_student_(pipe.student, torch.Generator().manual_seed(2))
    sp = BENCH_SPEC
    arrays = batch_mod.build_scene(11, sp["P"], sp["M"], sp["V"], sp["Pv"],
                                   tuple(cfg.xdecoder.mask_shape))
    batch = batch_mod.SceneBatch.from_numpy(arrays, device="cuda")
    with torch.inference_mode():
        (f2d, _), lift_s = synced(lambda: pipe.lift_scene(batch, n_valid=sp["V"]))
    teacher_s = []
    for _ in range(2):
        ft, dt = synced(lambda: pipe.teacher_point_features(batch))
        teacher_s.append(dt)
    log(f"Stage-1 inputs: lift {lift_s:.3f} s; Sonata teacher (bf16, 5 stages, "
        f"{sum(p.numel() for p in pipe.sonata.parameters()) / 1e6:.1f} M parameters) "
        f"{teacher_s[0]:.3f} s first call, {teacher_s[1]:.3f} s second; "
        f"features {tuple(ft.shape)}")
    assert ft.shape == (sp["P"], pipe.sonata.out_channels) == (sp["P"], 1088)
    assert torch.isfinite(ft).all() and ft.abs().max() > 0

    optimizer, _ = mods["optim"].make_optimizer(cfg.train, pipe.student, steps_per_epoch=100)
    state = train_mod.TrainState(pipe.student, optimizer, 0,
                                 torch.Generator(device="cuda").manual_seed(5))
    step = train_mod.make_train_step(pipe)
    before = {k: v.detach().clone() for k, v in pipe.student.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    nce.info_nce_fwd.launches = nce.info_nce_bwd.launches = 0
    losses, step_s = [], []
    for _ in range(1 + n_steps):
        loss, dt = synced(lambda: step(state, batch, f2d, ft))
        losses.append(loss.item())
        step_s.append(dt)
    launches = (nce.info_nce_fwd.launches, nce.info_nce_bwd.launches)
    peak = torch.cuda.max_memory_allocated()
    s_per_step = sum(step_s[1:]) / n_steps
    log(f"Stage-1 steps: warm-up {step_s[0]:.3f} s, then {s_per_step:.3f} s/step "
        f"({', '.join(f'{t:.3f}' for t in step_s[1:])}); losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; K2 launches fwd {launches[0]} "
        f"bwd {launches[1]} over {1 + n_steps} steps; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    assert launches == (1 + n_steps, 1 + n_steps), launches
    assert all(np.isfinite(losses)), losses
    after = pipe.student.state_dict()
    for kind, names in (("parameter", [k for k, _ in pipe.student.named_parameters()]),
                        ("running statistic", [k for k, _ in pipe.student.named_buffers()])):
        same = [k for k in names if torch.equal(before[k], after[k])]
        assert not same, f"{kind}s unchanged by training: {same[:5]}"

    # the split, as bench.py --stage1 --profile-stages takes it
    gen = torch.Generator(device="cuda").manual_seed(6)
    sample = lambda: mods["ctr"].sample_contrastive_pairs_hybrid(  # noqa: E731
        gen, ft, batch.point_valid, coords=batch.points, num_anchors=cc.num_anchors,
        num_macro=cc.num_macro_negatives, num_micro=cc.num_micro_negatives,
        spatial_k=cc.spatial_knn_k, spatial_method=cc.spatial_method,
        spatial_radius=cc.spatial_radius)
    with torch.no_grad():
        pairs, _ = synced(sample)
        sampler_s = min(synced(sample)[1] for _ in range(3))
        knn_s = min(synced(lambda: mods["knn"].knn_anchors_grid(
            batch.points, batch.point_valid, pairs.anchor_idx, k=cc.spatial_knn_k,
            radius=cc.spatial_radius))[1] for _ in range(3))

    def fwd_bwd():
        state.optimizer.zero_grad()
        loss, _ = pipe.stage1_loss(None, batch, f2d, ft, train=True, pairs=pairs)
        loss.backward()

    fb_s = min(synced(fwd_bwd)[1] for _ in range(3))
    _, opt_s = synced(state.optimizer.step)
    glue_s = s_per_step - sampler_s - fb_s - opt_s
    log(f"Stage-1 split: sampler {sampler_s:.3f} s (spatial kNN {knn_s:.3f} s, "
        f"feature part {sampler_s - knn_s:.3f} s), student fwd+bwd {fb_s:.3f} s, "
        f"optimizer {opt_s:.3f} s, rest {glue_s:.3f} s")
    prof = profile_call(lambda: step(state, batch, f2d, ft), "profiled Stage-1 step")
    return dict(k2_launches=launches, steps=1 + n_steps, losses=losses, step_seconds=step_s,
                seconds_per_step=s_per_step, peak_bytes=peak, lift_seconds=lift_s,
                teacher_seconds=teacher_s, sampler_s=sampler_s, spatial_knn_s=knn_s,
                student_fwd_bwd_s=fb_s, optimizer_s=opt_s, rest_s=glue_s, profile=prof)


# ---------------------------------------------------------------------------
# phase 7: the training entry point
# ---------------------------------------------------------------------------

def phase_train_main(nce, train_mod):
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--synthetic", "--epochs", "1"]
        overrides = ["contrastive.fused_loss=true", "train.print_freq=1",
                     f"train.save_path={tmp}"]
        n0 = (nce.info_nce_fwd.launches, nce.info_nce_bwd.launches)
        state, first_s = synced(lambda: train_mod.main(
            common + ["--steps-per-epoch", "2"] + overrides))
        metrics = Path(tmp) / "metrics.jsonl"
        recs = [json.loads(x) for x in metrics.read_text().splitlines()]
        assert state.step == 2 and [r["step"] for r in recs] == [1, 2], recs
        assert (Path(tmp) / "ckpt" / "step_2.pt").exists()
        ckpt_mb = (Path(tmp) / "ckpt" / "step_2.pt").stat().st_size / 1e6
        resumed, resume_s = synced(lambda: train_mod.main(
            common + ["--steps-per-epoch", "1"] + overrides + [f"train.resume={tmp}/ckpt"]))
        assert resumed.step == 3 and (Path(tmp) / "ckpt" / "step_3.pt").exists()
        launches = (nce.info_nce_fwd.launches - n0[0], nce.info_nce_bwd.launches - n0[1])
        assert launches == (3, 3), launches
        recs = [json.loads(x) for x in metrics.read_text().splitlines()]
    log(f"run.train.main --synthetic (scannet): 2 steps + checkpoint ({ckpt_mb:.0f} MB) "
        f"in {first_s:.1f} s, resumed at step 2 -> 3 in {resume_s:.1f} s; losses "
        f"{[round(r['loss'], 5) for r in recs]}; K2 launches {launches}")
    assert all(np.isfinite(r["loss"]) for r in recs)
    return dict(first_s=first_s, resume_s=resume_s, checkpoint_mb=ckpt_mb,
                metrics=recs, k2_launches=launches)


# ---------------------------------------------------------------------------
# phase 8: Stage 1 on the card against the CPU at the tiny preset
# ---------------------------------------------------------------------------

def phase_stage1_small(mods):
    cfg = mods["cfg"].load_config("tiny", overrides=["contrastive.fused_loss=true"])
    nce = mods["nce"]
    text = text_embeddings(len(cfg.data.all_label) + 1, cfg.xdecoder.hidden_dim, seed=2)
    sonata = mods["pipe"].build_sonata(cfg.sonata)
    seed_sonata(sonata, 7, "cpu")
    cpu = mods["pipe"].GeoPurifyPipeline(cfg, text, 20.0, device="cpu",
                                         sonata_state=sonata.state_dict())
    mods["student"].init_student_(cpu.student, torch.Generator().manual_seed(6))
    gpu = mods["pipe"].GeoPurifyPipeline(cfg, text, 20.0, device="cuda",
                                         student_state=cpu.student.state_dict(),
                                         sonata_state=sonata.state_dict())
    make = mods["synth"].make_scene_batch
    bc, bg = (make(seed=3, n_points=1500, n_views=2, device=d) for d in ("cpu", "cuda"))
    P = bc.points.shape[0]
    f2d = torch.from_numpy(np.random.default_rng(8).normal(
        size=(P, cfg.pooling.feature_dim)).astype(np.float32))
    # f32 on both sides: no TF32 in the card's matmuls and convolutions
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ft_c = cpu.teacher_point_features(bc)
        ft_g = gpu.teacher_point_features(bg)
        ft_rel = ((ft_g.cpu() - ft_c).abs().max() / ft_c.abs().max()).item()
        with torch.no_grad():
            pairs = mods["ctr"].sample_contrastive_pairs_hybrid(
                torch.Generator().manual_seed(9), ft_c, bc.point_valid, coords=bc.points,
                num_anchors=cfg.contrastive.num_anchors,
                num_macro=cfg.contrastive.num_macro_negatives,
                num_micro=cfg.contrastive.num_micro_negatives,
                spatial_k=cfg.contrastive.spatial_knn_k)
        pairs_g = type(pairs)(*(x.cuda() for x in pairs))
        n0 = (nce.info_nce_fwd.launches, nce.info_nce_bwd.launches)
        loss_c, _ = cpu.stage1_loss(None, bc, f2d, ft_c.clone(), train=True, pairs=pairs)
        loss_c.backward()
        loss_g, _ = gpu.stage1_loss(None, bg, f2d.cuda(), ft_c.cuda(), train=True,
                                    pairs=pairs_g)
        loss_g.backward()
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    launches = (nce.info_nce_fwd.launches - n0[0], nce.info_nce_bwd.launches - n0[1])
    rel = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    grads_c = {k: p.grad for k, p in cpu.student.named_parameters()}
    top = max(g.abs().max().item() for g in grads_c.values())
    worst = 0.0
    for name, p in gpu.student.named_parameters():
        gc, gg = grads_c[name], p.grad.cpu()
        scale = gc.abs().max().item()
        if scale < 1e-5 * top:
            # a conv bias ahead of train-mode BatchNorm: 0 up to rounding
            assert gg.abs().max().item() < 1e-5 * top, name
            continue
        worst = max(worst, (gg - gc).abs().max().item() / scale)
    stats_err = max((b.cpu() - cpu.student.get_buffer(k)).abs().max().item()
                    for k, b in gpu.student.named_buffers())
    log(f"tiny Stage 1 card vs CPU: teacher features rel {ft_rel:.2e}; loss "
        f"{loss_g.item():.6f} vs {loss_c.item():.6f} (rel {rel:.2e}); worst gradient "
        f"rel {worst:.2e}; running stats max diff {stats_err:.2e}; K2 launches {launches}")
    assert launches == (1, 1), launches
    # f32 with TF32 off on both devices; sums in other orders, and the
    # embedding gathers' and sparse convs' backward scatter through
    # index_add_, atomically and in a changing order on the card
    assert ft_rel <= 1e-4 and rel <= 1e-5
    assert worst <= 1e-4 and stats_err <= 1e-5
    return dict(teacher_rel=ft_rel, loss_rel=rel, worst_grad_rel=worst,
                stats_max_diff=stats_err)


# ---------------------------------------------------------------------------
# phase 9: K1 at the preset-scale and wide shapes
# ---------------------------------------------------------------------------

# (M, band, C): the preset-scale paths' shapes (scannet logit space, the
# Matterport presets' 40, 80 and 160 classes, scannet200's 200, feature
# space's 512 channels as two column slabs of 256), then three widths at
# the bench spec
K1_SHAPES = ((1 << 18, 6144, 19), (1 << 18, 6144, 40), (1 << 18, 6144, 80),
             (1 << 18, 6144, 160), (1 << 18, 6144, 200), (1 << 18, 6144, 512),
             (65536, 12288, 64), (65536, 12288, 200), (65536, 12288, 512))
# the presets that smooth K1 at each class count (logit space), and the
# 512 channels of feature space at every preset
K1_PRESETS = {19: "scannet", 21: "matterport", 40: "matterport40", 80: "matterport80",
              160: "matterport160", 200: "scannet200", 512: "feature space (any preset)"}


def phase_k1_wide(band_mod):
    return {shape: k1_row(band_mod, *shape) for shape in K1_SHAPES}


# ---------------------------------------------------------------------------
# ScanNet-layout scenes on disk, rendered from their points
# ---------------------------------------------------------------------------

SCANNET_K = np.array([[1170.187988, 0.0, 647.75, 0.0], [0.0, 1170.187988, 483.75, 0.0],
                      [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]])


def room_points(batch_mod, seed: int, P: int, M: int):
    """``data.batch.build_scene``'s surface-like room (floor, two walls,
    object blobs; 2 cm voxels, P // M points each): points, colours in
    [-1, 1] (the OpenScene convention) and labels (wall 0, floor 1, blobs
    by region)."""
    a = batch_mod.build_scene(seed, P, M, 1, 1, (2, 2))
    vox = a["voxel_coords"]
    lab = 2 + (vox[:, 0] // 40 + vox[:, 1] // 40) % 17
    lab = np.where((vox[:, 0] < 3) | (vox[:, 1] < 3), 0, lab)
    lab = np.where(vox[:, 2] < 3, 1, lab)
    labels = lab[a["point2voxel"]].astype(np.int64)
    rng = np.random.default_rng(seed)
    palette = rng.uniform(-0.8, 0.8, (20, 3))
    colors = (palette[labels] + rng.normal(scale=0.1, size=(P, 3))).clip(-1, 1)
    return a["points"], colors.astype(np.float32), labels


def zbuffer(pts, w2c, K, W: int, H: int, splat: int, device):
    """Vectorised point-splat z-buffer: (depth [H, W] f64 with 0 where no
    point lands, flat pixel ids and depths of the nearest points, the
    points' ids)."""
    w2c_t = torch.as_tensor(w2c, dtype=torch.float64, device=device)
    p = pts @ w2c_t[:3, :3].T + w2c_t[:3, 3]
    z = p[:, 2]
    zs = z.clamp(min=1e-6)
    u = torch.round(p[:, 0] * K[0, 0] / zs + K[0, 2]).long()
    v = torch.round(p[:, 1] * K[1, 1] / zs + K[1, 2]).long()
    ids, pix, zz = [], [], []
    for dy in range(splat):
        for dx in range(splat):
            uu, vv = u + dx, v + dy
            ok = (z > 0.05) & (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
            ids.append(torch.nonzero(ok)[:, 0])
            pix.append(vv[ok] * W + uu[ok])
            zz.append(z[ok])
    ids, pix, zz = torch.cat(ids), torch.cat(pix), torch.cat(zz)
    depth = torch.full((H * W,), float("inf"), dtype=torch.float64, device=device)
    depth.scatter_reduce_(0, pix, zz, reduce="amin")
    front = zz <= depth[pix]
    depth = torch.where(torch.isinf(depth), 0.0, depth).reshape(H, W)
    return depth, pix[front], ids[front]


def write_scannet_scene(root: Path, sid: str, pts, colors, labels, n_views: int,
                        frame_stride: int, color_wh, depth_wh, device):
    """``<root>/3d/<sid>_vh_clean_2.pth`` (coords, colours in [-1, 1],
    labels) and ``<root>/2d/<sid>/{color,depth,pose,intrinsic}``: ``n_views``
    frames every ``frame_stride``-th pose (the frames between get a pose
    and no image), colour JPEGs at ``color_wh`` and uint16 millimetre depth
    PNGs at ``depth_wh``, both rendered from the points, cameras on a ring
    inside the room looking across it."""
    from PIL import Image

    from geopurify_tpu_torch.data.synthetic import _look_at

    torch.save((pts, colors, labels), root / "3d" / f"{sid}_vh_clean_2.pth")
    d = root / "2d" / sid
    for sub in ("color", "depth", "pose", "intrinsic"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    Wc, Hc = color_wh
    K = SCANNET_K.copy()
    K[0] *= Wc / 1296.0
    K[1] *= Hc / 968.0
    np.savetxt(d / "intrinsic" / "intrinsic_color.txt", K)
    Kd = K[:3, :3].copy()
    for ax, s_ in ((0, depth_wh[0] / Wc), (1, depth_wh[1] / Hc)):
        Kd[ax, ax] *= s_
        Kd[ax, 2] = (Kd[ax, 2] + 0.5) * s_ - 0.5
    pts_t = torch.from_numpy(pts).to(device, torch.float64)
    rgb_t = torch.from_numpy(((colors + 1) * 127.5).astype(np.uint8)).to(device)
    lo, hi = pts.min(0).astype(np.float64), pts.max(0).astype(np.float64)
    c, ext = (lo + hi) / 2, hi - lo
    for k in range(n_views):
        th = 2 * np.pi * k / n_views
        eye = np.array([c[0] + 0.3 * ext[0] * np.cos(th), c[1] + 0.3 * ext[1] * np.sin(th),
                        lo[2] + 0.4 * ext[2]])
        target = np.array([c[0] - 0.3 * ext[0] * np.cos(th + 0.7),
                           c[1] - 0.3 * ext[1] * np.sin(th + 0.7), lo[2]])
        w2c = _look_at(eye, target)
        pose = np.linalg.inv(w2c)
        for j in range(frame_stride):
            np.savetxt(d / "pose" / f"{k * frame_stride + j}.txt", pose)
        fid = k * frame_stride
        depth, _, _ = zbuffer(pts_t, w2c, Kd, depth_wh[0], depth_wh[1], 2, device)
        mm = torch.round(depth * 1000).clamp(0, 65535).to(torch.int32).cpu().numpy()
        Image.fromarray(mm.astype(np.uint16)).save(d / "depth" / f"{fid}.png")
        _, pix, ids = zbuffer(pts_t, w2c, K[:3, :3], Wc, Hc, 3, device)
        img = torch.full((Hc * Wc, 3), 128, dtype=torch.uint8, device=device)
        img[pix] = rgb_t[ids]
        Image.fromarray(img.reshape(Hc, Wc, 3).cpu().numpy()).save(
            d / "color" / f"{fid}.jpg", quality=90)


def write_dataset(root: Path, batch_mod, views, P: int, M: int, frame_stride: int,
                  color_wh, depth_wh, device, seed0: int):
    """One scene per entry of ``views`` (its view count), listed in order."""
    (root / "3d").mkdir(parents=True, exist_ok=True)
    sids = [f"scene{seed0 + i:04d}_00" for i in range(len(views))]
    for i, (sid, n_views) in enumerate(zip(sids, views)):
        pts, colors, labels = room_points(batch_mod, seed0 + i, P, M)
        write_scannet_scene(root, sid, pts, colors, labels, n_views, frame_stride,
                            color_wh, depth_wh, device)
    (root / "list.txt").write_text("\n".join(sids) + "\n")
    return sids


def dataset_overrides(root: Path):
    return [f"data.data_root={root / '3d'}", f"data.data_root_2d={root / '2d'}",
            f"data.eval_scene_list={root / 'list.txt'}", f"train.save_path={root / 'run'}"]


class Instrument:
    """Per-scene records of ``run.validate.main``'s own path, taken from the
    outside: the loader's ``make_scene_batch`` (host load time, the batch's
    sizes), ``GeoPurifyPipeline.evaluate_scene`` (run with ``profile=True``
    for the stage split; K1 launches, band overflow, peak device memory,
    view coverage and the classes predicted) and the smoothing's kNN
    (synchronised timer). ``build_pipeline`` gives the X-Decoder
    ``seed_released``'s weights (the entry point's stand-in is all zeros, which would
    send zeros through the lift and the smoothing), or those of ``seed``
    (None: an ``xdecoder.ckpt`` run keeps the converted weights). Each
    scene's per-point predictions and logits are kept on the host in
    ``preds``. Restores everything on exit."""

    def __init__(self, mods, seed=seed_released, capture=False):
        self.mods, self.scenes, self.preds, self._undo = mods, [], [], []
        self.build_s = None
        self.seed = seed
        # ``capture``: the first scene's voxels, points and seen voxels, on
        # the host, for phase 14
        self.scene0 = {} if capture else None

    def _patch(self, owner, name, fn):
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, fn)

    def __enter__(self):
        loaders, pipe, pool, band, train, lift, knn, sc = (
            self.mods[k] for k in ("loaders", "pipe", "pool", "band", "train", "lift",
                                   "knn", "sc"))
        load, evaluate, search_full, fill_grid, build = (
            loaders.SceneDataset.make_scene_batch, pipe.GeoPurifyPipeline.evaluate_scene,
            pool.knn_search, lift.nearest_fill_grid, train.build_pipeline)
        rec = self

        def keep(**tensors):
            if rec.scene0 is not None and len(rec.scenes) == 1:
                rec.scene0.update({n: t.cpu() for n, t in tensors.items()
                                   if n not in rec.scene0})

        def build_pipeline(*a, **k):
            t = time.perf_counter()
            built = build(*a, **k)
            if rec.seed is not None:
                rec.seed(built, 1, "cuda")      # main then seeds the student itself
            torch.cuda.synchronize()
            rec.build_s = time.perf_counter() - t
            return built

        def make_scene_batch(ds, sid, *a, **k):
            t = time.perf_counter()
            batch = load(ds, sid, *a, **k)
            torch.cuda.synchronize()
            rec.scenes.append(dict(sid=sid, load_s=time.perf_counter() - t, knn_s=[],
                                   P=batch.points.shape[0], M=batch.voxel_coords.shape[0],
                                   V=batch.images.shape[0], Pv=batch.view_point_ids.shape[1],
                                   views=int(batch.view_valid.sum()),
                                   points=int(batch.point_valid.sum()),
                                   voxels=int(batch.voxel_valid.sum()), fill_s=[]))
            keep(points=batch.points, point_valid=batch.point_valid)
            return batch

        def evaluate_scene(self_, batch, *a, **k):
            torch.cuda.reset_peak_memory_stats()
            n0 = band.banded_window_matmul.launches
            z0 = dict(sc.ZSTACK_ROUTES)
            t = time.perf_counter()
            out = evaluate(self_, batch, *a, **{**k, "profile": True})
            torch.cuda.synchronize()
            r = rec.scenes[-1]
            valid = batch.point_valid
            r.update(seconds=time.perf_counter() - t, stages=out["stage_seconds"],
                     k1_launches=band.banded_window_matmul.launches - n0,
                     zstack_routes={n: c - z0[n] for n, c in sc.ZSTACK_ROUTES.items()},
                     band_overflow=int(out["band_overflow"]),
                     peak_bytes=torch.cuda.max_memory_allocated(),
                     finite=bool(torch.isfinite(out["logits"]).all()),
                     classes=int(out["logits"].shape[1]),
                     covered=float((out["view_count"][valid] > 0).float().mean()),
                     predicted=int(torch.unique(out["pred"][valid]).numel()))
            rec.preds.append((out["pred"].cpu(), out["logits"].cpu()))
            return out

        # the smoothing's kNN, whichever route build_affinity_graph takes:
        # the grid route through its private form, which also gives the
        # certificate's counts
        def knn_self_grid(coords, valid, k, radius=12, num_candidates=4096):
            (d, i, st), dt = synced(lambda: knn._knn_self_grid(coords, valid, k, radius,
                                                               num_candidates))
            rec.scenes[-1]["knn_s"].append(dt)
            rec.scenes[-1]["knn_stats"] = st
            keep(voxel_coords=coords, voxel_valid=valid)
            return d, i

        def knn_search(*a, **k):
            res, dt = synced(lambda: search_full(*a, **k))
            rec.scenes[-1]["knn_s"].append(dt)
            return res

        def nearest_fill_grid(features, coords, has_value, valid, **k):
            res, dt = synced(lambda: fill_grid(features, coords, has_value, valid, **k))
            rec.scenes[-1]["fill_s"].append(dt)
            keep(fill_has=has_value)
            return res

        self._patch(loaders.SceneDataset, "make_scene_batch", make_scene_batch)
        self._patch(pipe.GeoPurifyPipeline, "evaluate_scene", evaluate_scene)
        self._patch(pool, "knn_self_grid", knn_self_grid)
        self._patch(pool, "knn_search", knn_search)
        self._patch(lift, "nearest_fill_grid", nearest_fill_grid)
        self._patch(train, "build_pipeline", build_pipeline)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)


# ---------------------------------------------------------------------------
# phase 10: Stage-2 validation at preset scale through run.validate.main
# ---------------------------------------------------------------------------

PRESET_OVERRIDES = ["pooling.band=6144", "pooling.max_residual=2097152"]


def run_validate(mods, preset: str, root: Path, n_scenes: int, min_views: int,
                 extra=(), seed=seed_released, capture=False):
    """``run.validate.main`` on the card over the first ``n_scenes`` of
    ``root``; the K1 count is set to 0 just before and read just after.
    ``capture``: the record's ``scene0`` holds the first scene's voxels,
    points and seen voxels (phase 14's inputs)."""
    band = mods["band"]
    overrides = PRESET_OVERRIDES + list(extra)
    cfg = mods["cfg"].load_config(preset, overrides=overrides)
    args = ["--preset", preset, "--max-scenes", str(n_scenes)] + overrides + \
        dataset_overrides(root)
    band.banded_window_matmul.launches = 0
    with Instrument(mods, seed, capture) as ins:
        t = time.perf_counter()
        result = mods["validate"].main(args)
        wall = time.perf_counter() - t
    launches = band.banded_window_matmul.launches
    n_cls = len(cfg.data.all_label)
    for i, r in enumerate(ins.scenes):
        st, ks = r["stages"], r["knn_stats"]
        log(f"{preset} {' '.join(extra)} scene {i} ({r['sid']}): load {r['load_s']:.2f} s (P={r['P']}, "
            f"{r['points']} points, M={r['M']}, {r['voxels']} voxels, {r['views']} of "
            f"V={r['V']} views, Pv={r['Pv']}); evaluate {r['seconds']:.2f} s = views "
            f"{st['views']:.2f} + fuse_fill {st['fuse_fill']:.2f} (donor fill "
            f"{sum(r['fill_s']):.3f}) + pool_classify {st['pool_classify']:.2f} (grid kNN "
            f"{sum(r['knn_s']):.3f}, {ks['failed']} of {ks['queries']} queries recomputed, "
            f"{ks['overflow_tiles']} of {ks['tiles']} tiles over budget); student 3^3 convs "
            f"{r['zstack_routes']}; K1 launches "
            f"{r['k1_launches']}, band_overflow {r['band_overflow']}, peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB; {r['covered']:.1%} of the points seen, "
            f"{r['predicted']} classes predicted")
        assert (r["P"], r["M"], r["Pv"]) == (1 << 20, 1 << 18, 1 << 16), r
        assert r["views"] >= min_views and r["V"] >= r["views"], r
        assert r["voxels"] > (1 << 17) and r["points"] > (1 << 19), r
        assert r["band_overflow"] == 0, "banded operator overflowed"
        assert r["k1_launches"] == cfg.pooling.num_iterations, r["k1_launches"]
        assert r["finite"] and r["classes"] == n_cls, r
        assert r["predicted"] > 1, "one class predicted: the seeded weights say nothing"
        # the preset path: the grid kNN, the donor fill at voxel resolution
        # and the z-stack gate (M >= student.zstack_min_voxels), the
        # overflow route counted with the z-stacked one
        assert len(r["knn_s"]) == 1 and len(r["fill_s"]) == 1, r
        assert sum(r["zstack_routes"].values()) == 1 + 2 * cfg.student.num_res_blocks, r
    log(f"{preset} {' '.join(extra)}: run.validate.main over {len(ins.scenes)} scenes in {wall:.1f} s; "
        f"K1 launches {launches}; result {json.dumps(result)[:400]}")
    assert len(ins.scenes) == n_scenes and launches == n_scenes * cfg.pooling.num_iterations
    groups = result["summary"]
    assert set(groups) >= {"all", "base", "novel", "foreground"}
    assert all(np.isfinite(v) for g in groups.values() for v in g.values())
    assert len(result["per_class_iou"]) == cfg.data.test_classes
    assert result["scenes_per_sec"] > 0
    return dict(scenes=ins.scenes, k1_launches=launches, wall_s=wall, result=result,
                preds=ins.preds, build_s=ins.build_s, scene0=ins.scene0)


def phase_preset_validation(mods, root: Path, views=(36, 140)):
    """Two scenes (36 views: the V=64 bucket; 140 views: V=256) written under
    ``root`` (phase 13 reads them again) through ``scannet``, then the first
    at ``scannet200`` and in feature space."""
    t = time.perf_counter()
    write_dataset(root, mods["batch"], views, 1 << 20, 1 << 18, frame_stride=20,
                  color_wh=(1296, 968), depth_wh=(640, 480), device="cuda", seed0=21)
    write_s = time.perf_counter() - t
    log(f"wrote {len(views)} ScanNet-layout scenes ({views} views) in {write_s:.1f} s")
    scannet = run_validate(mods, "scannet", root, len(views), min_views=32, capture=True)
    assert [r["V"] for r in scannet["scenes"]] == [64, 256], scannet["scenes"]
    scannet200 = run_validate(mods, "scannet200", root, 1, min_views=32)
    feature = run_validate(mods, "scannet", root, 1, min_views=32,
                           extra=["pooling.smooth_space=feature"])
    scene0 = scannet["scene0"]
    for rec in (scannet, scannet200, feature):
        del rec["preds"], rec["scene0"]
    return dict(write_s=write_s, scannet=scannet, scannet200=scannet200,
                feature=feature), scene0


# ---------------------------------------------------------------------------
# phase 11: the validation path on the card against the CPU (tiny preset)
# ---------------------------------------------------------------------------

def tiny_validation_pair(mods, root: Path):
    """The tiny preset over ``root``, padded to P = 2^19 points so that
    ``lift_scene`` takes the voxel-resolution fill, with a band below the
    voxel bucket so that the smoothing runs K1 (its plain version on the
    CPU); the same seeded weights on the CPU and on the card. The fixture's
    ~480 voxels fill most of the 512-voxel bucket, so the 384-row window
    holds most of the graph's edges and K1 carries most of every round (a
    bucket far above the voxels puts the window on padding rows, and K1
    then adds zeros)."""
    cfg = mods["cfg"].load_config("tiny", overrides=dataset_overrides(root) + [
        "data.max_points=524288", "data.max_views=4", "data.max_voxels=512",
        "pooling.band=384"])
    # seeds under which all four classes win on the CPU, no point within
    # 0.39% of the logit scale of a tie (9 of the fixture's 3000 valid
    # points within 1%)
    text = text_embeddings(len(cfg.data.all_label) + 1, cfg.xdecoder.hidden_dim, seed=6)
    cpu = mods["pipe"].GeoPurifyPipeline(cfg, text, 20.0, device="cpu")
    seed_small(cpu, 13)
    gpu = mods["pipe"].GeoPurifyPipeline(cfg, text, 20.0, device="cuda",
                                         teacher_state=cpu.xdecoder.state_dict(),
                                         student_state=cpu.student.state_dict())
    return cfg, cpu, gpu


class Preds:
    """Pass-through pipeline that keeps each scene's predictions, logits and
    view counts on the host."""

    def __init__(self, pipeline):
        self.pipeline, self.out = pipeline, []

    def evaluate_scene(self, batch):
        out = self.pipeline.evaluate_scene(batch)
        self.out.append((out["pred"].cpu().numpy(), out["logits"].float().cpu().numpy(),
                         out["view_count"].cpu().numpy(), batch.point_valid.cpu().numpy()))
        return out


def phase_validation_small(mods, n_scenes=2):
    loaders, validate = mods["loaders"], mods["validate"]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_dataset(root, mods["batch"], (6,) * n_scenes, 1500, 500, frame_stride=1,
                      color_wh=(128, 96), depth_wh=(64, 48), device="cpu", seed0=3)
        cfg, cpu, gpu = tiny_validation_pair(mods, root)
        dc = loaders.SceneDataset(cfg, split="val", device="cpu")
        dg = loaders.SceneDataset(cfg, split="val", device="cuda")
        batches_c = [b for _, b in dc.iter_scenes()]
        batches_g = [b for _, b in dg.iter_scenes()]
        for bc, bg in zip(batches_c, batches_g):
            for f in dataclasses.fields(bc):
                assert torch.equal(getattr(bc, f.name), getattr(bg, f.name).cpu()), f.name
        prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        n0 = mods["band"].banded_window_matmul.launches
        try:
            pc, pg = Preds(cpu), Preds(gpu)
            mc, _ = validate.evaluate_scenes(pc, iter(batches_c), cfg)
            mg, _ = validate.evaluate_scenes(pg, iter(batches_g), cfg)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    n_k1 = mods["band"].banded_window_matmul.launches - n0
    flips = total = unseen = 0
    classes, dmax, scale, margins = set(), 0.0, 0.0, []
    for (pred_c, lc, count_c, valid), (pred_g, lg, count_g, _) in zip(pc.out, pg.out):
        assert pred_c.shape == (1 << 19,)
        np.testing.assert_array_equal(count_c, count_g)
        flips += int((pred_c != pred_g)[valid].sum())
        total += int(valid.sum())
        unseen += int(((count_c == 0) & valid).sum())
        classes |= set(np.unique(pred_c[valid]).tolist())
        dmax = max(dmax, float(np.abs(lc - lg)[valid].max()))
        scale = max(scale, float(np.abs(lc[valid]).max()))
        top2 = np.sort(lc[valid], axis=1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
    # a point can flip only where the CPU's top-two margin is under twice
    # the largest logit change
    near = int((np.concatenate(margins) <= 2 * dmax).sum())
    hist_diff = max(np.abs(a - b).max() for a, b in (
        (mc.intersection, mg.intersection), (mc.union, mg.union), (mc.target, mg.target)))
    log(f"tiny validation card vs CPU (P=2^19, voxel fill; {total} points, {unseen} "
        f"unseen): pred flips {flips}/{total}, max|dlogit| {dmax:.3e} of scale "
        f"{scale:.3f}, {near} points within 2 max|dlogit| of a tie, max histogram "
        f"diff {hist_diff}, classes {sorted(classes)}, K1 launches on the card {n_k1}")
    np.testing.assert_array_equal(mc.target, mg.target)
    # f32 on both devices with TF32 off, the smoothing in bf16 on both: the
    # logits within 1% of their scale (phase 4 measures 0.3%), predictions
    # flipped only at near-ties and at most 9 points (the fixture's voxels
    # hold 3 points each: three voxels); each flip moves a histogram count
    # by at most 1
    assert dmax <= 1e-2 * scale, (dmax, scale)
    assert flips <= min(near, 9) and hist_diff <= flips
    assert unseen > 0 and len(classes) == len(cfg.data.all_label), classes
    assert n_k1 == n_scenes * cfg.pooling.num_iterations, n_k1
    return dict(flips=flips, points=total, near_ties=near, max_abs_logit_diff=dmax,
                logit_scale=scale, hist_diff=float(hist_diff), classes=sorted(classes))


# ---------------------------------------------------------------------------
# phase 12: released-layout checkpoints in, on-disk scenes through both stages
# ---------------------------------------------------------------------------

# the cache and fused-feature modes' cut: P = M = 2^16 points a scene (the
# preset keeps 2^20 in 2^18 voxels). A cache entry holds P x (512 + 1088)
# f32 values, 0.42 GB at 2^16 (6.7 GB at 2^20), deflated as the JAX
# package writes it, which takes most of the precompute's time; M >= P
# keeps every sampled point, so the fused files' rows align with the batch
# (the loader's voxel budget would drop points otherwise)
FROZEN_SIZES = ["data.max_points=65536", "data.max_voxels=65536"]
# the synthetic room's 2^20 points put far more than the train split's
# 65000 visible points (the reference's cap) into every rendered view
TRAIN_VIEWS = ["fusion.max_visible_points=1048576"]


class deterministic:
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` inside
    the block: the voxel means' ``index_add_`` sums in a fixed order, so two
    runs on the same weights can be compared bit for bit."""

    def __enter__(self):
        self.prev = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled())
        torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(self.prev[0], warn_only=self.prev[1])


def save_reference(path: Path, sd) -> float:
    """``torch.save`` of a reference-layout state dict (numpy -> tensors);
    returns its size in MB."""
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    return path.stat().st_size / 1e6


def released_xdecoder(mods, root: Path):
    """The full-width ``scannet`` X-Decoder with ``seed_released``'s weights
    and the language tower ``build_pipeline`` initialises without a
    checkpoint, written out in the reference layout
    (``xdecoder_focall_last.pt``); returns its path, its MB and the logit
    scale the converter gives it."""
    cfg = mods["cfg"].load_config("scannet")
    t = cfg.text
    lang = mods["lang"].LanguageEncoder(t.vocab_size, t.width, t.layers, t.heads,
                                        t.context_length, t.dim_proj)
    mods["lang"].init_language_(lang, torch.Generator().manual_seed(cfg.train.manual_seed))
    xdec = mods["xdec"].XDecoderSegModel(cfg.xdecoder).to("cuda")
    seed_released(type("Teacher", (), dict(xdecoder=xdec))(), 1, "cuda")
    path = root / "xdecoder_focall_last.pt"
    t0 = time.perf_counter()
    mb = save_reference(path, mods["convx"].synthesize_torch_state_dict(xdec, lang))
    n = sum(p.numel() for p in xdec.parameters()) + sum(p.numel() for p in lang.parameters())
    log(f"reference-layout X-Decoder + language tower: {n / 1e6:.1f} M parameters, "
        f"{mb:.0f} MB written in {time.perf_counter() - t0:.1f} s")
    # the converter's logit scale: numpy's exp of the tower's f32 parameter
    return path, mb, float(np.exp(lang.logit_scale.detach().numpy()))


def released_sonata(mods, root: Path, batch):
    """The full-width Sonata (``sonata.norm=ln``) seeded as in phase 6, out to
    the release layout (spconv >= 2 kernels) and back through
    ``sonata.ckpt``: the teacher's features on ``batch`` must be bit-equal
    to those of the teacher loaded directly."""
    cfg = mods["cfg"].load_config("scannet")
    assert cfg.sonata.norm == "ln"
    sonata = mods["pipe"].build_sonata(cfg.sonata).to("cuda")
    seed_sonata(sonata, 3, "cuda")
    path = root / "sonata.pth"
    mb = save_reference(path, mods["convs"].export_sonata_state_dict(sonata))
    text = text_embeddings(len(cfg.data.all_label) + 1, cfg.xdecoder.hidden_dim, seed=0)
    direct = mods["pipe"].GeoPurifyPipeline(cfg, text, 20.0, device="cuda",
                                            sonata_state=sonata.state_dict())
    del sonata
    ccfg = mods["cfg"].load_config("scannet", overrides=[f"sonata.ckpt={path}"])
    conv, conv_s = synced(lambda: mods["train"].build_pipeline(
        ccfg, torch.Generator().manual_seed(0), "cuda"))
    same_params = all(torch.equal(a, b) for a, b in zip(
        direct.sonata.state_dict().values(), conv.sonata.state_dict().values()))
    with deterministic():
        ft_d, direct_s = synced(lambda: direct.teacher_point_features(batch))
        ft_c, ckpt_s = synced(lambda: conv.teacher_point_features(batch))
    equal = torch.equal(ft_d, ft_c)
    log(f"Sonata through sonata.ckpt ({mb:.0f} MB, build_pipeline {conv_s:.1f} s): "
        f"parameters bit-equal {same_params}; teacher features {tuple(ft_c.shape)} "
        f"bit-equal {equal} (max |diff| {(ft_d - ft_c).abs().max().item():.3e}); "
        f"{direct_s:.2f} s direct, {ckpt_s:.2f} s converted")
    assert same_params and equal
    assert torch.isfinite(ft_c).all() and ft_c.abs().max() > 0
    return path, dict(mb=mb, build_s=conv_s, features_bit_equal=equal,
                      direct_s=direct_s, converted_s=ckpt_s)


class timed_precompute:
    """Times ``precompute_scene`` (the lift and the teacher, to host arrays)
    and the compressed write of each scene of ``run.precompute.main``."""

    def __init__(self, mod):
        self.mod, self.compute, self.write = mod, [], []
        self.scene, self.save = mod.precompute_scene, mod.np.savez_compressed

        def scene(*a, **k):
            out, dt = synced(lambda: self.scene(*a, **k))
            self.compute.append(dt)
            return out

        def save(*a, **k):
            t = time.perf_counter()
            self.save(*a, **k)
            self.write.append(time.perf_counter() - t)

        mod.precompute_scene, mod.np.savez_compressed = scene, save

    def undo(self):
        self.mod.precompute_scene, self.mod.np.savez_compressed = self.scene, self.save


def write_fused_features(mods, root: Path, cache: Path, out: Path, sids, P: int) -> float:
    """One ``<sid>.pt`` per scene in the reference layout, from the cached
    ``f2d``: ``feat`` over the sampled points, ``mask_full`` over all of the
    scene's points; returns MB a scene."""
    out.mkdir()
    sizes = []
    for sid in sids:
        n_all = len(mods["loaders"].load_scene_any(str(root / "3d" / f"{sid}_vh_clean_2.pth")).xyz)
        keep = mods["loaders"].deterministic_keep(sid, n_all, P)
        with np.load(cache / f"{sid}.npz") as data:
            valid = data["point_valid"]
            feat = data["f2d"][: int(valid.sum())]
        assert len(feat) == len(keep) and valid[: len(keep)].all()
        mask = np.zeros(n_all, bool)
        mask[keep] = True
        torch.save({"feat": torch.from_numpy(np.ascontiguousarray(feat)),
                    "mask_full": torch.from_numpy(mask)}, out / f"{sid}.pt")
        sizes.append((out / f"{sid}.pt").stat().st_size / 1e6)
    return float(np.mean(sizes))


def run_train_mode(mods, label: str, args, steps: int):
    """``run.train.main`` with ``args``; the K2 counts are set to 0 just
    before and read just after. Records each step's host seconds (inputs,
    train step) and the stage split of the metrics record."""
    train_mod, nce = mods["train"], mods["nce"]
    inputs_call, make_step = train_mod.StepInputs.__call__, train_mod.make_train_step
    times = []

    def timed_inputs(self, it):
        out, dt = synced(lambda: inputs_call(self, it))
        times.append(dict(inputs_s=dt, usable=out is not None))
        return out

    def timed_make_step(pipeline, *a):
        step = make_step(pipeline, *a)

        def run(*a):
            loss, dt = synced(lambda: step(*a))
            times[-1]["step_s"] = dt
            return loss
        return run

    train_mod.StepInputs.__call__ = timed_inputs
    train_mod.make_train_step = timed_make_step
    torch.cuda.reset_peak_memory_stats()
    nce.info_nce_fwd.launches = nce.info_nce_bwd.launches = 0
    try:
        state, wall = synced(lambda: train_mod.main(args))
    finally:
        train_mod.StepInputs.__call__ = inputs_call
        train_mod.make_train_step = make_step
    launches = (nce.info_nce_fwd.launches, nce.info_nce_bwd.launches)
    peak = torch.cuda.max_memory_allocated()
    save = Path([a.split("=", 1)[1] for a in args if a.startswith("train.save_path=")][-1])
    recs = [json.loads(x) for x in (save / "metrics.jsonl").read_text().splitlines()]
    stages = recs[-1]["stages"]
    per = [t["inputs_s"] + t["step_s"] for t in times]
    split = ", ".join("%.2f + %.2f" % (t["inputs_s"], t["step_s"]) for t in times)
    log(f"{label}: {state.step} steps in {wall:.1f} s (startup included); per step "
        f"inputs + train step {split} s; stages {json.dumps(stages)}; losses "
        f"{[round(r['loss'], 5) for r in recs]}; K2 launches {launches}; peak "
        f"{peak / 2**30:.2f} GiB")
    assert state.step == steps and len(times) == steps and all(t["usable"] for t in times)
    assert launches == (steps, steps), launches
    assert all(np.isfinite(r["loss"]) for r in recs) and len(recs) == steps
    assert (save / "ckpt" / f"step_{steps}.pt").exists()
    return dict(steps=steps, wall_s=wall, step_seconds=per, first_step_s=per[0],
                later_steps_s=float(np.mean(per[1:])), inputs_s=[t["inputs_s"] for t in times],
                train_step_s=[t["step_s"] for t in times], stages=stages,
                losses=[r["loss"] for r in recs], k2_launches=launches, peak_bytes=peak)


def phase_released(mods, views=(36, 36)):
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t = time.perf_counter()
        sids = write_dataset(root, mods["batch"], views, 1 << 20, 1 << 18, frame_stride=20,
                             color_wh=(1296, 968), depth_wh=(640, 480), device="cuda",
                             seed0=41)
        write_s = time.perf_counter() - t
        log(f"wrote {len(views)} ScanNet-layout scenes ({views} views) in {write_s:.1f} s")
        data = dataset_overrides(root) + [f"data.train_scene_list={root / 'list.txt'}"]

        # 1. Stage 2 through xdecoder.ckpt against the same weights loaded directly
        xpath, x_mb, x_scale = released_xdecoder(mods, root)
        with deterministic():
            direct = run_validate(mods, "scannet", root, 1, min_views=32,
                                  seed=seed_at_scale(x_scale))
            conv = run_validate(mods, "scannet", root, 1, min_views=32,
                                extra=[f"xdecoder.ckpt={xpath}"], seed=None)
        (pc, lc), (pd, ld) = conv.pop("preds")[0], direct.pop("preds")[0]
        flips = int((pc != pd).sum())
        diff, scale = (lc - ld).abs().max().item(), ld.abs().max().item()
        miou = (conv["result"]["summary"]["all"]["mIoU"],
                direct["result"]["summary"]["all"]["mIoU"])
        log(f"xdecoder.ckpt ({x_mb:.0f} MB) against the weights loaded directly: "
            f"{flips} of {pc.numel()} predictions differ ({torch.unique(pc).numel()} "
            f"classes predicted), logits max |diff| {diff:.3e} of scale {scale:.4f}; "
            f"mIoU {miou[0]} vs "
            f"{miou[1]}; run.validate.main {conv['wall_s']:.1f} s vs "
            f"{direct['wall_s']:.1f} s (the first of the process; build_pipeline "
            f"{conv['build_s']:.1f} s vs {direct['build_s']:.1f} s, evaluate "
            f"{conv['scenes'][0]['seconds']:.2f} s vs {direct['scenes'][0]['seconds']:.2f} s); "
            f"K1 launches {conv['k1_launches']} and {direct['k1_launches']}")
        assert flips == 0 and diff == 0 and scale > 0 and miou[0] == miou[1]
        assert conv["k1_launches"] == direct["k1_launches"] == 19

        # 2. the Sonata teacher through sonata.ckpt
        cfg = mods["cfg"].load_config("scannet", overrides=data + TRAIN_VIEWS)
        ds = mods["loaders"].SceneDataset(cfg, split="train", augment=False, device="cuda")
        batch = ds.make_scene_batch(sids[0])
        assert batch is not None and batch.points.shape[0] == 1 << 20
        spath, sonata = released_sonata(mods, root, batch)
        del batch, ds
        torch.cuda.empty_cache()

        # 3. precompute the teacher cache and fused files at the cut sizes
        # (argparse takes the flags first, then the overrides)
        ckpts = [f"xdecoder.ckpt={xpath}", f"sonata.ckpt={spath}"]
        cache = root / "cache"
        data += TRAIN_VIEWS
        torch.cuda.reset_peak_memory_stats()
        pre_split = timed_precompute(mods["precompute"])
        pre, pre_wall = synced(lambda: mods["precompute"].main(
            ["--preset", "scannet", "--out", str(cache)] + data + FROZEN_SIZES + ckpts))
        pre_split.undo()
        pre_peak = torch.cuda.max_memory_allocated()
        cache_mb = float(np.mean([(cache / f"{s}.npz").stat().st_size / 1e6 for s in sids]))
        with np.load(cache / f"{sids[0]}.npz") as d0:
            shapes = {k: (d0[k].shape, str(d0[k].dtype)) for k in d0.files}
        assert sorted(pre) == sorted(sids)
        assert shapes == {"f2d": ((65536, 512), "float32"),
                          "f_teacher": ((65536, 1088), "float32"),
                          "point_valid": ((65536,), "bool")}, shapes
        fused_mb = write_fused_features(mods, root, cache, root / "fused", sids, 65536)
        split = ", ".join("%.1f + %.1f" % (c, w) for c, w in zip(pre_split.compute,
                                                                pre_split.write))
        log(f"run.precompute.main: {len(pre)} scenes in {pre_wall:.1f} s (startup included), "
            f"{', '.join(f'{v:.1f}' for v in pre.values())} s a scene = lift and teacher + "
            f"np.savez_compressed {split} s; {cache_mb:.0f} MB a cache file {shapes}; "
            f"fused file {fused_mb:.0f} MB; peak {pre_peak / 2**30:.2f} GiB")

        # 4. Stage 1 in the three real-data modes
        modes = {}
        for label, flags, steps, overrides in (
                ("teacher cache", ["--teacher-cache", str(cache)], 3, FROZEN_SIZES),
                ("fused features", ["--fused-features", str(root / "fused"),
                                    "--teacher-cache", str(cache)], 2, FROZEN_SIZES),
                ("live", [], 2, ckpts)):
            args = (["--preset", "scannet", "--epochs", "1", "--steps-per-epoch", str(steps)]
                    + flags + data + overrides
                    + ["contrastive.fused_loss=true", "train.print_freq=1",
                       f"train.save_path={root / label.replace(' ', '_')}"])
            modes[label] = run_train_mode(mods, f"run.train.main {label}", args, steps)
        for label in ("teacher cache", "fused features"):
            assert "lift_2d" not in modes[label]["stages"], modes[label]["stages"]
        assert {"lift_2d", "teacher_3d"} <= set(modes["live"]["stages"])
        # the fused files hold the cached f2d row for row, and both modes read
        # the cached teacher: the same scenes give the same losses
        np.testing.assert_allclose(modes["fused features"]["losses"],
                                   modes["teacher cache"]["losses"][:2], rtol=1e-4)
    return dict(write_s=write_s, xdecoder_mb=x_mb, validate_converted=conv,
                validate_direct=direct, prediction_flips=flips, logits_diff=diff,
                logits_scale=scale,
                miou=miou, sonata=sonata,
                precompute_s=pre, precompute_wall_s=pre_wall, precompute_peak_bytes=pre_peak,
                precompute_compute_s=pre_split.compute, precompute_write_s=pre_split.write,
                cache_mb=cache_mb, fused_mb=fused_mb, modes=modes,
                k1_launches=conv["k1_launches"] + direct["k1_launches"],
                k2_launches=tuple(sum(m["k2_launches"][i] for m in modes.values())
                                  for i in (0, 1)))


# ---------------------------------------------------------------------------
# phase 13: the parallel layer on the card
# ---------------------------------------------------------------------------

def dp_tiny_card_vs_cpu(mods, mesh, dev):
    """One data-parallel step at the ``tiny`` preset on the card and on the
    CPU, over the same gloo group, with this rank's same scene, features
    and pairs (TF32 off): loss, averaged gradients and running statistics
    within phase 8's tolerance; K2 launched once on the card."""
    cfg = mods["cfg"].load_config("tiny", overrides=["contrastive.fused_loss=true"])
    cc, nce = cfg.contrastive, mods["nce"]
    text = text_embeddings(len(cfg.data.all_label) + 1, cfg.xdecoder.hidden_dim, seed=2)
    make = mods["synth"].make_scene_batch
    scenes = {d: make(seed=3 + mesh.rank, n_points=1500, n_views=2, device=d)
              for d in ("cpu", dev)}
    P = scenes["cpu"].points.shape[0]
    rng = np.random.default_rng(8 + mesh.rank)
    f2d = torch.from_numpy(rng.normal(size=(P, cfg.pooling.feature_dim)).astype(np.float32))
    ft = torch.from_numpy(rng.normal(size=(P, 24)).astype(np.float32))
    with torch.no_grad():
        pairs = mods["ctr"].sample_contrastive_pairs_hybrid(
            torch.Generator().manual_seed(9 + mesh.rank), ft, scenes["cpu"].point_valid,
            coords=scenes["cpu"].points, num_anchors=cc.num_anchors,
            num_macro=cc.num_macro_negatives, num_micro=cc.num_micro_negatives,
            spatial_k=cc.spatial_knn_k)
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for d in ("cpu", dev):
            pipe = mods["pipe"].GeoPurifyPipeline(cfg, text, 20.0, device=d)
            nce.info_nce_fwd.launches = nce.info_nce_bwd.launches = 0
            res = mods["dryrun"].stage1_dp(pipe, mesh, scenes[d], f2d.to(d), ft.to(d),
                                           steps=1, seed=6,
                                           pairs=type(pairs)(*(x.to(d) for x in pairs)))
            out[str(d)] = (res["losses"][0],
                           {k: p.grad.cpu() for k, p in pipe.student.named_parameters()},
                           {k: b.cpu() for k, b in pipe.student.named_buffers()},
                           (nce.info_nce_fwd.launches, nce.info_nce_bwd.launches))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    (loss_c, grads_c, stats_c, _), (loss_g, grads_g, stats_g, launches) = (
        out["cpu"], out[str(dev)])
    top = max(g.abs().max().item() for g in grads_c.values())
    worst = 0.0
    for name, gc in grads_c.items():
        gg, scale = grads_g[name], gc.abs().max().item()
        if scale < 1e-5 * top:
            # a conv bias ahead of train-mode BatchNorm: 0 up to rounding
            assert gg.abs().max().item() < 1e-5 * top, name
            continue
        worst = max(worst, (gg - gc).abs().max().item() / scale)
    stats = max((stats_g[k] - v).abs().max().item() for k, v in stats_c.items())
    return dict(loss_rel=abs(loss_g - loss_c) / abs(loss_c), worst_grad_rel=worst,
                stats_max_diff=stats, k2_launches=launches)


def phase13_rank(dev, root: str, n_steps: int):
    """One of two ranks over gloo on the one card (``parallel.spawn``): (a)
    ``n_steps`` data-parallel Stage-1 steps at ``scannet`` on a bench-spec
    scene of its own, and the tiny step card against CPU; (c) the
    view-parallel lift of one bench-spec scene; (b) ``run.validate.main
    --distributed`` over the scenes under ``root``. Counts are set to 0 just
    before each path and read just after."""
    mods = load_mods()
    cfg_mod, pipe_mod, batch_mod, dryrun = (mods[k] for k in ("cfg", "pipe", "batch",
                                                              "dryrun"))
    nce, band = mods["nce"], mods["band"]
    mesh = mods["mesh"].make_mesh()
    sp = BENCH_SPEC
    rec = {}

    # (a) Stage 1: one scene a rank, SyncBN, K2
    cfg = cfg_mod.load_config("scannet", overrides=["contrastive.fused_loss=true"])
    hw = tuple(cfg.xdecoder.mask_shape)
    text = text_embeddings(len(cfg.data.all_label) + 1, cfg.xdecoder.hidden_dim, seed=0)
    pipe = pipe_mod.GeoPurifyPipeline(cfg, text, 20.0, device=dev)
    batch = batch_mod.SceneBatch.from_numpy(
        batch_mod.build_scene(11 + mesh.rank, sp["P"], sp["M"], sp["V"], sp["Pv"], hw),
        device=dev)
    g = torch.Generator(device=dev).manual_seed(30 + mesh.rank)
    f2d = torch.randn((sp["P"], cfg.pooling.feature_dim), generator=g, device=dev)
    ft = torch.randn((sp["P"], 1088), generator=g, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    nce.info_nce_fwd.launches = nce.info_nce_bwd.launches = 0
    dp = dryrun.stage1_dp(pipe, mesh, batch, f2d, ft, steps=n_steps, seed=2)
    dp.update(k2_launches=(nce.info_nce_fwd.launches, nce.info_nce_bwd.launches),
              peak_bytes=torch.cuda.max_memory_allocated(dev))
    rec["dp"] = dp
    del pipe, batch, f2d, ft
    torch.cuda.empty_cache()
    rec["dp_tiny"] = dp_tiny_card_vs_cpu(mods, mesh, dev)

    # (c) the view-parallel lift, the rank's 4 views a micro-batch on both sides
    cfg = cfg_mod.load_config("scannet", overrides=["xdecoder.view_batch=4"])
    pipe = pipe_mod.GeoPurifyPipeline(cfg, text, 20.0, device=dev)
    seed_released(pipe, 1, dev)
    batch = batch_mod.SceneBatch.from_numpy(
        batch_mod.build_scene(21, sp["P"], sp["M"], sp["V"], sp["Pv"], hw), device=dev)
    with deterministic():
        rec["lift"] = dryrun.view_parallel_lift(pipe, batch, mesh.group)
    del pipe, batch
    torch.cuda.empty_cache()

    # (b) run.validate.main --distributed
    rec["validate"] = validate_capturing(mods, root, ["--distributed"])
    return rec


def validate_capturing(mods, root: str, flags, n_scenes=None):
    """``run.validate.main`` at ``scannet`` over the scenes under ``root``
    (deterministic algorithms; the X-Decoder as ``seed_released``): its
    result, the summed I/U/T histograms, what it printed, K1's launches and
    the per-scene records."""
    import contextlib
    import io

    validate, band = mods["validate"], mods["band"]
    seen = {}
    allreduce = validate.allreduce_meter_across_hosts

    def recording(meter):
        meter = allreduce(meter)
        seen["iut"] = np.stack([meter.intersection, meter.union, meter.target])
        return meter

    args = flags + ["--preset", "scannet"] + PRESET_OVERRIDES + dataset_overrides(Path(root))
    if n_scenes:
        args += ["--max-scenes", str(n_scenes)]
    out = io.StringIO()
    validate.allreduce_meter_across_hosts = recording
    band.banded_window_matmul.launches = 0
    try:
        with deterministic(), Instrument(mods) as ins, contextlib.redirect_stdout(out):
            t = time.perf_counter()
            result = validate.main(args)
            wall = time.perf_counter() - t
    finally:
        validate.allreduce_meter_across_hosts = allreduce
    return dict(result=result, iut=seen["iut"], stdout=out.getvalue(), wall_s=wall,
                k1_launches=band.banded_window_matmul.launches, scenes=ins.scenes)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_parallel(mods, root: Path, n_steps=3):
    """Phase 13: the single-process validation of phase 10's scenes (the
    reference), the two gloo ranks of ``phase13_rank``, then
    ``run.train.main --distributed`` as a world of 1 over NCCL, launched as
    ``torchrun`` would (``env://``). The reference is one run a scene
    (``--shard-idx r --shard-total 2``): the loader subsamples each view's
    visible points from its own generator, whose state depends on the
    scenes it loaded before, so rank r, which loads scene r only, matches
    a run that loads scene r only. (d) runs beside the reference runs."""
    nccl_dir = tempfile.TemporaryDirectory()
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    t_nccl = time.perf_counter()
    nccl_log = open(Path(nccl_dir.name) / "log.txt", "w+")
    nccl = subprocess.Popen(
        [sys.executable, "-m", "geopurify_tpu_torch.run.train", "--distributed",
         "--synthetic", "--preset", "scannet", "--epochs", "1", "--steps-per-epoch", "2",
         "contrastive.fused_loss=true", "train.print_freq=1",
         f"train.save_path={nccl_dir.name}"],
        cwd=HERE, env=env, stdout=nccl_log, stderr=subprocess.STDOUT)
    try:
        shards = [validate_capturing(mods, str(root),
                                     ["--shard-idx", str(r), "--shard-total", "2"])
                  for r in range(2)]
        for sh in shards:
            for sc in sh["scenes"]:
                log(f"(b) one run, {sc['sid']}: load {sc['load_s']:.2f} s, evaluate "
                    f"{sc['seconds']:.2f} s, {sc['predicted']} classes predicted")
        single = dict(iut=sum(sh["iut"] for sh in shards),
                      wall_s=sum(sh["wall_s"] for sh in shards), shards=shards)
        # (d) a world of 1 over NCCL through the CLI, as torchrun launches it
        with nccl_dir, nccl_log:
            nccl.wait(timeout=600)
            nccl_s = time.perf_counter() - t_nccl
            nccl_log.seek(0)
            out = nccl_log.read()
            assert nccl.returncode == 0, out[-4000:]
            recs = [json.loads(x) for x in
                    (Path(nccl_dir.name) / "metrics.jsonl").read_text().splitlines()]
            assert "(nccl)" in out and [r["step"] for r in recs] == [1, 2]
            assert all(np.isfinite(r["loss"]) for r in recs)
        log(f"(d) run.train.main --distributed over NCCL (world 1), beside the reference "
            f"runs and done within their {nccl_s:.1f} s: 2 steps in "
            f"{recs[-1]['elapsed_s']:.2f} s of its loop; losses {[r['loss'] for r in recs]}")
        t = time.perf_counter()
        ranks = mods["mesh"].spawn(phase13_rank, 2, "cuda", backend="gloo",
                                   args=(str(root), n_steps), timeout_s=900)
        ranks_s = time.perf_counter() - t
        rec = dict(single=single, ranks=ranks, ranks_s=ranks_s)

        # (a)
        for r, rr in enumerate(ranks):
            dp = rr["dp"]
            steps = ", ".join(f"{x:.3f}" for x in dp["step_seconds"])
            log(f"(a) rank {r}: DP Stage-1 steps {steps} s; losses {dp['losses']}; "
                f"replicas bit-equal {dp['replicas_equal']}; K2 launches {dp['k2_launches']}; "
                f"peak {dp['peak_bytes'] / 2**30:.2f} GiB")
            assert all(dp["replicas_equal"]) and np.isfinite(dp["losses"]).all(), dp
            assert dp["k2_launches"] == (n_steps, n_steps), dp["k2_launches"]
            t8 = rr["dp_tiny"]
            log(f"(a) rank {r}: tiny DP step card vs CPU: loss rel {t8['loss_rel']:.2e}, worst "
                f"gradient rel {t8['worst_grad_rel']:.2e}, running stats max diff "
                f"{t8['stats_max_diff']:.2e}; K2 launches {t8['k2_launches']}")
            assert t8["loss_rel"] <= 1e-5 and t8["worst_grad_rel"] <= 1e-4
            assert t8["stats_max_diff"] <= 1e-5 and t8["k2_launches"] == (1, 1)
        assert ranks[0]["dp"]["losses"] == ranks[1]["dp"]["losses"]

        # (c)
        for r, rr in enumerate(ranks):
            lf = rr["lift"]
            log(f"(c) rank {r}: view-parallel lift {lf['sharded_s']:.3f} s against the "
                f"sequential {lf['sequential_s']:.3f} s; counts equal {lf['counts_equal']}; "
                f"features max |diff| {lf['max_abs_diff']:.3e}, {lf['n_beyond']} of "
                f"{lf['seen']} seen points beyond 2e-3 (consensus near-ties)")
            assert lf["counts_equal"] and lf["finite"] and lf["seen"] > 0
            assert lf["n_beyond"] <= 1e-3 * lf["seen"], lf

        # (b)
        for r, rr in enumerate(ranks):
            v = rr["validate"]
            for sc in v["scenes"]:
                log(f"(b) rank {r} {sc['sid']}: load {sc['load_s']:.2f} s, evaluate "
                    f"{sc['seconds']:.2f} s (views {sc['views']}, K1 {sc['k1_launches']}), peak "
                    f"{sc['peak_bytes'] / 2**30:.2f} GiB, {sc['predicted']} classes predicted")
                assert sc["k1_launches"] == 19 and sc["predicted"] > 1, sc
            assert v["k1_launches"] == 19 * len(v["scenes"]) and len(v["scenes"]) == 1
            np.testing.assert_array_equal(v["iut"], single["iut"])
        lines = [rr["validate"]["stdout"].strip().splitlines() for rr in ranks]
        assert len(lines[0]) == 1 and lines[1] == []
        result = ranks[0]["validate"]["result"]
        assert json.loads(lines[0][0]) == json.loads(json.dumps(result))
        log(f"(b) run.validate.main --distributed: I/U/T equal to the runs of one scene "
            f"each ({single['wall_s']:.1f} s of validate.main there; the ranks {ranks_s:.1f} s "
            f"for (a)-(c) and (b) with start-up); mIoU {result['summary']['all']['mIoU']}")

        for rr in ranks:
            del rr["validate"]["scenes"]
        rec.update(nccl_s=nccl_s, nccl_metrics=recs,
                   k1_launches=sum(rr["validate"]["k1_launches"] for rr in ranks),
                   k2_launches=tuple(sum(rr["dp"]["k2_launches"][i] for rr in ranks)
                                     for i in (0, 1)))
        for sh in shards:
            del sh["scenes"]
        return rec
    finally:
        if nccl.poll() is None:
            nccl.kill()
            nccl.wait()


# ---------------------------------------------------------------------------
# phase 14: the pruned searches and the z-stacked student at phase 10's scene
# ---------------------------------------------------------------------------

def best_of(fn, n: int):
    """(first result, least seconds) of ``n`` synchronised calls after one
    warm-up call."""
    fn()
    runs = [synced(fn) for _ in range(n)]
    return runs[0][0], min(t for _, t in runs)


def phase_grid_search(mods, scene0):
    """Each pruned search against its brute force on phase 10's first scene
    (``scannet``: M = 2^18 voxel bucket, P = 2^20 points): the kNN-96 of the
    smoothing graph (bit-equal on the valid rows), the voxel fill's donors
    (equal, the lowest id on ties), the sampler's anchors' kNN (equal, at
    the preset's 4096 anchors drawn by ``select_anchors``), and the
    full-width student (518-512-128, 4 residual blocks, seeded) with the
    z-stacked table against the plain one; each with both times and the
    certificate's counts."""
    knn, sc, dev = mods["knn"], mods["sc"], "cuda"
    cfg = mods["cfg"].load_config("scannet", overrides=PRESET_OVERRIDES)
    pc, cc, scfg = cfg.pooling, cfg.contrastive, cfg.student
    vox, vv = scene0["voxel_coords"].to(dev), scene0["voxel_valid"].to(dev)
    M, k = vox.shape[0], pc.knn_k

    def shares(st):
        return (st["failed"] / max(st["queries"], 1),
                st["overflow_tiles"] / max(st["tiles"], 1))

    # the smoothing graph's kNN: grid against full
    (d_g, i_g, st), grid_s = best_of(
        lambda: knn._knn_self_grid(vox, vv, k, pc.knn_radius, pc.knn_candidates), 3)
    ids = torch.arange(M, device=dev)
    (d_f, i_f), full_s = synced(lambda: knn.knn_search(
        vox, vox, vv, k, query_ids=ids, exclude_identical_index=True))
    knn_equal = torch.equal(d_g[vv], d_f[vv]) and torch.equal(i_g[vv], i_f[vv])
    unfilled = bool(torch.isinf(d_g[~vv]).all()) and bool((i_g[~vv] == 0).all())
    knn_shares = shares(st)
    log(f"kNN-{k} certificate (M={M}, {st['queries']} valid voxels, radius "
        f"{pc.knn_radius}, budget {pc.knn_candidates}): {knn_shares[0]:.4%} of the "
        f"queries failed it ({st['failed']}, recomputed), {knn_shares[1]:.4%} of the "
        f"tiles over budget ({st['overflow_tiles']} of {st['tiles']})")
    log(f"kNN-{k}: grid {grid_s * 1e3:.1f} ms, full {full_s * 1e3:.1f} ms "
        f"({full_s / grid_s:.1f}x); dists and idx bit-equal on the valid rows: "
        f"{knn_equal}; invalid rows unfilled: {unfilled}")
    assert knn_equal and unfilled
    del d_g, i_g, d_f, i_f

    # the voxel fill's donors: grid against the sweep of nearest_fill
    cf, has = vox.float(), scene0["fill_has"].to(dev)
    (q_g, don_g, fst), fill_s = best_of(
        lambda: knn._nearest_fill_grid(cf, has, vv, 512, 4096, 16, 9), 3)
    donors_ok = has & vv
    (q_s, don_s, _), sweep_s = best_of(lambda: knn._nearest_donor_core(
        cf, donors_ok, vv & ~has, knn._donor_tile(int(donors_ok.sum()))), 1)
    fill_equal = torch.equal(q_g, q_s) and torch.equal(don_g, don_s)
    fill_shares = shares(fst)
    log(f"voxel fill donors: {fst['queries']} unseen of {int(vv.sum())} voxels; grid "
        f"{fill_s * 1e3:.1f} ms, sweep {sweep_s * 1e3:.1f} ms; {fill_shares[0]:.4%} "
        f"recomputed, {fill_shares[1]:.4%} of {fst['tiles']} tiles over budget; donors "
        f"equal (lowest id on ties): {fill_equal}")
    assert fill_equal

    # the sampler's anchors' spatial kNN at P = 2^20: grid against brute
    pts, pv = scene0["points"].to(dev), scene0["point_valid"].to(dev)
    aidx, _ = mods["ctr"].select_anchors(torch.Generator(device=dev).manual_seed(8), pv,
                                         cc.num_anchors)
    aidx = aidx.long()
    (a_d, a_i, ast), anchors_s = best_of(lambda: knn._knn_anchors_grid(
        pts, pv, aidx, cc.spatial_knn_k, cc.spatial_radius), 2)
    (b_d, b_i), brute_s = best_of(lambda: knn.knn_search(
        pts[aidx], pts, pv, cc.spatial_knn_k, query_ids=aidx,
        exclude_identical_index=True), 2)
    av = pv[aidx]
    sets_equal = torch.equal(a_i[av].sort(1).values, b_i[av].sort(1).values)
    anchors_equal = torch.equal(a_d[av], b_d[av]) and torch.equal(a_i[av], b_i[av])
    anchor_shares = shares(ast)
    log(f"anchors' kNN-{cc.spatial_knn_k} (P={pts.shape[0]}, {aidx.shape[0]} anchors, "
        f"radius {cc.spatial_radius}): grid {anchors_s * 1e3:.1f} ms, brute "
        f"{brute_s * 1e3:.1f} ms; {anchor_shares[0]:.4%} recomputed, "
        f"{anchor_shares[1]:.4%} of {ast['tiles']} tiles over budget; sets equal "
        f"{sets_equal}, bit-equal {anchors_equal}")
    assert sets_equal and anchors_equal

    # the student: z-stacked against the plain table
    student = mods["student"].AffinityPredictor(
        scfg.input_dim, scfg.hidden_dim, scfg.embed_dim, scfg.num_res_blocks,
        bn_momentum=scfg.bn_momentum).to(dev).eval()
    mods["student"].init_student_(student, torch.Generator().manual_seed(4))
    x = torch.randn((M, scfg.input_dim), generator=torch.Generator(device=dev).manual_seed(9),
                    device=dev)
    nbr = sc.build_neighbor_table(vox, vv)
    budget = max(16384, M // 16)          # the pipeline's residual budget
    zt_preset = sc.build_zstack_table(vox, vv, nbr, res_budget=budget)
    res_cnt = zt_preset.res_cnt.tolist()
    zt = zt_preset if not bool(zt_preset.overflow) else sc.build_zstack_table(
        vox, vv, nbr, res_budget=max(res_cnt))
    with torch.inference_mode():
        e_p, plain_s = best_of(lambda: student(x, nbr, vv), 2)
        e_z, z_s = best_of(lambda: student(x, zt, vv), 2)
    rel = float((e_z - e_p).abs().max() / e_p.abs().max())
    log(f"student forward (M={M}): plain table {plain_s * 1e3:.1f} ms, z-stacked "
        f"{z_s * 1e3:.1f} ms (residual budget {zt.res_dst.shape[1]}, z-hole edges a "
        f"tap {min(res_cnt)}-{max(res_cnt)}; at the pipeline's budget {budget} the "
        f"table overflows: {bool(zt_preset.overflow)}); max |diff| {rel:.2e} of the "
        f"embedding scale")
    assert not bool(zt.overflow) and rel < 2e-4, rel
    return dict(knn=dict(grid_s=grid_s, full_s=full_s, stats=st, bit_equal=knn_equal,
                         failed_share=knn_shares[0], overflow_share=knn_shares[1]),
                fill=dict(grid_s=fill_s, sweep_s=sweep_s, stats=fst, equal=fill_equal),
                anchors=dict(grid_s=anchors_s, brute_s=brute_s, stats=ast,
                             equal=anchors_equal),
                student=dict(plain_s=plain_s, zstack_s=z_s, rel=rel, res_cnt=res_cnt,
                             preset_budget=budget,
                             preset_overflow=bool(zt_preset.overflow)))


# ---------------------------------------------------------------------------
# phase 15: the 2D family (run.infer2d, the alternative X-Decoders)
# ---------------------------------------------------------------------------

INFER2D_CLASSES = 8                    # the first 8 of scannet's 20 class names
INFER2D_GALLERY = 4
INFER2D_EVAL_PAIRS = 8
CAPTION_STEPS = 20


def synthetic_photo(rng, hw=(480, 640)):
    """A 480x640 RGB frame of coloured rectangles over noise, uint8."""
    img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    for _ in range(6):
        y, x = rng.integers(0, hw[0] - 60), rng.integers(0, hw[1] - 80)
        img[y:y + rng.integers(40, 240), x:x + rng.integers(60, 320)] = rng.integers(0, 256, 3)
    return img


def write_2d_inputs(root: Path, rng, classes: int):
    """Three query images, a gallery of 4, and 8 image / label-png pairs
    (ids 0..classes-1 and the 255 ignore) listed in ``eval.txt``."""
    from PIL import Image

    paths = []
    for i in range(3):
        paths.append(root / f"query{i}.png")
        Image.fromarray(synthetic_photo(rng)).save(paths[-1])
    (root / "gallery").mkdir()
    for i in range(INFER2D_GALLERY):
        Image.fromarray(synthetic_photo(rng)).save(root / "gallery" / f"g{i}.jpg")
    lines = []
    for i in range(INFER2D_EVAL_PAIRS):
        Image.fromarray(synthetic_photo(rng)).save(root / f"eval{i}.png")
        gt = rng.integers(0, classes, (480, 640)).astype(np.uint8)
        gt[:40] = 255
        Image.fromarray(gt).save(root / f"eval{i}_gt.png")
        lines.append(f"{root / f'eval{i}.png'} {root / f'eval{i}_gt.png'}")
    (root / "eval.txt").write_text("\n".join(lines) + "\n")
    return [str(p) for p in paths]


def seed_2d(model, seed: int, device):
    """``seed_lecun`` for an X-Decoder module (every backbone and pixel
    decoder, the caption slots)."""
    seed_lecun(type("Teacher", (), dict(xdecoder=model))(), seed, device)


def captioning_checkpoint(mods, root: Path, cfg, device="cuda"):
    """The full-width ``scannet`` X-Decoder with caption slots (77 tokens),
    LeCun-seeded, and a language tower initialised as ``build_pipeline``
    does, at a logit scale of 50, written in the reference layout."""
    t = cfg.text
    lang = mods["lang"].LanguageEncoder(t.vocab_size, t.width, t.layers, t.heads,
                                        t.context_length, t.dim_proj)
    mods["lang"].init_language_(lang, torch.Generator().manual_seed(cfg.train.manual_seed))
    with torch.no_grad():
        lang.logit_scale.fill_(float(np.log(50.0)))
    xdec = mods["xdec"].XDecoderSegModel(cfg.xdecoder, caption_len=t.context_length).to(device)
    seed_2d(xdec, 7, device)
    path = root / "xdecoder_captioning.pt"
    t0 = time.perf_counter()
    mb = save_reference(path, mods["convx"].synthesize_torch_state_dict(xdec, lang))
    log(f"captioning X-Decoder checkpoint: {mb:.0f} MB in {time.perf_counter() - t0:.1f} s")
    del xdec
    return path


class Recorder:
    """Wraps ``owner.name`` to keep what it returns (the runs' maps, caption
    ids); ``restore`` puts the original back."""

    def __init__(self):
        self.saved, self.out = [], {}

    def wrap(self, owner, name, key, pick=lambda a, r: r):
        fn = getattr(owner, name)
        self.saved.append((owner, name, fn))

        def rec(*a, **k):
            r = fn(*a, **k)
            self.out.setdefault(key, []).append(pick(a, r))
            return r

        setattr(owner, name, rec)

    def restore(self):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)


def infer2d_run(mods, args, device="cuda"):
    """``run.infer2d.main(args)`` with its seconds."""
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = mods["infer2d"].main([*args, "--device", device])
    if device == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase15_infer2d(mods, root: Path, ckpt: Path, classes, preset="scannet", extra=(),
                    device="cuda"):
    """(a) every task of ``run.infer2d.main`` at ``preset`` through
    ``xdecoder.ckpt``; the pipeline is built once (the first run's start-up
    is reported apart) and each task times its images from the second on."""
    train_mod, inf2d = mods["train"], mods["infer2d"]
    paths = write_2d_inputs(root, np.random.default_rng(15), len(classes))
    base = ["--preset", preset, "--classes", ",".join(classes), f"xdecoder.ckpt={ckpt}",
            *extra]
    run = functools.partial(infer2d_run, device=device)
    built, build, fwd_s = {}, train_mod.build_pipeline, []

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def build_once(cfg, gen, **kw):
        if "p" not in built:
            t0 = time.perf_counter()
            built["p"] = build(cfg, gen, **kw)
            built["s"] = time.perf_counter() - t0
            model = built["p"][0].xdecoder
            forward = model.forward

            def timed(*a, **k):             # the X-Decoder forward's share of an image
                sync()
                t1 = time.perf_counter()
                r = forward(*a, **k)
                sync()
                fwd_s.append(time.perf_counter() - t1)
                return r

            model.forward = timed
        return built["p"]

    rec = Recorder()
    train_mod.build_pipeline = build_once
    rec.wrap(inf2d, "semseg_from_outputs", "semseg", lambda a, r: r.cpu())
    rec.wrap(mods["lang"].HashTokenizer, "decode", "caption_ids",
             lambda a, r: np.asarray(a[1]))
    tasks = {
        "semseg": ["--rich-overlay"],
        # thresholds low enough for seeded weights' segments to pass
        "panoseg": ["--things", ",".join(classes[2:]), "--object-threshold", "0.05",
                    "--overlap-threshold", "0.0"],
        "instseg": ["--topk", "5"],
        "refseg": ["--phrases", "a chair,the floor"],
        "captioning": ["--caption-steps", str(CAPTION_STEPS)],
    }
    out = {}
    try:
        for task, targs in tasks.items():
            secs, fwd = [], []
            for i, img in enumerate(paths):
                n0 = len(fwd_s)
                dst, s = run(mods, ["--image", img, "--task", task,
                                    "--out", str(root / f"{task}{i}.png"), *targs, *base])
                assert os.path.exists(dst) and os.path.getsize(dst) > 0, dst
                secs.append(s)
                fwd.append(sum(fwd_s[n0:]))
            out[task] = dict(s_per_image=secs[1:], first_s=secs[0], forward_s=fwd[1:])
            log(f"  infer2d {task}: {', '.join(f'{v:.3f}' for v in secs[1:])} s an image, "
                f"X-Decoder forward {', '.join(f'{v:.3f}' for v in fwd[1:])} s "
                f"(first {secs[0]:.2f} s)")
        secs = []
        for i in range(2):
            dst, s = run(mods, ["--image", paths[i], "--task", "retrieval",
                                "--phrases", "a chair,a bright room",
                                "--gallery", str(root / "gallery"),
                                "--out", str(root / f"ret{i}.png"), *base])
            ranking = json.loads(Path(dst).read_text())
            assert all(len(v) == 1 + INFER2D_GALLERY for v in ranking.values()), ranking
            secs.append(s / (1 + INFER2D_GALLERY))
        out["retrieval"] = dict(s_per_image=secs[1:], first_s=secs[0])
        log(f"  infer2d retrieval (gallery of {INFER2D_GALLERY}): {secs[1]:.3f} s an image")
        res, s = run(mods, ["--eval-list", str(root / "eval.txt"), *base])
        assert np.isfinite(res["mIoU"]), res
        out["eval_list"] = dict(s_per_image=[s / INFER2D_EVAL_PAIRS], mIoU=res["mIoU"],
                                pACC=res["pACC"])
        log(f"  infer2d --eval-list over {INFER2D_EVAL_PAIRS} pairs: "
            f"{s / INFER2D_EVAL_PAIRS:.3f} s an image, mIoU {res['mIoU']:.2f}")
    finally:
        train_mod.build_pipeline = build
        rec.restore()
    out["build_pipeline_s"] = built["s"]
    wins = [int(np.unique(m.numpy()).size) for m in rec.out["semseg"]]
    assert max(wins) > 1, f"one class wins every semseg map: {wins}"
    ids = np.concatenate(rec.out["caption_ids"])
    cfg = mods["cfg"].load_config(preset, overrides=list(extra))
    assert len(rec.out["caption_ids"]) == len(paths)
    assert ((ids >= 0) & (ids < cfg.text.vocab_size)).all(), ids
    out.update(classes_winning=wins, caption_ids=rec.out["caption_ids"][0][:CAPTION_STEPS]
               .tolist())
    log(f"  semseg classes winning per map {wins}; caption ids "
        f"{out['caption_ids'][:8]}...; build_pipeline {built['s']:.1f} s")
    return out


ALT_CONFIGS = {
    "FocalNet-L (scannet, the yardstick)": [],
    "focal_dw FocalNet-L": ["xdecoder.backbone.variant=focal_dw"],
    "DaViT": ["xdecoder.backbone_type=davit"],
    "ViT-B": ["xdecoder.backbone_type=vit"],
    "FocalNet-L + deformable decoder": ["xdecoder.pixel_decoder=deform"],
}


def phase15_alt_configs(mods, text_dim=512):
    """(b) one forward of each alternative configuration (and of the
    ``scannet`` FocalNet-L as the yardstick) at full width, bf16, 484x648:
    median ms of 3 after a warm-up, peak memory; the deformable one's
    ms_deform_attn time from an instrumented forward."""
    pdd = mods["pdd"]
    out = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    img = torch.rand((1, 484, 648, 3), generator=g, device="cuda") * 255
    text = text_embeddings(21, text_dim, seed=3).cuda()
    for name, over in ALT_CONFIGS.items():
        cfg = mods["cfg"].load_config("scannet", overrides=over).xdecoder
        model = mods["xdec"].XDecoderSegModel(cfg).to("cuda").eval()
        seed_2d(model, 11, "cuda")
        n_par = sum(p.numel() for p in model.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            o = model(img, text, 50.0)
            ms = []
            for _ in range(3):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                o = model(img, text, 50.0)
                b.record()
                torch.cuda.synchronize()
                ms.append(a.elapsed_time(b))
            finite = all(bool(torch.isfinite(v.float()).all()) for k, v in o.items()
                         if k != "padded_hw")
            assert finite, name
            rec = dict(ms=float(np.median(ms)), ms_all=ms, params_M=n_par / 1e6,
                       peak_GiB=torch.cuda.max_memory_allocated() / 2 ** 30,
                       pred_masks=list(o["pred_masks"].shape))
            if cfg.pixel_decoder == "deform":
                calls, fn = [], pdd.ms_deform_attn

                def timed(*a, **k):
                    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    e0.record()
                    r = fn(*a, **k)
                    e1.record()
                    calls.append((e0, e1))
                    return r

                pdd.ms_deform_attn = timed
                try:
                    model(img, text, 50.0)
                finally:
                    pdd.ms_deform_attn = fn
                torch.cuda.synchronize()
                rec["ms_deform_attn_ms"] = sum(a.elapsed_time(b) for a, b in calls)
                rec["ms_deform_attn_calls"] = len(calls)
                rec["ms_deform_attn_share"] = rec["ms_deform_attn_ms"] / rec["ms"]
        out[name] = rec
        log(f"  {name}: {rec['params_M']:.1f} M parameters, {rec['ms']:.2f} ms a forward "
            f"({', '.join(f'{v:.2f}' for v in ms)}), peak {rec['peak_GiB']:.2f} GiB"
            + (f"; ms_deform_attn {rec['ms_deform_attn_ms']:.2f} ms over "
               f"{rec['ms_deform_attn_calls']} calls ({100 * rec['ms_deform_attn_share']:.1f}%)"
               if "ms_deform_attn_ms" in rec else ""))
        del model, o
        torch.cuda.empty_cache()
    return out


def rel_err(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def narrow_cfg(mods, over):
    return mods["cfg"].load_config("tiny", overrides=[
        "xdecoder.mask_shape=[128,192]", "xdecoder.enc_layers=2", *over]).xdecoder


def phase15_card_vs_cpu(mods, root: Path, dev="cuda"):
    """(c) the card against the CPU in f32 with TF32 off, at narrow widths:
    each configuration of (b) (pixel features, then the head with both on
    the CPU's attention masks: rel < 1e-4), ms_deform_attn with sampling
    points outside the maps, and the infer2d tasks at the tiny preset."""
    out = {}
    g = torch.Generator().manual_seed(5)
    img = torch.rand((2, 128, 192, 3), generator=g) * 255
    text = torch.randn((5, 16), generator=g)
    text = text / text.norm(dim=-1, keepdim=True)
    xd = mods["xdec"]
    for name, over in {"focal_dw": ["xdecoder.backbone.variant=focal_dw"],
                       "DaViT": ["xdecoder.backbone_type=davit"],
                       "ViT-B": ["xdecoder.backbone_type=vit"],
                       "deformable decoder": ["xdecoder.pixel_decoder=deform"]}.items():
        cpu = xd.XDecoderSegModel(narrow_cfg(mods, over)).eval()
        seed_2d(cpu, 21, "cpu")
        gpu = xd.XDecoderSegModel(narrow_cfg(mods, over)).eval()
        gpu.load_state_dict(cpu.state_dict())
        gpu.to(dev)
        with torch.inference_mode():
            mf_c, ms_c = xd.encode_pixel_features(cpu, img)
            head_c = xd.apply_head(cpu, ms_c, mf_c, text, 20.0, return_attn=True)
            mf_g, ms_g = xd.encode_pixel_features(gpu, img.to(dev))
            head_g = xd.apply_head(gpu, ms_g, mf_g, text.to(dev), 20.0,
                                   attn_mask_override=[m.to(dev) for m in
                                                       head_c["attn_masks"][:-1]])
        errs = {"mask_features": rel_err(mf_g, mf_c),
                "multi_scale": max(rel_err(a, b) for a, b in zip(ms_g, ms_c))}
        errs.update({k: rel_err(head_g[k], head_c[k])
                     for k in ("pred_logits", "pred_masks", "mask_embed", "cls_embed")})
        assert max(errs.values()) < 1e-4, (name, errs)
        out[name] = errs
        log(f"  card vs CPU, {name}: max rel {max(errs.values()):.2e}")
    # ms_deform_attn, a third of the sampling points outside the maps
    msda = mods["msda"]
    shapes = ((16, 24), (8, 12), (4, 6))
    L = sum(h * w for h, w in shapes)
    value = torch.randn((2, L, 8, 32), generator=g)
    loc = torch.rand((2, 300, 8, 3, 4, 2), generator=g) * 1.6 - 0.3
    w = torch.softmax(torch.randn((2, 300, 8, 12), generator=g), -1).reshape(2, 300, 8, 3, 4)
    with torch.inference_mode():
        ref = msda.ms_deform_attn(value, shapes, loc, w)
        got = msda.ms_deform_attn(value.to(dev), shapes, loc.to(dev), w.to(dev))
    out["ms_deform_attn"] = rel_err(got, ref)
    assert out["ms_deform_attn"] < 1e-4, out["ms_deform_attn"]
    log(f"  card vs CPU, ms_deform_attn ({((loc < 0) | (loc > 1)).any(-1).float().mean():.0%} "
        f"of the points outside): rel {out['ms_deform_attn']:.2e}")
    out["infer2d"] = infer2d_card_vs_cpu(mods, root, dev)
    return out


def flat_cpu(r):
    """The tensors of a (nested) tuple of results, on the host."""
    return [y for x in r for y in (flat_cpu(x) if isinstance(x, tuple) else [x.cpu()])]


def infer2d_card_vs_cpu(mods, root: Path, dev="cuda"):
    """``run.infer2d.main`` at the tiny preset on the card and on the CPU
    over one seeded captioning checkpoint: the query and mask logits within
    1e-4, semseg flips only at near-ties, the panoptic and instance tables,
    the refseg matches and the caption ids equal, the retrieval ranking and
    the evaluation's mIoU equal."""
    over = ["text.width=16"]
    cfg = mods["cfg"].load_config("tiny", overrides=over)
    t = cfg.text
    xdec = mods["xdec"].XDecoderSegModel(cfg.xdecoder, caption_len=t.context_length)
    seed_2d(xdec, 17, "cpu")
    lang = mods["lang"].LanguageEncoder(t.vocab_size, t.width, t.layers, t.heads,
                                        t.context_length, t.dim_proj)
    mods["lang"].init_language_(lang, torch.Generator().manual_seed(3))
    with torch.no_grad():
        lang.logit_scale.fill_(float(np.log(30.0)))
    ckpt = root / "tiny_xdecoder.pt"
    save_reference(ckpt, mods["convx"].synthesize_torch_state_dict(xdec, lang))
    classes = "wall,floor,chair,table"
    query = root / "query0.png"
    base = ["--preset", "tiny", "--classes", classes, f"xdecoder.ckpt={ckpt}", *over]
    runs = {
        "semseg": ["--image", str(query), "--task", "semseg"],
        "panoseg": ["--image", str(query), "--task", "panoseg", "--object-threshold", "0.2",
                    "--overlap-threshold", "0.2"],
        "instseg": ["--image", str(query), "--task", "instseg", "--topk", "4"],
        "refseg": ["--image", str(query), "--task", "refseg", "--phrases", "a chair,the floor"],
        "captioning": ["--image", str(query), "--task", "captioning", "--caption-steps", "8"],
        "retrieval": ["--image", str(query), "--task", "retrieval", "--phrases", "a chair",
                      "--gallery", str(root / "gallery")],
        "eval": ["--eval-list", str(root / "eval.txt")],
    }
    inf, inf2d = mods["inf"], mods["infer2d"]
    got = {}
    for side in ("cpu", dev):
        rec = Recorder()
        rec.wrap(inf2d, "semseg_from_outputs", "semseg",
                 lambda a, r: (a[0].float().cpu(), a[1].float().cpu(), r.cpu()))
        for fn in ("panoptic_inference", "instance_inference", "grounding_inference"):
            rec.wrap(inf, fn, fn, lambda a, r: flat_cpu(r))
        rec.wrap(mods["lang"].HashTokenizer, "decode", "caption_ids",
                 lambda a, r: np.asarray(a[1]))
        res = {}
        try:
            for task, args in runs.items():
                res[task] = mods["infer2d"].main([*args, "--out", str(root / f"{side}_{task}.png"),
                                                  *base, "--device", side])
        finally:
            rec.restore()
        got[side] = (rec.out, res)
    (c, res_c), (gc, res_g) = got["cpu"], got[dev]
    out = {"logits": 0.0, "masks": 0.0, "semseg_flips": 0}
    for (lc, mc, sc), (lg, mg, sg) in zip(c["semseg"], gc["semseg"]):
        out["logits"] = max(out["logits"], rel_err(lg, lc))
        out["masks"] = max(out["masks"], rel_err(mg, mc))
        flips = sc != sg
        out["semseg_flips"] += int(flips.sum())
        if flips.any():
            sem = inf.semantic_inference(lc, mc)
            sem = mods["layers"].resize_bicubic_antialias(sem[None], tuple(sc.shape))[0]
            margin = (sem[flips, sc[flips]] - sem[flips, sg[flips]]).abs().max()
            assert margin < 1e-4 * sem.abs().max(), ("semseg flip off a near-tie", margin)
    assert out["logits"] < 1e-4 and out["masks"] < 1e-4, out
    assert out["semseg_flips"] <= 0.001 * sum(s[2].numel() for s in c["semseg"]), out
    for fn in ("panoptic_inference", "instance_inference", "grounding_inference"):
        for a, b in zip(c[fn][0], gc[fn][0]):
            if a.dtype.is_floating_point:
                assert rel_err(b, a) < 1e-4, fn
            else:
                assert torch.equal(a, b), fn
    assert all(np.array_equal(a, b) for a, b in zip(c["caption_ids"], gc["caption_ids"]))
    rank_c, rank_g = (json.loads(Path(r["retrieval"]).read_text()) for r in (res_c, res_g))
    assert [[x["image"] for x in v] for v in rank_c.values()] == \
        [[x["image"] for x in v] for v in rank_g.values()]
    if out["semseg_flips"] == 0:
        assert res_c["eval"]["mIoU"] == res_g["eval"]["mIoU"], (res_c["eval"], res_g["eval"])
    out["mIoU"] = res_g["eval"]["mIoU"]
    out["panoptic_segments"] = int(gc["panoptic_inference"][0][3].sum())
    log(f"  card vs CPU, infer2d tiny: logits rel {out['logits']:.2e}, masks rel "
        f"{out['masks']:.2e}, semseg flips {out['semseg_flips']}; tables, caption ids, "
        f"ranking and mIoU ({out['mIoU']:.2f}) equal")
    return out


def phase_2d(mods):
    """Phase 15: (a) run.infer2d.main at scannet, (b) the alternative
    X-Decoder configurations at full width, (c) the card against the CPU.
    Neither kernel lies on this path: both counts are set to 0 before and
    must read 0 after."""
    band, nce = mods["band"], mods["nce"]
    band.banded_window_matmul.launches = 0
    nce.info_nce_fwd.launches = nce.info_nce_bwd.launches = 0
    out = {}
    cfg = mods["cfg"].load_config("scannet")
    classes = list(cfg.data.all_label[:INFER2D_CLASSES])
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        ckpt = captioning_checkpoint(mods, root, cfg)
        out["checkpoint_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["infer2d"] = phase15_infer2d(mods, root, ckpt, classes)
        out["infer2d"]["peak_GiB"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["infer2d_s"] = time.perf_counter() - t
        log(f"  infer2d peak {out['infer2d']['peak_GiB']:.2f} GiB")
        t = time.perf_counter()
        out["alt_configs"] = phase15_alt_configs(mods)
        out["alt_configs_s"] = time.perf_counter() - t
        launches = (band.banded_window_matmul.launches, nce.info_nce_fwd.launches,
                    nce.info_nce_bwd.launches)
        out["launches"] = launches
        assert launches == (0, 0, 0), f"K1 / K2 launched on the 2D path: {launches}"
        t = time.perf_counter()
        prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            out["card_vs_cpu"] = phase15_card_vs_cpu(mods, root)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        out["card_vs_cpu_s"] = time.perf_counter() - t
    log(f"  K1, K2-fwd, K2-bwd launches on the 2D path: {launches}")
    return out


# ---------------------------------------------------------------------------
# Phase 16: the interactive path (SEEM)
# ---------------------------------------------------------------------------

# SEEM's released configs decode 101 queries (scannet's X-Decoder has 201)
SEEM_QUERIES = "xdecoder.num_queries=101"
INTERACTIVE_ROUNDS = 3
INTERACTIVE_BUDGET = 64
NOC_INSTANCES = 4


def sync(device="cuda"):
    if device == "cuda":
        torch.cuda.synchronize()


def instrument_interactive(inter, device="cuda"):
    """Wraps ``run.infer_interactive``'s ``build_models`` (the models built
    once a head kind and reused, the head's forward timed and its outputs
    checked finite) and ``encode_image`` (timed). Returns the timings and a
    function that restores both."""
    build, encode = inter.build_models, inter.encode_image
    built, t = {}, {"build_s": {}, "encode_s": [], "head_s": []}

    def build_once(xc, task, budget, n_cls, dev):
        key = (task, budget)
        if key not in built:
            t0 = time.perf_counter()
            m = build(xc, task, budget, n_cls, dev)
            t["build_s"][task] = time.perf_counter() - t0
            forward = m.head.forward

            def timed(*a, **k):
                sync(device)
                t1 = time.perf_counter()
                r = forward(*a, **k)
                sync(device)
                t["head_s"].append(time.perf_counter() - t1)
                flat = [x for v in r.values() for x in (v if isinstance(v, list) else [v])]
                assert all(bool(torch.isfinite(x.float()).all()) for x in flat
                           if x.dtype != torch.bool), "non-finite SEEM head output"
                return r

            m.head.forward = timed
            built[key] = m
        return built[key]

    def encode_timed(*a, **k):
        sync(device)
        t0 = time.perf_counter()
        r = encode(*a, **k)
        sync(device)
        t["encode_s"].append(time.perf_counter() - t0)
        return r

    inter.build_models, inter.encode_image = build_once, encode_timed

    def restore():
        inter.build_models, inter.encode_image = build, encode
    return t, restore


def phase16_interactive(mods, root: Path, extra=(SEEM_QUERIES,), device="cuda"):
    """(a) ``run.infer_interactive.main`` at ``scannet``'s full width
    (FocalNet-L, the 6-layer FPN encoder, the 9-layer SEEM heads with 512
    hidden and 101 queries, f32) on a synthetic 480x640 photo: the v1
    loop, the demo head with a reference image, and the NoC protocol, each
    call's seconds, its backbone + pixel decoder and head rounds, its peak
    memory. ``extra`` overrides the config (a CPU rehearsal narrows it)."""
    import contextlib
    import io

    from PIL import Image

    inter, seem = mods["inter"], mods["seem"]
    rng = np.random.default_rng(16)
    photo, ref = root / "photo.png", root / "ref.png"
    Image.fromarray(synthetic_photo(rng)).save(photo)
    Image.fromarray(synthetic_photo(rng)).save(ref)
    base = ["--image", str(photo), "--preset", "scannet", "--budget", str(INTERACTIVE_BUDGET),
            "--device", device, *extra]
    runs = {
        "v1": ["--task", "v1", "--rounds", str(INTERACTIVE_ROUNDS),
               "--clicks", "240,320;260,360", "--neg-clicks", "40,40"],
        "demo": ["--task", "demo", "--clicks", "240,320", "--refimg", str(ref),
                 "--ref-clicks", "200,300;220,340"],
        "noc": ["--eval-noc", str(NOC_INSTANCES), "--rounds", str(INTERACTIVE_ROUNDS)],
    }
    t, restore = instrument_interactive(inter, device)
    cuda = device == "cuda"
    rec = Recorder()
    rec.wrap(seem, "demo_select_mask", "demo", lambda a, r: int(r[0][0]))
    out = {}
    try:
        for name, args in runs.items():
            n_head, n_enc = len(t["head_s"]), len(t["encode_s"])
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            stdout = io.StringIO()
            sync(device)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(stdout):
                res = inter.main([*args, "--out", str(root / f"{name}.png"), *base])
            sync(device)
            secs = time.perf_counter() - t0
            r = dict(s=secs, head_s=t["head_s"][n_head:], encode_s=t["encode_s"][n_enc:],
                     peak_GiB=torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0)
            if name == "noc":
                r["noc"] = json.loads(stdout.getvalue().strip().splitlines()[-1])
                assert res == 0 and set(r["noc"]) == {"noc@0.5", "noc@0.8", "noc@0.85",
                                                      "noc@0.9", "miou@iter1"}, r["noc"]
                assert all(1 <= r["noc"][f"noc@{v}"] <= INTERACTIVE_ROUNDS
                           for v in (0.5, 0.8, 0.85, 0.9))
                assert 0 <= r["noc"]["miou@iter1"] <= 1
                assert len(r["head_s"]) >= NOC_INSTANCES
            else:
                assert os.path.getsize(res) > 0, res
            out[name] = r
            log(f"  interactive {name}: {secs:.2f} s a call (build "
                f"{t['build_s'].pop('demo' if name == 'demo' else 'v1', 0.0):.2f} s), "
                f"backbone + pixel decoder {', '.join(f'{v:.3f}' for v in r['encode_s'])} s, "
                f"head rounds {', '.join(f'{v:.3f}' for v in r['head_s'])} s, "
                f"peak {r['peak_GiB']:.2f} GiB"
                + (f"; {r['noc']}" if name == "noc" else ""))
    finally:
        restore()
        rec.restore()
    best = rec.out["demo"][0]
    cfg = mods["cfg"].load_config("scannet", overrides=list(extra))
    assert 0 <= best < cfg.xdecoder.num_queries, best
    out["demo"]["winning_query"] = best
    log(f"  interactive demo: winning object query {best}")
    return out


# the narrow widths of phase 16 (b): the heads at C=64, 4 heads, 3 layers
SEEM_NARROW = dict(hidden_dim=64, dim_proj=64, num_queries=11, nheads=4,
                   dim_feedforward=128, dec_layers=3, mask_dim=64, max_spatial_tokens=16)


def seed_seem(head, seed: int):
    """Dense kernels N(0, 1/fan-in), biases N(0, 0.1^2), norm scales
    1 + N(0, 0.1^2), queries and embeddings N(0, 1), the projections
    N(0, 1/C), the indicator N(0, 0.5^2): masks of both signs at every
    round."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in head.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            r = torch.randn(p.shape, generator=g)
            if leaf == "weight":
                p.copy_(1 + 0.1 * r if p.dim() == 1 else r / p.shape[1] ** 0.5)
            elif leaf == "bias":
                p.copy_(0.1 * r)
            elif leaf == "class_embed" or leaf.startswith("mask_spatial_embed"):
                p.copy_(r / p.shape[0] ** 0.5)
            else:
                p.copy_((0.5 if leaf == "pn_indicator" else 1.0) * r)
    return head


def forced_pair(seem, cpu_fn, card_fn):
    """``cpu_fn()`` with each pre-threshold resize and each binary mask
    recorded, then ``card_fn()`` forced onto the CPU's binary masks, its
    own resizes recorded. Returns both results, the max rel of the resized
    logits and the flips (a side of sigmoid 0.5 the two disagree on), each
    of which must lie within 1e-4 of the logits' scale of the threshold."""
    blocked, resize = seem._blocked, seem.resize_bilinear_torch
    logits_c, logits_g, masks = [], [], []

    def recording(store):
        def f(x, hw):
            y = resize(x, hw)
            store.append(y.detach().float().cpu())
            return y
        return f

    def keep(m, size):
        r = blocked(m, size)
        masks.append(r.cpu())
        return r

    try:
        seem.resize_bilinear_torch, seem._blocked = recording(logits_c), keep
        out_c = cpu_fn()
        it = iter(masks)

        def forced(m, size):
            blocked(m, size)
            return next(it).to(m.device)

        seem.resize_bilinear_torch, seem._blocked = recording(logits_g), forced
        out_g = card_fn()
    finally:
        seem.resize_bilinear_torch, seem._blocked = resize, blocked
    assert len(logits_g) == len(logits_c)
    rel, flips = 0.0, 0
    for g, c in zip(logits_g, logits_c):
        rel = max(rel, rel_err(g, c))
        f = (torch.sigmoid(g) < 0.5) != (torch.sigmoid(c) < 0.5)
        flips += int(f.sum())
        if f.any():
            assert c[f].abs().max() < 1e-4 * c.abs().max(), "flip off a near-tie"
    return out_c, out_g, rel, flips


def _flat_out(out):
    return {f"{k}[{i}]" if isinstance(v, list) else k: x
            for k, v in out.items() for i, x in enumerate(v if isinstance(v, list) else [v])}


def seem_heads_card_vs_cpu(mods, dev="cuda"):
    """(b) each SEEM head at narrow widths, f32, on the CPU and on the card
    forced onto the CPU's masks: v0 with grounding and memory, v1 over two
    masks (the second empty) with memory, the demo's refimg bundle, then
    the demo with all four prompt kinds (the bundle fed back)."""
    import copy

    seem = mods["seem"]
    C, S = SEEM_NARROW["hidden_dim"], SEEM_NARROW["max_spatial_tokens"]
    g = torch.Generator().manual_seed(16)

    def feats():
        return ([torch.randn((1, h, w, C), generator=g) for h, w in ((8, 12), (16, 24), (32, 48))],
                torch.randn((1, 64, 96, C), generator=g))

    (ms, mf), (rms, rmf) = feats(), feats()
    text = torch.nn.functional.normalize(torch.randn((5, C), generator=g), dim=-1)
    spatial = dict(spatial_points=torch.rand((1, S, 2), generator=g),
                   spatial_valid=torch.arange(S)[None] < 12,
                   spatial_posneg=torch.where(torch.arange(S)[None] < 7, 1, -1))
    grounding = dict(grounding_tokens=torch.randn((1, 4, C), generator=g),
                     grounding_valid=torch.tensor([[True, True, True, False]]))

    def to(x, d):
        if isinstance(x, torch.Tensor):
            return x.to(d)
        return [to(y, d) for y in x] if isinstance(x, (list, tuple)) else x

    out = {}

    def compare(name, head, args, kw):
        head = seed_seem(head, 17).eval()
        card = copy.deepcopy(head).to(dev)
        with torch.inference_mode():
            oc, og, rel, flips = forced_pair(
                seem, lambda: head(*args, **kw),
                lambda: card(*to(list(args), dev), **{k: to(v, dev) for k, v in kw.items()}))
        fc, fg = _flat_out(oc), _flat_out(og)
        assert set(fc) == set(fg), name
        assert all(torch.equal(fg[k].cpu(), fc[k]) for k in fc if fc[k].dtype == torch.bool)
        errs = {k: rel_err(fg[k], fc[k]) for k in fc if fc[k].dtype != torch.bool}
        assert max(errs.values()) < 1e-4, (name, errs)
        out[name] = dict(max_rel=max(errs.values()), logits_rel=rel, flips=flips)
        log(f"  card vs CPU, {name}: outputs max rel {max(errs.values()):.2e}, "
            f"pre-threshold logits rel {rel:.2e}, flips {flips}")
        return oc

    compare("SEEMHead", seem.SEEMHead(**SEEM_NARROW, num_spatial_memories=8,
                                      max_grounding_tokens=4),
            (ms, mf, text, 20.0),
            dict(spatial, **grounding, prev_mask=torch.randn((1, 1, 64, 96), generator=g)))
    compare("SEEMHeadV1", seem.SEEMHeadV1(**SEEM_NARROW, num_spatial_memories=8, sample_size=3),
            (ms, mf, text, 20.0, *spatial.values(),
             (torch.arange(S)[None] >= 12).long(),        # mask 1: no valid point
             torch.randint(0, SEEM_NARROW["num_queries"], (6,), generator=g)),
            dict(num_masks=2, prev_mask=torch.randn((1, 2, 64, 96), generator=g),
                 memory_indices=torch.randint(0, 2, (3, 8), generator=g)))
    demo = dict(max_grounding_tokens=4, max_audio_tokens=4)
    bundle = compare("SEEMHeadDemo refimg", seem.SEEMHeadDemo(**SEEM_NARROW, **demo),
                     (rms, rmf, text, 20.0), dict(spatial, task="refimg"))
    compare("SEEMHeadDemo", seem.SEEMHeadDemo(**SEEM_NARROW, **demo), (ms, mf, text, 20.0),
            dict(spatial, **grounding, audio_tokens=torch.randn((1, 4, C), generator=g),
                 audio_valid=torch.tensor([[True, False, True, True]]),
                 visual_tokens_by_level=bundle["src_visual_queries"],
                 visual_valid=bundle["src_visual_maskings"],
                 visual_query_pos=bundle["visual_query_pos"],
                 visual_query_neg=bundle["visual_query_neg"], task="demo"))
    return out


# the v1 loop of phase 16 (b): narrow widths over a 128x192 image (smaller
# maps let GroupNorm amplify f32 noise, ROADMAP's trap)
INTERACTIVE_NARROW = ["xdecoder.hidden_dim=64", "xdecoder.conv_dim=64", "xdecoder.mask_dim=64",
                      "xdecoder.num_queries=11", "xdecoder.nheads=4",
                      "xdecoder.dim_feedforward=128", "xdecoder.dec_layers=3",
                      "xdecoder.enc_layers=2", "xdecoder.backbone.embed_dim=16",
                      "xdecoder.backbone.depths=[1,1,2,1]"]


def interactive_loop_card_vs_cpu(mods, root: Path, dev="cuda"):
    """(b) ``run.infer_interactive.main --task v1`` at narrow widths on the
    CPU and on the card (the same seeded weights: ``build_models`` draws
    from a CPU generator), the card forced onto the CPU's masks: each
    round's mask logits within 1e-4, and with no flip the same overlay."""
    from PIL import Image

    inter = mods["inter"]
    img = root / "narrow.png"
    Image.fromarray(synthetic_photo(np.random.default_rng(17), (128, 192))).save(img)
    args = ["--image", str(img), "--task", "v1", "--rounds", str(INTERACTIVE_ROUNDS),
            "--budget", "16", "--clicks", "60,90;70,110", "--neg-clicks", "10,10",
            *INTERACTIVE_NARROW]
    rounds = {}

    def run(side):
        rounds[side] = []
        build = inter.build_models

        def hooked(*a, **k):
            m = build(*a, **k)
            m.head.register_forward_hook(
                lambda mod, i, o: rounds[side].append(o["prev_mask"].float().cpu()))
            return m

        inter.build_models = hooked
        try:
            return inter.main([*args, "--out", str(root / f"narrow_{side}.png"), "--device", side])
        finally:
            inter.build_models = build

    dst_c, dst_g, rel, flips = forced_pair(mods["seem"], lambda: run("cpu"), lambda: run(dev))
    assert len(rounds[dev]) == len(rounds["cpu"]) == INTERACTIVE_ROUNDS
    errs = [rel_err(g, c) for g, c in zip(rounds[dev], rounds["cpu"])]
    assert max(errs) < 1e-4, errs
    if flips == 0:
        assert np.array_equal(np.asarray(Image.open(dst_g)), np.asarray(Image.open(dst_c)))
    log(f"  card vs CPU, interactive v1 loop: mask logits rel "
        f"{', '.join(f'{e:.2e}' for e in errs)} by round, pre-threshold logits rel {rel:.2e}, "
        f"flips {flips}" + ("; overlays equal" if flips == 0 else ""))
    return dict(rounds_rel=errs, logits_rel=rel, flips=flips)


def phase_interactive(mods):
    """Phase 16: (a) the interactive entry at scannet's full width, (b)
    the card against the CPU at narrow widths. Neither kernel lies on this
    path: both counts are set to 0 before and must read 0 after."""
    band, nce = mods["band"], mods["nce"]
    band.banded_window_matmul.launches = 0
    nce.info_nce_fwd.launches = nce.info_nce_bwd.launches = 0
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t = time.perf_counter()
        out["entry"] = phase16_interactive(mods, root)
        out["entry_s"] = time.perf_counter() - t
        launches = (band.banded_window_matmul.launches, nce.info_nce_fwd.launches,
                    nce.info_nce_bwd.launches)
        out["launches"] = launches
        assert launches == (0, 0, 0), f"K1 / K2 launched on the interactive path: {launches}"
        t = time.perf_counter()
        prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            out["card_vs_cpu"] = seem_heads_card_vs_cpu(mods)
            out["card_vs_cpu"]["v1 loop"] = interactive_loop_card_vs_cpu(mods, root)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        out["card_vs_cpu_s"] = time.perf_counter() - t
    log(f"  K1, K2-fwd, K2-bwd launches on the interactive path: {launches}")
    return out


# ---------------------------------------------------------------------------
# Phase 17: the 2D trainer
# ---------------------------------------------------------------------------

# (a): ``run.train2d.main`` at ``scannet``'s full width, one run a row:
# (name, arguments, steps, config overrides)
TRAIN2D_RUNS = (
    ("seg", ["--task", "seg", "--synthetic"], 6, []),
    ("seg --resume", ["--task", "seg", "--synthetic"], 1, []),
    ("vlp", ["--task", "vlp", "--caption-len", "32"], 3, []),
    ("joint zip", ["--task", "joint", "--joint-mode", "zip"], 3, []),
    ("joint switch", ["--task", "joint", "--joint-mode", "switch"], 2, []),
    ("interactive", ["--task", "interactive", "--image-hw", "512x512"], 3, [SEEM_QUERIES]),
    ("seg --data-root", ["--task", "seg"], 2, []),
    ("joint zip --vlp-data-root", ["--task", "joint", "--joint-mode", "zip"], 2, []),
)


def write_train2d_data(root: Path, rng, n_images=4):
    """A COCO-json instance set (``coco/``: 480x640 photos, three polygon and
    one uncompressed-RLE instance each, two categories) and a caption set
    (``caps/``: the same photos, two captions each)."""
    from PIL import Image

    for sub in ("coco/images", "caps/images"):
        (root / sub).mkdir(parents=True)
    images, anns, caps = [], [], {}
    for i in range(n_images):
        img = synthetic_photo(rng)
        Image.fromarray(img).save(root / "coco" / "images" / f"{i}.png")
        Image.fromarray(img).save(root / "caps" / "images" / f"{i}.png")
        caps[f"{i}.png"] = [f"a synthetic room number {i}", "coloured boxes over noise"]
        images.append({"id": i, "file_name": f"images/{i}.png", "height": 480, "width": 640})
        for k in range(4):
            y0, x0 = int(rng.integers(0, 300)), int(rng.integers(0, 400))
            y1, x1 = y0 + int(rng.integers(40, 180)), x0 + int(rng.integers(40, 240))
            if k < 3:
                seg = [[x0, y0, x1, y0, x1, y1, x0, y1]]
            else:
                m = np.zeros((480, 640), bool)
                m[y0:y1, x0:x1] = True
                flat = m.reshape(-1, order="F")
                edges = np.flatnonzero(np.diff(np.concatenate([[False], flat, [not flat[-1]]])))
                seg = {"size": [480, 640], "counts": np.diff(np.concatenate([[0], edges])).tolist()}
            anns.append({"id": len(anns), "image_id": i, "category_id": 1 + k % 2,
                         "segmentation": seg})
    (root / "coco" / "annotations.json").write_text(json.dumps(
        {"images": images, "annotations": anns,
         "categories": [{"id": 1, "name": "chair"}, {"id": 2, "name": "table"}]}))
    (root / "caps" / "captions.json").write_text(json.dumps(caps))
    return root / "coco", root / "caps"


def instrument_train2d(t2d, crit, device="cuda"):
    """Wraps ``run.train2d``'s ``apply_step`` (each step timed, with the time
    its calls of the criterion's host Hungarian assignment and of
    ``Train2DOptimizer.step`` (clip + AdamW) took; the device synchronised
    before each timer starts), and ``new_state`` (the initial parameters
    kept on the card). Returns the record (``steps``: per step (step,
    Hungarian, optimizer) seconds) and a function that restores all four."""
    saved = (t2d.apply_step, crit.hungarian_match, t2d.Train2DOptimizer.step, t2d.new_state)
    apply_step, hungarian, opt_step, new_state = saved
    t = {"steps": [], "hungarian_s": [], "opt_s": [], "initial": None}

    def timed(fn, key):
        def run(*a, **k):
            sync(device)
            t0 = time.perf_counter()
            r = fn(*a, **k)
            sync(device)
            t[key].append(time.perf_counter() - t0)
            return r
        return run

    def step(*a, **k):
        n_h, n_o = len(t["hungarian_s"]), len(t["opt_s"])
        sync(device)
        t0 = time.perf_counter()
        r = apply_step(*a, **k)
        sync(device)
        t["steps"].append((time.perf_counter() - t0, sum(t["hungarian_s"][n_h:]),
                           sum(t["opt_s"][n_o:])))
        return r

    def keep_initial(r, params):
        state = new_state(r, params)
        t["initial"] = [p.detach().clone() for p in state.params.parameters()]
        return state

    t2d.apply_step = step
    crit.hungarian_match = timed(hungarian, "hungarian_s")
    t2d.Train2DOptimizer.step = timed(opt_step, "opt_s")
    t2d.new_state = keep_initial

    def restore():
        t2d.apply_step, crit.hungarian_match, t2d.Train2DOptimizer.step, t2d.new_state = saved
    return t, restore


def phase17_train2d(mods, root: Path, smi: str, device="cuda", preset="scannet", over=()):
    """(a) ``run.train2d.main`` at ``scannet``'s full width (FocalNet-L, the
    6-layer FPN, the 9-layer head, 512 wide with 201 queries, bf16 compute,
    f32 parameters, 4096 criterion points; the 12-layer language tower with
    49408 tokens): each run of ``TRAIN2D_RUNS`` with its seconds a step,
    the step's split (forward + backward, the host Hungarian, clip +
    AdamW), the peak memory, finite losses, parameters moved after step 2,
    a checkpoint. ``preset`` / ``over`` narrow it for a CPU rehearsal."""
    import contextlib
    import io

    import shutil

    t2d, crit = mods["train2d"], mods["crit"]
    coco, caps = write_train2d_data(root, np.random.default_rng(17))
    t, restore = instrument_train2d(t2d, crit, device)
    cuda = device == "cuda"
    out = {}
    try:
        for name, args, steps, overrides in TRAIN2D_RUNS:
            # the resumed run goes on in the first run's directory
            path = root / ("seg" if name.startswith("seg --resume") else
                           name.replace(" ", "").replace("--", "-"))
            extra = ["--save-path", str(path), "--steps", str(steps), "--print-every", "1",
                     "--num-points", "4096", "--preset", preset, "--device", device]
            if name == "seg --resume":
                extra += ["--resume", str(path / "ckpt")]
            if name.endswith("--data-root"):
                extra += ["--data-root", str(coco)]
            if name.endswith("--vlp-data-root"):
                extra += ["--data-root", str(coco), "--vlp-data-root", str(caps)]
            n_step = len(t["steps"])
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            sync(device)
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(io.StringIO()):
                state = t2d.main([*args, *extra, *overrides, *over])
            sync(device)
            secs = time.perf_counter() - t0
            recs = [json.loads(ln) for ln in (path / "metrics.jsonl").read_text().splitlines()]
            step0 = state.step - steps
            recs = [rc for rc in recs if rc["step"] > step0]
            assert [rc["step"] for rc in recs] == list(range(step0 + 1, state.step + 1)), recs
            assert all(np.isfinite(v) for rc in recs for k, v in rc.items()
                       if k.startswith("loss")), recs
            ckpt = sorted((path / "ckpt").glob("step_*.pt"))
            assert ckpt and ckpt[-1].name == f"step_{state.step}.pt", ckpt
            moved = sum(not torch.equal(a, p.detach()) for a, p in
                        zip(t["initial"], state.params.parameters()))
            n_params = len(t["initial"])
            if state.step >= 2 and name != "seg --resume":
                assert moved > n_params // 2, f"{name}: {moved} of {n_params} tensors moved"
            step_s, hung, opt = (list(c) for c in zip(*t["steps"][n_step:]))
            assert len(step_s) == steps
            r = dict(s=secs, steps=steps, step_s=step_s, hungarian_s=hung, opt_s=opt,
                     fwd_bwd_s=[s - h - o for s, h, o in zip(step_s, hung, opt)],
                     peak_GiB=torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0,
                     moved=f"{moved}/{n_params}", losses=[rc["loss"] for rc in recs],
                     n_params=int(sum(p.numel() for p in state.params.parameters())))
            out[name] = r
            later = slice(1, None) if len(step_s) > 1 else slice(None)
            log(f"  train2d {name} [{smi}]: {secs:.2f} s for {steps} step(s) + build + "
                f"checkpoint; s/step {', '.join(f'{v:.3f}' for v in step_s)} (from step 2: "
                f"mean {np.mean(step_s[later]):.3f}); fwd+bwd "
                f"{np.mean(r['fwd_bwd_s'][later]):.3f}, host Hungarian "
                f"{np.mean(hung[later]):.4f}, clip+AdamW "
                f"{np.mean(opt[later]):.4f} s; peak {r['peak_GiB']:.2f} GiB; "
                f"{r['n_params'] / 1e6:.1f} M parameters, {r['moved']} tensors moved; "
                f"losses {', '.join(f'{v:.4f}' for v in r['losses'])}")
            del state
            if name != "seg":           # its checkpoint is the resume's
                shutil.rmtree(path / "ckpt")
            if cuda:
                torch.cuda.empty_cache()
    finally:
        restore()
    return out


def _grads(params):
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().double().cpu()
            for k, p in params.named_parameters()}


def compare_losses_grads(cpu, card, tol=1e-4):
    """Losses within ``tol`` relative; every gradient leaf within ``tol`` of
    its norm, but a leaf whose CPU gradient is under 1e-6 of the whole
    gradient's norm (zero in exact arithmetic: an attention key bias, a
    norm's bias ahead of a GroupNorm), whose card gradient must stay under
    1e-5 of it. Returns the worst loss and gradient errors."""
    (lc, gc), (lg, gg) = cpu, card
    loss_err = max(rel_err(lg[k], lc[k]) for k in lc)
    assert loss_err < tol, (loss_err, lc, lg)
    total = float(torch.sqrt(sum((g ** 2).sum() for g in gc.values())))
    worst = 0.0
    for k, g in gc.items():
        n, d = float(g.norm()), float((gg[k] - g).norm())
        if n <= 1e-6 * total:
            assert float(gg[k].norm()) <= 1e-5 * total, (k, n)
            continue
        assert d <= tol * n, (k, d, n)
        worst = max(worst, d / n)
    return loss_err, worst


def train2d_card_vs_cpu(mods, dev="cuda"):
    """(b) one step's losses and gradients of each task on the card against
    the CPU, f32 with TF32 off, at the tiny widths of the CPU tests: the
    X-Decoder tasks with the card on the CPU's attention masks
    (``attn_mask_override``), the interactive task through ``forced_pair``;
    the criterion's points and the spatial queries' sample shared."""
    import copy

    t2d, seem = mods["train2d"], mods["seem"]
    from geopurify_tpu_torch.data.mappers import InteractiveMapper
    from geopurify_tpu_torch.data.visual_sampler import StrokeSamplerConfig
    from geopurify_tpu_torch.models.lang import PROMPT_TEMPLATES, HashTokenizer

    cfg = mods["cfg"].load_config("tiny", overrides=["xdecoder.mask_shape=[64,96]",
                                                     "text.width=16"])
    g = torch.Generator().manual_seed(170)
    cap_len, ls = 12, t2d.LOGIT_SCALE
    params = t2d.Train2DParams(model=t2d.build_model(cfg, g, caption_len=cap_len),
                               lang=t2d.build_lang(cfg, cap_len, g),
                               no_object=torch.randn(16, generator=g) * 0.5)
    rng = np.random.default_rng(171)
    seg = t2d.synthetic_batch(rng, 2, (64, 96), 4)
    imgs = torch.from_numpy(rng.uniform(0, 255, (2, 64, 96, 3)).astype(np.float32))
    vlp = (imgs, *t2d.synthetic_captions(rng, 2, cap_len, cfg.text.vocab_size))
    text = t2d.unit_rows(5, 16, g)
    tk = HashTokenizer(vocab_size=cfg.text.vocab_size, context_length=cap_len)
    class_ids = torch.from_numpy(tk([PROMPT_TEMPLATES[0].format(n)
                                     for n in cfg.data.all_label])[0])
    points = tuple(torch.randint(0, n, (256,), generator=g) for n in (16, 24))

    def run(p, device, loss, forced):
        p = p.to(device)
        p.zero_grad(set_to_none=True)
        to = (lambda x: x.to(device)) if device != "cpu" else (lambda x: x)
        losses = loss(p, to, forced)
        losses[0].backward()
        return {k: v.detach().cpu() for k, v in losses[1].items()}, _grads(p)

    def masks_of(p, images, text, caption_tokens=None):
        with torch.no_grad():
            return p.model(images, text, ls, caption_tokens=caption_tokens,
                           return_attn=True)["attn_masks"][:-1]

    def seg_loss(p, to, forced):
        return t2d.seg_losses(p, *map(to, seg), to(text), ls, 256, points=tuple(map(to, points)),
                              attn_mask_override=[to(m) for m in forced["seg"]])

    def vlp_loss(p, to, forced):
        return t2d.vlp_losses(p, *map(to, vlp), to(text), ls,
                              attn_mask_override=[to(m) for m in forced["vlp"]])

    def joint_seg_loss(p, to, forced):
        return t2d.joint_seg_losses(p, *map(to, seg), to(class_ids), ls, 256,
                                    points=tuple(map(to, points)),
                                    attn_mask_override=[to(m) for m in forced["jseg"]])

    def zip_loss(p, to, forced):
        return t2d.joint_zip_losses(
            p, tuple(map(to, seg)), tuple(map(to, vlp)), to(class_ids), ls, 256,
            points=tuple(map(to, points)),
            seg_kw=dict(attn_mask_override=[to(m) for m in forced["jseg"]]),
            vlp_kw=dict(attn_mask_override=[to(m) for m in forced["jvlp"]]))

    with torch.no_grad():
        tok, _ = params.lang.encode_tokens(vlp[1])
        ctext = t2d.class_text(params, class_ids)
    forced = {"seg": masks_of(params, seg[0], text), "vlp": masks_of(params, imgs, text, tok),
              "jseg": masks_of(params, seg[0], ctext), "jvlp": masks_of(params, imgs, ctext, tok)}
    out = {}
    for name, loss in (("seg", seg_loss), ("vlp", vlp_loss), ("joint seg", joint_seg_loss),
                       ("joint zip", zip_loss)):
        cpu = run(params, "cpu", loss, forced)
        card = run(copy.deepcopy(params), dev, loss, forced)
        out[name] = compare_losses_grads(cpu, card)

    # the interactive task: SEEM v1 on the visual sampler's prompts
    xc = dataclasses.replace(cfg.xdecoder, mask_shape=(64, 64))
    from geopurify_tpu_torch.models.layers import flax_init_
    from geopurify_tpu_torch.models.xdecoder import _make_backbone, _make_pixel_decoder

    head = seem.SEEMHeadV1(hidden_dim=16, dim_proj=16, num_queries=xc.num_queries, nheads=2,
                           dim_feedforward=32, dec_layers=2, mask_dim=16, max_spatial_tokens=8)
    iparams = t2d.Train2DParams(backbone=_make_backbone(xc), pixdec=_make_pixel_decoder(xc),
                                head=head)
    flax_init_(iparams, g)
    seed_seem(iparams.head, 172)
    mapper = InteractiveMapper(image_size=64, sampler_cfg=StrokeSamplerConfig(max_candidate=2),
                               grounding=False)
    batch = t2d.synthetic_interactive_batch(rng, mapper, 1, (64, 64), 3, 2, 8)
    qidx = torch.from_numpy(rng.integers(0, xc.num_queries, 6))
    itext = text[:-2]

    def inter_loss(p, to, forced):
        return t2d.interactive_losses(p, *map(to, batch), to(itext), ls, to(qidx))

    cpu, card, rel, flips = forced_pair(
        seem, lambda: run(iparams, "cpu", inter_loss, None),
        lambda: run(copy.deepcopy(iparams), dev, inter_loss, None))
    out["interactive"] = (*compare_losses_grads(cpu, card), rel, flips)
    for name, r in out.items():
        log(f"  train2d card vs CPU {name}: losses rel {r[0]:.2e}, worst gradient leaf "
            f"{r[1]:.2e} of its norm"
            + (f", resized mask logits rel {r[2]:.2e}, flips {r[3]}" if len(r) > 2 else ""))
    return out


def phase_train2d(mods):
    """Phase 17: (a) ``run.train2d.main`` at scannet's full width, (b) the
    card against the CPU at tiny widths. Neither kernel lies on this path:
    both counts are set to 0 before and must read 0 after."""
    band, nce = mods["band"], mods["nce"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    band.banded_window_matmul.launches = 0
    nce.info_nce_fwd.launches = nce.info_nce_bwd.launches = 0
    out = {"card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        out["entry"] = phase17_train2d(mods, Path(tmp), smi)
        out["entry_s"] = time.perf_counter() - t
    launches = (band.banded_window_matmul.launches, nce.info_nce_fwd.launches,
                nce.info_nce_bwd.launches)
    out["launches"] = launches
    assert launches == (0, 0, 0), f"K1 / K2 launched on the 2D trainer's path: {launches}"
    t = time.perf_counter()
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out["card_vs_cpu"] = train2d_card_vs_cpu(mods)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    out["card_vs_cpu_s"] = time.perf_counter() - t
    log(f"  K1, K2-fwd, K2-bwd launches on the 2D trainer's path: {launches}; entry runs "
        f"{out['entry_s']:.1f} s, card vs CPU {out['card_vs_cpu_s']:.1f} s [{smi}]")
    return out


# ---------------------------------------------------------------------------
# phase 18: the data-preparation path: a raw ScanNet scan through
# geopurify-torch-preprocess into run.validate.main, the host load by part,
# and the parity dump / compare
# ---------------------------------------------------------------------------

SCANNET_DEPTH_K = np.array([[577.870605, 0.0, 319.5], [0.0, 577.870605, 239.5],
                            [0.0, 0.0, 1.0]])
# NYU40 ids of the room's parts, and the raw ScanNet category ids a
# label-filt image carries (the label tsv maps the one to the other)
ROOM_NYU40 = dict(wall=1, floor=2, cabinet=3, bed=4, chair=5, sofa=6, table=7, door=8,
                  window=9, bookshelf=10, picture=11, desk=14)


def raw_room(seed: int, n: int, size=(6.0, 5.0, 3.0)):
    """~``n`` surface points of a ``size`` (x, y, z metres) room: the floor,
    four walls with a door, a window and a picture on them, and furniture
    boxes (their tops and sides) standing on the floor, uniform by area,
    with NYU40 labels and label-coloured uint8 RGB."""
    X, Y, Z = size
    rects = [((0, 0, 0), (X, 0, 0), (0, Y, 0), "floor"),
             ((0, 0, 0), (X, 0, 0), (0, 0, Z), "wall"), ((0, Y, 0), (X, 0, 0), (0, 0, Z), "wall"),
             ((0, 0, 0), (0, Y, 0), (0, 0, Z), "wall"), ((X, 0, 0), (0, Y, 0), (0, 0, Z), "wall"),
             ((1.0, 0.01, 0.0), (0.9, 0, 0), (0, 0, 2.1), "door"),
             ((X - 0.01, 1.5, 1.0), (0, 1.6, 0), (0, 0, 1.2), "window"),
             ((2.5, Y - 0.01, 1.4), (1.0, 0, 0), (0, 0, 0.7), "picture")]
    boxes = [((0.4, 3.2, 0.0), (2.0, 1.5, 0.5), "bed"), ((2.8, 1.6, 0.0), (1.4, 0.8, 0.75), "table"),
             ((2.9, 0.9, 0.0), (0.45, 0.45, 0.9), "chair"), ((3.6, 2.6, 0.0), (0.45, 0.45, 0.9), "chair"),
             ((4.6, 4.1, 0.0), (1.2, 0.6, 0.8), "desk"), ((5.4, 0.2, 0.0), (0.5, 1.1, 1.8), "bookshelf"),
             ((0.2, 0.5, 0.0), (0.5, 0.9, 1.2), "cabinet"), ((2.6, 3.9, 0.0), (1.8, 0.8, 0.7), "sofa")]
    for (x0, y0, z0), (dx, dy, dz), name in boxes:
        top = z0 + dz
        rects += [((x0, y0, top), (dx, 0, 0), (0, dy, 0), name),
                  ((x0, y0, z0), (dx, 0, 0), (0, 0, dz), name),
                  ((x0, y0 + dy, z0), (dx, 0, 0), (0, 0, dz), name),
                  ((x0, y0, z0), (0, dy, 0), (0, 0, dz), name),
                  ((x0 + dx, y0, z0), (0, dy, 0), (0, 0, dz), name)]
    o, u, v = (np.array([r[i] for r in rects], np.float64) for i in range(3))
    area = np.linalg.norm(np.cross(u, v), axis=1)
    rng = np.random.default_rng(seed)
    which = rng.choice(len(rects), n, p=area / area.sum())
    a, b = rng.random((n, 1)), rng.random((n, 1))
    pts = o[which] + a * u[which] + b * v[which] + rng.normal(scale=0.002, size=(n, 3))
    nyu = np.array([ROOM_NYU40[r[3]] for r in rects])[which]
    palette = rng.integers(40, 216, (41, 3))
    rgb = np.clip(palette[nyu] + rng.normal(scale=12, size=(n, 3)), 0, 255).astype(np.uint8)
    return pts.astype(np.float32), rgb, nyu


def write_ply_vertices(path: Path, pts, rgb, label=None):
    """A binary little-endian vertex PLY in ScanNet's property layout (x y z
    float, red green blue alpha uchar, and ``label`` ushort for the
    ``.labels.ply``)."""
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"), ("green", "u1"),
              ("blue", "u1"), ("alpha", "u1")] + ([("label", "<u2")] if label is not None else [])
    rec = np.empty(len(pts), np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = pts.T
    rec["red"], rec["green"], rec["blue"] = rgb.T
    rec["alpha"] = 255
    if label is not None:
        rec["label"] = label
    types = {"<f4": "float", "u1": "uchar", "<u2": "ushort"}
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {len(pts)}"]
    header += [f"property {types[t]} {name}" for name, t in fields] + ["end_header\n"]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())


def room_poses(n_frames: int, size=(6.0, 5.0, 3.0)):
    """Camera -> world poses on an ellipse 1.2-1.7 m up inside the room,
    turning twice around and looking across it, slightly down."""
    X, Y, _ = size
    from geopurify_tpu_torch.data.synthetic import _look_at

    poses = []
    for k in range(n_frames):
        t = 4 * np.pi * k / n_frames
        eye = np.array([X / 2 + 1.2 * np.cos(t / 2), Y / 2 + 0.9 * np.sin(t / 2),
                        1.45 + 0.25 * np.sin(3 * t)])
        target = np.array([X / 2 + 2.5 * np.cos(t + 0.3), Y / 2 + 2.2 * np.sin(t + 0.3), 0.7])
        poses.append(np.linalg.inv(_look_at(eye, target)))
    return poses


def write_raw_scannet(root: Path, sid: str, n_vertices: int, n_frames: int, device="cuda"):
    """A raw ScanNet scan under ``root/scans/<sid>``: ``<sid>_vh_clean_2.ply``
    and its ``.labels.ply`` (NYU40 ids), a version-4 ``<sid>.sens`` of
    ``n_frames`` frames (1296x968 JPEG colour and 640x480 zlib depth in
    millimetres, rendered from the points by the z-buffer, ScanNet's
    intrinsics, depth shift 1000), ``label-filt/<frame>.png`` raw category
    ids for every 20th frame, and ``root/labels.tsv`` (raw id -> NYU40)."""
    import struct
    import zlib
    from concurrent.futures import ThreadPoolExecutor
    from io import BytesIO

    from PIL import Image

    scan = root / "scans" / sid
    scan.mkdir(parents=True)
    pts, rgb, nyu = raw_room(7, n_vertices)
    write_ply_vertices(scan / f"{sid}_vh_clean_2.ply", pts, rgb)
    write_ply_vertices(scan / f"{sid}_vh_clean_2.labels.ply", pts, rgb, label=nyu)
    raw_id = {k: 100 + k for k in ROOM_NYU40.values()}
    (root / "labels.tsv").write_text("id\traw_category\tnyu40id\n" + "".join(
        f"{r}\tc{n}\t{n}\n" for n, r in raw_id.items()))
    (scan / "label-filt").mkdir()
    pts_t = torch.from_numpy(pts).to(device, torch.float64)
    rgb_t = torch.from_numpy(rgb).to(device)
    lab_t = torch.from_numpy(np.vectorize(raw_id.get)(nyu).astype(np.uint8)).to(device)
    Kc = SCANNET_K[:3, :3]

    def encode(args):
        color, mm = args
        buf = BytesIO()
        Image.fromarray(color).save(buf, format="JPEG", quality=90)
        return buf.getvalue(), zlib.compress(mm.tobytes())

    poses = room_poses(n_frames)
    with ThreadPoolExecutor(8) as ex:          # PIL and zlib release the GIL
        futures = []
        for k, pose in enumerate(poses):
            w2c = np.linalg.inv(pose)
            depth, _, _ = zbuffer(pts_t, w2c, SCANNET_DEPTH_K, 640, 480, 2, device)
            mm = torch.round(depth * 1000).clamp(0, 65535).to(torch.int32).cpu().numpy()
            _, pix, ids = zbuffer(pts_t, w2c, Kc, 1296, 968, 3, device)
            img = torch.full((968 * 1296, 3), 128, dtype=torch.uint8, device=device)
            img[pix] = rgb_t[ids]
            futures.append(ex.submit(encode, (img.reshape(968, 1296, 3).cpu().numpy(),
                                              mm.astype(np.uint16))))
            if k % 20 == 0:
                lab = torch.zeros(968 * 1296, dtype=torch.uint8, device=device)
                lab[pix] = lab_t[ids]
                Image.fromarray(lab.reshape(968, 1296).cpu().numpy()).save(
                    scan / "label-filt" / f"{k}.png")
        blobs = [f.result() for f in futures]
    K4 = lambda K: np.pad(K, ((0, 1), (0, 1))).astype(np.float32) + np.diag([0, 0, 0, 1])  # noqa: E731
    with open(scan / f"{sid}.sens", "wb") as f:
        f.write(struct.pack("I", 4))
        f.write(struct.pack("Q", 9) + b"synthetic")
        for m in (K4(Kc), np.eye(4), K4(SCANNET_DEPTH_K), np.eye(4)):
            f.write(np.asarray(m, np.float32).tobytes())
        f.write(struct.pack("<iiIIIIfQ", 2, 1, 1296, 968, 640, 480, 1000.0, n_frames))
        for pose, (cb, db) in zip(poses, blobs):
            f.write(pose.astype(np.float32).tobytes())
            f.write(struct.pack("<QQQQ", 0, 0, len(cb), len(db)))
            f.write(cb)
            f.write(db)


def host_load_by_part(mods, root: Path, sid: str, cfg):
    """The loader's host work on the preprocessed scene, part by part, the
    way ``SceneDataset.make_scene_batch`` does it: read the ``.pth``, the
    cameras, each view's colour and depth image (one pass each), then the
    mapping of every view (on the card, ``ops/projection.compute_mapping``,
    with its results copied back, against ``native.compute_mapping``:
    exact) and the voxel dedup (the loader's numpy route against
    ``native.fnv_voxelize``: bit-equal, and again at phase 10's 2^20
    points), each the least of 3 timed runs after a warm-up."""
    from geopurify_tpu_torch import native
    from geopurify_tpu_torch.data import cameras
    from geopurify_tpu_torch.ops import projection, voxelize

    loaders = mods["loaders"]
    fus = cfg.fusion
    W, H = fus.img_dim
    assert native.available(), "the native host library did not build"
    parts = {}
    t = time.perf_counter()
    sp = loaders.load_scene_any(str(root / "3d" / f"{sid}_vh_clean_2.pth"))
    parts["read_pth"] = time.perf_counter() - t
    t = time.perf_counter()
    cams = cameras.load_scene_cameras(str(root / "2d" / sid), frame_stride=fus.frame_stride,
                                      resolution_scale=fus.resolution_scale, points=sp.xyz)
    parts["cameras"] = time.perf_counter() - t
    parts.update(images=0.0, depths=0.0)
    views = []
    for cam in cams:
        t = time.perf_counter()
        loaders._load_image(cam.image_path, (W, H))
        parts["images"] += time.perf_counter() - t
        t = time.perf_counter()
        depth = loaders._load_depth(cam.depth_path, (W, H), fus.depth_scale)
        parts["depths"] += time.perf_counter() - t
        views.append((cam.world_to_camera,
                      loaders._scale_intrinsic(cam.intrinsic, (cam.width, cam.height), (W, H)),
                      depth))
    pts = torch.from_numpy(sp.xyz).to("cuda", torch.float64)
    card, parts["mapping_card"] = best_of(lambda: [
        [x.cpu().numpy() for x in projection.compute_mapping(
            pts, w2c, K, depth, (W, H), cut_bound=fus.cut_boundary,
            vis_thres=fus.visibility_threshold)] for w2c, K, depth in views], 3)
    nat, parts["mapping_native"] = best_of(lambda: [
        native.compute_mapping(sp.xyz, w2c, K, depth, (W, H), fus.cut_boundary,
                               fus.visibility_threshold) for w2c, K, depth in views], 3)
    mism = sum(int((a != b).sum()) for cv, nv in zip(card, nat) for a, b in zip(cv, nv))
    n_vis = sum(int(cv[2].sum()) for cv in card)

    def discrete(xyz):
        d = np.floor(xyz / cfg.data.voxel_size)
        return np.floor(d - d.min(0))

    def dedups(disc):
        """(native result, its s, numpy result, its s): the native FNV
        dedup beside the loader's numpy one."""
        nat, nat_s = best_of(lambda: native.fnv_voxelize(disc.astype(np.int64)), 3)
        ref, np_s = best_of(lambda: voxelize.sparse_quantize_np(disc), 3)
        return nat, nat_s, ref, np_s

    vox_nat, parts["voxelize_native"], vox_np, parts["voxelize_numpy"] = dedups(
        discrete(sp.xyz))
    vox_equal = all(np.array_equal(a, b) for a, b in zip(vox_nat, vox_np))
    # the same two at phase 10's scene size (2^20 points of a room)
    big_nat, big_nat_s, big_np, big_np_s = dedups(discrete(raw_room(11, 2**20)[0]))
    big_equal = all(np.array_equal(a, b) for a, b in zip(big_nat, big_np))
    # the loader's whole load again, warm (a new dataset: no cached scene)
    _, warm_s = best_of(lambda: loaders.SceneDataset(cfg, split="val", device="cuda")
                        .make_scene_batch(sid), 2)
    aside = ("mapping_native", "voxelize_native")
    rest = warm_s - sum(v for k, v in parts.items() if k not in aside)
    log(f"host load by part ({len(sp.xyz)} points, {len(cams)} views, {n_vis} point-views "
        f"visible): the loader warm {warm_s * 1e3:.1f} ms = "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in parts.items() if k not in aside)
        + f", the rest (padding, stacking, copies to the card) {rest * 1e3:.1f} ms; beside "
        f"them mapping_native {parts['mapping_native'] * 1e3:.1f} ms, voxelize_native "
        f"{parts['voxelize_native'] * 1e3:.1f} ms")
    log(f"voxel dedup at 2^20 points ({len(big_np[0])} voxels): native {big_nat_s * 1e3:.1f} ms, "
        f"numpy (the loader's) {big_np_s * 1e3:.1f} ms")
    log(f"host load checks: native mapping mismatches {mism}; native voxels bit-equal "
        f"{vox_equal} ({len(vox_np[0])} voxels), at 2^20 points {big_equal}")
    assert mism == 0, f"native.compute_mapping differs from the card's mapping in {mism} entries"
    assert vox_equal and big_equal, "native.fnv_voxelize differs from the numpy dedup"
    return dict(parts_s=parts, warm_load_s=warm_s, rest_s=rest, views=len(cams),
                visible=n_vis, mapping_mismatches=mism, voxels=len(vox_np[0]),
                voxelize_bit_equal=vox_equal,
                dedup_2e20=dict(voxels=len(big_np[0]), native_s=big_nat_s, numpy_s=big_np_s,
                                bit_equal=big_equal))


def parity_pair(parity, base, dump: Path, extra=()):
    """``run.parity.main`` with ``--dump`` on the card, then ``--device cpu
    --compare`` on that dump: (its exit status, worst rel, the printed
    lines, both seconds, the dump)."""
    import contextlib
    import io

    _, dump_s = synced(lambda: parity.main(base + ["--dump", str(dump), "--device", "cuda",
                                                   *extra]))
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        try:
            parity.main(base + ["--compare", str(dump), "--device", "cpu", *extra])
            code = None
        except SystemExit as e:
            code = e.code
    lines = out.getvalue().strip().splitlines()
    worst = float(lines[-1].split("worst rel ")[1].rstrip(")"))
    return code, worst, lines, dump_s, time.perf_counter() - t, dict(np.load(dump))


def phase18_parity(mods, root: Path):
    """``run.parity.main`` over a released-layout checkpoint (phase 12's):
    ``--dump`` on the card, then ``--device cpu --compare`` on that dump, at
    the default config (the X-Decoder in bf16) and with ``--dtype float32``
    (the card's TF32 off). The f32 pair must exit
    0. The bf16 pair's status and worst rel are recorded: both devices'
    bf16 runs lie ~1e-1 from their own f32 run at this depth (nine rounds
    of thresholded attention on bf16 logits), so across devices it may
    exceed the tool's 5e-2 limit; a FLAG line says so when it does."""
    from geopurify_tpu_torch.run import parity

    ckpt, mb, _ = released_xdecoder(mods, root)
    base = ["--ckpt", str(ckpt)]
    rec = {"checkpoint_mb": mb}
    for label, extra in (("default", ()), ("f32", ("--dtype", "float32"))):
        prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        if extra:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            code, worst, lines, dump_s, compare_s, acts = parity_pair(
                parity, base, root / f"parity_{label}.npz", extra)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        for line in lines:
            log(f"  parity {label} (CPU against the card's dump): {line}")
        log(f"parity {label}: dump on the card {dump_s:.1f} s, compare on the CPU "
            f"{compare_s:.1f} s, exit status {code}, worst rel {worst:.3e}")
        assert all(np.isfinite(v).all() for v in acts.values()), "non-finite parity dump"
        rec[label] = dict(exit=code, worst_rel=worst, dump_s=dump_s, compare_s=compare_s,
                          lines=lines, shapes={k: list(v.shape) for k, v in acts.items()})
    if rec["default"]["exit"] != 0:
        log(f"FLAG: run.parity at the default config (bf16): the CPU against the card's dump "
            f"gives worst rel {rec['default']['worst_rel']:.3e}, above the tool's 5e-2 limit; "
            f"in f32 {rec['f32']['worst_rel']:.3e}")
    assert rec["f32"]["exit"] == 0, f"run.parity --compare in f32 exited {rec['f32']['exit']}"
    return rec


def phase_prep(mods, n_vertices=150_000, n_frames=400):
    """Phase 18: (a) a raw ScanNet scan through ``preprocess.main``
    (``scannet-3d``, ``scannet-2d`` at its defaults with the label tsv);
    (b) ``run.validate.main --device cuda`` at ``scannet`` over that output,
    K1 launched 19 times (its count set to 0 just before), K2 none; (c) the
    host load by part; (d) the parity dump on the card and its compare on
    the CPU, at the default config and in f32."""
    from geopurify_tpu_torch.data import preprocess

    band, nce = mods["band"], mods["nce"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    sid = "scene0707_00"
    rec = {"card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t = time.perf_counter()
        write_raw_scannet(root, sid, n_vertices, n_frames)
        rec["write_raw_s"] = time.perf_counter() - t
        sens_mb = (root / "scans" / sid / f"{sid}.sens").stat().st_size / 1e6
        scans = str(root / "scans")
        t = time.perf_counter()
        preprocess.main(["scannet-3d", "--scans", scans, "--out", str(root / "3d")])
        rec["preprocess_3d_s"] = time.perf_counter() - t
        t = time.perf_counter()
        preprocess.main(["scannet-2d", "--scans", scans, "--out", str(root / "2d"),
                         "--label-map", str(root / "labels.tsv")])
        rec["preprocess_2d_s"] = time.perf_counter() - t
        d2 = root / "2d" / sid
        n_out = {sub: len(os.listdir(d2 / sub)) for sub in ("color", "depth", "pose", "label")}
        coords, colors, labels = torch.load(root / "3d" / f"{sid}_vh_clean_2.pth",
                                            weights_only=False)
        log(f"raw scan: {n_vertices} vertices, {n_frames} frames ({sens_mb:.0f} MB .sens) "
            f"written in {rec['write_raw_s']:.1f} s; preprocess scannet-3d "
            f"{rec['preprocess_3d_s']:.2f} s, scannet-2d {rec['preprocess_2d_s']:.2f} s -> "
            f"{n_out}; labels {np.unique(labels).astype(int).tolist()}")
        assert coords.shape == (n_vertices, 3) and n_out == dict.fromkeys(n_out, n_frames // 20)
        assert set(np.unique(labels)) <= set(range(20)) | {255} and (labels < 20).all()
        # the loader's layout: the 320x240 stream's intrinsics as the scene's
        # colour intrinsics; the preprocess already took every 20th frame
        (d2 / "intrinsic").mkdir()
        np.savetxt(d2 / "intrinsic" / "intrinsic_color.txt", np.loadtxt(root / "2d" / "intrinsics.txt"))
        (root / "list.txt").write_text(sid + "\n")
        over = PRESET_OVERRIDES + dataset_overrides(root) + [
            "fusion.frame_stride=1", "fusion.resolution_scale=1.0"]
        cfg = mods["cfg"].load_config("scannet", overrides=over)
        band.banded_window_matmul.launches = 0
        nce.info_nce_fwd.launches = nce.info_nce_bwd.launches = 0
        with Instrument(mods) as ins:
            t = time.perf_counter()
            result = mods["validate"].main(["--preset", "scannet", "--device", "cuda"] + over)
            rec["validate_s"] = time.perf_counter() - t
        launches = (band.banded_window_matmul.launches, nce.info_nce_fwd.launches,
                    nce.info_nce_bwd.launches)
        (r,) = ins.scenes
        st = r["stages"]
        log(f"run.validate.main over the preprocessed scene: load {r['load_s']:.2f} s (P={r['P']}, "
            f"{r['points']} points, M={r['M']}, {r['voxels']} voxels, {r['views']} of V={r['V']} "
            f"views); evaluate {r['seconds']:.2f} s = views {st['views']:.2f} + fuse_fill "
            f"{st['fuse_fill']:.2f} + pool_classify {st['pool_classify']:.2f}; K1, K2-fwd, "
            f"K2-bwd launches {launches}, band_overflow {r['band_overflow']}, peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB; {r['covered']:.1%} of the points seen, "
            f"{r['predicted']} classes predicted; mIoU {result['summary']['all']}")
        assert r["points"] == n_vertices and r["views"] >= 0.75 * (n_frames // 20), r
        assert launches == (cfg.pooling.num_iterations, 0, 0), launches
        assert r["k1_launches"] == cfg.pooling.num_iterations and r["band_overflow"] == 0
        assert r["finite"] and r["covered"] > 0.5, r
        assert all(np.isfinite(v) for g in result["summary"].values() for v in g.values())
        rec.update(scene=r, launches=launches, result=result)
        rec["host_load"] = host_load_by_part(mods, root, sid, cfg)
        log(f"a scene: preprocess 3D {rec['preprocess_3d_s']:.2f} s + 2D "
            f"{rec['preprocess_2d_s']:.2f} s, host load {r['load_s']:.2f} s, evaluate "
            f"{r['seconds']:.2f} s [{smi}]")
        rec["parity"] = phase18_parity(mods, root)
    return rec


# ---------------------------------------------------------------------------
# phase 19: the bench entry point
# ---------------------------------------------------------------------------

# (label, flags, metric) of each run of ``python -m geopurify_tpu_torch.run.bench``
BENCH_RUNS = (
    ("default", ["--scenes", "8"], "stage2_scenes_per_sec"),
    ("profile", ["--profile-stages", "--scenes", "2"], "stage2_scenes_per_sec"),
    ("views64", ["--views", "64", "--scenes", "2"], "stage2_scenes_per_sec_v64"),
    ("preset", ["--preset-scale", "--scenes", "2"], "stage2_scenes_per_sec_preset_scale"),
    ("resident", ["--resident", "--scenes", "4"], "stage2_scenes_per_sec"),
    ("prefetch", ["--prefetch-h2d", "--scenes", "4"], "stage2_scenes_per_sec"),
    ("stage1", ["--stage1", "--profile-stages", "--scenes", "5"], "stage1_steps_per_sec"),
    ("view_parallel", ["--view-parallel", "2", "--scenes", "2"], "stage2_scenes_per_sec"),
    # the 8 data-parallel gloo ranks on this host's CPU (the CPU tests skip it)
    ("stage1_smoke", ["--smoke", "--stage1", "--scenes", "2"], "stage1_steps_per_sec"),
)


def bench_launches(flags) -> dict:
    """The kernels' launches a bench run must report: K1 19 times a pass of
    the smoothing (the warm-up, with --profile-stages two timed passes and
    one counted by ``compiled_costs``, each timed scene; rank 0's under
    --view-parallel); K2 forward and backward once a Stage-1 step (the
    warm-up, each timed step, with --profile-stages 5 timed forward +
    backward passes); none on the CPU."""
    n = int(flags[flags.index("--scenes") + 1])
    profile = "--profile-stages" in flags
    if "--smoke" in flags:
        return dict(banded_window_matmul=0, info_nce_fwd=0, info_nce_bwd=0)
    if "--stage1" in flags:
        steps = 1 + n + (5 if profile else 0)
        return dict(banded_window_matmul=0, info_nce_fwd=steps, info_nce_bwd=steps)
    return dict(banded_window_matmul=19 * (1 + (3 if profile else 0) + n),
                info_nce_fwd=0, info_nce_bwd=0)


def phase_bench(main_rec=None, timeout_s=300):
    """Each bench mode as a user runs it, in a process of its own: exactly one
    JSON line on stdout with the mode's metric, a finite positive value,
    the launch counts its stderr reports; the default run against phase 3's
    steady seconds a scene (a FLAG: line beyond 15%)."""
    runs = {}
    for label, flags, metric in BENCH_RUNS:
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "geopurify_tpu_torch.run.bench", *flags],
                              cwd=HERE, capture_output=True, text=True, timeout=timeout_s)
        wall = time.perf_counter() - t
        err = proc.stderr.splitlines()
        assert proc.returncode == 0, f"bench {label} exited {proc.returncode}:\n" + \
            "\n".join(err[-30:])
        lines = proc.stdout.splitlines()
        assert len(lines) == 1, f"bench {label}: stdout is not one line: {proc.stdout!r}"
        rec = json.loads(lines[0])
        launches = json.loads([x for x in err if x.startswith("launches: ")][-1][10:])
        log(f"bench {label} ({' '.join(flags)}): {lines[0]} in {wall:.1f} s")
        for x in err:
            log(f"  | {x}")
        assert rec["metric"] == metric and set(rec) == {"metric", "value", "unit",
                                                          "vs_baseline"}, rec
        assert np.isfinite(rec["value"]) and rec["value"] > 0, rec
        assert (rec["vs_baseline"] is None) == (metric == "stage1_steps_per_sec"), rec
        want = bench_launches(flags)
        assert launches == want, f"bench {label}: launches {launches}, expected {want}"
        runs[label] = dict(flags=flags, result=rec, launches=launches, wall_s=wall,
                           stderr=err)
    if main_rec is not None:
        bench_s = 1.0 / runs["default"]["result"]["value"]
        steady = main_rec["seconds_per_scene_steady"]
        gap = abs(bench_s - steady) / steady
        log(f"bench default {bench_s:.3f} s a scene against phase 3's steady "
            f"{steady:.3f} s ({gap:.1%} apart)")
        if gap > 0.15:
            log(f"FLAG: bench default run {bench_s:.3f} s a scene, {gap:.1%} from "
                f"phase 3's {steady:.3f} s")
    return runs


def load_mods():
    """The port's modules by short name (the rank processes of phase 13
    import them anew)."""
    sys.path.insert(0, str(HERE))
    from geopurify_tpu_torch import config as cfg_mod
    from geopurify_tpu_torch.data import batch as batch_mod
    from geopurify_tpu_torch.data import loaders as loaders_mod
    from geopurify_tpu_torch.data import synthetic as synth_mod
    from geopurify_tpu_torch.models import criterion as crit_mod
    from geopurify_tpu_torch.models import lang as lang_mod
    from geopurify_tpu_torch.models import inference2d as inf_mod
    from geopurify_tpu_torch.models import layers as layers_mod
    from geopurify_tpu_torch.models import lift as lift_mod
    from geopurify_tpu_torch.models import pipeline as pipe_mod
    from geopurify_tpu_torch.models import pixel_decoder_deform as pdd_mod
    from geopurify_tpu_torch.models import seem as seem_mod
    from geopurify_tpu_torch.models import student as student_mod
    from geopurify_tpu_torch.models import xdecoder as xdec_mod
    from geopurify_tpu_torch.ops import band as band_mod
    from geopurify_tpu_torch.ops import contrastive as ctr_mod
    from geopurify_tpu_torch.ops import infonce as nce_mod
    from geopurify_tpu_torch.ops import knn as knn_mod
    from geopurify_tpu_torch.ops import ms_deform_attn as msda_mod
    from geopurify_tpu_torch.ops import pooling as pool_mod
    from geopurify_tpu_torch.ops import sparse_conv as sc_mod
    from geopurify_tpu_torch.parallel import mesh as mesh_mod
    from geopurify_tpu_torch.run import dryrun as dryrun_mod
    from geopurify_tpu_torch.run import infer2d as infer2d_mod
    from geopurify_tpu_torch.run import infer_interactive as inter_mod
    from geopurify_tpu_torch.run import optim as optim_mod
    from geopurify_tpu_torch.run import precompute as precompute_mod
    from geopurify_tpu_torch.run import train as train_mod
    from geopurify_tpu_torch.run import train2d as train2d_mod
    from geopurify_tpu_torch.run import validate as validate_mod
    from geopurify_tpu_torch.utils import convert_sonata as convs_mod
    from geopurify_tpu_torch.utils import convert_xdecoder as convx_mod

    return dict(cfg=cfg_mod, batch=batch_mod, synth=synth_mod, pipe=pipe_mod,
                student=student_mod, ctr=ctr_mod, nce=nce_mod, knn=knn_mod,
                optim=optim_mod, train=train_mod, loaders=loaders_mod,
                validate=validate_mod, pool=pool_mod, band=band_mod, lang=lang_mod,
                xdec=xdec_mod, precompute=precompute_mod, convx=convx_mod, convs=convs_mod,
                mesh=mesh_mod, dryrun=dryrun_mod, lift=lift_mod, sc=sc_mod, inf=inf_mod,
                layers=layers_mod, pdd=pdd_mod, msda=msda_mod, infer2d=infer2d_mod,
                seem=seem_mod, inter=inter_mod, train2d=train2d_mod, crit=crit_mod)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a CUDA card",
              file=sys.stderr)
        return 1
    mods = load_mods()
    band_mod, nce_mod, train_mod = mods["band"], mods["nce"], mods["train"]
    cfg_mod, pipe_mod, batch_mod, pool_mod = (mods[k] for k in ("cfg", "pipe", "batch",
                                                                 "pool"))
    from geopurify_tpu_torch.utils.cuda_build import SOURCES, build_all

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t = time.perf_counter()
    logs = build_all()
    build_s = time.perf_counter() - t
    log(f"built {', '.join(SOURCES)} in {build_s:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "entry function" in line:
                log(f"  ptxas[{name}]: {line.split(': ', 1)[-1].strip()}")
            elif "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas[{name}]:   {line.split(': ', 1)[-1].strip()}")
    phase_s = {"1 build": build_s}

    def run(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        phase_s[label] = time.perf_counter() - t0
        log(f"phase {label}: {phase_s[label]:.1f} s")
        return out

    k1 = run("2 K1", phase_k1, band_mod)
    main_rec = run("3 Stage-2 main path", phase_main, cfg_mod, pipe_mod, batch_mod,
                   band_mod, pool_mod)
    small = run("4 Stage-2 card vs CPU", phase_small, cfg_mod, pipe_mod, batch_mod, band_mod)
    k2 = run("5 K2", phase_k2, nce_mod)
    stage1 = run("6 Stage-1 main path", phase_stage1, mods)
    train_rec = run("7 run.train.main", phase_train_main, nce_mod, train_mod)
    stage1_small = run("8 Stage-1 card vs CPU", phase_stage1_small, mods)
    k1_wide = run("9 K1 wide", phase_k1_wide, band_mod)
    with tempfile.TemporaryDirectory() as scenes10:
        preset, scene0 = run("10 preset-scale validation", phase_preset_validation, mods,
                             Path(scenes10))
        val_small = run("11 validation card vs CPU", phase_validation_small, mods)
        released = run("12 released checkpoints, on-disk Stage 1", phase_released, mods)
        parallel = run("13 parallel layer", phase_parallel, mods, Path(scenes10))
    grid = run("14 pruned searches and z-stack", phase_grid_search, mods, scene0)
    two_d = run("15 the 2D family", phase_2d, mods)
    interactive = run("16 the interactive path", phase_interactive, mods)
    train2d = run("17 the 2D trainer", phase_train2d, mods)
    prep = run("18 the data-preparation path", phase_prep, mods)
    bench = run("19 the bench", phase_bench, main_rec)

    # K1 at every shape a main path launched it: the bench-spec scenes
    # (phase 3), the scannet, scannet200 and feature-space preset-scale
    # validation (phase 10)
    k1_base = dict(route="cuda", source="geopurify_tpu_torch/csrc/band_matmul.cu",
                   replaces="geopurify_tpu/ops/pallas_band.py:115")
    k1_rows = [dict(name="banded_window_matmul", launches=main_rec["k1_launches"],
                    **k1_base, **k1[19])]
    for (M, band, C), preset_name in (((1 << 18, 6144, 19), "scannet"),
                                      ((1 << 18, 6144, 200), "scannet200"),
                                      ((1 << 18, 6144, 512), "feature")):
        k1_rows.append(dict(name=f"banded_window_matmul[M={M},band={band},C={C}]",
                            launches=preset[preset_name]["k1_launches"], **k1_base,
                            **k1_wide[(M, band, C)]))
    # phase 12's run.validate.main runs (xdecoder.ckpt and direct weights)
    k1_rows.append(dict(name="banded_window_matmul[M=262144,band=6144,C=19;xdecoder.ckpt]",
                        launches=released["k1_launches"], **k1_base,
                        **k1_wide[(1 << 18, 6144, 19)]))
    # a K1 row at a class count some preset smooths that the library call
    # beats is flagged on a line of its own and in the record, naming the
    # preset whether or not phase 10 ran it; it does not fail the run
    k1_behind = []
    measured = [((65536, 12288, C), row) for C, row in k1.items()] + list(k1_wide.items())
    for (M, band, C), r in measured:
        if C in K1_PRESETS and r["ms"] > r["library_ms"]:
            name = f"banded_window_matmul[M={M},band={band},C={C}]"
            k1_behind.append(name)
            log(f"FLAG: {name} ({K1_PRESETS[C]}) takes {r['ms']:.4f} ms a launch, "
                f"{r['ms'] / r['library_ms']:.2f}x torch.bmm over gathered windows "
                f"({r['library_ms']:.4f} ms)")
    # phase 13's run.validate.main --distributed, one 36- or 140-view scene a rank
    k1_rows.append(dict(name="banded_window_matmul[M=262144,band=6144,C=19;"
                             "validate --distributed, 2 ranks]",
                        launches=parallel["k1_launches"], **k1_base,
                        **k1_wide[(1 << 18, 6144, 19)]))
    # phase 18's run.validate.main over the scene geopurify-torch-preprocess wrote
    k1_rows.append(dict(name="banded_window_matmul[M=262144,band=6144,C=19;"
                             "preprocessed scene]",
                        launches=prep["launches"][0], **k1_base,
                        **k1_wide[(1 << 18, 6144, 19)]))
    # phase 19's bench runs: the bench-spec modes (rank 0's under
    # --view-parallel) and the preset-scale one
    k1_rows.append(dict(name="banded_window_matmul[run.bench]", launches=sum(
        r["launches"]["banded_window_matmul"] for label, r in bench.items()
        if label != "preset"), **k1_base, **k1[19]))
    k1_rows.append(dict(name="banded_window_matmul[M=262144,band=6144,C=19;"
                             "run.bench --preset-scale]",
                        launches=bench["preset"]["launches"]["banded_window_matmul"],
                        **k1_base, **k1_wide[(1 << 18, 6144, 19)]))
    # phase 6's step, phase 12's run.train.main over on-disk scenes and
    # phase 13's data-parallel steps (the same A=4096, NEG=63, E=128 shape)
    k2_rows = [dict(name=label, route="cuda", source="geopurify_tpu_torch/csrc/infonce.cu",
                    replaces=f"geopurify_tpu/ops/pallas_infonce.py:{line}",
                    launches=launches, **k2["rows"][name])
               for name, label, line, launches in (
                   ("info_nce_fwd", "info_nce_fwd", 128, stage1["k2_launches"][0]),
                   ("info_nce_bwd", "info_nce_bwd", 146, stage1["k2_launches"][1]),
                   ("info_nce_fwd", "info_nce_fwd[run.train.main on-disk]", 128,
                    released["k2_launches"][0]),
                   ("info_nce_bwd", "info_nce_bwd[run.train.main on-disk]", 146,
                    released["k2_launches"][1]),
                   ("info_nce_fwd", "info_nce_fwd[data-parallel, 2 ranks]", 128,
                    parallel["k2_launches"][0]),
                   ("info_nce_bwd", "info_nce_bwd[data-parallel, 2 ranks]", 146,
                    parallel["k2_launches"][1]),
                   ("info_nce_fwd", "info_nce_fwd[run.bench --stage1]", 128,
                    bench["stage1"]["launches"]["info_nce_fwd"]),
                   ("info_nce_bwd", "info_nce_bwd[run.bench --stage1]", 146,
                    bench["stage1"]["launches"]["info_nce_bwd"]))]
    record = dict(card=smi, phase_seconds=phase_s, k1=k1, main=main_rec, small=small,
                  k2=k2, stage1=stage1, train_main=train_rec, stage1_small=stage1_small,
                  k1_wide={str(k): v for k, v in k1_wide.items()},
                  k1_behind_library=k1_behind, preset=preset,
                  validation_small=val_small, released=released, parallel=parallel,
                  grid_search=grid, two_d=two_d, interactive=interactive, train2d=train2d,
                  prep=prep, bench=bench)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1, default=str))
    print(json.dumps({"kernels": k1_rows + k2_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
