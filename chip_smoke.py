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
   scene the host load, views / fuse_fill / pool_classify, the kNN, K1's
   launches, band_overflow and peak memory;
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
   one scene.

A K1 row at a preset's class count (or feature space's 512) that is
slower than its library call is flagged (``FLAG:`` lines naming the preset,
``k1_behind_library`` in the record) without failing the run, whether or
not phase 10 ran that preset. The line before the last holds the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. A fuller record goes to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

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
    bytes_ = R * band * 2 + M * C * 2 + n_t * 4 + R * C * 4
    flops = 2.0 * R * band * C
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

def seed_weights(pipe, seed: int, device):
    """bench.py's teacher recipe (N(0, 1) x 0.02 for every parameter) and a
    He-normal student with identity BatchNorm statistics, from a seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for p in pipe.xdecoder.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=device) * 0.02)
    seed_student(pipe, g, device)


def seed_student(pipe, g: torch.Generator, device):
    """He-normal student kernels from ``g``; biases and BatchNorm as built."""
    with torch.no_grad():
        for name, p in pipe.student.named_parameters():
            if name.endswith("kernel"):
                fan_in = p.shape[0] * p.shape[1]
            elif name.endswith("output_conv.weight"):
                fan_in = p.shape[1]
            else:
                continue
            p.copy_(torch.randn(p.shape, generator=g, device=device)
                    * (2.0 / fan_in) ** 0.5)


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


def seed_lecun(pipe, seed: int, device):
    """The X-Decoder's matrices N(0, 1 / fan-in), zero biases, unit norm
    scales, from a seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in pipe.xdecoder.named_parameters():
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=g, device=device)
                        / float(np.prod(p.shape[1:])) ** 0.5)
            else:
                p.fill_(0.0 if name.endswith("bias") else 1.0)


def query_prompts(pipe, batch, seed: int):
    """Class prompts for a seeded X-Decoder: the embeddings of the queries
    that win the most points of ``batch``'s first view, one a class, and a
    random background row. Random prompts all pick the one class nearest
    the direction the seeded queries' embeddings share."""
    n_cls = pipe.text_embeddings.shape[0] - 1
    with torch.inference_mode():
        lift = pipe._view_step(batch, 0)
        table = lift.embed_table[0]                     # [Q + 1, C], L2-normed
        Q = table.shape[0] - 1
        top = torch.bincount(lift.winner[0].long(), minlength=Q + 1)[:Q].topk(n_cls).indices
    bg = text_embeddings(1, table.shape[1], seed).to(table.device)
    pipe.text_embeddings = torch.cat([table[top], bg])


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


def text_embeddings(n: int, dim: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    t = torch.randn((n, dim), generator=g)
    return t / t.norm(dim=-1, keepdim=True)


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
    cfg = cfg_mod.GeoPurifyConfig()
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, all_label=tuple(f"c{i}" for i in range(4))),
        student=cfg_mod.StudentConfig(input_dim=22, hidden_dim=16, embed_dim=8,
                                      num_res_blocks=1),
        pooling=cfg_mod.PoolingConfig(knn_k=8, num_iterations=3, feature_dim=16,
                                      band=128),
        xdecoder=cfg_mod.XDecoderConfig(
            backbone=cfg_mod.FocalNetConfig(embed_dim=8, depths=(1, 1, 1, 1)),
            hidden_dim=16, conv_dim=16, mask_dim=16, num_queries=5, nheads=2,
            dim_feedforward=32, dec_layers=2, enc_layers=1,
            mask_shape=(48, 64), dtype="float32",
        ),
    )


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
    """Each input read once and each output written once: a, p, n f32 and
    valid bool in; the per-anchor loss out (forward), or g in and da, dp,
    dn out (backward). Operations: ~4 E flops a row for its norm and its dot
    with the anchor (NEG + 2 rows), ~3x that backward, at the f32 rate."""
    emb = 4 * (2 * A * E + A * NEG * E)
    bytes_ = emb + A + (4 * A + emb if backward else 4 * A)
    flops = 4.0 * E * (NEG + 2) * A * (3 if backward else 1)
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

    def __init__(self, mods, seed=seed_released):
        self.mods, self.scenes, self.preds, self._undo = mods, [], [], []
        self.build_s = None
        self.seed = seed

    def _patch(self, owner, name, fn):
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, fn)

    def __enter__(self):
        loaders, pipe, pool, band, train = (
            self.mods[k] for k in ("loaders", "pipe", "pool", "band", "train"))
        load, evaluate, knn, build = (
            loaders.SceneDataset.make_scene_batch, pipe.GeoPurifyPipeline.evaluate_scene,
            pool.knn_self_grid, train.build_pipeline)
        rec = self

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
                                   voxels=int(batch.voxel_valid.sum())))
            return batch

        def evaluate_scene(self_, batch, *a, **k):
            torch.cuda.reset_peak_memory_stats()
            n0 = band.banded_window_matmul.launches
            t = time.perf_counter()
            out = evaluate(self_, batch, *a, **{**k, "profile": True})
            torch.cuda.synchronize()
            r = rec.scenes[-1]
            valid = batch.point_valid
            r.update(seconds=time.perf_counter() - t, stages=out["stage_seconds"],
                     k1_launches=band.banded_window_matmul.launches - n0,
                     band_overflow=int(out["band_overflow"]),
                     peak_bytes=torch.cuda.max_memory_allocated(),
                     finite=bool(torch.isfinite(out["logits"]).all()),
                     classes=int(out["logits"].shape[1]),
                     covered=float((out["view_count"][valid] > 0).float().mean()),
                     predicted=int(torch.unique(out["pred"][valid]).numel()))
            rec.preds.append((out["pred"].cpu(), out["logits"].cpu()))
            return out

        def knn_self_grid(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = knn(*a, **k)
            torch.cuda.synchronize()
            rec.scenes[-1]["knn_s"].append(time.perf_counter() - t)
            return res

        self._patch(loaders.SceneDataset, "make_scene_batch", make_scene_batch)
        self._patch(pipe.GeoPurifyPipeline, "evaluate_scene", evaluate_scene)
        self._patch(pool, "knn_self_grid", knn_self_grid)
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
                 extra=(), seed=seed_released):
    """``run.validate.main`` on the card over the first ``n_scenes`` of
    ``root``; the K1 count is set to 0 just before and read just after."""
    band = mods["band"]
    overrides = PRESET_OVERRIDES + list(extra)
    cfg = mods["cfg"].load_config(preset, overrides=overrides)
    args = ["--preset", preset, "--max-scenes", str(n_scenes)] + overrides + \
        dataset_overrides(root)
    band.banded_window_matmul.launches = 0
    with Instrument(mods, seed) as ins:
        t = time.perf_counter()
        result = mods["validate"].main(args)
        wall = time.perf_counter() - t
    launches = band.banded_window_matmul.launches
    n_cls = len(cfg.data.all_label)
    for i, r in enumerate(ins.scenes):
        st = r["stages"]
        log(f"{preset} {' '.join(extra)} scene {i} ({r['sid']}): load {r['load_s']:.2f} s (P={r['P']}, "
            f"{r['points']} points, M={r['M']}, {r['voxels']} voxels, {r['views']} of "
            f"V={r['V']} views, Pv={r['Pv']}); evaluate {r['seconds']:.2f} s = views "
            f"{st['views']:.2f} + fuse_fill {st['fuse_fill']:.2f} + pool_classify "
            f"{st['pool_classify']:.2f} (kNN {sum(r['knn_s']):.2f}); K1 launches "
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
    log(f"{preset} {' '.join(extra)}: run.validate.main over {len(ins.scenes)} scenes in {wall:.1f} s; "
        f"K1 launches {launches}; result {json.dumps(result)[:400]}")
    assert len(ins.scenes) == n_scenes and launches == n_scenes * cfg.pooling.num_iterations
    groups = result["summary"]
    assert set(groups) >= {"all", "base", "novel", "foreground"}
    assert all(np.isfinite(v) for g in groups.values() for v in g.values())
    assert len(result["per_class_iou"]) == cfg.data.test_classes
    assert result["scenes_per_sec"] > 0
    return dict(scenes=ins.scenes, k1_launches=launches, wall_s=wall, result=result,
                preds=ins.preds, build_s=ins.build_s)


def phase_preset_validation(mods, root: Path, views=(36, 140)):
    """Two scenes (36 views: the V=64 bucket; 140 views: V=256) written under
    ``root`` (phase 13 reads them again) through ``scannet``, then the first
    at ``scannet200`` and in feature space."""
    t = time.perf_counter()
    write_dataset(root, mods["batch"], views, 1 << 20, 1 << 18, frame_stride=20,
                  color_wh=(1296, 968), depth_wh=(640, 480), device="cuda", seed0=21)
    write_s = time.perf_counter() - t
    log(f"wrote {len(views)} ScanNet-layout scenes ({views} views) in {write_s:.1f} s")
    scannet = run_validate(mods, "scannet", root, len(views), min_views=32)
    assert [r["V"] for r in scannet["scenes"]] == [64, 256], scannet["scenes"]
    scannet200 = run_validate(mods, "scannet200", root, 1, min_views=32)
    feature = run_validate(mods, "scannet", root, 1, min_views=32,
                           extra=["pooling.smooth_space=feature"])
    for rec in (scannet, scannet200, feature):
        del rec["preds"]
    return dict(write_s=write_s, scannet=scannet, scannet200=scannet200, feature=feature)


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


def load_mods():
    """The port's modules by short name (the rank processes of phase 13
    import them anew)."""
    sys.path.insert(0, str(HERE))
    from geopurify_tpu_torch import config as cfg_mod
    from geopurify_tpu_torch.data import batch as batch_mod
    from geopurify_tpu_torch.data import loaders as loaders_mod
    from geopurify_tpu_torch.data import synthetic as synth_mod
    from geopurify_tpu_torch.models import lang as lang_mod
    from geopurify_tpu_torch.models import pipeline as pipe_mod
    from geopurify_tpu_torch.models import student as student_mod
    from geopurify_tpu_torch.models import xdecoder as xdec_mod
    from geopurify_tpu_torch.ops import band as band_mod
    from geopurify_tpu_torch.ops import contrastive as ctr_mod
    from geopurify_tpu_torch.ops import infonce as nce_mod
    from geopurify_tpu_torch.ops import knn as knn_mod
    from geopurify_tpu_torch.ops import pooling as pool_mod
    from geopurify_tpu_torch.parallel import mesh as mesh_mod
    from geopurify_tpu_torch.run import dryrun as dryrun_mod
    from geopurify_tpu_torch.run import optim as optim_mod
    from geopurify_tpu_torch.run import precompute as precompute_mod
    from geopurify_tpu_torch.run import train as train_mod
    from geopurify_tpu_torch.run import validate as validate_mod
    from geopurify_tpu_torch.utils import convert_sonata as convs_mod
    from geopurify_tpu_torch.utils import convert_xdecoder as convx_mod

    return dict(cfg=cfg_mod, batch=batch_mod, synth=synth_mod, pipe=pipe_mod,
                student=student_mod, ctr=ctr_mod, nce=nce_mod, knn=knn_mod,
                optim=optim_mod, train=train_mod, loaders=loaders_mod,
                validate=validate_mod, pool=pool_mod, band=band_mod, lang=lang_mod,
                xdec=xdec_mod, precompute=precompute_mod, convx=convx_mod, convs=convs_mod,
                mesh=mesh_mod, dryrun=dryrun_mod)


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
        preset = run("10 preset-scale validation", phase_preset_validation, mods,
                     Path(scenes10))
        val_small = run("11 validation card vs CPU", phase_validation_small, mods)
        released = run("12 released checkpoints, on-disk Stage 1", phase_released, mods)
        parallel = run("13 parallel layer", phase_parallel, mods, Path(scenes10))

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
                    parallel["k2_launches"][1]))]
    record = dict(card=smi, phase_seconds=phase_s, k1=k1, main=main_rec, small=small,
                  k2=k2, stage1=stage1, train_main=train_rec, stage1_small=stage1_small,
                  k1_wide={str(k): v for k, v in k1_wide.items()},
                  k1_behind_library=k1_behind, preset=preset,
                  validation_small=val_small, released=released, parallel=parallel)
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
