#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port (geopurify_tpu_torch).

Needs one CUDA card (``torch.cuda.is_available()``) and the CUDA toolkit;
exits non-zero, printing no result, without them. Run from the repo root:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. the card's name and power limit; build every CUDA kernel from csrc/;
2. kernel K1 (banded-window matmul) against its plain PyTorch version at
   the Stage-2 shapes (M=65536, band=12288, C=19 and C=32), with its time,
   the plain version's, a torch.bmm yardstick and the bytes bound;
3. the main path at full width: ``GeoPurifyPipeline.evaluate_scene`` at
   the ``scannet`` preset (FocalNet-L X-Decoder in bf16, 518-512-128
   student, kNN-96 + 19 banded smoothing rounds) on 3 bench-spec scenes
   (P=131072, M=65536, V=8, Pv=16384, 484x648), seeded random weights,
   counting K1's launches; plus the gather path timed on one scene's graph
   and one more scene under torch.profiler (kernels by device time);
4. the same seeded pipeline at the small bench --smoke sizes on the card and
   on the CPU (plain versions): predictions must agree.

The line before the last holds the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. A fuller record goes to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 peak memory rate
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core peak
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


def phase_k1(band_mod, M=65536, band=12288, row_tile=2048):
    rows = {}
    for C in (19, 32):
        S, starts, f = k1_inputs(M, band, C, row_tile, seed=C)
        out = band_mod.banded_window_matmul(S, starts, f, band=band, row_tile=row_tile)
        torch.cuda.synchronize()
        ref = band_mod.banded_window_matmul_ref(S, starts, f, band=band, row_tile=row_tile)
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        # both sum exact bf16 products in f32, in different orders
        tol = 1e-4 * scale
        log(f"K1 C={C}: max_abs_err={err:.3e} (tolerance {tol:.3e}, "
            f"max|ref|={scale:.1f})")
        assert out.shape == (M, C) and torch.isfinite(out).all()
        assert err <= tol, f"K1 disagrees with its plain version at C={C}"
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
        rows[C] = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        log(f"K1 C={C}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.bmm {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
            f"{bound_ms / kernel_ms:.1%} of the bound")
        del S, f, FW, S3, out, ref
        torch.cuda.empty_cache()
    return rows


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
        for name, p in pipe.student.named_parameters():
            if name.endswith("kernel"):
                fan_in = p.shape[0] * p.shape[1]
            elif name.endswith("output_conv.weight"):
                fan_in = p.shape[1]
            else:
                continue
            p.copy_(torch.randn(p.shape, generator=g, device=device)
                    * (2.0 / fan_in) ** 0.5)


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
    seed_weights(pipe, 1, "cuda")
    n_params = sum(p.numel() for p in pipe.xdecoder.parameters())
    log(f"pipeline built in {time.perf_counter() - t0:.1f} s "
        f"(X-Decoder {n_params / 1e6:.1f} M parameters, {cfg.xdecoder.dtype})")
    hw = tuple(cfg.xdecoder.mask_shape)
    sp = BENCH_SPEC
    scenes = [batch_mod.build_scene(i + 1, sp["P"], sp["M"], sp["V"], sp["Pv"], hw)
              for i in range(n_scenes)]
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
        per_scene.append(dict(seconds=dt, band_overflow=out["band_overflow"], **st))
        log(f"scene {i}: {dt:.3f} s (views {st['views']:.3f}, fuse+fill "
            f"{st['fuse_fill']:.3f}, pool+classify {st['pool_classify']:.3f}) "
            f"band_overflow={out['band_overflow']}")
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
    prof = profile_scene(pipe, batch, sp["V"])
    steady = per_scene[1:] or per_scene
    return dict(scenes=per_scene, k1_launches=launches, peak_bytes=peak, profile=prof,
                seconds_per_scene_steady=sum(s["seconds"] for s in steady) / len(steady),
                graph_ms=graph_s * 1e3, gather_path_ms=gather_ms,
                banded_smoothing_ms=smooth_ms)


def profile_scene(pipe, batch, n_valid: int):
    """One more scene under torch.profiler: device kernels ranked by their
    own device time, and the device's busy share of the profiled wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pipe.evaluate_scene(batch, n_valid_views=n_valid)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages() if e.device_type == cuda),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    log(f"profiled scene: wall {wall_ms:.1f} ms (profiler on), device busy "
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
    # zero biases, norm scales near 1, N(0, 0.35^2) elsewhere: several
    # queries win and the points spread over several classes
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for mod in (cpu.xdecoder, cpu.student):
            for name, p in mod.named_parameters():
                r = torch.randn(p.shape, generator=g)
                if name.endswith("bias"):
                    p.zero_()
                elif "norm" in name and name.endswith("weight"):
                    p.copy_(1 + 0.1 * r)
                else:
                    p.copy_(0.35 * r)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from geopurify_tpu_torch import config as cfg_mod
    from geopurify_tpu_torch.data import batch as batch_mod
    from geopurify_tpu_torch.models import pipeline as pipe_mod
    from geopurify_tpu_torch.ops import band as band_mod
    from geopurify_tpu_torch.ops import pooling as pool_mod
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
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

    k1 = phase_k1(band_mod)
    main_rec = phase_main(cfg_mod, pipe_mod, batch_mod, band_mod, pool_mod)
    small = phase_small(cfg_mod, pipe_mod, batch_mod, band_mod)

    row = dict(name="banded_window_matmul", route="cuda",
               source="geopurify_tpu_torch/csrc/band_matmul.cu",
               replaces="geopurify_tpu/ops/pallas_band.py:115",
               launches=main_rec["k1_launches"], **k1[19])
    record = dict(card=smi, build_seconds=build_s, k1=k1, main=main_rec, small=small)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": [row]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
