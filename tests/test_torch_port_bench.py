"""The port's bench surface (geopurify_tpu_torch/run/bench.py) and its work
counter (utils/profiling.py: compiled_costs, mfu_table, hand_kernel) against
the JAX package's.

JAX counts a call's work with XLA's cost analysis of the compiled call;
the port counts the aten operations one call dispatches. On one matmul the
two agree exactly; on a SAME convolution they agree on the bytes and differ
on the FLOPs by the padded taps, which XLA skips and torch's formula
counts. The hand kernels K1 and K2 count their kernel's work on either
route. The bench runs here only at ``--smoke`` (the CPU); the JAX bench.py
is not run: its specs are cited by line (bench.py:346-409, :685-701).
"""

from __future__ import annotations

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.utils import profiling as jax_profiling
from geopurify_tpu_torch.ops import band, infonce
from geopurify_tpu_torch.run import bench
from geopurify_tpu_torch.utils import profiling


def test_compiled_costs_of_a_matmul_equal_xla():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(256, 512)).astype(np.float32)
    b = rng.normal(size=(512, 128)).astype(np.float32)
    xla = jax_profiling.compiled_costs(jax.jit(lambda x, y: x @ y), jnp.asarray(a),
                                       jnp.asarray(b))
    ours = profiling.compiled_costs(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    # 2 * 256 * 512 * 128 FLOPs; (256 x 512 + 512 x 128 + 256 x 128) f32
    assert xla == ours == {"flops": 33_554_432.0, "bytes": 917_504.0}


def test_compiled_costs_of_a_same_conv():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 32, 32, 16)).astype(np.float32)          # NHWC
    w = rng.normal(size=(3, 3, 16, 24)).astype(np.float32)           # HWIO

    def conv(x, w):
        return jax.lax.conv_general_dilated(x, w, (1, 1), "SAME",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    xla = jax_profiling.compiled_costs(jax.jit(conv), jnp.asarray(x), jnp.asarray(w))
    ours = profiling.compiled_costs(torch.nn.functional.conv2d, xt, wt, padding=1)
    # the same convolution on both sides
    np.testing.assert_allclose(
        torch.nn.functional.conv2d(xt, wt, padding=1).permute(0, 2, 3, 1).numpy(),
        np.asarray(conv(x, w)), rtol=1e-4, atol=1e-4)
    # bytes: input 1x32x32x16, kernel 3x3x16x24, output 1x32x32x24, f32
    assert xla["bytes"] == ours["bytes"] == 177_664.0
    # torch counts every tap, 2 * (32 * 32 * 24) * (3 * 3 * 16); XLA skips
    # the taps that fall on the SAME padding of the border pixels
    assert ours["flops"] == 7_077_888.0
    assert xla["flops"] == 6_786_048.0


def test_compiled_costs_take_composite_ops_apart_under_inference_mode():
    # under inference_mode linear / conv2d / einsum reach the counter whole;
    # it counts the matmuls and convolutions they are made of
    g = torch.Generator().manual_seed(2)
    x, w = torch.randn((64, 32), generator=g), torch.randn((32, 8), generator=g)
    lin = torch.nn.Linear(32, 16)
    img, k = torch.randn((1, 16, 32, 32), generator=g), torch.randn((24, 16, 3, 3), generator=g)
    calls = ((lin, (x,), {}, 2 * 64 * 32 * 16),
             (torch.einsum, ("ab,bc->ac", x, w), {}, 2 * 64 * 32 * 8),
             (torch.nn.functional.conv2d, (img, k), {"padding": 1}, 7_077_888))
    for fn, args, kwargs, flops in calls:
        plain = profiling.compiled_costs(fn, *args, **kwargs)
        with torch.inference_mode():
            inference = profiling.compiled_costs(fn, *args, **kwargs)
        assert plain["flops"] == inference["flops"] == flops
        assert inference["bytes"] == plain["bytes"]


def test_hand_kernels_count_their_kernel_work_not_their_route():
    g = torch.Generator().manual_seed(0)
    R, M, bw, C, row_tile = 512, 512, 64, 19, 128
    S = torch.randn((R, bw), generator=g).to(torch.bfloat16)
    f = torch.randn((M, C), generator=g).to(torch.bfloat16)
    starts = torch.tensor([0, 64, 128, 448], dtype=torch.int32)
    before = band.banded_window_matmul.launches
    k1 = profiling.compiled_costs(band.banded_window_matmul, S, starts, f, bw, row_tile)
    flops, bytes_ = band.banded_window_matmul_work(R, M, bw, C, 4)
    assert k1 == {"flops": flops, "bytes": bytes_} == {
        "flops": 2.0 * R * bw * C, "bytes": R * bw * 2 + M * C * 2 + 4 * 4 + R * C * 4}
    # the plain version it ran dispatches more bytes than the kernel moves
    plain = profiling.compiled_costs(band.banded_window_matmul_ref, S, starts, f, bw, row_tile)
    assert plain["bytes"] > k1["bytes"]
    assert band.banded_window_matmul.launches == before           # no launch on the CPU

    A, NEG, E = 64, 7, 16
    a, p = torch.randn((A, E), generator=g), torch.randn((A, E), generator=g)
    n = torch.randn((A, NEG, E), generator=g)
    valid = torch.rand((A,), generator=g) < 0.8
    gr = torch.rand((A,), generator=g)
    fwd = profiling.compiled_costs(infonce.info_nce_fwd, a, p, n, valid, 0.07)
    bwd = profiling.compiled_costs(infonce.info_nce_bwd, a, p, n, valid, 0.07, gr)
    for got, backward in ((fwd, False), (bwd, True)):
        flops, bytes_ = infonce.info_nce_work(A, NEG, E, backward)
        assert got == {"flops": flops, "bytes": float(bytes_)}
    emb = 4 * (2 * A * E + A * NEG * E)
    assert fwd["bytes"] == emb + A + 4 * A and bwd["bytes"] == 2 * emb + 5 * A
    # the fused loss through autograd: its forward and backward kernels
    # plus the ops around them, never the plain versions' ops
    xs = [x.clone().requires_grad_() for x in (a, p, n)]

    def loss_step():
        infonce.info_nce_loss_fused(*xs, valid, 0.07).backward()

    step = profiling.compiled_costs(loss_step)
    assert fwd["bytes"] + bwd["bytes"] < step["bytes"] < fwd["bytes"] + bwd["bytes"] + 4096
    assert step["flops"] == fwd["flops"] + bwd["flops"]


def test_mfu_table_matches_jax():
    rows = [("views", 0.352, {"flops": 3.1e13, "bytes": 4.2e11}, 1),
            ("lift_glue", 0.061, None, 1),
            ("pool+classify", 0.318, {"flops": 2.5e12, "bytes": 9.7e10}, 3),
            ("idle", 0.0, {"flops": 1.0, "bytes": 1.0}, 1)]
    for peaks in ((989.0, 3350.0), (197.0, 819.0)):
        assert profiling.mfu_table(rows, *peaks) == jax_profiling.mfu_table(rows, *peaks)
    assert profiling.mfu_table(rows) == jax_profiling.mfu_table(rows, 989.0, 3350.0)
    assert (profiling.H100_PEAK_TFLOPS_BF16, profiling.H100_PEAK_HBM_GBPS) == (989.0, 3350.0)


# bench.py:346-409 (config, scene shape, view micro-batch) and :685-701
# (metric and baseline); the Stage-1 smoke spec from :411-422
SPECS = {
    "smoke": (["--smoke"], (512, 256, 2, 128), 8, (8, 3, 16, 12288, 262144, 262144),
              "stage2_scenes_per_sec", 0.2),
    "default": ([], (131072, 65536, 8, 16384), 8, (96, 19, 512, 12288, 262144, 262144),
                "stage2_scenes_per_sec", 0.2),
    "views64": (["--views", "64"], (131072, 65536, 64, 16384), 64,
                (96, 19, 512, 12288, 262144, 262144), "stage2_scenes_per_sec_v64",
                1.0 / (3.8 + 0.15 * 64)),
    "preset": (["--preset-scale"], (2 ** 20, 2 ** 18, 32, 2 ** 16), 16,
               (96, 19, 512, 6144, 2 ** 21, 2 ** 21), "stage2_scenes_per_sec_preset_scale",
               0.025),
    "stage1_smoke": (["--stage1", "--smoke"], (4096, 2048, 2, 128), 8,
                     (8, 3, 16, 12288, 262144, 262144), "stage1_steps_per_sec", None),
}


@pytest.mark.parametrize("case", sorted(SPECS))
def test_bench_spec_and_metric_follow_bench_py(case):
    flags, shape, view_batch, pooling, metric, baseline = SPECS[case]
    args = bench.parse_args(flags)
    cfg, P, M, V, Pv = bench.bench_spec(args)
    assert (P, M, V, Pv) == shape
    assert cfg.xdecoder.view_batch == view_batch
    pc = cfg.pooling
    assert (pc.knn_k, pc.num_iterations, pc.feature_dim, pc.band, pc.max_residual,
            pc.res_chunk) == pooling
    smoke = "--smoke" in flags
    assert cfg.xdecoder.dtype == ("float32" if smoke else "bfloat16")
    assert len(cfg.data.all_label) == (4 if smoke else 19)
    assert tuple(cfg.xdecoder.mask_shape) == ((48, 64) if smoke else (484, 648))
    if "--stage1" in flags:
        cc = cfg.contrastive
        assert (cc.num_anchors, cc.spatial_knn_k, cc.fused_loss) == (256, 16, True)
    got_metric, got_baseline = bench.metric_and_baseline(args, V)
    assert got_metric == metric
    assert got_baseline == pytest.approx(baseline) if baseline else got_baseline is None


def test_bench_overrides_reach_the_config():
    args = bench.parse_args(["--views", "32", "--stage1", "xdecoder.view_batch=4",
                             "contrastive.fused_loss=false"])
    cfg, *_ = bench.bench_spec(args)
    assert cfg.xdecoder.view_batch == 4 and cfg.contrastive.fused_loss is False


@pytest.mark.parametrize("flags", [["--scenes", "1"], ["--stage1"], ["--preset-scale"],
                                   ["--view-parallel", "2"]])
def test_bench_modes_need_a_card(flags):
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(flags)


def test_bench_view_parallel_needs_its_ranks(monkeypatch):
    # a launcher's group of another size: JAX's message (bench.py:466-471)
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(SystemExit, match="--view-parallel 2 needs 2 devices, have 3"):
        bench.main(["--smoke", "--view-parallel", "2"])


def _one_json_line(out: str) -> dict:
    lines = out.splitlines()
    assert len(lines) == 1, out
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert np.isfinite(rec["value"]) and rec["value"] > 0
    return rec


@pytest.mark.parametrize("flags", [["--smoke", "--scenes", "2"],
                                   ["--smoke", "--profile-stages", "--scenes", "1"]])
def test_bench_smoke_prints_one_json_line(flags, capsys):
    assert bench.main(flags) == 0
    out, err = capsys.readouterr()
    rec = _one_json_line(out)
    assert rec["metric"] == "stage2_scenes_per_sec" and rec["unit"] == "scenes/sec"
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 0.2, rel=1e-3)
    assert "classes predicted" in err
    if "--profile-stages" in flags:
        table = err[err.index("stage "):].splitlines()
        assert [r.split()[0] for r in table[1:4]] == ["views", "lift_glue", "pool+classify"]
        # counted work beside each timed stage (a lift_glue wall at or below
        # 0 on the CPU prints n/a)
        assert "n/a" not in table[1] and "n/a" not in table[3]


@pytest.mark.slow
def test_bench_stage1_smoke_runs_eight_ranks(capsys):
    assert bench.main(["--smoke", "--stage1", "--scenes", "2"]) == 0
    rec = _one_json_line(capsys.readouterr().out)
    assert rec["metric"] == "stage1_steps_per_sec" and rec["vs_baseline"] is None


def test_bench_module_imports_no_jax():
    code = ("import sys, geopurify_tpu_torch.run.bench; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'geopurify_tpu')]; "
            "print(bad)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, check=True)
    assert proc.stdout.strip() == "[]"
