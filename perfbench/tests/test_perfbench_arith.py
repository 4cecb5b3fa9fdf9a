"""The arithmetic of the metrics on hand-made records: the device-busy
union and the idle gaps, the rooflines, the MFU, the stage means, and the
kernels' counts against the port's own formulas."""

import importlib.util
from pathlib import Path

import pytest

from perfbench import peaks, readers, trace

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(f"m_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_busy_union_and_gaps():
    device = [("k1", 1.0, 2.0), ("copy", 1.5, 2.5), ("k2", 4.0, 5.0), ("late", 9.5, 12.0)]
    r = trace.reduce(device, (0.5, 10.0))
    assert r["window_s"] == pytest.approx(9.5)
    # [1, 2.5] + [4, 5] + [9.5, 10] (clipped to the window)
    assert r["busy_s"] == pytest.approx(1.5 + 1.0 + 0.5)
    assert r["kernels"]["late"]["seconds"] == pytest.approx(0.5)
    gaps = dict((n, s) for n, s in r["idle_gaps"])
    assert gaps["after k2"] == pytest.approx(4.5)           # [5, 9.5]
    assert gaps["after copy"] == pytest.approx(1.5)         # [2.5, 4]
    assert gaps["window start"] == pytest.approx(0.5)       # [0.5, 1]
    assert [n for n, _ in r["device_ops"]][0] in ("k1", "copy", "k2")


def test_merge_and_gaps_edges():
    assert trace.merge([(3, 4), (1, 2), (2, 3)]) == [(1, 4)]
    assert trace.gaps([], 0, 2) == [(0, 2)]
    assert trace.gaps([(0, 2)], 0, 2) == []


def _rec(stage, **kw):
    rec = {"cell": {"stage": stage}, "work": {}, "trace_items": 1, "item_seconds": [],
           "stage_seconds": [], "split": [], "trace": None}
    rec.update(kw)
    return rec


def test_roofline_and_mfu():
    f, b = peaks.k1_work(65536, 65536, 12288, 19, 32)
    least = peaks.bound_s(f, b)
    assert least == pytest.approx(b / peaks.HBM_BYTES_PER_S)
    kern = {"void band_matmul_kernel<32>": {"seconds": 19 * least / 0.75, "count": 19},
            "other": {"seconds": 1.0, "count": 3}}
    rec = _rec(2, work={"k1": {"flops": f, "bytes": b}, "flops_per_item": 9.89e12},
               trace={"kernels": kern, "window_s": 4.0, "busy_s": 3.0},
               item_seconds=[9.0, 1.0, 1.0])
    assert reader("k1_roofline.s2").read(rec) == pytest.approx(75.0)
    # steady items only (the first one was traced): 1 s a scene, 9.89e12 at 989e12
    assert reader("mfu.s2").read(rec) == pytest.approx(1.0)
    assert reader("idle_pct.s2").read(rec) == pytest.approx(25.0)
    # a Stage-2 reader reads nothing in a Stage-1 cell, nor without its kernel
    assert reader("k1_roofline.s2").read(dict(rec, cell={"stage": 1})) is None
    assert reader("k1_roofline.s2").read(dict(rec, trace={"kernels": {}, "window_s": 1,
                                                          "busy_s": 1})) is None


def test_k2_roofline_sums_both_kernels():
    fw, bw = peaks.k2_work(4096, 63, 128, False), peaks.k2_work(4096, 63, 128, True)
    t = peaks.bound_s(*fw) * 2 + peaks.bound_s(*bw) * 2
    kern = {"infonce_fwd_kernel<true>": {"seconds": t / 2, "count": 2},
            "infonce_bwd_kernel<true>": {"seconds": t / 2, "count": 2}}
    rec = _rec(1, work={"k2_fwd": {"flops": fw[0], "bytes": fw[1]},
                        "k2_bwd": {"flops": bw[0], "bytes": bw[1]}},
               trace={"kernels": kern, "window_s": 1.0, "busy_s": 1.0})
    assert reader("k2_roofline.s1").read(rec) == pytest.approx(100.0)


def test_stage_and_split_means():
    rec = _rec(2, stage_seconds=[{"views": 9.0, "fuse_fill": 9.0, "pool_classify": 9.0},
                                 {"views": 2.0, "fuse_fill": 0.1, "pool_classify": 0.5},
                                 {"views": 4.0, "fuse_fill": 0.3, "pool_classify": 0.7}])
    assert reader("views_s.s2").read(rec) == pytest.approx(3.0)
    assert reader("fuse_fill_s.s2").read(rec) == pytest.approx(0.2)
    assert reader("pool_classify_s.s2").read(rec) == pytest.approx(0.6)
    assert reader("sampler_s.s1").read(rec) is None
    rec1 = _rec(1, split=[{"sampler": 0.2, "update": 0.8}], trace_items=4)
    # fewer items than were traced: all of them
    assert reader("sampler_s.s1").read(rec1) == pytest.approx(0.2)
    assert reader("update_s.s1").read(rec1) == pytest.approx(0.8)
    assert readers.stage_mean(rec1, "views") is None


def test_kernel_counts_are_the_ports():
    from geopurify_tpu_torch.ops.band import banded_window_matmul_work
    from geopurify_tpu_torch.ops.infonce import info_nce_work

    for args in [(65536, 65536, 12288, 19, 32), (262144, 262144, 6144, 160, 128)]:
        assert peaks.k1_work(*args) == banded_window_matmul_work(*args)
    for bwd in (False, True):
        assert peaks.k2_work(4096, 63, 128, bwd) == info_nce_work(4096, 63, 128, bwd)


def test_centred_logit_gap_holds_the_points_apart():
    """A program that gives every point the reference's mean row reads 1 in
    ``logit_err_centred``; shuffled points read about
    sqrt(2); a global shift of the row moves only ``logit_err_scene``."""
    import torch

    from perfbench import compare

    g = torch.Generator().manual_seed(3)
    P, C = 4096, 19
    ref_logits = torch.randn(C, generator=g) * 50 + torch.randn(P, C, generator=g)
    ref = {"logits": ref_logits, "pred": ref_logits.argmax(-1)}
    idx, valid = torch.arange(P), torch.ones(P, dtype=torch.bool)

    def numbers(logits):
        return compare.stage2_numbers({"logits": logits, "pred": logits.argmax(-1)},
                                      ref, valid, idx)

    mean_row = ref_logits.mean(0, keepdim=True).expand(P, C)
    assert numbers(mean_row)["logit_err_centred"] == pytest.approx(1.0)
    shuffled = numbers(ref_logits[torch.randperm(P, generator=g)])
    assert shuffled["logit_err_centred"] == pytest.approx(2 ** 0.5, rel=0.05)
    shifted = numbers(ref_logits + 10.0)
    assert shifted["logit_err_centred"] == pytest.approx(0.0, abs=1e-5)
    assert shifted["logit_err_scene"] > 10.0
