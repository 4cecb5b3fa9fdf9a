#!/usr/bin/env python3
"""Where K1's wgmma kernel spends its time, measured on a CUDA card.

Builds ``geopurify_tpu_torch/csrc/band_matmul.cu`` four times into a
temporary directory: as it is, without its wgmma products, without its
F-window loads, and without its S loads (each removal leaves the pipeline,
its barriers and the stores in place). Times each through the C entry point
at M = R = 2^18, band 6144 (the preset-scale shape) for C = 40, 200 and
512, in turns (each variant twice, the second pass in reverse order),
beside torch.bmm over gathered windows. The variants' outputs are
meaningless; only their times are. Needs a card and nvcc. From the repo
root:

    python3 scripts/k1_ablate.py
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from geopurify_tpu_torch.ops.band import _plan  # noqa: E402
from geopurify_tpu_torch.utils import cuda_build  # noqa: E402

MMA = "Wgmma<BN>::mma(acc, da + 2 * kk, db + kk * (16 * AW * 2 >> 4));"
EXPECT = "clamp ? G::A_BYTES : G::STAGE_BYTES"
S_LOAD = "tma_load(sA + s * G::A_BYTES, &map_s, bar, c * BK, static_cast<int>(row0));"
F_LOAD = "if (!clamp) {"


def variants(src: str):
    for text in (MMA, EXPECT, S_LOAD, F_LOAD):
        assert text in src, f"band_matmul.cu no longer holds {text!r}"
    return {
        "as built": src,
        "no products": src.replace(MMA, ";"),
        "no F loads": src.replace(EXPECT, "G::A_BYTES").replace(F_LOAD, "if (false) {"),
        "no S loads": src.replace(EXPECT, "G::B_BYTES").replace(S_LOAD, ";"),
    }


def build(tmp: Path):
    src = (cuda_build.CSRC / "band_matmul.cu").read_text()
    procs = {}
    for i, (name, text) in enumerate(variants(src).items()):
        d = tmp / str(i)
        d.mkdir()
        for header in cuda_build.CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        (d / "k.cu").write_text(text)
        cmd = [cuda_build._nvcc(), cuda_build.ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-o", str(d / "k.so"), str(d / "k.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), d / "k.so")
    libs = {}
    for name, (proc, so) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(str(so))
        lib.band_matmul_wgmma.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + \
            [ctypes.c_void_p]
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_ablate: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    M, band, row_tile = 1 << 18, 6144, 2048
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        for C in (40, 200, 512):
            plan = _plan(C, row_tile)
            S, starts, f = chip_smoke.k1_inputs(M, band, C, row_tile, seed=C + band)
            out = torch.empty((M, plan.ldf), dtype=torch.float32, device="cuda")
            times = {}
            for name in list(libs) + list(libs)[::-1]:
                lib = libs[name]

                def call():
                    err = lib.band_matmul_wgmma(
                        S.data_ptr(), starts.data_ptr(), f.data_ptr(), out.data_ptr(), M, M,
                        C, band, row_tile, plan.bn, plan.ldf, plan.cluster,
                        torch.cuda.current_stream().cuda_stream)
                    assert err == 0, err

                times.setdefault(name, []).append(chip_smoke.cuda_ms(call, iters=20))
            FW = f[starts.long()[:, None] + torch.arange(band, device="cuda")[None]]
            S3 = S.reshape(M // row_tile, row_tile, band)
            bmm = chip_smoke.cuda_ms(lambda: torch.bmm(S3, FW), iters=20)
            print(f"C={C} (bn {plan.bn}, {plan.slabs} slab(s), cluster {plan.cluster}): "
                  + "; ".join(f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in times.items())
                  + f"; torch.bmm {bmm:.4f} ms", flush=True)
            del S, f, out, FW, S3
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
