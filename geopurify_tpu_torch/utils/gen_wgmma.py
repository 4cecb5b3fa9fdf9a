"""Write ``csrc/wgmma_bf16.cuh``: one inline-PTX wrapper per wgmma width.

``wgmma.mma_async`` names every accumulator register in its operand list,
N / 2 of them for a 64 x N tile, and inline PTX numbers its operands, so a
wrapper cannot be written once for all N. This script writes one for each
column count of ``ops/band.py::WGMMA_COLS`` (the K1 instantiations) and an
X-macro listing them, which ``csrc/band_matmul.cu`` dispatches on. The
header is committed; ``tests/test_torch_port_band.py`` checks that it is
what this script writes. Run after editing ``WGMMA_COLS``:

    python -m geopurify_tpu_torch.utils.gen_wgmma
"""

from __future__ import annotations

from pathlib import Path

HEADER = Path(__file__).resolve().parent.parent / "csrc" / "wgmma_bf16.cuh"


def _wrapper(n: int) -> str:
    regs = n // 2                       # f32 accumulators a thread
    names = ", ".join(f"%{i}" for i in range(regs))
    outs = ",\n        ".join(
        ", ".join(f'"+f"(d[{j}])' for j in range(i, min(i + 8, regs)))
        for i in range(0, regs, 8))
    return f"""template <>
struct Wgmma<{n}> {{
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{names}}}, "
        "%{regs}, %{regs + 1}, p, 1, 1, 0, 1;\\n}}\\n"
        : {outs}
        : "l"(da), "l"(db), "r"(1));
  }}
}};
"""


def render(cols) -> str:
    body = "\n".join(_wrapper(n) for n in cols)
    listing = " ".join(f"X({n})" for n in cols)
    return f"""// Written by geopurify_tpu_torch/utils/gen_wgmma.py; do not edit by hand.
//
// wgmma.mma_async.m64nNk16 with f32 accumulators and bf16 A and B, both
// read from shared memory through matrix descriptors: A K-major, B MN-major
// (transpose flags 0 and 1), scale-d 1 (the accumulators start at zero). Thread
// t of the warpgroup holds d[4g + i] for the 8-column group g: rows
// 16 (t / 32) + (t % 32) / 4 (+ 8 for i >= 2), columns 8 g + 2 (t % 4)
// (+ 1 for odd i).
#pragma once

#include <stdint.h>

// the column counts K1 is instantiated for (ops/band.py::WGMMA_COLS)
#define WGMMA_COLS(X) {listing}

template <int N>
struct Wgmma;

{body}"""


def main() -> None:
    from geopurify_tpu_torch.ops.band import WGMMA_COLS

    HEADER.write_text(render(WGMMA_COLS))
    print(f"wrote {HEADER}")


if __name__ == "__main__":
    main()
