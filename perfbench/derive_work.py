"""Derive ``work/<cell>.json``: the operations of one item of a cell (a
scene in Stage 2, a step in Stage 1), counted once over the benchmark's
own plain reference at the cell's shapes, and the hand kernels' operations
and bytes a launch. The count is committed as data, so that it reads the
same work whatever implements it. The cell's runner counts its item
(``work(cell)``, as ``stage1.work`` and ``stage2.work`` do) with the
helpers here.

    python3 -m perfbench.derive_work <cell> [<cell> ...]

Counted: the multiply-adds (two operations each) of the layers' matrix
products and convolutions. The X-Decoder's are traced by
``torch.utils.flop_counter`` over the reference modules on the meta device
at one view; the rest follows the shapes, with the data-dependent parts
counted for what the cell's scenes need (a Stage-2 cell's: the mean over
its pool's rooms, the same in every run; a Stage-1 cell's: the room of
seed 0): the student's
3^3 convolutions over the neighbours that exist, the graph and the
smoothing rounds over the k live edges of each valid voxel. Not counted:
the searches (kNN, donors, sorting), the gathers and scatters, the
elementwise work (norms, softmax, AdamW).
"""

from __future__ import annotations

import json
import sys
from typing import Dict

import torch

from perfbench import cells

ROW_TILE = 2048      # the port's banded operator's row tile


def xdecoder_flops_per_view(program: dict, n_cls: int, hw) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.reference.xdecoder import XDecoderSegModel

    x = program["xdecoder"]
    with torch.device("meta"):
        model = XDecoderSegModel(x).requires_grad_(False)
        images = torch.zeros((1, hw[0], hw[1], 3))
        text = torch.zeros((n_cls + 1, x["hidden_dim"]))
    with FlopCounterMode(display=False) as fc:
        model(images, text, 20.0)
    return float(fc.get_total_flops())


def lift_flops_per_view(program: dict, n_cls: int, view_points: int, hw) -> float:
    """The winners' resampled masks at the points ([Pv, T] x [Pv, T, Q],
    T the bicubic taps of the stride-4 masks) and the query table's logits."""
    from perfbench.reference.layers import _aa_resize_taps

    x = program["xdecoder"]
    h, w = -(-hw[0] // 32) * 8, -(-hw[1] // 32) * 8
    taps = _aa_resize_taps(h, hw[0])[1].shape[1] * _aa_resize_taps(w, hw[1])[1].shape[1]
    Q = x["num_queries"] - 1
    return 2.0 * view_points * taps * Q + 2.0 * Q * x["hidden_dim"] * n_cls


def student_flops(program: dict, scene: dict, backward: bool) -> Dict[str, float]:
    """The student's convolutions over the neighbours that exist (the
    centre tap included), forward, and twice that again backward (the
    input's and the weights' gradients)."""
    from perfbench.reference.sparse_conv import build_neighbor_table

    s = program["student"]
    coords = torch.from_numpy(scene["voxel_coords"])
    valid = torch.from_numpy(scene["voxel_valid"])
    M = coords.shape[0]
    taps = int((build_neighbor_table(coords, valid) < M).sum())
    n_valid = int(valid.sum())
    H = s["hidden_dim"]
    fwd = 2.0 * taps * (s["input_dim"] * H + 2 * s["num_res_blocks"] * H * H)
    fwd += 2.0 * n_valid * H * s["embed_dim"]
    return {"student": fwd * (3 if backward else 1)}


def derive(name: str) -> dict:
    cell = cells.load_cell(name)
    return dict(cell=name, **cells.runner(cell).work(cell))


def main(argv=None) -> int:
    for name in (argv if argv is not None else sys.argv[1:]):
        work = derive(name)
        path = cells.HERE / "work" / f"{name}.json"
        path.write_text(json.dumps(work, indent=1) + "\n")
        print(f"{path}: {work['flops_per_item']:.6g} operations an item")
    return 0


if __name__ == "__main__":
    sys.exit(main())
