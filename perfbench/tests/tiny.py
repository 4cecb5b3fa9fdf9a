"""Tiny-width cells for the CPU tests: the committed cells' files with the
widths, depths and scenes cut down, so that a whole run fits in seconds."""

from __future__ import annotations

from perfbench import cells

TINY_PROGRAM = {
    "xdecoder": {"backbone": {"embed_dim": 8, "depths": [1, 1, 1, 1]},
                 "hidden_dim": 16, "conv_dim": 16, "mask_dim": 16, "num_queries": 21,
                 "nheads": 2, "dim_feedforward": 32, "dec_layers": 2, "enc_layers": 1,
                 "mask_shape": [48, 64], "view_batch": 2},
    "student": {"input_dim": 22, "hidden_dim": 16, "embed_dim": 8, "num_res_blocks": 1},
    "pooling": {"knn_k": 8, "num_iterations": 3, "feature_dim": 16, "band": 128,
                "max_residual": 4096, "res_chunk": 4096},
    "contrastive": {"num_anchors": 64, "spatial_knn_k": 16},
}


def tiny_cell(name: str, **traffic) -> dict:
    cell = cells.load_cell(name)
    cell["program"] = cells.merge(cell["program"], TINY_PROGRAM)
    if cell["stage"] == 2:
        cell["program"]["xdecoder"]["dtype"] = "float32"
        scene = {"points": 1024, "voxels": 512, "views": 3, "view_points": 128}
    else:
        scene = {"points": 2048, "voxels": 1024}
        cell["traffic"]["teacher_dim"] = 16
    cell["traffic"] = dict(cell["traffic"], scene=scene, pool=2, trace_items=1, **traffic)
    if cell["stage"] == 2:
        cell["traffic"]["check_scenes"] = 2
    return cell
