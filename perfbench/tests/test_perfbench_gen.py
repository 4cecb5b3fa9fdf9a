"""The frozen generators: the same seed gives the same scenes and weights,
another seed other ones, and large seeds work."""

import numpy as np
import torch

from perfbench.gen.scene import FIELDS, build_scene
from perfbench.gen.weights import draw_student, draw_xdecoder, prompts_from_lift, sub_seed

BIG = 2 ** 31 + 12345


def test_scene_deterministic_by_seed():
    a = build_scene([BIG, 1], 1024, 512, 3, 128, (48, 64))
    b = build_scene([BIG, 1], 1024, 512, 3, 128, (48, 64))
    c = build_scene([BIG, 2], 1024, 512, 3, 128, (48, 64))
    assert set(a) == set(FIELDS)
    for k in FIELDS:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["images"], c["images"])
    assert not np.array_equal(a["voxel_coords"], c["voxel_coords"])


def test_scene_layout():
    s = build_scene([7, 0], 2048, 512, 2, 256, (32, 40))
    vox = s["voxel_coords"]
    assert vox.shape == (512, 3) and s["points"].shape == (2048, 3)
    # lexicographically sorted and distinct voxels; each point in its voxel
    keys = (vox[:, 0].astype(np.int64) * 1000 + vox[:, 1]) * 1000 + vox[:, 2]
    assert np.all(np.diff(keys) > 0)
    inside = s["points"] - vox[s["point2voxel"]] * np.float32(0.02)
    assert inside.min() >= -1e-6 and inside.max() <= 0.02 + 1e-6
    assert s["images"].shape == (2, 32, 40, 3) and s["images"].dtype == np.uint8
    for v in range(2):
        assert len(np.unique(s["view_point_ids"][v])) == 256


def test_sub_seed_deterministic_and_distinct():
    assert sub_seed(BIG, 1) == sub_seed(BIG, 1)
    assert sub_seed(BIG, 1) != sub_seed(BIG, 2) != sub_seed(BIG + 1, 2)
    assert 0 <= sub_seed(2 ** 70, 3) < 2 ** 63


def test_weights_deterministic_and_scaled():
    shapes = [("a.weight", (64, 32)), ("a.bias", (64,)), ("n.weight", (32,)),
              ("c.weight", (16, 8, 3, 3))]
    w1 = draw_xdecoder(shapes, 11, "cpu")
    w2 = draw_xdecoder(shapes, 11, "cpu")
    w3 = draw_xdecoder(shapes, 12, "cpu")
    for k in w1:
        torch.testing.assert_close(w1[k], w2[k], rtol=0, atol=0)
    assert not torch.equal(w1["a.weight"], w3["a.weight"])
    assert torch.all(w1["a.bias"] == 0) and torch.all(w1["n.weight"] == 1)
    assert abs(float(w1["a.weight"].std()) - 32 ** -0.5) < 0.02
    assert abs(float(w1["c.weight"].std()) - 72 ** -0.5) < 0.03
    st = draw_student([("input_conv.kernel", (27, 8, 16)), ("input_conv.bias", (16,)),
                       ("input_norm.weight", (16,)), ("input_norm.mean", (16,)),
                       ("input_norm.var", (16,)), ("output_conv.weight", (4, 16))], 5, "cpu")
    assert abs(float(st["input_conv.kernel"].std()) - (2 / 216) ** 0.5) < 0.02
    assert torch.all(st["input_norm.var"] == 1) and torch.all(st["input_norm.mean"] == 0)
    assert torch.all(st["input_conv.bias"] == 0) and torch.all(st["input_norm.weight"] == 1)


def test_prompts_pick_the_most_winning_queries_centred():
    table = torch.eye(5)[:, :4]                 # 4 queries + the zero row
    table[4] = 0
    winner = torch.tensor([2, 2, 2, 0, 0, 3, 4, 4, 4, 4])
    text = prompts_from_lift(winner, table, 2, seed=3)
    h = 0.5 ** 0.5
    torch.testing.assert_close(text[0], torch.tensor([-h, 0.0, h, 0.0]))
    torch.testing.assert_close(text[1], torch.tensor([h, 0.0, -h, 0.0]))
    assert text.shape == (3, 4) and abs(float(text[2].norm()) - 1) < 1e-6
