"""``run.infer_interactive.main --task demo`` held against the JAX package
on the CPU, with and without a reference image's visual prompt: every
head call's outputs (f32 rel < 1e-5), the winning object query and its
mask, and the written overlay. The weights are carried as in
``tests/test_torch_port_interactive.py``."""

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_port_interactive import _rel, _same_calls, run_both


@pytest.mark.parametrize("refimg", [False, True])
def test_demo_matches_jax(monkeypatch, capsys, tmp_path, refimg):
    """``--task demo``: the same winning object query and its mask, with
    the click prompt alone and composed with a reference image's visual
    prompt."""
    argv = ["--synthetic", "--task", "demo", "--clicks", "40,60;50,80", "--budget", "8"]
    if refimg:
        ref = tmp_path / "ref.png"
        rng = np.random.default_rng(4)
        img = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
        img[30:80, 20:90] = [220, 60, 40]
        Image.fromarray(img).save(ref)
        argv += ["--refimg", str(ref), "--ref-clicks", "40,40;60,70;70,30"]
    (rj, cj, pj, _), (rt, ct, pt, _) = run_both(monkeypatch, capsys, argv, tmp_path, "demo")
    _same_calls(cj, ct)
    assert len(pj) == len(pt) == 1
    assert np.array_equal(pt[0][0], pj[0][0])
    assert _rel(pt[0][1], pj[0][1]) < 1e-5
    assert np.array_equal(np.asarray(Image.open(rt)), np.asarray(Image.open(rj)))
