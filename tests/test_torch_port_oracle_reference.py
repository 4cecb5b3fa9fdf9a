"""The port against the reference torch code itself (``parity/compare.py``
with the oracles of ``parity/oracle.py``): twins of the tests of
``tests/test_torch_parity.py`` that run the reference, and of
``tests/test_visual_sampler.py::test_parity_visual_sampler``, with the
same tolerances, the port's side on the CPU. They need the GeoPurify
reference tree at ``parity.shims.geopurify_root()`` and skip without it;
the full-size head study also needs ``GEOPURIFY_FULLSIZE=1``, as the JAX
one does."""

import os

import numpy as np
import pytest
import torch

from geopurify_tpu_torch.parity import compare, shims

TOL = 1e-4


@pytest.fixture(autouse=True)
def _reference_tree():
    if not os.path.isdir(shims.reference_root()):
        pytest.skip(f"needs the reference tree at {shims.reference_root()}")


def _check(rows):
    assert rows
    for name, (mx, rel) in rows.items():
        assert rel < TOL, f"{name}: rel={rel:.3e} max|d|={mx:.3e}"


def test_parity_pad_and_resize():
    _check(compare.parity_pad(device="cpu"))
    _check(compare.parity_resize(device="cpu"))


def test_parity_lang():
    _check(compare.parity_lang(device="cpu"))


def test_parity_focalnet():
    _check(compare.parity_focalnet(device="cpu"))


def test_parity_focalnet_dw():
    """focal_dw under both postLN settings."""
    _check(compare.parity_focalnet_dw(use_postln=True, device="cpu"))
    _check(compare.parity_focalnet_dw(use_postln=False, device="cpu"))


def test_parity_pixel_decoder():
    _check(compare.parity_pixel_decoder(device="cpu"))


def test_parity_head():
    _check(compare.parity_head(device="cpu"))


def test_parity_lift():
    _check(compare.parity_lift(device="cpu"))


def test_parity_davit():
    _check(compare.parity_davit(device="cpu"))


def test_parity_vit():
    _check(compare.parity_vit(device="cpu"))


def test_parity_deform_pixel_decoder():
    _check(compare.parity_deform_pixel_decoder(device="cpu"))


def test_parity_matcher_costs():
    """The port's Hungarian cost pieces (``models/criterion.set_criterion``'s
    dice and linearised mask-BCE costs, each alone by its weight, over
    every mask pixel) == the reference's batch_dice_loss /
    batch_sigmoid_ce_loss (matcher.py:23-77)."""
    from geopurify_tpu_torch.models.criterion import set_criterion

    shims.install()
    shims.add_reference_to_path()
    from xdecoder.modeling.modules.matcher import batch_dice_loss, batch_sigmoid_ce_loss

    rng = np.random.default_rng(0)
    Q, T, P = 7, 5, 64
    pm = rng.normal(0, 3, (Q, P)).astype(np.float32)
    gm = (rng.uniform(size=(T, P)) < 0.4).astype(np.float32)
    with torch.no_grad(), shims.cpu_cuda():
        ref_d = batch_dice_loss(torch.from_numpy(pm), torch.from_numpy(gm)).numpy()
        ref_m = batch_sigmoid_ce_loss(torch.from_numpy(pm), torch.from_numpy(gm)).numpy()
    points = (torch.zeros(P, dtype=torch.long), torch.arange(P))

    def cost(dice, mask):
        out = set_criterion(torch.zeros(1, Q, 3), torch.from_numpy(pm)[None, :, None],
                            torch.zeros(1, T, dtype=torch.long),
                            torch.from_numpy(gm)[None, :, None],
                            torch.ones(1, T, dtype=torch.bool), cost_class=0.0,
                            cost_dice=dice, cost_mask=mask, points=points, return_cost=True)
        return out["cost"][0].numpy()

    np.testing.assert_allclose(cost(1.0, 0.0), ref_d, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cost(0.0, 1.0), ref_m, rtol=1e-5, atol=1e-6)


def test_parity_seem():
    _check(compare.parity_seem(device="cpu"))


def test_parity_head_vlp():
    _check(compare.parity_head_vlp(device="cpu"))


def test_parity_seem_v1():
    _check(compare.parity_seem_v1(device="cpu"))


def test_parity_stage2_end_to_end():
    """The composed Stage-2 chain, at the JAX test's limits: voxel features
    rel < 1e-6, student embeds and affinity weights < 1e-5, kNN-96
    neighbour sets exact, final features within the mutation-calibrated
    band (rel < 2e-2 and abs < 8e-4), argmax identical wherever the fp64
    margin clears the fp32 noise, I/U/T within the sub-margin rows."""
    rows = compare.parity_stage2(device="cpu")
    for name, tol in (("stage2/voxel_in", 1e-6), ("stage2/embed", 1e-5),
                      ("stage2/affinity_w", 1e-5)):
        mx, rel = rows[name]
        assert rel < tol, f"{name}: rel={rel:.3e} max|d|={mx:.3e}"
    assert rows["stage2/knn_sets"] == (0.0, 0.0), \
        f"kNN neighbor sets differ on {rows['stage2/knn_sets'][0]} rows"
    mx, rel = rows["stage2/features"]
    assert rel < 2e-2 and mx < 8e-4, f"stage2/features: rel={rel:.3e} abs={mx:.3e}"
    n_tie, frac_conf = rows["stage2/pred_agree"]
    assert frac_conf == 0.0, f"confident-margin prediction disagreements: {frac_conf}"
    for name in ("stage2/hist_I", "stage2/hist_U", "stage2/hist_T"):
        mx, _ = rows[name]
        assert mx <= n_tie, f"{name}: max|d|={mx} vs {n_tie} sub-margin rows"


def test_parity_stage2_mutation_sensitivity():
    """The 19 -> 17 rounds and sharpen 20 -> 19 mutants of the port's
    pipeline land OUTSIDE the calibrated band against the cached oracle
    scene."""
    for mutate in ({"num_iterations": 17}, {"sharpen": 19.0}):
        rows = compare.parity_stage2(mutate=mutate, features_only=True, device="cpu")
        mx, rel = rows["stage2/features"]
        assert rel >= 2e-2 or mx >= 8e-4, (
            f"mutant {mutate} INSIDE the calibrated band (rel={rel:.3e} abs={mx:.3e})")


def test_parity_seem_demo():
    _check(compare.parity_seem_demo(device="cpu"))


def test_parity_head_fullsize():
    """Full-size head: round-0 pre-threshold masks rel < 1e-5, attention-mask
    flips < 1e-3 and threshold-marginal (p99 |sigmoid - 0.5| < 0.1), the
    finals forced onto the reference's binarized masks rel < 2e-4."""
    if os.environ.get("GEOPURIFY_FULLSIZE") != "1":
        pytest.skip("full-size head study (minutes on a CPU); set GEOPURIFY_FULLSIZE=1")
    rows = compare.parity_head_fullsize(device="cpu")
    _, rel = rows["head_full/round0_masks"]
    assert rel < 1e-5, f"round0: rel={rel:.3e}"
    _, frac = rows["head_full/flip_frac"]
    assert frac < 1e-3, f"attn-mask flip fraction {frac:.2e}"
    _, p99 = rows["head_full/flip_margin"]
    assert p99 < 0.1, f"flip margin p99 {p99:.3f} not threshold-marginal"
    for k in ("forced_pred_logits", "forced_pred_masks", "forced_mask_embed",
              "forced_cls_logits"):
        _, rel = rows[f"head_full/{k}"]
        assert rel < 2e-4, f"{k}: rel={rel:.3e}"


def test_parity_visual_sampler():
    """Bit-exact replay of the reference sampler family through the port's
    data/visual_sampler.py."""
    rows = compare.parity_visual_sampler(device="cpu")
    assert len(rows) == 14
    bad = {k: v for k, v in rows.items() if v != (0.0, 0.0)}
    assert not bad, f"sampler cases diverge from the reference: {bad}"
