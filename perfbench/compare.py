"""The numbers that decide ``correct``, each held against its limit.

Stage 2 (scenes of the window drawn from the seed, against the plain
reference on the same inputs and weights; each number the mean over
those scenes), over the sampled valid points of a scene:

- ``logit_err_scene``, the number the cells compare: |L - L_ref| /
  |L_ref - mean_ref| (Frobenius, the mean over the points), the whole gap
  over how far the reference's points spread from their mean row. The
  smoothing leaves every point of a scene near one logit row, so this
  mostly holds that row;
- reported by the calibration only: ``logit_err_centred``, |(L - mean) -
  (L_ref - mean_ref)| / |L_ref - mean_ref|, the per-point structure with
  each side less its own mean row (the reference's mean row at every
  point reads 1, shuffled points about sqrt(2); at the cells' widths the
  control reads ~1 too, so no limit separates it from sound runs);
  ``logit_err_p50``, the median point's |l - l_ref| / |l_ref|;
  ``pred_miss_pct``, the share of points whose class is not the
  reference's (it swings between ~0 and ~100% with a global near-tie
  between two classes); ``centred_miss_pct``, the same for the classes of
  the centred rows.

Stage 1 (the first three steps of the window's own step object against
the reference's three steps from the same weights, anchors and inputs):

- ``loss_rel``: the largest |loss - loss_ref| / |loss_ref| over the steps;
- ``grad_leaf_gap``: over the leaves, the largest gap between the norms of
  the program's and the reference's first gradient (the program's read
  from AdamW's first moment after one step), over the larger of the
  reference leaf's norm and the median leaf's;
- ``change_leaf_gap``: the same for each leaf's change over the three
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (biases ahead of a BatchNorm: nought in
  exact arithmetic, so AdamW moves them by rounding alone).
"""

from __future__ import annotations

from typing import Dict

import torch

# leaves whose first reference gradient is below this share of the median
# leaf's are rounding noise, moved by AdamW's normalisation alone
ROUNDING_LEAF = 1e-3


def stage2_numbers(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                   point_valid: torch.Tensor, sample_idx: torch.Tensor) -> Dict[str, float]:
    """``prog``: ``pred`` [P] and ``logits`` [S, C] at the points
    ``sample_idx`` [S]; ``ref``: ``pred`` and ``logits`` [P, C]."""
    valid = point_valid.bool()
    keep = valid[sample_idx]
    lp = prog["logits"].float()[keep]
    lr = ref["logits"][sample_idx].float()[keep]
    err = (lp - lr).norm(dim=-1) / lr.norm(dim=-1).clamp(min=1e-30)
    lr_c = lr - lr.mean(dim=0, keepdim=True)
    lp_c = lp - lp.mean(dim=0, keepdim=True)
    spread = lr_c.norm().clamp(min=1e-30)
    miss = (prog["pred"].long() != ref["pred"].long()) & valid
    return {
        "logit_err_centred": float((lp_c - lr_c).norm() / spread),
        "logit_err_scene": float((lp - lr).norm() / spread),
        "logit_err_p50": float(err.median()) if err.numel() else 0.0,
        "pred_miss_pct": 100.0 * float(miss.sum()) / max(int(valid.sum()), 1),
        "centred_miss_pct": 100.0 * float((lp_c.argmax(-1) != lr_c.argmax(-1)).float().mean())
        if lp.numel() else 0.0,
    }


def mean_numbers(per_item) -> Dict[str, float]:
    """Each number's mean over the items compared."""
    return {k: sum(d[k] for d in per_item) / len(per_item) for k in per_item[0]}


def _leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keys) -> float:
    norms_r = {k: float(ref[k].float().norm()) for k in keys}
    med = float(torch.tensor(sorted(norms_r.values())).median())
    gap = 0.0
    for k in keys:
        d = abs(float(prog[k].float().norm()) - norms_r[k])
        gap = max(gap, d / max(norms_r[k], med, 1e-30))
    return gap


def stage1_numbers(prog: dict, ref: dict, p0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``prog`` / ``ref``: ``losses`` (3 floats), ``grads1`` and ``params``
    (name -> tensor, after the third step); ``p0`` the drawn weights."""
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    keys = sorted(ref["grads1"])
    g_norm = {k: float(ref["grads1"][k].float().norm()) for k in keys}
    med = float(torch.tensor(sorted(g_norm.values())).median())
    moved = [k for k in keys if g_norm[k] >= ROUNDING_LEAF * med]
    d_prog = {k: prog["params"][k].float() - p0[k].float() for k in moved}
    d_ref = {k: ref["params"][k].float() - p0[k].float() for k in moved}
    return {
        "loss_rel": loss_rel,
        "grad_leaf_gap": _leaf_gap(prog["grads1"], ref["grads1"], keys),
        "change_leaf_gap": _leaf_gap(d_prog, d_ref, moved),
    }


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; a number passes at or under it."""
    return {k: {"value": numbers[k], "limit": limits[k], "ok": numbers[k] <= limits[k]}
            for k in limits}
