"""The 2D trainer's criterion, schedule and optimizer held against the JAX
package on the CPU.

``set_criterion`` runs in both packages on the same seeded predictions and
targets, the port on the points the JAX sampler drew: the masked cost
matrix (recorded where JAX hands it to the host) within rel 1e-5, equal
assignments (a mismatch reports the cost margin), the losses and their
gradients with respect to the logits and masks within rel 1e-5; then the
VLP losses and their gradients. The schedule equals JAX's at every step up
to twice ``--steps``; ``Train2DOptimizer`` given optax's gradients
reproduces optax's parameters within 1e-6 over three updates, with and
without clipping and accumulation (the first update moves nothing:
``sched(0) = 0``)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geopurify_tpu.models import criterion as jcrit
from geopurify_tpu.run import train2d as jtrain
from geopurify_tpu_torch.models import criterion as tcrit
from geopurify_tpu_torch.run import train2d as ttrain


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def criterion_inputs(seed, B=2, Q=7, T=4, n_cls=5, hw=(12, 16), gt_hw=None):
    """Seeded logits [B, Q, n_cls+1], mask logits, rectangle targets with
    one invalid slot an image; ``gt_hw`` (smaller than ``hw``) is a target
    grid of an image padded to the size divisibility."""
    rng = np.random.default_rng(seed)
    H, W = hw
    h, w = gt_hw or hw
    logits = (3 * rng.normal(size=(B, Q, n_cls + 1))).astype(np.float32)
    masks = (4 * rng.normal(size=(B, Q, H, W))).astype(np.float32)
    gt_masks = np.zeros((B, T, h, w), np.float32)
    for b in range(B):
        for t in range(T):
            y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
            gt_masks[b, t, y0: y0 + rng.integers(2, h // 2 + 2),
                     x0: x0 + rng.integers(2, w // 2 + 2)] = 1
    gt_cls = rng.integers(0, n_cls, (B, T)).astype(np.int32)
    gt_valid = np.ones((B, T), bool)
    gt_valid[:, -1] = False
    return logits, masks, gt_cls, gt_masks, gt_valid


def jax_criterion(inputs, rng, num_points, monkeypatch):
    """JAX's losses, their gradients w.r.t. the logits and masks, the cost
    matrix it solves and its assignment (eager, so that the recording
    wrapper is traced), and the points it drew."""
    logits, masks, gt_cls, gt_masks, gt_valid = (jnp.asarray(a) for a in inputs)
    costs, assigns = [], []
    solve = jcrit.hungarian_match

    def recording(cost):
        a = solve(cost)
        jax.debug.callback(lambda c, s: (costs.append(np.asarray(c)),
                                         assigns.append(np.asarray(s))), cost, a)
        return a

    monkeypatch.setattr(jcrit, "hungarian_match", recording)
    fn = jcrit.set_criterion.__wrapped__

    def loss(lg, mk):
        out = fn(lg, mk, gt_cls, gt_masks, gt_valid, rng, num_points=num_points)
        return out["loss"], out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(logits, masks)
    rows, cols = jcrit._sample_mask_points(masks, rng, num_points)
    return ({k: np.asarray(v) for k, v in out.items()}, [np.asarray(g) for g in grads],
            costs[-1], assigns[-1], (np.asarray(rows), np.asarray(cols)))


def port_criterion(inputs, points):
    logits, masks, gt_cls, gt_masks, gt_valid = (torch.from_numpy(a) for a in inputs)
    logits.requires_grad_(True)
    masks.requires_grad_(True)
    out = tcrit.set_criterion(logits, masks, gt_cls, gt_masks, gt_valid,
                              points=tuple(torch.from_numpy(np.array(p)) for p in points),
                              return_cost=True)
    out["loss"].backward()
    return out, [logits.grad.numpy(), masks.grad.numpy()]


def assignment_margin(cost, a, b):
    """Per image, the cost of assignment ``b`` less that of ``a`` under
    ``cost`` (a tie if ~0)."""
    def total(c, s):
        q = np.nonzero(s >= 0)[0]
        return c[q, s[q]].sum()
    return [total(c, sb) - total(c, sa) for c, sa, sb in zip(cost, a, b)]


@pytest.mark.parametrize("case", ["square", "padded grid"])
def test_set_criterion_matches_jax(case, monkeypatch):
    """Costs, assignments, losses and gradients. ``padded grid``: the target
    grid is smaller than the predicted one, and both read it at the points
    clamped to its edge."""
    inputs = criterion_inputs(1 if case == "square" else 2,
                              gt_hw=None if case == "square" else (10, 13))
    jout, jgrads, jcost, jassign, points = jax_criterion(inputs, jax.random.key(5), 64,
                                                         monkeypatch)
    tout, tgrads = port_criterion(inputs, points)
    assert _rel(tout["cost"].numpy(), jcost) < 1e-5
    tassign = tout["assign"].numpy()
    assert np.array_equal(tassign, jassign), (
        "assignments differ; cost margin", assignment_margin(jcost, jassign, tassign))
    assert (tassign >= 0).sum() == inputs[0].shape[0] * inputs[2].shape[1]
    for k in ("loss_ce", "loss_dice", "loss_mask", "loss"):
        assert _rel(tout[k].detach().numpy(), jout[k]) < 1e-5, k
    for g, r in zip(tgrads, jgrads):
        assert _rel(g, r) < 1e-5
    if case == "padded grid":
        assert points[0].max() >= 10 or points[1].max() >= 13


def test_hungarian_leaves_extra_queries_unmatched():
    cost = torch.tensor([[[1.0, 9.0], [9.0, 1.0], [5.0, 5.0]]])
    assert tcrit.hungarian_match(cost).tolist() == [[0, 1, -1]]


def test_vlp_losses_match_jax():
    """Captioning CE and the image-text contrastive loss, values and
    gradients w.r.t. every input."""
    rng = np.random.default_rng(3)
    B, T, D, V = 3, 6, 8, 11
    pred = rng.normal(size=(B, T, D)).astype(np.float32)
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, (B, T)).astype(np.int64)
    mask = (rng.random((B, T)) < 0.7).astype(np.float32)
    v, t = (rng.normal(size=(B, D)).astype(np.float32) for _ in range(2))
    scale = np.float32(2.3)

    jcap, jgcap = jax.value_and_grad(jcrit.captioning_loss, argnums=(0, 1))(
        jnp.asarray(pred), jnp.asarray(table), jnp.asarray(ids), jnp.asarray(mask))
    jret, jgret = jax.value_and_grad(jcrit.image_text_contrastive_loss, argnums=(0, 1, 2))(
        jnp.asarray(v), jnp.asarray(t), jnp.asarray(scale))
    tp, tt, tv, ttx, ts = (torch.tensor(a, requires_grad=True) for a in (pred, table, v, t, scale))
    tcap = tcrit.captioning_loss(tp, tt, torch.from_numpy(ids), torch.from_numpy(mask))
    tret = tcrit.image_text_contrastive_loss(tv, ttx, ts)
    (tcap + tret).backward()
    assert _rel(tcap.item(), jcap) < 1e-5 and _rel(tret.item(), jret) < 1e-5
    for g, r in zip((tp, tt, tv, ttx, ts), (*jgcap, *jgret)):
        assert _rel(g.grad.numpy(), r) < 1e-5


@pytest.mark.parametrize("steps", [3, 50])
def test_schedule_matches_jax(steps):
    """Warm-up over 10, x0.1 at 88% and 96% of ``steps``, at every step up to
    2 * steps; 0 at step 0."""
    decay = (int(steps * 0.88), int(steps * 0.96))
    js = jtrain.make_schedule(1e-4, warmup_steps=10, decay_steps=decay)
    ts = ttrain.make_schedule(1e-4, warmup_steps=10, decay_steps=decay)
    got = [ts(s) for s in range(2 * steps + 1)]
    want = [float(js(s)) for s in range(2 * steps + 1)]
    assert got == want
    assert got[0] == 0.0


def _tree(rng):
    return {"a": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "c": rng.normal(size=(2, 2, 3)).astype(np.float32)}


@pytest.mark.parametrize("clip,accum", [(0.0, 1), (0.5, 1), (0.5, 2), (100.0, 2)])
def test_optimizer_matches_optax(clip, accum):
    """Given the same gradients (their norms ~4, so clip 0.5 scales every
    update and 100 none), three updates of the port's clip + AdamW +
    accumulation against optax's chain under MultiSteps: parameters within
    1e-6 after each raw step; the first update changes nothing."""
    rng = np.random.default_rng(4)
    params = _tree(rng)
    sched = jtrain.make_schedule(0.05, warmup_steps=2, decay_steps=(3, 5))
    tx = optax.chain(optax.clip_by_global_norm(clip) if clip else optax.identity(),
                     optax.adamw(sched, weight_decay=0.05))
    if accum > 1:
        tx = optax.MultiSteps(tx, accum)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jp)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = ttrain.Train2DOptimizer(list(tparams.values()),
                                  ttrain.make_schedule(0.05, 2, (3, 5)), 0.05, clip, accum)
    for raw in range(3 * accum):
        grads = _tree(rng)
        upd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        applied = opt.step()
        assert applied == ((raw + 1) % accum == 0)
        for k, p in tparams.items():
            ref = np.asarray(jp[k])
            assert np.abs(p.detach().numpy() - ref).max() <= 1e-6 * np.abs(ref).max(), (raw, k)
            if raw < accum:            # sched(0) = 0: the first update is a no-op
                assert np.array_equal(p.detach().numpy(), params[k])
    assert opt.count == 3
    moved = max(np.abs(p.detach().numpy() - params[k]).max() for k, p in tparams.items())
    assert moved > 1e-3
