"""The 2D trainer's entry point on the CPU: ``run.train2d.main --device cpu
--preset tiny`` runs every task (both joint modes, on-disk seg and caption
data too) and writes ``metrics.jsonl`` with the JAX entry's keys and a
checkpoint; a seg run resumed from its step-2 checkpoint equals the
uninterrupted run bit for bit; ``--resume`` raises for the tasks JAX
never resumes; and one data-parallel seg step over two gloo ranks equals
the manual mean of the per-rank gradients (each rank's own criterion
points), with bit-equal replicas."""

import json
import shutil

import numpy as np
import pytest
import torch

import tests.torch_dist_workers as workers
from geopurify_tpu_torch.models import criterion as crit
from geopurify_tpu_torch.parallel import spawn
from geopurify_tpu_torch.run import train2d
from geopurify_tpu_torch.run.train import rank_generator
from geopurify_tpu_torch.utils.checkpoint import restore_checkpoint
from tests.test_torch_port_data2d import write_coco

BASE = ["--device", "cpu", "--preset", "tiny", "--print-every", "1", "text.width=16"]

# the record keys of the JAX entry: seg train2d.py:1006-1012, vlp :824-826,
# joint :604-607 / :635-637 (with the task's losses), interactive :745-747
SEG = {"loss_ce", "loss_dice", "loss_mask", "loss"}
VLP = {"loss", "loss_captioning", "loss_retrieval"}
KEYS = {
    "seg": [{"step", "lr", "items_per_sec", *SEG}],
    "vlp": [{"step", "lr", *VLP}],
    "joint-zip": [{"step", "task", "lr", *SEG, *VLP}],
    "joint-switch": [{"step", "task", "lr", *SEG}, {"step", "task", "lr", *VLP}],
    "interactive": [{"step", "lr", "loss", "loss_spatial_ce", "loss_spatial_dice"}],
}
ARGS = {
    "seg": ["--task", "seg", "--synthetic", "--image-hw", "64x96"],
    "vlp": ["--task", "vlp", "--caption-len", "12", "--image-hw", "64x96"],
    "joint-zip": ["--task", "joint", "--joint-mode", "zip", "--caption-len", "12",
                  "--image-hw", "64x96"],
    "joint-switch": ["--task", "joint", "--joint-mode", "switch", "--caption-len", "12",
                     "--image-hw", "64x96"],
    "interactive": ["--task", "interactive", "--image-hw", "64x64", "--prompt-budget", "8"],
}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: the tiny models gain nothing from more, and the
    suite runs several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(tmp_path, name, extra=(), steps=3):
    out = tmp_path / name
    state = train2d.main([*ARGS[name.split("+")[0]], "--steps", str(steps),
                          "--save-path", str(out), *BASE, *extra])
    recs = [json.loads(ln) for ln in (out / "metrics.jsonl").read_text().splitlines()]
    return state, recs, out


@pytest.mark.parametrize("task", list(KEYS))
def test_main_runs_each_task(task, tmp_path):
    state, recs, out = run(tmp_path, task)
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert [set(r) for r in recs] == [
        KEYS[task][1] if task == "joint-switch" and r["task"] == "vlp" else KEYS[task][0]
        for r in recs]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert recs[0]["lr"] == pytest.approx(1e-5) and recs[1]["lr"] == pytest.approx(2e-7)
    if task == "joint-switch":
        assert [r["task"] for r in recs[:2]] == ["seg", "vlp"]
    saved, step = restore_checkpoint(str(out / "ckpt"))
    assert step == 3 == state.step
    assert set(saved["params"]) == set(state.params.state_dict())


def test_main_on_disk_data(tmp_path):
    """``--data-root`` (COCO json, its class names) for seg, and joint zip
    with ``--vlp-data-root`` (captions.json) beside it."""
    from tests.test_torch_port_data2d import test_caption_batches_equal

    coco, caps = tmp_path / "coco", tmp_path / "caps"
    write_coco(coco, np.random.default_rng(0))
    test_caption_batches_equal("list", caps.mkdir() or caps)
    _, recs, _ = run(tmp_path, "seg+disk", ["--data-root", str(coco)], steps=2)
    assert len(recs) == 2 and all(np.isfinite(r["loss"]) for r in recs)
    _, recs, _ = run(tmp_path, "joint-zip+disk", ["--data-root", str(coco),
                                                 "--vlp-data-root", str(caps)], steps=2)
    assert len(recs) == 2 and all(np.isfinite(r["loss_captioning"]) for r in recs)


def test_seg_resume_is_bit_equal(tmp_path):
    """Three steps against two, then a resume for one from the step-2
    checkpoint. The resume restores the parameters, AdamW's moments and
    update count, the criterion's generator and the numpy batch stream.
    As in JAX, ``--steps`` of the resumed run sets its schedule (decays at
    int(0.88 steps), int(0.96 steps)): with 3 and 1, update 2 is decayed
    twice in both."""
    whole, _, out = run(tmp_path, "seg", ["--save-every", "2"])
    resume = tmp_path / "resume"
    resume.mkdir()
    shutil.copy(out / "ckpt" / "step_2.pt", resume / "step_2.pt")
    part, recs, _ = run(tmp_path, "seg+resumed", ["--resume", str(resume)], steps=1)
    assert part.step == whole.step == 3 and [r["step"] for r in recs] == [3]
    for (k, a), (_, b) in zip(whole.params.state_dict().items(),
                              part.params.state_dict().items()):
        assert torch.equal(a, b), k
    sa, sb = whole.opt_state.adamw.state_dict(), part.opt_state.adamw.state_dict()
    for i in sa["state"]:
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][i][k], sb["state"][i][k])
    assert torch.equal(whole.generator.get_state(), part.generator.get_state())


@pytest.mark.parametrize("task", ["vlp", "joint-zip", "interactive"])
def test_resume_raises_for_tasks_jax_never_resumes(task, tmp_path):
    with pytest.raises(SystemExit):
        run(tmp_path, task, ["--resume", str(tmp_path)], steps=1)


def test_main_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        train2d.main([*ARGS["seg"], "--preset", "tiny", "--steps", "1",
                      "--save-path", str(tmp_path)])


def test_dp_seg_step_matches_manual_mean():
    """Two gloo ranks, one seg step: each rank draws its criterion points
    from the step's generator folded by its rank (equal to the draws made
    here), the gradients the optimizer receives are the mean of the
    ranks' own gradients (and the losses their mean), the parameters after
    the update equal one update by that mean, and the replicas are
    bit-equal (cf. tests/test_train2d_infer2d.py::
    test_train2d_dp_step_matches_manual_pmean). Each rank's gradients are
    taken from the rank itself: recomputed here, under another thread
    count, the Hungarian assignment of near-tied queries may differ."""
    overrides = ["xdecoder.mask_shape=[32,48]"]
    rng = np.random.default_rng(0)
    batches = [[t.numpy() for t in train2d.synthetic_batch(rng, 2, (32, 48), 4)]
               for _ in range(2)]
    text = train2d.unit_rows(5, 16, torch.Generator().manual_seed(1)).numpy()
    ranks = spawn(workers.train2d_dp_seg_step, 2, "cpu",
                  args=(overrides, batches, text, 32), timeout_s=300)
    assert all(r["equal"] for r in ranks)
    for r, got in enumerate(ranks):
        gen = rank_generator(torch.Generator().manual_seed(5), r)
        want = crit.sample_mask_points((8, 16), gen, 32)    # 32x48 padded to 32x64
        assert all(np.array_equal(a, b.numpy()) for a, b in zip(got["points"], want)), r
    assert not all(np.array_equal(a, b) for a, b in zip(*(g["points"] for g in ranks)))
    received = ranks[0]["grads"]
    for k, g in received.items():
        mean = (ranks[0]["local_grads"][k] + ranks[1]["local_grads"][k]) / 2
        np.testing.assert_array_equal(g, mean, err_msg=k)
        np.testing.assert_array_equal(ranks[1]["grads"][k], g, err_msg=k)
    for k, v in ranks[0]["losses"].items():
        assert v == pytest.approx((ranks[0]["local_losses"][k] + ranks[1]["local_losses"][k]) / 2,
                                  rel=1e-6)
    assert ranks[0]["local_losses"]["loss"] != ranks[1]["local_losses"]["loss"]
    _, params = workers.train2d_tiny_params(overrides)
    opt = train2d.Train2DOptimizer(params.parameters(), lambda n: 1e-2, 0.05, 0.0)
    for k, p in params.named_parameters():
        p.grad = torch.from_numpy(received[k])
    opt.step()
    for k, p in params.named_parameters():
        assert np.array_equal(p.detach().numpy(), ranks[0]["params"][k]), k
        assert np.array_equal(ranks[1]["params"][k], ranks[0]["params"][k]), k


@pytest.mark.parametrize("over,probe", [("xdecoder.backbone.variant=focal_dw", "dw1."),
                                        ("xdecoder.pixel_decoder=deform", "level_embed")])
def test_interactive_follows_the_config(over, probe, tmp_path):
    """The interactive task builds the backbone and pixel decoder that
    ``xdecoder`` names (the JAX entry builds the plain FocalNet and the FPN
    whatever it says, train2d.py:672-681; ROADMAP Queue 3)."""
    state, _, _ = run(tmp_path, "interactive", [over], steps=1)
    names = [n for mod in (state.params.backbone, state.params.pixdec)
             for n, _ in mod.named_parameters()]
    assert any(probe in n for n in names), over


@pytest.mark.parametrize("accum", [1, 2])
def test_seg_step_updates_like_the_optimizer(accum):
    """``make_train2d_step`` end to end: the step count, the losses it
    returns, and parameters that move only on applied updates after the
    first (whose learning rate is sched(0) = 0)."""
    _, params = workers.train2d_tiny_params(["xdecoder.mask_shape=[32,48]"])
    args = type("A", (), dict(steps=8, lr=1e-2, weight_decay=0.05, grad_clip=0.01,
                              grad_accum=accum))
    state = train2d.Train2DState(params, train2d.make_optimizer(params, args), 0,
                                 torch.Generator().manual_seed(0))
    step = train2d.make_train2d_step(None, 32)
    text = train2d.unit_rows(5, 16, torch.Generator().manual_seed(1))
    before = [p.detach().clone() for p in params.parameters()]
    rng = np.random.default_rng(2)
    snaps = []
    for _ in range(3 * accum):
        losses = step(state, *train2d.synthetic_batch(rng, 2, (32, 48), 4), text,
                      train2d.LOGIT_SCALE)
        assert set(losses) == {"loss_ce", "loss_dice", "loss_mask", "loss"}
        assert all(bool(torch.isfinite(v)) for v in losses.values())
        snaps.append([p.detach().clone() for p in params.parameters()])
    assert state.step == 3 * accum and state.opt_state.count == 3
    for i, snap in enumerate(snaps):
        moved = any(not torch.equal(a, b) for a, b in zip(snap, before))
        assert moved == (i >= 2 * accum - 1), i
