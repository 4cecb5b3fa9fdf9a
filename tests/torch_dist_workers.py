"""Rank functions the parallel tests spawn (``geopurify_tpu_torch.parallel.
spawn``): importable without JAX, so that each rank starts with torch and
the port only. Each takes the rank's device first and returns numpy."""

from __future__ import annotations

import numpy as np
import torch

from geopurify_tpu_torch.config import load_config
from geopurify_tpu_torch.data.synthetic import make_scene_batch
from geopurify_tpu_torch.models.pipeline import GeoPurifyPipeline
from geopurify_tpu_torch.ops.contrastive import ContrastivePairs
from geopurify_tpu_torch.parallel.mesh import make_mesh, replicas_equal
from geopurify_tpu_torch.run.optim import make_optimizer
from geopurify_tpu_torch.run.train import TrainState, make_train_step


def dp_steps(device, overrides, text, student_state, scene_kw, f2ds, fts, pairs,
             steps_per_epoch):
    """Data-parallel Stage-1 steps of the ``tiny`` preset: rank r trains on
    the synthetic scene of seed r with ``f2ds[r]`` / ``fts[r]`` and the
    pairs ``pairs[step][r]``. Per step: the loss, the averaged gradients the
    optimizer received, the parameters and running statistics after it, and
    whether the replicas are bit-equal."""
    cfg = load_config("tiny", overrides=overrides)
    mesh = make_mesh(cfg.parallel.dp, cfg.parallel.tp)
    r = mesh.rank
    pipe = GeoPurifyPipeline(cfg, text, 20.0, device=device,
                             student_state={k: torch.from_numpy(v)
                                            for k, v in student_state.items()})
    opt, _ = make_optimizer(cfg.train, pipe.student, steps_per_epoch)
    state = TrainState(pipe.student, opt, 0, torch.Generator().manual_seed(0))
    scene = make_scene_batch(seed=r, **scene_kw)
    grads = {}
    inner = opt.step

    def capturing_step():
        grads.update({k: p.grad.numpy().copy()
                      for k, p in pipe.student.named_parameters()})
        return inner()

    opt.step = capturing_step
    step = make_train_step(pipe, mesh)
    out = []
    for step_pairs in pairs:
        loss = step(state, scene, torch.from_numpy(f2ds[r]), torch.from_numpy(fts[r]),
                    pairs=ContrastivePairs(*(torch.from_numpy(x) for x in step_pairs[r])))
        sd = pipe.student.state_dict()
        out.append(dict(loss=loss.item(), grads=dict(grads),
                        state={k: v.numpy().copy() for k, v in sd.items()},
                        equal=replicas_equal(list(sd.values()), mesh.group)))
    return out


def validate_main(device, argv):
    """``run.validate.main(argv)`` on this rank (the group already joined):
    its result, the I/U/T histograms it summarised (after the all-reduce)
    and what it printed."""
    import contextlib
    import io

    from geopurify_tpu_torch.run import validate

    seen = {}
    allreduce = validate.allreduce_meter_across_hosts

    def recording(meter):
        meter = allreduce(meter)
        seen["iut"] = np.stack([meter.intersection, meter.union, meter.target])
        return meter

    validate.allreduce_meter_across_hosts = recording
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = validate.main(argv)
    return dict(result=result, iut=seen["iut"], stdout=out.getvalue())


def meter_allreduce(device, hists):
    """This rank's ``hists[rank]`` (I, U, T) in a meter, summed over the
    ranks."""
    from geopurify_tpu_torch.utils.metrics import SegMeter, allreduce_meter_across_hosts

    rank = torch.distributed.get_rank()
    meter = SegMeter(num_classes=hists[rank].shape[1])
    meter.update(*hists[rank])
    allreduce_meter_across_hosts(meter)
    return np.stack([meter.intersection, meter.union, meter.target])


def sharded_lift(device, cfg_dict, text, xdecoder_state, arrays):
    """``sharded_lift_scene`` of the pipeline of ``cfg_dict`` (a config as a
    dict) with the given X-Decoder weights on the scene ``arrays``;
    (fused, count)."""
    from geopurify_tpu_torch.config import GeoPurifyConfig, _apply_dict
    from geopurify_tpu_torch.data.batch import SceneBatch
    from geopurify_tpu_torch.parallel.view_parallel import sharded_lift_scene

    pipe = GeoPurifyPipeline(_apply_dict(GeoPurifyConfig(), cfg_dict), text, 20.0,
                             device=device,
                             teacher_state={k: torch.from_numpy(v)
                                            for k, v in xdecoder_state.items()})
    fused, count = sharded_lift_scene(pipe, SceneBatch.from_numpy(arrays))
    return fused.numpy(), count.numpy()


def train_main(device, argv):
    """``run.train.main(argv)`` on this rank: the step reached and the
    student's state."""
    from geopurify_tpu_torch.run import train

    state = train.main(argv)
    return state.step, {k: v.numpy() for k, v in state.student.state_dict().items()}


def train2d_tiny_params(overrides):
    """The ``tiny`` preset's seg parameters (X-Decoder + no-object), seeded."""
    from geopurify_tpu_torch.run import train2d

    cfg = load_config("tiny", overrides=overrides)
    g = torch.Generator().manual_seed(0)
    model = train2d.build_model(cfg, g)
    return cfg, train2d.Train2DParams(model=model, no_object=torch.randn(
        (cfg.xdecoder.hidden_dim,), generator=g) * 0.02)


def train2d_dp_seg_step(device, overrides, batches, text, num_points):
    """One data-parallel seg step of ``run.train2d`` (rank r on
    ``batches[r]``, the criterion's generator seeded 5 and folded by rank):
    this rank's own gradients and losses (what it hands the all-reduce),
    the criterion's points it drew, the averaged gradients the optimizer
    received, the parameters after it, the losses the step returned and
    whether the replicas are bit-equal."""
    from geopurify_tpu_torch.models import criterion
    from geopurify_tpu_torch.run import train2d

    cfg, params = train2d_tiny_params(overrides)
    mesh = make_mesh(cfg.parallel.dp, cfg.parallel.tp)
    params.to(device)
    opt = train2d.Train2DOptimizer(params.parameters(), lambda n: 1e-2, 0.05, 0.0)
    state = train2d.Train2DState(params, opt, 0, torch.Generator().manual_seed(5))
    names = [k for k, _ in params.named_parameters()]
    seen = {}
    reduce, sample = train2d.all_reduce_mean_, criterion.sample_mask_points

    def recording_reduce(tensors, n, group=None):
        seen["local"] = [t.detach().numpy().copy() for t in tensors]
        return reduce(tensors, n, group)

    def recording_sample(*a, **k):
        rows, cols = sample(*a, **k)
        seen["points"] = [rows.numpy().copy(), cols.numpy().copy()]
        return rows, cols

    train2d.all_reduce_mean_, criterion.sample_mask_points = recording_reduce, recording_sample
    grads = {}
    inner = opt.step

    def capturing_step():
        grads.update({k: p.grad.numpy().copy() for k, p in params.named_parameters()})
        return inner()

    opt.step = capturing_step
    try:
        step = train2d.make_train2d_step(mesh, num_points)
        losses = step(state, *(torch.from_numpy(a) for a in batches[mesh.rank]),
                      torch.from_numpy(text), train2d.LOGIT_SCALE)
    finally:
        train2d.all_reduce_mean_, criterion.sample_mask_points = reduce, sample
    return {"grads": grads, "losses": {k: float(v) for k, v in losses.items()},
            "local_grads": dict(zip(names, seen["local"][:-1])),
            "local_losses": dict(zip(losses, seen["local"][-1].tolist())),
            "points": seen["points"],
            "params": {k: v.detach().numpy().copy() for k, v in params.named_parameters()},
            "equal": replicas_equal(list(params.parameters()))}
