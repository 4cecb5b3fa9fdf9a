"""Stage-1 cells: the student's distillation steps back to back through the
port's ``run/train.py::make_train_step`` (the fused K2 loss and AdamW),
on two seeded scenes kept on the card with their 512-d lifted and teacher
features drawn from the seed (the teacher-cache mode), in turn.

Set-up builds the one step object (the pipeline's student with the drawn
weights, its optimizer, the anchor generator from the seed) and drives it
through its first three steps, which build K2 and warm the allocator; it
keeps their losses, the first gradient as AdamW holds it (its first moment
over 1 - beta1) and the weights after the third. The window goes on with
that same object; no step starts once ``seconds`` have passed, and
``step_s`` is the window's time to its last completion over the steps.

After the window the plain reference follows the first three steps from
the same weights, scenes and generator (``reference/stage1.py``), and
``compare.stage1_numbers`` holds the two. With ``--trace 1`` each step of
the window is split: the harness draws the step's anchors through the
port's sampler (synchronised), then calls the step with those pairs.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from perfbench import cells, compare, refrun
from perfbench.gen.scene import build_scene, to_device
from perfbench.gen.weights import draw_student, sub_seed, unit_rows
from perfbench.stage2 import sync
from perfbench.trace import Window

SET_UP_STEPS = 3


def inputs(cell: dict, seed: int, device) -> tuple:
    """The scenes and their lifted and teacher features, from the seed."""
    tr = cell["traffic"]
    sc = tr["scene"]
    P, M = sc["points"], sc["voxels"]
    scenes, f2d, ft = [], [], []
    for i in range(tr["scenes"]):
        scenes.append(to_device(build_scene([seed, i], P, M, 1, 64, (8, 8)), device))
        g = torch.Generator(device=device).manual_seed(sub_seed(seed, 10, i))
        f2d.append(torch.randn((P, cell["program"]["pooling"]["feature_dim"]),
                               generator=g, device=device))
        ft.append(torch.randn((P, tr["teacher_dim"]), generator=g, device=device))
    return scenes, f2d, ft


def run(cell: dict, seed: int, seconds: float, trace: bool, device: torch.device,
        say: Callable, step_fn=None) -> Dict[str, object]:
    """One run of a Stage-1 cell. ``step_fn(step, state, scene, f2d, ft,
    pairs)`` replaces the timed call where a test plants a fault."""
    from geopurify_tpu_torch.data.batch import SceneBatch
    from geopurify_tpu_torch.models.pipeline import GeoPurifyPipeline
    from geopurify_tpu_torch.ops.contrastive import sample_contrastive_pairs_hybrid
    from geopurify_tpu_torch.run.optim import make_optimizer
    from geopurify_tpu_torch.run.train import TrainState, make_train_step, rank_generator

    if step_fn is None:
        def step_fn(step, state, scene, f2d, ft, pairs=None):
            return step(state, scene, f2d, ft, pairs=pairs)

    tr = cell["traffic"]
    cfg = cells.program_config(cell)
    cc = cfg.contrastive
    scenes, f2d, ft = inputs(cell, seed, device)
    batches = [SceneBatch(**s) for s in scenes]
    _, st_shapes = refrun.shapes(cell["program"])
    ssd = draw_student(st_shapes, sub_seed(seed, 2), device)
    n_cls = cells.n_classes(cell)
    pipe = GeoPurifyPipeline(cfg, unit_rows(n_cls + 1, cfg.xdecoder.hidden_dim,
                                            sub_seed(seed, 3), device),
                             cell["config_file"]["logit_scale"], device=device)
    pipe.student.load_state_dict(ssd)
    del ssd
    optimizer, _ = make_optimizer(cfg.train, pipe.student,
                                  steps_per_epoch=tr["steps_per_epoch"])
    gen_seed = sub_seed(seed, 5)
    state = TrainState(pipe.student, optimizer, 0,
                       torch.Generator(device=device).manual_seed(gen_seed))
    step = make_train_step(pipe)
    beta1 = optimizer.adamw.param_groups[0]["betas"][0]

    prog_first = {"losses": []}
    for t in range(SET_UP_STEPS):
        i = t % len(batches)
        loss = step_fn(step, state, batches[i], f2d[i], ft[i])
        prog_first["losses"].append(float(loss))
        if t == 0:
            prog_first["grads1"] = {
                n: (optimizer.adamw.state[p]["exp_avg"] / (1 - beta1)).cpu()
                for n, p in pipe.student.named_parameters()}
    prog_first["params"] = {n: p.detach().to("cpu", copy=True)
                           for n, p in pipe.student.named_parameters()}
    peak_setup = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window = Window(trace)
    sync(device)
    setup_end = time.perf_counter()

    split, item_s = [], []
    window.start()
    t_open = time.perf_counter()
    n = 0
    while True:
        i = (SET_UP_STEPS + n) % len(batches)
        ti = time.perf_counter()
        pairs = None
        if trace:
            with torch.no_grad():
                pairs = sample_contrastive_pairs_hybrid(
                    rank_generator(state.generator, 0), ft[i], batches[i].point_valid,
                    coords=batches[i].points, num_anchors=cc.num_anchors,
                    num_macro=cc.num_macro_negatives, num_micro=cc.num_micro_negatives,
                    spatial_k=cc.spatial_knn_k, spatial_method=cc.spatial_method,
                    spatial_radius=cc.spatial_radius)
            sync(device)
        ts = time.perf_counter()
        float(step_fn(step, state, batches[i], f2d[i], ft[i], pairs))
        t_done = time.perf_counter()
        item_s.append(t_done - ti)
        if trace:
            split.append({"sampler": ts - ti, "update": t_done - ts})
        n += 1
        if n == tr["trace_items"]:
            window.stop()
        if t_done - t_open >= seconds:
            break
    window.stop()
    span = t_done - t_open
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del pipe, state, optimizer, step, batches
    say(f"{n} steps in {span:.3f}s: {span / n:.4f} s/step")

    traced = window.result()
    if trace:
        say(f"trace: {window.counts[0]} device ops, {window.counts[1]} window marks")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref, p0 = refrun.stage1_reference(cell, seed, scenes, f2d, ft, gen_seed, SET_UP_STEPS)
    prog_dev = {"losses": prog_first["losses"],
                "grads1": {k: v.to(device) for k, v in prog_first["grads1"].items()},
                "params": {k: v.to(device) for k, v in prog_first["params"].items()}}
    numbers = compare.stage1_numbers(prog_dev, ref, p0)
    say(f"reference steps: {time.perf_counter() - t_ref:.2f}s; losses "
        f"{prog_first['losses']} against {ref['losses']}")
    return {
        "attempted": n,
        "setup_end": setup_end,
        "e2e": {"step_s": span / n},
        "peak_window": peak,
        "peak_run": max(peak, peak_setup),
        "numbers": numbers,
        "records": {"item_seconds": item_s, "split": split,
                    "trace_items": tr["trace_items"], "trace": traced},
    }
