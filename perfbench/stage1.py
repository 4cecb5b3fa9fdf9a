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
port's sampler (synchronised), then calls the step with those pairs, and
the window's steps are recorded by the program's span recorder
(``profiling.recording``), whose one synchronize comes after the last step.

``run`` has seams through which a runner in another file reuses this
set-up, window and comparison with other inputs and other work in the
step; their defaults give the teacher-cache step above:

- ``inputs(cell, seed, device) -> (scenes, f2d, ft)``: the frozen inputs,
  a list each, scene ``t % len(scenes)`` feeding step ``t``;
- ``ahead(t, batch, f2d, ft) -> ft``: work inside the timed call ahead of
  the train step (a live teacher; ``t`` counts the steps from the set-up's
  first); it returns the teacher features the step takes, and its results
  of the set-up steps are kept on the host for ``reference``;
- ``reference(cell, seed, scenes, f2d, ft, kept, lowp=None) -> (ft_ref,
  numbers)``: the plain reference's side of those inputs, the teacher
  features its steps take (a precision step down where ``lowp`` is
  given), and the numbers that hold the program's ``kept`` against them
  (none where ``kept`` is None), joined to ``compare.stage1_numbers``'s.
  It runs once the step object is freed, and frees what ``ahead`` holds
  of the program.

``work`` counts a step's operations (``derive_work``); ``control`` runs
the reference a precision step down in the program's place
(``calibrate``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import torch

from perfbench import cells, compare, peaks, refrun
from perfbench.derive_work import student_flops
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


def work(cell: dict) -> dict:
    """A step's counted operations (the room of seed 0) and K2's work a
    launch, forward and backward."""
    prog, tr = cell["program"], cell["traffic"]
    cc = prog["contrastive"]
    P, M = tr["scene"]["points"], tr["scene"]["voxels"]
    scene = build_scene([0, 0], P, M, 1, 64, (8, 8))
    A, D, E = cc["num_anchors"], tr["teacher_dim"], prog["student"]["embed_dim"]
    NEG = cc["num_negatives"]
    parts = {
        "sampler": 2.0 * A * P * D + 2.0 * A * cc["spatial_knn_k"] * D,
        **student_flops(prog, scene, backward=True),
        "loss": peaks.k2_work(A, NEG, E, False)[0] + peaks.k2_work(A, NEG, E, True)[0],
    }
    fwd, bwd = peaks.k2_work(A, NEG, E, False), peaks.k2_work(A, NEG, E, True)
    return {"parts": parts, "flops_per_item": sum(parts.values()),
            "k2_fwd": {"A": A, "NEG": NEG, "E": E, "flops": fwd[0], "bytes": fwd[1]},
            "k2_bwd": {"A": A, "NEG": NEG, "E": E, "flops": bwd[0], "bytes": bwd[1]}}


def control(cell: dict, seed: int, device, lowp=None, inputs=inputs, reference=None) -> dict:
    """The numbers of ``run`` with the plain reference a precision step
    down in the program's place (the student in bf16; with a ``reference``
    seam its teacher features too, at ``lowp``, bf16 unless given),
    against the reference in f32, on the cell's own inputs and sizes."""
    scenes, f2d, ft = inputs(cell, seed, device)
    ft_ref = ft_low = ft
    extra = {}
    if reference is not None:
        ft_low, _ = reference(cell, seed, scenes, f2d, ft, None, lowp or "bf16")
        kept = [ft_low[t % len(scenes)].cpu() for t in range(SET_UP_STEPS)]
        ft_ref, extra = reference(cell, seed, scenes, f2d, ft, kept)
    gen_seed = sub_seed(seed, 5)
    ref, p0 = refrun.stage1_reference(cell, seed, scenes, f2d, ft_ref, gen_seed, SET_UP_STEPS)
    low, _ = refrun.stage1_reference(cell, seed, scenes, f2d, ft_low, gen_seed,
                                     SET_UP_STEPS, lowp="bf16")
    return {**compare.stage1_numbers(low, ref, p0), **extra}


def run(cell: dict, seed: int, seconds: float, trace: bool, device: torch.device,
        say: Callable, step_fn=None, inputs=inputs, ahead=None,
        reference=None) -> Dict[str, object]:
    """One run of a Stage-1 cell. ``step_fn(step, state, scene, f2d, ft,
    pairs)`` replaces the timed call where a test plants a fault;
    ``inputs``, ``ahead`` and ``reference`` are the seams of the module's
    docstring."""
    from geopurify_tpu_torch.data.batch import SceneBatch
    from geopurify_tpu_torch.models.pipeline import GeoPurifyPipeline
    from geopurify_tpu_torch.ops.contrastive import sample_contrastive_pairs_hybrid
    from geopurify_tpu_torch.run.optim import make_optimizer
    from geopurify_tpu_torch.run.train import TrainState, make_train_step, rank_generator
    from geopurify_tpu_torch.utils import profiling

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

    def teacher(t):
        i = t % len(batches)
        return ft[i] if ahead is None else ahead(t, batches[i], f2d[i], ft[i])

    prog_first, kept = {"losses": []}, []
    for t in range(SET_UP_STEPS):
        i = t % len(batches)
        ft_t = teacher(t)
        loss = step_fn(step, state, batches[i], f2d[i], ft_t)
        prog_first["losses"].append(float(loss))
        if ahead is not None:
            kept.append(ft_t.detach().cpu())
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
    # traced, the program records the window's steps; the recorder's one
    # synchronize comes when the block closes, after the last step
    with profiling.recording(device) if trace else contextlib.nullcontext():
        while True:
            i = (SET_UP_STEPS + n) % len(batches)
            ti = time.perf_counter()
            ft_t = teacher(SET_UP_STEPS + n)
            pairs, part = None, {}
            if trace:
                if ahead is not None:
                    sync(device)
                    part["ahead"] = time.perf_counter() - ti
                ta = time.perf_counter()
                with torch.no_grad():
                    pairs = sample_contrastive_pairs_hybrid(
                        rank_generator(state.generator, 0), ft_t, batches[i].point_valid,
                        coords=batches[i].points, num_anchors=cc.num_anchors,
                        num_macro=cc.num_macro_negatives, num_micro=cc.num_micro_negatives,
                        spatial_k=cc.spatial_knn_k, spatial_method=cc.spatial_method,
                        spatial_radius=cc.spatial_radius)
                sync(device)
                part["sampler"] = time.perf_counter() - ta
            ts = time.perf_counter()
            float(step_fn(step, state, batches[i], f2d[i], ft_t, pairs))
            t_done = time.perf_counter()
            item_s.append(t_done - ti)
            if trace:
                split.append(dict(part, update=t_done - ts))
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
    ft_ref, extra = (ft, {}) if reference is None else reference(
        cell, seed, scenes, f2d, ft, kept)
    ref, p0 = refrun.stage1_reference(cell, seed, scenes, f2d, ft_ref, gen_seed, SET_UP_STEPS)
    prog_dev = {"losses": prog_first["losses"],
                "grads1": {k: v.to(device) for k, v in prog_first["grads1"].items()},
                "params": {k: v.to(device) for k, v in prog_first["params"].items()}}
    numbers = {**compare.stage1_numbers(prog_dev, ref, p0), **extra}
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
