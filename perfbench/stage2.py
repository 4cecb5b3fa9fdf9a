"""Stage-2 cells: scenes labelled back to back through the port's
``GeoPurifyPipeline.evaluate_scene``, one scene in flight.

Set-up builds a pool of distinct scenes on host threads: the room of
the pool's scene i is drawn from the fixed seed i, the same in
every run, so every seed gives the same 3D work (the kNN's certificates,
the band's residual, the z-stack's holes) in the same order; the pixels,
geometric features and views come from the run's seed. It draws the
weights on the card (the frozen teacher from ``refrun.TEACHER_SEED``, as
one released checkpoint serves every scan; the student from the seed),
takes the class prompts from the plain reference's X-Decoder on the first
view (the benchmark's input, not the program's set-up: its seconds are
left out of ``setup_s``), loads the weights into the program and labels
the first scene once (every kernel built, the allocator warm). The window
then labels the pool's scenes in turn: each scene is copied from pinned
host memory on a side stream while the one before it computes (the
loader's upload, inside the window), and no scene starts once ``seconds``
have passed. ``scenes_per_s`` is the scenes completed over the time from
the window's opening to the last completion.

After the window, ``traffic.check_scenes`` of the pool's scenes, drawn
from the seed, are labelled again by the plain reference in f32 from the
same inputs and weights, and the program's answers for them (kept from the
window) are compared, each number the mean over those scenes
(``compare.stage2_numbers``).

``work`` counts a scene's operations (``derive_work``); ``control`` runs
the reference a precision step down in the program's place, or at the
configuration's own bf16 as the witness (``calibrate``).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict

import torch

from perfbench import cells, compare, peaks, refrun
from perfbench.derive_work import (ROW_TILE, lift_flops_per_view, student_flops,
                                   xdecoder_flops_per_view)
from perfbench.gen.scene import build_scene, to_device
from perfbench.gen.weights import prompts_from_lift, sub_seed, unit_rows
from perfbench.trace import Window

LOGIT_SAMPLE = 65536      # points whose logit rows the comparison keeps


class Uploader:
    """Host scenes to the device: from pinned memory on a side stream, so
    that a copy overlaps the compute queued before it; ``ready`` makes the
    compute stream wait for the copy and marks the tensors as used there."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def start(self, arrays: dict):
        if self.stream is None:
            return to_device(arrays, self.device), None
        with torch.cuda.stream(self.stream):
            scene = to_device(arrays, self.device, pin=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        return scene, done

    def ready(self, pending) -> dict:
        scene, done = pending
        if done is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(done)
            for t in scene.values():
                t.record_stream(compute)
        return scene


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pool_scene(cell: dict, seed: int, i: int) -> dict:
    """The pool's scene ``i``: its room from the fixed seed ``i``, the rest
    from the run's seed."""
    sc = cell["traffic"]["scene"]
    hw = tuple(cell["program"]["xdecoder"]["mask_shape"])
    return build_scene([seed, i], sc["points"], sc["voxels"], sc["views"],
                       sc["view_points"], hw, geometry_seed=i)


def build_pool(seed: int, cell: dict) -> list:
    n = cell["traffic"]["pool"]
    with ThreadPoolExecutor(max_workers=min(n, 4)) as ex:
        return list(ex.map(lambda i: pool_scene(cell, seed, i), range(n)))


def class_prompts(cell: dict, xsd: dict, scene: dict, seed: int) -> torch.Tensor:
    """The prompts of the queries that win the most points of view 0, by
    the reference X-Decoder in f32 (``gen.weights.prompts_from_lift``)."""
    from perfbench.reference.stage2 import lift_views

    prog = cell["program"]
    dev = scene["points"].device
    xdec = refrun.xdecoder(prog, xsd)
    text0 = unit_rows(cells.n_classes(cell) + 1, prog["xdecoder"]["hidden_dim"],
                      sub_seed(seed, 3), dev)
    with torch.no_grad(), refrun.exact_f32():
        lift = lift_views(xdec, scene, text0, cell["config_file"]["logit_scale"],
                          prog["xdecoder"], 0, 1)
    return prompts_from_lift(lift.winner[0], lift.embed_table[0], cells.n_classes(cell),
                             sub_seed(seed, 4))


def work(cell: dict) -> dict:
    """A scene's counted operations (the mean over the pool's rooms) and
    K1's work a launch."""
    prog, sc = cell["program"], cell["traffic"]["scene"]
    n_cls = cells.n_classes(cell)
    hw = tuple(prog["xdecoder"]["mask_shape"])
    P, M, V, Pv = sc["points"], sc["voxels"], sc["views"], sc["view_points"]
    pc = prog["pooling"]
    C = prog["xdecoder"]["hidden_dim"]
    k, E = pc["knn_k"], prog["student"]["embed_dim"]
    n_rooms = cell["traffic"]["pool"]
    student, n_valid = 0.0, 0.0
    for i in range(n_rooms):
        # the room of the pool's scene i (``pool_scene``); one view
        scene = build_scene([0, i], P, M, 1, Pv, hw, geometry_seed=i)
        student += student_flops(prog, scene, backward=False)["student"] / n_rooms
        n_valid += int(scene["voxel_valid"].sum()) / n_rooms
    parts = {
        "xdecoder": V * xdecoder_flops_per_view(prog, n_cls, hw),
        "lift": V * lift_flops_per_view(prog, n_cls, Pv, hw),
        "fuse": 2.0 * P * prog["xdecoder"]["fusion_top_k"] * C,
        "student": student,
        "projection": 2.0 * n_valid * pc["feature_dim"] * n_cls,
        "graph": 2.0 * n_valid * k * E,
        "smoothing": pc["num_iterations"] * 2.0 * n_valid * k * n_cls,
    }
    n_t = -(-M // ROW_TILE)
    f1, b1 = peaks.k1_work(M, M, pc["band"], n_cls, n_t)
    return {"parts": parts, "flops_per_item": sum(parts.values()),
            "k1": {"R": M, "M": M, "band": pc["band"], "C": n_cls, "n_t": n_t,
                   "flops": f1, "bytes": b1, "launches_per_item": pc["num_iterations"]}}


def control(cell: dict, seed: int, device, lowp=None) -> dict:
    """The numbers of ``run`` over the first ``check_scenes`` of the pool
    with the plain reference in the program's place, its X-Decoder's
    operands in float8 e4m3 and its student in bf16 (``lowp`` "fp8", the
    control) or its X-Decoder's operands in bf16 (``lowp`` "bf16", the
    witness), against the reference in f32."""
    pool = build_pool(seed, cell)
    xsd, _ = refrun.draw_weights(cell, seed, device)
    text = class_prompts(cell, xsd, to_device(pool[0], device), seed)
    del xsd
    P = cell["traffic"]["scene"]["points"]
    g = torch.Generator(device="cpu").manual_seed(sub_seed(seed, 6))
    idx = torch.sort(torch.randperm(P, generator=g)[:LOGIT_SAMPLE]).values.to(device)
    per_scene = []
    for j in range(cell["traffic"]["check_scenes"]):
        scene = to_device(pool[j], device)
        ref = refrun.stage2_reference(cell, seed, scene, text)
        low = refrun.stage2_reference(cell, seed, scene, text, lowp=lowp or "fp8")
        low["logits"] = low["logits"][idx]
        per_scene.append(compare.stage2_numbers(low, ref, scene["point_valid"], idx))
        del ref, low
    return compare.mean_numbers(per_scene)


def run(cell: dict, seed: int, seconds: float, trace: bool, device: torch.device,
        say: Callable, evaluate=None) -> Dict[str, object]:
    """One run of a Stage-2 cell. ``evaluate(pipe, batch, profile)``
    replaces the timed call where a test plants a fault."""
    from geopurify_tpu_torch.data.batch import SceneBatch
    from geopurify_tpu_torch.models.pipeline import GeoPurifyPipeline

    if evaluate is None:
        def evaluate(pipe, batch, profile):
            return pipe.evaluate_scene(batch, n_valid_views=batch.images.shape[0],
                                       profile=profile)

    tr = cell["traffic"]
    cfg = cells.program_config(cell)
    P = tr["scene"]["points"]
    t0 = time.perf_counter()
    pool = build_pool(seed, cell)
    say(f"pool of {len(pool)} scenes built in {time.perf_counter() - t0:.2f}s")
    xsd, ssd = refrun.draw_weights(cell, seed, device)
    first = to_device(pool[0], device)
    sync(device)
    tp = time.perf_counter()
    text = class_prompts(cell, xsd, first, seed)
    sync(device)
    t1 = time.perf_counter()
    prompt_s = t1 - tp
    pipe = GeoPurifyPipeline(cfg, text, cell["config_file"]["logit_scale"], device=device)
    pipe.xdecoder.load_state_dict(xsd)
    pipe.student.load_state_dict(ssd)
    del xsd, ssd
    sync(device)
    t2 = time.perf_counter()
    out = evaluate(pipe, SceneBatch(**first), trace)
    sync(device)
    del out, first
    say(f"set-up: pool and weights {tp - t0:.2f}s, prompts by the reference {prompt_s:.2f}s "
        f"(not in setup_s), pipeline {t2 - t1:.2f}s, first scene {time.perf_counter() - t2:.2f}s")
    g = torch.Generator(device="cpu").manual_seed(sub_seed(seed, 6))
    sample_idx = torch.sort(torch.randperm(P, generator=g)[:LOGIT_SAMPLE]).values.to(device)
    up = Uploader(device)
    window = Window(trace)
    peak_setup = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sync(device)
    setup_end = time.perf_counter()

    kept, item_s, stages, overflow = {}, [], [], 0
    pending = up.start(pool[0])
    window.start()
    t_open = time.perf_counter()
    n = 0
    while True:
        scene = up.ready(pending)
        pending = up.start(pool[(n + 1) % len(pool)])
        ti = time.perf_counter()
        out = evaluate(pipe, SceneBatch(**scene), trace)
        sync(device)
        t_done = time.perf_counter()
        item_s.append(t_done - ti)
        if trace:
            stages.append(out["stage_seconds"])
        overflow = max(overflow, int(out["band_overflow"]))
        if n < len(pool):
            kept[n] = {"pred": out["pred"], "logits": out["logits"][sample_idx]}
        n += 1
        if n == tr["trace_items"]:
            window.stop()
        del out, scene
        if t_done - t_open >= seconds:
            break
    window.stop()
    span = t_done - t_open
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del pending, pipe
    say(f"{n} scenes in {span:.3f}s: {n / span:.4f} scenes/s; band overflow {overflow}")

    # the comparison, once the window has closed and the program is freed
    traced = window.result()
    if trace:
        say(f"trace: {window.counts[0]} device ops, {window.counts[1]} window marks")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checked = torch.randperm(len(kept), generator=g)[:tr["check_scenes"]].tolist()
    t_ref = time.perf_counter()
    per_scene = []
    for j in checked:
        ref = refrun.stage2_reference(cell, seed, to_device(pool[j], device), text)
        per_scene.append(compare.stage2_numbers(kept[j], ref, ref["point_valid"], sample_idx))
        del ref
    numbers = compare.mean_numbers(per_scene)
    say(f"reference on pool scenes {checked}: {time.perf_counter() - t_ref:.2f}s")
    return {
        "attempted": n,
        "setup_end": setup_end,
        "setup_excluded": prompt_s,
        "e2e": {"scenes_per_s": n / span},
        "peak_window": peak,
        "peak_run": max(peak, peak_setup),
        "numbers": numbers,
        "records": {"item_seconds": item_s, "stage_seconds": stages,
                    "trace_items": tr["trace_items"], "trace": traced},
    }
