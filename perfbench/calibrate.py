"""The readings that the limits of a cell's comparison are set from, in one
process (the card's set-up paid once):

- the program: a short run of the cell on each of ``--seeds``, every number
  that ``compare`` computes (not only those the cell limits);
- the faults of ``faults.FAULTS`` named in ``--faults``, planted under the
  timed path, on each of ``--fault-seeds``;
- the control: on each of ``--control-seeds``, the plain reference computed
  a step below the configuration's precision (Stage 2: the X-Decoder's
  operands in float8 e4m3, the student in bf16; Stage 1: the student in
  bf16) in the program's place, against the reference in f32, on the
  cell's own inputs and sizes;
- the witness (Stage 2): on each of ``--witness-seeds``, the plain
  reference with the X-Decoder's operands in bf16, the configuration's own
  precision, against the reference in f32: how far bf16 alone moves each
  number, with no code of the program.

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 5 [--out readings.jsonl]

The benchmark's own runs never run the control. One JSON line a reading
goes to standard output (and to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from perfbench import cells, compare, faults, refrun, run
from perfbench.gen.scene import to_device


def control_stage2(cell: dict, seed: int, device, lowp: str = "fp8") -> dict:
    from perfbench import stage2
    from perfbench.gen.weights import sub_seed

    pool = stage2.build_pool(seed, cell)
    xsd, _ = refrun.draw_weights(cell, seed, device)
    text = stage2.class_prompts(cell, xsd, to_device(pool[0], device), seed)
    del xsd
    P = cell["traffic"]["scene"]["points"]
    g = torch.Generator(device="cpu").manual_seed(sub_seed(seed, 6))
    idx = torch.sort(torch.randperm(P, generator=g)[:stage2.LOGIT_SAMPLE]).values.to(device)
    per_scene = []
    for j in range(cell["traffic"]["check_scenes"]):
        scene = to_device(pool[j], device)
        ref = refrun.stage2_reference(cell, seed, scene, text)
        low = refrun.stage2_reference(cell, seed, scene, text, lowp=lowp)
        low["logits"] = low["logits"][idx]
        per_scene.append(compare.stage2_numbers(low, ref, scene["point_valid"], idx))
        del ref, low
    return compare.mean_numbers(per_scene)


def control_stage1(cell: dict, seed: int, device) -> dict:
    from perfbench import stage1
    from perfbench.gen.weights import sub_seed

    scenes, f2d, ft = stage1.inputs(cell, seed, device)
    gen_seed = sub_seed(seed, 5)
    ref, p0 = refrun.stage1_reference(cell, seed, scenes, f2d, ft, gen_seed, stage1.SET_UP_STEPS)
    low, _ = refrun.stage1_reference(cell, seed, scenes, f2d, ft, gen_seed,
                                     stage1.SET_UP_STEPS, lowp="bf16")
    return compare.stage1_numbers(low, ref, p0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--witness-seeds", default="")
    p.add_argument("--faults", default="", help="names of faults.FAULTS to plant")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = cells.load_cell(args.workload)
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    kind = torch.cuda.get_device_name(device)

    def emit(rec):
        line = json.dumps(dict(rec, workload=args.workload, device=kind))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for s in [int(x) for x in args.seeds.split(",") if x]:
        t = time.perf_counter()
        res = run.run_cell(cell, s, args.seconds, False, device)
        emit({"side": "program", "seed": s, "numbers": res["numbers"],
              "metrics": res["metrics"], "seconds": time.perf_counter() - t})
        torch.cuda.empty_cache()
    for name in [x for x in args.faults.split(",") if x]:
        _, hooks, ctx = faults.FAULTS[name]
        for s in [int(x) for x in args.fault_seeds.split(",") if x]:
            with ctx():
                res = run.run_cell(cell, s, args.seconds, False, device, **hooks)
            emit({"side": f"fault:{name}", "seed": s, "numbers": res["numbers"]})
            torch.cuda.empty_cache()
    control = control_stage2 if cell["stage"] == 2 else control_stage1
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        t = time.perf_counter()
        emit({"side": "control", "seed": s, "numbers": control(cell, s, device),
              "seconds": time.perf_counter() - t})
        torch.cuda.empty_cache()
    for s in [int(x) for x in args.witness_seeds.split(",") if x]:
        t = time.perf_counter()
        emit({"side": "witness:bf16", "seed": s,
              "numbers": control_stage2(cell, s, device, lowp="bf16"),
              "seconds": time.perf_counter() - t})
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
