"""The readings that the limits of a cell's comparison are set from, in one
process (the card's set-up paid once):

- the program: a short run of the cell on each of ``--seeds``, every number
  that ``compare`` computes (not only those the cell limits);
- the faults of ``faults.FAULTS`` named in ``--faults``, planted under the
  timed path, on each of ``--fault-seeds``;
- the control: on each of ``--control-seeds``, the cell's runner's
  ``control(cell, seed, device)``: the plain reference computed a step
  below the configuration's precision (Stage 2: the X-Decoder's operands
  in float8 e4m3, the student in bf16; Stage 1: the student in bf16) in
  the program's place, against the reference in f32, on the cell's own
  inputs and sizes;
- the witness: on each of ``--witness-seeds``, ``control(cell, seed,
  device, lowp="bf16")`` (Stage 2: the plain reference with the
  X-Decoder's operands in bf16, the configuration's own precision, against
  the reference in f32: how far bf16 alone moves each number, with no code
  of the program).

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

from perfbench import cells, faults, run


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
    runner = cells.runner(cell)
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
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        t = time.perf_counter()
        emit({"side": "control", "seed": s, "numbers": runner.control(cell, s, device),
              "seconds": time.perf_counter() - t})
        torch.cuda.empty_cache()
    for s in [int(x) for x in args.witness_seeds.split(",") if x]:
        t = time.perf_counter()
        emit({"side": "witness:bf16", "seed": s,
              "numbers": runner.control(cell, s, device, lowp="bf16"),
              "seconds": time.perf_counter() - t})
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
