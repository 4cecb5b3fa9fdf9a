"""The benchmark of ``geopurify_tpu_torch`` on NVIDIA H100 cards: one run of
one cell, one JSON line as the last line of standard output.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), the traffic the generator draws from the seed,
the limits of the comparison that decides ``correct`` and its runner.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones: every reader in ``metrics/`` that finds something to read
in the traced run. Logs and the numbers compared, each beside its limit,
go to standard error; the run exits 1 without a result when the card is
missing, and 3 when a module of JAX or of the JAX package has been loaded.

The runner is the module of ``perfbench/`` that the cell's ``runner`` key
names (``cells.load_cell`` fills in ``stage1`` or ``stage2`` from its
``stage`` where there is none), so that a cell of a new kind comes as new
files. It has three functions:

- ``run(cell, seed, seconds, trace, device, say, **hooks)``: set-up, the
  window and the comparison, returning ``attempted`` (items completed in
  the window), ``setup_end`` (``time.perf_counter()`` at the window's
  opening), optionally ``setup_excluded`` (seconds of set-up that are the
  benchmark's own, left out of ``setup_s``), ``e2e`` (the end-to-end
  metrics but ``peak_gib`` and ``setup_s``, by name), ``peak_window`` and
  ``peak_run`` (bytes allocated at most in the window and in the run),
  ``numbers`` (every number compared, by the names of the cell's
  ``limits``) and ``records``: for the readers of its ``stage`` (the item
  kind they key on: 1 a training step, 2 a scene) ``item_seconds`` (the
  wall seconds of each item of the window), ``trace_items`` (the items
  under the profiler) and, with ``trace``, ``trace`` (``Window.result``)
  and ``split`` (Stage 1: a dict a step, ``sampler`` and ``update``
  seconds) or ``stage_seconds`` (Stage 2: a dict a scene of its stage
  spans); the span readers (``spans.py``) take the program's recorded
  items of the stage's root, ``step`` or ``scene``, as many as the steady
  entries of ``split`` or ``stage_seconds``. ``hooks`` plant faults
  (``faults.py``);
- ``work(cell)``: the counted work of an item (``derive_work``);
- ``control(cell, seed, device, lowp=None)``: the numbers that ``run``
  compares, with the plain reference a precision step down in the
  program's place (``calibrate``).

``stage1.run`` has seams (its docstring) through which a runner in another
file reuses Stage 1's set-up, window and comparison.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".cache" / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "geopurify_tpu")
GIB = float(1 << 30)
UNITS = {"scenes_per_s": "scenes/s", "step_s": "s/step"}


def say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the JAX
    package's, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def read_metrics(rec: dict) -> dict:
    """Every per-layer reader of ``metrics/`` that finds something to read."""
    out = {}
    for path in sorted((HERE / "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location(f"perfbench_metric_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(rec)
        if value is not None:
            out[path.stem] = {"value": float(value), "unit": mod.UNIT}
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, **hooks) -> dict:
    """One run of ``cell`` on ``device``: the result's keys but ``device``'s
    own name, with the per-layer records under ``records``."""
    from perfbench import cells, compare

    out = cells.runner(cell).run(cell, seed, seconds, trace, device, say, **hooks)
    checks = compare.judge(out["numbers"], cell["limits"])
    correct = all(c["ok"] for c in checks.values())
    if trace:
        rec = dict(out["records"], cell=cell, work=cells.load_work(cell["name"]))
        metrics = read_metrics(rec)
    else:
        metrics = {k: {"value": v, "unit": UNITS[k]} for k, v in out["e2e"].items()}
        metrics["peak_gib"] = {"value": out["peak_window"] / GIB, "unit": "GiB"}
        # the benchmark's own reference work before the window (Stage 2's
        # class prompts) is no set-up of the program's
        setup = out["setup_end"] - T_START - out.get("setup_excluded", 0.0)
        metrics["setup_s"] = {"value": setup, "unit": "s"}
    return {"correct": correct, "attempted": out["attempted"], "failed": 0 if correct else 1,
            "metrics": metrics, "peak_run": out["peak_run"],
            "trace": out["records"]["trace"] if trace else None,
            "numbers": out["numbers"],
            "checks": {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}}


def main(argv=None) -> int:
    args = parse_args(argv)
    seed = args.seed % (1 << 63)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    from perfbench import cells

    cell = cells.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        say(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 1
    device = torch.device("cuda", 0)
    say(f"{args.workload}: {torch.cuda.get_device_name(device)}, seed {seed}, "
        f"{args.seconds:g} s, trace {args.trace}")
    res = run_cell(cell, seed, args.seconds, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        say(f"modules of JAX or the JAX package were loaded: {', '.join(bad)}")
        return 3
    result = {
        "correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
        "metrics": res["metrics"],
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell["chips"], "memory_peak_bytes": int(res["peak_run"])},
    }
    if res["trace"] is not None:
        result["device"]["busy_s"] = res["trace"]["busy_s"]
        result["device"]["window_s"] = res["trace"]["window_s"]
        result["breakdown"] = {"device_ops": res["trace"]["device_ops"],
                               "idle_gaps": res["trace"]["idle_gaps"]}
    result["checks"] = res["checks"]
    print(json.dumps(result), flush=True)
    for k, c in res["checks"].items():
        say(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
