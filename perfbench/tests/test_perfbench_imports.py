"""What the benchmark loads: nothing of JAX or the JAX package anywhere, and
nothing of the program in the reference. Each check runs in a fresh
interpreter, so that what the test process has loaded does not count.
Top-level module names are compared whole: ``geopurify_tpu_torch`` begins
with ``geopurify_tpu`` and is not the JAX package."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "geopurify_tpu"}
REFERENCE = sorted(p.stem for p in (ROOT / "perfbench" / "reference").glob("*.py")
                   if p.stem != "__init__")


def loaded_after(imports):
    code = ("import json, sys\n" + "".join(f"import {m}\n" for m in imports)
            + "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, env={"PATH": "/usr/bin:/bin",
                                                     "PYTHONPATH": str(ROOT)})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_benchmark_loads_no_jax():
    mods = ["perfbench.run", "perfbench.calibrate", "perfbench.derive_work",
            "perfbench.stage1", "perfbench.stage2",
            # what the cells' runners import from the program
            "geopurify_tpu_torch.models.pipeline", "geopurify_tpu_torch.data.batch",
            "geopurify_tpu_torch.ops.contrastive", "geopurify_tpu_torch.run.optim",
            "geopurify_tpu_torch.run.train"]
    top = loaded_after(mods + [f"perfbench.reference.{m}" for m in REFERENCE])
    assert "geopurify_tpu_torch" in top and "perfbench" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    top = loaded_after([f"perfbench.reference.{m}" for m in REFERENCE]
                       + ["perfbench.gen.scene", "perfbench.gen.weights", "perfbench.compare",
                          "perfbench.peaks", "perfbench.trace"])
    assert "torch" in top
    assert not top & (FORBIDDEN | {"geopurify_tpu_torch"}), top


def test_forbidden_check_compares_whole_names():
    from perfbench import run

    assert run.forbidden_modules(["geopurify_tpu_torch", "geopurify_tpu_torch.ops",
                                  "jaxtyping", "torch"]) == []
    assert run.forbidden_modules(["geopurify_tpu.ops.knn", "jax._src", "flax"]) == [
        "flax", "geopurify_tpu", "jax"]
