"""A cell's files, found by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``), its traffic, its overrides, the
limits of its comparison and, under ``runner``, the module of
``perfbench/`` that runs it (without the key, ``stage1`` or ``stage2``
from its ``stage``); ``work/<cell>.json`` holds its counted work.
``program_config`` builds the port's configuration from the same numbers
the reference reads.
"""

from __future__ import annotations

import copy
import importlib
import json
import re
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
# the runner of a cell that names none, by its ``stage`` (the item kind
# the readers key on: 1 a training step, 2 a scene)
DEFAULT_RUNNER = {1: "stage1", 2: "stage2"}
MODULE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*(\.[A-Za-z_][A-Za-z0-9_]*)*$")


def _read(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1]} named {name!r} ({path} is missing)")
    return json.loads(path.read_text())


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over`` laid on it, nested dicts merged key by key."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def runner_path(name: str) -> Path:
    """The file of the runner ``name``, a module of ``perfbench/``
    (``tests.toy_runner`` is ``perfbench/tests/toy_runner.py``); exits
    naming the file where there is none."""
    path = HERE / f"{name.replace('.', '/')}.py"
    if not MODULE.match(name) or not path.is_file():
        raise SystemExit(f"no runner named {name!r} ({path} is missing)")
    return path


def runner(cell: dict):
    """The module that runs ``cell`` (the contract: ``run.py``'s docstring)."""
    runner_path(cell["runner"])
    return importlib.import_module(f"perfbench.{cell['runner']}")


def load_cell(name: str) -> dict:
    """The workload file with its runner's name under ``runner`` (the
    default filled in), its configuration file under ``config_file`` and
    the configuration as this cell runs it under ``program``."""
    cell = _read("workloads", name)
    cell.setdefault("runner", DEFAULT_RUNNER.get(cell["stage"], ""))
    runner_path(cell["runner"])
    conf = _read("configs", cell["config"])
    cell["config_file"] = conf
    cell["program"] = merge(conf["program"], cell.get("overrides", {}))
    return cell


def load_work(name: str) -> dict:
    path = HERE / "work" / f"{name}.json"
    return json.loads(path.read_text()) if path.is_file() else {}


def _dotted(tree: dict, prefix: str = "") -> List[str]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _dotted(v, f"{prefix}{k}.")
        else:
            out.append(f"{prefix}{k}={v!r}")
    return out


def program_config(cell: dict):
    """The port's ``GeoPurifyConfig``: the preset the configuration names,
    with every number of the cell's ``program`` laid on it."""
    from geopurify_tpu_torch.config import load_config

    return load_config(cell["config_file"]["preset"], overrides=_dotted(cell["program"]))


def n_classes(cell: dict) -> int:
    return int(cell["config_file"]["classes"])
