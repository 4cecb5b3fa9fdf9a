"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and compiles on its
own into ``<build dir>/lib<name>-<hash>.so`` (the hash is the source's
and the ``csrc/*.cuh`` headers', so an edit rebuilds). Sources include no
PyTorch header, which keeps a build to seconds. ``build_all`` starts one
nvcc per source at once and waits for all of them. Nothing here runs at
import.

The build directory (``build_dir``) is the package's own ``_build/`` when
it can be written (a checkout, an editable install), else
``$XDG_CACHE_HOME/geopurify_tpu_torch`` (``~/.cache`` when that is unset),
as for a wheel in a read-only site-packages; the host library of
``native/`` builds there too.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

log = logging.getLogger("geopurify.cuda_build")

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
SOURCES = ("band_matmul", "infonce")

_loaded: Dict[str, ctypes.CDLL] = {}
_build_dir: Optional[Path] = None


def _writable(d: Path) -> bool:
    try:
        d.mkdir(parents=True, exist_ok=True)
    except OSError:
        return False
    return os.access(d, os.W_OK | os.X_OK)


def build_dir() -> Path:
    """Where built libraries go: the package's ``_build/`` if it can be
    written, else the user cache directory (logged once). Raises when
    neither can be written."""
    global _build_dir
    if _build_dir is None:
        cache = Path(os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache")
        for cand in (BUILD, cache / "geopurify_tpu_torch"):
            if _writable(cand):
                break
        else:
            raise RuntimeError(f"no writable build directory: {BUILD} and {cand} refused")
        if cand != BUILD:
            log.warning("%s is not writable: building into %s", BUILD, cand)
        else:
            log.info("building into %s", cand)
        _build_dir = cand
    return _build_dir


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # headers a source may include
        h.update(header.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path):
    return [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
            "-fPIC", "-Xptxas", "-v", "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library in parallel; returns name -> ptxas log
    (empty for a library that was already built). Raises on a failed build."""
    procs = {}
    for name in names:
        out = _lib_path(name)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen(
                _command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first use)."""
    if name not in _loaded:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
