"""ctypes bindings for the host C++ library (``geopurify_native.cpp``).

Port of geopurify_tpu/native/__init__.py: the same five wrappers with the
same signatures and results (``fnv_voxelize``, ``compute_mapping``,
``vertex_normals``, ``grid_knn``, ``nearest_donor``), over the port's own
copy of the C++ source. The library builds at first use with
``g++ -O3 -shared -fPIC -std=c++17 -pthread`` into the build directory of
the CUDA kernels (``utils/cuda_build.build_dir``: the package's git-ignored
``_build/``, or the user cache directory where that cannot be written),
named by a hash of the source, so an edit rebuilds.

What differs from the JAX module: it builds next to the CUDA kernels, not
beside its source, and a failed build is logged once as a warning with
the compiler's message and ``available()`` is then False; the JAX module
falls back without a word. A wrapper called without the library raises.
The port's loader does not call it: its voxel dedup stays in numpy and
its mapping on the card (``ops/voxelize``, ``ops/projection``), each
measured faster there (PERF.md).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger("geopurify.native")

SRC = Path(__file__).resolve().parent / "geopurify_native.cpp"
COMMAND = ("g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
_lock = threading.Lock()


def library_path() -> Path:
    from geopurify_tpu_torch.utils.cuda_build import build_dir

    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    return build_dir() / f"libgeopurify_native-{digest}.so"


def _build() -> ctypes.CDLL:
    out = library_path()
    if not out.exists():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([*COMMAND, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed:\n{proc.stderr}")
        os.replace(tmp, out)       # atomic: parallel workers never load half a file
    return ctypes.CDLL(str(out))


# geopurify_tpu/native/__init__.py:45
def _get() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    with _lock:
        if _lib is None and _build_error is None:
            try:
                lib = _build()
                _declare(lib)
                _lib = lib
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _build_error = str(e)
                log.warning("the native host library did not build; the numpy routes "
                            "run instead: %s", _build_error)
    return _lib


# geopurify_tpu/native/__init__.py:58
def _declare(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)

    lib.fnv_hash_rows.argtypes = [i64p, ctypes.c_int64, ctypes.c_int32, u64p]
    lib.fnv_hash_rows.restype = None
    lib.fnv_voxelize.argtypes = [i64p, ctypes.c_int64, ctypes.c_int32, i64p, i64p]
    lib.fnv_voxelize.restype = ctypes.c_int64
    lib.compute_mapping.argtypes = [
        f32p, ctypes.c_int64, f64p, f64p, f32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
        i32p, i32p, u8p,
    ]
    lib.compute_mapping.restype = None
    lib.accumulate_face_normals.argtypes = [f32p, ctypes.c_int64, i64p, ctypes.c_int64, f64p]
    lib.accumulate_face_normals.restype = None
    lib.nearest_donor.argtypes = [f32p, ctypes.c_int64, u8p, i64p]
    lib.nearest_donor.restype = None
    lib.grid_knn.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32, i64p, f32p]
    lib.grid_knn.restype = None


def available() -> bool:
    """True once the library is built and loaded (builds on the first call)."""
    return _get() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _get()
    if lib is None:
        raise RuntimeError(f"the native host library is not available: {_build_error}")
    return lib


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


# geopurify_tpu/native/__init__.py:94
def fnv_voxelize(discrete: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``np.unique`` over the rows' FNV-1a hashes: (inds, inds_reverse)."""
    lib = _lib_or_raise()
    coords = np.ascontiguousarray(discrete, np.int64)
    n, d = coords.shape
    inds = np.empty(n, np.int64)
    inds_reverse = np.empty(n, np.int64)
    m = lib.fnv_voxelize(_ptr(coords, ctypes.c_int64), n, d,
                         _ptr(inds, ctypes.c_int64), _ptr(inds_reverse, ctypes.c_int64))
    return inds[:m].copy(), inds_reverse


# geopurify_tpu/native/__init__.py:109
def compute_mapping(points: np.ndarray, w2c: np.ndarray, K: np.ndarray,
                    depth: Optional[np.ndarray], image_dim: Tuple[int, int],
                    cut_bound: int = 10, vis_thres: float = 0.05
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The loader's occlusion-tested mapping on the host: (rows int32, cols
    int32, visible bool); points in f32, the arithmetic in f64."""
    lib = _lib_or_raise()
    W, H = image_dim
    pts = np.ascontiguousarray(points, np.float32)
    n = len(pts)
    w2c_ = np.ascontiguousarray(w2c, np.float64)
    K_ = np.ascontiguousarray(np.asarray(K)[:3, :3], np.float64)
    rows = np.empty(n, np.int32)
    cols = np.empty(n, np.int32)
    vis = np.empty(n, np.uint8)
    if depth is not None:
        depth_ = np.ascontiguousarray(depth, np.float32)
        dptr = _ptr(depth_, ctypes.c_float)
    else:
        dptr = ctypes.POINTER(ctypes.c_float)()
    lib.compute_mapping(_ptr(pts, ctypes.c_float), n, _ptr(w2c_, ctypes.c_double),
                        _ptr(K_, ctypes.c_double), dptr, W, H, cut_bound, vis_thres,
                        _ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32),
                        _ptr(vis, ctypes.c_uint8))
    return rows, cols, vis.astype(bool)


# geopurify_tpu/native/__init__.py:138
def vertex_normals(xyz: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Face-area-weighted vertex normals, L2-normalised, f32."""
    lib = _lib_or_raise()
    x = np.ascontiguousarray(xyz, np.float32)
    f = np.ascontiguousarray(faces, np.int64)
    out = np.zeros((len(x), 3), np.float64)
    lib.accumulate_face_normals(_ptr(x, ctypes.c_float), len(x), _ptr(f, ctypes.c_int64),
                                len(f), _ptr(out, ctypes.c_double))
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    return (out / np.maximum(norm, 1e-12)).astype(np.float32)


# geopurify_tpu/native/__init__.py:152
def grid_knn(coords: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN over unique integer grid cells (Chebyshev-shell expansion):
    (idx [m, k] int64 with -1 padding, d2 [m, k] f32 ascending)."""
    lib = _lib_or_raise()
    c = np.ascontiguousarray(coords, np.int32)
    # the packed 21-bit-a-field key is collision-free only in this range
    if len(c) and (c.min() < -16384 or c.max() >= 2080768):
        raise ValueError(f"grid_knn coords out of packed-key range [-16384, 2080768): "
                         f"[{c.min()}, {c.max()}]")
    m = len(c)
    idx = np.empty((m, k), np.int64)
    d2 = np.empty((m, k), np.float32)
    lib.grid_knn(_ptr(c, ctypes.c_int32), m, k, _ptr(idx, ctypes.c_int64),
                 _ptr(d2, ctypes.c_float))
    return idx, d2


# geopurify_tpu/native/__init__.py:176
def nearest_donor(coords: np.ndarray, has_value: np.ndarray) -> np.ndarray:
    """For each row of ``coords``, the index of the nearest row with
    ``has_value`` set (rows with a value return themselves). Not the
    device search ``ops/knn.nearest_fill_grid``."""
    lib = _lib_or_raise()
    c = np.ascontiguousarray(coords, np.float32)
    hv = np.ascontiguousarray(has_value, np.uint8)
    out = np.empty(len(c), np.int64)
    lib.nearest_donor(_ptr(c, ctypes.c_float), len(c), _ptr(hv, ctypes.c_uint8),
                      _ptr(out, ctypes.c_int64))
    return out
