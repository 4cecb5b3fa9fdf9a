"""PLY mesh / point-cloud IO and normal estimation (numpy).

Port of geopurify_tpu/data/ply.py, whole: binary and ascii PLY parsing,
face-area-weighted vertex normals and the binary point-cloud writer, with
no third-party PLY dependency. The port keeps its own copy so that it
imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


# geopurify_tpu/data/ply.py:30
@dataclass
class PlyElement:
    name: str
    count: int
    # scalar properties: list of (name, dtype-char)
    properties: List[Tuple[str, str]] = field(default_factory=list)
    # list properties: (name, count-dtype, item-dtype)
    list_properties: List[Tuple[str, str, str]] = field(default_factory=list)
    data: Optional[Dict[str, np.ndarray]] = None


# geopurify_tpu/data/ply.py:40
def _parse_header(f) -> Tuple[List[PlyElement], str]:
    line = f.readline().strip()
    if line != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements: List[PlyElement] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens or tokens[0] == "comment":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            elements.append(PlyElement(tokens[1], int(tokens[2])))
        elif tokens[0] == "property":
            if tokens[1] == "list":
                elements[-1].list_properties.append(
                    (tokens[4], _PLY_DTYPES[tokens[2]], _PLY_DTYPES[tokens[3]])
                )
                elements[-1].properties.append((tokens[4], "list"))
            else:
                elements[-1].properties.append((tokens[-1], _PLY_DTYPES[tokens[1]]))
        elif tokens[0] == "end_header":
            break
    if fmt is None:
        raise ValueError("PLY header missing format line")
    return elements, fmt


# geopurify_tpu/data/ply.py:72
def read_ply(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Parse a PLY file. Returns {element_name: {property: array}}.

    List properties with a uniform length (e.g. triangle vertex_indices) come
    back as [count, k] arrays.
    """
    with open(path, "rb") as f:
        elements, fmt = _parse_header(f)
        endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for el in elements:
            if fmt == "ascii":
                out[el.name] = _read_ascii_element(f, el)
            else:
                out[el.name] = _read_binary_element(f, el, endian)
    return out


# geopurify_tpu/data/ply.py:90
def _read_binary_element(f, el: PlyElement, endian: str) -> Dict[str, np.ndarray]:
    if not el.list_properties:
        dt = np.dtype([(n, endian + d) for n, d in el.properties])
        raw = np.frombuffer(f.read(dt.itemsize * el.count), dtype=dt)
        return {n: np.ascontiguousarray(raw[n]) for n, _ in el.properties}
    # rows with one uniform-length list, optionally mixed with scalars on
    # either side (e.g. Matterport region faces: vertex_indices + material_id
    # + segment_id + category_id)
    if len(el.list_properties) == 1:
        name, cnt_d, item_d = el.list_properties[0]
        cnt_dt = np.dtype(endian + cnt_d)
        pre, post, seen = [], [], False
        for n, d in el.properties:
            if d == "list":
                seen = True
                continue
            (post if seen else pre).append((n, d))
        pre_size = sum(np.dtype(endian + d).itemsize for _, d in pre)
        head = f.read(pre_size + cnt_dt.itemsize)
        k = int(np.frombuffer(head[pre_size:], cnt_dt)[0])
        row_dt = np.dtype(
            [(n, endian + d) for n, d in pre]
            + [("__count", endian + cnt_d), (name, endian + item_d, (k,))]
            + [(n, endian + d) for n, d in post]
        )
        rest = f.read(row_dt.itemsize * el.count - len(head))
        raw = np.frombuffer(head + rest, dtype=row_dt)
        if not np.all(raw["__count"] == k):
            raise ValueError("variable-length PLY lists unsupported in fast path")
        out = {n: np.ascontiguousarray(raw[n]) for n, _ in pre + post}
        out[name] = np.ascontiguousarray(raw[name])
        return out
    raise ValueError("multi-list PLY elements unsupported")


# geopurify_tpu/data/ply.py:125
def _read_ascii_element(f, el: PlyElement) -> Dict[str, np.ndarray]:
    rows = [f.readline().split() for _ in range(el.count)]
    out: Dict[str, np.ndarray] = {}
    if not el.list_properties:
        arr = np.array(rows, dtype=np.float64)
        for i, (n, d) in enumerate(el.properties):
            out[n] = arr[:, i].astype(np.dtype(d))
        return out
    name = el.list_properties[0][0]
    item_d = el.list_properties[0][2]
    out[name] = np.array([r[1:] for r in rows], dtype=np.dtype(item_d))
    return out


# geopurify_tpu/data/ply.py:139
def write_ply_points(
    path: str,
    xyz: np.ndarray,
    rgb: Optional[np.ndarray] = None,        # uint8 or 0..1 float
    normals: Optional[np.ndarray] = None,
) -> None:
    """Binary little-endian point-cloud writer (storePly equivalent)."""
    n = len(xyz)
    props = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    if normals is not None:
        props += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
    if rgb is not None:
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    dt = np.dtype([(p, "<" + d) for p, d in props])
    rec = np.empty(n, dtype=dt)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    if normals is not None:
        rec["nx"], rec["ny"], rec["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    if rgb is not None:
        c = rgb if rgb.dtype == np.uint8 else np.clip(rgb * 255, 0, 255).astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = c[:, 0], c[:, 1], c[:, 2]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    type_names = {"f4": "float", "u1": "uchar"}
    header += [f"property {type_names[d]} {p}" for p, d in props]
    header.append("end_header\n")
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())


# geopurify_tpu/data/ply.py:169
def face_normals(xyz: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Unnormalized face normals — magnitude = 2x triangle area, so summing
    them per vertex gives the area weighting for free
    (reference models/utils/dataset_utils.py vertex_normal/face_normal)."""
    a = xyz[faces[:, 1]] - xyz[faces[:, 0]]
    b = xyz[faces[:, 2]] - xyz[faces[:, 0]]
    return np.cross(a, b)


# geopurify_tpu/data/ply.py:178
def vertex_normals(xyz: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Face-area-weighted vertex normals, L2-normalized."""
    fn = face_normals(xyz, faces)
    vn = np.zeros_like(xyz, dtype=np.float64)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return (vn / np.maximum(norm, 1e-12)).astype(np.float32)


# geopurify_tpu/data/ply.py:188
def load_point_ply(path: str) -> Dict[str, np.ndarray]:
    """Load a labeled mesh/point PLY: xyz, rgb (0..1), label (if present),
    normals (stored, or face-area-weighted if faces exist, else zeros).

    Mirrors the reference's load_point_ply (dataset_utils.py:173-201) used for
    ScanNet ``points3d.labels.ply`` normal extraction.
    """
    data = read_ply(path)
    v = data["vertex"]
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    out: Dict[str, np.ndarray] = {"xyz": xyz}
    if "red" in v:
        rgb = np.stack([v["red"], v["green"], v["blue"]], axis=1)
        out["rgb"] = (rgb.astype(np.float32) / 255.0) if rgb.dtype == np.uint8 else rgb
    if "label" in v:
        out["label"] = v["label"].astype(np.int32)
    if "nx" in v:
        n = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float32)
        out["normal"] = n
    elif "face" in data:
        faces = next(iter(data["face"].values())).astype(np.int64)
        out["normal"] = vertex_normals(xyz, faces)
    else:
        out["normal"] = np.zeros_like(xyz)
    return out
