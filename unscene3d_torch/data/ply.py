"""Minimal PLY reader and writer (the port's own copy of
unscene3d_tpu/data/ply.py; numpy only).

Supports ascii and binary_little_endian, vertex properties and triangular
face lists: enough for ScanNet `_vh_clean_2.ply` meshes and the
reference's ply export (utils/point_cloud_utils.py:9-49).
"""

from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> dict:
    """Returns dict with 'vertices' (V,3) f64, optional 'colors' (V,3) u8,
    optional 'normals', 'faces' (F,3) i64, plus 'vertex_data' (structured)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a ply file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) or ('list', idx_t, val_t, name)])
        while True:
            line = f.readline().strip().decode()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append([parts[1], int(parts[2]), []])
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append(("list", _TYPES[parts[2]], _TYPES[parts[3]], parts[4]))
                else:
                    elements[-1][2].append((parts[2], _TYPES[parts[1]]))

        out = {}
        for name, count, props in elements:
            is_list = any(p[0] == "list" for p in props)
            if not is_list:
                dt = np.dtype([(p[0], ("<" if fmt != "ascii" else "") + p[1]) for p in props])
                if fmt == "ascii":
                    rows = [f.readline().split() for _ in range(count)]
                    arr = np.array([tuple(r) for r in rows], dtype=dt)
                else:
                    arr = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
                out[name] = arr
            else:
                # assume a single homogeneous triangle list (ScanNet faces)
                _, idx_t, val_t, pname = props[0]
                if fmt == "ascii":
                    faces = np.array([f.readline().split()[1:4] for _ in range(count)], np.int64)
                else:
                    idx_size = np.dtype(idx_t).itemsize
                    val_size = np.dtype(val_t).itemsize
                    raw = f.read(count * (idx_size + 3 * val_size))
                    dt = np.dtype([("n", "<" + idx_t), ("v", "<" + val_t, (3,))])
                    faces = np.frombuffer(raw, dtype=dt)["v"].astype(np.int64)
                out[name] = faces

    result = {"vertex_data": out.get("vertex")}
    v = out.get("vertex")
    if v is not None:
        result["vertices"] = np.column_stack([v["x"], v["y"], v["z"]]).astype(np.float64)
        if "red" in v.dtype.names:
            result["colors"] = np.column_stack([v["red"], v["green"], v["blue"]])
        if "nx" in v.dtype.names:
            result["normals"] = np.column_stack([v["nx"], v["ny"], v["nz"]])
    if "face" in out:
        result["faces"] = out["face"]
    return result


def write_ply(path: str, vertices: np.ndarray, colors: np.ndarray | None = None,
              faces: np.ndarray | None = None,
              extra: dict[str, np.ndarray] | None = None):
    """`extra`: optional per-vertex scalar int32 properties (e.g. the
    reference's S3DIS preprocessed plys carry label/instance_id/segment_id)."""
    v = np.asarray(vertices, np.float32)
    extra = extra or {}
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {len(v)}",
               "property float x", "property float y", "property float z"]
        if colors is not None:
            hdr += ["property uchar red", "property uchar green", "property uchar blue"]
        for name in extra:
            hdr.append(f"property int {name}")
        if faces is not None:
            hdr += [f"element face {len(faces)}",
                    "property list uchar int vertex_indices"]
        hdr.append("end_header")
        f.write(("\n".join(hdr) + "\n").encode())
        fields = [("xyz", "<f4", (3,))]
        if colors is not None:
            fields.append(("rgb", "u1", (3,)))
        fields += [(name, "<i4") for name in extra]
        if colors is not None or extra:
            dt = np.dtype(fields)
            arr = np.empty(len(v), dt)
            arr["xyz"] = v
            if colors is not None:
                arr["rgb"] = np.asarray(colors, np.uint8)
            for name, vals in extra.items():
                arr[name] = np.asarray(vals, np.int32)
            f.write(arr.tobytes())
        else:
            f.write(v.astype("<f4").tobytes())
        if faces is not None:
            fa = np.asarray(faces, np.int32)
            dt = np.dtype([("n", "u1"), ("v", "<i4", (3,))])
            arr = np.empty(len(fa), dt)
            arr["n"] = 3
            arr["v"] = fa
            f.write(arr.tobytes())
