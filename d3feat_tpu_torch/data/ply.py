"""Self-contained PLY point-cloud I/O (no open3d dependency); port of
``d3feat_tpu.data.ply``, copied as it is.

Capability counterpart of the reference reader/writer
(reference: utils/ply.py:114-352): binary little/big-endian and ASCII
reading of vertex properties, binary-little-endian writing of named
per-point fields. The reference additionally depends on open3d for test
fragments (reference: datasets/ThreeDMatch.py:190-191); here fragment
loading uses this module + our own voxel subsampling instead.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_INV_TYPES = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
              "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a PLY file; returns {property_name: 1-D array} for the vertex
    element. List properties (e.g. face indices) are skipped for binary files
    only if they follow all vertices (the common layout)."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        elements: List[dict] = []
        current = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tokens = line.strip().split()
            if not tokens:
                continue
            key = tokens[0]
            if key == b"format":
                fmt = tokens[1].decode()
            elif key == b"element":
                current = {"name": tokens[1].decode(), "count": int(tokens[2]), "props": []}
                elements.append(current)
            elif key == b"property":
                if current is None:
                    raise ValueError("property before element in PLY header")
                if tokens[1] == b"list":
                    current["props"].append(("list", tokens[2].decode(), tokens[3].decode(),
                                             tokens[4].decode()))
                else:
                    current["props"].append((tokens[1].decode(), tokens[2].decode()))
            elif key == b"end_header":
                break

        vertex = next((e for e in elements if e["name"] == "vertex"), None)
        if vertex is None:
            raise ValueError("no vertex element in PLY")
        if any(p[0] == "list" for p in vertex["props"]):
            raise ValueError("list properties on vertex element are unsupported")

        if fmt == "ascii":
            names = [p[1] for p in vertex["props"]]
            rows = []
            for _ in range(vertex["count"]):
                rows.append([float(v) for v in f.readline().split()[: len(names)]])
            arr = np.asarray(rows)
            return {n: arr[:, i] for i, n in enumerate(names)}

        endian = "<" if fmt == "binary_little_endian" else ">"
        # elements are stored in header order; read/skip until vertex
        out: Dict[str, np.ndarray] = {}
        for e in elements:
            if any(p[0] == "list" for p in e["props"]):
                if e is vertex:
                    raise ValueError("list properties on vertex element")
                break  # variable-size element: stop (vertex already read if earlier)
            dtype = np.dtype([(p[1], endian + _PLY_TYPES[p[0]]) for p in e["props"]])
            data = np.fromfile(f, dtype=dtype, count=e["count"])
            if e is vertex:
                out = {name: np.ascontiguousarray(data[name]) for name in data.dtype.names}
                break
        return out


def read_ply_points(path: str) -> np.ndarray:
    """Convenience: [N, 3] float array of x/y/z."""
    d = read_ply(path)
    return np.stack([d["x"], d["y"], d["z"]], axis=1).astype(np.float64)


def write_ply(path: str, fields: Sequence[np.ndarray], names: Sequence[str]) -> None:
    """Write per-point fields as binary-little-endian PLY.

    ``fields`` is a list of [N] or [N, k] arrays whose columns consume the
    ``names`` in order (e.g. a [N,3] array uses 'x','y','z').
    """
    cols: List[np.ndarray] = []
    for fld in fields:
        fld = np.asarray(fld)
        if fld.ndim == 1:
            cols.append(fld)
        else:
            cols.extend(fld[:, i] for i in range(fld.shape[1]))
    if len(cols) != len(names):
        raise ValueError(f"{len(cols)} columns but {len(names)} names")
    n = len(cols[0])
    if any(len(c) != n for c in cols):
        raise ValueError("field length mismatch")

    dtype = np.dtype([(nm, "<" + c.dtype.str[1:].replace("i8", "i4"))
                      for nm, c in zip(names, cols)])
    rec = np.empty(n, dtype=dtype)
    for nm, c in zip(names, cols):
        rec[nm] = c.astype(rec.dtype[nm])

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    for nm in names:
        header.append(f"property {_INV_TYPES[rec.dtype[nm].str[1:]]} {nm}")
    header.append("end_header\n")
    with open(path, "wb") as f:
        f.write("\n".join(header).encode())
        rec.tofile(f)
