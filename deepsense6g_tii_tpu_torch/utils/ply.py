"""Minimal PLY point-cloud IO (own copy of ``deepsense6g_tii_tpu/utils/ply.py``).

A dependency-free reader/writer for the vertex element of ascii and binary
PLY files (the original pipeline used Open3D's IO) — the only capability
the data path needs.
"""

from __future__ import annotations

import io
from typing import Dict, Tuple

import numpy as np

_PLY_DTYPES: Dict[str, str] = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _parse_header(f) -> Tuple[str, int, list, int]:
    """Returns (fmt, n_vertices, vertex_properties, header_len_bytes)."""
    magic = f.readline()
    if magic.strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    n_vertices = 0
    properties = []
    in_vertex_element = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tokens = line.decode("ascii", errors="replace").strip().split()
        if not tokens:
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            in_vertex_element = tokens[1] == "vertex"
            if in_vertex_element:
                n_vertices = int(tokens[2])
        elif tokens[0] == "property" and in_vertex_element:
            if tokens[1] == "list":
                raise ValueError("list properties in vertex element unsupported")
            properties.append((tokens[2], _PLY_DTYPES[tokens[1]]))
        elif tokens[0] == "end_header":
            break
    return fmt, n_vertices, properties, f.tell()


def read_points(path) -> np.ndarray:
    """Reads the (N, 3) float64 xyz vertex array from a .ply file."""
    with open(path, "rb") as f:
        fmt, n, props, offset = _parse_header(f)
        names = [p[0] for p in props]
        if fmt == "ascii":
            if n == 0:
                return np.zeros((0, 3), dtype=np.float64)
            text = f.read().decode("ascii")
            data = np.loadtxt(io.StringIO(text), dtype=np.float64, ndmin=2)
            data = data[:n]
            cols = [names.index(c) for c in ("x", "y", "z")]
            return data[:, cols]
        elif fmt == "binary_little_endian":
            dtype = np.dtype([(name, "<" + d) for name, d in props])
            raw = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
            return np.stack(
                [raw["x"].astype(np.float64),
                 raw["y"].astype(np.float64),
                 raw["z"].astype(np.float64)], axis=1)
        elif fmt == "binary_big_endian":
            dtype = np.dtype([(name, ">" + d) for name, d in props])
            raw = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
            return np.stack(
                [raw["x"].astype(np.float64),
                 raw["y"].astype(np.float64),
                 raw["z"].astype(np.float64)], axis=1)
        raise ValueError(f"unsupported PLY format {fmt!r}")


def write_points(path, points: np.ndarray, ascii: bool = True) -> None:
    """Writes an (N, 3) xyz array as a PLY vertex cloud.

    ``ascii=True`` matches Open3D's ``write_ascii=True`` output.
    """
    points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    n = points.shape[0]
    fmt = "ascii" if ascii else "binary_little_endian"
    header = (
        "ply\n"
        f"format {fmt} 1.0\n"
        f"element vertex {n}\n"
        "property double x\n"
        "property double y\n"
        "property double z\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if ascii:
            for row in points:
                f.write(f"{row[0]:.10g} {row[1]:.10g} {row[2]:.10g}\n".encode("ascii"))
        else:
            f.write(points.astype("<f8").tobytes())
