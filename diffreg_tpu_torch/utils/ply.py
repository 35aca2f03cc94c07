"""Minimal PLY point-cloud IO (the reference's lib/ply.py).

Counterpart of the JAX package's utils/ply.py, byte for byte the same files:
binary-little-endian and ascii PLY with float/double/int vertex properties,
enough for debug dumps and dataset interop. Each package reads the other's
files.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

_TYPES = {
    "float": ("f4", "f"), "float32": ("f4", "f"),
    "double": ("f8", "d"), "float64": ("f8", "d"),
    "int": ("i4", "i"), "int32": ("i4", "i"),
    "uint": ("u4", "I"), "uint32": ("u4", "I"),
    "short": ("i2", "h"), "ushort": ("u2", "H"),
    "char": ("i1", "b"), "uchar": ("u1", "B"), "uint8": ("u1", "B"),
}


def write_ply(path: str, arrays: List[np.ndarray], names: List[str],
              binary: bool = True) -> None:
    """Write columns (each [N] or [N, k]) with per-column names."""
    cols = []
    for a in arrays:
        a = np.asarray(a)
        cols.extend(a.T if a.ndim == 2 else [a])
    assert len(cols) == len(names)
    n = len(cols[0])

    fmt = "binary_little_endian" if binary else "ascii"
    header = [f"ply", f"format {fmt} 1.0", f"element vertex {n}"]
    np_types = []
    for c, name in zip(cols, names):
        t = "float" if c.dtype.kind == "f" else ("int" if c.dtype.kind == "i" else "uchar")
        if c.dtype == np.float64:
            t = "double"
        header.append(f"property {t} {name}")
        np_types.append(_TYPES[t][0])
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        rec = np.rec.fromarrays(
            [c.astype(t) for c, t in zip(cols, np_types)],
            names=",".join(names))
        if binary:
            f.write(rec.tobytes())
        else:
            for row in rec:
                f.write((" ".join(str(v) for v in row) + "\n").encode())


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read vertex properties into a dict of 1-D arrays."""
    with open(path, "rb") as f:
        line = f.readline().decode().strip()
        assert line == "ply", "not a PLY file"
        binary = False
        n = 0
        props: List[Tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().decode().strip()
            if line.startswith("format"):
                binary = "binary" in line
                assert "big" not in line, "big-endian PLY unsupported"
            elif line.startswith("element"):
                parts = line.split()
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n = int(parts[2])
            elif line.startswith("property") and in_vertex:
                _, t, name = line.split()
                props.append((name, _TYPES[t][0]))
            elif line == "end_header":
                break

        dtype = np.dtype([(name, t) for name, t in props])
        if binary:
            data = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype, count=n)
        else:
            rows = [f.readline().decode().split() for _ in range(n)]
            data = np.array([tuple(r) for r in rows], dtype=dtype)
        return {name: np.asarray(data[name]) for name, _ in props}
