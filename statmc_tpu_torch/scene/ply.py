# Copied from statmc_tpu/scene/ply.py (numpy host code; imports rewritten, behaviour unchanged).
"""Minimal PLY mesh reader (ascii + binary_little_endian).

Replaces the reference's rply dependency (src/ext/rply used by
src/shapes/plymesh.cpp... triangle.cpp:CreatePLYMesh).  Supports the
vertex properties pbrt scenes use (x y z [nx ny nz] [u v / s t]) and
triangle/quad faces (quads are split).
"""
from __future__ import annotations

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str):
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype)| ('list', idx_dtype, cnt_dtype, name)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            parts = line.decode("ascii", "replace").split()
            if not parts:
                continue
            if parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append(
                        ("list", _DTYPES[parts[2]], _DTYPES[parts[3]], parts[4])
                    )
                else:
                    elements[-1][2].append((parts[2], _DTYPES[parts[1]]))
            elif parts[0] == "end_header":
                break
        if fmt == "ascii":
            return _read_ascii(f, elements)
        if fmt == "binary_little_endian":
            return _read_binary(f, elements, "<")
        if fmt == "binary_big_endian":
            return _read_binary(f, elements, ">")
        raise ValueError(f"{path}: unsupported PLY format {fmt}")


def _assemble(vdata, vprops, faces):
    names = [p[0] for p in vprops]

    def col(*cands):
        for c in cands:
            if c in names:
                return vdata[:, names.index(c)]
        return None

    P = np.stack([col("x"), col("y"), col("z")], axis=-1).astype(np.float32)
    N = None
    if "nx" in names:
        N = np.stack([col("nx"), col("ny"), col("nz")], axis=-1).astype(np.float32)
    UV = None
    u = col("u", "s", "texture_u")
    v = col("v", "t", "texture_v")
    if u is not None and v is not None:
        UV = np.stack([u, v], axis=-1).astype(np.float32)
    tris = []
    for fc in faces:
        for k in range(1, len(fc) - 1):
            tris.append((fc[0], fc[k], fc[k + 1]))
    idx = np.asarray(tris, np.int32) if tris else np.zeros((0, 3), np.int32)
    return P, N, UV, idx


def _read_ascii(f, elements):
    vdata, vprops, faces = None, None, []
    for name, count, props in elements:
        if name == "vertex":
            vprops = props
            rows = []
            for _ in range(count):
                rows.append([float(x) for x in f.readline().split()])
            vdata = np.asarray(rows, np.float64)
        elif name == "face":
            for _ in range(count):
                vals = [int(x) for x in f.readline().split()]
                faces.append(vals[1 : 1 + vals[0]])
        else:
            for _ in range(count):
                f.readline()
    return _assemble(vdata, vprops, faces)


def _read_binary(f, elements, endian):
    vdata, vprops, faces = None, None, []
    for name, count, props in elements:
        if name == "vertex" and all(p[0] != "list" for p in props):
            vprops = props
            dt = np.dtype([(p[0], endian + p[1]) for p in props])
            raw = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
            vdata = np.stack(
                [raw[p[0]].astype(np.float64) for p in props], axis=-1
            )
        else:
            # Element with list properties (faces) or unknown: read per-row.
            is_face = name == "face"
            for _ in range(count):
                for p in props:
                    if p[0] == "list":
                        cnt_dt = np.dtype(endian + p[1])
                        n = int(
                            np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0]
                        )
                        idx_dt = np.dtype(endian + p[2])
                        vals = np.frombuffer(
                            f.read(idx_dt.itemsize * n), idx_dt
                        )
                        if is_face and p[3] in ("vertex_indices", "vertex_index"):
                            faces.append(vals.astype(np.int64).tolist())
                    else:
                        dt = np.dtype(endian + p[1])
                        f.read(dt.itemsize)
    return _assemble(vdata, vprops, faces)
