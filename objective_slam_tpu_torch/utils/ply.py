"""PLY point-cloud I/O with normals and triangle faces (numpy only).

A copy of ``objective_slam_tpu.utils.ply`` (ply.py:14-193): ``PlyCloud``,
``read_ply`` (ascii and binary_little_endian; x/y/z, nx/ny/nz, other
vertex properties kept in ``extra``, triangle faces), ``write_ply`` and
``read_stl`` (:196-233). The port cannot import the JAX package's module
(importing any of it imports jax).
"""

from __future__ import annotations

import io
import struct
from typing import NamedTuple

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


class PlyCloud(NamedTuple):
    points: np.ndarray               # (n, 3) float32
    normals: np.ndarray | None       # (n, 3) float32 or None
    extra: dict[str, np.ndarray]     # other per-vertex properties
    faces: np.ndarray | None         # (f, 3) int32 triangle indices or None


def read_ply(path) -> PlyCloud:
    """Read a PLY file (ascii or binary_little_endian)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header_end = data.index(b"\n", header_end) + 1
    header = data[:header_end].decode("ascii", errors="replace")
    body = data[header_end:]

    fmt = None
    elements: list[tuple[str, int, list[tuple[str, str]]]] = []
    cur_props: list[tuple[str, str]] = []
    for line in header.splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur_props = []
            elements.append((parts[1], int(parts[2]), cur_props))
        elif parts[0] == "property":
            if parts[1] == "list":
                cur_props.append((parts[-1], f"list:{parts[2]}:{parts[3]}"))
            else:
                cur_props.append((parts[-1], _DTYPES[parts[1]]))
    if fmt is None:
        raise ValueError(f"{path}: missing format line")
    if fmt == "binary_big_endian":
        raise ValueError(f"{path}: big-endian PLY not supported")

    parsed: dict[str, dict[str, np.ndarray]] = {}
    if fmt == "ascii":
        text = io.StringIO(body.decode("ascii", errors="replace"))
        for name, count, props in elements:
            has_list = any(t.startswith("list:") for _, t in props)
            cols: dict[str, list] = {p: [] for p, _ in props}
            for _ in range(count):
                tokens = text.readline().split()
                ti = 0
                for pname, ptype in props:
                    if ptype.startswith("list:"):
                        k = int(tokens[ti]); ti += 1
                        cols[pname].append([float(x) for x in
                                            tokens[ti:ti + k]])
                        ti += k
                    else:
                        cols[pname].append(float(tokens[ti])); ti += 1
            parsed[name] = {
                p: (np.asarray(v) if not t.startswith("list:")
                    else np.asarray(v, dtype=object)
                    if any(len(x) != len(v[0]) for x in v)
                    else np.asarray(v))
                for (p, t), v in zip(props, cols.values())}
    else:  # binary_little_endian
        offset = 0
        for name, count, props in elements:
            if any(t.startswith("list:") for _, t in props):
                # list properties (faces): parse row by row
                rows = []
                for _ in range(count):
                    row = {}
                    for pname, ptype in props:
                        if ptype.startswith("list:"):
                            _, ctype, vtype = ptype.split(":")
                            cdt = np.dtype("<" + _DTYPES[ctype])
                            vdt = np.dtype("<" + _DTYPES[vtype])
                            k = int(np.frombuffer(body, cdt, 1, offset)[0])
                            offset += cdt.itemsize
                            row[pname] = np.frombuffer(body, vdt, k, offset)
                            offset += vdt.itemsize * k
                        else:
                            dt = np.dtype("<" + ptype)
                            row[pname] = np.frombuffer(body, dt, 1, offset)[0]
                            offset += dt.itemsize
                    rows.append(row)
                parsed[name] = {
                    p: np.asarray([r[p] for r in rows])
                    for p, _ in props}
            else:
                dt = np.dtype([(p, "<" + t) for p, t in props])
                arr = np.frombuffer(body, dt, count, offset)
                offset += dt.itemsize * count
                parsed[name] = {p: arr[p] for p, _ in props}

    if "vertex" not in parsed:
        raise ValueError(f"{path}: no vertex element")
    vert = parsed["vertex"]
    pts = np.stack([vert["x"], vert["y"], vert["z"]], axis=-1).astype(
        np.float32)
    normals = None
    if all(k in vert for k in ("nx", "ny", "nz")):
        normals = np.stack([vert["nx"], vert["ny"], vert["nz"]],
                           axis=-1).astype(np.float32)
    extra = {k: np.asarray(v) for k, v in vert.items()
             if k not in ("x", "y", "z", "nx", "ny", "nz")}
    faces = None
    face_el = parsed.get("face")
    if face_el:
        key = next(iter(face_el))
        fl = face_el[key]
        if fl.dtype != object and fl.ndim == 2 and fl.shape[1] == 3:
            faces = fl.astype(np.int32)
        else:
            tri = [f for f in fl if len(f) == 3]
            faces = (np.asarray(tri, np.int32) if tri else None)
    return PlyCloud(points=pts, normals=normals, extra=extra, faces=faces)


def write_ply(path, points, normals=None, binary: bool = True,
              faces=None) -> None:
    """Write a point cloud (+ optional normals / triangle faces) as PLY.

    Equivalent of matlab/write_ply_cloud.m (stride-downsampling is the
    caller's job) and the MATLAB compute_normals.m output format."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    props = ["property float x", "property float y", "property float z"]
    cols = [points]
    if normals is not None:
        normals = np.asarray(normals, np.float32)
        props += ["property float nx", "property float ny",
                  "property float nz"]
        cols.append(normals)
    header = ["ply",
              "format binary_little_endian 1.0" if binary else
              "format ascii 1.0",
              f"element vertex {n}", *props]
    if faces is not None:
        faces = np.asarray(faces, np.int32)
        header += [f"element face {faces.shape[0]}",
                   "property list uchar int vertex_indices"]
    header += ["end_header"]
    body = np.concatenate(cols, axis=-1)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            f.write(body.astype("<f4").tobytes())
            if faces is not None:
                rec = np.empty(faces.shape[0],
                               dtype=[("k", "u1"), ("v", "<i4", (3,))])
                rec["k"] = 3
                rec["v"] = faces
                f.write(rec.tobytes())
        else:
            for row in body:
                f.write((" ".join(f"{v:.9g}" for v in row) + "\n")
                        .encode("ascii"))
            if faces is not None:
                for face in faces:
                    f.write((f"3 {face[0]} {face[1]} {face[2]}\n")
                            .encode("ascii"))


def read_stl(path, weld_decimals: int = 5):
    """Binary STL triangle-soup reader with vertex welding.

    STL repeats every vertex once per incident triangle, without
    connectivity; the soup is welded into an indexed mesh by exact match
    on coordinates rounded to `weld_decimals`, the form that
    ``pointcloud.mesh_vertex_normals`` and ``synthetic.partial_view``
    take. Triangles that the welding collapsed are dropped.

    Returns (vertices (n, 3) float32, faces (m, 3) int32)."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 84:
        raise ValueError(f"{path}: not a binary STL (too short)")
    n_tri = struct.unpack("<I", raw[80:84])[0]
    if len(raw) != 84 + 50 * n_tri:
        raise ValueError(f"{path}: size mismatch — ascii STL or corrupt "
                         f"({len(raw)} bytes, {n_tri} triangles declared)")
    rec = np.frombuffer(raw, dtype=[("nrm", "<f4", (3,)),
                                    ("v", "<f4", (3, 3)),
                                    ("attr", "<u2")], count=n_tri, offset=84)
    soup = np.ascontiguousarray(rec["v"].reshape(-1, 3))        # (3m, 3)
    key = np.round(soup.astype(np.float64), weld_decimals)
    _, first, inv = np.unique(key.view([("x", "f8"), ("y", "f8"),
                                        ("z", "f8")]).reshape(-1),
                              return_index=True, return_inverse=True)
    verts = soup[first]
    faces = inv.reshape(-1, 3).astype(np.int32)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts.astype(np.float32), faces[ok]
