"""PLY mesh reader (counterpart of pbrt_tpu/scene/plyio.py; pbrt-v4
TriQuadMesh::ReadPLY), numpy only.

ascii and binary little or big endian; vertex properties x, y, z, then
nx, ny, nz and u, v (or s, t) where present; face vertex_indices lists
fanned into triangles (a quad into two). A binary face list whose faces
all have the same count is read as one array; other lists face by face.
"""
from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _parse_header(data):
    """(format, [(element, count, properties)], the body's bytes); a
    property is (type, name) or ("list", count type, index type, name)."""
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii", "replace").splitlines()
    if header[0].strip() != "ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []
    for line in header[1:]:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[1], parts[2]))
    return fmt, elements, data[end:]


def read_ply(path):
    """dict(vertices (V, 3) float32, indices (F, 3) int64, normals (V, 3)
    float32 or None, uvs (V, 2) float32 or None)."""
    with open(path, "rb") as f:
        fmt, elements, body = _parse_header(f.read())
    verts = normals = uvs = None
    faces = []
    if fmt == "ascii":
        tokens = body.split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                ncol = len(props)
                arr = np.array(tokens[pos:pos + count * ncol],
                               np.float64).reshape(count, ncol)
                pos += count * ncol
                verts, normals, uvs = _extract_vertex(
                    arr, {p[1]: i for i, p in enumerate(props)})
            elif name == "face":
                for _ in range(count):
                    n = int(tokens[pos])
                    _add_face(faces, [int(tokens[pos + 1 + i])
                                      for i in range(n)])
                    pos += 1 + n
            else:
                pos += count * len(props)   # fixed-size properties assumed
    else:
        endian = "<" if "little" in fmt else ">"
        off = 0
        for name, count, props in elements:
            if name == "vertex" and all(p[0] != "list" for p in props):
                dt = np.dtype([(p[1], endian + _TYPES[p[0]]) for p in props])
                arr_s = np.frombuffer(body, dt, count, off)
                off += dt.itemsize * count
                arr = np.stack([arr_s[p[1]].astype(np.float64)
                                for p in props], 1)
                verts, normals, uvs = _extract_vertex(
                    arr, {p[1]: i for i, p in enumerate(props)})
            elif name == "face":
                off = _read_binary_faces(body, off, count, props[0], endian,
                                         faces)
            elif all(p[0] != "list" for p in props):
                off += np.dtype([(f"c{i}", endian + _TYPES[p[0]])
                                 for i, p in enumerate(props)]).itemsize \
                    * count
            else:
                raise ValueError(f"unsupported PLY element {name}")
    return dict(vertices=np.asarray(verts, np.float32),
                indices=np.asarray(faces, np.int64).reshape(-1, 3),
                normals=None if normals is None else
                np.asarray(normals, np.float32),
                uvs=None if uvs is None else np.asarray(uvs, np.float32))


def _read_binary_faces(body, off, count, prop, endian, faces):
    """Append the fanned triangles of count binary faces at off to faces;
    returns the offset past them."""
    _list, ct, it, _name = prop
    cdt = np.dtype(endian + _TYPES[ct])
    idt = np.dtype(endian + _TYPES[it])
    if count:
        n = int(np.frombuffer(body, cdt, 1, off)[0])
        row = np.dtype([("n", cdt), ("i", idt, (n,))])
        if n >= 3 and len(body) >= off + row.itemsize * count:
            rows = np.frombuffer(body, row, count, off)
            if (rows["n"] == n).all():
                idx = rows["i"].astype(np.int64)
                # each face's fan in turn, as _add_face
                fan = np.stack([idx[:, [0, k, k + 1]]
                                for k in range(1, n - 1)], 1)
                faces.extend(fan.reshape(-1, 3).tolist())
                return off + row.itemsize * count
    for _ in range(count):
        n = int(np.frombuffer(body, cdt, 1, off)[0])
        off += cdt.itemsize
        _add_face(faces, np.frombuffer(body, idt, n, off).tolist())
        off += idt.itemsize * n
    return off


def _extract_vertex(arr, cols):
    verts = np.stack([arr[:, cols["x"]], arr[:, cols["y"]],
                      arr[:, cols["z"]]], 1)
    normals = uvs = None
    if "nx" in cols:
        normals = np.stack([arr[:, cols["nx"]], arr[:, cols["ny"]],
                            arr[:, cols["nz"]]], 1)
    for ux, vx in (("u", "v"), ("s", "t")):
        if ux in cols and vx in cols:
            uvs = np.stack([arr[:, cols[ux]], arr[:, cols[vx]]], 1)
            break
    return verts, normals, uvs


def _add_face(faces, idx):
    for k in range(1, len(idx) - 1):
        faces.append([idx[0], idx[k], idx[k + 1]])
