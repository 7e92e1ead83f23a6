"""Mesh import: binary/ASCII FBX and OBJ in numpy (counterpart of the
reference ``scene/meshio.py``, array for array).

Binary FBX 7.x node records are read directly (zlib-compressed array
properties, 64-bit record offsets from version 7500 on); the first mesh's
positions and polygon indices are fan-triangulated, with its UV and normal
layers when present. ASCII FBX yields positions only. OBJ faces carry
``vt``/``vn`` indices (negative indices count from the end).
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np

_FBX_MAGIC = b"Kaydara FBX Binary  \x00\x1a\x00"


def _read_fbx_props(data, pos, count):
    props = []
    for _ in range(count):
        t = data[pos : pos + 1]
        pos += 1
        if t == b"Y":
            (v,) = struct.unpack_from("<h", data, pos)
            pos += 2
        elif t == b"C":
            v = bool(data[pos])
            pos += 1
        elif t == b"I":
            (v,) = struct.unpack_from("<i", data, pos)
            pos += 4
        elif t == b"F":
            (v,) = struct.unpack_from("<f", data, pos)
            pos += 4
        elif t == b"D":
            (v,) = struct.unpack_from("<d", data, pos)
            pos += 8
        elif t == b"L":
            (v,) = struct.unpack_from("<q", data, pos)
            pos += 8
        elif t in (b"f", b"d", b"l", b"i", b"b"):
            n, enc, clen = struct.unpack_from("<III", data, pos)
            pos += 12
            raw = data[pos : pos + clen]
            pos += clen
            if enc == 1:
                raw = zlib.decompress(raw)
            dt = {b"f": "<f4", b"d": "<f8", b"l": "<i8", b"i": "<i4", b"b": "i1"}[t]
            v = np.frombuffer(raw, dtype=dt, count=n)
        elif t in (b"S", b"R"):
            (n,) = struct.unpack_from("<I", data, pos)
            pos += 4
            v = data[pos : pos + n]
            pos += n
            if t == b"S":
                v = v.decode("utf-8", "replace")
        else:
            raise ValueError(f"unknown FBX property type {t!r}")
        props.append(v)
    return props, pos


def _parse_fbx_nodes(data, pos, end, version):
    """Parse sibling node records until the NULL sentinel; returns a list of
    (name, props, children)."""
    word = 8 if version >= 7500 else 4
    fmt = "<QQQ" if version >= 7500 else "<III"
    sentinel = 13 + 12 if version >= 7500 else 13
    nodes = []
    while pos < end:
        end_off, n_props, _plen = struct.unpack_from(fmt, data, pos)
        name_len = data[pos + 3 * word]
        hdr = 3 * word + 1
        if end_off == 0:
            pos += hdr + 0  # NULL record
            # NULL record is hdr bytes of zeros + name byte; its size equals
            # the header size (13 or 25); advance past it and stop
            pos += sentinel - hdr - 1 if sentinel > hdr + 1 else 0
            break
        name = data[pos + hdr : pos + hdr + name_len].decode("ascii", "replace")
        p = pos + hdr + name_len
        props, p = _read_fbx_props(data, p, n_props)
        children = []
        if p < end_off:
            children = _parse_fbx_nodes(data, p, end_off, version)
        nodes.append((name, props, children))
        pos = end_off
    return nodes


def _find_nodes(nodes, name):
    return [n for n in nodes if n[0] == name]


def _fbx_attr_layer(gchildren, idx, layer_name, elem_name, idx_name, dim):
    """Per-polygon-vertex attribute from a LayerElement node, or None.

    Handles the mapping/reference mode matrix the FBX SDK resolves for the
    reference (core-mesh-parser.cpp checkNormal/checkUV): {ByControlPoint,
    ByPolygonVertex} × {Direct, IndexToDirect}.
    """
    for name, _, lchildren in gchildren:
        if name != layer_name:
            continue
        arr = mapping = ref = aidx = None
        for cname, cprops, _ in lchildren:
            if cname == elem_name and cprops:
                arr = np.asarray(cprops[0], np.float64).reshape(-1, dim)
            elif cname == idx_name and cprops:
                aidx = np.asarray(cprops[0], np.int64)
            elif cname == "MappingInformationType" and cprops:
                mapping = cprops[0]
            elif cname == "ReferenceInformationType" and cprops:
                ref = cprops[0]
        if arr is None:
            continue
        ctrl = np.where(idx < 0, ~idx, idx)  # control-point id per pv
        if mapping == "ByControlPoint":
            per_pv = arr[aidx[ctrl]] if (ref == "IndexToDirect" and aidx is not None) else arr[ctrl]
        else:  # ByPolygonVertex (default)
            pv = np.arange(idx.shape[0])
            per_pv = arr[aidx[pv]] if (ref == "IndexToDirect" and aidx is not None) else arr[pv]
        return per_pv.astype(np.float32)
    return None


def _fbx_uv_layer(gchildren, idx):
    return _fbx_attr_layer(
        gchildren, idx, "LayerElementUV", "UV", "UVIndex", 2
    )


def _fbx_normal_layer(gchildren, idx):
    return _fbx_attr_layer(
        gchildren, idx, "LayerElementNormal", "Normals", "NormalsIndex", 3
    )


def load_fbx_full(path: str):
    """First mesh → ((T,3,3) f32 triangles, (T,3,2) UVs or None,
    (T,3,3) per-corner normals or None)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[: len(_FBX_MAGIC)] == _FBX_MAGIC:
        (version,) = struct.unpack_from("<I", data, 23)
        nodes = _parse_fbx_nodes(data, 27, len(data), version)
        verts = idx = per_pv_uv = per_pv_n = None
        objects = _find_nodes(nodes, "Objects")
        geoms = []
        for _, _, children in objects:
            geoms += _find_nodes(children, "Geometry") + _find_nodes(children, "Model")
        for _, _, gchildren in geoms:
            v = _find_nodes(gchildren, "Vertices")
            i = _find_nodes(gchildren, "PolygonVertexIndex")
            if v and i:
                verts = np.asarray(v[0][1][0], np.float64).reshape(-1, 3)
                idx = np.asarray(i[0][1][0], np.int64)
                per_pv_uv = _fbx_uv_layer(gchildren, idx)
                per_pv_n = _fbx_normal_layer(gchildren, idx)
                break
        if verts is None:
            raise ValueError(f"no mesh geometry found in {path}")
    else:
        verts, idx = _load_fbx_ascii(path)
        per_pv_uv = per_pv_n = None
    tris = _triangulate(verts, idx)
    uvs = _triangulate_attr(idx, per_pv_uv) if per_pv_uv is not None else None
    normals = (
        _triangulate_attr(idx, per_pv_n) if per_pv_n is not None else None
    )
    return tris, uvs, normals


def load_fbx_ex(path: str):
    """First mesh → ((T,3,3) f32 triangles, (T,3,2) f32 UVs or None)."""
    return load_fbx_full(path)[:2]


def load_fbx(path: str) -> np.ndarray:
    """Load the first mesh → (T,3,3) float32 triangles (fan-triangulated)."""
    return load_fbx_full(path)[0]


def _load_fbx_ascii(path: str):
    """Minimal ASCII FBX: extract the first Vertices/PolygonVertexIndex.

    (np.fromstring was removed in numpy 2 — parse via str.split.)
    """
    with open(path, "r", errors="replace") as f:
        text = f.read()

    def grab(key):
        m = re.search(
            key + r"\s*:\s*\*?\d*\s*\{?\s*(?:a\s*:)?([\s\-0-9.,eE+]+)", text
        )
        if not m:
            raise ValueError(f"{key} not found in ASCII FBX")
        toks = [t for t in re.split(r"[\s,]+", m.group(1)) if t]
        try:
            return np.asarray([float(t) for t in toks], np.float64)
        except ValueError as e:
            # e.g. the reference's own bundled teapot-ascii.fbx contains the
            # malformed literal "0.6351.18075633049011" in its Vertices
            # array (corrupt upstream asset) — surface a clear diagnosis
            raise ValueError(
                f"{path}: malformed number in ASCII FBX {key} array ({e})"
            ) from None

    verts = grab(r"Vertices").reshape(-1, 3)
    idx = grab(r"PolygonVertexIndex").astype(np.int64)
    return verts, idx


def _triangulate(verts: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """FBX polygon list (negative index = ~last of polygon) → triangle fan."""
    tris = []
    poly = []
    for i in idx:
        if i < 0:
            poly.append(~int(i))
            for k in range(1, len(poly) - 1):
                tris.append((poly[0], poly[k], poly[k + 1]))
            poly = []
        else:
            poly.append(int(i))
    t = np.asarray(tris, np.int64)
    return verts[t].astype(np.float32)


def _triangulate_attr(idx: np.ndarray, per_pv: np.ndarray) -> np.ndarray:
    """Fan-triangulate a per-polygon-vertex attribute with the same fan
    order as ``_triangulate`` → (T, 3, attr_dim)."""
    tris = []
    poly = []
    for pv, i in enumerate(idx):
        poly.append(pv)
        if i < 0:
            for k in range(1, len(poly) - 1):
                tris.append((poly[0], poly[k], poly[k + 1]))
            poly = []
    t = np.asarray(tris, np.int64)
    return per_pv[t].astype(np.float32)


def load_obj_full(path: str):
    """Wavefront OBJ → ((T,3,3) triangles, (T,3,2) UVs or None,
    (T,3,3) per-corner normals or None)."""
    verts = []
    uvs = []
    norms = []
    tris = []
    tri_uv_idx = []
    tri_n_idx = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif parts[0] == "vn":
                norms.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                ids, uids, nids = [], [], []
                for p in parts[1:]:
                    fields = p.split("/")
                    i = int(fields[0])
                    ids.append(i - 1 if i > 0 else len(verts) + i)
                    if len(fields) > 1 and fields[1]:
                        u = int(fields[1])
                        uids.append(u - 1 if u > 0 else len(uvs) + u)
                    else:
                        uids.append(-1)
                    if len(fields) > 2 and fields[2]:
                        nn = int(fields[2])
                        nids.append(nn - 1 if nn > 0 else len(norms) + nn)
                    else:
                        nids.append(-1)
                for k in range(1, len(ids) - 1):
                    tris.append((ids[0], ids[k], ids[k + 1]))
                    tri_uv_idx.append((uids[0], uids[k], uids[k + 1]))
                    tri_n_idx.append((nids[0], nids[k], nids[k + 1]))
    v = np.asarray(verts, np.float64)
    t = np.asarray(tris, np.int64)
    out_tris = v[t].astype(np.float32)
    out_uvs = None
    tu = np.asarray(tri_uv_idx, np.int64)
    if len(uvs) and len(tu) and (tu >= 0).all():
        out_uvs = np.asarray(uvs, np.float64)[tu].astype(np.float32)
    out_ns = None
    tn = np.asarray(tri_n_idx, np.int64)
    if len(norms) and len(tn) and (tn >= 0).all():
        out_ns = np.asarray(norms, np.float64)[tn].astype(np.float32)
    return out_tris, out_uvs, out_ns


def load_obj_ex(path: str):
    return load_obj_full(path)[:2]


def load_obj(path: str) -> np.ndarray:
    return load_obj_full(path)[0]


def load_mesh_full(path: str):
    """Mesh → (triangles (T,3,3), UVs (T,3,2) | None, normals (T,3,3) | None)."""
    if path.lower().endswith(".obj"):
        return load_obj_full(path)
    if path.lower().endswith(".fbx"):
        return load_fbx_full(path)
    raise ValueError(f"unsupported mesh format: {path}")


def load_mesh_ex(path: str):
    """Mesh → (triangles (T,3,3), UVs (T,3,2) or None)."""
    return load_mesh_full(path)[:2]


def load_mesh(path: str) -> np.ndarray:
    return load_mesh_full(path)[0]
