"""A scene file of the upstream DumbTracer, kept by the benchmark: the JSON
subset that ``scenes/scene_test.json`` uses, read as the port's
``scene/parser.parse_scene`` reads it, with frozen copies of the port's
binary FBX reader (``scene/meshio.load_fbx_full``), its PNG reader
(``utils/imageio``) and its texture decoding
(``scene/parser._load_texture_image``), so that a change to the program
cannot change the scene it is measured on. It imports nothing of the port.

``build(cfg)`` gives a ``SceneSpec`` for the file ``cfg["file"]`` (relative
to the checkout's root) at ``cfg``'s image size: world-space triangles with
per-corner UVs and shading normals, material, light and texture rows in
the port's ``HostScene`` format, the environment colour and the camera. The
same spec goes to the port (``to_host_scene``) and to the plain reference
(``pt_bench/reference/textured.py``).

The subset:

- ``camera`` (focal length, sensor size, direction, position), ``film``;
- ``textures``: PNG files; diffuse maps are sRGB-encoded, roughness and
  normal maps read raw;
- ``materials``: GGX dielectric rows and their diffuse, roughness and
  normal maps;
- ``objects``: binary FBX meshes with UV and normal layers;
- ``lights``: point and spot lights, placed by the world section's
  ``srt`` transforms or, where the world places none, at their canonical
  pose (the origin, aimed at -z);
- ``world``: each transform's instances and lights, baked into world space;
- ``envlight``: an image the repository does not hold stands as the
  parser's dim constant environment 0.05, with no environment NEE, as the
  port renders such a file. That stand-in changes the lighting and the
  mix (no environment importance sampling, one shadow ray a bounce
  fewer), so the configuration that runs it lists ``envlight`` in its
  ``reduced``.

Anything else (other materials, primitives, OBJ or ASCII FBX, a mesh without
UVs or normals, a missing texture, an environment image that is present,
a mesh placed more than once) is refused with ``ValueError``: the port
would read it otherwise than this copy.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
GGX_DIELECTRIC = 1
POINT, SPOT = 0, 1
MISSING_ENV = (0.05, 0.05, 0.05)  # the parser's stand-in for an absent environment image


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    tris: np.ndarray  # (T, 3, 3) float32 world-space corners
    tri_mat: np.ndarray  # (T,) int32 material ids
    tri_uv: np.ndarray  # (T, 3, 2) float32 per-corner UVs
    tri_ns: np.ndarray  # (T, 3, 3) float32 per-corner unit shading normals
    materials: tuple  # HostScene material dicts (texture ids under *_tex)
    lights: tuple  # HostScene light dicts
    textures: tuple  # (H, W, 3) float32 linear-light images
    env_color: tuple
    camera: dict  # position, direction, width, height, focal_length_mm, sensor_height_mm


# ------------------------------------------------------- binary FBX (frozen)

_FBX_MAGIC = b"Kaydara FBX Binary  \x00\x1a\x00"


def _read_fbx_props(data, pos, count):
    props = []
    for _ in range(count):
        t = data[pos:pos + 1]
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
            raw = data[pos:pos + clen]
            pos += clen
            if enc == 1:
                raw = zlib.decompress(raw)
            dt = {b"f": "<f4", b"d": "<f8", b"l": "<i8", b"i": "<i4", b"b": "i1"}[t]
            v = np.frombuffer(raw, dtype=dt, count=n)
        elif t in (b"S", b"R"):
            (n,) = struct.unpack_from("<I", data, pos)
            pos += 4
            v = data[pos:pos + n]
            pos += n
            if t == b"S":
                v = v.decode("utf-8", "replace")
        else:
            raise ValueError(f"unknown FBX property type {t!r}")
        props.append(v)
    return props, pos


def _parse_fbx_nodes(data, pos, end, version):
    """Sibling node records until the NULL sentinel → [(name, props,
    children)]."""
    word = 8 if version >= 7500 else 4
    fmt = "<QQQ" if version >= 7500 else "<III"
    nodes = []
    while pos < end:
        end_off, n_props, _ = struct.unpack_from(fmt, data, pos)
        name_len = data[pos + 3 * word]
        hdr = 3 * word + 1
        if end_off == 0:
            break
        name = data[pos + hdr:pos + hdr + name_len].decode("ascii", "replace")
        p = pos + hdr + name_len
        props, p = _read_fbx_props(data, p, n_props)
        children = _parse_fbx_nodes(data, p, end_off, version) if p < end_off else []
        nodes.append((name, props, children))
        pos = end_off
    return nodes


def _find_nodes(nodes, name):
    return [n for n in nodes if n[0] == name]


def _fbx_attr_layer(gchildren, idx, layer_name, elem_name, idx_name, dim):
    """Per-polygon-vertex attribute of a LayerElement node, or None:
    {ByControlPoint, ByPolygonVertex} x {Direct, IndexToDirect}."""
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
        ctrl = np.where(idx < 0, ~idx, idx)
        where = ctrl if mapping == "ByControlPoint" else np.arange(idx.shape[0])
        per_pv = arr[aidx[where]] if (ref == "IndexToDirect" and aidx is not None) else arr[where]
        return per_pv.astype(np.float32)
    return None


def _fans(idx: np.ndarray):
    """(polygon-vertex index, control point) of each triangle's corners,
    fan-triangulating the FBX polygon list (a negative index closes a
    polygon) → two (T, 3) int64 arrays."""
    pv_tris, cp_tris, poly = [], [], []
    for pv, i in enumerate(idx):
        poly.append((pv, ~int(i) if i < 0 else int(i)))
        if i < 0:
            for k in range(1, len(poly) - 1):
                corners = (poly[0], poly[k], poly[k + 1])
                pv_tris.append([c[0] for c in corners])
                cp_tris.append([c[1] for c in corners])
            poly = []
    return np.asarray(pv_tris, np.int64), np.asarray(cp_tris, np.int64)


def load_fbx(path: str):
    """The first mesh of a binary FBX → ((T, 3, 3) float32 triangles,
    (T, 3, 2) UVs or None, (T, 3, 3) per-corner normals or None)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(_FBX_MAGIC)] != _FBX_MAGIC:
        raise ValueError(f"{path}: not a binary FBX")
    (version,) = struct.unpack_from("<I", data, 23)
    nodes = _parse_fbx_nodes(data, 27, len(data), version)
    geoms = []
    for _, _, children in _find_nodes(nodes, "Objects"):
        geoms += _find_nodes(children, "Geometry") + _find_nodes(children, "Model")
    for _, _, gchildren in geoms:
        v = _find_nodes(gchildren, "Vertices")
        i = _find_nodes(gchildren, "PolygonVertexIndex")
        if v and i:
            verts = np.asarray(v[0][1][0], np.float64).reshape(-1, 3)
            idx = np.asarray(i[0][1][0], np.int64)
            uv = _fbx_attr_layer(gchildren, idx, "LayerElementUV", "UV", "UVIndex", 2)
            nrm = _fbx_attr_layer(gchildren, idx, "LayerElementNormal", "Normals",
                                  "NormalsIndex", 3)
            pv, cp = _fans(idx)
            return (verts[cp].astype(np.float32),
                    None if uv is None else uv[pv].astype(np.float32),
                    None if nrm is None else nrm[pv].astype(np.float32))
    raise ValueError(f"no mesh geometry found in {path}")


# -------------------------------------------------------------- PNG (frozen)

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _unfilter(raw: np.ndarray, h: int, w: int, c: int, depth_bytes: int) -> np.ndarray:
    stride = w * c * depth_bytes
    bpp = c * depth_bytes
    out = np.zeros((h, stride), np.uint8)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = raw[pos + 1:pos + 1 + stride].astype(np.int32)
        pos += 1 + stride
        prev = out[y - 1].astype(np.int32) if y > 0 else np.zeros(stride, np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:  # up
            cur = (line + prev) & 0xFF
        else:  # sub (1), average (3), paeth (4): sequential
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                cc = prev[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur.astype(np.uint8)
    return out


def read_png(path: str) -> np.ndarray:
    """A non-interlaced 8/16-bit PNG → uint8/uint16 (H, W, C): through PIL
    where it is installed, else the stdlib reader below."""
    try:
        from PIL import Image

        with Image.open(path) as im:
            if im.mode == "P":
                im = im.convert("RGB")
            arr = np.asarray(im)
        return arr[:, :, None] if arr.ndim == 2 else arr
    except ImportError:
        pass
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, palette = 8, b"", None
    w = h = depth = color_type = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, color_type, _, _, interlace = struct.unpack(">IIBBBBB", payload)
            if interlace:
                raise ValueError("interlaced PNG unsupported")
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    if depth not in (8, 16):
        raise ValueError(f"bit depth {depth} unsupported")
    arr = _unfilter(np.frombuffer(zlib.decompress(idat), np.uint8), h, w, channels, depth // 8)
    if depth == 16:
        arr = arr.reshape(h, w, channels, 2)
        img = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
    else:
        img = arr.reshape(h, w, channels)
    return palette[img[..., 0]] if color_type == 3 else img


def srgb_to_linear(img_uint: np.ndarray) -> np.ndarray:
    x = img_uint.astype(np.float32) / float(np.iinfo(img_uint.dtype).max)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def texture_image(path: str, ttype: str) -> np.ndarray:
    """PNG → linear-light (H, W, 3) float32: diffuse maps sRGB-decoded,
    data maps (roughness, normal) read raw."""
    img = read_png(path)
    if img.ndim == 2:
        img = img[:, :, None]
    if ttype == "diffuse":
        return srgb_to_linear(img[..., :3] if img.shape[2] >= 3
                              else np.repeat(img[..., :1], 3, 2))
    x = img.astype(np.float32) / float(np.iinfo(img.dtype).max)
    return x[..., :3] if x.shape[2] >= 3 else np.repeat(x[..., :1], 3, axis=2)


# --------------------------------------------------------------- the file


def srt_matrix(srt: dict) -> np.ndarray:
    """4x4 float64: scale, then rotation about an axis, then translation."""
    m = np.eye(4)
    if "scale" in srt:
        m[:3, :3] = np.diag(np.broadcast_to(np.asarray(srt["scale"], float), (3,)))
    if "rotate-axis" in srt:
        axis = np.asarray(srt["rotate-axis"], float)
        x, y, z = axis / np.linalg.norm(axis)
        ang = np.deg2rad(float(srt.get("rotate-degrees", 0.0)))
        c, s = np.cos(ang), np.sin(ang)
        r = np.array([
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
        ])
        m[:3, :3] = r @ m[:3, :3]
    if "translation-vector" in srt:
        m[:3, 3] = np.asarray(srt["translation-vector"], float)
    return m


def transform_tris(tris: np.ndarray, m: np.ndarray) -> np.ndarray:
    """(T, 3, 3) corners under a 4x4 affine, in float32, each row
    m[r,0]·x + m[r,1]·y + m[r,2]·z + m[r,3] from left to right."""
    p = np.asarray(tris, np.float32)
    m = np.asarray(m, np.float32)
    return np.stack([m[r, 0] * p[..., 0] + m[r, 1] * p[..., 1] + m[r, 2] * p[..., 2] + m[r, 3]
                     for r in range(3)], axis=-1).astype(np.float32)


def _material(mj: dict, tex_ids: dict) -> dict:
    """A GGX dielectric row, its maps' texture ids under ``*_tex``."""
    name = mj.get("name")
    if "ggx-dielectric" not in mj or float(mj.get("metallic", 0.0)) >= 0.5:
        raise ValueError(f"material {name!r}: only GGX dielectric rows are in the subset")
    extra = {}
    for key, field, ttype in (("diffuse", "albedo_tex", "diffuse"),
                              ("roughness", "rough_tex", "roughness"),
                              ("normal", "normal_tex", "normal")):
        ref = mj.get(key)
        if isinstance(ref, str):
            if tex_ids.get(ref, (None, None))[1] != ttype:
                raise ValueError(f"material {name!r}: {key} map {ref!r} is no loaded "
                                 f"{ttype} texture")
            extra[field] = tex_ids[ref][0]
    roughness = 0.5 if "rough_tex" in extra else float(mj.get("roughness", 0.5))
    aniso = float(mj.get("ggx-anisotropy", 0.0))
    alpha = roughness ** 2
    g = mj["ggx-dielectric"]
    return dict(mtype=GGX_DIELECTRIC,
                refl_tint=np.asarray(g.get("reflectance-tint", (1.0, 1.0, 1.0)), np.float32),
                trans_tint=np.asarray(g.get("transmittance-tint", (0.0, 0.0, 0.0)), np.float32),
                phi0=0.0, eta=float(mj.get("ior", 1.5)), alphax=float(alpha * (1.0 + aniso)),
                alphay=float(alpha * max(1.0 - aniso, 1e-3)), **extra)


def _light(lj: dict, m) -> dict:
    color = tuple(lj.get("radiant-intensity", (1.0, 1.0, 1.0)))
    m = m if m is not None else np.eye(4)
    pos = tuple((m @ np.array([0.0, 0.0, 0.0, 1.0]))[:3])
    radius = float(lj.get("radius", 1e-3))
    ltype = lj.get("type", "point")
    if ltype == "point":
        return dict(ltype=POINT, color=color, pos=pos, radius=radius)
    if ltype == "spot":
        d = np.asarray(m[:3, :3] @ np.array([0.0, 0.0, -1.0]), np.float64)
        theta_e = np.deg2rad(float(lj.get("cone-angle", 60.0))) / 2.0
        theta_0 = theta_e * (1.0 - float(lj.get("falloff-percentage", 10.0)) / 100.0)
        return dict(ltype=SPOT, color=color, pos=pos,
                    direction=(d / np.linalg.norm(d)).astype(np.float32),
                    cos_theta0=float(np.cos(theta_0)), cos_theta_e=float(np.cos(theta_e)),
                    radius=radius)
    raise ValueError(f"light {lj.get('name')!r}: type {ltype!r} is outside the subset")


def build(cfg: dict) -> SceneSpec:
    """The scene file ``cfg["file"]`` at ``cfg``'s image size."""
    path = Path(cfg["file"])
    path = path if path.is_absolute() else ROOT / path
    base = path.parent
    doc = json.loads(path.read_text())
    cam = doc.get("camera", {})

    textures, tex_ids = [], {}
    for tj in doc.get("textures", []):
        tpath = base / tj["path"]
        if not tpath.is_file() or tpath.suffix.lower() != ".png":
            raise ValueError(f"texture {tj['name']!r}: no PNG at {tpath}")
        tex_ids[tj["name"]] = (len(textures), tj["type"])
        textures.append(np.asarray(texture_image(str(tpath), tj["type"]), np.float32))
    materials, mat_ids = [], {}
    for mj in doc.get("materials", []):
        mat_ids[mj["name"]] = len(materials)
        materials.append(_material(mj, tex_ids))

    objects = {oj["name"]: oj for oj in doc.get("objects", [])}
    lights_by_name = {lj["name"]: lj for lj in doc.get("lights", [])}
    transforms = {tj["name"]: srt_matrix(tj["srt"]) for tj in doc.get("transforms", [])}
    parts, lights, placed, seen = [], [], set(), set()
    for tname, binding in doc.get("world", {}).items():
        m = transforms[tname]
        for oname in binding.get("instances", []):
            if oname in seen:
                raise ValueError(f"object {oname!r} is placed more than once")
            seen.add(oname)
            oj = objects[oname]
            if str(oj.get("type", "")).upper() != "FBX":
                raise ValueError(f"object {oname!r}: only FBX meshes are in the subset")
            tris, uvs, normals = load_fbx(str(base / oj["path"]))
            if uvs is None or normals is None:
                raise ValueError(f"object {oname!r}: a mesh without UVs or normals")
            nit = np.linalg.inv(m[:3, :3]).T
            nw = np.asarray(normals, np.float32) @ nit.T.astype(np.float32)
            nw = nw / np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True), 1e-20)
            mat = mat_ids[oj.get("material", next(iter(mat_ids)))]
            parts.append((transform_tris(tris, m), np.full(len(tris), mat, np.int32),
                          np.asarray(uvs, np.float32), np.asarray(nw, np.float32)))
        for lname in binding.get("lights", []):
            lights.append(_light(lights_by_name[lname], m))
            placed.add(lname)
    lights += [_light(lj, None) for name, lj in lights_by_name.items() if name not in placed]

    env = doc.get("envlight")
    if env and (base / env).exists():
        raise ValueError(f"environment image {env!r} is present: outside the subset")
    camera = dict(position=tuple(cam.get("position", (0.0, 0.0, 0.0))),
                  direction=tuple(cam.get("direction", (0.0, 1.0, 0.0))),
                  width=cfg["width"], height=cfg["height"],
                  focal_length_mm=float(cam.get("focalLength", 20.0)),
                  sensor_height_mm=float(cam.get("sensorSize", 36.0)))
    cat = lambda i: np.concatenate([p[i] for p in parts])  # noqa: E731
    return SceneSpec(cat(0), cat(1), cat(2), cat(3), tuple(materials), tuple(lights),
                     tuple(textures), MISSING_ENV if env else (0.0, 0.0, 0.0), camera)


def to_host_scene(spec: SceneSpec, HostScene):
    """The spec as the port's ``HostScene`` (the class is passed in, so
    this module imports nothing of the port)."""
    hs = HostScene()
    for image in spec.textures:
        hs.add_texture(image)
    for mat in spec.materials:
        hs.add_material(dict(mat))
    hs.add_model(list(spec.tris), 0, uvs=spec.tri_uv, normals=spec.tri_ns)
    hs.tri_mat = [int(m) for m in spec.tri_mat]
    for light in spec.lights:
        hs.add_light(dict(light))
    hs.env_color = spec.env_color
    hs.camera = dataclasses.replace(hs.camera, **spec.camera)
    return hs
