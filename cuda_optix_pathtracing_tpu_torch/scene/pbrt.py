"""Minimal PBRT-v4 scene-description parser (counterpart of the
reference ``scene/pbrt.py``), covering the subset of
``scenes/cornell-box.pbrt`` and ``scenes/cornell-area.pbrt``:

- ``Film`` (resolution, filename), ``Sampler`` (pixelsamples)
- ``LookAt`` + ``Camera "perspective"`` (fov)
- ``MakeNamedMaterial``/``NamedMaterial`` with type "diffuse"
- ``AttributeBegin/End`` with ``Translate``/``Rotate``/``Scale`` CTM
- ``AreaLightSource "diffuse"`` (rgb L) applying to following shapes
- ``Shape "trianglemesh"`` (point3 P + integer indices)
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, field

import numpy as np

from ..ops.bsdf import diffuse_light, lambert
from ..ops.camera import CameraConfig
from .types import HostScene, scene_from_host

log = logging.getLogger("dtpt-torch.parser")


def _tokenize(text: str):
    # strip comments
    text = re.sub(r"#[^\n]*", " ", text)
    # strings, brackets, numbers, identifiers
    return re.findall(r'"[^"]*"|\[|\]|[^\s\[\]"]+', text)


def _rot_matrix(angle_deg, x, y, z):
    a = np.deg2rad(angle_deg)
    axis = np.asarray([x, y, z], np.float64)
    axis = axis / np.linalg.norm(axis)
    c, s = np.cos(a), np.sin(a)
    x, y, z = axis
    return np.asarray(
        [
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
        ]
    )


@dataclass
class _State:
    ctm: np.ndarray = field(default_factory=lambda: np.eye(4))
    area_light: object = None  # (3,) rgb L or None
    material: str = ""


@dataclass
class PbrtScene:
    width: int = 256
    height: int = 256
    spp: int = 0
    filename: str = "pbrt-output.png"


class _Reader:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def done(self):
        return self.i >= len(self.toks)

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def peek(self):
        return self.toks[self.i] if not self.done() else None

    def floats(self, n):
        return [float(self.next()) for _ in range(n)]

    def params(self):
        """Read '"type name" [values…]' pairs until a non-parameter token."""
        out = {}
        while not self.done():
            t = self.peek()
            if not (t.startswith('"') and len(t.split()) == 2):
                break
            decl = self.next().strip('"')
            ptype, name = decl.split()
            vals = []
            if self.peek() == "[":
                self.next()
                while self.peek() != "]":
                    vals.append(self.next())
                self.next()
            else:
                vals.append(self.next())
            if ptype in ("float", "rgb", "point3", "integer", "point2", "normal"):
                vals = [float(v) for v in vals]
                if ptype == "integer":
                    vals = [int(v) for v in vals]
            else:
                vals = [v.strip('"') for v in vals]
            out[name] = vals
        return out


def parse_pbrt(path: str) -> tuple[HostScene, PbrtScene]:
    """Parse the PBRT subset into a HostScene (+ film metadata)."""
    with open(path) as f:
        toks = _tokenize(f.read())
    r = _Reader(toks)

    hs = HostScene()
    meta = PbrtScene()
    materials: dict[str, int] = {}
    st = _State()
    stack: list[_State] = []
    lookat = None
    fov = 90.0

    def mat_id_for(state: _State) -> int:
        if state.area_light is not None:
            hs.materials.append(diffuse_light(state.area_light))
            return len(hs.materials) - 1
        if state.material in materials:
            return materials[state.material]
        hs.materials.append(lambert((0.8, 0.8, 0.8)))
        return len(hs.materials) - 1

    while not r.done():
        tok = r.next()
        if tok == "Film":
            r.next()  # "rgb"
            p = r.params()
            meta.width = int(p.get("xresolution", [256])[0])
            meta.height = int(p.get("yresolution", [256])[0])
            meta.filename = p.get("filename", ["pbrt-output.png"])[0]
        elif tok == "Sampler":
            r.next()
            p = r.params()
            meta.spp = int(p.get("pixelsamples", [0])[0])
        elif tok == "ColorSpace":
            r.next()
        elif tok == "Option":
            r.params()
        elif tok == "LookAt":
            vals = r.floats(9)
            lookat = (
                np.asarray(vals[0:3]),
                np.asarray(vals[3:6]),
                np.asarray(vals[6:9]),
            )
        elif tok == "Camera":
            r.next()  # "perspective"
            p = r.params()
            fov = float(p.get("fov", [90.0])[0])
        elif tok == "WorldBegin":
            pass
        elif tok == "AttributeBegin":
            stack.append(
                _State(st.ctm.copy(), st.area_light, st.material)
            )
        elif tok == "AttributeEnd":
            st = stack.pop()
        elif tok == "Translate":
            t = r.floats(3)
            m = np.eye(4)
            m[:3, 3] = t
            st.ctm = st.ctm @ m
        elif tok == "Rotate":
            a = r.floats(4)
            m = np.eye(4)
            m[:3, :3] = _rot_matrix(*a)
            st.ctm = st.ctm @ m
        elif tok == "Scale":
            sc = r.floats(3)
            m = np.diag([sc[0], sc[1], sc[2], 1.0])
            st.ctm = st.ctm @ m
        elif tok == "AreaLightSource":
            r.next()  # "diffuse"
            p = r.params()
            st.area_light = np.asarray(p.get("L", [1.0, 1.0, 1.0]), np.float32)
        elif tok == "MakeNamedMaterial":
            name = r.next().strip('"')
            p = r.params()
            refl = p.get("reflectance", [0.5, 0.5, 0.5])
            hs.materials.append(lambert(tuple(refl)))
            materials[name] = len(hs.materials) - 1
        elif tok == "NamedMaterial":
            st.material = r.next().strip('"')
        elif tok == "Shape":
            kind = r.next().strip('"')
            p = r.params()
            if kind != "trianglemesh":
                continue
            pts = np.asarray(p["P"], np.float64).reshape(-1, 3)
            idx = np.asarray(p["indices"], np.int64).reshape(-1, 3)
            pts_h = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
            pts_w = (st.ctm @ pts_h.T).T[:, :3]
            mid = mat_id_for(st)
            for tri in idx:
                hs.add_model([pts_w[tri].astype(np.float32)], mid)
        else:
            # unknown directive: warn loudly, then skip its parameter block —
            # a silently-dropped directive makes a wrong image look authored
            log.warning("pbrt: unsupported directive '%s' skipped", tok)
            r.params()

    # camera: LookAt world transform → position + direction
    if lookat is not None:
        pos, look, _up = lookat
        d = look - pos
        d = d / np.linalg.norm(d)
    else:
        pos, d = np.zeros(3), np.asarray([0.0, 1.0, 0.0])
    # fov (vertical) → focal length on the 36mm sensor convention
    sensor = 36.0
    focal = sensor / 2.0 / np.tan(np.deg2rad(fov) / 2.0)
    hs.camera = CameraConfig(
        position=tuple(pos.astype(float)),
        direction=tuple(d.astype(float)),
        width=meta.width,
        height=meta.height,
        focal_length_mm=float(focal),
        sensor_height_mm=sensor,
    )
    return hs, meta


def load_pbrt(path: str, device="cuda"):
    """Parse and build the device scene → (Scene, PbrtScene)."""
    hs, meta = parse_pbrt(path)
    return scene_from_host(hs, device=device), meta
