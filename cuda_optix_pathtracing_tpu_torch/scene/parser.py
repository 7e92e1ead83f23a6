"""JSON scene parser (counterpart of the reference ``scene/parser.py``),
for scenes like ``scenes/scene_example.json``:

    camera{focalLength,sensorSize,direction,max-depth}
    film{resolutionX,resolutionY,samples}
    textures[] materials[] objects[] lights[] envlight
    transforms[] (SRT)  world{transform: {instances:[], lights:[]}}

Keys are checked strictly (unknown keys raise). Material mapping to the
BSDF set:

    metallic ≥ 0.5                  → GGX conductor (F0 from `diffuse`)
    "ggx-dielectric" block present  → GGX dielectric (ior, tints, roughness)
    otherwise                       → Oren-Nayar (σ = roughness·π/2)

Lights are positioned/oriented by the world-section SRT transform applied
to the canonical pose (origin, direction (0,0,-1)).

A texture or environment file that is missing or not a PNG is warned
about and replaced, as in the reference: materials fall back to their
constants, the environment to a dim constant 0.05. An object that the
world places under two or more transforms loads its mesh once, as an
instance group (``HostScene.add_instance_group``), and everything else
bakes into world space; grouping is skipped (every placement bakes) when
the scene has textures or emissive materials, and for an object with
authored normals.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass

import numpy as np

from ..ops import bsdf as B
from ..ops import lights as L
from ..ops.camera import CameraConfig
from ..native import smooth_normals, transform_tris
from ..utils.imageio import read_png, srgb_to_linear
from . import meshio, procedural
from .types import HostScene, Scene, scene_from_host

log = logging.getLogger("dtpt-torch.parser")

_CAMERA_KEYS = {"focalLength", "sensorSize", "direction", "max-depth", "position"}
_FILM_KEYS = {"resolutionX", "resolutionY", "samples"}
_TEXTURE_KEYS = {"name", "type", "path"}
_TEX_TYPES = {"diffuse", "normal", "metallic", "roughness"}
_MATERIAL_KEYS = {
    "name", "diffuse", "normal", "metallic", "roughness", "ior",
    "ggx-anisotropy", "ggx-dielectric", "oren-nayar-multiscatter",
}
_OBJECT_KEYS = {"name", "type", "shape", "path", "material"}
_LIGHT_KEYS = {
    "name", "type", "cone-angle", "falloff-percentage", "radiant-intensity",
    "radius", "direction",
}
_TRANSFORM_KEYS = {"name", "srt"}
_SRT_KEYS = {"translation-vector", "rotate-axis", "rotate-degrees", "scale"}


class SceneParseError(ValueError):
    pass


def _check_keys(obj: dict, allowed: set, ctx: str):
    for k in obj:
        if k not in allowed:
            raise SceneParseError(f"unknown key '{k}' in {ctx}")


@dataclass
class ParsedScene:
    width: int
    height: int
    spp: int
    max_depth: int
    envlight_path: str | None


def _srt_matrix(srt: dict) -> np.ndarray:
    _check_keys(srt, _SRT_KEYS, "transform.srt")
    m = np.eye(4)
    if "scale" in srt:
        s = np.broadcast_to(np.asarray(srt["scale"], float), (3,))
        m[:3, :3] = np.diag(s)
    if "rotate-axis" in srt:
        axis = np.asarray(srt["rotate-axis"], float)
        axis = axis / np.linalg.norm(axis)
        ang = np.deg2rad(float(srt.get("rotate-degrees", 0.0)))
        c, s_ = np.cos(ang), np.sin(ang)
        x, y, z = axis
        r = np.array(
            [
                [c + x * x * (1 - c), x * y * (1 - c) - z * s_, x * z * (1 - c) + y * s_],
                [y * x * (1 - c) + z * s_, c + y * y * (1 - c), y * z * (1 - c) - x * s_],
                [z * x * (1 - c) - y * s_, z * y * (1 - c) + x * s_, c + z * z * (1 - c)],
            ]
        )
        m[:3, :3] = r @ m[:3, :3]
    if "translation-vector" in srt:
        m[:3, 3] = np.asarray(srt["translation-vector"], float)
    return m


def _resolve_tex(tex_ids: dict, name: str, want: str, ctx: str) -> int:
    info = tex_ids.get(name)
    if info is None:
        raise SceneParseError(f"{ctx} references unknown texture '{name}'")
    tid, ttype = info
    if ttype != want:
        log.warning(
            "%s uses texture '%s' of type '%s' where '%s' was expected",
            ctx, name, ttype, want,
        )
    return tid


def _material_from_json(mj: dict, tex_ids: dict | None = None) -> dict:
    tex_ids = tex_ids or {}
    name = mj.get("name")
    _check_keys(mj, _MATERIAL_KEYS, f"material '{name}'")
    extra: dict = {}
    diffuse = mj.get("diffuse", (0.8, 0.8, 0.8))
    if isinstance(diffuse, str):
        extra["albedo_tex"] = _resolve_tex(
            tex_ids, diffuse, "diffuse", f"material '{name}' diffuse"
        )
        diffuse = (0.8, 0.8, 0.8)  # fallback constant behind the texture
    roughness = mj.get("roughness", 0.5)
    if isinstance(roughness, str):
        extra["rough_tex"] = _resolve_tex(
            tex_ids, roughness, "roughness", f"material '{name}' roughness"
        )
        roughness = 0.5
    if isinstance(mj.get("normal"), str):
        extra["normal_tex"] = _resolve_tex(
            tex_ids, mj["normal"], "normal", f"material '{name}' normal"
        )
    metallic = mj.get("metallic", 0.0)
    if isinstance(metallic, str):
        log.warning(
            "material '%s': metallic texture '%s' unsupported (static lobe "
            "dispatch) — using metallic=0", name, metallic,
        )
        metallic = 0.0
    metallic = float(metallic)
    aniso = float(mj.get("ggx-anisotropy", 0.0))
    alpha = float(roughness) ** 2
    ax = alpha * (1.0 + aniso)
    ay = alpha * max(1.0 - aniso, 1e-3)
    if metallic >= 0.5:
        f0 = np.clip(np.asarray(diffuse, float), 1e-3, 0.999)
        eta = (1.0 + np.sqrt(f0)) / (1.0 - np.sqrt(f0))
        return {**B.ggx_conductor(eta, (0.0, 0.0, 0.0), 0.0, ax, ay), **extra}
    if "ggx-dielectric" in mj:
        g = mj["ggx-dielectric"]
        _check_keys(
            g, {"reflectance-tint", "transmittance-tint"}, "ggx-dielectric"
        )
        return {
            **B.ggx_dielectric(
                g.get("reflectance-tint", (1.0, 1.0, 1.0)),
                g.get("transmittance-tint", (0.0, 0.0, 0.0)),
                0.0,
                float(mj.get("ior", 1.5)),
                ax,
                ay,
            ),
            **extra,
        }
    sigma = float(roughness) * np.pi / 2.0
    return {**B.oren_nayar(diffuse, sigma), **extra}


def _object_triangles(oj: dict, base_dir: str):
    """→ ((T,3,3) triangles, (T,3,2) UVs | None, (T,3,3) normals | None).

    Meshes without authored normals get smooth normals (66° crease, the
    port's native library); primitives stay flat."""
    _check_keys(oj, _OBJECT_KEYS, f"object '{oj.get('name')}'")
    otype = oj.get("type", "primitive")
    if otype == "primitive":
        shape = oj.get("shape", "cube")
        if shape == "cube":
            tris = procedural.generate_cube((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
        elif shape == "plane":
            tris = procedural.generate_plane((0, 0, 0), (0, 0, 1), 1.0, 1.0)
        elif shape == "sphere":
            tris = procedural.generate_sphere((0.0, 0.0, 0.0), 0.5, 8, 16)
        else:
            raise SceneParseError(f"unknown primitive shape '{shape}'")
        return np.stack(tris).astype(np.float32), None, None
    if otype.upper() == "FBX" or otype.lower() in ("obj", "mesh"):
        path = oj["path"]
        if not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        tris, uvs, normals = meshio.load_mesh_full(path)
        if normals is None and len(tris):
            normals = smooth_normals(tris, crease_deg=66.0)
        return np.asarray(tris, np.float32), uvs, normals
    raise SceneParseError(f"unknown object type '{otype}'")


def _load_texture_image(path: str, ttype: str) -> np.ndarray:
    """PNG → linear-light (H,W,3) float32. Diffuse maps are sRGB-encoded;
    data maps (roughness/normal/metallic) are read raw."""
    img = read_png(path)
    if img.ndim == 2:
        img = img[:, :, None]
    if ttype == "diffuse":
        return srgb_to_linear(img[..., :3] if img.shape[2] >= 3 else np.repeat(img[..., :1], 3, 2))
    x = img.astype(np.float32) / float(np.iinfo(img.dtype).max)
    if x.shape[2] >= 3:
        return x[..., :3]
    return np.repeat(x[..., :1], 3, axis=2)


def _light_from_json(lj: dict, transform: np.ndarray | None) -> dict:
    _check_keys(lj, _LIGHT_KEYS, f"light '{lj.get('name')}'")
    color = tuple(lj.get("radiant-intensity", (1.0, 1.0, 1.0)))
    m = transform if transform is not None else np.eye(4)
    pos = tuple((m @ np.array([0.0, 0.0, 0.0, 1.0]))[:3])
    direction = tuple((m[:3, :3] @ np.array([0.0, 0.0, -1.0])))
    radius = float(lj.get("radius", 1e-3))
    ltype = lj.get("type", "point")
    if ltype == "point":
        return L.point_light(color, pos, radius)
    if ltype == "spot":
        cone_deg = float(lj.get("cone-angle", 60.0))
        falloff = float(lj.get("falloff-percentage", 10.0)) / 100.0
        theta_e = np.deg2rad(cone_deg) / 2.0
        theta_0 = theta_e * (1.0 - falloff)
        return L.spot_light(
            color, pos, direction, float(np.cos(theta_0)), float(np.cos(theta_e)), radius
        )
    if ltype == "directional":
        return L.directional_light(color, direction)
    if ltype in ("env", "environment"):
        return L.environment_light(color)
    raise SceneParseError(f"unknown light type '{ltype}'")


def parse_scene(path: str) -> tuple[HostScene, ParsedScene]:
    """Parse the JSON scene into a HostScene + render settings."""
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        doc = json.load(f)

    cam_j = doc.get("camera", {})
    _check_keys(cam_j, _CAMERA_KEYS, "camera")
    film_j = doc.get("film", {})
    _check_keys(film_j, _FILM_KEYS, "film")
    width = int(film_j.get("resolutionX", 256))
    height = int(film_j.get("resolutionY", 256))

    hs = HostScene()
    hs.camera = CameraConfig(
        position=tuple(cam_j.get("position", (0.0, 0.0, 0.0))),
        direction=tuple(cam_j.get("direction", (0.0, 1.0, 0.0))),
        width=width,
        height=height,
        focal_length_mm=float(cam_j.get("focalLength", 20.0)),
        sensor_height_mm=float(cam_j.get("sensorSize", 36.0)),
    )

    # textures (reference parseTexture, core-parser.cpp:306-366: keys
    # name/type/path, type ∈ diffuse|normal|metallic|roughness)
    tex_ids: dict = {}
    for tj in doc.get("textures", []):
        _check_keys(tj, _TEXTURE_KEYS, f"texture '{tj.get('name')}'")
        tname, ttype = tj["name"], tj["type"]
        if ttype not in _TEX_TYPES:
            raise SceneParseError(f"texture '{tname}': unknown type '{ttype}'")
        if tname in tex_ids:
            raise SceneParseError(f"texture '{tname}' already exists")
        tpath = tj["path"]
        if not os.path.isabs(tpath):
            tpath = os.path.join(base_dir, tpath)
        if not os.path.exists(tpath) or not tpath.lower().endswith(".png"):
            log.warning(
                "texture '%s': cannot load '%s' (missing or non-PNG) — "
                "materials referencing it fall back to constants", tname, tpath,
            )
            continue
        tex_ids[tname] = (hs.add_texture(_load_texture_image(tpath, ttype)), ttype)

    mat_ids = {}
    for mj in doc.get("materials", []):
        try:
            mat_ids[mj["name"]] = hs.add_material(_material_from_json(mj, tex_ids))
        except SceneParseError as e:
            if "unknown texture" in str(e):
                # Replace ONLY the references that actually fail to
                # resolve; resolvable textures (incl. normal maps) stay.
                def _keep(k, v):
                    if k in ("diffuse", "roughness", "normal") and isinstance(
                        v, str
                    ):
                        return v in tex_ids
                    return True

                dropped = [
                    f"{k}='{v}'" for k, v in mj.items() if not _keep(k, v)
                ]
                log.warning(
                    "%s — dropping unresolved reference(s) %s, keeping the "
                    "rest", e, ", ".join(dropped),
                )
                mj2 = {
                    k: ((0.8, 0.8, 0.8) if k == "diffuse"
                        else 0.5 if k == "roughness" else v)
                    if not _keep(k, v) else v
                    for k, v in mj.items()
                    if _keep(k, v) or k != "normal"
                }
                mat_ids[mj["name"]] = hs.add_material(_material_from_json(mj2, tex_ids))
            else:
                raise
    if not mat_ids:
        mat_ids["__default"] = hs.add_material(B.oren_nayar((0.8, 0.8, 0.8), 0.3))

    objects = {oj["name"]: oj for oj in doc.get("objects", [])}
    lights = {lj["name"]: lj for lj in doc.get("lights", [])}
    transforms = {}
    for tj in doc.get("transforms", []):
        _check_keys(tj, _TRANSFORM_KEYS, f"transform '{tj.get('name')}'")
        transforms[tj["name"]] = _srt_matrix(tj["srt"])

    world = doc.get("world", {})
    placed_lights = set()

    # an object placed under two or more transforms loads its mesh once as
    # an instance group (unless the scene has textures or emissive
    # materials, or the object has authored normals: those bake)
    placements = {}
    for tname, binding in world.items():
        for oname in binding.get("instances", []):
            placements.setdefault(oname, []).append(transforms.get(tname))
    scene_emissive = any(
        np.max(np.asarray(mj.get("emission", (0.0,) * 3))) > 0.0
        for mj in hs.materials
    )
    grouped = set()
    if not hs.textures and not scene_emissive:
        for oname, mats in placements.items():
            if len(mats) < 2 or any(m is None for m in mats):
                continue
            oj = objects.get(oname)
            if oj is None:
                raise SceneParseError(
                    f"world references unknown object '{oname}'"
                )
            tris, _, normals = _object_triangles(oj, base_dir)
            if normals is not None:
                continue  # authored normals bake
            mat = mat_ids[oj.get("material", next(iter(mat_ids)))]
            hs.add_instance_group(np.asarray(tris, np.float32), mat, np.stack(mats))
            grouped.add(oname)
    if grouped:
        world = {
            tname: {
                **binding,
                "instances": [o for o in binding.get("instances", []) if o not in grouped],
            }
            for tname, binding in world.items()
        }

    for tname, binding in world.items():
        m = transforms.get(tname)
        if m is None:
            raise SceneParseError(f"world references unknown transform '{tname}'")
        for oname in binding.get("instances", []):
            oj = objects.get(oname)
            if oj is None:
                raise SceneParseError(f"world references unknown object '{oname}'")
            tris, uvs, normals = _object_triangles(oj, base_dir)
            mat = mat_ids[oj.get("material", next(iter(mat_ids)))]
            # world transform (normals by the inverse transpose,
            # renormalised)
            tw = transform_tris(tris, m)
            nw = None
            if normals is not None:
                nit = np.linalg.inv(m[:3, :3]).T
                nw = np.asarray(normals, np.float32) @ nit.T.astype(np.float32)
                nw = nw / np.maximum(
                    np.linalg.norm(nw, axis=-1, keepdims=True), 1e-20
                )
            hs.add_model(tw, mat, uvs=uvs, normals=nw)
        for lname in binding.get("lights", []):
            lj = lights.get(lname)
            if lj is None:
                raise SceneParseError(f"world references unknown light '{lname}'")
            hs.add_light(_light_from_json(lj, m))
            placed_lights.add(lname)
    # lights not placed by the world section sit at their canonical pose
    for lname, lj in lights.items():
        if lname not in placed_lights:
            hs.add_light(_light_from_json(lj, None))

    envlight = doc.get("envlight")
    if envlight is not None and not isinstance(envlight, str):
        raise SceneParseError("envlight must be an image path")
    if envlight:
        env_path = envlight if os.path.isabs(envlight) else os.path.join(base_dir, envlight)
        if os.path.exists(env_path) and env_path.lower().endswith(".png"):
            img = read_png(env_path)
            hs.env_image = srgb_to_linear(img[..., :3])
        else:
            reason = (
                "file not found" if not os.path.exists(env_path)
                else "unsupported format (PNG only)"
            )
            log.warning(
                "envlight '%s': %s — substituting dim constant environment "
                "(0.05); the render WILL differ from the authored scene",
                env_path, reason,
            )
            hs.env_color = (0.05, 0.05, 0.05)

    parsed = ParsedScene(
        width=width,
        height=height,
        spp=int(film_j.get("samples", 0)),
        max_depth=int(cam_j.get("max-depth", 0)),
        envlight_path=(
            os.path.join(base_dir, envlight) if envlight else None
        ),
    )
    return hs, parsed


def load_scene(path: str, device="cuda") -> tuple[Scene, ParsedScene]:
    hs, parsed = parse_scene(path)
    return scene_from_host(hs, device=device), parsed
