"""Flat SoA scene (counterpart of the reference ``scene/types.py``):
triangles as (v0, e0, e1) SoA, material/light tables and the camera
transforms, as tensors on one device.

Scenes at or above ``BVH_THRESHOLD`` triangles (or with ``use_bvh=True``)
get an 8-wide BVH: the triangle arrays are then in packed-BVH order
(leaf-major, padded with zero-edge rows; the UV and normal arrays
follow) and ``bvh`` holds the node tables the traversal kernels read.
Textures live in one mip pool (``ops/texture.py``); an environment image
gets its sampling distribution (``ops/envmap.py``). Scenes that need a
light tree or instancing (slice 5b) raise ``NotImplementedError``.

Every table a kernel or a query reads is built here, once per scene: the
BVH node tables (the reference's layout, and the compact copy with its
triangle rows that the BVH kernels walk), ``bounds`` (the packed rows'
box, which the ray sort of BVH queries quantises origins in),
``shade_tables``, the fused kernels' packed shading tables, and a
brute-force scene's ``brute_tables``, its fused kernel's whole
shared-memory blob.

``scene_from_arrays`` carries a reference ``Scene`` over: it takes the
reference's fields flattened to numpy by dotted name (``"materials.albedo"``,
``"lights.pos"``, ``"emissive.cdf"``, ...), so one scene can be rendered
by both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..ops.bsdf import MaterialTable, make_material_table
from ..ops.bvh import (
    PackedBVH,
    build_bvh,
    pack_bvh,
    pack_tri_rows,
    packed_bvh,
    permute_tri_array,
)
from ..ops.camera import CameraConfig, camera_from_raster, world_from_camera
from ..ops.distrib import Piecewise2D
from ..ops.envmap import EnvMap, constant_envmap, make_envmap
from ..ops.lights import (
    ALL_LIGHT_TYPES,
    POINT,
    SPOT,
    EmissiveTable,
    LightTable,
    area_light,
    make_emissive_table,
    make_light_table,
)
from ..ops.raysort import scene_bounds
from ..ops.shade_tables import pack_brute_tables, pack_shade_tables
from ..ops.texture import TexturePool, build_texture_pool, uv_density

# scenes at or above this many triangles get a BVH in the reference
BVH_THRESHOLD = 512

# scenes with at least this many finite light records get a light tree
LIGHT_TREE_THRESHOLD = 16


class Scene(NamedTuple):
    """Device scene."""

    tri_v0: torch.Tensor  # (T,3)
    tri_e0: torch.Tensor  # (T,3) p1 - p0
    tri_e1: torch.Tensor  # (T,3) p2 - p0
    tri_mat: torch.Tensor  # (T,) int32 material id
    materials: MaterialTable
    lights: LightTable  # finite lights (NEE targets)
    env: EnvMap  # constant environment
    cam_from_raster: torch.Tensor  # (4,4)
    world_from_cam: torch.Tensor  # (4,4)
    emissive: Optional[EmissiveTable] = None  # area-light triangle set
    bvh: Optional[PackedBVH] = None  # node tables; the tri_* arrays are
    # then in packed-BVH order
    shade_tables: Optional[torch.Tensor] = None  # (S,) f32 fused-kernel
    # shading tables (ops/shade_tables.pack_shade_tables)
    bounds: Optional[torch.Tensor] = None  # (2, 3) f32 [lo, hi] box of the
    # triangle rows (pads included) of a BVH scene: the ray sort's grid
    tri_rows: Optional[torch.Tensor] = None  # (Tp, 12) f32 [v0,0|e0,0|e1,0]
    # rows of a BVH scene, which the BVH kernels read (ops/bvh.pack_tri_rows)
    brute_tables: Optional[torch.Tensor] = None  # (T·12 + S,) f32 blob of a
    # brute-force scene that its fused kernel stages in shared memory: rows
    # [v0, mat | e0, 0 | e1, 0], then shade_tables (pack_brute_tables)
    textures: Optional[TexturePool] = None  # all textures' mip chains
    tri_uv: Optional[torch.Tensor] = None  # (T,3,2) per-corner UVs
    tri_uvdens: Optional[torch.Tensor] = None  # (T,) ‖duv/dp‖ for cone LOD
    tri_ns: Optional[torch.Tensor] = None  # (T,3,3) per-corner shading
    # normals; None = flat shading everywhere
    light_types: tuple = ALL_LIGHT_TYPES  # the light types the table
    # holds, known when the scene is built: the integrator runs only their
    # branches

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_lights(self) -> int:
        return self.lights.ltype.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device


def scene_to(scene: Scene, device) -> Scene:
    """The same scene with every tensor on ``device``."""
    device = torch.device(device)
    if scene.device == device:
        return scene

    def mv(x):
        if torch.is_tensor(x):
            return x.to(device)
        if hasattr(x, "_fields"):
            return type(x)(*(mv(f) for f in x))
        return x  # None, host arrays, ints

    return mv(scene)


@dataclass
class HostScene:
    """Mutable host-side scene under construction."""

    triangles: list = field(default_factory=list)  # (3,3) float arrays
    tri_mat: list = field(default_factory=list)
    tri_uv: list = field(default_factory=list)  # (3,2) per-corner UVs or None
    tri_ns: list = field(default_factory=list)  # (3,3) per-corner shading
    # normals or None (flat)
    materials: list = field(default_factory=list)  # bsdf factory dicts
    lights: list = field(default_factory=list)  # light factory dicts
    textures: list = field(default_factory=list)  # (H,W,3) linear images
    env_color: tuple = (0.0, 0.0, 0.0)
    env_image: object = None  # (H,W,3) radiance array; overrides env_color
    env_rotation: object = None  # (3,3)
    camera: CameraConfig = field(default_factory=CameraConfig)

    def add_model(self, tris: Sequence, mat_id: int, uvs=None, normals=None):
        for i, t in enumerate(tris):
            self.triangles.append(np.asarray(t, np.float32))
            self.tri_mat.append(mat_id)
            self.tri_uv.append(None if uvs is None else np.asarray(uvs[i], np.float32))
            self.tri_ns.append(None if normals is None else np.asarray(normals[i], np.float32))

    def add_material(self, mat: dict) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_texture(self, image) -> int:
        """Register a linear-RGB image → its texture id."""
        self.textures.append(np.asarray(image, np.float32))
        return len(self.textures) - 1

    def add_light(self, light: dict):
        self.lights.append(light)


def scene_from_host(
    hs: HostScene,
    use_bvh: Optional[bool] = None,
    use_light_tree: Optional[bool] = None,
    device="cuda",
) -> Scene:
    """Device scene from a HostScene: emissive materials become one AREA
    light row over an emissive-triangle table; scenes with
    ``BVH_THRESHOLD`` triangles or more (or ``use_bvh=True``) get a BVH
    and packed-BVH triangle order. Textures become one mip pool, with
    per-corner UVs (box-mapped where a triangle has none) and their
    ‖duv/dp‖ densities; authored normals become per-corner shading normals
    (flat face normals where a triangle has none)."""
    device = resolve_device(device)
    tris = np.stack(hs.triangles).astype(np.float32)  # (T,3,3)
    v0 = tris[:, 0]
    e0 = tris[:, 1] - tris[:, 0]
    e1 = tris[:, 2] - tris[:, 0]
    tri_mat = np.asarray(hs.tri_mat, np.int32)
    if hs.env_image is not None:
        env = make_envmap(hs.env_image, hs.env_rotation, device=device)
    else:
        env = constant_envmap(hs.env_color, device)

    lights = list(hs.lights)
    emission_by_mat = np.stack(
        [
            np.broadcast_to(
                np.asarray(m.get("emission", (0.0,) * 3), np.float32), (3,)
            )
            for m in hs.materials
        ]
    ) if hs.materials else np.zeros((0, 3), np.float32)
    emissive = None
    n_emissive = 0
    if len(emission_by_mat) and emission_by_mat.max() > 0:
        em_mask = emission_by_mat[tri_mat].max(axis=1) > 0
        if em_mask.any():
            emissive = make_emissive_table(
                v0[em_mask], e0[em_mask], e1[em_mask],
                emission_by_mat[tri_mat[em_mask]], device=device,
            )
            n_emissive = int(em_mask.sum())
            lights = lights + [area_light()]
    # NEE needs at least one light row; a zero-intensity point light is a
    # no-op filler
    if not lights:
        lights = [dict(ltype=POINT, color=(0.0, 0.0, 0.0))]

    n_finite = (
        sum(1 for li in lights if li.get("ltype", POINT) in (POINT, SPOT))
        + n_emissive
    )
    if use_light_tree if use_light_tree is not None else n_finite >= LIGHT_TREE_THRESHOLD:
        raise NotImplementedError(
            f"{n_finite} finite lights need a light tree, which is not "
            "ported yet (slice 5b: light tree and instancing); pass "
            "use_light_tree=False for uniform selection"
        )

    tri_uv = None
    if hs.textures:
        uv_rows = list(hs.tri_uv) + [None] * (len(tris) - len(hs.tri_uv))
        tri_uv = np.stack(
            [uv if uv is not None else box_map_uv(tris[i]) for i, uv in enumerate(uv_rows)]
        ).astype(np.float32)  # (T,3,2)
    tri_ns = None
    ns_rows = list(hs.tri_ns) + [None] * (len(tris) - len(hs.tri_ns))
    if any(n is not None for n in ns_rows):
        face_n = np.cross(e0, e1)
        face_n = face_n / np.maximum(np.linalg.norm(face_n, axis=1, keepdims=True), 1e-20)
        tri_ns = np.stack(
            [
                np.asarray(n, np.float32) if n is not None else np.broadcast_to(face_n[i], (3, 3))
                for i, n in enumerate(ns_rows)
            ]
        ).astype(np.float32)  # (T,3,3)

    bvh = None
    if use_bvh if use_bvh is not None else len(tris) >= BVH_THRESHOLD:
        bvh = pack_bvh(build_bvh(v0, e0, e1), device)
        v0, e0, e1, tri_mat = (permute_tri_array(a, bvh.perm) for a in (v0, e0, e1, tri_mat))
        if tri_uv is not None:
            tri_uv = permute_tri_array(tri_uv, bvh.perm)
        if tri_ns is not None:
            tri_ns = permute_tri_array(tri_ns, bvh.perm)

    cam = hs.camera
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    tv0, te0, te1 = t(v0), t(e0), t(e1)
    tuv = None if tri_uv is None else t(tri_uv)
    return with_kernel_tables(Scene(
        tri_v0=tv0,
        tri_e0=te0,
        tri_e1=te1,
        tri_mat=t(tri_mat),
        materials=make_material_table(hs.materials, device),
        lights=make_light_table(lights, device),
        env=env,
        cam_from_raster=t(
            camera_from_raster(
                cam.focal_length_mm, cam.sensor_height_mm, cam.width, cam.height
            )
        ),
        world_from_cam=t(world_from_camera(cam.direction, cam.position)),
        emissive=emissive,
        bvh=bvh,
        tri_rows=None if bvh is None else pack_tri_rows(tv0, te0, te1),
        textures=build_texture_pool(hs.textures, device) if hs.textures else None,
        tri_uv=tuv,
        tri_uvdens=None if tuv is None else uv_density(tuv, te0, te1),
        tri_ns=None if tri_ns is None else t(tri_ns),
        light_types=tuple(sorted({int(li.get("ltype", POINT)) for li in lights})),
    ))


def box_map_uv(tri: np.ndarray) -> np.ndarray:
    """UVs of a triangle without authored ones: its corners projected onto
    the plane of its normal's dominant axis (one world unit per UV tile)."""
    e0 = tri[1] - tri[0]
    e1 = tri[2] - tri[0]
    axis = int(np.argmax(np.abs(np.cross(e0, e1))))
    keep = [i for i in range(3) if i != axis]
    return tri[:, keep].astype(np.float32)


def with_kernel_tables(scene: Scene) -> Scene:
    """``scene`` with the tables its kernels and queries read, built once
    per scene so that no launch builds them: the fused kernels' shading
    tables, a BVH scene's ``bounds``, and a brute-force scene's blob for its
    fused kernel. (A BVH scene's compact nodes and triangle rows are built
    with its ``bvh`` and ``tri_*`` arrays.)"""
    shade = pack_shade_tables(scene.materials, scene.lights, scene.env, scene.emissive)
    if scene.bvh is not None:
        bounds = torch.stack(scene_bounds(scene.tri_v0, scene.tri_e0, scene.tri_e1))
        return scene._replace(shade_tables=shade, bounds=bounds)
    brute = pack_brute_tables(scene.tri_v0, scene.tri_e0, scene.tri_e1, scene.tri_mat, shade)
    return scene._replace(shade_tables=shade, brute_tables=brute)


# reference Scene fields outside this slice, and the slice that ports them
_LATER = {
    "light_tree": "slice 5b: light tree",
    "tri_emrec": "slice 5b: light tree",
    "instances": "slice 5b: instancing",
}

_INT_FIELDS = {"mtype", "ltype", "albedo_tex", "rough_tex", "normal_tex"}


def scene_from_arrays(fields: dict, device) -> Scene:
    """Port's Scene from a reference Scene flattened to numpy by dotted
    field name. Fields of features outside this slice raise."""
    device = resolve_device(device)
    for key in fields:
        top = key.split(".")[0]
        if top in _LATER:
            raise NotImplementedError(
                f"scene field {key!r} is not ported yet ({_LATER[top]})"
            )
    f = {k: np.asarray(v) for k, v in fields.items()}

    def t(a, dt=np.float32):
        return torch.as_tensor(np.array(a, dt), device=device)

    def table(cls, prefix):
        return cls(*(
            t(f[f"{prefix}.{name}"], np.int32 if name in _INT_FIELDS else np.float32)
            for name in cls._fields
        ))

    emissive = table(EmissiveTable, "emissive") if "emissive.v0" in f else None
    bvh = None
    if "bvh.meta" in f:
        bvh = packed_bvh(t(f["bvh.box"]), t(f["bvh.meta"], np.int32), f["bvh.perm"])
    textures = None
    if "textures.texels" in f:
        textures = TexturePool(
            t(f["textures.texels"]),
            *(t(f[f"textures.{name}"], np.int32) for name in TexturePool._fields[1:]),
        )
    image = f["env.image"].astype(np.float32)
    flat = image.reshape(-1, 3)
    env = EnvMap(
        t(image), table(Piecewise2D, "env.dist"), t(f["env.rotation"]), t(f["env.scale"]),
        uniform=bool(np.all(flat == flat[0])),
    )
    opt = lambda key: t(f[key]) if key in f else None  # noqa: E731
    tv0, te0, te1 = t(f["tri_v0"]), t(f["tri_e0"]), t(f["tri_e1"])
    return with_kernel_tables(Scene(
        tri_v0=tv0,
        tri_e0=te0,
        tri_e1=te1,
        tri_mat=t(f["tri_mat"], np.int32),
        materials=table(MaterialTable, "materials"),
        lights=table(LightTable, "lights"),
        env=env,
        cam_from_raster=t(f["cam_from_raster"]),
        world_from_cam=t(f["world_from_cam"]),
        emissive=emissive,
        bvh=bvh,
        tri_rows=None if bvh is None else pack_tri_rows(tv0, te0, te1),
        textures=textures,
        tri_uv=opt("tri_uv"),
        tri_uvdens=opt("tri_uvdens"),
        tri_ns=opt("tri_ns"),
        light_types=tuple(sorted(set(f["lights.ltype"].astype(np.int64).tolist()))),
    ))
