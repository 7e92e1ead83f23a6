"""Flat SoA scene (counterpart of the reference ``scene/types.py``):
triangles as (v0, e0, e1) SoA, material/light tables and the camera
transforms, as tensors on one device.

Scenes at or above ``BVH_THRESHOLD`` triangles (or with ``use_bvh=True``)
get an 8-wide BVH: the triangle arrays are then in packed-BVH order
(leaf-major, padded with zero-edge rows; the UV and normal arrays
follow) and ``bvh`` holds the node tables the traversal kernels read.
Textures live in one mip pool (``ops/texture.py``); an environment image
gets its sampling distribution (``ops/envmap.py``). Scenes with
``LIGHT_TREE_THRESHOLD`` finite light records or more (or
``use_light_tree=True``) get a light tree over them (``ops/light_tree.py``)
and ``tri_emrec``, each triangle's record. Instanced scenes carry an
``InstanceTable``: affine placements of base meshes, each mesh held once
(``MeshTables``), the renderable geometry their union.

Every table a kernel or a query reads is built here, once per scene: the
BVH node tables (the reference's layout, and the compact copy with its
triangle rows that the BVH kernels walk), ``bounds`` (the packed rows'
box, which the ray sort of BVH queries quantises origins in),
``shade_tables``, the fused kernels' packed shading tables, and a
brute-force scene's ``brute_tables``, its fused kernel's whole
shared-memory blob, and each distinct instance mesh's rows.

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
from ..ops.light_tree import LightTree, build_light_tree, light_tree_from_arrays
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
    light_tree: Optional[LightTree] = None  # many-lights tree over the
    # finite rows and the emissive triangles
    tri_emrec: Optional[torch.Tensor] = None  # (T,) int32 light-tree
    # record of each emissive triangle, −1 elsewhere, in the triangle
    # arrays' order: tree-pmf MIS on directly hit emitters
    instances: Optional["InstanceTable"] = None  # when present, the
    # triangle arrays hold each base mesh once, in object space, and the
    # renderable geometry is the union of the placed meshes: queries run
    # per instance on object-space rays over that mesh's own tables

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_lights(self) -> int:
        return self.lights.ltype.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device


class MeshTables(NamedTuple):
    """One base mesh's intersection tables, in its own (packed-BVH) order:
    what the kernels read for an instance of it. ``tri_rows`` are
    ``(Tp, 12)`` rows ``[v0,0|e0,0|e1,0]``: the traversal kernels' rows for
    a BVH mesh, the brute-force kernels' 48 B rows otherwise. A Scene
    carries the same fields for its own triangles, so the kernel wrappers
    take either."""

    tri_v0: torch.Tensor  # (Tp,3)
    tri_e0: torch.Tensor  # (Tp,3)
    tri_e1: torch.Tensor  # (Tp,3)
    bvh: Optional[PackedBVH] = None
    tri_rows: Optional[torch.Tensor] = None  # (Tp, 12), with_kernel_tables


class InstanceTable(NamedTuple):
    """Affine placements of base meshes: instance ``k`` places
    ``meshes[k]`` (instances of one mesh share one ``MeshTables``) by
    ``world_from_obj[k]``. ``tstart[k]`` is the offset of the mesh's
    (padded) rows in the scene's concatenated triangle arrays, so a local
    row plus it gathers ``tri_mat``. ``bounds_lo/hi`` are the instances'
    world boxes, a one-level culling step: a ray that misses box ``k``
    skips that instance; None skips the test."""

    world_from_obj: torch.Tensor  # (I, 3, 4) affine [R|t]
    obj_from_world: torch.Tensor  # (I, 3, 4) its inverse
    bounds_lo: Optional[torch.Tensor]  # (I, 3) world boxes
    bounds_hi: Optional[torch.Tensor]  # (I, 3)
    tstart: torch.Tensor  # (I,) int64
    meshes: tuple  # (I,) MeshTables

    @property
    def count(self) -> int:
        return self.world_from_obj.shape[0]


def _world_bounds(lo, hi, mats):
    """Object box (lo, hi) × (I, 4, 4) affines → (I, 3) world lo, hi."""
    corners = np.array(
        [[(lo, hi)[ix][0], (lo, hi)[iy][1], (lo, hi)[iz][2]]
         for ix in (0, 1) for iy in (0, 1) for iz in (0, 1)],
        np.float32,
    )  # (8, 3)
    wc = np.einsum("kij,cj->kci", mats[:, :3, :3], corners) + mats[:, None, :3, 3]
    return wc.min(axis=1), wc.max(axis=1)


def make_instance_table(transforms, meshes, tstart=None, bounds=None, device="cpu") -> InstanceTable:
    """(I, 4, 4) world-from-object matrices, each instance's MeshTables,
    their row offsets (default 0) and world boxes (default: none, every
    ray tests every instance) → InstanceTable on ``device``."""
    mats = np.asarray(transforms, np.float32).reshape(-1, 4, 4)
    inv = np.stack([np.linalg.inv(m) for m in mats]).astype(np.float32)
    i = mats.shape[0]
    t = lambda a, dt=np.float32: torch.as_tensor(np.asarray(a, dt), device=device)  # noqa: E731
    return InstanceTable(
        world_from_obj=t(mats[:, :3, :]),
        obj_from_world=t(inv[:, :3, :]),
        bounds_lo=None if bounds is None else t(bounds[0]),
        bounds_hi=None if bounds is None else t(bounds[1]),
        tstart=t(np.zeros(i) if tstart is None else tstart, np.int64),
        meshes=tuple(meshes),
    )


def scene_to(scene: Scene, device) -> Scene:
    """The same scene with every tensor on ``device``; tables that
    instances share stay shared."""
    device = torch.device(device)
    if scene.device == device:
        return scene
    memo = {}

    def mv(x):
        if not (torch.is_tensor(x) or isinstance(x, tuple)):
            return x  # None, host arrays, ints
        if id(x) not in memo:
            if torch.is_tensor(x):
                memo[id(x)] = x.to(device)
            elif hasattr(x, "_fields"):
                memo[id(x)] = type(x)(*(mv(f) for f in x))
            else:
                memo[id(x)] = tuple(mv(f) for f in x)
        return memo[id(x)]

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
    instance_transforms: object = None  # (I, 4, 4) world-from-object
    # placements of the one mesh in ``triangles`` (Scene.instances); no
    # emissive materials, no light tree
    instance_groups: list = field(default_factory=list)  # base meshes,
    # each {"tris": (T,3,3), "mat": int, "transforms": (K,4,4)} placed K
    # times; ``triangles`` then stand as one identity instance. No
    # emissive materials, textures or authored normals (_scene_from_host_grouped)

    def add_instance_group(self, tris, mat_id: int, transforms):
        """Register a base mesh placed under K affine transforms."""
        self.instance_groups.append(dict(
            tris=np.asarray(tris, np.float32),
            mat=int(mat_id),
            transforms=np.asarray(transforms, np.float32).reshape(-1, 4, 4),
        ))

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
    (flat face normals where a triangle has none). Scenes with
    ``LIGHT_TREE_THRESHOLD`` finite light records or more (or
    ``use_light_tree=True``) get a light tree. ``hs.instance_transforms``
    places the one mesh several times; ``hs.instance_groups`` build a
    multi-mesh instanced scene (``_scene_from_host_grouped``)."""
    device = resolve_device(device)
    if hs.instance_groups:
        return _scene_from_host_grouped(hs, use_bvh, device)
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
    em_idx_of_tri = np.full((len(tris),), -1, np.int32)
    if len(emission_by_mat) and emission_by_mat.max() > 0:
        em_mask = emission_by_mat[tri_mat].max(axis=1) > 0
        if em_mask.any():
            emissive = make_emissive_table(
                v0[em_mask], e0[em_mask], e1[em_mask],
                emission_by_mat[tri_mat[em_mask]], device=device,
            )
            n_emissive = int(em_mask.sum())
            em_idx_of_tri[em_mask] = np.arange(n_emissive, dtype=np.int32)
            lights = lights + [area_light()]
    # NEE needs at least one light row; a zero-intensity point light is a
    # no-op filler
    if not lights:
        lights = [dict(ltype=POINT, color=(0.0, 0.0, 0.0))]
    light_table = make_light_table(lights, device)

    # the light tree over the finite records (point/spot rows and emissive
    # triangles), counted from the host dicts
    n_finite = (
        sum(1 for li in lights if li.get("ltype", POINT) in (POINT, SPOT))
        + n_emissive
    )
    light_tree = tri_emrec = None
    if use_light_tree if use_light_tree is not None else n_finite >= LIGHT_TREE_THRESHOLD:
        light_tree, emissive_rec = build_light_tree(light_table, emissive, device)
        if light_tree is not None and n_emissive:
            tri_emrec = np.where(
                em_idx_of_tri >= 0, emissive_rec[np.maximum(em_idx_of_tri, 0)], -1
            ).astype(np.int32)

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
        if tri_emrec is not None:
            tri_emrec = permute_tri_array(tri_emrec, bvh.perm, pad_value=-1)
        if tri_uv is not None:
            tri_uv = permute_tri_array(tri_uv, bvh.perm)
        if tri_ns is not None:
            tri_ns = permute_tri_array(tri_ns, bvh.perm)

    cam = hs.camera
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    tv0, te0, te1 = t(v0), t(e0), t(e1)
    tuv = None if tri_uv is None else t(tri_uv)
    tri_rows = None if bvh is None else pack_tri_rows(tv0, te0, te1)

    instances = None
    if hs.instance_transforms is not None:
        if emissive is not None or light_tree is not None:
            raise ValueError(
                "instanced scenes do not support emissive geometry / "
                "light trees (bake the transforms instead)"
            )
        mats4 = np.asarray(hs.instance_transforms, np.float32).reshape(-1, 4, 4)
        pts = tris.reshape(-1, 3)  # the host triangles, no pad rows
        mesh = MeshTables(tv0, te0, te1, bvh, tri_rows)
        instances = make_instance_table(
            mats4, [mesh] * mats4.shape[0],
            bounds=_world_bounds(pts.min(0), pts.max(0), mats4), device=device,
        )

    return with_kernel_tables(Scene(
        tri_v0=tv0,
        tri_e0=te0,
        tri_e1=te1,
        tri_mat=t(tri_mat),
        materials=make_material_table(hs.materials, device),
        lights=light_table,
        env=env,
        cam_from_raster=t(
            camera_from_raster(
                cam.focal_length_mm, cam.sensor_height_mm, cam.width, cam.height
            )
        ),
        world_from_cam=t(world_from_camera(cam.direction, cam.position)),
        emissive=emissive,
        bvh=bvh,
        tri_rows=tri_rows,
        textures=build_texture_pool(hs.textures, device) if hs.textures else None,
        tri_uv=tuv,
        tri_uvdens=None if tuv is None else uv_density(tuv, te0, te1),
        tri_ns=None if tri_ns is None else t(tri_ns),
        light_types=tuple(sorted({int(li.get("ltype", POINT)) for li in lights})),
        light_tree=light_tree,
        tri_emrec=None if tri_emrec is None else t(tri_emrec),
        instances=instances,
    ))


def _scene_from_host_grouped(hs: HostScene, use_bvh, device) -> Scene:
    """Multi-mesh instanced scene: each of ``hs.instance_groups``' meshes,
    and the baked ``hs.triangles`` as an identity instance, in its own
    packed-BVH order (every mesh gets a BVH when the meshes hold
    ``BVH_THRESHOLD`` triangles in all, or ``use_bvh=True``), concatenated
    into the scene's triangle arrays; the InstanceTable carries each
    instance's mesh tables (shared by the instances of one mesh), row
    offset and world box.

    Refused: emissive materials (NEE would sample object-space geometry),
    textures and authored normals on any mesh; no light tree is built."""
    if hs.textures:
        raise ValueError("instance groups do not support textured scenes")
    if any(n is not None for n in hs.tri_ns):
        raise ValueError("instance groups do not support authored normals")
    used_mats = set(np.asarray(hs.tri_mat, np.int64).tolist()) | {
        g["mat"] for g in hs.instance_groups
    }
    for mi in used_mats:
        if np.asarray(hs.materials[mi].get("emission", (0.0,) * 3), np.float32).max() > 0:
            raise ValueError(
                "instanced scenes do not support emissive geometry / "
                "light trees (bake the transforms instead)"
            )

    meshes = []  # (tris (T,3,3), material ids (T,))
    inst = []  # (mesh index, (4,4))
    if hs.triangles:
        meshes.append((np.stack(hs.triangles).astype(np.float32), np.asarray(hs.tri_mat, np.int32)))
        inst.append((0, np.eye(4, dtype=np.float32)))
    for g in hs.instance_groups:
        gt = np.asarray(g["tris"], np.float32)
        for m4 in np.asarray(g["transforms"], np.float32).reshape(-1, 4, 4):
            inst.append((len(meshes), m4))
        meshes.append((gt, np.full(len(gt), g["mat"], np.int32)))

    total = sum(len(tris) for tris, _ in meshes)
    build = use_bvh if use_bvh is not None else total >= BVH_THRESHOLD
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    tables, tstarts, obj_bounds, g_mat = [], [], [], []
    off = 0
    for tris, mat_ids in meshes:
        v0 = tris[:, 0]
        e0 = tris[:, 1] - tris[:, 0]
        e1 = tris[:, 2] - tris[:, 0]
        bvh = None
        if build:
            bvh = pack_bvh(build_bvh(v0, e0, e1), device)
            v0, e0, e1, mat_ids = (permute_tri_array(a, bvh.perm) for a in (v0, e0, e1, mat_ids))
        tables.append(MeshTables(t(v0), t(e0), t(e1), bvh))
        tstarts.append(off)
        off += len(v0)
        pts = tris.reshape(-1, 3)
        obj_bounds.append((pts.min(0), pts.max(0)))
        g_mat.append(mat_ids)

    mats4 = np.stack([m for _, m in inst])
    mesh_ids = [mi for mi, _ in inst]
    blo = np.zeros((len(inst), 3), np.float32)
    bhi = np.zeros((len(inst), 3), np.float32)
    for k, mi in enumerate(mesh_ids):
        lo_k, hi_k = _world_bounds(obj_bounds[mi][0], obj_bounds[mi][1], mats4[k:k + 1])
        blo[k], bhi[k] = lo_k[0], hi_k[0]
    instances = make_instance_table(
        mats4, [tables[mi] for mi in mesh_ids],
        tstart=[tstarts[mi] for mi in mesh_ids], bounds=(blo, bhi), device=device,
    )

    lights = list(hs.lights) or [dict(ltype=POINT, color=(0.0, 0.0, 0.0))]
    if hs.env_image is not None:
        env = make_envmap(hs.env_image, hs.env_rotation, device=device)
    else:
        env = constant_envmap(hs.env_color, device)
    cam = hs.camera
    return with_kernel_tables(Scene(
        tri_v0=torch.cat([m.tri_v0 for m in tables]),
        tri_e0=torch.cat([m.tri_e0 for m in tables]),
        tri_e1=torch.cat([m.tri_e1 for m in tables]),
        tri_mat=t(np.concatenate(g_mat).astype(np.int32)),
        materials=make_material_table(hs.materials, device),
        lights=make_light_table(lights, device),
        env=env,
        cam_from_raster=t(
            camera_from_raster(cam.focal_length_mm, cam.sensor_height_mm, cam.width, cam.height)
        ),
        world_from_cam=t(world_from_camera(cam.direction, cam.position)),
        light_types=tuple(sorted({int(li.get("ltype", POINT)) for li in lights})),
        instances=instances,
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
    with its ``bvh`` and ``tri_*`` arrays.) An instanced scene instead gets
    each distinct mesh's rows (instances of a mesh share them) and, as
    ``bounds``, the box of its instances' world boxes, the ray sort's grid."""
    shade = pack_shade_tables(scene.materials, scene.lights, scene.env, scene.emissive)
    if scene.instances is not None:
        inst = scene.instances
        built = {}
        for m in inst.meshes:
            if id(m) not in built:
                rows = m.tri_rows
                if rows is None:
                    rows = pack_tri_rows(m.tri_v0, m.tri_e0, m.tri_e1)
                built[id(m)] = m._replace(tri_rows=rows)
        inst = inst._replace(meshes=tuple(built[id(m)] for m in inst.meshes))
        if inst.bounds_lo is not None:
            bounds = torch.stack([inst.bounds_lo.amin(0), inst.bounds_hi.amax(0)])
        else:
            bounds = torch.stack(scene_bounds(scene.tri_v0, scene.tri_e0, scene.tri_e1))
        return scene._replace(shade_tables=shade, bounds=bounds, instances=inst)
    if scene.bvh is not None:
        bounds = torch.stack(scene_bounds(scene.tri_v0, scene.tri_e0, scene.tri_e1))
        return scene._replace(shade_tables=shade, bounds=bounds)
    brute = pack_brute_tables(scene.tri_v0, scene.tri_e0, scene.tri_e1, scene.tri_mat, shade)
    return scene._replace(shade_tables=shade, brute_tables=brute)


_INT_FIELDS = {"mtype", "ltype", "albedo_tex", "rough_tex", "normal_tex"}


def _pad_perm(v0, e0, e1) -> np.ndarray:
    """The packed-BVH permutation's real/pad split of a mesh whose
    permutation was not carried over: pad rows are all zeros."""
    pad = ~(np.any(v0 != 0, 1) | np.any(e0 != 0, 1) | np.any(e1 != 0, 1))
    return np.where(pad, -1, np.arange(len(v0))).astype(np.int32)


def scene_from_arrays(fields: dict, device) -> Scene:
    """Port's Scene from a reference Scene flattened to numpy by dotted
    field name. The light tree comes as ``light_tree.<field>`` (its host
    int ``n_infinite`` among them); instance ``k``'s mesh tables as
    ``instances.meshes.<k>.v0/e0/e1`` and, for a BVH mesh,
    ``.box/.meta``: instances of one mesh (the same ``tstart``) share one
    MeshTables."""
    device = resolve_device(device)
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
    light_tree = None
    if "light_tree.feat" in f:
        light_tree = light_tree_from_arrays(
            *(f[f"light_tree.{name}"] for name in (
                "feat", "rec_kind", "rec_idx", "trail", "trail_len", "rec_energy",
                "infinite_rows", "n_infinite")),
            device=device,
        )
    instances = None
    if "instances.tstart" in f:
        tstart = f["instances.tstart"].astype(np.int64)
        by_start = {}
        for k, start in enumerate(tstart.tolist()):
            if start not in by_start:
                v0, e0, e1 = (f[f"instances.meshes.{k}.{n}"].astype(np.float32)
                              for n in ("v0", "e0", "e1"))
                mesh_bvh = None
                if f"instances.meshes.{k}.meta" in f:
                    mesh_bvh = packed_bvh(t(f[f"instances.meshes.{k}.box"]),
                                          t(f[f"instances.meshes.{k}.meta"], np.int32),
                                          _pad_perm(v0, e0, e1))
                by_start[start] = MeshTables(t(v0), t(e0), t(e1), mesh_bvh)
        w = f["instances.world_from_obj"].astype(np.float32)
        instances = InstanceTable(
            world_from_obj=t(w),
            obj_from_world=t(f["instances.obj_from_world"]),
            bounds_lo=t(f["instances.bounds_lo"]),
            bounds_hi=t(f["instances.bounds_hi"]),
            tstart=t(tstart, np.int64),
            meshes=tuple(by_start[s] for s in tstart.tolist()),
        )
    image = f["env.image"].astype(np.float32)
    flat = image.reshape(-1, 3)
    env = EnvMap(
        t(image), table(Piecewise2D, "env.dist"), t(f["env.rotation"]), t(f["env.scale"]),
        uniform=bool(np.all(flat == flat[0])),
    )
    opt = lambda key, dt=np.float32: t(f[key], dt) if key in f else None  # noqa: E731
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
        light_tree=light_tree,
        tri_emrec=opt("tri_emrec", np.int32),
        instances=instances,
    ))
