"""The port's instancing (``Scene.instances``) against the JAX reference:
the instance tables and per-mesh tables field for field, renders of
single- and multi-mesh instanced scenes at the parity bar, the carry-over
of instanced and tree scenes through ``scene_from_arrays``; then the
reference's own instancing tests (``tests/test_instancing.py``) on the
port's API. The scenes are built outside any caching, each package from
its own host scene."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu.models.megakernel import MegakernelConfig as JCfg
from cuda_optix_pathtracing_tpu.models.megakernel import render_sample_batch as j_render_batch
from cuda_optix_pathtracing_tpu.ops import bsdf as JB
from cuda_optix_pathtracing_tpu.ops import lights as JL
from cuda_optix_pathtracing_tpu.ops.camera import CameraConfig as JCam
from cuda_optix_pathtracing_tpu.scene import parser as jparser
from cuda_optix_pathtracing_tpu.scene.types import HostScene as JHost
from cuda_optix_pathtracing_tpu.scene.types import scene_from_host as j_from_host
from cuda_optix_pathtracing_tpu_torch.models.megakernel import (
    MegakernelConfig,
    render_sample_batch,
    resolve_fused,
)
from cuda_optix_pathtracing_tpu_torch.models.megakernel_cuda import megakernel_cuda_supported
from cuda_optix_pathtracing_tpu_torch.native import transform_tris
from cuda_optix_pathtracing_tpu_torch.ops import bsdf as TB
from cuda_optix_pathtracing_tpu_torch.ops import lights as TL
from cuda_optix_pathtracing_tpu_torch.ops.camera import CameraConfig as TCam
from cuda_optix_pathtracing_tpu_torch.scene import parser as tparser
from cuda_optix_pathtracing_tpu_torch.scene.procedural import generate_sphere
from cuda_optix_pathtracing_tpu_torch.scene.types import HostScene as THost
from cuda_optix_pathtracing_tpu_torch.scene.types import (
    make_instance_table,
    scene_from_arrays,
    scene_to,
)
from cuda_optix_pathtracing_tpu_torch.scene.types import scene_from_host as t_from_host

torch.set_num_threads(2)

CFG = dict(remat=False, pixel_order="linear")
MESH_FIELDS = ("v0", "e0", "e1", "box", "meta")


def _grid_transforms(n_side=4, spacing=1.2, z=0.0):
    mats = []
    for i in range(n_side):
        for j in range(n_side):
            m = np.eye(4, dtype=np.float32)
            m[0, 3] = (i - (n_side - 1) / 2.0) * spacing
            m[1, 3] = 3.0 + j * spacing
            m[2, 3] = z
            mats.append(m)
    return np.stack(mats)


def _sixteen(host_cls, bsdf, lights, cam_cls, instanced: bool):
    """Sixteen spheres on a grid: one mesh placed 16 times, or baked."""
    tris = np.stack(generate_sphere((0.0, 0.0, 0.0), 0.45, 6, 12))
    mats = _grid_transforms()
    hs = host_cls()
    hs.camera = cam_cls(width=32, height=32)
    if instanced:
        hs.add_model(list(tris), 0)
        hs.instance_transforms = mats
    else:
        for m in mats:
            hs.add_model(list(transform_tris(tris, m)), 0)
    hs.materials = [bsdf.oren_nayar((0.8, 0.6, 0.4), 0.4)]
    hs.lights = [lights.point_light((40.0, 40.0, 40.0), (0.0, 1.0, 3.0), 1e-3)]
    return hs


_TET = np.array(
    [
        [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
        [[0, 0, 0], [1, 0, 0], [0, 0, 1]],
        [[0, 0, 0], [0, 1, 0], [0, 0, 1]],
        [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
    ],
    np.float32,
)
_FLOOR = np.array(
    [
        [[-4, -0.6, -4], [4, -0.6, -4], [4, -0.6, 6]],
        [[-4, -0.6, -4], [4, -0.6, 6], [-4, -0.6, 6]],
    ],
    np.float32,
)


def _mats_at(positions, scale=1.0):
    out = []
    for p in positions:
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] *= scale
        m[:3, 3] = p
        out.append(m)
    return np.stack(out)


SPH_MATS = _mats_at([(-1.2, 2.6, 0), (1.2, 2.6, 0), (0, 3.8, 0)])
TET_MATS = _mats_at([(-1.5, 1.2, 0.5), (1.0, 1.2, 0.5)], scale=0.8)


def _groups(host_cls, bsdf, lights, cam_cls, grouped: bool):
    """Two base meshes (a sphere ×3, a tetrahedron ×2) and a baked floor,
    or everything baked."""
    sph = np.stack(generate_sphere((0.0, 0.0, 0.0), 0.5, 6, 12))
    hs = host_cls()
    hs.camera = cam_cls(width=24, height=24)
    hs.materials = [
        bsdf.oren_nayar((0.8, 0.6, 0.4), 0.4),
        bsdf.oren_nayar((0.4, 0.6, 0.8), 0.2),
        bsdf.oren_nayar((0.7, 0.7, 0.7), 0.5),
    ]
    hs.lights = [lights.point_light((40.0, 40.0, 40.0), (0.0, 1.0, 3.0), 1e-3)]
    hs.add_model(list(_FLOOR), 2)
    if grouped:
        hs.add_instance_group(sph, 0, SPH_MATS)
        hs.add_instance_group(_TET, 1, TET_MATS)
    else:
        for m in SPH_MATS:
            hs.add_model(list(transform_tris(sph, m)), 0)
        for m in TET_MATS:
            hs.add_model(list(transform_tris(_TET, m)), 1)
    return hs


SCENE_KINDS = {"single": (_sixteen, 32), "groups": (_groups, 24)}


def _pair(kind, use_bvh=True):
    build, _ = SCENE_KINDS[kind]
    j = j_from_host(build(JHost, JB, JL, JCam, True), use_bvh=use_bvh)
    t = t_from_host(build(THost, TB, TL, TCam, True), use_bvh=use_bvh, device="cpu")
    return j, t


@pytest.fixture(scope="module")
def pairs():
    return {kind: _pair(kind) for kind in SCENE_KINDS}


@pytest.mark.parametrize("kind", list(SCENE_KINDS))
def test_instance_table_equals_reference(pairs, kind):
    """The instance table (affines, world boxes, row offsets), every
    instance's mesh tables and the concatenated arrays equal the
    reference's; instances of one mesh share one MeshTables."""
    j_scene, t_scene = pairs[kind]
    ji, ti = j_scene.instances, t_scene.instances
    for name in ("world_from_obj", "obj_from_world", "bounds_lo", "bounds_hi", "tstart"):
        np.testing.assert_array_equal(getattr(ti, name).numpy(), np.asarray(getattr(ji, name)),
                                      err_msg=name)
    for name in ("tri_v0", "tri_e0", "tri_e1", "tri_mat"):
        np.testing.assert_array_equal(getattr(t_scene, name).numpy(),
                                      np.asarray(getattr(j_scene, name)), err_msg=name)
    for k, (jm, tm) in enumerate(zip(ji.meshes, ti.meshes)):
        for name, ref in zip(MESH_FIELDS, jm):
            ours = {"v0": tm.tri_v0, "e0": tm.tri_e0, "e1": tm.tri_e1,
                    "box": tm.bvh.box, "meta": tm.bvh.meta}[name]
            np.testing.assert_array_equal(ours.numpy(), np.asarray(ref), err_msg=f"{k}.{name}")
        np.testing.assert_array_equal(tm.tri_rows[:, [0, 1, 2, 4, 5, 6, 8, 9, 10]].numpy(),
                                      torch.cat([tm.tri_v0, tm.tri_e0, tm.tri_e1], 1).numpy())
    starts = ti.tstart.tolist()
    for a in range(ti.count):
        for b in range(ti.count):
            assert (ti.meshes[a] is ti.meshes[b]) == (starts[a] == starts[b])
    assert t_scene.bounds.shape == (2, 3)


@pytest.mark.parametrize("kind", list(SCENE_KINDS))
def test_instanced_render_matches_reference(pairs, kind):
    """The port's instanced render against JAX's XLA integrator at depth 2,
    one sample, to the parity bar."""
    j_scene, t_scene = pairs[kind]
    size = SCENE_KINDS[kind][1]
    jcfg = JCfg(max_depth=2, backend="xla", **CFG)
    # the scene is the jitted function's argument, not a constant it folds
    ref = np.asarray(jax.jit(lambda s: j_render_batch(s, jcfg, size, size, jnp.uint32(0)))(j_scene))
    ours = render_sample_batch(t_scene, MegakernelConfig(max_depth=2, **CFG), size, size,
                               0).numpy()
    diff = np.abs(ref - ours)
    assert np.isfinite(ours).all() and ours.max() > 0.01
    assert diff.mean() < 1e-4, diff.mean()
    assert (diff.max(-1) > 1e-3).mean() < 0.005


def _flatten(obj, prefix=""):
    """Reference Scene → {dotted name: numpy array}: NamedTuples and the
    light tree's dataclass by field (its host int ``n_infinite`` too), the
    instance meshes as ``instances.meshes.<k>.<v0|e0|e1|box|meta>``; None
    left out."""
    if obj is None:
        return {}
    if prefix == "instances.meshes.":
        return {f"{prefix}{k}.{name}": np.asarray(a)
                for k, mesh in enumerate(obj) for name, a in zip(MESH_FIELDS, mesh)
                if a is not None}
    if hasattr(obj, "_fields"):
        names = obj._fields
    elif dataclasses.is_dataclass(obj):
        out = {f"{prefix}n_infinite": np.asarray(obj.n_infinite)}
        for f in dataclasses.fields(obj):
            if f.name not in ("depth", "n_records", "n_infinite", "frontiers"):
                out.update(_flatten(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    else:
        return {prefix[:-1]: np.asarray(obj)}
    out = {}
    for name in names:
        out.update(_flatten(getattr(obj, name), f"{prefix}{name}."))
    return out


def _tree_host(host_cls, bsdf, lights, cam_cls):
    rng = np.random.default_rng(2)
    hs = host_cls()
    hs.camera = cam_cls(width=8, height=8)
    hs.materials = [bsdf.lambert((0.6, 0.6, 0.6)), bsdf.diffuse_light((4.0, 4.0, 4.0))]
    hs.add_model(list(_FLOOR), 0)
    hs.add_model([_TET[3] + np.float32([0, 2, 1])], 1)
    for _ in range(18):
        hs.add_light(lights.point_light(tuple(rng.uniform(0.1, 2, 3)),
                                        tuple(rng.uniform(-3, 3, 3))))
    hs.add_light(lights.environment_light((0.1, 0.1, 0.1)))
    return hs


@pytest.mark.parametrize("kind", ["single", "groups", "tree"])
def test_scene_from_arrays_carries_instances_and_trees(pairs, kind):
    """A reference scene flattened to numpy carries over into the port's
    Scene equal to the port's own build (the trees' host ints, frontiers
    and the instance meshes' compact nodes included)."""
    if kind == "tree":
        j_scene = j_from_host(_tree_host(JHost, JB, JL, JCam))
        t_scene = t_from_host(_tree_host(THost, TB, TL, TCam), device="cpu")
        assert t_scene.light_tree is not None and t_scene.light_tree.n_infinite == 1
    else:
        j_scene, t_scene = pairs[kind]
    carried = scene_from_arrays(_flatten(j_scene), "cpu")
    if kind == "tree":
        for name in ("feat", "rec_kind", "rec_idx", "trail", "trail_len", "infinite_rows"):
            assert torch.equal(getattr(carried.light_tree, name), getattr(t_scene.light_tree, name))
        for name in ("depth", "n_records", "n_infinite", "frontiers"):
            assert getattr(carried.light_tree, name) == getattr(t_scene.light_tree, name), name
        assert torch.equal(carried.tri_emrec, t_scene.tri_emrec)
        return
    ci, ti = carried.instances, t_scene.instances
    for name in ("world_from_obj", "obj_from_world", "bounds_lo", "bounds_hi", "tstart"):
        assert torch.equal(getattr(ci, name), getattr(ti, name)), name
    for cm, tm in zip(ci.meshes, ti.meshes):
        for name in ("tri_v0", "tri_e0", "tri_e1", "tri_rows"):
            assert torch.equal(getattr(cm, name), getattr(tm, name)), name
        assert torch.equal(cm.bvh.nodes, tm.bvh.nodes) and cm.bvh.depth == tm.bvh.depth
    assert len({id(m) for m in ci.meshes}) == len({id(m) for m in ti.meshes})
    assert torch.equal(carried.bounds, t_scene.bounds)


def test_instanced_gate_and_scene_to(pairs):
    """The fused gate refuses instanced scenes (``auto`` resolves to the
    plain integrator); moving a scene keeps its instances' shared tables
    shared; a table without boxes tests every instance."""
    t_scene = pairs["groups"][1]
    assert not megakernel_cuda_supported(t_scene, MegakernelConfig())
    assert resolve_fused(t_scene, MegakernelConfig()).fused == "off"
    moved = scene_to(t_scene, "meta")
    assert moved.instances.meshes[1] is moved.instances.meshes[2]
    assert moved.instances.meshes[1].tri_v0.device.type == "meta"
    ti = t_scene.instances
    mats4 = np.concatenate([ti.world_from_obj[:3].numpy(), np.tile([[[0, 0, 0, 1]]], (3, 1, 1))], 1)
    assert make_instance_table(mats4, ti.meshes[:3]).tstart.tolist() == [0, 0, 0]
    open_table = make_instance_table(mats4, ti.meshes[:3], tstart=ti.tstart[:3].numpy())
    assert open_table.bounds_lo is None
    scene = t_scene._replace(instances=open_table)
    size = SCENE_KINDS["groups"][1]
    cfg = MegakernelConfig(max_depth=1, **CFG)
    img = render_sample_batch(scene, cfg, size, size, 0)
    boxed = render_sample_batch(t_scene._replace(instances=ti._replace(
        world_from_obj=ti.world_from_obj[:3], obj_from_world=ti.obj_from_world[:3],
        bounds_lo=ti.bounds_lo[:3], bounds_hi=ti.bounds_hi[:3], tstart=ti.tstart[:3],
        meshes=ti.meshes[:3])), cfg, size, size, 0)
    assert torch.equal(img, boxed)


# --- the reference's instancing tests on the port's API --------------------


def _render(scene, size, depth=2):
    return render_sample_batch(scene, MegakernelConfig(max_depth=depth, **CFG), size, size, 0).numpy()


def test_sixteen_instances_one_mesh_of_memory():
    """16 placements cost one base mesh (and BVH)."""
    s_inst = t_from_host(_sixteen(THost, TB, TL, TCam, True), use_bvh=True, device="cpu")
    s_bake = t_from_host(_sixteen(THost, TB, TL, TCam, False), use_bvh=True, device="cpu")
    assert s_inst.instances is not None
    assert s_inst.instances.world_from_obj.shape[0] == 16
    assert s_bake.tri_v0.shape[0] >= 10 * s_inst.tri_v0.shape[0]


def test_instanced_render_matches_baked(pairs):
    """The instanced traversal renders the baked scene's image."""
    a = _render(pairs["single"][1], 32)
    b = _render(t_from_host(_sixteen(THost, TB, TL, TCam, False), use_bvh=True, device="cpu"), 32)
    assert np.isfinite(a).all()
    assert a.max() > 0.01
    assert np.abs(a - b).mean() < 1e-4
    assert (np.abs(a - b).max(-1) > 1e-2).mean() < 0.01


def test_instanced_rotation_scale():
    """Rotated and scaled instances shade as their baked copies (the
    inverse-transpose normals and the shared t)."""
    tris = np.stack(generate_sphere((0.0, 0.0, 0.0), 0.5, 6, 12))
    mats = []
    rng = np.random.default_rng(0)
    for k in range(4):
        ang = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(ang), np.sin(ang)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32) * (0.6 + 0.3 * k)
        m[:3, 3] = (k - 1.5, 3.0, 0.0)
        mats.append(m)

    def mk(instanced):
        hs = THost()
        hs.camera = TCam(width=24, height=24)
        if instanced:
            hs.add_model(list(tris), 0)
            hs.instance_transforms = np.stack(mats)
        else:
            for m in mats:
                hs.add_model(list(transform_tris(tris, m)), 0)
        hs.materials = [TB.oren_nayar((0.7, 0.7, 0.7), 0.2)]
        hs.lights = [TL.point_light((30.0, 30.0, 30.0), (1.0, 0.5, 2.0), 1e-3)]
        return t_from_host(hs, use_bvh=True, device="cpu")

    assert np.abs(_render(mk(True), 24) - _render(mk(False), 24)).mean() < 1e-4


def _ball_doc(extra_objects=(), extra_world=None):
    return {
        "camera": {},
        "film": {"resolutionX": 16, "resolutionY": 16},
        "materials": [{"name": "white", "diffuse": [0.8, 0.8, 0.8]}],
        "objects": [{"name": "ball", "type": "primitive", "shape": "sphere",
                     "material": "white"}, *extra_objects],
        "lights": [],
        "transforms": [{"name": f"t{k}", "srt": {"translation-vector": [k, 3, 0]}}
                       for k in range(4)],
        "world": {**{f"t{k}": {"instances": ["ball"]} for k in range(4)}, **(extra_world or {})},
    }


def test_parser_world_instances_without_duplication(tmp_path):
    """A world placing one object under many transforms loads its mesh
    once and fills Scene.instances, as the reference's parser groups it."""
    p = tmp_path / "inst.json"
    p.write_text(json.dumps(_ball_doc()))
    scene, _ = tparser.load_scene(str(p), device="cpu")
    assert scene.instances is not None
    assert scene.instances.world_from_obj.shape[0] == 4
    base = np.stack(generate_sphere((0.0, 0.0, 0.0), 0.5, 8, 16)).shape[0]
    assert scene.tri_v0.shape[0] < 2 * base
    jhs, _ = jparser.parse_scene(str(p))
    ths, _ = tparser.parse_scene(str(p))
    assert len(ths.instance_groups) == len(jhs.instance_groups) == 1
    for key in ("tris", "mat", "transforms"):
        np.testing.assert_array_equal(ths.instance_groups[0][key], jhs.instance_groups[0][key])


def test_multi_mesh_groups_match_baked(pairs):
    """Two base meshes × several instances each, beside baked geometry,
    render the fully baked scene's image: per-mesh tables, global row
    offsets, the world-box cull."""
    s_g = pairs["groups"][1]
    s_b = t_from_host(_groups(THost, TB, TL, TCam, False), use_bvh=True, device="cpu")
    assert s_g.instances is not None
    assert s_g.instances.world_from_obj.shape[0] == 6  # identity + 3 + 2
    assert s_g.tri_v0.shape[0] < s_b.tri_v0.shape[0] / 1.5
    a, b = _render(s_g, 24), _render(s_b, 24)
    assert np.isfinite(a).all()
    assert a.max() > 0.01
    assert np.abs(a - b).mean() < 1e-4
    assert (np.abs(a - b).max(-1) > 1e-2).mean() < 0.01


def test_group_restrictions_raise():
    """Emissive materials, textures and authored normals are refused in a
    grouped scene."""
    sph = np.stack(generate_sphere((0.0, 0.0, 0.0), 0.5, 4, 8))
    one = np.stack([np.eye(4, dtype=np.float32)])
    hs = THost()
    hs.camera = TCam(width=8, height=8)
    hs.materials = [TB.diffuse_light((5.0, 5.0, 5.0))]
    hs.add_instance_group(sph, 0, one)
    with pytest.raises(ValueError, match="emissive"):
        t_from_host(hs, use_bvh=False, device="cpu")
    hs.materials = [TB.lambert((0.5, 0.5, 0.5))]
    hs.add_texture(np.ones((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="textured"):
        t_from_host(hs, use_bvh=False, device="cpu")
    hs.textures = []
    hs.add_model([sph[0]], 0, normals=[np.eye(3, dtype=np.float32)])
    with pytest.raises(ValueError, match="authored normals"):
        t_from_host(hs, use_bvh=False, device="cpu")


def test_parser_mixed_instanced_and_baked_world(tmp_path):
    """A world placing one object 4 times and another once groups the
    first and bakes the second into the identity instance."""
    slab = {"name": "slab", "type": "primitive", "shape": "cube", "material": "white"}
    doc = _ball_doc([slab], {"tslab": {"instances": ["slab"]}})
    doc["transforms"].append({"name": "tslab", "srt": {"translation-vector": [0, 0, 0]}})
    p = tmp_path / "mixed.json"
    p.write_text(json.dumps(doc))
    scene, _ = tparser.load_scene(str(p), device="cpu")
    assert scene.instances is not None
    assert scene.instances.world_from_obj.shape[0] == 5
    ball = np.stack(generate_sphere((0.0, 0.0, 0.0), 0.5, 8, 16)).shape[0]
    assert scene.tri_v0.shape[0] < 2 * ball
    j_scene = j_from_host(jparser.parse_scene(str(p))[0])
    np.testing.assert_array_equal(scene.instances.tstart.numpy(), np.asarray(j_scene.instances.tstart))
    np.testing.assert_array_equal(scene.tri_v0.numpy(), np.asarray(j_scene.tri_v0))
