"""The port's scene files against the JAX reference: ``parse_scene`` and
``parse_pbrt`` on the five bundled scenes give the same HostScene fields,
film, samples and depth; ``scene_from_host`` the same Scene field by field
(integers equal, floats within 1e-6 relative), which also carries over;
strict keys and the missing-file substitutions behave alike; and the fused
kernel's gate keeps textured and normal-mapped scenes off it."""

import dataclasses
import json
import logging
import os

import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu.scene import parser as jparser
from cuda_optix_pathtracing_tpu.scene import pbrt as jpbrt
from cuda_optix_pathtracing_tpu.scene.types import scene_from_host as j_from_host
from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig, resolve_fused
from cuda_optix_pathtracing_tpu_torch.models.megakernel_cuda import megakernel_cuda_supported
from cuda_optix_pathtracing_tpu_torch.scene import load_pbrt, load_scene, scene_from_arrays
from cuda_optix_pathtracing_tpu_torch.scene import parser as tparser
from cuda_optix_pathtracing_tpu_torch.scene import pbrt as tpbrt
from cuda_optix_pathtracing_tpu_torch.scene.types import scene_from_host as t_from_host
from cuda_optix_pathtracing_tpu_torch.utils.imageio import write_png
from test_torch_bridge import _leaves, flatten_scene

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
FILES = ["scene_test.json", "scene_example.json", "fbx_example.json",
         "cornell-box.pbrt", "cornell-area.pbrt"]


def _parse(pkg, name):
    path = os.path.join(SCENES, name)
    if name.endswith(".pbrt"):
        return (jpbrt if pkg == "jax" else tpbrt).parse_pbrt(path)
    return (jparser if pkg == "jax" else tparser).parse_scene(path)


@pytest.fixture(scope="module")
def scenes():
    """(reference Scene, port Scene, reference meta, port meta) per file,
    each built once."""
    out = {}
    for name in FILES:
        jhs, jmeta = _parse("jax", name)
        ths, tmeta = _parse("torch", name)
        out[name] = (j_from_host(jhs), t_from_host(ths, device="cpu"), jmeta, tmeta)
    return out


def _hold(ours: dict, ref: dict):
    """Every reference field in ``ours``: integers and flags equal, floats
    within 1e-6 relative."""
    for key, b in ref.items():
        assert key in ours, key
        a = ours[key]
        assert a.shape == b.shape, key
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)


def _host_fields(hs):
    f = {"triangles": np.stack(hs.triangles), "tri_mat": np.asarray(hs.tri_mat)}
    for name in ("tri_uv", "tri_ns"):
        rows = getattr(hs, name)
        f[f"{name}.none"] = np.array([r is None for r in rows])
        if any(r is not None for r in rows):
            f[name] = np.stack([r for r in rows if r is not None])
    for i, im in enumerate(hs.textures):
        f[f"textures.{i}"] = np.asarray(im)
    for i, m in enumerate(hs.materials):
        f.update({f"materials.{i}.{k}": np.asarray(v) for k, v in m.items()})
    for i, li in enumerate(hs.lights):
        f.update({f"lights.{i}.{k}": np.asarray(v) for k, v in li.items()})
    f["env_color"] = np.asarray(hs.env_color)
    if hs.env_image is not None:
        f["env_image"] = np.asarray(hs.env_image)
    f.update({f"camera.{k}": np.asarray(v) for k, v in dataclasses.asdict(hs.camera).items()})
    return f


@pytest.mark.parametrize("name", FILES)
def test_parse_equals_reference(name):
    jhs, jmeta = _parse("jax", name)
    ths, tmeta = _parse("torch", name)
    assert dataclasses.asdict(tmeta) == dataclasses.asdict(jmeta)
    ours, ref = _host_fields(ths), _host_fields(jhs)
    assert ours.keys() == ref.keys()
    for key in ref:
        assert ours[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


@pytest.mark.parametrize("name", FILES)
def test_scene_from_host_equals_reference(scenes, name):
    j_scene, t_scene, jmeta, tmeta = scenes[name]
    ref = flatten_scene(j_scene)
    _hold(_leaves(t_scene), ref)
    # the bridge carries the reference's scene over to the same port scene
    carried = _leaves(scene_from_arrays(ref, "cpu"))
    ours = _leaves(t_scene)
    assert carried.keys() == ours.keys()
    _hold(carried, ours)
    assert (jmeta.width, jmeta.height) == (256, 256)


def test_scene_features(scenes):
    """What each bundled scene needs, as the port builds it."""
    test, example, fbx, box, _ = (scenes[n][1] for n in FILES)
    assert test.bvh is not None and test.textures is not None
    assert test.textures.num_textures == 3 and test.tri_ns is not None
    assert int((test.bvh.perm >= 0).sum()) == 9216
    assert example.bvh is None and example.num_triangles == 12
    assert not example.env.uniform and example.env.image.shape == (512, 1024, 3)
    assert fbx.tri_ns is not None and fbx.num_triangles == 480 and fbx.env.uniform
    assert box.emissive is not None and box.num_triangles == 36
    assert example.light_types == (0, 1) and box.light_types == (4,)


def test_load_functions_build_the_same_scene(scenes):
    scene, parsed = load_scene(os.path.join(SCENES, "fbx_example.json"), device="cpu")
    assert parsed.max_depth == 12 and parsed.spp == 32
    _hold(_leaves(scene), _leaves(scenes["fbx_example.json"][1]))
    box, meta = load_pbrt(os.path.join(SCENES, "cornell-box.pbrt"), device="cpu")
    assert meta.spp == 2048 and box.num_triangles == 36


@pytest.mark.parametrize("name", ["fbx_example.json", "scene_test.json"])
def test_fused_gate_refuses_normals_and_textures(scenes, name):
    """Kernel 1/5 shade with the table's constants and the geometric
    normal: a scene with shading normals or textures takes the plain
    integrator whatever the device, and ``fused="on"`` raises."""
    scene = scenes[name][1]
    cfg = MegakernelConfig()
    assert not megakernel_cuda_supported(scene, cfg)
    flat = scene._replace(tri_ns=None, textures=None, tri_uv=None, tri_uvdens=None)
    assert megakernel_cuda_supported(flat, cfg)  # the refusal is those fields
    cuda_like = _on_cuda(scene)
    assert resolve_fused(cuda_like, cfg).fused == "off"
    with pytest.raises(ValueError, match="feature set"):
        resolve_fused(scene, dataclasses.replace(cfg, fused="on"))


def _on_cuda(scene):
    """The scene as ``resolve_fused`` would see it on a card: a device of
    type cuda (the gate reads only host copies of its tables)."""

    class Dev(type(scene)):
        @property
        def device(self):
            return torch.device("cuda")

    return Dev(*scene)


def _write(tmp_path, doc):
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(doc))
    return str(path)


BASE = {
    "materials": [{"name": "m", "diffuse": [0.5, 0.5, 0.5]}],
    "objects": [{"name": "box", "type": "primitive", "shape": "cube", "material": "m"}],
    "transforms": [{"name": "a", "srt": {"translation-vector": [0, 2, 0]}}],
    "world": {"a": {"instances": ["box"]}},
}


@pytest.mark.parametrize("section,bad", [
    ("camera", {"focalLength": 20, "bogus-key": 1}),
    ("film", {"resolutionX": 8, "frames": 2}),
])
def test_strict_keys_match_reference(tmp_path, section, bad):
    path = _write(tmp_path, {**BASE, section: bad})
    with pytest.raises(jparser.SceneParseError) as j_err:
        jparser.parse_scene(path)
    with pytest.raises(tparser.SceneParseError) as t_err:
        tparser.parse_scene(path)
    assert str(t_err.value) == str(j_err.value)


def test_missing_files_substitute_as_reference(tmp_path, caplog):
    doc = {
        **BASE,
        "textures": [{"name": "t", "type": "diffuse", "path": "nowhere.png"}],
        "materials": [{"name": "m", "diffuse": "t", "roughness": 0.3}],
        "envlight": "sky.exr",
    }
    path = _write(tmp_path, doc)
    with caplog.at_level(logging.WARNING):
        ths, _ = tparser.parse_scene(path)
    jhs, _ = jparser.parse_scene(path)
    assert ths.env_color == jhs.env_color == (0.05, 0.05, 0.05)
    assert not ths.textures and not jhs.textures
    ours, ref = _host_fields(ths), _host_fields(jhs)
    assert ours.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    text = caplog.text
    assert "cannot load" in text and "substituting dim constant environment" in text


def test_instance_groups_raise(tmp_path):
    """An object under two transforms becomes the reference's instance
    group (mesh, material, transforms equal); in a textured scene it bakes
    instead, and a grouped build with textures raises."""
    doc = {**BASE, "transforms": BASE["transforms"] + [
        {"name": "b", "srt": {"translation-vector": [1, 2, 0]}}]}
    doc["world"] = {"a": {"instances": ["box"]}, "b": {"instances": ["box"]}}
    path = _write(tmp_path, doc)
    (jg,), (tg,) = jparser.parse_scene(path)[0].instance_groups, tparser.parse_scene(path)[0].instance_groups
    for key in ("tris", "mat", "transforms"):
        np.testing.assert_array_equal(tg[key], jg[key], err_msg=key)
    write_png(str(tmp_path / "t.png"), np.full((4, 4, 3), 128, np.uint8))
    doc["textures"] = [{"name": "t", "type": "diffuse", "path": "t.png"}]
    doc["materials"] = [{"name": "m", "diffuse": "t"}]
    ths = tparser.parse_scene(_write(tmp_path, doc))[0]
    jhs = jparser.parse_scene(_write(tmp_path, doc))[0]
    assert ths.textures and not ths.instance_groups and not jhs.instance_groups
    assert len(ths.triangles) == len(jhs.triangles) == 24
    ths.add_instance_group(ths.triangles[:12], 0, np.eye(4)[None])
    with pytest.raises(ValueError, match="textured"):
        t_from_host(ths, device="cpu")
