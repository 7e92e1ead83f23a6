"""Bridge between the JAX reference and the PyTorch port: scene carry-over,
shared numpy tables, import hygiene of the port and its device default."""

import ast
import pathlib

import jax.numpy as jnp  # noqa: F401  (JAX stays on the CPU in tests)
import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu.ops import bsdf as jbsdf
from cuda_optix_pathtracing_tpu.ops import camera as jcamera
from cuda_optix_pathtracing_tpu.scene import cornell_box as j_cornell_box
from cuda_optix_pathtracing_tpu.scene.procedural import cornell_box_mesh as j_cornell_box_mesh
from cuda_optix_pathtracing_tpu_torch.ops import bsdf as tbsdf
from cuda_optix_pathtracing_tpu_torch.ops import camera as tcamera
from cuda_optix_pathtracing_tpu_torch.scene import cornell_box, cornell_box_mesh, scene_from_arrays

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent


def flatten_scene(obj, prefix: str = "") -> dict:
    """Reference Scene (nested NamedTuples of arrays) → {dotted name:
    numpy array}, leaving out fields that are None."""
    out = {}
    if obj is None:
        return out
    if hasattr(obj, "_fields"):
        for name in obj._fields:
            out.update(flatten_scene(getattr(obj, name), f"{prefix}{name}."))
        return out
    out[prefix[:-1]] = np.asarray(obj)
    return out


def _leaves(obj, prefix=""):
    """Port Scene → {dotted name: numpy array} (tensors, host arrays and
    ints alike), leaving out fields that are None."""
    if obj is None:
        return {}
    if not hasattr(obj, "_fields"):
        return {prefix[:-1]: obj.numpy() if torch.is_tensor(obj) else np.asarray(obj)}
    out = {}
    for name in obj._fields:
        out.update(_leaves(getattr(obj, name), f"{prefix}{name}."))
    return out


@pytest.fixture(scope="module")
def ref_scene():
    return j_cornell_box(32, 32)


def test_cornell_box_equals_carried_over_reference(ref_scene):
    ported = _leaves(cornell_box(32, 32, device="cpu"))
    carried = _leaves(scene_from_arrays(flatten_scene(ref_scene), "cpu"))
    assert ported.keys() == carried.keys()
    for key in ported:
        assert ported[key].dtype == carried[key].dtype, key
        np.testing.assert_array_equal(ported[key], carried[key], err_msg=key)
    assert ported["tri_v0"].shape == (26, 3)


def test_mesh_scene_equals_carried_over_reference():
    ref = j_cornell_box_mesh(32, 32, subdiv=16)
    assert ref.bvh is not None
    ported = _leaves(cornell_box_mesh(32, 32, subdiv=16, device="cpu"))
    carried = _leaves(scene_from_arrays(flatten_scene(ref), "cpu"))
    assert ported.keys() == carried.keys()
    for key in ported:
        assert ported[key].dtype == carried[key].dtype, key
        np.testing.assert_array_equal(ported[key], carried[key], err_msg=key)
    assert ported["tri_v0"].shape == (1520, 3) and ported["bvh.box"].shape == (20, 128)
    for key in ("bvh.box", "bvh.meta", "bvh.perm", "tri_v0", "tri_mat"):
        np.testing.assert_array_equal(ported[key], np.asarray(flatten_scene(ref)[key]), err_msg=key)
    assert ported["bvh.depth"] == 3


def test_scene_from_arrays_refuses_later_slices(ref_scene):
    """Every reference field is ported now (the light tree and instances
    last): a tree or an instance table whose arrays are incomplete is
    refused, naming the missing array."""
    fields = flatten_scene(ref_scene)
    with pytest.raises(KeyError, match="light_tree.rec_kind"):
        scene_from_arrays({**fields, "light_tree.feat": np.zeros((1, 15))}, "cpu")
    with pytest.raises(KeyError, match="instances.meshes.0.v0"):
        scene_from_arrays({**fields, "instances.tstart": np.zeros(2, np.int32)}, "cpu")


def test_e_poly_coeffs_equal():
    c2j, c1j, dj = jbsdf._e_poly_coeffs()
    c2t, c1t, dt = tbsdf._e_poly_coeffs()
    assert dj == dt
    np.testing.assert_array_equal(c2j, c2t)
    np.testing.assert_array_equal(c1j, c1t)


@pytest.mark.parametrize("res", [(32, 32), (256, 256), (64, 48)])
def test_camera_matrices_equal(res):
    w, h = res
    np.testing.assert_array_equal(
        np.asarray(jcamera.camera_from_raster(20.0, 36.0, w, h)),
        tcamera.camera_from_raster(20.0, 36.0, w, h),
    )
    np.testing.assert_array_equal(
        np.asarray(jcamera.world_from_camera((0.3, 1.0, -0.2), (0.1, -2.0, 0.5))),
        tcamera.world_from_camera((0.3, 1.0, -0.2), (0.1, -2.0, 0.5)),
    )


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_reference():
    files = sorted((REPO / "cuda_optix_pathtracing_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top != "jax", f"{path} imports {mod}"
            assert top != "cuda_optix_pathtracing_tpu", f"{path} imports {mod}"


def test_render_defaults_to_cuda(monkeypatch):
    from cuda_optix_pathtracing_tpu_torch.models.megakernel import render

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = cornell_box(8, 8, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render(scene, 8, 8, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cornell_box(8, 8)
