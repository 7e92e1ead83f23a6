"""The port's mesh import and host mesh attributes against the JAX
reference: FBX (binary and ASCII) and OBJ arrays bit for bit, world
transforms within 1 ulp, smooth normals equal."""

import os

import numpy as np
import pytest

from cuda_optix_pathtracing_tpu import native as jnative
from cuda_optix_pathtracing_tpu.scene import meshio as jmeshio
from cuda_optix_pathtracing_tpu_torch import native as tnative
from cuda_optix_pathtracing_tpu_torch.scene import meshio as tmeshio

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")

OBJ_TEXT = (
    "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 0.5 1\n"
    "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
    "vn 0 0 1\nvn 0 0.6 0.8\n"
    "f 1/1/1 2/2/1 3/3/1 4/4/1\n"
    "f -5/-4/-2 -4/-3/-1 -1/-1/-1\n"
)


def _equal(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("path", ["sphere.fbx", "res/fbx/teapot.fbx"])
def test_fbx_equals_reference(path):
    p = os.path.join(SCENES, path)
    ours = tmeshio.load_fbx_full(p)
    _equal(ours, jmeshio.load_fbx_full(p))
    tris, uvs, ns = ours
    assert uvs is not None and ns is not None
    assert tris.shape[0] in (480, 9216)


def test_ascii_fbx_equals_reference(tmp_path):
    """The bundled ASCII teapot is corrupt upstream: both loaders raise the
    same diagnosis; a well-formed ASCII quad loads to the same arrays."""
    bad = os.path.join(SCENES, "res", "fbx", "teapot-ascii.fbx")
    with pytest.raises(ValueError, match="malformed number"):
        tmeshio.load_fbx_full(bad)
    p = tmp_path / "quad.fbx"
    p.write_text(
        "; FBX 7.3.0 project file\nObjects: {\n"
        '  Geometry: 1, "Geometry::quad", "Mesh" {\n'
        "    Vertices: *12 {\n      a: 0,0,0, 1,0,0, 1,1,0, 0,1,0\n    }\n"
        "    PolygonVertexIndex: *4 {\n      a: 0,1,2,-4\n    }\n  }\n}\n"
    )
    ours = tmeshio.load_fbx_full(str(p))
    _equal(ours, jmeshio.load_fbx_full(str(p)))
    assert ours[0].shape == (2, 3, 3)


def test_obj_equals_reference(tmp_path):
    p = tmp_path / "m.obj"
    p.write_text(OBJ_TEXT)
    ours = tmeshio.load_mesh_full(str(p))
    _equal(ours, jmeshio.load_mesh_full(str(p)))
    assert ours[0].shape == (3, 3, 3) and ours[1].shape == (3, 3, 2)
    _equal(tmeshio.load_obj_ex(str(p)), jmeshio.load_obj_ex(str(p)))
    np.testing.assert_array_equal(tmeshio.load_mesh(str(p)), jmeshio.load_mesh(str(p)))
    with pytest.raises(ValueError, match="unsupported mesh format"):
        tmeshio.load_mesh_full(str(tmp_path / "m.ply"))


def test_transform_tris_within_one_ulp():
    rs = np.random.default_rng(11)
    tris = rs.normal(size=(2000, 3, 3)).astype(np.float32) * 3.0
    m = np.eye(4)
    m[:3, :3] = rs.normal(size=(3, 3))
    m[:3, 3] = rs.normal(size=3) * 5.0
    ours = tnative.transform_tris(tris, m)
    ref = jnative.transform_tris(tris, m)
    assert ours.dtype == np.float32 and ours.shape == tris.shape
    ulp = np.spacing(np.maximum(np.abs(ours), np.abs(ref)))
    assert (np.abs(ours - ref) <= ulp).all()
    assert tnative.transform_tris(tris[:0], m).shape == (0, 3, 3)


def test_smooth_normals_equal_reference():
    tris = tmeshio.load_fbx_full(os.path.join(SCENES, "sphere.fbx"))[0]
    ours = tnative.smooth_normals(tris, crease_deg=66.0)
    np.testing.assert_array_equal(ours, jnative.smooth_normals(tris, crease_deg=66.0))
    np.testing.assert_allclose(np.linalg.norm(ours, axis=-1), 1.0, atol=1e-5)
