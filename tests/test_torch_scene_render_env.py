"""The port's plain integrator on the environment-map scene files against
the JAX reference (see ``test_torch_scene_render.py`` for the bar):
``scene_example.json`` (a specular cube under the HDR veranda map) with
env NEE off and on, the same with the cube made rough (Oren-Nayar, so
that env NEE and its MIS weights shape the image), and
``fbx_example.json`` (shading normals, constant environment)."""

import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig, render_sample_batch
from test_torch_scene_render import SIZE, parity, render_pair, scene_pair

torch.set_num_threads(2)


def _rough(hs, bsdf):
    hs.materials = [bsdf.oren_nayar((0.4, 0.5, 0.2), 0.6)]


@pytest.fixture(scope="module")
def veranda():
    pair = scene_pair("scene_example.json")
    assert not pair[1].env.uniform
    return pair


@pytest.fixture(scope="module")
def veranda_rough():
    return scene_pair("scene_example.json", _rough)


@pytest.mark.parametrize("env_nee", [False, True])
def test_env_scene_matches_reference(veranda, env_nee):
    ref, ours = render_pair(veranda, env_nee=env_nee)
    parity(ref, ours)
    assert ours.mean() > 0.05  # the veranda lights the image


@pytest.mark.parametrize("env_nee", [False, True])
def test_rough_env_scene_matches_reference(veranda_rough, env_nee):
    ref, ours = render_pair(veranda_rough, env_nee=env_nee)
    parity(ref, ours)


def test_env_nee_changes_the_rough_image(veranda_rough):
    _, t_scene = veranda_rough
    imgs = [
        render_sample_batch(t_scene, MegakernelConfig(max_depth=2, env_nee=e), SIZE, SIZE, 0)
        for e in (False, True)
    ]
    assert not torch.equal(*imgs)
    assert np.isfinite(imgs[1].numpy()).all()


def test_shading_normal_scene_matches_reference():
    pair = scene_pair("fbx_example.json")
    assert pair[1].tri_ns is not None
    ref, ours = render_pair(pair)
    parity(ref, ours)
    assert ours.max() > 0.01
