"""The port's plain integrator on the bundled scene files against the JAX
reference's XLA integrator on the CPU (``fused="off"``), on the same RNG
keys, to the reference's parity bar: mean abs diff < 1e-4 and fewer than
0.5 % of pixels off by more than 1e-3. Each scene is parsed by its own
package, its camera reset to 16×16 in both alike; depth 3, 2 samples as
one batch. This file: the textured BVH scene ``scene_test.json``
(trilinear, EWA, env NEE) and ``cornell-box.pbrt``;
``test_torch_scene_render_env.py``: the environment-map scenes."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu.models.megakernel import MegakernelConfig as JCfg
from cuda_optix_pathtracing_tpu.models.megakernel import render_sample_batch as j_render_batch
from cuda_optix_pathtracing_tpu.ops import bsdf as JB
from cuda_optix_pathtracing_tpu.scene import parser as jparser
from cuda_optix_pathtracing_tpu.scene import pbrt as jpbrt
from cuda_optix_pathtracing_tpu.scene.types import scene_from_host as j_from_host
from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig, render_sample_batch
from cuda_optix_pathtracing_tpu_torch.ops import bsdf as TB
from cuda_optix_pathtracing_tpu_torch.scene import parser as tparser
from cuda_optix_pathtracing_tpu_torch.scene import pbrt as tpbrt
from cuda_optix_pathtracing_tpu_torch.scene.types import scene_from_host as t_from_host

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
SIZE = 16
DEPTH = 3
SPP = 2


def host_scenes(name, edit=None):
    """(reference HostScene, port HostScene) of a bundled file, the camera
    reset to SIZE² and ``edit(host_scene, bsdf_module)`` applied to both,
    each with its own package's ``ops.bsdf``."""
    path = os.path.join(SCENES, name)
    out = []
    for jx in (True, False):
        if name.endswith(".pbrt"):
            hs, _ = (jpbrt if jx else tpbrt).parse_pbrt(path)
        else:
            hs, _ = (jparser if jx else tparser).parse_scene(path)
        hs.camera = dataclasses.replace(hs.camera, width=SIZE, height=SIZE)
        if edit is not None:
            edit(hs, JB if jx else TB)
        out.append(hs)
    return out


def scene_pair(name, edit=None):
    jhs, ths = host_scenes(name, edit)
    return j_from_host(jhs), t_from_host(ths, device="cpu")


def render_pair(pair, **cfg):
    """SPP samples per pixel of both packages → (reference, port) sums
    over the samples, (H, W, 3) each."""
    j_scene, t_scene = pair
    jcfg = JCfg(max_depth=DEPTH, remat=False, backend="xla", fused="off", **cfg)
    ref = np.asarray(j_render_batch(j_scene, jcfg, SIZE, SIZE, jnp.uint32(0), nspp=SPP))
    ours = render_sample_batch(
        t_scene, MegakernelConfig(max_depth=DEPTH, fused="off", **cfg), SIZE, SIZE, 0, nspp=SPP
    ).numpy()
    return ref.sum(0), ours.sum(0)


def parity(ref, ours, n=SPP):
    diff = np.abs(ref - ours) / n
    assert np.isfinite(ours).all()
    assert diff.mean() < 1e-4, diff.mean()
    assert (diff.max(-1) > 1e-3).mean() < 0.005


@pytest.fixture(scope="module")
def teapot():
    pair = scene_pair("scene_test.json")
    assert pair[1].bvh is not None and pair[1].textures is not None
    return pair


@pytest.mark.parametrize("cfg", [{}, {"texture_filter": "ewa"}, {"env_nee": True}],
                         ids=["trilinear", "ewa", "env_nee"])
def test_textured_teapot_matches_reference(teapot, cfg):
    ref, ours = render_pair(teapot, **cfg)
    parity(ref, ours)
    assert ours.mean() > 1e-3  # the teapot and its lights show


def test_texture_filters_differ(teapot):
    """EWA and trilinear sample the same textures differently: the two
    images differ somewhere, while each matches the reference."""
    _, t_scene = teapot
    imgs = [
        render_sample_batch(t_scene, MegakernelConfig(max_depth=2, texture_filter=f), SIZE, SIZE, 0)
        for f in ("trilinear", "ewa")
    ]
    assert not torch.equal(*imgs)


def test_pbrt_cornell_box_matches_reference():
    ref, ours = render_pair(scene_pair("cornell-box.pbrt"))
    parity(ref, ours)
    assert ours.mean() > 0.1


def test_carried_over_scene_renders_the_same(teapot):
    """The reference's scene carried over by ``scene_from_arrays`` renders
    as the port's own build of the same file, at the parity bar (their
    UV densities differ in the last ulps, so the LODs may too)."""
    from cuda_optix_pathtracing_tpu_torch.scene import scene_from_arrays
    from test_torch_bridge import flatten_scene

    j_scene, t_scene = teapot
    carried = scene_from_arrays(flatten_scene(j_scene), "cpu")
    cfg = MegakernelConfig(max_depth=DEPTH)
    ours = render_sample_batch(t_scene, cfg, SIZE, SIZE, 0, nspp=SPP).numpy().sum(0)
    theirs = render_sample_batch(carried, cfg, SIZE, SIZE, 0, nspp=SPP).numpy().sum(0)
    parity(theirs, ours)
