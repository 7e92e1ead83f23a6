"""The intersection queries of the unfused integrator (``ops/query.py``):
on the CPU, ``closest`` and ``occluded`` against ``intersect_closest`` and
``intersect_any`` on every live ray of the brute-force Cornell box, the
BVH mesh box and the instanced mesh box, one span a call and ``rays.query``
counting every ray handed in; on the card (marked ``cuda``), the kernel
route against ``backend="torch"`` with the ray sort on and off. Imports
nothing of JAX, so the card case runs with

    python -m pytest --noconftest -m cuda tests/test_torch_query.py -q
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig
from cuda_optix_pathtracing_tpu_torch.ops import query as Q
from cuda_optix_pathtracing_tpu_torch.ops.intersect import BIG_T, intersect_any, intersect_closest
from cuda_optix_pathtracing_tpu_torch.scene import procedural as P
from cuda_optix_pathtracing_tpu_torch.utils import trace

SCENES = ["cornell", "mesh", "instanced"]
N = 512


def _scene(kind, device):
    if kind == "cornell":
        return P.cornell_box(8, 8, device=device)
    if kind == "mesh":
        return P.cornell_box_mesh(8, 8, subdiv=8, use_bvh=True, device=device)
    return P.cornell_box_mesh_instanced(8, 8, subdiv=8, device=device)


def _rays(device, n=N, seed=7):
    """Rays from inside the box in every direction, a per-ray t_max and a
    mask with about half the rays alive."""
    rs = np.random.default_rng(seed)
    o = rs.uniform([-1.9, 0.1, -0.4], [1.9, 3.9, 1.9], (n, 3))
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    alive = torch.as_tensor(rs.random(n) < 0.5, device=device)
    return f(o), f(d), f(rs.uniform(0.2, 5.0, n)), alive


def _world_tris(scene):
    """The scene's triangles in world space, in its global row order: an
    instanced scene's concatenated object-space rows placed by their
    instance's transform."""
    if scene.instances is None:
        return scene.tri_v0, scene.tri_e0, scene.tri_e1
    inst = scene.instances
    v0, e0, e1 = (x.clone() for x in (scene.tri_v0, scene.tri_e0, scene.tri_e1))
    for k, mesh in enumerate(inst.meshes):
        rows = slice(int(inst.tstart[k]), int(inst.tstart[k]) + mesh.tri_v0.shape[0])
        m = inst.world_from_obj[k]
        v0[rows] = scene.tri_v0[rows] @ m[:, :3].T + m[:, 3]
        e0[rows] = scene.tri_e0[rows] @ m[:, :3].T
        e1[rows] = scene.tri_e1[rows] @ m[:, :3].T
    return v0, e0, e1


@pytest.mark.parametrize("kind", SCENES)
def test_queries_equal_the_sweeps_on_live_rays(kind):
    scene = _scene(kind, "cpu")
    cfg = MegakernelConfig(fused="off")
    o, d, t_max, alive = _rays("cpu")
    hit = Q.closest(scene, cfg, o, d, alive=alive)
    occ = Q.occluded(scene, cfg, o, d, t_max, alive=alive)
    tris = _world_tris(scene)
    ref = intersect_closest(o, d, *tris)
    ref_occ = intersect_any(o, d, *tris, t_max)
    a = alive
    assert 0 < int(a.sum()) < N and bool(ref.hit[a].any()) and bool(ref_occ[a].any())
    assert torch.equal(hit.hit[a], ref.hit[a]) and torch.equal(occ[a], ref_occ[a])
    if scene.instances is None:
        for field in ("t", "tri", "u", "v", "pos", "normal", "error"):
            assert torch.equal(getattr(hit, field)[a], getattr(ref, field)[a]), field
    else:
        # object space, then back: the same triangles, t and position to rounding
        h = a & ref.hit
        assert torch.equal(hit.tri[h], ref.tri[h])
        torch.testing.assert_close(hit.t[h], ref.t[h], rtol=1e-5, atol=0.0)
        torch.testing.assert_close(hit.pos[h], ref.pos[h], rtol=0.0, atol=1e-5)
        torch.testing.assert_close(hit.normal[h], ref.normal[h], rtol=0.0, atol=1e-5)


@pytest.mark.parametrize("kind", SCENES)
def test_each_query_opens_its_span_and_counts_its_rays(kind):
    scene = _scene(kind, "cpu")
    cfg = MegakernelConfig(fused="off")
    o, d, t_max, alive = _rays("cpu")
    for name, call in (("pt.closest", lambda: Q.closest(scene, cfg, o, d, alive=alive)),
                       ("pt.shadow", lambda: Q.occluded(scene, cfg, o, d, t_max, alive=alive))):
        trace.reset()
        with trace.recording(), profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
            counts = trace.snapshot()
        spans = Counter(e.name for e in prof.events() if e.name.startswith("pt."))
        assert spans == Counter({name: 1}), spans
        assert counts["rays.query"] == N and counts["rays.live"] == int(alive.sum())
        trace.reset()
        call()
        assert trace.snapshot()["rays.query"] == N
    trace.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("sort", ["on", "off"])
@pytest.mark.parametrize("kind", SCENES)
def test_kernel_route_equals_plain_route(kind, sort):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    scene = _scene(kind, torch.device("cuda"))
    o, d, t_max, alive = _rays(torch.device("cuda"), n=8192)
    kern = MegakernelConfig(fused="off", sort_rays=sort)
    plain = MegakernelConfig(fused="off", backend="torch")
    hk, hp = (Q.closest(scene, c, o, d, alive=alive) for c in (kern, plain))
    ok, op = (Q.occluded(scene, c, o, d, t_max, alive=alive) for c in (kern, plain))
    a = alive
    assert torch.equal(ok[a], op[a]) and torch.equal(hk.hit[a], hp.hit[a])
    h = a & hp.hit
    rel = (hk.t - hp.t).abs() / hp.t.abs()
    if scene.bvh is None and all(m.bvh is None for m in getattr(scene.instances, "meshes", ())):
        assert torch.equal(hk.t[a], hp.t[a]) and torch.equal(hk.tri[a], hp.tri[a])
    else:
        # kernel 4 walks the tree: t to 1e-5, the row but on ties
        assert bool((rel[h] <= 1e-5).all())
        assert bool(((hk.tri == hp.tri) | (rel <= 1e-6))[h].all())
    assert bool((hk.t[a & ~hp.hit] >= BIG_T).all())
