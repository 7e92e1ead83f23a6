"""The BSDF stage of the unfused bounce (``models/bsdf_step.py``): its route
rule and its plain version on the CPU, and on the card (marked ``cuda``,
skipped without one) the kernel ``pt_bsdf_step`` against the plain stage,
bit for bit, on synthetic rows of every lobe and at the main path's own
launches, with the films and launch counts of whole renders. On a GPU
machine:

    python -m pytest --noconftest -m cuda tests/test_torch_bsdf_step.py -q

Imports nothing of JAX or the reference."""

import dataclasses
import math
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

SCENE_TEST = os.path.join(os.path.dirname(__file__), "..", "scenes", "scene_test.json")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _launches(name: str = "bsdf_step") -> int:
    from cuda_optix_pathtracing_tpu_torch.utils import trace

    return trace.snapshot()[f"launches.{name}"]


class _Hit(NamedTuple):
    pos: torch.Tensor
    normal: torch.Tensor
    error: torch.Tensor


def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


# material mixes: "all" every lobe (Oren-Nayar, Lambert, GGX dielectric and
# conductor; delta, isotropic and anisotropic roughness; zero and tiny
# tints), the others a table whose features drop lobes
MIXES = {
    "all": (0, 1, 2, 3),
    "pruned": (3, 1),  # Lambert and an isotropic dielectric
    "ggx_only": (1, 2),
    "diffuse_only": (0, 3),
}


def _stage_inputs(n, device, seed, mix="all", textured=True, tree=True, depth=0,
                  sample="rows"):
    """Synthetic inputs of the stage, n rows: (args of bsdf_step_plain
    after cfg and sampler, MatFeatures of the table). About 60 % of the
    rows alive; ~5 % seen from behind the geometric normal; shading normals
    perturbed about it, some flipped; a third inside a dielectric."""
    from cuda_optix_pathtracing_tpu_torch.models.megakernel import PathState
    from cuda_optix_pathtracing_tpu_torch.ops.bsdf import MaterialTable, mat_features_from_table

    rs = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    b = lambda a: torch.as_tensor(np.asarray(a, bool), device=device)  # noqa: E731
    ng = _unit(rs, n)
    d = _unit(rs, n)
    facing = np.sum(d * ng, axis=1) > 0.0
    d[facing] *= -1.0
    d[rs.random(n) < 0.05] *= -1.0
    ns = ng + 0.3 * rs.normal(size=(n, 3))
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    ns[rs.random(n) < 0.1] *= -1.0
    pos = rs.uniform(-2.0, 2.0, (n, 3))
    types = np.asarray(MIXES[mix], np.int32)[rs.integers(0, len(MIXES[mix]), n)]
    rough = rs.uniform(0.01, 1.0, (n, 2))
    kind = rs.random(n)
    ax = np.where(kind < 0.2, 5e-4, rough[:, 0])
    ay = np.where(kind < 0.2, 5e-4, np.where(kind < 0.6, ax, rough[:, 1]))
    if mix == "pruned":
        ay = ax
    trans = rs.uniform(0.0, 1.0, (n, 3))
    tk = rs.random(n)
    trans[tk < 0.2] = 0.0
    trans[(tk >= 0.2) & (tk < 0.25)] = 5e-7
    refl = rs.uniform(0.0, 1.0, (n, 3))
    refl[rs.random(n) < 0.05] = 0.0
    ids = torch.full((n,), -1, dtype=torch.int32, device=device)
    mat = MaterialTable(
        mtype=torch.as_tensor(types, device=device), albedo=f(rs.uniform(0, 1, (n, 3))),
        on_sigma=f(rs.uniform(0.0, math.pi / 2, n)), alphax=f(ax), alphay=f(ay),
        phi0=f(rs.uniform(0.0, 2 * math.pi, n)), eta=f(rs.uniform(1.1, 2.0, n)),
        refl_tint=f(refl), trans_tint=f(trans), cond_eta=f(rs.uniform(0.1, 3.0, (n, 3))),
        cond_k=f(rs.uniform(0.1, 4.0, (n, 3))), emission=f(np.zeros((n, 3))),
        albedo_tex=ids, rough_tex=ids, normal_tex=ids,
    )
    state = PathState(
        o=f(rs.uniform(-2, 2, (n, 3))), d=f(d), beta=f(rs.uniform(0.05, 1.5, (n, 3))),
        radiance=f(rs.uniform(0, 1, (n, 3))), alive=b(np.ones(n, bool)),
        inside=b(rs.random(n) < 0.33), eta_scale=f(rs.uniform(0.3, 3.0, n)),
        prev_pdf=f(rs.uniform(0, 2, n)), prev_delta=b(rs.random(n) < 0.3),
        cone_w=f(rs.uniform(0, 0.01, n)) if textured else None,
        cone_s=f(rs.uniform(0, 0.5, n)) if textured else None,
        prev_n=f(_unit(rs, n)) if tree else None,
    )
    hit = _Hit(pos=f(pos), normal=f(ng), error=f(np.abs(pos) * 1e-6 + 1e-7))
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)  # noqa: E731
    px, py = i64(rs.integers(0, 256, n)), i64(rs.integers(0, 256, n))
    if sample == "rows":
        sample = i64(rs.integers(0, 2**33, n))
    if depth == "rows":
        depth = i64(rs.integers(0, 6, n))
    alive = b(rs.random(n) < 0.6)
    cone_at_hit = f(rs.uniform(0, 0.05, n)) if textured else None
    args = (px, py, sample, depth, state, hit, mat, -state.d, f(ns), alive, state.radiance,
            cone_at_hit)
    return args, mat_features_from_table(mat)


def _differ(new, ref) -> dict:
    """Rows that differ in each field of two PathStates, bit for bit."""
    out = {}
    for name, a, r in zip(new._fields, new, ref):
        if a is None or r is None:
            if (a is None) != (r is None):
                out[name] = "None on one side"
            continue
        assert a.dtype == r.dtype and a.shape == r.shape, name
        if a.dtype == torch.float32:
            a, r = a.view(torch.int32), r.view(torch.int32)
        bad = a != r
        if bad.dim() == 2:
            bad = bad.any(-1)
        if bool(bad.any()):
            out[name] = int(bad.sum())
    return out


# ---- the route rule and the plain stage (CPU) ------------------------------------


class _OnCard:
    """Stands in for a CUDA tensor in the route rule's device test."""

    is_cuda = True
    requires_grad = False


@pytest.mark.parametrize("case", ["kernel", "cpu_rows", "backend_torch", "needs_grad",
                                  "grad_off"])
def test_route_rule(case):
    """``pt_bsdf_step`` runs the stage for rows on the card with
    ``backend`` "auto" or "cuda" while autograd records nothing; CPU rows,
    ``backend="torch"`` and a trace that needs a gradient take the plain
    stage."""
    from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box

    scene = cornell_box(8, 8, device="cpu")
    state = MK.camera_path_state(scene, MK.MegakernelConfig(), torch.zeros((4, 3)),
                                 torch.ones((4, 3)))
    cfg = MK.MegakernelConfig(backend="torch" if case == "backend_torch" else "auto")
    if case != "cpu_rows":
        state = state._replace(o=_OnCard())
    if case in ("needs_grad", "grad_off"):
        scene = scene._replace(materials=scene.materials._replace(
            albedo=scene.materials.albedo.clone().requires_grad_(True)))
    with torch.set_grad_enabled(case != "grad_off"):
        assert MK._bsdf_kernel_route(cfg, scene, state) == (case in ("kernel", "grad_off"))


def _spy_stages(monkeypatch):
    """Count the calls of each stage ``bounce_step`` takes; the kernel
    stage is replaced by a spy that must not be called on the CPU."""
    from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK

    calls = {"plain": 0, "kernel": 0}
    plain = MK.bsdf_step_plain

    def counting_plain(*args):
        calls["plain"] += 1
        return plain(*args)

    def counting_kernel(*args):
        calls["kernel"] += 1
        raise AssertionError("pt_bsdf_step called for CPU rows")

    monkeypatch.setattr(MK, "bsdf_step_plain", counting_plain)
    monkeypatch.setattr(MK, "bsdf_step", counting_kernel)
    return calls


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("case", ["cornell", "mesh"])
def test_cpu_render_takes_plain_stage(monkeypatch, backend, case):
    """A CPU render runs the plain stage once a bounce on either backend;
    no kernel launch is counted."""
    from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig, render
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box, cornell_box_mesh

    scene = (cornell_box(8, 8, device="cpu") if case == "cornell"
             else cornell_box_mesh(8, 8, subdiv=4, device="cpu"))
    calls = _spy_stages(monkeypatch)
    before = _launches()
    cfg = MegakernelConfig(max_depth=3, fused="off", backend=backend)
    film = render(scene, 8, 8, 2, cfg=cfg, kspp=2, device="cpu")
    assert calls == {"plain": 2 * 3, "kernel": 0}
    assert _launches() == before
    assert bool(torch.isfinite(film.mean).all()) and float(film.mean.mean()) > 0.0


def test_gradient_trace_takes_plain_stage(monkeypatch):
    """An albedo gradient with path replay runs the plain stage in the
    forward pass and again in the replay, and its gradient is the same as
    with the stage unobserved."""
    from cuda_optix_pathtracing_tpu_torch.models import differentiable as D
    from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box

    scene = cornell_box(8, 8, device="cpu")
    cfg = MegakernelConfig(max_depth=3, fused="off")
    target = torch.zeros((8, 8, 3))

    def grad():
        loss = D.make_loss(scene, cfg, 8, 8, 2, target, spp_per_pass=2)
        params = D.init_params(scene, ("albedo",))
        loss(params).backward()
        return params["albedo"].grad

    g_ref = grad()
    calls = _spy_stages(monkeypatch)
    before = _launches()
    g = grad()
    assert calls == {"plain": 2 * 3, "kernel": 0}
    assert _launches() == before
    assert bool(g_ref.any()) and torch.equal(g, g_ref)


def test_wrapper_refuses_cpu_rows():
    """The kernel's wrapper launches or raises: CPU rows are refused, not
    handed to the plain stage."""
    from cuda_optix_pathtracing_tpu_torch.models.bsdf_step import bsdf_step
    from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig
    from cuda_optix_pathtracing_tpu_torch.ops import rng as R

    args, _ = _stage_inputs(16, "cpu", seed=1)
    before = _launches()
    with pytest.raises(ValueError, match="CUDA rows"):
        bsdf_step(MegakernelConfig(), R.Sampler("hash", 7), *args)
    assert _launches() == before


@pytest.mark.parametrize("textured,tree", [(True, True), (False, False)])
def test_plain_stage_keeps_dead_rows(textured, tree):
    """A row whose path did not reach the stage (``alive`` false) leaves it
    with its state unchanged, field for field: the kernel only copies such
    a row."""
    from cuda_optix_pathtracing_tpu_torch.models.bsdf_step import bsdf_step_plain
    from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig
    from cuda_optix_pathtracing_tpu_torch.ops import rng as R

    args, ft = _stage_inputs(512, "cpu", seed=2, textured=textured, tree=tree, depth=3)
    state, alive = args[4], args[9]
    new = bsdf_step_plain(MegakernelConfig(features=ft), R.Sampler("hash", 5), *args)
    dead = ~alive
    assert bool(dead.any()) and bool(new.alive.any())
    assert not bool(new.alive[dead].any())
    for name in ("o", "d", "beta", "inside", "eta_scale", "prev_pdf", "prev_delta", "cone_w",
                 "cone_s", "prev_n"):
        a, b = getattr(new, name), getattr(state, name)
        assert (a is None) == (b is None) == (name in ("cone_w", "cone_s") and not textured
                                              or name == "prev_n" and not tree), name
        if a is not None:
            assert torch.equal(a[dead], b[dead]), name
    assert new.radiance is state.radiance


# ---- the kernel against the plain stage (card) -------------------------------------


def _hold(cfg, sampler, args):
    """The kernel and the plain stage on the same inputs: every field equal
    bit for bit, one launch counted (none for no rows)."""
    from cuda_optix_pathtracing_tpu_torch.models.bsdf_step import bsdf_step, bsdf_step_plain

    before = _launches()
    new = bsdf_step(cfg, sampler, *args)
    ref = bsdf_step_plain(cfg, sampler, *args)
    torch.cuda.synchronize()
    assert _launches() == before + int(args[4].o.shape[0] > 0)
    assert _differ(new, ref) == {}
    return new


STAGE_CASES = [
    # sampler, depth (rr_start_depth 2), mix, textured, tree
    ("hash", 0, "all", True, True),
    ("hash", 3, "all", False, False),
    ("halton", 0, "all", True, False),
    ("halton", 2, "all", False, True),
    ("hash", "rows", "all", True, True),
    ("hash", 1, "pruned", False, False),
    ("hash", 2, "ggx_only", True, False),
    ("hash", 4, "diffuse_only", False, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", STAGE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernel_matches_plain_stage(dev, case):
    """1,048,576 synthetic rows: every lobe, isotropic and anisotropic,
    delta and rough, inside flips, dead rows, both samplers, depths on both
    sides of rr_start_depth (and one a row), the lobes a table lacks
    dropped as cfg.features drops them."""
    from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig
    from cuda_optix_pathtracing_tpu_torch.ops import rng as R

    sampler, depth, mix, textured, tree = case
    args, ft = _stage_inputs(1 << 20, dev, seed=11, mix=mix, textured=textured, tree=tree,
                             depth=depth, sample="rows" if sampler == "hash" else 2**31 + 99)
    features = ft if mix != "all" else MegakernelConfig().features
    new = _hold(MegakernelConfig(features=features), R.Sampler(sampler, 2**31 + 12_345), args)
    assert 0.1 < float(new.alive.float().mean()) < 0.6


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 37])
def test_kernel_any_launch_size(dev, n):
    from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig
    from cuda_optix_pathtracing_tpu_torch.ops import rng as R

    args, _ = _stage_inputs(n, dev, seed=n)
    _hold(MegakernelConfig(), R.Sampler("hash", 3), args)


def _teapot(dev, size=256):
    from cuda_optix_pathtracing_tpu_torch.scene.parser import parse_scene
    from cuda_optix_pathtracing_tpu_torch.scene.types import scene_from_host

    hs, _ = parse_scene(SCENE_TEST)
    hs.camera = dataclasses.replace(hs.camera, width=size, height=size)
    return scene_from_host(hs, device=dev)


def _scene(case, dev):
    """(scene, cfg, size, spp a pass) of a render case: the benchmark's
    ``mesh256_d5_off`` pass and teapot pass, and smaller tree, instanced
    and Halton scenes."""
    from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box_mesh, cornell_box_mesh_instanced
    from cuda_optix_pathtracing_tpu_torch.scene.procedural import cornell_box_many_lights

    if case == "mesh_off":
        return cornell_box_mesh(256, 256, subdiv=64, device=dev), MegakernelConfig(fused="off"), 256, 16
    if case == "teapot":
        return _teapot(dev), MegakernelConfig(max_depth=12), 256, 32
    if case == "tree":
        sc = cornell_box_many_lights(64, 64, subdiv=8, device=dev)
        return sc, MegakernelConfig(nee_splits=4), 64, 4
    if case == "instanced":
        return cornell_box_mesh_instanced(64, 64, subdiv=8, device=dev), MegakernelConfig(), 64, 4
    assert case == "halton"
    sc = cornell_box_mesh(64, 64, subdiv=16, device=dev)
    return sc, MegakernelConfig(fused="off", sampler="halton"), 64, 4


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mesh_off", "teapot", "tree", "instanced", "halton"])
def test_kernel_holds_plain_stage_at_main_path_launches(dev, monkeypatch, case):
    """Each bounce of one pass runs the kernel and the plain stage on the
    same inputs, which must agree bit for bit: the mesh box's 1,048,576
    rows at depths 0-4, the teapot's 2,097,152 (textured, normal-mapped,
    rough dielectric, inside flips, cones) at depths 0-11, the many-lights
    box (prev_n), the instanced box and the Halton sampler."""
    from cuda_optix_pathtracing_tpu_torch.models import bsdf_step as BS
    from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK

    scene, cfg, size, spp = _scene(case, dev)
    seen = []

    def both(*args):
        new = BS.bsdf_step(*args)
        seen.append(_differ(new, BS.bsdf_step_plain(*args)))
        return new

    monkeypatch.setattr(MK, "bsdf_step", both)
    MK.render_sample_batch(scene, cfg, size, size, 0, nspp=spp)
    torch.cuda.synchronize()
    assert len(seen) == cfg.max_depth
    assert seen == [{}] * cfg.max_depth


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mesh_off", "teapot", "wavefront"])
def test_render_films_match_plain_stage(dev, monkeypatch, case):
    """``render()``'s film (mean, M2) at 256² on the kernel route equals the
    plain stage's bit for bit: the ``mesh256_d5_off`` pass (5 launches),
    the teapot's 32-spp pass (12) and the dense wavefront on the mesh box
    (one launch a bounce it reaches)."""
    from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
    from cuda_optix_pathtracing_tpu_torch.models.wavefront import WavefrontConfig, render_wavefront

    scene, cfg, size, spp = _scene("mesh_off" if case == "wavefront" else case, dev)

    def film():
        if case == "wavefront":
            return render_wavefront(scene, size, size, 1, cfg=WavefrontConfig(), kspp=1)
        return MK.render(scene, size, size, spp, cfg=cfg, kspp=spp, spp_per_pass=spp)

    before = _launches()
    new = film()
    torch.cuda.synchronize()
    launched = _launches() - before
    monkeypatch.setattr(MK, "_bsdf_kernel_route", lambda *a: False)
    ref = film()
    assert _launches() - before == launched
    if case == "wavefront":
        assert 1 <= launched <= cfg.max_depth
    else:
        assert launched == cfg.max_depth
    assert torch.equal(new.mean, ref.mean) and torch.equal(new.m2, ref.m2)
    assert bool(torch.isfinite(new.mean).all()) and float(new.mean.mean()) > 0.0


@pytest.mark.cuda
def test_gradient_step_launches_no_bsdf_kernel(dev):
    """The gradient step keeps the plain stage, forward and replay: no
    launch of the kernel, and the gradient is finite and non-zero."""
    from cuda_optix_pathtracing_tpu_torch.models import differentiable as D
    from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box

    scene = cornell_box(64, 64, device=dev)
    loss = D.make_loss(scene, MegakernelConfig(fused="off"), 64, 64, 4,
                       torch.zeros((64, 64, 3), device=dev), spp_per_pass=4)
    params = D.init_params(scene, ("albedo",))
    before = _launches()
    loss(params).backward()
    torch.cuda.synchronize()
    assert _launches() == before
    g = params["albedo"].grad
    assert bool(torch.isfinite(g).all()) and bool(g.any())
