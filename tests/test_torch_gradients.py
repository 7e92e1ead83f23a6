"""Gradients of the port (``models/differentiable.py``, path replay in
``trace_paths``, ``ops/autodiff.nondiff_kernel``) on the CPU.

The port's loss and gradients are held to the JAX reference's
``jax.value_and_grad`` on the same Cornell box and RNG keys (computed once
per module: its compile dominates the file's time); the reference's own
gradient tests (``tests/test_gradients.py``) are ported to run on the port
alone; and the repairs this slice needed are pinned: the environment's
texel lookup, ``mat_features_from_table`` on an optimised table, the
fused kernels' tables rebuilt by ``inject_params`` and the fused gate's
refusal of unequal texels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu.models.differentiable import init_params as j_init_params
from cuda_optix_pathtracing_tpu.models.differentiable import make_loss as j_make_loss
from cuda_optix_pathtracing_tpu.models.megakernel import MegakernelConfig as JCfg
from cuda_optix_pathtracing_tpu.ops import envmap as JE
from cuda_optix_pathtracing_tpu.ops.sampling import map_to_sphere as j_map_to_sphere
from cuda_optix_pathtracing_tpu.scene import cornell_box as j_cornell_box
from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
from cuda_optix_pathtracing_tpu_torch.models.differentiable import (
    PARAM_KEYS,
    fd_gradient_check,
    init_params,
    inject_params,
    make_loss,
    render_mean,
)
from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig, resolve_fused
from cuda_optix_pathtracing_tpu_torch.models.megakernel_cuda import megakernel_cuda_supported
from cuda_optix_pathtracing_tpu_torch.ops import autodiff
from cuda_optix_pathtracing_tpu_torch.ops.autodiff import nondiff_kernel
from cuda_optix_pathtracing_tpu_torch.ops.bsdf import mat_features_from_table
from cuda_optix_pathtracing_tpu_torch.ops.bvh_cuda import bvh_closest_raw
from cuda_optix_pathtracing_tpu_torch.ops.envmap import eval_envmap, make_envmap
from cuda_optix_pathtracing_tpu_torch.ops.intersect import (
    BIG_T,
    intersect_any,
    intersect_closest_raw,
)
from cuda_optix_pathtracing_tpu_torch.ops.sampling import map_to_sphere
from cuda_optix_pathtracing_tpu_torch.scene import cornell_box, cornell_box_mesh, scene_from_arrays
from test_torch_bridge import flatten_scene

torch.set_num_threads(2)

W = H = 8
SPP = 2
DEPTH = 2


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def reference():
    """JAX's loss and gradients of all five parameters, jointly, once, with
    the samples traced as one pass (as the bench's gradient step). It is
    evaluated op by op (``jax.disable_jit``): the same function, at less
    than half the cost of compiling it whole on the CPU."""
    j_scene = j_cornell_box(W, H)
    cfg = JCfg(max_depth=DEPTH, remat=False, backend="xla")
    loss = j_make_loss(j_scene, cfg, W, H, SPP, jnp.zeros((H, W, 3), jnp.float32),
                       spp_per_pass=SPP)
    with jax.disable_jit():
        val, grads = jax.value_and_grad(loss)(j_init_params(j_scene, PARAM_KEYS))
    return j_scene, float(val), {k: np.asarray(v) for k, v in grads.items()}


def _loss_for(keys, spp=SPP, max_depth=DEPTH, remat=True, remat_every=1):
    scene = cornell_box(W, H, device="cpu")
    cfg = MegakernelConfig(max_depth=max_depth, remat=remat, remat_every=remat_every,
                           backend="torch")
    params = init_params(scene, keys)
    return make_loss(scene, cfg, W, H, spp, torch.zeros((H, W, 3))), params


def _grads(loss, params):
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    val = loss(leaves)
    val.backward()
    return float(val.detach()), {k: v.grad.numpy() for k, v in leaves.items()}


# ---- parity with the reference ---------------------------------------------


def test_loss_and_gradients_match_reference(reference):
    """Loss to rtol 1e-5, each gradient to relative L2 <= 1e-3 with the
    same nonzero entries: albedo, both tints, the light colour and the
    environment texels (those the escaped rays map to)."""
    j_scene, j_val, j_grads = reference
    scene = scene_from_arrays(flatten_scene(j_scene), "cpu")
    cfg = MegakernelConfig(max_depth=DEPTH, backend="torch")
    loss = make_loss(scene, cfg, W, H, SPP, torch.zeros((H, W, 3)), spp_per_pass=SPP)
    val, grads = _grads(loss, init_params(scene, PARAM_KEYS))
    np.testing.assert_allclose(val, j_val, rtol=1e-5)
    for key in PARAM_KEYS:
        g, jg = grads[key], j_grads[key]
        assert g.shape == jg.shape, key
        assert np.isfinite(g).all(), key
        np.testing.assert_array_equal(g != 0, jg != 0, err_msg=key)
        assert _rel_l2(g, jg) <= 1e-3, (key, _rel_l2(g, jg))
    # the environment's gradient spreads over the texels the escaped rays
    # map to, not onto one texel
    assert (j_grads["env_image"].reshape(-1, 3) != 0).any(-1).sum() > 1


# ---- the reference's gradient tests, on the port ---------------------------


@pytest.mark.parametrize(
    "key,idx,eps",
    [
        ("albedo", (2, 0), 1e-2),  # white ceiling, R channel
        ("albedo", (5, 1), 1e-2),  # red wall, G channel (indirect only)
        ("light_color", (0, 0), 1e-2),  # spot light R
        # env_image: the entry of largest gradient, picked at run time
        ("env_image", None, 1e-2),
    ],
)
def test_fd_gradient(key, idx, eps):
    loss, params = _loss_for((key,))
    if idx is None:
        _, g = _grads(loss, params)
        g = g[key]
        idx = tuple(int(i) for i in np.unravel_index(np.abs(g).argmax(), g.shape))
        assert np.abs(g).max() > 1e-9, f"all-zero gradient for {key}"
    auto, fd = fd_gradient_check(loss, params, key, idx, eps=eps)
    assert np.isfinite(auto) and np.isfinite(fd)
    assert abs(fd) > 1e-9, f"fd gradient vanished for {key}{idx}"
    np.testing.assert_allclose(auto, fd, rtol=2e-2, atol=1e-7)


@pytest.mark.parametrize("remat_every", [1, 2])
def test_remat_grad_matches_plain(remat_every):
    """Path replay (checkpointed bounces) == the stored-activations backward."""
    loss_r, params = _loss_for(("albedo",), remat=True, remat_every=remat_every)
    loss_p, _ = _loss_for(("albedo",), remat=False)
    _, g_r = _grads(loss_r, params)
    _, g_p = _grads(loss_p, params)
    np.testing.assert_allclose(g_r["albedo"], g_p["albedo"], rtol=1e-5, atol=1e-9)


def test_grad_all_params_jointly():
    """One backward pass over albedo, light and env jointly stays finite,
    and its albedo entry equals the albedo-only gradient."""
    loss, params = _loss_for(("albedo", "light_color", "env_image"))
    _, g = _grads(loss, params)
    for k, v in g.items():
        assert np.all(np.isfinite(v)), k
    loss_a, params_a = _loss_for(("albedo",))
    _, ga = _grads(loss_a, params_a)
    np.testing.assert_allclose(g["albedo"], ga["albedo"], rtol=1e-5, atol=1e-9)


def test_optimization_step_decreases_loss():
    """A few Adam steps on albedo reduce the L2 image loss."""
    scene = cornell_box(W, H, device="cpu")
    cfg = MegakernelConfig(max_depth=2, remat=True, backend="torch")
    with torch.no_grad():
        target = render_mean(scene, cfg, W, H, 2)
    start = torch.clamp(scene.materials.albedo + 0.2, 0.0, 1.0)
    params = {"albedo": start.clone().requires_grad_(True)}
    loss = make_loss(scene, cfg, W, H, 2, target)
    opt = torch.optim.Adam(params.values(), lr=5e-2)
    losses = []
    for _ in range(3):
        opt.zero_grad()
        val = loss(params)
        val.backward()
        opt.step()
        losses.append(float(val.detach()))
    assert losses[-1] < losses[0], losses


# ---- path replay only where a gradient is taken ----------------------------


def test_replay_only_when_recording(monkeypatch):
    """trace_paths checkpoints its bounce groups only when autograd records
    (grad on and a scene tensor requiring grad): a forward render keeps the
    plain loop."""
    calls = []
    real = MK.checkpoint

    def counting(fn, *args, **kw):
        calls.append(kw)
        return real(fn, *args, **kw)

    monkeypatch.setattr(MK, "checkpoint", counting)
    loss, params = _loss_for(("albedo",), max_depth=3, remat_every=2)
    loss(params).backward()
    assert len(calls) == 2 * SPP  # groups (0, 1) and (2,) per sample
    assert all(kw["use_reentrant"] is False for kw in calls)
    calls.clear()
    with torch.no_grad():
        loss(params)
    loss({"albedo": params["albedo"].detach()})
    assert calls == []


# ---- nondiff_kernel ---------------------------------------------------------


def _rays(n=256, seed=3):
    rs = np.random.default_rng(seed)
    o = rs.uniform([-2.0, 0.0, -0.5], [2.0, 4.0, 2.0], (n, 3))
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    return f(o), f(d)


def test_nondiff_kernel_outputs_and_zero_grads():
    scene = cornell_box(W, H, device="cpu")
    tri = (scene.tri_v0, scene.tri_e0, scene.tri_e1)
    o, d = _rays()
    t_ref, i_ref = intersect_closest_raw(o, d, *tri)
    occ_ref = intersect_any(o, d, *tri, 2.0)
    o_g, d_g = o.clone().requires_grad_(True), d.clone().requires_grad_(True)
    v0_g = scene.tri_v0.clone().requires_grad_(True)
    t, i = nondiff_kernel(intersect_closest_raw)(o_g, d_g, v0_g, *tri[1:])
    occ = nondiff_kernel(intersect_any)(o_g, d_g, *tri, t_max=torch.tensor(2.0))
    assert torch.equal(t, t_ref) and torch.equal(i, i_ref) and torch.equal(occ, occ_ref)
    assert t.requires_grad and not i.requires_grad and not occ.requires_grad
    w = torch.linspace(0.5, 1.5, t.shape[0])
    (torch.where(t < BIG_T, t, 0.0) * w).sum().backward()
    for x in (o_g, d_g, v0_g):
        assert x.grad is not None and torch.isfinite(x.grad).all()
        assert not x.grad.any()
    # through the plain sweep itself, the same loss has a nonzero gradient
    o_p = o.clone().requires_grad_(True)
    t_p, _ = intersect_closest_raw(o_p, d, *tri)
    (torch.where(t_p < BIG_T, t_p, 0.0) * w).sum().backward()
    assert o_p.grad.any()


def test_nondiff_kernel_adds_nothing_without_grad(monkeypatch):
    """With grad off, or no input requiring it, the wrapped function is
    called directly: no autograd node, nothing launched or synced."""
    def refuse(*a, **k):
        raise AssertionError("autograd.Function used where no gradient is recorded")

    monkeypatch.setattr(autodiff._NonDiff, "apply", refuse)
    scene = cornell_box(W, H, device="cpu")
    o, d = _rays()
    fn = nondiff_kernel(intersect_closest_raw)
    t, _ = fn(o, d, scene.tri_v0, scene.tri_e0, scene.tri_e1)
    assert t.grad_fn is None
    with torch.no_grad():
        fn(o.requires_grad_(True), d, scene.tri_v0, scene.tri_e0, scene.tri_e1)


@pytest.mark.parametrize("wrapped", [False, True])
def test_bvh_kernel_reverse_mode(wrapped):
    """d/dscale of sum(scale * t) over the hits of the BVH closest query
    equals sum(t): the query's discrete outputs are constants of the
    differentiable weight (the reference's ``test_bvh_kernel_reverse_mode``;
    on the CPU the query is the plain sweep, here also wrapped as the card
    wraps its kernel, with rays that require grad)."""
    mesh = cornell_box_mesh(W, H, subdiv=8, use_bvh=True, device="cpu")
    assert mesh.bvh is not None
    o, d = _rays(1024)
    query = nondiff_kernel(bvh_closest_raw) if wrapped else bvh_closest_raw
    if wrapped:
        o.requires_grad_(True)
    scale = torch.tensor(2.0, requires_grad=True)
    t, _ = query(o, d, mesh)
    hit_t = torch.where(t < 1e30, t, 0.0)
    (scale * hit_t).sum().backward()
    expect = float(hit_t.detach().sum())
    assert expect > 0.0
    assert abs(float(scale.grad) - expect) < 1e-3 * max(1.0, abs(expect))
    if wrapped:
        assert not o.grad.any()


# ---- the repairs --------------------------------------------------------------


def _env_inputs():
    rs = np.random.default_rng(7)
    image = rs.uniform(0.0, 2.0, (16, 32, 3)).astype(np.float32)
    a, b = 0.7, -0.4  # a rotation about z, then about x
    rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    rot = (rx @ rz).astype(np.float32)
    d = rs.normal(size=(4096, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    axes = np.concatenate([np.eye(3), -np.eye(3)])
    return image, rot, np.concatenate([d, axes]).astype(np.float32)


def test_map_to_sphere_matches_reference():
    _, _, d = _env_inputs()
    d = np.concatenate([d, np.zeros((1, 3), np.float32)])  # the zero vector
    ju, jv = (np.asarray(x) for x in j_map_to_sphere(jnp.asarray(d)))
    u, v = (x.numpy() for x in map_to_sphere(torch.as_tensor(d)))
    np.testing.assert_allclose(u, ju, atol=1e-6, rtol=0)
    np.testing.assert_allclose(v, jv, atol=1e-6, rtol=0)
    assert u[-1] == 0.0 and v[-1] == 0.0


def test_eval_envmap_matches_reference():
    """A non-constant map under a rotation: each direction gets the texel
    the reference looks up, at 1e-6."""
    image, rot, d = _env_inputs()
    j_rad, _ = JE.eval_envmap(JE.make_envmap(image, rot, 1.5), jnp.asarray(d))
    rad = eval_envmap(make_envmap(image, rot, 1.5), torch.as_tensor(d))[0].numpy()
    np.testing.assert_allclose(rad, np.asarray(j_rad), atol=1e-6, rtol=0)
    assert len(np.unique(rad[:, 0])) > 100  # many texels, not one


def test_eval_envmap_uniform_map_unchanged():
    """A constant map gives its colour whichever way it is evaluated: the
    lookup, the shortcut of a map built constant, and with texels that
    require grad (the lookup again)."""
    scene = cornell_box(W, H, device="cpu")
    _, _, d = _env_inputs()
    d = torch.as_tensor(d)
    env = scene.env
    assert env.uniform
    a = eval_envmap(env, d)[0]
    b = eval_envmap(env._replace(uniform=False), d)[0]
    c = eval_envmap(env._replace(image=env.image.clone().requires_grad_(True)), d)[0]
    assert torch.equal(a, b) and torch.equal(a, c.detach())
    assert torch.equal(a[0], env.image[0, 0] * env.scale)


def test_mat_features_from_table_on_injected_table():
    scene = cornell_box(W, H, device="cpu")
    sc = inject_params(scene, init_params(scene, ("albedo", "refl_tint", "trans_tint")))
    assert sc.materials.trans_tint.requires_grad
    assert mat_features_from_table(sc.materials) == mat_features_from_table(scene.materials)


@pytest.mark.parametrize("mesh", [False, True])
def test_inject_params_rebuilds_kernel_tables(reference, mesh):
    """The fused kernels' tables of an injected scene equal those of a scene
    built with the new values, and carry no gradient."""
    scene = (cornell_box_mesh(W, H, subdiv=8, use_bvh=True, device="cpu") if mesh
             else cornell_box(W, H, device="cpu"))
    fields = {
        "materials.albedo": scene.materials.albedo.numpy() * 0.5 + 0.1,
        "materials.refl_tint": scene.materials.refl_tint.numpy()[::-1].copy(),
        "materials.trans_tint": scene.materials.trans_tint.numpy() * 0.9,
        "lights.color": scene.lights.color.numpy() * 2.0 + 0.5,
    }
    keys = {"materials.albedo": "albedo", "materials.refl_tint": "refl_tint",
            "materials.trans_tint": "trans_tint", "lights.color": "light_color"}
    params = {keys[k]: torch.tensor(v, requires_grad=True) for k, v in fields.items()}
    sc = inject_params(scene, params)
    j_scene = reference[0]
    if mesh:
        from cuda_optix_pathtracing_tpu.scene.procedural import cornell_box_mesh as j_mesh

        j_scene = j_mesh(W, H, subdiv=8, use_bvh=True)
    built = scene_from_arrays({**flatten_scene(j_scene), **fields}, "cpu")
    assert torch.equal(sc.shade_tables, built.shade_tables)
    assert not sc.shade_tables.requires_grad
    assert not torch.equal(sc.shade_tables, scene.shade_tables)
    if mesh:
        assert sc.brute_tables is None and torch.equal(sc.bounds, built.bounds)
    else:
        assert torch.equal(sc.brute_tables, built.brute_tables)
        assert not sc.brute_tables.requires_grad
    assert sc.materials.albedo is params["albedo"]


def test_fused_gate_refuses_unequal_texels():
    scene = cornell_box(W, H, device="cpu")
    cfg = MegakernelConfig()
    assert megakernel_cuda_supported(scene, cfg)
    same = inject_params(scene, {"env_image": scene.env.image.clone()})
    assert megakernel_cuda_supported(same, cfg)
    img = scene.env.image.clone()
    img[3, 0, 1] += 0.25
    varied = inject_params(scene, {"env_image": img})
    assert not megakernel_cuda_supported(varied, cfg)
    with pytest.raises(ValueError, match="fused='on'"):
        resolve_fused(varied, MegakernelConfig(fused="on"))
    assert resolve_fused(varied, cfg).fused == "off"


def test_injected_env_renders_its_texels():
    """A render after an environment update sees the new texels: a uniform
    map injected as a parameter renders the original image, and raising the
    texels the escaped rays map to brightens it."""
    scene = cornell_box(W, H, device="cpu")
    cfg = MegakernelConfig(max_depth=DEPTH, backend="torch")
    with torch.no_grad():
        base = render_mean(scene, cfg, W, H, SPP)
        same = render_mean(inject_params(scene, {"env_image": scene.env.image.clone()}),
                           cfg, W, H, SPP)
        brighter = render_mean(inject_params(scene, {"env_image": scene.env.image * 3.0}),
                               cfg, W, H, SPP)
    assert torch.equal(base, same)
    assert float(brighter.sum()) > float(base.sum())
