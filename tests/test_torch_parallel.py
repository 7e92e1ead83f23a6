"""The port's sharded render and training step (``parallel/``), its CLI in
multi-process mode and its driver entry, on the CPU.

Shard blocks rendered in one process and concatenated are bit-equal to the
unsharded Welford loop for 2 and 8 ranks, as the reference's
``tests/test_sharded.py`` asserts for its mesh shapes; the port's film and
gradient are held to JAX's ``render_sharded``/``train_step_sharded`` on
its 8-device CPU mesh (XLA integrator) at the parity bar and at the
reference's scale-relative gradient bar; two real processes joined by
gloo give the one-process film bit for bit and the global gradient."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cuda_optix_pathtracing_tpu.models.differentiable import init_params as j_init_params
from cuda_optix_pathtracing_tpu.models.differentiable import inject_params as j_inject_params
from cuda_optix_pathtracing_tpu.models.megakernel import MegakernelConfig as JCfg
from cuda_optix_pathtracing_tpu.parallel.render import make_mesh as j_make_mesh
from cuda_optix_pathtracing_tpu.parallel.render import render_sharded as j_render_sharded
from cuda_optix_pathtracing_tpu.parallel.render import train_step_sharded as j_train_step_sharded
from cuda_optix_pathtracing_tpu.scene import cornell_box as j_cornell_box
from cuda_optix_pathtracing_tpu_torch.entry import dryrun_multidevice, entry, free_port
from cuda_optix_pathtracing_tpu_torch.models.differentiable import init_params, inject_params, make_loss
from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig, render
from cuda_optix_pathtracing_tpu_torch.ops.film import Film, film_add_sample
from cuda_optix_pathtracing_tpu_torch.parallel import distributed as D
from cuda_optix_pathtracing_tpu_torch.parallel.render import (
    Mesh,
    _render_pixels,
    make_mesh,
    render_sharded,
    train_step_sharded,
)
from cuda_optix_pathtracing_tpu_torch.scene import cornell_box, scene_from_arrays
from cuda_optix_pathtracing_tpu_torch.utils.imageio import read_png
from test_torch_bridge import flatten_scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 16
SPP = 2
DEPTH = 2
PROC_TIMEOUT_S = 240


def _parity(a, b):
    diff = np.abs(a - b)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert diff.mean() < 1e-4, diff.mean()
    assert (diff.max(-1) > 1e-3).mean() < 0.005


@pytest.fixture(scope="module")
def scene():
    return cornell_box(W, H, device="cpu")


@pytest.fixture(scope="module")
def cfg():
    return MegakernelConfig(max_depth=DEPTH, remat=True)


@pytest.fixture(scope="module")
def unsharded(scene, cfg):
    """The Welford loop over every pixel that ``render_sharded`` runs per
    block, without shards: the equality oracle."""
    ids = torch.arange(W * H)
    px, py = ids % W, ids // W
    z = torch.zeros((W * H, 3))
    film = Film(z, z.clone(), torch.zeros(()))
    for s in range(SPP):
        film = film_add_sample(film, _render_pixels(scene, cfg, px, py, s))
    return film


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's sharded film and the gradient its SGD(1.0) step applied, on
    the conftest's 8 virtual CPU devices."""
    j_scene = j_cornell_box(W, H)
    jcfg = JCfg(max_depth=DEPTH, remat=True, backend="xla")
    mesh = j_make_mesh(8)
    film = j_render_sharded(j_scene, jcfg, W, H, SPP, mesh)
    p0 = j_init_params(j_scene, ("albedo",))
    tx = optax.sgd(1.0)
    step = j_train_step_sharded(tx.update, lambda p: j_inject_params(j_scene, p), jcfg, W, H,
                                SPP, mesh)
    p1, _, loss = step(p0, tx.init(p0), jnp.zeros((H, W, 3), jnp.float32), jnp.uint32(0))
    return (j_scene, np.asarray(film.mean), np.asarray(film.m2), float(loss),
            np.asarray(p0["albedo"] - p1["albedo"]))


@pytest.mark.parametrize("n", [2, 8])
def test_shard_blocks_concatenate_to_unsharded(scene, cfg, unsharded, n):
    """Every rank's block, rendered here in turn and concatenated: the
    unsharded loop bit for bit, and so ``render(fused="off")``'s film."""
    blocks = [render_sharded(scene, cfg, W, H, SPP, Mesh(n, k), device="cpu") for k in range(n)]
    assert all(b.mean.shape == (W * H // n, 3) for b in blocks)
    assert torch.equal(torch.cat([b.mean for b in blocks]), unsharded.mean)
    assert torch.equal(torch.cat([b.m2 for b in blocks]), unsharded.m2)
    assert all(float(b.n) == SPP for b in blocks)
    whole = render(scene, W, H, SPP, cfg=MegakernelConfig(max_depth=DEPTH, fused="off"),
                   device="cpu")
    assert torch.equal(whole.mean.reshape(-1, 3), unsharded.mean)
    assert torch.equal(whole.m2.reshape(-1, 3), unsharded.m2)


def test_shards_must_divide(scene, cfg):
    with pytest.raises(ValueError, match="do not split evenly"):
        render_sharded(scene, cfg, W, H, SPP, Mesh(3, 0), device="cpu")
    with pytest.raises(ValueError, match="not a rank"):
        render_sharded(scene, cfg, W, H, SPP, Mesh(2, -1), device="cpu")


def test_sharded_film_matches_reference(jax_reference, cfg):
    """The port's 8 blocks on the reference's Cornell box against JAX's
    ``render_sharded(make_mesh(8))``, at the parity bar."""
    j_scene, j_mean, j_m2, _, _ = jax_reference
    t_scene = scene_from_arrays(flatten_scene(j_scene), "cpu")
    blocks = [render_sharded(t_scene, cfg, W, H, SPP, Mesh(8, k), device="cpu") for k in range(8)]
    _parity(torch.cat([b.mean for b in blocks]).numpy(), j_mean.reshape(-1, 3))
    _parity(torch.cat([b.m2 for b in blocks]).numpy(), j_m2.reshape(-1, 3))


def _sgd_gradient(scene, cfg, mesh):
    params = init_params(scene, ("albedo",))
    p0 = params["albedo"].detach().clone()
    opt = torch.optim.SGD(params.values(), lr=1.0)
    step = train_step_sharded(opt, lambda p: inject_params(scene, p), cfg, W, H, SPP, mesh,
                              device="cpu")
    loss = step(params, torch.zeros((H, W, 3)), 0)
    return float(loss), (p0 - params["albedo"].detach()).numpy()


def test_train_step_sharded_matches_global_and_reference(jax_reference, cfg):
    """One process (a mesh of one rank): the step's SGD(1) update is the
    gradient of ``make_loss``'s global loss; against JAX's sharded step at
    the reference's bar (rtol 1e-4, atol 1e-4·max|g|)."""
    j_scene, _, _, j_loss, j_g = jax_reference
    t_scene = scene_from_arrays(flatten_scene(j_scene), "cpu")
    loss, g = _sgd_gradient(t_scene, cfg, make_mesh())
    params = init_params(t_scene, ("albedo",))
    ref = make_loss(t_scene, cfg, W, H, SPP, torch.zeros((H, W, 3)))(params)
    ref.backward()
    g_ref = params["albedo"].grad.numpy()
    np.testing.assert_allclose(loss, float(ref.detach()), rtol=1e-6)
    np.testing.assert_allclose(g, g_ref, rtol=1e-4, atol=1e-4 * np.abs(g_ref).max())
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    np.testing.assert_allclose(g, j_g, rtol=1e-4, atol=1e-4 * np.abs(j_g).max())


def _worker_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return env


def _run_all(cmds):
    procs = [subprocess.Popen(c, env=_worker_env(), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=PROC_TIMEOUT_S)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-4000:]}"
    return outs


def test_two_processes_match_one(tmp_path, scene, cfg, unsharded):
    """Two real processes, gloo: ``render_multihost``'s assembled film is
    the one-process film bit for bit, and so is rank 0's render over a
    mesh of itself alone; the step's averaged loss and gradient are the
    global ones at the reference's bar."""
    port = free_port()
    worker = os.path.join(REPO, "tests", "torch_dist_worker.py")
    _run_all([[sys.executable, worker, str(r), "2", str(port), str(tmp_path)] for r in range(2)])
    got = torch.load(tmp_path / "rank0.pt")
    assert got["mean"].shape == (H, W, 3) and float(got["n"]) == SPP
    assert torch.equal(got["mean"].reshape(-1, 3), unsharded.mean)
    assert torch.equal(got["m2"].reshape(-1, 3), unsharded.m2)
    assert torch.equal(got["alone"], unsharded.mean)  # make_mesh(1) of a group of 2
    loss, g = _sgd_gradient(scene, cfg, make_mesh())
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-6)
    g2 = got["grad"].numpy()
    np.testing.assert_allclose(g2, g, rtol=1e-4, atol=1e-4 * np.abs(g).max())


def test_init_distributed_single_process(monkeypatch):
    """No coordinator, one process: no group, rank 0, a mesh of one."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert D.init_distributed(device="cpu") == 0
    assert D.init_distributed(num_processes=1, device="cpu") == 0
    assert not torch.distributed.is_initialized()
    assert make_mesh() == D.global_mesh() == Mesh(1, 0, "rays")
    with pytest.raises(ValueError, match="needs a torch.distributed group"):
        make_mesh(2)
    with pytest.raises(ValueError, match="coordinator"):
        D.init_distributed(num_processes=2, device="cpu")
    film = Film(torch.ones(4, 3), torch.zeros(4, 3), torch.ones(()))
    assert D.gather_film(film) is film
    with pytest.raises(ValueError, match="needs its torch.distributed group"):
        D.gather_film(film, Mesh(2, 0))


def test_torchrun_coordinator_must_be_its_store(monkeypatch):
    """Under torchrun every rank is a client of torchrun's own store: a
    coordinator at another port would hang the rendezvous, so it raises."""
    monkeypatch.setenv("TORCHELASTIC_USE_AGENT_STORE", "True")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29511")
    with pytest.raises(ValueError, match="--master-port 29612"):
        D.init_distributed("localhost:29612", 2, 0, device="cpu")
    assert not torch.distributed.is_initialized()


def test_backend_choice(monkeypatch):
    """NCCL only for CUDA ranks with a card each; gloo on the CPU and for
    ranks that share a card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert D.choose_backend("cpu", 2) == "gloo"
    assert D.choose_backend("cuda", 1) == "nccl"
    assert D.choose_backend("cuda", 2) == "gloo"


def test_cli_two_processes(tmp_path):
    """The CLI with ``--coordinator`` and two processes: rank 0's PNGs are
    byte-equal to a one-process CLI render with the same flags."""
    port = free_port()
    args = ["--scene", "cornell", "--device", "cpu", "--width", str(W), "--height", str(H),
            "--spp", "1", "--max-depth", "3", "--log-level", "warn"]
    cli = [sys.executable, "-m", "cuda_optix_pathtracing_tpu_torch.utils.cli"]
    _run_all([cli + args + ["--out", str(tmp_path / f"multi{r}.png"),
                            "--coordinator", f"localhost:{port}", "--num-processes", "2",
                            "--process-id", str(r)] for r in range(2)]
             + [cli + args + ["--out", str(tmp_path / "single.png")]])
    assert not (tmp_path / "multi1.png").exists()  # rank 0 writes
    for name in ("", "_sqrt_mse"):
        a = (tmp_path / f"multi0{name}.png").read_bytes()
        assert a == (tmp_path / f"single{name}.png").read_bytes(), name
    assert read_png(str(tmp_path / "multi0.png")).shape == (H, W, 3)


def test_entry_and_dryrun():
    """``entry()`` renders one sample batch; ``dryrun_multidevice(2)``
    runs the sharded render and an Adam step over two gloo ranks."""
    fn, args = entry(device="cpu")
    img = fn(*args)
    assert img.shape == (64, 64, 3) and bool(torch.isfinite(img).all())
    loss = dryrun_multidevice(2, device="cpu")
    assert np.isfinite(loss) and loss > 0.0


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multidevice(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.init_distributed("localhost:1", 1, 0)
    scene = cornell_box(8, 8, device="cpu")
    cfg = MegakernelConfig(max_depth=1)
    for call in (lambda: render_sharded(scene, cfg, 8, 8, 1, Mesh()),
                 lambda: D.render_multihost(scene, cfg, 8, 8, 1),
                 lambda: train_step_sharded(None, None, cfg, 8, 8, 1, Mesh())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
