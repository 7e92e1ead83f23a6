"""One rank of the port's two-process tests (``test_torch_parallel.py``),
on the CPU with gloo. Imports only the port (the suite's conftest, which
configures JAX, is not loaded in a subprocess):

    python tests/torch_dist_worker.py <rank> <world> <port> <out_dir>

Every rank renders the Cornell box (16², depth 2, 2 spp) with
``render_multihost`` and takes one ``train_step_sharded`` step with SGD at
lr 1; rank 0 writes the assembled film, the averaged loss, the applied
gradient and its render over a mesh of itself alone (``make_mesh(1)``) to
``<out_dir>/rank0.pt``.
"""

import sys

import torch

W = H = 16
SPP = 2
DEPTH = 2


def main() -> int:
    rank, world, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(2)

    import torch.distributed as dist

    from cuda_optix_pathtracing_tpu_torch.models.differentiable import init_params, inject_params
    from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig
    from cuda_optix_pathtracing_tpu_torch.parallel.distributed import (
        init_distributed,
        render_multihost,
    )
    from cuda_optix_pathtracing_tpu_torch.parallel.render import (
        make_mesh,
        render_sharded,
        train_step_sharded,
    )
    from cuda_optix_pathtracing_tpu_torch.scene import cornell_box

    assert init_distributed(f"localhost:{port}", world, rank, device="cpu") == rank
    assert init_distributed() == rank  # a no-op inside the group
    assert dist.get_backend() == "gloo" and dist.get_world_size() == world
    try:
        scene = cornell_box(W, H, device="cpu")
        cfg = MegakernelConfig(max_depth=DEPTH, remat=True)
        film = render_multihost(scene, cfg, W, H, SPP, device="cpu")
        params = init_params(scene, ("albedo",))
        p0 = params["albedo"].detach().clone()
        opt = torch.optim.SGD(params.values(), lr=1.0)
        step = train_step_sharded(opt, lambda p: inject_params(scene, p), cfg, W, H, SPP,
                                  make_mesh(), device="cpu")
        loss = step(params, torch.zeros((H, W, 3)), 0)
        first = make_mesh(1)  # a mesh of rank 0 alone: every rank calls it
        assert (first.size, first.rank) == (1, 0 if rank == 0 else -1)
        if rank == 0:
            alone = render_sharded(scene, cfg, W, H, SPP, first, device="cpu")
            torch.save({"mean": film.mean, "m2": film.m2, "n": film.n, "loss": loss,
                        "grad": p0 - params["albedo"].detach(), "alone": alone.mean},
                       f"{out_dir}/rank0.pt")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
