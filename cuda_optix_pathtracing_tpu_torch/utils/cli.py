"""CLI renderer (counterpart of the reference ``utils/cli.py``): parse
flags → build the scene → progressive render with per-batch stats →
write the mean and sqrt-MSE PNGs.

Run as: ``python -m cuda_optix_pathtracing_tpu_torch.utils.cli --scene cornell``
(``--device cuda`` is the default; ``--device cpu`` runs the plain path).
Scenes: ``cornell`` (26 triangles), ``cornell-mesh`` (the same box with
finely tessellated spheres, subdivision 48: 9,034 triangles and a BVH), or
a scene file: ``.pbrt`` (``scene/pbrt.py``) or JSON (``scene/parser.py``),
e.g. ``--scene scenes/scene_test.json``. A file sets the film size; its
sample count replaces the default ``--spp``, and a JSON file's
``max-depth`` replaces ``--max-depth``.

Multi-process: with ``--coordinator host:port --num-processes N
--process-id R`` (or under ``torchrun``, whose environment fills in what
is left out) each process renders its block of pixels
(``parallel.distributed.render_multihost``), the film is assembled on
every rank and rank 0 writes the PNGs. That branch renders the whole
``--spp`` at once: no checkpoint resume, no partial images.
"""

from __future__ import annotations

import os
import sys


def main(argv=None) -> int:
    from .config import DEFAULT_SPP, parse_args

    cfg = parse_args(argv)

    import torch

    from .._device import resolve_device
    from .logging import get_logger

    log = get_logger(level=cfg.log_level)
    device = resolve_device(cfg.device)
    multi = bool(cfg.coordinator or cfg.num_processes)
    rank = 0
    if multi:
        from ..parallel.distributed import init_distributed

        rank = init_distributed(
            cfg.coordinator or None,
            cfg.num_processes or None,
            cfg.process_id if cfg.process_id >= 0 else None,
            device=device,
        )
    try:
        return _render(cfg, device, log, multi, rank, DEFAULT_SPP)
    finally:
        if multi and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _render(cfg, device, log, multi: bool, rank: int, default_spp: int) -> int:
    import torch

    from ..models.megakernel import MegakernelConfig, render
    from ..ops.bsdf import mat_features_from_table
    from ..ops.film import film_sqrt_mse, srgb_encode, to_uint8
    from ..scene import cornell_box, cornell_box_mesh
    from .checkpoint import load_film, save_film
    from .imageio import write_png
    from .timers import AvgAndTotalTimer

    if cfg.scene == "cornell":
        scene = cornell_box(cfg.width, cfg.height, device=device)
    elif cfg.scene == "cornell-mesh":
        scene = cornell_box_mesh(cfg.width, cfg.height, device=device)
    elif cfg.scene.endswith(".pbrt"):
        from ..scene.pbrt import load_pbrt

        scene, meta = load_pbrt(cfg.scene, device=device)
        cfg.width, cfg.height = meta.width, meta.height
        if meta.spp and cfg.spp == default_spp:
            cfg.spp = meta.spp
    else:
        from ..scene.parser import load_scene

        scene, parsed = load_scene(cfg.scene, device=device)
        cfg.width, cfg.height = parsed.width, parsed.height
        if parsed.spp and cfg.spp == default_spp:
            cfg.spp = parsed.spp
        if parsed.max_depth:
            cfg.max_depth = parsed.max_depth
    log.info(
        "scene=%s %dx%d spp=%d depth=%d sampler=%s device=%s",
        cfg.scene, cfg.width, cfg.height, cfg.spp, cfg.max_depth, cfg.sampler,
        device,
    )
    mk = MegakernelConfig(
        max_depth=cfg.max_depth, sampler=cfg.sampler, seed=cfg.seed,
        features=mat_features_from_table(scene.materials),
    )

    film = None
    if cfg.checkpoint and os.path.exists(cfg.checkpoint):
        film, _ = load_film(cfg.checkpoint, device)
        log.info("resumed film at %d spp from %s", int(film.n), cfg.checkpoint)

    npix = cfg.width * cfg.height
    timer = AvgAndTotalTimer().start()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def write_outputs(f, out_path):
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        write_png(out_path, to_uint8(srgb_encode(f.mean)).cpu().numpy())
        base, ext = os.path.splitext(out_path)
        write_png(
            f"{base}_sqrt_mse{ext}",
            to_uint8(srgb_encode(film_sqrt_mse(f))).cpu().numpy(),
        )

    if multi:
        # pixels sharded over the ranks, the film assembled on every rank;
        # rank 0 writes the outputs
        if film is not None:
            log.warning(
                "--checkpoint resume is not supported in multi-process mode; "
                "re-rendering %d spp from scratch", cfg.spp,
            )
        if cfg.save_partial:
            log.warning(
                "--save-partial / kspp batching is not supported in "
                "multi-process mode; only the final image is written"
            )
        from ..parallel.distributed import render_multihost

        film = render_multihost(scene, mk, cfg.width, cfg.height, cfg.spp, device=device)
        sync()
        timer.lap()
        if rank == 0:
            write_outputs(film, cfg.out)
            log.info("wrote %s (total %.1fs)", cfg.out, timer.total)
        return 0

    def on_batch(f, done):
        sync()
        timer.lap()
        log.info(
            "spp %d/%d  %.2f Mpaths/s (ema, host clock on %s)  total %.1fs",
            done, cfg.spp, npix * cfg.kspp / max(timer.ema, 1e-9) / 1e6, device, timer.total,
        )
        if cfg.save_partial:
            base, ext = os.path.splitext(cfg.out)
            write_outputs(f, f"{base}_spp{done}{ext}")
        if cfg.checkpoint:
            save_film(cfg.checkpoint, f, cfg.seed)

    film = render(
        scene, cfg.width, cfg.height, cfg.spp,
        cfg=mk, kspp=cfg.kspp, film=film, progress_cb=on_batch, device=device,
    )
    write_outputs(film, cfg.out)
    log.info("wrote %s (total %.1fs)", cfg.out, timer.total)
    return 0


if __name__ == "__main__":
    sys.exit(main())
