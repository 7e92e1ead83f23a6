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
"""

from __future__ import annotations

import logging
import os
import sys
import time


def main(argv=None) -> int:
    from .config import DEFAULT_SPP, parse_args

    cfg = parse_args(argv)

    from .._device import resolve_device
    from ..models.megakernel import MegakernelConfig, render
    from ..ops.bsdf import mat_features_from_table
    from ..ops.film import film_sqrt_mse, srgb_encode, to_uint8
    from ..scene import cornell_box, cornell_box_mesh
    from .checkpoint import load_film, save_film
    from .imageio import write_png

    logging.basicConfig(
        level=getattr(logging, cfg.log_level.upper()),
        format="%(asctime)s %(levelname)s %(message)s",
    )
    log = logging.getLogger("dtpt-torch")
    device = resolve_device(cfg.device)

    if cfg.scene == "cornell":
        scene = cornell_box(cfg.width, cfg.height, device=device)
    elif cfg.scene == "cornell-mesh":
        scene = cornell_box_mesh(cfg.width, cfg.height, device=device)
    elif cfg.scene.endswith(".pbrt"):
        from ..scene.pbrt import load_pbrt

        scene, meta = load_pbrt(cfg.scene, device=device)
        cfg.width, cfg.height = meta.width, meta.height
        if meta.spp and cfg.spp == DEFAULT_SPP:
            cfg.spp = meta.spp
    else:
        from ..scene.parser import load_scene

        scene, parsed = load_scene(cfg.scene, device=device)
        cfg.width, cfg.height = parsed.width, parsed.height
        if parsed.spp and cfg.spp == DEFAULT_SPP:
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
    t_start = time.perf_counter()
    t_last = [t_start, int(film.n) if film is not None else 0]

    def write_outputs(f, out_path):
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        write_png(out_path, to_uint8(srgb_encode(f.mean)).cpu().numpy())
        base, ext = os.path.splitext(out_path)
        write_png(
            f"{base}_sqrt_mse{ext}",
            to_uint8(srgb_encode(film_sqrt_mse(f))).cpu().numpy(),
        )

    def on_batch(f, done):
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)
        now = time.perf_counter()
        rate = npix * (done - t_last[1]) / max(now - t_last[0], 1e-9) / 1e6
        t_last[:] = [now, done]
        log.info(
            "spp %d/%d  %.2f Mpaths/s (this batch, host clock on %s)  total %.1fs",
            done, cfg.spp, rate, device, now - t_start,
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
    log.info("wrote %s (total %.1fs)", cfg.out, time.perf_counter() - t_start)
    return 0


if __name__ == "__main__":
    sys.exit(main())
