#!/usr/bin/env python3
"""CPU probes of the PyTorch port, run before a chip call (no GPU needed).

    python3 cpu_probe.py ops [CHECKOUT ...]   # default: this checkout
    python3 cpu_probe.py mse [SIZE]           # default: 48

``ops``: the aten ops that one ``fused="off"`` pass runs (the Cornell
box and the mesh Cornell box at subdivision 8, 16², 2 spp in one batch,
depth 5), and a SHA-256 prefix of each film, for each checkout given: two
checkouts that run the same ops make the same launches on the card.

``mse``: the light tree against uniform selection on
``cornell_box_many_lights`` (subdivision 8) at SIZE², depth 5: each
strategy's mean squared error at 16 spp against a 128-spp tree image
(``nee_splits=2``, seed 1), and their ratio, the check ``chip_smoke.py``
phase 7 makes at 256².
"""

from __future__ import annotations

import subprocess
import sys

_OPS = r"""
import hashlib, sys, torch
from torch.profiler import ProfilerActivity, profile
torch.set_num_threads(2)
from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig, render_sample_batch
from cuda_optix_pathtracing_tpu_torch.scene import cornell_box, cornell_box_mesh
for name, scene in (("cornell", cornell_box(16, 16, device="cpu")),
                    ("mesh", cornell_box_mesh(16, 16, subdiv=8, use_bvh=True, device="cpu"))):
    cfg = MegakernelConfig(fused="off")
    render_sample_batch(scene, cfg, 16, 16, 0, nspp=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        img = render_sample_batch(scene, cfg, 16, 16, 0, nspp=2)
    n = sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))
    print(name, "aten ops", n, "film", hashlib.sha256(img.numpy().tobytes()).hexdigest()[:16])
"""


def ops(checkouts) -> None:
    for path in checkouts or ["."]:
        out = subprocess.run([sys.executable, "-c", _OPS], cwd=path, capture_output=True,
                             text=True, check=True).stdout
        for line in out.splitlines():
            if " aten ops " in line:
                print(f"{path}: {line}")


def mse(size: int) -> None:
    import torch

    from cuda_optix_pathtracing_tpu_torch.models.megakernel import (
        MegakernelConfig,
        render_sample_batch,
    )
    from cuda_optix_pathtracing_tpu_torch.ops.bsdf import mat_features_from_table
    from cuda_optix_pathtracing_tpu_torch.scene.procedural import cornell_box_many_lights

    torch.set_num_threads(4)
    scene = cornell_box_many_lights(size, size, subdiv=8, device="cpu")
    feats = mat_features_from_table(scene.materials)

    def mean(strategy, spp, seed=0, splits=1):
        cfg = MegakernelConfig(max_depth=5, light_strategy=strategy, seed=seed,
                               nee_splits=splits, features=feats)
        acc = sum(render_sample_batch(scene, cfg, size, size, k, nspp=16).sum(0)
                  for k in range(0, spp, 16))
        return acc / spp

    ref = mean("tree", 128, seed=1, splits=2)
    err = {s: float(((mean(s, 16) - ref) ** 2).mean()) for s in ("tree", "uniform")}
    print(f"{size}x{size}: tree MSE {err['tree']:.4e}, uniform {err['uniform']:.4e}, "
          f"ratio {err['tree'] / err['uniform']:.3f}")


if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in ("ops", "mse"):
        sys.exit(__doc__)
    if sys.argv[1] == "ops":
        ops(sys.argv[2:])
    else:
        mse(int(sys.argv[2]) if len(sys.argv) > 2 else 48)
