"""The port's CLI renders the Cornell boxes and scene files on the CPU and
writes both PNGs; ``--checkpoint`` resumes a film."""

import json

import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu_torch.utils import cli
from cuda_optix_pathtracing_tpu_torch.utils.checkpoint import load_film
from cuda_optix_pathtracing_tpu_torch.utils.imageio import read_png

torch.set_num_threads(2)

ARGS = ["--scene", "cornell", "--device", "cpu", "--width", "16", "--height", "16",
        "--max-depth", "3", "--kspp", "2", "--log-level", "warning"]


def test_cli_writes_pngs(tmp_path):
    out = tmp_path / "img" / "render.png"
    assert cli.main(ARGS + ["--spp", "2", "--out", str(out)]) == 0
    mean = read_png(str(out))
    err = read_png(str(tmp_path / "img" / "render_sqrt_mse.png"))
    assert mean.shape == (16, 16, 3) and err.shape == (16, 16, 3)
    assert mean.dtype == np.uint8 and mean.mean() > 0


def test_cli_checkpoint_resumes(tmp_path):
    ck = str(tmp_path / "film.npz")
    out = str(tmp_path / "r.png")
    assert cli.main(ARGS + ["--spp", "2", "--out", out, "--checkpoint", ck]) == 0
    film, seed = load_film(ck)
    assert float(film.n) == 2 and seed == 0
    assert cli.main(ARGS + ["--spp", "4", "--out", out, "--checkpoint", ck]) == 0
    assert float(load_film(ck)[0].n) == 4


def test_cli_renders_mesh_scene(tmp_path):
    out = tmp_path / "mesh.png"
    args = ["--scene", "cornell-mesh", "--device", "cpu", "--width", "16", "--height", "16",
            "--spp", "1", "--max-depth", "2", "--log-level", "warning", "--out", str(out)]
    assert cli.main(args) == 0
    mean = read_png(str(out))
    assert mean.shape == (16, 16, 3) and mean.mean() > 0
    assert read_png(str(tmp_path / "mesh_sqrt_mse.png")).shape == (16, 16, 3)


def test_cli_halton_sampler(tmp_path):
    out = tmp_path / "halton.png"
    args = ["--scene", "cornell", "--device", "cpu", "--width", "16", "--height", "16",
            "--spp", "1", "--max-depth", "3", "--sampler", "halton", "--log-level", "warning",
            "--out", str(out)]
    assert cli.main(args) == 0
    assert read_png(str(out)).mean() > 0
    with pytest.raises(SystemExit):
        cli.main(["--sampler", "sobol"])


def test_cli_refuses_unported_scenes(tmp_path):
    """A scene file renders: its film size (256²) comes from the file, the
    sample count and depth from the flags."""
    out = tmp_path / "pbrt.png"
    args = ["--scene", "scenes/cornell-box.pbrt", "--device", "cpu", "--spp", "1",
            "--max-depth", "2", "--log-level", "warning", "--out", str(out)]
    assert cli.main(args) == 0
    mean = read_png(str(out))
    assert mean.shape == (256, 256, 3) and mean.mean() > 0
    assert read_png(str(tmp_path / "pbrt_sqrt_mse.png")).shape == (256, 256, 3)


def test_cli_refuses_instanced_scene(tmp_path):
    """An object the world places under two transforms becomes an instance
    group, which the port renders now: the CLI writes its image."""
    doc = {
        "materials": [{"name": "m", "diffuse": [0.5, 0.5, 0.5]}],
        "objects": [{"name": "box", "type": "primitive", "shape": "cube", "material": "m"}],
        "transforms": [
            {"name": "a", "srt": {"translation-vector": [0, 2, 0]}},
            {"name": "b", "srt": {"translation-vector": [1, 2, 0]}},
        ],
        "world": {"a": {"instances": ["box"]}, "b": {"instances": ["box"]}},
    }
    path = tmp_path / "twice.json"
    path.write_text(json.dumps(doc))
    assert cli.main(ARGS + ["--scene", str(path), "--out", str(tmp_path / "x.png")]) == 0
    assert read_png(str(tmp_path / "x.png")).ndim == 3
