"""The port's utilities on the CPU: the NaN guard (``MegakernelConfig.debug``;
the reference's two ``tests/test_debug.py`` tests on the port), the logger's
levels and rank tag, the timer's moving average, the RMSE metric against
the reference's on seeded arrays, and the CLI's multi-process flags."""

import logging
import time

import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu.utils import rmse as j_rmse
from cuda_optix_pathtracing_tpu_torch.models.differentiable import inject_params
from cuda_optix_pathtracing_tpu_torch.models.megakernel import MegakernelConfig, render
from cuda_optix_pathtracing_tpu_torch.scene import cornell_box
from cuda_optix_pathtracing_tpu_torch.utils import logging as tlog
from cuda_optix_pathtracing_tpu_torch.utils import rmse
from cuda_optix_pathtracing_tpu_torch.utils.config import parse_args
from cuda_optix_pathtracing_tpu_torch.utils.imageio import write_png
from cuda_optix_pathtracing_tpu_torch.utils.timers import AvgAndTotalTimer

torch.set_num_threads(2)


# ---- NaN guard: the reference's tests, on the port --------------------------


def _cfg(**kw):
    return MegakernelConfig(max_depth=2, remat=False, fused="off", debug=True, **kw)


def _poisoned(scene):
    albedo = scene.materials.albedo.clone()
    albedo[0, 0] = float("nan")
    return inject_params(scene, {"albedo": albedo})


def test_nan_guard_fires_on_poisoned_material():
    scene = _poisoned(cornell_box(8, 8, device="cpu"))
    with pytest.raises(FloatingPointError, match=r"^NaN guard: film holds \d+ non-finite values "
                                                 r"after sample batch ending at spp=1"):
        render(scene, 8, 8, 1, cfg=_cfg(), kspp=1, device="cpu")


def test_nan_guard_quiet_on_clean_scene():
    scene = cornell_box(8, 8, device="cpu")
    film = render(scene, 8, 8, 1, cfg=_cfg(), kspp=1, device="cpu")
    assert bool(torch.isfinite(film.mean).all())


def test_nan_guard_off_by_default():
    """Without ``debug`` the poisoned film comes back unchecked, and the
    guard names the batch it fires after."""
    scene = _poisoned(cornell_box(8, 8, device="cpu"))
    cfg = MegakernelConfig(max_depth=2, fused="off")
    assert not cfg.debug
    film = render(scene, 8, 8, 2, cfg=cfg, kspp=1, device="cpu")
    assert not bool(torch.isfinite(film.mean).all())
    with pytest.raises(FloatingPointError, match="spp=2"):
        render(scene, 8, 8, 2, cfg=_cfg(), kspp=2, device="cpu")


# ---- logging ------------------------------------------------------------


def test_log_levels_and_rank_tag(capsys):
    assert logging.getLevelName(tlog.TRACE) == "TRACE"
    for name, level in (("trace", 5), ("debug", logging.DEBUG), ("info", logging.INFO),
                        ("warn", logging.WARNING), ("warning", logging.WARNING),
                        ("error", logging.ERROR), ("unknown", logging.INFO)):
        assert tlog.get_logger("dtpt-test", name).level == level
    log = tlog.get_logger("dtpt-test", "trace")
    assert len(log.handlers) == 1 and not log.propagate
    tlog.get_logger("dtpt-test", "trace")
    assert len(log.handlers) == 1  # the handler is installed once
    log.log(tlog.TRACE, "a trace record")
    log.debug("a debug record")
    err = capsys.readouterr().err
    assert "TRACE dtpt-test: a trace record" in err and "dtpt-test: a debug record" in err
    assert "[h" not in err  # no group: no rank tag


def test_rank_tag_in_a_group(monkeypatch, capsys):
    """Inside a group of more than one rank every record carries ``[h<rank>]``,
    read when the record is written."""
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    assert tlog.rank_tag() == "[h1]"
    tlog.get_logger("dtpt-test-rank", "info").info("hello")
    assert "[h1]dtpt-test-rank: hello" in capsys.readouterr().err
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    assert tlog.rank_tag() == ""


# ---- timer --------------------------------------------------------------


def test_timer_ema(monkeypatch):
    clock = iter([10.0, 11.0, 13.0, 17.0, 18.0, 18.5])
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    t = AvgAndTotalTimer(alpha=0.5).start()
    assert t.lap() == 1.0 and t.ema == 1.0  # the first lap seeds the average
    assert t.lap() == 2.0 and t.ema == 1.5
    assert t.lap() == 4.0 and t.ema == 2.75
    assert t.laps == 3 and t.total == 7.0
    with t:  # restarts at 18.0, laps at 18.5
        pass
    assert t.laps == 4 and t.total == 7.5 and t.ema == 0.5 * 0.5 + 0.5 * 2.75


# ---- RMSE ---------------------------------------------------------------


def test_rmse_matches_reference():
    rs = np.random.default_rng(7)
    img = rs.uniform(size=(24, 20, 3))
    ref = rs.uniform(size=(24, 20, 3))
    np.testing.assert_array_equal(rmse.rmse_image(img, ref), j_rmse.rmse_image(img, ref))
    assert rmse.mean_rmse(img, ref) == j_rmse.mean_rmse(img, ref)
    assert rmse.mean_rmse(img, img) == 0.0
    with pytest.raises(ValueError, match="shape mismatch"):
        rmse.mean_rmse(img, ref[:, :10])


def test_load_unit_rgb_and_main(tmp_path, capsys):
    """``load_unit_rgb`` on PNGs the port writes (RGB, grey, RGBA) agrees
    with the reference's loader; ``main`` prints the mean RMSE and writes
    the map."""
    rs = np.random.default_rng(3)
    a = rs.integers(0, 256, (12, 10, 3), dtype=np.uint8)
    b = rs.integers(0, 256, (12, 10, 3), dtype=np.uint8)
    grey = rs.integers(0, 256, (12, 10), dtype=np.uint8)
    rgba = rs.integers(0, 256, (12, 10, 4), dtype=np.uint8)
    paths = {}
    for name, img in (("a", a), ("b", b), ("grey", grey), ("rgba", rgba)):
        paths[name] = str(tmp_path / f"{name}.png")
        write_png(paths[name], img)
    np.testing.assert_array_equal(rmse.load_unit_rgb(paths["a"]), a / 255.0)
    np.testing.assert_array_equal(rmse.load_unit_rgb(paths["grey"]),
                                  np.repeat(grey[:, :, None], 3, axis=2) / 255.0)
    np.testing.assert_array_equal(rmse.load_unit_rgb(paths["rgba"]), rgba[:, :, :3] / 255.0)
    for name in paths.values():
        np.testing.assert_array_equal(rmse.load_unit_rgb(name), j_rmse.load_unit_rgb(name))
    out = str(tmp_path / "map.png")
    assert rmse.main([paths["a"], paths["b"], "--save-rmse", out]) == 0
    printed = float(capsys.readouterr().out.strip())
    assert printed == rmse.mean_rmse(a / 255.0, b / 255.0)
    assert rmse.load_unit_rgb(out).shape == (12, 10, 3)


# ---- CLI flags ----------------------------------------------------------


def test_cli_flags():
    cfg = parse_args(["--log-level", "trace", "--mesh", "4", "--coordinator", "localhost:1234",
                      "--num-processes", "2", "--process-id", "1"])
    assert (cfg.log_level, cfg.mesh, cfg.coordinator, cfg.num_processes, cfg.process_id) == (
        "trace", 4, "localhost:1234", 2, 1)
    d = parse_args([])
    assert (d.coordinator, d.num_processes, d.process_id, d.mesh) == ("", 0, -1, 0)
    for level in ("warn", "warning", "error", "debug", "info"):
        assert parse_args(["--log-level", level]).log_level == level
    with pytest.raises(SystemExit):
        parse_args(["--log-level", "verbose"])
