"""The comparison that decides ``correct`` has teeth: on tiny CPU cells held
to the real cells' limits, the bfloat16 control fails it, and so does a
run whose timed path is broken underneath (a state left unchanged, half of
the batch left out with the mean taken over the rest, an answer altered
where it is produced). A sound run passes."""

from __future__ import annotations

import pytest

from pt_bench import check, faults, harness

from .ptbench_cells import make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, hook=None):
    return harness.run(cell, 2**31 + 3, 0.5, False, device="cpu", root=root, traffic_hook=hook)


@pytest.mark.parametrize("cell", ["tiny.render", "tiny.render_pass", "tiny.grad"])
def test_bfloat16_control_fails(root, cell):
    r = harness.run(cell, 2**31 + 9, 0.5, False, device="cpu", root=root, control=True)
    assert r["correct"] is True, r["checks"]
    ok, checks = check.verdict(r["control"], harness.load_cell(cell, root).limits)
    assert not ok, checks


@pytest.mark.parametrize("cell", ["tiny.render", "tiny.render_pass", "tiny.grad"])
@pytest.mark.parametrize("fault", faults.NAMES)
def test_broken_timed_path_is_not_correct(root, cell, fault):
    hook, undo = faults.plant(fault)
    try:
        r = _run(root, cell, hook)
    finally:
        undo()
    assert r["correct"] is False, r["checks"]


def test_sound_run_is_correct(root):
    assert _run(root, "tiny.render")["correct"] is True
