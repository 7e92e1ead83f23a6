"""The port's spans and counters (``utils/trace.py``) on the CPU: nothing
recorded and nothing added while recording is off, the span tree of an
unfused render and of a loss's backward, and the ray counters against
counts taken by hand from ``trace_paths``' states."""

import contextlib
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cuda_optix_pathtracing_tpu_torch.models import differentiable as D
from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
from cuda_optix_pathtracing_tpu_torch.ops import rng as R
from cuda_optix_pathtracing_tpu_torch.ops.film import film_new
from cuda_optix_pathtracing_tpu_torch.scene import cornell_box
from cuda_optix_pathtracing_tpu_torch.utils import trace

W = H = 16
DEPTH = 3


@pytest.fixture(scope="module")
def scene():
    return cornell_box(W, H, device="cpu")


def _render(scene, kspp=2):
    cfg = MK.MegakernelConfig(max_depth=DEPTH, fused="off")
    return MK.render_progressive(scene, film_new(H, W, "cpu"), cfg, W, H, 0, kspp, 1,
                                 device="cpu")


def _loss_backward(scene):
    loss = D.make_loss(scene, MK.MegakernelConfig(max_depth=2), W, H, 1, torch.zeros(H, W, 3))
    params = D.init_params(scene, ("albedo",))
    loss(params).backward()
    return params["albedo"].grad


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events()


def _ops(fn) -> Counter:
    return Counter(e.name for e in _profiled(fn))


def test_recording_off_records_nothing_and_adds_no_op(scene, monkeypatch):
    """Off: no ``record_function`` call (patched to raise), no ``pt.``
    event under the profiler, and the same ATen ops as with the
    instrumentation taken out."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called while recording is off")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        m.setattr(torch.autograd.profiler, "record_function", refuse)
        _render(scene, kspp=1)
        _loss_backward(scene)
    for fn in (lambda: _render(scene, kspp=1), lambda: _loss_backward(scene)):
        ops = _ops(fn)
        assert not [name for name in ops if name.startswith("pt.")]
        with monkeypatch.context() as m:
            m.setattr(trace, "span", lambda name, **args: contextlib.nullcontext())
            m.setattr(trace, "count_device", lambda name, x: None)
            assert _ops(fn) == ops


def _tree(events):
    """The ``pt.`` spans as (name, [children]) trees, in start order."""
    spans = sorted((e for e in events if e.name.startswith("pt.")),
                   key=lambda e: e.time_range.start)
    nodes = {id(e): (e.name, []) for e in spans}
    roots = []
    for e in spans:
        p = e.cpu_parent
        while p is not None and id(p) not in nodes:
            p = p.cpu_parent
        (nodes[id(p)][1] if p is not None else roots).append(nodes[id(e)])
    return roots


def _names(nodes):
    return [n for n, _ in nodes]


def test_span_tree_of_an_unfused_render(scene):
    kspp = 2
    with trace.recording():
        roots = _tree(_profiled(lambda: _render(scene, kspp)))
    assert _names(roots) == ["pt.batch"]
    batch = roots[0][1]
    assert _names(batch) == ["pt.pass", "pt.film"] * kspp
    for _, children in batch[::2]:
        assert _names(children) == ["pt.camera", "pt.trace", "pt.film"]
        bounces = children[1][1]
        assert _names(bounces) == ["pt.bounce"] * DEPTH
        for _, steps in bounces:
            assert _names(steps) == ["pt.closest", "pt.shade", "pt.nee", "pt.bsdf"]
            assert _names(steps[2][1]) == ["pt.shadow"]


def test_loss_backward_opens_replay_spans(scene):
    with trace.recording():
        events = _profiled(lambda: _loss_backward(scene))
    names = Counter(e.name for e in events if e.name.startswith("pt."))
    for span in ("pt.loss", "pt.inject", "pt.pass", "pt.camera", "pt.trace"):
        assert names[span] == 1, names
    for span in ("pt.bounce", "pt.closest", "pt.shade", "pt.nee", "pt.shadow", "pt.bsdf"):
        assert names[span] == names[span + ":replay"] == 2, names  # depth 2, one bounce a group
    assert not [n for n in names if n.endswith(":replay") and n[:-len(":replay")] not in names]


def test_ray_counters_equal_hand_counts(scene, monkeypatch):
    """``rays.query``: every ray handed to ``_closest`` and ``_any``;
    ``rays.live``: those alive, which only a recording counts."""
    cfg = MK.MegakernelConfig(max_depth=DEPTH, fused="off")
    px, py, sample, o, d, _, _ = MK.camera_batch(scene, cfg, W, H, 0)
    n = o.shape[0]

    # by hand: the closest queries see each bounce's state, the shadow
    # queries the rays NEE marks alive
    shadow_live = []
    any_plain = MK._any

    def spy(scene, cfg, o, d, t_max, alive=None):
        shadow_live.append(int(alive.sum()))
        return any_plain(scene, cfg, o, d, t_max, alive=alive)

    state = MK.camera_path_state(scene, cfg, o, d)
    closest_live = []
    with monkeypatch.context() as m:
        m.setattr(MK, "_any", spy)
        sampler = R.Sampler(cfg.sampler, cfg.seed)
        for depth in range(DEPTH):
            closest_live.append(int(state.alive.sum()))
            state = MK.bounce_step(scene, cfg, sampler, px, py, sample, depth, state)
    assert len(shadow_live) == DEPTH and closest_live[0] == n > closest_live[-1]

    trace.reset()
    with trace.recording():
        radiance = MK.trace_paths(scene, cfg, px, py, sample, o, d, device="cpu")
        counts = trace.snapshot()
    assert torch.equal(radiance, state.radiance)
    assert counts["rays.query"] == 2 * DEPTH * n
    assert counts["rays.live"] == sum(closest_live) + sum(shadow_live)

    trace.reset()
    MK.trace_paths(scene, cfg, px, py, sample, o, d, device="cpu")
    counts = trace.snapshot()
    assert counts["rays.query"] == 2 * DEPTH * n and counts["rays.live"] == 0
    trace.reset()
