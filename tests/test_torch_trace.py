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
from cuda_optix_pathtracing_tpu_torch.ops import query as Q
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
    """``rays.query``: every ray handed to ``closest`` and ``occluded``;
    ``rays.live``: those alive, which only a recording counts."""
    cfg = MK.MegakernelConfig(max_depth=DEPTH, fused="off")
    px, py, sample, o, d, _, _ = MK.camera_batch(scene, cfg, W, H, 0)
    n = o.shape[0]

    # by hand: the closest queries see each bounce's state, the shadow
    # queries the rays NEE marks alive
    shadow_live = []
    any_plain = Q.occluded

    def spy(scene, cfg, o, d, t_max, alive=None):
        shadow_live.append(int(alive.sum()))
        return any_plain(scene, cfg, o, d, t_max, alive=alive)

    state = MK.camera_path_state(scene, cfg, o, d)
    closest_live = []
    with monkeypatch.context() as m:
        m.setattr(Q, "occluded", spy)
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


@pytest.fixture(scope="module")
def teapot():
    """``scenes/scene_test.json`` at 8², its material's normal map taken
    out: the fetch still runs for every row, but only the albedo and
    roughness maps are the material's own."""
    import dataclasses
    import os

    from cuda_optix_pathtracing_tpu_torch.scene.parser import parse_scene
    from cuda_optix_pathtracing_tpu_torch.scene.types import scene_from_host

    hs, _ = parse_scene(os.path.join(os.path.dirname(__file__), "..", "scenes", "scene_test.json"))
    hs.camera = dataclasses.replace(hs.camera, width=8, height=8)
    assert [hs.materials[0][k] for k in ("albedo_tex", "rough_tex", "normal_tex")] == [0, 2, 1]
    hs.materials[0] = {k: v for k, v in hs.materials[0].items() if k != "normal_tex"}
    return scene_from_host(hs, device="cpu")


def _teapot_cfg():
    return MK.MegakernelConfig(max_depth=DEPTH, fused="off", tri_chunk=1024)


def _teapot_trace(teapot):
    cfg = _teapot_cfg()
    px, py, sample, o, d, _, _ = MK.camera_batch(teapot, cfg, 8, 8, 0)
    return MK.trace_paths(teapot, cfg, px, py, sample, o, d, device="cpu")


def test_texture_span_opens_once_a_bounce_under_shade(scene, teapot):
    with trace.recording():
        roots = _tree(_profiled(lambda: _teapot_trace(teapot)))
        cornell = Counter(e.name for e in _profiled(lambda: _render(scene, kspp=1)))
    assert _names(roots) == ["pt.camera", "pt.trace"]
    bounces = roots[1][1]
    assert _names(bounces) == ["pt.bounce"] * DEPTH
    for _, steps in bounces:
        assert _names(steps) == ["pt.closest", "pt.shade", "pt.nee", "pt.bsdf"]
        assert _names(steps[1][1]) == ["pt.texture"]
        assert not steps[1][1][0][1]  # no span inside it
    assert cornell["pt.shade"] == DEPTH and cornell["pt.texture"] == 0


def test_texture_counters_equal_hand_counts(teapot, monkeypatch):
    """``tex.query``: every row of every bounce, once for each of the three
    fetches; ``tex.live``: the rows of live paths that hit, once for each
    map their material has (two here), which only a recording counts."""
    cfg = _teapot_cfg()
    px, py, sample, o, d, _, _ = MK.camera_batch(teapot, cfg, 8, 8, 0)
    n = o.shape[0]
    live_hits = []
    closest = Q.closest

    def spy(scene, cfg, o, d, alive=None):
        hit = closest(scene, cfg, o, d, alive=alive)
        live_hits.append(int((alive & hit.hit).sum()))
        return hit

    with monkeypatch.context() as m:
        m.setattr(Q, "closest", spy)
        state = MK.camera_path_state(teapot, cfg, o, d)
        sampler = R.Sampler(cfg.sampler, cfg.seed)
        for depth in range(DEPTH):
            state = MK.bounce_step(teapot, cfg, sampler, px, py, sample, depth, state)
    assert len(live_hits) == DEPTH and n > live_hits[0] >= live_hits[-1] > 0  # misses, deaths

    trace.reset()
    with trace.recording():
        radiance = MK.trace_paths(teapot, cfg, px, py, sample, o, d, device="cpu")
        counts = trace.snapshot()
    assert torch.equal(radiance, state.radiance)
    assert counts["tex.query"] == 3 * DEPTH * n
    assert counts["tex.live"] == 2 * sum(live_hits)

    trace.reset()
    MK.trace_paths(teapot, cfg, px, py, sample, o, d, device="cpu")
    counts = trace.snapshot()
    assert counts["tex.query"] == 3 * DEPTH * n and counts["tex.live"] == 0
    trace.reset()


def test_textured_bounce_adds_no_op_while_off(teapot, monkeypatch):
    """Off: the textured bounce runs the same ATen ops as with the span and
    the texture counters taken out, and no ``pt.`` event."""
    ops = _ops(lambda: _teapot_trace(teapot))
    assert not [name for name in ops if name.startswith("pt.")]
    with monkeypatch.context() as m:
        m.setattr(trace, "span", lambda name, **args: contextlib.nullcontext())
        m.setattr(MK, "_count_texture_rows", lambda mat, alive: None)
        assert _ops(lambda: _teapot_trace(teapot)) == ops


def test_texture_counters_count_outside_the_texture_span(teapot, monkeypatch):
    """The texture counters run under ``pt.shade`` but after ``pt.texture``
    has closed, so the span's time and launches are the fetches' alone."""
    open_spans, seen = [], []
    span, count, count_device = trace.span, trace.count, trace.count_device

    @contextlib.contextmanager
    def spy_span(name, **args):
        open_spans.append(name)
        try:
            with span(name, **args):
                yield
        finally:
            open_spans.pop()

    def spy(real):
        def counted(name, *args):
            seen.append((name, tuple(open_spans)))
            real(name, *args)

        return counted

    monkeypatch.setattr(trace, "span", spy_span)
    monkeypatch.setattr(trace, "count", spy(count))
    monkeypatch.setattr(trace, "count_device", spy(count_device))
    trace.reset()
    with trace.recording():
        _teapot_trace(teapot)
    trace.reset()
    for name in ("tex.query", "tex.live"):
        where = [spans for n, spans in seen if n == name]
        assert len(where) == DEPTH, name
        assert all(s[-2:] == ("pt.bounce", "pt.shade") for s in where), (name, where)
