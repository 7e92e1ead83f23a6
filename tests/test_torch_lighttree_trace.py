"""The light tree's span and counters (``utils/trace.py``) in the port's
unfused bounce, on the CPU: one ``pt.lighttree`` around each importance
descent (under ``pt.nee``) and around each emitter hit's pmf replay (under
``pt.shade``); ``lighttree.query`` counts every row handed to either,
``lighttree.live`` (while recording) the rows whose answer is used; films
bit-equal with recording on and off; no op added while off; nothing of the
tree in a scene that picks its lights uniformly. On the card (marked
``cuda``): a 256² tree pass on the kernel route, one ``pt_bsdf_step``
launch a bounce.

    python -m pytest --noconftest -m cuda tests/test_torch_lighttree_trace.py -q
"""

import contextlib
import dataclasses
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
from cuda_optix_pathtracing_tpu_torch.ops import query as Q
from cuda_optix_pathtracing_tpu_torch.ops import rng as R
from cuda_optix_pathtracing_tpu_torch.ops.film import film_new
from cuda_optix_pathtracing_tpu_torch.scene.procedural import cornell_box_many_lights
from cuda_optix_pathtracing_tpu_torch.utils import trace

W = H = 8
DEPTH = 4
SPP = 4
CFG = MK.MegakernelConfig(max_depth=DEPTH, fused="off", seed=2**31 + 3)
UNIFORM = dataclasses.replace(CFG, light_strategy="uniform")


@pytest.fixture(scope="module")
def scene():
    sc = cornell_box_many_lights(W, H, subdiv=4, device="cpu")
    assert sc.light_tree is not None and sc.tri_emrec is not None
    return sc


def _trace(scene, cfg=CFG):
    px, py, sample, o, d, _, _ = MK.camera_batch(scene, cfg, W, H, 0, nspp=SPP)
    return MK.trace_paths(scene, cfg, px, py, sample, o, d, device="cpu")


def _render(scene, cfg=CFG):
    return MK.render_progressive(scene, film_new(H, W, "cpu"), cfg, W, H, 0, SPP, SPP,
                                 device="cpu")


def _spans_at(monkeypatch, fn, *names):
    """Run ``fn`` recording, the open spans at each count of ``names`` and
    at each opening of ``pt.lighttree`` → [(what, open spans)]."""
    open_spans, seen = [], []
    span, count, count_device = trace.span, trace.count, trace.count_device

    @contextlib.contextmanager
    def spy_span(name, **args):
        if name == "pt.lighttree":
            seen.append((name, tuple(open_spans)))
        open_spans.append(name)
        try:
            with span(name, **args):
                yield
        finally:
            open_spans.pop()

    def spy(real):
        def counted(name, *args):
            if name in names:
                seen.append((name, tuple(open_spans)))
            real(name, *args)

        return counted

    with monkeypatch.context() as m:
        m.setattr(trace, "span", spy_span)
        m.setattr(trace, "count", spy(count))
        m.setattr(trace, "count_device", spy(count_device))
        trace.reset()
        with trace.recording():
            fn()
        trace.reset()
    return seen


def test_one_span_a_descent_and_a_replay(scene, monkeypatch):
    seen = _spans_at(monkeypatch, lambda: _trace(scene), "lighttree.query", "lighttree.live")
    spans = [s for n, s in seen if n == "pt.lighttree"]
    assert len(spans) == 2 * DEPTH
    # per bounce: the replay under pt.shade, then the descent under pt.nee,
    # neither inside another span of its stage
    assert [s[-1] for s in spans] == ["pt.shade", "pt.nee"] * DEPTH
    assert all(s[-2] == "pt.bounce" for s in spans)
    # the counters count after the span closes, in the same stage
    for name in ("lighttree.query", "lighttree.live"):
        where = [s for n, s in seen if n == name]
        assert [s[-1] for s in where] == ["pt.shade", "pt.nee"] * DEPTH, name
    with trace.recording():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _trace(scene)
    assert Counter(e.name for e in prof.events())["pt.lighttree"] == 2 * DEPTH


def test_counters_equal_hand_counts(scene, monkeypatch):
    """``lighttree.query``: every row, twice a bounce (the replay, the
    descent); ``lighttree.live``: a descent's live paths that hit, a
    replay's live paths that hit an emissive triangle with a record."""
    cfg = CFG
    px, py, sample, o, d, _, _ = MK.camera_batch(scene, cfg, W, H, 0, nspp=SPP)
    n = o.shape[0]
    live_hits, emitter_hits = [], []
    closest = Q.closest

    def spy(sc, cfg, o, d, alive=None):
        hit = closest(sc, cfg, o, d, alive=alive)
        live = alive & hit.hit
        live_hits.append(int(live.sum()))
        emitter_hits.append(int((live & (sc.tri_emrec[hit.tri] >= 0)).sum()))
        return hit

    with monkeypatch.context() as m:
        m.setattr(Q, "closest", spy)
        state = MK.camera_path_state(scene, cfg, o, d)
        sampler = R.Sampler(cfg.sampler, cfg.seed)
        for depth in range(DEPTH):
            state = MK.bounce_step(scene, cfg, sampler, px, py, sample, depth, state)
    assert len(live_hits) == DEPTH and n >= live_hits[0] > live_hits[-1] > 0  # deaths
    assert sum(emitter_hits) > 0  # some paths reach the quads

    trace.reset()
    with trace.recording():
        radiance = MK.trace_paths(scene, cfg, px, py, sample, o, d, device="cpu")
        counts = trace.snapshot()
    assert torch.equal(radiance, state.radiance)
    assert counts["lighttree.query"] == 2 * DEPTH * n
    assert counts["lighttree.live"] == sum(live_hits) + sum(emitter_hits)

    trace.reset()
    MK.trace_paths(scene, cfg, px, py, sample, o, d, device="cpu")
    counts = trace.snapshot()
    assert counts["lighttree.query"] == 2 * DEPTH * n and counts["lighttree.live"] == 0
    trace.reset()


def test_films_equal_with_recording_on_and_off(scene):
    off = _render(scene)
    with trace.recording():
        on = _render(scene)
    trace.reset()
    assert torch.equal(on.mean, off.mean) and torch.equal(on.m2, off.m2)
    assert float(off.mean.mean()) > 0.0


def test_tree_bounce_adds_no_op_while_off(scene, monkeypatch):
    """Off: the same ATen ops as with the span and the tree's counters
    taken out, and no ``pt.`` event."""
    def ops():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _trace(scene)
        return Counter(e.name for e in prof.events())

    got = ops()
    assert not [name for name in got if name.startswith("pt.")]
    with monkeypatch.context() as m:
        m.setattr(trace, "span", lambda name, **args: contextlib.nullcontext())
        m.setattr(MK, "_count_tree_rows", lambda alive, rec_of_tri=None: None)
        assert ops() == got


def test_uniform_scene_has_no_tree_span_or_counter(scene, monkeypatch):
    seen = _spans_at(monkeypatch, lambda: _trace(scene, UNIFORM), "lighttree.query",
                     "lighttree.live")
    assert seen == []
    trace.reset()
    with trace.recording():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _trace(scene, UNIFORM)
        counts = trace.snapshot()
    trace.reset()
    assert not [e for e in prof.events() if e.name == "pt.lighttree"]
    assert not [k for k, v in counts.items() if k.startswith("lighttree.") and v]


@pytest.mark.cuda
def test_tree_pass_on_the_kernel_route_launches_one_bsdf_step_a_bounce():
    """The benchmark's tree pass (256², spheres 64², 32 spp in one pass) on
    the kernel route: one ``pt_bsdf_step`` a bounce, both tree stages a
    bounce over every row, a finite film."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    size, spp = 256, 32
    scene = cornell_box_many_lights(size, size, subdiv=64, device="cuda")
    cfg = MK.resolve_fused(scene, MK.MegakernelConfig())
    assert cfg.fused == "off" and MK._tree_on(cfg, scene)
    before = trace.snapshot()
    img = MK.render_sample_batch(scene, cfg, size, size, 0, nspp=spp)
    torch.cuda.synchronize()
    after = trace.snapshot()
    assert after["launches.bsdf_step"] - before["launches.bsdf_step"] == cfg.max_depth
    assert after["lighttree.query"] - before["lighttree.query"] == 2 * cfg.max_depth * size * size * spp
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
