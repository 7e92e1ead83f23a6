"""The span window's reduction (``spans.attribute``) on synthetic events:
the label of a gap is the innermost span open at its midpoint on the
thread that launched the kernel ending it, an autograd node's forward
span with ``[bwd]`` by sequence number, or ``outside``; the labels' idle
seconds sum to the window's."""

from __future__ import annotations

import pytest

from pt_bench import spans
from pt_bench.spans import Event

MS = 1_000_000  # ns


def span(name, thread, start, end):
    return Event("span", name, thread, start * MS, end * MS)


def kernel(thread, start, end, launch):
    return Event("kernel", "k", thread, start * MS, end * MS, launch=launch * MS)


def window(start, end):
    return Event("window", spans.WINDOW, 1, start * MS, end * MS)


def idle_ms(att):
    return {spans.SEP.join(p): round(v * 1e3, 6) for p, v in att.idle.items()}


def test_innermost_span_on_the_launching_thread_at_the_midpoint():
    events = [
        window(0, 100),
        span("pt.pass", 1, 0, 100), span("pt.camera", 1, 10, 30), span("pt.film", 1, 40, 60),
        span("pt.bounce", 2, 0, 100),  # another thread, open throughout
        kernel(1, 0, 10, 0),
        kernel(1, 30, 40, 25),  # gap 10-30, midpoint 20: pt.camera
        kernel(2, 60, 70, 55),  # gap 40-60 ended by thread 2's launch: pt.bounce
        kernel(1, 90, 100, 65),  # gap 70-90, midpoint 80: back in pt.pass
    ]
    att = spans.attribute(events)
    assert idle_ms(att) == {"pt.pass>pt.camera": 20.0, "pt.bounce": 20.0, "pt.pass": 20.0}
    # each kernel under the label of its launch
    assert att.kernels == {("pt.pass",): 2, ("pt.pass", "pt.camera"): 1, ("pt.bounce",): 1}
    assert att.launches(spans.leaf("pt.camera")) == 1
    assert att.spans == {"pt.pass", "pt.camera", "pt.film", "pt.bounce"}


def test_backward_node_takes_its_forward_span_by_sequence_number():
    events = [
        window(0, 100),
        span("pt.loss", 1, 0, 40), span("pt.shade", 1, 10, 20),
        Event("op", "aten::where", 1, 12 * MS, 13 * MS, seq=7),
        Event("op", "aten::mul", 1, 30 * MS, 31 * MS, seq=8),  # in pt.loss only
        # the backward thread: nodes of seq 7 and 8, one of no forward op,
        # and the replay's recomputed bounce
        Event("node", spans.NODE + "WhereBackward0", 2, 50 * MS, 60 * MS, seq=7, fwd_thread=1),
        Event("node", spans.NODE + "MulBackward0", 2, 60 * MS, 70 * MS, seq=8, fwd_thread=1),
        Event("node", spans.NODE + "AddBackward0", 2, 70 * MS, 80 * MS, seq=99, fwd_thread=1),
        span("pt.bounce:replay", 2, 80, 90),
        kernel(1, 0, 50, 0),
        kernel(2, 54, 56, 53),  # gap 50-54: WhereBackward0 → pt.shade
        kernel(2, 66, 68, 65),  # gap 56-66: MulBackward0 → pt.loss
        kernel(2, 74, 76, 73),  # gap 68-74: no forward op → backward
        kernel(2, 86, 88, 85),  # gap 76-86, midpoint 81: the replay span
        kernel(1, 98, 100, 97),  # gap 88-98: thread 1 in no span and no node
    ]
    att = spans.attribute(events)
    assert idle_ms(att) == {"pt.loss>pt.shade[bwd]": 4.0, "pt.loss[bwd]": 10.0,
                            "backward": 6.0, "pt.bounce:replay": 10.0, "outside": 10.0}
    assert att.share(spans.is_backward) == pytest.approx(100.0 * 30 / 40)
    assert att.launches(spans.is_backward) == 4
    assert att.share(spans.leaf(spans.OUTSIDE)) == pytest.approx(25.0)


def test_outside_and_the_window_edges():
    events = [
        window(0, 100),
        span("pt.batch", 1, 20, 60), span("pt.bounce", 1, 25, 35),
        kernel(1, 10, 20, 5),  # leading gap 0-10, midpoint 5: outside any span
        kernel(1, 40, 50, 30),  # gap 20-40, midpoint 30: pt.bounce
        # gap 50-80, midpoint 65: pt.batch has closed
        Event("copy", "Memcpy DtoH", 1, 80 * MS, 85 * MS, launch=70 * MS),
        kernel(None, 86, 90, 86),  # a launch whose thread was not found
    ]
    att = spans.attribute(events)
    assert idle_ms(att) == {"outside": 10.0 + 30.0 + 10.0, "pt.batch>pt.bounce": 20.0,
                            "unresolved": 1.0}
    assert att.share(spans.under("pt.bounce")) == pytest.approx(100.0 * 20 / 71)
    # copies are busy time, not launches
    assert sum(att.kernels.values()) == 3


@pytest.mark.parametrize("overlap", [False, True])
def test_attributions_sum_to_the_window_idle(overlap):
    events = [window(0, 200), span("pt.pass", 1, 0, 150), span("pt.camera", 1, 0, 30)]
    t = 5
    for i in range(12):
        d = 20 if overlap and i % 3 == 0 else 6
        events.append(kernel(1 + i % 2, t, t + d, t - 1))
        t += 4 + 3 * i % 7
    att = spans.attribute(events)
    assert att.idle_s() == pytest.approx(att.window_s - att.busy_s, rel=1e-12)
    assert att.share(lambda path: True) == pytest.approx(100.0)
    assert spans.Attribution.from_json(att.to_json()) == att


@pytest.mark.parametrize("cell, spans_seen", [
    ("tiny.render_pass", {"pt.batch", "pt.pass", "pt.camera", "pt.trace", "pt.bounce",
                          "pt.closest", "pt.shade", "pt.nee", "pt.shadow", "pt.bsdf", "pt.film"}),
    ("tiny.grad", {"pt.loss", "pt.inject", "pt.bounce", "pt.bounce:replay",
                   "pt.closest:replay"}),
])
def test_span_window_on_the_cpu(tmp_path, cell, spans_seen):
    """The child's whole window at a tiny size on the CPU: the port's spans
    and ray counters are read (no device, so no kernel and no gap)."""
    from .ptbench_cells import make_root

    out = spans.measure(cell, 2**31 + 5, device="cpu", root=make_root(tmp_path))
    att = spans.Attribution.from_json(out["attribution"])
    assert spans_seen <= att.spans and not att.kernels
    assert 0 < out["counters"]["rays.live"] < out["counters"]["rays.query"]
    assert out["units"] == {"tiny.render_pass": 3, "tiny.grad": 2}[cell]


def _traced_run(monkeypatch, argv, card=True):
    spans._RESULTS.clear()
    monkeypatch.setattr(spans.sys, "argv", ["run.py", *argv])
    monkeypatch.setattr(spans.torch.cuda, "is_available", lambda: card)


TRACED = ["--workload", "tiny.grad", "--seed", "7", "--trace", "1"]


@pytest.mark.parametrize("argv, card", [
    (["--workload", "tiny.grad", "--seed", "7", "--trace", "0"], True),
    (TRACED, False),
])
def test_window_reads_nothing_outside_a_traced_run_on_a_card(monkeypatch, argv, card):
    _traced_run(monkeypatch, argv, card)
    monkeypatch.setattr(spans.subprocess, "run", lambda *a, **k: pytest.fail("started"))
    assert spans.window() is None


def test_window_reads_nothing_from_a_port_without_spans(monkeypatch):
    _traced_run(monkeypatch, TRACED)
    monkeypatch.setattr(spans.importlib.util, "find_spec", lambda name: None)
    monkeypatch.setattr(spans.subprocess, "run", lambda *a, **k: pytest.fail("started"))
    assert spans.window() is None


@pytest.mark.parametrize("rc, stdout", [(1, '{"units": 1}\n'), (0, ""), (0, "not json\n")])
def test_a_failed_window_fails_the_run(monkeypatch, rc, stdout):
    """A child that fails or prints no result raises: the traced run fails
    instead of leaving the span metrics out."""
    _traced_run(monkeypatch, TRACED)
    monkeypatch.setattr(spans.subprocess, "run",
                        lambda cmd, **k: spans.subprocess.CompletedProcess(cmd, rc, stdout))
    with pytest.raises((RuntimeError, ValueError)):
        spans.window()
    spans._RESULTS.clear()
