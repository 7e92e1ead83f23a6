"""``idle_attributed.camera`` in the render cells whose batch latency, and
not their rate, is bounded end to end, so that it moves ``batch_ms_p95``
there: share of the span window's device idle seconds put down to the
port's ``pt.camera`` span (``pt_bench/spans.py``), in %. Nothing when the
span is absent."""

from pt_bench import spans


def read(rec):
    w = spans.window()
    if w is None or "pt.camera" not in w.attribution.spans:
        return None
    return w.attribution.share(spans.leaf("pt.camera"))
