"""``idle_attributed.outside`` in the render cells whose batch latency, and
not their rate, is bounded end to end, so that it moves ``batch_ms_p95``
there: share of the span window's device idle seconds put down to no span
of the port and no autograd node (the benchmark's loop and syncs), in %
(``pt_bench/spans.py``). Nothing when the port opened no span."""

from pt_bench import spans


def read(rec):
    w = spans.window()
    if w is None or not w.attribution.spans:
        return None
    return w.attribution.share(spans.leaf(spans.OUTSIDE))
