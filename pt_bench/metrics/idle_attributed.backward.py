"""Share of the span window's device idle seconds put down to the backward
pass: the path replay's ``:replay`` spans, autograd nodes labelled by
their forward span with ``[bwd]``, and ``backward`` (a node whose forward
op was not found), in % (``pt_bench/spans.py``). Nothing when no replay
span opened."""

from pt_bench import spans


def read(rec):
    w = spans.window()
    if w is None or not any(s.endswith(spans.REPLAY) for s in w.attribution.spans):
        return None
    return w.attribution.share(spans.is_backward)
