"""Share of the span window's device idle seconds put down to no span of
the port and no autograd node: the caller's own code (the benchmark's loop
and syncs, the optimiser), in % (``pt_bench/spans.py``). Nothing when the
port opened no span."""

from pt_bench import spans


def read(rec):
    w = spans.window()
    if w is None or not w.attribution.spans:
        return None
    return w.attribution.share(spans.leaf(spans.OUTSIDE))
