"""Device kernels launched under the port's ``pt.lighttree`` span per
sample per pixel, in the span window of a render (``pt_bench/spans.py``).
Nothing when the span is absent."""

from pt_bench import spans


def read(rec):
    w = spans.window()
    if w is None or rec.kind != "render" or "pt.lighttree" not in w.attribution.spans:
        return None
    return w.attribution.launches(spans.under("pt.lighttree")) / (w.units * w.spp)
