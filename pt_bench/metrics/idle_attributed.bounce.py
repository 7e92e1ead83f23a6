"""Share of the span window's device idle seconds put down to the port's
``pt.bounce`` span and its children (closest hit, shading, NEE and its
shadow rays, BSDF sampling, the ray sort) in the forward pass, in %
(``pt_bench/spans.py``). Nothing when the span is absent."""

from pt_bench import spans


def read(rec):
    w = spans.window()
    if w is None or "pt.bounce" not in w.attribution.spans:
        return None
    return w.attribution.share(spans.under("pt.bounce"))
