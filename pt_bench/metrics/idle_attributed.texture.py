"""Share of the span window's device idle seconds put down to the port's
``pt.texture`` span (the textured block of a bounce: the cone width at the
hit, the hit's UVs, the albedo and roughness fetches, the normal map) in
the forward pass, in % (``pt_bench/spans.py``). Nothing when the span is
absent."""

from pt_bench import spans


def read(rec):
    w = spans.window()
    if w is None or "pt.texture" not in w.attribution.spans:
        return None
    return w.attribution.share(spans.under("pt.texture"))
