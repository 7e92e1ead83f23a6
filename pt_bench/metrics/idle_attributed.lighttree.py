"""Share of the span window's device idle seconds put down to the port's
``pt.lighttree`` span (the light tree's importance descent under
``pt.nee`` and its pmf replay for an emitter hit under ``pt.shade``) in the
forward pass, in % (``pt_bench/spans.py``). Nothing when the span is
absent."""

from pt_bench import spans


def read(rec):
    w = spans.window()
    if w is None or "pt.lighttree" not in w.attribution.spans:
        return None
    return w.attribution.share(spans.under("pt.lighttree"))
