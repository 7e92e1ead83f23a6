"""Device kernels launched by the backward pass (autograd nodes and the
path replay's ``:replay`` spans) per gradient step, in the span window
(``pt_bench/spans.py``). Nothing when no replay span opened."""

from pt_bench import spans


def read(rec):
    w = spans.window()
    if w is None or rec.kind != "grad" or not any(
            s.endswith(spans.REPLAY) for s in w.attribution.spans):
        return None
    return w.attribution.launches(spans.is_backward) / w.units
