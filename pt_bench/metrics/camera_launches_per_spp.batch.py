"""``camera_launches_per_spp`` in the render cells whose batch latency, and
not their rate, is bounded end to end, so that it moves ``batch_ms_p95``
there: device kernels launched under the port's ``pt.camera`` span per
sample per pixel, in the span window of a render (``pt_bench/spans.py``).
Nothing when the span is absent."""

from pt_bench import spans


def read(rec):
    w = spans.window()
    if w is None or rec.kind != "render" or "pt.camera" not in w.attribution.spans:
        return None
    return w.attribution.launches(spans.leaf("pt.camera")) / (w.units * w.spp)
