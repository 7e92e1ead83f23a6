"""``launches_per_spp`` in the render cells whose batch latency, and not
their rate, is bounded end to end, so that it moves ``batch_ms_p95``
there: device kernels the host launched per sample per pixel in the traced
window of a render (copies and fills not counted)."""


def read(rec):
    if rec.kind != "render" or not rec.trace.launches:
        return None
    return rec.trace.launches / (rec.units * rec.spp)
