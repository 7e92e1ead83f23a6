"""``device_idle_share.render`` in the render cells whose batch latency, and
not their rate, is bounded end to end, so that it moves ``batch_ms_p95``
there: one minus the traced window's device-busy seconds over the untraced
wall of as many batches, in %."""


def read(rec):
    if rec.kind != "render" or rec.trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.wall_s)
