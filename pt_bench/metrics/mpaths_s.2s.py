"""``mpaths_s`` as a per-layer reading, for the render cells whose rate
swings with the host's speed by more than an end-to-end bound can hold:
camera paths per second, in millions, over the traced run's untraced
stretch of whole batches that lasts ``harness.RATE_SECONDS`` or more,
before the profiler has run (the windows after it render the same samples
again, so that no other reading moves)."""


def read(rec):
    if rec.kind != "render" or rec.rate_s <= 0.0:
        return None
    return rec.rate_paths / rec.rate_s / 1e6
