"""Device kernels the host launched per gradient step (forward and path replay)
in the traced window (copies and fills not counted)."""


def read(rec):
    if rec.kind != "grad" or not rec.trace.launches:
        return None
    return rec.trace.launches / rec.units
