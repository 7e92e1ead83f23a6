"""Share of a gradient step's wall in which the card ran nothing: one minus the
traced window's device-busy seconds over the untraced wall of as many steps,
in %."""


def read(rec):
    if rec.kind != "grad" or rec.trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.wall_s)
