"""Share of the rays handed to the intersection queries that were alive,
in %: the port's counters ``rays.live`` over ``rays.query`` in the span
window (``pt_bench/spans.py``); the rest are lanes spent on dead paths and
shadow rays that cannot contribute. Nothing when no ray was counted."""

from pt_bench import spans


def read(rec):
    w = spans.window()
    if w is None or not w.counters.get("rays.query"):
        return None
    return 100.0 * w.counters.get("rays.live", 0) / w.counters["rays.query"]
