"""Share of the rows handed to texture fetches that belong to a live path
whose material has that map, in %: the port's counters ``tex.live`` over
``tex.query`` in the span window (``pt_bench/spans.py``); the rest are
fetches the dense masked route spends on dead lanes. Nothing when no
fetch was counted."""

from pt_bench import spans


def read(rec):
    w = spans.window()
    if w is None or not w.counters.get("tex.query"):
        return None
    return 100.0 * w.counters.get("tex.live", 0) / w.counters["tex.query"]
