"""Share of the rows handed to the light tree (a descent, or the pmf
replay of an emitter hit) whose answer is used, in %: the port's counters
``lighttree.live`` over ``lighttree.query`` in the span window
(``pt_bench/spans.py``). A descent's answer is used on a live path, a
replay's on a live path that hit an emissive triangle with a record; the
rest are rows the dense masked route spends on the tree for nothing.
Nothing when no row was counted."""

from pt_bench import spans


def read(rec):
    w = spans.window()
    if w is None or not w.counters.get("lighttree.query"):
        return None
    return 100.0 * w.counters.get("lighttree.live", 0) / w.counters["lighttree.query"]
