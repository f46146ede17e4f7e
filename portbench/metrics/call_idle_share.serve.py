"""Share of the time inside served ``generate`` calls in which no kernel or
copy ran on the card, over the calls of the traced half of the window, in
percent; the empty queue between calls is not counted."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_calls:
        return None
    tr = ctx.trace
    idle, total = tr.idle_inside([(tr.at(a), tr.at(b)) for a, b, _ in ctx.traced_calls])
    return 100.0 * idle / total if total else None
