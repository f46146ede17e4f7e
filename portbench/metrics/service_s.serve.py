"""Mean seconds of a served ``generate`` call in the untraced half of the
window (the serving layer's per-call log line)."""


def read(ctx):
    calls = ctx.serve_calls
    return sum(c[1] - c[0] for c in calls) / len(calls) if calls else None
